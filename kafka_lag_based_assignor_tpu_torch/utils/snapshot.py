"""Crash-safe lifecycle snapshots: the sidecar's warm state, durable.

The port's own copy of ``kafka_lag_based_assignor_tpu/utils/snapshot.py``
(the module imports no JAX, but the port imports nothing of that
package), byte-compatible with it: the same sections give the same
document, so either package's sidecar loads the other's file, and the
backends keep one on-disk layout, so a hand-off between the two packages
keeps its warm state.

Every byte of warm state -- per-stream choices and rosters, SLO classes,
the recommend call's lag-trend windows, breaker cooldowns, the overload
rung -- otherwise lives only in process memory, and a deploy or crash
cold-starts every tenant at once.  The service periodically (and on
churn) snapshots its host-recoverable state, and a restarting process
rehydrates from it off the serving path (service.py's recovery).

Format (one JSON document)::

    {"format": "klba-snapshot", "version": 1, "written_at": <unix s>,
     "sections": {"streams":  {"crc32": <int>, "body": {...}},
                  "breakers": {"crc32": <int>, "body": {...}},
                  "overload": {"crc32": <int>, "body": {...}}}}

Design rules, in failure-model order:

* **Atomic**: a snapshot is written to a same-directory temp file and
  ``os.rename``-d into place (:func:`atomic_write_bytes` — THE helper
  every durable package write goes through), so a
  crash mid-write leaves the previous snapshot intact and a reader can
  never observe a torn file from this writer.
* **Versioned**: a loader only trusts ``version == SNAPSHOT_VERSION``.
  A WRONG version (older writer) and a FUTURE version (newer writer, a
  rolled-back deploy) both load as a counted cold start — never a
  guess at a foreign schema.
* **Per-section checksummed**: each section's body carries a CRC32 of
  its canonical JSON encoding.  A corrupt section (bit rot, a torn
  copy) is SKIPPED and counted — the other sections still load; losing
  the breaker states must not cost every tenant its warm roster.
* **Fail-open**: :meth:`SnapshotStore.load` never raises into the
  serving path.  Anything unreadable — missing file, truncated JSON,
  wrong format marker — is a counted cold start; anything partially
  readable is a counted partial load.  :meth:`SnapshotStore.save`
  never raises either (an outage of the snapshot volume must not take
  the sidecar down); failures land in
  ``klba_snapshot_writes_total{outcome="error"}``.

Backends and cross-host hand-off: the store persists through a
pluggable
:class:`SnapshotBackend`.  ``file`` is the per-instance
atomic local file; ``memory`` and ``object`` are object-store-shaped
backends (an in-memory cell shared by path, and a filesystem-simulated
object store) that speak the full remote protocol — **versioned
compare-and-swap** writes plus **epoch-fenced writer leases**:

* every object write can be conditioned on the object version last
  observed (``write_if(data, prev_version=...)`` — a mismatch raises
  :class:`CASConflict`, the loser never lands);
* a writer first acquires a **lease** whose fencing ``token`` is
  minted by CAS and monotone across acquisitions: a replacement
  instance that takes over (lease expired or released) holds a HIGHER
  token, and every subsequent write from the fenced-off predecessor —
  its ``write_if`` carries its stale token — raises
  :class:`FencedWriter` and is rejected loudly (counted as
  ``klba_snapshot_writes_total{outcome="fenced"}``, flight-recorded)
  instead of clobbering the adopted state.

Lease semantics: ``acquire_lease`` succeeds only when no LIVE lease is
held by another owner (else :class:`LeaseHeld`); a successful acquire
always bumps the token (a fresh fencing epoch).  ``renew_lease``
extends the expiry WITHOUT changing the token; an expired-but-
unsuperseded lease may still write (and renews on the next save) — the
token, not the clock, is the authority, exactly like object-store
generation numbers.  All of this stays fail-open at the store level: a
backend outage (fault point ``backend.partition``) never takes
assignment down — saves count errors, loads count cold starts, and a
boot that cannot acquire the lease serves anyway with writes denied
(``outcome="no_lease"``).

Fault points (utils/faults, wired into the chaos suite):
``snapshot.write`` fires at the head of every save, ``snapshot.load``
at the head of every load — both exercise the fail-open contracts
above.  ``backend.partition`` / ``backend.latency`` fire at the head
of every backend operation (an unreachable / slow remote store);
``snapshot.cas`` fires inside conditional writes (a simulated CAS
race — the write loses as :class:`CASConflict`); ``snapshot.lease``
fires inside lease acquire/renew/release (a lease-channel failure).

Telemetry: ``klba_snapshot_writes_total{outcome}`` (``ok`` | ``error``
| ``fenced`` | ``no_lease``), ``klba_snapshot_write_duration_ms``,
``klba_snapshot_bytes``, ``klba_snapshot_loads_total{outcome}``,
``klba_snapshot_sections_skipped_total{section}``,
``klba_snapshot_cas_conflicts_total``,
``klba_lease_acquires_total{outcome}``,
``klba_lease_releases_total``,
``klba_lease_takeovers_total{previous}``.

Clock discipline: durations flow through the registry clock;
``written_at`` / snapshot age need a WALL clock that survives a
process restart, so the store takes an injectable ``wall_clock``
defaulting to ``time.time`` (referenced, never called directly).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import faults, metrics

LOGGER = logging.getLogger(__name__)

#: The schema version THIS writer produces and the only one the loader
#: trusts.  Bump it on any incompatible body change; the rollout story
#: (DEPLOYMENT.md "Restarts and recovery") is that a version mismatch
#: is a clean cold start, never a migration attempt in the sidecar.
SNAPSHOT_VERSION = 1

_FORMAT = "klba-snapshot"

#: Load outcomes, the ``klba_snapshot_loads_total`` label values:
#: ``ok`` (every section verified), ``partial`` (>= 1 section skipped),
#: ``cold`` (nothing usable: corrupt/wrong-version/unreadable),
#: ``missing`` (no file — the normal first boot).
LOAD_OUTCOMES = ("ok", "partial", "cold", "missing")


def _canonical(body: Any) -> bytes:
    """THE byte encoding the section checksums are computed over —
    shared by save and load so the two can never disagree on
    whitespace or key order."""
    return json.dumps(
        body, sort_keys=True, separators=(",", ":")
    ).encode("utf-8")


def section_crc(body: Any) -> int:
    """CRC32 of a section body's canonical encoding (exposed so tests
    can build hand-tampered snapshots)."""
    return zlib.crc32(_canonical(body))


def atomic_write_bytes(path: str, data: bytes) -> None:
    """THE durable-write helper: write ``data`` to a
    same-directory temp file, fsync, then ``os.rename`` over ``path``.
    A reader can observe the old file or the new file, never a torn
    mix; a crash mid-write leaves the old file untouched.  The temp
    name carries the pid so two processes pointed at one path cannot
    corrupt each other's staging (last rename still wins, atomically).
    """
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, path)
    except BaseException:
        # Never leave staging litter next to the real file; the rename
        # either happened (tmp is gone) or the write is abandoned.
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


# -- snapshot backends (cross-host hand-off) -------------------------------

#: Backend kinds ``build_backend`` (and the service/config layer)
#: accepts.  ``file`` = the per-instance atomic local file;
#: ``memory`` = an in-process cell shared by path (tests, drills, and
#: the two-instance soaks); ``object`` = a filesystem-simulated object
#: store (a directory of versioned objects + a meta/lease document) —
#: the full remote CAS + lease protocol, tier-1-testable.
BACKEND_KINDS = ("file", "memory", "object")


class CASConflict(RuntimeError):
    """A conditional write lost its compare-and-swap: the object
    version moved under the writer.  The loser's data never landed."""


class FencedWriter(RuntimeError):
    """A write (or renew) carried a STALE fencing token: a replacement
    instance holds a newer lease.  The write was rejected; the caller
    must stop writing — its warm-state epoch is over."""


class LeaseHeld(RuntimeError):
    """``acquire_lease`` found a live lease held by another owner."""

    def __init__(self, owner: str, expires_in_s: float):
        super().__init__(
            f"writer lease held by {owner!r} for another "
            f"{expires_in_s:.3f}s"
        )
        self.owner = owner
        self.expires_in_s = expires_in_s


class Lease:
    """One granted writer lease: the monotone fencing ``token`` is the
    write authority; ``expires_at`` / ``acquired_at`` are wall-clock
    (they must be comparable across hosts and restarts)."""

    __slots__ = ("owner", "token", "expires_at", "acquired_at")

    def __init__(
        self, owner: str, token: int, expires_at: float,
        acquired_at: float,
    ):
        self.owner = owner
        self.token = int(token)
        self.expires_at = float(expires_at)
        self.acquired_at = float(acquired_at)

    def as_dict(self) -> Dict[str, Any]:
        return {
            "owner": self.owner,
            "token": self.token,
            "expires_at": self.expires_at,
            "acquired_at": self.acquired_at,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Lease":
        return cls(
            str(d["owner"]), int(d["token"]), float(d["expires_at"]),
            float(d.get("acquired_at", 0.0)),
        )


def _lease_live(lease: Optional[Dict[str, Any]], now: float) -> bool:
    return lease is not None and float(lease["expires_at"]) > now


class SnapshotBackend:
    """Abstract snapshot persistence: versioned objects + writer
    leases.  Subclasses implement the six primitives under their own
    mutual exclusion; the CAS/fencing *semantics* live here so the
    three backends cannot diverge.

    State model per backend: one object (the snapshot document bytes)
    with a monotone ``object_version`` (0 = never written), plus an
    optional lease record ``{owner, token, expires_at, acquired_at}``
    and a ``fence_token`` — the highest token EVER minted, persisted
    independently of the lease so a release can never reset the
    fencing epoch (a stale holder's token must stay stale forever; the
    ``released`` record additionally remembers who handed off, for the
    lifecycle surface).  Every public operation fires the shared fault
    points (``backend.latency`` then ``backend.partition``); lease
    operations additionally fire ``snapshot.lease`` and conditional
    writes ``snapshot.cas``.
    """

    kind = "abstract"

    def __init__(self, wall_clock: Callable[[], float] = time.time):
        self._wall = wall_clock

    # -- primitives (subclass responsibility, caller-locked) ---------------

    def _load_state(self) -> Dict[str, Any]:
        """Normalized state dict (see :meth:`_norm_state`)."""
        raise NotImplementedError

    @staticmethod
    def _norm_state(raw: Dict[str, Any]) -> Dict[str, Any]:
        """Normalize a raw persisted state document: defaults, copies,
        and the fence-token backfill (documents written before a
        release carry the token only inside the lease)."""
        lease = raw.get("lease")
        released = raw.get("released")
        fence = raw.get("fence_token")
        if fence is None:
            fence = int(lease["token"]) if lease else 0
        return {
            "object_version": int(raw.get("object_version", 0)),
            "lease": dict(lease) if lease else None,
            "released": dict(released) if released else None,
            "fence_token": int(fence),
        }

    def _store_state(self, state: Dict[str, Any]) -> None:
        raise NotImplementedError

    def _read_data(self, state: Dict[str, Any]) -> Optional[bytes]:
        raise NotImplementedError

    def _write_data(self, data: bytes, new_version: int) -> None:
        raise NotImplementedError

    def _mutex(self):
        """Context manager serializing read-modify-write cycles."""
        raise NotImplementedError

    def describe(self) -> str:
        raise NotImplementedError

    # -- shared fault hooks ------------------------------------------------

    def _enter(self) -> None:
        """Every backend op passes here: ``backend.latency`` (sleep,
        then proceed) models a slow link, ``backend.partition``
        (raise) an unreachable store."""
        faults.fire("backend.latency")
        faults.fire("backend.partition")

    # -- object ops --------------------------------------------------------

    def read(self) -> Tuple[Optional[bytes], int]:
        """``(data, object_version)``; ``(None, v)`` when no object is
        readable.  Lease-free — recovery may always LOOK."""
        self._enter()
        with self._mutex():
            state = self._load_state()
            return self._read_data(state), int(state["object_version"])

    def version(self) -> int:
        self._enter()
        with self._mutex():
            return int(self._load_state()["object_version"])

    def write_if(
        self,
        data: bytes,
        prev_version: Optional[int] = None,
        token: Optional[int] = None,
    ) -> int:
        """Write the object; returns the new version.

        ``prev_version`` (when not None) must equal the current object
        version or :class:`CASConflict` is raised — the loser never
        lands.  ``token`` (when not None) must equal the CURRENT lease
        token or :class:`FencedWriter` is raised — a fenced-off
        predecessor can never clobber its replacement's adopted state,
        even with a "winning" version guess.  Both None = the
        unconditional legacy write (the plain file's semantics)."""
        self._enter()
        if prev_version is not None or token is not None:
            try:
                faults.fire("snapshot.cas")
            except faults.FaultError as exc:
                # The injected CAS race: this write LOSES, exactly as
                # if a concurrent writer bumped the version first.
                raise CASConflict(f"injected CAS race: {exc}") from exc
        with self._mutex():
            state = self._load_state()
            if token is not None:
                lease = state.get("lease")
                if lease is None or int(lease["token"]) != int(token):
                    raise FencedWriter(
                        f"write with fencing token {token} rejected: "
                        f"current lease is "
                        f"{lease and lease.get('token')!r} "
                        f"(held by {lease and lease.get('owner')!r})"
                    )
            if prev_version is not None and (
                int(prev_version) != int(state["object_version"])
            ):
                raise CASConflict(
                    f"object version moved: expected {prev_version}, "
                    f"backend holds {state['object_version']}"
                )
            new_version = int(state["object_version"]) + 1
            self._write_data(data, new_version)
            state["object_version"] = new_version
            self._store_state(state)
            return new_version

    # -- lease ops ---------------------------------------------------------

    def read_lease(self) -> Optional[Lease]:
        self._enter()
        with self._mutex():
            lease = self._load_state().get("lease")
            return Lease.from_dict(lease) if lease else None

    def lease_state(self) -> Dict[str, Any]:
        """Raw lease-channel state ``{lease, released, fence_token}``
        — the hand-off observability read (who held the state before
        this boot, and whether they crashed or drained)."""
        self._enter()
        with self._mutex():
            state = self._load_state()
            return {
                "lease": state.get("lease"),
                "released": state.get("released"),
                "fence_token": int(state.get("fence_token", 0)),
            }

    def acquire_lease(self, owner: str, ttl_s: float) -> Lease:
        """Grant (token = highest ever minted + 1) unless a LIVE lease
        is held by another owner (:class:`LeaseHeld`).  An expired or
        released lease is taken over — the MONOTONE token bump is what
        fences the previous holder out, and it survives releases (the
        ``fence_token``), so a drained predecessor's stale token can
        never collide with a successor's."""
        self._enter()
        faults.fire("snapshot.lease")
        now = self._wall()
        with self._mutex():
            state = self._load_state()
            cur = state.get("lease")
            if _lease_live(cur, now) and cur["owner"] != owner:
                raise LeaseHeld(
                    str(cur["owner"]), float(cur["expires_at"]) - now
                )
            token = max(
                int(state.get("fence_token", 0)),
                int(cur["token"]) if cur else 0,
            ) + 1
            lease = Lease(owner, token, now + float(ttl_s), now)
            state["lease"] = lease.as_dict()
            state["fence_token"] = token
            state["released"] = None
            self._store_state(state)
            return lease

    def renew_lease(self, lease: Lease, ttl_s: float) -> Lease:
        """Extend the expiry of the lease named by ``lease.token``
        (token unchanged); :class:`FencedWriter` when superseded."""
        self._enter()
        faults.fire("snapshot.lease")
        now = self._wall()
        with self._mutex():
            state = self._load_state()
            cur = state.get("lease")
            if cur is None or int(cur["token"]) != lease.token:
                raise FencedWriter(
                    f"renew with token {lease.token} rejected: current "
                    f"lease is {cur and cur.get('token')!r}"
                )
            renewed = Lease(
                lease.owner, lease.token, now + float(ttl_s),
                float(cur.get("acquired_at", now)),
            )
            state["lease"] = renewed.as_dict()
            self._store_state(state)
            return renewed

    def release_lease(self, lease: Lease) -> None:
        """Drop the lease iff still ours (a superseded release is a
        no-op — never yank the replacement's lease)."""
        self._enter()
        faults.fire("snapshot.lease")
        with self._mutex():
            state = self._load_state()
            cur = state.get("lease")
            if cur is not None and int(cur["token"]) == lease.token:
                state["released"] = cur
                state["lease"] = None
                self._store_state(state)


#: In-memory backend cells, shared BY PATH within the process: two
#: service instances constructed with the same path (a restart drill,
#: the two-instance soaks) see one "remote" store.  Plain dict under
#: the module import lock semantics; each cell carries its own lock.
_MEMORY_CELLS: Dict[str, Dict[str, Any]] = {}
_MEMORY_CELLS_LOCK = threading.Lock()


def reset_memory_backends() -> None:
    """Drop every in-memory cell (test hygiene)."""
    with _MEMORY_CELLS_LOCK:
        _MEMORY_CELLS.clear()


class InMemoryBackend(SnapshotBackend):
    """Object-store-shaped backend in process memory, keyed by name:
    the CAS + lease protocol with zero I/O — what the failure-matrix
    tests and the concurrent-writer soaks run against."""

    kind = "memory"

    def __init__(
        self, name: str, wall_clock: Callable[[], float] = time.time
    ):
        super().__init__(wall_clock)
        self.name = str(name)
        with _MEMORY_CELLS_LOCK:
            cell = _MEMORY_CELLS.get(self.name)
            if cell is None:
                cell = _MEMORY_CELLS[self.name] = {
                    "lock": threading.RLock(),
                    "state": self._norm_state({}),
                    "data": None,
                }
        self._cell = cell

    def _mutex(self):
        return self._cell["lock"]

    def _load_state(self) -> Dict[str, Any]:
        # Copy: callers mutate the dict before _store_state.
        return self._norm_state(self._cell["state"])

    def _store_state(self, state: Dict[str, Any]) -> None:
        self._cell["state"] = self._norm_state(state)

    def _read_data(self, state: Dict[str, Any]) -> Optional[bytes]:
        return self._cell["data"]

    def _write_data(self, data: bytes, new_version: int) -> None:
        self._cell["data"] = bytes(data)

    def describe(self) -> str:
        return f"memory://{self.name}"


class _FsMutex:
    """O_CREAT|O_EXCL lock-file mutex for the filesystem backends'
    read-modify-write cycles: held only for the (sub-ms) meta RMW, a
    stale lock (holder crashed mid-cycle) is broken after
    ``stale_s``.

    Ownership-safe: the lock file carries a unique owner token.
    Breaking a stale lock RENAMES it first (atomic — exactly one
    breaker wins, and a resumed holder can no longer be holding the
    live path), and release verifies the token before unlinking, so a
    holder that stalled past ``stale_s`` and resumed can never delete
    its successor's live lock."""

    _SEQ = iter(range(1, 1 << 30))

    def __init__(
        self,
        path: str,
        wall_clock: Callable[[], float],
        timeout_s: float = 5.0,
        stale_s: float = 5.0,
    ):
        self.path = path
        self._wall = wall_clock
        self.timeout_s = float(timeout_s)
        self.stale_s = float(stale_s)
        self._token = f"{os.getpid()}.{next(self._SEQ)}"

    def __enter__(self) -> "_FsMutex":
        deadline = self._wall() + self.timeout_s
        while True:
            try:
                fd = os.open(
                    self.path, os.O_CREAT | os.O_EXCL | os.O_WRONLY
                )
                os.write(fd, self._token.encode())
                os.close(fd)
                return self
            except FileExistsError:
                try:
                    age = self._wall() - os.path.getmtime(self.path)
                    if age > self.stale_s:
                        # Break by RENAME, not unlink-in-place: the
                        # rename is atomic, so exactly one breaker
                        # claims the stale lock and a resumed stale
                        # holder finds its file gone instead of
                        # racing the successor's.
                        doomed = f"{self.path}.stale.{self._token}"
                        os.rename(self.path, doomed)
                        os.unlink(doomed)
                        continue
                except OSError:
                    continue  # holder released between stat and break
                if self._wall() >= deadline:
                    raise TimeoutError(
                        f"backend lock {self.path} held past "
                        f"{self.timeout_s}s"
                    )
                time.sleep(0.002)

    def __exit__(self, *exc) -> None:
        try:
            # Unlink only OUR lock: if a peer broke us as stale and a
            # successor now holds the path, its token differs and the
            # live lock is left alone.
            with open(self.path, "rb") as f:
                if f.read().decode() != self._token:
                    return
            os.unlink(self.path)
        except OSError:
            pass  # broken as stale by a peer — already gone


class _ThreadAndFileMutex:
    """The filesystem backends' RMW guard: in-process threads
    serialize on ``thread_lock``, processes on a :class:`_FsMutex`
    over ``lock_path`` — the file lock is held only for the sub-ms
    meta read-modify-write."""

    def __init__(
        self,
        thread_lock: "threading.RLock",
        lock_path: str,
        wall_clock: Callable[[], float],
    ):
        self._thread_lock = thread_lock
        self._lock_path = lock_path
        self._wall = wall_clock

    def __enter__(self) -> "_ThreadAndFileMutex":
        self._thread_lock.acquire()
        self._fs = _FsMutex(self._lock_path, self._wall)
        try:
            self._fs.__enter__()
        except BaseException:
            self._thread_lock.release()
            raise
        return self

    def __exit__(self, *exc) -> None:
        try:
            self._fs.__exit__(*exc)
        finally:
            self._thread_lock.release()


class FsObjectBackend(SnapshotBackend):
    """Filesystem-simulated object store under one directory: the
    snapshot document lives as a VERSIONED object (``snapshot.v<N>``,
    written atomically) and ``meta.json`` holds the current version +
    lease — so a torn object write can never be observed (the meta
    still points at the previous object) and two processes CAS against
    one directory through the lock-file mutex.  This is the shape a
    real S3/GCS backend would take (conditional PUT on a generation
    number); shipping it filesystem-simulated keeps the whole protocol
    tier-1-testable."""

    kind = "object"

    #: Old object generations kept for readers mid-swap.
    KEEP_OBJECTS = 2

    def __init__(
        self, directory: str,
        wall_clock: Callable[[], float] = time.time,
    ):
        super().__init__(wall_clock)
        if not directory:
            raise ValueError("backend directory must be non-empty")
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._meta_path = os.path.join(self.directory, "meta.json")
        self._lock_path = os.path.join(self.directory, "lock")
        self._thread_lock = threading.RLock()

    def _mutex(self):
        return _ThreadAndFileMutex(
            self._thread_lock, self._lock_path, self._wall
        )

    def _object_path(self, version: int) -> str:
        return os.path.join(self.directory, f"snapshot.v{int(version)}")

    def _load_state(self) -> Dict[str, Any]:
        try:
            with open(self._meta_path, "rb") as f:
                meta = json.loads(f.read().decode("utf-8"))
            return self._norm_state(meta)
        except (OSError, ValueError):
            return self._norm_state({})

    def _store_state(self, state: Dict[str, Any]) -> None:
        atomic_write_bytes(
            self._meta_path,
            json.dumps(
                self._norm_state(state), sort_keys=True
            ).encode("utf-8"),
        )

    def _read_data(self, state: Dict[str, Any]) -> Optional[bytes]:
        version = int(state["object_version"])
        if version <= 0:
            return None
        try:
            with open(self._object_path(version), "rb") as f:
                return f.read()
        except FileNotFoundError:
            # Meta points at a GC'd/never-landed object: genuinely
            # nothing to read (a counted "missing" load).  Any OTHER
            # I/O fault (EACCES, EIO) must propagate so the store's
            # fail-open load reports a logged COLD start — a real disk
            # fault may not masquerade as a fresh install.
            return None

    def _write_data(self, data: bytes, new_version: int) -> None:
        atomic_write_bytes(self._object_path(new_version), data)
        # GC generations older than the keep window (best-effort).
        doomed = new_version - self.KEEP_OBJECTS
        while doomed > 0:
            path = self._object_path(doomed)
            if not os.path.exists(path):
                break
            try:
                os.unlink(path)
            except OSError:
                break
            doomed -= 1

    def describe(self) -> str:
        return f"object://{self.directory}"


class FileBackend(SnapshotBackend):
    """The per-instance atomic local file, as a backend: the
    snapshot document lives at ``path`` byte-for-byte as before (the
    corruption matrix, operator tooling, and hand-tampering tests all
    still read it directly), and CAS/lease metadata appears in a
    sidecar ``<path>.meta`` ONLY once fencing is actually used — an
    unfenced deployment's disk layout is exactly one file.
    Cross-host CAS is not this backend's claim (one file on one host);
    in-process fencing serializes on the thread lock and
    cross-process-on-one-host fencing on the lock-file mutex — both
    are held for every read-modify-write cycle."""

    kind = "file"

    def __init__(
        self, path: str, wall_clock: Callable[[], float] = time.time
    ):
        super().__init__(wall_clock)
        if not path:
            raise ValueError("snapshot path must be non-empty")
        self.path = str(path)
        self._meta_path = f"{self.path}.meta"
        self._lock_path = f"{self.path}.lock"
        self._thread_lock = threading.RLock()
        # In-memory version counter serving until (unless) the sidecar
        # meta exists; monotone within this process either way.
        self._mem_version = 0

    def _mutex(self):
        # Same composition as FsObjectBackend: without the file lock
        # two processes could both read fence_token=N and mint the
        # SAME token N+1 — the exact lost-update fencing exists to
        # prevent.  The lock file is transient (created and removed
        # around each sub-ms RMW), so the unfenced one-file disk
        # layout is preserved between operations.
        return _ThreadAndFileMutex(
            self._thread_lock, self._lock_path, self._wall
        )

    def _meta_engaged(self) -> bool:
        return os.path.exists(self._meta_path)

    def _load_state(self) -> Dict[str, Any]:
        if self._meta_engaged():
            try:
                with open(self._meta_path, "rb") as f:
                    meta = json.loads(f.read().decode("utf-8"))
                return self._norm_state(meta)
            except (OSError, ValueError):
                pass  # corrupt sidecar: fall through to memory state
        return self._norm_state(
            {"object_version": self._mem_version}
        )

    def _store_state(self, state: Dict[str, Any]) -> None:
        self._mem_version = int(state["object_version"])
        # The sidecar exists only once a lease engaged fencing (or it
        # already exists and must stay coherent): an unfenced
        # deployment keeps the exact one-file layout.
        if state.get("lease") is not None or self._meta_engaged():
            atomic_write_bytes(
                self._meta_path,
                json.dumps(
                    self._norm_state(state), sort_keys=True
                ).encode("utf-8"),
            )

    def _read_data(self, state: Dict[str, Any]) -> Optional[bytes]:
        try:
            with open(self.path, "rb") as f:
                return f.read()
        except FileNotFoundError:
            # The plain file's "missing" semantics: no file = first boot.
            # Every other OSError (EACCES, EIO, IsADirectoryError)
            # propagates into the store's fail-open load — a logged
            # cold start, never a clean-looking fresh install.
            return None

    def _write_data(self, data: bytes, new_version: int) -> None:
        atomic_write_bytes(self.path, data)

    def describe(self) -> str:
        return self.path


def build_backend(
    kind: str, path: str,
    wall_clock: Callable[[], float] = time.time,
) -> SnapshotBackend:
    """Backend factory for the config/service layer: ``kind`` is one
    of :data:`BACKEND_KINDS`; ``path`` is the file (``file``), the
    shared cell name (``memory``), or the store directory
    (``object``)."""
    if kind == "file":
        return FileBackend(path, wall_clock=wall_clock)
    if kind == "memory":
        return InMemoryBackend(path, wall_clock=wall_clock)
    if kind == "object":
        return FsObjectBackend(path, wall_clock=wall_clock)
    raise ValueError(
        f"unknown snapshot backend {kind!r}; valid: {list(BACKEND_KINDS)}"
    )


class LoadResult:
    """One load's outcome: the verified section bodies, what was
    skipped, and the snapshot's age (seconds at load time, from the
    file's own ``written_at`` wall-clock stamp)."""

    __slots__ = ("outcome", "sections", "skipped", "age_s", "reason")

    def __init__(
        self,
        outcome: str,
        sections: Dict[str, Any],
        skipped: List[str],
        age_s: Optional[float],
        reason: Optional[str] = None,
    ):
        self.outcome = outcome
        self.sections = sections
        self.skipped = skipped
        self.age_s = age_s
        self.reason = reason


class SnapshotStore:
    """Owns one snapshot location: atomic save, corruption-tolerant
    load, and — when a lease is attached — epoch-fenced writes.

    ``wall_clock`` stamps ``written_at`` (it must survive restarts, so
    it is wall time, not the registry's perf counter); durations still
    flow through the registry clock.  Thread-safe: saves serialize on
    an internal lock (the periodic writer, a churn trigger, and the
    drain's final snapshot may race).

    Persistence flows through ``backend`` (:class:`SnapshotBackend`);
    a plain ``path`` keeps the one-file behavior (a
    :class:`FileBackend` with unconditional writes until fencing is
    attached)."""

    def __init__(
        self,
        path: Optional[str] = None,
        wall_clock: Callable[[], float] = time.time,
        backend: Optional[SnapshotBackend] = None,
    ):
        if backend is None:
            if not path:
                raise ValueError("snapshot path must be non-empty")
            backend = FileBackend(path, wall_clock=wall_clock)
        self.backend = backend
        self.path = backend.describe()
        self._wall = wall_clock
        self._lock = threading.Lock()
        # Last successful save's wall stamp + size, for the lifecycle
        # stats surface (None until a save succeeds or a load finds a
        # file).
        self._last_written_at: Optional[float] = None
        self._last_bytes: Optional[int] = None
        # Last object version this store observed (load or save): the
        # prev_version its fenced CAS writes are conditioned on.
        self._version = 0
        # Writer-lease state (attach_lease/acquire_lease): fencing is
        # OFF until attached — unconditional legacy writes.
        self._lease_owner: Optional[str] = None
        self._lease_ttl_s = 0.0
        self._lease: Optional[Lease] = None
        self._m_writes = {
            o: metrics.REGISTRY.counter(
                "klba_snapshot_writes_total", {"outcome": o}
            )
            for o in ("ok", "error", "fenced", "no_lease")
        }
        self._m_write_ms = metrics.REGISTRY.histogram(
            "klba_snapshot_write_duration_ms"
        )
        self._m_bytes = metrics.REGISTRY.gauge("klba_snapshot_bytes")
        self._m_loads = {
            o: metrics.REGISTRY.counter(
                "klba_snapshot_loads_total", {"outcome": o}
            )
            for o in LOAD_OUTCOMES
        }
        self._m_cas = metrics.REGISTRY.counter(
            "klba_snapshot_cas_conflicts_total"
        )

    # -- writer lease ------------------------------------------------------

    @property
    def fencing_enabled(self) -> bool:
        return self._lease_owner is not None

    @property
    def lease_token(self) -> Optional[int]:
        """The held writer lease's fencing token (None when fencing is
        off or the lease was not acquired) — what the federation plane
        stamps on peer-bound payloads so a fenced-off predecessor's
        sync requests are rejected by its peers too."""
        with self._lock:
            return self._lease.token if self._lease is not None else None

    def attach_lease(self, owner: str, ttl_s: float) -> None:
        """Engage epoch fencing: every subsequent save requires the
        lease acquired via :meth:`acquire_lease` and is a
        ``save_if(token, prev_version)`` against the backend."""
        if not owner:
            raise ValueError("lease owner must be non-empty")
        if not ttl_s > 0:
            raise ValueError(f"lease ttl_s={ttl_s} must be > 0")
        self._lease_owner = str(owner)
        self._lease_ttl_s = float(ttl_s)

    def acquire_lease(
        self,
        wait_s: float = 0.0,
        poll_s: float = 0.05,
        sleep: Callable[[float], None] = time.sleep,
    ) -> Dict[str, Any]:
        """Acquire (or take over) the writer lease, waiting up to
        ``wait_s`` for a live foreign lease to expire or be released.
        NEVER raises — a backend outage must not fail the boot; the
        caller serves anyway and writes are denied (``no_lease``).
        Returns ``{ok, token?, waited_ms, previous_holder,
        previous_expired, error?}``."""
        if not self.fencing_enabled:
            return {"ok": True, "waited_ms": 0.0, "token": None,
                    "previous_holder": None, "previous_expired": False}
        started = self._wall()
        deadline = started + max(float(wait_s), 0.0)
        prev_holder: Optional[str] = None
        prev_expired = False
        while True:
            try:
                try:
                    ls = self.backend.lease_state()
                except Exception:  # noqa: BLE001 — observational read
                    LOGGER.warning(
                        "could not read the current lease holder",
                        exc_info=True,
                    )
                    ls = {}
                held = ls.get("lease")
                released = ls.get("released")
                if held is not None and held["owner"] != self._lease_owner:
                    prev_holder = str(held["owner"])
                    prev_expired = (
                        float(held["expires_at"]) <= self._wall()
                    )
                elif released is not None and (
                    released.get("owner") != self._lease_owner
                ):
                    # The predecessor DRAINED: it released the lease
                    # after its final snapshot — a hand-off, not a
                    # crash (the service reports the mode).
                    prev_holder = str(released.get("owner"))
                    prev_expired = False
                lease = self.backend.acquire_lease(
                    self._lease_owner, self._lease_ttl_s
                )
                with self._lock:
                    self._lease = lease
                waited_ms = (self._wall() - started) * 1000.0
                metrics.REGISTRY.counter(
                    "klba_lease_acquires_total", {"outcome": "acquired"}
                ).inc()
                if prev_holder is not None:
                    metrics.REGISTRY.counter(
                        "klba_lease_takeovers_total",
                        {
                            "previous": (
                                "expired" if prev_expired else "released"
                            )
                        },
                    ).inc()
                return {
                    "ok": True,
                    "token": lease.token,
                    "waited_ms": waited_ms,
                    "previous_holder": prev_holder,
                    "previous_expired": prev_expired,
                }
            except LeaseHeld as exc:
                prev_holder = exc.owner
                prev_expired = False
                now = self._wall()
                if now >= deadline:
                    metrics.REGISTRY.counter(
                        "klba_lease_acquires_total",
                        {"outcome": "timeout"},
                    ).inc()
                    LOGGER.warning(
                        "writer lease still held by %r after %.1fs; "
                        "serving WITHOUT the lease (snapshot writes "
                        "denied until acquired)", exc.owner, wait_s,
                    )
                    return {
                        "ok": False,
                        "waited_ms": (now - started) * 1000.0,
                        "previous_holder": prev_holder,
                        "previous_expired": False,
                        "error": str(exc),
                    }
                sleep(min(poll_s, max(deadline - now, 0.0)))
            except Exception as exc:  # noqa: BLE001 — boot fail-open
                LOGGER.warning(
                    "lease acquisition failed; serving WITHOUT the "
                    "lease (snapshot writes denied)", exc_info=True,
                )
                metrics.REGISTRY.counter(
                    "klba_lease_acquires_total", {"outcome": "error"}
                ).inc()
                return {
                    "ok": False,
                    "waited_ms": (self._wall() - started) * 1000.0,
                    "previous_holder": prev_holder,
                    "previous_expired": prev_expired,
                    "error": str(exc),
                }

    def release_lease(self) -> None:
        """Drop the held lease (graceful drain: the replacement then
        acquires without waiting out the TTL).  Fail-open."""
        with self._lock:
            lease, self._lease = self._lease, None
        if lease is None:
            return
        try:
            self.backend.release_lease(lease)
            metrics.REGISTRY.counter("klba_lease_releases_total").inc()
        except Exception:  # noqa: BLE001 — drain must complete
            LOGGER.warning(
                "lease release failed; the TTL will expire it",
                exc_info=True,
            )

    def lease_stats(self) -> Dict[str, Any]:
        """The lifecycle surface's lease row: this store's fencing
        state plus the backend's CURRENT holder (fail-open to
        unknown)."""
        with self._lock:
            mine = self._lease
        out: Dict[str, Any] = {
            "enabled": self.fencing_enabled,
            "owner": self._lease_owner,
            "ttl_s": self._lease_ttl_s if self.fencing_enabled else None,
            "token": mine.token if mine is not None else None,
            "held": False,
        }
        if not self.fencing_enabled:
            return out
        try:
            holder = self.backend.read_lease()
        except Exception:  # noqa: BLE001 — monitoring read
            LOGGER.warning("lease holder read failed", exc_info=True)
            holder = None
        now = self._wall()
        if holder is not None:
            out["holder"] = holder.owner
            out["holder_token"] = holder.token
            out["holder_age_s"] = max(0.0, now - holder.acquired_at)
            out["expires_in_s"] = holder.expires_at - now
            out["held"] = (
                mine is not None and holder.token == mine.token
            )
        else:
            out["holder"] = None
        return out

    # -- save --------------------------------------------------------------

    def save(self, sections: Dict[str, Any]) -> Dict[str, Any]:
        """Write one snapshot atomically; NEVER raises (a snapshot
        volume outage must not take the service down).  Returns
        ``{"ok", "bytes", "duration_ms"[, "error", "fenced",
        "denied"]}``.  Fault point ``snapshot.write`` fires first — an
        injected failure exercises exactly the fail-open path a full
        disk would.

        With fencing attached this is ``save_if(token, prev_version)``:
        the write carries the held lease's fencing token and the last
        observed object version.  A :class:`CASConflict` (our version
        info went stale — only same-token writers can race us, so the
        token stays authoritative) is retried once against the
        re-read version; a :class:`FencedWriter` (a replacement holds
        a newer lease) is REJECTED loudly — counted, flight-recorded —
        and this store stops pretending to own the state."""
        started = metrics.REGISTRY.clock()
        try:
            faults.fire("snapshot.write")
            if self.fencing_enabled and self._lease is None:
                # The boot handshake failed (backend blip, lingering
                # predecessor): re-try ONE non-blocking acquisition
                # per save, so the instance regains snapshot coverage
                # at the cadence once the lease frees instead of
                # running uncovered until its next restart.  Outside
                # the store lock — acquire_lease takes it to install
                # the lease.
                self.acquire_lease(wait_s=0.0)
            payload = {
                "format": _FORMAT,
                "version": SNAPSHOT_VERSION,
                "written_at": self._wall(),
                "sections": {
                    name: {"crc32": section_crc(body), "body": body}
                    for name, body in sections.items()
                },
            }
            data = json.dumps(payload, sort_keys=True).encode("utf-8")
            with self._lock:
                token: Optional[int] = None
                prev: Optional[int] = None
                if self.fencing_enabled:
                    lease = self._lease
                    if lease is None:
                        self._m_writes["no_lease"].inc()
                        return {
                            "ok": False, "denied": "no_lease",
                            "error": "no writer lease held",
                        }
                    # Renew ahead of expiry so a healthy cadence never
                    # lets the lease lapse between writes; a lapse
                    # without a successor still writes (the token is
                    # the authority), a superseded renew raises
                    # FencedWriter like the write itself would.
                    now = self._wall()
                    if lease.expires_at - now < self._lease_ttl_s / 2:
                        lease = self.backend.renew_lease(
                            lease, self._lease_ttl_s
                        )
                        self._lease = lease
                    token = lease.token
                    prev = self._version
                try:
                    new_version = self.backend.write_if(
                        data, prev_version=prev, token=token
                    )
                except CASConflict:
                    self._m_cas.inc()
                    if token is None:
                        raise
                    # Same-token conflict: our version info is stale
                    # (an unobserved own write); re-read and retry
                    # ONCE.  A foreign newer writer surfaces as
                    # FencedWriter, never here.
                    LOGGER.warning(
                        "snapshot CAS conflict at version %s; "
                        "re-reading and retrying once", prev,
                    )
                    prev = self.backend.version()
                    new_version = self.backend.write_if(
                        data, prev_version=prev, token=token
                    )
                self._version = new_version
                self._last_written_at = payload["written_at"]
                self._last_bytes = len(data)
        except FencedWriter as exc:
            self._m_writes["fenced"].inc()
            metrics.FLIGHT.record(
                "lifecycle",
                {
                    "event": "fenced_write",
                    "owner": self._lease_owner,
                    "error": str(exc),
                },
            )
            LOGGER.warning(
                "snapshot save REJECTED by fencing — a replacement "
                "instance owns the state now; this instance must not "
                "write again: %s", exc,
            )
            return {"ok": False, "fenced": True, "error": str(exc)}
        except Exception as exc:  # noqa: BLE001 — fail-open by contract
            LOGGER.warning(
                "snapshot save to %s failed; serving continues on the "
                "previous snapshot", self.path, exc_info=True,
            )
            self._m_writes["error"].inc()
            return {"ok": False, "error": str(exc)}
        duration_ms = (metrics.REGISTRY.clock() - started) * 1000.0
        self._m_writes["ok"].inc()
        self._m_write_ms.observe(duration_ms)
        self._m_bytes.set(len(data))
        return {"ok": True, "bytes": len(data), "duration_ms": duration_ms}

    # -- load --------------------------------------------------------------

    def load(self) -> LoadResult:
        """Read + verify the snapshot; NEVER raises into the serving
        path.  A bad section is skipped and counted; an unusable file
        is a counted cold start.  Fault point ``snapshot.load`` fires
        first (fails open to cold)."""
        skipped: List[str] = []
        try:
            faults.fire("snapshot.load")
            raw, version = self.backend.read()
            with self._lock:
                self._version = version
            if raw is None:
                return self._finish(
                    LoadResult("missing", {}, [], None, "no snapshot file")
                )
            payload = json.loads(raw.decode("utf-8"))
            if (
                not isinstance(payload, dict)
                or payload.get("format") != _FORMAT
            ):
                return self._finish(LoadResult(
                    "cold", {}, [], None, "not a klba snapshot"
                ))
            version = payload.get("version")
            if version != SNAPSHOT_VERSION:
                # Wrong OR future version: a foreign schema is a clean
                # cold start, never a guess (DEPLOYMENT.md versioning
                # policy).
                return self._finish(LoadResult(
                    "cold", {}, [], None,
                    f"snapshot version {version!r} != {SNAPSHOT_VERSION}",
                ))
            written_at = payload.get("written_at")
            age_s = (
                max(0.0, self._wall() - float(written_at))
                if isinstance(written_at, (int, float)) else None
            )
            sections_in = payload.get("sections")
            if not isinstance(sections_in, dict):
                return self._finish(LoadResult(
                    "cold", {}, [], age_s, "sections block missing"
                ))
            sections: Dict[str, Any] = {}
            for name, entry in sections_in.items():
                try:
                    body = entry["body"]
                    if int(entry["crc32"]) != section_crc(body):
                        raise ValueError("checksum mismatch")
                except Exception:  # noqa: BLE001 — skip + count, per section
                    LOGGER.warning(
                        "snapshot section %r failed verification; "
                        "skipping it (other sections still load)",
                        name, exc_info=True,
                    )
                    skipped.append(str(name))
                    metrics.REGISTRY.counter(
                        "klba_snapshot_sections_skipped_total",
                        {"section": str(name)},
                    ).inc()
                    continue
                sections[str(name)] = body
            if isinstance(written_at, (int, float)):
                with self._lock:
                    if self._last_written_at is None:
                        self._last_written_at = float(written_at)
                        self._last_bytes = len(raw)
            if not sections and skipped:
                return self._finish(LoadResult(
                    "cold", {}, skipped, age_s, "every section corrupt"
                ))
            outcome = "partial" if skipped else "ok"
            return self._finish(
                LoadResult(outcome, sections, skipped, age_s)
            )
        except Exception as exc:  # noqa: BLE001 — fail-open by contract
            LOGGER.warning(
                "snapshot load from %s failed; cold start",
                self.path, exc_info=True,
            )
            return self._finish(
                LoadResult("cold", {}, skipped, None, str(exc))
            )

    def _finish(self, result: LoadResult) -> LoadResult:
        self._m_loads[result.outcome].inc()
        if result.outcome != "ok":
            LOGGER.warning(
                "snapshot load outcome=%s skipped=%s reason=%s",
                result.outcome, result.skipped, result.reason,
            )
        return result

    # -- observability ------------------------------------------------------

    def age_s(self) -> Optional[float]:
        """Seconds since the last KNOWN successful write (this process
        or, after a load, the loaded file's stamp); None before
        either."""
        with self._lock:
            if self._last_written_at is None:
                return None
            return max(0.0, self._wall() - self._last_written_at)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            last = self._last_written_at
            size = self._last_bytes
        return {
            "path": self.path,
            "backend": self.backend.kind,
            "age_s": (
                max(0.0, self._wall() - last) if last is not None else None
            ),
            "bytes": size,
            "writes": self._m_writes["ok"].value,
            "write_errors": self._m_writes["error"].value,
            "writes_fenced": self._m_writes["fenced"].value,
        }


class SnapshotWriter:
    """Background snapshot cadence: one daemon thread writes
    ``collect()``'s sections through ``store`` every ``interval_s``,
    plus soon after any :meth:`mark_churn` (debounced — a registration
    storm coalesces into one write, bounded by ``debounce_s``).  The
    writer never raises (the store's save is fail-open); ``close()``
    stops the thread WITHOUT a final write — the drain path owns the
    final snapshot explicitly, and a crash by definition never gets
    one."""

    def __init__(
        self,
        store: SnapshotStore,
        collect: Callable[[], Dict[str, Any]],
        interval_s: float = 30.0,
        debounce_s: float = 0.2,
    ):
        if interval_s <= 0:
            raise ValueError(f"interval_s={interval_s} must be > 0")
        self._store = store
        self._collect = collect
        self.interval_s = float(interval_s)
        self.debounce_s = min(float(debounce_s), self.interval_s)
        self._cond = threading.Condition()
        self._churn = False
        self._closed = False
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "SnapshotWriter":
        with self._cond:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="klba-snapshot", daemon=True
                )
                self._thread.start()
        return self

    def mark_churn(self) -> None:
        """State changed (stream joined/left/poisoned, membership
        moved): write a snapshot soon, ahead of the cadence."""
        with self._cond:
            self._churn = True
            self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def write_now(self) -> Dict[str, Any]:
        """One synchronous snapshot through the store (the drain's
        final write and the operator's on-demand path).  Runs as a
        self-rooted ``background`` trace (root ``snapshot.write``)
        linked to every stream whose warm state it persisted — lease
        activity inside the store's save lands in the same trace."""
        with metrics.request_scope(
            kind="background", root_name="snapshot.write"
        ):
            try:
                payload = self._collect()
                tr = metrics.current_trace()
                if tr is not None:
                    for sid in (payload.get("streams") or {}):
                        tr.link_stream(sid)
                return self._store.save(payload)
            except Exception as exc:  # noqa: BLE001 — collector fail-open
                LOGGER.warning(
                    "snapshot collection failed; skipping this write",
                    exc_info=True,
                )
                return {"ok": False, "error": str(exc)}

    def _run(self) -> None:
        while True:
            with self._cond:
                if not self._closed and not self._churn:
                    self._cond.wait(self.interval_s)
                if self._closed:
                    return
                churned = self._churn
            if churned:
                # Debounce a churn burst into one write; a close during
                # the debounce still exits without writing (the drain
                # owns the final snapshot).
                with self._cond:
                    self._cond.wait(self.debounce_s)
                    if self._closed:
                        return
                    self._churn = False
            self.write_now()
