"""Cross-stream megabatch coalescer: one batched resident dispatch for N
concurrent consumer groups, roster-stable and pipeline-overlapped.

Counterpart of ``kafka_lag_based_assignor_tpu/ops/coalesce.py`` on one
device.  The streaming engine (:mod:`.streaming`) serves one consumer group
a rebalance, and each warm epoch that needs quality work costs one refine
dispatch.  A sidecar serving 32 groups would pay 32 such dispatches a wave
although the epochs are independent and share a shape, so
:class:`MegabatchCoalescer` runs them as one.

Mechanism
---------

The coalescer keeps a queue of pending epochs (:class:`EpochSubmission`:
the exact-shape lag payload, the stream's resident warm state and its
static refine arguments).  A flusher thread admits submissions for a short
window (a full shape group, or a locked roster's whole wave, flushes at
once), groups them by shape key ``(padded P, C, payload dtype, iters,
max_pairs, exchange_budget)`` and runs each multi-row group as one batched
warm core (:func:`_epoch_rows`): the totals re-derived from each row's
table, the batched K6 digest (one launch for the wave's rows,
:func:`.refine.state_digest_rows`) and the batched bulk rounds
(:func:`.refine.refine_rounds_resident_rows`), whose rows stop on their
own and equal the single-stream dispatch bit for bit.  The host-facing
outputs come back in one fetch.

Roster
------

The first wave a stream set serves together RE-STACKS: each stream's
resident ``(choice, row_tab, counts)`` is stacked on a new leading axis.
After ``lock_waves`` consecutive waves of the same stream set the roster
LOCKS: the stacked ``[N, ...]`` successors stay on the device as one
:class:`_ResidentBatch` owned by the coalescer, each engine holds a
:class:`ResidentRow` (batch + stable row) in place of its own tensors, and
every later wave runs on the batch directly (``klba_coalesce_roster_hits_
total``; ``klba_coalesce_restack_total`` stays flat).  PyTorch has no
buffer donation: a locked wave rebinds the batch to the tensors it returns
(:meth:`_ResidentBatch.adopt_resident_buffers`), and a failure after the
wave started poisons the batch as the JAX package's donated batch is
poisoned, so its rows recover through the service's ladder.

A locked wave whose every row carries a delta plan (the engine's host-side
diff) stages ``[N, K]`` (index, value) pairs and scatters them into the
batch's resident ``[N, B]`` lag rows instead of staging ``[N, B]``.  Mixed
waves, re-stack waves, a ``delta.apply`` fault and a row failing the
readback's lag-sum check stage dense (``klba_delta_epochs_total`` counts
each planned epoch's one outcome).

The lock is invalidated exactly once per churn: a stream joined, left, was
poisoned or rebuilt its state.  The churn wave re-stacks (handles of the
frozen old batch materialize their rows, one gather a buffer), and the next
stable wave re-locks.  Padding rows carry zero lags and a 0.0 quality
limit, so they stop before the first round and pass through unchanged.

Pipeline
--------

A flush is upload (two rotating pinned host staging buffers per key, copied
with ``non_blocking=True`` on the coalescer's own CUDA stream; a CUDA event
recorded after the copy is the slot's ``ready``), dispatch, and readback.
With ``pipeline=True`` readback runs on its own thread, so the flusher
returns to admission while a wave is read.  The flusher and readback
threads enter one CUDA device and stream: the service's
(:func:`..utils.device.carry_cuda_context`, passed in), or else those of the
first submitting thread.

Deadlines and isolation
-----------------------

Every submission carries an SLO class, rank and optional deadline
(:mod:`..utils.overload`).  A flush orders rows by (class rank, remaining
deadline); a row whose budget is below the flush-cost EWMA is re-routed to
the inline path (:class:`DeadlineReroute`), an expired one is shed
(:class:`DeadlineShed`), and a row whose waiter was abandoned is dropped
(:class:`SubmitterGone`).  A flush that fails before it dispatches (fault
point ``coalesce.flush``, a gather fault ``coalesce.gather``) re-runs every
row on its own through the card's single-stream dispatch; only a row whose
own dispatch fails sees an error.  A row whose readback digest disagrees
with its submitter's host truth is quarantined
(:class:`..utils.scrub.CorruptStateDetected`) and the roster evicted once.

Builds: no kernel is built on the serving path; the batched K6 entry lives
in the same source as the single-row one (``csrc/state_digest.cu``).

Telemetry: the JAX coalescer's ``klba_coalesce_*`` series, the
``coalesce.window`` / ``.upload`` / ``.dispatch`` / ``.readback`` spans, a
wave-rooted trace linked to every submitting request, and the
``coalesce_flush`` flight record.

Mesh placement (:mod:`..sharded.megabatch`): with an active mesh manager a
roster is placed once, when it locks: on the 2-D ("streams", "p") mesh when
the manager is on that rung and the padded batch covers its S*D devices,
else on the streams mesh, else not at all.  A placed batch holds N/D whole
rows a device (:class:`..sharded.megabatch.RowShards`); a locked wave stages
each row's upload on its device, and each device runs the batched refine on
its own rows with one batched K6 launch for them: D launches a wave, every
row bit-equal to the unplaced wave's.  A ``mesh.collective`` fault before a
placed wave, or a failed placement, dispatch or readback, degrades the
manager one rung (2-D -> streams -> single); the rows in flight resolve
through the single-stream isolation path, and the next stable wave
re-stacks on the placement the manager still offers.
``stats()["stream_sharded_rosters"]`` counts the placed locked rosters.
"""

from __future__ import annotations

import logging
import queue
import threading
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..sharded.megabatch import (
    RowShards,
    place_rows,
    shardable,
    shardable2d,
)
from ..utils import faults, metrics, observability
from ..utils import scrub as scrub_mod
from ..utils.device import DeviceLike, carry_cuda_context, fetch, resolve_device
from ..utils.overload import record_shed
from ..utils.watchdog import SolveRejected
from .batched import _narrow_choice
from .refine import refine_rounds_resident_rows, state_digest_rows
from .streaming import _DELTA_ENTRY_BYTES, _warm_fused_resident

LOGGER = logging.getLogger(__name__)


class SubmitterGone(RuntimeError):
    """A parked submission's waiter abandoned its wait (its watchdog
    deadline passed) before the flush; the row was dropped from the wave
    and this exception unparks the orphaned worker thread."""


class DeadlineShed(SolveRejected):
    """A parked submission's SLO deadline expired before its flush: the row
    was shed without touching the device, so the submitter's warm state is
    intact (the :class:`SolveRejected` contract); the service serves
    ``kept_previous`` and charges no breaker."""


class DeadlineReroute(Exception):
    """Internal marker: the flush re-routed this row to the inline path
    (remaining budget below the flush-cost EWMA).  Never escapes
    :meth:`..ops.streaming.StreamingAssignor.submit_epoch`: the parked
    worker catches it and runs the inline dispatch itself."""


def _resident_totals_rows(lags, row_tab, counts):
    """Per-row per-consumer totals from the resident tables:
    ``.streaming._resident_totals`` over the leading axis."""
    N, B = lags.shape
    M = row_tab.shape[2]
    slot_ok = torch.arange(M, device=lags.device) < counts[:, :, None]
    idx = torch.clamp(row_tab.long(), 0, B - 1)
    vals = lags.gather(1, idx.reshape(N, -1)).reshape(idx.shape)
    return torch.where(slot_ok, vals, 0).sum(dim=2)


def _epoch_rows(lags, choice, row_tab, cnt, limits, num_consumers: int,
                iters: int, max_pairs, exchange_budget: int):
    """The batched warm core of every megabatch dispatch: the single-stream
    warm core (:func:`.streaming._warm_fused_resident` minus its pad, which
    the host already applied) over every row.  The digest audits the state
    each row STARTED from (the batched K6, one launch), then the batched
    bulk rounds run until every row has stopped.

    Returns ``(narrow [N, B], choice int32 [N, B], row_tab [N, C, M],
    counts [N, C], lags int64 [N, B], totals [N, C], rounds int64[N],
    exchanges int64[N], digest int64 [N, 5])``; rounds and exchanges are
    numpy arrays (the loop's own host reads)."""
    lags64 = lags.to(torch.int64)
    totals = _resident_totals_rows(lags64, row_tab, cnt)
    digest = state_digest_rows(lags64, choice, cnt, num_consumers, row_tab)
    choice, row_tab, cnt, totals, rounds, ex = refine_rounds_resident_rows(
        lags64, choice, row_tab, cnt, totals, num_consumers=num_consumers,
        iters=iters, max_pairs=max_pairs, exchange_budget=exchange_budget,
        quality_limits=limits, fan=8,
    )
    narrow = _narrow_choice(choice, num_consumers)
    return (narrow, choice, row_tab, cnt, lags64, totals, rounds, ex, digest)


def _megabatch_fused_resident(lags, choices, row_tabs, counts, limits,
                              num_consumers: int, iters: int, max_pairs,
                              exchange_budget: int):
    """The RE-STACK dispatch: N streams' resident tensors arrive as length-N
    tuples and are stacked on the batch axis (roster establishment and
    churn recovery)."""
    return _epoch_rows(
        lags, torch.stack(choices), torch.stack(row_tabs), torch.stack(counts),
        limits, num_consumers, iters, max_pairs, exchange_budget,
    )


def _megabatch_fused_locked(lags, choice, row_tab, counts, limits,
                            num_consumers: int, iters: int, max_pairs,
                            exchange_budget: int):
    """The LOCKED dispatch: the stacked ``[N, ...]`` batch goes in whole;
    the only upload is the ``[N, B]`` lag staging (each stream's row at its
    stable index) and the ``[N]`` limits.  The inputs are never written, so
    the batch stays valid until the caller rebinds it to the outputs."""
    return _epoch_rows(
        lags, choice, row_tab, counts, limits, num_consumers, iters,
        max_pairs, exchange_budget,
    )


def _placed_wave(fn, args, warm: dict):
    """A locked wave on a placed batch: ``fn`` (a locked dispatch) runs on
    each device's rows (``args`` are :class:`RowShards`, split alike), and
    the host-facing outputs are concatenated in row order on the lead device
    while the resident successors stay split.  Same outputs as ``fn`` on the
    whole batch: every row's refine is its own."""
    outs = [fn(*[a.parts[d] for a in args], **warm) for d in range(len(args[0].parts))]
    lead = outs[0][0].device

    def cat(i):
        return torch.cat([o[i].to(lead) for o in outs])

    def split(i):
        return RowShards([o[i] for o in outs])

    return (cat(0), split(1), split(2), split(3), split(4), cat(5),
            np.concatenate([o[6] for o in outs]),
            np.concatenate([o[7] for o in outs]), cat(8))


def _megabatch_fused_locked_delta(idx, vals, lags, choice, row_tab, counts,
                                  limits, num_consumers: int, iters: int,
                                  max_pairs, exchange_budget: int):
    """The LOCKED DELTA dispatch: the stacked ``[N, K]`` (index, value)
    updates scatter into a copy of the batch's resident ``[N, B]`` lag rows,
    then the batched warm core runs.  A row's padding entries write index
    0's new value (one identical value, written more than once); batch
    padding rows carry (0, 0) onto their zero lag rows."""
    lags = lags.clone()
    lags.scatter_(1, idx.long(), vals)
    return _epoch_rows(
        lags, choice, row_tab, counts, limits, num_consumers, iters,
        max_pairs, exchange_budget,
    )


class EpochResult(NamedTuple):
    """One stream's share of a flush: host-facing outputs on the host, the
    resident successor on the device (a ``(choice, row_tab, counts, lags)``
    tuple on the re-stack path, a :class:`ResidentRow` once the roster
    locks)."""

    narrow: np.ndarray  # int16-ish [B] padded choice (slice [:P] yourself)
    resident: Any
    totals: np.ndarray  # int64 [C]
    counts: np.ndarray  # int32 [C]
    rounds: int
    exchanges: int


class _ResidentBatch:
    """One locked roster's stacked resident warm state: ``choice [n_pad,
    B]``, ``row_tab [n_pad, C, M]``, ``counts [n_pad, C]`` and ``lags int64
    [n_pad, B]``, rebound to their successors on every locked flush.
    ``lock`` serializes that rebinding against a :class:`ResidentRow`
    materializing its row from another thread.  ``valid`` False freezes the
    tensors (an invalidated batch is never rebound again); ``poisoned`` True
    means a flush on it failed, and materialization fails loudly.  ``mesh``
    is the mesh the batch was placed on at lock time (its tensors are then
    :class:`RowShards`), or None."""

    __slots__ = ("shape_key", "choice", "row_tab", "counts", "lags", "n_real",
                 "valid", "poisoned", "lock", "mesh")

    def __init__(self, shape_key, choice, row_tab, counts, lags, n_real: int,
                 mesh=None):
        self.mesh = mesh
        self.shape_key = shape_key
        self.choice = choice
        self.row_tab = row_tab
        self.counts = counts
        self.lags = lags
        self.n_real = int(n_real)
        self.valid = True
        self.poisoned = False
        self.lock = threading.Lock()

    @property
    def n_pad(self) -> int:
        return self.choice.shape[0]

    def adopt_resident_buffers(self, choice, row_tab, counts, lags) -> None:
        """The locked wave's rebinding site (caller holds ``self.lock``):
        the one place outside construction these fields are assigned."""
        self.choice = choice
        self.row_tab = row_tab
        self.counts = counts
        self.lags = lags


class ResidentRow:
    """A stream's resident-state handle while its roster is locked: the
    batch owns the tensors; this names the stream's stable row.  The engine
    keeps it where it kept its own ``(choice, row_tab, counts, lags)`` and
    hands it back on its next submission; :meth:`materialize` (one gather a
    buffer) is paid only when the stream leaves the batch."""

    __slots__ = ("batch", "row")

    def __init__(self, batch: _ResidentBatch, row: int):
        self.batch = batch
        self.row = int(row)

    def matches(self, bucket: int, num_consumers: int, m_rows: int) -> bool:
        """Does this row fit a (bucket, C, M) warm dispatch?"""
        b = self.batch
        return (b.choice.shape[1] == bucket
                and tuple(b.row_tab.shape[1:]) == (num_consumers, m_rows))

    def materialize(self) -> Tuple[Any, Any, Any, Any]:
        """The row's own ``(choice, row_tab, counts, lags)`` tensors (copies:
        the batch may be rebound after).  Fault point ``coalesce.gather``
        fires here (the roster-churn path)."""
        faults.fire("coalesce.gather")
        b = self.batch
        with b.lock:
            if b.poisoned:
                raise RuntimeError(
                    "resident batch was poisoned (a flush on it failed); the "
                    "row's warm state is gone"
                )
            r = self.row
            return (b.choice[r].clone(), b.row_tab[r].clone(),
                    b.counts[r].clone(), b.lags[r].clone())


class _Roster:
    """Per-shape-key roster: the owner set of the last wave, its
    consecutive-wave streak, the locked batch (None until the streak
    reaches ``lock_waves``) and a recency tick for eviction."""

    __slots__ = ("owners", "streak", "batch", "last_used")

    def __init__(self, owners: frozenset):
        self.owners = owners
        self.streak = 1
        self.batch: Optional[_ResidentBatch] = None
        self.last_used = 0


# Retention caps: a locked batch pins its stacked device tensors and a
# staging pair two pinned host buffers; least-recently-used entries past
# the caps are dropped (a dropped batch is invalidated first).
_MAX_ROSTERS = 8
_MAX_STAGING = 16


def _torch_dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else torch.from_numpy(
        np.zeros(0, dtype=np.dtype(dtype))).dtype


class _SlotReady:
    """When a staging slot may be refilled: on the card, once the CUDA event
    recorded after the slot's host-to-device copy has passed (the copy has
    read the pinned buffer); on the CPU at once (the copy is synchronous)."""

    __slots__ = ("event",)

    def __init__(self, cuda: bool):
        self.event = torch.cuda.Event() if cuda else None

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()

    def is_set(self) -> bool:
        return self.event is None or self.event.query()


class _StagingSlot:
    """One of the two rotating host staging buffers of a (shape key, batch
    bucket): lag and limit tensors (pinned on the card) and their
    ``ready``."""

    __slots__ = ("lags", "limits", "ready")

    def __init__(self, n_pad: int, bucket: int, dtype, cuda: bool = False):
        self.lags = torch.zeros((n_pad, bucket), dtype=_torch_dtype(dtype),
                                pin_memory=cuda)
        self.limits = torch.zeros(n_pad, dtype=torch.float64, pin_memory=cuda)
        self.ready = _SlotReady(cuda)


class _DeltaStagingSlot:
    """The rotating staging pair of a locked delta wave: ``[n_pad, K]``
    index and value tensors and the limits, same ``ready`` rule."""

    __slots__ = ("idx", "vals", "limits", "ready")

    def __init__(self, n_pad: int, k: int, cuda: bool = False):
        self.idx = torch.zeros((n_pad, k), dtype=torch.int32, pin_memory=cuda)
        self.vals = torch.zeros((n_pad, k), dtype=torch.int64, pin_memory=cuda)
        self.limits = torch.zeros(n_pad, dtype=torch.float64, pin_memory=cuda)
        self.ready = _SlotReady(cuda)


@dataclass
class EpochSubmission:
    """One stream's pending warm epoch (see the module docstring)."""

    payload: np.ndarray  # exact-shape [P] lags, already dtype-downcast
    bucket: int  # padded refine shape B (the engine's _bucket(P))
    resident: Any  # (choice, row_tab, counts, lags) tuple OR ResidentRow
    limit: float  # device-side quality target (negative disables)
    num_consumers: int
    iters: int
    max_pairs: int
    exchange_budget: int
    scope: Any = None  # metrics.capture_scope() token of the submitter
    owner: Any = None  # stable stream identity (the engine) for rosters
    # SLO placement (utils/overload): rank orders every flush; deadline_at
    # is the absolute registry-clock instant the row's budget expires.
    klass: str = "standard"
    rank: int = 1
    deadline_at: Optional[float] = None
    # "Is the parked waiter already abandoned?" (the submitter's watchdog
    # call, utils/watchdog.capture_abandon_check); None without a watchdog.
    abandoned: Optional[Callable[[], bool]] = None
    # Delta plan (ops/streaming._delta_plan): the raw changed positions and
    # their new int64 values, when the engine planned a delta epoch.
    delta_idx: Optional[np.ndarray] = None
    delta_vals: Optional[np.ndarray] = None
    # Host int64 lag sum (wrapping as the device sums do): the digest's
    # truth and a delta row's divergence check.
    lag_sum: Optional[int] = None
    future: Future = field(default_factory=Future)
    enqueued_at: float = 0.0

    @property
    def shape_key(self) -> Tuple:
        """Everything a batched dispatch needs to agree on."""
        return (self.bucket, self.num_consumers, self.payload.dtype.str,
                self.iters, self.max_pairs, self.exchange_budget)


class MegabatchCoalescer:
    """Admission-window dispatch coalescer (module docstring).

    ``window_s`` is the admission window measured from the oldest pending
    submission; ``max_batch`` pending epochs of one shape (or a locked
    roster's whole wave) flush at once.  ``lock_waves`` consecutive
    identical-stream-set waves lock a roster.  ``pipeline`` False reads
    back inline on the flusher.  ``delta_k`` is the stacked delta wave's K
    (0: every wave stages dense).  ``device`` is where the waves run
    (default the CUDA card, raising without one; ``"cpu"`` the plain path).
    ``mesh_manager`` is the mesh locked rosters are placed over: ``"auto"``
    (the process-wide active manager), a :class:`..sharded.mesh.MeshManager`
    or None (no placement; a mesh-off service must not adopt a co-resident
    instance's mesh).
    ``cuda_context`` is the context factory the flusher and readback
    threads enter (:func:`..utils.device.carry_cuda_context`); None captures
    the first submitting thread's.  The flusher is a daemon thread started
    by the first submission.
    """

    def __init__(
        self,
        window_s: float = 0.0005,
        max_batch: int = 32,
        lock_waves: int = 1,
        pipeline: bool = True,
        delta_k: int = 512,
        mesh_manager="auto",
        device: DeviceLike = None,
        cuda_context=None,
    ):
        if window_s < 0:
            raise ValueError(f"window_s={window_s} must be >= 0")
        if max_batch < 1:
            raise ValueError(f"max_batch={max_batch} must be >= 1")
        if lock_waves < 1:
            raise ValueError(f"lock_waves={lock_waves} must be >= 1")
        if delta_k < 0:
            raise ValueError(f"delta_k={delta_k} must be >= 0")
        self.mesh_manager = mesh_manager
        self.device = resolve_device(device)
        self.window_s = float(window_s)
        self.max_batch = int(max_batch)
        self.lock_waves = int(lock_waves)
        self.pipeline = bool(pipeline)
        self.delta_k = int(delta_k)
        self._cuda = self.device.type == "cuda"
        self._cuda_context = cuda_context
        self._copy_stream = None  # the coalescer's own H2D stream (lazy)
        # Overload backpressure (utils/overload): per-class window scales in
        # rank order (critical, standard, best_effort); plain GIL-atomic
        # writes from the service's admission path.
        self._window_scales = (1.0, 1.0, 1.0)
        # EWMA of a megabatch flush's dispatch-to-readback wall time: the
        # deadline triage's "can this row survive a full flush".
        self._flush_cost_s = 0.0
        self._cond = threading.Condition()
        self._pending: List[EpochSubmission] = []
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._clock = metrics.REGISTRY.clock
        # Rosters are mutated by the flusher and invalidated by a failed
        # readback, so the dict has its own leaf lock; staging is
        # flusher-only.
        self._roster_lock = threading.Lock()
        self._rosters: Dict[Tuple, _Roster] = {}
        self._staging: Dict[Tuple, list] = {}
        self._tick = 0  # flush-group counter driving LRU eviction
        self._rb_q: Optional[queue.Queue] = None
        self._rb_thread: Optional[threading.Thread] = None
        # Drain bookkeeping: waves inside the flusher and readback jobs
        # issued but not finished, under their own leaf condition.
        self._quiesce = threading.Condition()
        self._busy = 0
        self._rb_outstanding = 0
        reg = metrics.REGISTRY
        self._m_batch = reg.histogram("klba_coalesce_batch_size")
        self._m_path = {
            p: reg.counter("klba_coalesce_flushes_total", {"path": p})
            for p in ("megabatch", "single", "fallback")
        }
        self._m_hits = reg.counter("klba_coalesce_roster_hits_total")
        self._m_restack = reg.counter("klba_coalesce_restack_total")
        self._m_invalid = reg.counter("klba_coalesce_roster_invalidations_total")
        self._m_dead = reg.counter("klba_coalesce_dead_rows_total")
        self._m_reroutes = reg.counter("klba_coalesce_deadline_reroutes_total")
        self._m_window_scale = reg.gauge("klba_coalesce_window_scale")
        self._m_window_scale.set(1.0)
        self._m_h2d_dense = reg.counter("klba_h2d_bytes_total", {"path": "dense"})
        self._m_h2d_delta = reg.counter("klba_h2d_bytes_total", {"path": "delta"})
        self._m_delta_applied = reg.counter("klba_delta_epochs_total",
                                            {"outcome": "applied"})
        self._m_delta_fallback = reg.counter("klba_delta_epochs_total",
                                             {"outcome": "fallback"})

    # -- submission --------------------------------------------------------

    def set_window_scale(self, scale: float) -> None:
        """The single-scale form: every class's window to ``window_s *
        scale`` (clamped to [0.05, 1.0]).  Safe from any thread."""
        scale = min(max(float(scale), 0.05), 1.0)
        self.set_window_scales((scale, scale, scale))

    def set_window_scales(self, scales) -> None:
        """Per-class window scales in rank order (critical, standard,
        best_effort), from the overload controller's decision: each parked
        submission's window uses its own class's scale.  Safe from any
        thread."""
        scales = tuple(min(max(float(s), 0.05), 1.0) for s in scales)
        if len(scales) != 3:
            raise ValueError("window scales must be a (crit, std, be) triple")
        if scales == self._window_scales:
            return  # every admitted request calls this; rung 0 pays nothing
        self._window_scales = scales
        self._m_window_scale.set(scales[1])  # the standard class's
        with self._cond:
            self._cond.notify_all()

    def submit(self, sub: EpochSubmission) -> Future:
        """Enqueue one epoch; returns the future its flush resolves.  Raises
        RuntimeError after :meth:`close`.  Fault point ``admit.park``."""
        faults.fire("admit.park")
        with self._cond:
            if self._closed:
                raise RuntimeError("megabatch coalescer is closed")
            sub.enqueued_at = self._clock()
            self._pending.append(sub)
            if self._thread is None:
                if self._cuda_context is None:
                    self._cuda_context = carry_cuda_context(self.device)
                if self.pipeline:
                    # Depth 2 is the double buffer: one wave in readback
                    # while the next uploads; a third backpressures.
                    self._rb_q = queue.Queue(maxsize=2)
                    self._rb_thread = threading.Thread(
                        target=self._readback_loop, name="klba-coalesce-rb",
                        daemon=True,
                    )
                    self._rb_thread.start()
                self._thread = threading.Thread(
                    target=self._run, name="klba-coalesce", daemon=True
                )
                self._thread.start()
            self._cond.notify_all()
        return sub.future

    def stats(self) -> Dict[str, Any]:
        """Roster tracking for the service's ``stats`` answer; the counters
        are process-wide registry reads."""
        with self._roster_lock:
            locked = sum(1 for r in self._rosters.values() if r.batch is not None)
            sharded = sum(1 for r in self._rosters.values()
                          if r.batch is not None and r.batch.mesh is not None)
        return {
            "locked_rosters": locked,
            "stream_sharded_rosters": sharded,
            "roster_hits": self._m_hits.value,
            "restack_flushes": self._m_restack.value,
            "roster_invalidations": self._m_invalid.value,
            "dead_rows_dropped": self._m_dead.value,
        }

    def close(self, timeout_s: Optional[float] = None) -> None:
        """Stop admitting; the flusher flushes what is queued (its futures
        resolve) and exits, then the readback thread.  ``timeout_s`` waits
        up to that long for both threads to end (None: do not wait)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if timeout_s is None:
            return
        for t in (self._thread, self._rb_thread):
            if t is not None and t is not threading.current_thread():
                t.join(timeout_s)

    def drain(self, timeout_s: Optional[float] = 30.0) -> bool:
        """Quiesce for a graceful drain: wait until every admitted
        submission has flushed and every readback completed.  Neither stops
        admissions nor closes.  True when quiet, False on timeout.  Fault
        point ``drain.flush`` fires first and propagates."""
        faults.fire("drain.flush")
        deadline = self._clock() + timeout_s if timeout_s is not None else None
        while not self._quiet():
            remaining = None if deadline is None else deadline - self._clock()
            if remaining is not None and remaining <= 0:
                return False
            with self._quiesce:
                self._quiesce.wait(0.05 if remaining is None else min(0.05, remaining))
        return True

    def _quiet(self) -> bool:
        """No submission parked, no wave in the flusher, no readback
        outstanding (the two locks taken one after the other)."""
        with self._cond:
            pending = len(self._pending)
        with self._quiesce:
            return pending == 0 and self._busy == 0 and self._rb_outstanding == 0

    # -- the flusher -------------------------------------------------------

    def _flush_ready(self) -> bool:
        """Caller holds ``self._cond``: a full shape group, or a locked
        roster whose whole wave is pending, flushes at once."""
        tally: Dict[Tuple, int] = {}
        for s in self._pending:
            tally[s.shape_key] = tally.get(s.shape_key, 0) + 1
        with self._roster_lock:
            for key, n in tally.items():
                if n >= self.max_batch:
                    return True
                roster = self._rosters.get(key)
                if (roster is not None and roster.batch is not None
                        and roster.batch.valid and n >= roster.batch.n_real):
                    return True
        return False

    def _run(self) -> None:
        with self._cuda_context():
            self._run_loop()

    def _run_loop(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._closed:
                    self._cond.wait()
                if not self._pending:
                    if self._rb_q is not None:
                        self._rb_q.put(None)  # drain and stop the readback
                    return
                if not self._closed and self.window_s > 0:
                    # The window runs from each row's own arrival at its
                    # class's scale; the wave flushes at the earliest such
                    # deadline, recomputed at every wake-up.
                    with metrics.span("coalesce.window"):
                        while not self._closed:
                            if self._flush_ready():
                                break
                            scales = self._window_scales
                            deadline = min(
                                s.enqueued_at + self.window_s
                                * scales[s.rank if 0 <= s.rank < 3 else 1]
                                for s in self._pending
                            )
                            remaining = deadline - self._clock()
                            if remaining <= 0:
                                break
                            self._cond.wait(remaining)
                batch, self._pending = self._pending, []
                # Pop and busy-mark in one step under the admission lock,
                # so a drain never sees "nothing pending, flusher idle"
                # while a wave is in hand.
                with self._quiesce:
                    self._busy += 1
            try:
                self._flush(batch)
            except Exception as exc:  # noqa: BLE001 — delivered to waiters
                LOGGER.warning("coalescer flush crashed", exc_info=True)
                for s in batch:
                    if not s.future.done():
                        s.future.set_exception(exc)
            finally:
                with self._quiesce:
                    self._busy -= 1
                    self._quiesce.notify_all()

    def _readback_loop(self) -> None:
        with self._cuda_context():
            while True:
                job = self._rb_q.get()
                if job is None:
                    return
                try:
                    job()
                except Exception:  # noqa: BLE001 — jobs resolve own futures
                    LOGGER.warning("coalescer readback job crashed", exc_info=True)
                finally:
                    with self._quiesce:
                        self._rb_outstanding -= 1
                        self._quiesce.notify_all()

    def _enqueue_readback(self, job: Callable[[], None]) -> None:
        if self._rb_q is None:
            job()  # strict serial: readback on the flusher
        else:
            with self._quiesce:
                self._rb_outstanding += 1
            self._rb_q.put(job)

    def _flush(self, batch: List[EpochSubmission]) -> None:
        # Dead submitters are dropped BEFORE grouping, expired rows shed,
        # and rows whose budget cannot survive a full flush re-routed to
        # the inline path after the waves dispatch.
        now = self._clock()
        live: List[EpochSubmission] = []
        laggards: List[EpochSubmission] = []
        for s in batch:
            abandoned = s.abandoned
            if abandoned is not None and abandoned():
                self._m_dead.inc()
                if not s.future.done():
                    s.future.set_exception(SubmitterGone(
                        "submitter abandoned its wait (deadline passed) "
                        "before the coalesced flush"
                    ))
                continue
            if s.deadline_at is not None:
                remaining = s.deadline_at - now
                if remaining <= 0:
                    record_shed(
                        s.klass, "admit_deadline", None,
                        request_id=(s.scope.request_id if s.scope is not None
                                    else None),
                        scope=s.scope,
                    )
                    if not s.future.done():
                        s.future.set_exception(DeadlineShed(
                            f"{s.klass!r} epoch's deadline budget expired "
                            "while parked for the coalesced flush"
                        ))
                    continue
                if remaining < self._flush_cost_s:
                    self._m_reroutes.inc()
                    laggards.append(s)
                    continue
            live.append(s)
        # SLO placement: (class rank, remaining deadline), stable, so the
        # max_batch chunks below are cut in this order.
        live.sort(key=lambda s: (
            s.rank,
            (s.deadline_at - now) if s.deadline_at is not None else float("inf"),
        ))
        groups: Dict[Tuple, List[EpochSubmission]] = {}
        for s in live:
            groups.setdefault(s.shape_key, []).append(s)
        for group in groups.values():
            # The batch cap holds here too: a group that outgrew max_batch
            # flushes as max_batch chunks.
            for i in range(0, len(group), self.max_batch):
                self._flush_group(group[i: i + self.max_batch])
        for s in laggards:
            if not s.future.done():
                s.future.set_exception(DeadlineReroute(
                    f"{s.klass!r} epoch's remaining budget cannot survive a "
                    "full flush; re-routed to the inline path"
                ))

    def _flush_group(self, rows: List[EpochSubmission]) -> None:
        self._tick += 1
        self._m_batch.observe(len(rows))
        path = "single"
        try:
            faults.fire("coalesce.flush")
            if len(rows) > 1:
                job = self._traced_wave(rows, lambda: self._dispatch_megabatch(rows))
                self._m_path["megabatch"].inc()
                self._enqueue_readback(job)
                return
        except Exception:  # noqa: BLE001 — isolated below, per row
            LOGGER.warning(
                "coalesced flush of %d epoch(s) failed; isolating rows via "
                "single-stream dispatch", len(rows), exc_info=True,
            )
            path = "fallback"
            # The rows leave the batch as tuples through their single
            # dispatches; re-stack and re-lock on the next stable wave.
            self._invalidate(rows[0].shape_key, None)
        self._m_path[path].inc()
        # A delta-planned row on the single dispatch stages dense: its one
        # outcome is a fallback.
        planned = sum(1 for s in rows if s.delta_idx is not None and not s.future.done())
        if planned:
            self._m_delta_fallback.inc(planned)
        for s in rows:
            if not s.future.done():
                self._resolve_single(s)

    # -- roster bookkeeping ------------------------------------------------

    def _invalidate(self, key: Tuple, batch: Optional[_ResidentBatch]) -> None:
        """Drop ``key``'s locked batch (if ``batch`` is given, only while it
        is still THE batch).  Its tensors freeze: handles stay
        materializable."""
        with self._roster_lock:
            roster = self._rosters.get(key)
            if roster is None or roster.batch is None:
                return
            if batch is not None and roster.batch is not batch:
                return
            roster.batch.valid = False
            roster.batch = None
            self._m_invalid.inc()

    def _poison(self, batch: _ResidentBatch) -> None:
        """A flush on this batch failed: materialization now fails loudly
        and the roster is invalidated; the rows recover through the
        engines' ladders."""
        batch.poisoned = True
        self._invalidate(batch.shape_key, batch)

    def _covers(self, batch: _ResidentBatch, rows: List[EpochSubmission]) -> bool:
        """True when this wave IS the locked roster: every submission holds
        a handle of this batch and together they cover every real row once."""
        if not batch.valid or len(rows) != batch.n_real:
            return False
        seen = set()
        for s in rows:
            r = s.resident
            if not isinstance(r, ResidentRow) or r.batch is not batch:
                return False
            seen.add(r.row)
        return seen == set(range(batch.n_real))

    def _note_wave(self, key: Tuple, rows: List[EpochSubmission]) -> Tuple[bool, _Roster]:
        """Streak accounting for a re-stack wave; returns (lock_now,
        roster).  Submissions without an owner key on themselves."""
        owners = frozenset(
            id(s.owner) if s.owner is not None else ("anon", id(s)) for s in rows
        )
        with self._roster_lock:
            roster = self._rosters.get(key)
            if roster is None or roster.owners != owners:
                roster = self._rosters[key] = _Roster(owners)
            else:
                roster.streak += 1
            roster.last_used = self._tick
            if len(self._rosters) > _MAX_ROSTERS:
                stale_key = min((k for k in self._rosters if k != key),
                                key=lambda k: self._rosters[k].last_used)
                stale = self._rosters.pop(stale_key)
                if stale.batch is not None:
                    stale.batch.valid = False
                    self._m_invalid.inc()
            return roster.streak >= self.lock_waves, roster

    @staticmethod
    def _materialize(resident):
        m = getattr(resident, "materialize", None)
        return m() if m is not None else resident

    # -- mesh placement (sharded/megabatch) --------------------------------

    def _mesh_mgr(self):
        if self.mesh_manager != "auto":
            return self.mesh_manager  # an explicit manager, or None = off
        from ..sharded import mesh as mesh_mod

        return mesh_mod.active_manager()

    def _batch_mesh(self, n_pad: int):
        """The mesh a locking batch of ``n_pad`` rows is placed on, most
        capable rung first: the 2-D mesh when the manager is on that rung
        and the batch covers its S*D devices, else the streams mesh when it
        divides the batch, else None."""
        mgr = self._mesh_mgr()
        if mgr is None or not mgr.active:
            return None
        if mgr.mesh2d_available and shardable2d(mgr.mesh2d(), n_pad):
            return mgr.mesh2d()
        if mgr.streams_available and shardable(mgr.streams_mesh(), n_pad):
            return mgr.streams_mesh()
        return None

    def _degrade_mesh(self, reason: str) -> None:
        """A placed wave failed: step the manager one rung down; the rows in
        flight resolve through the single-stream path."""
        mgr = self._mesh_mgr()
        if mgr is not None:
            mgr.degrade(reason)

    def _note_flush_cost(self, started: float, builds_before: int) -> None:
        """EWMA (alpha 0.3) of dispatch-to-readback wall time; a flush that
        built a kernel is left out (it predicts nothing of the next)."""
        if observability.compile_count() != builds_before:
            return
        self._flush_cost_s += 0.3 * ((self._clock() - started) - self._flush_cost_s)

    # -- staging -----------------------------------------------------------

    def _staging_pair(self, k: Tuple, make: Callable[[], Any]):
        """Next of the two rotating staging slots cached under ``k``
        (flusher only)."""
        pair = self._staging.get(k)
        if pair is None:
            pair = self._staging[k] = [make(), make(), 0, self._tick]
            if len(self._staging) > _MAX_STAGING:
                # Evict the stalest idle pair (no copy from it in flight).
                idle = [(p[3], key2) for key2, p in self._staging.items()
                        if key2 != k and p[0].ready.is_set() and p[1].ready.is_set()]
                if idle:
                    self._staging.pop(min(idle)[1])
        pair[3] = self._tick
        slot = pair[pair[2]]
        pair[2] ^= 1
        return slot

    def _staging_slot(self, key: Tuple, n_pad: int, bucket: int, dtype) -> _StagingSlot:
        return self._staging_pair(
            (key, n_pad), lambda: _StagingSlot(n_pad, bucket, dtype, self._cuda)
        )

    def _delta_staging_slot(self, key: Tuple, n_pad: int, k: int) -> _DeltaStagingSlot:
        return self._staging_pair(
            (key, n_pad, "delta"), lambda: _DeltaStagingSlot(n_pad, k, self._cuda)
        )

    def _h2d(self, slot, *hosts):
        """Copy the slot's host tensors to the device.  On the card: device
        tensors allocated on the current (compute) stream, filled with
        non-blocking copies on the coalescer's own stream after it has
        caught up with the compute stream, the slot's event recorded after
        the copies, and the compute stream made to wait for it.  On the CPU:
        copies (the slot is refilled by the next wave)."""
        if not self._cuda:
            return tuple(h.clone() for h in hosts)
        dev = self.device
        compute = torch.cuda.current_stream(dev)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=dev)
        copy = self._copy_stream
        outs = tuple(torch.empty(h.shape, dtype=h.dtype, device=dev) for h in hosts)
        copy.wait_stream(compute)
        with torch.cuda.stream(copy):
            for o, h in zip(outs, hosts):
                o.copy_(h, non_blocking=True)
            slot.ready.event.record(copy)
        compute.wait_event(slot.ready.event)
        return outs

    def _stage_upload(self, rows: List[EpochSubmission], n_pad: int,
                      row_of: Callable[[int], int], mesh=None):
        """Upload stage: fill a rotating staging slot (row placement by
        ``row_of``: wave order for re-stacks, the stable roster index for
        locked waves; pad rows stay zero-lag and 0.0-limit) and start the
        copy; with a placed batch's ``mesh`` each row block goes straight to
        its device (:func:`..sharded.megabatch.place_rows`).  Returns (slot,
        lags_dev, limits_dev)."""
        s0 = rows[0]
        slot = self._staging_slot(s0.shape_key, n_pad, s0.bucket, s0.payload.dtype)
        with metrics.span("coalesce.upload"):
            slot.ready.wait()
            lags_h = slot.lags.numpy()
            limits_h = slot.limits.numpy()
            lags_h[:] = 0
            limits_h[:] = 0.0
            for i, s in enumerate(rows):
                r = row_of(i)
                lags_h[r, : s.payload.shape[0]] = s.payload
                limits_h[r] = s.limit
            self._m_h2d_dense.inc(lags_h.nbytes)
            if mesh is not None:
                lags_dev, limits_dev = place_rows(mesh, slot.lags, slot.limits)
            else:
                lags_dev, limits_dev = self._h2d(slot, slot.lags, slot.limits)
        return slot, lags_dev, limits_dev

    def _stage_delta_upload(self, rows: List[EpochSubmission], n_pad: int,
                            row_of: Callable[[int], int], mesh=None):
        """Delta upload stage (locked waves): fill the ``[n_pad, K]`` pair
        (a row's padding entries write index 0's new value, batch padding
        rows (0, 0)) and start the copy: O(N·K) bytes instead of O(N·B)."""
        s0 = rows[0]
        slot = self._delta_staging_slot(s0.shape_key, n_pad, self.delta_k)
        with metrics.span("coalesce.upload"):
            slot.ready.wait()
            idx_h = slot.idx.numpy()
            vals_h = slot.vals.numpy()
            limits_h = slot.limits.numpy()
            idx_h[:] = 0
            vals_h[:] = 0
            limits_h[:] = 0.0
            for i, s in enumerate(rows):
                r = row_of(i)
                n = s.delta_idx.shape[0]
                idx_h[r, :n] = s.delta_idx
                vals_h[r, :] = int(s.payload[0])
                vals_h[r, :n] = s.delta_vals
                limits_h[r] = s.limit
            self._m_h2d_delta.inc(idx_h.nbytes + vals_h.nbytes)
            if mesh is not None:
                idx_dev, vals_dev, limits_dev = place_rows(
                    mesh, slot.idx, slot.vals, slot.limits)
            else:
                idx_dev, vals_dev, limits_dev = self._h2d(slot, slot.idx, slot.vals,
                                                          slot.limits)
        return slot, idx_dev, vals_dev, limits_dev

    # -- the dispatch ------------------------------------------------------

    def _link_wave(self, wave, rows: List[EpochSubmission]) -> None:
        """Links both ways between the wave's trace and every submitting
        request's trace."""
        wtr = getattr(wave, "trace", None)
        if wtr is None:
            return
        for s in rows:
            tr = getattr(s.scope, "trace", None) if s.scope is not None else None
            if tr is None:
                continue
            wtr.link(tr.trace_id, tr.root_span_id, relation="request")
            tr.link(wtr.trace_id, wtr.root_span_id, relation="wave")

    def _traced_wave(self, rows: List[EpochSubmission],
                     dispatch: Callable[[], Callable[[], None]]) -> Callable[[], None]:
        """Run ``dispatch`` and its readback job under one wave-rooted
        trace that finishes exactly once (on the readback's exit, or here if
        the dispatch raises)."""
        wave = metrics.begin_scope(kind="wave", root_name="coalesce.wave")
        self._link_wave(wave, rows)
        try:
            with metrics.adopt_scope(wave):
                inner = dispatch()
        except Exception:
            metrics.finish_scope(wave)
            raise

        def readback() -> None:
            try:
                with metrics.adopt_scope(wave):
                    inner()
            finally:
                metrics.finish_scope(wave)

        return readback

    def _dispatch_megabatch(self, rows: List[EpochSubmission]) -> Callable[[], None]:
        """Upload and dispatch one multi-row group; returns its readback."""
        key = rows[0].shape_key
        with self._roster_lock:
            roster = self._rosters.get(key)
            batch = roster.batch if roster is not None else None
        if batch is not None and self._covers(batch, rows):
            with self._roster_lock:
                roster.last_used = self._tick
            return self._dispatch_locked(batch, rows)
        if batch is not None:
            # Roster churn: one invalidation, one re-stack, then re-lock.
            self._invalidate(key, batch)
        lock_now, roster = self._note_wave(key, rows)
        return self._dispatch_restack(rows, lock_now, roster)

    def _delta_wave_ok(self, rows: List[EpochSubmission]) -> bool:
        """A locked wave takes the stacked delta path when it is enabled,
        every row carries a plan that fits K, and the padded delta staging
        is smaller than the dense one."""
        s0 = rows[0]
        return (
            self.delta_k > 0
            and all(s.delta_idx is not None and s.delta_idx.shape[0] <= self.delta_k
                    for s in rows)
            and self.delta_k * _DELTA_ENTRY_BYTES < s0.bucket * s0.payload.dtype.itemsize
        )

    def _dispatch_locked(self, batch: _ResidentBatch,
                         rows: List[EpochSubmission]) -> Callable[[], None]:
        started = self._clock()
        builds_before = observability.compile_count()
        s0 = rows[0]
        C = s0.num_consumers
        row_of = lambda i: rows[i].resident.row  # noqa: E731
        warm = dict(num_consumers=C, iters=s0.iters, max_pairs=s0.max_pairs,
                    exchange_budget=s0.exchange_budget)
        if batch.mesh is not None:
            # The placed wave's dispatch boundary: a lost collective degrades
            # the manager and raises before any staging, the batch intact;
            # the flush's isolation path serves every row single-stream and
            # the next stable wave re-stacks on the rung left.
            mgr = self._mesh_mgr()
            if mgr is not None:
                mgr.check_collective()
        delta_wave = False
        if self._delta_wave_ok(rows):
            # The fault point fires before staging: a failure here (or in
            # the staging) stages this wave dense with the batch untouched.
            try:
                faults.fire("delta.apply")
                _, idx_dev, vals_dev, limits_dev = self._stage_delta_upload(
                    rows, batch.n_pad, row_of, mesh=batch.mesh)
                delta_wave = True
            except Exception:  # noqa: BLE001 — dense is the fallback
                LOGGER.warning("stacked delta staging failed; staging this "
                               "wave dense", exc_info=True)
        if not delta_wave:
            _, lags_dev, limits_dev = self._stage_upload(rows, batch.n_pad, row_of,
                                                         mesh=batch.mesh)
            planned = sum(1 for s in rows if s.delta_idx is not None)
            if planned:
                self._m_delta_fallback.inc(planned)
        try:
            with metrics.span("coalesce.dispatch"):
                with batch.lock:
                    if delta_wave:
                        fn = _megabatch_fused_locked_delta
                        args = (idx_dev, vals_dev, batch.lags, batch.choice,
                                batch.row_tab, batch.counts, limits_dev)
                    else:
                        fn = _megabatch_fused_locked
                        args = (lags_dev, batch.choice, batch.row_tab, batch.counts,
                                limits_dev)
                    out = (_placed_wave(fn, args, warm) if batch.mesh is not None
                           else fn(*args, **warm))
                    (narrow, choice_b, tab_b, counts_b, lags_b, totals, rounds,
                     ex, digest) = out
                    batch.adopt_resident_buffers(choice_b, tab_b, counts_b, lags_b)
        except Exception:
            self._poison(batch)
            if batch.mesh is not None:
                self._degrade_mesh("dispatch")
            raise
        self._m_hits.inc()
        self._record_flush(rows, batch.n_pad, roster=True)

        def readback() -> None:
            try:
                with metrics.span("coalesce.readback"):
                    with batch.lock:
                        with metrics.device_phase("megabatch"):
                            narrow_np, totals_np, counts_np, digest_np = fetch(
                                narrow, totals,
                                counts_b.gather() if batch.mesh is not None else counts_b,
                                digest)
                for s in rows:
                    r = s.resident.row
                    if s.future.done():
                        continue
                    if (delta_wave and s.lag_sum is not None
                            and int(totals_np[r].sum()) != s.lag_sum):
                        # The row's resident lags drifted from its
                        # submitter's mirror: it re-syncs through the dense
                        # single dispatch and re-stacks next wave.
                        LOGGER.warning("delta wave row diverged from its host "
                                       "lag sum; re-syncing the row dense")
                        self._m_delta_fallback.inc()
                        scrub_mod.record_quarantine(["lags"], "resynced",
                                                    source="delta_wave")
                        self._resolve_single(s)
                        continue
                    if self._row_digest_failed(s, digest_np[r], batch):
                        if delta_wave:
                            self._m_delta_fallback.inc()
                        continue
                    if delta_wave:
                        self._m_delta_applied.inc()
                    s.future.set_result(EpochResult(
                        narrow=narrow_np[r], resident=s.resident,
                        totals=totals_np[r], counts=counts_np[r],
                        rounds=int(rounds[r]), exchanges=int(ex[r]),
                    ))
                # Chaos injection (device.corrupt.*) at the readback: a
                # seeded bit flip in one locked row of the adopted batch.
                self._corrupt_resident_rows(batch, rows)
            except Exception:  # noqa: BLE001 — per-row outcome below
                LOGGER.warning("locked megabatch readback failed; poisoning the "
                               "resident batch", exc_info=True)
                self._poison(batch)
                if batch.mesh is not None:
                    self._degrade_mesh("readback")
                for s in rows:
                    if not s.future.done():
                        if delta_wave:
                            self._m_delta_fallback.inc()
                        self._resolve_single(s)
            finally:
                self._note_flush_cost(started, builds_before)

        return readback

    def _row_digest_failed(self, s: EpochSubmission, digest_row, batch) -> bool:
        """Per-row integrity gate of a readback: on a mismatch with the
        submitter's host truth the row's result is never served (its future
        fails with CorruptStateDetected) and the roster is evicted once.
        Returns True when the row was quarantined."""
        fails = scrub_mod.digest_failures(digest_row, s.payload.shape[0], s.lag_sum)
        if not fails:
            return False
        LOGGER.warning("megabatch row digest FAILED (%s); quarantining the row "
                       "and evicting the roster", ",".join(fails))
        if batch is not None:
            self._invalidate(batch.shape_key, batch)
        if not s.future.done():
            s.future.set_exception(scrub_mod.CorruptStateDetected(
                f"megabatch row digest mismatch ({','.join(fails)}); row "
                "quarantined — the roster re-stacks and the stream heals from "
                "host truth",
                fails,
            ))
        return True

    def _corrupt_resident_rows(self, batch: _ResidentBatch,
                               rows: List[EpochSubmission]) -> None:
        """Chaos injection site (``device.corrupt.*``) for locked rows: one
        seeded bit of the named stacked tensor flipped in one row of this
        wave's submitters, the host mirror left intact.  One global load
        when no drill is active."""
        if faults.active() is None:
            return
        plan = scrub_mod.corruption_plan(limit=batch.n_real)
        if not plan:
            return
        with batch.lock:
            if not batch.valid or batch.poisoned:
                return
            arrays = {"choice": batch.choice, "row_tab": batch.row_tab,
                      "counts": batch.counts, "lags": batch.lags}
            for buffer, seed in plan:
                rng = np.random.default_rng(seed)
                sub = rows[int(rng.integers(len(rows)))]
                r = sub.resident.row
                limit = None if buffer in ("counts", "row_tab") else sub.payload.shape[0]
                arr = arrays[buffer]
                flipped = scrub_mod.flip_bit(arr[r].cpu().numpy(), seed + 1, limit=limit)
                arr = arr.clone()
                arr[r] = torch.from_numpy(flipped).to(arr.device)
                arrays[buffer] = arr
                LOGGER.warning("injected device.corrupt.%s bit flip into locked "
                               "row %d (seed %d)", buffer, r, seed)
            batch.adopt_resident_buffers(arrays["choice"], arrays["row_tab"],
                                         arrays["counts"], arrays["lags"])

    def _dispatch_restack(self, rows: List[EpochSubmission], lock_now: bool,
                          roster: _Roster) -> Callable[[], None]:
        started = self._clock()
        builds_before = observability.compile_count()
        s0 = rows[0]
        N = len(rows)
        # Batch axis padded to a power of two; padding rows cycle the
        # surviving rows' tensors at zero lags and a 0.0 limit.
        n_pad = 1 << (N - 1).bit_length()
        residents = [self._materialize(s.resident) for s in rows]
        padded = residents + [residents[i % N] for i in range(n_pad - N)]
        _, lags_dev, limits_dev = self._stage_upload(rows, n_pad, lambda i: i)
        with metrics.span("coalesce.dispatch"):
            out = _megabatch_fused_resident(
                lags_dev, tuple(r[0] for r in padded), tuple(r[1] for r in padded),
                tuple(r[2] for r in padded), limits_dev,
                num_consumers=s0.num_consumers, iters=s0.iters,
                max_pairs=s0.max_pairs, exchange_budget=s0.exchange_budget,
            )
        self._m_restack.inc()
        planned = sum(1 for s in rows if s.delta_idx is not None)
        if planned:
            self._m_delta_fallback.inc(planned)
        (narrow, choice_b, tab_b, counts_b, lags_b, totals, rounds, ex,
         digest) = out
        batch: Optional[_ResidentBatch] = None
        handles: Optional[List[ResidentRow]] = None
        if lock_now:
            # The roster locks: this wave's stacked successors become the
            # resident batch and the rows' ownership moves to it.  With an
            # active mesh they are placed over it here, once a lock (the 2-D
            # mesh when the rung and the batch allow, else the streams mesh);
            # a failed placement locks single-device and degrades the manager.
            placed = (choice_b, tab_b, counts_b, lags_b)
            mesh = self._batch_mesh(n_pad)
            if mesh is not None:
                try:
                    placed = place_rows(mesh, *placed)
                except Exception:  # noqa: BLE001 — single-device locks
                    LOGGER.warning("placement on the %s mesh failed; locking the roster "
                                   "on one device", dict(mesh.shape), exc_info=True)
                    self._degrade_mesh("place")
                    placed, mesh = (choice_b, tab_b, counts_b, lags_b), None
            batch = _ResidentBatch(s0.shape_key, *placed, n_real=N, mesh=mesh)
            handles = [ResidentRow(batch, i) for i in range(N)]
            with self._roster_lock:
                roster.batch = batch
        self._record_flush(rows, n_pad, roster=False)

        def readback() -> None:
            try:
                with metrics.span("coalesce.readback"):
                    with metrics.device_phase("megabatch"):
                        narrow_np, totals_np, counts_np, digest_np = fetch(
                            narrow, totals, counts_b, digest)
                for i, s in enumerate(rows):
                    if s.future.done():
                        continue
                    if self._row_digest_failed(s, digest_np[i], batch):
                        continue
                    resident = (handles[i] if handles is not None
                                else (choice_b[i].clone(), tab_b[i].clone(),
                                      counts_b[i].clone(), lags_b[i].clone()))
                    s.future.set_result(EpochResult(
                        narrow=narrow_np[i], resident=resident,
                        totals=totals_np[i], counts=counts_np[i],
                        rounds=int(rounds[i]), exchanges=int(ex[i]),
                    ))
            except Exception:  # noqa: BLE001 — per-row outcome below
                LOGGER.warning("megabatch readback failed; isolating rows via "
                               "single-stream dispatch", exc_info=True)
                if batch is not None:
                    self._poison(batch)
                for s in rows:
                    if not s.future.done():
                        self._resolve_single(s)
            finally:
                self._note_flush_cost(started, builds_before)

        return readback

    def _record_flush(self, rows: List[EpochSubmission], n_pad: int,
                      roster: bool) -> None:
        s0 = rows[0]
        metrics.FLIGHT.record("coalesce_flush", {
            "streams": len(rows),
            "padded_rows": n_pad,
            "bucket": s0.bucket,
            "consumers": s0.num_consumers,
            "roster_locked": roster,
            "classes": [s.klass for s in rows],
            "request_ids": [s.scope.request_id for s in rows if s.scope is not None],
            "trace_ids": [
                s.scope.trace.trace_id for s in rows
                if s.scope is not None and getattr(s.scope, "trace", None) is not None
            ],
        })

    def _resolve_single(self, s: EpochSubmission) -> None:
        """One epoch on the card's single-stream resident dispatch (the
        single-row flush and the per-row isolation path).  A handle
        materializes its row first.  Never raises: the result or the row's
        own exception lands on the future, under the submitter's scope."""
        with metrics.adopt_scope(s.scope):
            try:
                choice, row_tab, counts = self._materialize(s.resident)[:3]
                self._m_h2d_dense.inc(s.payload.nbytes)
                payload = torch.from_numpy(np.ascontiguousarray(s.payload)).to(
                    choice.device)
                out = _warm_fused_resident(
                    payload, choice, row_tab, counts, s.limit,
                    num_consumers=s.num_consumers, iters=s.iters,
                    max_pairs=s.max_pairs, exchange_budget=s.exchange_budget,
                )
                (narrow, choice_p, row_tab, counts, lags_p, totals, rounds, ex,
                 digest) = out
                narrow_np, digest_np, totals_np, counts_np = fetch(
                    narrow, digest, totals, counts)
                if self._row_digest_failed(s, digest_np, None):
                    return
                s.future.set_result(EpochResult(
                    narrow=narrow_np, resident=(choice_p, row_tab, counts, lags_p),
                    totals=totals_np, counts=counts_np, rounds=int(rounds),
                    exchanges=int(ex),
                ))
            except Exception as exc:  # noqa: BLE001 — the row's own error
                LOGGER.warning("coalesced single-row dispatch failed", exc_info=True)
                s.future.set_exception(exc)
