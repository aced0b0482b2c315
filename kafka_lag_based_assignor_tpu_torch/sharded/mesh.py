"""Mesh manager: discover and validate the device mesh ONCE at service start.

Counterpart of ``kafka_lag_based_assignor_tpu/sharded/mesh.py``.  The P axis
of one large solve shards over the mesh (:mod:`.solve`), and the topic-axis
batch backend lives in :mod:`.topics`.  This module owns the topology
decisions those paths share:

* **One process drives the mesh.**  The JAX package runs a ``Mesh`` from one
  controller (``shard_map`` runs every shard's body in one process); here a
  mesh is an ordered list of ``torch.device`` s, a sharded array a list of
  per-shard tensors, and the collectives (:mod:`.collectives`) plain
  functions over such lists.  The manager, its degrade ladder, the
  :func:`dispatch_gate` lock and the sidecar's threads all assume one
  process, as in the JAX package.
* **Discovery and validation at start, not per request.**  The sidecar (or a
  library embedder) builds one :class:`MeshManager` from the
  ``tpu.assignor.mesh.devices`` knob ("off" | "auto" | an integer), calls
  :meth:`MeshManager.configure` once, and :func:`activate` installs it as the
  process-wide backend selection input.  The visible devices are the CUDA
  cards (:func:`visible_devices`) or, when set, N **virtual shards** on one
  base device: the counterpart of XLA's forced host device count, from the
  ``KLBA_VIRTUAL_SHARDS`` environment variable (``"N"``, ``"N:cpu"``,
  ``"N:cuda:0"``; read at :meth:`MeshManager.configure`) or
  :func:`set_virtual_shards`.  Every sharded path then runs on one card (or
  the CPU, in the tests), each shard's tensors on the base device.
* **Cross-axis composition** (``tpu.assignor.mesh.shape``): the device set
  can also factor as a 2-D ("streams", "p") mesh; ``"auto"`` picks the most
  square (S, D) split favouring "p", ``"SxD"`` pins it, and a shape the
  device count cannot satisfy falls back to the 1-D rung at boot.  The
  coalescer places locked rosters on it (:mod:`.megabatch`), and a stream's
  resident state goes over its "p" axis (:mod:`.resident`).
* **Single-device is the default AND the degradation target**, reached down
  :data:`LADDER` one rung at a time on a lost device, a ``mesh.collective``
  fault or a sharded dispatch that raises; 1-D configurations drop straight
  to single.  Observable as ``klba_mesh_active`` / ``klba_mesh_devices`` /
  ``klba_mesh_shape{axis}``, ``klba_mesh_degraded_total{reason}`` and
  ``klba_mesh_degrade_total{from,to}``.
"""

from __future__ import annotations

import logging
import os
import threading
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import faults, metrics

LOGGER = logging.getLogger(__name__)

#: Axis names: the P-sharded solve splits partition rows over "p"; the
#: megabatch spreads tenant rows over "streams".  The 2-D mesh composes
#: both, axis order ("streams", "p").
SOLVE_AXIS = "p"
STREAMS_AXIS = "streams"

#: The degrade ladder of a 2-D mesh, least to most degraded; each fault
#: steps one rung.  1-D configurations use ("1d", "single").
LADDER: Tuple[str, ...] = ("2d", "streams", "p", "single")

#: Rungs where each sharded capability remains available.
_SOLVE_RUNGS = frozenset(("2d", "1d", "p"))
_STREAMS_RUNGS = frozenset(("2d", "1d", "streams"))

#: Default P floor below which a single device wins outright
#: (``tpu.assignor.mesh.solve.min.rows``).
DEFAULT_SOLVE_MIN_ROWS = 65536

#: The environment variable that sets virtual shards (read at configure()).
VIRTUAL_SHARDS_ENV = "KLBA_VIRTUAL_SHARDS"

# One collective program in flight at a time: the program already uses
# every shard, and the sidecar's request threads must not interleave two.
# Re-entrant so a gated entry may call another (cold solve -> sharded tail).
_DISPATCH_GATE = threading.RLock()

# Set by set_virtual_shards(); wins over the environment variable.
_VIRTUAL: Optional[Tuple[int, torch.device]] = None


def dispatch_gate() -> threading.RLock:
    """The process-wide collective-dispatch gate: every entry that runs a
    multi-shard program (``solve_sharded``, ``refine_sharded``,
    ``solve_linear_sharded``, ``plan_stats_sharded``) holds it for its
    dispatch."""
    return _DISPATCH_GATE


class MeshCollectiveError(RuntimeError):
    """A sharded dispatch lost a collective (the ``mesh.collective`` fault or
    a real failure): the manager has already degraded one rung; the caller
    serves this request down its single-device ladder."""


def set_virtual_shards(count: Optional[int], device: Any = "cuda") -> None:
    """Make :func:`visible_devices` answer ``count`` virtual shards on
    ``device`` (None restores the environment / the real cards).  The tests
    call it with ``device="cpu"``, as the JAX tests force 8 host devices."""
    global _VIRTUAL
    if count is None:
        _VIRTUAL = None
        return
    if int(count) < 1:
        raise ValueError(f"virtual shard count {count} must be >= 1")
    _VIRTUAL = (int(count), _base_device(device))


def _base_device(device: Any) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"virtual shards live on cuda or cpu, not {dev}")
    return dev


def virtual_shards() -> Optional[Tuple[int, torch.device]]:
    """``(count, base device)`` of the virtual shards in force, or None:
    :func:`set_virtual_shards` first, else ``KLBA_VIRTUAL_SHARDS``."""
    if _VIRTUAL is not None:
        return _VIRTUAL
    raw = os.environ.get(VIRTUAL_SHARDS_ENV, "").strip()
    if not raw:
        return None
    count, _, device = raw.partition(":")
    try:
        n = int(count)
    except ValueError:
        raise ValueError(
            f"{VIRTUAL_SHARDS_ENV}={raw!r} invalid; use 'N', 'N:cpu' or "
            "'N:cuda:0'"
        )
    if n < 1:
        raise ValueError(f"{VIRTUAL_SHARDS_ENV}={raw!r}: N must be >= 1")
    return n, _base_device(device or "cuda")


def visible_devices() -> List[torch.device]:
    """The devices a mesh may take (``jax.devices()`` of the JAX package):
    the virtual shards when set, else every CUDA card (none without one)."""
    virtual = virtual_shards()
    if virtual is not None:
        n, base = virtual
        return [base] * n
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """A named grid of devices (the JAX ``Mesh``): ``devices`` an object
    array of ``torch.device`` shaped by the axes, ``axis_names``, and
    ``shape`` the axis sizes by name, so ``mesh.shape["p"]`` reads as in
    the JAX package.  Virtual shards repeat one device."""

    def __init__(self, devices: Any, axis_names: Sequence[str]):
        flat = list(np.asarray(devices, dtype=object).reshape(-1))
        grid = np.empty(len(flat), dtype=object)
        grid[:] = flat
        self.devices = grid.reshape(np.shape(devices))
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"mesh of shape {self.devices.shape} needs "
                f"{self.devices.ndim} axis names, got {self.axis_names}"
            )
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_list(self) -> List[torch.device]:
        """The devices in row-major order (shard d of a 1-D mesh is [d])."""
        return list(self.devices.reshape(-1))

    @property
    def virtual(self) -> bool:
        """True when several shards share one device."""
        return len(set(self.device_list)) < self.size

    def __repr__(self) -> str:
        kind = ", virtual" if self.virtual else ""
        return f"Mesh({self.shape}{kind})"


def _parse_spec(spec: Any) -> Any:
    """``"off"`` | ``"auto"`` | positive int (accepts int-like strings)."""
    if spec in (None, "", "off", "0", 0, False):
        return "off"
    if spec == "auto":
        return "auto"
    try:
        n = int(spec)
    except (TypeError, ValueError):
        raise ValueError(
            f"mesh devices spec {spec!r} invalid; use 'off', 'auto', or "
            "a positive integer"
        )
    if n < 1:
        raise ValueError(f"mesh devices spec {n} must be >= 1")
    return n


def _parse_shape(spec: Any) -> Any:
    """``"off"`` | ``"auto"`` | an ``"SxD"`` string / (S, D) pair."""
    if spec in (None, "", "off", "0", 0, False):
        return "off"
    if spec == "auto":
        return "auto"
    if isinstance(spec, str):
        parts = spec.lower().replace("*", "x").split("x")
        if len(parts) != 2:
            raise ValueError(
                f"mesh shape spec {spec!r} invalid; use 'off', 'auto', "
                "or 'SxD' (e.g. '2x4')"
            )
        spec = parts
    try:
        s, d = (int(v) for v in spec)
    except (TypeError, ValueError):
        raise ValueError(
            f"mesh shape spec {spec!r} invalid; use 'off', 'auto', or "
            "'SxD' (e.g. '2x4')"
        )
    if s < 1 or d < 1:
        raise ValueError(f"mesh shape {s}x{d}: both axes must be >= 1")
    return (s, d)


def auto_shape(n: int) -> Tuple[int, int]:
    """The ``"auto"`` (S, D) factorization of ``n`` devices: the most square
    split favouring the "p" axis (D >= S) — 8 -> (2, 4), 4 -> (2, 2),
    2 -> (1, 2), primes -> (1, n)."""
    s = int(int(n) ** 0.5)
    while s > 1 and n % s:
        s -= 1
    return (max(s, 1), n // max(s, 1))


class MeshManager:
    """One process's device-mesh topology and health state (the JAX
    manager's knobs and ladder).

    ``devices`` is ``"off"`` (never shard), ``"auto"`` (all visible devices;
    inactive when only one is visible) or an integer N (exactly the first N;
    fewer visible degrades at boot instead of raising).  ``shape`` is
    ``"off"``, ``"auto"`` or ``"SxD"``; ``solve_min_rows`` gates the
    P-sharded solve.
    """

    def __init__(
        self,
        devices: Any = "auto",
        solve_min_rows: int = DEFAULT_SOLVE_MIN_ROWS,
        shape: Any = "off",
    ):
        self.spec = _parse_spec(devices)
        self.shape_spec = _parse_shape(shape)
        self.solve_min_rows = int(solve_min_rows)
        self._lock = threading.Lock()
        self._devices: List[torch.device] = []
        self._degraded: Optional[str] = None
        self._configured = False
        self._virtual = False
        self._rung = "single"
        self._shape: Optional[Tuple[int, int]] = None
        self._solve_mesh: Optional[Mesh] = None
        self._streams_mesh: Optional[Mesh] = None
        self._mesh2d: Optional[Mesh] = None
        self._m_active = metrics.REGISTRY.gauge("klba_mesh_active")
        self._m_devices = metrics.REGISTRY.gauge("klba_mesh_devices")

    # -- discovery ----------------------------------------------------------

    def configure(self) -> "MeshManager":
        """Discover and validate the mesh (once at service start, never per
        request).  A spec the visible devices cannot satisfy degrades to
        single-device instead of raising; an unsatisfiable 2-D shape falls
        back to the 1-D rung; calling again re-validates."""
        with self._lock:
            self._configured = True
            if self.spec == "off":
                self._install([], None, "single")
                return self
            visible = visible_devices()
            self._virtual = virtual_shards() is not None
            want = len(visible) if self.spec == "auto" else int(self.spec)
            if want < 2:
                # One device is not a mesh: quietly single-device.
                self._install([], None, "single")
                return self
            if len(visible) < want:
                LOGGER.warning(
                    "mesh.devices=%s but only %d device(s) visible; "
                    "degrading to the single-device backend",
                    self.spec, len(visible),
                )
                self._install([], "missing_devices", "single")
                return self
            devices = visible[:want]
            rung, shape = "1d", None
            if self.shape_spec != "off":
                shape = (
                    auto_shape(want)
                    if self.shape_spec == "auto" else self.shape_spec
                )
                if shape[0] * shape[1] != want:
                    LOGGER.warning(
                        "mesh.shape=%dx%d does not factor %d device(s); "
                        "falling back to the 1-D rung",
                        shape[0], shape[1], want,
                    )
                    shape = None
                else:
                    rung = "2d"
            self._install(devices, None, rung, shape)
            LOGGER.info(
                "device mesh configured: %d %s on %s (rung %s%s)",
                want,
                "virtual shard(s)" if self._virtual else "device(s)",
                visible[0], rung,
                f", shape {shape[0]}x{shape[1]}" if shape else "",
            )
        return self

    def _install(
        self,
        devices: List[torch.device],
        degraded: Optional[str],
        rung: str,
        shape: Optional[Tuple[int, int]] = None,
    ) -> None:
        """Caller holds the lock: adopt a device set (or none) at one ladder
        rung and rebuild the cached axis meshes."""
        self._devices = devices
        self._degraded = degraded
        self._rung = rung if devices else "single"
        self._shape = shape if (devices and rung == "2d") else None
        self._solve_mesh = (
            Mesh(devices, (SOLVE_AXIS,))
            if devices and rung in _SOLVE_RUNGS else None
        )
        self._streams_mesh = (
            Mesh(devices, (STREAMS_AXIS,))
            if devices and rung in _STREAMS_RUNGS else None
        )
        self._mesh2d = None
        if self._shape is not None:
            grid = np.empty(len(devices), dtype=object)
            grid[:] = devices
            self._mesh2d = Mesh(grid.reshape(self._shape),
                                (STREAMS_AXIS, SOLVE_AXIS))
        if degraded is not None:
            metrics.REGISTRY.counter(
                "klba_mesh_degraded_total", {"reason": degraded}
            ).inc()
        self._m_active.set(1 if self.active else 0)
        self._m_devices.set(len(devices))
        s, d = self._shape if self._shape else (0, 0)
        metrics.REGISTRY.gauge("klba_mesh_shape", {"axis": STREAMS_AXIS}).set(s)
        metrics.REGISTRY.gauge("klba_mesh_shape", {"axis": SOLVE_AXIS}).set(d)

    # -- selection ----------------------------------------------------------

    @property
    def active(self) -> bool:
        """True while ANY sharded backend may be selected."""
        return bool(self._devices) and self._rung != "single"

    @property
    def rung(self) -> str:
        """The current ladder rung ("2d" | "streams" | "p" | "single", or
        "1d" for shape-off configurations)."""
        return self._rung

    @property
    def size(self) -> int:
        return len(self._devices) if self.active else 0

    @property
    def mesh_shape(self) -> Optional[Tuple[int, int]]:
        """The active (S, D) factorization, or None below the 2-D rung."""
        return self._shape

    @property
    def virtual(self) -> bool:
        """True when the configured devices are virtual shards."""
        return self._virtual

    def solve_mesh(self) -> Mesh:
        """The 1-D ("p",) mesh of the P-sharded solve."""
        m = self._solve_mesh
        if m is None or not self.active:
            raise RuntimeError("mesh manager is not active")
        return m

    def streams_mesh(self) -> Mesh:
        """The 1-D ("streams",) mesh of the megabatch placement."""
        m = self._streams_mesh
        if m is None or not self.active:
            raise RuntimeError("mesh manager is not active")
        return m

    def mesh2d(self) -> Mesh:
        """The 2-D ("streams", "p") mesh (the "2d" rung only)."""
        m = self._mesh2d
        if m is None or not self.active:
            raise RuntimeError("mesh manager is not on the 2-D rung")
        return m

    @property
    def solve_available(self) -> bool:
        return self.active and self._solve_mesh is not None

    @property
    def streams_available(self) -> bool:
        return self.active and self._streams_mesh is not None

    @property
    def mesh2d_available(self) -> bool:
        return self.active and self._mesh2d is not None

    def should_shard_solve(self, num_rows: int) -> bool:
        """The "p" capability live at the current rung AND the row count at
        or above the single-device-wins floor."""
        return self.solve_available and int(num_rows) >= self.solve_min_rows

    # -- degradation --------------------------------------------------------

    def check_collective(self) -> None:
        """The ``mesh.collective`` fault point for a caller about to enter a
        sharded dispatch: a firing plan degrades the manager one rung and
        raises :class:`MeshCollectiveError`."""
        try:
            faults.fire("mesh.collective")
        except Exception as exc:
            self.degrade("collective")
            raise MeshCollectiveError(
                "mesh collective failed; degraded one rung toward the "
                "single-device backend"
            ) from exc

    def degrade(self, reason: str) -> None:
        """Step ONE rung down the ladder (2-D: 2d -> streams -> p -> single;
        1-D: straight to single).  Idempotent at the bottom; :meth:`restore`
        / :meth:`configure` re-arm."""
        with self._lock:
            if not self._devices or self._rung == "single":
                return
            frm = self._rung
            nxt = {"2d": "streams", "streams": "p"}.get(frm, "single")
            LOGGER.warning(
                "device mesh degraded (%s): rung %s -> %s", reason, frm, nxt,
            )
            metrics.REGISTRY.counter(
                "klba_mesh_degrade_total", {"from": frm, "to": nxt}
            ).inc()
            if nxt == "single":
                self._install([], reason, "single")
            else:
                metrics.REGISTRY.counter(
                    "klba_mesh_degraded_total", {"reason": reason}
                ).inc()
                self._install(self._devices, None, nxt)
                self._degraded = reason

    def restore(self) -> "MeshManager":
        """Re-validate after an operator fixed the topology."""
        return self.configure()

    def status(self) -> Dict[str, Any]:
        """The sidecar's ``stats.mesh`` section: the JAX manager's keys, and
        ``virtual`` (True when the devices are virtual shards)."""
        return {
            "spec": self.spec,
            "configured": self._configured,
            "active": self.active,
            "devices": len(self._devices),
            "degraded": self._degraded,
            "solve_min_rows": self.solve_min_rows,
            "shape": (
                f"{self._shape[0]}x{self._shape[1]}" if self._shape else None
            ),
            "rung": self._rung,
            "virtual": self._virtual,
        }


# The active manager: ONE global load + None compare when no mesh is
# configured (the faults._ACTIVE pattern).
_ACTIVE: Optional[MeshManager] = None


def active_manager() -> Optional[MeshManager]:
    return _ACTIVE


def activate(manager: MeshManager) -> MeshManager:
    global _ACTIVE
    _ACTIVE = manager
    return manager


def deactivate(manager: Optional[MeshManager] = None) -> None:
    """Clear the active manager (with ``manager``, only while it is still the
    installed one: a stopping sidecar must not clobber a replacement's)."""
    global _ACTIVE
    if manager is None or _ACTIVE is manager:
        _ACTIVE = None


@contextmanager
def managed(manager: MeshManager) -> Iterator[MeshManager]:
    """Scope an active manager to a block (tests, probes)."""
    activate(manager)
    try:
        yield manager
    finally:
        deactivate(manager)
