"""Host<->device dispatch: map-based API in, batched kernels on device, maps out.

Counterpart of ``assign_device``, ``assign_group_device``,
``assign_topic_device`` and ``_rebuild_topic`` in
``kafka_lag_based_assignor_tpu/ops/dispatch.py``.  Converts the reference
core's signature — ``(Map<topic, List<TopicPartitionLag>>, Map<member,
List<topic>>) -> Map<member, List<TopicPartition>>``
(LagBasedPartitionAssignor.java:166-188) — into packed topic groups
(:mod:`.packing`), runs one batched solve per group (one kernel launch),
and rebuilds per-member partition lists in the reference's append order:
topics in sorted order, partitions within a topic in processing order (lag
descending, partition id ascending, :228-235).

Member-rank convention: per group, subscribed members sorted
lexicographically map to dense kernel indices, so the kernel's integer
tie-break reproduces the reference's member-id string compare (:259).

Backend selection (multi-device): :func:`sharded_solve_manager` is the one
place a large single solve is routed to the P-axis-sharded backend
(:mod:`..sharded.solve`): the active mesh manager, its health and its
single-device-wins row floor gate here.  Single-device is the default and
the degradation target.

The quality router (``tpu.assignor.quality.mode``), the quality tile's
autotune and the per-topic host orchestration of the quality solvers
(:func:`assign_per_topic`) live here too, as in the JAX module.  The knobs
are process-wide, as there.

Each group dispatch fires the ``device.compile`` fault point, where a
first-use kernel build would block, and reports the round-scan kernel's key
form to :func:`observe_pack_shift`, as the JAX module reports its
value-derived static arguments.
"""

from __future__ import annotations

import logging
import threading
from contextlib import contextmanager
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..convert import group_tensors
from ..models.greedy import consumers_per_topic
from ..types import AssignmentMap, TopicPartition, TopicPartitionLag
from ..utils import faults, metrics
from ..utils.config import QUALITY_MODES, validate_quality_tile
from ..utils.device import DeviceLike, resolve_device
from .batched import assign_batched_rounds, assign_batched_scan
from .packing import TopicGroup, build_groups
from .rounds_cuda import rank_bits_for
from .rounds_kernel import assign_global_rounds
from .scan_cuda import host_lag_range
from .scan_kernel import pack_shift_for

LOGGER = logging.getLogger(__name__)

# The last value-derived kernel choice seen per (kernel, lags shape, C) call
# signature.  The round-scan kernel takes one of two key forms by the
# input's value range (:func:`.rounds_cuda.packed_rank_bits`): both give the
# same assignment, but a lag magnitude drifting across the packing bound
# changes the code the card runs, as it changes the executable the JAX
# package compiles, and the change must be observable.
_LAST_PACK_SHIFT: Dict[Tuple, object] = {}


def observe_pack_shift(key: Tuple, shift) -> None:
    """INFO-log changes in value-derived kernel choices per call signature.
    ``shift`` may be a plain pack shift or a tuple (here ``(pack_shift,
    rank_bits)``) — compared structurally, any change counts.  Every
    observed change also bumps the process-wide drift counter
    (utils/observability.static_drift_count), as in the JAX package."""
    prev = _LAST_PACK_SHIFT.get(key)
    if prev is not None and prev != shift:
        from ..utils.observability import note_static_drift

        note_static_drift()
        LOGGER.info(
            "value-derived kernel choice for %s changed %s -> %s (input "
            "value ranges drifted): the round scan runs its other key form",
            key, prev, shift,
        )
    _LAST_PACK_SHIFT[key] = shift


def round_scan_rank_bits(group: TopicGroup, kernel: str) -> int:
    """The key form the round-scan kernel takes for ``group`` with zero
    starting totals (:func:`.rounds_cuda.packed_rank_bits`' rule on the
    numpy inputs): > 0 the packed key's rank bits, 0 the two-key form.
    The bound is each topic's sum of valid lags, or the whole group's for
    ``global`` (its totals carry across topics)."""
    C = group.num_consumers
    live = np.where(group.valid, group.lags, 0)
    if live.size == 0:
        return rank_bits_for(C, 0.0, 0.0)
    sums = live.sum(axis=-1, dtype=np.float64)
    bound = float(sums.sum() if kernel == "global" else sums.max())
    return rank_bits_for(C, bound, min(float(live.min()), 0.0))

# "global" returns a single [C] totals vector (cross-topic) instead of
# [T, C]; the choice/counts contracts are identical across all three.
_BATCHED_KERNELS = {
    "rounds": assign_batched_rounds,
    "scan": assign_batched_scan,
    "global": assign_global_rounds,
}


def _rebuild_topic(
    topic: str,
    members: Sequence[str],
    lags: np.ndarray,
    pids: np.ndarray,
    valid: np.ndarray,
    choice: np.ndarray,
) -> Dict[str, List[TopicPartition]]:
    """Per-member lists for one topic, in processing order, vectorized.

    A stable argsort over the processing-order choice array groups rows per
    consumer while preserving processing order within each consumer.
    """
    P = int(valid.sum())
    lags, pids, choice = lags[:P], pids[:P], choice[:P]
    order = np.lexsort((pids, -lags))
    sorted_choice = choice[order]
    sorted_pids = pids[order]
    grouped = np.argsort(sorted_choice, kind="stable")
    counts = np.bincount(
        sorted_choice[sorted_choice >= 0], minlength=len(members)
    )
    out: Dict[str, List[TopicPartition]] = {}
    pos = int((sorted_choice < 0).sum())  # unassigned rows group first (-1)
    for c, member in enumerate(members):
        rows = grouped[pos : pos + int(counts[c])]
        out[member] = [TopicPartition(topic, int(sorted_pids[i])) for i in rows]
        pos += int(counts[c])
    return out


def assign_group_device(
    group: TopicGroup, kernel: str = "rounds", device: DeviceLike = None,
    refine_iters: int = 0,
):
    """Run one packed topic group through a batched kernel.

    Returns (choice int32[T, P_pad], counts int32[T, C], totals) as tensors
    on ``device``; ``totals`` is per-topic [T, C] for the parity kernels
    ("rounds", "scan") but a single cross-topic [C] vector for "global".
    ``refine_iters`` (0: strict parity; "rounds" and "scan" only) appends
    that many rounds of per-topic exchange refinement.
    """
    # Where a first-use kernel build would block: drills inject their
    # hang or raise here, once a group, as the JAX package does.
    faults.fire("device.compile")
    kernel_fn = _BATCHED_KERNELS[kernel]
    if refine_iters and kernel == "global":
        raise ValueError(
            "refine_iters is per-topic and would undo the 'global' "
            "kernel's cross-topic balance; use kernel='rounds' or 'scan'"
        )
    # Packed single-key sort when the group's value ranges allow, checked
    # on the numpy inputs (padding rows included: they only widen the
    # bound).  The round scans stop after the longest topic's rounds; the
    # P-step scan stops after each topic's valid rows on its own, and takes
    # its key form from the lags' range, known here without a read.
    max_lag = int(group.lags.max()) if group.lags.size else 0
    max_pid = int(group.partition_ids.max()) if group.partition_ids.size else 0
    options = {"pack_shift": pack_shift_for(max_lag, max_pid)}
    if kernel in ("rounds", "global"):
        observe_pack_shift(
            (kernel, group.lags.shape, group.num_consumers),
            (options["pack_shift"], round_scan_rank_bits(group, kernel)),
        )
    if kernel == "scan":
        options["lag_range"] = host_lag_range(group.lags, group.valid.sum(axis=1))
    else:
        options["n_valid"] = int(group.valid.sum(axis=1).max()) if group.valid.size else 0
    if refine_iters:
        options["refine_iters"] = int(refine_iters)
    lags, pids, valid = group_tensors(group, device=device)
    return kernel_fn(lags, pids, valid, num_consumers=group.num_consumers, **options)


def assign_device(
    partition_lag_per_topic: Mapping[str, Sequence[TopicPartitionLag]],
    subscriptions: Mapping[str, Sequence[str]],
    kernel: str = "rounds",
    device: DeviceLike = None,
    refine_iters: Optional[int] = None,
) -> AssignmentMap:
    """Device-backed equivalent of the reference's static core (:166-188):
    full parity including empty members and missing-lag topics, with one
    batched solve per subscriber-set group.  ``device`` defaults to the
    CUDA card (raises without one); ``"cpu"`` runs the plain PyTorch path.

    ``refine_iters`` (default off: strict reference parity) appends that
    many rounds of exchange refinement to each group's solve, the default
    solver's quality mode; only the per-topic kernels ("rounds", "scan")
    take it, since a per-topic refinement would undo "global"'s
    cross-topic balance.
    """
    if kernel not in _BATCHED_KERNELS:
        raise ValueError(
            f"unknown kernel {kernel!r}; valid: {sorted(_BATCHED_KERNELS)}"
        )
    refine = int(refine_iters) if refine_iters else 0
    dev = resolve_device(device)
    assignment: AssignmentMap = {m: [] for m in subscriptions}
    by_topic = consumers_per_topic(subscriptions)
    groups = build_groups(partition_lag_per_topic, by_topic)

    fragments: Dict[str, Dict[str, List[TopicPartition]]] = {}
    for group in groups:
        choice = assign_group_device(
            group, kernel=kernel, device=dev, refine_iters=refine
        )[0]
        choice = choice.cpu().numpy()
        for ti, topic in enumerate(group.topics):
            fragments[topic] = _rebuild_topic(
                topic,
                group.members,
                group.lags[ti],
                group.partition_ids[ti],
                group.valid[ti],
                choice[ti],
            )

    # Merge fragments in global sorted-topic order so per-member list order
    # matches the oracle exactly (topics sorted, then processing order).
    for topic in sorted(fragments):
        for member, tps in fragments[topic].items():
            assignment[member].extend(tps)
    return assignment


def assign_topic_device(
    topic: str,
    consumers: Sequence[str],
    partition_lags: Sequence[TopicPartitionLag],
    kernel: str = "rounds",
    device: DeviceLike = None,
    refine_iters: Optional[int] = None,
) -> Dict[str, List[TopicPartition]]:
    """Single-topic convenience wrapper (degenerate one-topic group)."""
    return assign_device(
        {topic: partition_lags},
        {m: [topic] for m in consumers},
        kernel=kernel,
        device=device,
        refine_iters=refine_iters,
    )


#: "auto" routes the quality solve to the linear-space mode at or above
#: this many (padded) partition rows; below it the dense Sinkhorn path.
LINEAR_AUTO_MIN_ROWS = 32768

# Process-wide quality-plane knobs; tests scope overrides with
# quality_scope.
_QUALITY = {"mode": "auto", "tile": 1024}
_QUALITY_LOCK = threading.Lock()


def normalize_quality_mode(mode) -> str:
    m = str(mode)
    if m not in QUALITY_MODES:
        raise ValueError(
            f"quality mode {mode!r} invalid; choose one of {QUALITY_MODES}"
        )
    return m


def set_quality_mode(mode) -> str:
    """Install the process-wide quality mode."""
    m = normalize_quality_mode(mode)
    with _QUALITY_LOCK:
        _QUALITY["mode"] = m
    return m


def quality_mode() -> str:
    return _QUALITY["mode"]


def set_quality_tile(tile) -> int:
    """Install the process-wide linear-mode tile size (pow2 rows per
    streamed tile — the ``tpu.assignor.quality.tile`` knob)."""
    t = validate_quality_tile(tile)
    with _QUALITY_LOCK:
        _QUALITY["tile"] = t
    return t


def quality_tile() -> int:
    return _QUALITY["tile"]


# How the process-wide tile was last chosen ("default" until an autotune
# runs; then "autotuned" or "cpu-default") and the free memory the choice
# was derived from.
_TILE_SOURCE = {"source": "default", "memory_bytes": None}


def autotune_quality_tile(memory_stats=None, device: DeviceLike = None) -> int:
    """Size ``tpu.assignor.quality.tile`` from the device's free memory
    instead of the static default (the warm-up calls it before the quality
    solves run).  ``memory_stats`` is ``{"bytes_limit", "bytes_in_use"}``
    as the JAX package reads it; None reads the card through
    ``torch.cuda.mem_get_info`` (a CPU device has none).

    Sizing rule, the JAX package's: the linear-OT tile keeps ~3 live
    (tile, C) f32 blocks per step, so the tile is the largest pow2 with
    ``3 * tile * 1024 * 4`` (C sized at the 1000-consumer lane pad) under
    1/8th of the device's free memory.  Without memory statistics (the
    CPU) the static tile stays.  The choice is exported as the gauge
    ``klba_quality_tile_autotuned{source}``."""
    if memory_stats is None:
        dev = resolve_device(device)
        if dev.type == "cuda":
            free, total = torch.cuda.mem_get_info(dev)
            memory_stats = {"bytes_limit": total, "bytes_in_use": total - free}
    if not memory_stats:
        _TILE_SOURCE.update(source="cpu-default", memory_bytes=None)
        metrics.REGISTRY.gauge(
            "klba_quality_tile_autotuned", {"source": "cpu-default"}
        ).set(quality_tile())
        return quality_tile()
    free = int(
        memory_stats.get("bytes_limit", 0)
        - memory_stats.get("bytes_in_use", 0)
    )
    budget = max(free // 8, 1)
    tile = 8
    while tile * 2 <= 65536 and 3 * (tile * 2) * 1024 * 4 <= budget:
        tile *= 2
    chosen = set_quality_tile(tile)
    _TILE_SOURCE.update(source="autotuned", memory_bytes=free)
    metrics.REGISTRY.gauge(
        "klba_quality_tile_autotuned", {"source": "autotuned"}
    ).set(chosen)
    LOGGER.info(
        "quality tile autotuned to %d rows (device free memory %d bytes)",
        chosen, free,
    )
    return chosen


@contextmanager
def quality_scope(mode, tile: Optional[int] = None):
    """Scope a quality mode (and optionally a tile size) to a block; the
    previous knobs are restored even when a setter rejects its value."""
    with _QUALITY_LOCK:
        prev = dict(_QUALITY)
    try:
        set_quality_mode(mode)
        if tile is not None:
            set_quality_tile(tile)
        yield
    finally:
        with _QUALITY_LOCK:
            _QUALITY.update(prev)


def sharded_solve_manager(num_rows: int, num_consumers: int):
    """The active :class:`..sharded.mesh.MeshManager` when the P-axis-sharded
    backend should serve one P-row solve, else None (single device).  One
    global load and a few int compares on the unconfigured path."""
    from ..sharded import mesh as mesh_mod

    mgr = mesh_mod.active_manager()
    if mgr is None or int(num_consumers) < 2:
        return None
    return mgr if mgr.should_shard_solve(num_rows) else None


def resolve_quality_mode(num_rows: int, num_consumers: int) -> str:
    """THE quality-mode router: pinned modes win; "auto" picks linear at
    or above :data:`LINEAR_AUTO_MIN_ROWS` rows (and never for one
    consumer)."""
    mode = _QUALITY["mode"]
    if mode != "auto":
        return mode
    if int(num_consumers) < 2:
        return "sinkhorn"
    if int(num_rows) >= LINEAR_AUTO_MIN_ROWS:
        return "linear"
    return "sinkhorn"


def quality_status(device: DeviceLike = "cpu") -> Dict:
    """The sidecar's ``stats.quality`` section (the JAX package's
    ``ops/dispatch.quality_status``): the mode and tile knobs, how the tile
    was chosen, the "auto" row floor and the last linear solve's record
    (``linear_ot.last_solve_info()``).

    Its ``kernel`` entry states the port's rule, not a probe's verdict:
    the JAX package gates its Pallas duals and digest kernels behind a
    parity-and-speed probe, while here the device decides alone.  On a
    CUDA ``device`` the hand-written kernels serve every call (K4/K5 for
    the linear duals, K6 for the digest), so both entries are True; on the
    CPU the plain PyTorch versions serve, so both are False, the JAX
    gate's answer on a CPU backend."""
    from .linear_ot import last_solve_info

    on_card = torch.device(device).type == "cuda"
    return {
        "mode": quality_mode(),
        "tile": quality_tile(),
        "tile_source": dict(_TILE_SOURCE),
        "auto_min_rows": LINEAR_AUTO_MIN_ROWS,
        "last_linear_solve": last_solve_info(),
        "kernel": dict(duals=on_card, digest=on_card),
    }


def assign_per_topic(
    partition_lag_per_topic: Mapping[str, Sequence[TopicPartitionLag]],
    subscriptions: Mapping[str, Sequence[str]],
    solve_topic,
) -> AssignmentMap:
    """Shared host orchestration for per-topic solvers: dedup + rank
    members, columnarize rows, call ``solve_topic(lags int64[P], pids
    int32[P], num_consumers) -> choice`` (a tensor or array of consumer
    indices in input row order), and rebuild per-member lists with the
    same reference ordering as the batched path."""
    assignment: AssignmentMap = {m: [] for m in subscriptions}
    by_topic = consumers_per_topic(subscriptions)
    for topic in sorted(by_topic):
        members = sorted(set(by_topic[topic]))
        rows = partition_lag_per_topic.get(topic, ())
        if not members or not rows:
            continue
        P = len(rows)
        lags = np.fromiter((r.lag for r in rows), np.int64, count=P)
        pids = np.fromiter((r.partition for r in rows), np.int32, count=P)
        choice = solve_topic(lags, pids, len(members))
        if isinstance(choice, torch.Tensor):
            choice = choice.cpu().numpy()
        frag = _rebuild_topic(
            topic, members, lags, pids, np.ones(P, dtype=bool),
            np.asarray(choice)[:P],
        )
        for member, tps in frag.items():
            assignment[member].extend(tps)
    return assignment
