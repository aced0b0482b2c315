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

The quality router (``tpu.assignor.quality.mode``) and the per-topic host
orchestration of the quality solvers (:func:`assign_per_topic`) live here
too, as in the JAX module.  The knobs are process-wide, as there.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from ..convert import group_tensors
from ..models.greedy import consumers_per_topic
from ..types import AssignmentMap, TopicPartition, TopicPartitionLag
from ..utils.config import QUALITY_MODES, validate_quality_tile
from ..utils.device import DeviceLike, resolve_device
from .batched import assign_batched_rounds, assign_batched_scan
from .packing import TopicGroup, build_groups
from .rounds_kernel import assign_global_rounds
from .scan_kernel import pack_shift_for

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
    kernel_fn = _BATCHED_KERNELS[kernel]
    if refine_iters and kernel == "global":
        raise ValueError(
            "refine_iters is per-topic and would undo the 'global' "
            "kernel's cross-topic balance; use kernel='rounds' or 'scan'"
        )
    # Packed single-key sort when the group's value ranges allow, checked
    # on the numpy inputs (padding rows included: they only widen the
    # bound).  The round scans stop after the longest topic's rounds; the
    # P-step scan stops after each topic's valid rows on its own.
    max_lag = int(group.lags.max()) if group.lags.size else 0
    max_pid = int(group.partition_ids.max()) if group.partition_ids.size else 0
    options = {"pack_shift": pack_shift_for(max_lag, max_pid)}
    if kernel != "scan":
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
