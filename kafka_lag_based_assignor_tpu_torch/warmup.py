"""Boot-time warm-up: build every kernel and run every solve path once
before serving.

Counterpart of ``kafka_lag_based_assignor_tpu/warmup.py``.  A rebalance is
on the consumer group's critical path, and in a fresh process its first
solve builds the kernels it launches with ``nvcc`` (about 40 s for the
round scan's source) inside the group's stall.  The warm-up moves that
cost to startup (the plugin's ``configure()`` with
``tpu.assignor.warmup.shapes``, the sidecar's ``start()`` with
``warmup_shapes`` and after a recovery).  Here "warm" means:

1. ``ops/_build.build_all()`` on the card (every ``nvcc`` started together)
   and the ``native`` core's ``g++`` build;
2. ``ops/dispatch.autotune_quality_tile`` (the quality tile sized from the
   device's free memory, before any quality job runs) and
   ``install_compile_counter()``, so that a deployment can assert that
   ``compile_count()`` moves by 0 from here on;
3. one run of each job the JAX warm-up builds for the solvers asked for, on
   synthetic data, through the entry points the rebalance path uses, so
   every host path, scratch buffer and key form is touched once.

Usage (at startup, not inside a rebalance)::

    from kafka_lag_based_assignor_tpu_torch.warmup import warmup
    rows = warmup(max_partitions=100_000, consumers=[1000], topics=[1])

With ``coalesce_max_batch > 1`` the "stream" solver also drives the
megabatch coalescer (:mod:`.ops.coalesce`): for each pow2 batch size up to
the cap, one re-stack wave that locks the roster, one locked dense wave and
one locked delta wave, so the first coalesced waves of a deployment build
nothing and touch no fresh path.  With an active ``mesh_manager`` it also
runs the sharded cold solve the engine's cold hook would (the "sharded_linear"
job, or "sharded" when the quality mode is pinned to "sinkhorn"), and at or
above its row floor the "sharded_resident" job: an engine pinned to the
manager through a cold, a dense warm and a delta epoch, so the placed
resident state's path (K6's shard entry included) is built and touched.
While the manager is the process-active one, the "coalesce" waves lock onto
the stream-axis (or 2-D) placement as production waves do.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .ops.packing import pad_bucket
from .utils.device import DeviceLike, resolve_device
from .utils.observability import stopwatch

LOGGER = logging.getLogger(__name__)


def bucket_range(max_value: int, minimum: int = 8) -> List[int]:
    """All power-of-two buckets that inputs in [1, max_value] pad to."""
    buckets = []
    b = minimum
    while True:
        buckets.append(b)
        if b >= max_value:
            break
        b *= 2
    return buckets


def _ready(out, device: torch.device):
    """Wait for a job's device work (``jax.block_until_ready`` in the JAX
    warm-up); returns the job's output."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out


def _build_kernels(device: torch.device) -> None:
    """Step 1: the card's kernels (every ``nvcc`` together) and the native
    core.  A failed build is logged: the job that needs it fails and is
    skipped below, and the rebalance path raises as it would have."""
    from . import native
    from .ops import _build

    if device.type == "cuda":
        try:
            _build.build_all()
        except Exception:
            LOGGER.warning("warmup: building the kernels failed", exc_info=True)
    try:
        native.load()
    except Exception:
        LOGGER.warning("warmup: building the native core failed", exc_info=True)


def _coalesce_waves(lags1d: np.ndarray, C: int, n: int, refine_iters: int,
                    delta_buckets: int, dev: torch.device):
    """The megabatch job: ``n`` engines through one coalescer (window 2 s,
    batch cap ``n``, roster lock on the first wave).  Wave 1 re-stacks and
    locks, wave 2 runs locked and dense, wave 3 (every row a small change of
    wave 2's, so every engine plans a delta) locked and delta, when the
    service's delta ladder is on.  The rows submit under alternating SLO
    classes with far deadlines, so the ordered flush runs too.  Returns the
    last wave's lags."""
    import threading

    from .ops.coalesce import MegabatchCoalescer
    from .ops.streaming import StreamingAssignor, delta_k_ladder
    from .utils.metrics import REGISTRY
    from .utils.overload import SLO_CLASSES, class_rank

    rng = np.random.default_rng(n)
    engines = [
        StreamingAssignor(num_consumers=C, refine_iters=refine_iters,
                          refine_threshold=None, delta_max_fraction=1.0,
                          delta_buckets=max(delta_buckets, 1), device=dev)
        for _ in range(n)
    ]
    for eng in engines:
        eng.rebalance(lags1d)
    ladder = delta_k_ladder(delta_buckets)
    coal = MegabatchCoalescer(window_s=2.0, max_batch=n, lock_waves=1,
                              delta_k=ladder[-1] if ladder else 0, device=dev)
    arrs = None
    try:
        for wave in range(3 if ladder else 2):
            if wave < 2:
                arrs = [rng.integers(0, 1000, lags1d.shape[0]).astype(np.int64)
                        for _ in engines]
            else:
                arrs = [a + (np.arange(a.shape[0]) < 8) for a in arrs]
            errs = []

            def run(eng, arr, i):
                klass = SLO_CLASSES[i % len(SLO_CLASSES)]
                try:
                    eng.submit_epoch(arr, coal, slo_class=klass, rank=class_rank(klass),
                                     deadline_at=REGISTRY.clock() + 600.0)
                except Exception as exc:  # noqa: BLE001 — re-raised below
                    errs.append(exc)

            threads = [threading.Thread(target=run, args=(eng, arr, i))
                       for i, (eng, arr) in enumerate(zip(engines, arrs))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errs:
                raise errs[0]
    finally:
        coal.close(timeout_s=30.0)
    return arrs


def warmup(
    max_partitions: int,
    consumers: Sequence[int],
    topics: Sequence[int] = (1,),
    solvers: Sequence[str] = ("rounds", "stream"),
    all_partition_buckets: bool = False,
    sinkhorn_iters: int = 24,
    refine_iters: Optional[int] = None,
    stream_refine_iters: int = 128,
    coalesce_max_batch: int = 1,
    delta_buckets: int = 6,
    mesh_manager=None,
    device: DeviceLike = None,
) -> List[Tuple[str, int, int, int, Optional[float]]]:
    """Build the kernels and run every job for each shape the deployment
    will see.

    Args, as the JAX warm-up's:
      max_partitions: largest per-topic partition count expected.
      consumers: exact consumer-group sizes to warm.
      topics: topic-batch sizes for the batched solves (bucketed).
      solvers: subset of {"rounds", "scan", "global", "stream", "sinkhorn",
        "linear"}.  "sinkhorn" runs the dense solve under a pinned
        "sinkhorn" quality scope; the linear solve runs when asked for, or
        when ``resolve_quality_mode(P, C)`` routes the shape to it.
      all_partition_buckets: every bucket up to the max, or only the one
        ``max_partitions`` pads to (default).
      sinkhorn_iters / refine_iters: the production config's values;
        ``refine_iters`` > 0 also runs the parity solvers' refine.
      stream_refine_iters: the streaming engine's exchange budget.  The
        "stream" job drives the JAX sequence: cold, warm, an identity
        ``remap_members``, ``seed_choice``, ``prestack_resident``,
        ``quarantine_resident(..., record=False)``, lags above 2**32
        through ``assign_stream`` and the engine, ``reset`` and a wide
        cold chain.
      coalesce_max_batch: > 1 adds the megabatch waves ("coalesce" rows,
        T the batch size) for every pow2 batch size from 2 up to it.
      delta_buckets: > 0 adds one delta epoch at each K of
        ``delta_k_ladder(delta_buckets)`` up to P ("stream_delta" rows).
      mesh_manager: an active :class:`.sharded.mesh.MeshManager` adds the
        sharded cold solve ("sharded_linear" / "sharded" rows, T the mesh
        size) and, at or above its row floor, the placed resident epochs
        ("sharded_resident" rows).
      device: where the jobs run; None means the CUDA card (raises
        without one), ``"cpu"`` the plain path.

    Returns ``(solver, T, P_bucket, C, seconds)`` for each job that ran.  A
    failing job is logged and skipped: the warm-up must never take a
    deployment down.
    """
    from .ops.batched import assign_batched_rounds, assign_batched_scan
    from .ops.dispatch import autotune_quality_tile
    from .ops.rounds_kernel import assign_global_rounds
    from .ops.scan_kernel import pack_shift_for
    from .utils.observability import install_compile_counter

    dev = resolve_device(device)
    _build_kernels(dev)
    # The tile BEFORE any quality job: the jobs below run the geometry
    # production will run (on the CPU the static default stays).
    autotune_quality_tile(device=dev)
    # Builds from here on are counted: a deployment snapshots
    # compile_count() after the warm-up and asserts a zero delta.
    install_compile_counter()
    p_buckets = (
        bucket_range(max_partitions)
        if all_partition_buckets
        else [pad_bucket(max_partitions)]
    )
    t_buckets = sorted({pad_bucket(t, minimum=1) for t in topics})

    def on_dev(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)

    done: List[Tuple[str, int, int, int, Optional[float]]] = []
    rng = np.random.default_rng(0)
    for P in p_buckets:
        lags1d = rng.integers(0, 1000, size=P).astype(np.int64)
        pids1d = np.arange(P, dtype=np.int32)
        for C in consumers:
            jobs = []
            if "stream" in solvers:

                def stream_job(lags1d=lags1d, C=C):
                    # The cold chain (K1 + K6), the warm resident refine,
                    # the table-building variant (after the identity remap,
                    # the seed, the pre-stack and the quarantine), the wide
                    # lags (K1's two-key form) and a wide cold chain.
                    # refine_threshold=None forces the warm dispatch; delta
                    # off keeps this job's warm epochs dense (the delta
                    # ladder has its own jobs below).
                    from .ops.batched import assign_stream, stream_payload
                    from .ops.streaming import StreamingAssignor

                    engine = StreamingAssignor(
                        num_consumers=C, refine_iters=stream_refine_iters,
                        refine_threshold=None, delta_enabled=False, device=dev,
                    )
                    engine.rebalance(lags1d)
                    out = engine.rebalance(lags1d)
                    engine.remap_members(np.arange(C, dtype=np.int32), C)
                    engine.rebalance(lags1d)
                    # Warm-restart recovery replays seed_choice + rebalance,
                    # and with recovery_prestack seed_choice ->
                    # prestack_resident -> a resident dispatch.
                    engine.seed_choice(np.asarray(out))
                    engine.rebalance(lags1d)
                    engine.seed_choice(np.asarray(out))
                    engine.prestack_resident()
                    engine.rebalance(lags1d)
                    # The quarantine -> heal replay; record=False keeps the
                    # drill out of the production quarantine counters.
                    engine.quarantine_resident(
                        ["choice"], source="warmup", record=False
                    )
                    engine.rebalance(lags1d)
                    wide = lags1d + (np.int64(1) << 32)
                    payload, shift = stream_payload(wide)
                    assign_stream(on_dev(payload), C, pack_shift=shift)
                    engine.rebalance(wide)
                    engine.reset()
                    engine.rebalance(wide)
                    return out

                jobs.append(("stream", 1, stream_job))
            mesh_live = (
                "stream" in solvers and mesh_manager is not None
                and mesh_manager.active
            )
            if mesh_live:
                from .ops import dispatch as _dispatch_mod

                sharded_linear = _dispatch_mod.quality_mode() != "sinkhorn"

                def sharded_job(lags1d=lags1d, C=C, linear=sharded_linear):
                    # The cold hook's dispatch at the engine's cold budget:
                    # the linear duals unless the mode is pinned "sinkhorn".
                    from .ops.streaming import StreamingAssignor
                    from .sharded.solve import solve_linear_sharded, solve_sharded

                    budget = StreamingAssignor(num_consumers=C, device=dev).cold_refine_iters
                    solver = solve_linear_sharded if linear else solve_sharded
                    return solver(mesh_manager.solve_mesh(), lags1d, C,
                                  refine_iters=budget)[0]

                jobs.append(("sharded_linear" if sharded_linear else "sharded",
                             mesh_manager.size, sharded_job))
            if mesh_live and mesh_manager.should_shard_solve(P):

                def resident_job(lags1d=lags1d, C=C):
                    # The placed resident state (sharded/resident): cold,
                    # a dense warm and a delta epoch with the manager as the
                    # engine's backend, the placement the adopt hook applies.
                    from .ops.streaming import StreamingAssignor

                    eng = StreamingAssignor(
                        num_consumers=C, refine_iters=stream_refine_iters,
                        refine_threshold=None, delta_enabled=delta_buckets > 0,
                        delta_max_fraction=1.0,
                        delta_buckets=max(delta_buckets, 1),
                        mesh_backend=mesh_manager, device=dev,
                    )
                    cur = lags1d.copy()
                    eng.rebalance(cur)
                    cur = cur + 1
                    out = eng.rebalance(cur)
                    if delta_buckets > 0:
                        nxt = cur.copy()
                        nxt[:8] = nxt[:8] + 1 + (np.arange(8) % 7)
                        out = eng.rebalance(nxt)
                    return out

                jobs.append(("sharded_resident", mesh_manager.size, resident_job))
            if "stream" in solvers and delta_buckets > 0:
                from .ops.streaming import delta_k_ladder

                for K in delta_k_ladder(delta_buckets):
                    if K > P:
                        break

                    def delta_job(lags1d=lags1d, C=C, K=K):
                        # Two dense epochs seed the resident lag buffer,
                        # then exactly K changed lags make a delta at this
                        # rung (fraction 1.0 admits it; the bytes gate still
                        # applies, as in production).
                        from .ops.streaming import StreamingAssignor

                        eng = StreamingAssignor(
                            num_consumers=C, refine_iters=stream_refine_iters,
                            refine_threshold=None, delta_max_fraction=1.0,
                            delta_buckets=delta_buckets, device=dev,
                        )
                        cur = lags1d.copy()
                        eng.rebalance(cur)
                        eng.rebalance(cur)
                        nxt = cur.copy()
                        nxt[:K] = nxt[:K] + 1 + (np.arange(K) % 7)
                        return eng.rebalance(nxt)

                    jobs.append(("stream_delta", K, delta_job))
            if "stream" in solvers and coalesce_max_batch > 1:
                n = 2
                while n <= coalesce_max_batch:

                    def coalesce_job(lags1d=lags1d, C=C, n=n):
                        return _coalesce_waves(lags1d, C, n, stream_refine_iters,
                                               delta_buckets, dev)

                    jobs.append(("coalesce", n, coalesce_job))
                    n *= 2
            if "sinkhorn" in solvers or "linear" in solvers:
                from .models.sinkhorn import assign_topic_sinkhorn
                from .ops import dispatch as dispatch_mod

                valid1d = np.ones(P, dtype=bool)
                want_linear = "linear" in solvers or (
                    "sinkhorn" in solvers
                    and dispatch_mod.resolve_quality_mode(P, C) == "linear"
                )
                if "sinkhorn" in solvers and (
                    dispatch_mod.quality_mode() != "linear"
                ):

                    def sinkhorn_job(lags1d=lags1d, C=C):
                        with dispatch_mod.quality_scope("sinkhorn"):
                            return assign_topic_sinkhorn(
                                lags1d, pids1d, valid1d, num_consumers=C,
                                iters=sinkhorn_iters, refine_iters=refine_iters,
                                device=dev,
                            )

                    jobs.append(("sinkhorn", 1, sinkhorn_job))
                if want_linear:

                    def linear_job(lags1d=lags1d, C=C):
                        from .ops.linear_ot import assign_topic_linear

                        return assign_topic_linear(
                            lags1d, pids1d, valid1d, num_consumers=C,
                            iters=sinkhorn_iters, refine_iters=refine_iters,
                            device=dev,
                        )

                    jobs.append(("linear", 1, linear_job))
            for T in t_buckets:
                lags = np.broadcast_to(lags1d, (T, P)).copy()
                pids = np.broadcast_to(pids1d, (T, P)).copy()
                # The dispatch derives the packed-sort shift from the group's
                # value ranges; dense pids 0..P-1 and these lags give the
                # shift a dense production group gets.  (The round scan's
                # key form is chosen per call, so there is no rank-bits
                # argument to pass as the JAX warm-up does.)
                shift = pack_shift_for(int(lags.max()), int(pids.max()))
                parity_refine = (
                    {"refine_iters": int(refine_iters)} if refine_iters else {}
                )
                args = (on_dev(lags), on_dev(pids), on_dev(np.ones((T, P), bool)))
                if "rounds" in solvers:
                    jobs.append(("rounds", T, lambda args=args, shift=shift,
                                 ri=parity_refine: assign_batched_rounds(
                                     *args, num_consumers=C, pack_shift=shift, **ri)))
                if "scan" in solvers:
                    jobs.append(("scan", T, lambda args=args, ri=parity_refine:
                                 assign_batched_scan(*args, num_consumers=C, **ri)))
                if "global" in solvers:
                    jobs.append(("global", T, lambda args=args, shift=shift:
                                 assign_global_rounds(*args, num_consumers=C,
                                                      pack_shift=shift)))
            for name, T, job in jobs:
                ok = True
                with stopwatch() as t:
                    try:
                        _ready(job(), dev)
                    except Exception:
                        LOGGER.warning(
                            "warmup %s T=%d P=%d C=%d failed (skipped)",
                            name, T, P, C, exc_info=True,
                        )
                        ok = False
                if not ok:
                    continue
                secs = t[0] / 1000.0
                done.append((name, T, P, C, secs))
                LOGGER.info(
                    "warmup %s T=%d P=%d C=%d in %.1fs", name, T, P, C, secs
                )
    return done
