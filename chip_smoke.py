#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card; hold its kernels to their plain
versions.

Run from the repository root, on a machine with a CUDA card and ``nvcc``::

    python3 chip_smoke.py

Phases (each raises on failure; the script exits 0 only if all pass):

1. environment: the card's name, and its name and power limit as
   ``nvidia-smi`` reports them;
2. build: ``nvcc`` builds every ``csrc/*.cu`` of the port (seconds printed);
3. kernels: each kernel against its plain PyTorch version on the card, on the
   same inputs, bit for bit (every value is an integer: tolerance 0);
4. main path: the port's ``LagBasedPartitionAssignor(device="cuda")`` with a
   ``FakeBroker`` on BASELINE config 5 (1 topic, 100k partitions, 1k
   consumers) and config 3 (256 topics x 64 partitions, 64 consumers), for
   the ``rounds`` and ``global`` solvers: every ``assign()`` must launch the
   round-scan kernel, keep each topic's count spread <= 1 and equal the
   port's CPU path on the same input; the README example must give its
   documented answer;
5. times at the config-5 shape, with CUDA events, median of 30 runs after
   warm-up: the kernel alone, its plain version on the card, and the whole
   ``assign()`` on the host clock; then, for each phase-4 cell, one
   ``assign()`` under ``torch.profiler``: the device's busy time and its
   idle share of the wall.

It prints one JSON ``kernels`` line, and as its last line
``{"ok": true, "device": {...}}``.  Without a card it exits 1 and prints no
result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from kafka_lag_based_assignor_tpu_torch.assignor import LagBasedPartitionAssignor
from kafka_lag_based_assignor_tpu_torch.ops import _build, rounds_cuda
from kafka_lag_based_assignor_tpu_torch.ops.rounds_kernel import round_rows
from kafka_lag_based_assignor_tpu_torch.ops.scan_kernel import sort_partitions_with
from kafka_lag_based_assignor_tpu_torch.testing import baseline_workload, broker_for
from kafka_lag_based_assignor_tpu_torch.types import GroupSubscription, Subscription

# H100 SXM peaks (NVIDIA's data sheet): HBM3 bandwidth, and the non-tensor
# float32 rate, used for the kernel's int64 compare-exchanges, which have no
# published peak of their own (it over-states the integer rate, so the
# bound stays a lower bound).
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
REPEATS = 30


def log(*parts) -> None:
    print(*parts, flush=True)


# -- phase 1 ---------------------------------------------------------------


def environment() -> str:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda},"
        f" {torch.cuda.device_count()} visible)")
    log(smi)
    return name


# -- phase 2 ---------------------------------------------------------------


def build() -> None:
    for name, seconds in _build.build_all().items():
        log(f"built csrc/{name}.cu in {seconds:.2f} s")
        log(_build.build_log(name).strip())


# -- phase 3 ---------------------------------------------------------------


def round_inputs(lags: np.ndarray, n_valid: np.ndarray, C: int, device):
    """Kernel inputs as the main path makes them: each topic's rows sorted
    into processing order and cut into rounds (gains, valid, totals0)."""
    T, P = lags.shape
    lags_t = torch.from_numpy(lags).to(device)
    pids = torch.arange(P, dtype=torch.int32, device=device).expand(T, P)
    valid = torch.arange(P, device=device)[None, :] < torch.from_numpy(n_valid).to(device)[:, None]
    _, sl, sv = sort_partitions_with(lags_t, pids, valid, pack_shift=0)
    gains, ok, R, _ = round_rows(sl, sv, C, int(n_valid.max()))
    return (
        gains.reshape(T, R, C).contiguous(),
        ok.reshape(T, R, C).to(torch.uint8).contiguous(),
        torch.zeros(C, dtype=torch.int64, device=device),
    )


def kernel_cases():
    """(name, lags [T, P], valid rows per topic, C, carry across topics)."""
    rng = np.random.default_rng(7)

    def full(T, P):
        return np.full(T, P)

    yield ("config5_narrow", rng.integers(0, 20_000, (1, 100_000)),
           full(1, 100_000), 1000, False)
    yield ("config5_wide", rng.integers(2**20, 2**31, (1, 100_000)),
           full(1, 100_000), 1000, False)
    table = rng.integers(0, 1000, (256, 64))
    yield "config3_rounds", table, full(256, 64), 64, False
    yield "config3_global", table, full(256, 64), 64, True
    yield "one_consumer", rng.integers(0, 10**6, (4, 50)), full(4, 50), 1, False
    yield ("fewer_rows_than_consumers", rng.integers(0, 10**6, (3, 128)),
           np.array([100, 7, 1]), 700, False)
    yield "ties", rng.integers(0, 3, (8, 5000)), full(8, 5000), 300, False
    yield ("max_slots", rng.integers(0, 10**9, (2, 40_000)), full(2, 40_000),
           rounds_cuda.MAX_SLOTS, False)


def kernels_vs_plain(device) -> int:
    worst = 0
    for name, lags, n_valid, C, carry in kernel_cases():
        gains, valid, totals0 = round_inputs(lags.astype(np.int64), n_valid, C, device)
        got_c, got_t = rounds_cuda.rounds_scan(gains, valid, totals0, carry)
        want_c, want_t = rounds_cuda.rounds_scan_torch(gains, valid, totals0, carry)
        if device.type == "cuda":
            torch.cuda.synchronize()
        err = max(
            int((got_c.long() - want_c.long()).abs().max()),
            int((got_t - want_t).abs().max()),
        )
        worst = max(worst, err)
        log(f"kernel vs plain  {name:26s} T={gains.shape[0]} R={gains.shape[1]} "
            f"C={C} carry={carry}: max |diff| {err}")
        if err:
            raise AssertionError(f"rounds_scan disagrees with its plain version on {name}")
    return worst


# -- phase 4 ---------------------------------------------------------------


def subscription(members, topics) -> GroupSubscription:
    return GroupSubscription({m: Subscription(tuple(topics)) for m in members})


def plugin(lags, members, solver, device):
    """A configured assignor with its broker, and the assign() arguments."""
    broker = broker_for(lags)
    assignor = LagBasedPartitionAssignor(lambda props: broker, device=device)
    assignor.configure({"group.id": "chip-smoke", "tpu.assignor.solver": solver})
    return assignor, broker.cluster(), subscription(members, sorted(lags))


def assign_once(lags, members, solver, device):
    assignor, cluster, group = plugin(lags, members, solver, device)
    out = assignor.assign(cluster, group)
    return {
        m: [(tp.topic, tp.partition) for tp in a.partitions]
        for m, a in out.group_assignment.items()
    }, assignor.last_stats


def main_path(device) -> int:
    lags, members = baseline_workload(1)
    got, _ = assign_once(lags, members, "rounds", device)
    if got != {"C0": [("t0", 0)], "C1": [("t0", 2), ("t0", 1)]}:
        raise AssertionError(f"README example gave {got}")

    runs = [(cfg, solver) for cfg in (5, 3) for solver in ("rounds", "global")]
    workloads = {cfg: baseline_workload(cfg) for cfg in (5, 3)}
    results = {}
    rounds_cuda.rounds_scan.launches = 0
    for cfg, solver in runs:
        before = rounds_cuda.rounds_scan.launches
        results[cfg, solver] = assign_once(*workloads[cfg], solver, device)
        grew = rounds_cuda.rounds_scan.launches - before
        if device.type == "cuda" and grew < 1:
            raise AssertionError(f"config {cfg} {solver}: no round-scan launch")
    launches = rounds_cuda.rounds_scan.launches

    for (cfg, solver), (got, stats) in results.items():
        lags, members = workloads[cfg]
        for topic in lags:
            counts = [sum(t == topic for t, _ in tps) for tps in got.values()]
            if max(counts) - min(counts) > 1:
                raise AssertionError(f"config {cfg} {solver}: spread > 1 on {topic}")
        want, _ = assign_once(lags, members, solver, torch.device("cpu"))
        if got != want:
            raise AssertionError(f"config {cfg} {solver}: differs from the CPU path")
        log(f"main path  config {cfg} {solver:6s}: {stats.num_partitions} partitions, "
            f"{stats.num_members} members, quality_ratio {stats.quality_ratio!r}, "
            f"wall {stats.wall_ms:.3f} ms (solve {stats.solve_ms:.3f} ms), "
            "equal to the CPU path")
    log(f"main path: rounds_scan launched {launches} times")
    return launches


# -- phase 5 ---------------------------------------------------------------


def median_event_ms(fn) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(T: int, R: int, C: int) -> tuple:
    """The least time for the work: each input read once, each output
    written once, over the HBM rate; or the compare-exchanges of the
    bitonic network over the scalar rate — whichever is larger."""
    moved = T * R * C * (8 + 1 + 4) + C * 8 + T * C * 8
    slots = rounds_cuda.slots_for(C)
    stages = int(math.log2(slots)) * (int(math.log2(slots)) + 1) // 2
    ops = T * R * stages * (slots // 2)
    by_bytes, by_ops = moved / HBM_BYTES_PER_S * 1e3, ops / SCALAR_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations", stages


def times(device):
    lags, members = baseline_workload(5)
    P = lags["t0"].size
    C = len(members)
    gains, valid, totals0 = round_inputs(lags["t0"][None], np.array([P]), C, device)
    T, R, _ = gains.shape
    kernel = median_event_ms(lambda: rounds_cuda._launch(gains, valid, totals0, False))
    wrapper = median_event_ms(lambda: rounds_cuda.rounds_scan(gains, valid, totals0))
    plain = median_event_ms(lambda: rounds_cuda.rounds_scan_torch(gains, valid, totals0))
    bound, bound_by, stages = bound_ms(T, R, C)

    assignor, cluster, group = plugin(lags, members, "rounds", device)
    walls, parts = [], []
    for i in range(REPEATS + 3):
        t0 = time.perf_counter()
        assignor.assign(cluster, group)
        torch.cuda.synchronize()
        if i >= 3:
            walls.append((time.perf_counter() - t0) * 1e3)
            stats = assignor.last_stats
            parts.append((stats.lag_read_ms, stats.solve_ms))
    wall = statistics.median(walls)
    lag_read = statistics.median(p[0] for p in parts)
    solve = statistics.median(p[1] for p in parts)
    log(f"times at config 5 (T={T} R={R} C={C}, {R * stages} barrier stages): kernel "
        f"{kernel!r} ms ({kernel * 1e6 / (R * stages):.1f} ns a stage), wrapper with "
        f"its checks {wrapper!r} ms, plain version on the card {plain!r} ms, bound "
        f"{bound!r} ms ({bound_by})")
    log(f"assign() at config 5, medians of {REPEATS} (host clock): wall {wall!r} ms "
        f"(min {min(walls)!r}), of which lag read {lag_read!r} ms (FakeBroker), "
        f"solve {solve!r} ms, the rest (stats, result objects) "
        f"{wall - lag_read - solve!r} ms; the kernel is {kernel / wall:.4%} of the wall")
    return kernel, plain, bound, bound_by


def device_shares(device) -> None:
    """One profiled assign() per main-path cell: the device's busy time
    (kernels and copies, from torch.profiler's CUDA activity), the round
    scan's share of it, and the device's idle share of the wall."""
    from torch.profiler import ProfilerActivity, profile

    for cfg in (5, 3):
        lags, members = baseline_workload(cfg)
        for solver in ("rounds", "global"):
            assignor, cluster, group = plugin(lags, members, solver, device)
            assignor.assign(cluster, group)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                assignor.assign(cluster, group)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            events = [
                e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "Activity Buffer" not in e.key
            ]
            busy = sum(e.self_device_time_total for e in events) / 1e3
            scan = sum(
                e.self_device_time_total for e in events if "rounds_scan" in e.key
            ) / 1e3
            log(f"device share  config {cfg} {solver:6s}: wall {wall!r} ms (profiled), "
                f"device busy {busy!r} ms, of which the round scan {scan!r} ms; "
                f"idle share {1 - busy / wall!r}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script measures the "
              "port on the card", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    name = environment()
    build()
    max_err = kernels_vs_plain(device)
    launches = main_path(device)
    kernel, plain, bound, bound_by = times(device)
    device_shares(device)
    log(json.dumps({"kernels": [{
        "name": "rounds_scan",
        "route": "cuda",
        "source": "kafka_lag_based_assignor_tpu_torch/csrc/rounds_scan.cu",
        "replaces": "kafka_lag_based_assignor_tpu/ops/rounds_pallas.py:194",
        "also_replaces": "kafka_lag_based_assignor_tpu/ops/rounds_pallas.py:160",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel,
        "plain_ms": plain,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
