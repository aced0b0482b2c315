#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card; hold its kernels to their plain
versions.

Run from the repository root, on a machine with a CUDA card and ``nvcc``::

    python3 chip_smoke.py

Phases (each raises on failure; the script exits 0 only if all pass):

1. environment: the card's name, and its name and power limit as
   ``nvidia-smi`` reports them;
2. build: ``nvcc`` builds every ``csrc/*.cu`` of the port (seconds printed,
   and ptxas' registers, shared memory and spills of every kernel
   instantiation), and ``g++`` the native core (``native/greedy.cpp``);
3. kernels: each kernel against its plain PyTorch version on the card, on the
   same inputs, at every shape the main paths give it and at edge shapes:
   the round scan bit for bit (integers: tolerance 0), also at the quality
   solver's greedy-leg shapes of configs 2, 4 and 5, at every slot count
   1, 2, 4, ..., 16,384 (C not a power of two above 2) with small lags and
   with lags that force the two-key form, at config 5's shape forced into
   the two-key form (lags near 2^40) and with negative gains; each case in
   the key form ``packed_rank_bits`` gives it and, where that is the
   packed key, in the two-key form too, every launch twice to the same
   bits, the form logged; the f32 quality
   kernels within ``max |kernel - plain| <= 1e-5 * max |plain|`` (f32 sums
   in another order and an approximate exp), each run twice to the same
   bits: the plan statistics (K3) at the dedup shapes of configs 2, 4 and
   5 and at every U = 1, 17, 1,024, 4,096 and C = 1, 16, 31, 512, 1,000,
   1,024, 1,025, 2,000, 16,384 (C ascending, the generic kernel's shared
   memory growing in one process), in each ``need`` (both, load, colsum;
   the marginal asked for alone equal bit for bit to its ``need="both"``
   value) and in each kernel form that takes the shape (the cluster form
   up to C = 1,024, the pass form at every C); superblock partials and
   the mirror-prox step at config 5 with C 1000 and 16, and at the duals
   the plain linear loop holds after its last step at config 5, also at
   edge shapes (C = 1, 2, not a multiple of 128, and 1,025, 2,000 and
   16,384 in that order; trailing tiles all padding, all-zero weights);
   C = 16,385 raising in both
   linear-OT wrappers on both devices; and torch's argmin / argmax on the
   card take the first index among ties, as the JAX package's do; the
   resident-state digest (K6) bit for bit, each case launched twice to the
   same bits, at BASELINE config 5's resident shape (B 131,072, C 1,000,
   M 133), clean and with each corruption class, at B = 7 and 8, B = 1,027
   (not a multiple of 4), C = 1, C = 16,384, M = 0 and a wrapping lag sum,
   and C = 16,385 raising on both devices; from the profiler, one call of
   K3 (configs 2 and 4, ``need`` load and colsum) and of K6 (config 5)
   enqueues one kernel and no memset; the streaming engine's bulk
   refine on the card bit for bit against the port's CPU path from a
   drifted config-5 resident state; the P-step scan (K7) bit for bit
   against its plain version on the card, each case launched twice to the
   same bits, at C = 1, 2, 31, 32, 33, 1,000, 1,024, 1,025 and 16,384, with
   all-zero lags, lags near 2^62 (wrapping totals), an eligible mask and a
   mask with none eligible, padding rows (at the end and in the middle)
   and config 3's 256 topics x 64 rows, then the main path's own inputs
   at configs 5 (131,072 padded rows, 100k valid, C 1,000) and 3 bit for
   bit against the plain version on CPU copies (timed on the host clock),
   and C = 16,385 raising on both devices; ``refine_batched`` (16 rounds) on the card bit for bit against
   the port's CPU path at config 3, at its shape with 16 consumers and on
   the config-5 topic; and ``native.assign_native`` at config 5 equal to
   the ``rounds`` solve on the card;
4. main paths, each with every launch count set to 0 just before it and
   read just after, through the port's ``LagBasedPartitionAssignor(
   device="cuda")`` with a ``FakeBroker``:
   a. ``rounds`` and ``global`` on BASELINE config 5 (1 topic, 100k
      partitions, 1k consumers) and config 3 (256 topics x 64 partitions,
      64 consumers): every ``assign()`` launches the round-scan kernel,
      keeps each topic's count spread <= 1 and equals the port's CPU path;
      the README example gives its documented answer;
   b. ``sinkhorn`` on BASELINE configs 2 (1k x 16), 4 (10k x 512, 90 %
      zero lag: the dense path) and 5 (the linear path): the plan-statistics
      kernel launches at 2 and 4, the mirror-prox step (and so the
      superblock partials) at 5, the round scan at all three; every
      partition is assigned once, count spread <= 1, peak member load no
      worse than the ``rounds`` solver's, the additive bound at config 5; a
      second ``assign()`` gives the same assignment; the port's CPU path
      on the same input meets the same invariants (both quality ratios
      printed);
   c. the streaming engine ``StreamingAssignor(num_consumers=1000,
      refine_iters=512, imbalance_guardrail=1.25)`` at full config 5 in four
      legs: bench.py's 10-epoch drift schedule (seed 5), three delta epochs
      (at most 512 changed lags, on one consumer's partitions), a member
      leaving and one joining, and a corruption drill (one flipped bit of
      the resident choice raises ``CorruptStateDetected``, the next epoch
      heals).  Every epoch keeps each partition in [0, C), count spread
      <= 1 and, warm and untripped, churn <= 2 * 512 + repaired rows; the
      digest kernel launches once per refine dispatch and the round scan
      once per cold chain; a second run on the card and a run of the port's
      CPU engine at the card's bucket give the same bits;
   d. ``scan``, ``native``, and ``rounds`` and ``scan`` with
      ``tpu.assignor.refine.iters=16`` at configs 5 and 3: every ``scan``
      ``assign()`` launches K7; ``scan`` and ``native`` equal ``rounds``;
      ``rounds`` + refine keeps each topic's count spread <= 1 and its peak
      <= the greedy one, equals the port's CPU path and ``scan`` + refine;
5. times, with CUDA events, medians of 30 runs after warm-up: each kernel
   alone at its main-path shape, its plain version on the card, the
   library yardstick where there is one, and its bound; the device time
   of each kernel alone (``torch.profiler``, by kernel name), of all the
   device work one call enqueues (kernels, memsets and copies: "all
   ops"), and of K3's library yardstick (all its ops), the round
   scan's at config 5 and at config 3 ``global`` with its time a round and
   a network stage, and K4's kernel launches a step; the ``assign()``
   wall on the host clock at config 5 (``rounds``) and configs 4 and 5
   (``sinkhorn``); then, for each phase-4 cell, one ``assign()`` under
   ``torch.profiler``: the device's busy time and its idle share of the
   wall; the streaming epoch walls by type (cold, and the medians of the
   no-op, warm-refine and delta epochs), the host reads of a warm epoch and
   one profiled warm-refine epoch; K7 alone at configs 5 and 3 (event and
   device time, time a step, bound; its plain version on the card, a
   median at config 3 and one call at config 5, equal to the kernel), the ``assign()`` walls of ``scan`` and ``rounds`` + 16 refine
   rounds at config 5 (medians of 10), and the device shares of those
   cells at configs 5 and 3.

It prints the card's name and power limit, one JSON ``kernels`` line, and as
its last line
``{"ok": true, "device": {...}}``.  Without a card it exits 1 and prints no
result.

Four more modes time kernels alone::

    python3 chip_smoke.py --k1-times           # phase 5's K1 times only
    python3 chip_smoke.py --k1-ab ROOT [ROOT ...]
    python3 chip_smoke.py --k36-times          # K3 and K6 (and K4, K5 alone)
    python3 chip_smoke.py --k36-ab ROOT [ROOT ...]

``--k36-times`` times K3 at the dedup shapes of configs 2 and 4 (``need``
load and colsum, through the public wrapper; a package without ``need``
computes both) and its library yardstick, K6 at config 5's resident
state, K4 and K5 alone at config 5, and the quality ratio of the dense
``sinkhorn`` cells (configs 2 and 4); where the package has two K3 forms,
each form alone at U = 1,024, 2,048, 4,096 and C = 16, 512, 1,024.  The
``-ab`` modes run the matching ``-times`` mode once for each checkout ROOT,
in that order, each in a process that imports the port's package from
that ROOT (its kernels build under ROOT), for example a parent commit
unpacked with ``git archive`` beside this one: ``--k36-ab parent . .
parent``.  ``--device-share CFG SOLVER REFINE`` (REFINE 0 for none) prints
one phase-4 cell's profiled ``assign()`` as JSON: phase 5 runs it when the
cell's profiler sessions in its own process all lost their records.
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from kafka_lag_based_assignor_tpu_torch import native
from kafka_lag_based_assignor_tpu_torch.assignor import LagBasedPartitionAssignor
from kafka_lag_based_assignor_tpu_torch.models import sinkhorn
from kafka_lag_based_assignor_tpu_torch.ops import (
    _build,
    batched,
    dispatch,
    linear_ot,
    linear_ot_cuda,
    plan_stats,
    plan_stats_cuda,
    refine,
    rounds_cuda,
    scan_cuda,
    state_digest_cuda,
    streaming,
)
from kafka_lag_based_assignor_tpu_torch.ops.packing import (
    pad_bucket,
    pad_topic_rows,
    table_rows,
)
from kafka_lag_based_assignor_tpu_torch.ops.rounds_kernel import round_rows
from kafka_lag_based_assignor_tpu_torch.ops.scan_kernel import (
    pack_shift_for,
    sort_partitions_with,
)
from kafka_lag_based_assignor_tpu_torch.testing import (
    baseline_workload,
    broker_for,
    lag_rows,
    stream_drift,
    stream_lags0,
)
from kafka_lag_based_assignor_tpu_torch.types import GroupSubscription, Subscription
from kafka_lag_based_assignor_tpu_torch.utils import scrub
from kafka_lag_based_assignor_tpu_torch.utils.observability import (
    count_constrained_bound,
)

# H100 SXM peaks (NVIDIA's data sheet): HBM3 bandwidth, and the non-tensor
# float32 rate, used for the kernel's int64 compare-exchanges, which have no
# published peak of their own (it over-states the integer rate, so the
# bound stays a lower bound).
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# The exp rate: 16 ex2 results a clock on each SM (the multi-function
# unit's throughput for compute capability 9.0 in NVIDIA's CUDA programming
# guide), 132 SMs, 1.98 GHz boost clock.  One f32 exp is one ex2 after a
# multiply, so this bounds any softmax from below.
EXPS_PER_S = 16 * 132 * 1.98e9
REPEATS = 30
# Dynamic shared memory a block may use on the H100 (227 KB).
SMEM_PER_BLOCK = 232448
# The f32 kernels' tolerance against their plain versions, relative to the
# largest entry: sums run in another order.
F32_TOL = 1e-5
SINKHORN_CONFIGS = (2, 4, 5)
# Duals iterations of an assign() (the tpu.assignor.sinkhorn.iters default).
LINEAR_ITERS = 24

# Every kernel's launch counter: (name, the object holding ``launches``).
COUNTERS = (
    ("rounds_scan", rounds_cuda.rounds_scan),
    ("plan_stats", plan_stats.plan_stats),
    ("superblock_partials", linear_ot_cuda.superblock_partials),
    ("mirror_prox_step", linear_ot_cuda.mirror_prox_step),
    ("state_digest", refine.state_digest),
    ("scan_greedy", scan_cuda.scan_greedy),
)
# The name each kernel has in the profiler (a substring of it): K5 is the
# pass K4 launches twice; K3's two forms are klba_plan_stats_cluster and
# klba_plan_stats_pass.
KERNEL_NAMES = {
    "rounds_scan": "rounds_scan_kernel",
    "plan_stats": "klba_plan_stats_",
    "superblock_partials": "klba_linear_ot_pass",
    "mirror_prox_step": "klba_linear_ot_pass",
    "state_digest": "digest_",
    "scan_greedy": "scan_greedy_kernel",
}
# The streaming engine at BASELINE config 5, as bench.py drives it: P
# partitions, C consumers, and the warm epoch's exchange budget.
STREAM_P = 100_000
STREAM_C = 1000
STREAM_BUDGET = 512
# The parity solvers' quality mode in path d: tpu.assignor.refine.iters.
REFINE_ITERS = 16


def log(*parts) -> None:
    print(*parts, flush=True)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def reset_counts() -> None:
    for _, fn in COUNTERS:
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in COUNTERS}


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
    t0 = time.perf_counter()
    native.load()
    log(f"built native/greedy.cpp with g++ into {native.library_path()} in "
        f"{time.perf_counter() - t0:.2f} s")


# -- phase 3 ---------------------------------------------------------------


def round_inputs(lags: np.ndarray, n_valid: np.ndarray, C: int, device,
                 rows: int | None = None):
    """Kernel inputs as the main path makes them: each topic's rows sorted
    into processing order and cut into rounds (gains, valid, totals0).
    ``rows`` bounds the rows the rounds cover (default the most valid
    rows of any topic; the quality solver's greedy leg covers every padded
    row)."""
    T, P = lags.shape
    lags_t = torch.from_numpy(lags).to(device)
    pids = torch.arange(P, dtype=torch.int32, device=device).expand(T, P)
    valid = torch.arange(P, device=device)[None, :] < torch.from_numpy(n_valid).to(device)[:, None]
    _, sl, sv = sort_partitions_with(lags_t, pids, valid, pack_shift=0)
    gains, ok, R, _ = round_rows(sl, sv, C, int(n_valid.max()) if rows is None else rows)
    return (
        gains.reshape(T, R, C).contiguous(),
        ok.reshape(T, R, C).to(torch.uint8).contiguous(),
        torch.zeros(C, dtype=torch.int64, device=device),
    )


def slot_class_cases(rng):
    """Two cases at each slot count N = 1, 2, 4, ..., 16,384 (C not a power
    of two where C > 2, so every class has pad slots): small lags, which
    admit the packed key, and lags from 2 to 4 times 2^(61 - rank_bits)
    over the rows, which force the two-key form.  The odd C of these takes
    the kernel's slot-at-a-time loads from 4,096 slots up; the ``_vector``
    cases, at 4,096 and 8,192 slots (4 and 8 a thread), have a C that is a
    multiple of that and must take its 16-byte loads and stores."""
    shapes = [(f"slots{1 << n}", {1: 1, 2: 2, 4: 3}.get(1 << n, (1 << n) // 2 + (1 << n) // 8 + 1))
              for n in range(15)]
    for name, C in shapes + [("slots4096_vector", 3000), ("slots8192_vector", 6000)]:
        P = 3 * C + 5
        lo = 2 ** (62 - max(1, (C - 1).bit_length())) // P
        yield (f"{name}_packed", rng.integers(0, 10**6, (2, P)), np.full(2, P), C, False,
               None, "packed")
        yield (f"{name}_two_key", rng.integers(lo, 2 * lo, (2, P)), np.full(2, P), C, False,
               None, "two-key")


def kernel_cases():
    """(name, lags [T, P], valid rows per topic, C, carry across topics,
    rows the rounds cover or None, the key form it must take or None)."""
    rng = np.random.default_rng(7)

    def full(T, P):
        return np.full(T, P)

    # The quality solver's greedy leg at each sinkhorn cell: the padded
    # topic, every padded row scanned (ops/rounds_kernel.assign_topic_rounds
    # without n_valid).
    for config in SINKHORN_CONFIGS:
        lags, members = baseline_workload(config)
        lags_p, _, valid = pad_topic_rows(lags["t0"])
        yield (f"sinkhorn_greedy_config{config}", lags_p[None],
               np.array([int(valid.sum())]), len(members), False, lags_p.shape[0], None)
    yield ("config5_narrow", rng.integers(0, 20_000, (1, 100_000)),
           full(1, 100_000), 1000, False, None, None)
    yield ("config5_wide", rng.integers(2**20, 2**31, (1, 100_000)),
           full(1, 100_000), 1000, False, None, None)
    table = rng.integers(0, 1000, (256, 64))
    yield "config3_rounds", table, full(256, 64), 64, False, None, None
    yield "config3_global", table, full(256, 64), 64, True, None, None
    yield "one_consumer", rng.integers(0, 10**6, (4, 50)), full(4, 50), 1, False, None, None
    yield ("fewer_rows_than_consumers", rng.integers(0, 10**6, (3, 128)),
           np.array([100, 7, 1]), 700, False, None, None)
    yield "ties", rng.integers(0, 3, (8, 5000)), full(8, 5000), 300, False, None, None
    yield ("max_slots", rng.integers(0, 10**9, (2, 40_000)), full(2, 40_000),
           rounds_cuda.MAX_SLOTS, False, None, None)
    yield from slot_class_cases(rng)
    # Config 5's shape with lags near 2^40: the sum, about 2^56.6, passes
    # 2^51 (rank_bits 10) but stays below the 2^63 sentinel.
    yield ("config5_two_key", rng.integers(2**40 - 2**36, 2**40, (1, 100_000)),
           np.full(1, 100_000), 1000, False, None, "two-key")
    yield ("negative_gains", rng.integers(-1000, 10**6, (3, 3000)), np.full(3, 3000), 300,
           False, None, "two-key")


def scan_diff(got, want) -> int:
    """max |diff| over the (choice, totals) of two round scans."""
    return max(int((got[0].long() - want[0].long()).abs().max()),
               int((got[1] - want[1]).abs().max()))


def kernels_vs_plain(device) -> int:
    """K1 bit for bit against its plain version: every case in the form
    ``packed_rank_bits`` gives it (through the wrapper) and, where that is
    the packed key, in the two-key form too; each launch twice, to the same
    bits.  Logs whether each launch moved its rows with vector loads or a
    slot at a time.  Returns max |diff| (0)."""
    worst = 0
    for name, lags, n_valid, C, carry, rows, form in kernel_cases():
        gains, valid, totals0 = round_inputs(lags.astype(np.int64), n_valid, C, device,
                                             rows)
        rb = rounds_cuda.packed_rank_bits(gains, valid, totals0, carry)
        if form is not None and (rb > 0) != (form == "packed"):
            raise AssertionError(f"{name}: rank_bits {rb}, expected the {form} form")
        want = rounds_cuda.rounds_scan_torch(gains, valid, totals0, carry, rb)
        errs, io = {}, set()
        if rb:  # the plain version's two bodies agree
            errs["plain two-key"] = scan_diff(
                rounds_cuda.rounds_scan_torch(gains, valid, totals0, carry, 0), want)
        for key_rb in sorted({rb, 0}, reverse=True):
            first = (rounds_cuda.rounds_scan(gains, valid, totals0, carry) if key_rb == rb
                     else rounds_cuda._launch(gains, valid, totals0, carry, key_rb))
            again = rounds_cuda._launch(gains, valid, totals0, carry, key_rb)
            sync(device)
            if not all(torch.equal(a, b) for a, b in zip(first, again)):
                raise AssertionError(f"rounds_scan {name}: two runs differ")
            errs["packed" if key_rb else "two-key"] = scan_diff(first, want)
            io.add("vector" if rounds_cuda.vector_io(gains, valid, first[0]) else "scalar")
        err = max(errs.values())
        worst = max(worst, err)
        log(f"kernel vs plain  {name:26s} T={gains.shape[0]} R={gains.shape[1]} "
            f"C={C} carry={carry} rank_bits {rb}: max |diff| {errs}, two runs equal, "
            f"{'/'.join(sorted(io))} loads")
        if err:
            raise AssertionError(f"rounds_scan disagrees with its plain version on {name}")
        if "_vector_" in name and io != {"vector"}:
            raise AssertionError(f"rounds_scan {name}: took {io} loads, not the vector path")
    return worst


def scan_cases():
    """(name, sorted lags [T, P], valid [T, P], C, eligible or None): K7's
    inputs, each topic's rows in processing order (lag descending, padding
    last) unless the name says otherwise."""
    rng = np.random.default_rng(17)

    def rows(T, P, lo=0, hi=10**6, n_valid=None):
        lags = -np.sort(-rng.integers(lo, hi, (T, P)), axis=1)
        n = np.full(T, P) if n_valid is None else np.asarray(n_valid)
        valid = np.arange(P)[None, :] < n[:, None]
        return np.where(valid, lags, 0), valid

    for C in (1, 2, 31, 32, 33, 1000, 1024, 1025, 16384):
        yield f"C{C}", *rows(2, min(3 * C + 7, 3000)), C, None
    yield "all_zero_lags", *rows(2, 2000, 0, 1), 300, None
    # 12 rows of about 2^62 a consumer: the totals wrap past 2^63.
    yield "near_2^62", *rows(2, 600, 2**62 - 2**40, 2**62), 50, None
    yield "eligible_mask", *rows(3, 2500), 1000, rng.random(1000) < 0.5
    yield "none_eligible", *rows(2, 100), 40, np.zeros(40, bool)
    yield "padding_rows", *rows(4, 1500, n_valid=[1500, 1, 0, 777]), 100, None
    lags, valid = rows(2, 500)
    yield "padding_in_the_middle", lags, valid & (rng.random((2, 500)) < 0.8), 64, None
    yield "config3", *rows(256, 64, 0, 1000), 64, None


def scan_vs_plain(device) -> tuple:
    """K7 bit for bit against its plain version, each case launched twice
    to the same bits: the ``scan_cases`` against the plain version on the
    card, then the main path's inputs at configs 5 and 3 (``k7_cases``)
    against the plain version on CPU copies, timed on the host clock; C =
    16,385 raises on both devices; any difference raises.  Returns (the
    max |diff|, 0, {config: the CPU plain version's ms})."""
    for dev in (device, torch.device("cpu")):
        z = torch.zeros((1, 4), dtype=torch.int64, device=dev)
        try:
            scan_cuda.scan_greedy(z, z.to(torch.uint8), scan_cuda.MAX_SLOTS + 1)
        except ValueError:
            pass
        else:
            raise AssertionError(f"scan_greedy took 16,385 consumers on {dev}")

    def check(name, L, V, C, E, want, where):
        first = scan_cuda.scan_greedy(L, V, C, E)
        again = scan_cuda._launch(L, V, C, E)
        sync(device)
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise AssertionError(f"scan_greedy {name}: two runs differ")
        if not all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(first, want)):
            raise AssertionError(f"scan_greedy disagrees with its plain version on {name}")
        log(f"kernel vs plain  scan_greedy {name:22s} T={L.shape[0]} P={L.shape[1]} C={C}: "
            f"bit-equal to the plain version {where}, two runs equal, "
            f"{int((first[0] >= 0).sum())} rows assigned")

    for name, lags, valid, C, elig in scan_cases():
        L = torch.from_numpy(lags.astype(np.int64)).to(device)
        V = torch.from_numpy(valid.astype(np.uint8)).to(device)
        E = None if elig is None else torch.from_numpy(elig.astype(np.uint8)).to(device)
        check(name, L, V, C, E, scan_cuda.scan_greedy_torch(L, V, C, E), "on the card")
    cpu_ms = {}
    for name, sl, sv, C, _ in k7_cases(device):
        start = time.perf_counter()
        want = scan_cuda.scan_greedy(sl.cpu(), sv.cpu(), C)
        cpu_ms[name] = (time.perf_counter() - start) * 1e3
        check(f"main path {name}", sl, sv, C, None, want,
              f"on the CPU ({cpu_ms[name]!r} ms there)")
    log("scan_greedy: 16,385 consumers raise ValueError on the card and on the CPU")
    return 0, cpu_ms


def refine_batched_vs_cpu(device) -> None:
    """``refine_batched`` (16 rounds) on the card against the port's CPU
    path from the same greedy start, bit for bit: config 3 (T 256, where
    one partition a consumer leaves nothing to exchange), its shape with 16
    consumers (topics that stop in different rounds) and the config-5
    topic at its padded shape."""
    lags3, members3 = baseline_workload(3)
    table = np.stack([lags3[t] for t in sorted(lags3)])
    lags5, members5 = baseline_workload(5)
    cases = [("config 3", table, table.shape[1], len(members3)),
             ("config 3 shape, 16 consumers", table, table.shape[1], 16),
             ("config 5", pad_topic_rows(lags5["t0"])[0][None], lags5["t0"].size,
              len(members5))]
    for name, lags, n_valid, C in cases:
        T, P = lags.shape
        L = torch.from_numpy(lags).to(device)
        pids = torch.arange(P, dtype=torch.int32, device=device).expand(T, P).contiguous()
        V = (torch.arange(P, device=device) < n_valid).expand(T, P).contiguous()
        greedy = batched.assign_batched_rounds(L, pids, V, C)
        got = batched.refine_batched(L, V, greedy[0], C, REFINE_ITERS)
        want = batched.refine_batched(L.cpu(), V.cpu(), greedy[0].cpu(), C, REFINE_ITERS)
        for what, g, w in zip(("choice", "counts", "totals"), got, want):
            if not torch.equal(g.cpu(), w):
                raise AssertionError(f"refine_batched {name}: {what} differs from the CPU path")
        spread = int((got[1].amax(1) - got[1].amin(1)).max())
        peak_before, peak_after = int(greedy[2].amax()), int(got[2].amax())
        if spread > 1 or (got[2].amax(1) > greedy[2].amax(1)).any():
            raise AssertionError(f"refine_batched {name}: spread {spread} or a peak rose")
        log(f"refine_batched on the card = CPU path at {name} (T={T} P={P} C={C}): "
            f"{int((got[0] != greedy[0]).sum())} rows moved, peak {peak_before} -> "
            f"{peak_after}, count spread {spread}")


def native_vs_rounds(device) -> None:
    """``native.assign_native`` at config 5 equal to the ``rounds`` solve on
    the card, member list order included."""
    lags, members = baseline_workload(5)
    rows, subs = lag_rows(lags), {m: ["t0"] for m in members}
    t0 = time.perf_counter()
    got = native.assign_native(rows, subs)
    wall = (time.perf_counter() - t0) * 1e3
    if got != dispatch.assign_device(rows, subs, kernel="rounds", device=device):
        raise AssertionError("assign_native at config 5 differs from rounds on the card")
    log(f"assign_native at config 5 = rounds on the card ({wall:.3f} ms on the host)")


def f32_check(kind: str, name: str, got, want, again) -> float:
    """Hold one f32 kernel output to its plain version (module docstring's
    tolerance) and to a second run's bits; returns max |kernel - plain|."""
    worst, scale = 0.0, 0.0
    for g, w, a in zip(got, want, again):
        if not torch.equal(g, a):
            raise AssertionError(f"{kind} {name}: two runs differ")
        worst = max(worst, float((g - w).abs().max()))
        scale = max(scale, float(w.abs().max()))
    log(f"kernel vs plain  {kind:19s} {name:28s} max |diff| {worst!r} "
        f"(max |plain| {scale!r}, ratio {worst / scale if scale else 0.0!r})")
    if not worst <= F32_TOL * scale:
        raise AssertionError(f"{kind} disagrees with its plain version on {name}")
    return worst


def dedup_case(config: int, device):
    """The dedup weights of a BASELINE config, as the dense path makes them."""
    lags, members = baseline_workload(config)
    lags_p, _, valid = pad_topic_rows(lags["t0"])
    return tuple(
        torch.from_numpy(a).to(device)
        for a in sinkhorn._dedup_weights(lags_p, valid, len(members))
    ), len(members)


def blocks_case(config: int, device, tile: int = 1024):
    """The mirror-prox row blocks of a BASELINE config: ws_b, cnt_b
    [8, tpb, tile], as the linear path makes them."""
    lags, members = baseline_workload(config)
    lags_p, _, valid = pad_topic_rows(lags["t0"])
    C = len(members)
    P2, t, _ = linear_ot.plan_shape(lags_p.shape[0], tile)
    ws, cnt = linear_ot._ws_cnt(
        torch.from_numpy(lags_p).to(device), torch.from_numpy(valid).to(device),
        sinkhorn._scale_np(lags_p, valid, C),
    )
    return (linear_ot._to_blocks(ws, P2, 8, t),
            linear_ot._to_blocks(cnt, P2, 8, t)), C


def random_duals(C: int, device, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(C, generator=g).mul_(0.3).to(device),
            torch.randn(C, generator=g).mul_(0.1).to(device))


def plan_stats_cases(device):
    """(name, ws_u, count_u, wsum_u, A, B): the dense path's shapes at
    configs 2 and 4, config 5's (the dedup cap), every U = 1, 17, 1,024,
    4,096 at every C = 1, 16, 31, 512, 1,000, 1,024, 1,025, 2,000, 16,384
    (C ascending), and all-zero weights."""
    g = torch.Generator().manual_seed(1)
    for config in (2, 4, 5):
        (ws, cnt, wsum), C = dedup_case(config, device)
        yield (f"config{config} U={ws.shape[0]} C={C}", ws, cnt, wsum,
               *random_duals(C, device))
    for C in (1, 16, 31, 512, 1000, 1024, 1025, 2000, 16384):
        for U in (1, 17, 1024, 4096):
            ws = torch.rand(U, generator=g).mul_(4.0)
            cnt = torch.randint(0, 5, (U,), generator=g).float()
            cnt[0] = 1.0  # at least one live row
            yield (f"random U={U} C={C}", *(x.to(device) for x in (ws, cnt, ws * cnt)),
                   *random_duals(C, device, U + C))
    zeros = torch.zeros(64, device=device)
    yield "all-zero weights U=64 C=100", zeros, zeros, zeros, *random_duals(100, device)


def plan_stats_vs_plain(device) -> float:
    """K3 against its plain version at every case of ``plan_stats_cases``,
    in each ``need`` and each form that takes the shape, every launch twice
    to the same bits, and the marginal asked for alone equal bit for bit to
    its ``need="both"`` value.  Returns max |kernel - plain|."""
    worst = 0.0
    for name, *args in plan_stats_cases(device):
        U, C = args[0].shape[0], args[3].shape[0]
        forms = ["cluster", "pass"] if C <= plan_stats_cuda.REG_COLS else ["pass"]
        chosen = plan_stats_cuda.form_for(U, C)
        ratios = {}
        for form in forms:
            both = None
            for need in ("both", "load", "colsum"):
                got = (plan_stats.plan_stats(*args, need=need) if form == chosen
                       else plan_stats_cuda.launch(*args, need=need, form=form))
                again = plan_stats_cuda.launch(*args, need=need, form=form)
                want = plan_stats.plan_stats_torch(*args, need=need)
                if [g is None for g in got] != [w is None for w in want]:
                    raise AssertionError(f"plan_stats {name} {need}: returned {got}")
                pairs = [(g, w, a) for g, w, a in zip(got, want, again) if w is not None]
                err, scale = 0.0, 0.0
                for g, w, a in pairs:
                    if not torch.equal(g, a):
                        raise AssertionError(f"plan_stats {name} {need} {form}: two runs differ")
                    err = max(err, float((g - w).abs().max()))
                    scale = max(scale, float(w.abs().max()))
                if not err <= F32_TOL * scale:
                    raise AssertionError(f"plan_stats disagrees with its plain version on "
                                         f"{name} need={need} form={form}: {err} of {scale}")
                if need == "both":
                    both = got
                else:
                    i = 0 if need == "load" else 1
                    if not torch.equal(got[i], both[i]):
                        raise AssertionError(f"plan_stats {name} {form}: need={need} differs "
                                             f"from need=both")
                worst = max(worst, err)
                ratios[f"{form}/{need}"] = err / scale if scale else 0.0
        log(f"kernel vs plain  plan_stats {name:28s} (form {chosen}): max |diff| / max |plain| "
            + ", ".join(f"{k} {v:.3g}" for k, v in ratios.items())
            + "; two runs equal; alone = both")
    return worst


def loop_duals(ws_b, cnt_b, C: int, device):
    """The duals (A, B) the linear loop holds after its last step on these
    blocks: the main path's loop and iteration count, with the plain step.
    The duals grow along the loop, and with them the logits' magnitude."""
    eta = linear_ot.MIRROR_PROX_ETA
    A, B, rounds = linear_ot.mirror_prox(
        lambda A, B, sc, prev: linear_ot_cuda.mirror_prox_step_torch(
            ws_b, cnt_b, A, B, sc, prev, eta),
        C, LINEAR_ITERS, float(cnt_b.sum()), device=device)
    log(f"linear loop duals at config 5: {rounds} rounds, max |A| {float(A.abs().max())!r}, "
        f"max |B| {float(B.abs().max())!r}, max |ws * A| "
        f"{float(ws_b.max()) * float(A.abs().max())!r}")
    return A, B


def linear_cases(device):
    """(name, ws_b, cnt_b, A, B): config 5's blocks with C 1000 (its main
    path) at random duals and at the duals its loop ends with, and with C
    16; then edge shapes: C = 1, 2, 130, then 1,025, 2,000 and 16,384 (the
    largest, the fewest rows a chunk) in that order, so that the generic
    kernel's shared memory grows from call to call in one process; trailing
    tiles all padding (65 real rows in [8, 8, 64]) and all-zero weights."""
    g = torch.Generator().manual_seed(2)
    (ws_b, cnt_b), C = blocks_case(5, device)
    yield f"config5 {list(ws_b.shape)} C={C}", ws_b, cnt_b, *random_duals(C, device)
    yield (f"config5 {list(ws_b.shape)} C={C} loop duals", ws_b, cnt_b,
           *loop_duals(ws_b, cnt_b, C, device))
    yield f"config5 {list(ws_b.shape)} C=16", ws_b, cnt_b, *random_duals(16, device, 16)
    for shape, C in (((8, 2, 8), 2), ((8, 4, 64), 130), ((8, 1, 8), 1), ((8, 1, 8), 1025),
                     ((8, 2, 8), 2000), ((8, 1, 8), linear_ot_cuda.MAX_CONSUMERS)):
        ws = torch.rand(shape, generator=g).mul_(3.0)
        cnt = (torch.rand(shape, generator=g) < 0.8).float()
        yield (f"random {list(shape)} C={C}", ws.to(device), cnt.to(device),
               *random_duals(C, device, C))
    ws = torch.zeros((8, 8, 64))
    cnt = torch.zeros((8, 8, 64))
    ws.view(-1)[:65] = torch.rand(65, generator=g).mul_(3.0)
    cnt.view(-1)[:65] = 1.0
    yield ("65 real rows in [8, 8, 64] C=100", ws.to(device), cnt.to(device),
           *random_duals(100, device, 100))
    zeros = torch.zeros((8, 1, 8), device=device)
    yield "all-zero weights [8, 1, 8] C=5", zeros, zeros, *random_duals(5, device)


def linear_limits(device) -> None:
    """C = 16,385 raises ValueError from both linear-OT wrappers on the card
    and on the CPU; the row-tile pass's shared memory fits a block at every
    C it takes."""
    C = linear_ot_cuda.MAX_CONSUMERS + 1
    for dev in (device, torch.device("cpu")):
        ws = torch.ones((8, 1, 8), device=dev)
        A, B = torch.zeros(C, device=dev), torch.zeros(C, device=dev)
        scalars = (torch.tensor(1.0, device=dev), torch.tensor(0.0, device=dev))
        for name, call in (
                ("superblock_partials", lambda: linear_ot_cuda.superblock_partials(ws, ws, A, B)),
                ("mirror_prox_step", lambda: linear_ot_cuda.mirror_prox_step(
                    ws, ws, A, B, *scalars, eta=linear_ot.MIRROR_PROX_ETA))):
            try:
                call()
            except ValueError:
                continue
            raise AssertionError(f"{name} took C={C} on {dev}")
    lib = linear_ot_cuda._bind()
    smem = {c: lib.klba_row_tile_smem_bytes(c) for c in (1, 2, 16, 130, 1000, 1024, 1025, C - 1)}
    if max(smem.values()) > SMEM_PER_BLOCK:
        raise AssertionError(f"row-tile shared memory {smem} above {SMEM_PER_BLOCK} bytes")
    log(f"linear-OT wrappers raise ValueError at C={C} on both devices; row-tile shared "
        f"memory by C (bytes): {smem}")


def first_index_ties(device) -> None:
    """The quality path relies on torch.argmin / argmax returning the first
    index among ties on the card, as jnp.argmin / argmax do."""
    g = torch.Generator().manual_seed(3)
    x = torch.randint(0, 3, (64, 4096), generator=g).to(device)
    first = torch.arange(4096).expand(64, 4096)
    for got, hit in ((x.argmin(dim=1), x == x.min(dim=1, keepdim=True).values),
                     (x.argmax(dim=1), x == x.max(dim=1, keepdim=True).values)):
        want = torch.where(hit.cpu(), first, 4096).min(dim=1).values
        if not torch.equal(got.cpu(), want):
            raise AssertionError("argmin / argmax on the card do not take the first tie")
    log("argmin / argmax on the card take the first index among ties")


def quality_kernels_vs_plain(device) -> dict:
    """The f32 kernels against their plain versions; max |diff| by kernel."""
    first_index_ties(device)
    worst = {"plan_stats": plan_stats_vs_plain(device), "superblock_partials": 0.0,
             "mirror_prox_step": 0.0}
    for name, ws_b, cnt_b, A, B in linear_cases(device):
        got = linear_ot_cuda.superblock_partials(ws_b, cnt_b, A, B)
        again = linear_ot_cuda.superblock_partials(ws_b, cnt_b, A, B)
        want = linear_ot._superblock_partials(ws_b, cnt_b, A, B)
        worst["superblock_partials"] = max(
            worst["superblock_partials"],
            f32_check("superblock_partials", name, got, want, again),
        )
        for sc, prev in ((1.0, float("inf")), (0.5, 0.0)):
            scalars = (torch.tensor(sc, device=device), torch.tensor(prev, device=device))
            step = (ws_b, cnt_b, A, B, *scalars)
            got = linear_ot_cuda.mirror_prox_step(*step, eta=linear_ot.MIRROR_PROX_ETA)
            again = linear_ot_cuda.mirror_prox_step(*step, eta=linear_ot.MIRROR_PROX_ETA)
            want = linear_ot_cuda.mirror_prox_step_torch(
                *step, eta=linear_ot.MIRROR_PROX_ETA)
            worst["mirror_prox_step"] = max(
                worst["mirror_prox_step"],
                f32_check("mirror_prox_step", f"{name} sc={sc} prev={prev}",
                          got, want, again),
            )
    torch.cuda.synchronize()
    linear_limits(device)
    return worst


def resident_case(B: int, P: int, C: int, device, seed: int = 0):
    """A consistent resident state on ``device``: lags int64[B] (0 past P),
    a count-balanced choice over [:P] (-1 past it), and the row table and
    counts built from them."""
    rng = np.random.default_rng(seed)
    lags = np.zeros(B, np.int64)
    lags[:P] = rng.integers(0, 10**9, P)
    choice = np.full(B, -1, np.int32)
    choice[:P] = rng.permutation(np.arange(P) % C)
    lags_t, choice_t = torch.from_numpy(lags).to(device), torch.from_numpy(choice).to(device)
    tab, counts, _ = refine.build_choice_tables(
        lags_t, torch.arange(B, device=device) < P, choice_t, C, table_rows(B, C)
    )
    return lags_t, choice_t, counts, tab


def corrupted(kind: str, lags, choice, counts, tab, C: int):
    """Copies of the four buffers with one corruption class applied."""
    lags, choice, counts, tab = (t.clone() for t in (lags, choice, counts, tab))
    if kind == "choice -2":
        choice[7] = -2
    elif kind == "choice C":
        choice[9] = C
    elif kind == "choice C+5":
        choice[11] = C + 5
    elif kind == "counts +1":
        counts[-1] += 1
    elif kind == "counts -1":
        counts[0] -= 1
    elif kind == "table bit flip":
        tab[2, 1] ^= 1 << 5
    elif kind == "table slot names another row":
        tab[4, 0] = tab[4, 1]
    elif kind == "table sentinel":
        tab[1, int(counts[1])] = 0
    elif kind == "table row out of range":
        tab[5, 0] = -7
    elif kind == "lag sum wraps":
        lags[:4] = 2**62 + 3
    return lags, choice, counts, tab


DIGEST_KINDS = ("clean", "choice -2", "choice C", "choice C+5", "counts +1",
                "counts -1", "table bit flip", "table slot names another row",
                "table sentinel", "table row out of range", "lag sum wraps")


def digest_cases(device):
    """(name, lags, choice, counts, C, row_tab, P): config 5's resident
    shape clean and corrupted, then the edge shapes."""
    B = pad_bucket(STREAM_P)
    base = resident_case(B, STREAM_P, STREAM_C, device)
    for kind in DIGEST_KINDS:
        lags, choice, counts, tab = corrupted(kind, *base, STREAM_C)
        yield (f"config5 B={B} C={STREAM_C} M={tab.shape[1]} {kind}", lags, choice, counts,
               STREAM_C, tab, STREAM_P)
    for B, P, C, kind in ((8, 5, 3, "clean"), (8, 5, 3, "counts +1"), (7, 5, 3, "clean"),
                          (1027, 1000, 24, "clean"), (1027, 1000, 24, "choice C+5"),
                          (1027, 1000, 24, "table bit flip"), (1024, 1000, 1, "clean"),
                          (65536, 3 * 16384, 16384, "clean"),
                          (65536, 3 * 16384, 16384, "choice C+5"),
                          (65536, 3 * 16384, 16384, "table sentinel"),
                          (4096, 4000, 24, "lag sum wraps")):
        lags, choice, counts, tab = corrupted(kind, *resident_case(B, P, C, device, B + C), C)
        yield f"B={B} C={C} M={tab.shape[1]} {kind}", lags, choice, counts, C, tab, P
    # M = 0: a table with no slots (lane 4 is then |0 - sum of assigned rows|).
    lags, choice, counts, _ = resident_case(1024, 1000, 24, device, 5)
    tab = torch.empty((24, 0), dtype=torch.int32, device=device)
    yield "B=1024 C=24 M=0 clean", lags, choice, counts, 24, tab, 1000


def digest_plain(lags, choice, counts, C: int, tab):
    base = refine._state_digest_torch(lags, choice, counts, C)
    return torch.cat([base, refine._row_tab_lane_torch(lags, choice, tab, counts, C)[None]])


def digest_vs_plain(device) -> int:
    """K6 against its plain version, bit for bit; returns max |diff| (0)."""
    worst = 0
    for name, lags, choice, counts, C, tab, P in digest_cases(device):
        got = refine.state_digest(lags, choice, counts, C, row_tab=tab)
        again = refine.state_digest(lags, choice, counts, C, row_tab=tab)
        four = refine.state_digest(lags, choice, counts, C)
        want = digest_plain(lags, choice, counts, C, tab)
        sync(device)
        err = int((got - want).abs().max())
        worst = max(worst, err)
        if not torch.equal(got, again):
            raise AssertionError(f"state_digest {name}: two runs differ")
        log(f"kernel vs plain  state_digest {name:52s}: {got.tolist()} max |diff| {err}, "
            f"two runs equal")
        if err or not torch.equal(four, want[:4]):
            raise AssertionError(f"state_digest disagrees with its plain version on {name}")
        if tab.shape[1] == 0:
            continue  # no table: the host check's lane 4 does not apply
        fails = scrub.digest_failures(got.cpu().numpy(), P, int(lags.sum()))
        if ("clean" in name or "wraps" in name) != (fails == []):
            raise AssertionError(f"state_digest on {name}: host check gave {fails}")
    for dev in (device, torch.device("cpu")):
        C = refine.DIGEST_MAX_CONSUMERS + 1
        z = torch.zeros(8, dtype=torch.int32, device=dev)
        try:
            refine.state_digest(z.long(), z, torch.zeros(C, dtype=torch.int32, device=dev), C)
        except ValueError:
            continue
        raise AssertionError(f"state_digest took C={C} on {dev}")
    log(f"state_digest raises ValueError at C={refine.DIGEST_MAX_CONSUMERS + 1} on both devices")
    return worst


def drifted_resident(device):
    """A config-5 engine on ``device`` after its cold start, and the lags
    of six epochs of bench.py's drift (so the drain and the heat-up have
    happened): (engine, int64 lags)."""
    rng, lags0 = stream_lags0(STREAM_P)
    engine = stream_engine(device)
    choice = engine.rebalance(lags0)
    lags = lags0.astype(np.float64)
    for epoch in range(6):
        lags = stream_drift(rng, lags, epoch, choice, STREAM_C)
    return engine, lags.astype(np.int64)


def bulk_refine_vs_cpu(device) -> None:
    """The warm bulk refine (fan 8, budget 512, the engine's quality limit)
    on the card against the port's CPU path from the same drifted config-5
    resident state, bit for bit."""
    engine, lags = drifted_resident(device)
    choice_p, row_tab, counts, _ = engine._resident
    lags_p = streaming._pad_lags(torch.from_numpy(lags).to(device), choice_p.shape[0])
    totals = streaming._resident_totals(lags_p, row_tab, counts)
    limit = engine._quality_limit(count_constrained_bound(lags, STREAM_C),
                                  float(lags.sum(dtype=np.float64)))
    kw = dict(num_consumers=STREAM_C, iters=STREAM_BUDGET, max_pairs=min(STREAM_C // 2, 16),
              exchange_budget=STREAM_BUDGET, quality_limit=limit, bulk_transfer=True, fan=8)
    state = (lags_p, choice_p, row_tab, counts, totals)
    got = refine.refine_rounds_resident(*state, **kw)
    want = refine.refine_rounds_resident(*(t.cpu() for t in state), **kw)
    for name, g, w in zip(("choice", "row_tab", "counts", "totals"), got, want):
        if not torch.equal(g.cpu(), w):
            raise AssertionError(f"bulk refine on the card: {name} differs from the CPU path")
    if got[4:] != want[4:] or got[5] == 0:
        raise AssertionError(f"bulk refine: rounds/exchanges {got[4:]} vs CPU {want[4:]}")
    log(f"bulk refine on the card = CPU path at config 5 (B={choice_p.shape[0]}, "
        f"M={row_tab.shape[1]}, limit {limit!r}): {got[4]} rounds, {got[5]} exchanges, "
        f"peak {int(totals.max())} -> {int(got[3].max())}")


# -- phase 4 ---------------------------------------------------------------


def subscription(members, topics) -> GroupSubscription:
    return GroupSubscription({m: Subscription(tuple(topics)) for m in members})


def plugin(lags, members, solver, device, refine=None):
    """A configured assignor with its broker, and the assign() arguments;
    ``refine`` sets tpu.assignor.refine.iters."""
    broker = broker_for(lags)
    assignor = LagBasedPartitionAssignor(lambda props: broker, device=device)
    configs = {"group.id": "chip-smoke", "tpu.assignor.solver": solver}
    if refine is not None:
        configs["tpu.assignor.refine.iters"] = str(refine)
    assignor.configure(configs)
    return assignor, broker.cluster(), subscription(members, sorted(lags))


def assign_once(lags, members, solver, device, refine=None):
    assignor, cluster, group = plugin(lags, members, solver, device, refine)
    out = assignor.assign(cluster, group)
    return {
        m: [(tp.topic, tp.partition) for tp in a.partitions]
        for m, a in out.group_assignment.items()
    }, assignor.last_stats


def main_path(device) -> int:
    """Path a: ``rounds`` and ``global``.  Returns the round-scan launches
    counted from just before the path to just after it."""
    reset_counts()
    lags, members = baseline_workload(1)
    got, _ = assign_once(lags, members, "rounds", device)
    if got != {"C0": [("t0", 0)], "C1": [("t0", 2), ("t0", 1)]}:
        raise AssertionError(f"README example gave {got}")

    runs = [(cfg, solver) for cfg in (5, 3) for solver in ("rounds", "global")]
    workloads = {cfg: baseline_workload(cfg) for cfg in (5, 3)}
    results = {}
    for cfg, solver in runs:
        before = rounds_cuda.rounds_scan.launches
        results[cfg, solver] = assign_once(*workloads[cfg], solver, device)
        grew = rounds_cuda.rounds_scan.launches - before
        if device.type == "cuda" and grew < 1:
            raise AssertionError(f"config {cfg} {solver}: no round-scan launch")
    launches = read_counts()["rounds_scan"]

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
    log(f"main path (rounds, global): rounds_scan launched {launches} times")
    return launches


def check_quality(label: str, lags, members, got, greedy_peak, linear: bool):
    """The quality solve's invariants on one single-topic result: every
    partition once, count spread <= 1, peak load no worse than greedy's
    and, in linear mode, within the additive bound.  Returns the peak."""
    arr = lags["t0"]
    held = {m: [p for _, p in tps] for m, tps in got.items()}
    if sorted(p for ps in held.values() for p in ps) != list(range(arr.size)):
        raise AssertionError(f"{label}: not every partition assigned exactly once")
    counts = [len(held[m]) for m in members]
    if max(counts) - min(counts) > 1:
        raise AssertionError(f"{label}: count spread {max(counts) - min(counts)}")
    peak = max(int(arr[ps].sum()) if ps else 0 for ps in held.values())
    if peak > greedy_peak:
        raise AssertionError(f"{label}: peak {peak} above greedy's {greedy_peak}")
    if linear:
        bound = linear_ot.additive_bound(arr, np.ones(arr.size, bool), len(members))
        if peak > bound:
            raise AssertionError(f"{label}: peak {peak} above the additive bound {bound}")
    return peak


def greedy_peak(lags, got) -> int:
    arr = lags["t0"]
    return max(int(arr[[p for _, p in tps]].sum()) if tps else 0 for tps in got.values())


def sinkhorn_path(device) -> dict:
    """Path b: ``sinkhorn`` at BASELINE configs 2, 4 and 5.  Returns every
    kernel's launches counted from just before the path to just after."""
    workloads = {cfg: baseline_workload(cfg) for cfg in SINKHORN_CONFIGS}
    peaks = {cfg: greedy_peak(workloads[cfg][0],
                              assign_once(*workloads[cfg], "rounds", device)[0])
             for cfg in SINKHORN_CONFIGS}
    reset_counts()
    results = {}
    for cfg in SINKHORN_CONFIGS:
        before = read_counts()
        got, stats = assign_once(*workloads[cfg], "sinkhorn", device)
        rounds = linear_ot.last_solve_info() if cfg == 5 else None
        again, _ = assign_once(*workloads[cfg], "sinkhorn", device)
        grew = {k: v - before[k] for k, v in read_counts().items()}
        needed = ["rounds_scan"] + (
            ["mirror_prox_step", "superblock_partials"] if cfg == 5 else ["plan_stats"])
        if device.type == "cuda" and any(grew[k] < 1 for k in needed):
            raise AssertionError(f"config {cfg} sinkhorn: launches {grew}, "
                                 f"needed {needed}")
        if got != again:
            raise AssertionError(f"config {cfg} sinkhorn: a second assign() differs")
        results[cfg] = (got, stats, grew, rounds)
    launches = read_counts()

    for cfg, (got, stats, grew, rounds) in results.items():
        lags, members = workloads[cfg]
        peak = check_quality(f"config {cfg} sinkhorn", lags, members, got,
                             peaks[cfg], linear=cfg == 5)
        cpu, cpu_stats = assign_once(lags, members, "sinkhorn", torch.device("cpu"))
        check_quality(f"config {cfg} sinkhorn (CPU)", lags, members, cpu,
                      peaks[cfg], linear=cfg == 5)
        log(f"main path  config {cfg} sinkhorn: {stats.num_partitions} partitions, "
            f"{stats.num_members} members, peak {peak} (greedy {peaks[cfg]}), "
            f"quality_ratio {stats.quality_ratio!r} (CPU path "
            f"{cpu_stats.quality_ratio!r}; same assignment: {got == cpu}), "
            f"wall {stats.wall_ms:.3f} ms (solve {stats.solve_ms:.3f} ms), "
            f"launches in two assign() {grew}"
            + (f", duals rounds {rounds['duals_rounds']}" if rounds else ""))
    log(f"main path (sinkhorn): launches {launches}")
    return launches


def topic_loads(lags, got) -> dict:
    """{topic: (count spread, peak member load)} of an assignment."""
    counts, loads = {}, {}
    for member, tps in got.items():
        for topic, p in tps:
            counts.setdefault(topic, {}).setdefault(member, 0)
            counts[topic][member] += 1
            loads.setdefault(topic, {}).setdefault(member, 0)
            loads[topic][member] += int(lags[topic][p])
    members = len(got)
    return {t: (max(c.values()) - (min(c.values()) if len(c) == members else 0),
                max(loads[t].values())) for t, c in counts.items()}


SOLVER_RUNS = (("rounds", None), ("scan", None), ("native", None), ("rounds", REFINE_ITERS),
               ("scan", REFINE_ITERS))


def solver_path(device) -> dict:
    """Path d: ``scan``, ``native``, and ``rounds`` and ``scan`` with 16
    refine rounds at BASELINE configs 5 and 3.  Every ``scan`` assign()
    launches K7; ``scan`` and ``native`` equal ``rounds``; ``rounds`` +
    refine keeps each topic's count spread <= 1 and its peak <= the greedy
    one, equals the port's CPU path, and equals ``scan`` + refine.  Returns
    every kernel's launches counted from just before the path to just
    after."""
    workloads = {cfg: baseline_workload(cfg) for cfg in (5, 3)}
    reset_counts()
    results = {}
    for cfg in (5, 3):
        for solver, refine_iters in SOLVER_RUNS:
            before = scan_cuda.scan_greedy.launches
            results[cfg, solver, refine_iters] = assign_once(*workloads[cfg], solver, device,
                                                             refine_iters)
            if (solver == "scan" and device.type == "cuda"
                    and scan_cuda.scan_greedy.launches - before < 1):
                raise AssertionError(f"config {cfg} scan: no scan_greedy launch")
    launches = read_counts()

    for cfg in (5, 3):
        lags, members = workloads[cfg]
        greedy, _ = results[cfg, "rounds", None]
        refined, _ = results[cfg, "rounds", REFINE_ITERS]
        for solver, refine_iters in SOLVER_RUNS[1:]:
            want = refined if refine_iters else greedy
            if results[cfg, solver, refine_iters][0] != want:
                raise AssertionError(f"config {cfg} {solver} refine {refine_iters}: differs "
                                     f"from rounds")
        before, after = topic_loads(lags, greedy), topic_loads(lags, refined)
        for topic, (spread, peak) in after.items():
            if spread > 1 or peak > before[topic][1]:
                raise AssertionError(f"config {cfg} rounds + refine: {topic} spread {spread}, "
                                     f"peak {peak} against greedy {before[topic][1]}")
        cpu, _ = assign_once(lags, members, "rounds", torch.device("cpu"), REFINE_ITERS)
        if cpu != refined:
            raise AssertionError(f"config {cfg} rounds + refine: differs from the CPU path")
        moved = sum(len(set(refined[m]) - set(greedy[m])) for m in greedy)
        for solver, refine_iters in SOLVER_RUNS:
            _, stats = results[cfg, solver, refine_iters]
            log(f"main path  config {cfg} {solver:6s} refine {refine_iters}: "
                f"quality_ratio {stats.quality_ratio!r}, wall {stats.wall_ms:.3f} ms (solve "
                f"{stats.solve_ms:.3f} ms), device {stats.device}")
        log(f"main path  config {cfg}: scan = native = rounds; scan + refine = rounds + refine "
            f"= the CPU path; refine moved {moved} partitions, peak "
            f"{max(p for _, p in before.values())} -> {max(p for _, p in after.values())}")
    log(f"main path (scan, native, refine): launches {launches}")
    return launches


def stream_engine(device):
    """The streaming engine as bench.py drives it at BASELINE config 5."""
    return streaming.StreamingAssignor(
        num_consumers=STREAM_C, refine_iters=STREAM_BUDGET, imbalance_guardrail=1.25,
        device=device,
    )


def heat(lags: np.ndarray, choice: np.ndarray, C: int) -> np.ndarray:
    """The lags with the partitions (at most 512) of the consumer at the
    median load scaled so that its total is 1.15x the refine threshold: the
    kept assignment needs a refine, and since the refine never raises the
    peak, the guardrail cannot trip (1.02 * 1.15 < 1.25)."""
    totals = np.bincount(choice, weights=lags, minlength=C)
    c = int(np.argsort(totals, kind="stable")[C // 2])
    rows = np.flatnonzero(choice == c)[:512]
    mean = lags.sum(dtype=np.float64) / C
    target = 1.15 * 1.02 * max(count_constrained_bound(lags, C), 1.0) * mean
    out = lags.copy()
    out[rows] = (lags[rows] * (target / totals[c])).astype(np.int64)
    return out


def outcomes(engine) -> dict:
    return {"delta": dict(engine.delta_epochs), "readback": dict(engine.rb_delta_epochs)}


class StreamRun:
    """The four streaming legs on one fresh engine, each epoch checked as it
    runs.  ``model`` tracks what the engine's resident state should be (live
    or stale, and the lags its host mirror holds), from which each epoch's
    delta and readback outcomes are predicted."""

    def __init__(self, device, bucket=None):
        self.device = device
        self.engine = stream_engine(device)
        if bucket is not None:  # the CPU engine at the card's padded shape
            self.engine._bucket = bucket
        self.records = []
        self.live, self.mirror = False, None

    def epoch(self, leg: str, lags: np.ndarray, corrupt: bool = False):
        """One rebalance; returns its choice (None when it raised, as a
        corrupted epoch must)."""
        engine, C = self.engine, self.engine.num_consumers
        launches, before = read_counts(), outcomes(engine)
        t0 = time.perf_counter()
        try:
            choice, raised = engine.rebalance(lags), None
        except scrub.CorruptStateDetected as exc:
            if not corrupt:
                raise
            choice, raised = None, exc.buffers
        sync(self.device)
        wall = (time.perf_counter() - t0) * 1e3
        s = None if raised else dataclasses.replace(engine.last_stats)
        grew = {k: v - launches[k] for k, v in read_counts().items()}
        moved = {side: {o: n - before[side][o] for o, n in d.items() if n != before[side][o]}
                 for side, d in outcomes(engine).items()}
        label = f"stream {leg} epoch {len(self.records)}"
        if corrupt:
            if raised is None or "choice" not in raised or not engine.quarantined:
                raise AssertionError(f"{label}: a flipped choice bit gave {raised}")
            refined, cold = True, False
        else:
            refined, cold = s.refined, s.cold_start
            counts = np.bincount(choice, minlength=C)
            if choice.min() < 0 or choice.max() >= C or counts.max() - counts.min() > 1:
                raise AssertionError(f"{label}: choice outside [0, C) or count spread > 1")
            if not cold and s.churn > 2 * STREAM_BUDGET + s.repaired_rows:
                raise AssertionError(f"{label}: churn {s.churn} past the budget's bound")
        # Predicted outcomes: a warm dispatch over a live resident plans a
        # delta upload (applied when at most 512 lags changed since the
        # mirror) and reads back O(changed); a stale resident is rebuilt.
        want = {"delta": {}, "readback": {}}
        if refined and self.live and (corrupt or s.repaired_rows == 0):
            n = int((lags != self.mirror).sum())
            want["delta"] = {"applied" if n <= 512 else "fallback": 1}
            want["readback"] = {} if corrupt else {"applied": 1}
        if moved != want:
            raise AssertionError(f"{label}: outcomes {moved}, expected {want}")
        if self.device.type == "cuda" and (
                grew["state_digest"] != int(refined) + int(cold)
                or grew["rounds_scan"] != int(cold)):
            raise AssertionError(f"{label}: launches {grew} for refined={refined} cold={cold}")
        if corrupt:
            self.live, self.mirror = False, None
        elif refined or cold:
            self.live, self.mirror = True, lags.copy()
        self.last_lags = lags
        kind = ("corrupt" if corrupt else "trip" if s.guardrail_tripped else "cold" if cold
                else "noop" if not refined else "delta" if moved["delta"].get("applied")
                else "refine")
        self.records.append((leg, kind, choice, s, moved, raised, wall))
        log(f"{label:28s} {kind:7s} wall {wall:9.3f} ms "
            + (f"raised CorruptStateDetected({raised})" if corrupt else
               f"churn {s.churn} repaired {s.repaired_rows} quality_ratio "
               f"{s.quality_ratio:.4f} rounds {s.refine_rounds} exchanges "
               f"{s.refine_exchanges}")
            + f" outcomes {moved} launches {grew}")
        return choice

    def remap(self, old_to_new: np.ndarray, C: int) -> None:
        self.engine.remap_members(old_to_new, C)
        self.live, self.mirror = False, None

    def run(self) -> "StreamRun":
        rng, lags0 = stream_lags0(STREAM_P)
        choice = self.epoch("schedule", lags0)
        lags = lags0.astype(np.float64)
        for e in range(10):  # bench.py's drift schedule
            lags = stream_drift(rng, lags, e, choice, STREAM_C)
            choice = self.epoch("schedule", lags.astype(np.int64))
        cur = lags.astype(np.int64)
        for _ in range(3):
            cur = heat(cur, choice, STREAM_C)
            choice = self.epoch("delta", cur)
        leave = np.arange(STREAM_C, dtype=np.int32) - (np.arange(STREAM_C) > STREAM_C // 2)
        leave[STREAM_C // 2] = -1
        self.remap(leave, STREAM_C - 1)
        choice = self.epoch("membership", cur)
        self.remap(np.arange(STREAM_C - 1, dtype=np.int32), STREAM_C)
        choice = self.epoch("membership", cur)
        # The drill: a live resident, one flipped bit of its choice tensor,
        # then the same lags twice: the first dispatch raises, the next heals.
        cur = heat(cur, choice, STREAM_C)
        choice = self.epoch("drill", cur)
        resident_choice = self.engine._resident[0]
        host = resident_choice[:STREAM_P].cpu().numpy()
        resident_choice[:STREAM_P].copy_(torch.from_numpy(scrub.flip_bit(host, seed=5)))
        cur = heat(cur, choice, STREAM_C)
        self.epoch("drill", cur, corrupt=True)
        self.epoch("drill", cur)
        if self.engine.quarantined or self.engine.needs_dense_resync:
            raise AssertionError("the epoch after the corrupted one did not heal")
        return self


def same_runs(a: StreamRun, b: StreamRun, what: str) -> None:
    """Two runs of the legs give the same bits at every epoch."""
    for i, (x, y) in enumerate(zip(a.records, b.records)):
        if not (x[0] == y[0] and np.array_equal(x[2], y[2]) and x[3] == y[3]
                and x[4:6] == y[4:6]):
            raise AssertionError(f"stream epoch {i} ({x[0]}): {what} differ")
    if len(a.records) != len(b.records):
        raise AssertionError(f"stream: {what} ran {len(a.records)} and {len(b.records)} epochs")
    log(f"stream: {what} give the same choice, stats and outcomes at all "
        f"{len(a.records)} epochs")


def streaming_path(device):
    """Path c: the streaming engine at full config 5.  Returns (the launches
    of the first run on the card, counted from just before it to just after,
    and the second run, whose walls phase 5 reports)."""
    reset_counts()
    first = StreamRun(device).run()
    launches = read_counts()
    log(f"main path (streaming): launches {launches}")
    second = StreamRun(device).run()
    same_runs(first, second, "two runs on the card")
    cpu = StreamRun(torch.device("cpu"), bucket=pad_bucket).run()
    same_runs(first, cpu, "the card and the CPU engine at the card's bucket")
    return launches, second


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


def k1_cases(device):
    """K1's two timed shapes, as the main path makes them: (name, (gains,
    valid, totals0), carry).  Config 5 is one block of 100 rounds of 1,000
    consumers; config 3 ``global`` one block of 256 rounds of 64."""
    lags, members = baseline_workload(5)
    P = lags["t0"].size
    yield ("config 5", round_inputs(lags["t0"][None], np.array([P]), len(members), device),
           False)
    lags, members = baseline_workload(3)
    table = np.stack([lags[t] for t in sorted(lags)])
    yield ("config 3 global",
           round_inputs(table, np.full(len(table), table.shape[1]), len(members), device), True)


def k1_times(device) -> dict:
    """K1 through its wrapper at each of ``k1_cases``: the CUDA-event time
    (the wrapper's checks and host read included), the device time alone
    (profiler, by kernel name), per round and per network stage, beside the
    bound.  Uses only the wrapper's public interface, so that it times any
    version of the package on the path."""
    out = {}
    for name, (gains, valid, totals0), carry in k1_cases(device):
        T, R, C = gains.shape
        depth = T * R if carry else R  # rounds in one block's chain

        def fn():
            return rounds_cuda.rounds_scan(gains, valid, totals0, carry)

        event = median_event_ms(fn)
        alone, per_call = device_ms(fn, KERNEL_NAMES["rounds_scan"])
        bound, bound_by, stages = bound_ms(T, R, C)
        packed = getattr(rounds_cuda, "packed_rank_bits", None)
        rank_bits = packed(gains, valid, totals0, carry) if packed else None
        two_key = None
        if rank_bits:  # the same inputs forced into the two-key form
            two_key, _ = device_ms(
                lambda: rounds_cuda._launch(gains, valid, totals0, carry, 0),
                KERNEL_NAMES["rounds_scan"])
        out[name] = {
            "T": T, "R": R, "C": C, "carry": carry, "rank_bits": rank_bits,
            "event_ms": event, "alone_ms": alone, "launches_a_call": per_call,
            "ns_a_round": alone * 1e6 / depth, "ns_a_stage": alone * 1e6 / (depth * stages),
            "two_key_alone_ms": two_key, "bound_ms": bound, "bound_by": bound_by,
        }
        log(f"times  rounds_scan at {name} (T={T} R={R} C={C} carry={carry}, rank_bits "
            f"{rank_bits}): event {event!r} ms, device time alone {alone!r} ms "
            f"({per_call!r} kernels a call), {alone * 1e6 / depth!r} ns a round, "
            f"{alone * 1e6 / (depth * stages)!r} ns a stage of {stages}, bound {bound!r} ms "
            f"({bound_by}); forced into the two-key form, alone {two_key!r} ms")
    return out


def assign_walls(cfg: int, solver: str, device, repeats: int = REPEATS, refine=None):
    """Medians of ``repeats`` ``assign()`` calls after 3 warm-ups, host
    clock, ending in a synchronize: (wall, lag read, solve, min wall)."""
    lags, members = baseline_workload(cfg)
    assignor, cluster, group = plugin(lags, members, solver, device, refine)
    walls, parts = [], []
    for i in range(repeats + 3):
        t0 = time.perf_counter()
        assignor.assign(cluster, group)
        torch.cuda.synchronize()
        if i >= 3:
            walls.append((time.perf_counter() - t0) * 1e3)
            stats = assignor.last_stats
            parts.append((stats.lag_read_ms, stats.solve_ms))
    return (statistics.median(walls), statistics.median(p[0] for p in parts),
            statistics.median(p[1] for p in parts), min(walls))


def times(device) -> dict:
    """K1 at config 5 (the launch alone, through the wrapper, the plain
    version), ``k1_times`` and the config-5 ``rounds`` walls.  Returns the
    kernels-line fields."""
    lags, members = baseline_workload(5)
    P = lags["t0"].size
    C = len(members)
    gains, valid, totals0 = round_inputs(lags["t0"][None], np.array([P]), C, device)
    T, R, _ = gains.shape
    rb = rounds_cuda.packed_rank_bits(gains, valid, totals0)
    kernel = median_event_ms(lambda: rounds_cuda._launch(gains, valid, totals0, False, rb))
    wrapper = median_event_ms(lambda: rounds_cuda.rounds_scan(gains, valid, totals0))
    plain = median_event_ms(
        lambda: rounds_cuda.rounds_scan_torch(gains, valid, totals0, False, rb))
    plain_two_key = median_event_ms(
        lambda: rounds_cuda.rounds_scan_torch(gains, valid, totals0, False, 0))
    bound, bound_by, stages = bound_ms(T, R, C)
    log(f"times at config 5 (T={T} R={R} C={C}, rank_bits {rb}, {R * stages} network "
        f"stages): kernel {kernel!r} ms ({kernel * 1e6 / (R * stages):.1f} ns a stage), "
        f"wrapper with its checks {wrapper!r} ms, plain version on the card {plain!r} ms "
        f"(its two-key body {plain_two_key!r} ms), bound {bound!r} ms ({bound_by})")
    alone = k1_times(device)["config 5"]["alone_ms"]
    wall, lag_read, solve, fastest = assign_walls(5, "rounds", device)
    log(f"assign() at config 5 rounds, medians of {REPEATS} (host clock): wall "
        f"{wall!r} ms (min {fastest!r}), of which lag read {lag_read!r} ms "
        f"(FakeBroker), solve {solve!r} ms, the rest (stats, result objects) "
        f"{wall - lag_read - solve!r} ms; the kernel is {kernel / wall:.4%} of the wall")
    return dict(ms=kernel, alone_ms=alone, plain_ms=plain, bound_ms=bound, bound_by=bound_by,
                library_ms=None)


def k7_cases(device):
    """K7's inputs as the main path makes them, at configs 5 and 3: each
    topic padded to its bucket, sorted into processing order.  Yields
    (name, sorted lags, sorted valid, C, valid rows of all topics)."""
    for cfg in (5, 3):
        lags, members = baseline_workload(cfg)
        table = np.stack([pad_topic_rows(lags[t])[0] for t in sorted(lags)])
        n_valid = np.array([lags[t].size for t in sorted(lags)])
        T, P = table.shape
        L = torch.from_numpy(table).to(device)
        pids = torch.arange(P, dtype=torch.int32, device=device).expand(T, P)
        V = torch.arange(P, device=device)[None, :] < torch.from_numpy(n_valid).to(device)[:, None]
        _, sl, sv = sort_partitions_with(L, pids, V, pack_shift_for(int(table.max()), P - 1))
        yield (f"config {cfg}", sl.contiguous(), sv.to(torch.uint8).contiguous(), len(members),
               int(n_valid.sum()))


def k7_bound(T: int, P: int, C: int, steps: int) -> tuple:
    """(bound ms, "bytes" or "operations"): each input read once and each
    output written once over the HBM rate, or one compare a consumer a
    step (the argmin this run's valid rows need) over the scalar rate."""
    moved = T * P * (8 + 1 + 4) + T * C * (4 + 8)
    by_bytes = moved / HBM_BYTES_PER_S * 1e3
    by_ops = steps * C / SCALAR_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def once_event_ms(fn) -> tuple:
    """(CUDA-event ms of one ``fn()`` call, its result)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def k7_times(device) -> dict:
    """K7 through its wrapper at configs 5 and 3: CUDA-event time, device
    time alone (profiler, by kernel name), time a step of the deepest
    topic, the bound; its plain version on the card, a median at config 3
    and one call at config 5 (a 100k-step torch loop), whose output must
    equal the kernel's."""
    out = {}
    for name, sl, sv, C, steps in k7_cases(device):
        T, P = sl.shape
        depth = int(sv.sum(dim=1).max())

        def fn():
            return scan_cuda.scan_greedy(sl, sv, C)

        event = median_event_ms(fn)
        alone, per_call = device_ms(fn, KERNEL_NAMES["scan_greedy"])
        bound, bound_by = k7_bound(T, P, C, steps)
        if name == "config 3":
            plain = median_event_ms(lambda: scan_cuda.scan_greedy_torch(sl, sv, C))
        else:
            plain, want = once_event_ms(lambda: scan_cuda.scan_greedy_torch(sl, sv, C))
            if not all(torch.equal(a, b) for a, b in zip(fn(), want)):
                raise AssertionError(f"scan_greedy disagrees with its plain version at {name}")
        out[name] = {"T": T, "P": P, "C": C, "depth": depth, "event_ms": event,
                     "alone_ms": alone, "launches_a_call": per_call,
                     "ns_a_step": alone * 1e6 / depth, "bound_ms": bound, "bound_by": bound_by,
                     "plain_ms": plain}
        log(f"times  scan_greedy at {name} (T={T} P={P} C={C}, {depth} dependent steps): event "
            f"{event!r} ms, device time alone {alone!r} ms ({per_call!r} kernels a call), "
            f"{alone * 1e6 / depth!r} ns a step, bound {bound!r} ms ({bound_by}), plain "
            f"version on the card {plain!r} ms"
            + (" (one call)" if name == "config 5" else ""))
    return out


def solver_times(device, plain_cpu_ms: dict) -> dict:
    """K7's times (``k7_times``) and the ``assign()`` walls of ``scan`` and
    of ``rounds`` + 16 refine rounds at config 5, medians of 10.  Returns
    the kernels-line fields: the standard ones at config 5, where K7 spends
    its time; config 3's under ``config3_*``; the CPU plain version's time
    from phase 3 under ``plain_cpu_ms``."""
    k7 = k7_times(device)
    for solver, refine_iters in (("scan", None), ("rounds", REFINE_ITERS)):
        wall, lag_read, solve, fastest = assign_walls(5, solver, device, 10, refine_iters)
        log(f"assign() at config 5 {solver} refine {refine_iters}, medians of 10 (host "
            f"clock): wall {wall!r} ms (min {fastest!r}), lag read {lag_read!r} ms, solve "
            f"{solve!r} ms")
    c3, c5 = k7["config 3"], k7["config 5"]
    return dict(ms=c5["event_ms"], alone_ms=c5["alone_ms"], plain_ms=c5["plain_ms"],
                bound_ms=c5["bound_ms"], bound_by=c5["bound_by"], library_ms=None,
                depth=c5["depth"], ns_a_step=c5["ns_a_step"],
                plain_cpu_ms=plain_cpu_ms["config 5"],
                config3_ms=c3["event_ms"], config3_alone_ms=c3["alone_ms"],
                config3_plain_ms=c3["plain_ms"], config3_bound_ms=c3["bound_ms"],
                config3_plain_cpu_ms=plain_cpu_ms["config 3"])


def exp_bound(exps: int, moved: int) -> tuple:
    """(bound ms, "operations" or "bytes"): the larger of the exps over the
    card's exp rate and the bytes over its memory rate."""
    by_ops, by_bytes = exps / EXPS_PER_S * 1e3, moved / HBM_BYTES_PER_S * 1e3
    return max(by_ops, by_bytes), "operations" if by_ops >= by_bytes else "bytes"


def softmax_library(ws, A, B, weights):
    """The library yardstick: torch.softmax over the materialized logits,
    then one matrix product per weight vector (timed, never used by the
    port)."""
    x = torch.softmax(-ws[:, None] * A + B, dim=1)
    return [torch.mv(x.T, w) for w in weights]


def superblock_library(ws_b, cnt_b, A, B):
    Sb = ws_b.shape[0]
    x = torch.softmax(-ws_b.reshape(-1)[:, None] * A + B, dim=1).reshape(Sb, -1, A.shape[0])
    return [torch.matmul(w.reshape(Sb, 1, -1), x) for w in (ws_b, cnt_b)]


def device_profile(fn, kernel: str) -> dict:
    """What one ``fn()`` enqueues on the device, from torch.profiler's CUDA
    activity over REPEATS calls, divided by REPEATS: ``alone_ms``, the time
    in the CUDA kernels whose name holds ``kernel`` (one of KERNEL_NAMES),
    and ``launches``, their count; ``all_ops_ms``, the time of everything
    the call enqueued (kernels, memsets and copies); ``kernels`` and
    ``memsets``, the counts of each.  Unlike the CUDA-event time it leaves
    out the host's launch gaps.  A session first runs REPEATS calls with
    the profiler warming up (their records are dropped), then records
    REPEATS calls.  A session that lost records (an op counted a number of
    times that is not a multiple of REPEATS) or gave the named kernels no
    time is repeated, up to five in all; raises when none was whole, so that
    neither a renamed kernel nor a lost record can read as a cheaper call."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        sessions = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: sessions.append(p.key_averages())) as prof:
            for _ in range(2):
                for _ in range(REPEATS):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        cuda = [e for e in sessions[-1]
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "Activity Buffer" not in e.key]
        hits = [e for e in cuda if kernel in e.key]
        lost = [(e.key[:40], e.count) for e in cuda if e.count % REPEATS]
        if hits and sum(e.self_device_time_total for e in hits) > 0 and not lost:
            def ms(events):
                return sum(e.self_device_time_total for e in events) / REPEATS / 1e3

            def count(events):
                return sum(e.count for e in events) // REPEATS

            return {
                "alone_ms": ms(hits),
                "launches": count(hits),
                "all_ops_ms": ms(cuda),
                "kernels": count(e for e in cuda
                                 if "Memset" not in e.key and "Memcpy" not in e.key),
                "memsets": count(e for e in cuda if "Memset" in e.key),
            }
        log(f"profiler session {attempt + 1} lost records or gave no time to kernels named "
            f"{kernel!r}; it recorded {[(e.key[:40], e.count) for e in cuda]}")
    raise AssertionError(f"no whole profiler session for kernels named {kernel!r}")


def device_ms(fn, kernel: str) -> tuple:
    """(device time alone, launches) of one ``fn()`` in the kernels named
    ``kernel`` (``device_profile``)."""
    prof = device_profile(fn, kernel)
    return prof["alone_ms"], prof["launches"]


def op_times(fn, kernel: str) -> dict:
    """CUDA-event time of ``fn()`` (median of REPEATS) beside its
    ``device_profile``."""
    return {"event_ms": median_event_ms(fn), **device_profile(fn, kernel)}


def call_plan_stats(args, need: str):
    """K3 through its public wrapper for ``need``; a package without
    ``need`` (this change's parent) computes both marginals."""
    if HAS_NEED:
        return plan_stats.plan_stats(*args, need=need)
    return plan_stats.plan_stats(*args)


HAS_NEED = "need" in inspect.signature(plan_stats.plan_stats).parameters


def one_launch_a_call(device) -> None:
    """From the profiler: one call of K3 at the dense main path's shapes
    (configs 2 and 4, ``need`` load and colsum) and of K6 at config 5's
    resident state enqueues one kernel and no memset."""
    calls = []
    for config in (2, 4):
        (ws, cnt, wsum), C = dedup_case(config, device)
        args = (ws, cnt, wsum, *random_duals(C, device))
        for need in ("load", "colsum"):
            calls.append((f"plan_stats config {config} need={need}", "plan_stats",
                          lambda args=args, need=need: call_plan_stats(args, need)))
    lags, choice, counts, tab = resident_case(pad_bucket(STREAM_P), STREAM_P, STREAM_C, device)
    calls.append(("state_digest config 5", "state_digest",
                  lambda: refine.state_digest(lags, choice, counts, STREAM_C, row_tab=tab)))
    for label, name, fn in calls:
        prof = device_profile(fn, KERNEL_NAMES[name])
        log(f"enqueued a call  {label}: {prof['kernels']!r} kernels, {prof['memsets']!r} "
            f"memsets")
        if prof["kernels"] != 1 or prof["memsets"] != 0:
            raise AssertionError(f"{label}: a call enqueued {prof}, not one kernel")


def k3_times(device) -> dict:
    """K3 through its public wrapper at the dense path's shapes (configs 2
    and 4), for each ``need`` (``op_times``), and its library yardstick for
    the load alone (softmax and one ``mv``, beside need=load) and for both
    marginals (softmax and two, beside need=both): CUDA-event time and
    device time of all its ops.  Returns {config: row}."""
    out = {}
    for config in (2, 4):
        (ws, cnt, wsum), C = dedup_case(config, device)
        A, B = random_duals(C, device)
        args = (ws, cnt, wsum, A, B)
        row = {"U_pad": ws.shape[0], "U": int((cnt > 0).sum()), "C": C}
        for need in ("load", "colsum", "both"):
            row[need] = op_times(lambda: call_plan_stats(args, need),
                                 KERNEL_NAMES["plan_stats"])
        for need, weights in (("load", (wsum,)), ("both", (wsum, cnt))):
            def library(weights=weights):
                return softmax_library(ws, A, B, weights)

            row[f"library_{need}"] = {"event_ms": median_event_ms(library),
                                      "all_ops_ms": device_profile(library, "")["all_ops_ms"]}
        out[config] = row
        log(f"times  plan_stats at config {config} (U_pad {row['U_pad']}, {row['U']} with "
            f"weight, C {C}): " + "; ".join(
                f"need={need} event {row[need]['event_ms']!r} ms, alone "
                f"{row[need]['alone_ms']!r} ms, all ops {row[need]['all_ops_ms']!r} ms "
                f"({row[need]['kernels']!r} kernels, {row[need]['memsets']!r} memsets)"
                for need in ("load", "colsum", "both"))
            + "; " + "; ".join(
                f"library yardstick for need={need} event {row[f'library_{need}']['event_ms']!r}"
                f" ms, device time (all its ops) {row[f'library_{need}']['all_ops_ms']!r} ms"
                for need in ("load", "both")))
    return out


def quality_times(device) -> dict:
    """Each f32 kernel at its main-path shape: kernel (K3 through its
    wrapper for the load, as the duals loop's first call), plain version
    and library yardstick (CUDA events, medians of 30), the kernel's device
    time alone and of all its ops (profiler) and its bound; then the
    sinkhorn walls.  Returns {name: kernels-line fields}."""
    k3 = k3_times(device)[4]
    (ws, cnt, wsum), C = dedup_case(4, device)
    A, B = random_duals(C, device)
    U = int((cnt > 0).sum())
    out = {"plan_stats": dict(
        zip(("bound_ms", "bound_by"), exp_bound(U * C, 4 * (2 * ws.shape[0] + 3 * C))),
        ms=k3["load"]["event_ms"], alone_ms=k3["load"]["alone_ms"],
        all_ops_ms=k3["load"]["all_ops_ms"],
        plain_ms=median_event_ms(
            lambda: plan_stats.plan_stats_torch(ws, cnt, wsum, A, B, "load")),
        library_ms=k3["library_load"]["event_ms"],
        library_alone_ms=k3["library_load"]["all_ops_ms"],
    )}
    shapes = {"plan_stats": f"config 4: U_pad {ws.shape[0]} ({U} with weight), C {C}, "
                            "need=load"}

    (ws_b, cnt_b), C = blocks_case(5, device)
    A, B = random_duals(C, device)
    # Rows with a weight: the corrector pass and K5 compute those with ws or
    # cnt non-zero, the predictor those with ws non-zero.
    rows = int(((ws_b != 0) | (cnt_b != 0)).sum())
    load_rows = int((ws_b != 0).sum())
    Sb = ws_b.shape[0]
    sc, prev = torch.tensor(1.0, device=device), torch.tensor(float("inf"), device=device)
    eta = linear_ot.MIRROR_PROX_ETA

    def k5():
        return linear_ot_cuda.superblock_partials(ws_b, cnt_b, A, B)

    def k4():
        return linear_ot_cuda.mirror_prox_step(ws_b, cnt_b, A, B, sc, prev, eta=eta)

    out["superblock_partials"] = dict(
        zip(("bound_ms", "bound_by"),
            exp_bound(rows * C, 4 * (2 * ws_b.numel() + 2 * C + 2 * Sb * C))),
        ms=median_event_ms(k5),
        plain_ms=median_event_ms(lambda: linear_ot._superblock_partials(ws_b, cnt_b, A, B)),
        library_ms=median_event_ms(lambda: superblock_library(ws_b, cnt_b, A, B)),
    )
    out["mirror_prox_step"] = dict(
        zip(("bound_ms", "bound_by"),
            exp_bound((rows + load_rows) * C, 4 * (2 * ws_b.numel() + 2 * C + 2 + 3 * C))),
        ms=median_event_ms(k4),
        plain_ms=median_event_ms(lambda: linear_ot_cuda.mirror_prox_step_torch(
            ws_b, cnt_b, A, B, sc, prev, eta=eta)),
        library_ms=None,
    )
    shape = f"config 5: {list(ws_b.shape)} ({rows} valid rows), C {C}"
    # K5 with both marginals is the launch of K4's corrector pass; the
    # predictor pass launches it for the load only.
    shapes.update(superblock_partials=f"{shape}, both marginals",
                  mirror_prox_step=shape)
    for name, fn in (("superblock_partials", k5), ("mirror_prox_step", k4)):
        prof = device_profile(fn, KERNEL_NAMES[name])
        out[name].update(alone_ms=prof["alone_ms"], all_ops_ms=prof["all_ops_ms"])
    per_step = device_profile(k4, KERNEL_NAMES["mirror_prox_step"])["launches"]
    if per_step > 2:
        raise AssertionError(f"mirror_prox_step launched {per_step} kernels a step")
    log(f"mirror_prox_step: {per_step!r} kernel launches a step (profiler)")

    for name, t in out.items():
        log(f"times  {name:19s} at {shapes[name]}: kernel {t['ms']!r} ms (device time "
            f"alone {t['alone_ms']!r} ms, all ops {t['all_ops_ms']!r} ms), plain version "
            f"{t['plain_ms']!r} ms, library yardstick {t['library_ms']!r} ms, bound "
            f"{t['bound_ms']!r} ms ({t['bound_by']}), {t['ms'] / t['bound_ms']:.1f}x the bound")
    for cfg in (4, 5):
        wall, lag_read, solve, fastest = assign_walls(cfg, "sinkhorn", device)
        log(f"assign() at config {cfg} sinkhorn, medians of {REPEATS} (host clock): "
            f"wall {wall!r} ms (min {fastest!r}), lag read {lag_read!r} ms, solve "
            f"{solve!r} ms ({solve / wall:.2%} of the wall)")
    return out


def profiled_assign(cfg: int, solver: str, refine_iters, device) -> dict:
    """One assign() of a phase-4 cell under torch.profiler: its wall (ms,
    host clock), the device's busy time (ms), the port's kernels' part of
    it and the five busiest device ops.  A session first runs one assign()
    with the profiler warming up (its records are dropped), then records
    one.  Every main-path cell launches a port kernel, so a session that
    recorded none of them lost its records: it is repeated, up to three in
    all; ``None`` when none was whole."""
    from torch.profiler import ProfilerActivity, profile, schedule

    lags, members = baseline_workload(cfg)
    assignor, cluster, group = plugin(lags, members, solver, device, refine_iters)
    assignor.assign(cluster, group)
    ours = tuple(dict.fromkeys(KERNEL_NAMES.values()))
    for attempt in range(3):
        sessions, walls = [], []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: sessions.append(p.key_averages())) as prof:
            for _ in range(2):
                t0 = time.perf_counter()
                assignor.assign(cluster, group)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                prof.step()
        events = [
            e for e in (sessions[-1] if sessions else [])
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "Activity Buffer" not in e.key
        ]
        kernels = sum(
            e.self_device_time_total for e in events if any(k in e.key for k in ours)
        ) / 1e3
        if kernels > 0:
            top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
            return {
                "wall_ms": walls[-1],
                "busy_ms": sum(e.self_device_time_total for e in events) / 1e3,
                "kernels_ms": kernels,
                "top": [(e.key[:48], e.self_device_time_total / 1e3, e.count) for e in top],
            }
        log(f"profiler session {attempt + 1} of an assign() recorded no port kernel; it "
            f"recorded {[(e.key[:40], e.count) for e in events]}")
    return None


def device_shares(device) -> None:
    """One profiled assign() per main-path cell: the device's busy time
    (kernels and copies, from torch.profiler's CUDA activity), the port's
    kernels' share of it, and the device's idle share of the wall.  A cell
    whose sessions all lost their records is profiled again in a new
    process (``--device-share``), whose profiler starts afresh; it raises
    when that fails too."""
    cells = [(cfg, solver, None) for cfg in (5, 3) for solver in ("rounds", "global")]
    cells += [(cfg, "sinkhorn", None) for cfg in SINKHORN_CONFIGS]
    cells += [(cfg, solver, refine_iters) for cfg in (5, 3)
              for solver, refine_iters in (("scan", None), ("rounds", REFINE_ITERS))]
    for cfg, solver, refine_iters in cells:
        share = profiled_assign(cfg, solver, refine_iters, device)
        label = solver if refine_iters is None else f"{solver}+refine{refine_iters}"
        if share is None:
            log(f"device share  config {cfg} {label}: profiled again in a new process")
            share = device_share_in_child(cfg, solver, refine_iters)
        log(f"device share  config {cfg} {label:16s}: wall {share['wall_ms']!r} ms (profiled), "
            f"device busy {share['busy_ms']!r} ms, of which the port's kernels "
            f"{share['kernels_ms']!r} ms; idle share {1 - share['busy_ms'] / share['wall_ms']!r}; "
            "top: " + "; ".join(f"{k} {ms:.3f} ms x{n}" for k, ms, n in share["top"]))


def device_share_in_child(cfg: int, solver: str, refine_iters) -> dict:
    """``profiled_assign`` of one cell in a new process of this script (its
    kernels are built already); raises when that process fails or its
    sessions lost their records too."""
    argv = [sys.executable, os.path.abspath(__file__), "--device-share", str(cfg), solver,
            str(refine_iters or 0)]
    done = subprocess.run(argv, capture_output=True, text=True, timeout=300)
    lines = done.stdout.strip().splitlines()
    share = json.loads(lines[-1]).get("device_share") if done.returncode == 0 and lines else None
    if share is None:
        raise AssertionError(
            f"no profiler session of an assign() at config {cfg} {solver} recorded a port "
            f"kernel, in this process or a new one (rc {done.returncode}): "
            f"{done.stdout[-2000:]}{done.stderr[-2000:]}")
    return share


def profiled_epoch(engine, lags: np.ndarray):
    """One rebalance under torch.profiler: (stats, wall ms, device busy ms,
    the digest kernel's ms, device-to-host copies, top device events)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.rebalance(lags)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and "Activity Buffer" not in e.key
    ]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    digest = sum(e.self_device_time_total for e in events
                 if KERNEL_NAMES["state_digest"] in e.key) / 1e3
    reads = sum(e.count for e in events if "DtoH" in e.key)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
    return engine.last_stats, wall, busy, digest, reads, top


def stream_times(run: StreamRun):
    """The digest kernel at the resident state the legs left (config 5)
    through its wrapper (``op_times``), its plain version and its bound;
    the epoch walls of ``run`` by type; one profiled warm-refine epoch.
    Returns the kernels-line fields."""
    engine = run.engine
    choice_p, row_tab, counts, lags_p = engine._resident
    C, M = engine.num_consumers, row_tab.shape[1]
    t = op_times(lambda: refine.state_digest(lags_p, choice_p, counts, C, row_tab=row_tab),
                 KERNEL_NAMES["state_digest"])
    plain = median_event_ms(lambda: digest_plain(lags_p, choice_p, counts, C, row_tab))
    # Each input read once, the owner of every valid slot gathered once, the
    # five lanes written once.
    valid_slots = int(torch.clamp(counts, max=M).sum())
    moved = 8 * lags_p.numel() + 4 * (choice_p.numel() + C + C * M + valid_slots) + 8 * 5
    bound = moved / HBM_BYTES_PER_S * 1e3
    log(f"times  state_digest at B={lags_p.numel()} C={C} M={M} ({valid_slots} valid slots): "
        f"wrapper {t['event_ms']!r} ms (device time alone {t['alone_ms']!r} ms, all ops "
        f"{t['all_ops_ms']!r} ms: {t['kernels']!r} kernels, {t['memsets']!r} memsets), plain "
        f"version {plain!r} ms, bound {bound!r} ms ({moved} bytes), "
        f"{t['event_ms'] / bound:.1f}x the bound")

    walls = {}
    for leg, kind, *_, wall in run.records:
        walls.setdefault(kind, []).append(wall)
    log("stream epoch walls (host clock, second run on the card): " + "; ".join(
        f"{kind} p50 {statistics.median(w)!r} ms of {len(w)} (min {min(w)!r}, max {max(w)!r})"
        for kind, w in sorted(walls.items())))

    rng = np.random.default_rng(9)
    lags = (run.last_lags * rng.lognormal(0.0, 0.05, run.last_lags.shape[0])).astype(np.int64)
    lags = heat(lags, engine.export_state(), C)
    s, wall, busy, digest, reads, top = profiled_epoch(engine, lags)
    if not s.refined or s.guardrail_tripped:
        raise AssertionError(f"the profiled epoch did not refine warm: {s}")
    log(f"profiled warm-refine epoch (dense upload): wall {wall!r} ms, {s.refine_rounds} "
        f"rounds, {s.refine_exchanges} exchanges, device busy {busy!r} ms, of which "
        f"state_digest {digest!r} ms; idle share {1 - busy / wall!r}; {reads} device-to-host "
        "copies; top: " + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms "
                                    f"x{e.count}" for e in top))
    return dict(ms=t["event_ms"], alone_ms=t["alone_ms"], all_ops_ms=t["all_ops_ms"],
                plain_ms=plain, bound_ms=bound, bound_by="bytes", library_ms=None)


SOURCES = {
    "rounds_scan": ("csrc/rounds_scan.cu", "ops/rounds_pallas.py:194"),
    "plan_stats": ("csrc/plan_stats.cu", "ops/plan_stats.py:184"),
    "superblock_partials": ("csrc/linear_ot.cu", "ops/linear_ot_pallas.py:169"),
    "mirror_prox_step": ("csrc/linear_ot.cu", "ops/linear_ot_pallas.py:226"),
    "state_digest": ("csrc/state_digest.cu", "ops/linear_ot_pallas.py:350"),
    # No Pallas kernel: the JAX package's lax.scan in this function.
    "scan_greedy": ("csrc/scan_greedy.cu", None),
}
COUNTERPARTS = {"scan_greedy": "kafka_lag_based_assignor_tpu/ops/scan_kernel.py::"
                               "assign_topic_scan"}


def kernel_line(name, launches, err, t: dict) -> dict:
    source, replaces = SOURCES[name]
    line = {
        "name": name,
        "route": "cuda",
        "source": f"kafka_lag_based_assignor_tpu_torch/{source}",
        "replaces": None if replaces is None else f"kafka_lag_based_assignor_tpu/{replaces}",
        "launches": launches,
        "max_abs_err": err,
        **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                             "alone_ms")},
    }
    if name in COUNTERPARTS:
        line["counterpart"] = COUNTERPARTS[name]
    for key in ("library_alone_ms", "depth", "ns_a_step", "plain_cpu_ms", "config3_ms",
                "config3_alone_ms", "config3_plain_ms", "config3_bound_ms",
                "config3_plain_cpu_ms"):
        if key in t:
            line[key] = t[key]
    return line


def k36_times(device) -> dict:
    """K3 (``k3_times``), K6 through its wrapper at config 5's resident
    state, K5 and K4 alone at config 5, K1 alone (``k1_times``), the dense
    ``sinkhorn`` cells' quality ratios and K3's pass form (both marginals)
    at U 1,024 and C 2,000 and 16,384 and at U 4,096 and C 2,000; where the
    package has two K3 forms, each form alone at U = 1,024, 2,048, 4,096 and
    C = 16, 512, 1,024.  Uses only interfaces this change's parent has too,
    apart from the forms."""
    out = {"plan_stats": k3_times(device)}
    lags, choice, counts, tab = resident_case(pad_bucket(STREAM_P), STREAM_P, STREAM_C, device)
    out["state_digest"] = op_times(
        lambda: refine.state_digest(lags, choice, counts, STREAM_C, row_tab=tab),
        KERNEL_NAMES["state_digest"])
    (ws_b, cnt_b), C = blocks_case(5, device)
    A, B = random_duals(C, device)
    sc, prev = torch.tensor(1.0, device=device), torch.tensor(float("inf"), device=device)
    out["superblock_partials"] = device_ms(
        lambda: linear_ot_cuda.superblock_partials(ws_b, cnt_b, A, B),
        KERNEL_NAMES["superblock_partials"])[0]
    out["mirror_prox_step"] = device_ms(
        lambda: linear_ot_cuda.mirror_prox_step(ws_b, cnt_b, A, B, sc, prev,
                                                eta=linear_ot.MIRROR_PROX_ETA),
        KERNEL_NAMES["mirror_prox_step"])[0]
    out["rounds_scan"] = {name: t["alone_ms"] for name, t in k1_times(device).items()}
    out["quality_ratio"] = {
        cfg: assign_once(*baseline_workload(cfg), "sinkhorn", device)[1].quality_ratio
        for cfg in (2, 4)}
    # The pass form where the cluster cannot serve (C > 1,024), both
    # marginals, as both packages compute them.
    g = torch.Generator().manual_seed(3)
    wide = {}
    for U, C in ((1024, 2000), (1024, 16384), (4096, 2000)):
        ws = torch.rand(U, generator=g).mul_(4.0).to(device)
        cnt = torch.randint(0, 5, (U,), generator=g).float().to(device)
        args = (ws, cnt, ws * cnt, *random_duals(C, device, C))
        wide[f"U={U} C={C}"] = op_times(lambda: call_plan_stats(args, "both"),
                                        KERNEL_NAMES["plan_stats"])
    out["plan_stats_wide"] = wide
    if hasattr(plan_stats_cuda, "form_for"):
        g = torch.Generator().manual_seed(4)
        forms = {}
        for U in (1024, 2048, 4096):
            for C in (16, 512, 1024):
                ws = torch.rand(U, generator=g).mul_(4.0).to(device)
                cnt = torch.randint(0, 5, (U,), generator=g).float().to(device)
                args = (ws, cnt, ws * cnt, *random_duals(C, device, C))
                forms[f"U={U} C={C}"] = {
                    form: device_ms(lambda: plan_stats_cuda.launch(*args, need="load",
                                                                   form=form),
                                    KERNEL_NAMES["plan_stats"])[0]
                    for form in ("cluster", "pass")}
                forms[f"U={U} C={C}"]["chosen"] = plan_stats_cuda.form_for(U, C)
        out["forms"] = forms
    k3 = out["plan_stats"]
    log(f"k36  K3 alone (load/colsum/both): " + "; ".join(
        f"config {cfg} " + " / ".join(f"{k3[cfg][need]['alone_ms']!r}"
                                      for need in ("load", "colsum", "both"))
        + f" ms, library (load/both) {k3[cfg]['library_load']['all_ops_ms']!r} / "
        f"{k3[cfg]['library_both']['all_ops_ms']!r} ms" for cfg in (2, 4))
        + "; K3 pass form (both): " + "; ".join(
            f"{shape} alone {t['alone_ms']!r} ms all ops {t['all_ops_ms']!r} ms"
            for shape, t in out["plan_stats_wide"].items())
        + f"; K6 "
        f"alone {out['state_digest']['alone_ms']!r} ms, all ops "
        f"{out['state_digest']['all_ops_ms']!r} ms, event {out['state_digest']['event_ms']!r} "
        f"ms; K5 {out['superblock_partials']!r} ms; K4 {out['mirror_prox_step']!r} ms; "
        f"K1 {out['rounds_scan']}; quality ratios {out['quality_ratio']}")
    for shape, t in out.get("forms", {}).items():
        log(f"k36  K3 forms at {shape}: cluster {t['cluster']!r} ms, pass {t['pass']!r} ms, "
            f"chosen {t['chosen']}")
    return out


def ab(mode: str, roots) -> None:
    """Run ``--{mode}-times`` for the package of each checkout in ``roots``,
    in that order, each in a process of its own that imports the package
    from that root (for example parent, change, change, parent)."""
    runs = []
    for root in roots:
        proc = subprocess.run(
            [sys.executable, "-P", os.path.abspath(__file__), f"--{mode}-times"], cwd=root,
            env={**os.environ, "PYTHONPATH": os.path.abspath(root)},
            capture_output=True, text=True, timeout=900,
        )
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr)
            raise AssertionError(f"{mode} times of {root} exited {proc.returncode}")
        runs.append({"root": root, **json.loads(proc.stdout.strip().splitlines()[-1])})
    for run in runs:
        if mode == "k1":
            log(f"k1 a/b  {run['root']}: " + "; ".join(
                f"{name} alone {t['alone_ms']!r} ms event {t['event_ms']!r} ms"
                for name, t in run["k1_times"].items()))
        else:
            t = run["k36_times"]
            log(f"k36 a/b  {run['root']}: " + "; ".join(
                f"K3 config {cfg} load alone {t['plan_stats'][cfg]['load']['alone_ms']!r} ms "
                f"all ops {t['plan_stats'][cfg]['load']['all_ops_ms']!r} ms event "
                f"{t['plan_stats'][cfg]['load']['event_ms']!r} ms"
                for cfg in ("2", "4"))
                + "; K3 pass form (both): " + "; ".join(
                    f"{shape} alone {w['alone_ms']!r} ms all ops {w['all_ops_ms']!r} ms"
                    for shape, w in t["plan_stats_wide"].items())
                + f"; K6 alone {t['state_digest']['alone_ms']!r} ms all ops "
                f"{t['state_digest']['all_ops_ms']!r} ms event "
                f"{t['state_digest']['event_ms']!r} ms; K5 {t['superblock_partials']!r} ms; "
                f"K4 {t['mirror_prox_step']!r} ms; K1 {t['rounds_scan']}; quality ratios "
                f"{t['quality_ratio']}")
    log(json.dumps({f"{mode}_ab": runs}))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script measures the "
              "port on the card", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    for mode in ("k1", "k36"):
        if sys.argv[1:2] == [f"--{mode}-ab"]:
            ab(mode, sys.argv[2:])
            return 0
    name = environment()
    if sys.argv[1:] == ["--k1-times"]:
        log(json.dumps({"k1_times": k1_times(device), "device": name}))
        return 0
    if sys.argv[1:] == ["--k36-times"]:
        _build.build_all()
        log(json.dumps({"k36_times": k36_times(device), "device": name}))
        return 0
    if sys.argv[1:2] == ["--device-share"]:
        cfg, solver, refine_iters = int(sys.argv[2]), sys.argv[3], int(sys.argv[4]) or None
        log(json.dumps({"device_share": profiled_assign(cfg, solver, refine_iters, device)}))
        return 0
    build()
    max_err = kernels_vs_plain(device)
    f32_err = quality_kernels_vs_plain(device)
    digest_err = digest_vs_plain(device)
    one_launch_a_call(device)
    bulk_refine_vs_cpu(device)
    scan_err, k7_plain_cpu_ms = scan_vs_plain(device)
    refine_batched_vs_cpu(device)
    native_vs_rounds(device)
    rounds_launches = main_path(device)
    launches = sinkhorn_path(device)
    stream_launches, stream_run = streaming_path(device)
    solver_launches = solver_path(device)
    launches["rounds_scan"] += (rounds_launches + stream_launches["rounds_scan"]
                                + solver_launches["rounds_scan"])
    launches["state_digest"] = stream_launches["state_digest"]
    launches["scan_greedy"] = solver_launches["scan_greedy"]
    k1 = times(device)
    quality = quality_times(device)
    digest = stream_times(stream_run)
    k7 = solver_times(device, k7_plain_cpu_ms)
    device_shares(device)
    line = [dict(kernel_line("rounds_scan", launches["rounds_scan"], max_err, k1),
                 also_replaces="kafka_lag_based_assignor_tpu/ops/rounds_pallas.py:160")]
    for k, t in quality.items():
        line.append(kernel_line(k, launches[k], f32_err[k], t))
    line.append(kernel_line("state_digest", launches["state_digest"], digest_err, digest))
    line.append(kernel_line("scan_greedy", launches["scan_greedy"], scan_err, k7))
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
