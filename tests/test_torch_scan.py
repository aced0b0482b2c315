"""The port's P-step greedy scan against the JAX package, on the CPU.

``assign_topic_scan`` (with and without an eligible mask), the batched
``assign_batched_scan``, ``sort_partitions`` in both sort forms and the
plain version of the scan kernel (``scan_cuda.scan_greedy_torch``, which
the wrapper runs for CPU tensors) are held bit for bit against
``kafka_lag_based_assignor_tpu.ops.scan_kernel`` / ``ops.batched``: integer
arithmetic, so the tolerance is exact equality.  Inputs are made with
numpy from a seed.  The kernel itself runs on the card only; above 16,384
eligible consumers it sorts in its wide form, and the CPU takes those
groups too.

The kernel computes the scan as rounds of E valid rows (E the eligible
consumers); that round form, built here from the port's round scan
(``rounds_cuda.rounds_scan_torch``), is held bit for bit against the step
form and the JAX scan, and the wrapper's host rules (``scan_plan``, and
the main path's ``host_lag_range``) are tested as plain functions.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from kafka_lag_based_assignor_tpu.ops import batched as jax_batched  # noqa: E402
from kafka_lag_based_assignor_tpu.ops import scan_kernel as jax_scan  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops import (  # noqa: E402
    batched,
    dispatch,
    rounds_cuda,
    rounds_kernel,
    scan_cuda,
    scan_kernel,
)
from kafka_lag_based_assignor_tpu_torch.testing import (  # noqa: E402
    baseline_workload,
    lag_rows,
)

T = torch.from_numpy


def topic(seed, P, C, kind):
    """(lags, partition_ids, valid) of one topic: ``ties`` (lags 0..2),
    ``zero`` (all zero), ``zipf``, or ``huge`` (near 2^62, so that the
    consumers' totals wrap around int64)."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        lags = rng.integers(0, 3, P)
    elif kind == "zero":
        lags = np.zeros(P, np.int64)
    elif kind == "huge":
        lags = rng.integers(2**62 - 2**40, 2**62, P)
    else:
        lags = (rng.pareto(1.1, P) * 1000).astype(np.int64)
    pids = rng.permutation(P).astype(np.int32)
    valid = rng.random(P) < 0.85
    return lags.astype(np.int64), pids, valid


def jax_topic_scan(lags, pids, valid, C, eligible=None):
    out = jax_scan.assign_topic_scan(
        jnp.asarray(lags), jnp.asarray(pids), jnp.asarray(valid), C,
        None if eligible is None else jnp.asarray(eligible))
    return [np.array(x) for x in out]


def assert_equal(got, want):
    for name, g, w in zip(("choice", "counts", "totals"), got, want):
        assert g.dtype == T(w).dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize("kind", ["zipf", "ties", "zero", "huge"])
@pytest.mark.parametrize("P,C", [(1, 1), (9, 1), (40, 3), (64, 64), (50, 100), (777, 33)])
@pytest.mark.parametrize("seed", [0, 1])
def test_assign_topic_scan_matches_jax(seed, P, C, kind):
    lags, pids, valid = topic(seed, P, C, kind)
    got = scan_kernel.assign_topic_scan(T(lags), T(pids), T(valid), C)
    assert_equal(got, jax_topic_scan(lags, pids, valid, C))


@pytest.mark.parametrize("mask", ["some", "one", "none"])
@pytest.mark.parametrize("P,C", [(30, 5), (300, 40)])
def test_assign_topic_scan_eligible_matches_jax(P, C, mask):
    lags, pids, valid = topic(P + C, P, C, "zipf")
    rng = np.random.default_rng(C)
    eligible = {"some": rng.random(C) < 0.4, "one": np.arange(C) == C - 1,
                "none": np.zeros(C, bool)}[mask]
    got = scan_kernel.assign_topic_scan(T(lags), T(pids), T(valid), C, T(eligible))
    want = jax_topic_scan(lags, pids, valid, C, eligible)
    assert_equal(got, want)
    held = got[0].numpy()
    if mask == "none":
        assert (held == -1).all()
    else:
        assert eligible[held[valid]].all() and (held[~valid] == -1).all()


def test_assign_batched_scan_matches_jax():
    """A [T, P] batch with padding rows (each topic's own valid count, one
    topic all padding), in both sort forms."""
    rng = np.random.default_rng(8)
    Tn, P, C = 12, 96, 10
    lags = (rng.pareto(1.0, (Tn, P)) * 500).astype(np.int64)
    pids = np.broadcast_to(np.arange(P, dtype=np.int32), (Tn, P)).copy()
    valid = np.arange(P)[None] < rng.integers(0, P + 1, Tn)[:, None]
    valid[3] = False
    want = jax_batched.assign_batched_scan(
        jnp.asarray(lags), jnp.asarray(pids), jnp.asarray(valid), num_consumers=C)
    shift = scan_kernel.pack_shift_for(int(lags.max()), P - 1)
    assert shift > 0
    for pack_shift in (0, shift):
        got = batched.assign_batched_scan(T(lags), T(pids), T(valid), C,
                                          pack_shift=pack_shift)
        assert_equal(got, [np.array(x) for x in want])
    # The scan and the round decomposition give the same answer.
    rounds = rounds_kernel.assign_topic_rounds(T(lags), T(pids), T(valid), C)
    for s, r in zip(got, rounds):
        assert torch.equal(s, r)


@pytest.mark.parametrize("kind", ["zipf", "ties", "huge"])
def test_sort_partitions_matches_jax(kind):
    lags, pids, valid = topic(3, 500, 1, kind)
    want = np.asarray(jax_scan.sort_partitions(
        jnp.asarray(lags), jnp.asarray(pids), jnp.asarray(valid)))
    shift = scan_kernel.pack_shift_for(int(lags.max()), int(pids.max()))
    assert (shift > 0) == (kind != "huge")
    for pack_shift in {0, shift}:
        got = scan_kernel.sort_partitions(T(lags), T(pids), T(valid), pack_shift)
        np.testing.assert_array_equal(got.numpy(), want)
        if pack_shift:
            np.testing.assert_array_equal(got.numpy(), np.asarray(jax_scan.sort_partitions(
                jnp.asarray(lags), jnp.asarray(pids), jnp.asarray(valid), pack_shift)))


@pytest.mark.parametrize("eligible", [False, True])
def test_scan_greedy_torch_is_the_step_loop(eligible):
    """The plain version of the kernel on presorted rows (padding in the
    middle too, which the kernel must also treat as a no-op step) against
    JAX's scan over the same sorted rows, topic by topic."""
    rng = np.random.default_rng(4)
    Tn, P, C = 5, 120, 17
    lags = rng.integers(0, 1000, (Tn, P)).astype(np.int64)
    valid = rng.random((Tn, P)) < 0.7
    elig = rng.random(C) < 0.5 if eligible else None
    got = scan_cuda.scan_greedy(T(lags), T(valid.astype(np.uint8)), C,
                                None if elig is None else T(elig.astype(np.uint8)))
    # The JAX step body, one sorted row at a time: its argmin, then the
    # owner's count and total.
    for t in range(Tn):
        counts = np.zeros(C, np.int32)
        totals = np.zeros(C, np.int64)
        mask = np.ones(C, bool) if elig is None else elig
        for s in range(P):
            if not valid[t, s] or not mask.any():
                assert int(got[0][t, s]) == -1
                continue
            who = int(jax_scan._argmin_consumer(
                jnp.asarray(counts), jnp.asarray(totals), jnp.asarray(mask)))
            assert int(got[0][t, s]) == who
            counts[who] += 1
            totals[who] += lags[t, s]
        np.testing.assert_array_equal(got[1][t].numpy(), counts)
        np.testing.assert_array_equal(got[2][t].numpy(), totals)


def test_scan_limits_raise_on_the_cpu():
    """Bad inputs raise; one consumer above the register network's 16,384
    slots (once refused) is answered as the JAX scan answers it."""
    z = torch.zeros((2, 8), dtype=torch.int64)
    v = torch.ones((2, 8), dtype=torch.uint8)
    C = rounds_cuda.REGISTER_SLOTS + 1
    lags, pids, valid = topic(3, 3 * C // 2, C, "zipf")
    assert_equal(scan_kernel.assign_topic_scan(T(lags), T(pids), T(valid), C),
                 jax_topic_scan(lags, pids, valid, C))
    scan_cuda.scan_greedy(z, v, C)
    for bad in (
        lambda: scan_cuda.scan_greedy(z, v, 0),
        lambda: scan_cuda.scan_greedy(z.int(), v, 4),
        lambda: scan_cuda.scan_greedy(z, v.bool(), 4),
        lambda: scan_cuda.scan_greedy(z, v, 4, torch.ones(3, dtype=torch.uint8)),
        lambda: scan_cuda.scan_greedy(z.t(), v.t(), 4),
    ):
        with pytest.raises(ValueError):
            bad()


def round_form(sorted_lags, sorted_valid, C, eligible=None):
    """The scan's answer from the round decomposition: per topic, the
    eligible consumers and the valid rows compacted, the round scan over
    [1, R, E] from zero totals (two-key form: totals wrap), its positions
    mapped back to consumer indices."""
    Tn, P = sorted_lags.shape
    ids = (torch.arange(C) if eligible is None
           else torch.nonzero(eligible.bool()).flatten())
    E = ids.numel()
    choice = torch.full((Tn, P), -1, dtype=torch.int32)
    counts = torch.zeros((Tn, C), dtype=torch.int32)
    totals = torch.zeros((Tn, C), dtype=torch.int64)
    for t in range(Tn):
        rows = torch.nonzero(sorted_valid[t].bool()).flatten()
        n = rows.numel()
        if E == 0 or n == 0:
            continue
        R = -(-n // E)
        gains = torch.zeros(R * E, dtype=torch.int64)
        ok = torch.zeros(R * E, dtype=torch.uint8)
        gains[:n], ok[:n] = sorted_lags[t, rows], 1
        seat, tot = rounds_cuda.rounds_scan_torch(
            gains.view(1, R, E), ok.view(1, R, E), torch.zeros(E, dtype=torch.int64))
        seat = seat.flatten()[:n].long()
        choice[t, rows] = ids[seat].int()
        counts[t, ids] = torch.bincount(seat, minlength=E).int()
        totals[t, ids] = tot[0]
    return choice, counts, totals


ROUND_KINDS = ["ties", "zero", "huge", "zipf"]


@pytest.mark.parametrize("n_eligible", ["0", "1", "2", "C-1", "C"])
@pytest.mark.parametrize("C", [1, 2, 31, 33, 64])
def test_round_form_is_the_scan(C, n_eligible):
    """Three topics of 97 sorted rows (all valid; invalid at the end;
    invalid in the middle and at the end), tied, zero, zipf or near-2^62
    lags (wrapping totals): the round form equals ``scan_greedy_torch`` and
    the JAX scan (one topic at a time, rows already in processing order)
    in choice, counts and totals."""
    rng = np.random.default_rng(C * 10 + len(n_eligible))
    E = min(C, max(0, {"0": 0, "1": 1, "2": 2, "C-1": C - 1, "C": C}[n_eligible]))
    eligible = np.zeros(C, bool)
    eligible[rng.choice(C, E, replace=False)] = True
    kind = ROUND_KINDS[(C + len(n_eligible)) % 4]
    Tn, P = 3, 97
    lags = np.stack([topic(int(rng.integers(1 << 30)), P, C, kind)[0] for _ in range(Tn)])
    lags = -np.sort(-lags, axis=1)
    valid = np.ones((Tn, P), bool)
    valid[1, int(rng.integers(0, P)):] = False
    valid[2] = rng.random(P) < 0.7
    valid[2, int(rng.integers(P // 2, P)):] = False
    L, V = T(lags), T(valid.astype(np.uint8))
    mask = None if E == C and n_eligible == "C" else T(eligible.astype(np.uint8))
    got = round_form(L, V, C, mask)
    assert_equal(got, [x.numpy() for x in scan_cuda.scan_greedy_torch(L, V, C, mask)])
    for t in range(Tn):
        want = jax_topic_scan(lags[t], np.arange(P, dtype=np.int32), valid[t], C, eligible)
        assert_equal([x[t] for x in got], want)


def test_scan_plan_width_and_key_form():
    """``scan_plan``: E is C without a mask and the mask's count with one
    (the kernel sorts ``slots_for(E)`` slots); the packed key where every
    valid lag is >= 0 and each topic's valid sum is below 2^(61 -
    rank_bits), K1's rule; lags on invalid rows count for nothing."""
    C = 1000
    rank_bits = rounds_cuda.rank_bits_for(C, 0.0, 0.0)
    assert rank_bits == 10
    lags = torch.full((2, 8), 1000, dtype=torch.int64)
    valid = torch.ones((2, 8), dtype=torch.uint8)
    assert scan_cuda.scan_plan(lags, valid, C) == (C, rank_bits)
    mask = torch.zeros(C, dtype=torch.uint8)
    for E in (0, 1, 2, 33):
        mask[:E] = 1
        assert scan_cuda.scan_plan(lags, valid, C, mask) == (E, rank_bits)
    assert [rounds_cuda.slots_for(E) for E in (0, 1, 2, 33, 1000)] == [1, 1, 2, 64, 1024]
    limit = 1 << (61 - rank_bits)
    near = torch.tensor([[limit // 2, limit // 2 - 1], [limit - 1, 0]])
    assert scan_cuda.scan_plan(near, torch.ones_like(near, dtype=torch.uint8), C)[1] == rank_bits
    over = torch.tensor([[limit // 2, limit // 2]])  # one topic's sum reaches the limit
    assert scan_cuda.scan_plan(over, torch.ones_like(over, dtype=torch.uint8), C)[1] == 0
    huge = torch.full((1, 4), 2**62 - 1)
    assert scan_cuda.scan_plan(huge, torch.ones_like(huge, dtype=torch.uint8), C)[1] == 0
    negative = torch.tensor([[5, -1]])
    flags = torch.tensor([[1, 1]], dtype=torch.uint8)
    assert scan_cuda.scan_plan(negative, flags, C)[1] == 0
    flags[0, 1] = 0  # the negative lag is on an invalid row
    assert scan_cuda.scan_plan(negative, flags, C)[1] == rank_bits
    assert scan_cuda.scan_plan(huge[:, :0], huge[:, :0].to(torch.uint8), C) == (C, rank_bits)


@pytest.mark.parametrize("kind", ["zipf", "ties", "zero", "huge", "negative", "wide"])
def test_host_lag_range_bounds_the_plan(kind):
    """``host_lag_range`` over a padded batch (the rows' lags, padding
    included, and each topic's valid count) never admits a key form that a
    read of the valid lags refuses: where it gives the packed key, the read
    gives the same plan.  With a mask, E is the mask's count either way."""
    rng = np.random.default_rng(len(kind))
    C, Tn, P = 33, 4, 200
    lags = np.stack([topic(int(rng.integers(1 << 30)), P, C, kind if kind in ROUND_KINDS
                           else "zipf")[0] for _ in range(Tn)])
    if kind == "negative":
        lags[1, 7] = -3
    if kind == "wide":  # the range refuses the packed key, a read admits it
        lags[:, 1:] = 0
        lags[:, 0] = 1 << 54
    valid = rng.random((Tn, P)) < 0.8
    valid[:, 0] = True
    lag_range = scan_cuda.host_lag_range(lags, valid.sum(axis=1))
    L, V = T(lags), T(valid.astype(np.uint8))
    read = scan_cuda.scan_plan(L, V, C)
    host = scan_cuda.scan_plan(L, V, C, lag_range=lag_range)
    assert host[0] == read[0] == C
    if host[1]:
        assert host == read
    assert (host[1] > 0) == {"zipf": True, "ties": True, "zero": True, "huge": False,
                             "negative": False, "wide": False}[kind]
    assert kind != "wide" or read[1] > 0
    mask = T((rng.random(C) < 0.5).astype(np.uint8))
    assert scan_cuda.scan_plan(L, V, C, mask, lag_range)[0] == int(mask.sum())


class _Planned(Exception):
    """Ends a solve once its plan is taken."""


@pytest.mark.parametrize("cfg", [1, 2, 3, 4, 5])
def test_main_path_plans_the_scan_on_the_host(cfg, monkeypatch):
    """``dispatch`` hands the scan the lags' range from its numpy arrays,
    so that the main path's launch reads nothing from the card; at every
    BASELINE config that range gives the plan a read of the sorted rows
    gives: E = C and the packed key."""
    lags, members = baseline_workload(cfg)
    planned = []

    def plan_only(lags_t, pids, valid, C, pack_shift=0, lag_range=None):
        _, sl, sv = scan_kernel.sort_partitions_with(lags_t, pids, valid, pack_shift)
        sv = sv.to(torch.uint8)
        read = scan_cuda.scan_plan(sl, sv, C)
        assert scan_cuda.scan_plan(sl, sv, C, lag_range=lag_range) == read
        planned.append(read)
        raise _Planned

    monkeypatch.setattr(batched, "assign_topic_scan", plan_only)
    with pytest.raises(_Planned):
        dispatch.assign_device(lag_rows(lags), {m: sorted(lags) for m in members},
                               kernel="scan", device="cpu")
    assert planned == [(len(members), max(1, (len(members) - 1).bit_length()))]
