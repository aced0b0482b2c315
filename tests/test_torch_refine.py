"""The port's integer refinement stages against the JAX package, on the CPU.

Everything here is integer (or host numpy) arithmetic, so the tolerance is
exact equality: the row-table geometry (``table_rows``, ``pad_topic_rows``),
``segment_sum``, the co-sort, ``_boundaries``, ``segment_argmin_first``,
the lexicographic sort helper, the quantization shift,
``build_choice_tables``, the parity body of ``refine_rounds_resident``
(compared on ``choice``, ``row_tab``, ``counts``, ``totals`` and the rounds
run; its warm options are held in ``test_torch_delta.py``), the oracle
``refine_assignment`` with its options, ``refine_assignment_resident`` and
``refine_batched``.  Inputs are made with numpy from a seed and handed to
both packages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from kafka_lag_based_assignor_tpu.ops import batched as jax_batched  # noqa: E402
from kafka_lag_based_assignor_tpu.ops import packing as jax_packing  # noqa: E402
from kafka_lag_based_assignor_tpu.ops import refine as jax_refine  # noqa: E402
from kafka_lag_based_assignor_tpu.ops import scan_kernel as jax_scan  # noqa: E402
from kafka_lag_based_assignor_tpu.ops import sortops as jax_sortops  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops import (  # noqa: E402
    batched,
    packing,
    refine,
    sortops,
)

T = torch.from_numpy


@pytest.mark.parametrize("P,C", [(1, 1), (5, 3), (1000, 16), (4097, 7), (10, 64)])
def test_table_rows_and_pad_topic_rows_match_jax(P, C):
    assert packing.table_rows(P, C) == jax_packing.table_rows(P, C)
    lags = np.random.default_rng(P).integers(0, 10**6, P)
    pids = np.arange(P, dtype=np.int32)[::-1].copy()
    for args in ((lags,), (lags, pids)):
        for got, want in zip(packing.pad_topic_rows(*args),
                             jax_packing.pad_topic_rows(*args)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_segment_sum_matches_jax(dtype):
    rng = np.random.default_rng(3)
    S = 11
    vals = rng.integers(-(10**9), 10**9, 500).astype(dtype)
    seg = rng.integers(-2, S + 2, 500).astype(np.int32)  # out of range too
    got = sortops.segment_sum(T(vals), T(seg), S).numpy()
    want = np.asarray(jax_sortops.segment_sum(jnp.asarray(vals), jnp.asarray(seg), S))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_lexsort_matches_lax_sort():
    rng = np.random.default_rng(4)
    k1 = rng.integers(0, 4, (6, 300))
    k2 = rng.integers(0, 5, (6, 300))
    idx = np.broadcast_to(np.arange(300), (6, 300))
    want = lax.sort((jnp.asarray(k1), jnp.asarray(k2), jnp.asarray(idx)),
                    num_keys=2, dimension=1)[2]
    np.testing.assert_array_equal(sortops.lexsort(T(k1), T(k2), dim=1).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("top", [0, 1, 2**47 + 3, 2**48, 2**53 + 1, 2**62 + 5])
def test_quant_shift_matches_jax(top):
    lags = np.array([top, 7, 3, top], np.int64)
    assigned = np.array([True, True, False, False])
    for mask in (assigned, ~assigned, np.zeros(4, bool)):
        got = int(refine._quant_shift(T(lags), T(mask)))
        assert got == int(jax_refine._quant_shift(jnp.asarray(lags), jnp.asarray(mask)))


def balanced_start(rng, P, C, n_valid):
    """A count-balanced choice over the valid prefix (-1 on padding)."""
    choice = np.full(P, -1, np.int32)
    choice[:n_valid] = rng.permutation(np.arange(n_valid) % C).astype(np.int32)
    return choice


def case(seed, P, C, kind):
    rng = np.random.default_rng(seed)
    n_valid = P - P // 8
    if kind == "ties":
        raw = rng.integers(0, 4, n_valid) * 1000
    elif kind == "huge":  # quantization shift > 0
        raw = rng.integers(2**50, 2**55, n_valid)
    else:
        raw = (1000 * (n_valid / (rng.permutation(n_valid) + 1)) ** (1 / 1.1))
    lags = np.zeros(P, np.int64)
    lags[:n_valid] = raw.astype(np.int64)
    valid = np.arange(P) < n_valid
    return lags, valid, balanced_start(rng, P, C, n_valid)


CASES = [(1, 256, 7, "ties"), (2, 1024, 16, "zipf"), (3, 512, 33, "huge")]
CASE_IDS = ["ties_C7", "zipf_C16", "huge_C33"]


@pytest.mark.parametrize("seed,P,C,kind", CASES, ids=CASE_IDS)
def test_build_choice_tables_matches_jax(seed, P, C, kind):
    lags, valid, choice = case(seed, P, C, kind)
    M = packing.table_rows(P, C)
    got = refine.build_choice_tables(T(lags), T(valid), T(choice), C, M)
    want = jax_refine.build_choice_tables(
        jnp.asarray(lags), jnp.asarray(valid), jnp.asarray(choice), C, M
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("max_pairs", [None, 4])
@pytest.mark.parametrize("seed,P,C,kind", CASES, ids=CASE_IDS)
def test_refine_rounds_resident_matches_jax(seed, P, C, kind, max_pairs):
    lags, valid, choice = case(seed, P, C, kind)
    M = packing.table_rows(P, C)
    tab, counts, totals = refine.build_choice_tables(
        T(lags), T(valid), T(choice), C, M
    )
    got = refine.refine_rounds_resident(
        T(lags), T(choice), tab, counts, totals, C, iters=40, max_pairs=max_pairs,
    )
    jtab, jcounts, jtotals = jax_refine.build_choice_tables(
        jnp.asarray(lags), jnp.asarray(valid), jnp.asarray(choice), C, M
    )
    want = jax_refine.refine_rounds_resident(
        jnp.asarray(lags), jnp.asarray(choice), jtab, jcounts, jtotals, C,
        iters=40, max_pairs=max_pairs,
    )
    for name, g, w in zip(("choice", "row_tab", "counts", "totals"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got[4] == int(want[4]) and got[4] > 0
    assert got[5] == int(want[5])
    # The exchanges kept the count spread and lowered the peak.
    assert int(got[2].max() - got[2].min()) <= 1
    assert int(got[3].max()) <= int(totals.max())


@pytest.mark.parametrize(
    "kwargs",
    [{"bulk_transfer": True}, {"fan": 2}, {"quality_limit": 10.0},
     {"exchange_budget": 5}, {}],
)
def test_unported_refine_options_raise(kwargs):
    """``allow_moves=False`` (the federated slice) raises with any of the
    warm options beside it; the warm options alone are ported
    (tests/test_torch_delta.py holds them to the JAX package)."""
    lags, valid, choice = case(1, 64, 4, "ties")
    tab, counts, totals = refine.build_choice_tables(
        T(lags), T(valid), T(choice), 4, packing.table_rows(64, 4)
    )
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        refine.refine_rounds_resident(
            T(lags), T(choice), tab, counts, totals, 4, iters=3,
            allow_moves=False, **kwargs
        )


# -- the oracle refinement and its primitives -------------------------------


def test_sort_with_matches_lax_sort():
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 6, (3, 400))
    pay = rng.integers(-50, 50, (3, 400)).astype(np.int32)
    got = sortops.sort_with(T(keys), T(pay), T(keys * 7))
    want = lax.sort((jnp.asarray(keys), jnp.asarray(pay), jnp.asarray(keys * 7)),
                    num_keys=1, dimension=1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("S", [1, 7, 40])
def test_boundaries_match_jax(S):
    vals = np.sort(np.random.default_rng(S).integers(-1, S + 2, 300)).astype(np.int32)
    for v in (vals, vals[:0]):
        got = sortops._boundaries(T(v), S).numpy()
        want = np.asarray(jax_sortops._boundaries(jnp.asarray(v), S))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("S", [1, 5, 64])
@pytest.mark.parametrize("P", [1, 33, 700])
def test_segment_argmin_first_matches_jax(S, P):
    """Ties everywhere (scores 0..4), segment ids from -3 to S + 3 (out of
    range on both sides, the discard bin S itself), and, with S = 64 and
    few rows, segments that stay empty."""
    rng = np.random.default_rng(S * 1000 + P)
    score = rng.integers(0, 5, P).astype(np.int64)
    seg = rng.integers(-3, S + 4, P).astype(np.int32)
    got = sortops.segment_argmin_first(T(score), T(seg), S, P)
    want = jax_sortops.segment_argmin_first(jnp.asarray(score), jnp.asarray(seg), S, P)
    for g, w in zip(got, want):
        assert g.dtype == T(np.array(w)).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if S == 64 and P == 1:
        assert int((got[1] == P).sum()) >= S - 1  # the empty segments


def greedy_choice(lags, valid, C):
    """The JAX package's greedy scan: the start the solvers hand over."""
    P = lags.shape[0]
    out = jax_scan.assign_topic_scan(
        jnp.asarray(lags), jnp.arange(P, dtype=jnp.int32), jnp.asarray(valid), C)
    return np.array(out[0])


def refine_case(seed, P, C, start):
    """(lags, valid, choice): Zipf lags (>= 2^48 for ``huge``, so that the
    quantization shift is > 0) with padding rows, and a greedy start or a
    ``hot`` one (every row on a random consumer: unbalanced counts)."""
    rng = np.random.default_rng(seed)
    n_valid = P - P // 9
    raw = (rng.pareto(1.1, n_valid) * 1000).astype(np.int64)
    if start == "huge":
        raw += 2**48 + rng.integers(0, 2**52, n_valid)
    lags = np.zeros(P, np.int64)
    lags[:n_valid] = raw
    valid = np.arange(P) < n_valid
    if start == "hot":
        choice = np.where(valid, rng.integers(0, C, P), -1).astype(np.int32)
    else:
        choice = greedy_choice(lags, valid, C)
    return lags, valid, choice


def assert_refine_equal(got, want):
    for name, g, w in zip(("choice", "counts", "totals"), got, want):
        w = np.array(w)
        assert g.dtype == T(w).dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize("start", ["greedy", "hot", "huge"])
@pytest.mark.parametrize("seed,P,C", [(1, 64, 2), (2, 300, 7), (3, 1000, 16), (4, 777, 33)])
def test_refine_assignment_matches_jax(seed, P, C, start):
    lags, valid, choice = refine_case(seed, P, C, start)
    got = refine.refine_assignment(T(lags), T(valid), T(choice), C, iters=24)
    want = jax_refine.refine_assignment(
        jnp.asarray(lags), jnp.asarray(valid), jnp.asarray(choice), C, iters=24)
    assert_refine_equal(got, want)
    if start != "hot":
        counts = got[1].numpy()
        assert counts.max() - counts.min() <= 1
        greedy_totals = np.bincount(choice[valid], weights=lags[valid], minlength=C)
        assert got[2].numpy().max() <= greedy_totals.max()


@pytest.mark.parametrize(
    "kwargs",
    [{"max_pairs": 1}, {"max_pairs": 3}, {"max_pairs": 0}, {"patience": 1},
     {"patience": 0}, {"iters": 0}, {"iters": 1}, {"iters": 80}],
)
def test_refine_assignment_options_match_jax(kwargs):
    lags, valid, choice = refine_case(11, 500, 12, "greedy")
    got = refine.refine_assignment(T(lags), T(valid), T(choice), 12, **kwargs)
    want = jax_refine.refine_assignment(
        jnp.asarray(lags), jnp.asarray(valid), jnp.asarray(choice), 12, **kwargs)
    assert_refine_equal(got, want)


def test_refine_assignment_edges_match_jax():
    lags, valid, choice = refine_case(12, 40, 1, "greedy")
    args = (jnp.asarray(lags), jnp.asarray(valid), jnp.asarray(choice))
    assert_refine_equal(refine.refine_assignment(T(lags), T(valid), T(choice), 1),
                        jax_refine.refine_assignment(*args, 1))
    C = 2 * ((1 << 14) - 1)  # K = C // 2 reaches the pair-id field
    for pkg, fn_args in ((refine, (T(lags), T(valid), T(choice))), (jax_refine, args)):
        with pytest.raises(ValueError, match="pair-id"):
            pkg.refine_assignment(*fn_args, C)


@pytest.mark.parametrize("seed,P,C", [(5, 400, 9), (6, 1024, 32), (7, 130, 2)])
def test_refine_assignment_resident_matches_jax(seed, P, C):
    lags, valid, choice = refine_case(seed, P, C, "greedy")
    args = (jnp.asarray(lags), jnp.asarray(valid), jnp.asarray(choice))
    for kwargs in ({}, {"iters": 0}, {"max_pairs": 2, "patience": 3}):
        got = refine.refine_assignment_resident(T(lags), T(valid), T(choice), C, **kwargs)
        want = jax_refine.refine_assignment_resident(*args, C, **kwargs)
        assert_refine_equal(got, want)
    # Bit-identical to the oracle rounds with no budget and no limit.
    oracle = refine.refine_assignment(T(lags), T(valid), T(choice), C)
    resident = refine.refine_assignment_resident(T(lags), T(valid), T(choice), C)
    for o, r in zip(oracle, resident):
        assert torch.equal(o, r)


def test_refine_batched_stops_each_topic_on_its_own():
    """Six topics of one batch: one with equal lags (nothing to gain, it
    stops on patience at once), one with a single heavy row, Zipf ones
    with different valid prefixes: they stop in different rounds, and each
    equals the JAX package's vmapped loop and its own one-topic solve."""
    rng = np.random.default_rng(21)
    Tn, P, C = 6, 192, 8
    lags = (rng.pareto(1.0, (Tn, P)) * 1000).astype(np.int64)
    lags[0] = 5
    lags[1] = 1
    lags[1, 0] = 10**9
    valid = np.arange(P)[None] < np.array([P, P, 40, 100, 150, P])[:, None]
    choice = np.stack([greedy_choice(lags[t], valid[t], C) for t in range(Tn)])
    got = batched.refine_batched(T(lags), T(valid), T(choice), C, 30)
    want = jax_batched.refine_batched(
        jnp.asarray(lags), jnp.asarray(valid), jnp.asarray(choice), C, 30)
    assert_refine_equal(got, want)
    changed = set()
    for t in range(Tn):
        one = refine.refine_assignment(T(lags[t]), T(valid[t]), T(choice[t]), C, iters=30)
        for g, o in zip(got, one):
            assert torch.equal(g[t], o)
        changed.add(int((one[0].numpy() != choice[t]).sum()))
    assert 0 in changed and len(changed) > 2  # the topics did not all run alike
