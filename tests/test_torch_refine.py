"""The port's integer quality-solver stages against the JAX package, on the CPU.

Everything here is integer (or host numpy) arithmetic, so the tolerance is
exact equality: the row-table geometry (``table_rows``, ``pad_topic_rows``),
``segment_sum``, the lexicographic sort helper, the quantization shift,
``build_choice_tables`` and the parity body of ``refine_rounds_resident``
(compared on ``choice``, ``row_tab``, ``counts``, ``totals`` and the rounds
run; its warm options are held in ``test_torch_delta.py``).  Inputs are
made with numpy from a seed and handed to both packages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from kafka_lag_based_assignor_tpu.ops import packing as jax_packing  # noqa: E402
from kafka_lag_based_assignor_tpu.ops import refine as jax_refine  # noqa: E402
from kafka_lag_based_assignor_tpu.ops import sortops as jax_sortops  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops import packing, refine, sortops  # noqa: E402

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
