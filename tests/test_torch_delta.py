"""The streaming slice's building blocks against the JAX package, on the CPU.

All integer or host numpy, so the tolerance is exact equality:

* the warm refine (``refine_rounds_resident`` with ``bulk_transfer=True,
  fan=8``, an exchange budget and a quality limit) from the same resident
  start, on odd C, tied lags, fewer pairs than the fan and a limit below
  the current peak; and the parity body with a budget and a limit —
  compared on choice, row table, counts, totals, rounds and exchanges;
* the O(changed) readback (``readback_k``, ``compact_changed``,
  ``apply_assignment_delta``), the delta K ladder, the upload payload
  rule, the narrow choice and ``pad_chunk``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from kafka_lag_based_assignor_tpu.ops import batched as jax_batched  # noqa: E402
from kafka_lag_based_assignor_tpu.ops import delta as jax_delta  # noqa: E402
from kafka_lag_based_assignor_tpu.ops import packing as jax_packing  # noqa: E402
from kafka_lag_based_assignor_tpu.ops import refine as jax_refine  # noqa: E402
from kafka_lag_based_assignor_tpu.ops import streaming as jax_streaming  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops import (  # noqa: E402
    batched,
    delta,
    packing,
    refine,
    streaming,
)

T = torch.from_numpy


def resident_start(seed, P, C, n_valid, kind):
    """Lags and a count-balanced choice over the valid prefix."""
    rng = np.random.default_rng(seed)
    lags = np.zeros(P, np.int64)
    if kind == "ties":
        lags[:n_valid] = rng.integers(0, 3, n_valid) * 1000
    else:
        lags[:n_valid] = (1000 * (n_valid / (rng.permutation(n_valid) + 1))
                          ** (1 / 1.1)).astype(np.int64)
    choice = np.full(P, -1, np.int32)
    choice[:n_valid] = rng.permutation(np.arange(n_valid) % C)
    return lags, np.arange(P) < n_valid, choice


def run_both(lags, valid, choice, C, **kw):
    M = packing.table_rows(lags.shape[0], C)
    tab, counts, totals = refine.build_choice_tables(T(lags), T(valid), T(choice), C, M)
    entry = (T(choice).clone(), tab.clone(), counts.clone(), totals.clone())
    got = refine.refine_rounds_resident(T(lags), T(choice), tab, counts, totals, C, **kw)
    # The refine builds new tensors: its inputs are the entry state still.
    for a, b in zip((T(choice), tab, counts, totals), entry):
        assert torch.equal(a, b)
    j = [jnp.asarray(a) for a in (lags, valid, choice)]
    jtab, jcounts, jtotals = jax_refine.build_choice_tables(*j, C, M)
    want = jax_refine.refine_rounds_resident(
        j[0], j[2], jtab, jcounts, jtotals, C, **kw
    )
    for name, g, w in zip(("choice", "row_tab", "counts", "totals"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got[4] == int(want[4]), "rounds"
    assert got[5] == int(want[5]), "exchanges"
    return got, totals


# (seed, P, valid rows, C, lag kind, exchange budget, limit as a fraction of
# the start's peak, or None for no limit)
BULK = [
    (11, 2048, 2000, 15, "zipf", 40, 0.9),   # C odd, K = 7 < fan
    (12, 512, 480, 8, "ties", 24, 0.97),     # tied lags, K = 4 < fan
    (13, 4096, 4096, 64, "zipf", 200, 0.8),  # K = 16 pairs, 2 heavy x 8
    (14, 1024, 1000, 33, "zipf", 0, None),   # no budget, no target
]


@pytest.mark.parametrize("seed,P,n,C,kind,budget,frac", BULK,
                         ids=["C15", "ties", "C64", "no_target"])
def test_bulk_refine_matches_jax(seed, P, n, C, kind, budget, frac):
    lags, valid, choice = resident_start(seed, P, C, n, kind)
    peak = float(np.bincount(choice[:n], weights=lags[:n], minlength=C).max())
    limit = None if frac is None else frac * peak
    got, totals = run_both(
        lags, valid, choice, C, iters=64, max_pairs=min(C // 2, 16),
        exchange_budget=budget, quality_limit=limit, bulk_transfer=True, fan=8,
    )
    assert got[4] > 0 and got[5] > 0
    if budget:
        assert got[5] <= budget
    # Bulk rounds swap: counts are unchanged and the peak never rises.
    assert torch.equal(got[2], refine.build_choice_tables(
        T(lags), T(valid), T(choice), C, packing.table_rows(P, C))[1])
    assert int(got[3].max()) <= int(totals.max())


@pytest.mark.parametrize("budget,frac", [(7, 0.9), (3, None), (0, 0.95)])
def test_parity_refine_with_budget_and_limit_matches_jax(budget, frac):
    lags, valid, choice = resident_start(21, 1024, 16, 900, "zipf")
    peak = float(np.bincount(choice[:900], weights=lags[:900], minlength=16).max())
    got, _ = run_both(
        lags, valid, choice, 16, iters=40, exchange_budget=budget,
        quality_limit=None if frac is None else frac * peak,
    )
    assert got[5] > 0
    if budget:
        assert got[5] <= budget


def test_negative_limit_is_no_limit():
    lags, valid, choice = resident_start(22, 512, 8, 500, "zipf")
    M = packing.table_rows(512, 8)
    state = refine.build_choice_tables(T(lags), T(valid), T(choice), 8, M)
    a = refine.refine_rounds_resident(T(lags), T(choice), *state, 8, iters=30)
    b = refine.refine_rounds_resident(T(lags), T(choice), *state, 8, iters=30,
                                      quality_limit=-1.0)
    for x, y in zip(a[:4], b[:4]):
        assert torch.equal(x, y)
    assert a[4:] == b[4:]


@pytest.mark.parametrize("budget,P", [(0, 1000), (1, 1000), (512, 100_000),
                                      (512, 4000), (64, 3000), (100, 10**6)])
def test_readback_k_matches_jax(budget, P):
    assert delta.readback_k(budget, P) == jax_delta.readback_k(budget, P)


@pytest.mark.parametrize("n_changed,K", [(0, 16), (5, 16), (16, 16), (40, 32),
                                         (300, 128)])
def test_compact_changed_matches_jax(n_changed, K):
    rng = np.random.default_rng(n_changed + K)
    P, B, C = 1000, 1024, 40
    entry = np.full(B, -1, np.int32)
    entry[:P] = rng.integers(0, C, P)
    exit_ = entry.copy()
    rows = rng.choice(P, n_changed, replace=False)
    exit_[rows] = (exit_[rows] + 1 + rng.integers(0, C - 1, n_changed)) % C
    exit_[P + 3] = 5  # past P: never part of the diff
    narrow = exit_[:P].astype(np.int16)
    got = delta.compact_changed(T(entry), T(exit_), T(narrow), P, K)
    want = jax_delta.compact_changed(
        jnp.asarray(entry), jnp.asarray(exit_), jnp.asarray(narrow), P, K
    )
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    n = int(got[2])
    assert n == n_changed
    if n <= K:
        out = delta.apply_assignment_delta(entry[:P], got[0].numpy(), got[1].numpy(), n)
        np.testing.assert_array_equal(out, exit_[:P])
        np.testing.assert_array_equal(out, jax_delta.apply_assignment_delta(
            entry[:P], np.asarray(want[0]), np.asarray(want[1]), n))


def test_delta_ladder_matches_jax():
    for n in (0, 1, 15, 16, 17, 100, 512, 513, 10**5):
        assert streaming.delta_bucket(n) == jax_streaming.delta_bucket(n)
    for b in (0, 1, 3, 6):
        assert streaming.delta_k_ladder(b) == jax_streaming.delta_k_ladder(b)
    assert streaming.DELTA_MIN_K == jax_streaming.DELTA_MIN_K
    assert streaming._DELTA_ENTRY_BYTES == jax_streaming._DELTA_ENTRY_BYTES


@pytest.mark.parametrize("case", ["narrow", "wide", "negative", "empty"])
def test_stream_payload_matches_jax(case):
    lags = {
        "narrow": np.array([0, 5, 2**31 - 1, 7], np.int64),
        "wide": np.array([3, 2**31, 2**40], np.int64),
        "negative": np.array([-1, 5], np.int64),
        "empty": np.zeros(0, np.int64),
    }[case]
    got, shift = batched.stream_payload(lags)
    want, jshift = jax_batched.stream_payload(lags)
    assert got.dtype == want.dtype and shift == jshift
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("C", [1, 1000, 32767, 32768])
def test_narrow_choice_matches_jax(C):
    choice = np.array([0, C - 1, -1], np.int32)
    got = batched._narrow_choice(T(choice), C).numpy()
    want = np.asarray(jax_batched._narrow_choice(jnp.asarray(choice), C))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097, 100_000])
def test_pad_chunk_matches_jax(n):
    assert packing.pad_chunk(n) == jax_packing.pad_chunk(n)
    assert packing.pad_chunk(n, 128) == jax_packing.pad_chunk(n, 128)


@pytest.mark.parametrize("P,C", [(1, 1), (1000, 16), (3001, 24), (5, 8)])
def test_assign_stream_is_the_greedy(P, C):
    """The stream path's greedy (padded to the pow2 bucket, n_valid = P)
    gives the JAX package's stream answer."""
    lags = np.random.default_rng(P).integers(0, 10**6, P).astype(np.int64)
    payload, shift = batched.stream_payload(lags)
    got = batched.assign_stream(T(payload), C, pack_shift=shift).numpy()
    want = np.asarray(jax_batched.assign_stream(lags, num_consumers=C))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
