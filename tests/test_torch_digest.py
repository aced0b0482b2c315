"""The resident-state digest (K6's plain version) against the JAX package.

Every lane is integer arithmetic, so the tolerance is exact equality:
``_state_digest_torch`` against ``refine._state_digest_xla`` and
``_row_tab_lane_torch`` against ``refine._row_tab_lane_xla``, on a clean
resident state and on each corruption class the digest exists to catch
(choices of -2, C and C + 5, counts off by one, a flipped table slot, a slot
naming another row of the same consumer, a broken sentinel), on lags whose
int64 sum wraps, at C = 1 and at a row count that is not a multiple of 128.
The host truths (``utils/scrub``) and the bit flip of the drills are copies;
they are held to the JAX package's too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from kafka_lag_based_assignor_tpu.ops import refine as jax_refine  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import scrub as jax_scrub  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops import packing, refine  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops import state_digest_cuda  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.utils import scrub  # noqa: E402

T = torch.from_numpy


def resident_state(seed, B, P, C):
    """A consistent resident 4-tuple as numpy: lags int64[B] (0 past P),
    choice int32[B] (count-balanced over [:P], -1 past it) and the row
    table and counts built from them."""
    rng = np.random.default_rng(seed)
    lags = np.zeros(B, np.int64)
    lags[:P] = rng.integers(0, 10**9, P)
    choice = np.full(B, -1, np.int32)
    choice[:P] = rng.permutation(np.arange(P) % C)
    tab, counts, _ = refine.build_choice_tables(
        T(lags), T(np.arange(B) < P), T(choice), C, packing.table_rows(B, C)
    )
    return lags, choice, tab.numpy().copy(), counts.numpy().copy()


def corrupt(kind, lags, choice, tab, counts, C):
    if kind == "choice_minus2":
        choice[7] = -2
    elif kind == "choice_C":
        choice[9] = C
    elif kind == "choice_C_plus_5":
        choice[11] = C + 5
    elif kind == "counts_plus_one":
        counts[3] += 1
    elif kind == "counts_minus_one":
        counts[0] -= 1
    elif kind == "table_flip":
        tab[2, 1] ^= 1 << 5
    elif kind == "table_same_consumer":
        tab[4, 0] = tab[4, 1]
    elif kind == "table_sentinel":
        tab[1, counts[1]] = 0
    elif kind == "table_out_of_range":
        tab[5, 0] = -7
    elif kind == "lags_wrap":
        lags[:4] = 2**62 + 3  # the int64 sum wraps past 2**63
    else:
        assert kind == "clean"


KINDS = ["clean", "choice_minus2", "choice_C", "choice_C_plus_5",
         "counts_plus_one", "counts_minus_one", "table_flip",
         "table_same_consumer", "table_sentinel", "table_out_of_range",
         "lags_wrap"]
SHAPES = [(4096, 3000, 24), (1000, 1000, 7), (1000, 999, 13)]


def both_digests(lags, choice, tab, counts, C):
    got = (
        refine._state_digest_torch(T(lags), T(choice), T(counts), C).numpy(),
        int(refine._row_tab_lane_torch(T(lags), T(choice), T(tab), T(counts), C)),
    )
    j = [jnp.asarray(a) for a in (lags, choice, tab, counts)]
    want = (
        np.asarray(jax_refine._state_digest_xla(j[0], j[1], j[3], C)),
        int(jax_refine._row_tab_lane_xla(j[0], j[1], j[2], j[3], C)),
    )
    return got, want


@pytest.mark.parametrize("B,P,C", SHAPES, ids=lambda v: str(v))
@pytest.mark.parametrize("kind", KINDS)
def test_digest_lanes_match_jax(kind, B, P, C):
    lags, choice, tab, counts = resident_state(B + C, B, P, C)
    corrupt(kind, lags, choice, tab, counts, C)
    (base, lane), (jbase, jlane) = both_digests(lags, choice, tab, counts, C)
    assert base.dtype == np.int64
    np.testing.assert_array_equal(base, jbase)
    assert lane == jlane
    # The wrapper: the plain version on a CPU tensor, four lanes or five.
    full = refine.state_digest(T(lags), T(choice), T(counts), C, row_tab=T(tab))
    np.testing.assert_array_equal(full.numpy(), np.append(jbase, jlane))
    np.testing.assert_array_equal(
        refine.state_digest(T(lags), T(choice), T(counts), C).numpy(), jbase
    )
    # The host truths name the same buffers as the JAX package's.
    lag_sum = int(lags[:P].sum(dtype=np.int64))
    fails = scrub.digest_failures(full.numpy(), P, lag_sum)
    assert fails == jax_scrub.digest_failures(np.append(jbase, jlane), P, lag_sum)
    assert (fails == []) == (kind == "clean" or kind == "lags_wrap")


def test_lag_sum_wraps_like_numpy():
    lags = np.array([2**62, 2**62, 2**62, 2**62 + 5, 7], np.int64)
    choice = np.array([0, 0, 0, 0, -1], np.int32)
    got = refine._state_digest_torch(T(lags), T(choice), T(np.array([4], np.int32)), 1)
    assert int(got[2]) == int(lags.sum(dtype=np.int64)) == 12
    assert got.tolist() == [4, 0, 12, 0]


def test_one_consumer():
    lags, choice, tab, counts = resident_state(3, 520, 517, 1)
    (base, lane), (jbase, jlane) = both_digests(lags, choice, tab, counts, 1)
    np.testing.assert_array_equal(base, jbase)
    assert lane == jlane == 0
    assert base[0] == 517 and base[1] == 0 and base[3] == 0


@pytest.mark.parametrize("bad", ["consumers", "dtype", "shape", "table"])
def test_digest_limits_raise_on_the_cpu(bad):
    lags, choice, tab, counts = (T(a) for a in resident_state(1, 64, 60, 4))
    C = 4
    if bad == "consumers":  # counts and the table for another consumer count
        counts = torch.zeros(C + 1, dtype=torch.int32)
        tab = torch.zeros((C + 1, 2), dtype=torch.int32)
    elif bad == "dtype":
        choice = choice.long()
    elif bad == "shape":
        lags = lags[:-1]
    else:
        tab = tab[:2]
    with pytest.raises(ValueError):
        refine.state_digest(lags, choice, counts, C, row_tab=tab)


def test_cpu_digest_never_counts_a_launch():
    before = refine.state_digest.launches
    lags, choice, tab, counts = (T(a) for a in resident_state(2, 256, 200, 5))
    refine.state_digest(lags, choice, counts, 5, row_tab=tab)
    assert refine.state_digest.launches == before


@pytest.mark.parametrize("dtype,limit", [(np.int32, 100), (np.int64, None),
                                         (np.int32, None)])
def test_flip_bit_matches_jax(dtype, limit):
    arr = np.random.default_rng(0).integers(0, 1000, (7, 40)).astype(dtype)
    for seed in range(5):
        got = scrub.flip_bit(arr, seed, limit=limit)
        np.testing.assert_array_equal(got, jax_scrub.flip_bit(arr, seed, limit=limit))
        assert int((got != arr).sum()) == 1


@pytest.mark.parametrize("C,nbytes", [(1, 68), (1000, 4064), (16384, 65600)])
def test_digest_scratch_size(C, nbytes):
    """Eight 64-bit words (five sums, the ticket, two spare), then an int32
    histogram of C bins."""
    assert state_digest_cuda.scratch_bytes(C) == nbytes


def test_digest_scratch_is_kept_per_device_and_stream(monkeypatch):
    monkeypatch.setattr(state_digest_cuda, "_scratch", {})
    cpu = torch.device("cpu")
    first = state_digest_cuda.scratch_for(cpu, 3, 1000)
    assert first.dtype == torch.uint8 and not first.any()
    assert first.numel() == state_digest_cuda.scratch_bytes(1000)
    # Fewer consumers fit the buffer held; more grow it, zeroed again.
    assert state_digest_cuda.scratch_for(cpu, 3, 24) is first
    grown = state_digest_cuda.scratch_for(cpu, 3, 16384)
    assert grown is not first and grown.numel() == state_digest_cuda.scratch_bytes(16384)
    assert not grown.any()
    assert state_digest_cuda.scratch_for(cpu, 3, 1000) is grown
    other = state_digest_cuda.scratch_for(cpu, 4, 1000)
    assert other is not grown
    assert set(state_digest_cuda._scratch) == {(-1, 3), (-1, 4)}
