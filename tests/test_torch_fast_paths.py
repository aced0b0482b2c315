"""The port's one-shot dense stream paths against the JAX package's.

``ops/rounds_kernel.assign_presorted_rounds``, ``ops/batched.
_stream_presorted``, ``assign_stream_batch``, ``assign_stream_global``,
``stream_payload(..., partition_axis=1)`` and ``totals_rank_bits_for`` run
on the CPU on the same seeded inputs in both packages, and the answers are
equal bit for bit, dtype included: dense and ragged T x P, C from 1 to
above P, lags near 2**31 and 2**32 (both sides of the int32 upload and of
the packed key), and all-zero topics.  The cases of
``tests/test_fast_paths.py`` that name these functions are mirrored here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kafka_lag_based_assignor_tpu.ops import batched as jax_batched  # noqa: E402
from kafka_lag_based_assignor_tpu.ops import rounds_kernel as jax_rounds  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops import batched, rounds_kernel  # noqa: E402


def dense_case(seed, T, P, high=10**10, zero_rows=False):
    rng = np.random.default_rng(seed)
    lags = rng.integers(0, high, size=(T, P), dtype=np.int64)
    lags[rng.random((T, P)) < 0.2] = 0  # lag ties
    if zero_rows:
        lags[::2] = 0
    return lags


# (T, P, C): dense and ragged shapes, C from 1 to above P.
SHAPES = [(7, 100, 16), (16, 64, 16), (3, 1000, 16), (1, 1, 1), (4, 5, 9),
          (5, 33, 1), (2, 64, 64), (6, 17, 40), (3, 129, 7)]
# Lag ranges: int32 upload, just under and over 2**31, near and over 2**32.
HIGHS = [10**6, 2**31 - 1, 2**31 + 5, 2**32 + 3, 2**40]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("high", HIGHS)
def test_assign_stream_batch_matches_jax(shape, high):
    T, P, C = shape
    lags = dense_case(sum(shape) + high % 97, T, P, high=high)
    want = np.asarray(jax_batched.assign_stream_batch(lags, num_consumers=C))
    got = batched.assign_stream_batch(lags, C, device="cpu").numpy()
    assert got.dtype == want.dtype == np.int16
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("high", HIGHS)
def test_assign_stream_global_matches_jax(shape, high):
    T, P, C = shape
    lags = dense_case(3 * sum(shape) + high % 89, T, P, high=high)
    want_choice, want_totals = jax_batched.assign_stream_global(lags, num_consumers=C)
    choice, totals = batched.assign_stream_global(lags, C, device="cpu")
    np.testing.assert_array_equal(choice.numpy(), np.asarray(want_choice))
    np.testing.assert_array_equal(totals.numpy(), np.asarray(want_totals))
    assert totals.dtype == torch.int64


@pytest.mark.parametrize("fn", ["batch", "global"])
def test_all_zero_topics_match_jax(fn):
    lags = dense_case(5, 6, 50, zero_rows=True)
    if fn == "global":
        lags[:] = 0
    if fn == "batch":
        want = np.asarray(jax_batched.assign_stream_batch(lags, num_consumers=8))
        got = batched.assign_stream_batch(lags, 8, device="cpu").numpy()
    else:
        want = np.asarray(jax_batched.assign_stream_global(lags, num_consumers=8)[0])
        got = batched.assign_stream_global(lags, 8, device="cpu")[0].numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(8))
def test_presorted_rounds_match_jax(seed):
    """tests/test_fast_paths.py::test_presorted_rounds_parity, across both
    packages: every output of the host-presorted rounds equal, and equal
    to the padded round scan."""
    rng = np.random.default_rng(seed)
    P, C = 1000, 13
    lags = rng.integers(0, 10**6, size=P).astype(np.int64)
    lags[rng.random(P) < 0.3] = 0
    perm = np.argsort(-lags, kind="stable").astype(np.int32)
    want = jax_rounds.assign_presorted_rounds(lags[perm], perm, num_consumers=C)
    got = rounds_kernel.assign_presorted_rounds(
        torch.from_numpy(lags[perm]), torch.from_numpy(perm), C)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    pids = torch.arange(P, dtype=torch.int32)
    base = rounds_kernel.assign_topic_rounds(
        torch.from_numpy(lags), pids, torch.ones(P, dtype=torch.bool), C)
    for a, b in zip(base, got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("P,C", [(1, 1), (7, 3), (64, 64), (100, 130), (257, 16)])
@pytest.mark.parametrize("refine_iters", [0, 8])
def test_stream_presorted_matches_jax(P, C, refine_iters):
    rng = np.random.default_rng(P * 31 + C)
    lags = rng.integers(0, 2**33, size=P).astype(np.int64)
    perm = np.argsort(-lags, kind="stable").astype(np.int32)
    want = np.asarray(jax_batched._stream_presorted(
        lags, perm, num_consumers=C, refine_iters=refine_iters))
    got = batched._stream_presorted(torch.from_numpy(lags), torch.from_numpy(perm), C,
                                    refine_iters=refine_iters).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_stream_paths_agree(seed):
    """tests/test_fast_paths.py::test_assign_stream_paths_agree: the
    presorted path equals the padded device path of one topic."""
    rng = np.random.default_rng(seed)
    P, C = 1500, 16
    lags = rng.integers(0, 10**9, size=P).astype(np.int64)
    perm = np.argsort(-lags, kind="stable").astype(np.int32)
    host = batched._stream_presorted(torch.from_numpy(lags), torch.from_numpy(perm), C)
    payload, shift = batched.stream_payload(lags)
    dev = batched.assign_stream(torch.from_numpy(payload), C, pack_shift=shift)
    assert torch.equal(host, dev) and host.dtype == torch.int16


@pytest.mark.parametrize("high", HIGHS)
@pytest.mark.parametrize("axis", [0, 1])
def test_stream_payload_axis_matches_jax(high, axis):
    lags = dense_case(high % 13, 5, 300, high=high)
    want, want_shift = jax_batched.stream_payload(lags, partition_axis=axis)
    got, shift = batched.stream_payload(lags, partition_axis=axis)
    assert shift == want_shift and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["huge", "negative", "small", "empty", "batch"])
def test_totals_rank_bits_for_matches_jax(case):
    """tests/test_fast_paths.py::test_totals_rank_bits_overflow_guard."""
    arr = {
        "huge": np.full(4, 1 << 60, dtype=np.int64),
        "negative": -np.full(4, 1 << 60, dtype=np.int64),
        "small": np.arange(100, dtype=np.int64),
        "empty": np.zeros(0, dtype=np.int64),
        "batch": dense_case(1, 4, 64, high=2**50),
    }[case]
    for C in (1, 16, 1000):
        assert batched.totals_rank_bits_for(arr, C) == jax_batched.totals_rank_bits_for(
            arr, C)


def test_int32_downcast_gives_the_wide_answer():
    """tests/test_fast_paths.py::test_assign_stream_batch_int32_downcast_parity:
    a constant added to every lag keeps the processing order, so the
    int32 upload and the int64 one give the same choices."""
    rng = np.random.default_rng(5)
    lags = rng.integers(0, 2**30, size=(4, 200)).astype(np.int64)
    narrow = batched.assign_stream_batch(lags, 8, device="cpu")
    wide = batched.assign_stream_batch(lags + (1 << 40), 8, device="cpu")
    assert torch.equal(narrow, wide)


def test_batch_equals_assign_batched_rounds():
    """The dense path's answer is the batched rounds solve with dense ids
    and an all-true mask (tests/test_fast_paths.py::
    test_assign_stream_batch_parity, inside the port)."""
    lags = dense_case(9, 7, 100)
    pids = torch.arange(100, dtype=torch.int32).expand(7, 100).contiguous()
    base, _, _ = batched.assign_batched_rounds(
        torch.from_numpy(lags), pids, torch.ones((7, 100), dtype=torch.bool), 16)
    got = batched.assign_stream_batch(lags, 16, device="cpu")
    assert torch.equal(got.to(torch.int32), base)


def test_outside_the_kernel_limits_raises_on_the_cpu():
    """20,000 consumers, above the register network's 16,384 slots (once
    refused on both devices), are answered as the JAX package answers
    them."""
    lags = dense_case(2, 2, 8)
    got = batched.assign_stream_batch(lags, 20000, device="cpu").numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_batched.assign_stream_batch(lags, num_consumers=20000)))
    choice, totals = batched.assign_stream_global(lags, 20000, device="cpu")
    want_choice, want_totals = jax_batched.assign_stream_global(lags, num_consumers=20000)
    np.testing.assert_array_equal(choice.numpy(), np.asarray(want_choice))
    np.testing.assert_array_equal(totals.numpy(), np.asarray(want_totals))


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batched.assign_stream_batch(dense_case(0, 2, 4), 2)
