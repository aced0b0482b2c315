"""The port's P-step greedy scan against the JAX package, on the CPU.

``assign_topic_scan`` (with and without an eligible mask), the batched
``assign_batched_scan``, ``sort_partitions`` in both sort forms and the
plain version of the scan kernel (``scan_cuda.scan_greedy_torch``, which
the wrapper runs for CPU tensors) are held bit for bit against
``kafka_lag_based_assignor_tpu.ops.scan_kernel`` / ``ops.batched``: integer
arithmetic, so the tolerance is exact equality.  Inputs are made with
numpy from a seed.  The kernel itself runs on the card only; its limit
(16,384 consumers) raises on the CPU too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from kafka_lag_based_assignor_tpu.ops import batched as jax_batched  # noqa: E402
from kafka_lag_based_assignor_tpu.ops import scan_kernel as jax_scan  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops import (  # noqa: E402
    batched,
    rounds_kernel,
    scan_cuda,
    scan_kernel,
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
    z = torch.zeros((2, 8), dtype=torch.int64)
    v = torch.ones((2, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="16384"):
        scan_cuda.scan_greedy(z, v, scan_cuda.MAX_SLOTS + 1)
    with pytest.raises(ValueError, match="16384"):
        scan_kernel.assign_topic_scan(z, z.to(torch.int32), v.bool(), 16385)
    scan_cuda.scan_greedy(z, v, scan_cuda.MAX_SLOTS)  # the limit itself runs
    for bad in (
        lambda: scan_cuda.scan_greedy(z, v, 0),
        lambda: scan_cuda.scan_greedy(z.int(), v, 4),
        lambda: scan_cuda.scan_greedy(z, v.bool(), 4),
        lambda: scan_cuda.scan_greedy(z, v, 4, torch.ones(3, dtype=torch.uint8)),
        lambda: scan_cuda.scan_greedy(z.t(), v.t(), 4),
    ):
        with pytest.raises(ValueError):
            bad()
