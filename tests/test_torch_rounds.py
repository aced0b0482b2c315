"""The port's round scan against the JAX package, bit for bit, on the CPU.

Every value on this path is an integer, so the tolerance is exact equality
everywhere.  Inputs are made with numpy from a seed and handed to both
packages.  The JAX side runs its XLA round scan (both round bodies: the
two-key body and the packed ``(total << rank_bits) | id`` body) and its
Pallas round-scan kernels in interpret mode; the port side runs
``rounds_scan`` on CPU tensors, i.e. the plain version of its CUDA kernel.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from kafka_lag_based_assignor_tpu.ops import batched as jax_batched  # noqa: E402
from kafka_lag_based_assignor_tpu.ops import rounds_kernel as jax_rounds  # noqa: E402
from kafka_lag_based_assignor_tpu.ops.rounds_pallas import (  # noqa: E402
    rounds_scan_pallas,
)
from kafka_lag_based_assignor_tpu_torch.ops import rounds_cuda  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops import rounds_kernel  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops.batched import (  # noqa: E402
    assign_batched_rounds,
)

# (C, P): P < C, P = C and P = 3C + 5 for every C (C = 1 has no P < C).
SHAPES = [
    (C, P)
    for C in (1, 2, 7, 64, 1000)
    for P in sorted({max(C // 2, 1), C, 3 * C + 5})
]


def sorted_case(seed, P, kind="uniform"):
    """Processing-order rows: descending lags, a valid prefix of random
    length (at least one row), zero padding after it."""
    rng = np.random.default_rng(seed)
    n_valid = int(rng.integers(1, P + 1))
    if kind == "zeros":
        raw = np.zeros(n_valid, np.int64)
    elif kind == "ties":
        raw = rng.integers(0, 3, size=n_valid)
    elif kind == "wide":  # each lag < 2**31, totals well past 2**31
        raw = rng.integers(2**30, 2**31 - 1, size=n_valid)
    else:
        raw = rng.integers(0, 10**5, size=n_valid)
    lags = np.zeros(P, np.int64)
    lags[:n_valid] = -np.sort(-raw.astype(np.int64))
    return lags, np.arange(P) < n_valid, n_valid


def jax_scan(lags, valid, C, n_valid, rank_bits):
    totals, choice = jax_rounds._rounds_scan(
        jnp.asarray(lags), jnp.asarray(valid), jnp.zeros((C,), jnp.int64),
        C, n_valid=n_valid, totals_rank_bits=rank_bits,
    )
    return np.asarray(totals), np.asarray(choice)


def port_scan(lags, valid, C, n_valid):
    totals, choice = rounds_kernel._rounds_scan(
        torch.from_numpy(lags), torch.from_numpy(valid),
        torch.zeros(C, dtype=torch.int64), C, n_valid=n_valid,
    )
    return totals.numpy(), choice.numpy()


def kernel_rows(lags, valid, C, n_valid=None):
    """One topic's sorted rows cut into rounds, as the wrapper takes them:
    (gains int64[1, R, C], valid uint8[1, R, C])."""
    lags_h, valid_h, R, _ = rounds_kernel.round_rows(
        torch.from_numpy(lags), torch.from_numpy(valid), C, n_valid)
    return (lags_h.reshape(1, R, C).contiguous(),
            valid_h.reshape(1, R, C).to(torch.uint8).contiguous())


def port_body(lags, valid, C, n_valid, rank_bits, totals0=None):
    """The port's plain version in one key form, laid out as the JAX scan
    returns it: (totals[C], choice int32[P] in sorted order)."""
    gains, ok = kernel_rows(lags, valid, C, n_valid)
    start = torch.zeros(C, dtype=torch.int64) if totals0 is None else torch.from_numpy(totals0)
    choice, totals = rounds_cuda.rounds_scan_torch(gains, ok, start, False, rank_bits)
    flat = np.full(lags.shape[0], -1, np.int32)
    head = min(choice.numel(), lags.shape[0])
    flat[:head] = choice.reshape(-1)[:head].numpy()
    return totals[0].numpy(), flat


@pytest.mark.parametrize("C,P", SHAPES)
def test_scan_matches_jax_both_bodies(C, P):
    lags, valid, n_valid = sorted_case(C * 1000 + P, P)
    rank_bits = jax_batched.totals_rank_bits_for(lags, C)
    assert rank_bits > 0  # the packed body is admissible here
    assert rounds_cuda.packed_rank_bits(
        *kernel_rows(lags, valid, C, n_valid), torch.zeros(C, dtype=torch.int64)
    ) == rank_bits
    want_t, want_c = port_scan(lags, valid, C, n_valid)
    for port_rb in (0, rank_bits):
        got_t, got_c = port_body(lags, valid, C, n_valid, port_rb)
        np.testing.assert_array_equal(want_c, got_c)
        np.testing.assert_array_equal(want_t, got_t)
    for rb in (0, rank_bits):
        got_t, got_c = jax_scan(lags, valid, C, n_valid, rb)
        np.testing.assert_array_equal(want_c, got_c)
        np.testing.assert_array_equal(want_t, got_t)


def boundary_lags(seed, C, P, target):
    """P descending lags, all multiples of 64 (so every f64 partial sum
    below 2**59 is exact), summing to exactly ``target``."""
    rng = np.random.default_rng(seed)
    lags = rng.integers(1, 1000, size=P).astype(np.int64) * 64
    lags[0] = target // 128 * 64
    lags[1] = target - lags[0] - lags[2:].sum()
    return -np.sort(-lags)


@pytest.mark.parametrize("side", [-1, 1])
@pytest.mark.parametrize("C", [7, 64])
def test_packing_boundary(C, side):
    """Lags summing to 64 below and 64 above 2**(61 - rank_bits): the rule
    admits the packed key, then not; both port bodies equal both JAX bodies
    on each side (the shifted totals still fit an int64 just above)."""
    rb = max(1, (C - 1).bit_length())
    lags = boundary_lags(C, C, 3 * C + 5, 2 ** (61 - rb) + side * 64)
    valid = np.ones(lags.shape, bool)
    zeros = torch.zeros(C, dtype=torch.int64)
    want_rb = rb if side < 0 else 0
    assert rounds_cuda.packed_rank_bits(*kernel_rows(lags, valid, C), zeros) == want_rb
    assert jax_batched.totals_rank_bits_for(lags, C) == want_rb
    want_t, want_c = jax_scan(lags, valid, C, None, 0)
    for port_rb in (0, rb):
        got_t, got_c = port_body(lags, valid, C, None, port_rb)
        np.testing.assert_array_equal(got_c, want_c)
        np.testing.assert_array_equal(got_t, want_t)
    got_t, got_c = jax_scan(lags, valid, C, None, rb)
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(got_t, want_t)
    assert want_t.sum() == 2 ** (61 - rb) + side * 64


def test_carry_packs_per_topic_not_across():
    """Each topic's sum fits the packed key; the carried sum does not: the
    per-topic scan packs, the carried one takes the two-key form, and both
    equal the JAX scan (the carried one run topic after topic)."""
    C, P = 7, 26
    rb = max(1, (C - 1).bit_length())
    tables = [boundary_lags(s, C, P, 2 ** (61 - rb) - 64 * (s + 1)) for s in range(2)]
    valid = np.ones(P, bool)
    rows = [kernel_rows(t, valid, C) for t in tables]
    gains = torch.cat([g for g, _ in rows])
    ok = torch.cat([v for _, v in rows])
    zeros = torch.zeros(C, dtype=torch.int64)
    assert rounds_cuda.packed_rank_bits(gains, ok, zeros, False) == rb
    assert rounds_cuda.packed_rank_bits(gains, ok, zeros, True) == 0
    choice, totals = rounds_cuda.rounds_scan(gains, ok, zeros, False)
    for t, lags in enumerate(tables):
        want_t, want_c = jax_scan(lags, valid, C, None, rb)
        np.testing.assert_array_equal(choice[t].reshape(-1)[:P].numpy(), want_c)
        np.testing.assert_array_equal(totals[t].numpy(), want_t)
    choice, totals = rounds_cuda.rounds_scan(gains, ok, zeros, True)
    start = jnp.zeros((C,), jnp.int64)
    for t, lags in enumerate(tables):
        start, want_c = jax_rounds._rounds_scan(
            jnp.asarray(lags), jnp.asarray(valid), start, C, totals_rank_bits=0)
        np.testing.assert_array_equal(choice[t].reshape(-1)[:P].numpy(),
                                      np.asarray(want_c))
    np.testing.assert_array_equal(totals[0].numpy(), np.asarray(start))
    assert int(totals.sum()) > 2 ** (61 - rb)


@pytest.mark.parametrize("kind", ["totals0 > 0", "totals0 < 0", "negative gain"])
def test_start_and_sign_cases(kind):
    """A positive start packs; a negative start or a negative valid gain
    takes the two-key form; each equals the JAX scan from the same start."""
    C, P = 13, 70
    rng = np.random.default_rng(11)
    lags, valid, n_valid = sorted_case(5, P)
    totals0 = rng.integers(0, 10**6, size=C).astype(np.int64)
    if kind == "totals0 < 0":
        totals0[3] = -5
    if kind == "negative gain":
        lags[n_valid - 1] = -7
    gains, ok = kernel_rows(lags, valid, C, n_valid)
    rb = rounds_cuda.packed_rank_bits(gains, ok, torch.from_numpy(totals0))
    assert rb == (4 if kind == "totals0 > 0" else 0)
    want_t, want_c = jax_rounds._rounds_scan(
        jnp.asarray(lags), jnp.asarray(valid), jnp.asarray(totals0), C,
        n_valid=n_valid, totals_rank_bits=rb)
    got_t, got_c = port_body(lags, valid, C, n_valid, rb, totals0)
    np.testing.assert_array_equal(got_c, np.asarray(want_c))
    np.testing.assert_array_equal(got_t, np.asarray(want_t))
    choice, totals = rounds_cuda.rounds_scan(gains, ok, torch.from_numpy(totals0))
    np.testing.assert_array_equal(totals[0].numpy(), np.asarray(want_t))


@pytest.mark.parametrize("kind", ["uniform", "negative gain"])
def test_wrapper_runs_the_plain_version_in_the_admitted_form(monkeypatch, kind):
    """On the CPU the wrapper hands the plain version the rank_bits it would
    give the kernel."""
    C, P = 9, 40
    lags, valid, _ = sorted_case(2, P)
    if kind == "negative gain":
        lags[0] = -1
    gains, ok = kernel_rows(lags, valid, C)
    zeros = torch.zeros(C, dtype=torch.int64)
    seen = []
    plain = rounds_cuda.rounds_scan_torch

    def spy(*args):
        seen.append(args[-1])
        return plain(*args)

    monkeypatch.setattr(rounds_cuda, "rounds_scan_torch", spy)
    rounds_cuda.rounds_scan(gains, ok, zeros)
    assert seen == [rounds_cuda.packed_rank_bits(gains, ok, zeros)]
    assert seen[0] == (4 if kind == "uniform" else 0)


@pytest.mark.parametrize("kind", ["zeros", "ties", "wide"])
@pytest.mark.parametrize("C", [7, 64])
def test_scan_matches_jax_value_classes(kind, C):
    lags, valid, n_valid = sorted_case(C, 5 * C + 3, kind)
    want_t, want_c = port_scan(lags, valid, C, None)
    got_t, got_c = jax_scan(lags, valid, C, None, 0)
    np.testing.assert_array_equal(want_c, got_c)
    np.testing.assert_array_equal(want_t, got_t)
    if kind == "wide":
        assert want_t.max() > 2**31


@pytest.mark.parametrize(
    "C,P,kind,wide",
    [(7, 26, "uniform", False), (1000, 3005, "ties", False),
     (64, 197, "wide", True)],
)
def test_plain_kernel_matches_pallas_interpret(C, P, kind, wide):
    """The plain version of the CUDA kernel against the TPU kernel it
    replaces (K1 narrow / K2 wide), run by the Pallas interpreter."""
    lags, valid, _ = sorted_case(P, P, kind)
    R = -(-P // C)
    pad = R * C - P
    gains = np.concatenate([lags, np.zeros(pad, np.int64)]).reshape(R, C)
    valid_rows = np.concatenate([valid, np.zeros(pad, bool)]).reshape(R, C)
    pal_totals, pal_choice = rounds_scan_pallas(
        jnp.asarray(np.where(valid_rows, gains, -1).astype(np.int32)),
        num_consumers=C, interpret=True, wide=wide,
    )
    choice, totals = rounds_cuda.rounds_scan(
        torch.from_numpy(gains)[None].contiguous(),
        torch.from_numpy(valid_rows.astype(np.uint8))[None].contiguous(),
        torch.zeros(C, dtype=torch.int64),
    )
    np.testing.assert_array_equal(choice[0].numpy(), np.asarray(pal_choice))
    np.testing.assert_array_equal(totals[0].numpy(), np.asarray(pal_totals))
    if wide:
        assert totals.max() > 2**31


def test_packed_plain_body_matches_pallas_interpret():
    """The packed plain body (pad sentinel, unpacking, positional add) at
    64 slots of 41 consumers against the narrow TPU kernel (K1)."""
    C, P = 41, 200
    lags, valid, _ = sorted_case(41, P)
    gains, ok = kernel_rows(lags, valid, C)
    R = gains.shape[1]
    pal_totals, pal_choice = rounds_scan_pallas(
        jnp.asarray(np.where(ok[0].numpy() != 0, gains[0].numpy(), -1).astype(np.int32)),
        num_consumers=C, interpret=True, wide=False,
    )
    rb = rounds_cuda.packed_rank_bits(gains, ok, torch.zeros(C, dtype=torch.int64))
    assert rb == 6 and rounds_cuda.slots_for(C) == 64 and R == 5
    choice, totals = rounds_cuda.rounds_scan_torch(
        gains, ok, torch.zeros(C, dtype=torch.int64), False, rb)
    np.testing.assert_array_equal(choice[0].numpy(), np.asarray(pal_choice))
    np.testing.assert_array_equal(totals[0].numpy(), np.asarray(pal_totals))


def group_case(seed, T, P, C, max_lag=10**6):
    """A padded [T, P] group: ragged topics, shuffled partition ids."""
    rng = np.random.default_rng(seed)
    lags = np.zeros((T, P), np.int64)
    pids = np.zeros((T, P), np.int32)
    valid = np.zeros((T, P), bool)
    for t in range(T):
        n = int(rng.integers(1, P + 1))
        lags[t, :n] = rng.integers(0, max_lag, size=n)
        pids[t, :n] = rng.permutation(n)
        valid[t, :n] = True
    return lags, pids, valid


@pytest.mark.parametrize("pack_shift", [0, 11])
@pytest.mark.parametrize("solver", ["rounds", "global"])
def test_group_solve_matches_jax(solver, pack_shift):
    T, P, C = 4, 96, 13
    lags, pids, valid = group_case(7, T, P, C)
    rb = jax_batched.totals_rank_bits_for(
        lags.reshape(1, -1) if solver == "global" else lags, C
    )
    jax_fn, port_fn = (
        (jax_batched.assign_batched_rounds, assign_batched_rounds)
        if solver == "rounds"
        else (jax_rounds.assign_global_rounds, rounds_kernel.assign_global_rounds)
    )
    want = jax_fn(
        lags, pids, valid, num_consumers=C, pack_shift=pack_shift,
        totals_rank_bits=rb,
    )
    got = port_fn(
        torch.from_numpy(lags), torch.from_numpy(pids),
        torch.from_numpy(valid), C, pack_shift=pack_shift,
        n_valid=int(valid.sum(axis=1).max()),
    )
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("pack_shift", [0, 9])
def test_topic_solve_matches_jax(pack_shift):
    lags, pids, valid = group_case(3, 1, 300, 17)
    want = jax_rounds.assign_topic_rounds(
        lags[0], pids[0], valid[0], num_consumers=17, pack_shift=pack_shift,
    )
    got = rounds_kernel.assign_topic_rounds(
        torch.from_numpy(lags[0]), torch.from_numpy(pids[0]),
        torch.from_numpy(valid[0]), 17, pack_shift=pack_shift,
    )
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_wrapper_rejects_too_many_consumers():
    """One consumer above the register network's 16,384 slots used to be
    refused; the wrapper now answers it (the kernel's wide form on the
    card), in both key forms, bit for bit as the JAX round scan does."""
    C = rounds_cuda.REGISTER_SLOTS + 1
    lags, valid, n_valid = sorted_case(11, 2 * C + 5)
    gains, ok = kernel_rows(lags, valid, C)
    zeros = torch.zeros(C, dtype=torch.int64)
    rb = rounds_cuda.packed_rank_bits(gains, ok, zeros)
    assert rb == 15
    choice, totals = rounds_cuda.rounds_scan(gains, ok, zeros)
    for form in (rb, 0):
        want_t, want_c = jax_scan(lags, valid, C, None, form)
        got_c, got_t = rounds_cuda.rounds_scan_torch(gains, ok, zeros, False, form)
        np.testing.assert_array_equal(got_c.reshape(-1)[: lags.size].numpy(), want_c)
        np.testing.assert_array_equal(got_t[0].numpy(), want_t)
    np.testing.assert_array_equal(choice.reshape(-1)[: lags.size].numpy(), want_c)
    np.testing.assert_array_equal(totals[0].numpy(), want_t)


@pytest.mark.parametrize("carry", [False, True])
def test_wrapper_rejects_totals_reaching_the_sentinel(carry):
    """Each topic alone stays below 2**63 - 1; the two together do not,
    which only matters when the totals carry across topics."""
    big = 2**62
    gains = torch.tensor([[[big - 1, 0]], [[big, 0]]], dtype=torch.int64)
    valid = torch.ones_like(gains, dtype=torch.uint8)
    totals0 = torch.zeros(2, dtype=torch.int64)
    if carry:
        with pytest.raises(ValueError, match="sentinel"):
            rounds_cuda.rounds_scan(gains, valid, totals0, True)
    else:
        _, totals = rounds_cuda.rounds_scan(gains, valid, totals0)
        assert totals[:, 0].tolist() == [big - 1, big]
    # An invalid gain is never counted against the bound.
    valid[1, 0, 0] = 0
    _, totals = rounds_cuda.rounds_scan(gains, valid, totals0, carry)
    assert int(totals.sum()) == big - 1
