"""The batched resident refine and the batched digest, on the CPU.

* ``ops/refine.refine_rounds_resident_rows`` against N single-row
  ``refine_rounds_resident(bulk_transfer=True, fan=8)`` calls on the same
  inputs: every row's choice, table, counts and totals equal bit for bit,
  its rounds and exchanges exact.  Rows stop at different rounds (patience,
  target met, budget spent), a live quality limit per row, exchange budgets,
  zero-lag padding rows (limit 0.0), N of 1, 3 and 32;
* ``ops/coalesce._epoch_rows`` (the wave's warm core) against the JAX
  package's vmapped ``_epoch_rows`` on the same stacked inputs;
* ``ops/refine.state_digest_rows``' plain version against N single-row
  ``state_digest(..., row_tab=...)`` calls, clean and with each corruption
  class of ``utils/scrub``, and its input checks.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from kafka_lag_based_assignor_tpu.ops import coalesce as jax_coalesce  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops import coalesce, refine  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops.packing import table_rows  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops.rounds_kernel import (  # noqa: E402
    assign_topic_rounds,
)
from kafka_lag_based_assignor_tpu_torch.utils import scrub  # noqa: E402


def resident_row(rng, P, B, C, drift=True, zero=False):
    """(lags int64[B], choice int32[B], row_tab, counts, totals): a greedy
    solve's resident state, then the lags drifted (the warm epoch's
    input).  ``zero`` gives a padding row: zero lags."""
    lags = np.zeros(B, np.int64)
    lags[:P] = rng.integers(10**6, 10**8, P)
    pids = torch.arange(B, dtype=torch.int32)
    valid = pids < P
    choice, _, _ = assign_topic_rounds(torch.from_numpy(lags), pids, valid, C, n_valid=P)
    if drift:
        lags[:P] = rng.integers(10**6, 10**8, P)
        hot = rng.random(P) < 0.1
        lags[:P][hot] *= 3
    if zero:
        lags[:] = 0
    lt = torch.from_numpy(lags)
    tab, counts, totals = refine.build_choice_tables(lt, valid, choice, C, table_rows(B, C))
    return lt, choice.to(torch.int32), tab, counts, totals


def stack(rows, k):
    return torch.stack([r[k] for r in rows])


def check_rows(rows, C, iters, max_pairs, budget, limits, patience=8):
    want = [
        refine.refine_rounds_resident(
            *r, num_consumers=C, iters=iters, max_pairs=max_pairs, patience=patience,
            exchange_budget=budget, quality_limit=limits[n], bulk_transfer=True, fan=8)
        for n, r in enumerate(rows)
    ]
    got = refine.refine_rounds_resident_rows(
        stack(rows, 0), stack(rows, 1), stack(rows, 2), stack(rows, 3), stack(rows, 4),
        num_consumers=C, iters=iters, max_pairs=max_pairs, patience=patience,
        exchange_budget=budget, quality_limits=limits, fan=8)
    for n, w in enumerate(want):
        for k in range(4):
            assert torch.equal(got[k][n], w[k]), (n, k)
        assert (int(got[4][n]), int(got[5][n])) == (w[4], w[5]), n
    return [w[4] for w in want], [w[5] for w in want]


@pytest.mark.parametrize("N", [1, 3, 32])
@pytest.mark.parametrize("budget", [0, 16])
def test_rows_equal_single_rows_without_limit(N, budget):
    rng = np.random.default_rng(100 + N + budget)
    rows = [resident_row(rng, 300, 320, 8) for _ in range(N)]
    check_rows(rows, 8, 64, 4, budget, [-1.0] * N)


@pytest.mark.parametrize("N", [1, 3, 32])
def test_rows_with_a_live_limit_each(N):
    """Each row its own target: some met before the first round (limit
    above the peak), some live, some disabled; the rows stop at different
    rounds."""
    rng = np.random.default_rng(7 * N)
    rows = [resident_row(rng, 500, 512, 8) for _ in range(N)]
    limits = []
    for n, r in enumerate(rows):
        mean = float(r[4].double().mean())
        limits.append([-1.0, 1.02 * mean, 1.10 * mean, 1e18][n % 4])
    rounds, _ = check_rows(rows, 8, 128, 4, 0, limits)
    if N >= 4:
        assert len(set(rounds)) > 1, "the rows stopped together"
        assert rounds[3] == 0  # target met before the first round


@pytest.mark.parametrize("budget", [1, 7, 40])
def test_exchange_budgets_per_row(budget):
    rng = np.random.default_rng(budget)
    rows = [resident_row(rng, 400, 512, 16) for _ in range(5)]
    _, ex = check_rows(rows, 16, 64, 16, budget, [-1.0] * 5)
    assert max(ex) <= budget


def test_zero_lag_padding_rows_pass_through():
    """A batch's padding rows: zero lags and a 0.0 limit stop before round
    one and come back unchanged, beside live rows."""
    rng = np.random.default_rng(3)
    live = [resident_row(rng, 200, 256, 4) for _ in range(2)]
    pad = [resident_row(rng, 200, 256, 4, zero=True) for _ in range(2)]
    rows = live + pad
    rounds, ex = check_rows(rows, 4, 32, 2, 8, [-1.0, -1.0, 0.0, 0.0])
    assert rounds[2:] == [0, 0] and ex[2:] == [0, 0]
    got = refine.refine_rounds_resident_rows(
        stack(rows, 0), stack(rows, 1), stack(rows, 2), stack(rows, 3), stack(rows, 4),
        4, 32, 2, exchange_budget=8, quality_limits=[-1.0, -1.0, 0.0, 0.0])
    assert torch.equal(got[0][2:], stack(rows, 1)[2:])


def test_patience_stops_rows_apart():
    rng = np.random.default_rng(11)
    rows = [resident_row(rng, 600, 640, 8) for _ in range(6)]
    rounds, _ = check_rows(rows, 8, 200, 4, 0, [-1.0] * 6, patience=2)
    assert len(set(rounds)) > 1


def test_inputs_are_never_written():
    rng = np.random.default_rng(5)
    rows = [resident_row(rng, 100, 128, 4) for _ in range(3)]
    args = [stack(rows, k) for k in range(5)]
    copies = [a.clone() for a in args]
    refine.refine_rounds_resident_rows(*args, num_consumers=4, iters=16, fan=8)
    for a, c in zip(args, copies):
        assert torch.equal(a, c)


def test_no_rounds_for_one_consumer_or_no_budget():
    rng = np.random.default_rng(6)
    rows = [resident_row(rng, 50, 64, 1, drift=False) for _ in range(2)]
    out = refine.refine_rounds_resident_rows(*[stack(rows, k) for k in range(5)],
                                             num_consumers=1, iters=8)
    assert list(out[4]) == [0, 0] and list(out[5]) == [0, 0]
    rows = [resident_row(rng, 50, 64, 4) for _ in range(2)]
    out = refine.refine_rounds_resident_rows(*[stack(rows, k) for k in range(5)],
                                             num_consumers=4, iters=0)
    assert torch.equal(out[0], stack(rows, 1))


@pytest.mark.parametrize("N,limit", [(3, "none"), (4, "live")])
def test_epoch_rows_match_jax(N, limit):
    """The wave's warm core against the JAX package's vmapped core on the
    same stacked state: narrow choice, resident successors, totals, rounds,
    exchanges and digest, row for row."""
    rng = np.random.default_rng(40 + N)
    C, B, P = 8, 512, 480
    rows = [resident_row(rng, P, B, C) for _ in range(N)]
    lags = stack(rows, 0)
    limits = np.array([-1.0] * N if limit == "none"
                      else [1.03 * float(r[4].double().mean()) for r in rows])
    want = jax_coalesce._megabatch_fused_locked(
        jnp.asarray(lags.numpy().astype(np.int32)), jnp.asarray(stack(rows, 1).numpy()),
        jnp.asarray(stack(rows, 2).numpy()), jnp.asarray(stack(rows, 3).numpy()),
        jnp.asarray(limits), num_consumers=C, iters=32, max_pairs=4, exchange_budget=32)
    got = coalesce._epoch_rows(
        lags.to(torch.int32), stack(rows, 1), stack(rows, 2), stack(rows, 3),
        torch.from_numpy(limits), C, 32, 4, 32)
    for k, (w, g) in enumerate(zip(want, got)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"output {k}")


def digest_rows(rng, N, B=256, C=8):
    rows = [resident_row(rng, B - 17, B, C, drift=False) for _ in range(N)]
    return (stack(rows, 0).contiguous(), stack(rows, 1).contiguous(),
            stack(rows, 3).contiguous(), stack(rows, 2).contiguous())


def single_digests(lags, choice, counts, tab, C):
    return torch.stack([
        refine.state_digest(lags[n], choice[n], counts[n], C, row_tab=tab[n])
        for n in range(lags.shape[0])
    ])


@pytest.mark.parametrize("N", [1, 3, 32])
def test_digest_rows_equal_single_rows_clean(N):
    rng = np.random.default_rng(N)
    lags, choice, counts, tab = digest_rows(rng, N)
    got = refine.state_digest_rows(lags, choice, counts, 8, tab)
    assert got.dtype == torch.int64 and tuple(got.shape) == (N, 5)
    assert torch.equal(got, single_digests(lags, choice, counts, tab, 8))
    for n in range(N):
        assert scrub.digest_failures(got[n].numpy(), 239,
                                     int(lags[n].sum())) == []


@pytest.mark.parametrize("buffer", sorted(scrub.CORRUPT_POINTS))
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_digest_rows_catch_each_corruption_in_its_row(buffer, seed):
    """A bit flipped in one row's named buffer shows in that row's digest
    alone, as the single-row digest shows it."""
    rng = np.random.default_rng(seed)
    N, C = 4, 8
    lags, choice, counts, tab = digest_rows(rng, N, C=C)
    clean = refine.state_digest_rows(lags, choice, counts, C, tab)
    bufs = {"lags": lags, "choice": choice, "counts": counts, "row_tab": tab}
    victim = seed % N
    arr = bufs[buffer]
    limit = None if buffer in ("counts", "row_tab") else 239
    arr[victim] = torch.from_numpy(scrub.flip_bit(arr[victim].numpy(), seed, limit=limit))
    got = refine.state_digest_rows(lags, choice, counts, C, tab)
    assert torch.equal(got, single_digests(lags, choice, counts, tab, C))
    others = [n for n in range(N) if n != victim]
    assert torch.equal(got[others], clean[others])
    truth = int(np.asarray(bufs["lags"][victim]).sum()) if buffer != "lags" else int(
        clean[victim][2])
    assert scrub.digest_failures(got[victim].numpy(), 239, truth)


@pytest.mark.parametrize("bad", ["rank", "rows", "dtype", "consumers", "strided"])
def test_digest_rows_input_checks(bad):
    rng = np.random.default_rng(0)
    lags, choice, counts, tab = digest_rows(rng, 2)
    C = 8
    if bad == "rank":
        lags = lags[0]
    elif bad == "rows":
        counts = counts[:1]
    elif bad == "dtype":
        choice = choice.to(torch.int64)
    elif bad == "consumers":
        C = 20000
    else:
        tab = tab[:, :, :3]
    with pytest.raises(ValueError):
        refine.state_digest_rows(lags, choice, counts, C, tab)


def test_cpu_digest_rows_count_no_launch():
    rng = np.random.default_rng(0)
    before = refine.state_digest_rows.launches
    refine.state_digest_rows(*digest_rows(rng, 2)[:3], 8, digest_rows(rng, 2)[3])
    assert refine.state_digest_rows.launches == before
