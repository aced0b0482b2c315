"""The port's quality solver (``solver=sinkhorn``) against the JAX package,
on the CPU.

Host numpy and integer stages match bit for bit: the rounding noise hash,
the dedup weights (tail quantization included), the linear-mode geometry.

The f32 kernels cannot match XLA's ``exp`` bit for bit, so their plain
versions (which the wrappers run for CPU tensors) are held to a tolerance
against the XLA references the JAX tests hold the Pallas kernels to:
``plan_stats_lax`` (and ``plan_stats_pallas`` in interpret mode at one tiny
shape), ``_superblock_partials`` and one mirror-prox step built from them.
Tolerance for each marginal: ``rtol=1e-5`` and ``atol=1e-6 * max|value|``
(a few f32 ulps of the largest entry: the sums run in another order).

The duals loops branch on ``spread > prev_spread`` and stop on ``delta >
tol``, so ulp-level differences can fork their trajectories: the duals are
compared after two iterations only (``|dA| <= 1e-4 * max|A|``, eta = 8
amplifies the marginals' differences into A; ``|dB| <= 1e-5``), and whole
solves are held to exact invariants — every valid row assigned once, count
spread <= 1, a peak load no worse than the greedy rounds solve's, the
additive bound in linear mode — and to a quality ratio within 2 % of the
JAX run's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from kafka_lag_based_assignor_tpu.assignor import (  # noqa: E402
    LagBasedPartitionAssignor as JaxAssignor,
)
from kafka_lag_based_assignor_tpu.models import sinkhorn as jax_sinkhorn  # noqa: E402
from kafka_lag_based_assignor_tpu.ops import dispatch as jax_dispatch  # noqa: E402
from kafka_lag_based_assignor_tpu.ops import linear_ot as jax_linear  # noqa: E402
from kafka_lag_based_assignor_tpu.ops import plan_stats as jax_plan  # noqa: E402
from kafka_lag_based_assignor_tpu.testing import FakeBroker as JaxBroker  # noqa: E402
from kafka_lag_based_assignor_tpu_torch import convert  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.assignor import (  # noqa: E402
    LagBasedPartitionAssignor,
)
from kafka_lag_based_assignor_tpu_torch.models import sinkhorn  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops import dispatch, linear_ot  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops import linear_ot_cuda, plan_stats  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops import plan_stats_cuda  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops.packing import pad_topic_rows  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops.rounds_kernel import (  # noqa: E402
    assign_topic_rounds,
)
from kafka_lag_based_assignor_tpu_torch.testing import (  # noqa: E402
    baseline_workload,
    broker_for,
    zipf_lags,
)
from kafka_lag_based_assignor_tpu_torch.types import (  # noqa: E402
    GroupSubscription,
    Subscription,
)
from kafka_lag_based_assignor_tpu_torch.utils.observability import (  # noqa: E402
    count_constrained_bound,
)

T = torch.from_numpy


def assert_close(got, want):
    """The f32 marginal tolerance of the module docstring."""
    got, want = np.asarray(got), np.asarray(want)
    atol = 1e-6 * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


def skewed(seed, P, zero_share=0.5):
    """Zipf lags with a share of zero-lag partitions (many ties)."""
    rng = np.random.default_rng(seed)
    lags = zipf_lags(rng, P)
    lags[rng.random(P) < zero_share] = 0
    return lags


def duals_case(seed, U, C):
    rng = np.random.default_rng(seed)
    ws = rng.gamma(0.5, 2.0, U).astype(np.float32)
    cnt = rng.integers(0, 5, U).astype(np.float32)
    wsum = (ws * cnt).astype(np.float32)
    A = rng.normal(0, 0.3, C).astype(np.float32)
    B = rng.normal(0, 0.1, C).astype(np.float32)
    return ws, cnt, wsum, A, B


# -- bit-exact host stages ---------------------------------------------------


def test_noise_matches_jax_bit_for_bit():
    p = np.concatenate([np.arange(300), [2**31 - 1, 2**30 + 7, 123456789]])
    p = np.concatenate([p, -p[1:]]).astype(np.int32)  # negative int32 wraps
    j = np.arange(70, dtype=np.int32)
    got = plan_stats.noise(T(p)[:, None], T(j)[None, :]).numpy()
    want = np.asarray(jax_plan.noise(jnp.asarray(p)[:, None], jnp.asarray(j)[None, :]))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("P,C,distinct", [(3000, 37, False), (9000, 100, True)])
def test_dedup_weights_match_jax_bit_for_bit(P, C, distinct):
    rng = np.random.default_rng(P)
    lags = (rng.permutation(P).astype(np.int64) * 1009 + 1 if distinct
            else skewed(P, P))
    valid = rng.random(P) < 0.9
    assert sinkhorn._scale_np(lags, valid, C) == jax_sinkhorn._scale_np(lags, valid, C)
    got = sinkhorn._dedup_weights(lags, valid, C)
    want = jax_sinkhorn._dedup_weights(lags, valid, C)
    if distinct:  # more than 4096 unique values: the tail is quantized
        assert len(np.unique(lags[valid])) > sinkhorn._DEDUP_CAP
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("rows", [1, 63, 64, 1000, 4097, 131072])
@pytest.mark.parametrize("tile", [8, 64, 1024])
def test_plan_shape_matches_jax(rows, tile):
    assert linear_ot.plan_shape(rows, tile) == jax_linear.plan_shape(rows, tile)


def test_scaled_and_blocked_rows_match_jax_bit_for_bit():
    lags = skewed(5, 1000)
    valid = np.arange(1000) < 900
    scale = sinkhorn._scale_np(lags, valid, 13)
    ws = sinkhorn._scaled_ws(T(lags), T(valid), 13).numpy()
    np.testing.assert_array_equal(
        ws, np.asarray(jax_sinkhorn._scaled_ws(jnp.asarray(lags), jnp.asarray(valid), 13))
    )
    P2, t, _ = linear_ot.plan_shape(1000, 64)
    got = [linear_ot._to_blocks(x, P2, 8, t).numpy()
           for x in linear_ot._ws_cnt(T(lags), T(valid), scale)]
    want = [np.asarray(jax_linear._to_blocks(x, P2, 8, t))
            for x in jax_linear._ws_cnt(jnp.asarray(lags), jnp.asarray(valid), scale)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# -- f32 kernels' plain versions, to the stated tolerance -----------------------


@pytest.mark.parametrize("U,C", [(1024, 512), (1000, 37), (8, 2)])
def test_plan_stats_matches_jax(U, C):
    ws, cnt, wsum, A, B = duals_case(U, U, C)
    before = plan_stats.plan_stats.launches
    got = plan_stats.plan_stats(*convert.dedup_from_numpy(ws, cnt, wsum, device="cpu"),
                                *convert.duals_from_numpy(A, B, device="cpu"))
    want = jax_plan.plan_stats_lax(*(jnp.asarray(x) for x in (ws, cnt, wsum, A, B)))
    for g, w in zip(got, want):
        assert_close(g.numpy(), w)
    assert plan_stats.plan_stats.launches == before  # CPU tensors: no launch


@pytest.mark.parametrize("need", ["both", "load", "colsum"])
@pytest.mark.parametrize("U,C", [(1024, 512), (1024, 16), (17, 31), (8, 2)])
def test_plan_stats_need_matches_jax(U, C, need):
    """Each ``need`` against the JAX package's, with None in the same place;
    a marginal asked for alone has its ``need="both"`` bits."""
    ws, cnt, wsum, A, B = duals_case(U + C, U, C)
    args = [T(x) for x in (ws, cnt, wsum, A, B)]
    got = plan_stats.plan_stats(*args, need=need)
    want = jax_plan.plan_stats_lax(*(jnp.asarray(x) for x in (ws, cnt, wsum, A, B)),
                                   need=need)
    assert [g is None for g in got] == [w is None for w in want]
    both = plan_stats.plan_stats(*args)
    for g, w, b in zip(got, want, both):
        if w is not None:
            assert_close(g.numpy(), w)
            assert torch.equal(g, b)


def test_plan_stats_refuses_an_unknown_need():
    ws, cnt, wsum, A, B = (T(x) for x in duals_case(0, 8, 2))
    with pytest.raises(ValueError, match="need"):
        plan_stats.plan_stats(ws, cnt, wsum, A, B, need="loads")


@pytest.mark.parametrize("config", [2, 4])
def test_sinkhorn_duals_with_need_equal_both_marginals(monkeypatch, config):
    """The duals loop asks for one marginal a call; the same loop given both
    marginals at every call ends on the same bits."""
    lags, members = baseline_workload(config)
    lags_p, _, valid = pad_topic_rows(lags["t0"])
    C = len(members)
    dedup = [T(a) for a in sinkhorn._dedup_weights(lags_p, valid, C)]
    needs = []
    A, B = sinkhorn._sinkhorn_duals(*dedup, C, iters=6)
    real = sinkhorn.plan_stats

    def both(*args, need="both"):
        needs.append(need)
        return real(*args)

    monkeypatch.setattr(sinkhorn, "plan_stats", both)
    A2, B2 = sinkhorn._sinkhorn_duals(*dedup, C, iters=6)
    assert needs[:2] == ["load", "colsum"]
    assert torch.equal(A, A2) and torch.equal(B, B2)


@pytest.mark.parametrize("U,C,form", [
    (1, 1, "cluster"), (1024, 16, "cluster"), (1024, 512, "cluster"), (2048, 1024, "cluster"),
    (4096, 512, "pass"), (1024, 1025, "columns"), (8, 16384, "columns"),
    (4096, 1024, "pass"), (1, 60000, "columns"),
])
def test_plan_stats_form_choice(U, C, form):
    assert plan_stats_cuda.form_for(U, C) == form


@pytest.mark.parametrize("U,C,tile,per,tickets,floats", [
    # The pass form (C <= 1024): tiles = ceil(U / 16) in groups of
    # ceil(sqrt(tiles)); tickets: tiles + groups + 3; floats: the tile rows
    # of both marginals and, with more than one group, the group rows.
    (1, 1, 16, 1, 5, 2),
    (1024, 512, 16, 8, 75, 2 * 64 * 512 + 2 * 8 * 512),
    (1040, 3, 16, 9, 76, 2 * 65 * 3 + 2 * 8 * 3),
    # The column form (C > 1024): tiles = ceil(U / 64); tickets: (tiles +
    # groups + 1) a column tile of 1,024 consumers, the totals' ticket, one
    # a 256-row block and the exit count; floats add 4 + U * (4 + 2 *
    # column tiles) of row statistics.
    (4096, 16384, 64, 8, (64 + 8 + 1) * 16 + 1 + 16 + 1,
     2 * 64 * 16384 + 2 * 8 * 16384 + 4 + 4096 * (4 + 2 * 16)),
    (1024, 20000, 64, 4, (16 + 4 + 1) * 20 + 1 + 4 + 1,
     2 * 16 * 20000 + 2 * 4 * 20000 + 4 + 1024 * (4 + 2 * 20)),
    (17, 1025, 64, 1, (1 + 1 + 1) * 2 + 1 + 1 + 1, 2 * 1025 + 4 + 17 * (4 + 2 * 2)),
])
def test_plan_stats_pass_geometry(U, C, tile, per, tickets, floats):
    assert plan_stats_cuda.pass_geometry(U, C) == (tile, per, tickets, floats)


@pytest.mark.parametrize("C,form", [(1025, "cluster"), (1024, "columns"), (16, "columns")])
def test_plan_stats_launch_refuses_a_form_the_width_does_not_take(C, form):
    """The cluster form holds A and B in registers (C <= 1024); the column
    form is the whole-card pass above 1,024 consumers only."""
    ws, cnt, wsum, A, B = (T(x) for x in duals_case(0, 8, C))
    with pytest.raises(ValueError, match="form"):
        plan_stats_cuda.launch(ws, cnt, wsum, A, B, form=form)


def test_plan_stats_scratch_is_kept_per_device_stream_and_shape(monkeypatch):
    """The pass form's scratch is kept for each (device, stream) and only
    grows, whatever the shapes it serves."""
    monkeypatch.setattr(plan_stats_cuda, "_scratch", {})
    cpu = torch.device("cpu")
    first = plan_stats_cuda.scratch_for(cpu, 7, *plan_stats_cuda.pass_geometry(4096, 512)[2:])
    tickets, rows = first
    assert tickets.dtype == torch.int32 and not tickets.any() and rows.dtype == torch.float32
    assert (tickets.numel(), rows.numel()) == plan_stats_cuda.pass_geometry(4096, 512)[2:]
    assert plan_stats_cuda.scratch_for(cpu, 7, *plan_stats_cuda.pass_geometry(1024, 511)[2:]) \
        is first
    assert plan_stats_cuda.scratch_for(cpu, 8, 275, 4) is not first
    grown = plan_stats_cuda.scratch_for(cpu, 7, 300, 10)
    assert grown is not first and not grown[0].any()
    assert (grown[0].numel(), grown[1].numel()) == (300, rows.numel())
    assert plan_stats_cuda.scratch_for(cpu, 7, 5, 2) is grown
    assert set(plan_stats_cuda._scratch) == {(-1, 7), (-1, 8)}


@pytest.mark.parametrize("need,form", [("loads", None), ("load", "grid")])
def test_plan_stats_launch_refuses_unknown_need_or_form(need, form):
    ws, cnt, wsum, A, B = (T(x) for x in duals_case(0, 8, 2))
    with pytest.raises(ValueError):
        plan_stats_cuda.launch(ws, cnt, wsum, A, B, need=need, form=form)


def test_plan_stats_matches_the_pallas_kernel_in_interpret_mode():
    ws, cnt, wsum, A, B = duals_case(1, 16, 5)
    got = plan_stats.plan_stats(*(T(x) for x in (ws, cnt, wsum, A, B)))
    want = jax_plan.plan_stats_pallas(*(jnp.asarray(x) for x in (ws, cnt, wsum, A, B)),
                                      interpret=True)
    for g, w in zip(got, want):
        assert_close(g.numpy(), w)


def blocked_case(seed, P, C, tile):
    lags = skewed(seed, P, zero_share=0.3)
    valid = np.arange(P) < P - P // 10
    scale = sinkhorn._scale_np(lags, valid, C)
    P2, t, _ = linear_ot.plan_shape(P, tile)
    ws, cnt = jax_linear._ws_cnt(jnp.asarray(lags), jnp.asarray(valid), scale)
    blocks = [np.array(jax_linear._to_blocks(x, P2, 8, t)) for x in (ws, cnt)]
    rng = np.random.default_rng(seed)
    A = rng.normal(0, 0.5, C).astype(np.float32)
    B = rng.normal(0, 0.1, C).astype(np.float32)
    return blocks[0], blocks[1], A, B


@pytest.mark.parametrize("P,C,tile", [(2048, 100, 64), (600, 2, 8), (1024, 130, 1024)])
def test_superblock_partials_match_jax(P, C, tile):
    ws_b, cnt_b, A, B = blocked_case(P, P, C, tile)
    got = linear_ot_cuda.superblock_partials(T(ws_b), T(cnt_b), T(A), T(B))
    want = jax_linear._superblock_partials(*(jnp.asarray(x) for x in (ws_b, cnt_b, A, B)))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert_close(g.numpy(), w)


def jax_step(ws_b, cnt_b, A, B, sc, prev_spread):
    """One mirror-prox step of the JAX package's unfused body."""
    ws_b, cnt_b, A, B = (jnp.asarray(x) for x in (ws_b, cnt_b, A, B))
    load1 = jax_linear._ordered_sum(jax_linear._superblock_partials(ws_b, cnt_b, A, B)[0])
    spread = jnp.max(load1) - jnp.min(load1)
    sc = jnp.where(spread > prev_spread, sc * jnp.float32(0.5),
                   jnp.minimum(sc * jnp.float32(1.2), jnp.float32(1.0)))
    A_half = A + jnp.float32(8.0) * sc * (load1 - jax_linear._mean_padded(load1))
    l2, c2 = jax_linear._superblock_partials(ws_b, cnt_b, A_half, B)
    return load1, jax_linear._ordered_sum(l2), jax_linear._ordered_sum(c2)


@pytest.mark.parametrize("sc,prev_spread", [(1.0, np.inf), (0.5, 0.0)])
@pytest.mark.parametrize("P,C,tile", [(2048, 100, 64), (600, 2, 8)])
def test_mirror_prox_step_matches_jax(P, C, tile, sc, prev_spread):
    ws_b, cnt_b, A, B = blocked_case(P + 1, P, C, tile)
    want = jax_step(ws_b, cnt_b, A, B, np.float32(sc), np.float32(prev_spread))
    scalars = (torch.tensor(sc, dtype=torch.float32),
               torch.tensor(prev_spread, dtype=torch.float32))
    before = linear_ot_cuda.mirror_prox_step.launches
    fused = linear_ot_cuda.mirror_prox_step(T(ws_b), T(cnt_b), T(A), T(B), *scalars,
                                            eta=linear_ot.MIRROR_PROX_ETA)
    assert linear_ot_cuda.mirror_prox_step.launches == before
    plain = linear_ot_cuda.mirror_prox_step_torch(T(ws_b), T(cnt_b), T(A), T(B),
                                                  *scalars, eta=8.0)
    for f, p, w in zip(fused, plain, want):
        assert torch.equal(f, p)
        assert_close(f.numpy(), w)


def edge_blocks(name):
    """The kernels' edge shapes: 65 real rows in P2 = 4096 (the trailing
    tiles all padding), or the largest consumer count with 8 x 1 x 8 rows."""
    rng = np.random.default_rng(11)
    if name == "65 real rows of 4096":
        ws = np.zeros(4096, np.float32)
        cnt = np.zeros(4096, np.float32)
        ws[:65] = rng.gamma(0.5, 2.0, 65)
        ws[:65][rng.random(65) < 0.2] = 0.0  # valid zero-lag rows
        cnt[:65] = 1.0
        blocks = [np.array(jax_linear._to_blocks(jnp.asarray(x), 4096, 8, 64))
                  for x in (ws, cnt)]
        C = 100
    else:
        blocks = [rng.gamma(0.5, 2.0, (8, 1, 8)).astype(np.float32),
                  (rng.random((8, 1, 8)) < 0.8).astype(np.float32)]
        C = 16384
    A = rng.normal(0, 0.5, C).astype(np.float32)
    B = rng.normal(0, 0.1, C).astype(np.float32)
    return blocks[0], blocks[1], A, B


EDGE_CASES = ["65 real rows of 4096", "C=16384 at 8 x 1 x 8"]


@pytest.mark.parametrize("name", EDGE_CASES)
def test_superblock_partials_match_jax_at_edge_shapes(name):
    ws_b, cnt_b, A, B = edge_blocks(name)
    got = linear_ot_cuda.superblock_partials(T(ws_b), T(cnt_b), T(A), T(B))
    want = jax_linear._superblock_partials(*(jnp.asarray(x) for x in (ws_b, cnt_b, A, B)))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert_close(g.numpy(), w)


@pytest.mark.parametrize("sc,prev_spread", [(1.0, np.inf), (0.5, 0.0)])
@pytest.mark.parametrize("name", EDGE_CASES)
def test_mirror_prox_step_matches_jax_at_edge_shapes(name, sc, prev_spread):
    ws_b, cnt_b, A, B = edge_blocks(name)
    want = jax_step(ws_b, cnt_b, A, B, np.float32(sc), np.float32(prev_spread))
    scalars = (torch.tensor(sc, dtype=torch.float32),
               torch.tensor(prev_spread, dtype=torch.float32))
    got = linear_ot_cuda.mirror_prox_step(T(ws_b), T(cnt_b), T(A), T(B), *scalars,
                                          eta=linear_ot.MIRROR_PROX_ETA)
    for g, w in zip(got, want):
        assert_close(g.numpy(), w)


@pytest.mark.parametrize("wrapper", ["superblock_partials", "mirror_prox_step"])
def test_linear_ot_wrappers_refuse_one_consumer_too_many(wrapper):
    """16,385 consumers, once refused, are answered: both wrappers hold the
    JAX functions' values to the module's tolerance; zero consumers still
    raise."""
    C = 16385
    rng = np.random.default_rng(16385)
    ws = rng.gamma(0.5, 2.0, (8, 1, 8)).astype(np.float32)
    cnt = (rng.random((8, 1, 8)) < 0.8).astype(np.float32)
    A = rng.normal(0, 0.5, C).astype(np.float32)
    B = rng.normal(0, 0.1, C).astype(np.float32)
    if wrapper == "superblock_partials":
        got = linear_ot_cuda.superblock_partials(T(ws), T(cnt), T(A), T(B))
        want = jax_linear._superblock_partials(*(jnp.asarray(x) for x in (ws, cnt, A, B)))
    else:
        got = linear_ot_cuda.mirror_prox_step(T(ws), T(cnt), T(A), T(B), torch.tensor(1.0),
                                              torch.tensor(0.0), eta=8.0)
        want = jax_step(ws, cnt, A, B, np.float32(1.0), np.float32(0.0))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert_close(g.numpy(), w)
    with pytest.raises(ValueError, match="consumer"):
        linear_ot_cuda.superblock_partials(T(ws), T(cnt), torch.zeros(0), torch.zeros(0))


def test_sinkhorn_duals_track_jax():
    lags = skewed(7, 3000)
    valid = np.ones(3000, bool)
    weights = jax_sinkhorn._dedup_weights(lags, valid, 37)
    A, B = jax_sinkhorn._sinkhorn_duals_jit(*weights, num_consumers=37, iters=2)
    a, b = sinkhorn._sinkhorn_duals(*(T(w) for w in weights), 37, iters=2)
    np.testing.assert_allclose(a.numpy(), A, rtol=0, atol=1e-4 * np.abs(A).max())
    np.testing.assert_allclose(b.numpy(), B, rtol=0, atol=1e-5)


@pytest.mark.parametrize("tile", [64, 256])
def test_linear_duals_track_jax(tile):
    P, C = 4096, 37
    lags = np.zeros(P, np.int64)
    lags[:3000] = skewed(8, 3000)
    valid = np.arange(P) < 3000
    scale = sinkhorn._scale_np(lags, valid, C)
    A, B, rounds = jax_linear._linear_duals_jit(
        jnp.asarray(lags), jnp.asarray(valid), np.float64(scale), np.float32(3000),
        num_consumers=C, iters=2, tile=tile,
    )
    a, b, r = linear_ot._linear_duals(T(lags), T(valid), scale, 3000,
                                      num_consumers=C, iters=2, tile=tile)
    assert r == int(rounds) == 2
    np.testing.assert_allclose(a.numpy(), A, rtol=0, atol=1e-4 * np.abs(A).max())
    np.testing.assert_allclose(b.numpy(), B, rtol=0, atol=1e-5)


# -- whole solves: exact invariants ------------------------------------------


def quality_ratio(lags, choice, C):
    v = choice >= 0
    totals = np.bincount(choice[v], weights=lags[v].astype(np.float64), minlength=C)
    mean = totals.sum() / C
    imbalance = totals.max() / mean if mean > 0 else 1.0
    return imbalance / max(count_constrained_bound(lags[v], C), 1.0)


def check_invariants(lags, valid, choice, C):
    """Every valid row once, on a real consumer; padding unassigned; count
    spread <= 1; peak load no worse than the greedy rounds solve's."""
    choice = np.asarray(choice)
    assert np.all((choice[valid] >= 0) & (choice[valid] < C))
    assert np.all(choice[~valid] == -1)
    counts = np.bincount(choice[valid], minlength=C)
    assert counts.max() - counts.min() <= 1
    totals = np.bincount(choice[valid], weights=lags[valid], minlength=C)
    _, _, g_totals = assign_topic_rounds(
        T(lags), T(np.arange(len(lags), dtype=np.int32)), T(valid), C
    )
    assert totals.max() <= int(g_totals.max())
    return totals


@pytest.mark.parametrize(
    "P,C,zero_share", [(1000, 16, 0.0), (5000, 64, 0.9)],
    ids=["sequential_rounding", "parallel_rounding"],
)
def test_assign_topic_sinkhorn_invariants(P, C, zero_share):
    lags_p, pids_p, valid = pad_topic_rows(skewed(P, P, zero_share))
    with dispatch.quality_scope("sinkhorn"):
        choice, counts, totals = sinkhorn.assign_topic_sinkhorn(
            lags_p, pids_p, valid, C, device="cpu"
        )
    with jax_dispatch.quality_scope("sinkhorn"):
        want = jax_sinkhorn.assign_topic_sinkhorn(lags_p, pids_p, valid, C)[0]
    got_totals = check_invariants(lags_p, valid, choice.numpy(), C)
    np.testing.assert_array_equal(got_totals, totals.numpy())
    assert quality_ratio(lags_p, choice.numpy(), C) <= (
        quality_ratio(lags_p, np.asarray(want), C) * 1.02
    )


def test_round_parallel_is_a_valid_rounding_of_jax_duals():
    P, C = 8192, 50
    lags = skewed(9, P, 0.5)
    valid = np.arange(P) < 8000
    A, B, ws = jax_sinkhorn.sinkhorn_duals(lags, valid, C)
    n_valid = 8000
    args = (lags, np.array(ws), valid, np.array(A), np.array(B))
    got = sinkhorn._round_parallel(*(T(x) for x in args), C, n_valid // C, n_valid % C)
    want = jax_sinkhorn._round_parallel(
        *(jnp.asarray(x) for x in args), C, n_valid // C, n_valid % C
    )
    got = got.numpy()
    assert np.all(got[~valid] == -1) and np.all(got[valid] >= 0)
    counts = np.bincount(got[valid], minlength=C)
    assert counts.min() == n_valid // C and counts.max() == -(-n_valid // C)
    # Reported, not asserted: the plan argmax and the kept-load cumsum are
    # f32, so the rounding may differ from JAX's in near-ties.
    print("round_parallel bit-equal to JAX:", np.array_equal(got, np.asarray(want)))


def test_assign_topic_linear_invariants():
    P, C = 3000, 24
    lags_p, pids_p, valid = pad_topic_rows(skewed(11, P, 0.2))
    with dispatch.quality_scope("linear", tile=64):
        choice, _, totals = linear_ot.assign_topic_linear(
            lags_p, pids_p, valid, C, device="cpu"
        )
    with jax_dispatch.quality_scope("linear", tile=64):
        want = jax_linear.assign_topic_linear(lags_p, pids_p, valid, C)[0]
    check_invariants(lags_p, valid, choice, C)
    assert totals.max() <= linear_ot.additive_bound(lags_p, valid, C)
    info = linear_ot.last_solve_info()
    assert info["tile"] == 64 and info["backend"] == "cpu"
    assert quality_ratio(lags_p, choice, C) <= quality_ratio(lags_p, np.asarray(want), C) * 1.02


def test_quality_router_matches_jax():
    for mode in ("auto", "sinkhorn", "linear"):
        with dispatch.quality_scope(mode), jax_dispatch.quality_scope(mode):
            for rows in (8, 32767, 32768, 131072):
                for C in (1, 2, 1000):
                    assert dispatch.resolve_quality_mode(rows, C) == (
                        jax_dispatch.resolve_quality_mode(rows, C)
                    )
    with pytest.raises(ValueError):
        with dispatch.quality_scope("linear", tile=100):
            pass
    assert dispatch.quality_mode() == "auto" and dispatch.quality_tile() == 1024


def jax_broker_for(lags):
    broker = JaxBroker()
    for topic, arr in lags.items():
        for p, value in enumerate(arr.tolist()):
            broker.with_partition(topic, p, end=value, committed=0)
    return broker


@pytest.mark.parametrize("mode", ["auto", "linear"])
def test_plugin_sinkhorn_solver_invariants(mode):
    lags = {"a": skewed(1, 700), "b": skewed(2, 64, 0.0), "c": skewed(3, 5)}
    members = [f"m{i}" for i in range(9)]
    subs = {m: ["a", "b", "c"] if i % 3 else ["a", "b"] for i, m in enumerate(members)}
    group = GroupSubscription({m: Subscription(t) for m, t in subs.items()})
    configs = {"group.id": "g", "tpu.assignor.solver": "sinkhorn",
               "tpu.assignor.refine.iters": "16"}
    port = LagBasedPartitionAssignor(lambda props: broker_for(lags), device="cpu")
    port.configure(configs)
    ref = JaxAssignor(lambda props: jax_broker_for(lags))
    ref.configure(configs)
    with dispatch.quality_scope(mode, tile=64), jax_dispatch.quality_scope(mode, tile=64):
        got = port.assign(broker_for(lags).cluster(), group)
        want = ref.assign(broker_for(lags).cluster(), group)
    assert port.last_stats.device == "cpu" and port.last_stats.refine_iters == 16
    assert port.last_stats.refine_iters == ref.last_stats.refine_iters
    for topic, arr in lags.items():
        held = {m: [tp.partition for tp in a.partitions if tp.topic == topic]
                for m, a in got.group_assignment.items()}
        takers = [m for m in members if topic in subs[m]]
        rows = sorted(p for m in takers for p in held[m])
        assert rows == list(range(len(arr)))  # every partition once
        assert all(not held[m] for m in members if m not in takers)
        counts = [len(held[m]) for m in takers]
        assert max(counts) - min(counts) <= 1
    assert port.last_stats.quality_ratio <= ref.last_stats.quality_ratio * 1.02
