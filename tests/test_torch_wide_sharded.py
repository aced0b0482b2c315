"""The port's P-axis sharded programs at 16,385 and 20,000 consumers
against the JAX package, on the CPU.

The port's mesh is one process over 8 virtual CPU shards
(``sharded.mesh.set_virtual_shards(8, "cpu")``), beside the JAX package's 8
virtual CPU devices (``tests/conftest.py``).  At groups wider than the
register network:

* the exchange program: ``solve_sharded`` and ``refine_sharded`` bit for
  bit with JAX at D 2 and 4 (P 65,536, C 20,000);
* the linear duals (``_linear_duals_sharded``, K5 per shard on the card:
  its column form at Sb 8, 4, 2) at P2 2,048 (2,000 rows), tile 256, 2
  rounds: bit-identical across D 1, 2 and 4 at C 16,385 and 20,000, and
  at C 20,000 within a bound of JAX's sharded duals and as close to the
  float64 duals as JAX's are; at P2 8,192 (6,000 rows), one round, within
  ``tests/test_torch_sharded.py``'s tolerance of JAX's.  The plain K5 body
  costs about 0.7 s a marginal at P2 2,048 and C 20,000 on one core, 4x
  that at 8,192; the card runs the wide group's 200,000 rows
  (``chip_smoke.py``, phase 4m).

The engine's sharded cold epoch, the topic axis and placement at these
widths are in ``tests/test_torch_wide_placed.py``.  Integer paths: exact.
Inputs are made with numpy from a seed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from kafka_lag_based_assignor_tpu.models import sinkhorn as jax_sinkhorn  # noqa: E402
from kafka_lag_based_assignor_tpu.sharded import solve as jax_solve  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops import linear_ot  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.sharded import solve as port_solve  # noqa: E402
from test_torch_sharded import (  # noqa: E402
    jmesh,
    no_global_manager,
    pmesh,
    virtual_cpu_shards,
)
from test_torch_wide_groups import one_torch_thread  # noqa: E402

pytestmark = [pytest.mark.skipif(len(jax.devices()) < 8,
                                 reason="virtual 8-device CPU mesh unavailable"),
              pytest.mark.usefixtures(virtual_cpu_shards.__name__, no_global_manager.__name__,
                                      one_torch_thread.__name__)]

ABOVE, WIDE = 16_385, 20_000



def uniform(seed, P):
    return np.random.default_rng(seed).integers(0, 10**6, P).astype(np.int64)


def balanced(choice, P, C):
    choice = np.asarray(choice)
    assert choice.shape == (P,) and choice.min() >= 0 and choice.max() < C
    counts = np.bincount(choice, minlength=C)
    assert counts.max() - counts.min() <= 1


# -- the exchange program -----------------------------------------------------


@pytest.mark.parametrize("D", [2, 4])
def test_solve_and_refine_sharded_bit_equal_to_jax(D):
    P, C = 65_536, WIDE
    lags = uniform(D, P)
    want = jax_solve.solve_sharded(jmesh(D), lags, C, refine_iters=16)
    got = port_solve.solve_sharded(pmesh(D), lags, C, refine_iters=16)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[3] == want[3]
    balanced(got[0], P, C)
    rng = np.random.default_rng(D + 10)
    valid = np.arange(P) < P - 37
    choice = np.where(valid, rng.permutation(P) % C, -1).astype(np.int32)
    lags = np.where(valid, lags, 0)
    want = jax_solve.refine_sharded(jmesh(D), lags, valid, choice, C, iters=16)
    got = port_solve.refine_sharded(pmesh(D), lags, valid, choice, C, iters=16)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[3] == want[3]


# -- the linear duals ------------------------------------------------------------

DUALS_P2, DUALS_N, DUALS_TILE = 2048, 2000, 256


def duals_case(C, P2=DUALS_P2, n=DUALS_N, seed=None):
    lags = np.zeros(P2, np.int64)
    lags[:n] = uniform(C if seed is None else seed, n)
    valid = np.arange(P2) < n
    return lags, valid, jax_sinkhorn._scale_np(lags, valid, C)


def port_duals(D, C, lags, valid, scale, rounds=2):
    lp, vp = port_solve._place_inputs(pmesh(D), lags, valid)
    a, b, r = port_solve._linear_duals_sharded(lp, vp, scale, float(valid.sum()), C, rounds,
                                               DUALS_TILE)
    assert r == rounds
    for d in range(D):
        assert torch.equal(a[d], a[0]) and torch.equal(b[d], b[0])
    return a[0], b[0]


def jax_duals(D, C, lags, valid, scale, rounds=2):
    step = jax_solve._linear_duals_executable(jmesh(D), C, rounds, DUALS_TILE)
    A, B, r = step(*jax_solve._place_inputs(jmesh(D), lags, valid), np.float64(scale),
                   np.float32(valid.sum()))
    assert int(r) == rounds
    return np.asarray(A), np.asarray(B)


def f64_duals(C, lags, valid, scale, rounds=2):
    """The same mirror-prox loop in float64 (the plain K5 body on f64
    blocks): the exact duals both packages' f32 runs approximate."""
    S, eta = linear_ot._SUPERBLOCKS, linear_ot.MIRROR_PROX_ETA
    P2, n = lags.shape[0], int(valid.sum())
    ws, cnt = linear_ot._ws_cnt(torch.from_numpy(lags), torch.from_numpy(valid), scale)
    wb, cb = (linear_ot._to_blocks(x, P2, S, DUALS_TILE).double() for x in (ws, cnt))
    A = torch.zeros(C, dtype=torch.float64)
    B = linear_ot._noise_seed(C, "cpu").double()
    sc, prev = torch.tensor(1.0, dtype=torch.float64), torch.tensor(np.inf)
    for _ in range(rounds):
        load1 = linear_ot._ordered_sum(linear_ot._superblock_partials(wb, cb, A, B)[0])
        spread = load1.max() - load1.min()
        sc = torch.where(spread > prev, sc * 0.5, torch.clamp(sc * 1.2, max=1.0))
        half = A + (eta * sc) * (load1 - load1.mean())
        load2, col2 = (linear_ot._ordered_sum(p)
                       for p in linear_ot._superblock_partials(wb, cb, half, B))
        A = A + (eta * sc) * (load2 - load2.mean())
        B = B + torch.log(n / C / (col2 + 1e-9))
        prev = spread
    return A.numpy(), B.numpy()


@pytest.mark.parametrize("C", [ABOVE, WIDE])
def test_linear_duals_bit_identical_across_meshes(C):
    """K5's per-shard superblocks at Sb 8, 4, 2 on the card (its column
    form): every shard and every mesh size hold the same bits, 2 rounds."""
    lags, valid, scale = duals_case(C)
    a1, b1 = port_duals(1, C, lags, valid, scale)
    for D in (2, 4):
        a, b = port_duals(D, C, lags, valid, scale)
        assert torch.equal(a, a1) and torch.equal(b, b1)


def test_linear_duals_round_one_track_jax():
    """One round at P2 8,192 (6,000 rows, seed 20000), D 2: within
    ``tests/test_torch_sharded.py``'s 1e-4 max|A| / 1e-5 of JAX's duals."""
    lags, valid, scale = duals_case(WIDE, 8192, 6000, seed=20000)
    a, b = port_duals(2, WIDE, lags, valid, scale, rounds=1)
    A, B = jax_duals(2, WIDE, lags, valid, scale, rounds=1)
    np.testing.assert_allclose(a.numpy(), A, rtol=0, atol=1e-4 * np.abs(A).max())
    np.testing.assert_allclose(b.numpy(), B, rtol=0, atol=1e-5)


def test_linear_duals_as_close_to_exact_as_jax():
    """Against JAX's sharded duals at D 2.  With fewer rows than consumers
    (every P2 below C) the second round amplifies f32 rounding in both
    packages alike: here they differ by 5.2e-4 max|A| in A and 1.5e-3 in
    B, beyond ``tests/test_torch_sharded.py``'s 1e-4 max|A| / 1e-5, and
    each is about as far from the float64 loop (3.4e-4 / 3.7e-4 max|A| in
    A, 8.4e-4 / 9.2e-4 in B).  So the port is held to JAX within 1e-3
    max|A| in A and 3e-3 in B, JAX to the float64 duals within 1e-3
    max|A| and 2.5e-3, and the port's distance from the float64 duals to
    1.5x JAX's."""
    lags, valid, scale = duals_case(WIDE)
    a, b = port_duals(2, WIDE, lags, valid, scale)
    A, B = jax_duals(2, WIDE, lags, valid, scale)
    A64, B64 = f64_duals(WIDE, lags, valid, scale)
    top = np.abs(A64).max()
    np.testing.assert_allclose(a.numpy(), A, rtol=0, atol=1e-3 * top)
    np.testing.assert_allclose(b.numpy(), B, rtol=0, atol=3e-3)
    for got, want, exact, bound in ((a, A, A64, 1e-3 * top), (b, B, B64, 2.5e-3)):
        port_err = np.abs(got.numpy() - exact).max()
        jax_err = np.abs(want - exact).max()
        assert jax_err <= bound, (jax_err, bound)
        assert port_err <= 1.5 * jax_err, (port_err, jax_err)
