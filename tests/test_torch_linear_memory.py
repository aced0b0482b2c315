"""The linear solve's geometry and working set against the JAX package's, on
the CPU (bench.py's ``linear_ot_scale``, config 14):

* ``last_solve_info()``'s tile, tile count and ``peak_bytes_estimate``
  equal JAX's at the parity shape (4,096 x 64) and the scale shapes
  (16,384 and 65,536 x 128, Zipf from ``default_rng(0x11EA)``);
* ``autotune_quality_tile`` picks JAX's tile from the same memory
  statistics (16 GB and 80 GB free, and none);
* at the parity shape the linear mode's quality ratio is within 1.05x the
  dense ``sinkhorn`` one's in both packages;
* the plan argmax of the rounding streams blocks whose size changes no
  bit (against one block of every row, and against JAX's);
* the rounding tail (``finish_from_duals``: the parallel rounding, the
  greedy, the tables and the refine, the same torch code the card runs)
  stays under 1/8 of the [P_pad, C] f32 plan at 65,536 x 128, counted op
  by op with the solve's inputs, the CUDA radix sort's own buffers and
  the widened int32 indices (the count the card's allocator gives);
* its chunked sorts (``sortops.stable_argsort``) give the permutation of
  one stable sort, and the chunked tail the bits of the unchunked one.

No memory fraction of the whole solve is gated here: on the CPU the plain
K5 body materializes one superblock's plan, [tiles a block, tile, C], by
design; ``chip_smoke.py --probes`` gates the card's peak.
"""

import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_flatten  # noqa: E402

from kafka_lag_based_assignor_tpu.models import sinkhorn as jax_sinkhorn  # noqa: E402
from kafka_lag_based_assignor_tpu.ops import dispatch as jax_dispatch  # noqa: E402
from kafka_lag_based_assignor_tpu.ops import linear_ot as jax_linear_ot  # noqa: E402
from kafka_lag_based_assignor_tpu.ops import plan_stats as jax_plan_stats  # noqa: E402
from kafka_lag_based_assignor_tpu.ops.packing import pad_topic_rows  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.models import sinkhorn  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops import (  # noqa: E402
    dispatch,
    linear_ot,
    plan_stats,
    refine,
    rounds_kernel,
    sortops,
)
from kafka_lag_based_assignor_tpu_torch.testing import zipf_lags  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.utils.observability import (  # noqa: E402
    count_constrained_bound,
)


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def shapes():
    """bench.py's draws in its order: the parity shape, then the two scale
    shapes, from one generator."""
    rng = np.random.default_rng(0x11EA)
    return {"parity": (zipf_lags(rng, 4096), 64), "scale16384": (zipf_lags(rng, 16384), 128),
            "scale65536": (zipf_lags(rng, 65536), 128)}


def quality(lags, totals, C):
    t = np.asarray(totals, dtype=np.float64)
    imbalance = float(t.max() / t.mean()) if t.mean() > 0 else 1.0
    return imbalance / max(count_constrained_bound(lags, C), 1.0)


GEOMETRY = ("tile", "tiles", "peak_bytes_estimate")


@pytest.mark.parametrize("name", ["parity", "scale16384", "scale65536"])
def test_solve_geometry_matches_jax(name):
    lags, C = shapes()[name]
    lp, pp, vp = pad_topic_rows(lags)
    linear_ot.assign_topic_linear(lp, pp, vp, num_consumers=C, device="cpu")
    port = {k: linear_ot.last_solve_info()[k] for k in GEOMETRY}
    jax_linear_ot.assign_topic_linear(lp, pp, vp, num_consumers=C)
    assert port == {k: jax_linear_ot.last_solve_info()[k] for k in GEOMETRY}


@pytest.mark.parametrize("free_gb", [16, 80, None])
def test_autotuned_tile_matches_jax(free_gb):
    stats = (None if free_gb is None
             else {"bytes_limit": 81 * 2**30, "bytes_in_use": (81 - free_gb) * 2**30})
    before = dispatch.quality_tile(), jax_dispatch.quality_tile()
    try:
        got = dispatch.autotune_quality_tile(stats, device="cpu")
        want = jax_dispatch.autotune_quality_tile(stats)
    finally:
        dispatch.set_quality_tile(before[0])
        jax_dispatch.set_quality_tile(before[1])
    assert got == want
    if free_gb:
        assert got == 65536  # the 1,024-lane rule caps it at any realistic card


def test_parity_shape_linear_within_5_percent_of_dense():
    lags, C = shapes()["parity"]
    lp, pp, vp = pad_topic_rows(lags)
    ratios = {}
    for name, sink, lin, dsp, on in (
            ("jax", jax_sinkhorn.assign_topic_sinkhorn, jax_linear_ot.assign_topic_linear,
             jax_dispatch, {}),
            ("port", sinkhorn.assign_topic_sinkhorn, linear_ot.assign_topic_linear, dispatch,
             {"device": "cpu"})):
        with dsp.quality_scope("sinkhorn"):
            s_tot = np.asarray(sink(lp, pp, vp, num_consumers=C, **on)[2])
        with dsp.quality_scope("linear"):
            l_tot = np.asarray(lin(lp, pp, vp, num_consumers=C, **on)[2])
        ratios[name] = quality(lags, l_tot, C) / quality(lags, s_tot, C)
    assert ratios["port"] <= 1.05 and ratios["jax"] <= 1.05, ratios


def test_argmax_blocks_change_no_bit(monkeypatch):
    g = torch.Generator().manual_seed(5)
    P, C = 3000, 700
    ws = torch.rand(P, generator=g) * 4.0
    valid = torch.rand(P, generator=g) < 0.9
    A, B = torch.rand(C, generator=g), torch.rand(C, generator=g)
    blocked = [plan_stats.implicit_plan_argmax(ws, valid, A, B, tie_noise=t) for t in (0, 1)]
    monkeypatch.setattr(plan_stats, "_TILE_P", 1 << 20)  # one block of every row
    whole = [plan_stats.implicit_plan_argmax(ws, valid, A, B, tie_noise=t) for t in (0, 1)]
    jax_args = [jnp.asarray(x.numpy()) for x in (ws, valid, A, B)]
    for t in (0, 1):
        assert torch.equal(blocked[t], whole[t])
        want = np.asarray(jax_plan_stats.implicit_plan_argmax(*jax_args, tie_noise=bool(t)))
        np.testing.assert_array_equal(blocked[t].numpy(), want)


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages the ops in its scope allocated and that are
    still alive, and their peak, as the card's allocator would count them
    (before its 512-byte rounding): a stable sort of more than 4,096 rows
    also holds the CUDA radix sort's own buffers (an int64 iota and the
    double buffers of its keys and int64 values), and an int32 index is
    widened to int64 for the indexing op.  ``base`` counts the buffers
    already live (the solve's inputs)."""

    def __init__(self, base=0):
        super().__init__()
        self.live, self.now, self.peak = set(), base, base

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        extra = 0
        if name.startswith("aten.sort") and args[0].numel() > 4096:
            extra = args[0].numel() * (16 + args[0].element_size())
        if name.startswith(("aten.index.", "aten.index_put")):
            extra += sum(8 * t.numel() for t in tree_flatten(args[1])[0]
                         if isinstance(t, torch.Tensor) and t.dtype == torch.int32)
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            storage = t.untyped_storage()
            key, n = storage.data_ptr(), storage.nbytes()
            if n == 0 or key in self.live:
                continue
            self.live.add(key)
            self.now += n
            weakref.finalize(storage, self._free, key, n)
        self.peak = max(self.peak, self.now + extra)
        return out

    def _free(self, key, n):
        if key in self.live:
            self.live.discard(key)
            self.now -= n


def test_rounding_tail_stays_within_an_eighth_of_the_plan():
    lags, C = shapes()["scale65536"]
    lp, pp, vp = pad_topic_rows(lags)
    lags_t, pids_t, valid_t = (torch.from_numpy(np.asarray(a)) for a in (lp, pp, vp))
    n_valid = int(np.asarray(vp).sum())
    scale = sinkhorn._scale_np(np.asarray(lp), np.asarray(vp), C)
    A, B, rounds = linear_ot._linear_duals(lags_t, valid_t, scale, n_valid, num_consumers=C,
                                           iters=24, tile=linear_ot.DEFAULT_TILE)
    counter = LiveBytes(base=sum(t.nbytes for t in (lags_t, pids_t, valid_t)))
    with counter:
        choice, _, _ = linear_ot.finish_from_duals(lags_t, pids_t, valid_t, A, B, C, 96,
                                                   tiles=64, tile=1024, rounds=rounds,
                                                   backend="cpu")
    plan = lp.shape[0] * C * 4
    # Every sort of P rows at once (the tail before it sorted in chunks)
    # counted 82.0 B a row, 0.16 of the plan, as the card read 0.161.
    assert counter.peak < plan / 8, (counter.peak, plan)
    counts = np.bincount(choice[:lags.size], minlength=C)
    assert counts.max() - counts.min() <= 1


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("chunk", [1 << 20, 6000, 4096, 777])
def test_stable_argsort_is_the_stable_sort(dtype, chunk):
    rng = np.random.default_rng(11)
    key = torch.from_numpy(rng.integers(-50, 50, 20000)).to(dtype)
    key[::7] = torch.iinfo(dtype).max
    got = sortops.stable_argsort(key, chunk)
    assert got.dtype == torch.int32
    assert torch.equal(got.to(torch.int64), torch.sort(key, stable=True).indices)


def test_chunked_tail_sorts_change_no_bit():
    lags, C = shapes()["scale16384"]
    lp, pp, vp = pad_topic_rows(lags)
    lags_t, pids_t, valid_t = (torch.from_numpy(np.asarray(a)) for a in (lp, pp, vp))
    n_valid = int(np.asarray(vp).sum())
    scale = sinkhorn._scale_np(np.asarray(lp), np.asarray(vp), C)
    A, B, _ = linear_ot._linear_duals(lags_t, valid_t, scale, n_valid, num_consumers=C,
                                      iters=24, tile=linear_ot.DEFAULT_TILE)
    floor_cap = n_valid // C
    got = {}
    for rows in (None, 5000):
        choice = sinkhorn._round_parallel(lags_t, None, valid_t, A, B, C, floor_cap,
                                          n_valid - floor_cap * C, sort_rows=rows)
        greedy = rounds_kernel.assign_topic_rounds(lags_t, pids_t, valid_t, C, sort_rows=rows)
        tables = refine.build_choice_tables(lags_t, valid_t, choice, C, 200, sort_rows=rows)
        got[rows] = (choice, *greedy, *tables)
    for a, b in zip(got[None], got[5000]):
        assert torch.equal(a, b)
    # Lags past 2^31 with Zipf's ties: the overflow's int32 lag ranks
    # order them as JAX's int64 keys do.
    big = lags_t * (1 << 33)
    ws = sinkhorn._scaled_ws(big, valid_t, C)
    want = jax_sinkhorn._round_parallel(
        *(jnp.asarray(x.numpy()) for x in (big, ws, valid_t, A, B)), C, floor_cap,
        n_valid - floor_cap * C)
    got = sinkhorn._round_parallel(big, None, valid_t, A, B, C, floor_cap,
                                   n_valid - floor_cap * C, sort_rows=5000)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert sinkhorn._tail_sort_rows(65536, 128) == 16384
    assert sinkhorn._tail_sort_rows(131072, 1000) == 131072
