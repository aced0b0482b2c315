"""The port's megabatch coalescer at 16,385 consumers against the JAX
coalescer, on the CPU.

``tests/test_torch_coalesce.py``'s twin at a group wider than the register
network: 4 streams of 40,000 partitions, C 16,385, ``refine_iters`` 32,
``refine_threshold`` None (every warm epoch refines), uniform lags in
[0, 10^6) from seeds 6000 + g, as phase 4m (b) of ``chip_smoke.py`` draws
them.  The JAX package's coalescer and the port's (``max_batch`` 4)
get the same waves: a re-stack wave that starts the roster's streak, a
wave that locks it, a locked dense wave and a locked delta wave.  Every
row equals the JAX row bit for bit (choice, rounds, exchanges, imbalance),
the narrowed choice keeps every consumer index (int16 while C <= 32,767),
and ``stats()`` agrees: the locked rosters and every counter's delta.

After the locked wave the roster's stacked resident state [4, B 65,536,
C 16,385] goes through the batched digest (``state_digest_rows``, K6's
batched entry on the card) and each row through the single digest, and
both equal the JAX package's ``_state_digest_xla`` and
``_row_tab_lane_xla`` of that row.

Then the same 4 wide streams on a 4-way streams mesh of virtual CPU shards
(``sharded/megabatch.place_rows``: one row a shard, a batched digest a
shard): a wave that locks and places the roster, a dense wave and a delta
wave, every row equal to the unplaced coalescer's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from kafka_lag_based_assignor_tpu.ops import coalesce as jax_coalesce  # noqa: E402
from kafka_lag_based_assignor_tpu.ops import refine as jax_refine  # noqa: E402
from kafka_lag_based_assignor_tpu.ops import streaming as jax_streaming  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops import refine  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops.coalesce import (  # noqa: E402
    MegabatchCoalescer,
    ResidentRow,
)
from kafka_lag_based_assignor_tpu_torch.ops.streaming import (  # noqa: E402
    StreamingAssignor,
    delta_k_ladder,
)
from kafka_lag_based_assignor_tpu_torch.sharded import mesh as port_mesh  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.sharded.megabatch import RowShards  # noqa: E402
from test_torch_coalesce import _submit_all as submit_all  # noqa: E402
from test_torch_wide_groups import one_torch_thread  # noqa: E402

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

G, P, C, ITERS = 4, 40_000, 16_385, 32


def stats_delta(before, after):
    return {k: after[k] - before[k] for k in after if k != "locked_rosters"}


def batch_digests_match_jax(engines):
    """The locked batch's digests: batched = single = JAX, row by row."""
    rows = [e._resident for e in engines]
    assert all(isinstance(r, ResidentRow) for r in rows)
    batch = rows[0].batch
    assert all(r.batch is batch for r in rows)
    lags, choice, counts, tab = batch.lags, batch.choice, batch.counts, batch.row_tab
    assert choice.shape[0] == G and tab.shape[1] == C
    batched = refine.state_digest_rows(lags, choice, counts, C, tab)
    assert tuple(batched.shape) == (G, 5)
    for r in (row.row for row in rows):
        single = refine.state_digest(lags[r], choice[r], counts[r], C, row_tab=tab[r])
        np.testing.assert_array_equal(batched[r].numpy(), single.numpy())
        j = [jnp.asarray(x[r].numpy()) for x in (lags, choice, tab, counts)]
        want = np.append(np.asarray(jax_refine._state_digest_xla(j[0], j[1], j[3], C)),
                         int(jax_refine._row_tab_lane_xla(*j, C)))
        np.testing.assert_array_equal(batched[r].numpy(), want)
        assert batched[r, 1] == 0 and batched[r, 3] == 0 and batched[r, 4] == 0


def test_twin_coalescers_agree_with_jax_at_16385_consumers():
    rngs = [np.random.default_rng(6000 + g) for g in range(G)]
    kw = dict(num_consumers=C, refine_iters=ITERS, refine_threshold=None)
    jax_eng = [jax_streaming.StreamingAssignor(**kw) for _ in range(G)]
    port_eng = [StreamingAssignor(device="cpu", **kw) for _ in range(G)]
    jc = jax_coalesce.MegabatchCoalescer(window_s=60.0, max_batch=G)
    pc = MegabatchCoalescer(window_s=60.0, max_batch=G, device="cpu")
    try:
        lags = [r.integers(0, 10**6, P) for r in rngs]
        for a, b, lg in zip(jax_eng, port_eng, lags):
            np.testing.assert_array_equal(np.asarray(a.rebalance(lg)), b.rebalance(lg))
        j0, p0 = jc.stats(), pc.stats()
        for wave in range(4):
            if wave == 3:  # every row a small change: a locked delta wave
                lags = [lg.copy() for lg in lags]
                for lg, r in zip(lags, rngs):
                    lg[r.choice(P, 8, replace=False)] += 10**5
            else:
                lags = [r.integers(0, 10**6, P) for r in rngs]
            want = submit_all(jax_eng, lags, jc)
            got = submit_all(port_eng, lags, pc)
            for g in range(G):
                np.testing.assert_array_equal(got[g], np.asarray(want[g]))
                assert got[g].min() >= 0 and got[g].max() == C - 1
                sa, sb = jax_eng[g].last_stats, port_eng[g].last_stats
                assert (sb.refine_rounds, sb.refine_exchanges) == (
                    sa.refine_rounds, sa.refine_exchanges)
                assert sb.max_mean_imbalance == sa.max_mean_imbalance
                assert sb.refined
            if wave == 2:
                batch_digests_match_jax(port_eng)
        j1, p1 = jc.stats(), pc.stats()
        assert p1["locked_rosters"] == j1["locked_rosters"] == 1
        assert stats_delta(p0, p1) == stats_delta(j0, j1)
        assert stats_delta(p0, p1)["roster_hits"] >= 2
    finally:
        jc.close()
        pc.close(timeout_s=60.0)


def placed_waves(mgr):
    """The 4 wide streams (lags from seeds 7000 + g) through a port
    coalescer on ``mgr`` (None: unplaced): a dense wave that locks the
    roster, a dense wave, then an 8-row delta wave."""
    rngs = [np.random.default_rng(7000 + g) for g in range(G)]
    engines = [StreamingAssignor(num_consumers=C, refine_iters=ITERS, refine_threshold=None,
                                 delta_max_fraction=1.0, delta_buckets=2, mesh_backend=mgr,
                                 device="cpu") for _ in range(G)]
    lags = [r.integers(0, 10**6, P) for r in rngs]
    for e, lg in zip(engines, lags):
        e.rebalance(lg)
    coal = MegabatchCoalescer(window_s=60.0, max_batch=G, lock_waves=1,
                              delta_k=delta_k_ladder(2)[-1], mesh_manager=mgr, device="cpu")
    outs = []
    try:
        for wave in range(3):
            if wave == 2:
                lags = [lg.copy() for lg in lags]
                for lg, r in zip(lags, rngs):
                    lg[r.choice(P, 8, replace=False)] += 10**5
            else:
                lags = [r.integers(0, 10**6, P) for r in rngs]
            outs.append([np.asarray(o) for o in submit_all(engines, lags, coal)])
        batch = engines[0]._resident.batch
    finally:
        coal.close(timeout_s=60.0)
    return outs, batch


def test_streams_mesh_placement_matches_unplaced_at_16385_consumers():
    port_mesh.set_virtual_shards(8, "cpu")
    try:
        mgr = port_mesh.MeshManager(devices=4, solve_min_rows=1 << 20).configure()
        placed, batch = placed_waves(mgr)
    finally:
        port_mesh.deactivate()
        port_mesh.set_virtual_shards(None)
    assert isinstance(batch.choice, RowShards) and len(batch.choice.parts) == G
    assert dict(batch.mesh.shape) == {"streams": 4}
    unplaced, base_batch = placed_waves(None)
    assert not isinstance(base_batch.choice, RowShards)
    for w in range(3):
        for g in range(G):
            np.testing.assert_array_equal(placed[w][g], unplaced[w][g], err_msg=f"{w}/{g}")
