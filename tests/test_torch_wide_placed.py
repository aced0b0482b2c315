"""The port's sharded engine, topic axis and placement at 16,385 and 20,000
consumers against the JAX package, on the CPU.

The port's mesh is one process over 8 virtual CPU shards
(``sharded.mesh.set_virtual_shards(8, "cpu")``), beside the JAX package's 8
virtual CPU devices (``tests/conftest.py``).  At groups wider than the
register network:

* the engine's exchange cold epoch and a warm epoch at D 4 (quality mode
  ``sinkhorn``), equal to the JAX engine's, stats included;
* the topic axis: ``assign_sharded`` on 8 topics x 5,000 partitions, C
  20,000, on (4, 1) and (2, 2) with refine 0 and 16, equal to JAX (and
  without refine to the unsharded batched solve); C 20,001 on (2, 2)
  raises JAX's ``ValueError``;
* placement: placed warm and delta epochs at D 2 and 4, C 16,385, equal to
  the unplaced engine and to the JAX engine with its resident state
  sharded;
* the shard digest (K6's shard entry on the card) at C 20,000, equal to the
  gathered digest, clean and for each corruption class.

The P-axis programs at these widths are in
``tests/test_torch_wide_sharded.py``.  Integer paths: exact.  Inputs are
made with numpy from a seed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from kafka_lag_based_assignor_tpu.ops import dispatch as jax_dispatch  # noqa: E402
from kafka_lag_based_assignor_tpu.ops.streaming import (  # noqa: E402
    StreamingAssignor as JaxEngine,
)
from kafka_lag_based_assignor_tpu.sharded import mesh as jax_mesh  # noqa: E402
from kafka_lag_based_assignor_tpu.sharded import topics as jax_topics  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops import dispatch, refine  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops.batched import assign_batched_rounds  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops.streaming import StreamingAssignor  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.sharded import mesh as port_mesh  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.sharded import topics as port_topics  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.sharded.resident import PlacedResident  # noqa: E402
from test_torch_placement import CORRUPTIONS, _corrupt, _state  # noqa: E402
from test_torch_sharded import no_global_manager, virtual_cpu_shards  # noqa: E402
from test_torch_wide_groups import one_torch_thread  # noqa: E402
from test_torch_wide_sharded import ABOVE, WIDE, balanced, uniform  # noqa: E402

pytestmark = [pytest.mark.skipif(len(jax.devices()) < 8,
                                 reason="virtual 8-device CPU mesh unavailable"),
              pytest.mark.usefixtures(virtual_cpu_shards.__name__, no_global_manager.__name__,
                                      one_torch_thread.__name__)]


# -- the engine ------------------------------------------------------------------


def test_engine_exchange_cold_epoch_and_warm_epoch_match_jax():
    P, C = 40_000, ABOVE
    mgrs = [mod.MeshManager(devices=4, solve_min_rows=2048).configure()
            for mod in (jax_mesh, port_mesh)]
    kw = dict(num_consumers=C, refine_iters=32)
    lags = uniform(5, P)
    rng = np.random.default_rng(5)
    with jax_dispatch.quality_scope("sinkhorn"), dispatch.quality_scope("sinkhorn"):
        pair = (JaxEngine(mesh_backend=mgrs[0], **kw),
                StreamingAssignor(mesh_backend=mgrs[1], device="cpu", **kw))
        for epoch in range(2):
            out = [np.asarray(e.rebalance(lags)) for e in pair]
            np.testing.assert_array_equal(out[1], out[0])
            assert vars(pair[1].last_stats) == vars(pair[0].last_stats)
            assert pair[1].last_stats.sharded_solve == (epoch == 0)
            balanced(out[1], P, C)
            lags = lags.copy()
            lags[rng.integers(0, P, 4000)] *= 3


# -- the topic axis ----------------------------------------------------------------


def topic_batch(T, P, seed):
    lags = np.random.default_rng(seed).integers(0, 10**6, (T, P)).astype(np.int64)
    return lags, np.tile(np.arange(P, dtype=np.int32), (T, 1)), np.ones((T, P), bool)


def topic_meshes(topics_axis, members_axis):
    n = topics_axis * members_axis
    return (jax_topics.make_mesh(jax.devices()[:n], topics_axis, members_axis),
            port_topics.make_mesh(port_mesh.visible_devices()[:n], topics_axis,
                                  members_axis))


@pytest.mark.parametrize("refine_iters", [0, 16])
@pytest.mark.parametrize("topics_axis,members_axis", [(4, 1), (2, 2)])
def test_assign_sharded_topic_axis_matches_jax(topics_axis, members_axis, refine_iters):
    lags, pids, valid = topic_batch(8, 5_000, seed=topics_axis * 10 + refine_iters)
    jm, pm = topic_meshes(topics_axis, members_axis)
    want = jax_topics.assign_sharded(jm, lags, pids, valid, num_consumers=WIDE,
                                     refine_iters=refine_iters)
    got = port_topics.assign_sharded(pm, lags, pids, valid, num_consumers=WIDE,
                                     refine_iters=refine_iters)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if not refine_iters:
        ref = assign_batched_rounds(*(torch.from_numpy(a) for a in (lags, pids, valid)),
                                    num_consumers=WIDE)
        for g, r in zip(got[:3], ref):
            np.testing.assert_array_equal(g.numpy(), r.numpy())


def test_assign_sharded_members_axis_must_divide_the_group():
    lags, pids, valid = topic_batch(8, 64, seed=7)
    jm, pm = topic_meshes(2, 2)
    errors = []
    for fn, mesh in ((jax_topics.assign_sharded, jm), (port_topics.assign_sharded, pm)):
        with pytest.raises(ValueError) as err:
            fn(mesh, lags, pids, valid, num_consumers=WIDE + 1)
        errors.append(str(err.value))
    assert errors[1] == errors[0]
    assert "not divisible by members axis 2" in errors[1]


# -- placement -----------------------------------------------------------------------


PLACED_C, PLACED_P = ABOVE, 40_000
PLACED_KW = dict(num_consumers=PLACED_C, refine_iters=32, refine_threshold=None,
                 cold_refine_iters=32, delta_max_fraction=1.0, delta_buckets=2)


def placed_script(seed):
    """A seed choice and 4 epochs: dense drift, 8-row delta, drift, delta."""
    rng = np.random.default_rng(seed)
    cur = rng.integers(0, 10**6, PLACED_P).astype(np.int64)
    seed_choice = (np.argsort(np.argsort(-cur, kind="stable")) % PLACED_C).astype(np.int32)
    epochs = []
    for k in range(4):
        if k % 2 == 0:
            cur = (cur * rng.lognormal(0, 0.2, PLACED_P)).astype(np.int64)
        else:
            cur = cur.copy()
            cur[rng.choice(PLACED_P, 8, replace=False)] += rng.integers(1, 10**6, 8)
        epochs.append(cur)
    return seed_choice, epochs


def drive(engine, seed_choice, epochs):
    engine.seed_choice(seed_choice)
    return [np.asarray(engine.rebalance(e.copy())) for e in epochs]


@pytest.mark.parametrize("D", [2, 4])
def test_placed_warm_and_delta_epochs_match_unplaced_and_jax(D):
    seed_choice, epochs = placed_script(0x4D00 + D)
    unplaced = drive(StreamingAssignor(**PLACED_KW, mesh_backend=None, device="cpu"),
                     seed_choice, epochs)
    mgr = port_mesh.MeshManager(devices=D, solve_min_rows=256).configure()
    eng = StreamingAssignor(**PLACED_KW, mesh_backend=mgr, device="cpu")
    placed = drive(eng, seed_choice, epochs)
    assert isinstance(eng._resident, PlacedResident)
    assert len(eng._resident.shards) == D
    assert eng.delta_epochs["applied"] == 2
    jmgr = jax_mesh.MeshManager(devices=D, solve_min_rows=256).configure()
    jeng = JaxEngine(**PLACED_KW, mesh_backend=jmgr)
    jax_out = drive(jeng, seed_choice, epochs)
    assert jeng._resident_sharded
    for k, (a, b, j) in enumerate(zip(unplaced, placed, jax_out)):
        np.testing.assert_array_equal(b, a, err_msg=f"epoch {k}")
        np.testing.assert_array_equal(b, j, err_msg=f"epoch {k}")
        balanced(b, PLACED_P, PLACED_C)


@pytest.mark.parametrize("kind", CORRUPTIONS, ids=lambda k: k or "clean")
def test_shard_digest_equals_gathered_digest_at_20000_consumers(kind):
    lags, choice, tab, counts = _corrupt(_state(20, 65_536, WIDE, 60_000), kind)
    want = refine.state_digest(lags, choice, counts, WIDE, row_tab=tab)
    for D in (2, 4):
        lag_s, ch_s = list(torch.tensor_split(lags, D)), list(torch.tensor_split(choice, D))
        offsets = np.cumsum([0] + [t.shape[0] for t in lag_s[:-1]]).tolist()
        got = refine.state_digest_sharded(lag_s, ch_s, counts, WIDE, tab, offsets)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert (int(want[1]) == 0 and int(want[3]) == 0 and int(want[4]) == 0) == (
        kind in (None, "lags"))
