"""The port's topic-axis mesh backend against the JAX package's, on the CPU.

``sharded.topics`` (and its ``parallel.mesh`` shim) on 8 virtual CPU shards
(``sharded.mesh.set_virtual_shards(8, "cpu")``) beside the JAX package's 8
virtual CPU devices: ``assign_sharded`` over ``tests/test_parallel.py``'s
mesh shapes, with and without the per-topic refine, a ragged padded batch,
``assign_global_replicated``, the shape errors — every output bit for bit
with the JAX function's at the same mesh shape.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from kafka_lag_based_assignor_tpu.parallel import mesh as jax_parallel  # noqa: E402
from kafka_lag_based_assignor_tpu.sharded import topics as jax_topics  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops.batched import assign_batched_rounds  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.parallel import mesh as port_parallel  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.sharded import mesh as port_mesh  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.sharded import topics as port_topics  # noqa: E402

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="virtual 8-device CPU mesh unavailable")

SHAPES = [(8, 1), (4, 2), (2, 4), (1, 8), (4, 1), (2, 2)]


@pytest.fixture(scope="module", autouse=True)
def virtual_cpu_shards():
    port_mesh.set_virtual_shards(8, "cpu")
    yield
    port_mesh.set_virtual_shards(None)


def make_batch(T, P, seed=0, hi=10**9):
    rng = np.random.default_rng(seed)
    lags = rng.integers(0, hi, size=(T, P)).astype(np.int64)
    pids = np.tile(np.arange(P, dtype=np.int32), (T, 1))
    return lags, pids, np.ones((T, P), dtype=bool)


def meshes(topics_axis, members_axis):
    n = topics_axis * members_axis
    return (jax_topics.make_mesh(jax.devices()[:n], topics_axis, members_axis),
            port_topics.make_mesh(port_mesh.visible_devices()[:n], topics_axis,
                                  members_axis))


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), np.asarray(w))


@pytest.mark.parametrize("refine_iters", [0, 8])
@pytest.mark.parametrize("topics_axis,members_axis", SHAPES)
def test_assign_sharded_bit_equal_to_jax(topics_axis, members_axis, refine_iters):
    T, P, C = 16, 64, 8
    lags, pids, valid = make_batch(T, P, seed=topics_axis + members_axis)
    jm, pm = meshes(topics_axis, members_axis)
    want = jax_topics.assign_sharded(jm, *jax_topics.shard_topic_batch(jm, lags, pids, valid),
                                     num_consumers=C, refine_iters=refine_iters)
    got = port_topics.assign_sharded(pm, *port_topics.shard_topic_batch(pm, lags, pids, valid),
                                     num_consumers=C, refine_iters=refine_iters)
    assert_same(got, want)
    if not refine_iters:
        ref = assign_batched_rounds(*(torch.from_numpy(a) for a in (lags, pids, valid)),
                                    num_consumers=C)
        assert_same(got[:3], [r.numpy() for r in ref])
        np.testing.assert_array_equal(got[3].numpy(), ref[2].numpy().sum(axis=0))


def test_config3_shape_and_host_arrays():
    """Config 3's [256, 64] table with 64 consumers on (4, 2), host arrays
    passed straight in (placed by the call), through the ``parallel``
    shim."""
    lags, pids, valid = make_batch(256, 64, seed=3, hi=10**6)
    jm, pm = meshes(4, 2)
    want = jax_parallel.assign_sharded(jm, lags, pids, valid, num_consumers=64)
    got = port_parallel.assign_sharded(pm, lags, pids, valid, num_consumers=64)
    assert_same(got, want)


def test_ragged_padded_topic_axis():
    rng = np.random.default_rng(11)
    C, true_p = 8, [64, 1, 17, 40, 64, 33]
    lags = np.zeros((8, 64), np.int64)
    pids = np.tile(np.arange(64, dtype=np.int32), (8, 1))
    valid = np.zeros((8, 64), bool)
    for t, p in enumerate(true_p):
        lags[t, :p] = rng.integers(0, 10**9, size=p)
        valid[t, :p] = True
    jm, pm = meshes(8, 1)
    want = jax_topics.assign_sharded(jm, lags, pids, valid, num_consumers=C)
    got = port_topics.assign_sharded(pm, lags, pids, valid, num_consumers=C)
    assert_same(got, want)
    assert (got[0].numpy()[~valid] == -1).all()


@pytest.mark.parametrize("topics_axis,members_axis", [(4, 2), (8, 1)])
def test_global_replicated_bit_equal_to_jax(topics_axis, members_axis):
    lags, pids, valid = make_batch(12, 32, seed=5)
    jm, pm = meshes(topics_axis, members_axis)
    want = jax_topics.assign_global_replicated(jm, lags, pids, valid, num_consumers=6)
    got = port_topics.assign_global_replicated(pm, lags, pids, valid, num_consumers=6)
    assert_same(got, want)


def test_shape_errors_match_jax():
    lags, pids, valid = make_batch(8, 16)
    for mod, devs in ((jax_topics, jax.devices()), (port_topics, port_mesh.visible_devices())):
        with pytest.raises(ValueError, match="3x2"):
            mod.make_mesh(devs, topics_axis=3, members_axis=2)
        mesh = mod.make_mesh(devs, topics_axis=4, members_axis=2)
        with pytest.raises(ValueError, match="not divisible by members axis"):
            mod.assign_sharded(mesh, lags, pids, valid, num_consumers=7)
    default = port_topics.make_mesh()
    assert default.shape == {"topics": 8, "members": 1} and default.virtual
