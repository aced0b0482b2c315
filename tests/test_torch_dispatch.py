"""The port's rebalance path against the JAX package, on the CPU.

``assign_device`` (``native.assign_native`` for ``native``) and the
plugin's ``assign()`` of both packages solve the same BASELINE workloads
(the README example = config 1, configs 2 and 3 at full size, config 5 cut
to 5k partitions / 100 consumers) for the ``rounds``, ``global``, ``scan``
and ``native`` solvers and for ``rounds`` and ``scan`` with 16 rounds of
exchange refinement.  Results must be identical, member list order
included (both packages promise processing order), and the parity
solvers' equal to the JAX package's host oracle.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kafka_lag_based_assignor_tpu import lag as jax_lag  # noqa: E402
from kafka_lag_based_assignor_tpu import native as jax_native  # noqa: E402
from kafka_lag_based_assignor_tpu.assignor import (  # noqa: E402
    LagBasedPartitionAssignor as JaxAssignor,
)
from kafka_lag_based_assignor_tpu.models import greedy as jax_greedy  # noqa: E402
from kafka_lag_based_assignor_tpu.ops import batched as jax_batched  # noqa: E402
from kafka_lag_based_assignor_tpu.ops import dispatch as jax_dispatch  # noqa: E402
from kafka_lag_based_assignor_tpu.testing import FakeBroker as JaxBroker  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import config as jax_config  # noqa: E402
from kafka_lag_based_assignor_tpu_torch import lag, native  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.assignor import (  # noqa: E402
    LagBasedPartitionAssignor,
)
from kafka_lag_based_assignor_tpu_torch.ops.batched import (  # noqa: E402
    assign_stream_refined,
)
from kafka_lag_based_assignor_tpu_torch.ops.dispatch import (  # noqa: E402
    assign_device,
    assign_topic_device,
)
from kafka_lag_based_assignor_tpu_torch.testing import (  # noqa: E402
    baseline_workload,
    broker_for,
    lag_rows,
)
from kafka_lag_based_assignor_tpu_torch.types import (  # noqa: E402
    GroupSubscription,
    Subscription,
    TopicPartition,
)
from kafka_lag_based_assignor_tpu_torch.utils import config  # noqa: E402

# (BASELINE config, (partitions, consumers) cut or None for full size).
CASES = [(1, None), (2, None), (3, None), (5, (5000, 100))]
CASE_IDS = ["readme", "zipf_1k_16c", "vmap_256t_64p_64c", "northstar_5k_100c"]
ORACLES = {
    "rounds": jax_greedy.assign_greedy,
    "scan": jax_greedy.assign_greedy,
    "native": jax_greedy.assign_greedy,
    "global": jax_greedy.assign_greedy_global,
}
# (solver, refine rounds or None): the parity solvers, and the default
# solver's quality mode on both per-topic kernels.
SOLVERS = [("rounds", None), ("global", None), ("scan", None), ("native", None),
           ("rounds", 16), ("scan", 16)]
SOLVER_IDS = ["rounds", "global", "scan", "native", "rounds_refine16", "scan_refine16"]
REFINE_ITERS = 16


def workload(case):
    cfg, cut = case
    lags, members = baseline_workload(cfg, *(cut or ()))
    return lags, {m: sorted(lags) for m in members}


def pairs(assignment):
    """member -> [(topic, partition), ...] in list order, either package."""
    return {
        m: [(tp.topic, tp.partition) for tp in tps]
        for m, tps in assignment.items()
    }


@pytest.mark.parametrize("solver,refine", SOLVERS, ids=SOLVER_IDS)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_assign_device_matches_jax(case, solver, refine):
    lags, subs = workload(case)
    rows = lag_rows(lags)
    if solver == "native":
        got = pairs(native.assign_native(rows, subs))
        want = pairs(jax_native.assign_native(rows, subs))
    else:
        got = pairs(assign_device(rows, subs, kernel=solver, device="cpu",
                                  refine_iters=refine))
        want = pairs(jax_dispatch.assign_device(rows, subs, kernel=solver,
                                                refine_iters=refine))
    assert got == want
    if refine is None:
        assert got == pairs(ORACLES[solver](rows, subs))
    for topic in lags:  # per-topic count spread <= 1
        counts = [sum(t == topic for t, _ in tps) for tps in got.values()]
        assert max(counts) - min(counts) <= 1


def test_global_refine_is_rejected_like_jax():
    lags, subs = workload(CASES[1])
    rows = lag_rows(lags)
    with pytest.raises(ValueError, match="global"):
        assign_device(rows, subs, kernel="global", device="cpu", refine_iters=8)
    with pytest.raises(ValueError, match="global"):
        jax_dispatch.assign_device(rows, subs, kernel="global", refine_iters=8)


@pytest.mark.parametrize("P,C,iters", [(3000, 40, 32), (5000, 100, 16), (777, 1, 8)])
def test_assign_stream_refined_matches_jax(P, C, iters):
    lags, _ = baseline_workload(5, P, C)
    arr = lags["t0"]
    got = assign_stream_refined(torch.from_numpy(arr), C, refine_iters=iters)
    want = np.asarray(jax_batched.assign_stream_refined(arr, C, refine_iters=iters))
    assert got.dtype == torch.int16 and want.dtype == np.int16
    np.testing.assert_array_equal(got.numpy(), want)


def test_readme_worked_example():
    rows = lag_rows(baseline_workload(1)[0])
    got = assign_device(rows, {"C0": ["t0"], "C1": ["t0"]}, device="cpu")
    assert got == assign_topic_device("t0", ["C1", "C0"], rows["t0"], device="cpu")
    assert got == {
        "C0": [TopicPartition("t0", 0)],
        "C1": [TopicPartition("t0", 2), TopicPartition("t0", 1)],
    }


def jax_broker_for(lags):
    broker = JaxBroker()
    for topic, arr in lags.items():
        for p, value in enumerate(arr.tolist()):
            broker.with_partition(topic, p, end=value, committed=0)
    return broker


@pytest.mark.parametrize("solver,refine", SOLVERS, ids=SOLVER_IDS)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_plugin_matches_jax_plugin(case, solver, refine):
    lags, subs = workload(case)
    group = GroupSubscription({m: Subscription(t) for m, t in subs.items()})
    configs = {"group.id": "g", "tpu.assignor.solver": solver}
    if refine is not None:
        configs["tpu.assignor.refine.iters"] = str(refine)

    port = LagBasedPartitionAssignor(lambda props: broker_for(lags), device="cpu")
    port.configure(configs)
    broker = broker_for(lags)
    got = port.assign(broker.cluster(), group)

    ref = JaxAssignor(lambda props: jax_broker_for(lags))
    ref.configure(configs)
    want = ref.assign(broker.cluster(), group)

    def by_member(ga):
        return pairs({m: a.partitions for m, a in ga.group_assignment.items()})

    assert by_member(got) == by_member(want)
    assert not ref.last_stats.fallback_used
    assert port.last_stats.device == (None if solver == "native" else "cpu")
    assert port.last_stats.refine_iters == ref.last_stats.refine_iters
    assert port.last_stats.num_partitions == ref.last_stats.num_partitions
    assert port.last_stats.quality_ratio == ref.last_stats.quality_ratio


def test_host_solver_is_the_oracle():
    lags, subs = workload(CASES[1])
    group = GroupSubscription({m: Subscription(t) for m, t in subs.items()})
    port = LagBasedPartitionAssignor(lambda props: broker_for(lags), device="cpu")
    port.configure({"group.id": "g", "tpu.assignor.solver": "host"})
    got = port.assign(broker_for(lags).cluster(), group)
    want = jax_greedy.assign_greedy(lag_rows(lags), subs)
    assert pairs({m: a.partitions for m, a in got.group_assignment.items()}) == (
        pairs(want)
    )
    assert port.last_stats.device is None


def test_sinkhorn_solver_runs():
    lags, subs = workload(CASES[1])
    group = GroupSubscription({m: Subscription(t) for m, t in subs.items()})
    port = LagBasedPartitionAssignor(lambda props: broker_for(lags), device="cpu")
    port.configure({"group.id": "g", "tpu.assignor.solver": "sinkhorn"})
    got = port.assign(broker_for(lags).cluster(), group)
    held = sorted(tp.partition for a in got.group_assignment.values()
                  for tp in a.partitions)
    assert held == list(range(len(lags["t0"])))
    assert port.last_stats.count_spread <= 1
    assert port.last_stats.solver == "sinkhorn" and port.last_stats.device == "cpu"


@pytest.mark.parametrize(
    "raw",
    [
        {"group.id": "g", "tpu.assignor.solver": "sinkhorn",
         "tpu.assignor.sinkhorn.iters": "12", "tpu.assignor.quality.mode": "linear",
         "tpu.assignor.quality.tile": "256", "tpu.assignor.refine.iters": "4"},
        {"group.id": "orders", "auto.offset.reset": "earliest"},
        {"group.id": "g", "tpu.assignor.solver": "global",
         "tpu.assignor.lag.retries": "2"},
        {"group.id": "g", "tpu.assignor.refine.iters": "auto"},
    ],
)
def test_config_matches_jax(raw):
    got, want = config.parse_config(raw), jax_config.parse_config(raw)
    for key in ("group_id", "auto_offset_reset", "solver", "lag_retries",
                "lag_retry_backoff_s", "refine_iters", "client_id",
                "metadata_consumer_props", "sinkhorn_iters"):
        assert getattr(got, key) == getattr(want, key), key
    # quality.mode / .tile are validated but not kept: nothing in the
    # plugin installs them (the router reads ops.dispatch's knobs).
    assert not hasattr(got, "quality_mode") and not hasattr(got, "quality_tile")


@pytest.mark.parametrize(
    "bad",
    [
        {},
        {"group.id": "g", "tpu.assignor.solver": "x"},
        {"group.id": "g", "tpu.assignor.quality.mode": "dense"},
        {"group.id": "g", "tpu.assignor.quality.tile": "100"},
        {"group.id": "g", "tpu.assignor.sinkhorn.iters": "0"},
        {"group.id": "g", "tpu.assignor.solver": "global",
         "tpu.assignor.refine.iters": "8"},
    ],
)
def test_config_rejects_like_jax(bad):
    with pytest.raises(ValueError):
        config.parse_config(bad)
    with pytest.raises(ValueError):
        jax_config.parse_config(bad)


def test_lag_formula_matches_jax():
    rng = np.random.default_rng(11)
    for _ in range(200):
        begin, end = sorted(int(v) for v in rng.integers(0, 1000, size=2))
        committed = None if rng.random() < 0.4 else int(rng.integers(0, 1200))
        mode = str(rng.choice(["latest", "LATEST", "earliest", "none"]))
        meta = None if committed is None else jax_lag.OffsetAndMetadata(committed)
        assert lag.compute_partition_lag(meta, begin, end, mode) == (
            jax_lag.compute_partition_lag(meta, begin, end, mode)
        )
