"""The port's sidecar at 16,385 and 20,000 members against the JAX sidecar,
on the CPU.

Kafka caps no group, and the JAX sidecar answers a group of 20,000 members;
so must the port's.  ``tests/test_torch_service.py``'s twin (the JAX
``AssignorService`` and the port's, ``device="cpu"``, one stepped clock)
gets the same request lines for one topic of 40,000 uniform lags in
[0, 10^6) (seed 18):

* ``assign`` with ``rounds`` and ``global`` at 16,385 and 20,000 members
  (K1's cluster form on the card); ``scan`` (K7's) is in
  ``tests/test_torch_wide_scan.py``;
* ``assign`` with lags near 2^40 at 16,385 members, whose member totals
  pass 2^31 (K2's int64 totals);
* a stream at 16,385 members with ``refine_iters`` 32: a cold epoch
  zlib-encoded both ways, two warm epochs with the lightest member's share
  heated, and one ``lag_delta`` epoch acked for an ``assignment_delta``
  answer.

Every reply equals the JAX reply minus ids, times and ``stats.device``,
and the two registries move the same counter series.  The request lines
are built once a test and sent to both.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kafka_lag_based_assignor_tpu_torch import service  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.lag import (  # noqa: E402
    AssignmentDeltaTracker,
    LagDeltaTracker,
)
from test_torch_service import Twin, rows  # noqa: E402
from test_torch_wide_groups import one_torch_thread  # noqa: E402

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

ABOVE, WIDE = 16_385, 20_000
P = 40_000


@pytest.fixture()
def twin():
    pair = Twin()
    try:
        yield pair
    finally:
        pair.close()


def group(C, seed=18, high=10**6, low=0):
    lags = np.random.default_rng(seed).integers(low, high, P, dtype=np.int64)
    members = [f"m{i:05d}" for i in range(C)]
    return lags, members


def assign_params(lags, members, solver):
    return {"topics": {"t0": rows(lags)}, "subscriptions": {m: ["t0"] for m in members},
            "solver": solver}


def counts_balanced(assignments, C, rows=P):
    sizes = [len(v) for v in assignments.values()] + [0] * (C - len(assignments))
    return max(sizes) - min(sizes) <= 1 and sum(sizes) == rows


@pytest.mark.parametrize("C", [ABOVE, WIDE])
@pytest.mark.parametrize("solver", ["rounds", "global"])
def test_assign_matches_jax(twin, solver, C):
    lags, members = group(C)
    reply = twin.same("assign", assign_params(lags, members, solver))
    result = reply["result"]
    assert result["stats"]["device"] == "cpu"
    assert counts_balanced(result["assignments"], C)
    series = twin.series_moved_alike()
    assert series[("klba_requests_total", (("method", "assign"),))] == 1


def test_assign_with_int64_totals_matches_jax(twin):
    """Lags in [2^40 - 2^20, 2^40): three rounds put each member's total
    near 2^41, past int32 (K2's totals on the card)."""
    lags, members = group(ABOVE, seed=19, high=1 << 40, low=(1 << 40) - (1 << 20))
    reply = twin.same("assign", assign_params(lags, members, "rounds"))
    assert counts_balanced(reply["result"]["assignments"], ABOVE)
    assert reply["result"]["stats"]["device"] == "cpu"
    twin.series_moved_alike()


def heat_lightest(lags, assignments, factor=3):
    """The lags with the lightest member's partitions multiplied, so that
    the next epoch trips the guardrail and refines."""
    totals = {m: sum(int(lags[p]) for _, p in tps) for m, tps in assignments.items()}
    light = min(sorted(totals), key=totals.get)
    hot = [p for _, p in assignments[light]]
    out = lags.copy()
    out[hot] *= factor
    return out


def test_stream_cold_warm_delta_and_zlib_match_jax(twin):
    lags, members = group(ABOVE, seed=20)
    base = {"stream_id": "wide", "topic": "t0", "members": members,
            "options": {"refine_iters": 32}}
    packed = {**base, "lags": service.encode_lags_zlib(rows(lags)), "encoding": "zlib",
              "accept_encoding": "zlib"}
    cold = twin.same("stream_assign", packed)
    assert cold["result"]["stream"]["cold_start"]
    dense = service.decode_wire_assignments(cold["result"])["assignments"]
    assert len(json.dumps(dense)) > len(cold["result"]["assignments_encoded"])
    for epoch in range(2):
        lags = heat_lightest(lags, dense)
        warm = twin.same("stream_assign", {**base, "lags": rows(lags)})
        stream = warm["result"]["stream"]
        assert not stream["cold_start"] and stream["refined"], (epoch, stream)
        dense = warm["result"]["assignments"]
        assert counts_balanced(dense, ABOVE)

    lag_tracker, acks = LagDeltaTracker(), AssignmentDeltaTracker()
    lag_tracker.params_for(rows(lags))
    lag_tracker.note_result(warm["result"])
    acks.note_result(warm["result"], members)
    lags = heat_lightest(lags, dense, 2)
    params = acks.stamp({**base, **lag_tracker.params_for(rows(lags))})
    assert "lag_delta" in params and "assign_ack" in params
    delta = twin.same("stream_assign", params)
    assert delta["result"]["stream"]["lag_epoch"] > warm["result"]["stream"]["lag_epoch"]
    assert "assignment_delta" in delta["result"]
    rebuilt = acks.note_result(delta["result"], members)
    assert counts_balanced(rebuilt, ABOVE)
    series = twin.series_moved_alike()
    assert series[("klba_assign_delta_epochs_total", (("outcome", "applied"),))] == 1
    assert series[("klba_wire_lag_bytes_total", (("encoding", "zlib"),))] > 0
