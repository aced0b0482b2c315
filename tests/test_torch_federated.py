"""The port's federation wire and coordinator (``federated/``) against
the JAX package's: the cases of ``tests/test_federated.py``'s ``TestWire``
and ``TestCapacityHygiene`` run on the port, and twin checks — the same
payload encodes to the same bytes in both packages, and the federation
config keys parse alike."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kafka_lag_based_assignor_tpu.federated import wire as jax_wire  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.federated import wire  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.federated.peers import (  # noqa: E402
    FederationCoordinator,
    PeerSpec,
    parse_peer_specs,
)
from kafka_lag_based_assignor_tpu_torch.ops import fedsolve  # noqa: E402

C = 4
SHARD_P = 128
# The port's entry points default to the card; the tests run the CPU path.
DEV = "cpu"


def _shard(seed, p=SHARD_P):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1_000_000, size=p).astype(np.int64)


class TestWire:
    def test_request_roundtrip_is_whitelisted(self):
        params = wire.sync_request(
            "a", 3, 1, C, scale=10.0,
            duals_a=np.zeros(C, np.float32),
            duals_b=np.ones(C, np.float32),
            fence_token=7,
        )
        assert set(params) <= wire._REQUEST_KEYS
        assert params["duals"]["B"] == [1.0] * C

    def test_partition_axis_vector_rejected(self):
        # The shape audit: a P-length vector cannot ride under an
        # allowed key — only C-length consumer-axis aggregates may.
        with pytest.raises(wire.PayloadViolation):
            wire.sync_request(
                "a", 1, 1, C, scale=1.0,
                duals_a=np.zeros(SHARD_P), duals_b=np.zeros(SHARD_P),
            )

    def test_unknown_key_rejected(self):
        with pytest.raises(wire.PayloadViolation):
            wire._check_payload(
                {"lags": [1, 2, 3]}, wire._REQUEST_KEYS, C
            )

    def test_unknown_reject_reason(self):
        with pytest.raises(wire.PayloadViolation):
            wire.sync_reject("a", "nope", 1, C)

    def test_assert_lag_free_catches_leak(self):
        lags = _shard(1)
        leaky = json.dumps(
            {"oops": [int(v) for v in lags[:8]]}
        ).encode()
        with pytest.raises(AssertionError):
            wire.assert_lag_free(leaky, lags)

    def test_real_payloads_are_lag_free(self):
        lags = _shard(2)
        scale = max(float(lags.sum()), 1.0) / C
        w = fedsolve.shard_dedup(lags, np.ones(lags.shape[0], bool),
                                 scale)
        A, B = fedsolve.initial_duals(C, device=DEV)
        load, colsum = fedsolve.shard_marginals(*w, A, B, device=DEV)
        req = wire.sync_request(
            "a", 1, 1, C, scale=scale, duals_a=A, duals_b=B,
        )
        resp = wire.sync_response(
            "b", 1, 1, C, total_lag=int(lags.sum()),
            n_valid=lags.shape[0], load=load, colsum=colsum,
        )
        wire.assert_lag_free(wire.encode(req), lags)
        wire.assert_lag_free(wire.encode(resp), lags)

    def test_parse_peer_specs(self):
        specs = parse_peer_specs("a=h1:7531, b=h2:7532")
        assert specs == [PeerSpec("a", "h1", 7531),
                         PeerSpec("b", "h2", 7532)]
        for bad in ("a", "a=h1", "a=h1:x", "a=h1:7531,a=h2:2"):
            with pytest.raises(ValueError):
                parse_peer_specs(bad)



class TestCapacityHygiene:
    """Review fixes: a peer's NaN/negative capacity never reaches the
    summed count marginal (dropped to uniform + counted), the wire
    audit rejects it at construction, and per-shard vectors are
    normalized so the aggregation is scale-invariant."""

    def test_wire_rejects_nonfinite_and_nonpositive(self):
        for bad in ([float("nan"), 1, 1, 1], [-1.0, 1, 1, 1],
                    [0.0, 1, 1, 1]):
            with pytest.raises(
                wire.PayloadViolation, match="finite and > 0"
            ):
                wire.sync_response(
                    "a", 1, 0, C, total_lag=1, n_valid=4,
                    capacity=bad,
                )

    def test_capacity_usable(self):
        assert wire.capacity_usable([1.0, 2.0])
        assert not wire.capacity_usable([1.0, float("inf")])
        assert not wire.capacity_usable([1.0, float("nan")])
        assert not wire.capacity_usable([1.0, 0.0])
        assert not wire.capacity_usable([1.0, -2.0])

    def test_scale_invariant_aggregation(self):
        """Two initiators whose shards express the SAME capacity
        ratios in different units must produce the same cap vector:
        the per-shard normalization (each vector scaled to sum C)
        makes the hello-phase sum unit-free."""
        coord = FederationCoordinator(
            self_id="s", peers=[], capacity=[1000.0, 1000.0, 500.0,
                                             500.0], device=DEV
        )
        small = FederationCoordinator(
            self_id="s2", peers=[], capacity=[2.0, 2.0, 1.0, 1.0], device=DEV
        )
        a = np.asarray(coord._capacity_for(C), np.float64)
        b = np.asarray(small._capacity_for(C), np.float64)
        np.testing.assert_allclose(
            a * (C / a.sum()), b * (C / b.sum())
        )


# -- twins: one wire, one config --------------------------------------------


def _payloads(mod):
    """The same payloads built by one package's serializer."""
    A = np.linspace(-1.5, 2.25, C).astype(np.float32)
    B = np.array([0.1, -3.0, 7.5, 1e-7], np.float32)
    load = np.array([1.25, 0.5, 3.0, 2.0], np.float32)
    tp = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
    return [
        mod.sync_request("a", 3, 0, C, scale=12.5, phase="hello"),
        mod.sync_request("a", 4, 2, C, scale=1e9 / 3, duals_a=A, duals_b=B,
                         fence_token=9, phase="exchange", traceparent=tp),
        mod.sync_request("g", 5, 1, C, scale=2.0, duals_a=A, duals_b=B,
                         phase="gossip"),
        mod.sync_response("b", 7, 2, C, total_lag=123456789, n_valid=640,
                          load=load, colsum=load * 3, fence_token=2),
        mod.sync_response("b", 7, 0, C, total_lag=5, n_valid=4,
                          capacity=[3.0, 1.0, 1.0, 0.5]),
        mod.sync_reject("b", "stale_epoch", 2, C),
        mod.sync_reject("b", "fenced", 3, C),
    ]


def test_wire_bytes_equal_jax():
    """Every payload kind encodes to the same bytes in both packages (the
    JAX and port sidecars speak one peer wire)."""
    for got, want in zip(_payloads(wire), _payloads(jax_wire)):
        assert wire.encode(got) == jax_wire.encode(want)


@pytest.mark.parametrize("bad", [
    dict(duals_a=np.zeros(SHARD_P), duals_b=np.zeros(SHARD_P)),
    dict(phase="mutate"),
])
def test_wire_rejects_like_jax(bad):
    for mod in (wire, jax_wire):
        with pytest.raises(mod.PayloadViolation):
            mod.sync_request("a", 1, 1, C, scale=1.0, **bad)


@pytest.mark.parametrize("text", ["a=h1:7531, b=h2:7532", "x=10.0.0.1:1", "",
                                  "a", "a=h1:x", "a=h1:7531,a=h2:2", "a=h:70000"])
def test_parse_peer_specs_like_jax(text):
    from kafka_lag_based_assignor_tpu.federated.peers import (
        parse_peer_specs as jax_parse,
    )

    out = []
    for parse in (jax_parse, parse_peer_specs):
        try:
            out.append([tuple(s) for s in parse(text)])
        except ValueError as exc:
            out.append(str(exc))
    assert out[1] == out[0]


@pytest.mark.parametrize("props", [
    {},
    {"tpu.assignor.federation.self.id": "west",
     "tpu.assignor.federation.peers": "east=h:7531",
     "tpu.assignor.federation.rounds": 4,
     "tpu.assignor.federation.sync.timeout.ms": 500,
     "tpu.assignor.federation.max.staleness.ms": 60000,
     "tpu.assignor.federation.gossip.interval.ms": 250,
     "tpu.assignor.federation.capacity": "3,1,1,1"},
    {"tpu.assignor.federation.peers": "east=h:7531"},
    {"tpu.assignor.federation.self.id": "w", "tpu.assignor.federation.peers": "east"},
    {"tpu.assignor.federation.sync.timeout.ms": 0},
    {"tpu.assignor.federation.gossip.interval.ms": -1},
    {"tpu.assignor.federation.capacity": "3,zero"},
    {"tpu.assignor.federation.capacity": "3,-1"},
    {"tpu.assignor.federation.rounds": 0},
])
def test_federation_config_keys_like_jax(props):
    from kafka_lag_based_assignor_tpu.utils import config as jax_config
    from kafka_lag_based_assignor_tpu_torch.utils import config

    keys = ("federation_self_id", "federation_peers", "federation_rounds",
            "federation_sync_timeout_s", "federation_max_staleness_s",
            "federation_gossip_interval_s", "federation_capacity")
    out = []
    for parse in (jax_config.parse_config, config.parse_config):
        try:
            cfg = parse({"group.id": "g", **props})
            out.append([getattr(cfg, k) for k in keys])
        except ValueError as exc:
            out.append(str(exc))
    assert out[1] == out[0]

