"""The port's federated sidecar methods (``peer_sync``, ``federation``,
``federated_assign``) against ``tests/test_federated.py``'s
``TestFederatedService``, ``TestGossipDuals`` and partition-heal soak, run on
two port sidecars over loopback TCP (``device="cpu"``); then a mixed pair —
one JAX sidecar and one port sidecar — converges on one wire, and the
snapshot's ``federation`` section keeps the JAX document format."""

import json
import socket
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kafka_lag_based_assignor_tpu_torch.federated import wire  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.federated.peers import (  # noqa: E402
    FederationCoordinator,
    PeerSpec,
)
from kafka_lag_based_assignor_tpu_torch.ops import fedsolve  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.service import (  # noqa: E402
    AssignorService,
    AssignorServiceClient,
)
from kafka_lag_based_assignor_tpu_torch.utils import faults, metrics  # noqa: E402

C = 4
SHARD_P = 128
MEMBERS = [f"m{i}" for i in range(C)]
# The port's entry points default to the card; the tests run the CPU path.
DEV = "cpu"


def _counter(name, labels=None):
    return metrics.REGISTRY.counter(name, labels or {}).value


def _shard(seed, p=SHARD_P):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1_000_000, size=p).astype(np.int64)


def _rows(lags):
    return [[int(i), int(v)] for i, v in enumerate(lags)]


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _assert_balanced(result, members=None):
    members = members or MEMBERS
    sizes = [len(result["assignments"][m]) for m in members]
    assert max(sizes) - min(sizes) <= 1, sizes
    return sizes


@pytest.fixture(scope="module")
def duo():
    """Two federated sidecars in one process (a <-> b), generous sync
    timeouts (first exchanges compile), tight breaker policy so trip
    tests are cheap."""
    ports = _free_ports(2)
    ids = ("a", "b")
    svcs = []
    for i in range(2):
        j = 1 - i
        svc = AssignorService(
            port=ports[i],
            coalesce_max_batch=1,
            scrub_interval_ms=0,
            breaker_failures=2,
            breaker_cooldown_s=0.2,
            slo_deadline_s={"best_effort": 2.0},
            federation_self_id=ids[i],
            federation_peers=f"{ids[j]}=127.0.0.1:{ports[j]}",
            federation_rounds=8,
            federation_sync_timeout_s=60.0, device=DEV
        )
        svc.start()
        svcs.append(svc)
    clients = [
        AssignorServiceClient("127.0.0.1", p, timeout_s=180.0)
        for p in ports
    ]
    shards = {"a": _shard(41), "b": _shard(42)}
    yield {
        "svcs": dict(zip(ids, svcs)),
        "clients": dict(zip(ids, clients)),
        "shards": shards,
    }
    for c in clients:
        c.close()
    for s in svcs:
        s.stop()


@pytest.fixture(autouse=True)
def _clean_slate(request):
    """Faults off and breakers closed around every test in this
    module (the injector and the watchdog are process-global)."""
    faults.deactivate()
    yield
    faults.deactivate()
    if "duo" in request.fixturenames:
        duo = request.getfixturevalue("duo")
        for svc in duo["svcs"].values():
            svc._watchdog.reset()


def _fed_assign(duo, sid, **kw):
    return duo["clients"][sid].federated_assign(
        "t0", _rows(duo["shards"][sid]), MEMBERS, **kw
    )


def _warm_federation(duo):
    """Both sidecars registered + one converged pass each."""
    _fed_assign(duo, "a")
    _fed_assign(duo, "b")
    return _fed_assign(duo, "a")


class TestFederatedService:
    def test_converges_global(self, duo):
        r = _warm_federation(duo)
        assert r["federation"]["rung"] == "global"
        assert 1 <= r["federation"]["rounds"] <= 8
        _assert_balanced(r)

    def test_status_surfaces(self, duo):
        _warm_federation(duo)
        status = duo["clients"]["a"].federation()
        assert status["enabled"] is True
        assert status["rung"] == "global"
        assert "b" in status["peers"]
        assert status["peers"]["b"]["epoch_seen"] >= 1
        stats = duo["clients"]["a"].request("stats")
        assert stats["federation"]["self_id"] == "a"
        assert "peer:b" in stats["breakers"]

    def test_partition_serves_local_only_no_errors(self, duo):
        """Chaos: peer.partition — every peer RPC fails, yet the
        sidecar keeps serving VALID count-balanced local assignments
        with zero request errors (fail-open to single-cluster
        behavior; cache intentionally bypassed by expiring it)."""
        svc = duo["svcs"]["a"]
        svc._federation._last_good = None  # force past rung 2
        errors_before = svc.errors
        with faults.injected(
            faults.FaultInjector(7).plan("peer.partition", times=0)
        ):
            r = _fed_assign(duo, "a")
        assert r["federation"]["rung"] == "local_only"
        _assert_balanced(r)
        assert svc.errors == errors_before

    def test_partition_with_fresh_cache_serves_last_good(self, duo):
        _warm_federation(duo)
        with faults.injected(
            faults.FaultInjector(7).plan("peer.partition", times=0)
        ):
            r = _fed_assign(duo, "a")
        assert r["federation"]["rung"] == "last_good_global"
        assert r["federation"]["staleness_s"] is not None
        _assert_balanced(r)

    def test_stale_cache_falls_to_local_only(self, duo):
        _warm_federation(duo)
        fed = duo["svcs"]["a"]._federation
        with fed._cache_lock:
            fed._last_good["at"] -= fed.max_staleness_s + 1.0
        with faults.injected(
            faults.FaultInjector(7).plan("peer.partition", times=0)
        ):
            r = _fed_assign(duo, "a")
        assert r["federation"]["rung"] == "local_only"
        _assert_balanced(r)

    def test_heal_reconverges_within_bounded_rounds(self, duo):
        with faults.injected(
            faults.FaultInjector(7).plan("peer.partition", times=0)
        ):
            _fed_assign(duo, "a")
        duo["svcs"]["a"]._watchdog.reset()  # close the peer breaker
        r = _fed_assign(duo, "a")
        assert r["federation"]["rung"] == "global"
        assert r["federation"]["rounds"] <= 8

    def test_stale_duals_dropped_and_counted(self, duo):
        """Chaos: peer.stale_duals — the peer's answer is treated as
        stale state: counted, dropped, never averaged in (the round
        aborts to the ladder instead of blending)."""
        _warm_federation(duo)
        before = _counter(
            "klba_peer_stale_duals_total", {"reason": "injected"}
        )
        with faults.injected(
            faults.FaultInjector(7).plan("peer.stale_duals", times=0)
        ):
            r = _fed_assign(duo, "a")
        assert r["federation"]["rung"] != "global"
        _assert_balanced(r)
        assert _counter(
            "klba_peer_stale_duals_total", {"reason": "injected"}
        ) > before

    def test_slow_link_round_is_deadline_bounded(self, duo):
        """Chaos: peer.slow_link — a slow inter-cluster link cannot
        hold the request past its class budget: the exchange degrades
        inside the deadline and the answer still serves."""
        _warm_federation(duo)
        started = time.monotonic()
        with faults.injected(
            faults.FaultInjector(7).plan(
                "peer.slow_link", mode="latency", times=0,
                delay_s=0.45,
            )
        ):
            r = _fed_assign(duo, "a", slo_class="best_effort")
        elapsed = time.monotonic() - started
        _assert_balanced(r)
        # 2 s best_effort budget: the rounds that fit, then the
        # ladder — never the full 8-round exchange at 0.45 s/call.
        assert elapsed < 8.0, elapsed

    def test_sync_fault_charges_peer_breaker(self, duo):
        """Chaos: peer.sync — protocol-level sync failures charge that
        peer's circuit breaker; enough of them trip it."""
        svc = duo["svcs"]["a"]
        svc._watchdog.reset()
        with faults.injected(
            faults.FaultInjector(7).plan("peer.sync", times=0)
        ):
            _fed_assign(duo, "a")
            _fed_assign(duo, "a")
        stats = svc._watchdog.stats()["peer:b"]
        assert (
            stats["consecutive_failures"] >= 1
            or stats["state"] == "open"
        )

    def test_server_rejects_regressed_epoch(self, duo):
        fed = duo["svcs"]["b"]._federation
        fed.register_local_shard(duo["shards"]["b"], C)
        hi = wire.sync_request("x", 9, 0, C, scale=1.0, phase="hello")
        assert "rejected" not in fed.serve_sync(hi)
        before = _counter(
            "klba_peer_stale_duals_total", {"reason": "stale_epoch"}
        )
        lo = wire.sync_request("x", 3, 0, C, scale=1.0, phase="hello")
        out = fed.serve_sync(lo)
        assert out["rejected"] == "stale_epoch"
        assert _counter(
            "klba_peer_stale_duals_total", {"reason": "stale_epoch"}
        ) == before + 1

    def test_server_rejects_fenced_token(self, duo):
        fed = duo["svcs"]["b"]._federation
        fed.register_local_shard(duo["shards"]["b"], C)
        hi = wire.sync_request(
            "y", 1, 0, C, scale=1.0, phase="hello", fence_token=5
        )
        assert "rejected" not in fed.serve_sync(hi)
        lo = wire.sync_request(
            "y", 2, 0, C, scale=1.0, phase="hello", fence_token=3
        )
        out = fed.serve_sync(lo)
        assert out["rejected"] == "fenced"

    def test_server_rejects_unregistered_and_mismatch(self):
        fed = FederationCoordinator("solo", [], device=DEV)
        out = fed.serve_sync(
            wire.sync_request("z", 1, 0, C, scale=1.0, phase="hello")
        )
        assert out["rejected"] == "unavailable"
        fed.register_local_shard(_shard(5), C)
        out = fed.serve_sync(
            wire.sync_request("z", 2, 0, C + 1, scale=1.0,
                              phase="hello")
        )
        assert out["rejected"] == "mismatch"

    def test_on_wire_payloads_are_lag_free(self, duo):
        """The privacy gate, against REAL protocol traffic: request
        and response payloads for an actual shard contain no window of
        its raw lag vector."""
        fed_b = duo["svcs"]["b"]._federation
        lags = duo["shards"]["b"]
        _warm_federation(duo)
        scale = max(float(
            sum(int(s.sum()) for s in duo["shards"].values())
        ), 1.0) / C
        A, B = fedsolve.initial_duals(C, device=DEV)
        # A distinct sender id: bumping the real peer "a"'s epoch
        # ledger here would make its later genuine syncs read stale.
        req = wire.sync_request(
            "wire-audit", 1, 1, C, scale=scale, duals_a=A, duals_b=B,
        )
        resp = fed_b.serve_sync(req)
        assert "marginals" in resp
        wire.assert_lag_free(wire.encode(req), lags)
        wire.assert_lag_free(wire.encode(resp), lags)

    def test_epoch_bumps_only_on_changed_shard(self, duo):
        fed = duo["svcs"]["a"]._federation
        lags = duo["shards"]["a"]
        e1 = fed.register_local_shard(lags, C)
        e2 = fed.register_local_shard(lags, C)
        assert e2 == e1
        e3 = fed.register_local_shard(lags + 1, C)
        assert e3 == e1 + 1
        fed.register_local_shard(lags, C)  # restore for later tests

    def test_degrade_rung_skips_peer_rounds(self, duo):
        """Overload integration: a degraded admission answers
        local-only WITHOUT paying peer rounds (the shed is counted)."""
        svc = duo["svcs"]["a"]
        ctl = svc._overload
        for _ in range(30):
            # Seeded so that after the request's own zero-depth feed
            # (one 0.7x EWMA decay) pressure lands in [1.5, 2.5):
            # rung 2 (degrade_best_effort), below the rung-3 reject.
            ctl.note_depth(ctl.depth_high * 3.4)
        ctl._last_eval = None
        try:
            r = _fed_assign(duo, "a", slo_class="best_effort")
            assert r["federation"]["rung"] == "local_only"
            assert r["federation"]["rounds"] == 0
        finally:
            for _ in range(50):
                ctl.note_depth(0.0)
            ctl._rung = 0
            ctl._last_eval = None

    def test_coordinator_state_roundtrip(self, duo):
        _warm_federation(duo)
        fed = duo["svcs"]["a"]._federation
        state = json.loads(json.dumps(fed.export_state()))
        fresh = FederationCoordinator(
            "a", [PeerSpec("b", "127.0.0.1", 1)], device=DEV
        )
        fresh.restore_state(state)
        assert fresh.local_epoch == fed.local_epoch
        assert fresh._links["b"].max_epoch_seen >= 1
        with fresh._cache_lock:
            cached = fresh._last_good
        assert cached is not None and cached["C"] == C
        # Restored duals serve the last_good_global rung.
        out = fresh.assign(
            duo["shards"]["a"], C, lambda: 30.0, refine_iters=64
        )
        assert out["rung"] == "last_good_global"
        counts = np.bincount(out["choice"], minlength=C)
        assert counts.max() - counts.min() <= 1

    def test_restore_discards_malformed(self):
        fresh = FederationCoordinator("a", [], device=DEV)
        fresh.restore_state({"epoch": "x", "last_good": 3})
        fresh.restore_state("garbage")
        assert fresh.local_epoch == 0

    def test_peer_sync_without_federation_errors(self):
        with AssignorService(port=0, coalesce_max_batch=1,
                             scrub_interval_ms=0, device=DEV) as svc:
            with AssignorServiceClient(*svc.address) as c:
                with pytest.raises(RuntimeError, match="not configured"):
                    c.request("peer_sync", {"peer_id": "x"})
                assert c.federation() == {"enabled": False}

    def test_peers_require_self_id(self):
        with pytest.raises(ValueError, match="federation_self_id"):
            AssignorService(
                port=0, federation_peers="a=127.0.0.1:1", device=DEV
            )

    def test_from_config_wiring(self):
        from kafka_lag_based_assignor_tpu_torch.utils.config import (
            parse_config,
        )

        cfg = parse_config({
            "group.id": "g",
            "tpu.assignor.federation.self.id": "west",
            "tpu.assignor.federation.peers": "east=h:7531",
            "tpu.assignor.federation.rounds": 4,
            "tpu.assignor.federation.sync.timeout.ms": 500,
            "tpu.assignor.federation.max.staleness.ms": 60000,
        })
        assert cfg.federation_self_id == "west"
        assert cfg.federation_rounds == 4
        assert cfg.federation_sync_timeout_s == 0.5
        assert cfg.federation_max_staleness_s == 60.0
        with pytest.raises(ValueError, match="federation"):
            parse_config({
                "group.id": "g",
                "tpu.assignor.federation.peers": "east=h:7531",
            })
        with pytest.raises(ValueError, match="peer spec"):
            parse_config({
                "group.id": "g",
                "tpu.assignor.federation.self.id": "west",
                "tpu.assignor.federation.peers": "east",
            })


class TestGossipDuals:
    def test_gossip_phase_whitelisted_unknown_rejected(self):
        params = wire.sync_request(
            "a", 1, 1, C, scale=1.0,
            duals_a=np.zeros(C, np.float32),
            duals_b=np.zeros(C, np.float32),
            phase="gossip",
        )
        assert params["phase"] == "gossip"
        assert set(params) <= wire._REQUEST_KEYS
        with pytest.raises(wire.PayloadViolation, match="phase"):
            wire.sync_request(
                "a", 1, 1, C, scale=1.0,
                duals_a=np.zeros(C, np.float32),
                duals_b=np.zeros(C, np.float32),
                phase="mutate",
            )

    def test_idle_without_shard_or_peers_and_status(self):
        coord = FederationCoordinator("solo", [], device=DEV)
        try:
            idle = _counter(
                "klba_gossip_rounds_total", {"outcome": "idle"}
            )
            assert coord.gossip_now() == "idle"
            assert _counter(
                "klba_gossip_rounds_total", {"outcome": "idle"}
            ) == idle + 1
            g = coord.status()["gossip"]
            assert g["interval_s"] == 0.0
            assert g["thread_alive"] is False
            assert g["last"]["outcome"] == "idle"
        finally:
            coord.close()

    def test_ctor_rejects_negative_interval(self):
        with pytest.raises(ValueError, match="gossip_interval_s"):
            FederationCoordinator("solo", [], gossip_interval_s=-0.1, device=DEV)

    def test_gossip_refresh_then_warm_cache_serve(self, duo):
        """One gossip round refreshes the dual cache; with the warm
        window open, the next federated_assign serves rung global in
        ONE local round — no synchronous exchange — and says so via
        ``federation.warm_cache``."""
        _warm_federation(duo)
        fed = duo["svcs"]["a"]._federation
        ok = _counter("klba_gossip_rounds_total", {"outcome": "ok"})
        assert fed.gossip_now() == "ok"
        assert _counter(
            "klba_gossip_rounds_total", {"outcome": "ok"}
        ) == ok + 1
        assert fed.last_gossip["outcome"] == "ok"
        prev = (fed.gossip_interval_s, fed.gossip_freshness_s)
        fed.gossip_interval_s, fed.gossip_freshness_s = 1.0, 60.0
        try:
            with faults.injected(
                # Every synchronous peer RPC severed: only the warm
                # cache can serve rung global here.
                faults.FaultInjector(7).plan("peer.partition", times=0)
            ):
                r = _fed_assign(duo, "a")
        finally:
            fed.gossip_interval_s, fed.gossip_freshness_s = prev
        assert r["federation"]["rung"] == "global"
        assert r["federation"]["warm_cache"] is True
        _assert_balanced(r)

    def test_stale_gossip_cache_falls_through_ladder(self, duo):
        """A cache past the gossip FRESHNESS window (but inside the
        last-good staleness bound) must NOT serve as warm-cache
        global — the ordinary ladder answers last_good_global."""
        _warm_federation(duo)
        fed = duo["svcs"]["a"]._federation
        prev = (fed.gossip_interval_s, fed.gossip_freshness_s)
        fed.gossip_interval_s, fed.gossip_freshness_s = 1.0, 0.5
        with fed._cache_lock:
            fed._last_good["at"] -= 1.0  # older than freshness
        try:
            with faults.injected(
                faults.FaultInjector(7).plan("peer.partition", times=0)
            ):
                r = _fed_assign(duo, "a")
        finally:
            fed.gossip_interval_s, fed.gossip_freshness_s = prev
        assert r["federation"]["rung"] == "last_good_global"
        assert r["federation"].get("warm_cache") is False
        _assert_balanced(r)

    def test_gossip_degraded_under_partition_keeps_cache(self, duo):
        _warm_federation(duo)
        fed = duo["svcs"]["a"]._federation
        degraded = _counter(
            "klba_gossip_rounds_total", {"outcome": "degraded"}
        )
        with faults.injected(
            faults.FaultInjector(7).plan("peer.partition", times=0)
        ):
            assert fed.gossip_now() == "degraded"
        assert _counter(
            "klba_gossip_rounds_total", {"outcome": "degraded"}
        ) == degraded + 1
        with fed._cache_lock:
            assert fed._last_good is not None  # kept, just aging

    def test_daemon_thread_starts_and_stops_with_service(self):
        ports = _free_ports(2)
        svc = AssignorService(
            port=ports[0],
            coalesce_max_batch=1,
            scrub_interval_ms=0,
            federation_self_id="g0",
            federation_peers=f"g1=127.0.0.1:{ports[1]}",
            federation_gossip_interval_s=30.0,  # never fires in-test
            device=DEV,
        )
        svc.start()
        try:
            fed = svc._federation
            assert fed.gossip_interval_s == 30.0
            assert fed._gossip_thread is not None
            assert fed._gossip_thread.is_alive()
            assert fed.status()["gossip"]["thread_alive"] is True
        finally:
            svc.stop()
        assert not fed._gossip_thread.is_alive()

    def test_gossip_config_key_wiring(self):
        from kafka_lag_based_assignor_tpu_torch.utils.config import (
            parse_config,
        )

        cfg = parse_config({
            "group.id": "g",
            "tpu.assignor.federation.self.id": "west",
            "tpu.assignor.federation.peers": "east=h:7531",
            "tpu.assignor.federation.gossip.interval.ms": 250,
        })
        assert cfg.federation_gossip_interval_s == 0.25
        assert parse_config({
            "group.id": "g",
        }).federation_gossip_interval_s == 0.0
        with pytest.raises(ValueError, match="gossip"):
            parse_config({
                "group.id": "g",
                "tpu.assignor.federation.self.id": "west",
                "tpu.assignor.federation.peers": "east=h:7531",
                "tpu.assignor.federation.gossip.interval.ms": -1,
            })


def test_partition_heal_soak(duo):
    """Two sidecars: converge, a full partition window (every epoch
    still serves a valid count-balanced assignment, zero request
    errors), then heal — peers re-converge to rung global within the
    bounded round budget and stale/fenced state never blended in."""
    _warm_federation(duo)
    svc_a = duo["svcs"]["a"]
    errors_before = {
        sid: duo["svcs"][sid].errors for sid in ("a", "b")
    }
    # Partition window: every peer RPC fails for both sidecars.
    with faults.injected(
        faults.FaultInjector(13).plan("peer.partition", times=0)
    ):
        for i in range(6):
            for sid in ("a", "b"):
                r = _fed_assign(duo, sid)
                assert r["federation"]["rung"] in (
                    "last_good_global", "local_only"
                )
                _assert_balanced(r)
            svc_a._watchdog.reset()
            duo["svcs"]["b"]._watchdog.reset()
    for sid in ("a", "b"):
        assert duo["svcs"][sid].errors == errors_before[sid]
    # Heal: breakers closed, next epochs re-converge.
    for svc in duo["svcs"].values():
        svc._watchdog.reset()
    for sid in ("a", "b"):
        r = _fed_assign(duo, sid)
        assert r["federation"]["rung"] == "global"
        assert r["federation"]["rounds"] <= 8
        _assert_balanced(r)




# -- one wire: a JAX sidecar and a port sidecar peer ------------------------


def test_mixed_pair_converges_global():
    """One JAX sidecar and one port sidecar, peered over loopback TCP:
    both register their shards, then each one's federated_assign converges
    to rung global over the other's marginals (the wire is one wire)."""
    from kafka_lag_based_assignor_tpu.service import AssignorService as JaxService
    from kafka_lag_based_assignor_tpu.service import (
        AssignorServiceClient as JaxClient,
    )

    ports = _free_ports(2)
    common = dict(coalesce_max_batch=1, scrub_interval_ms=0, federation_rounds=8,
                  federation_sync_timeout_s=60.0)
    jax_svc = JaxService(port=ports[0], federation_self_id="jax",
                         federation_peers=f"port=127.0.0.1:{ports[1]}", **common)
    port_svc = AssignorService(port=ports[1], federation_self_id="port",
                               federation_peers=f"jax=127.0.0.1:{ports[0]}",
                               device=DEV, **common)
    jax_svc.start()
    port_svc.start()
    shards = {"jax": _shard(61), "port": _shard(62)}
    try:
        with JaxClient("127.0.0.1", ports[0], timeout_s=180.0) as jc, \
                AssignorServiceClient("127.0.0.1", ports[1], timeout_s=180.0) as pc:
            clients = {"jax": jc, "port": pc}
            for sid in ("port", "jax", "port", "jax"):
                r = clients[sid].federated_assign("t0", _rows(shards[sid]), MEMBERS)
            assert r["federation"]["rung"] == "global"
            r = pc.federated_assign("t0", _rows(shards["port"]), MEMBERS)
            assert r["federation"]["rung"] == "global"
            assert 1 <= r["federation"]["rounds"] <= 8
            _assert_balanced(r)
            assert pc.federation()["peers"]["jax"]["epoch_seen"] >= 1
            assert jc.federation()["peers"]["port"]["epoch_seen"] >= 1
    finally:
        jax_svc.stop()
        port_svc.stop()


def test_snapshot_federation_section_is_the_jax_document():
    """The snapshot's ``federation`` section: the port coordinator's export
    restores into the JAX coordinator and back, and each package's export
    of the same state is the same JSON document (clocks pinned)."""
    from kafka_lag_based_assignor_tpu.federated.peers import (
        FederationCoordinator as JaxCoordinator,
    )

    peers = [PeerSpec("b", "127.0.0.1", 1), PeerSpec("c", "127.0.0.1", 2)]
    port_fed = FederationCoordinator("a", peers, clock=lambda: 100.0, device=DEV)
    port_fed.register_local_shard(_shard(71), C)
    port_fed.register_local_shard(_shard(72), C)
    port_fed._links["b"].max_epoch_seen = 5
    port_fed._links["c"].max_fence_seen = 3
    A, B = fedsolve.initial_duals(C, device=DEV)
    with port_fed._cache_lock:
        port_fed._last_good = {
            "A": A + 0.25, "B": B, "scale": 1234.5, "base_load": np.ones(C) * 0.5,
            "C": C, "at": 97.5, "rounds": 6, "cap_frac": None, "converged": True,
        }
    doc = json.dumps(port_fed.export_state(), sort_keys=True)
    jax_fed = JaxCoordinator("a", peers, clock=lambda: 100.0)
    jax_fed.restore_state(json.loads(doc))
    assert json.dumps(jax_fed.export_state(), sort_keys=True) == doc
    back = FederationCoordinator("a", peers, clock=lambda: 100.0, device=DEV)
    back.restore_state(json.loads(json.dumps(jax_fed.export_state())))
    assert json.dumps(back.export_state(), sort_keys=True) == doc
    for fed in (port_fed, jax_fed, back):
        fed.close()
