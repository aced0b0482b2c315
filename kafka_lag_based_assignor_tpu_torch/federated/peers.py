"""Peer coordination: dual-exchange rounds, breakers, staleness, ladder.

Counterpart of ``kafka_lag_based_assignor_tpu/federated/peers.py``; the
coordinator's device math runs on ``device`` (:mod:`..ops.fedsolve`: K3 for
each round's marginals, the resident refine for the local rounding).

One :class:`FederationCoordinator` lives in each sidecar and plays both
protocol roles:

* **server** — :meth:`serve_sync` answers a peer's ``peer_sync``
  request over THIS sidecar's registered local lag shard: handshake
  scalars (``phase: hello``) or the shard's marginal contribution
  under the carried duals (``phase: exchange``).  Stateless per round
  (the duals ride in the request), so concurrent initiators never
  conflict.  Monotone **epoch** and **fencing-token** checks run per
  sender: a request whose epoch or token regresses below the recorded
  maximum is answered with a structured reject and counted
  (``klba_peer_stale_duals_total``) — stale or fenced state is dropped,
  never averaged in.
* **initiator** — :meth:`assign` converges a GLOBAL assignment for the
  local shard inside the request's deadline budget: a hello round fixes
  the shared scale/cap from every peer's scalars, then synchronized
  exchange rounds sum the per-shard marginals and step the shared
  duals (:mod:`..ops.fedsolve`) until convergence, and the local shard
  is rounded with the other shards' converged loads as a fixed base.
  Every per-peer exchange runs under that peer's circuit breaker
  (utils/watchdog, key ``peer:<id>``) with a bounded per-call timeout,
  through a reconnect-once line client.

Degradation ladder (``FEDERATION_RUNGS``): any incomplete round —
partitioned peer, tripped breaker, stale/fenced response, exhausted
budget — abandons the exchange and falls to the **last-good-global**
duals (bounded staleness: the cache serves only within
``max_staleness_s`` and for the same consumer count), then to
**local_only**, where the caller runs today's single-cluster solve
untouched — a fully partitioned peer set fails open to exactly the
pre-federation behavior.

Fault points (utils/faults): ``peer.partition`` / ``peer.slow_link``
fire at the link transport, ``peer.sync`` inside the breaker-wrapped
exchange, ``peer.stale_duals`` in the initiator's response validation
(a firing plan makes the response count as stale).
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np

from ..utils import faults, metrics
from ..utils.device import DeviceLike, resolve_device
from ..utils.watchdog import Watchdog
from . import wire

LOGGER = logging.getLogger(__name__)

#: The degradation ladder, best to worst (gauge exports the index).
FEDERATION_RUNGS = ("global", "last_good_global", "local_only")

#: Default bound on exchange rounds per assign (each round is one
#: marginal RPC per peer; convergence typically lands well under it —
#: the leader's damped iteration exits in ~6-24 steps).
DEFAULT_MAX_ROUNDS = 16

#: Default per-peer sync RPC timeout (seconds) — small relative to any
#: request budget: a slow link must cost one bounded wait, not the
#: whole deadline.
DEFAULT_SYNC_TIMEOUT_S = 2.0

#: Default bounded staleness of the last-good-global dual cache.
DEFAULT_MAX_STALENESS_S = 300.0


class PeerSpec(NamedTuple):
    peer_id: str
    host: str
    port: int


def parse_peer_specs(text: str) -> List[PeerSpec]:
    """Parse ``"id=host:port,id=host:port"`` (the config/CLI grammar);
    raises ValueError on malformed or duplicate entries."""
    specs: List[PeerSpec] = []
    seen = set()
    for entry in str(text).split(","):
        entry = entry.strip()
        if not entry:
            continue
        if "=" not in entry or ":" not in entry.split("=", 1)[1]:
            raise ValueError(
                f"peer spec {entry!r} must be 'id=host:port'"
            )
        pid, addr = entry.split("=", 1)
        host, port_s = addr.rsplit(":", 1)
        try:
            port = int(port_s)
        except ValueError:
            raise ValueError(f"peer spec {entry!r} has a non-integer port")
        if not pid or not host or not 0 < port < 65536:
            raise ValueError(f"peer spec {entry!r} is invalid")
        if pid in seen:
            raise ValueError(f"duplicate peer id {pid!r}")
        seen.add(pid)
        specs.append(PeerSpec(pid, host, port))
    return specs


class PeerDropped(RuntimeError):
    """One peer's contribution failed for this round (transport,
    protocol reject, stale/fenced response): raised INSIDE the
    breaker-wrapped exchange so consecutive failures trip that peer's
    breaker, and caught by the round loop, which abandons the global
    attempt (partial marginal sums are never used)."""

    def __init__(self, peer_id: str, reason: str):
        super().__init__(f"peer {peer_id!r} dropped: {reason}")
        self.peer_id = peer_id
        self.reason = reason


class _PeerLink:
    """One peer's transport: a lazily built reconnect-once line client
    (the same :class:`..service.AssignorServiceClient` the JVM shim
    models) plus the per-sender monotone (epoch, fence) ledger."""

    def __init__(self, spec: PeerSpec, timeout_s: float):
        self.spec = spec
        self.timeout_s = float(timeout_s)
        self._client = None
        self._lock = threading.Lock()
        # Highest epoch / fencing token ever seen FROM this peer: a
        # response regressing below either is stale/fenced state from
        # a predecessor and is dropped, never averaged in.
        self.max_epoch_seen = -1
        self.max_fence_seen: Optional[int] = None
        self.last_outcome: Optional[str] = None

    def request(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """One ``peer_sync`` round trip.  Fault points: a
        ``peer.partition`` raise = unreachable peer; a
        ``peer.slow_link`` latency plan delays here (the caller's
        watchdog deadline bounds the damage)."""
        faults.fire("peer.partition")
        faults.fire("peer.slow_link")
        with self._lock:
            if self._client is None:
                from ..service import AssignorServiceClient

                self._client = AssignorServiceClient(
                    self.spec.host, self.spec.port,
                    timeout_s=self.timeout_s,
                )
            return self._client.request(
                wire.PEER_SYNC_METHOD, params
            )

    def close(self) -> None:
        with self._lock:
            if self._client is not None:
                try:
                    self._client.close()
                except OSError:
                    pass  # already torn down
                self._client = None


class FederationCoordinator:
    """Both halves of the federation protocol for one sidecar (module
    docstring).  ``watchdog`` hosts the per-peer breakers (keys
    ``peer:<id>`` — they surface in the service's ``stats.breakers``
    next to the solver breakers); ``fence_token`` is a zero-arg
    callable returning this sidecar's current writer fencing token
    (utils/snapshot lease) or None when fencing is off.  ``device`` is where
    the shard math runs (None: the CUDA card, raising without one)."""

    def __init__(
        self,
        self_id: str,
        peers: List[PeerSpec],
        watchdog: Optional[Watchdog] = None,
        max_rounds: int = DEFAULT_MAX_ROUNDS,
        sync_timeout_s: float = DEFAULT_SYNC_TIMEOUT_S,
        max_staleness_s: float = DEFAULT_MAX_STALENESS_S,
        fence_token: Optional[Callable[[], Optional[int]]] = None,
        clock: Optional[Callable[[], float]] = None,
        capacity: Optional[Any] = None,
        gossip_interval_s: float = 0.0,
        gossip_freshness_s: Optional[float] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        if not self_id:
            raise ValueError("federation self_id must be non-empty")
        if float(gossip_interval_s) < 0:
            raise ValueError(
                f"gossip_interval_s={gossip_interval_s} must be >= 0"
            )
        if any(p.peer_id == self_id for p in peers):
            raise ValueError(
                f"peer list names this sidecar's own id {self_id!r}"
            )
        if int(max_rounds) < 1:
            raise ValueError(f"max_rounds={max_rounds} must be >= 1")
        if float(sync_timeout_s) <= 0:
            raise ValueError(
                f"sync_timeout_s={sync_timeout_s} must be > 0"
            )
        self.self_id = str(self_id)
        self.max_rounds = int(max_rounds)
        self.sync_timeout_s = float(sync_timeout_s)
        self.max_staleness_s = float(max_staleness_s)
        self._fence_token = fence_token or (lambda: None)
        self._clock = clock or metrics.REGISTRY.clock
        # Weighted shards (ROADMAP federated (c)): this cluster's
        # per-consumer capacity weight vector, exchanged in the hello
        # phase and summed into the global count-marginal target.  None
        # = contribute uniform weights (the n/C back-compat marginal
        # when NO shard advertises capacity).  Length is validated
        # against C at use — a roster-size change simply drops it.
        self.capacity = (
            np.asarray(capacity, dtype=np.float64)
            if capacity is not None else None
        )
        self._watchdog = watchdog or Watchdog(
            sync_timeout_s, cooldown_s=30.0, failure_threshold=2
        )
        self._links = {
            p.peer_id: _PeerLink(p, self.sync_timeout_s) for p in peers
        }
        # Local shard (the server side's truth) + the monotone local
        # epoch.  Guarded by one lock; serve_sync and assign both read
        # it.  The dedup cache is keyed by (epoch, scale) — one entry,
        # rebuilt when either moves.
        self._shard_lock = threading.Lock()
        self._shard: Optional[Dict[str, Any]] = None
        self.local_epoch = 0
        # Per-INITIATOR monotone (epoch, fence) ledger for serve_sync:
        # requests from a given peer id must never regress.  Bounded by
        # the configured peer set plus strangers (capped).
        self._seen_lock = threading.Lock()
        self._seen: Dict[str, Dict[str, Any]] = {}
        # Last-good-global dual cache (bounded staleness): the newest
        # COMPLETE exchange's duals + remote base loads (every peer
        # contributed every round; tol-convergence not required — see
        # the cache-write comment in _try_global).
        self._cache_lock = threading.Lock()
        self._last_good: Optional[Dict[str, Any]] = None
        self.last_rounds = 0
        self.last_rung: Optional[str] = None
        self._m_rung = metrics.REGISTRY.gauge("klba_federation_rung")
        self._m_staleness = metrics.REGISTRY.gauge(
            "klba_federation_staleness_s"
        )
        self._m_link_state = {
            pid: metrics.REGISTRY.gauge(
                "klba_peer_link_state", {"peer": pid}
            )
            for pid in self._links
        }
        # Async gossip duals (the background convergence plane): a
        # daemon thread re-converges the consumer-axis duals with peers
        # at a jittered cadence, continuously refreshing the last-good
        # cache, so assign() can serve rung "global" from warm duals in
        # ONE local round — no synchronous peer RTT on the serve path.
        # Off by default (interval 0 = today's synchronous exchange).
        # The freshness window bounds how old a gossiped dual set may
        # be and still serve AS "global"; past it the ordinary ladder
        # (synchronous exchange -> last-good -> local-only) takes over.
        self.gossip_interval_s = float(gossip_interval_s)
        self.gossip_freshness_s = (
            float(gossip_freshness_s)
            if gossip_freshness_s is not None
            else min(2.5 * self.gossip_interval_s, self.max_staleness_s)
        )
        self.last_gossip: Optional[Dict[str, Any]] = None
        self._m_gossip = {
            o: metrics.REGISTRY.counter(
                "klba_gossip_rounds_total", {"outcome": o}
            )
            for o in ("ok", "degraded", "idle", "error")
        }
        self._gossip_stop = threading.Event()
        self._gossip_thread: Optional[threading.Thread] = None
        if self.gossip_interval_s > 0 and self._links:
            self._gossip_thread = threading.Thread(
                target=self._gossip_loop,
                name=f"klba-gossip-{self.self_id}", daemon=True,
            )
            self._gossip_thread.start()

    # -- local shard --------------------------------------------------------

    def register_local_shard(self, lags: np.ndarray, C: int) -> int:
        """Install this sidecar's current local lag view (sorted-pid
        order) as the shard peers sync against; bumps the monotone
        local epoch when the vector changed.  Returns the epoch."""
        lags = np.asarray(lags, dtype=np.int64)
        with self._shard_lock:
            prev = self._shard
            changed = (
                prev is None
                or prev["C"] != int(C)
                or prev["lags"].shape != lags.shape
                or not np.array_equal(prev["lags"], lags)
            )
            if changed:
                self.local_epoch += 1
                self._shard = {
                    "lags": lags,
                    "C": int(C),
                    "total": int(lags.sum(dtype=np.int64)),
                    "n": int(lags.shape[0]),
                    "dedup": None,  # (scale, (ws_u, count_u, wsum_u))
                }
            return self.local_epoch

    def _shard_dedup(self, shard: Dict[str, Any], scale: float):
        """Caller holds ``_shard_lock``: the shard's dedup weights
        under ``scale``, cached (one entry — scale is fixed per
        exchange and moves only with the global totals)."""
        from ..ops import fedsolve

        cached = shard["dedup"]
        if cached is not None and abs(cached[0] - scale) < 1e-9:
            return cached[1]
        weights = fedsolve.shard_dedup(
            shard["lags"], np.ones(shard["n"], bool), scale
        )
        shard["dedup"] = (float(scale), weights)
        return weights

    # -- the server half ----------------------------------------------------

    def _served(self, outcome: str) -> None:
        metrics.REGISTRY.counter(
            "klba_peer_sync_served_total", {"outcome": outcome}
        ).inc()

    def _count_stale(self, reason: str) -> None:
        metrics.REGISTRY.counter(
            "klba_peer_stale_duals_total", {"reason": reason}
        ).inc()

    def serve_sync(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """Answer one incoming ``peer_sync`` request (the service's
        dispatch calls this).  Never raises for protocol-level
        problems — those are structured rejects the initiator counts;
        malformed requests raise ValueError like any wire input."""
        if not isinstance(params, dict):
            raise ValueError("peer_sync params must be a JSON object")
        sender = params.get("peer_id")
        if not isinstance(sender, str) or not sender:
            raise ValueError("peer_sync params.peer_id must be a string")
        epoch = params.get("epoch")
        if not isinstance(epoch, int) or isinstance(epoch, bool):
            raise ValueError("peer_sync params.epoch must be an integer")
        C = params.get("num_consumers")
        if not isinstance(C, int) or isinstance(C, bool) or C < 1:
            raise ValueError(
                "peer_sync params.num_consumers must be a positive "
                "integer"
            )
        token = self._fence_token()
        if params.get("version") != wire.PROTOCOL_VERSION:
            self._served("version")
            return wire.sync_reject(self.self_id, "version", epoch, C)
        # Monotone epoch + fencing per SENDER: a regressing request is
        # stale state from a rolled-back or fenced-off predecessor —
        # rejected and counted, never served marginals that it would
        # blend into a stale global.
        fence = params.get("fence_token")
        with self._seen_lock:
            rec = self._seen.get(sender)
            if rec is None:
                if len(self._seen) >= 256:
                    # Strangers are bounded (L014) — but ONLY strangers
                    # are evictable: dropping a configured peer's entry
                    # would reset its monotone epoch/fence record and
                    # let a fenced-off predecessor be served again.
                    evictable = next(
                        (k for k in self._seen if k not in self._links),
                        None,
                    )
                    if evictable is None:
                        raise ValueError(
                            "peer ledger full of configured peers"
                        )
                    self._seen.pop(evictable)
                rec = self._seen[sender] = {"epoch": -1, "fence": None}
            if epoch < rec["epoch"]:
                self._count_stale("stale_epoch")
                self._served("stale_epoch")
                return wire.sync_reject(
                    self.self_id, "stale_epoch", self.local_epoch, C
                )
            if fence is not None and rec["fence"] is not None and (
                int(fence) < rec["fence"]
            ):
                self._count_stale("fenced")
                self._served("fenced")
                return wire.sync_reject(
                    self.self_id, "fenced", self.local_epoch, C
                )
            rec["epoch"] = epoch
            if fence is not None:
                rec["fence"] = max(
                    int(fence),
                    rec["fence"] if rec["fence"] is not None else 0,
                )
        with self._shard_lock:
            shard = self._shard
            if shard is None:
                self._served("unavailable")
                return wire.sync_reject(
                    self.self_id, "unavailable", self.local_epoch, C
                )
            if shard["C"] != C:
                self._served("mismatch")
                return wire.sync_reject(
                    self.self_id, "mismatch", self.local_epoch, C
                )
            if params.get("phase") == "hello":
                self._served("ok")
                return wire.sync_response(
                    self.self_id, self.local_epoch,
                    int(params.get("round", 0)), C,
                    total_lag=shard["total"], n_valid=shard["n"],
                    fence_token=token,
                    capacity=self._capacity_for(C),
                )
            duals = params.get("duals") or {}
            a = duals.get("A")
            b = duals.get("B")
            if (
                not isinstance(a, list) or not isinstance(b, list)
                or len(a) != C or len(b) != C
            ):
                raise ValueError(
                    "peer_sync exchange params.duals.A/B must be "
                    "length-C lists"
                )
            scale = float(params.get("scale", 0.0))
            if not scale > 0:
                raise ValueError("peer_sync params.scale must be > 0")
            weights = self._shard_dedup(shard, scale)
            total, n = shard["total"], shard["n"]
            my_epoch = self.local_epoch
        from ..ops import fedsolve

        load, colsum = fedsolve.shard_marginals(
            *weights,
            np.asarray(a, dtype=np.float32),
            np.asarray(b, dtype=np.float32),
            device=self.device,
        )
        self._served("ok")
        return wire.sync_response(
            self.self_id, my_epoch, int(params.get("round", 0)), C,
            total_lag=total, n_valid=n, load=load, colsum=colsum,
            fence_token=token,
        )

    def _capacity_for(self, C: int) -> Optional[list]:
        """This cluster's capacity vector as a wire-ready list, or None
        when unset or shaped for a different roster."""
        cap = self.capacity
        if cap is None or cap.shape != (int(C),):
            return None
        return [float(v) for v in cap]

    # -- the initiator half -------------------------------------------------

    def _sync_once(
        self, link: _PeerLink, params: Dict[str, Any]
    ) -> Dict[str, Any]:
        """One breaker-wrapped peer exchange: transport + protocol +
        staleness validation.  Raises :class:`PeerDropped` on ANY
        reason this peer's contribution cannot be used — the watchdog
        counts consecutive failures toward the peer's breaker, and the
        round loop abandons the global attempt."""
        pid = link.spec.peer_id
        with metrics.span("federation.sync"):
            return self._sync_once_inner(link, pid, params)

    def _sync_once_inner(
        self, link: _PeerLink, pid: str, params: Dict[str, Any]
    ) -> Dict[str, Any]:
        try:
            # Fault point peer.sync: a protocol-level failure inside
            # the exchange (distinct from the transport-level
            # peer.partition) — charged to this peer's breaker.
            faults.fire("peer.sync")
            resp = link.request(params)
        except PeerDropped:
            raise
        except Exception as exc:
            raise PeerDropped(pid, f"transport: {exc}") from exc
        if not isinstance(resp, dict):
            raise PeerDropped(pid, "malformed response")
        rejected = resp.get("rejected")
        if rejected is not None:
            raise PeerDropped(pid, f"rejected: {rejected}")
        epoch = resp.get("epoch")
        if not isinstance(epoch, int):
            raise PeerDropped(pid, "missing epoch")
        stale_reason = None
        try:
            faults.fire("peer.stale_duals")
        except faults.FaultError:
            # The drill's simulated stale peer state: validate as if
            # the response's epoch had regressed.
            stale_reason = "injected"
        if epoch < link.max_epoch_seen:
            stale_reason = "stale_epoch"
        fence = resp.get("fence_token")
        if (
            fence is not None
            and link.max_fence_seen is not None
            and int(fence) < link.max_fence_seen
        ):
            stale_reason = "fenced"
        if stale_reason is not None:
            self._count_stale(stale_reason)
            raise PeerDropped(pid, f"stale duals ({stale_reason})")
        link.max_epoch_seen = max(link.max_epoch_seen, epoch)
        if fence is not None:
            link.max_fence_seen = max(
                int(fence), link.max_fence_seen or 0
            )
        return resp

    def _exchange_round(
        self,
        params_for: Callable[[str], Dict[str, Any]],
        remaining_s: Callable[[], Optional[float]],
    ) -> Optional[Dict[str, Dict[str, Any]]]:
        """One synchronized round against EVERY peer; returns
        ``{peer_id: response}`` or None when any peer failed (partial
        rounds are never used).  Each call runs under that peer's
        breaker with a timeout bounded by both the sync timeout and the
        request's remaining budget — re-read PER PEER, so N slow peers
        cannot stack N x remaining past the request deadline."""
        out: Dict[str, Dict[str, Any]] = {}
        for pid, link in self._links.items():
            timeout = self.sync_timeout_s
            rem = remaining_s()
            if rem is not None:
                timeout = min(timeout, rem)
            if timeout <= 0:
                self._note_peer(pid, "budget")
                return None
            try:
                resp = self._watchdog.call(
                    self._sync_once, link, params_for(pid),
                    key=f"peer:{pid}", timeout_s=timeout,
                )
            except Exception:
                # Transport failure, breaker fail-fast, injected fault,
                # stale/fenced drop — this round cannot complete.  The
                # ladder (not an error) decides what serves.
                LOGGER.warning(
                    "federation round lost peer %r", pid, exc_info=True
                )
                self._note_peer(pid, "error")
                return None
            self._note_peer(pid, "ok")
            out[pid] = resp
        return out

    def _note_peer(self, pid: str, outcome: str) -> None:
        link = self._links[pid]
        link.last_outcome = outcome
        metrics.REGISTRY.counter(
            "klba_peer_sync_total", {"peer": pid, "outcome": outcome}
        ).inc()
        state = self._watchdog.state(f"peer:{pid}")
        self._m_link_state[pid].set(
            {"closed": 0, "half_open": 1, "open": 2}.get(state, 0)
        )

    def assign(
        self,
        lags: np.ndarray,
        C: int,
        remaining_s: Callable[[], Optional[float]],
        refine_iters: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Converge (or degrade to) an assignment for the local shard.

        Returns ``{"rung": ..., "choice": int32[P] | None, "rounds",
        "peers_ok", "staleness_s", "converged"}`` — ``choice`` is None
        exactly at rung ``local_only`` (the caller runs its normal
        single-cluster solve, unchanged).  Never raises for peer
        failures; the ladder is the contract.
        """
        from ..ops import fedsolve

        lags = np.asarray(lags, dtype=np.int64)
        epoch = self.register_local_shard(lags, int(C))
        token = self._fence_token()
        result: Dict[str, Any] = {
            "rung": "local_only", "choice": None, "rounds": 0,
            "peers_ok": 0, "staleness_s": None, "converged": False,
            "warm_cache": False,
        }
        with metrics.span("federation.assign"):
            # Warm-cache fast path: with the gossip daemon keeping the
            # duals converged in the background, a fresh-enough cache
            # serves rung "global" in ONE local rounding call — no
            # synchronous peer RTT on the serve path.  A stale or
            # missing cache falls through to the ordinary ladder.
            attempt = (
                self._round_from_gossip(
                    fedsolve, lags, int(C), refine_iters
                )
                if self.gossip_interval_s > 0 else None
            )
            if attempt is None and self._links:
                attempt = self._try_global(
                    fedsolve, lags, int(C), epoch, token, remaining_s,
                    refine_iters,
                )
            if attempt is not None:
                result.update(attempt)
            else:
                cached = self._round_from_cache(
                    fedsolve, lags, int(C), refine_iters
                )
                if cached is not None:
                    result.update(cached)
        rung = result["rung"]
        self.last_rung = rung
        self._m_rung.set(FEDERATION_RUNGS.index(rung))
        metrics.REGISTRY.counter(
            "klba_federation_assign_total", {"rung": rung}
        ).inc()
        if rung != "global":
            metrics.FLIGHT.record(
                "federation",
                {
                    "event": "degraded",
                    "rung": rung,
                    "staleness_s": result["staleness_s"],
                    "peers_ok": result["peers_ok"],
                },
            )
        return result

    def _try_global(
        self, fedsolve, lags, C, epoch, token, remaining_s, refine_iters
    ) -> Optional[Dict[str, Any]]:
        """The synchronized exchange; None when any round lost a peer
        or the budget ran out (the caller then consults the cache)."""
        conv = self._converge_duals(
            fedsolve, C, epoch, token, remaining_s, phase="exchange"
        )
        if conv is None:
            return None
        self.last_rounds = conv["rounds"]
        choice, _, _ = fedsolve.round_local_shard(
            lags, C, conv["A"], conv["B"], conv["scale"],
            conv["base_load"], refine_iters=refine_iters,
            capacity_frac=conv["cap_frac"], device=self.device,
        )
        self._m_staleness.set(0.0)
        return {
            "rung": "global", "choice": choice,
            "rounds": conv["rounds"], "peers_ok": len(self._links),
            "staleness_s": 0.0, "converged": conv["converged"],
        }

    def _converge_duals(
        self, fedsolve, C, epoch, token, remaining_s,
        phase: str = "exchange",
    ) -> Optional[Dict[str, Any]]:
        """Hello + synchronized dual-exchange rounds against EVERY
        peer, refreshing the last-good cache on completion; None when
        any round lost a peer or the budget ran out.  This ONE body is
        shared verbatim by the synchronous serve path
        (``phase="exchange"``) and the background gossip daemon
        (``phase="gossip"``) — same per-peer breakers, same monotone
        epoch/fence staleness fencing, same complete-round discipline —
        so the only difference between the two planes is who pays the
        RTTs and when."""
        # Handshake: every peer's scalars fix the shared scale/cap.
        hello = self._exchange_round(
            lambda pid: wire.sync_request(
                self.self_id, epoch, 0, C, scale=1.0,
                fence_token=token, phase="hello",
                traceparent=metrics.current_traceparent(),
            ),
            remaining_s,
        )
        if hello is None:
            return None
        with self._shard_lock:
            shard = self._shard
            if shard is None or shard["C"] != C:
                # The gossip daemon races shard registration: no local
                # shard (or a roster flip mid-convergence) simply skips
                # this attempt — nothing to converge against.
                return None
            total = shard["total"]
            n = shard["n"]
        # Weighted shards: every shard's capacity vector (uniform ones
        # when a shard advertises none or sends an unusable one) is
        # NORMALIZED to sum C before summing — the aggregation is then
        # scale-invariant (a cluster reporting [1000, 500] and one
        # reporting [2, 1] express the same preference with the same
        # weight, and an unweighted cluster's uniform vote counts
        # equally).  A peer vector with a NaN/negative entry (the
        # wire audit rejects them at construction, but the response is
        # parsed JSON) is dropped to uniform, counted as stale state.
        # With NO shard weighted, the cap vector degenerates to
        # exactly the uniform n/C marginal.
        def _norm(vec) -> Optional[np.ndarray]:
            if vec is None or not (
                isinstance(vec, (list, np.ndarray)) and len(vec) == C
            ):
                return None
            if not wire.capacity_usable(vec):
                return None
            arr = np.asarray(vec, np.float64)
            return arr * (C / arr.sum())

        own_cap = _norm(self._capacity_for(C))
        cap_vecs = [own_cap if own_cap is not None
                    else np.ones(C, np.float64)]
        any_weighted = own_cap is not None
        for resp in hello.values():
            total += int(resp.get("total_lag", 0))
            n += int(resp.get("n_valid", 0))
            raw_cap = resp.get("capacity")
            peer_cap = _norm(raw_cap)
            if peer_cap is not None:
                cap_vecs.append(peer_cap)
                any_weighted = True
            else:
                if raw_cap is not None:
                    self._count_stale("capacity")
                cap_vecs.append(np.ones(C, np.float64))
        scale = max(float(total), 1.0) / C
        cap_frac: Optional[np.ndarray] = None
        if any_weighted:
            capw = np.sum(cap_vecs, axis=0)
            cap_frac = capw / capw.sum()
            cap = max(float(n), 1.0) * cap_frac
        else:
            cap = max(float(n), 1.0) / C
        with self._shard_lock:
            weights = self._shard_dedup(self._shard, scale)
        A, B = fedsolve.initial_duals(C, device=self.device)
        step_scale, prev_spread = 1.0, float("inf")
        rounds = 0
        converged = False
        remote_load = np.zeros(C, np.float64)
        for r in range(1, self.max_rounds + 1):
            with metrics.span("federation.round"):
                load, colsum = fedsolve.shard_marginals(
                    *weights, A, B, device=self.device
                )
                responses = self._exchange_round(
                    lambda pid: wire.sync_request(
                        self.self_id, epoch, r, C, scale=scale,
                        duals_a=A, duals_b=B, fence_token=token,
                        phase=phase,
                        traceparent=metrics.current_traceparent(),
                    ),
                    remaining_s,
                )
            if responses is None:
                return None
            rounds = r
            load_sum = load.astype(np.float64)
            colsum_sum = colsum.astype(np.float64)
            remote_load = np.zeros(C, np.float64)
            for pid, resp in responses.items():
                marg = resp.get("marginals") or {}
                r_load = np.asarray(
                    marg.get("load", []), dtype=np.float64
                )
                r_col = np.asarray(
                    marg.get("colsum", []), dtype=np.float64
                )
                if r_load.shape != (C,) or r_col.shape != (C,):
                    # A structurally short response cannot be summed;
                    # treat like a lost round.  Keyed by the CONFIGURED
                    # peer id, not the response's self-reported one —
                    # an id the links don't know would raise out of
                    # the never-raises ladder.
                    self._note_peer(pid, "error")
                    return None
                load_sum += r_load
                colsum_sum += r_col
                remote_load += r_load
            A, B, step_scale, spread, delta = fedsolve.dual_step(
                A, B, load_sum, colsum_sum, cap, step_scale,
                prev_spread, device=self.device,
            )
            # Carry the SPREAD (like the leader's loop body): the
            # damping test is "did the load spread grow since last
            # step" — carrying delta (>= spread by construction) would
            # keep `grew` from ever firing once the colsum correction
            # dominates, un-damping exactly the oscillating regime the
            # epsilon-scaled step exists for.
            prev_spread = spread
            if delta <= fedsolve.DUAL_TOL:
                converged = True
                break
        # Cache every COMPLETE exchange (all peers contributed every
        # round) — convergence-by-tol is deliberately NOT required: a
        # budget-bounded exchange that ran its full round budget still
        # yields near-converged duals (bench-measured quality 1.0001 at
        # max_rounds with delta ~3e-5 above tol), and an empty cache
        # would cost the middle rung exactly when partitions follow a
        # slow exchange.
        with self._cache_lock:
            self._last_good = {
                "A": np.asarray(A, np.float32),
                "B": np.asarray(B, np.float32),
                "scale": float(scale),
                "base_load": remote_load.astype(np.float32),
                "C": int(C),
                "at": self._clock(),
                "rounds": rounds,
                # The weighted-count shares (None = uniform) ride the
                # cache so the last-good-global rung rounds with the
                # same capacity apportionment the exchange converged
                # under.
                "cap_frac": cap_frac,
                # Whether the exchange hit DUAL_TOL (vs exhausting the
                # round budget) — the gossip warm-serve path reports it
                # as the served assignment's convergence.
                "converged": converged,
            }
        return {
            "A": A, "B": B, "scale": scale, "base_load": remote_load,
            "rounds": rounds, "converged": converged,
            "cap_frac": cap_frac,
        }

    def _round_from_cache(
        self, fedsolve, lags, C, refine_iters
    ) -> Optional[Dict[str, Any]]:
        """Rung 2: round the local shard with the last-good-global
        duals, inside the bounded-staleness window.  None when the
        cache is empty, too old, or shaped for a different roster —
        the caller then serves local-only."""
        with self._cache_lock:
            cached = dict(self._last_good) if self._last_good else None
        if cached is None or cached["C"] != C:
            return None
        age = self._clock() - cached["at"]
        if age > self.max_staleness_s:
            return None
        choice, _, _ = fedsolve.round_local_shard(
            lags, C, cached["A"], cached["B"], cached["scale"],
            cached["base_load"], refine_iters=refine_iters,
            capacity_frac=cached.get("cap_frac"), device=self.device,
        )
        self._m_staleness.set(age)
        return {
            "rung": "last_good_global", "choice": choice,
            "rounds": cached["rounds"], "peers_ok": 0,
            "staleness_s": age, "converged": False,
        }

    def _round_from_gossip(
        self, fedsolve, lags, C, refine_iters
    ) -> Optional[Dict[str, Any]]:
        """The gossip warm-cache fast path: round the local shard with
        the background-converged duals when the cache is inside the
        gossip FRESHNESS window (much tighter than the last-good rung's
        bounded staleness — these duals must be current enough to
        *count as* rung "global").  None falls through to the ordinary
        ladder."""
        with self._cache_lock:
            cached = dict(self._last_good) if self._last_good else None
        if cached is None or cached["C"] != C:
            return None
        age = self._clock() - cached["at"]
        if age > self.gossip_freshness_s:
            return None
        choice, _, _ = fedsolve.round_local_shard(
            lags, C, cached["A"], cached["B"], cached["scale"],
            cached["base_load"], refine_iters=refine_iters,
            capacity_frac=cached.get("cap_frac"), device=self.device,
        )
        self._m_staleness.set(age)
        return {
            "rung": "global", "choice": choice,
            "rounds": cached["rounds"],
            "peers_ok": len(self._links), "staleness_s": age,
            "converged": bool(cached.get("converged", False)),
            "warm_cache": True,
        }

    # -- the gossip daemon --------------------------------------------------

    def gossip_now(self) -> str:
        """One background convergence attempt (the daemon's body, also
        callable directly by tests and the scenario runner for
        deterministic cadence).  Returns the outcome counted into
        ``klba_gossip_rounds_total``: ``ok`` (cache refreshed),
        ``degraded`` (a peer was lost — the cache keeps its previous
        entry and ages), or ``idle`` (no shard registered / no peers
        yet — nothing to converge against)."""
        from ..ops import fedsolve

        with self._shard_lock:
            shard = self._shard
            C = int(shard["C"]) if shard is not None else None
        if C is None or not self._links:
            outcome = "idle"
        else:
            with metrics.span("federation.gossip"):
                conv = self._converge_duals(
                    fedsolve, C, self.local_epoch, self._fence_token(),
                    lambda: None, phase="gossip",
                )
            outcome = "ok" if conv is not None else "degraded"
        self._m_gossip[outcome].inc()
        self.last_gossip = {"outcome": outcome, "at": self._clock()}
        return outcome

    def _gossip_loop(self) -> None:
        # Jittered cadence (0.75x-1.25x the configured interval, from a
        # per-sidecar deterministic stream): peers started together must
        # not phase-lock their gossip rounds into synchronized RTT
        # bursts against each other.
        import random

        rng = random.Random(f"gossip:{self.self_id}")
        while not self._gossip_stop.is_set():
            wait_s = self.gossip_interval_s * (0.75 + 0.5 * rng.random())
            if self._gossip_stop.wait(wait_s):
                return
            try:
                self.gossip_now()
            except Exception:
                # The daemon must survive anything a round can throw
                # (the serve path never depends on it succeeding).
                LOGGER.warning("gossip round failed", exc_info=True)
                self._m_gossip["error"].inc()
                self.last_gossip = {
                    "outcome": "error", "at": self._clock()
                }

    # -- operator surface ---------------------------------------------------

    def status(self) -> Dict[str, Any]:
        """The wire ``federation`` method / ``stats.federation``
        section."""
        with self._cache_lock:
            cached = self._last_good
            cache_info = (
                {
                    "age_s": self._clock() - cached["at"],
                    "rounds": cached["rounds"],
                    "num_consumers": cached["C"],
                }
                if cached else None
            )
        peers = {}
        for pid, link in self._links.items():
            peers[pid] = {
                "address": f"{link.spec.host}:{link.spec.port}",
                "breaker": self._watchdog.state(f"peer:{pid}"),
                "last_outcome": link.last_outcome,
                "epoch_seen": link.max_epoch_seen,
                "fence_seen": link.max_fence_seen,
            }
        return {
            "self_id": self.self_id,
            "epoch": self.local_epoch,
            "rung": self.last_rung,
            "last_rounds": self.last_rounds,
            "max_rounds": self.max_rounds,
            "sync_timeout_s": self.sync_timeout_s,
            "max_staleness_s": self.max_staleness_s,
            "last_good": cache_info,
            "gossip": {
                "interval_s": self.gossip_interval_s,
                "freshness_s": self.gossip_freshness_s,
                "thread_alive": (
                    self._gossip_thread is not None
                    and self._gossip_thread.is_alive()
                ),
                "last": (
                    {
                        "outcome": self.last_gossip["outcome"],
                        "age_s": (
                            self._clock() - self.last_gossip["at"]
                        ),
                    }
                    if self.last_gossip is not None else None
                ),
            },
            "peers": peers,
        }

    # -- lifecycle snapshot (utils/snapshot) --------------------------------

    def export_state(self) -> Dict[str, Any]:
        """Host-durable federation state for the lifecycle snapshot:
        the monotone local epoch (it must survive restarts or peers
        would reject the replacement as stale), the per-peer ledger,
        and the last-good-global duals (age stored relative to the
        write so it rebases on load).  The snapshot save itself is
        fenced by the round-14 writer tokens, so a fenced-off
        predecessor cannot clobber the successor's federation state."""
        with self._cache_lock:
            cached = self._last_good
            cache = None
            if cached is not None:
                cap_frac = cached.get("cap_frac")
                cache = {
                    "A": [float(v) for v in cached["A"]],
                    "B": [float(v) for v in cached["B"]],
                    "scale": cached["scale"],
                    "base_load": [float(v) for v in cached["base_load"]],
                    "C": cached["C"],
                    "age_s": self._clock() - cached["at"],
                    "rounds": cached["rounds"],
                    "cap_frac": (
                        [float(v) for v in cap_frac]
                        if cap_frac is not None else None
                    ),
                }
        return {
            "epoch": self.local_epoch,
            "peer_epochs": {
                pid: link.max_epoch_seen
                for pid, link in self._links.items()
            },
            "peer_fences": {
                pid: link.max_fence_seen
                for pid, link in self._links.items()
            },
            "last_good": cache,
        }

    def restore_state(self, state: Dict[str, Any]) -> None:
        """Adopt exported federation state after a restart; malformed
        input is discarded whole (fail-open, like every recovery
        section)."""
        try:
            epoch = int(state.get("epoch", 0))
            cache = state.get("last_good")
            peer_epochs = dict(state.get("peer_epochs") or {})
            peer_fences = dict(state.get("peer_fences") or {})
        except (TypeError, ValueError, AttributeError):
            LOGGER.warning(
                "discarding malformed federation snapshot", exc_info=True
            )
            return
        self.local_epoch = max(self.local_epoch, epoch)
        for pid, link in self._links.items():
            try:
                if pid in peer_epochs:
                    link.max_epoch_seen = max(
                        link.max_epoch_seen, int(peer_epochs[pid])
                    )
                fence = peer_fences.get(pid)
                if fence is not None:
                    link.max_fence_seen = max(
                        int(fence), link.max_fence_seen or 0
                    )
            except (TypeError, ValueError):
                LOGGER.warning(
                    "discarding malformed peer ledger for %r", pid,
                    exc_info=True,
                )
        if cache is not None:
            try:
                C = int(cache["C"])
                restored = {
                    "A": np.asarray(cache["A"], np.float32),
                    "B": np.asarray(cache["B"], np.float32),
                    "scale": float(cache["scale"]),
                    "base_load": np.asarray(
                        cache["base_load"], np.float32
                    ),
                    "C": C,
                    "at": self._clock() - max(
                        float(cache.get("age_s", 0.0)), 0.0
                    ),
                    "rounds": int(cache.get("rounds", 0)),
                    "cap_frac": (
                        np.asarray(cache["cap_frac"], np.float64)
                        if cache.get("cap_frac") is not None else None
                    ),
                }
                cf = restored["cap_frac"]
                if cf is not None and cf.shape != (C,):
                    restored["cap_frac"] = None
                if (
                    restored["A"].shape == (C,)
                    and restored["B"].shape == (C,)
                    and restored["base_load"].shape == (C,)
                ):
                    with self._cache_lock:
                        self._last_good = restored
            except (TypeError, ValueError, KeyError):
                LOGGER.warning(
                    "discarding malformed last-good dual cache",
                    exc_info=True,
                )

    def close(self) -> None:
        self._gossip_stop.set()
        thread = self._gossip_thread
        if thread is not None and thread.is_alive():
            # Bounded join: a gossip round mid-RTT finishes within the
            # per-peer sync timeout; don't hang shutdown past it.
            thread.join(timeout=self.sync_timeout_s + 1.0)
        for link in self._links.values():
            link.close()
