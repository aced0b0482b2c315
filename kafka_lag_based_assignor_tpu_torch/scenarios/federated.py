"""The federated replay engine: two real sidecars, a severed link.

The single-sidecar engine (:mod:`.replay`) drives ``stream_assign``;
the federated ladder needs a PEER, so this module boots two in-process
:class:`..service.AssignorService` sidecars federated with each other
and drives ``federated_assign`` on sidecar *a* through a trace's lag
evolution while the composed ``peer_partition`` plane severs and heals
the link mid-trace (``injector.set_epoch`` in lockstep, exactly like
the stream engine).

Determinism is handled the same way the traces pin workloads: the
gossip daemon's THREAD never runs here — the runner calls
``gossip_now()`` itself once per epoch (the daemon's exact body), and
sidecar *a*'s federation clock is replaced with an epoch-counting fake
so the freshness/staleness windows are measured in epochs, not wall
time.  The expected ladder is then a pure function of the sever window
and the two windows:

- cache age <= ``gossip_freshness`` epochs  -> rung ``global`` served
  from the warm gossip cache (one local round, no peer RTT);
- then, while the partition holds, age <= ``max_staleness`` epochs ->
  ``last_good_global``;
- then ``local_only`` — today's single-cluster solve, fail-open;
- after the heal (one breaker-recovery epoch of grace), gossip
  refreshes the cache and rung ``global`` returns.

:func:`evaluate_ladder` gates that envelope; violations feed the same
fleet artifact as every other scenario.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from ..service import AssignorService, AssignorServiceClient
from ..utils import faults
from ..utils.device import DeviceLike

from . import compose
from .traces import generate

#: The federated degradation ladder, best -> worst
#: (federated/peers.FEDERATION_RUNGS, as an order map).
FEDERATION_RUNG_ORDER = {
    "global": 0, "last_good_global": 1, "local_only": 2,
}

#: Freshness/staleness windows in EPOCHS (the fake clock's unit).
GOSSIP_FRESHNESS_EPOCHS = 1.5
MAX_STALENESS_EPOCHS = 4.0

#: Epochs of grace after the heal before rung ``global`` is required
#: again (the severed peer's breaker needs one half-open probe).
HEAL_GRACE_EPOCHS = 1


def _sever_window(sc) -> List[int]:
    """The peer_partition plane's epoch set (sorted)."""
    epochs: List[int] = []
    for plane in sc.planes:
        for ev in plane.events:
            if ev.point == "peer.partition":
                epochs.extend(ev.epochs)
    if not epochs:
        raise ValueError(
            f"federated scenario {sc.name!r} has no peer.partition plane"
        )
    return sorted(set(epochs))


def _balanced(assignments: Dict[str, Any], members) -> bool:
    sizes = [len(assignments.get(m, [])) for m in members]
    return max(sizes) - min(sizes) <= 1


def replay_federated(
    sc, seed: int, client_timeout_s: float = 300.0,
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """Drive one federated scenario on two sidecars on ``device`` (None =
    the card); returns the fleet row."""
    trace = generate(sc.trace, seed, **sc.trace_knobs)
    sever = _sever_window(sc)
    injector = compose.build_injector(sc.planes, seed=seed)

    import socket

    socks = [socket.socket(), socket.socket()]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    ids = ("a", "b")
    svcs = []
    for i in range(2):
        j = 1 - i
        svcs.append(AssignorService(
            port=ports[i],
            coalesce_max_batch=1,
            scrub_interval_ms=0,
            breaker_failures=2,
            breaker_cooldown_s=0.01,
            slo_deadline_s={"best_effort": 30.0},
            federation_self_id=ids[i],
            federation_peers=f"{ids[j]}=127.0.0.1:{ports[j]}",
            federation_rounds=8,
            federation_sync_timeout_s=60.0,
            device=device,
            **dict(sc.service_kwargs),
        ).start())
    clients = [
        AssignorServiceClient("127.0.0.1", p, timeout_s=client_timeout_s)
        for p in ports
    ]

    # Sidecar a's federation plane on the epoch clock: windows in
    # epochs, gossip serving enabled, cadence driven BY the runner.
    epoch_clock = [0.0]
    fed = svcs[0]._federation
    fed._clock = lambda: epoch_clock[0]
    fed.gossip_interval_s = 1.0
    fed.gossip_freshness_s = GOSSIP_FRESHNESS_EPOCHS
    fed.max_staleness_s = MAX_STALENESS_EPOCHS

    members = list(trace.epochs[0].streams[0].members)
    topic = trace.epochs[0].streams[0].topic
    records: List[Dict[str, Any]] = []
    started = time.perf_counter()
    faults.activate(injector)
    try:
        # Boot both shards BEFORE the drive, like a live mesh where
        # both sidecars serve: b registers its local view, then a's
        # first (synchronous) exchange converges and seeds the dual
        # cache the gossip ticks keep warm from here on.
        b_lags = trace.epochs[0].streams[0].lags
        clients[1].federated_assign(
            topic, [[i, v] for i, v in enumerate(b_lags)], members
        )
        a_lags = trace.epochs[0].streams[0].lags
        clients[0].federated_assign(
            topic, [[i, v] for i, v in enumerate(a_lags)], members
        )
        for ev in trace.epochs:
            injector.set_epoch(ev.index)
            epoch_clock[0] = float(ev.index)
            gossip_outcome = fed.gossip_now()
            se = ev.streams[0]
            rec: Dict[str, Any] = {
                "epoch": ev.index,
                "severed": ev.index in sever,
                "gossip": gossip_outcome,
                "ok": False,
            }
            try:
                r = clients[0].federated_assign(
                    topic, [[i, v] for i, v in enumerate(se.lags)],
                    members,
                )
                rec["ok"] = True
                rec["rung"] = r["federation"]["rung"]
                rec["warm_cache"] = bool(
                    r["federation"].get("warm_cache", False)
                )
                rec["staleness_s"] = r["federation"]["staleness_s"]
                rec["balanced"] = _balanced(r["assignments"], members)
            except (ConnectionError, RuntimeError) as exc:
                rec["error"] = f"{type(exc).__name__}: {exc}"
            records.append(rec)
    finally:
        wall_s = time.perf_counter() - started
        faults.deactivate()
        for c in clients:
            c.close()
        for s in svcs:
            s.stop()

    violations = evaluate_ladder(records, sever)
    return {
        "scenario": sc.name,
        "trace": sc.trace,
        "seed": seed,
        "trace_sha256": trace.digest(),
        "fast": sc.fast,
        "planes": [p.name for p in sc.planes],
        "crash_epoch": None,
        "epochs": len(trace.epochs),
        "streams": 1,
        "partitions": trace.partitions,
        "wall_s": round(wall_s, 3),
        "records": len(records),
        "served": sum(1 for r in records if r["ok"]),
        "sheds": 0,
        "errors": sum(1 for r in records if not r["ok"]),
        "invalid": sum(
            1 for r in records if r["ok"] and not r["balanced"]
        ),
        "federation_ladder": [
            {k: r.get(k) for k in
             ("epoch", "severed", "gossip", "rung", "warm_cache")}
            for r in records
        ],
        "violations": violations,
        "reproduce": (
            f"python -m {__package__} --only {sc.name} --seed {seed}"
        ),
    }


def evaluate_ladder(
    records: List[Dict[str, Any]], sever: List[int]
) -> List[str]:
    """The federated degradation envelope (module docstring)."""
    v: List[str] = []
    sever_set = set(sever)
    heal_at = max(sever) + 1

    errors = [r for r in records if not r["ok"]]
    if errors:
        v.append(
            f"{len(errors)} federated_assign error(s) — the ladder "
            f"must fail open (first: {errors[0].get('error')})"
        )
        return v
    unbalanced = [r for r in records if not r["balanced"]]
    if unbalanced:
        v.append(
            f"{len(unbalanced)} epoch(s) served a count-unbalanced "
            "assignment"
        )

    rungs_in_window: List[str] = []
    prev_order = 0
    for r in records:
        e, rung = r["epoch"], r["rung"]
        order = FEDERATION_RUNG_ORDER.get(rung)
        if order is None:
            v.append(f"epoch {e}: unknown federation rung {rung!r}")
            continue
        if e < min(sever):
            if rung != "global":
                v.append(
                    f"epoch {e} (link up, warm gossip): rung {rung!r} "
                    "!= 'global'"
                )
            elif not r["warm_cache"]:
                v.append(
                    f"epoch {e}: rung global paid a synchronous "
                    "exchange despite a warm gossip cache"
                )
        elif e in sever_set:
            rungs_in_window.append(rung)
            if order < prev_order:
                v.append(
                    f"epoch {e}: rung climbed back to {rung!r} while "
                    "the link was still severed"
                )
            prev_order = order
        elif e >= heal_at + HEAL_GRACE_EPOCHS:
            if rung != "global":
                v.append(
                    f"epoch {e} (post-heal): rung {rung!r} never "
                    "recovered to 'global'"
                )
    if "last_good_global" not in rungs_in_window:
        v.append(
            "the sever window never served 'last_good_global' — the "
            "middle rung (bounded-staleness dual cache) did not engage"
        )
    if "local_only" not in rungs_in_window:
        v.append(
            "the sever window never degraded to 'local_only' — the "
            "staleness fence did not expire the dual cache"
        )
    return v
