"""The scenario catalog + fleet runner.

Each :class:`Scenario` binds a trace generator (by NAME — a CI
artifact's ``(trace, seed)`` pair is always reproducible via
``traces.generate``), a set of fault planes, the service knobs, and
its degradation envelope.  ``fast=True`` marks the CI subset; the
full corpus runs through ``python -m`` this package and in
``chip_smoke.py --scenarios`` on the card.  The catalog is the JAX
package's ``scenarios/corpus.py`` entry for entry (the tests hold the
two field for field).

The catalog (see DEPLOYMENT.md "Adversarial scenarios" for the prose
table): clean adversarial workloads gate the steady-state contract
(zero invalid, zero warm-loop compiles, bounded churn); composed-fault
scenarios gate the degradation ladder (never invalid, critical never
shed, bounded rung); the corruption scenario gates the integrity
plane's DETECTION (planted flips must be quarantined); the restart
scenario gates bit-exact recovery against an unfaulted twin.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils.device import DeviceLike
from . import compose
from .envelopes import Envelope, evaluate
from .replay import ReplayResult, mesh_shards, replay, twin_mismatches
from .traces import generate


@dataclass(frozen=True)
class Scenario:
    """One catalog entry: trace x planes x service knobs x envelope."""

    name: str
    trace: str                      # traces.GENERATORS key
    seed: int
    envelope: Envelope
    planes: Tuple[compose.FaultPlane, ...] = ()
    trace_knobs: Dict[str, Any] = field(default_factory=dict)
    service_kwargs: Dict[str, Any] = field(default_factory=dict)
    crash_epoch: Optional[int] = None
    parallel: bool = False
    fast: bool = True
    tune: Optional[Callable] = None
    epoch_sleep_s: float = 0.0
    # Wire-level ``options`` object sent with EVERY stream_assign of
    # the replay (e.g. ``{"refine_threshold": None}`` to force a warm
    # dispatch every epoch — scenarios that need deterministic wave
    # membership in the coalescer use this).
    request_options: Optional[Dict[str, Any]] = None
    # Federated scenarios replay through the two-sidecar engine
    # (scenarios/federated.py) and gate the federation ladder instead
    # of the stream envelope.
    federated: bool = False
    summary: str = ""


def _zero_eval_interval(svc) -> None:
    svc._overload.eval_interval_s = 0.0


#: Exhaustive catalog.  Composed-fault scenarios (>= 2 planes, or a
#: plane + crash): skew_storm_faulted, wave_corruption,
#: step_snapshot_flake, churn_restart.
CORPUS: Tuple[Scenario, ...] = (
    Scenario(
        name="skew_storm",
        trace="hot_skew_storm", seed=1101,
        envelope=Envelope(
            max_rung="none", max_steady_compiles=0,
            max_steady_churn=0.75,
        ),
        summary="recurring hot-partition storms, clean sidecar",
    ),
    Scenario(
        name="skew_storm_faulted",
        trace="hot_skew_storm", seed=1102,
        planes=(
            compose.solver_flake(epochs=(4,)),
            compose.wire_latency(epochs=(3, 5), delay_s=0.02),
        ),
        envelope=Envelope(
            max_rung="host_snake", max_steady_compiles=None,
        ),
        summary="storms + refine dispatch raise + slow wire reads",
    ),
    Scenario(
        name="lag_wave",
        trace="lag_wave_multi", seed=1103,
        envelope=Envelope(
            max_rung="none", max_steady_compiles=0,
        ),
        summary="correlated multi-topic lag wave, clean sidecar",
    ),
    Scenario(
        name="wave_corruption",
        trace="lag_wave_multi", seed=1104,
        planes=(
            compose.corruption(("choice", "row_tab"), epochs=(4, 6)),
            compose.wire_latency(epochs=(5,), delay_s=0.01),
        ),
        envelope=Envelope(
            max_rung="host_snake", max_steady_compiles=None,
            min_detected_corruptions=1,
        ),
        summary=(
            "lag wave + planted device bit flips (choice, row table) "
            "— the integrity plane must detect and quarantine"
        ),
    ),
    Scenario(
        name="diurnal",
        trace="diurnal_ramp", seed=1105,
        envelope=Envelope(
            max_rung="none", max_steady_compiles=0,
            max_steady_churn=0.6,
        ),
        summary="smooth diurnal load ramp, clean sidecar",
    ),
    Scenario(
        name="step_snapshot_flake",
        trace="step_load", seed=1106,
        planes=(
            compose.snapshot_flake(epochs=(6, 7, 8, 9)),
            compose.backend_slow(epochs=(6, 7, 8, 9), delay_s=0.02),
        ),
        service_kwargs={
            "snapshot_path": "auto", "snapshot_interval_s": 0.05,
        },
        epoch_sleep_s=0.03,
        envelope=Envelope(
            max_rung="none", max_steady_compiles=0,
        ),
        summary=(
            "8x load step while snapshot writes fail on a slow "
            "backend — serving must continue fail-open"
        ),
    ),
    Scenario(
        name="churn_restart",
        trace="lag_wave_multi", seed=1107,
        planes=(compose.delta_flake(epochs=(2, 3)),),
        crash_epoch=5,
        envelope=Envelope(
            max_rung="host_snake", max_steady_compiles=None,
            require_bit_exact_recovery=True,
        ),
        summary=(
            "delta-path faults, then a mid-trace crash/restart — "
            "recovered epochs must be bit-exact vs the unfaulted twin"
        ),
    ),
    Scenario(
        name="peer_partition",
        trace="lag_wave_multi", seed=1112,
        trace_knobs={"epochs": 13},
        federated=True,
        planes=(
            compose.peer_partition(epochs=(4, 5, 6, 7, 8, 9)),
        ),
        envelope=Envelope(
            max_rung="host_snake", max_steady_compiles=None,
            require_anomaly_traces=False,
        ),
        summary=(
            "gossip links severed mid-trace, then healed — the "
            "federated ladder must degrade global -> "
            "last_good_global -> local_only as the dual cache ages "
            "out, and recover to warm-cache global after the heal"
        ),
    ),
    Scenario(
        name="zipf_overload_shed",
        trace="zipf_tenants", seed=1108,
        trace_knobs={"tenants": 8, "epochs": 8},
        service_kwargs={
            "slo_deadline_s": {"critical": 5.0},
            "overload_depth_high": 4.0,
            "coalesce_window_ms": 2.0,
            "coalesce_max_batch": 2,
            "coalesce_lock_waves": 1 << 30,
        },
        parallel=True,
        tune=_zero_eval_interval,
        envelope=Envelope(
            max_rung="host_snake", max_steady_compiles=None,
            require_shed_ordering=True,
        ),
        summary=(
            "zipf tenant stampede with mixed SLO classes on an "
            "undersized coalescer — sheds must land bottom-up, "
            "critical never"
        ),
    ),
    Scenario(
        name="large_tenant_2d",
        trace="zipf_tenants", seed=1113,
        trace_knobs={"tenants": 8, "epochs": 8},
        planes=(
            compose.mesh_collective(epochs=(4, 6)),
        ),
        service_kwargs={
            "mesh_devices": "auto",
            "mesh_shape": "2x4",
            "mesh_solve_min_rows": 128,
            # Wide enough that all 8 tenants of one epoch ride ONE
            # coalesced wave (the wave locks after 1 round and every
            # later epoch hits the locked sharded dispatch boundary —
            # where the injected collective faults are consumed).
            "coalesce_window_ms": 50.0,
            "coalesce_max_batch": 8,
            "coalesce_lock_waves": 1,
        },
        parallel=True,
        # Refine every epoch: stable 8-row wave membership keeps the
        # coalescer's roster locked, so the fault epochs land on the
        # locked sharded dispatch boundary deterministically.
        request_options={"refine_threshold": None},
        envelope=Envelope(
            max_rung="host_snake", max_steady_compiles=None,
            require_mesh_ladder=True, min_mesh_degrades=2,
        ),
        summary=(
            "zipf tenant mix on the 2-D ('streams','p') mesh — the "
            "dominant tenant's rows are P-sharded, the locked "
            "megabatch spreads over the full grid, and injected "
            "mesh.collective faults must walk the documented ladder "
            "(2d -> streams -> p) one rung at a time, never serving "
            "an invalid assignment"
        ),
    ),
    Scenario(
        name="flapping_roster",
        trace="flapping_consumers", seed=1109,
        fast=False,
        envelope=Envelope(
            max_rung="none", max_steady_compiles=0,
        ),
        summary=(
            "consumer roster flaps (C-1/C+1) — cold chains confined "
            "to declared transition epochs"
        ),
    ),
    Scenario(
        name="storm_breaker",
        trace="hot_skew_storm", seed=1110,
        trace_knobs={"epochs": 12},
        planes=(
            compose.refine_hang(epochs=(4, 5, 6), delay_s=0.2),
        ),
        service_kwargs={
            "breaker_cooldown_s": 0.2, "breaker_failures": 3,
        },
        fast=False,
        envelope=Envelope(
            max_rung="host_snake", max_steady_compiles=None,
        ),
        summary=(
            "three consecutive wedged warm dispatches trip the "
            "stream breaker; the ladder serves through the cooldown"
        ),
    ),
)


def get_scenario(name: str) -> Scenario:
    for sc in CORPUS:
        if sc.name == name:
            return sc
    raise KeyError(
        f"unknown scenario {name!r}; valid: {[s.name for s in CORPUS]}"
    )


def run_scenario(
    sc: Scenario, seed: Optional[int] = None, device: DeviceLike = None,
) -> Dict[str, Any]:
    """Replay one scenario (plus its clean twin when the envelope
    demands bit-exact recovery) on sidecars on ``device`` (None = the
    card) and evaluate the envelope; returns the JSON-ready result row
    carrying everything needed to reproduce."""
    seed = sc.seed if seed is None else seed
    if sc.federated:
        from .federated import replay_federated

        return replay_federated(sc, seed, device=device)
    trace = generate(sc.trace, seed, **sc.trace_knobs)
    injector = (
        compose.build_injector(sc.planes, seed=seed)
        if sc.planes else None
    )
    with mesh_shards(sc.service_kwargs, device):
        result = replay(
            trace,
            injector=injector,
            service_kwargs=dict(sc.service_kwargs),
            crash_epoch=sc.crash_epoch,
            parallel=sc.parallel,
            tune=sc.tune,
            epoch_sleep_s=sc.epoch_sleep_s,
            request_options=sc.request_options,
            device=device,
        )
        if sc.envelope.require_bit_exact_recovery:
            twin = replay(
                trace,
                service_kwargs={
                    k: v for k, v in sc.service_kwargs.items()
                    if k != "snapshot_path"
                },
                parallel=sc.parallel,
                tune=sc.tune,
                device=device,
            )
            result.twin_mismatches = twin_mismatches(result, twin)
    violations = evaluate(result, sc.envelope)
    return {
        "scenario": sc.name,
        "trace": sc.trace,
        "seed": seed,
        "trace_sha256": result.trace_sha256,
        "fast": sc.fast,
        "planes": [p.name for p in sc.planes],
        "crash_epoch": sc.crash_epoch,
        "epochs": len(trace.epochs),
        "streams": len(trace.stream_ids),
        "partitions": trace.partitions,
        "wall_s": round(result.wall_s, 3),
        "records": len(result.records),
        "served": sum(1 for r in result.records if r.ok),
        "sheds": sum(1 for r in result.records if r.shed),
        "errors": sum(
            1 for r in result.records if not r.ok and not r.shed
        ),
        "invalid": sum(
            1 for r in result.records if r.ok and not r.valid
        ),
        "compiles_by_phase": result.compiles_by_phase,
        "sheds_by_class": result.sheds_by_class,
        "quarantines": result.quarantines,
        "corruptions_planted": result.corruptions_planted,
        "faults": result.faults_snapshot,
        "mesh_degrades": result.mesh_degrades,
        "restarted_at": result.restarted_at,
        "recovery": result.recovery,
        "twin_mismatches": result.twin_mismatches,
        "trace_stats": result.trace_stats,
        "anomalous_trace_ids": sorted({
            r.trace_id for r in result.records
            if r.trace_id is not None and (
                r.shed is not None or r.resync or r.rung != "none"
            )
        }),
        "violations": violations,
        "reproduce": (
            f"python -m {__package__} --only {sc.name} --seed {seed}"
        ),
    }


def run_fleet(
    *, fast_only: bool = False, only: Optional[List[str]] = None,
    seed: Optional[int] = None, log=None, device: DeviceLike = None,
) -> Dict[str, Any]:
    """Run the (sub)fleet on sidecars on ``device`` (None = the card);
    returns the artifact dict ``python -m`` this package writes (the
    JAX fleet's layout).  ``ok`` is False iff any scenario violated its
    envelope."""
    picked = [
        sc for sc in CORPUS
        if (not fast_only or sc.fast)
        and (only is None or sc.name in only)
    ]
    if only:
        unknown = set(only) - {sc.name for sc in picked}
        if unknown:
            raise KeyError(
                f"unknown scenario(s) {sorted(unknown)}; valid: "
                f"{[s.name for s in CORPUS]}"
            )
    rows = []
    for sc in picked:
        if log is not None:
            log(f"scenario {sc.name} (trace={sc.trace}, "
                f"seed={seed if seed is not None else sc.seed}) ...")
        row = run_scenario(sc, seed=seed, device=device)
        if log is not None:
            status = (
                "ok" if not row["violations"]
                else f"FAIL: {'; '.join(row['violations'])}"
            )
            log(f"  {row['wall_s']:.1f}s served={row['served']} "
                f"sheds={row['sheds']} -> {status}")
        rows.append(row)
    return {
        "fleet": "scenario_fleet",
        "fast_only": fast_only,
        "scenarios": rows,
        "violations": sum(len(r["violations"]) for r in rows),
        "ok": all(not r["violations"] for r in rows),
    }
