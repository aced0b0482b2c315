"""Declarative degradation envelopes + their evaluator.

An envelope states how far the service may degrade under one
scenario's stress.  The non-negotiables default ON for every scenario
(zero invalid assignments, zero critical-class sheds, shed ordering
respected); the scenario-specific knobs bound churn, solution quality,
the worst ladder rung served, steady-state warm-loop compiles, and —
for corruption/restart drills — require the integrity plane to have
actually detected the planted corruption, or the post-restart epochs
to be bit-exact against the unfaulted twin.

Phase awareness: ``steady``-gated bounds (compiles, churn, latency)
evaluate only over epochs the trace tagged ``steady`` — warm-up and
declared transitions (a roster flap's recompile, a load step's churn)
are the scenario's point, not violations.

:func:`evaluate` returns a list of human-readable violation strings —
empty means the scenario passed.  The fleet runner aggregates these
into the CI artifact and its exit code.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

#: The degraded-mode ladder, ordered least -> most degraded
#: (service.py ``stream.degraded_rung``).
RUNG_ORDER = {
    "none": 0,
    "kept_previous": 1,
    "cold_device": 2,
    "host_snake": 3,
}

#: The MESH manager's documented degrade steps (sharded/mesh LADDER):
#: a ``mesh.collective`` fault walks a 2-D config
#: 2d -> streams -> p -> single one rung at a time; 1-D configs keep
#: the historical one-step drop.  Envelopes gate every observed
#: ``klba_mesh_degrade_total{from,to}`` transition against this set —
#: a skipped rung (2d -> single) or a re-armed jump (p -> 2d) is a
#: ladder violation even when every request was still served validly.
MESH_LADDER_STEPS = frozenset({
    ("2d", "streams"),
    ("streams", "p"),
    ("p", "single"),
    ("1d", "single"),
})


@dataclass(frozen=True)
class Envelope:
    """Per-scenario degradation bounds (``None`` disables a gate)."""

    # Non-negotiable: a served assignment must always be valid, and
    # the critical class must never shed, regardless of scenario.
    max_invalid: int = 0
    max_critical_sheds: int = 0
    # Shed ordering: in any epoch where ``standard`` shed, a lower
    # class must have shed too (critical is covered by the count gate).
    require_shed_ordering: bool = True
    # Worst ladder rung the scenario may serve, ever.
    max_rung: str = "host_snake"
    # Steady-phase bounds (warm/transition epochs excluded).
    max_steady_compiles: Optional[int] = 0
    max_steady_churn: Optional[float] = None
    max_quality_ratio: Optional[float] = None
    max_steady_p99_ms: Optional[float] = None
    # Wire-level request errors (ConnectionError / server error
    # responses) the scenario tolerates; sheds are counted apart.
    max_errors: int = 0
    # Corruption drills: the integrity plane must have detected (and
    # quarantined) at least this many planted corruptions.
    min_detected_corruptions: int = 0
    # Crash/restart drills: every compared epoch must be bit-exact
    # against the unfaulted, uninterrupted twin replay.
    require_bit_exact_recovery: bool = False
    # Anomaly-biased tail sampling (utils/trace): every record that
    # degraded — shed, served a rung below "none", or resynced — must
    # have its trace in the kept set (100% anomaly retention), while
    # healthy-trace retention stays near the configured sample rate
    # (bounded at rate * healthy + slack, so a sampler that silently
    # keeps everything fails the envelope too).
    require_anomaly_traces: bool = True
    healthy_trace_slack: int = 8
    # Cross-axis mesh drills: every mesh degrade transition observed
    # during the replay must be a documented one-rung ladder step
    # (:data:`MESH_LADDER_STEPS`), and at least ``min_mesh_degrades``
    # transitions must have been exercised (a fleet that silently
    # never entered a sharded dispatch would otherwise pass the
    # ladder gate vacuously).
    require_mesh_ladder: bool = False
    min_mesh_degrades: int = 0


def evaluate(result, envelope: Envelope) -> List[str]:
    """Check one :class:`..replay.ReplayResult` against its envelope."""
    v: List[str] = []
    recs = result.records
    steady = [r for r in recs if r.phase == "steady"]

    invalid = sum(1 for r in recs if r.ok and not r.valid)
    if invalid > envelope.max_invalid:
        v.append(
            f"invalid assignments: {invalid} > {envelope.max_invalid}"
        )

    crit_sheds = sum(
        1 for r in recs if r.shed and r.slo_class == "critical"
    )
    if crit_sheds > envelope.max_critical_sheds:
        v.append(
            f"critical-class sheds: {crit_sheds} > "
            f"{envelope.max_critical_sheds}"
        )

    if envelope.require_shed_ordering:
        by_epoch = {}
        for r in recs:
            by_epoch.setdefault(r.epoch, []).append(r)
        for epoch, rows in sorted(by_epoch.items()):
            classes_present = {r.slo_class for r in rows}
            shed_classes = {r.slo_class for r in rows if r.shed}
            if (
                "standard" in shed_classes
                and "best_effort" in classes_present
                and "best_effort" not in shed_classes
            ):
                v.append(
                    f"shed ordering violated at epoch {epoch}: "
                    "standard shed while best_effort served"
                )

    max_rung_seen = "none"
    for r in recs:
        if r.ok and RUNG_ORDER.get(r.rung, 0) > RUNG_ORDER[max_rung_seen]:
            max_rung_seen = r.rung
    if RUNG_ORDER[max_rung_seen] > RUNG_ORDER[envelope.max_rung]:
        v.append(
            f"degraded rung {max_rung_seen!r} exceeds envelope "
            f"{envelope.max_rung!r}"
        )

    if envelope.max_steady_compiles is not None:
        compiles = result.compiles_by_phase.get("steady", 0)
        if compiles > envelope.max_steady_compiles:
            v.append(
                f"steady-state warm-loop compiles: {compiles} > "
                f"{envelope.max_steady_compiles}"
            )

    if envelope.max_steady_churn is not None:
        worst = max(
            (r.churn for r in steady if r.ok and r.churn is not None),
            default=0.0,
        )
        if worst > envelope.max_steady_churn:
            v.append(
                f"steady-state churn {worst:.3f} > "
                f"{envelope.max_steady_churn}"
            )

    if envelope.max_quality_ratio is not None:
        worst_q = max(
            (
                r.quality_ratio for r in steady
                if r.ok and r.quality_ratio is not None
            ),
            default=0.0,
        )
        if worst_q > envelope.max_quality_ratio:
            v.append(
                f"steady-state quality ratio {worst_q:.3f} > "
                f"{envelope.max_quality_ratio}"
            )

    if envelope.max_steady_p99_ms is not None:
        lats = sorted(
            r.latency_ms for r in steady
            if r.ok and r.latency_ms is not None
        )
        if lats:
            p99 = lats[min(len(lats) - 1, int(len(lats) * 0.99))]
            if p99 > envelope.max_steady_p99_ms:
                v.append(
                    f"steady-state p99 {p99:.1f}ms > "
                    f"{envelope.max_steady_p99_ms}ms"
                )

    errors = sum(1 for r in recs if not r.ok and not r.shed)
    if errors > envelope.max_errors:
        v.append(f"request errors: {errors} > {envelope.max_errors}")

    if envelope.min_detected_corruptions > 0:
        if result.quarantines < envelope.min_detected_corruptions:
            v.append(
                "integrity plane detected "
                f"{result.quarantines} corruption(s) < "
                f"{envelope.min_detected_corruptions} required "
                f"(planted: {result.corruptions_planted})"
            )

    if envelope.require_bit_exact_recovery:
        if result.twin_mismatches is None:
            v.append(
                "bit-exact recovery required but no twin comparison "
                "was recorded"
            )
        elif result.twin_mismatches > 0:
            v.append(
                f"{result.twin_mismatches} epoch(s) diverged from the "
                "unfaulted twin after recovery"
            )

    if envelope.require_mesh_ladder:
        degrades = getattr(result, "mesh_degrades", {}) or {}
        total = 0
        for key, count in sorted(degrades.items()):
            frm, _, to = key.partition("->")
            total += int(count)
            if (frm, to) not in MESH_LADDER_STEPS:
                v.append(
                    f"mesh degrade {frm!r} -> {to!r} (x{count}) is not "
                    "a documented one-rung ladder step"
                )
        if total < envelope.min_mesh_degrades:
            v.append(
                f"mesh ladder exercised {total} degrade(s) < "
                f"{envelope.min_mesh_degrades} required"
            )

    if envelope.require_anomaly_traces:
        kept = set(result.kept_trace_ids)
        anomalous = [
            r for r in recs
            if r.shed is not None or r.resync
            or (r.ok and RUNG_ORDER.get(r.rung, 0) > 0)
        ]
        missing = sorted({
            r.trace_id for r in anomalous
            if r.trace_id is not None and r.trace_id not in kept
        })
        unstamped = sum(1 for r in anomalous if r.trace_id is None)
        if missing:
            v.append(
                f"{len(missing)} anomalous trace(s) not retained by "
                f"the tail sampler (e.g. {missing[0]})"
            )
        if unstamped:
            v.append(
                f"{unstamped} anomalous record(s) carried no trace id"
            )
        stats = result.trace_stats or {}
        rate = stats.get("sample_rate")
        if rate is not None and rate < 0.5:
            # Healthy retention must track the configured rate: the
            # 0.5x coefficient is deliberately loose (the hash keep is
            # binomial) while still failing a sampler that keeps all.
            healthy = (
                int(stats.get("kept_sampled", 0))
                + int(stats.get("dropped", 0))
            )
            bound = 0.5 * healthy + envelope.healthy_trace_slack
            if stats.get("kept_sampled", 0) > bound:
                v.append(
                    "healthy-trace retention "
                    f"{stats.get('kept_sampled')} of {healthy} exceeds "
                    f"the rate-{rate} envelope bound {bound:.0f}"
                )
    return v
