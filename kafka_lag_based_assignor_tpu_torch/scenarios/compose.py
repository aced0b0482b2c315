"""The fault-schedule composer: declarative planes -> ONE injector.

A *fault plane* is a named, declarative bundle of fault events — each
event pins a ``utils/faults`` point to exact trace epochs via the
injector's exact-schedule API (:meth:`..utils.faults.FaultInjector.
schedule`).  Scenarios compose several planes (a device flake plane
over a wire-latency plane over a corruption plane) and
:func:`build_injector` overlays them into one
:class:`..utils.faults.FaultInjector` the replay engine activates and
clocks (``set_epoch``) in lockstep with the trace.

Overlay semantics: two planes scheduling the SAME point merge — epoch
sets union, ``per_epoch`` takes the max, and the modes must agree (a
point cannot both raise and inject latency; that would make the drill
depend on plane order, which is exactly the nondeterminism this module
exists to exclude).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Sequence, Tuple

from ..utils import faults


@dataclass(frozen=True)
class FaultEvent:
    """One point's schedule inside a plane: fire ``per_epoch`` times in
    each listed trace epoch (``per_epoch`` <= 0 = every eligible
    call)."""

    point: str
    epochs: Tuple[int, ...]
    mode: str = "raise"
    per_epoch: int = 1
    delay_s: float = 0.05


@dataclass(frozen=True)
class FaultPlane:
    """A named bundle of fault events composed as one unit."""

    name: str
    events: Tuple[FaultEvent, ...] = field(default_factory=tuple)


def build_injector(
    planes: Sequence[FaultPlane], seed: int = 0
) -> faults.FaultInjector:
    """Overlay ``planes`` into one exact-schedule injector.

    The seed only matters for corruption points (``device.corrupt.*``
    pick the flipped element/bit from it) — scheduled plans have no
    probability coin, so everything else is seed-independent."""
    merged: Dict[str, FaultEvent] = {}
    for plane in planes:
        for ev in plane.events:
            prior = merged.get(ev.point)
            if prior is None:
                merged[ev.point] = ev
                continue
            if prior.mode != ev.mode:
                raise ValueError(
                    f"plane {plane.name!r} schedules {ev.point!r} as "
                    f"{ev.mode!r} but an earlier plane scheduled it as "
                    f"{prior.mode!r} — merged points must agree on mode"
                )
            merged[ev.point] = FaultEvent(
                point=ev.point,
                epochs=tuple(sorted(set(prior.epochs) | set(ev.epochs))),
                mode=ev.mode,
                per_epoch=max(prior.per_epoch, ev.per_epoch),
                delay_s=max(prior.delay_s, ev.delay_s),
            )
    inj = faults.FaultInjector(seed=seed)
    for ev in merged.values():
        inj.schedule(
            ev.point, mode=ev.mode, at_epochs=ev.epochs,
            per_epoch=ev.per_epoch, delay_s=ev.delay_s,
        )
    return inj


# --- The plane catalog ---------------------------------------------------
# Factories, not constants: a scenario picks WHICH epochs each plane
# hits, so the same plane composes with traces of different lengths.


def solver_flake(epochs: Sequence[int], per_epoch: int = 1) -> FaultPlane:
    """The warm engine's refine dispatch raises — the ladder must
    answer down a degraded rung, never an invalid assignment."""
    return FaultPlane("solver_flake", (
        FaultEvent("stream.refine", tuple(epochs), per_epoch=per_epoch),
    ))


def wire_latency(
    epochs: Sequence[int], delay_s: float = 0.02, per_epoch: int = 2
) -> FaultPlane:
    """Slow socket reads on the sidecar's line protocol."""
    return FaultPlane("wire_latency", (
        FaultEvent(
            "wire.read", tuple(epochs), mode="latency",
            per_epoch=per_epoch, delay_s=delay_s,
        ),
    ))


def corruption(
    buffers: Sequence[str], epochs: Sequence[int], per_epoch: int = 1
) -> FaultPlane:
    """Seeded bit flips into the named device-resident buffers
    (``choice`` | ``counts`` | ``lags`` | ``row_tab``) at adoption
    boundaries — the integrity plane must detect, quarantine, heal."""
    return FaultPlane("corruption", tuple(
        FaultEvent(
            f"device.corrupt.{buf}", tuple(epochs), per_epoch=per_epoch,
        )
        for buf in buffers
    ))


def refine_hang(
    epochs: Sequence[int], delay_s: float = 0.2, per_epoch: int = 1
) -> FaultPlane:
    """A wedged warm dispatch (bounded hang then failure) — feeds the
    per-solver breaker; repeated epochs can trip it."""
    return FaultPlane("refine_hang", (
        FaultEvent(
            "stream.refine", tuple(epochs), mode="hang",
            per_epoch=per_epoch, delay_s=delay_s,
        ),
    ))


def delta_flake(epochs: Sequence[int], per_epoch: int = 1) -> FaultPlane:
    """The host-side lag differ raises — the contract is an
    answer-preserving fallback to the dense upload within the same
    epoch (warm state intact), so this plane composes with bit-exact
    twin envelopes."""
    return FaultPlane("delta_flake", (
        FaultEvent("delta.diff", tuple(epochs), per_epoch=per_epoch),
    ))


def snapshot_flake(epochs: Sequence[int], per_epoch: int = 0) -> FaultPlane:
    """Snapshot writes fail — the fail-open contract: serving
    continues, errors counted, previous snapshot survives."""
    return FaultPlane("snapshot_flake", (
        FaultEvent("snapshot.write", tuple(epochs), per_epoch=per_epoch),
    ))


def backend_slow(
    epochs: Sequence[int], delay_s: float = 0.05, per_epoch: int = 0
) -> FaultPlane:
    """A slow snapshot-backend link (latency mode: operations proceed
    after the delay)."""
    return FaultPlane("backend_slow", (
        FaultEvent(
            "backend.latency", tuple(epochs), mode="latency",
            per_epoch=per_epoch, delay_s=delay_s,
        ),
    ))


def peer_partition(epochs: Sequence[int]) -> FaultPlane:
    """Sever every gossip/exchange link for the listed trace epochs
    (``per_epoch=0``: EVERY peer RPC in the window fails, the full
    partition shape) — the federated ladder must degrade
    global -> last_good_global -> local_only as the dual cache ages
    out, and recover to rung global after the heal."""
    return FaultPlane("peer_partition", (
        FaultEvent("peer.partition", tuple(epochs), per_epoch=0),
    ))


def mesh_collective(
    epochs: Sequence[int], per_epoch: int = 1
) -> FaultPlane:
    """A sharded dispatch loses a collective (the ``mesh.collective``
    point fires at every sharded entry: the P-sharded solve, the
    resident placement, the locked 2-D megabatch flush).  Each firing
    steps the mesh manager exactly ONE rung down the documented ladder
    (2-D -> streams -> p -> single); the faulted request itself
    resolves through the single-device fallback inside its own budget
    — never an invalid assignment."""
    return FaultPlane("mesh_collective", (
        FaultEvent(
            "mesh.collective", tuple(epochs), per_epoch=per_epoch,
        ),
    ))


def shed_flake(epochs: Sequence[int], per_epoch: int = 1) -> FaultPlane:
    """The overload controller's admission decision itself faults —
    the service must FAIL OPEN (admit) rather than shed on an error."""
    return FaultPlane("shed_flake", (
        FaultEvent("shed.decide", tuple(epochs), per_epoch=per_epoch),
    ))
