"""Deterministic adversarial workload traces.

The JAX fleet's generators (``scenarios/traces.py``), copied: every
generator gives the same bytes and digest (``tests/test_torch_scenarios.py``
pins the golden digests and holds each generator to the JAX one).  The
comments below speak of the JAX package's XLA compiles; the port's
zero-steady gate counts kernel builds instead.

A trace is a typed, immutable event stream: per epoch, the set of live
streams and — for each — its dense lag vector, consumer roster, and SLO
class, plus a *phase tag* (``warm`` | ``steady`` | ``transition``) that
tells the envelope evaluator which epochs are fair game for
steady-state gates (zero warm-loop compiles, churn bounds) and which
are expected to pay cold/transition costs (a roster flap recompiles; a
load step may churn).

Determinism is the whole contract: every generator is a pure function
of ``(seed, knobs)`` through one :func:`numpy.random.default_rng`
stream, so ``(scenario name, seed)`` in a CI artifact reproduces the
exact byte-identical workload locally (:func:`trace_digest` pins this
in tests/test_scenarios.py and tests/test_torch_scenarios.py).  Lag
magnitudes stay inside int32 — the wire payload dtype every epoch must
share, or a mid-trace range flip
would retrace the fused executable and fail the zero-compile gate for
the wrong reason.

Generators (the catalog dimension — scenarios/corpus.py composes these
with fault planes and envelopes):

``hot_skew_storm``      recurring hot-partition storms: a rotating
                        small set of partitions spikes ~64x over a
                        uniform floor
``flapping_consumers``  the consumer roster flaps (C-1 / C+1 joins
                        and leaves) while lags drift — each flap is a
                        cold-chain transition epoch
``lag_wave_multi``      a correlated lag wave sweeping across the
                        partition index of several topics at once
                        (the multi-tenant incident shape)
``zipf_tenants``        many tenants with zipf-ranked load scales and
                        a mixed SLO-class roster — the overload/shed
                        workload
``diurnal_ramp``        a smooth multiplicative daily ramp up and back
                        down (capacity-planning shape; recommend gate)
``step_load``           an abrupt sustained load step (topic backfill
                        / replay shape)
"""

from __future__ import annotations

import hashlib
import json
import math
from dataclasses import asdict, dataclass, field
from typing import Callable, Dict, Tuple

import numpy as np

#: Phase tags (the envelope evaluator's epoch filter).
PHASES = ("warm", "steady", "transition")

# int32-safe lag ceiling: every epoch's payload must share the int32
# wire dtype (see bench config9 — a range flip retraces the executable).
_LAG_CAP = 2**31 - 2


@dataclass(frozen=True)
class StreamEpoch:
    """One stream's demand at one epoch."""

    stream_id: str
    topic: str
    members: Tuple[str, ...]
    lags: Tuple[int, ...]
    slo_class: str = "standard"


@dataclass(frozen=True)
class EpochEvent:
    """One trace epoch: the live stream set + its phase tag."""

    index: int
    phase: str
    streams: Tuple[StreamEpoch, ...]


@dataclass(frozen=True)
class Trace:
    """A full deterministic workload: ``(name, seed)`` -> these bytes."""

    name: str
    seed: int
    partitions: int
    epochs: Tuple[EpochEvent, ...]
    knobs: Dict[str, int] = field(default_factory=dict)

    @property
    def consumer_counts(self) -> Tuple[int, ...]:
        """Every roster size the trace uses (warm-up shape planning)."""
        return tuple(sorted({
            len(se.members) for ev in self.epochs for se in ev.streams
        }))

    @property
    def stream_ids(self) -> Tuple[str, ...]:
        return tuple(sorted({
            se.stream_id for ev in self.epochs for se in ev.streams
        }))

    def digest(self) -> str:
        return trace_digest(self)


def trace_digest(trace: Trace) -> str:
    """sha256 over the canonical JSON encoding of the trace.

    Canonical = ``sort_keys`` + tuple->list coercion + no whitespace
    variance, so the digest is a stable function of the trace VALUES
    and nothing else (not dict order, not dataclass field order
    changes that keep names, not the python version's repr)."""
    payload = json.dumps(
        asdict(trace), sort_keys=True, separators=(",", ":")
    )
    return hashlib.sha256(payload.encode("utf-8")).hexdigest()


def _members(c: int) -> Tuple[str, ...]:
    return tuple(f"m{j}" for j in range(c))


def _lags_tuple(arr: np.ndarray) -> Tuple[int, ...]:
    return tuple(int(v) for v in np.minimum(arr, _LAG_CAP))


def _phase(index: int, warm: int) -> str:
    return "warm" if index < warm else "steady"


# Warm epochs past the cold start re-roll their lag vectors entirely
# (not base + small drift): a drift too small to cross the refine
# threshold would defer the warm fused executable's first dispatch —
# and its XLA compile — into the first STEADY epoch, failing the
# zero-steady-compile envelope for a warm-up artifact rather than a
# regression.  Every generator routes warm-epoch lags through this.
def _warm_reroll(
    e: int, warm: int, lags: np.ndarray, rng: np.random.Generator,
    low: int, high: int,
) -> np.ndarray:
    if 1 <= e < warm:
        return rng.integers(low, high, lags.shape[0]).astype(np.int64)
    return lags


def hot_skew_storm(
    seed: int, *, partitions: int = 192, consumers: int = 4,
    epochs: int = 10, warm: int = 2, storm_every: int = 2,
    hot_fraction: float = 0.0625, spike: int = 64,
) -> Trace:
    """Recurring hot-partition storms over a uniform floor.

    From the first post-warm epoch, every ``storm_every``-th epoch
    re-picks ``hot_fraction`` of the partitions and spikes them
    ``spike``x — the classic skewed-producer incident the lag-aware
    objective exists for.  Storms keep the ``steady`` tag: shapes and
    dtype never change, so the zero-compile gate holds through them."""
    rng = np.random.default_rng(seed)
    members = _members(consumers)
    hot_n = max(1, int(partitions * hot_fraction))
    base = rng.integers(10**4, 10**5, partitions).astype(np.int64)
    events = []
    for e in range(epochs):
        lags = base + rng.integers(0, 10**4, partitions)
        lags = _warm_reroll(e, warm, lags, rng, 10**4, 11 * 10**4)
        if e >= warm and (e - warm) % storm_every == 0:
            hot = rng.choice(partitions, size=hot_n, replace=False)
            lags[hot] = lags[hot] * spike
        events.append(EpochEvent(
            index=e, phase=_phase(e, warm),
            streams=(StreamEpoch(
                stream_id="skew-0", topic="t-skew", members=members,
                lags=_lags_tuple(lags),
            ),),
        ))
    return Trace(
        name="hot_skew_storm", seed=seed, partitions=partitions,
        epochs=tuple(events),
        knobs={"consumers": consumers, "spike": spike},
    )


def flapping_consumers(
    seed: int, *, partitions: int = 192, consumers: int = 4,
    epochs: int = 10, warm: int = 2,
) -> Trace:
    """A flapping consumer roster: members leave and (re)join while
    lags drift.  Every roster-size change is tagged ``transition`` —
    the cold chain it forces (fresh C bucket, XLA compile) is the
    scenario's point, not a regression."""
    rng = np.random.default_rng(seed)
    base = rng.integers(10**4, 10**6, partitions).astype(np.int64)
    # The flap schedule: C, C-1 (leave), C (rejoin), C+1 (scale out),
    # cycled in 2-epoch blocks over the post-warm epochs.  BOTH epochs
    # of a block whose roster differs from the previous block's are
    # tagged transition: the flap epoch is a cold chain (the C change
    # resets the stream) and the next is that roster's first warm
    # dispatch — its one-time compile is warm-up, not a regression.
    flaps = [consumers, consumers - 1, consumers, consumers + 1]

    def block_c(e: int) -> int:
        if e < warm:
            return consumers
        return flaps[((e - warm) // 2) % len(flaps)]

    events = []
    for e in range(epochs):
        c = block_c(e)
        prev_block = consumers if e < warm + 2 else block_c(
            warm + (((e - warm) // 2) - 1) * 2
        )
        phase = (
            "transition" if (e >= warm and c != prev_block)
            else _phase(e, warm)
        )
        lags = base + rng.integers(0, 10**5, partitions)
        lags = _warm_reroll(e, warm, lags, rng, 10**4, 10**6)
        events.append(EpochEvent(
            index=e, phase=phase,
            streams=(StreamEpoch(
                stream_id="flap-0", topic="t-flap", members=_members(c),
                lags=_lags_tuple(lags),
            ),),
        ))
    return Trace(
        name="flapping_consumers", seed=seed, partitions=partitions,
        epochs=tuple(events), knobs={"consumers": consumers},
    )


def lag_wave_multi(
    seed: int, *, partitions: int = 192, consumers: int = 4,
    epochs: int = 10, warm: int = 2, topics: int = 3,
) -> Trace:
    """A correlated lag wave sweeping the partition index of several
    topics at once — the shared-dependency incident (a slow downstream
    store backing partitions of many topics).  The wave center moves a
    fixed stride per epoch; every stream sees the SAME center, so the
    cross-stream correlation structure is part of the pinned bytes."""
    rng = np.random.default_rng(seed)
    members = _members(consumers)
    bases = [
        rng.integers(10**4, 10**5, partitions).astype(np.int64)
        for _ in range(topics)
    ]
    width = max(4, partitions // 8)
    idx = np.arange(partitions)
    events = []
    for e in range(epochs):
        center = (e * partitions) // max(1, epochs - 1) if epochs > 1 else 0
        # Triangular bump around the center (integer math end-to-end).
        dist = np.abs(idx - center)
        bump = np.maximum(0, width - dist).astype(np.int64)
        streams = []
        for t in range(topics):
            lags = bases[t] + rng.integers(0, 10**4, partitions)
            lags = _warm_reroll(e, warm, lags, rng, 10**4, 11 * 10**4)
            if e >= warm:
                lags = lags + bump * (10**5) * (t + 1)
            streams.append(StreamEpoch(
                stream_id=f"wave-{t}", topic=f"t-wave{t}",
                members=members, lags=_lags_tuple(lags),
            ))
        events.append(EpochEvent(
            index=e, phase=_phase(e, warm), streams=tuple(streams),
        ))
    return Trace(
        name="lag_wave_multi", seed=seed, partitions=partitions,
        epochs=tuple(events),
        knobs={"consumers": consumers, "topics": topics},
    )


def zipf_tenants(
    seed: int, *, partitions: int = 192, consumers: int = 4,
    epochs: int = 8, warm: int = 2, tenants: int = 8,
) -> Trace:
    """A zipf-ranked multi-tenant mix with a mixed SLO-class roster —
    the overload workload.  Tenant k's load scale is ``1/rank^1.2``
    of the heaviest; the class roster is fixed (2 critical, 2
    standard, the rest best_effort) so shed-ordering envelopes have
    every class present in every epoch."""
    rng = np.random.default_rng(seed)
    members = _members(consumers)
    classes = (
        ["critical"] * 2 + ["standard"] * 2
        + ["best_effort"] * max(0, tenants - 4)
    )[:tenants]
    scales = [1.0 / (k + 1) ** 1.2 for k in range(tenants)]
    bases = [
        rng.integers(10**4, 10**5, partitions).astype(np.int64)
        for _ in range(tenants)
    ]
    events = []
    for e in range(epochs):
        streams = []
        for k in range(tenants):
            drift = rng.integers(0, 10**5, partitions)
            dense = _warm_reroll(
                e, warm, bases[k] + drift, rng, 10**4, 11 * 10**4
            )
            lags = (dense * int(scales[k] * 1000)) // 1000
            streams.append(StreamEpoch(
                stream_id=f"zipf-{k}", topic=f"t-zipf{k}",
                members=members, lags=_lags_tuple(np.maximum(lags, 1)),
                slo_class=classes[k],
            ))
        events.append(EpochEvent(
            index=e, phase=_phase(e, warm), streams=tuple(streams),
        ))
    return Trace(
        name="zipf_tenants", seed=seed, partitions=partitions,
        epochs=tuple(events),
        knobs={"consumers": consumers, "tenants": tenants},
    )


def diurnal_ramp(
    seed: int, *, partitions: int = 192, consumers: int = 4,
    epochs: int = 10, warm: int = 2,
) -> Trace:
    """A smooth diurnal ramp: load scales up ~4x to a midday peak and
    back down, via integer permille factors of a half-sine — the
    capacity-planning shape the ``recommend`` surface tracks."""
    rng = np.random.default_rng(seed)
    members = _members(consumers)
    base = rng.integers(10**4, 10**5, partitions).astype(np.int64)
    span = max(1, epochs - warm - 1)
    events = []
    for e in range(epochs):
        t = max(0, e - warm) / span
        permille = 1000 + int(3000 * math.sin(math.pi * min(t, 1.0)))
        dense = _warm_reroll(
            e, warm, base + rng.integers(0, 10**4, partitions),
            rng, 10**4, 11 * 10**4,
        )
        lags = (dense * permille) // 1000
        events.append(EpochEvent(
            index=e, phase=_phase(e, warm),
            streams=(StreamEpoch(
                stream_id="diurnal-0", topic="t-diurnal",
                members=members, lags=_lags_tuple(lags),
            ),),
        ))
    return Trace(
        name="diurnal_ramp", seed=seed, partitions=partitions,
        epochs=tuple(events), knobs={"consumers": consumers},
    )


def step_load(
    seed: int, *, partitions: int = 192, consumers: int = 4,
    epochs: int = 10, warm: int = 2, step_at: int = 5, step: int = 8,
) -> Trace:
    """An abrupt sustained load step (a topic backfill / replay storm):
    ``step``x from epoch ``step_at`` onward.  The step epoch itself is
    tagged ``transition`` — the jump may legitimately churn the
    assignment; the sustained plateau after it must hold steady."""
    rng = np.random.default_rng(seed)
    members = _members(consumers)
    base = rng.integers(10**4, 10**5, partitions).astype(np.int64)
    events = []
    for e in range(epochs):
        lags = base + rng.integers(0, 10**4, partitions)
        lags = _warm_reroll(e, warm, lags, rng, 10**4, 11 * 10**4)
        if e >= step_at:
            lags = lags * step
        phase = "transition" if e == step_at else _phase(e, warm)
        events.append(EpochEvent(
            index=e, phase=phase,
            streams=(StreamEpoch(
                stream_id="step-0", topic="t-step", members=members,
                lags=_lags_tuple(lags),
            ),),
        ))
    return Trace(
        name="step_load", seed=seed, partitions=partitions,
        epochs=tuple(events),
        knobs={"consumers": consumers, "step": step},
    )


#: The generator registry: scenario traces are named here; corpus.py
#: references names, never functions, so a CI artifact's
#: (trace, seed) pair is always reproducible via :func:`generate`.
GENERATORS: Dict[str, Callable[..., Trace]] = {
    "hot_skew_storm": hot_skew_storm,
    "flapping_consumers": flapping_consumers,
    "lag_wave_multi": lag_wave_multi,
    "zipf_tenants": zipf_tenants,
    "diurnal_ramp": diurnal_ramp,
    "step_load": step_load,
}


def generate(name: str, seed: int, **knobs) -> Trace:
    """Build the named trace; raises KeyError listing valid names."""
    try:
        gen = GENERATORS[name]
    except KeyError:
        raise KeyError(
            f"unknown trace generator {name!r}; valid: "
            f"{sorted(GENERATORS)}"
        ) from None
    return gen(seed, **knobs)
