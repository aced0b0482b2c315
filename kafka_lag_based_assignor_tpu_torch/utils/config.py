"""Typed configuration layer.

A copy of ``parse_config`` / ``AssignorConfig`` from
``kafka_lag_based_assignor_tpu/utils/config.py``, cut to the keys this
package reads.  The reference receives an untyped ``Map<String,?>``
through Kafka's ``Configurable`` SPI (LagBasedPartitionAssignor.java:97-130)
and consumes ``group.id`` (required, :107-113) and ``auto.offset.reset``
(default "latest", :346-347), and derives the metadata-consumer overrides
``enable.auto.commit=false`` + ``client.id=<group.id>.assignor``
(:116-120).  The framework's own knobs live under the ``tpu.assignor.``
prefix, with the JAX package's names, defaults and parse rules, so one
consumer config drives either package and a value one package rejects the
other rejects too; keys this package does not read pass through untouched,
as the reference copies the whole map (:101-104).  Among those are the
sidecar's, warm-up's and lifecycle's keys (``tpu.assignor.warmup.shapes``
and the rest), which come with those slices.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional

GROUP_ID_CONFIG = "group.id"
AUTO_OFFSET_RESET_CONFIG = "auto.offset.reset"
ENABLE_AUTO_COMMIT_CONFIG = "enable.auto.commit"
CLIENT_ID_CONFIG = "client.id"
PARTITION_ASSIGNMENT_STRATEGY_CONFIG = "partition.assignment.strategy"

SOLVER_CONFIG = (
    "tpu.assignor.solver"  # rounds | scan | global | sinkhorn | native | host
)
FALLBACK_CONFIG = "tpu.assignor.host.fallback"  # bool: greedy host fallback
PROFILE_CONFIG = "tpu.assignor.profile"  # bool: torch.profiler traces
SOLVE_TIMEOUT_CONFIG = "tpu.assignor.solve.timeout.ms"  # 0/empty disables
# Circuit-breaker knobs (utils/watchdog): how long a tripped solver stays
# sidelined before the single half-open probe, and how many CONSECUTIVE
# exceptions (not only timeouts) trip the breaker.
BREAKER_COOLDOWN_CONFIG = "tpu.assignor.breaker.cooldown.ms"
BREAKER_FAILURES_CONFIG = "tpu.assignor.breaker.failures"  # int >= 1
# Opt-in bounded retry for the three lag batch RPCs (lag.py): number of
# RETRIES per RPC (0 = reference abort semantics, the default) and the
# deterministic exponential-backoff base delay.
LAG_RETRIES_CONFIG = "tpu.assignor.lag.retries"  # int >= 0
LAG_RETRY_BACKOFF_CONFIG = "tpu.assignor.lag.retry.backoff.ms"
# int >= 0, or unset/"auto".  For the "sinkhorn" solver, "auto" selects
# the per-rounding-path budget (models/sinkhorn: 24 for the sequential
# rounding, 96 for the parallel one) and an explicit integer is honored
# exactly.  For the parity solvers an explicit integer > 0 opts into the
# exchange refinement (rounds and scan; rejected for global below).
REFINE_ITERS_CONFIG = "tpu.assignor.refine.iters"
SINKHORN_ITERS_CONFIG = "tpu.assignor.sinkhorn.iters"  # int > 0
# Quality-mode plane (ops/dispatch + ops/linear_ot).  ``quality.mode``
# routes every quality solve: "sinkhorn" pins the dense implicit-plan
# path, "linear" the O(P + C)-memory mirror-prox path, "auto" (default)
# picks linear at large row counts.  ``quality.tile`` is the linear
# mode's streamed tile size in rows (pow2).  Both are validated here, so
# a malformed value fails at configure() as in the JAX package, but they
# are not kept: the plugin does not install them (the JAX plugin does not
# either; its sidecar does), and the router reads the process-wide knobs
# of ops/dispatch.
QUALITY_MODE_CONFIG = "tpu.assignor.quality.mode"
QUALITY_TILE_CONFIG = "tpu.assignor.quality.tile"

#: Valid ``quality.mode`` values (the router in ops/dispatch uses them).
QUALITY_MODES = ("sinkhorn", "linear", "auto")

_MAX_QUALITY_TILE = 1 << 16


def validate_quality_tile(tile) -> int:
    """THE ``quality.tile`` validator, shared by this config key and
    ops/linear_ot: a power of two in [8, 65536]."""
    try:
        t = int(tile)
    except (TypeError, ValueError):
        raise ValueError(f"quality tile {tile!r} is not an integer")
    if t < 8 or t > _MAX_QUALITY_TILE or (t & (t - 1)):
        raise ValueError(
            f"quality tile {t} must be a power of two in "
            f"[8, {_MAX_QUALITY_TILE}]"
        )
    return t

# The JAX package's solver names: all of them parse and run here.
VALID_SOLVERS = ("rounds", "scan", "global", "sinkhorn", "native", "host")
# The solvers whose answer is the reference's, bit for bit.
PARITY_SOLVERS = ("rounds", "scan", "native", "host")


@dataclass
class AssignorConfig:
    """Validated view over the consumer config map."""

    group_id: str
    auto_offset_reset: str = "latest"
    solver: str = "rounds"
    host_fallback: bool = True
    profile: bool = False
    # A hung device must never block a rebalance past its deadline; None
    # disables the watchdog (the solve runs inline).  The default leaves
    # headroom for a first rebalance's kernel builds (about 40 s for the
    # round-scan source); a trip only sidelines the device for the
    # breaker's cooldown, not forever.
    solve_timeout_s: Optional[float] = 120.0
    # Circuit-breaker policy: a tripped solver fails fast (host fallback)
    # for the cooldown, then exactly one probe is admitted half-open;
    # breaker_failures consecutive exceptions trip it like a timeout does.
    breaker_cooldown_s: float = 300.0
    breaker_failures: int = 3
    # Lag-RPC retry policy: 0 retries preserves the reference's
    # broker-exception-aborts-the-rebalance semantics exactly.
    lag_retries: int = 0
    lag_retry_backoff_s: float = 0.05
    refine_iters: Optional[int] = None
    sinkhorn_iters: int = 24
    consumer_group_props: Dict[str, Any] = field(default_factory=dict)
    metadata_consumer_props: Dict[str, Any] = field(default_factory=dict)

    @property
    def client_id(self) -> str:
        return f"{self.group_id}.assignor"


def _as_bool(value: Any) -> bool:
    """The JAX package's rule: a bool as given; anything else is true only
    when its text is "true", "1" or "yes" (any case)."""
    if isinstance(value, bool):
        return value
    return str(value).strip().lower() in ("true", "1", "yes")


def parse_config(configs: Mapping[str, Any]) -> AssignorConfig:
    """Validate and type the raw config map.

    Raises ``ValueError`` if ``group.id`` is absent — the reference throws
    IllegalArgumentException in the same situation (:107-113) so that a
    misconfigured consumer fails at construction, not mid-rebalance.
    """
    consumer_group_props = dict(configs)

    group_id = consumer_group_props.get(GROUP_ID_CONFIG)
    if group_id is None:
        raise ValueError(
            f"{GROUP_ID_CONFIG} cannot be null when using "
            f"{PARTITION_ASSIGNMENT_STRATEGY_CONFIG}=LagBasedPartitionAssignor"
        )

    solver = str(consumer_group_props.get(SOLVER_CONFIG, "rounds"))
    if solver not in VALID_SOLVERS:
        raise ValueError(
            f"{SOLVER_CONFIG}={solver!r} invalid; choose one of {VALID_SOLVERS}"
        )

    # Derived metadata-consumer properties, exactly as the reference builds
    # them (:116-120): same config, auto-commit off, suffixed client id.
    metadata_consumer_props = dict(consumer_group_props)
    metadata_consumer_props[ENABLE_AUTO_COMMIT_CONFIG] = "false"
    metadata_consumer_props[CLIENT_ID_CONFIG] = f"{group_id}.assignor"

    def _as_int(key: str, default: int, minimum: int) -> int:
        raw = consumer_group_props.get(key, default)
        try:
            value = int(raw)
        except (TypeError, ValueError):
            raise ValueError(f"{key}={raw!r} is not an integer")
        if value < minimum:
            raise ValueError(f"{key}={value} must be >= {minimum}")
        return value

    sinkhorn_iters = _as_int(SINKHORN_ITERS_CONFIG, 24, 1)
    raw_refine = consumer_group_props.get(REFINE_ITERS_CONFIG, None)
    refine_iters = (
        None
        if raw_refine in (None, "", "auto")
        else _as_int(REFINE_ITERS_CONFIG, raw_refine, 0)
    )
    if solver == "global" and refine_iters:
        raise ValueError(
            f"{REFINE_ITERS_CONFIG} is per-topic and would undo the "
            f"'global' solver's cross-topic balance; unset it or choose "
            f"solver 'rounds'/'scan'/'sinkhorn'"
        )

    quality_mode = str(
        consumer_group_props.get(QUALITY_MODE_CONFIG, "auto")
    )
    if quality_mode not in QUALITY_MODES:
        raise ValueError(
            f"{QUALITY_MODE_CONFIG}={quality_mode!r} invalid; choose "
            f"one of {QUALITY_MODES}"
        )
    raw_tile = consumer_group_props.get(QUALITY_TILE_CONFIG, 1024)
    try:
        validate_quality_tile(raw_tile)
    except ValueError as exc:
        raise ValueError(f"{QUALITY_TILE_CONFIG}: {exc}")

    raw_timeout = consumer_group_props.get(SOLVE_TIMEOUT_CONFIG, 120_000)
    try:
        timeout_ms = float(raw_timeout) if raw_timeout not in ("", None) else 0.0
    except (TypeError, ValueError):
        raise ValueError(
            f"{SOLVE_TIMEOUT_CONFIG}={raw_timeout!r} is not a number"
        )
    # Zero, negative or empty: no deadline (the solve runs inline).
    solve_timeout_s = timeout_ms / 1000.0 if timeout_ms > 0 else None

    def _as_ms(key: str, default_ms: float) -> float:
        raw = consumer_group_props.get(key, default_ms)
        try:
            value = float(raw)
        except (TypeError, ValueError):
            raise ValueError(f"{key}={raw!r} is not a number")
        if value < 0:
            raise ValueError(f"{key}={value} must be >= 0")
        return value / 1000.0

    raw_backoff = consumer_group_props.get(LAG_RETRY_BACKOFF_CONFIG, 50.0)
    try:
        backoff_ms = float(raw_backoff)
    except (TypeError, ValueError):
        raise ValueError(
            f"{LAG_RETRY_BACKOFF_CONFIG}={raw_backoff!r} is not a number"
        )
    if backoff_ms < 0:
        raise ValueError(f"{LAG_RETRY_BACKOFF_CONFIG}={backoff_ms} must be >= 0")

    return AssignorConfig(
        group_id=str(group_id),
        auto_offset_reset=str(
            consumer_group_props.get(AUTO_OFFSET_RESET_CONFIG, "latest")
        ),
        solver=solver,
        host_fallback=_as_bool(consumer_group_props.get(FALLBACK_CONFIG, True)),
        profile=_as_bool(consumer_group_props.get(PROFILE_CONFIG, False)),
        solve_timeout_s=solve_timeout_s,
        breaker_cooldown_s=_as_ms(BREAKER_COOLDOWN_CONFIG, 300_000.0),
        breaker_failures=_as_int(BREAKER_FAILURES_CONFIG, 3, 1),
        lag_retries=_as_int(LAG_RETRIES_CONFIG, 0, 0),
        lag_retry_backoff_s=backoff_ms / 1000.0,
        refine_iters=refine_iters,
        sinkhorn_iters=sinkhorn_iters,
        consumer_group_props=consumer_group_props,
        metadata_consumer_props=metadata_consumer_props,
    )
