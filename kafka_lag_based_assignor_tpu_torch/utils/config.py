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
as the reference copies the whole map (:101-104).  The sidecar's keys
that the port's sidecar serves (the megabatch coalescer, delta epochs, SLO
classes and overload, the metrics port, the quality mode and tile,
snapshots and drain, the writer lease, the resync pacer, the scrubber and
the recovery pre-stack, the device mesh, federation) and
``tpu.assignor.warmup.shapes`` are read here.
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
# mode's streamed tile size in rows (pow2).  The plugin does not install
# them (the JAX plugin does not either); the sidecar installs them
# process-wide when it starts, and the router reads the process-wide
# knobs of ops/dispatch.
QUALITY_MODE_CONFIG = "tpu.assignor.quality.mode"
QUALITY_TILE_CONFIG = "tpu.assignor.quality.tile"

# Delta epochs (ops/streaming, served by the sidecar): whether a warm
# dispatch may scatter a sparse (indices, values) lag update onto the
# device-resident lag buffer instead of re-uploading the full vector; the
# changed-fraction ceiling above which the dense upload is used; the
# number of pow2 K-ladder rungs (0 disables like enabled=false); and the
# per-stream adaptive cutoff.
DELTA_ENABLED_CONFIG = "tpu.assignor.delta.enabled"
DELTA_MAX_FRACTION_CONFIG = "tpu.assignor.delta.max.fraction"
DELTA_BUCKETS_CONFIG = "tpu.assignor.delta.buckets"
DELTA_ADAPTIVE_CONFIG = "tpu.assignor.delta.adaptive"
# SLO classes + overload control (utils/overload, served by the sidecar).
# Per-stream class: "tpu.assignor.slo.class.<stream_id>" = critical |
# standard | best_effort (a wire params.slo_class override wins per
# request; unlisted streams are "standard").  Per-class deadline budget:
# "tpu.assignor.slo.deadline.ms.<class>", which caps that class's request
# budget below solve.timeout.ms.  The overload detector's knobs: the
# epoch-latency level (ms) read as pressure 1.0 (0/unset = auto: half the
# solve timeout) and the weighted in-flight depth read as pressure 1.0.
SLO_CLASS_PREFIX = "tpu.assignor.slo.class."
SLO_DEADLINE_PREFIX = "tpu.assignor.slo.deadline.ms."
OVERLOAD_LATENCY_BUDGET_CONFIG = "tpu.assignor.overload.latency.budget.ms"
OVERLOAD_DEPTH_HIGH_CONFIG = "tpu.assignor.overload.depth.high"
# Megabatch coalescer knobs (ops/coalesce, served by the sidecar): the
# admission window in ms and the per-shape batch cap (<= 1 disables
# cross-stream coalescing); the consecutive identical-stream-set waves
# before a roster locks; and whether readback overlaps the next wave's
# upload (false: strict serial).
COALESCE_WINDOW_CONFIG = "tpu.assignor.coalesce.window.ms"
COALESCE_MAX_BATCH_CONFIG = "tpu.assignor.coalesce.max_batch"
COALESCE_LOCK_WAVES_CONFIG = "tpu.assignor.coalesce.roster.lock.waves"
COALESCE_PIPELINE_CONFIG = "tpu.assignor.coalesce.pipeline"
# Opt-in plain-HTTP /metrics listener (utils/metrics_http): 0/unset
# disables (the wire ``metrics`` method is always served).
METRICS_PORT_CONFIG = "tpu.assignor.metrics.port"
# Lifecycle snapshots + graceful drain (utils/snapshot, served by the
# sidecar).  ``snapshot.path`` names the snapshot file (empty/unset
# disables snapshots and recovery); ``snapshot.interval.ms`` is the periodic
# write cadence (churn writes early, debounced); ``snapshot.max.age.ms`` is
# the boot-time staleness guard (an older snapshot rehydrates nothing);
# ``drain.timeout.ms`` bounds how long a drain waits for in-flight requests
# before the final snapshot and the listener close.
SNAPSHOT_PATH_CONFIG = "tpu.assignor.snapshot.path"
SNAPSHOT_INTERVAL_CONFIG = "tpu.assignor.snapshot.interval.ms"
SNAPSHOT_MAX_AGE_CONFIG = "tpu.assignor.snapshot.max.age.ms"
DRAIN_TIMEOUT_CONFIG = "tpu.assignor.drain.timeout.ms"
# Cross-host hand-off: where the snapshot lives ("file", or the
# object-store-shaped "memory" / "object" with versioned CAS writes); a
# lease ttl > 0 engages epoch-fenced writer leases, boot waiting up to
# ``snapshot.lease.wait.ms`` for a crashed predecessor's (0 = auto, 2x ttl
# + 1 s).
SNAPSHOT_BACKEND_CONFIG = "tpu.assignor.snapshot.backend"
SNAPSHOT_LEASE_TTL_CONFIG = "tpu.assignor.snapshot.lease.ttl.ms"
SNAPSHOT_LEASE_WAIT_CONFIG = "tpu.assignor.snapshot.lease.wait.ms"
# Post-restart resync pacing: at most this many concurrent stale-resident
# dense rebuilds; excess epochs wait (``klba_resync_paced_total``).  0
# disables.
RESYNC_MAX_INFLIGHT_CONFIG = "tpu.assignor.resync.max.inflight"
# The resident-state scrubber's cadence (utils/scrub); 0 disables it (the
# per-dispatch digests stay on either way).
SCRUB_INTERVAL_CONFIG = "tpu.assignor.scrub.interval.ms"
# Rebuild each recovered stream's resident state at boot, off the serving
# path (``StreamingAssignor.prestack_resident``).
RECOVERY_PRESTACK_CONFIG = "tpu.assignor.recovery.prestack"
# "P:C[:T][,P:C[:T]...]": shapes to warm at configure() time (consumer
# startup, not on a rebalance's critical path): each entry builds every
# kernel and runs the configured solver once at max_partitions P /
# num_consumers C / a topic batch of T (default 1).  Shared parser with the
# sidecar's --warmup flag (parse_warmup_shapes).  Empty/unset skips it.
WARMUP_SHAPES_CONFIG = "tpu.assignor.warmup.shapes"


def parse_warmup_shapes(text: str) -> list:
    """THE parser for warm-up shape lists, used by this config key and the
    sidecar's ``--warmup`` flag.  Returns [(max_partitions, num_consumers,
    topics), ...]; raises ValueError on malformed or non-positive
    entries."""
    shapes = []
    for pair in str(text).split(","):
        parts = pair.split(":")
        if len(parts) not in (2, 3):
            raise ValueError(
                f"warmup shape {pair!r} must be "
                "'max_partitions:num_consumers[:topics]'"
            )
        try:
            nums = [int(p) for p in parts]
        except ValueError:
            raise ValueError(
                f"warmup shape {pair!r} must be "
                "'max_partitions:num_consumers[:topics]'"
            )
        if len(nums) == 2:
            nums.append(1)
        if any(n < 1 for n in nums):
            raise ValueError(
                f"warmup shape entries must be positive, got {pair!r}"
            )
        shapes.append(tuple(nums))
    return shapes

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


# Multi-device sharding (sharded/).  ``mesh.devices`` selects the device
# mesh discovered and validated ONCE at sidecar start: "off" (default —
# single-device), "auto" (all visible devices; single-device when only one
# is visible), or an integer N (exactly N devices; fewer visible degrades to
# single-device at boot, fail-open).  Virtual shards on one device come from
# KLBA_VIRTUAL_SHARDS (sharded/mesh).  ``mesh.solve.min.rows`` is the
# partition floor below which a single device wins and the P-sharded solve
# is not selected.  ``mesh.shape`` factorizes the pool into an (S, D)
# ("streams", "p") grid: "off" (default), "auto" or "SxD".
MESH_DEVICES_CONFIG = "tpu.assignor.mesh.devices"
MESH_SOLVE_MIN_ROWS_CONFIG = "tpu.assignor.mesh.solve.min.rows"
MESH_SHAPE_CONFIG = "tpu.assignor.mesh.shape"
# Federated multi-cluster assignment (federated/; DEPLOYMENT.md
# "Federated assignment").  ``federation.self.id`` is this sidecar's
# stable peer identity (empty/unset disables the whole plane);
# ``federation.peers`` lists the peer sidecars as
# "id=host:port,id=host:port".  ``federation.rounds`` bounds the
# dual-exchange rounds per federated_assign; ``sync.timeout.ms`` is
# the per-peer RPC deadline (also bounded by the request budget);
# ``max.staleness.ms`` bounds how old the last-good-global dual cache
# may be and still serve the middle degradation rung.
FEDERATION_SELF_ID_CONFIG = "tpu.assignor.federation.self.id"
FEDERATION_PEERS_CONFIG = "tpu.assignor.federation.peers"
FEDERATION_ROUNDS_CONFIG = "tpu.assignor.federation.rounds"
FEDERATION_SYNC_TIMEOUT_CONFIG = "tpu.assignor.federation.sync.timeout.ms"
FEDERATION_MAX_STALENESS_CONFIG = (
    "tpu.assignor.federation.max.staleness.ms"
)
# Async gossip duals: cadence of the background dual-
# convergence daemon.  0 (the default) disables gossip — every
# federated_assign pays the synchronous exchange; > 0 keeps the duals
# warm so assigns serve rung global from cache in one local round.
FEDERATION_GOSSIP_INTERVAL_CONFIG = (
    "tpu.assignor.federation.gossip.interval.ms"
)
# Weighted shards (ROADMAP federated (c)): this cluster's per-consumer
# capacity weight vector as comma-separated positive floats (length =
# the consumer count federated_assign serves).  Exchanged in the hello
# handshake through the audited federated/wire serializer and summed
# into the global count-marginal target — consumers with more capacity
# take proportionally more partitions.  Empty/unset contributes
# uniform weights (the n/C marginal when no cluster is weighted).
FEDERATION_CAPACITY_CONFIG = "tpu.assignor.federation.capacity"


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
    # Quality-mode routing + the linear mode's tile size (installed by the
    # sidecar, read by ops/dispatch).
    quality_mode: str = "auto"
    quality_tile: int = 1024
    # Megabatch coalescer (ops/coalesce): admission window, batch cap,
    # roster lock streak and the readback pipeline.
    coalesce_window_s: float = 0.0005
    coalesce_max_batch: int = 32
    coalesce_lock_waves: int = 1
    coalesce_pipeline: bool = True
    # Delta epochs (ops/streaming): fraction ceiling, pow2 K ladder and
    # the adaptive cutoff.
    delta_enabled: bool = True
    delta_max_fraction: float = 0.125
    delta_buckets: int = 6
    delta_adaptive: bool = True
    # Multi-device sharding (sharded/): mesh spec, the P-sharded-solve row
    # floor, and the cross-axis (S, D) factorization ("off" = 1-D rungs).
    mesh_devices: str = "off"
    mesh_solve_min_rows: int = 65536
    mesh_shape: str = "off"
    # Federated multi-cluster assignment (federated/): peer identity,
    # peer set (validated "id=host:port" list), round/timeout bounds,
    # the last-good dual cache's staleness window, the gossip cadence and
    # this cluster's capacity weights.
    federation_self_id: Optional[str] = None
    federation_peers: str = ""
    federation_rounds: int = 16
    federation_sync_timeout_s: float = 2.0
    federation_max_staleness_s: float = 300.0
    federation_gossip_interval_s: float = 0.0
    federation_capacity: Optional[list] = None
    # SLO classes + overload control (utils/overload): per-stream class
    # map, per-class deadline budgets (seconds), and the detector's
    # pressure normalizers (0 latency budget = auto).
    slo_classes: Dict[str, str] = field(default_factory=dict)
    slo_deadline_s: Dict[str, float] = field(default_factory=dict)
    overload_latency_budget_ms: float = 0.0
    overload_depth_high: float = 24.0
    # Plain-HTTP /metrics port (utils/metrics_http); None = disabled.
    metrics_port: Optional[int] = None
    # Lifecycle snapshots + drain (utils/snapshot; None path disables).
    snapshot_path: Optional[str] = None
    snapshot_interval_s: float = 30.0
    snapshot_max_age_s: float = 900.0
    drain_timeout_s: float = 10.0
    # Cross-host hand-off: backend kind + epoch-fenced writer lease (ttl 0
    # = fencing off) + boot lease wait (0 = auto).
    snapshot_backend: str = "file"
    snapshot_lease_ttl_s: float = 0.0
    snapshot_lease_wait_s: float = 0.0
    # Post-restart resync pacing + boot-time roster pre-stacking.
    resync_max_inflight: int = 8
    recovery_prestack: bool = False
    # Resident-state scrubber cadence (utils/scrub); 0 disables.
    scrub_interval_s: float = 30.0
    # (max_partitions, num_consumers, topics) shapes to warm at configure().
    warmup_shapes: list = field(default_factory=list)
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
        quality_tile = validate_quality_tile(raw_tile)
    except ValueError as exc:
        raise ValueError(f"{QUALITY_TILE_CONFIG}: {exc}")

    raw_shapes = consumer_group_props.get(WARMUP_SHAPES_CONFIG, "")
    warmup_shapes = []
    if raw_shapes not in (None, ""):
        try:
            warmup_shapes = parse_warmup_shapes(raw_shapes)
        except ValueError as exc:
            raise ValueError(f"{WARMUP_SHAPES_CONFIG}: {exc}")

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

    metrics_port = _as_int(METRICS_PORT_CONFIG, 0, 0)

    raw_snap_path = consumer_group_props.get(SNAPSHOT_PATH_CONFIG, "")
    snapshot_path = (
        str(raw_snap_path) if raw_snap_path not in (None, "") else None
    )
    snapshot_interval_s = _as_ms(SNAPSHOT_INTERVAL_CONFIG, 30_000.0)
    if snapshot_interval_s <= 0:
        raise ValueError(
            f"{SNAPSHOT_INTERVAL_CONFIG} must be > 0 ms"
        )
    snapshot_max_age_s = _as_ms(SNAPSHOT_MAX_AGE_CONFIG, 900_000.0)
    if snapshot_max_age_s <= 0:
        raise ValueError(f"{SNAPSHOT_MAX_AGE_CONFIG} must be > 0 ms")
    drain_timeout_s = _as_ms(DRAIN_TIMEOUT_CONFIG, 10_000.0)
    # The backend kind against the roster utils/snapshot ships: a typo
    # fails at configure() time, not at the first snapshot write.
    from .snapshot import BACKEND_KINDS

    snapshot_backend = str(
        consumer_group_props.get(SNAPSHOT_BACKEND_CONFIG, "file")
    )
    if snapshot_backend not in BACKEND_KINDS:
        raise ValueError(
            f"{SNAPSHOT_BACKEND_CONFIG}={snapshot_backend!r} invalid; "
            f"choose one of {list(BACKEND_KINDS)}"
        )
    snapshot_lease_ttl_s = _as_ms(SNAPSHOT_LEASE_TTL_CONFIG, 0.0)
    snapshot_lease_wait_s = _as_ms(SNAPSHOT_LEASE_WAIT_CONFIG, 0.0)
    resync_max_inflight = _as_int(RESYNC_MAX_INFLIGHT_CONFIG, 8, 0)
    scrub_interval_s = _as_ms(SCRUB_INTERVAL_CONFIG, 30_000.0)

    # SLO class map + per-class deadline budgets: prefix-keyed entries,
    # validated against the class roster (utils/overload).
    from .overload import SLO_CLASSES

    slo_classes: Dict[str, str] = {}
    slo_deadline_s: Dict[str, float] = {}
    for key, value in consumer_group_props.items():
        if key.startswith(SLO_CLASS_PREFIX):
            stream_id = key[len(SLO_CLASS_PREFIX):]
            klass = str(value)
            if not stream_id or klass not in SLO_CLASSES:
                raise ValueError(
                    f"{key}={value!r} invalid; classes: {list(SLO_CLASSES)}"
                )
            slo_classes[stream_id] = klass
        elif key.startswith(SLO_DEADLINE_PREFIX):
            klass = key[len(SLO_DEADLINE_PREFIX):]
            if klass not in SLO_CLASSES:
                raise ValueError(
                    f"{key}: unknown class {klass!r}; "
                    f"classes: {list(SLO_CLASSES)}"
                )
            secs = _as_ms(key, 0.0)  # ms-typed knob, seconds out
            if secs <= 0:
                raise ValueError(f"{key}={value!r} must be > 0 ms")
            slo_deadline_s[klass] = secs

    # Delta-epoch knobs: the fraction is a plain float in (0, 1]; the
    # bucket count bounds the K ladder, capped at 16 rungs.
    raw_frac = consumer_group_props.get(DELTA_MAX_FRACTION_CONFIG, 0.125)
    try:
        delta_max_fraction = float(raw_frac)
    except (TypeError, ValueError):
        raise ValueError(
            f"{DELTA_MAX_FRACTION_CONFIG}={raw_frac!r} is not a number"
        )
    if not 0.0 < delta_max_fraction <= 1.0:
        raise ValueError(
            f"{DELTA_MAX_FRACTION_CONFIG}={delta_max_fraction} must be "
            "in (0, 1]"
        )
    delta_buckets = _as_int(DELTA_BUCKETS_CONFIG, 6, 0)
    if delta_buckets > 16:
        raise ValueError(
            f"{DELTA_BUCKETS_CONFIG}={delta_buckets} must be <= 16 "
            "(each rung is one compiled executable per shape bucket)"
        )

    # Mesh knobs: the spec is validated HERE (the sharded/ parser) so a
    # typo'd device count fails at configure() time, not at boot.
    from ..sharded.mesh import _parse_shape as _parse_mesh_shape
    from ..sharded.mesh import _parse_spec as _parse_mesh_spec

    raw_mesh = consumer_group_props.get(MESH_DEVICES_CONFIG, "off")
    try:
        mesh_devices = str(_parse_mesh_spec(raw_mesh))
    except ValueError as exc:
        raise ValueError(f"{MESH_DEVICES_CONFIG}: {exc}")
    mesh_solve_min_rows = _as_int(MESH_SOLVE_MIN_ROWS_CONFIG, 65536, 1)
    raw_shape = consumer_group_props.get(MESH_SHAPE_CONFIG, "off")
    try:
        shape = _parse_mesh_shape(raw_shape)
    except ValueError as exc:
        raise ValueError(f"{MESH_SHAPE_CONFIG}: {exc}")
    mesh_shape = shape if isinstance(shape, str) else f"{shape[0]}x{shape[1]}"

    # Federation knobs: the peer list is PARSED here so a typo'd spec
    # fails at configure() time, not at the first peer round.
    raw_self_id = consumer_group_props.get(FEDERATION_SELF_ID_CONFIG, "")
    federation_self_id = (
        str(raw_self_id) if raw_self_id not in (None, "") else None
    )
    federation_peers = str(
        consumer_group_props.get(FEDERATION_PEERS_CONFIG, "") or ""
    )
    if federation_peers:
        if federation_self_id is None:
            raise ValueError(
                f"{FEDERATION_PEERS_CONFIG} requires "
                f"{FEDERATION_SELF_ID_CONFIG}"
            )
        from ..federated.peers import parse_peer_specs

        try:
            parse_peer_specs(federation_peers)
        except ValueError as exc:
            raise ValueError(f"{FEDERATION_PEERS_CONFIG}: {exc}")
    federation_rounds = _as_int(FEDERATION_ROUNDS_CONFIG, 16, 1)
    federation_sync_timeout_s = _as_ms(
        FEDERATION_SYNC_TIMEOUT_CONFIG, 2_000.0
    )
    if federation_sync_timeout_s <= 0:
        raise ValueError(f"{FEDERATION_SYNC_TIMEOUT_CONFIG} must be > 0 ms")
    federation_max_staleness_s = _as_ms(
        FEDERATION_MAX_STALENESS_CONFIG, 300_000.0
    )
    federation_gossip_interval_s = _as_ms(
        FEDERATION_GOSSIP_INTERVAL_CONFIG, 0.0
    )
    if federation_gossip_interval_s < 0:
        raise ValueError(
            f"{FEDERATION_GOSSIP_INTERVAL_CONFIG} must be >= 0 ms"
        )
    raw_capacity = consumer_group_props.get(
        FEDERATION_CAPACITY_CONFIG, ""
    )
    federation_capacity = None
    if raw_capacity not in (None, ""):
        try:
            federation_capacity = [
                float(v) for v in str(raw_capacity).split(",")
            ]
        except ValueError:
            raise ValueError(
                f"{FEDERATION_CAPACITY_CONFIG}={raw_capacity!r} must be "
                "comma-separated numbers"
            )
        if any(v <= 0 for v in federation_capacity):
            raise ValueError(
                f"{FEDERATION_CAPACITY_CONFIG} entries must be > 0"
            )

    # The controller keeps this knob in ms (it normalizes a p99 measured
    # in ms), so convert _as_ms's seconds back out once, here.
    overload_latency_budget_ms = (
        _as_ms(OVERLOAD_LATENCY_BUDGET_CONFIG, 0.0) * 1000.0
    )
    raw_depth = consumer_group_props.get(OVERLOAD_DEPTH_HIGH_CONFIG, 24.0)
    try:
        overload_depth_high = float(raw_depth)
    except (TypeError, ValueError):
        raise ValueError(
            f"{OVERLOAD_DEPTH_HIGH_CONFIG}={raw_depth!r} is not a number"
        )
    if overload_depth_high <= 0:
        raise ValueError(
            f"{OVERLOAD_DEPTH_HIGH_CONFIG}={overload_depth_high} must be > 0"
        )

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
        quality_mode=quality_mode,
        quality_tile=quality_tile,
        coalesce_window_s=_as_ms(COALESCE_WINDOW_CONFIG, 0.5),
        coalesce_max_batch=_as_int(COALESCE_MAX_BATCH_CONFIG, 32, 1),
        coalesce_lock_waves=_as_int(COALESCE_LOCK_WAVES_CONFIG, 1, 1),
        coalesce_pipeline=_as_bool(
            consumer_group_props.get(COALESCE_PIPELINE_CONFIG, True)
        ),
        delta_enabled=_as_bool(
            consumer_group_props.get(DELTA_ENABLED_CONFIG, True)
        ),
        delta_max_fraction=delta_max_fraction,
        delta_buckets=delta_buckets,
        delta_adaptive=_as_bool(
            consumer_group_props.get(DELTA_ADAPTIVE_CONFIG, True)
        ),
        mesh_devices=mesh_devices,
        mesh_solve_min_rows=mesh_solve_min_rows,
        mesh_shape=mesh_shape,
        federation_self_id=federation_self_id,
        federation_peers=federation_peers,
        federation_rounds=federation_rounds,
        federation_sync_timeout_s=federation_sync_timeout_s,
        federation_max_staleness_s=federation_max_staleness_s,
        federation_gossip_interval_s=federation_gossip_interval_s,
        federation_capacity=federation_capacity,
        slo_classes=slo_classes,
        slo_deadline_s=slo_deadline_s,
        overload_latency_budget_ms=overload_latency_budget_ms,
        overload_depth_high=overload_depth_high,
        metrics_port=metrics_port if metrics_port > 0 else None,
        snapshot_path=snapshot_path,
        snapshot_interval_s=snapshot_interval_s,
        snapshot_max_age_s=snapshot_max_age_s,
        drain_timeout_s=drain_timeout_s,
        snapshot_backend=snapshot_backend,
        snapshot_lease_ttl_s=snapshot_lease_ttl_s,
        snapshot_lease_wait_s=snapshot_lease_wait_s,
        resync_max_inflight=resync_max_inflight,
        scrub_interval_s=scrub_interval_s,
        recovery_prestack=_as_bool(
            consumer_group_props.get(RECOVERY_PRESTACK_CONFIG, False)
        ),
        warmup_shapes=warmup_shapes,
        consumer_group_props=consumer_group_props,
        metadata_consumer_props=metadata_consumer_props,
    )
