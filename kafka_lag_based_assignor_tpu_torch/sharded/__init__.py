"""Multi-device backend: one process drives a list of devices.

Counterpart of ``kafka_lag_based_assignor_tpu/sharded/``:

* :mod:`.mesh` — the mesh manager: discover and validate once at service
  start (``tpu.assignor.mesh.devices``), degrade to single-device on a lost
  device or a ``mesh.collective`` fault; virtual shards on one device.
* :mod:`.collectives` — psum / pmin / pmax / all-gather over per-shard
  tensor lists.
* :mod:`.solve` — the P-axis-sharded solves (seed + exchange refine, plan
  stats, the linear-OT duals and rounding tail).
* :mod:`.topics` — the topic-axis batch backend.
* :mod:`.resident` — the P-axis placement of a stream's resident warm state
  (row shards over "p", the consumer-axis tables replicated).
* :mod:`.megabatch` — the stream-axis and 2-D placement of a locked
  megabatch roster (whole rows a device).

Backend selection lives in :mod:`..ops.dispatch` (``sharded_solve_manager``):
single-device is the default and the degradation target.  Placement moves
bytes only: every epoch, wave and digest is bit-identical to the unplaced
run.
"""

from .mesh import (
    MeshCollectiveError,
    MeshManager,
    activate,
    active_manager,
    deactivate,
    managed,
)
from . import megabatch, resident
from .solve import (
    plan_stats_sharded,
    refine_sharded,
    seed_reference,
    solve_sharded,
)

__all__ = [
    "MeshCollectiveError",
    "MeshManager",
    "activate",
    "active_manager",
    "deactivate",
    "managed",
    "megabatch",
    "plan_stats_sharded",
    "refine_sharded",
    "resident",
    "seed_reference",
    "solve_sharded",
]
