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

Backend selection lives in :mod:`..ops.dispatch` (``sharded_solve_manager``):
single-device is the default and the degradation target.  Not ported yet:
the JAX package's ``resident`` (P-sharded resident buffers) and
``megabatch`` (stream-axis placement) modules, which move bytes only.
"""

from .mesh import (
    MeshCollectiveError,
    MeshManager,
    activate,
    active_manager,
    deactivate,
    managed,
)
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
    "plan_stats_sharded",
    "refine_sharded",
    "seed_reference",
    "solve_sharded",
]
