"""Topic-axis mesh backend: shard a topic batch over a device mesh.

Counterpart of ``kafka_lag_based_assignor_tpu/sharded/topics.py``.  The
topic axis is the data-parallel dimension of the BATCHED solve: each topic's
assignment is independent, so a [T, P] batch splits over the mesh's
"topics" axis with no communication in the solve itself, and the
per-member global stats reduce with a ``psum`` over "topics".  On the
"members" axis each shard reduces only its C / members slice of the
per-member stats, so no shard holds every member's accumulators.

Each shard's topic block is one batched rounds solve (one K1 launch a
shard, :func:`..ops.rounds_kernel.assign_topic_rounds`), with the optional
per-topic exchange refine (:func:`..ops.refine.refine_assignment`).  The
greedy inside one topic is sequential over rounds, so a topic is never split
across shards.  Outputs are whole tensors on the mesh's first device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops.rounds_kernel import assign_topic_rounds
from . import collectives as coll
from .mesh import Mesh, visible_devices


def make_mesh(devices: Optional[Sequence[torch.device]] = None,
              topics_axis: Optional[int] = None, members_axis: int = 1) -> Mesh:
    """Build a 2-D ("topics", "members") mesh; default all topic
    parallelism, ("topics", 1).  ``members_axis`` > 1 carves shards for the
    member-axis stats."""
    devices = list(devices if devices is not None else visible_devices())
    n = len(devices)
    if topics_axis is None:
        topics_axis = n // members_axis
    if topics_axis * members_axis != n:
        raise ValueError(f"mesh {topics_axis}x{members_axis} != {n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(topics_axis, members_axis), ("topics", "members"))


def _as_tensor(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def shard_topic_batch(mesh: Mesh, lags, partition_ids, valid):
    """Place a host topic batch with the mesh's topic sharding: returns three
    lists, one [T / topics, P] block per mesh device in row-major order
    (the blocks of one "topics" row replicated over "members")."""
    Tm, Mm = mesh.shape["topics"], mesh.shape["members"]
    out = []
    for arr in (lags, partition_ids, valid):
        host = arr.cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
        if host.shape[0] % Tm:
            raise ValueError(
                f"topic batch of {host.shape[0]} not divisible by the topics "
                f"axis {Tm}"
            )
        blocks = np.split(host, Tm)
        out.append([_as_tensor(blocks[t], mesh.devices[t, m])
                    for t in range(Tm) for m in range(Mm)])
    return tuple(out)


def _sharded_step(lags, partition_ids, valid, m: int, *, num_consumers: int,
                  members_axis: int, refine_iters: int = 0):
    """One shard's body: its topic block [T_loc, P] through the batched
    rounds (and the per-topic refine), then its member slice of the
    per-member sums (reduced over "topics" by the caller)."""
    choice, counts, totals = assign_topic_rounds(
        lags, partition_ids, valid, num_consumers=num_consumers
    )
    if refine_iters:
        from ..ops.refine import refine_assignment

        choice, counts, totals = refine_assignment(
            lags, valid, choice, num_consumers=num_consumers, iters=refine_iters
        )
    c_local = num_consumers // members_axis
    lo = m * c_local
    return (choice, counts, totals, totals.sum(dim=0)[lo: lo + c_local],
            counts.sum(dim=0)[lo: lo + c_local])


def assign_sharded(mesh: Mesh, lags, partition_ids, valid, num_consumers: int,
                   refine_iters: int = 0):
    """Solve a topic batch sharded over ``mesh``.

    Args: [T, P] arrays (host arrays, tensors, or the lists of
    :func:`shard_topic_batch`) with T divisible by the "topics" axis and
    ``num_consumers`` by the "members" axis; ``refine_iters`` (0 = strict
    parity) chains the per-topic exchange refine onto each shard's topics.
    Returns (choice [T, P], counts [T, C], totals [T, C], member_load [C],
    member_count [C]) on the mesh's first device.
    """
    Tm, Mm = mesh.shape["topics"], mesh.shape["members"]
    C = int(num_consumers)
    if C % Mm:
        raise ValueError(
            f"num_consumers={num_consumers} not divisible by members axis {Mm}"
        )
    if not isinstance(lags, list):
        lags, partition_ids, valid = shard_topic_batch(mesh, lags, partition_ids, valid)
    outs = [
        _sharded_step(lags[i], partition_ids[i], valid[i], i % Mm, num_consumers=C,
                      members_axis=Mm, refine_iters=int(refine_iters))
        for i in range(Tm * Mm)
    ]
    # psum over "topics": each member column reduces its slice.
    load_cols: List[torch.Tensor] = []
    count_cols: List[torch.Tensor] = []
    for m in range(Mm):
        col = [outs[t * Mm + m] for t in range(Tm)]
        load_cols.append(coll.psum([o[3] for o in col])[0])
        count_cols.append(coll.psum([o[4] for o in col])[0])
    lead = mesh.device_list[0]
    rows = [outs[t * Mm] for t in range(Tm)]
    return (
        torch.cat([o[0].to(lead) for o in rows]),
        torch.cat([o[1].to(lead) for o in rows]),
        torch.cat([o[2].to(lead) for o in rows]),
        torch.cat([x.to(lead) for x in load_cols]),
        torch.cat([x.to(lead) for x in count_cols]),
    )


def assign_global_replicated(mesh: Mesh, lags, partition_ids, valid,
                             num_consumers: int):
    """The cross-topic GLOBAL mode on a mesh: REPLICATED, not sharded.  The
    global kernel carries member totals across topics in order, so the
    topic axis cannot be data-parallel without changing the answer; every
    shard runs the identical solve (one K1 launch each; deterministic, so
    the replicas agree bit for bit).  Returns shard 0's (choice [T, P],
    counts [T, C], totals [C])."""
    from ..ops.rounds_kernel import assign_global_rounds

    outs = [
        assign_global_rounds(_as_tensor(lags, dev), _as_tensor(partition_ids, dev),
                             _as_tensor(valid, dev), num_consumers=num_consumers)
        for dev in mesh.device_list
    ]
    return outs[0]
