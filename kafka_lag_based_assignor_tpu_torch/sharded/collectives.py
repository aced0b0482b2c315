"""The mesh's collectives over per-shard tensor lists.

A sharded array is a list with one tensor a shard, each on its shard's
device (shard d of a 1-D mesh is ``mesh.device_list[d]``; its position d is
JAX's ``lax.axis_index``).  These functions are the counterparts of
``lax.psum``, ``lax.pmin``, ``lax.pmax`` and ``lax.all_gather`` inside a
``shard_map`` body: each reduces or gathers in shard order on shard 0's
device and returns a FRESH copy on every shard's device, never an alias, so
virtual shards that share one device never share storage.  A float
reduction therefore has one order (shard 0 first) on every mesh.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


def _fan_out(value: torch.Tensor, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """One fresh copy of ``value`` on each shard's device."""
    return [value.to(p.device, copy=True) for p in parts]


def _reduce(parts: Sequence[torch.Tensor], op) -> List[torch.Tensor]:
    acc = parts[0]
    for p in parts[1:]:
        acc = op(acc, p.to(acc.device))
    return _fan_out(acc, parts)


def psum(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The element-wise sum over shards, replicated."""
    return _reduce(parts, torch.add)


def pmin(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The element-wise minimum over shards, replicated."""
    return _reduce(parts, torch.minimum)


def pmax(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The element-wise maximum over shards, replicated."""
    return _reduce(parts, torch.maximum)


def all_gather(parts: Sequence[torch.Tensor], tiled: bool = False) -> List[torch.Tensor]:
    """Every shard's part in shard order, replicated: stacked on a new
    leading axis ([D, ...]), or with ``tiled`` concatenated along axis 0."""
    lead = parts[0].device
    moved = [p.to(lead) for p in parts]
    whole = torch.cat(moved) if tiled else torch.stack(moved)
    return _fan_out(whole, parts)


def broadcast(value: torch.Tensor, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """A value computed once, as a fresh copy on each device."""
    return [value.to(d, copy=True) for d in devices]


def split(host: np.ndarray, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """A host array's axis 0 in ``len(devices)`` equal blocks, block d on
    device d (the ``NamedSharding(PartitionSpec("p"))`` placement)."""
    blocks = np.split(np.ascontiguousarray(host), len(devices))
    return [torch.from_numpy(np.ascontiguousarray(b)).to(d) for b, d in zip(blocks, devices)]


def gather_host(parts: Sequence[torch.Tensor]) -> np.ndarray:
    """The shards' parts concatenated in shard order, as one host array."""
    return np.concatenate([p.cpu().numpy() for p in parts])
