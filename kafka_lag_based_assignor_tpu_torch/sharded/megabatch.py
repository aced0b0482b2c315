"""Stream-axis (and cross-axis 2-D) placement of the roster-locked megabatch.

Counterpart of ``kafka_lag_based_assignor_tpu/sharded/megabatch.py``.  The
megabatch coalescer (:mod:`..ops.coalesce`) stacks N tenants' warm epochs
into one batched dispatch; the rows are independent (each tenant's refine
touches only its own [B] / [C, M] slices), so the stacked batch splits over a
leading ``("streams",)`` mesh axis with no collective at all:

* :func:`place_rows` splits a locked roster's stacked resident successors
  ``(choice [N, B], row_tab [N, C, M], counts [N, C], lags [N, B])`` once,
  at lock time, and lands each wave's staged host uploads (lags and limits,
  or the delta index / value pairs) on their rows' devices: on the streams
  mesh N/D whole rows a device, on the 2-D ``("streams", "p")`` mesh the
  batch axis flattened over all S*D devices (row-major, as JAX's
  ``PartitionSpec(("streams", "p"))``), every row whole on one device
  (:func:`stream_devices` picks the devices);
* :func:`place_batch` / :func:`place_batch2d` are the JAX names of the same
  split.

A placed tensor is a :class:`RowShards`: the leading-axis blocks, block d on
device d.  Every trailing axis stays whole.  On a placed batch each device
runs the batched refine on its own rows and launches K6's batched entry once
for them (the coalescer's placed wave): D launches a wave instead of one,
each row bit-equal to the unplaced wave's, since the batched refine keeps
every row's loop to itself.

Eligibility: the padded batch axis must cover and divide the mesh
(:func:`shardable`) or the flattened S*D grid (:func:`shardable2d`).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .mesh import SOLVE_AXIS, STREAMS_AXIS, Mesh


def shardable(mesh, n_pad: int) -> bool:
    """True when a padded batch of ``n_pad`` rows splits evenly over
    ``mesh``'s streams axis."""
    if mesh is None:
        return False
    D = mesh.shape[STREAMS_AXIS]
    return D > 1 and n_pad >= D and n_pad % D == 0


def shardable2d(mesh2d, n_pad: int) -> bool:
    """Cross-axis eligibility: the padded batch axis must cover and divide
    the flattened S*D extent."""
    if mesh2d is None:
        return False
    SD = mesh2d.shape[STREAMS_AXIS] * mesh2d.shape[SOLVE_AXIS]
    return SD > 1 and n_pad >= SD and n_pad % SD == 0


class RowShards:
    """A stacked ``[N, ...]`` tensor split on its leading axis: ``parts[d]``
    holds rows ``[d * N/D, (d + 1) * N/D)`` on device d.  It answers the
    reads the coalescer makes of a batch tensor: ``shape``, one row
    (``t[r]``, on the lead device), a copy (:meth:`clone`) and one row's
    replacement (``t[r] = row``)."""

    __slots__ = ("parts", "rows_per")

    def __init__(self, parts: Sequence[torch.Tensor]):
        self.parts = list(parts)
        self.rows_per = int(self.parts[0].shape[0])

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.rows_per * len(self.parts),) + tuple(self.parts[0].shape[1:])

    @property
    def device(self) -> torch.device:
        """The lead device (the coalescer's)."""
        return self.parts[0].device

    def _at(self, row: int) -> Tuple[int, int]:
        row = int(row)
        if not 0 <= row < self.shape[0]:
            raise IndexError(f"row {row} outside [0, {self.shape[0]})")
        return divmod(row, self.rows_per)

    def __getitem__(self, row: int) -> torch.Tensor:
        d, k = self._at(row)
        return self.parts[d][k].to(self.device)

    def __setitem__(self, row: int, value: torch.Tensor) -> None:
        d, k = self._at(row)
        self.parts[d][k] = value.to(self.parts[d].device)

    def clone(self) -> "RowShards":
        return RowShards([p.clone() for p in self.parts])

    def gather(self) -> torch.Tensor:
        """The whole ``[N, ...]`` tensor on the lead device."""
        return torch.cat([p.to(self.device) for p in self.parts])


def stream_devices(mesh: Mesh) -> List[torch.device]:
    """The devices a leading-axis split spreads over: the flattened (S, D)
    grid when the mesh has a "p" extent, else the streams axis (on a 2-D
    mesh with one "p" device, its column 0)."""
    if mesh.shape.get(SOLVE_AXIS, 1) > 1:
        return mesh.device_list
    grid = np.asarray(mesh.devices, dtype=object).reshape(mesh.shape[STREAMS_AXIS], -1)
    return list(grid[:, 0])


def place_rows(mesh: Mesh, *arrays) -> Tuple[RowShards, ...]:
    """Each tensor's leading axis in equal blocks over ``stream_devices``,
    block d copied to device d: a locked batch's stacked resident tensors
    (once a lock, not a flush) and a wave's staged host uploads alike.
    Returns them placed, in input order."""
    devices = stream_devices(mesh)
    return tuple(
        RowShards([b.to(d, copy=True)
                   for b, d in zip(torch.tensor_split(torch.as_tensor(a), len(devices)),
                                   devices)])
        for a in arrays
    )


def place_batch(mesh: Mesh, arrays) -> Tuple[RowShards, ...]:
    """The JAX name and signature (a tuple of arrays) of :func:`place_rows`;
    on the 2-D mesh it spreads the batch over the flattened S*D grid."""
    return place_rows(mesh, *arrays)


place_batch2d = place_batch
