"""P-axis placement of a stream's resident warm state.

Counterpart of ``kafka_lag_based_assignor_tpu/sharded/resident.py``.  The
streaming engine's four resident tensors (padded choice [B], row table
[C, M], counts [C], padded lags [B]) live on one device unless the active
mesh manager elects the P backend for the stream's shape; then
:func:`place_resident` re-places a freshly adopted state over the ("p",)
mesh:

* the two [B] row-axis tensors (choice, lags) split into D contiguous row
  shards, shard d on ``mesh.device_list[d]``;
* the two consumer-axis tensors (row_tab, counts) stay replicated, one copy
  a shard, as the sharded solve holds replicated state (C << P, and the
  exchange refine walks whole per-consumer slices).

Placement moves bytes, not values: :meth:`PlacedResident.gather` returns the
single-device tuple bit for bit, so the digest, quarantine, seed_choice and
snapshot contracts hold unchanged.  The engine digests a placed state shard
by shard (:func:`..ops.refine.state_digest_sharded`), runs its warm refine
on the gathered rows and places the successors again (the JAX partitioner
gathers a row-sharded input of that sort-heavy program the same way).

Eligibility (:func:`shardable_rows`) mirrors the megabatch rule on the other
axis: the padded row bucket must cover and divide the mesh.  A placement
failure is the caller's to handle: it keeps the single-device tensors and
degrades the manager.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .collectives import all_gather
from .mesh import SOLVE_AXIS, Mesh


def shardable_rows(mesh, bucket: int) -> bool:
    """True when a padded row bucket splits evenly over ``mesh``'s "p"
    axis (pow2 buckets over pow2 meshes always divide once ``bucket >=
    D``)."""
    if mesh is None:
        return False
    D = mesh.shape[SOLVE_AXIS]
    return D > 1 and bucket >= D and bucket % D == 0


class PlacedResident:
    """A resident state placed over a ("p",) mesh: ``shards[d]`` is shard
    d's ``(choice int32[Bs], row_tab int32[C, M], counts int32[C], lags
    int64[Bs])`` on its device, ``row_offsets[d]`` the global id of its
    first row.  :meth:`gather` returns the single-device 4-tuple."""

    __slots__ = ("shards", "row_offsets")

    def __init__(self, shards: Sequence[Tuple[torch.Tensor, ...]]):
        self.shards = [tuple(s) for s in shards]
        offsets, lo = [], 0
        for s in self.shards:
            offsets.append(lo)
            lo += int(s[0].shape[0])
        self.row_offsets = offsets

    @property
    def bucket(self) -> int:
        """The padded row count B of the whole state."""
        return self.row_offsets[-1] + int(self.shards[-1][0].shape[0])

    @property
    def table_shape(self) -> Tuple[int, int]:
        """(C, M) of the replicated row table."""
        return tuple(self.shards[0][1].shape)

    @property
    def devices(self) -> List[torch.device]:
        """Each shard's device, in shard order."""
        return [s[0].device for s in self.shards]

    @property
    def choice_shards(self) -> List[torch.Tensor]:
        return [s[0] for s in self.shards]

    @property
    def lag_shards(self) -> List[torch.Tensor]:
        return [s[3] for s in self.shards]

    def owner(self, row: int) -> Tuple[int, int]:
        """(shard, local index) of global row ``row``."""
        for d in range(len(self.shards) - 1, -1, -1):
            if row >= self.row_offsets[d]:
                return d, row - self.row_offsets[d]
        raise IndexError(row)

    def gather(self) -> Tuple[torch.Tensor, ...]:
        """The single-device ``(choice, row_tab, counts, lags)`` on the lead
        shard's device: the row shards gathered in order (the mesh's
        ``all_gather``), the lead's replicated copies."""
        lead = self.shards[0]
        choice = all_gather(self.choice_shards, tiled=True)[0]
        lags = all_gather(self.lag_shards, tiled=True)[0]
        return choice, lead[1].clone(), lead[2].clone(), lags


def place_resident(mesh: Mesh, resident) -> PlacedResident:
    """Place a freshly adopted resident 4-tuple ``(choice [B], row_tab [C,
    M], counts [C], lags [B])`` with the P-axis layout: the row tensors
    split over "p", the consumer-axis tensors replicated.  Values are
    unchanged, so :meth:`PlacedResident.gather` gives the input back bit for
    bit.  Every placed tensor is a fresh copy, never an alias of the
    input (virtual shards share a device)."""
    choice, row_tab, counts, lags = resident
    devices = mesh.device_list
    return PlacedResident([
        (c.to(d, copy=True), row_tab.to(d, copy=True), counts.to(d, copy=True),
         lg.to(d, copy=True))
        for c, lg, d in zip(torch.tensor_split(choice, len(devices)),
                            torch.tensor_split(lags, len(devices)), devices)
    ])
