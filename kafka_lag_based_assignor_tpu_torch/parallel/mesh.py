"""Compatibility shim: the topic-axis mesh backend lives in
:mod:`..sharded.topics`; this module re-exports its names."""

from __future__ import annotations

from ..sharded.topics import (
    assign_global_replicated,
    assign_sharded,
    make_mesh,
    shard_topic_batch,
)

__all__ = [
    "assign_global_replicated",
    "assign_sharded",
    "make_mesh",
    "shard_topic_batch",
]
