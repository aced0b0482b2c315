"""Durable writes.

A copy of ``atomic_write_bytes`` from
``kafka_lag_based_assignor_tpu/utils/snapshot.py``, the helper the flight
recorder (:mod:`.metrics`) and the trace collector (:mod:`.trace`) write
their dumps through.  The lifecycle snapshots themselves
(``SnapshotStore``, its backends, leases and fencing) come with the port's
lifecycle slice.
"""

from __future__ import annotations

import os


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Write ``data`` to a same-directory temp file, fsync, then
    ``os.rename`` over ``path``.  A reader can observe the old file or the
    new file, never a torn mix; a crash mid-write leaves the old file
    untouched.  The temp name carries the pid so two processes pointed at
    one path cannot corrupt each other's staging (the last rename still
    wins, atomically).
    """
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, path)
    except BaseException:
        # Never leave staging litter next to the real file; the rename
        # either happened (tmp is gone) or the write is abandoned.
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
