"""Lane padding shared by the quality kernels.

A copy of ``LANE`` and ``lane_pad`` from
``kafka_lag_based_assignor_tpu/ops/kernel_admission.py``.  The TPU kernels
padded the consumer axis to a multiple of the 128-lane vector width; the
port keeps that padded geometry, because the mirror-prox step's
extrapolation mean is a sum over the padded consumer axis
(:func:`.linear_ot._mean_padded`) and both packages must reduce over the
same element count.  The VMEM admission model of the JAX module has no
counterpart here: a CUDA kernel states its own limits and raises on inputs
outside them.
"""

from __future__ import annotations

#: The TPU's lane width, the unit the consumer axis is padded to.
LANE = 128


def lane_pad(n: int) -> int:
    """``n`` padded up to a full lane multiple (>= one lane)."""
    return max(LANE, -(-int(n) // LANE) * LANE)
