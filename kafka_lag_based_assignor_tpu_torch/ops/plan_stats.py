"""Implicit transport-plan statistics: the dense Sinkhorn solver's hot op.

Counterpart of ``kafka_lag_based_assignor_tpu/ops/plan_stats.py``.  The
Sinkhorn solver's log-plan is rank-structured
(:mod:`..models.sinkhorn`)::

    logX[p, j] = noise(p, j) - ws_p * A_j + B_j     (ws_p = lag_p / scale)

up to a per-row normalizer that cancels in the softmax, so the [P, C] plan
never exists in memory.  Each duals iteration needs only the plan's two
marginals (one a half-step, asked for with ``need``), and rows with equal
scaled lag have identical noise-free rows, so the marginals collapse onto
the deduplicated lag-value axis u::

    load_j   = sum_u  wsum_u  * X_u[j]     (scaled consumer loads)
    colsum_j = sum_u  count_u * X_u[j]     (count marginal)

:func:`plan_stats` is the wrapper: a CUDA tensor launches the hand-written
kernel of ``csrc/plan_stats.cu`` (:mod:`.plan_stats_cuda`) and counts the
launch in ``plan_stats.launches``; a CPU tensor runs
:func:`plan_stats_torch`, the plain version.  The per-(p, j) hash noise is
used only by the rounding helpers (:func:`implicit_plan_rows`,
:func:`implicit_plan_argmax`) as a deterministic tie-break.
"""

from __future__ import annotations

import torch

from ._build import count_launch

# Hash-noise amplitude: large enough to break the symmetric fixpoint of
# mirror descent (all-identical consumers), small enough not to distort
# the converged plan.
NOISE_AMP = 0.02

#: Rows per tile of the plain version and of the argmax streaming.
_TILE_P = 512
#: One block of the argmax streaming holds at most 1/_ARGMAX_SHARE of the
#: [P, C] f32 plan's logits: whole tiles, at least one and at most 64.
_ARGMAX_SHARE = 32


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to the int32 they wrap to (two's complement)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def noise(p_idx: torch.Tensor, j_idx: torch.Tensor) -> torch.Tensor:
    """Deterministic per-(partition, consumer) symmetry-breaking noise in
    [-NOISE_AMP/2, NOISE_AMP/2], from the JAX package's int32 hash (Knuth
    multiplicative mixing).  The int32 products wrap and the shifts are
    arithmetic; both are done here in int64 with an explicit wrap, so the
    bits are the JAX package's on every device."""
    h = _wrap32(
        _wrap32(p_idx.to(torch.int64) * -1640531527)
        + _wrap32(j_idx.to(torch.int64) * 40503)
    )
    h = h ^ (h >> 15)
    h = _wrap32(h * -1028477387)
    h = h ^ (h >> 13)
    u = (h >> 8) & 0xFFFF
    # Python scalars enter a float32 op as float32, as the JAX package's
    # explicit jnp.float32 constants do.
    return NOISE_AMP * (u.to(torch.float32) / 65536.0 - 0.5)


def implicit_plan_rows(p_idx, ws, A, B) -> torch.Tensor:
    """Rows of the implicit plan: X[p] = softmax_j(logits) for the given
    partition indices.  p_idx int[R], ws f32[R], A/B f32[C] -> f32[R, C]."""
    j = torch.arange(A.shape[0], dtype=torch.int32, device=A.device)
    logits = noise(p_idx[:, None], j[None, :]) - ws[:, None] * A[None, :] + B[None, :]
    return torch.softmax(logits, dim=1)


def implicit_plan_argmax(ws, valid, A, B, tie_noise: bool = True) -> torch.Tensor:
    """Each partition's most-preferred consumer under the implicit plan,
    argmax_j(noise(p, j) - ws_p * A_j + B_j) (the first index on ties),
    streamed over row tiles so live memory stays one (tile, C) block.
    Invalid rows return C.  int32[P].  ``tie_noise=False`` drops the hash
    term (the parallel rounding's capacity repair redistributes ties)."""
    P, C = ws.shape[0], A.shape[0]
    j = torch.arange(C, dtype=torch.int32, device=A.device)
    out = torch.empty(P, dtype=torch.int32, device=ws.device)
    # Blocks of up to 64 of the JAX package's 512-row tiles, 1/_ARGMAX_SHARE
    # of the rows: the rows are independent, so the block size changes no
    # result.
    step = _TILE_P * max(1, min(64, P // (_ARGMAX_SHARE * _TILE_P)))
    for lo in range(0, P, step):
        w = ws[lo: lo + step]
        # -w * A + B with the add in place: one block live at a time.
        logits = torch.mul(-w[:, None], A[None, :]).add_(B[None, :])
        if tie_noise:
            p = torch.arange(lo, lo + w.shape[0], dtype=torch.int32, device=ws.device)
            logits += noise(p[:, None], j[None, :])
        out[lo: lo + step] = torch.argmax(logits, dim=1).to(torch.int32)
        del logits
    return torch.where(valid, out, C)


def _check(ws_u, count_u, wsum_u, A, B) -> None:
    if ws_u.device.type not in ("cuda", "cpu"):
        raise ValueError(f"plan_stats runs on cuda or cpu, not {ws_u.device}")
    U, C = ws_u.shape[0], A.shape[0]
    for name, t, n in (("ws_u", ws_u, U), ("count_u", count_u, U),
                       ("wsum_u", wsum_u, U), ("A", A, C), ("B", B, C)):
        if t.dtype != torch.float32 or tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be float32[{n}], got {t.dtype}"
                             f"{list(t.shape)}")
        if t.device != ws_u.device:
            raise ValueError("plan_stats inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if U < 1:
        raise ValueError("plan_stats needs at least one value row")
    if C < 1:
        raise ValueError(f"plan_stats takes 1 or more consumers, got {C}")


def plan_stats_torch(ws_u, count_u, wsum_u, A, B, need: str = "both"):
    """Plain PyTorch version: the ``plan_stats_lax`` tile loop.  Each
    512-row value tile's softmax and its weighted column sums, then the
    tiles summed.  Returns (load f32[C] in ws units, colsum f32[C]), with
    None for the marginal ``need`` leaves out (its reduction is skipped)."""
    U = ws_u.shape[0]
    loads, cols = [], []
    for lo in range(0, U, _TILE_P):
        w = ws_u[lo: lo + _TILE_P]
        x = torch.softmax(-w[:, None] * A[None, :] + B[None, :], dim=1)
        if need != "colsum":
            loads.append((wsum_u[lo: lo + _TILE_P, None] * x).sum(dim=0))
        if need != "load":
            cols.append((count_u[lo: lo + _TILE_P, None] * x).sum(dim=0))
    return (torch.stack(loads).sum(dim=0) if loads else None,
            torch.stack(cols).sum(dim=0) if cols else None)


def plan_stats(ws_u, count_u, wsum_u, A, B, need: str = "both"):
    """The marginals of the implicit plan on the deduplicated value axis.

    Args: ws_u, count_u, wsum_u f32[U] (padding rows carry count = wsum =
    0 and contribute nothing); A, B f32[C], C >= 1; ``need`` is
    "both", "load" or "colsum", as in the JAX package (each duals half-step
    consumes one marginal).  Returns (load f32[C], colsum f32[C]) with None
    in the place ``need`` leaves out; a marginal has the same bits whether
    it was asked for alone or beside the other.  A CUDA tensor launches the
    kernel (one count in ``plan_stats.launches``) or raises; a CPU tensor
    runs :func:`plan_stats_torch`.
    """
    _check(ws_u, count_u, wsum_u, A, B)
    if need not in ("both", "load", "colsum"):
        raise ValueError(f"need must be 'both', 'load' or 'colsum', got {need!r}")
    if ws_u.device.type == "cpu":
        return plan_stats_torch(ws_u, count_u, wsum_u, A, B, need)
    from .plan_stats_cuda import launch

    out = launch(ws_u, count_u, wsum_u, A, B, need)
    count_launch(plan_stats)
    return out


plan_stats.launches = 0
