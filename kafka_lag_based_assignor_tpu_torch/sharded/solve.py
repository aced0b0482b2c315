"""P-axis-sharded solve: seed sort, plan stats, exchange refine and the
linear-OT quality solve over a device mesh.

Counterpart of ``kafka_lag_based_assignor_tpu/sharded/solve.py``.  The
PARTITION axis shards over the manager's 1-D ``("p",)`` mesh
(:mod:`.mesh`); the consumer-axis state (per-consumer totals, counts, duals,
C << P) is REPLICATED, one copy a shard, and all-reduced per round with the
collectives of :mod:`.collectives`.  Each JAX ``shard_map`` + ``while_loop``
program is a host loop of rounds here: every round runs each shard's body
on its own rows, then the collectives, then ONE host read for the stop test.

* **Seed** (:func:`_seed_local`): each shard sorts its rows lag-descending,
  a one-scalar all-gather fixes its global valid-rank offset, and the row of
  global rank g takes consumer ``g % C``: count-balanced at any mesh size.
* **Refine** (:func:`_refine_loop`): the round structure of
  :func:`..ops.refine.refine_assignment` over each shard's rows, then a
  ``pmin`` winner election per pair (ties to the lowest shard) and a
  ``psum`` fold of the winner's transfer into the replicated totals.  At
  mesh size 1 it IS ``refine_assignment``; at 2-8 swaps are found within a
  shard, so the result is count-balanced and quality-gated, not bit-equal.
* **Plan stats** (:func:`plan_stats_sharded`): shard-local segment sums and
  one ``psum``.
* **Linear-OT duals** (:func:`solve_linear_sharded`): each shard runs K5
  (:func:`..ops.linear_ot_cuda.superblock_partials`) on its own S/D of the
  fixed S superblocks, one all-gather an evaluation puts the partials in
  global block order, and the ordered combine and the dual update run on
  every shard.  The decomposition and the combine order do not depend on
  the mesh size, so the duals, and the rounded assignment, are bit-identical
  at every mesh size.  The single-device path takes the fused step (K4) on
  the card; K4 and K5 are each held to their plain versions only to f32
  tolerance there, so on the card the two may differ in the last bits.
* **The rounding tail** (:func:`_finish_sharded_tail`): the parallel
  rounding of :func:`..models.sinkhorn._round_refine_portfolio` with every
  P-sized sort replaced by shard-local sorts and a lexicographic rank
  election (:func:`_lex_rank`), the sorted layouts rebuilt replicated by
  permutation scatters, a closed-form overflow seat table, a distributed
  build of the refine's row table, and then the greedy twin (K1 through
  :func:`..ops.rounds_kernel._rounds_scan`) and the exchange refine
  (:func:`..ops.refine.refine_rounds_resident`) on the replicated rows: the
  single-device tail's bits.  Those two replicated computations run once, on
  shard 0, and their outputs are copied to every shard (the JAX program
  computes them on every device; the bits are the same).

Dispatch boundary: the solve entries fire ``mesh.collective`` on entry and
hold :func:`.mesh.dispatch_gate`; callers (the streaming engine's cold hook)
degrade the manager and serve single-device on any failure.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops.packing import pad_bucket, pad_chunk
from ..ops.refine import _PAIR_BITS, _SBIG, _VBITS
from ..ops.sortops import (
    bincount_sorted,
    lexsort,
    segment_argmin_first,
    segment_sum,
    sort_with,
)
from ..utils import faults, metrics
from . import collectives as coll
from .mesh import SOLVE_AXIS, Mesh, dispatch_gate

_I64MAX = torch.iinfo(torch.int64).max
_I32MAX = torch.iinfo(torch.int32).max

Parts = List[torch.Tensor]


def _quant_shift_all(lags: Parts, assigned: Parts) -> Parts:
    """:func:`..ops.refine._quant_shift` with the max taken over EVERY shard
    (``pmax``), so all shards quantize alike; the identity at mesh size 1."""
    maxlag = coll.pmax([
        torch.clamp(torch.where(a, x, 0).amax(), min=1)
        for x, a in zip(lags, assigned)
    ])
    out = []
    for m in maxlag:
        shifts = torch.arange(63, dtype=torch.int64, device=m.device)
        bitlen = ((m >> shifts) > 0).sum()
        out.append(torch.clamp(bitlen - _VBITS, min=0))
    return out


def _seed_local(lags, valid, num_consumers: int, counts_all, d: int):
    """Count-balanced seed of shard ``d``: local lag-descending stable sort,
    the global valid-rank offset from the gathered valid counts
    ``counts_all`` [D], consumer = global rank mod C.  Returns choice
    int32[L] in local input order (-1 on padding)."""
    L = lags.shape[0]
    dev = lags.device
    arange_l = torch.arange(L, dtype=torch.int32, device=dev)
    key = torch.where(valid, -lags, _I64MAX)
    _, srow = sort_with(key, arange_l)
    v_loc = valid.sum(dtype=torch.int32)
    offset = counts_all[:d].sum(dtype=torch.int32)
    g = offset + arange_l
    seat = torch.where(arange_l < v_loc, g % int(num_consumers), -1).to(torch.int32)
    out = torch.zeros(L, dtype=torch.int32, device=dev)
    out[srow.long()] = seat
    return out


def _pairing(totals, counts, it: int, C: int, K: int):
    """The replicated round header of one shard: the consumers ranked by
    total, the K heavy/light pairs (light partners rotating each round),
    each pair's gap and the per-consumer (pair, side, move allowed) table."""
    dev = totals.device
    n_light = C - K
    kk = torch.arange(K, device=dev)
    order = torch.argsort(totals, stable=True)
    rank = torch.empty_like(order).scatter_(0, order, torch.arange(C, device=dev))
    light_slot = (kk + it % n_light) % n_light
    light = order[light_slot]
    heavy = order[C - 1 - kk]
    diff = totals[heavy] - totals[light]
    slot_to_pair = torch.full((n_light,), K, dtype=torch.int64, device=dev)
    slot_to_pair[light_slot] = kk
    pair_of = torch.where(rank < n_light,
                          slot_to_pair[torch.clamp(rank, 0, n_light - 1)],
                          C - 1 - rank)
    heavy_side = rank >= C - K
    move_ok_pair = counts[heavy] > counts[light]
    move_ok_pad = torch.cat([move_ok_pair, move_ok_pair.new_zeros(1)])
    move_ok_of = heavy_side & move_ok_pad[torch.clamp(pair_of, 0, K)]
    combo_tab = (pair_of | (heavy_side.to(torch.int64) << _PAIR_BITS)
                 | (move_ok_of.to(torch.int64) << (_PAIR_BITS + 1)))
    return light, heavy, diff, combo_tab


def _local_candidates(lags, assigned, choice, pshift, diff, combo_tab, C: int, K: int):
    """One shard's candidate search of a round (the oracle's key layout):
    the round sort of the shard's rows, the nearest light neighbours and
    the per-pair segmented argmin.  Returns (minv int64[K], widx int32[K],
    nb_sel, srow, slag)."""
    L = lags.shape[0]
    dev = lags.device
    arange_l = torch.arange(L, device=dev)
    vmask = (1 << _VBITS) - 1
    safe_choice = torch.clamp(choice, 0, C - 1).to(torch.int64)
    combo = torch.where(assigned, combo_tab[safe_choice], -1)
    k_p = combo & ((1 << _PAIR_BITS) - 1)
    row_heavy = (combo >> _PAIR_BITS) & 1
    row_move_ok = (combo >> (_PAIR_BITS + 1)) & 1
    participates = (combo >= 0) & (k_p < K)
    diff_p = torch.where(participates, diff[torch.clamp(k_p, 0, K - 1)], 0)
    tgt = torch.clamp(lags - (diff_p >> 1), min=0) >> pshift
    qval = torch.where(row_heavy == 1, tgt, lags >> pshift)
    key = torch.where(
        participates,
        (k_p << (_VBITS + 1)) | (torch.clamp(qval, 0, vmask) << 1) | row_heavy,
        _I64MAX,
    )
    skey, slag, srow, smove_ok = sort_with(key, lags, arange_l, row_move_ok)
    part_s = skey < _I64MAX
    pair_s = skey >> (_VBITS + 1)
    heavy_s = part_s & ((skey & 1) == 1)
    light_s = part_s & ((skey & 1) == 0)
    qlag_s = slag >> pshift
    diff_s = torch.where(heavy_s, diff[torch.clamp(pair_s, 0, K - 1)], 0)
    delta_q_s = (diff_s >> 1) >> pshift
    diff_q_s = diff_s >> pshift
    prev_l = torch.cummax(torch.where(light_s, arange_l, -1), dim=0).values
    nxt_l = torch.cummin(torch.where(light_s, arange_l, L).flip(0), dim=0).values.flip(0)

    def neighbour(nb):
        nkey = skey[torch.clamp(nb, 0, L - 1)]
        okq = ((nb >= 0) & (nb < L) & ((nkey & 1) == 0)
               & ((nkey >> (_VBITS + 1)) == pair_s))
        d_q = qlag_s - ((nkey >> 1) & vmask)
        ok = heavy_s & okq & (d_q > 0) & (d_q < diff_q_s)
        return torch.where(ok, (d_q - delta_q_s).abs(), _SBIG)

    err_a = neighbour(prev_l)
    err_b = neighbour(nxt_l)
    use_b = err_b < err_a
    err_swap = torch.where(use_b, err_b, err_a)
    nb_sel = torch.where(use_b, nxt_l, prev_l)
    ok_move = heavy_s & (smove_ok == 1) & (slag > 0) & (slag < diff_s)
    score_move = torch.where(ok_move, (qlag_s - delta_q_s).abs(), _SBIG)
    combined = torch.where(score_move <= err_swap, score_move << 1,
                           (err_swap << 1) | 1)
    seg_h = torch.where(heavy_s, pair_s, K)
    minv, widx = segment_argmin_first(combined, seg_h, K, L)
    return minv, widx, nb_sel, srow, slag


def _refine_loop(lags: Parts, valid: Parts, choice: Parts, num_consumers: int,
                 iters: int, max_pairs: Optional[int], patience: int):
    """The :func:`..ops.refine.refine_assignment` round loop over each
    shard's rows, with the replicated consumer-axis state all-reduced per
    round (one ``pmin`` winner election, one ``psum`` transfer fold) and one
    host read a round (the stop test, from shard 0's replica).  Returns
    (choice parts int32, counts parts int32[C], totals parts int64[C],
    rounds)."""
    C = int(num_consumers)
    D = len(lags)
    K = max(1, min(C // 2, max_pairs if max_pairs is not None else C // 2))
    if K >= (1 << _PAIR_BITS) - 1:
        raise ValueError(
            f"max_pairs={K} exceeds the packed pair-id field ({_PAIR_BITS} bits)"
        )
    choice = [c.to(torch.int32) for c in choice]
    assigned = [v & (c >= 0) for v, c in zip(valid, choice)]
    seg0 = [torch.where(a, c, -1) for a, c in zip(assigned, choice)]
    totals = coll.psum([segment_sum(torch.where(a, x, 0), s, C)
                        for x, a, s in zip(lags, assigned, seg0)])
    counts = coll.psum([bincount_sorted(s, C) for s in seg0])
    if C < 2 or iters <= 0:
        return choice, counts, totals, 0
    pshift = _quant_shift_all(lags, assigned)
    it = since = 0
    while it < iters and since < patience:
        heads = [_pairing(totals[d], counts[d], it, C, K) for d in range(D)]
        cands = [
            _local_candidates(lags[d], assigned[d], choice[d], pshift[d],
                              heads[d][2], heads[d][3], C, K)
            for d in range(D)
        ]
        # Per-pair winner election across shards: the smallest packed score
        # wins, ties to the lowest shard index.
        gmin = coll.pmin([c[0] for c in cands])
        win_d = coll.pmin([
            torch.where(c[0] == g, d, D).to(torch.int32)
            for d, (c, g) in enumerate(zip(cands, gmin))
        ])
        moves = []
        for d in range(D):
            minv, widx, nb_sel, srow, slag = cands[d]
            L = lags[d].shape[0]
            mine = win_d[d] == d
            do = gmin[d] < (_SBIG << 1)
            is_swap = (gmin[d] & 1) == 1
            wclip = torch.clamp(widx, 0, L - 1).long()
            p_sel = srow[wclip]
            lag_p = slag[wclip]
            nb_k = torch.clamp(nb_sel[wclip], 0, L - 1)
            q_sel = srow[nb_k]
            lag_q = slag[nb_k]
            use_swap = do & is_swap
            d_amt = torch.where(do, torch.where(use_swap, lag_p - lag_q, lag_p), 0)
            moves.append((mine, do, is_swap, use_swap, p_sel, q_sel,
                          torch.where(mine, d_amt, 0)))
        # The winner's exact transfer, folded into the replicated totals
        # (only the winning shard contributes).
        d_k = coll.psum([m[6] for m in moves])
        peak_dropped = None
        for d in range(D):
            mine, do, is_swap, use_swap, p_sel, q_sel, _ = moves[d]
            light, heavy, _, _ = heads[d]
            L = lags[d].shape[0]
            ext = torch.cat([choice[d], choice[d].new_zeros(1)])
            ext[torch.where(mine & do, p_sel, L)] = light.to(torch.int32)
            ext[torch.where(mine & use_swap, q_sel, L)] = heavy.to(torch.int32)
            choice[d] = ext[:L]
            new_totals = totals[d].clone()
            new_totals.scatter_add_(0, heavy, -d_k[d])
            new_totals.scatter_add_(0, light, d_k[d])
            dc = (do & ~is_swap).to(counts[d].dtype)
            new_counts = counts[d].clone()
            new_counts.scatter_add_(0, heavy, -dc)
            new_counts.scatter_add_(0, light, dc)
            if d == 0:
                peak_dropped = new_totals.amax() < totals[d].amax()
            totals[d], counts[d] = new_totals, new_counts
        since = 0 if bool(peak_dropped) else since + 1
        it += 1
    return choice, counts, totals, it


def shard_bucket(num_rows: int, num_shards: int, device="cuda") -> int:
    """Padded solve shape: the streaming buckets (pow2 on the card, 4096-row
    chunks on the CPU, picked by ``device`` as the JAX package picks by
    backend) rounded up to a multiple of the mesh size."""
    B = pad_chunk(num_rows) if torch.device(device).type == "cpu" else pad_bucket(num_rows)
    D = int(num_shards)
    if B % D:
        B += D - (B % D)
    return B


def _devices(mesh: Mesh) -> List[torch.device]:
    if tuple(mesh.axis_names) != (SOLVE_AXIS,):
        raise ValueError(f"the P-sharded solve needs a ('p',) mesh, got {mesh.axis_names}")
    return mesh.device_list


def _place_inputs(mesh: Mesh, *host_arrays):
    """Split padded host inputs over the "p" axis: each shard's block lands
    on its device (no host gather)."""
    devs = _devices(mesh)
    return tuple(coll.split(a, devs) for a in host_arrays)


def solve_sharded(mesh: Mesh, lags: np.ndarray, num_consumers: int,
                  refine_iters: int = 64, max_pairs: Optional[int] = None,
                  patience: int = 8):
    """One P-axis-sharded cold solve (seed + exchange refine) on ``mesh``.

    ``lags`` is the exact host [P] int64 vector; padding to the
    mesh-divisible bucket happens here.  Fires ``mesh.collective`` on entry.
    Returns host ``(choice int32[P] in input order, counts int32[C], totals
    int64[C], rounds)``; the choice is count-balanced at any mesh size.
    """
    faults.fire("mesh.collective")
    C = int(num_consumers)
    lags = np.ascontiguousarray(lags, dtype=np.int64)
    P_len = int(lags.shape[0])
    D = mesh.shape[SOLVE_AXIS]
    B = shard_bucket(P_len, D, _devices(mesh)[0])
    lags_p = np.zeros(B, dtype=np.int64)
    lags_p[:P_len] = lags
    valid = np.zeros(B, dtype=bool)
    valid[:P_len] = True
    with metrics.span("sharded.solve"), dispatch_gate():
        lags_d, valid_d = _place_inputs(mesh, lags_p, valid)
        v_all = coll.all_gather([v.sum(dtype=torch.int32) for v in valid_d])
        seed = [_seed_local(x, v, C, g, d)
                for d, (x, v, g) in enumerate(zip(lags_d, valid_d, v_all))]
        choice, counts, totals, rounds = _refine_loop(
            lags_d, valid_d, seed, C, int(refine_iters), max_pairs, int(patience)
        )
        choice_np = coll.gather_host(choice)
        counts_np, totals_np = counts[0].cpu().numpy(), totals[0].cpu().numpy()
    metrics.REGISTRY.counter("klba_sharded_dispatch_total", {"path": "solve"}).inc()
    return choice_np[:P_len].astype(np.int32), counts_np, totals_np, int(rounds)


def refine_sharded(mesh: Mesh, lags: np.ndarray, valid: np.ndarray,
                   choice: np.ndarray, num_consumers: int, iters: int = 16,
                   max_pairs: Optional[int] = None, patience: int = 8):
    """The P-sharded equivalent of :func:`..ops.refine.refine_assignment`:
    bit-identical to it at mesh size 1, count-preserving and quality-gated
    at sizes 2-8.  Inputs are host arrays of one padded length divisible by
    the mesh size.  Returns host ``(choice int32[P], counts, totals,
    rounds)``."""
    faults.fire("mesh.collective")
    C = int(num_consumers)
    D = mesh.shape[SOLVE_AXIS]
    lags = np.ascontiguousarray(lags, dtype=np.int64)
    if lags.shape[0] % D:
        raise ValueError(
            f"refine_sharded input length {lags.shape[0]} must divide the "
            f"mesh size {D} (pad with valid=False rows)"
        )
    with metrics.span("sharded.refine"), dispatch_gate():
        lags_d, valid_d, choice_d = _place_inputs(
            mesh, lags, np.ascontiguousarray(valid, dtype=bool),
            np.ascontiguousarray(choice, dtype=np.int32),
        )
        out_c, counts, totals, rounds = _refine_loop(
            lags_d, valid_d, choice_d, C, int(iters), max_pairs, int(patience)
        )
        choice_np = coll.gather_host(out_c)
        counts_np, totals_np = counts[0].cpu().numpy(), totals[0].cpu().numpy()
    metrics.REGISTRY.counter("klba_sharded_dispatch_total", {"path": "refine"}).inc()
    return choice_np.astype(np.int32), counts_np, totals_np, int(rounds)


def plan_stats_sharded(mesh: Mesh, lags, valid, choice, num_consumers: int):
    """Sharded plan stats: per-consumer ``(totals int64[C], counts
    int32[C])`` of an assignment from shard-local segment sums and one
    ``psum``.  Inputs are host arrays of one mesh-divisible padded length."""
    C = int(num_consumers)
    with dispatch_gate():
        lags_d, valid_d, choice_d = _place_inputs(
            mesh, np.ascontiguousarray(lags, dtype=np.int64),
            np.ascontiguousarray(valid, dtype=bool),
            np.ascontiguousarray(choice, dtype=np.int32),
        )
        segs = [torch.where(v & (c >= 0), c, -1) for v, c in zip(valid_d, choice_d)]
        totals = coll.psum([segment_sum(torch.where(s >= 0, x, 0), s, C)
                            for x, s in zip(lags_d, segs)])
        counts = coll.psum([bincount_sorted(s, C) for s in segs])
    return totals[0].cpu().numpy(), counts[0].cpu().numpy()


# ---------------------------------------------------------------------------
# Linear-OT duals, P-sharded
# ---------------------------------------------------------------------------


def _linear_duals_sharded(lags: Parts, valid: Parts, scale: float, n_valid: float,
                          num_consumers: int, iters: int, tile: int):
    """The mirror-prox duals with the marginals P-sharded: each shard's K5
    over its own S/D superblocks (the global decomposition: shard d owns
    blocks d*S/D .. (d+1)*S/D - 1, padding at the global tail), one
    all-gather an evaluation into global block order, then the ordered
    combine and the update of :func:`..ops.linear_ot.mirror_prox` on every
    shard.  Returns (A parts, B parts, rounds)."""
    from ..ops import linear_ot
    from ..ops.linear_ot_cuda import superblock_partials

    C = int(num_consumers)
    D = len(lags)
    S = linear_ot._SUPERBLOCKS
    eta = linear_ot.MIRROR_PROX_ETA
    blocks = []
    for x, v in zip(lags, valid):
        ws, cnt = linear_ot._ws_cnt(x, v, scale)
        L = x.shape[0]
        blocks.append((linear_ot._to_blocks(ws, L, S // D, tile),
                       linear_ot._to_blocks(cnt, L, S // D, tile)))

    def marginals(A: Parts, B: Parts, colsum: bool):
        parts = [superblock_partials(wb, cb, a, b)
                 for (wb, cb), a, b in zip(blocks, A, B)]
        load = [linear_ot._ordered_sum(p) for p in coll.all_gather(
            [p[0] for p in parts], tiled=True)]
        if not colsum:
            return load, None
        col = [linear_ot._ordered_sum(p) for p in coll.all_gather(
            [p[1] for p in parts], tiled=True)]
        return load, col

    devs = [x.device for x in lags]
    f32 = dict(dtype=torch.float32)
    cap = [torch.tensor(max(float(n_valid), 1.0), device=d, **f32) / C for d in devs]
    A = [torch.zeros(C, device=d, **f32) for d in devs]
    B = [linear_ot._noise_seed(C, d) for d in devs]
    sc = [torch.tensor(1.0, device=d, **f32) for d in devs]
    prev = [torch.tensor(float("inf"), device=d, **f32) for d in devs]
    it = 0
    while it < iters:
        load1, _ = marginals(A, B, colsum=False)
        spread = [l1.max() - l1.min() for l1 in load1]
        sc = [torch.where(s > p, c * 0.5, torch.clamp(c * 1.2, max=1.0))
              for s, p, c in zip(spread, prev, sc)]
        A_half = [a + (eta * c) * (l1 - linear_ot._mean_padded(l1))
                  for a, c, l1 in zip(A, sc, load1)]
        load2, col2 = marginals(A_half, B, colsum=True)
        A = [a + (eta * c) * (l2 - linear_ot._mean_padded(l2))
             for a, c, l2 in zip(A, sc, load2)]
        upd = [torch.log(cp / (c2 + 1e-9)) for cp, c2 in zip(cap, col2)]
        B = [b + u for b, u in zip(B, upd)]
        delta = torch.maximum(spread[0], upd[0].abs().max())
        prev = spread
        it += 1
        if not bool(delta > 2e-5):
            break
    return A, B, it


# ---------------------------------------------------------------------------
# P-sharded rounding tail
# ---------------------------------------------------------------------------


def _bincount_scatter(vals, num_segments: int):
    """Sort-free integer histogram over bins 0..S-1 (out-of-range values not
    counted): the ints of :func:`..ops.sortops.bincount_sorted`.  int32[S]."""
    S = int(num_segments)
    in_range = (vals >= 0) & (vals < S)
    out = torch.zeros(S, dtype=torch.int32, device=vals.device)
    return out.index_add_(0, torch.clamp(vals, 0, S - 1).long(), in_range.to(torch.int32))


def _segsum_scatter(vals, seg, num_segments: int):
    """Sort-free integer segment sum (exact on ints in any order)."""
    S = int(num_segments)
    in_range = (seg >= 0) & (seg < S)
    out = torch.zeros(S, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, torch.clamp(seg, 0, S - 1).long(),
                          torch.where(in_range, vals, 0))


def _lex_rank(sorted_keys: Sequence[torch.Tensor], query_keys: Sequence[torch.Tensor]):
    """Global rank of each query row under the lexicographic order of the
    composite key, WITHOUT a cross-shard sort: ``sorted_keys`` are per-key
    ``[D, L]`` gathers of every shard's locally sorted key columns,
    ``query_keys`` the per-key ``[N]`` local queries.  The rank is the count
    of entries strictly below the query over every shard's column, found by
    a vectorized lexicographic binary search (``L.bit_length()`` steps of
    ``[N, D]`` gathers; ``jnp.searchsorted(side="left")`` per column).
    Callers end the key with the unique global row id, so the count IS the
    row's position in the virtual global sort.  int32[N]."""
    D, L = sorted_keys[0].shape
    N = query_keys[0].shape[0]
    dev = query_keys[0].device
    lo = torch.zeros((N, D), dtype=torch.int64, device=dev)
    hi = torch.full((N, D), L, dtype=torch.int64, device=dev)
    cols = [k.t() for k in sorted_keys]          # [L, D]
    for _ in range(max(1, int(L).bit_length())):
        active = lo < hi
        mid = torch.clamp((lo + hi) >> 1, max=L - 1)
        less = torch.zeros((N, D), dtype=torch.bool, device=dev)
        tie = torch.ones((N, D), dtype=torch.bool, device=dev)
        for col, q in zip(cols, query_keys):
            v = col.gather(0, mid)
            qq = q[:, None]
            less = less | (tie & (v < qq))
            tie = tie & (v == qq)
        lo = torch.where(active & less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)
    return lo.sum(dim=1).to(torch.int32)


def _rank_scatter(rank_loc: Parts, val_loc: Parts, P2: int) -> Parts:
    """The replicated SORTED-LAYOUT array from per-shard values and their
    global ranks: gather both, then one permutation scatter (ranks are
    unique).  How the tail builds ``x[perm]`` without sorting [P2]."""
    ranks = coll.all_gather(rank_loc, tiled=True)
    vals = coll.all_gather(val_loc, tiled=True)
    return [torch.zeros(P2, dtype=v.dtype, device=v.device).index_put_((r.long(),), v)
            for r, v in zip(ranks, vals)]


def _gathered_rank(keys_by_shard: List[Sequence[torch.Tensor]]) -> Parts:
    """Each shard's rows' global ranks under the composite key (a local
    lexicographic sort, a per-key all-gather, :func:`_lex_rank`)."""
    cols = []
    for keys in keys_by_shard:
        perm = lexsort(*keys)
        cols.append([k[perm] for k in keys])
    gathered = [coll.all_gather([c[k] for c in cols])
                for k in range(len(keys_by_shard[0]))]
    return [_lex_rank([g[d] for g in gathered], keys)
            for d, keys in enumerate(keys_by_shard)]


def _seat_table(rem, kept_load, cap_max: int, C: int):
    """The closed-form overflow seating: ``cum_slots[r]`` open slots precede
    round r, and ``seat_tab[r, m]`` is the m-th consumer open in round r in
    kept-load rank order (round r opens the consumers with rem > r)."""
    dev = rem.device
    lr_order = torch.argsort(kept_load, stable=True)
    sorted_rem = torch.sort(rem).values
    prefix_rem = torch.cat([sorted_rem.new_zeros(1), torch.cumsum(sorted_rem, 0)])
    rr = torch.arange(cap_max + 1, dtype=rem.dtype, device=dev)
    t_r = torch.searchsorted(sorted_rem, rr, right=True)
    cum_slots = prefix_rem[t_r] + rr * (C - t_r)
    open_mask = rem[lr_order][None, :] > rr[:, None]
    open_cum = torch.cumsum(open_mask.to(torch.int64), dim=1)
    size = (cap_max + 1) * C
    seat_dest = torch.where(open_mask, rr[:, None] * C + open_cum - 1, size)
    seat = torch.zeros(size + 1, dtype=torch.int64, device=dev)
    seat[seat_dest.reshape(-1)] = lr_order.expand(cap_max + 1, C).reshape(-1)
    return cum_slots, seat[:size].reshape(cap_max + 1, C)


def _sharded_tail(lags: Parts, valid: Parts, A: Parts, B: Parts, C: int,
                  refine_iters: int):
    """The P-sharded rounding tail (module docstring).  Returns (choice
    parts int32, counts int32[C], totals int64[C]) with the replicated
    outputs as shard 0's tensors."""
    from ..models.sinkhorn import _START_SLACK
    from ..ops.packing import table_rows
    from ..ops.plan_stats import implicit_plan_argmax
    from ..ops.refine import refine_rounds_resident
    from ..ops.rounds_kernel import _rounds_scan

    D = len(lags)
    L = lags[0].shape[0]
    P2 = L * D
    M = table_rows(P2, C)
    cap_max = P2 // C + 1
    devs = [x.device for x in lags]
    gidx = [d * L + torch.arange(L, dtype=torch.int64, device=dev)
            for d, dev in enumerate(devs)]

    # _scaled_ws with the f64 total psum-reduced: integer partial sums below
    # 2**53 are exact in any order, so every row's ws has the single-device
    # bits.
    w = [torch.where(v, x, 0).to(torch.float64) for x, v in zip(lags, valid)]
    scale = [torch.clamp(s, min=1.0) / C for s in coll.psum([wi.sum() for wi in w])]
    ws = [(wi / s).to(torch.float32) for wi, s in zip(w, scale)]
    jstar = [implicit_plan_argmax(s, v, a, b, tie_noise=False).to(torch.int64)
             for s, v, a, b in zip(ws, valid, A, B)]
    neg_lag = [torch.where(v, -x, _I64MAX) for x, v in zip(lags, valid)]

    # The (jstar, neg_lag, row) grouping order of _round_parallel.
    rank_par = _gathered_rank([(j, n, g) for j, n, g in zip(jstar, neg_lag, gidx)])
    sj_s = _rank_scatter(rank_par, jstar, P2)
    ws_s = _rank_scatter(rank_par, ws, P2)
    n_valid = coll.psum([v.sum() for v in valid])

    rounding = []
    for d in range(D):
        dev = devs[d]
        floor_cap = n_valid[d] // C
        extras = n_valid[d] - floor_cap * C
        cap = floor_cap + (torch.arange(C, device=dev) < extras).to(torch.int64)
        idx_p = torch.arange(P2, device=dev)
        bnd = torch.searchsorted(sj_s[d], torch.arange(C + 1, device=dev))
        pos = idx_p - bnd[torch.clamp(sj_s[d], 0, C)]
        keep_s = (sj_s[d] < C) & (pos < cap[torch.clamp(sj_s[d], 0, C - 1)])
        kept_cnt = torch.minimum(bnd[1:] - bnd[:-1], cap)
        # The order-sensitive f32 cumsum over the single-device sorted
        # layout: the kept loads' bits do not depend on the mesh.
        csum = torch.cat([ws_s[d].new_zeros(1),
                          torch.cumsum(torch.where(keep_s, ws_s[d], 0.0), 0)])
        kept_load = csum[bnd[1:]] - csum[bnd[:-1]]
        cum_slots, seat_tab = _seat_table(cap - kept_cnt, kept_load, cap_max, C)
        rounding.append((keep_s[rank_par[d].long()], cum_slots, seat_tab))

    # Overflow rank in (neg_lag, sorted-layout position) order: the stable
    # tiebreak of _round_parallel's overflow sort.
    okey = [torch.where(valid[d] & ~rounding[d][0], neg_lag[d], _I64MAX)
            for d in range(D)]
    orank = _gathered_rank([(o, r.to(torch.int64)) for o, r in zip(okey, rank_par)])
    starts = []
    for d in range(D):
        keep_loc, cum_slots, seat_tab = rounding[d]
        overflow = valid[d] & ~keep_loc
        r_of = torch.searchsorted(cum_slots, orank[d].to(torch.int64), right=True) - 1
        m_of = orank[d] - cum_slots[torch.clamp(r_of, 0, cap_max)]
        seat = seat_tab[torch.clamp(r_of, 0, cap_max), torch.clamp(m_of, 0, C - 1)]
        starts.append(torch.where(keep_loc, jstar[d],
                                  torch.where(overflow, seat, -1)).to(torch.int32))

    # The greedy twin: distributed processing-order ranks feeding the round
    # scan (K1) on the replicated sorted rows, once, on shard 0.
    neg_g = [torch.where(v, -x, 1) for x, v in zip(lags, valid)]
    pid_key = [torch.where(v, g, _I32MAX) for v, g in zip(valid, gidx)]
    rank_g = _gathered_rank([(n, p, g) for n, p, g in zip(neg_g, pid_key, gidx)])
    lag_gs = _rank_scatter(rank_g, lags, P2)
    valid_gs = _rank_scatter(rank_g, valid, P2)
    g_totals0, g_sorted0 = _rounds_scan(
        lag_gs[0], valid_gs[0], torch.zeros(C, dtype=torch.int64, device=devs[0]), C
    )
    g_totals = coll.broadcast(g_totals0, devs)
    g_sorted = coll.broadcast(g_sorted0, devs)
    g_choice_loc = [g_sorted[d][rank_g[d].long()] for d in range(D)]

    ot_totals = coll.psum([
        _segsum_scatter(torch.where(v, x, 0), torch.where(v, c, -1), C)
        for x, v, c in zip(lags, valid, starts)
    ])
    start_loc = [torch.where(o.max() <= _START_SLACK * g.max(), c, gc)
                 for o, g, c, gc in zip(ot_totals, g_totals, starts, g_choice_loc)]

    # Distributed choice-table build: local segment sort, one all-gathered
    # count prefix, a psum'd position scatter.  Each consumer's segment holds
    # its rows in ascending order, as build_choice_tables lays them out.
    seg_loc = [torch.where(v & (s >= 0), s, C).to(torch.int64)
               for v, s in zip(valid, start_loc)]
    tab_parts, cnt_loc = [], []
    for d in range(D):
        dev = devs[d]
        sseg, srow_g = sort_with(seg_loc[d], gidx[d])
        bnd_l = torch.searchsorted(sseg, torch.arange(C + 1, device=dev))
        cnt_loc.append((bnd_l[1:] - bnd_l[:-1]).to(torch.int32))
        tab_parts.append((sseg, srow_g, bnd_l))
    cnt_all = coll.all_gather(cnt_loc)
    tabs = []
    for d in range(D):
        dev = devs[d]
        sseg, srow_g, bnd_l = tab_parts[d]
        prefix = cnt_all[d][:d].sum(dim=0, dtype=torch.int64)
        pos_l = torch.arange(L, device=dev) - bnd_l[torch.clamp(sseg, 0, C)]
        dest = torch.where(sseg < C,
                           sseg * M + prefix[torch.clamp(sseg, 0, C - 1)] + pos_l, C * M)
        tab = torch.zeros(C * M + 1, dtype=torch.int32, device=dev)
        tab[dest] = (srow_g + 1).to(torch.int32)
        tabs.append(tab[: C * M])
    tab_flat = coll.psum(tabs)[0]
    row_tab = torch.where(tab_flat > 0, tab_flat - 1, P2).to(torch.int32).reshape(C, M)
    r_counts = coll.psum(cnt_loc)[0]
    r_totals = coll.psum([_segsum_scatter(torch.where(v, x, 0), s, C)
                          for x, v, s in zip(lags, valid, seg_loc)])[0]

    # The exchange refine on the all-gathered rows, once, on shard 0.
    lags_full = coll.all_gather(lags, tiled=True)[0]
    start_full = coll.all_gather(start_loc, tiled=True)[0]
    s_choice, _, s_counts, s_totals, _, _ = refine_rounds_resident(
        lags_full, start_full, row_tab, r_counts, r_totals, num_consumers=C,
        iters=int(refine_iters), max_pairs=min(C // 2, 64),
    )
    g_counts = _bincount_scatter(g_sorted0, C)
    use_s = s_totals.max() < g_totals0.max()
    g_choice_full = coll.all_gather(g_choice_loc, tiled=True)[0]
    fin_choice = torch.where(use_s, s_choice, g_choice_full)
    fin_counts = torch.where(use_s, s_counts.to(torch.int32), g_counts)
    fin_totals = torch.where(use_s, s_totals, g_totals0)
    out = [fin_choice[d * L:(d + 1) * L].to(devs[d], copy=True).to(torch.int32)
           for d in range(D)]
    return out, fin_counts, fin_totals


def _finish_sharded_tail(mesh: Mesh, lags_d: Parts, valid_d: Parts, lags_p: np.ndarray,
                         valid: np.ndarray, A: Parts, B: Parts, num_consumers: int,
                         refine_iters: int, *, tiles: int, tile: int, rounds: int):
    """Host wrapper of the P-sharded rounding tail, then the epilogue of
    :func:`..ops.linear_ot.finish_from_duals` (the additive-bound check, the
    quality metrics, the ``_LAST`` record) through
    :func:`..ops.linear_ot.record_linear_solve`."""
    from ..ops import linear_ot

    C = int(num_consumers)
    D = mesh.shape[SOLVE_AXIS]
    with metrics.device_phase("rounding"), dispatch_gate():
        choice, counts, totals = _sharded_tail(lags_d, valid_d, A, B, C, refine_iters)
        choice_np = coll.gather_host(choice)
        counts_np, totals_np = counts.cpu().numpy(), totals.cpu().numpy()
    metrics.REGISTRY.counter("klba_sharded_dispatch_total", {"path": "rounding"}).inc()
    linear_ot.record_linear_solve(
        lags_p, valid, totals_np, C, tiles=tiles, tile=tile, rounds=rounds,
        backend=f"sharded:{D}",
    )
    return choice_np, counts_np, totals_np


def solve_linear_sharded(mesh: Mesh, lags: np.ndarray, num_consumers: int,
                         iters: int = 24, refine_iters: int = 64,
                         tile: Optional[int] = None):
    """One linear-OT quality cold solve with both halves P-sharded over
    ``mesh`` (module docstring): the marginal scans split across shards
    (K5 on each), and above the sequential-rounding threshold the rounding
    tail too.  Bit-identical to the port's
    :func:`..ops.linear_ot.assign_topic_linear` on the CPU at ANY mesh size.

    ``lags`` is the exact host [P] int64 vector.  Fires ``mesh.collective``
    on entry; a shard outside K5's limits raises ``ValueError``
    (:func:`..ops.linear_ot_cuda.admit_sharded`).  Returns host ``(choice
    int32[P] in input order, counts, totals, duals_rounds)``."""
    from ..models.sinkhorn import _SCAN_ROUNDING_MAX_P, _scale_np
    from ..ops import linear_ot
    from ..ops.dispatch import quality_tile
    from ..ops.linear_ot_cuda import admit_sharded

    faults.fire("mesh.collective")
    C = int(num_consumers)
    lags = np.ascontiguousarray(lags, dtype=np.int64)
    P_len = int(lags.shape[0])
    D = mesh.shape[SOLVE_AXIS]
    tile_knob = quality_tile() if tile is None else tile
    # The pow2 plan bucket divides by any pow2 mesh size up to the
    # superblock count; other meshes cannot take whole superblocks.
    S = linear_ot._SUPERBLOCKS
    if D > S or S % D:
        raise ValueError(
            f"solve_linear_sharded needs a pow2 mesh size <= {S}, got {D}"
        )
    P2, tile_e, n_tiles = linear_ot.plan_shape(P_len, tile_knob)
    admit_sharded(P2 // D, C, tile_e)
    lags_p = np.zeros(P2, dtype=np.int64)
    lags_p[:P_len] = lags
    valid = np.zeros(P2, dtype=bool)
    valid[:P_len] = True
    scale = _scale_np(lags_p, valid, C)
    with metrics.span("sharded.linear_duals"), dispatch_gate():
        lags_d, valid_d = _place_inputs(mesh, lags_p, valid)
        # The stop test reads shard 0's duals every iteration, the last one
        # included, so the phase ends with the duals complete.
        with metrics.device_phase("duals"):
            A, B, rounds = _linear_duals_sharded(
                lags_d, valid_d, scale, float(valid.sum()), C, int(iters), tile_e,
            )
    metrics.REGISTRY.counter("klba_sharded_dispatch_total", {"path": "linear"}).inc()
    if D > 1 and C >= 2 and P2 > _SCAN_ROUNDING_MAX_P:
        choice, counts, totals = _finish_sharded_tail(
            mesh, lags_d, valid_d, lags_p, valid, A, B, C, int(refine_iters),
            tiles=n_tiles, tile=tile_e, rounds=rounds,
        )
    else:
        dev = lags_d[0].device
        choice, counts, totals = linear_ot.finish_from_duals(
            torch.from_numpy(lags_p).to(dev),
            torch.arange(P2, dtype=torch.int32, device=dev),
            torch.from_numpy(valid).to(dev), A[0], B[0], C, int(refine_iters),
            tiles=n_tiles, tile=tile_e, rounds=rounds, backend=f"sharded:{D}",
        )
    return choice[:P_len].astype(np.int32), counts, totals, int(rounds)


def seed_reference(lags: np.ndarray, num_consumers: int) -> np.ndarray:
    """Host twin of the mesh-1 sharded seed: lag-descending stable sort,
    consumer = rank mod C.  ``solve_sharded`` on a 1-shard mesh with
    ``refine_iters=0`` is bit-identical to this."""
    C = int(num_consumers)
    lags = np.asarray(lags, dtype=np.int64)
    order = np.lexsort((np.arange(lags.shape[0]), -lags))
    choice = np.empty(lags.shape[0], dtype=np.int32)
    choice[order] = np.arange(lags.shape[0], dtype=np.int32) % C
    return choice
