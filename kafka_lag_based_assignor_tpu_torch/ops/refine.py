"""Pairwise-exchange refinement and the resident-state digest.

Counterpart of ``refine_assignment``, ``_quant_shift``,
``build_choice_tables``, ``refine_rounds_resident`` and
``refine_assignment_resident`` in
``kafka_lag_based_assignor_tpu/ops/refine.py``.  It post-processes an
integral, count-balanced assignment to tighten the max/mean lag imbalance
while keeping ``max - min <= 1`` partitions.

:func:`refine_assignment` is the oracle round: two P-sized stable sorts a
round (every row keyed by pair, quantized lag and side; then one segmented
argmin), the swap partners found as nearest light neighbours by cumulative
max and min scans.  It takes a batch of independent topics, each stopping
on its own as the JAX package's ``vmap`` of the loop does.

The resident form keeps a compact per-consumer row table ``row_tab`` [C, M] (M =
``packing.table_rows``), the per-consumer counts and int64 totals.  Each
round ranks the consumers by total, pairs the K heaviest with K partners
from the light side (the partner permutation rotates every round), and for
every pair picks the best single move (heavy to light, lag closest to half
the gap, only while the counts allow) or swap (the light row whose
quantized lag is the nearest neighbour of the heavy row's target), by the
lexicographic minimum of (score, target, row).  Pairs are consumer-disjoint,
so all winners apply at once; every transferred amount d satisfies
0 < d < gap, so the global maximum never rises.  Integer arithmetic
throughout: the port gives the JAX package's bits.

The streaming engine's warm round type (``bulk_transfer`` with a partner
``fan``) and its exits (``quality_limit``, ``exchange_budget``) are ported
too; ``allow_moves=False`` (the federated weighted rounding,
:mod:`.fedsolve`) drops the parity body's count-changing moves, so the loop
is swap-only.  The loop runs on the host and makes one read from
the device a round: the stop test and the exchanges so far.

:func:`state_digest` is the integrity digest of the streaming engine's
resident state: the K6 kernel (``csrc/state_digest.cu``) on the card, its
plain version (:func:`_state_digest_torch` + :func:`_row_tab_lane_torch`)
on the CPU.  :func:`state_digest_rows` digests a coalescer wave's N states
in one launch, and :func:`state_digest_sharded` a row-sharded (placed)
state: one launch of K6's shard entry a shard, the partials summed.
"""

from __future__ import annotations

import numpy as np
import torch

from ._build import count_launch
from .packing import table_rows
from .sortops import (
    bincount_sorted,
    lexsort,
    segment_argmin_first,
    segment_sum,
    sort_with,
    stable_argsort,
)

_PAIR_BITS = 14
_VBITS = 63 - _PAIR_BITS - 1  # quantized-lag field width (48)
_SBIG = 1 << 60  # score sentinel; (x << 1) | 1 fits int64
# The parity round's pair blocks (refine_rounds_resident): rows x M at most
# P x C / _PAIR_SHARE entries, or _PAIR_MIN_ENTRIES where that is more.
_PAIR_SHARE = 1024
_PAIR_MIN_ENTRIES = 8192
_INT64_MAX = torch.iinfo(torch.int64).max


def _quant_shift(lags, assigned):
    """The quantization shift of each topic (along the last axis):
    max(bit_length(max assigned lag, >= 1) - 48, 0), as int64[...] (a
    scalar tensor for one topic).  The bit length is counted with integer
    shifts (no float, which rounds above 2**53)."""
    maxlag = torch.clamp(torch.where(assigned, lags, 0).amax(dim=-1), min=1)
    shifts = torch.arange(63, dtype=torch.int64, device=lags.device)
    bitlen = ((maxlag[..., None] >> shifts) > 0).sum(dim=-1)
    return torch.clamp(bitlen - _VBITS, min=0)


def _start_state(lags, valid, choice, num_consumers: int):
    """(choice int32, assigned mask, counts int32[..., C], totals
    int64[..., C]) of an assignment."""
    choice = choice.to(torch.int32)
    assigned = valid & (choice >= 0)
    seg0 = torch.where(assigned, choice, -1)
    totals = segment_sum(torch.where(assigned, lags, 0), seg0, num_consumers)
    return choice, assigned, bincount_sorted(seg0, num_consumers), totals


def refine_assignment(lags, valid, choice, num_consumers: int, iters: int = 16,
                      max_pairs: int | None = None, patience: int = 8):
    """Improve an integral assignment by rounds of parallel exchanges (the
    JAX package's oracle kernel, module docstring).

    Args: lags int64[P] or [T, P] (non-negative); valid bool of the same
    shape (invalid rows must have choice -1); choice int32 (count-balanced);
    ``num_consumers`` C; ``iters`` the round budget; ``max_pairs`` the
    pairs a round (default C // 2); ``patience`` stops a topic after that
    many consecutive rounds that did not lower its peak total.  Each topic
    of a batch runs until its own budget or patience ends and is frozen
    after that; the loop reads the device once a round (are any topics
    still going).

    Returns (choice int32, counts int32[..., C], totals int64[..., C]).
    """
    C = int(num_consumers)
    K = max(1, min(C // 2, max_pairs if max_pairs is not None else C // 2))
    if K >= (1 << _PAIR_BITS) - 1:
        raise ValueError(
            f"max_pairs={K} exceeds the packed pair-id field ({_PAIR_BITS} bits)"
        )
    choice, assigned, counts, totals = _start_state(lags, valid, choice, C)
    if C < 2:
        return choice, counts, totals
    one = lags.dim() == 1
    if one:
        lags, assigned, choice = lags[None], assigned[None], choice[None]
        counts, totals = counts[None], totals[None]
    T, P = lags.shape
    dev = lags.device
    n_light = C - K
    kk = torch.arange(K, device=dev)
    arange_p = torch.arange(P, device=dev).expand(T, P)
    arange_c = torch.arange(C, device=dev).expand(T, C)
    vmask = (1 << _VBITS) - 1
    pshift = _quant_shift(lags, assigned)[:, None]  # [T, 1]

    def body(it, choice, totals, counts):
        safe_choice = torch.clamp(choice, 0, C - 1).to(torch.int64)
        # Rank the consumers by load; pair the k-th heaviest with a partner
        # from the light side, the partner permutation rotating each round.
        order = torch.argsort(totals, dim=1, stable=True)
        rank = torch.empty_like(order).scatter_(1, order, arange_c)
        light_slot = (kk + it % n_light) % n_light
        light = order[:, light_slot]     # [T, K]
        heavy = order[:, C - 1 - kk]     # [T, K]
        diff = totals.gather(1, heavy) - totals.gather(1, light)

        # Per-consumer (pair, side, move allowed), gathered once per row.
        slot_to_pair = torch.full((n_light,), K, dtype=torch.int64, device=dev)
        slot_to_pair[light_slot] = kk
        pair_of = torch.where(rank < n_light,
                              slot_to_pair[torch.clamp(rank, 0, n_light - 1)],
                              C - 1 - rank)
        heavy_side = rank >= C - K
        move_ok_pair = counts.gather(1, heavy) > counts.gather(1, light)
        move_ok_pad = torch.cat([move_ok_pair, move_ok_pair.new_zeros(T, 1)], dim=1)
        move_ok_of = heavy_side & move_ok_pad.gather(1, torch.clamp(pair_of, 0, K))
        combo_tab = (pair_of | (heavy_side.to(torch.int64) << _PAIR_BITS)
                     | (move_ok_of.to(torch.int64) << (_PAIR_BITS + 1)))
        combo = torch.where(assigned, combo_tab.gather(1, safe_choice), -1)
        k_p = combo & ((1 << _PAIR_BITS) - 1)
        row_heavy = (combo >> _PAIR_BITS) & 1
        row_move_ok = (combo >> (_PAIR_BITS + 1)) & 1
        participates = (combo >= 0) & (k_p < K)
        diff_p = torch.where(participates, diff.gather(1, torch.clamp(k_p, 0, K - 1)), 0)

        # The round sort: light rows keyed by their quantized lag, heavy
        # rows by their ideal counterpart's (lag - gap / 2), the pair in
        # the high bits, the side bit last.
        tgt = torch.clamp(lags - (diff_p >> 1), min=0) >> pshift
        qval = torch.where(row_heavy == 1, tgt, lags >> pshift)
        key = torch.where(
            participates,
            (k_p << (_VBITS + 1)) | (torch.clamp(qval, 0, vmask) << 1) | row_heavy,
            _INT64_MAX,
        )
        skey, slag, srow, smove_ok = sort_with(key, lags, arange_p, row_move_ok)

        part_s = skey < _INT64_MAX
        pair_s = skey >> (_VBITS + 1)
        heavy_s = part_s & ((skey & 1) == 1)
        light_s = part_s & ((skey & 1) == 0)
        qlag_s = slag >> pshift
        diff_s = torch.where(heavy_s, diff.gather(1, torch.clamp(pair_s, 0, K - 1)), 0)
        delta_q_s = (diff_s >> 1) >> pshift
        diff_q_s = diff_s >> pshift

        # Nearest light neighbours: the last light row at or below, the
        # first above (lax.cummin(reverse=True) is a flip, cummin, flip).
        prev_l = torch.cummax(torch.where(light_s, arange_p, -1), dim=1).values
        nxt_l = torch.cummin(torch.where(light_s, arange_p, P).flip(1), dim=1).values.flip(1)

        def neighbour(nb):
            nkey = skey.gather(1, torch.clamp(nb, 0, P - 1))
            okq = ((nb >= 0) & (nb < P) & ((nkey & 1) == 0)
                   & ((nkey >> (_VBITS + 1)) == pair_s))
            d_q = qlag_s - ((nkey >> 1) & vmask)
            ok = heavy_s & okq & (d_q > 0) & (d_q < diff_q_s)
            return torch.where(ok, (d_q - delta_q_s).abs(), _SBIG)

        err_a = neighbour(prev_l)
        err_b = neighbour(nxt_l)
        use_b = err_b < err_a
        err_swap = torch.where(use_b, err_b, err_a)
        nb_sel = torch.where(use_b, nxt_l, prev_l)

        # The move candidate (exact validity) merged with the swap by a tag
        # bit under the score: ties prefer the move.
        ok_move = heavy_s & (smove_ok == 1) & (slag > 0) & (slag < diff_s)
        score_move = torch.where(ok_move, (qlag_s - delta_q_s).abs(), _SBIG)
        combined = torch.where(score_move <= err_swap, score_move << 1,
                               (err_swap << 1) | 1)
        seg_h = torch.where(heavy_s, pair_s, K)
        minv, widx = segment_argmin_first(combined, seg_h, K, P)

        # The [T, K] winners; pairs are disjoint, so all apply at once.
        do = minv < (_SBIG << 1)
        is_swap = (minv & 1) == 1
        wclip = torch.clamp(widx, 0, P - 1).to(torch.int64)
        p_sel = srow.gather(1, wclip)
        lag_p = slag.gather(1, wclip)
        nb_k = torch.clamp(nb_sel.gather(1, wclip), 0, P - 1)
        q_sel = srow.gather(1, nb_k)
        lag_q = slag.gather(1, nb_k)
        use_swap = do & is_swap
        d = torch.where(do, torch.where(use_swap, lag_p - lag_q, lag_p), 0)

        # Column P takes the writes JAX's mode="drop" discards.
        ext = torch.cat([choice, choice.new_zeros(T, 1)], dim=1)
        ext.scatter_(1, torch.where(do, p_sel, P), light.to(torch.int32))
        ext.scatter_(1, torch.where(use_swap, q_sel, P), heavy.to(torch.int32))
        new_totals = totals.clone()
        new_totals.scatter_add_(1, heavy, -d)
        new_totals.scatter_add_(1, light, d)
        dc = (do & ~is_swap).to(counts.dtype)
        new_counts = counts.clone()
        new_counts.scatter_add_(1, heavy, -dc)
        new_counts.scatter_add_(1, light, dc)
        peak_dropped = new_totals.amax(dim=1) < totals.amax(dim=1)
        return ext[:, :P], new_totals, new_counts, peak_dropped

    since = torch.zeros(T, dtype=torch.int64, device=dev)
    active = since < patience
    it = 0
    while it < iters and bool(active.any()):
        new_choice, new_totals, new_counts, peak_dropped = body(it, choice, totals, counts)
        # A topic that has stopped keeps its state, as under JAX's vmap.
        go = active[:, None]
        choice = torch.where(go, new_choice, choice)
        totals = torch.where(go, new_totals, totals)
        counts = torch.where(go, new_counts, counts)
        since = torch.where(active, torch.where(peak_dropped, 0, since + 1), since)
        it += 1
        active = since < patience
    if one:
        return choice[0], counts[0], totals[0]
    return choice, counts, totals


def build_choice_tables(lags, valid, choice, num_consumers: int, table_rows: int,
                        sort_rows=None):
    """One P-sized stable sort -> the compact per-consumer row table
    (``sort_rows`` bounds the rows it sorts at a time,
    :func:`.sortops.stable_argsort`).

    Returns (row_tab int32[C, M] — row indices in ascending order within a
    consumer, P at empty slots — counts int32[C], totals int64[C]).
    """
    C, M = int(num_consumers), int(table_rows)
    P = lags.shape[0]
    dev = lags.device
    seg = torch.where(valid & (choice >= 0), choice.to(torch.int32), C)
    if sort_rows is None:
        sseg, srow = torch.sort(seg, stable=True)
    else:
        srow = stable_argsort(seg, sort_rows)
        sseg = seg[srow]
    del seg
    bnd = torch.searchsorted(sseg, torch.arange(C + 1, dtype=sseg.dtype, device=dev))
    counts = (bnd[1:] - bnd[:-1]).to(torch.int32)
    # A sorted row's slot: its place in its consumer's run plus the
    # consumer's table offset, C * M (the drop slot) past M or past C.
    # int32 throughout (C * M + P fits), each [P] buffer freed once dead.
    flat = torch.arange(P, dtype=torch.int32, device=dev)
    flat -= bnd.to(torch.int32)[torch.clamp(sseg, 0, C)]
    drop = (sseg >= C) | (flat >= M)
    flat += sseg * M
    flat.masked_fill_(drop, C * M)
    del sseg, drop
    # One extra slot takes the writes that JAX's mode="drop" discards.
    tab = torch.full((C * M + 1,), P, dtype=torch.int32, device=dev)
    tab[flat] = srow.to(torch.int32)
    del flat, srow
    row_tab = tab[: C * M].reshape(C, M)
    lag_tab = lags[torch.clamp(row_tab, 0, P - 1)]
    lag_tab.masked_fill_(torch.arange(M, device=dev)[None, :] >= counts[:, None], 0)
    return row_tab, counts, lag_tab.sum(dim=1)


def _take(a, i):
    """a[k, i[k]] for each row k."""
    return a.gather(1, i[:, None])[:, 0]


def _drop_set(flat, idx, vals):
    """``flat.at[idx].set(vals, mode="drop")`` for a flat tensor whose
    last slot is the drop slot (idx == its index).  An index outside
    [-n, n), which only a corrupted resident row or count gives, goes to
    the drop slot too: JAX drops it, and on the card an out-of-bounds
    index would be a device-side assert that ends the process's CUDA
    context (the digest then rejects the epoch's answer)."""
    n = flat.shape[0]
    idx = torch.where((idx < -n) | (idx >= n), n - 1, idx)
    flat[idx] = vals.to(flat.dtype)
    return flat


def _row_local(rows, P: int):
    """A vmapped row's ``ext.at[rows]`` index over its P + 1 slots (the
    last the drop slot), resolved as JAX resolves it: a negative index
    wraps once, and what is then outside [0, P) is dropped.  Returns (the
    index, whether it lands in the row).  A stacked flat buffer needs the
    test: a corrupted row id would otherwise write into the next row."""
    r = rows.long()
    r = torch.where(r < 0, r + (P + 1), r)
    return r, (r >= 0) & (r < P)


def refine_rounds_resident(
    lags,
    choice,
    row_tab,
    counts,
    totals,
    num_consumers: int,
    iters: int,
    max_pairs: int | None = None,
    patience: int = 8,
    exchange_budget: int = 0,
    quality_limit=None,
    bulk_transfer: bool = False,
    fan: int = 1,
    allow_moves: bool = True,
):
    """The resident-table round loop (module docstring).

    Args: lags int64[P]; choice int32[P] (-1 unassigned); row_tab,
    counts, totals from :func:`build_choice_tables`; ``iters`` the round
    budget; ``max_pairs`` caps the pair count K (default C // 2);
    ``patience`` stops after that many rounds without progress;
    ``exchange_budget`` caps the applied exchanges (0: no cap);
    ``quality_limit`` is a peak-total target (None or negative: none) —
    a pair whose heavy consumer is at or below it applies nothing, and
    the loop stops once the peak is.  ``allow_moves`` False drops the
    count-changing MOVE candidates of the parity body, so every applied
    exchange is a swap and the counts never change (the federated weighted
    rounding seats capacity-weighted counts this way); the bulk rounds are
    swap-only by construction.

    ``bulk_transfer`` selects the warm engine's round: each pair sorts the
    heavy consumer's rows lag-descending and the light one's
    lag-ascending, matches the ranks, and applies the positive-gap swaps
    largest-gap-first while the cumulative transfer stays under the
    half-gap, the receiver's headroom to the limit and the heavy
    consumer's remaining distance to it.  ``fan`` clones each heavy
    consumer across that many pairs, each clone on a disjoint stripe of
    its sorted ranks.  A bulk round counts as progress only if it closed
    at least 1/16 of the peak's distance to the limit.

    The inputs are never written: every round builds new tensors, so the
    caller's entry state stays intact (the streaming engine diffs and
    audits it).  Returns (choice, row_tab, counts, totals, rounds_done,
    exchanges_done), the last two as ints.
    """
    C = int(num_consumers)
    P = lags.shape[0]
    M = row_tab.shape[1]
    K = max(1, min(C // 2, max_pairs if max_pairs is not None else C // 2))
    if C < 2 or iters <= 0:
        return choice, row_tab, counts, totals, 0, 0
    dev = lags.device
    choice = choice.to(torch.int32)
    n_light = C - K
    kk = torch.arange(K, device=dev)
    mslots = torch.arange(M, device=dev)
    nop = C * M
    # Pairs a block of the parity round's candidate search: its [rows, M]
    # temporaries (about a dozen int64 a pair slot) stay within 1/_PAIR_SHARE
    # of the [P, C] plan's entries (at least _PAIR_MIN_ENTRIES), one block
    # where all K pairs fit.
    pair_rows = max(1, min(K, max(P * C // _PAIR_SHARE, _PAIR_MIN_ENTRIES) // max(M, 1)))
    limit = -1.0 if quality_limit is None else float(quality_limit)
    budget = int(exchange_budget)

    def admit(do, ex_done):
        """Exact budget adherence: admit winners in order (heaviest pair
        first) until the remaining quota is spent."""
        if not budget:
            return do
        return do & (torch.cumsum(do.to(torch.int64), dim=0) <= budget - ex_done)

    def body(it, since, ex_done, choice, tab, counts, totals):
        order = torch.argsort(totals, stable=True)
        light = order[(kk + it % n_light) % n_light]  # [K]
        heavy = order[C - 1 - kk]                     # [K]
        diff = totals[heavy] - totals[light]          # [K] >= 0
        cnt_h = counts[heavy].to(torch.int64)
        cnt_l = counts[light].to(torch.int64)
        move_ok = cnt_h > cnt_l
        if not allow_moves:
            move_ok = torch.zeros_like(move_ok)
        delta = diff >> 1
        diff_q = diff >> pshift
        delta_q = delta >> pshift

        def winners(k):
            """The winning candidate of the pairs ``k`` (a slice): (m1, win,
            p_sel, lag_p, q_sel, lag_q, q_slot), one entry a pair."""
            hv, lt, dq, dlt_q = heavy[k], light[k], diff_q[k], delta_q[k]
            rows_h = tab[hv].to(torch.int64)  # [k, M]
            rows_l = tab[lt].to(torch.int64)
            hvalid = mslots[None, :] < cnt_h[k][:, None]
            lvalid = mslots[None, :] < cnt_l[k][:, None]
            lag_h = torch.where(hvalid, lags[torch.clamp(rows_h, 0, P - 1)], 0)
            lag_l = torch.where(lvalid, lags[torch.clamp(rows_l, 0, P - 1)], 0)
            qlag_h = lag_h >> pshift
            tgt_h = torch.clamp(lag_h - delta[k][:, None], min=0) >> pshift

            # Light segments sorted by (qval, row), as lax.sort(num_keys=2).
            key_q = torch.where(lvalid, lag_l >> pshift, _INT64_MAX)
            key_r = torch.where(lvalid, rows_l, P)
            del rows_l
            perm = lexsort(key_q, key_r, dim=1)
            sq = key_q.gather(1, perm)
            srow_l = key_r.gather(1, perm)
            sslot_l = perm
            slag_l = lag_l.gather(1, perm)
            del key_q, key_r, lag_l
            ins = torch.searchsorted(sq, tgt_h, right=True)
            n_l = cnt_l[k][:, None]

            def neighbour(idx):
                ok_idx = (idx >= 0) & (idx < n_l)
                i_c = torch.clamp(idx, 0, M - 1)
                d_q = qlag_h - sq.gather(1, i_c)
                ok = hvalid & ok_idx & (d_q > 0) & (d_q < dq[:, None])
                return torch.where(ok, (d_q - dlt_q[:, None]).abs(), _SBIG), i_c

            err_a, ia = neighbour(ins - 1)
            err_b, ib = neighbour(ins)
            del ins, sq
            use_b = err_b < err_a
            err_swap = torch.where(use_b, err_b, err_a)
            nb_i = torch.where(use_b, ib, ia)
            del err_a, err_b, ia, ib, use_b

            ok_move = (hvalid & move_ok[k][:, None] & (lag_h > 0)
                       & (lag_h < diff[k][:, None]))
            score_move = torch.where(ok_move, (qlag_h - dlt_q[:, None]).abs(), _SBIG)
            del ok_move, qlag_h, hvalid
            combined = torch.where(
                score_move <= err_swap, score_move << 1, (err_swap << 1) | 1
            )
            del score_move, err_swap

            # Winner per pair: lexicographic min (combined, target, row).
            m1 = combined.min(dim=1).values
            on1 = combined == m1[:, None]
            del combined
            m2 = torch.where(on1, tgt_h, _INT64_MAX).min(dim=1).values
            on2 = on1 & (tgt_h == m2[:, None])
            del on1, tgt_h
            m3 = torch.where(on2, rows_h, P).min(dim=1).values
            win = torch.argmax((on2 & (rows_h == m3[:, None])).to(torch.int32), dim=1)
            del on2
            nb_sel = _take(nb_i, win)
            return (m1, win, _take(rows_h, win), _take(lag_h, win), _take(srow_l, nb_sel),
                    _take(slag_l, nb_sel), _take(sslot_l, nb_sel))

        # The pairs in blocks of at most pair_rows: every step is per pair,
        # so the blocks give the same bits as one [K, M] pass, and the live
        # [rows, M] temporaries stay a fraction of the [P] buffers.
        parts = [winners(slice(lo, lo + pair_rows)) for lo in range(0, K, pair_rows)]
        m1, win, p_sel, lag_p, q_sel, lag_q, q_slot = (
            torch.cat(x) if len(parts) > 1 else x[0] for x in zip(*parts))
        del parts

        # With a quality limit, a pair whose heavy consumer already meets
        # the target applies nothing; limit < 0 keeps every pair active.
        active = totals[heavy].to(torch.float64) > limit
        do = admit((m1 < (_SBIG << 1)) & active, ex_done)
        is_swap = (m1 & 1) == 1
        use_swap = do & is_swap
        d = torch.where(use_swap, lag_p - lag_q, lag_p)
        d = torch.where(do, d, 0)

        upd_p = torch.where(do, p_sel, P)
        upd_q = torch.where(use_swap, q_sel, P)
        ext = torch.cat([choice, choice.new_zeros(1)])
        ext = _drop_set(ext, upd_p, light)
        ext = _drop_set(ext, upd_q, heavy)
        new_choice = ext[:P]
        new_totals = totals.clone()
        new_totals[heavy] -= d
        new_totals[light] += d
        dc = (do & ~is_swap).to(counts.dtype)
        new_counts = counts.clone()
        new_counts[heavy] -= dc
        new_counts[light] += dc

        # Table maintenance.  Swap: the two rows trade slots.  Move:
        # swap-with-last compaction on the heavy segment, append on the
        # light one.
        flat = torch.cat([tab.reshape(C * M), tab.new_zeros(1)])
        is_move = do & ~is_swap
        h_win = heavy * M + win
        h_last = heavy * M + cnt_h - 1
        last_row = flat[torch.clamp(h_last, 0, C * M - 1)]
        flat = _drop_set(flat, torch.where(use_swap, h_win, nop), q_sel)
        flat = _drop_set(flat, torch.where(use_swap, light * M + q_slot, nop), p_sel)
        flat = _drop_set(flat, torch.where(is_move, h_win, nop), last_row)
        flat = _drop_set(flat, torch.where(is_move, h_last, nop),
                         torch.full_like(p_sel, P))
        flat = _drop_set(flat, torch.where(is_move, light * M + cnt_l, nop), p_sel)

        peak_dropped = new_totals.max() < totals.max()
        new_since = torch.where(peak_dropped, 0, since + 1)
        new_ex = ex_done + do.to(torch.int64).sum()
        return (new_since, new_ex, new_choice, flat[:nop].reshape(C, M),
                new_counts, new_totals)

    fan_eff = max(1, min(int(fan), K))
    big64 = _INT64_MAX

    def bulk_body(it, since, ex_done, choice, tab, counts, totals):
        order = torch.argsort(totals, stable=True)
        light = order[(kk + it % n_light) % n_light]  # [K]
        # Each of the top ceil(K / fan) consumers appears in ``fan``
        # consecutive pairs, each clone on a disjoint stripe of its ranks.
        heavy = order[C - 1 - kk // fan_eff]
        diff = totals[heavy] - totals[light]
        delta = diff >> 1
        heavy_f = totals[heavy].to(torch.float64)
        active = heavy_f > limit
        # The remaining distance to the target split across the clones
        # (no target: each clone's share of the half-gap), and the
        # receiver's headroom to the same target.  f64 as in the JAX
        # package: IEEE division gives the same bits on every device.
        if limit >= 0:
            needed = torch.ceil((heavy_f - limit) / fan_eff).to(torch.int64)
            headroom = torch.floor(
                limit - totals[light].to(torch.float64)
            ).to(torch.int64)
        else:
            needed = delta // fan_eff + 1
            headroom = torch.full_like(delta, big64)
        cap = torch.minimum(delta, torch.clamp(headroom, min=0))

        rows_h = tab[heavy]  # [K, M] int32
        rows_l = tab[light]
        hvalid = mslots[None, :] < counts[heavy][:, None]
        lvalid = mslots[None, :] < counts[light][:, None]
        lag_h = torch.where(hvalid, lags[torch.clamp(rows_h.long(), 0, P - 1)], -1)
        lag_l = torch.where(lvalid, lags[torch.clamp(rows_l.long(), 0, P - 1)], big64)
        # Anti-ranked pairing: heavy rows lag-descending against light rows
        # lag-ascending, ties by row id (``lax.sort(num_keys=2)``).
        perm_h = lexsort(-lag_h, rows_h, dim=1)
        nh = (-lag_h).gather(1, perm_h)
        hs_row = rows_h.gather(1, perm_h)
        perm_l = lexsort(lag_l, rows_l, dim=1)
        la = lag_l.gather(1, perm_l)
        ls_row = rows_l.gather(1, perm_l)
        # Clone k works the sorted ranks r with r % fan == k % fan; its
        # j-th stripe row meets the light's j-th smallest.
        Ms = -(-M // fan_eff)
        jj = torch.arange(Ms, device=dev)
        gidx = jj[None, :] * fan_eff + (kk[:, None] % fan_eff)  # [K, Ms]
        in_seg = gidx < M
        gidx = torch.clamp(gidx, max=M - 1)
        nh_s = nh.gather(1, gidx)
        hs_row_s = hs_row.gather(1, gidx)
        hs_slot_s = perm_h.gather(1, gidx)
        ls_lag = la[:, :Ms]
        ls_row_s = ls_row[:, :Ms]
        ls_slot_s = perm_l[:, :Ms]
        rank_ok = in_seg & (nh_s <= 0) & (ls_lag < big64) & active[:, None]
        d = torch.where(rank_ok, -nh_s - ls_lag, 0)  # anti-ranked gap
        # Largest gaps first; prefix-select while the cumulative transfer
        # stays under the per-pair cap and the remaining distance.
        perm_d = lexsort(-d, hs_row_s, dim=1)
        ds = d.gather(1, perm_d)
        dh_row = hs_row_s.gather(1, perm_d)
        dh_slot = hs_slot_s.gather(1, perm_d)
        dl_row = ls_row_s.gather(1, perm_d)
        dl_slot = ls_slot_s.gather(1, perm_d)
        # A gap above the cap can never apply: keep it out of the running
        # total, or it would block every smaller swap behind it.
        fit = (ds > 0) & (ds <= cap[:, None])
        cum = torch.cumsum(torch.where(fit, ds, 0), dim=1)
        sel = fit & (cum <= cap[:, None]) & ((cum - ds) < needed[:, None])
        sel = admit(sel.reshape(-1), ex_done).reshape(K, Ms)

        transfer = torch.where(sel, ds, 0).sum(dim=1)  # int64 [K]
        # ``heavy`` repeats across the clones: index_add_ accumulates every
        # duplicate, as ``.at[heavy].add`` does (exact for int64).
        new_totals = totals.clone()
        new_totals.index_add_(0, heavy, -transfer)
        new_totals.index_add_(0, light, transfer)
        h_rows = torch.where(sel, dh_row.long(), P).reshape(-1)
        l_rows = torch.where(sel, dl_row.long(), P).reshape(-1)
        ext = torch.cat([choice, choice.new_zeros(1)])
        ext = _drop_set(ext, h_rows, light[:, None].expand(K, Ms).reshape(-1))
        ext = _drop_set(ext, l_rows, heavy[:, None].expand(K, Ms).reshape(-1))
        # Swaps are count-neutral: the two rows trade table slots (the
        # stripes are disjoint, so only the drop slot sees duplicates).
        flat = torch.cat([tab.reshape(C * M), tab.new_zeros(1)])
        hidx = torch.where(sel, heavy[:, None] * M + dh_slot, nop).reshape(-1)
        lidx = torch.where(sel, light[:, None] * M + dl_slot, nop).reshape(-1)
        flat = _drop_set(flat, hidx, dl_row.reshape(-1))
        flat = _drop_set(flat, lidx, dh_row.reshape(-1))

        # Relative-progress patience: a round counts only if it closed at
        # least 1/16 of the peak's remaining distance to the limit.
        old_peak = totals.max().to(torch.float64)
        new_peak = new_totals.max().to(torch.float64)
        min_step = (old_peak - limit) / 16.0 if limit >= 0 else 0.0
        good = (old_peak - new_peak) > torch.clamp(
            torch.as_tensor(min_step, dtype=torch.float64, device=dev), min=0.0
        )
        new_since = torch.where(good, 0, since + 1)
        new_ex = ex_done + sel.to(torch.int64).sum()
        return (new_since, new_ex, ext[:P], flat[:nop].reshape(C, M), counts,
                new_totals)

    if not bulk_transfer:
        pshift = _quant_shift(lags, choice >= 0)
    step = bulk_body if bulk_transfer else body
    since = torch.zeros((), dtype=torch.int64, device=dev)
    ex_done = torch.zeros((), dtype=torch.int64, device=dev)

    def going():
        """The loop test and the exchanges so far, in one host read."""
        go = (since < patience) & (totals.max().to(torch.float64) > limit)
        if budget:
            go &= ex_done < budget
        flag, ex = torch.stack([go.to(torch.int64), ex_done]).tolist()
        return bool(flag), ex

    it = 0
    go, ex = going()
    while go and it < iters:
        since, ex_done, choice, row_tab, counts, totals = step(
            it, since, ex_done, choice, row_tab, counts, totals
        )
        it += 1
        go, ex = going()
    return choice, row_tab, counts, totals, it, ex


def _row_gather(a, idx):
    """``a[n, idx[n, ...]]`` along axis 1 for each row n of a [N, X] tensor."""
    return a.gather(1, idx.reshape(idx.shape[0], -1)).reshape(idx.shape)


def refine_rounds_resident_rows(
    lags,
    choice,
    row_tab,
    counts,
    totals,
    num_consumers: int,
    iters: int,
    max_pairs: int | None = None,
    patience: int = 8,
    exchange_budget: int = 0,
    quality_limits=None,
    fan: int = 8,
):
    """The warm engine's bulk rounds over N independent rows at once: the
    counterpart of the JAX package's ``vmap`` of the warm core's
    ``while_loop`` (``ops/coalesce.py::_epoch_rows``).

    Args: lags int64[N, B], choice int32[N, B] (-1 unassigned), row_tab
    int32[N, C, M], counts int32[N, C], totals int64[N, C];
    ``quality_limits`` f64[N] (a negative entry: no target for that row;
    None: none for any); the rest as :func:`refine_rounds_resident`, whose
    ``bulk_transfer=True`` round every row runs with a partner ``fan``.

    Each row keeps its own round count, patience and exchange budget, and
    stops on its own exits; the loop runs until every row has stopped, and
    a stopped row is never changed.  No data crosses rows: the gathers and
    sorts run along each row's own axes, the scatters into a flat buffer
    with a row offset.  One host read a round: the [N] stop mask and the
    exchanges so far.  Each row's result equals, bit for bit, a single-row
    :func:`refine_rounds_resident` on the same inputs.

    Returns (choice, row_tab, counts, totals, rounds int64[N], exchanges
    int64[N]), the last two as numpy arrays; the inputs are never written.
    """
    C = int(num_consumers)
    N, P = lags.shape
    M = row_tab.shape[2]
    K = max(1, min(C // 2, max_pairs if max_pairs is not None else C // 2))
    none = np.zeros(N, dtype=np.int64)
    if C < 2 or iters <= 0 or N == 0:
        return choice, row_tab, counts, totals, none, none.copy()
    dev = lags.device
    f64 = torch.float64
    choice = choice.to(torch.int32)
    n_light = C - K
    kk = torch.arange(K, device=dev)
    mslots = torch.arange(M, device=dev)
    nrow = torch.arange(N, device=dev)[:, None]  # [N, 1]
    limit = (torch.full((N,), -1.0, dtype=f64, device=dev) if quality_limits is None
             else torch.as_tensor(quality_limits, dtype=f64, device=dev).reshape(N))
    has_limit = limit >= 0
    lim2 = limit[:, None]
    budget = int(exchange_budget)
    fan_eff = max(1, min(int(fan), K))
    big64 = _INT64_MAX
    Ms = -(-M // fan_eff)
    jj = torch.arange(Ms, device=dev)
    gidx = jj[None, :] * fan_eff + (kk[:, None] % fan_eff)  # [K, Ms]
    in_seg = gidx < M
    gidx = torch.clamp(gidx, max=M - 1).expand(N, K, Ms)

    def body(it, since, ex_done, choice, tab, counts, totals):
        order = torch.argsort(totals, dim=1, stable=True)  # [N, C]
        light = order[:, (kk + it % n_light) % n_light]  # [N, K]
        heavy = order[:, C - 1 - kk // fan_eff]
        tot_h = totals.gather(1, heavy)
        tot_l = totals.gather(1, light)
        diff = tot_h - tot_l
        delta = diff >> 1
        heavy_f = tot_h.to(f64)
        active = heavy_f > lim2
        # Both forms of the budget per row, the target's where it has one
        # (the single-row body's two branches, element for element).
        needed = torch.where(
            has_limit[:, None],
            torch.ceil((heavy_f - lim2) / fan_eff).to(torch.int64),
            delta // fan_eff + 1,
        )
        headroom = torch.where(
            has_limit[:, None],
            torch.floor(lim2 - tot_l.to(f64)).to(torch.int64),
            big64,
        )
        cap = torch.minimum(delta, torch.clamp(headroom, min=0))

        rows_h = tab.gather(1, heavy[:, :, None].expand(N, K, M))  # [N, K, M]
        rows_l = tab.gather(1, light[:, :, None].expand(N, K, M))
        hvalid = mslots < counts.gather(1, heavy)[:, :, None]
        lvalid = mslots < counts.gather(1, light)[:, :, None]
        lag_h = torch.where(hvalid, _row_gather(lags, torch.clamp(rows_h.long(), 0, P - 1)), -1)
        lag_l = torch.where(lvalid, _row_gather(lags, torch.clamp(rows_l.long(), 0, P - 1)),
                            big64)
        perm_h = lexsort(-lag_h, rows_h, dim=-1)
        nh = (-lag_h).gather(-1, perm_h)
        hs_row = rows_h.gather(-1, perm_h)
        perm_l = lexsort(lag_l, rows_l, dim=-1)
        la = lag_l.gather(-1, perm_l)
        ls_row = rows_l.gather(-1, perm_l)
        nh_s = nh.gather(-1, gidx)
        hs_row_s = hs_row.gather(-1, gidx)
        hs_slot_s = perm_h.gather(-1, gidx)
        ls_lag = la[..., :Ms]
        ls_row_s = ls_row[..., :Ms]
        ls_slot_s = perm_l[..., :Ms]
        rank_ok = in_seg & (nh_s <= 0) & (ls_lag < big64) & active[:, :, None]
        d = torch.where(rank_ok, -nh_s - ls_lag, 0)
        perm_d = lexsort(-d, hs_row_s, dim=-1)
        ds = d.gather(-1, perm_d)
        dh_row = hs_row_s.gather(-1, perm_d)
        dh_slot = hs_slot_s.gather(-1, perm_d)
        dl_row = ls_row_s.gather(-1, perm_d)
        dl_slot = ls_slot_s.gather(-1, perm_d)
        fit = (ds > 0) & (ds <= cap[:, :, None])
        cum = torch.cumsum(torch.where(fit, ds, 0), dim=-1)
        sel = fit & (cum <= cap[:, :, None]) & ((cum - ds) < needed[:, :, None])
        if budget:
            flat_sel = sel.reshape(N, K * Ms)
            quota = (budget - ex_done)[:, None]
            sel = (flat_sel & (torch.cumsum(flat_sel.to(torch.int64), dim=1) <= quota)
                   ).reshape(N, K, Ms)

        transfer = torch.where(sel, ds, 0).sum(dim=-1)  # [N, K]
        new_totals = totals.clone()
        flat_tot = new_totals.view(N * C)
        flat_tot.index_add_(0, (nrow * C + heavy).reshape(-1), -transfer.reshape(-1))
        flat_tot.index_add_(0, (nrow * C + light).reshape(-1), transfer.reshape(-1))
        r3 = nrow[:, :, None]
        drop_p = N * P
        h_local, h_in = _row_local(dh_row, P)
        l_local, l_in = _row_local(dl_row, P)
        h_rows = torch.where(sel & h_in, r3 * P + h_local, drop_p).reshape(-1)
        l_rows = torch.where(sel & l_in, r3 * P + l_local, drop_p).reshape(-1)
        ext = torch.cat([choice.reshape(-1), choice.new_zeros(1)])
        ext = _drop_set(ext, h_rows, light[:, :, None].expand(N, K, Ms).reshape(-1))
        ext = _drop_set(ext, l_rows, heavy[:, :, None].expand(N, K, Ms).reshape(-1))
        drop_t = N * C * M
        flat = torch.cat([tab.reshape(-1), tab.new_zeros(1)])
        hidx = torch.where(sel, r3 * (C * M) + heavy[:, :, None] * M + dh_slot, drop_t)
        lidx = torch.where(sel, r3 * (C * M) + light[:, :, None] * M + dl_slot, drop_t)
        flat = _drop_set(flat, hidx.reshape(-1), dl_row.reshape(-1))
        flat = _drop_set(flat, lidx.reshape(-1), dh_row.reshape(-1))

        old_peak = totals.amax(dim=1).to(f64)
        new_peak = new_totals.amax(dim=1).to(f64)
        min_step = torch.where(has_limit, (old_peak - limit) / 16.0, 0.0)
        good = (old_peak - new_peak) > torch.clamp(min_step, min=0.0)
        new_since = torch.where(good, 0, since + 1)
        new_ex = ex_done + sel.to(torch.int64).sum(dim=(1, 2))
        return (new_since, new_ex, ext[:drop_p].reshape(N, P),
                flat[:drop_t].reshape(N, C, M), counts, new_totals)

    since = torch.zeros(N, dtype=torch.int64, device=dev)
    ex_done = torch.zeros(N, dtype=torch.int64, device=dev)

    def going():
        """Each row's loop test and its exchanges so far, in one host read."""
        go = (since < patience) & (totals.amax(dim=1).to(f64) > limit)
        if budget:
            go &= ex_done < budget
        both = torch.stack([go.to(torch.int64), ex_done]).cpu().numpy()
        return both[0].astype(bool), both[1]

    rounds = np.zeros(N, dtype=np.int64)
    go, ex = going()
    it = 0
    while go.any() and it < iters:
        mask = torch.from_numpy(go).to(dev)
        out = body(it, since, ex_done, choice, row_tab, counts, totals)
        m1 = mask[:, None]
        since = torch.where(mask, out[0], since)
        ex_done = torch.where(mask, out[1], ex_done)
        choice = torch.where(m1, out[2], choice)
        row_tab = torch.where(mask[:, None, None], out[3], row_tab)
        totals = torch.where(m1, out[5], totals)
        rounds += go
        it += 1
        nxt, ex = going()
        go = go & nxt
    return choice, row_tab, counts, totals, rounds, ex


def refine_assignment_resident(lags, valid, choice, num_consumers: int,
                               iters: int = 16, max_pairs: int | None = None,
                               patience: int = 8, exchange_budget: int = 0,
                               quality_limit=-1.0):
    """:func:`refine_assignment` of one topic through the resident rounds:
    the table built fresh by one P-sized sort, :func:`refine_rounds_resident`
    run on it, the table dropped.  With no budget and no limit its results
    are bit-identical to :func:`refine_assignment`'s.  Needs the count
    invariant (max count <= ceil(P / C) + 1).  Returns (choice int32[P],
    counts int32[C], totals int64[C])."""
    C = int(num_consumers)
    if C < 2 or iters <= 0:
        choice, _, counts, totals = _start_state(lags, valid, choice, C)
        return choice, counts, totals
    choice = choice.to(torch.int32)
    row_tab, counts, totals = build_choice_tables(
        lags, valid, choice, C, table_rows(lags.shape[0], C)
    )
    choice, _, counts, totals, _, _ = refine_rounds_resident(
        lags, choice, row_tab, counts, totals, num_consumers=C, iters=iters,
        max_pairs=max_pairs, patience=patience, exchange_budget=exchange_budget,
        quality_limit=quality_limit,
    )
    return choice, counts, totals


# ---------------------------------------------------------------------------
# Resident-state integrity digest (K6)
# ---------------------------------------------------------------------------


def _state_digest_torch(lags_p, choice_p, counts, num_consumers: int):
    """Plain version of the digest, int64[4]: ``[counts_sum,
    range_violations, lags_sum, counts_vs_choice_L1]`` (the JAX package's
    ``_state_digest_xla``; :mod:`..utils.scrub` has the host truths).
    Integer sums, exact in any order; the int64 sums wrap modulo 2**64."""
    C = int(num_consumers)
    in_range = (choice_p >= 0) & (choice_p < C)
    viol = ((choice_p < -1) | (choice_p >= C)).sum()
    cnt = torch.bincount(
        torch.where(in_range, choice_p.long(), C), minlength=C + 1
    )[:C]
    mismatch = (cnt - counts.long()).abs().sum()
    return torch.stack([counts.long().sum(), viol, lags_p.long().sum(), mismatch])


def _row_tab_lane_torch(lags_p, choice_p, row_tab, counts, num_consumers: int):
    """Plain version of the row-table lane (int64 scalar, host truth 0; the
    JAX package's ``_row_tab_lane_xla``): the valid slots (``j <
    counts[c]``) whose row is outside [0, B) or not owned by ``c``, the
    empty slots not holding the sentinel B, and ``|sum(valid-slot rows) -
    sum(assigned rows)|``, which catches a slot that names another row of
    the same consumer."""
    B = lags_p.shape[0]
    C, M = int(num_consumers), row_tab.shape[1]
    dev = row_tab.device
    slot_j = torch.arange(M, device=dev)[None, :]
    valid_slot = slot_j < torch.clamp(counts.long(), max=M)[:, None]
    r = torch.clamp(row_tab.long(), 0, B - 1)
    owner_bad = (
        valid_slot & (choice_p[r] != torch.arange(C, device=dev)[:, None])
    ).sum()
    range_bad = (valid_slot & ((row_tab < 0) | (row_tab >= B))).sum()
    sentinel_bad = (~valid_slot & (row_tab != B)).sum()
    slot_sum = torch.where(valid_slot, r, 0).sum()
    assigned = (choice_p >= 0) & (choice_p < C)
    row_sum = torch.where(assigned, torch.arange(B, device=dev), 0).sum()
    return owner_bad + range_bad + sentinel_bad + (slot_sum - row_sum).abs()


def _check_digest(lags_p, choice_p, counts, num_consumers: int, row_tab) -> None:
    dev = lags_p.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"state_digest runs on cuda or cpu, not {dev}")
    C = int(num_consumers)
    if C < 1:
        raise ValueError(f"state_digest takes 1 or more consumers, got {C}")
    B = lags_p.shape[0]
    want = [("lags_p", lags_p, torch.int64, (B,)),
            ("choice_p", choice_p, torch.int32, (B,)),
            ("counts", counts, torch.int32, (C,))]
    if row_tab is not None:
        want.append(("row_tab", row_tab, torch.int32, (C, row_tab.shape[-1])))
    for name, t, dtype, shape in want:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype}{list(shape)}, got "
                             f"{t.dtype}{list(t.shape)}")
        if t.device != dev:
            raise ValueError("state_digest inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= B < 2**31 or (row_tab is not None and row_tab.numel() >= 2**31):
        raise ValueError(f"state_digest takes 1 to 2**31 - 1 rows, got {B}")


def state_digest(lags_p, choice_p, counts, num_consumers: int, row_tab=None):
    """The integrity digest of the resident state: int64[4], or int64[5]
    with the row-table lane when ``row_tab`` is given.

    Args: lags_p int64[B], choice_p int32[B] (-1 on padding), counts
    int32[C], row_tab int32[C, M]; C >= 1.  A CUDA tensor launches the K6
    kernel (one count in ``state_digest.launches``; its histogram in shared
    memory up to 57,856 consumers, in its scratch above), which computes
    all five lanes in one call, or raises; a
    CPU tensor runs the plain version.  Both raise ``ValueError`` on the
    same inputs.
    """
    _check_digest(lags_p, choice_p, counts, num_consumers, row_tab)
    if lags_p.device.type == "cpu":
        base = _state_digest_torch(lags_p, choice_p, counts, num_consumers)
        if row_tab is None:
            return base
        lane = _row_tab_lane_torch(lags_p, choice_p, row_tab, counts, num_consumers)
        return torch.cat([base, lane[None]])
    from .state_digest_cuda import launch

    out = launch(lags_p, choice_p, counts, num_consumers, row_tab)
    count_launch(state_digest)
    return out if row_tab is not None else out[:4]


state_digest.launches = 0


def state_digest_rows(lags, choice, counts, num_consumers: int, row_tab):
    """The integrity digest of N resident states of one shape: int64[N, 5],
    row n equal to ``state_digest(lags[n], choice[n], counts[n],
    num_consumers, row_tab=row_tab[n])``.

    Args: lags int64[N, B], choice int32[N, B], counts int32[N, C], row_tab
    int32[N, C, M]; N >= 1, the limits of :func:`state_digest` per row.  A
    CUDA tensor launches the batched K6 kernel once for all N rows (one
    count in ``state_digest_rows.launches``) or raises; a CPU tensor runs
    the plain version row by row.  Both raise ``ValueError`` on the same
    inputs.
    """
    if lags.dim() != 2 or lags.shape[0] < 1:
        raise ValueError(f"lags must be int64[N, B] with N >= 1, got {list(lags.shape)}")
    N = lags.shape[0]
    if not 1 <= N <= 65535:
        raise ValueError(f"state_digest_rows takes 1 to 65535 rows, got {N}")
    shapes = [("choice", choice, 2), ("counts", counts, 2), ("row_tab", row_tab, 3)]
    for name, t, dims in shapes:
        if t.dim() != dims or t.shape[0] != N:
            raise ValueError(f"{name} must have {dims} axes and {N} rows, got "
                             f"{list(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not lags.is_contiguous():
        raise ValueError("lags must be contiguous")
    _check_digest(lags[0], choice[0], counts[0], num_consumers, row_tab[0])
    if lags.device.type == "cpu":
        return torch.stack([
            torch.cat([
                _state_digest_torch(lags[n], choice[n], counts[n], num_consumers),
                _row_tab_lane_torch(lags[n], choice[n], row_tab[n], counts[n],
                                    num_consumers)[None],
            ])
            for n in range(N)
        ])
    from .state_digest_cuda import launch_rows

    out = launch_rows(lags, choice, counts, num_consumers, row_tab)
    count_launch(state_digest_rows)
    return out


state_digest_rows.launches = 0


def _state_digest_shard_torch(lags_s, choice_s, counts, num_consumers: int, row_tab,
                              lo: int, total_rows: int, lead: bool):
    """Plain version of one shard's partial digest (``csrc/state_digest.cu``,
    ``klba_state_digest_shard``): ``(part int64[5], hist int32[C])`` of the
    row shard ``[lo, lo + Bs)`` of a ``total_rows``-row state.  ``part`` is
    ``[lag sum, range violations, sum of the assigned global row ids, sum of
    the clamped valid-slot rows (lead only), owner failures of the valid
    slots whose clamped row lies in the shard + the slot range and sentinel
    failures (lead only)]``; ``hist`` the shard's occupancy histogram."""
    C, B = int(num_consumers), int(total_rows)
    Bs = lags_s.shape[0]
    dev = lags_s.device
    in_range = (choice_s >= 0) & (choice_s < C)
    viol = ((choice_s < -1) | (choice_s >= C)).sum()
    hist = torch.bincount(
        torch.where(in_range, choice_s.long(), C), minlength=C + 1
    )[:C].to(torch.int32)
    rows = lo + torch.arange(Bs, device=dev)
    row_sum = torch.where(in_range, rows, 0).sum()
    M = row_tab.shape[1]
    valid_slot = torch.arange(M, device=dev)[None, :] < torch.clamp(
        counts.long(), max=M)[:, None]
    r = torch.clamp(row_tab.long(), 0, B - 1)
    mine = valid_slot & (r >= lo) & (r < lo + Bs)
    owner = choice_s[torch.clamp(r - lo, 0, Bs - 1)]
    bad = (mine & (owner != torch.arange(C, device=dev)[:, None])).sum()
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    slot_sum = zero
    if lead:
        bad = (bad + (valid_slot & ((row_tab < 0) | (row_tab >= B))).sum()
               + (~valid_slot & (row_tab != B)).sum())
        slot_sum = torch.where(valid_slot, r, 0).sum()
    part = torch.stack([lags_s.long().sum(), viol, row_sum, slot_sum, bad])
    return part, hist


def state_digest_sharded(lag_shards, choice_shards, counts, num_consumers: int,
                         row_tab, row_offsets):
    """The integrity digest of a row-sharded resident state, int64[5] on the
    lead shard's device: equal to :func:`state_digest` of the gathered state
    (``row_tab`` given), without gathering its ``[B]`` rows.

    Args: ``lag_shards`` / ``choice_shards`` the D shards' rows (int64[Bs]
    and int32[Bs], each on its shard's device), ``counts`` int32[C] and
    ``row_tab`` int32[C, M] (one tensor, or one replicated copy a shard),
    ``row_offsets`` the global id of each shard's first row (``[0, B0, B0 +
    B1, ...]``); C >= 1.  On a CUDA shard it launches K6's shard
    entry once on that shard's device (one count a launch in
    ``state_digest_sharded.launches``) or raises; a CPU shard runs the plain
    version.  The partial lanes and histograms are summed with the mesh's
    psum; the lead shard then adds the count terms.  Integer sums: the
    result is exact whatever the split.  Raises ``ValueError`` on the same
    inputs on both devices.
    """
    from ..sharded.collectives import psum

    D = len(lag_shards)
    if D < 1 or len(choice_shards) != D or len(row_offsets) != D:
        raise ValueError("state_digest_sharded needs as many lag shards, choice "
                         "shards and row offsets, at least one")
    counts_l = list(counts) if isinstance(counts, (list, tuple)) else [counts] * D
    tabs_l = list(row_tab) if isinstance(row_tab, (list, tuple)) else [row_tab] * D
    if len(counts_l) != D or len(tabs_l) != D:
        raise ValueError("state_digest_sharded takes one counts / row_tab copy "
                         "a shard, or one for all")
    total = sum(int(t.shape[0]) for t in lag_shards)
    lo = 0
    for d in range(D):
        if int(row_offsets[d]) != lo:
            raise ValueError(f"row_offsets must be the shards' first rows; shard "
                             f"{d} starts at {lo}, not {int(row_offsets[d])}")
        if tabs_l[d] is None or tabs_l[d].dim() != 2 or tabs_l[d].shape[1] < 1:
            raise ValueError("state_digest_sharded needs the row table int32[C, M]")
        _check_digest(lag_shards[d], choice_shards[d], counts_l[d], num_consumers,
                      tabs_l[d])
        lo += int(lag_shards[d].shape[0])
    if total >= 2**31:
        raise ValueError(f"state_digest_sharded takes up to 2**31 - 1 rows, got {total}")
    parts, hists = [], []
    for d in range(D):
        args = (lag_shards[d], choice_shards[d], counts_l[d], num_consumers, tabs_l[d],
                int(row_offsets[d]), total, d == 0)
        if lag_shards[d].device.type == "cpu":
            part, hist = _state_digest_shard_torch(*args)
        else:
            from .state_digest_cuda import launch_shard

            part, hist = launch_shard(*args)
            count_launch(state_digest_sharded)
        parts.append(part)
        hists.append(hist)
    return combine_shard_digests(psum(parts)[0], psum(hists)[0], counts_l[0])


def combine_shard_digests(part, hist, counts):
    """The digest int64[5] from the shards' summed partial lanes ``part``
    int64[5] and occupancy ``hist`` [C] (the lead shard's work): the count
    lanes from ``counts``, the row-table lane's ``|slot sum - row sum|``."""
    cnt = counts.to(part.device).long()
    return torch.stack([
        cnt.sum(), part[1], part[0], (hist.long() - cnt).abs().sum(),
        part[4] + (part[3] - part[2]).abs(),
    ])


state_digest_sharded.launches = 0
