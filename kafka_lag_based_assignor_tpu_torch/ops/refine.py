"""Resident-table pairwise-exchange refinement (the parity body).

Counterpart of ``_quant_shift``, ``build_choice_tables`` and
``refine_rounds_resident`` in ``kafka_lag_based_assignor_tpu/ops/refine.py``.
It post-processes an integral, count-balanced assignment to tighten the
max/mean lag imbalance while keeping ``max - min <= 1`` partitions.

The state is a compact per-consumer row table ``row_tab`` [C, M] (M =
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

Only the parity body is ported.  The warm-path options of the JAX loop
(``bulk_transfer``, ``fan``, ``quality_limit``, ``exchange_budget``,
``allow_moves=False``) serve the streaming and federated slices and raise
``NotImplementedError`` here.  The loop runs on the host and reads one
scalar from the device a round (the patience stop).
"""

from __future__ import annotations

import torch

from .sortops import lexsort

_PAIR_BITS = 14
_VBITS = 63 - _PAIR_BITS - 1  # quantized-lag field width (48)
_SBIG = 1 << 60  # score sentinel; (x << 1) | 1 fits int64
_INT64_MAX = torch.iinfo(torch.int64).max


def _quant_shift(lags, assigned):
    """The quantization shift: max(bit_length(max assigned lag, >= 1) -
    48, 0), as an int64 scalar tensor.  The bit length is counted with
    integer shifts (no float, which rounds above 2**53)."""
    maxlag = torch.clamp(torch.where(assigned, lags, 0).max(), min=1)
    shifts = torch.arange(63, dtype=torch.int64, device=lags.device)
    bitlen = ((maxlag >> shifts) > 0).sum()
    return torch.clamp(bitlen - _VBITS, min=0)


def build_choice_tables(lags, valid, choice, num_consumers: int, table_rows: int):
    """One P-sized stable sort -> the compact per-consumer row table.

    Returns (row_tab int32[C, M] — row indices in ascending order within a
    consumer, P at empty slots — counts int32[C], totals int64[C]).
    """
    C, M = int(num_consumers), int(table_rows)
    P = lags.shape[0]
    dev = lags.device
    arange_p = torch.arange(P, device=dev)
    seg = torch.where(valid & (choice >= 0), choice.to(torch.int64), C)
    sseg, srow = torch.sort(seg, stable=True)
    bnd = torch.searchsorted(sseg, torch.arange(C + 1, device=dev))
    counts = (bnd[1:] - bnd[:-1]).to(torch.int32)
    pos = arange_p - bnd[torch.clamp(sseg, 0, C)]
    flat = torch.where((sseg < C) & (pos < M), sseg * M + pos, C * M)
    # One extra slot takes the writes that JAX's mode="drop" discards.
    tab = torch.full((C * M + 1,), P, dtype=torch.int32, device=dev)
    tab[flat] = srow.to(torch.int32)
    row_tab = tab[: C * M].reshape(C, M)
    slots = torch.arange(M, device=dev)[None, :]
    lag_tab = torch.where(
        slots < counts[:, None].to(torch.int64),
        lags[torch.clamp(row_tab.to(torch.int64), 0, P - 1)],
        0,
    )
    return row_tab, counts, lag_tab.sum(dim=1)


def _take(a, i):
    """a[k, i[k]] for each row k."""
    return a.gather(1, i[:, None])[:, 0]


def _drop_set(flat, idx, vals):
    """``flat.at[idx].set(vals, mode="drop")`` for a flat tensor whose
    last slot is the drop slot (idx == its index)."""
    flat[idx] = vals.to(flat.dtype)
    return flat


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
    """The resident-table round loop, parity body (module docstring).

    Args: lags int64[P]; choice int32[P] (-1 unassigned); row_tab,
    counts, totals from :func:`build_choice_tables`; ``iters`` the round
    budget; ``max_pairs`` caps the pair count K (default C // 2);
    ``patience`` stops after that many rounds without a drop of the peak.

    Returns (choice, row_tab, counts, totals, rounds_done,
    exchanges_done), the last two as ints.
    """
    if (exchange_budget or quality_limit is not None or bulk_transfer
            or fan != 1 or not allow_moves):
        raise NotImplementedError(
            "refine_rounds_resident's bulk_transfer, fan, quality_limit, "
            "exchange_budget and allow_moves=False serve the streaming and "
            "federated paths, which are not ported to PyTorch yet (see "
            "ROADMAP.md)"
        )
    C = int(num_consumers)
    P = lags.shape[0]
    M = row_tab.shape[1]
    K = max(1, min(C // 2, max_pairs if max_pairs is not None else C // 2))
    if C < 2 or iters <= 0:
        return choice, row_tab, counts, totals, 0, 0
    dev = lags.device
    choice = choice.to(torch.int32)
    pshift = _quant_shift(lags, choice >= 0)
    n_light = C - K
    kk = torch.arange(K, device=dev)
    mslots = torch.arange(M, device=dev)
    nop = C * M
    limit = -1.0  # no quality limit: every pair stays active

    def body(it, since, choice, tab, counts, totals):
        order = torch.argsort(totals, stable=True)
        light = order[(kk + it % n_light) % n_light]  # [K]
        heavy = order[C - 1 - kk]                     # [K]
        diff = totals[heavy] - totals[light]          # [K] >= 0
        cnt_h = counts[heavy].to(torch.int64)
        cnt_l = counts[light].to(torch.int64)
        move_ok = cnt_h > cnt_l
        delta = diff >> 1
        diff_q = diff >> pshift
        delta_q = delta >> pshift

        rows_h = tab[heavy].to(torch.int64)  # [K, M]
        rows_l = tab[light].to(torch.int64)
        hvalid = mslots[None, :] < cnt_h[:, None]
        lvalid = mslots[None, :] < cnt_l[:, None]
        lag_h = torch.where(hvalid, lags[torch.clamp(rows_h, 0, P - 1)], 0)
        lag_l = torch.where(lvalid, lags[torch.clamp(rows_l, 0, P - 1)], 0)
        qlag_h = lag_h >> pshift
        tgt_h = torch.clamp(lag_h - delta[:, None], min=0) >> pshift

        # Light segments sorted by (qval, row), as lax.sort(num_keys=2).
        key_q = torch.where(lvalid, lag_l >> pshift, _INT64_MAX)
        key_r = torch.where(lvalid, rows_l, P)
        perm = lexsort(key_q, key_r, dim=1)
        sq = key_q.gather(1, perm)
        srow_l = key_r.gather(1, perm)
        sslot_l = perm
        slag_l = lag_l.gather(1, perm)
        ins = torch.searchsorted(sq, tgt_h, right=True)

        def neighbour(idx):
            ok_idx = (idx >= 0) & (idx < cnt_l[:, None])
            i_c = torch.clamp(idx, 0, M - 1)
            d_q = qlag_h - sq.gather(1, i_c)
            ok = hvalid & ok_idx & (d_q > 0) & (d_q < diff_q[:, None])
            return torch.where(ok, (d_q - delta_q[:, None]).abs(), _SBIG), i_c

        err_a, ia = neighbour(ins - 1)
        err_b, ib = neighbour(ins)
        use_b = err_b < err_a
        err_swap = torch.where(use_b, err_b, err_a)
        nb_i = torch.where(use_b, ib, ia)

        ok_move = hvalid & move_ok[:, None] & (lag_h > 0) & (lag_h < diff[:, None])
        score_move = torch.where(ok_move, (qlag_h - delta_q[:, None]).abs(), _SBIG)
        combined = torch.where(
            score_move <= err_swap, score_move << 1, (err_swap << 1) | 1
        )

        # Winner per pair: lexicographic min (combined, target, row).
        m1 = combined.min(dim=1).values
        on1 = combined == m1[:, None]
        m2 = torch.where(on1, tgt_h, _INT64_MAX).min(dim=1).values
        on2 = on1 & (tgt_h == m2[:, None])
        m3 = torch.where(on2, rows_h, P).min(dim=1).values
        win = torch.argmax((on2 & (rows_h == m3[:, None])).to(torch.int32), dim=1)

        active = totals[heavy].to(torch.float64) > limit
        do = (m1 < (_SBIG << 1)) & active
        is_swap = (m1 & 1) == 1
        p_sel = _take(rows_h, win)
        lag_p = _take(lag_h, win)
        nb_sel = _take(nb_i, win)
        q_sel = _take(srow_l, nb_sel)
        lag_q = _take(slag_l, nb_sel)
        q_slot = _take(sslot_l, nb_sel)
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
        n_ex = do.to(torch.int64).sum()
        return (new_since, new_choice, flat[:nop].reshape(C, M), new_counts,
                new_totals, n_ex)

    since = torch.zeros((), dtype=torch.int64, device=dev)
    ex_done = torch.zeros((), dtype=torch.int64, device=dev)
    it = 0
    go = patience > 0 and bool(totals.max().to(torch.float64) > limit)
    while go and it < iters:
        since, choice, row_tab, counts, totals, n_ex = body(
            it, since, choice, row_tab, counts, totals
        )
        ex_done = ex_done + n_ex
        it += 1
        go = bool((since < patience) & (totals.max().to(torch.float64) > limit))
    return choice, row_tab, counts, totals, it, int(ex_done)
