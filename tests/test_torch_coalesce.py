"""The port's megabatch coalescer (``ops/coalesce``), on the CPU.

The port's counterparts of the cases of ``tests/test_coalesce.py`` (every
one applies on one device): window and max-batch flushes, every coalesced
row bit-equal to the same engine's inline epoch (choices, rounds and
exchanges), a live quality limit, oversized groups in max_batch chunks,
mixed shape keys, fairness, flush-fault and poisoned-row isolation, the
steady-state loop building nothing, the roster lock and its churn, bounded
retention, dead submitters, gather faults, the sidecar's routing and
stats, the knobs, and a corrupted locked row.  Then the twin: the JAX
package's coalescer and the port's get the same seeded waves, and every row
and every ``stats()`` delta agree.

Steadiness under a loaded host: every coalescer is closed and its threads
joined by the ``coal`` fixture, and no assertion needs a window shorter
than a loaded host keeps: waves flush full (``max_batch`` pending) or are
driven white-box through ``_flush`` with ``pipeline=False``.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kafka_lag_based_assignor_tpu.ops import coalesce as jax_coalesce  # noqa: E402
from kafka_lag_based_assignor_tpu.ops import streaming as jax_streaming  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import faults as jax_faults  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops import coalesce as coalesce_mod  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops.batched import stream_payload  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops.coalesce import (  # noqa: E402
    EpochSubmission,
    MegabatchCoalescer,
    ResidentRow,
    SubmitterGone,
)
from kafka_lag_based_assignor_tpu_torch.ops.streaming import StreamingAssignor  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.utils import faults, metrics  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.utils.observability import (  # noqa: E402
    compile_count,
    install_compile_counter,
)


@pytest.fixture()
def coal():
    """A factory of CPU coalescers; every one is closed and its flusher and
    readback threads joined at teardown."""
    made = []

    def make(**kw):
        kw.setdefault("device", "cpu")
        c = MegabatchCoalescer(**kw)
        made.append(c)
        return c

    yield make
    for c in made:
        c.close(timeout_s=60.0)
        for t in (c._thread, c._rb_thread):
            assert t is None or not t.is_alive()


def _engines(n, C=8, refine_iters=16, **kw):
    kw.setdefault("refine_threshold", None)  # every warm epoch dispatches
    return [StreamingAssignor(num_consumers=C, refine_iters=refine_iters,
                              device="cpu", **kw) for _ in range(n)]


def _lags(rng, P):
    """Lags well inside int32, so the payload dtype (part of the shape key)
    cannot flip mid-test."""
    return rng.integers(10**6, 10**8, P).astype(np.int64)


def _submit_all(engines, lags_list, coal, timeout_s=180.0):
    out = [None] * len(engines)
    errs = [None] * len(engines)

    def run(i):
        try:
            out[i] = engines[i].submit_epoch(lags_list[i], coal)
        except Exception as exc:  # noqa: BLE001 — re-raised below
            errs[i] = exc

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(engines))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout_s)
        assert not t.is_alive(), "coalesced epoch did not complete"
    for e in errs:
        if e is not None:
            raise e
    return out


def _hist():
    return metrics.REGISTRY.histogram("klba_coalesce_batch_size").state()


def _hist_delta(before, after):
    return [a - b for a, b in zip(after["buckets"], before["buckets"])]


def _same_epoch(a, b):
    sa, sb = a.last_stats, b.last_stats
    assert (sa.refine_rounds, sa.refine_exchanges) == (sb.refine_rounds, sb.refine_exchanges)
    assert sa.max_mean_imbalance == sb.max_mean_imbalance


def _seed_pair(rng, inline, co, P):
    for a, b in zip(inline, co):
        lg = _lags(rng, P)
        np.testing.assert_array_equal(a.rebalance(lg), b.rebalance(lg))


def _parity_wave(rng, inline, co, coal, P):
    arrs = [_lags(rng, P) for _ in co]
    want = [e.rebalance(a) for e, a in zip(inline, arrs)]
    got = _submit_all(co, arrs, coal)
    for g in range(len(co)):
        np.testing.assert_array_equal(want[g], got[g])
        _same_epoch(inline[g], co[g])


def test_constructor_validation_and_close(coal):
    for kw, match in (({"window_s": -1.0}, "window_s"), ({"max_batch": 0}, "max_batch"),
                      ({"lock_waves": 0}, "lock_waves"), ({"delta_k": -1}, "delta_k")):
        with pytest.raises(ValueError, match=match):
            MegabatchCoalescer(device="cpu", **kw)
    # A mesh manager is kept (it places locked rosters; none is locked
    # yet): the coalescer runs on its own device.
    kept = object()
    placed = MegabatchCoalescer(device="cpu", mesh_manager=kept)
    assert placed.mesh_manager is kept and placed.device.type == "cpu"
    assert placed.stats()["stream_sharded_rosters"] == 0
    placed.close()
    c = coal()
    c.close()
    with pytest.raises(RuntimeError, match="closed"):
        c.submit(EpochSubmission(payload=np.zeros(4, np.int32), bucket=8, resident=None,
                                 limit=-1.0, num_consumers=2, iters=1, max_pairs=1,
                                 exchange_budget=1))


def test_single_row_window_timeout_flush(coal):
    """A lone submission flushes when its window ends, through the
    single-stream dispatch: bit-equal to an inline twin engine."""
    rng = np.random.default_rng(40)
    P = 512
    (a,), (b,) = _engines(1), _engines(1)
    c = coal(window_s=0.005, max_batch=32)
    lags = _lags(rng, P)
    np.testing.assert_array_equal(a.rebalance(lags), b.rebalance(lags))
    lags2 = _lags(rng, P)
    np.testing.assert_array_equal(a.rebalance(lags2), b.submit_epoch(lags2, c))
    assert b.last_stats.refined
    _same_epoch(a, b)


def test_megabatch_rows_match_inline_bit_exact(coal):
    """Every row of a batched wave equals the same engine's inline epoch:
    choices, imbalance, rounds and exchanges, over several waves."""
    rng = np.random.default_rng(41)
    G, P = 3, 512
    inline, co = _engines(G), _engines(G)
    c = coal(window_s=5.0, max_batch=G)
    _seed_pair(rng, inline, co, P)
    for _ in range(3):
        _parity_wave(rng, inline, co, c, P)
    assert co[0].last_stats.refined


def test_megabatch_parity_with_live_quality_limit(coal):
    """Parity with the device-side target live (threshold 1.02, guardrail
    1.25): the limit test, the receiver headroom and the early exit."""
    rng = np.random.default_rng(48)
    G, P, C = 2, 512, 8
    kw = dict(refine_threshold=1.02, imbalance_guardrail=1.25)
    inline, co = _engines(G, C=C, **kw), _engines(G, C=C, **kw)
    c = coal(window_s=5.0, max_batch=G)
    base = [_lags(rng, P) for _ in range(G)]
    for g in range(G):
        np.testing.assert_array_equal(inline[g].rebalance(base[g]), co[g].rebalance(base[g]))
    for member in range(2):
        lags = [np.where(inline[g]._prev_choice == member, base[g] * 3, base[g]
                         ).astype(np.int64) for g in range(G)]
        want = [inline[g].rebalance(lags[g]) for g in range(G)]
        got = _submit_all(co, lags, c)
        for g in range(G):
            assert inline[g].last_stats.refined and co[g].last_stats.refined
            np.testing.assert_array_equal(want[g], got[g])
            _same_epoch(inline[g], co[g])
            sc = co[g].last_stats
            assert sc.max_mean_imbalance <= 1.02 * max(sc.imbalance_bound, 1.0) + 1e-9


def test_oversized_group_flushes_in_max_batch_chunks(coal):
    rng = np.random.default_rng(49)
    G, P = 3, 512
    inline, co = _engines(G), _engines(G)
    c = coal(window_s=0.2, max_batch=2)
    _seed_pair(rng, inline, co, P)
    before = _hist()
    _parity_wave(rng, inline, co, c, P)
    delta = _hist_delta(before, _hist())
    assert sum(delta) >= 2  # the wave split into >= 2 flushes
    assert sum(delta[2:]) == 0, "a flush exceeded max_batch"


def test_max_batch_flush_fires_before_window(coal):
    rng = np.random.default_rng(42)
    G, P = 2, 512
    co = _engines(G)
    c = coal(window_s=30.0, max_batch=G)
    for e in co:
        e.rebalance(_lags(rng, P))
    _submit_all(co, [_lags(rng, P) for _ in range(G)], c)
    t0 = time.monotonic()
    _submit_all(co, [_lags(rng, P) for _ in range(G)], c)
    # "Did not wait out the 30 s window", with room for a loaded host.
    assert time.monotonic() - t0 < 10.0, "full batch waited out the admission window"


def test_mixed_shape_buckets_flush_as_separate_groups(coal):
    rng = np.random.default_rng(43)
    P = 512
    (a8,), (b8,), (a4,), (b4,) = (_engines(1, C=8), _engines(1, C=8),
                                  _engines(1, C=4), _engines(1, C=4))
    c = coal(window_s=0.05, max_batch=32)
    lags = _lags(rng, P)
    for eng in (a8, b8, a4, b4):
        eng.rebalance(lags)
    lags2 = _lags(rng, P)
    want8, want4 = a8.rebalance(lags2), a4.rebalance(lags2)
    got8, got4 = _submit_all([b8, b4], [lags2, lags2], c)
    np.testing.assert_array_equal(want8, got8)
    np.testing.assert_array_equal(want4, got4)


def test_fairness_under_hot_stream(coal):
    """A hot stream's back-to-back epochs do not starve a slower one: every
    flush takes everything pending, so the cold stream rides the hot one's
    waves (a full pair flushes at once; the window is long enough for a
    loaded host to pair them)."""
    rng = np.random.default_rng(44)
    P = 512
    (hot,), (cold,) = _engines(1), _engines(1)
    c = coal(window_s=1.0, max_batch=2)
    done = {"hot": 0, "cold": 0}
    hot.rebalance(_lags(rng, P))
    cold.rebalance(_lags(rng, P))
    before = _hist()
    hot_lags = [_lags(rng, P) for _ in range(6)]
    cold_lags = [_lags(rng, P) for _ in range(3)]

    def loop(eng, arrs, name):
        for arr in arrs:
            eng.submit_epoch(arr, c)
            done[name] += 1

    threads = [threading.Thread(target=loop, args=(hot, hot_lags, "hot")),
               threading.Thread(target=loop, args=(cold, cold_lags, "cold"))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180.0)
        assert not t.is_alive(), "a stream starved"
    assert done == {"hot": 6, "cold": 3}
    delta = _hist_delta(before, _hist())
    assert sum(delta[1:]) >= 1, "no multi-row batch ever formed"


def test_flush_fault_isolates_rows_and_falls_back(coal):
    """An injected ``coalesce.flush`` fault fails the batch dispatch, not
    the epochs: every row re-runs the single-stream dispatch and returns
    the inline answer."""
    rng = np.random.default_rng(45)
    G, P = 2, 512
    inline, co = _engines(G), _engines(G)
    c = coal(window_s=5.0, max_batch=G)
    _seed_pair(rng, inline, co, P)
    fallback = metrics.REGISTRY.counter("klba_coalesce_flushes_total", {"path": "fallback"})
    before = fallback.value
    with faults.injected(faults.FaultInjector().plan("coalesce.flush", times=1)):
        _parity_wave(rng, inline, co, c, P)
    assert fallback.value == before + 1


def test_poisoned_row_does_not_poison_batchmates(coal, monkeypatch):
    rng = np.random.default_rng(46)
    G, P = 2, 512
    inline, co = _engines(G), _engines(G)
    c = coal(window_s=5.0, max_batch=G)
    for g in range(G):
        lg = _lags(rng, P)
        inline[g].rebalance(lg)
        co[g].rebalance(lg)
    lags = [_lags(rng, P) for _ in range(G)]
    lags[0][0] = 2**30 + 7  # marks row 0: its single dispatch raises
    want1 = inline[1].rebalance(lags[1])
    real = coalesce_mod._warm_fused_resident

    def flaky(payload, *args, **kw):
        if int(payload[0]) == 2**30 + 7:
            raise RuntimeError("poisoned row")
        return real(payload, *args, **kw)

    monkeypatch.setattr(coalesce_mod, "_warm_fused_resident", flaky)
    out, errs = [None, None], [None, None]

    def run(i):
        try:
            out[i] = co[i].submit_epoch(lags[i], c)
        except Exception as exc:  # noqa: BLE001 — asserted below
            errs[i] = exc

    with faults.injected(faults.FaultInjector().plan("coalesce.flush", times=1)):
        threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180.0)
            assert not t.is_alive()
    assert isinstance(errs[0], RuntimeError) and errs[1] is None
    np.testing.assert_array_equal(want1, out[1])


def test_steady_state_megabatch_loop_compiles_nothing(coal):
    """Once the waves have run, further coalesced waves build no kernel
    (``compile_count`` counts every nvcc / g++ build of ``ops/_build``)."""
    install_compile_counter()
    rng = np.random.default_rng(47)
    G, P = 3, 512
    co = _engines(G)
    c = coal(window_s=5.0, max_batch=G)
    for e in co:
        e.rebalance(_lags(rng, P))
    for _ in range(2):
        _submit_all(co, [_lags(rng, P) for _ in range(G)], c)
    before = compile_count()
    for _ in range(3):
        got = _submit_all(co, [_lags(rng, P) for _ in range(G)], c)
        for g in range(G):
            counts = np.bincount(got[g], minlength=8)
            assert counts.max() - counts.min() <= 1
    assert compile_count() == before, "the steady-state loop built a kernel"


def _sub_for(engine, lags, resident, abandoned=None):
    """An EpochSubmission as submit_epoch builds it for an always-refine
    engine, with the resident state given explicitly (white-box waves)."""
    arr = np.ascontiguousarray(lags, dtype=np.int64)
    payload, _ = stream_payload(arr)
    C = engine.num_consumers
    return EpochSubmission(
        payload=payload, bucket=engine._bucket(arr.shape[0]), resident=resident,
        limit=-1.0, num_consumers=C, iters=engine.refine_iters,
        max_pairs=min(C // 2, 16), exchange_budget=engine.refine_iters,
        owner=engine, abandoned=abandoned, lag_sum=int(arr.sum()),
    )


def _counters():
    reg = metrics.REGISTRY
    return (reg.counter("klba_coalesce_roster_hits_total"),
            reg.counter("klba_coalesce_restack_total"),
            reg.counter("klba_coalesce_roster_invalidations_total"))


def test_roster_locks_and_eliminates_restack(coal):
    """After the first wave the roster locks: engines hold ResidentRow
    handles, every later wave is a locked dispatch, the re-stack counter
    stays flat, nothing is built, and every row equals its inline twin."""
    install_compile_counter()
    rng = np.random.default_rng(60)
    G, P = 3, 512
    inline, co = _engines(G), _engines(G)
    c = coal(window_s=5.0, max_batch=G, lock_waves=1)
    hits, restack, _ = _counters()
    _seed_pair(rng, inline, co, P)
    h0, r0 = hits.value, restack.value
    _parity_wave(rng, inline, co, c, P)
    assert (hits.value, restack.value) == (h0, r0 + 1)
    assert all(isinstance(e._resident, ResidentRow) for e in co)
    _parity_wave(rng, inline, co, c, P)
    assert (hits.value, restack.value) == (h0 + 1, r0 + 1)
    before = compile_count()
    for _ in range(3):
        _parity_wave(rng, inline, co, c, P)
    assert (hits.value, restack.value) == (h0 + 4, r0 + 1)
    assert compile_count() == before


def test_roster_churn_invalidates_once_then_relocks(coal):
    """A stream leaving, joining or rebuilding its state invalidates the
    batch exactly once; the churn wave re-stacks and the next re-locks."""
    rng = np.random.default_rng(61)
    G, P = 3, 512
    inline, co = _engines(G), _engines(G)
    c = coal(window_s=5.0, max_batch=G, lock_waves=1, pipeline=False)
    hits, restack, inv = _counters()
    state = {}
    for g in range(G):
        lg = _lags(rng, P)
        np.testing.assert_array_equal(inline[g].rebalance(lg), co[g].rebalance(lg))
        state[g] = co[g]._resident

    def wave(members):
        arrs = {g: _lags(rng, P) for g in members}
        want = {g: inline[g].rebalance(arrs[g]) for g in members}
        subs = {g: _sub_for(co[g], arrs[g], state[g]) for g in members}
        c._flush(list(subs.values()))
        for g in members:
            r = subs[g].future.result(timeout=180.0)
            state[g] = r.resident
            np.testing.assert_array_equal(want[g], r.narrow[:P])

    h0, r0, i0 = hits.value, restack.value, inv.value
    steps = [([0, 1, 2], (0, 1, 0)), ([0, 1, 2], (1, 1, 0)),
             ([0, 1], (1, 2, 1)), ([0, 1], (2, 2, 1)),
             ([0, 1, 2], (2, 3, 2)), ([0, 1, 2], (3, 3, 2))]
    for members, (dh, dr, di) in steps:
        wave(members)
        assert (hits.value - h0, restack.value - r0, inv.value - i0) == (dh, dr, di)
    assert all(isinstance(state[g], ResidentRow) for g in range(G))
    state[1] = state[1].materialize()  # the stale-resident rebuild shape
    wave([0, 1, 2])
    assert (hits.value - h0, restack.value - r0, inv.value - i0) == (3, 4, 3)
    wave([0, 1, 2])
    assert (hits.value - h0, restack.value - r0, inv.value - i0) == (4, 4, 3)


def test_roster_and_staging_retention_is_bounded(coal):
    c = coal(pipeline=False)
    owners = [object() for _ in range(coalesce_mod._MAX_ROSTERS + 3)]
    batches = []
    for i, owner in enumerate(owners):
        c._tick += 1
        sub = EpochSubmission(payload=np.zeros(4, np.int32), bucket=8, resident=None,
                              limit=-1.0, num_consumers=2, iters=1, max_pairs=1,
                              exchange_budget=1, owner=owner)
        _, roster = c._note_wave(("key", i), [sub])
        batch = coalesce_mod._ResidentBatch(("key", i), None, None, None, None, n_real=1)
        roster.batch = batch
        batches.append(batch)
    assert len(c._rosters) == coalesce_mod._MAX_ROSTERS
    assert not batches[0].valid and batches[-1].valid
    for i in range(coalesce_mod._MAX_STAGING + 4):
        c._tick += 1
        c._staging_slot(("skey", i), 2, 8, np.int32)
    assert len(c._staging) <= coalesce_mod._MAX_STAGING + 1


def test_dead_submitter_rows_dropped_before_grouping(coal):
    rng = np.random.default_rng(62)
    G, P = 3, 512
    inline, co = _engines(G), _engines(G)
    c = coal(window_s=5.0, max_batch=8, pipeline=False)
    dead = metrics.REGISTRY.counter("klba_coalesce_dead_rows_total")
    _seed_pair(rng, inline, co, P)
    arrs = [_lags(rng, P) for _ in range(G)]
    want = [inline[g].rebalance(arrs[g]) for g in (0, 1)]
    subs = [_sub_for(co[0], arrs[0], co[0]._resident),
            _sub_for(co[2], arrs[2], co[2]._resident, abandoned=lambda: True),
            _sub_for(co[1], arrs[1], co[1]._resident)]
    before = dead.value
    c._flush(subs)
    with pytest.raises(SubmitterGone):
        subs[1].future.result(timeout=10.0)
    for sub, expect in zip((subs[0], subs[2]), want):
        np.testing.assert_array_equal(expect, sub.future.result(timeout=180.0).narrow[:P])
    assert dead.value == before + 1


def test_gather_fault_isolates_rows_on_churn_wave(coal):
    rng = np.random.default_rng(63)
    G, P = 3, 512
    inline, co = _engines(G), _engines(G)
    c = coal(window_s=5.0, max_batch=G, lock_waves=1, pipeline=False)
    fallback = metrics.REGISTRY.counter("klba_coalesce_flushes_total", {"path": "fallback"})
    state = {}
    for g in range(G):
        lg = _lags(rng, P)
        np.testing.assert_array_equal(inline[g].rebalance(lg), co[g].rebalance(lg))
        state[g] = co[g]._resident
    arrs = {g: _lags(rng, P) for g in (0, 1)}
    want = {g: inline[g].rebalance(arrs[g]) for g in (0, 1)}
    subs = {g: _sub_for(co[g], arrs[g], state[g]) for g in (0, 1)}
    c._flush(list(subs.values()))
    for g in (0, 1):
        r = subs[g].future.result(timeout=180.0)
        np.testing.assert_array_equal(want[g], r.narrow[:P])
        state[g] = r.resident
    arrs = {g: _lags(rng, P) for g in range(G)}
    want = {g: inline[g].rebalance(arrs[g]) for g in range(G)}
    subs = {g: _sub_for(co[g], arrs[g], state[g]) for g in range(G)}
    before = fallback.value
    with faults.injected(faults.FaultInjector().plan("coalesce.gather", times=1)) as inj:
        c._flush(list(subs.values()))
        for g in range(G):
            np.testing.assert_array_equal(
                want[g], subs[g].future.result(timeout=180.0).narrow[:P])
    assert inj.fired("coalesce.gather") == 1
    assert fallback.value == before + 1


def test_locked_row_corruption_quarantines_row_evicts_roster_once(coal):
    """A bit flipped in one locked row is caught by the next wave's per-row
    digest: that submitter alone fails (CorruptStateDetected, its engine
    quarantined), the batchmates are served, the roster is evicted once,
    the stream heals inline to a seeded twin's bits, and the roster
    re-locks."""
    from kafka_lag_based_assignor_tpu_torch.utils.scrub import CorruptStateDetected

    P, N = 384, 3
    engines = _engines(N, C=4)
    seqs = [iter([_lags(np.random.default_rng(900 + i), P) for _ in range(7)])
            for i in range(N)]
    c = coal(window_s=5.0, max_batch=N, lock_waves=1, pipeline=False)
    inv = metrics.REGISTRY.counter("klba_coalesce_roster_invalidations_total")
    for e in engines:
        e.rebalance(_lags(np.random.default_rng(5), P))

    def wave():
        out, errs = [None] * N, [None] * N
        lags_list = [next(it) for it in seqs]

        def run(i):
            try:
                out[i] = engines[i].submit_epoch(lags_list[i], c)
            except Exception as exc:  # noqa: BLE001 — asserted below
                errs[i] = exc

        threads = [threading.Thread(target=run, args=(i,)) for i in range(N)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180.0)
            assert not t.is_alive()
        return out, errs

    wave()
    _, errs = wave()
    assert all(e is None for e in errs)
    assert all(isinstance(e._resident, ResidentRow) for e in engines)
    inv0 = inv.value
    inj = faults.FaultInjector(seed=13).plan("device.corrupt.choice", mode="raise", times=1)
    with faults.injected(inj):
        _, errs = wave()
    assert all(e is None for e in errs)
    assert inj.fired("device.corrupt.choice") == 1
    out, errs = wave()
    failed = [i for i, e in enumerate(errs) if e is not None]
    assert len(failed) == 1
    bad = failed[0]
    assert isinstance(errs[bad], CorruptStateDetected) and engines[bad].quarantined
    assert inv.value - inv0 == 1
    assert all(out[i] is not None for i in range(N) if i != bad)
    prev = np.array(engines[bad]._prev_choice, copy=True)
    heal_lags = _lags(np.random.default_rng(0xBEEF), P)
    healed = engines[bad].rebalance(heal_lags)
    assert not engines[bad].quarantined
    (twin,) = _engines(1, C=4)
    twin.seed_choice(prev)
    np.testing.assert_array_equal(healed, twin.rebalance(heal_lags))
    for _ in range(2):
        _, errs = wave()
        assert all(e is None for e in errs)
    assert all(isinstance(e._resident, ResidentRow) for e in engines)
    assert inv.value - inv0 == 1


def test_cpu_coalescer_never_counts_a_launch(coal):
    """On the CPU the wave's digest is the plain version: no K6 launch is
    counted, batched or single."""
    from kafka_lag_based_assignor_tpu_torch.ops import refine

    rng = np.random.default_rng(64)
    co = _engines(2)
    c = coal(window_s=5.0, max_batch=2)
    for e in co:
        e.rebalance(_lags(rng, 256))
    before = (refine.state_digest.launches, refine.state_digest_rows.launches)
    for _ in range(2):
        _submit_all(co, [_lags(rng, 256) for _ in range(2)], c)
    assert (refine.state_digest.launches, refine.state_digest_rows.launches) == before


# -- the twin: the JAX coalescer and the port's on the same waves ----------


def _stats_delta(before, after):
    return {k: after[k] - before[k] for k in after if k != "locked_rosters"}


def test_twin_coalescers_agree_with_jax(coal):
    """8 streams, P 512, C 8, refine_iters 32: the same seeded waves (a
    re-stack wave that locks, locked dense waves, a locked delta wave and a
    flush fault) through the JAX package's coalescer and the port's.  Every
    row equals the JAX row bit for bit (choice, rounds, exchanges), and
    ``stats()`` agrees: the locked rosters and every counter's delta."""
    G, P, C, iters = 8, 512, 8, 32
    rng = np.random.default_rng(2024)
    jax_eng = [jax_streaming.StreamingAssignor(num_consumers=C, refine_iters=iters,
                                               refine_threshold=None) for _ in range(G)]
    port_eng = _engines(G, C=C, refine_iters=iters)
    jc = jax_coalesce.MegabatchCoalescer(window_s=60.0, max_batch=G)
    pc = coal(window_s=60.0, max_batch=G)
    try:
        lags = [_lags(rng, P) for _ in range(G)]
        for a, b, lg in zip(jax_eng, port_eng, lags):
            np.testing.assert_array_equal(np.asarray(a.rebalance(lg)), b.rebalance(lg))
        j0, p0 = jc.stats(), pc.stats()
        for wave in range(5):
            if wave == 3:  # every row a small change: a locked delta wave
                lags = [lg.copy() for lg in lags]
                for lg in lags:
                    lg[:6] += 1000
            else:
                lags = [_lags(rng, P) for _ in range(G)]
            if wave == 4:
                with faults.injected(faults.FaultInjector().plan("coalesce.flush", times=1)), \
                        jax_faults.injected(
                            jax_faults.FaultInjector().plan("coalesce.flush", times=1)):
                    want = _submit_all(jax_eng, lags, jc)
                    got = _submit_all(port_eng, lags, pc)
            else:
                want = _submit_all(jax_eng, lags, jc)
                got = _submit_all(port_eng, lags, pc)
            for g in range(G):
                np.testing.assert_array_equal(got[g], np.asarray(want[g]))
                sa, sb = jax_eng[g].last_stats, port_eng[g].last_stats
                assert (sb.refine_rounds, sb.refine_exchanges) == (
                    sa.refine_rounds, sa.refine_exchanges)
                assert sb.max_mean_imbalance == sa.max_mean_imbalance
        j1, p1 = jc.stats(), pc.stats()
        assert p1["locked_rosters"] == j1["locked_rosters"]
        assert _stats_delta(p0, p1) == _stats_delta(j0, j1)
        assert _stats_delta(p0, p1)["roster_hits"] >= 2
    finally:
        jc.close()
