"""The port's ``StreamingAssignor`` against the JAX package's, on the CPU.

Both engines take the same constructor arguments and the same epochs; on
the CPU both pad to ``pad_chunk``, so they are bit-comparable.  At every
epoch the choice vector, every field of ``last_stats`` (the float ones come
from the same integer totals, so they match exactly too) and the delta and
readback outcomes (the JAX registry counters against the port's dicts) are
equal.  The sequence: a cold start, a no-op, a concentrated-drift refine
(dense upload, O(changed) readback), two delta epochs, a guardrail trip, a
member leaving and one joining, ``seed_choice`` + ``prestack_resident``,
and ``reset``.  Then: a JAX engine's resident state carried into a port
engine; the membership repair against the JAX package's; the pinned-linear
cold solve as the warm loop's seed; and the digest-verify -> quarantine ->
heal cycle for each resident buffer.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kafka_lag_based_assignor_tpu.ops.streaming import (  # noqa: E402
    StreamingAssignor as JaxEngine,
)
from kafka_lag_based_assignor_tpu.utils import metrics  # noqa: E402
from kafka_lag_based_assignor_tpu_torch import convert  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops import refine  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops.dispatch import quality_scope  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops.packing import pad_bucket, pad_chunk  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops.streaming import (  # noqa: E402
    StreamingAssignor,
)
from kafka_lag_based_assignor_tpu_torch.testing import zipf_lags  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.utils import scrub  # noqa: E402

P, C = 3000, 24
KW = dict(num_consumers=C, refine_iters=64, imbalance_guardrail=1.25)
OUTCOMES = {
    "delta_epochs": ("klba_delta_epochs_total", ("applied", "fallback")),
    "rb_delta_epochs": ("klba_rb_delta_epochs_total",
                        ("applied", "fallback", "overflow")),
}


def jax_counts():
    return {
        key: {o: metrics.REGISTRY.counter(name, {"outcome": o}).value for o in outs}
        for key, (name, outs) in OUTCOMES.items()
    }


def port_counts(engine):
    return {key: dict(getattr(engine, key)) for key in OUTCOMES}


def diff(after, before):
    return {k: {o: after[k][o] - before[k][o] for o in after[k]} for k in after}


class Pair:
    """A JAX engine and a port engine driven through the same epochs."""

    def __init__(self, **kw):
        self.jax = JaxEngine(mesh_backend=None, **kw)
        self.port = StreamingAssignor(device="cpu", **kw)

    def epoch(self, lags):
        jb, pb = jax_counts(), port_counts(self.port)
        want = self.jax.rebalance(lags)
        got = self.port.rebalance(lags)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        assert (dataclasses.asdict(self.port.last_stats)
                == dataclasses.asdict(self.jax.last_stats))
        moved = diff(port_counts(self.port), pb)
        assert moved == diff(jax_counts(), jb)
        return got, self.port.last_stats, moved


def heaviest(choice, lags, rank=-1):
    return np.argsort(np.bincount(choice, weights=lags, minlength=C))[rank]


def test_engine_epochs_match_jax():
    rng = np.random.default_rng(1)
    lags = base = zipf_lags(rng, P)
    pair = Pair(**KW)

    c, s, _ = pair.epoch(lags)  # 1: cold start
    assert s.cold_start and pair.port._resident is not None
    c, s, moved = pair.epoch(lags)  # 2: no-op
    assert not s.refined and s.churn == 0 and moved == diff(moved, moved)

    # 3: concentrated drift on the median consumer: refines; the whole
    # vector drifted, so the upload is dense, the readback O(changed).
    lags = (lags * rng.lognormal(0, 0.05, P)).astype(np.int64)
    lags[c == heaviest(c, lags, C // 2)] *= 3
    c, s, moved = pair.epoch(lags)
    assert s.refined and s.churn > 0 and not s.guardrail_tripped
    assert moved["delta_epochs"]["fallback"] == 1
    assert moved["rb_delta_epochs"]["applied"] == 1

    # 4, 5: at most 16 changed lags, on the heaviest consumers: the delta
    # upload applies and the readback is O(changed) with nonzero churn.
    for rank, n in ((-1, 10), (-2, 16)):
        lags = lags.copy()
        lags[np.flatnonzero(c == heaviest(c, lags, rank))[:n]] *= 4
        c, s, moved = pair.epoch(lags)
        assert s.refined and s.churn > 0
        assert moved["delta_epochs"]["applied"] == 1
        assert moved["rb_delta_epochs"]["applied"] == 1

    # 6: one consumer's partitions 40x hotter: the bounded refine cannot
    # rescue it and the guardrail re-solves cold.
    lags = lags.copy()
    lags[c == 3] *= 40
    c, s, _ = pair.epoch(lags)
    assert s.guardrail_tripped and s.cold_start and s.refined

    # 7: a member leaves, then one joins; the repair re-seats the rows.
    leave = np.arange(C, dtype=np.int32) - (np.arange(C) > 5)
    leave[5] = -1
    for mapping, n in ((leave, C - 1), (np.arange(C - 1, dtype=np.int32), C)):
        pair.jax.remap_members(mapping, n)
        pair.port.remap_members(mapping, n)
        lags = (lags * rng.lognormal(0, 0.02, P)).astype(np.int64)
        c, s, _ = pair.epoch(lags)
        assert s.repaired_rows > 0 and s.count_spread <= 1

    # 8: seed_choice, then prestack_resident, then a warm epoch on it.
    for e in (pair.jax, pair.port):
        e.seed_choice(c)
        assert e.needs_dense_resync
        assert e.prestack_resident()
        assert not e.needs_dense_resync
    lags = base.copy()
    lags[c == heaviest(c, lags, C // 2)] *= 3
    c, s, _ = pair.epoch(lags)
    assert s.refined

    # 9: reset: the next epoch is cold again.
    pair.jax.reset()
    pair.port.reset()
    _, s, _ = pair.epoch(lags)
    assert s.cold_start and not s.guardrail_tripped
    assert pair.port.h2d_bytes["delta"] > 0 and pair.port.d2h_bytes["delta"] > 0


def test_engine_epochs_match_jax_at_the_card_bucket(monkeypatch):
    """The card pads the resident state to ``pad_bucket(P)``, the CPU to
    ``pad_chunk(P)``; at P = 9,000 they differ (16,384 against 12,288), and
    the table width and the bulk round's stripes with them.  Both engines
    pinned to the card's bucket go through the same epochs to the same
    bits: a cold start, warm refines on the same lags up to a no-op, a
    dense drift refine, two delta epochs and a guardrail trip."""
    P9 = 9000
    assert pad_bucket(P9) == 16384 and pad_chunk(P9) == 12288
    for engine in (JaxEngine, StreamingAssignor):
        monkeypatch.setattr(engine, "_bucket", lambda self, n: pad_bucket(n))
    rng = np.random.default_rng(9)
    lags = zipf_lags(rng, P9)
    pair = Pair(**KW)

    c, s, _ = pair.epoch(lags)
    assert s.cold_start and pair.port._resident[0].shape[0] == 16384
    # The same lags again: warm refines (each a delta of no lags) until the
    # quality gate holds, then a no-op.
    for _ in range(4):
        c, s, _ = pair.epoch(lags)
        if not s.refined:
            break
    assert not s.refined and s.churn == 0
    lags = (lags * rng.lognormal(0, 0.05, P9)).astype(np.int64)
    lags[c == heaviest(c, lags, C // 2)] *= 3
    c, s, moved = pair.epoch(lags)
    assert s.refined and not s.guardrail_tripped
    assert moved["delta_epochs"]["fallback"] == 1
    for rank in (-1, -2):  # 40 lags of a heavy consumer 4x: a delta epoch
        lags = lags.copy()
        lags[np.flatnonzero(c == heaviest(c, lags, rank))[:40]] *= 4
        c, s, moved = pair.epoch(lags)
        assert s.refined and s.churn > 0 and moved["delta_epochs"]["applied"] == 1
    lags = lags.copy()
    lags[c == 3] *= 40
    _, s, _ = pair.epoch(lags)
    assert s.guardrail_tripped and s.cold_start


def test_resident_state_carries_over_from_jax():
    rng = np.random.default_rng(2)
    lags = zipf_lags(rng, P)
    kw = dict(KW, refine_threshold=None)
    jax_engine = JaxEngine(mesh_backend=None, **kw)
    jax_engine.rebalance(lags)
    lags = (lags * rng.lognormal(0, 0.1, P)).astype(np.int64)
    jax_engine.rebalance(lags)  # one warm epoch: the resident is a successor
    port = StreamingAssignor(device="cpu", **kw)
    port.seed_choice(jax_engine.export_state())
    port._adopt_resident(
        convert.resident_from_numpy(*(np.asarray(b) for b in jax_engine._resident),
                                    device="cpu"),
        jax_engine._lag_mirror,
    )
    assert not port.needs_dense_resync
    lags = lags.copy()
    lags[:8] += 10**6  # a delta epoch on the carried state
    want = jax_engine.rebalance(lags)
    got = port.rebalance(lags)
    np.testing.assert_array_equal(got, want)
    assert dataclasses.asdict(port.last_stats) == dataclasses.asdict(jax_engine.last_stats)
    assert port.delta_epochs["applied"] == 1
    for g, w in zip(port._resident, jax_engine._resident):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(port._lag_mirror, jax_engine._lag_mirror)


@pytest.mark.parametrize(
    "P_,c_from,c_to,leaver",
    [(401, 4, 5, None), (600, 7, 6, 2), (600, 6, 7, None), (97, 5, 4, 0)],
)
def test_repair_after_remap_matches_jax(P_, c_from, c_to, leaver):
    rng = np.random.default_rng(P_ + c_to)
    lags = rng.integers(0, 10**6, P_).astype(np.int64)
    kw = dict(num_consumers=c_from, refine_iters=0, refine_threshold=None)
    jax_engine = JaxEngine(mesh_backend=None, **kw)
    port = StreamingAssignor(device="cpu", **kw)
    np.testing.assert_array_equal(port.rebalance(lags), jax_engine.rebalance(lags))
    if leaver is None:  # joiners extend the range
        mapping = np.arange(c_from, dtype=np.int32)
    else:
        mapping = np.arange(c_from, dtype=np.int32) - (np.arange(c_from) > leaver)
        mapping[leaver] = -1
    for e in (jax_engine, port):
        e.remap_members(mapping, c_to)
    prev = port._prev_choice
    np.testing.assert_array_equal(prev, jax_engine._prev_choice)
    got, moved = port._repair_choice(prev, lags)
    want, jmoved = jax_engine._repair_choice(jax_engine._prev_choice, lags)
    np.testing.assert_array_equal(got, want)
    assert moved == jmoved > 0
    counts = np.bincount(got, minlength=c_to)
    assert got.min() >= 0 and counts.max() - counts.min() <= 1


def test_pinned_linear_cold_solve_seeds_the_warm_loop():
    """With the quality mode pinned to "linear" the cold solve is the
    linear-OT solve: count-balanced, the resident state left stale.  The
    next refine rebuilds it from that choice exactly as the JAX engine does
    from the same seed."""
    rng = np.random.default_rng(5)
    lags = zipf_lags(rng, 1024)
    kw = dict(num_consumers=8, refine_iters=64, refine_threshold=None)
    with quality_scope("linear", tile=64):
        port = StreamingAssignor(device="cpu", **kw)
        choice = port.rebalance(lags)
    assert port.last_stats.cold_start and port.needs_dense_resync
    counts = np.bincount(choice, minlength=8)
    assert choice.min() >= 0 and counts.max() - counts.min() <= 1
    jax_engine = JaxEngine(mesh_backend=None, **kw)
    jax_engine.seed_choice(choice)
    lags = lags.copy()
    lags[:50] += 1000
    np.testing.assert_array_equal(port.rebalance(lags), jax_engine.rebalance(lags))
    assert dataclasses.asdict(port.last_stats) == dataclasses.asdict(jax_engine.last_stats)
    assert port.last_stats.refined and not port.needs_dense_resync


def flip(tensor, seed, start=0, stop=None):
    """One seeded bit flip in ``tensor[start:stop]`` (the whole tensor when
    both are left out), as a new tensor."""
    out = tensor.clone()
    part = out.reshape(-1)[start:stop]
    part.copy_(torch.from_numpy(scrub.flip_bit(part.numpy(), seed)))
    return out


def warm_engine(seed):
    """An engine past one warm epoch (a resident successor state), and the
    next epoch's lags: four of them changed, a delta epoch."""
    rng = np.random.default_rng(seed)
    lags = zipf_lags(rng, P)
    kw = dict(KW, refine_threshold=None)  # every warm epoch dispatches
    engine = StreamingAssignor(device="cpu", **kw)
    engine.rebalance(lags)
    lags = (lags * rng.lognormal(0, 0.1, P)).astype(np.int64)
    engine.rebalance(lags)
    lags = lags.copy()
    lags[:4] += 1000
    return engine, lags, kw


# A resident lag row is read only by a delta epoch, where a flip in a real
# row breaks the conservation check first (a dense resync, next test): the
# digest's lag lane is what sees a flip in the padding rows [P, B).
@pytest.mark.parametrize("buffer,slot,start,stop", [
    ("choice", 0, 0, P), ("row_tab", 1, 0, None), ("counts", 2, 0, None),
    ("lags", 3, P, None),
], ids=["choice", "row_tab", "counts", "lags"])
def test_corrupt_resident_is_quarantined_then_heals(buffer, slot, start, stop):
    engine, lags, kw = warm_engine(3)
    kept = engine.export_state()
    resident = list(engine._resident)
    resident[slot] = flip(resident[slot], 7 + slot, start, stop)
    engine._resident = tuple(resident)
    with pytest.raises(scrub.CorruptStateDetected) as err:
        engine.rebalance(lags)
    assert buffer in err.value.buffers
    assert engine.quarantined and engine.needs_dense_resync
    np.testing.assert_array_equal(engine.export_state(), kept)

    # The next epoch rebuilds the resident state from the host and heals:
    # the same choice as a fresh engine seeded with the same host vector.
    fresh = StreamingAssignor(device="cpu", **kw)
    fresh.seed_choice(kept)
    np.testing.assert_array_equal(engine.rebalance(lags), fresh.rebalance(lags))
    assert not engine.quarantined and engine._resident is not None
    choice_p, row_tab, counts, lags_p = engine._resident
    digest = refine.state_digest(lags_p, choice_p, counts, C, row_tab=row_tab)
    assert scrub.digest_failures(digest.numpy(), P, int(lags.sum())) == []
    for a, b in zip(engine._resident, fresh._resident):
        assert torch.equal(a, b)


def test_corrupt_lag_row_resyncs_dense():
    """A flipped lag of a real row: the delta epoch's conservation check
    (device totals against the host lag sum) re-syncs with a dense upload
    in the same epoch, and the answer is the healthy engine's."""
    engine, lags, kw = warm_engine(4)
    twin = StreamingAssignor(device="cpu", **kw)
    twin.seed_choice(engine.export_state())
    resident = list(engine._resident)
    resident[3] = flip(resident[3], 11, 0, P)
    engine._resident = tuple(resident)
    before = dict(engine.delta_epochs), dict(engine.rb_delta_epochs)
    got = engine.rebalance(lags)
    assert engine.delta_epochs["fallback"] == before[0]["fallback"] + 1
    assert engine.delta_epochs["applied"] == before[0]["applied"]
    assert engine.rb_delta_epochs["fallback"] == before[1]["fallback"] + 1
    assert not engine.quarantined
    np.testing.assert_array_equal(got, twin.rebalance(lags))


def test_flight_ring_and_step_trace_match_jax():
    """The engine's own flight ring gets a copy of every epoch record, as
    the JAX engine's does (the sidecar's ``stream_flight``), and
    ``step_trace`` names each epoch in a profile without changing a bit."""
    from torch.profiler import ProfilerActivity, profile

    from kafka_lag_based_assignor_tpu_torch.utils import metrics as port_metrics

    rng = np.random.default_rng(6)
    lags = zipf_lags(rng, 2000)
    rings = (metrics.FlightRecorder(capacity=8, dump_dir=""),
             port_metrics.FlightRecorder(capacity=8, dump_dir=""))
    jax_engine = JaxEngine(mesh_backend=None, flight=rings[0], **KW)
    traced = StreamingAssignor(device="cpu", flight=rings[1], step_trace=True, **KW)
    plain = StreamingAssignor(device="cpu", **KW)
    for epoch in range(3):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            got = traced.rebalance(lags)
        names = {e.key for e in prof.key_averages()}
        assert f"klba_stream_epoch:{epoch + 1}" in names
        np.testing.assert_array_equal(got, plain.rebalance(lags))
        np.testing.assert_array_equal(got, jax_engine.rebalance(lags))
        lags = (lags * rng.lognormal(0, 0.3, lags.size)).astype(np.int64)
    records = [r.snapshot() for r in rings]
    assert len(records[1]) == 3
    assert records[1] == records[0]
