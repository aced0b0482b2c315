"""The port's resident-state audit and scrubber against the JAX package's,
on the CPU.

* ``audit_engine``: after the same epochs and the same seeded
  ``device.corrupt.<buffer>`` flip, the port's engine and the JAX engine
  fail the same buffers, for each class (``choice``, ``counts``, ``lags``,
  ``row_tab``) and with no flip; a cold engine and a stale resident audit
  nothing in both;
* ``StateScrubber`` under one stepped clock: the same passes (audited,
  busy, suppressed), the same round-robin order past the budget, the same
  ``stats()``, and the same counter series moved;
* through each sidecar: the scrubber's pass over an idle stream whose
  resident choice holds a flipped bit counts
  ``klba_scrub_failures_total{buffer="choice"}`` once, quarantines the
  stream (``stats.scrub.quarantined_streams``) and the next epoch heals to
  the same bits in both, with the same series moved.
"""

import json
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kafka_lag_based_assignor_tpu import service as jax_service  # noqa: E402
from kafka_lag_based_assignor_tpu.ops import streaming as jax_streaming  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import faults as jax_faults  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import metrics as jax_metrics  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import scrub as jax_scrub  # noqa: E402
from kafka_lag_based_assignor_tpu_torch import service  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops import streaming  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.utils import faults, metrics, scrub  # noqa: E402
from test_torch_service import Clock, counters, moved, normalized, rows  # noqa: E402

P, C = 512, 8
BUFFERS = ["choice", "counts", "lags", "row_tab"]


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    yield
    faults.deactivate()
    jax_faults.deactivate()


def engines():
    kw = dict(num_consumers=C, refine_threshold=None, delta_max_fraction=1.0)
    return (("jax", jax_streaming.StreamingAssignor(mesh_backend=None, **kw),
             jax_scrub, jax_faults),
            ("port", streaming.StreamingAssignor(device="cpu", **kw), scrub, faults))


def lags(seed):
    return np.random.default_rng(seed).integers(0, 10**6, P).astype(np.int64)


@pytest.mark.parametrize("buffer", BUFFERS + [None])
def test_audit_fails_the_same_buffers_as_jax(buffer):
    """Two epochs, then one with the buffer's corruption point armed (the
    flip lands in the adopted resident state); both audits name the same
    buffers, and the audit the JAX package's own tests expect."""
    got = {}
    for name, engine, scrub_mod, flt in engines():
        engine.rebalance(lags(1))
        engine.rebalance(lags(2))
        if buffer is None:
            engine.rebalance(lags(3))
        else:
            inj = flt.FaultInjector(seed=7).plan(f"device.corrupt.{buffer}",
                                                 mode="raise", times=1)
            with flt.injected(inj):
                engine.rebalance(lags(3))
            assert inj.fired(f"device.corrupt.{buffer}") == 1
        got[name] = scrub_mod.audit_engine(engine)
    assert got["port"] == got["jax"]
    audited, fails = got["port"]
    # A flip in the row table can land in a slot past the consumer's count,
    # which the audit does not read (the next test pokes an occupied one).
    assert audited and (fails == [] if buffer in (None, "row_tab") else buffer in fails)


def test_occupied_row_tab_slot_fails_the_audit_alike():
    got = {}
    for name, engine, scrub_mod, _ in engines():
        engine.rebalance(lags(1))
        engine.rebalance(lags(2))
        choice, row_tab, counts, lags_d = engine._resident
        tab = np.asarray(row_tab).copy()
        tab[0, 0] = tab[0, 0] + 1 if tab[0, 0] + 1 < P else tab[0, 0] - 1
        if name == "jax":
            import jax.numpy as jnp

            tab = jnp.asarray(tab)
        else:
            tab = torch.from_numpy(tab)
        engine._resident = (choice, tab, counts, lags_d)
        got[name] = scrub_mod.audit_engine(engine)
    assert got["port"] == got["jax"] == (True, ["row_tab"])


def test_audit_skips_cold_and_stale_engines():
    for name, engine, scrub_mod, _ in engines():
        assert scrub_mod.audit_engine(engine) == (False, []), name
        engine.rebalance(lags(1))
        engine.rebalance(lags(2))
        assert scrub_mod.audit_engine(engine)[0], name
        engine.seed_choice(np.array(engine._prev_choice))
        assert scrub_mod.audit_engine(engine) == (False, []), name


def scrubber_run(scrub_mod, mets):
    """Passes of a scrubber over four targets (one busy, one with nothing
    to audit) under a clock that charges 0.1 s a tick against a 0.25 s
    budget, then one suppressed pass."""
    audits, tick, suppressed = [], [0.0], [False]

    def clock():
        tick[0] += 0.1
        return tick[0]

    outcome = {"a": "audited", "b": "busy", "c": "audited", "d": "skipped"}

    def targets():
        return [(n, lambda n=n: audits.append(n) or outcome[n]) for n in "abcd"]

    before = counters(mets)
    s = scrub_mod.StateScrubber(targets, interval_s=1.0, budget_s=0.25,
                                suppress=lambda: suppressed[0], clock=clock)
    passes = [s.scrub_once() for _ in range(3)]
    suppressed[0] = True
    passes.append(s.scrub_once())
    stats = s.stats()
    with pytest.raises(ValueError) as err:
        scrub_mod.StateScrubber(targets, interval_s=0.0)
    return passes, audits, stats, str(err.value), moved(before, counters(mets))


def test_scrubber_round_robin_and_suppression_match_jax():
    got = scrubber_run(scrub, metrics)
    assert got == scrubber_run(jax_scrub, jax_metrics)
    passes, audits, stats, _, series = got
    assert passes[-1] == {"audited": 0, "busy": 0, "suppressed": 1}
    assert audits[:4] == ["a", "b", "c", "d"]  # resumed past the budget cut
    assert stats["passes"] == 3
    assert series[("klba_scrub_skipped_total", (("reason", "overload"),))] == 1


def send(f, method, params):
    f.write(json.dumps({"id": 1, "method": method, "params": params}).encode() + b"\n")
    f.flush()
    return json.loads(f.readline())


def test_sidecar_scrub_quarantines_and_heals_as_jax():
    clock = Clock()
    kw = dict(port=0, scrub_interval_ms=3_600_000.0, clock=clock)
    svcs = {"jax": jax_service.AssignorService(coalesce_max_batch=1, **kw).start(),
            "port": service.AssignorService(device="cpu", coalesce_max_batch=1,
                                            **kw).start()}
    base = {"stream_id": "s0", "topic": "t0", "members": ["A", "B", "C"],
            "options": {"refine_threshold": None}}
    got = {}
    try:
        for name, svc in svcs.items():
            mets = jax_metrics if name == "jax" else metrics
            with socket.create_connection(svc.address) as sock:
                f = sock.makefile("rwb")
                for seed in (1, 2):
                    send(f, "stream_assign", {**base, "lags": rows(lags(seed))})
                before = counters(mets)
                resident = svc._streams["s0"].engine._resident
                host = np.asarray(resident[0]).copy()
                flipped = scrub.flip_bit(host, seed=5, limit=P)
                if name == "jax":
                    import jax.numpy as jnp

                    bufs = (jnp.asarray(flipped), *resident[1:])
                else:
                    bufs = (torch.from_numpy(flipped), *resident[1:])
                svc._streams["s0"].engine._resident = bufs
                scrub_pass = svc._scrubber.scrub_once()
                quarantined = svc.scrub_stats()["quarantined_streams"]
                healed = send(f, "stream_assign", {**base, "lags": rows(lags(3))})
                after = svc.scrub_stats()["quarantined_streams"]
                got[name] = (scrub_pass, quarantined, normalized(healed), after,
                             moved(before, counters(mets)))
    finally:
        for svc in svcs.values():
            svc.stop()
    assert got["port"] == got["jax"]
    scrub_pass, quarantined, healed, after, series = got["port"]
    assert scrub_pass == {"audited": 1, "busy": 0, "suppressed": 0}
    assert (quarantined, after) == (1, 0)
    assert healed["result"]["stream"]["degraded_rung"] == "none"
    assert series[("klba_scrub_failures_total", (("buffer", "choice"),))] == 1
