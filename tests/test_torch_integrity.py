"""The port's integrity plane against the JAX package's, case by case, on the
CPU: the twins of ``tests/test_scrub.py`` that the port's tests do not
already hold, and a small ``corruption_storm`` (bench.py's config 11)
through both sidecars.

Each twin runs the JAX test's scenario once with the JAX package and once
with the port (``device="cpu"``), checks the JAX test's own assertions in
both runs and compares what the two runs observed:

* the host digest check (``digest_failures``): the slot mapping and the
  row-table fifth lane;
* the engine: a ``device.corrupt.row_tab``, ``choice`` or ``counts`` flip
  caught by the next dispatch (``CorruptStateDetected``, the engine
  quarantined, the host truth kept) and healed bit for bit against a twin
  seeded from it; a ``lags`` flip caught by the audit and by a delta
  epoch's conservation check (re-synced dense); clean epochs audit clean;
* the scrubber's interval and budget validation, its suppression at rung
  2, the standing pressure of a takeover (the window held at rung-1 scale,
  released stream by stream, expired past its TTL), the scrub knob;
* the sidecar: a corrupted stream served ``kept_previous`` then healed
  bit for bit, an idle stream's ``counts`` flip quarantined by one scrub
  pass, strikes forgiven after a clean run;
* the storm: bench.py's flips (``choice``, ``counts``, ``lags``) into an
  inline stream and into a locked row of a 4-row coalescing sidecar at 256
  partitions x 8 members, the same injector seeds in both packages: every
  epoch's ``degraded_rung`` and choice equal across the packages, 6
  injected and 6 detected within one epoch or one scrub pass, each heal
  equal to a twin seeded from the host truth, no invalid answer, and each
  locked-row event evicting the roster exactly once.

Torch runs on one intra-op thread.
"""

import concurrent.futures as cf
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_overload_slo import PKGS, rows, sidecar, twin  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import config as jax_config  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import scrub as jax_scrub  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.utils import config  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.utils import scrub  # noqa: E402

for _pkg, _scrub, _config in zip(PKGS, (jax_scrub, scrub), (jax_config, config)):
    _pkg.scrub, _pkg.config = _scrub, _config
OPTS = {"guardrail": None, "refine_threshold": None}


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    for pkg in PKGS:
        pkg.faults.deactivate()


def q_total(pkg, outcome):
    return sum(c.value for c in pkg.metrics.REGISTRY.series("klba_quarantine_total")
               if c.labels.get("outcome") == outcome)


def engine(pkg, C=8, **kw):
    kw.setdefault("refine_threshold", None)
    return pkg.streaming.StreamingAssignor(num_consumers=C, **kw, **pkg.on)


def lags_of(rng, P=512):
    return rng.integers(0, 10**6, P).astype(np.int64)


def corrupt(pkg, eng, buffer, seed=7):
    """One epoch with ``device.corrupt.<buffer>`` armed: the flip lands in the
    freshly adopted resident state."""
    inj = pkg.faults.FaultInjector(seed=seed).plan(f"device.corrupt.{buffer}",
                                                   mode="raise", times=1)
    with pkg.faults.injected(inj):
        eng.rebalance(lags_of(np.random.default_rng(seed + 1000)))
    assert inj.fired(f"device.corrupt.{buffer}") == 1


def decode(assignments, members, P):
    idx = {m: j for j, m in enumerate(members)}
    got = np.full(P, -1, np.int32)
    for m, tps in assignments.items():
        for _t, p in tps:
            got[p] = idx[m]
    return got


# -- the host digest check --------------------------------------------------


def test_digest_failures_slot_mapping_and_fifth_lane():
    def run(pkg):
        f = pkg.scrub.digest_failures
        clean, clean5 = np.array([100, 0, 555, 0]), np.array([100, 0, 555, 0, 0])
        return [f(clean, 100, 555), f(clean, 99, 555), f(np.array([100, 1, 555, 0]), 100, 555),
                f(np.array([100, 0, 555, 2]), 100, 555), f(clean, 100, 554),
                f(clean, 100, None), sorted(f(np.array([99, 1, 1, 1]), 100, 555)),
                f(clean5, 100, 555), f(np.array([100, 0, 555, 0, 3]), 100, 555),
                f(np.array([100, 1, 555, 0, 1]), 100, 555)]

    assert twin(run) == [[], ["counts"], ["choice"], ["choice"], ["lags"], [],
                         ["choice", "counts", "lags"], [], ["row_tab"], ["choice", "row_tab"]]


# -- the engine: detect, quarantine, heal -----------------------------------


@pytest.mark.parametrize("buffer,seed", [("row_tab", 11), ("choice", 3), ("counts", 3)])
def test_dispatch_detects_corruption_and_heals_bit_exact(buffer, seed):
    """The first dispatch over a corrupted buffer raises
    ``CorruptStateDetected`` (the host truth intact, the engine
    quarantined); the next epoch heals to a seeded twin's bits."""
    def run(pkg):
        rng = np.random.default_rng(seed)
        e = engine(pkg)
        e.rebalance(lags_of(rng))
        e.rebalance(lags_of(rng))
        corrupt(pkg, e, buffer)
        q0, h0 = q_total(pkg, "quarantined"), q_total(pkg, "healed")
        prev = np.array(e._prev_choice, copy=True)
        with pytest.raises(pkg.scrub.CorruptStateDetected) as exc:
            e.rebalance(lags_of(np.random.default_rng(77)))
        assert buffer in exc.value.buffers and e.quarantined
        assert q_total(pkg, "quarantined") - q0 >= 1
        np.testing.assert_array_equal(e._prev_choice, prev)
        heal = lags_of(np.random.default_rng(78))
        healed = np.asarray(e.rebalance(heal))
        assert not e.quarantined and q_total(pkg, "healed") - h0 >= 1
        seeded = engine(pkg)
        seeded.seed_choice(prev)
        np.testing.assert_array_equal(healed, seeded.rebalance(heal))
        return sorted(exc.value.buffers), prev.tolist(), healed.tolist()

    twin(run)


def test_clean_epochs_audit_clean_and_digest_passes():
    def run(pkg):
        rng = np.random.default_rng(0)
        e = engine(pkg)
        out = [np.asarray(e.rebalance(lags_of(rng))).tolist() for _ in range(4)]
        return pkg.scrub.audit_engine(e), e.quarantined, out

    assert twin(run)[:2] == ((True, []), False)


def test_lags_corruption_detected_by_audit_and_delta_conservation():
    def run(pkg):
        rng = np.random.default_rng(5)
        e = engine(pkg, delta_max_fraction=1.0)
        base = lags_of(rng)
        e.rebalance(base)
        e.rebalance(base.copy())
        corrupt(pkg, e, "lags")
        first = pkg.scrub.audit_engine(e)
        r0 = q_total(pkg, "resynced")
        drift = np.array(e._lag_mirror, copy=True)
        drift[:8] += 17
        out = np.asarray(e.rebalance(drift))
        return first, q_total(pkg, "resynced") - r0, pkg.scrub.audit_engine(e), out.tolist()

    first, resynced, after, _ = twin(run)
    assert (first, resynced, after) == ((True, ["lags"]), 1, (True, []))


# -- the scrubber and the standing pressure ---------------------------------


def test_scrubber_interval_validation():
    def run(pkg):
        errors = []
        for kw in ({"interval_s": 0.0}, {"interval_s": 1.0, "budget_s": 0.0}):
            with pytest.raises(ValueError) as info:
                pkg.scrub.StateScrubber(lambda: [], **kw)
            errors.append(str(info.value))
        return errors

    twin(run)


def test_standing_pressure_holds_window_and_feeds_the_ladder():
    def run(pkg):
        clock = [0.0]

        def ctl():
            return pkg.overload.OverloadController(
                latency_budget_ms=1000.0, depth_high=8.0, clock=lambda: clock[0],
                eval_interval_s=0.0)

        c = ctl()
        seen = [c.admission("standard").window_scale]
        c.add_standing_pressure(4.0)
        d = c.admission("standard")
        seen += [d.action, d.window_scale, c.snapshot()["standing_pressure"],
                 c.snapshot()["window_scale"]]
        c.release_standing_pressure(2.0)
        seen.append(c.admission("standard").window_scale)
        c.release_standing_pressure(2.0)
        seen += [c.admission("standard").window_scale, c.snapshot()["standing_pressure"]]
        c = ctl()
        c.add_standing_pressure(16.0)
        d = c.admission("best_effort")
        c.release_standing_pressure(100.0)
        return seen + [d.rung, d.action, c.standing_pressure()]

    assert twin(run) == [1.0, "admit", 0.5, 4.0, 0.5, 0.5, 1.0, 0.0, 2, "degrade", 0.0]


def test_scrub_suppressed_under_overload_rung2():
    def run(pkg):
        with sidecar(pkg, scrub_interval_ms=3600_000.0) as svc:
            svc._overload.restore_state({"rung": 2, "pressure": 3.0, "ewma_depth": 0.0})
            return svc._scrubber.scrub_once()

    assert twin(run)["suppressed"] == 1


def test_scrub_interval_config_knob():
    def run(pkg):
        parse = pkg.config.parse_config
        out = [parse({"group.id": "g", "tpu.assignor.scrub.interval.ms": "5000"}).scrub_interval_s,
               parse({"group.id": "g"}).scrub_interval_s,
               parse({"group.id": "g", "tpu.assignor.scrub.interval.ms": 0}).scrub_interval_s]
        svc = pkg.service.AssignorService.from_config(
            {"group.id": "g", "tpu.assignor.scrub.interval.ms": 0}, **pkg.on)
        out.append(svc._scrubber is None)
        svc.stop()
        svc = pkg.service.AssignorService.from_config({"group.id": "g"}, **pkg.on)
        out.append(svc._scrubber.interval_s)
        svc.stop()
        return out

    assert twin(run) == [5.0, 30.0, 0.0, True, 30.0]


def snapshot_pair(pkg, path, sids, rng):
    """Serve ``sids`` on a sidecar with a snapshot file, snapshot, stop;
    returns each stream's lags."""
    vecs = {}
    with sidecar(pkg, snapshot_path=path, snapshot_interval_s=3600.0,
                 scrub_interval_ms=0.0) as svc:
        c = pkg.service.AssignorServiceClient(*svc.address, timeout_s=120.0)
        for sid in sids:
            vecs[sid] = lags_of(rng, 128)
            c.stream_assign(sid, "t0", rows(vecs[sid]), ["A", "B"])
        assert svc.snapshot_now()["ok"]
        c.close()
    return vecs


def test_takeover_under_load_sheds_until_warmup_drains(tmp_path):
    """A replacement adopting streams parks their class weight as standing
    pressure (the window held at rung-1 scale) and releases it stream by
    stream as each serves, a reset releasing one that never served."""
    def run(pkg):
        path = str(tmp_path / f"snap-{pkg.name}.json")
        vecs = snapshot_pair(pkg, path, ("s0", "s1"), np.random.default_rng(21))
        seen = []
        with sidecar(pkg, snapshot_path=path, snapshot_interval_s=3600.0,
                     recovery_warmup=False, scrub_interval_ms=0.0) as svc:
            snap = svc._overload.snapshot()
            seen += [snap["standing_pressure"], snap["window_scale"]]
            c = pkg.service.AssignorServiceClient(*svc.address, timeout_s=120.0)
            r = c.stream_assign("s0", "t0", rows(vecs["s0"]), ["A", "B"])
            seen += [r["stream"]["warm_restart"], svc._overload.standing_pressure()]
            c.stream_reset("s1")
            seen += [svc._overload.standing_pressure(),
                     svc._overload.snapshot()["window_scale"]]
            c.close()
        return seen

    assert twin(run) == [pytest.approx(4.0), 0.5, True, pytest.approx(2.0), 0.0, 1.0]


def test_takeover_warming_ttl_expires_unseen_streams(tmp_path):
    def run(pkg):
        path = str(tmp_path / f"snap-{pkg.name}.json")
        vecs = snapshot_pair(pkg, path, ("s0", "dead"), np.random.default_rng(33))
        now = [10_000.0]
        seen = []
        with sidecar(pkg, snapshot_path=path, snapshot_interval_s=3600.0,
                     recovery_warmup=False, scrub_interval_ms=0.0,
                     clock=lambda: now[0]) as svc:
            seen.append(svc._overload.standing_pressure())
            c = pkg.service.AssignorServiceClient(*svc.address, timeout_s=120.0)
            for step in (0.0, 0.0, pkg.service.TAKEOVER_WARMING_TTL_S + 1.0):
                now[0] += step
                c.stream_assign("s0", "t0", rows(vecs["s0"]), ["A", "B"])
                seen.append(svc._overload.standing_pressure())
            seen.append(svc._overload.snapshot()["window_scale"])
            c.close()
        return seen

    assert twin(run) == [pytest.approx(4.0), pytest.approx(2.0), pytest.approx(2.0), 0.0, 1.0]


# -- the sidecar ------------------------------------------------------------


def test_service_detects_serves_degraded_and_heals():
    """Corrupt -> the next epoch is served ``kept_previous`` (one strike) ->
    the epoch after heals warm, bit for bit against a seeded twin."""
    def run(pkg):
        rng = np.random.default_rng(0)
        P, members = 256, ["A", "B", "C", "D"]
        with sidecar(pkg, scrub_interval_ms=3600_000.0) as svc:
            c = pkg.service.AssignorServiceClient(*svc.address, timeout_s=120.0)
            for _ in range(2):
                c.stream_assign("s0", "t0", rows(lags_of(rng, P)), members, options=OPTS)
            inj = pkg.faults.FaultInjector(seed=4).plan("device.corrupt.choice",
                                                        mode="raise", times=1)
            with pkg.faults.injected(inj):
                c.stream_assign("s0", "t0", rows(lags_of(rng, P)), members, options=OPTS)
            served_prev = np.array(svc._streams["s0"].engine._prev_choice, copy=True)
            r = c.stream_assign("s0", "t0", rows(lags_of(rng, P)), members, options=OPTS)
            pkg.testing.assert_valid_assignment(r["assignments"], P)
            strikes = svc._streams["s0"].scrub_strikes
            heal = lags_of(rng, P)
            r2 = c.stream_assign("s0", "t0", rows(heal), members, options=OPTS)
            c.close()
        seeded = engine(pkg, C=4)
        seeded.seed_choice(served_prev)
        got = decode(r2["assignments"], members, P)
        np.testing.assert_array_equal(got, seeded.rebalance(heal))
        s, s2 = r["stream"], r2["stream"]
        return (inj.fired("device.corrupt.choice"), s["degraded_rung"], s["fallback_used"],
                strikes, s2["degraded_rung"], s2["cold_start"], got.tolist())

    assert twin(run)[:6] == (1, "kept_previous", True, 1, "none", False)


def test_service_scrubber_audits_idle_stream_and_quarantines():
    def run(pkg):
        rng = np.random.default_rng(2)
        with sidecar(pkg, scrub_interval_ms=3600_000.0) as svc:
            c = pkg.service.AssignorServiceClient(*svc.address, timeout_s=120.0)
            for _ in range(2):
                c.stream_assign("s0", "t0", rows(lags_of(rng, 256)), ["A", "B"], options=OPTS)
            inj = pkg.faults.FaultInjector(seed=6).plan("device.corrupt.counts",
                                                        mode="raise", times=1)
            with pkg.faults.injected(inj):
                c.stream_assign("s0", "t0", rows(lags_of(rng, 256)), ["A", "B"], options=OPTS)
            q0 = q_total(pkg, "quarantined")
            out = svc._scrubber.scrub_once()
            st = svc._streams["s0"]
            seen = [out["audited"], q_total(pkg, "quarantined") - q0 >= 1,
                    st.engine.quarantined, svc.scrub_stats()["quarantined_streams"]]
            r = c.stream_assign("s0", "t0", rows(lags_of(rng, 256)), ["A", "B"], options=OPTS)
            seen += [r["stream"]["degraded_rung"], st.engine.quarantined, r["assignments"]]
            c.close()
        return seen

    assert twin(run)[:6] == [1, True, True, 1, "none", False]


def test_strikes_forgiven_after_clean_run():
    def run(pkg):
        rng = np.random.default_rng(12)
        with sidecar(pkg, scrub_interval_ms=3600_000.0) as svc:
            c = pkg.service.AssignorServiceClient(*svc.address, timeout_s=120.0)

            def epoch():
                return c.stream_assign("s0", "t0", rows(lags_of(rng, 128)), ["A", "B"],
                                       options=OPTS)

            epoch()
            inj = pkg.faults.FaultInjector(seed=30).plan("device.corrupt.choice",
                                                         mode="raise", times=1)
            with pkg.faults.injected(inj):
                epoch()
            epoch()
            st = svc._streams["s0"]
            seen = [st.scrub_strikes]
            for _ in range(pkg.scrub.FORGIVE_AFTER):
                epoch()
            seen.append(st.scrub_strikes)
            c.close()
        return seen

    assert twin(run) == [1, 0]


# -- the storm (bench.py's corruption_storm at 256 x 8) ---------------------


STORM_P, STORM_C, STORM_N = 256, 8, 4
BUFFERS = ("choice", "counts", "lags")


def storm(pkg):
    """bench.py's config 11, one measured round, at 256 partitions: the flips
    into an inline stream (phase A) and into a locked row of a 4-row
    coalescing sidecar (phase B).  Returns the tally and every epoch's
    (stream, degraded_rung, choice)."""
    members = [f"m{j}" for j in range(STORM_C)]
    rng = np.random.default_rng(0x5C12B)
    seeds = iter(range(100, 200))
    tally = dict(injected=0, detected=0, late=0, invalid=0, heal_mismatch=0, evictions=[])
    epochs = []

    def fresh():
        return lags_of(rng, STORM_P)

    def note(sid, r):
        try:
            pkg.testing.assert_valid_assignment(r["assignments"], STORM_P)
        except AssertionError:
            tally["invalid"] += 1
        epochs.append((sid, r["stream"]["degraded_rung"],
                       decode(r["assignments"], members, STORM_P).tolist()))
        return r

    def heal_check(prev, lags, r):
        seeded = engine(pkg, C=STORM_C)
        seeded.seed_choice(prev)
        if not np.array_equal(decode(r["assignments"], members, STORM_P),
                              seeded.rebalance(lags)):
            tally["heal_mismatch"] += 1

    def injector(buffer):
        return pkg.faults.FaultInjector(seed=next(seeds)).plan(
            f"device.corrupt.{buffer}", mode="raise", times=1)

    def scored(hit):
        tally["detected" if hit else "late"] += 1

    with sidecar(pkg, coalesce_max_batch=1, scrub_interval_ms=3600_000.0,
                 breaker_cooldown_s=0.5) as svc:
        ca = pkg.service.AssignorServiceClient(*svc.address, timeout_s=300.0)

        def epoch_a(lags=None):
            lags = fresh() if lags is None else lags
            return note("a0", ca.stream_assign("a0", "t0", rows(lags), members, options=OPTS))

        epoch_a()
        epoch_a()
        for buffer in BUFFERS:
            inj = injector(buffer)
            with pkg.faults.injected(inj):
                epoch_a()
            tally["injected"] += inj.fired(f"device.corrupt.{buffer}")
            if buffer == "lags":
                q0 = q_total(pkg, "quarantined")
                svc._scrubber.scrub_once()
                scored(q_total(pkg, "quarantined") - q0 >= 1)
            else:
                scored(epoch_a()["stream"]["degraded_rung"] == "kept_previous")
            prev = np.array(svc._streams["a0"].engine._prev_choice, copy=True)
            heal = fresh()
            heal_check(prev, heal, epoch_a(heal))
            epoch_a()
            epoch_a()
        ca.close()

    # A 2 s window (bench.py's is 0.5 s): on a loaded host a wave's fourth
    # request can land past 0.5 s, and a wave that flushes short breaks the
    # locked roster the flips are planted in.
    with sidecar(pkg, coalesce_max_batch=STORM_N, coalesce_window_ms=2000.0,
                 scrub_interval_ms=3600_000.0, breaker_cooldown_s=0.5) as svc:
        streams = [f"b{i}" for i in range(STORM_N)]
        clients = {sid: pkg.service.AssignorServiceClient(*svc.address, timeout_s=300.0)
                   for sid in streams}
        last = {sid: fresh() for sid in streams}
        inv = pkg.metrics.REGISTRY.counter("klba_coalesce_roster_invalidations_total")
        pool = cf.ThreadPoolExecutor(max_workers=STORM_N)

        def wave(small_drift=False):
            for sid in streams:
                nxt = last[sid].copy()
                if small_drift:
                    pick = np.random.default_rng(7000 + int(sid[1:])).choice(STORM_P, 16,
                                                                           replace=False)
                    nxt[pick] += 13
                else:
                    nxt = fresh()
                last[sid] = nxt
            # The requests 50 ms apart inside the window: a wave that
            # re-stacks stacks its rows in arrival order, and a locked row's
            # flip (seeded by its row index) must hit the same stream in
            # both packages.
            futures = {}
            for sid in streams:
                futures[sid] = pool.submit(clients[sid].stream_assign, sid, "t0",
                                           rows(last[sid]), members, options=OPTS)
                time.sleep(0.05)
            return {sid: note(sid, futures[sid].result(timeout=300)) for sid in streams}

        try:
            for sid in streams:
                clients[sid].stream_assign(sid, "t0", rows(last[sid]), members, options=OPTS)
            wave()
            wave()
            wave(small_drift=True)
            for buffer in BUFFERS:
                inv0 = inv.value
                inj = injector(buffer)
                with pkg.faults.injected(inj):
                    wave()
                tally["injected"] += inj.fired(f"device.corrupt.{buffer}")
                if buffer == "lags":
                    q0 = q_total(pkg, "resynced")
                    wave(small_drift=True)
                    scored(q_total(pkg, "resynced") - q0 >= 1)
                else:
                    kept = [sid for sid, r in wave().items()
                            if r["stream"]["degraded_rung"] == "kept_previous"]
                    scored(len(kept) == 1)
                    tally["evictions"].append(int(inv.value - inv0))
                    for sid in [s for s in streams if svc._streams[s].engine.quarantined]:
                        prev = np.array(svc._streams[sid].engine._prev_choice, copy=True)
                        last[sid] = heal = fresh()
                        heal_check(prev, heal, note(sid, clients[sid].stream_assign(
                            sid, "t0", rows(heal), members, options=OPTS)))
                wave()
                wave()
        finally:
            pool.shutdown(wait=True)
            for c in clients.values():
                c.close()
    return tally, epochs


def test_corruption_storm_matches_jax():
    got = {pkg.name: storm(pkg) for pkg in PKGS}
    for name, (tally, _) in got.items():
        assert tally == dict(injected=6, detected=6, late=0, invalid=0, heal_mismatch=0,
                             evictions=[1, 1]), name
    jax_epochs, port_epochs = got["jax"][1], got["port"][1]
    assert len(port_epochs) == len(jax_epochs)
    for k, (want, have) in enumerate(zip(jax_epochs, port_epochs)):
        assert have == want, f"epoch {k}: {have[:2]} against JAX's {want[:2]}"
