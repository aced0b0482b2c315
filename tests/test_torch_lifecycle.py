"""The port sidecar's boot and restart against the JAX sidecar's, on the CPU.

Twin sidecars, the JAX ``AssignorService(coalesce_max_batch=1)`` and the
port's on ``device="cpu"``, each with a snapshot file, behind one stepped
clock and one pinned wall clock:

* they serve the same epochs of two streams (one with a dense pid set, one
  sparse), then ``drain`` over the wire: the same answer, a request during
  the drain rejected with the same ``DrainReject`` payload, the same counter
  series moved, and final snapshots whose sections are equal (the overload
  section's latency-derived pressure aside);
* restarts JAX -> JAX (the reference), JAX -> port, port -> JAX and
  port -> port, each on a copy of the drained file, with the pre-stack on:
  ``stats.lifecycle`` equal minus times and paths, and each stream's first
  epoch after the restart equal to the JAX restart's, reported as a warm
  restart;
* a recovered stream whose roster drifted is discarded alone, as in JAX;
* the resync pacer and ``DrainReject`` behave as the JAX ones;
* the kernel wrappers' launch counters count every launch of N threads x M
  increments;
* BASELINE config 5's drift through both engines at the card's bucket:
  the same choices and refine rounds epoch by epoch, and a restart (seed,
  pre-stack) before the last epoch gives the uninterrupted epoch's bits.
"""

import json
import os
import shutil
import socket
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kafka_lag_based_assignor_tpu import service as jax_service  # noqa: E402
from kafka_lag_based_assignor_tpu.ops import streaming as jax_streaming  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import metrics as jax_metrics  # noqa: E402
from kafka_lag_based_assignor_tpu_torch import service  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops import _build, streaming  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops.packing import pad_bucket  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.testing import (  # noqa: E402
    assert_valid_assignment,
    choice_from_assignments,
    stream_drift,
    stream_lags0,
)
from kafka_lag_based_assignor_tpu_torch.utils import metrics  # noqa: E402
from test_torch_service import Clock, counters, moved, normalized, rows  # noqa: E402

MEMBERS = ["m0", "m1", "m2", "m3"]
P_DENSE, P_SPARSE = 300, 120
SPARSE_PIDS = list(range(5, 5 + 3 * P_SPARSE, 3))
OPTS = {"refine_threshold": None}


class Wall:
    def __init__(self):
        self.now = 1_700_000_000.0

    def __call__(self):
        return self.now


def boot(pkg, path, clock, wall, **kw):
    """A started sidecar of ``pkg`` on the snapshot ``path`` whose store
    stamps with ``wall``."""
    knobs = dict(port=0, snapshot_path=str(path), snapshot_interval_s=3600.0,
                 scrub_interval_ms=0, clock=clock, **kw)
    if pkg == "jax":
        svc = jax_service.AssignorService(coalesce_max_batch=1, **knobs)
    else:
        svc = service.AssignorService(device="cpu", coalesce_max_batch=1, **knobs)
    svc._snapshot_store._wall = wall
    return svc.start()


class Wire:
    """One connection to each sidecar of a pair; each line goes to both."""

    def __init__(self, svcs, clock):
        self.clock = clock
        self.socks = [socket.create_connection(s.address) for s in svcs]
        self.files = [s.makefile("rwb") for s in self.socks]

    def send(self, method, params=None, step=True):
        """Each sidecar's reply to one line; ``step`` advances the shared
        clock first (not while a drain's final snapshot may be reading
        it on either side)."""
        if step:
            self.clock.now += 5.0
        line = json.dumps({"id": 1, "method": method, "params": params or {}})
        out = []
        for f in self.files:
            f.write(line.encode() + b"\n")
            f.flush()
            out.append(json.loads(f.readline()))
        return out

    def close(self):
        for f, s in zip(self.files, self.socks):
            f.close()
            s.close()


def epoch_params(sid, lags):
    pids = range(P_DENSE) if sid == "dense" else SPARSE_PIDS
    return {"stream_id": sid, "topic": "t0", "members": MEMBERS,
            "lags": rows(lags, pids), "options": OPTS}


def lags_for(sid, epoch):
    n = P_DENSE if sid == "dense" else P_SPARSE
    return np.random.default_rng(100 * epoch + len(sid)).integers(0, 10**6, n)


def series_moved(before, after):
    """The counters that moved, but the snapshot writes: a churn write
    (a stream created or discarded) runs on the snapshot writer's thread
    after its debounce, on its own time."""
    return {k: v for k, v in moved(before, after).items()
            if k[0] != "klba_snapshot_writes_total"}


def lifecycle_view(stats):
    """``stats.lifecycle`` without times, paths, the process-wide write
    counters and the file's size (its overload section holds the latency
    each process measured)."""
    out = json.loads(json.dumps(stats["lifecycle"]))
    for key in ("age_s", "duration_ms"):
        (out["recovery"] or {}).pop(key, None)
    snap = out["snapshot"]
    for key in list(snap):
        if key in ("path", "age_s", "last_written_at", "bytes") or key.startswith("write"):
            snap.pop(key)
    return out


@pytest.fixture(scope="module")
def drained(tmp_path_factory):
    """Phase A: both sidecars serve 3 epochs of two streams and drain.
    Returns the two final snapshot paths and what the drain answered."""
    root = tmp_path_factory.mktemp("lifecycle")
    clock, wall = Clock(), Wall()
    paths = {pkg: root / f"{pkg}.json" for pkg in ("jax", "port")}
    svcs = [boot(pkg, paths[pkg], clock, wall) for pkg in ("jax", "port")]
    wire = Wire(svcs, clock)
    before = (counters(jax_metrics), counters(metrics))
    try:
        for epoch in range(3):
            for sid in ("dense", "sparse"):
                got_jax, got_port = wire.send("stream_assign",
                                              epoch_params(sid, lags_for(sid, epoch)))
                assert normalized(got_port) == normalized(got_jax)
                assert_valid_assignment(got_port["result"]["assignments"],
                                        P_DENSE if sid == "dense" else P_SPARSE)
        answers = {"drain": wire.send("drain"),
                   "during": wire.send("stream_assign", epoch_params("dense", lags_for(
                       "dense", 3)), step=False)}
        for svc in svcs:
            assert svc.wait_stopped(30)
        answers["moved"] = (series_moved(before[0], counters(jax_metrics)),
                            series_moved(before[1], counters(metrics)))
    finally:
        wire.close()
        for svc in svcs:
            svc.stop()
    return paths, answers


def test_drain_answers_and_final_snapshot_match_jax(drained):
    paths, answers = drained
    got_jax, got_port = answers["drain"]
    assert got_port["result"] == got_jax["result"] == {"state": "draining",
                                                        "initiated": True}
    got_jax, got_port = answers["during"]
    assert normalized(got_port) == normalized(got_jax)
    assert got_port["error"]["shed"] == {"class": "standard", "rung": "draining",
                                         "retry_after_ms": 10000}
    assert answers["moved"][1] == answers["moved"][0]
    shed = ("klba_shed_total", (("class", "standard"), ("rung", "draining")))
    assert answers["moved"][1][shed] == 1
    docs = {pkg: json.loads(path.read_bytes()) for pkg, path in paths.items()}
    assert docs["port"]["written_at"] == docs["jax"]["written_at"]
    for name in ("streams", "breakers"):
        assert docs["port"]["sections"][name] == docs["jax"]["sections"][name]
    for key in ("rung", "ewma_depth"):
        assert (docs["port"]["sections"]["overload"]["body"][key]
                == docs["jax"]["sections"]["overload"]["body"][key])
    streams = docs["port"]["sections"]["streams"]["body"]
    assert streams["dense"]["pids"] == P_DENSE
    assert streams["sparse"]["pids"] == SPARSE_PIDS


@pytest.fixture(scope="module")
def restarts(drained, tmp_path_factory):
    """Each (writer, reader) restart on a copy of the writer's drained
    file: the reader's stats and each stream's first epoch after it."""
    paths, _ = drained
    root = tmp_path_factory.mktemp("restarts")
    out = {}
    for writer in ("jax", "port"):
        for reader in ("jax", "port"):
            path = root / f"{writer}-{reader}.json"
            shutil.copy(paths[writer], path)
            clock, wall = Clock(), Wall()
            wall.now += 30.0
            svc = boot(reader, path, clock, wall, recovery_prestack=True,
                       recovery_warmup=reader == "port")
            try:
                with service.AssignorServiceClient(*svc.address) as c:
                    stats = c.request("stats")
                    first = {sid: c.request("stream_assign",
                                            epoch_params(sid, lags_for(sid, 3)))
                             for sid in ("dense", "sparse")}
                out[writer, reader] = (stats, first, list(svc._recovery_shapes))
            finally:
                svc.stop()
    return out


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"),
                                           ("port", "port")])
def test_restart_matches_the_jax_restart(restarts, writer, reader):
    ref_stats, ref_first, ref_shapes = restarts["jax", "jax"]
    stats, first, shapes = restarts[writer, reader]
    assert lifecycle_view(stats) == lifecycle_view(ref_stats)
    recovery = stats["lifecycle"]["recovery"]
    assert (recovery["outcome"], recovery["streams_recovered"],
            recovery["streams_prestacked"]) == ("ok", 2, 2)
    assert sorted(shapes) == sorted(ref_shapes) == [(P_SPARSE, 4), (P_DENSE, 4)]
    for sid, got in first.items():
        assert strip_result(got) == strip_result(ref_first[sid])
        assert got["stream"]["warm_restart"] and not got["stream"]["cold_start"]
    choice = choice_from_assignments(first["dense"]["assignments"], MEMBERS, P_DENSE)
    assert (choice >= 0).all()


def strip_result(result):
    return normalized({"result": result})["result"]


def test_drifted_roster_discards_that_stream_only(drained, tmp_path):
    """As in JAX: a recovered stream whose members changed starts cold, the
    other stream keeps its warm restart; the discard is counted alike."""
    paths, _ = drained
    got = {}
    for pkg, mets in (("jax", jax_metrics), ("port", metrics)):
        path = tmp_path / f"{pkg}.json"
        shutil.copy(paths[pkg], path)
        before = counters(mets)
        svc = boot(pkg, path, Clock(), Wall(), recovery_warmup=False)
        try:
            with service.AssignorServiceClient(*svc.address) as c:
                drift = dict(epoch_params("dense", lags_for("dense", 3)),
                             members=MEMBERS[:3])
                replies = [c.request("stream_assign", drift),
                           c.request("stream_assign",
                                     epoch_params("sparse", lags_for("sparse", 3)))]
        finally:
            svc.stop()
        got[pkg] = ([strip_result(r) for r in replies],
                    series_moved(before, counters(mets)))
    assert got["port"] == got["jax"]
    (dense, sparse), series = got["port"]
    assert dense["stream"]["cold_start"] and not dense["stream"]["warm_restart"]
    assert sparse["stream"]["warm_restart"]
    assert series[("klba_recovery_streams_total", (("outcome", "discarded_drift"),))] == 1


def test_resync_pacer_and_drain_reject_match_jax():
    outcomes = {}
    for name, mod, mets in (("jax", jax_service, jax_metrics),
                            ("port", service, metrics)):
        before = counters(mets)
        clock = Clock()
        pacer = mod._ResyncPacer(2, clock=clock)
        steps = [pacer.acquire(1.0), pacer.acquire(None), pacer.acquire(0.0)]
        pacer.release()
        steps += [pacer.acquire(0.0), pacer.high_water]
        with pytest.raises(ValueError) as err:
            mod._ResyncPacer(0)
        rej = mod.DrainReject("critical", 750)
        outcomes[name] = (steps, str(err.value), str(rej), rej.klass, rej.rung,
                          rej.retry_after_ms, moved(before, counters(mets)))
    assert outcomes["port"] == outcomes["jax"]
    assert outcomes["port"][0] == [True, True, False, True, 2]


def test_launch_counters_count_every_thread():
    """N threads x M launches counted through ``count_launch`` add up
    exactly: the sidecar's handler threads and the scrubber launch at once.
    More threads than cores and a short switch interval make a lost update
    of a plain ``+=`` likely."""
    class Wrapper:
        launches = 0

    threads, per = 2 * (os.cpu_count() or 4), 5_000
    barrier = threading.Barrier(threads)

    def launch():
        barrier.wait()
        for i in range(per):
            _build.count_launch(Wrapper, 1 + i % 2)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=launch) for _ in range(threads)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in workers)
    assert Wrapper.launches == threads * per * 3 // 2


def test_config5_drift_and_restart_match_jax(monkeypatch):
    """BASELINE config 5's drift (bench.py's 10 epochs, seed 5) through the
    JAX engine and the port's, both at the card's padded bucket: the same
    choice and the same refine rounds and exchanges at every epoch.  Then a
    restart before the last epoch (a fresh engine seeded with the choice
    served before it, the resident state pre-stacked) gives the
    uninterrupted last epoch's bits in both packages."""
    for engine in (jax_streaming.StreamingAssignor, streaming.StreamingAssignor):
        monkeypatch.setattr(engine, "_bucket", lambda self, n: pad_bucket(n))
    kw = dict(num_consumers=1000, refine_iters=512, imbalance_guardrail=1.25)
    engines = (jax_streaming.StreamingAssignor(mesh_backend=None, **kw),
               streaming.StreamingAssignor(device="cpu", **kw))
    rng, lags0 = stream_lags0()
    epochs, lags, choices = [lags0], lags0.astype(np.float64), []
    for e in range(11):
        if e:
            lags = stream_drift(rng, lags, e - 1, choices[-1], 1000)
            epochs.append(lags.astype(np.int64))
        got = [np.asarray(eng.rebalance(epochs[-1])) for eng in engines]
        stats = [(s.refined, s.refine_rounds, s.refine_exchanges, s.cold_start)
                 for s in (eng.last_stats for eng in engines)]
        np.testing.assert_array_equal(got[1], got[0])
        assert stats[1] == stats[0]
        choices.append(got[1])
    for make in (lambda: jax_streaming.StreamingAssignor(mesh_backend=None, **kw),
                 lambda: streaming.StreamingAssignor(device="cpu", **kw)):
        engine = make()
        engine.seed_choice(choices[9])
        assert engine.prestack_resident()
        np.testing.assert_array_equal(np.asarray(engine.rebalance(epochs[10])),
                                      choices[10])
        assert engine.last_stats.refined and not engine.last_stats.cold_start
