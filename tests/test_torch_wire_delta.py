"""The port's wire delta trackers against the JAX package's, on the CPU.

* ``LagDeltaTracker``: one sequence of lag reads and server answers (a
  confirmed base, small and large changes, a resync, a failure, a pid-set
  change, a ``delta.diff`` fault in each package's own injector) gives the
  same ``stream_assign`` params from both packages' trackers;
* ``AssignmentDeltaTracker``: the same stamps and the same dense views
  from dense and delta answers, and the same rejection of a delta on a
  base it does not hold;
* end to end: both trackers driving a stream through the twin services
  (the JAX sidecar and the port's, as in ``test_torch_service``) for a
  drifting schedule: every answer equal, the held dense view equal to a
  dense answer, and the delta-epoch and delta-answer series moved alike.

Every comparison is exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kafka_lag_based_assignor_tpu import lag as jax_lag  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import faults as jax_faults  # noqa: E402
from kafka_lag_based_assignor_tpu_torch import lag  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.testing import zipf_lags  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.utils import faults  # noqa: E402
from test_torch_service import Twin, rows  # noqa: E402


def outcome(fn):
    try:
        return fn()
    except ValueError as exc:
        return ("ValueError", str(exc))


def lag_script():
    rng = np.random.default_rng(4)
    base = zipf_lags(rng, 40)
    small = base.copy()
    small[[2, 9]] += 5
    large = base * 2
    shuffled = rows(small)[::-1]
    return [
        ("read", rows(base)), ("ok", 1),
        ("read", rows(small)), ("ok", 2),
        ("read", shuffled), ("ok", 3),
        ("read", rows(large)), ("ok", 4),
        ("read", rows(large)), ("resync", None),
        ("read", rows(small)), ("ok", 5),
        ("read", rows(base)), ("fail", None),
        ("read", rows(base)), ("ok", 6),
        ("read", rows(base[:30])), ("ok", 7),
        ("read", rows(base[:30] + 1)), ("no_stream", None),
        ("read", rows(base[:30])), ("ok", 8),
        ("fault", rows(base[:30] + 2)), ("ok", 9),
        ("read", rows(base[:30] + 2)), ("ok", 10),
    ]


def drive_lag(module, faults_module, fraction):
    tracker = module.LagDeltaTracker(max_fraction=fraction)
    out = []
    for op, arg in lag_script():
        if op == "read":
            out.append(tracker.params_for(arg))
        elif op == "fault":
            inj = faults_module.FaultInjector(seed=1).plan("delta.diff", mode="raise")
            with faults_module.injected(inj):
                out.append(tracker.params_for(arg))
        elif op == "ok":
            tracker.note_result({"stream": {"lag_epoch": arg, "resync": False}})
        elif op == "resync":
            tracker.note_result({"stream": {"lag_epoch": 9, "resync": True}})
        elif op == "no_stream":
            tracker.note_result({})
        else:
            tracker.note_failure()
    return out


@pytest.mark.parametrize("fraction", [0.125, 0.5, 1.0])
def test_lag_delta_tracker_matches_jax(fraction):
    got = drive_lag(lag, faults, fraction)
    assert got == drive_lag(jax_lag, jax_faults, fraction)
    assert any("lag_delta" in p for p in got) and any("lags" in p for p in got)


@pytest.mark.parametrize("fraction", [0.0, 1.5, -1])
def test_lag_delta_tracker_rejects_like_jax(fraction):
    assert (outcome(lambda: lag.LagDeltaTracker(fraction))
            == outcome(lambda: jax_lag.LagDeltaTracker(fraction)))


MEMBERS = ["b", "a", "c"]


def dense(owner):
    out = {m: [] for m in sorted(MEMBERS)}
    for pid in sorted(owner):
        out[owner[pid]].append(["t0", pid])
    return out


def drive_assign(module):
    owner = {p: sorted(MEMBERS)[p % 3] for p in range(12)}
    tracker = module.AssignmentDeltaTracker()
    out = [tracker.stamp({})]
    answers = [
        {"assignments": dense(owner), "stream": {"assign_epoch": 1}},
        {"assignment_delta": {"base_epoch": 1, "epoch": 2, "topic": "t0",
                              "indices": [0, 5], "owners": [2, 0]}},
        {"assignment_delta": {"base_epoch": 2, "epoch": 3, "topic": "t0",
                              "indices": [], "owners": []}},
        {"assignment_delta": {"base_epoch": 7, "epoch": 8, "topic": "t0",
                              "indices": [1], "owners": [1]}},
        {"assignments": dense(owner), "stream": {}},
        {"assignments": dense(owner), "stream": {"assign_epoch": 4}},
        {"stream": {"assign_epoch": 5}},
        {"assignments": dense(owner), "stream": {"assign_epoch": 6}},
    ]
    for answer in answers:
        out.append(outcome(lambda a=answer: tracker.note_result(a, MEMBERS)))
        out.append(tracker.stamp({"x": 1}))
    tracker.note_failure()
    out.append(tracker.stamp({}))
    return out


def test_assignment_delta_tracker_matches_jax():
    got = drive_assign(lag)
    assert got == drive_assign(jax_lag)
    assert ("ValueError" in str(got)) and {"x": 1, "assign_ack": 3} in got


def test_trackers_drive_both_services_alike():
    """A 64-partition stream through eight drifting epochs, each sent as
    the trackers build it: dense first, then lag deltas with acks, a
    membership change and a pid-set change that force dense again."""
    rng = np.random.default_rng(21)
    lags = zipf_lags(rng, 64)
    pids = np.arange(64)
    members = ["m1", "m0", "m2"]
    up, down = lag.LagDeltaTracker(), lag.AssignmentDeltaTracker()
    pair = Twin()
    try:
        kinds = []
        for epoch in range(10):
            if epoch == 6:
                members = ["m1", "m0", "m3"]
            if epoch == 8:
                pids = pids + 100
            hot = rng.choice(64, size=3, replace=False)
            lags = lags.copy()
            lags[hot] = (lags[hot] * rng.uniform(1.5, 3.0, size=3)).astype(np.int64)
            params = down.stamp(up.params_for(rows(lags, pids)))
            reply = pair.same("stream_assign", {"stream_id": "t", "topic": "t0",
                                                "members": members, **params})
            result = reply["result"]
            view = down.note_result(result, members)
            up.note_result(result)
            kinds.append(("lag_delta" in params, "assignment_delta" in result))
            if "assignments" in result:
                assert view == result["assignments"]
            assert sorted(p for tps in view.values() for _, p in tps) == sorted(
                int(p) for p in pids)
        assert (True, True) in kinds and (False, False) in kinds
        series = pair.series_moved_alike()
    finally:
        pair.close()
    assert series[("klba_assign_delta_epochs_total", (("outcome", "applied"),))] >= 3
