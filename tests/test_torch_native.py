"""The port's native solver against the JAX package's, on the CPU.

``native.assign_native`` (the C++ greedy core, built with ``g++`` into
``build/klba_torch/``) must give the JAX package's ``assign_native`` answer,
member list order included, on the README example, BASELINE configs 2 and
3 and fuzzed multi-topic groups.  Bad arguments raise; a missing compiler
or a failed build raises ``RuntimeError`` and never answers from the Python
oracle.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kafka_lag_based_assignor_tpu import native as jax_native  # noqa: E402
from kafka_lag_based_assignor_tpu.models import greedy as jax_greedy  # noqa: E402
from kafka_lag_based_assignor_tpu_torch import native  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops import _build  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.testing import (  # noqa: E402
    baseline_workload,
    lag_rows,
)


def pairs(assignment):
    return {m: [(tp.topic, tp.partition) for tp in tps] for m, tps in assignment.items()}


@pytest.mark.parametrize("config", [1, 2, 3])
def test_assign_native_matches_jax_on_baseline(config):
    lags, members = baseline_workload(config)
    rows = lag_rows(lags)
    subs = {m: sorted(lags) for m in members}
    got = pairs(native.assign_native(rows, subs))
    assert got == pairs(jax_native.assign_native(rows, subs))
    assert got == pairs(jax_greedy.assign_greedy(rows, subs))


@pytest.mark.parametrize("seed", range(6))
def test_assign_native_matches_jax_fuzzed(seed):
    """Topics with ties, zero lags and lags near 2^62, members subscribed
    to random subsets (some to nothing), partition ids out of order."""
    rng = np.random.default_rng(seed)
    lags = {}
    for t in range(int(rng.integers(1, 6))):
        P = int(rng.integers(1, 300))
        kind = rng.integers(0, 3)
        values = (rng.integers(0, 3, P) if kind == 0 else
                  rng.integers(2**62 - 2**30, 2**62, P) // 64 if kind == 1 else
                  rng.integers(0, 10**6, P))
        lags[f"t{t}"] = values.astype(np.int64)
    members = [f"m{i:02d}" for i in rng.permutation(int(rng.integers(1, 40)))]
    subs = {m: sorted(t for t in lags if rng.random() < 0.6) for m in members}
    rows = {t: rows[::-1] for t, rows in lag_rows(lags).items()}
    got = pairs(native.assign_native(rows, subs))
    assert got == pairs(jax_native.assign_native(rows, subs))


def test_assign_topic_native_matches_jax_and_rejects_bad_arguments():
    rng = np.random.default_rng(3)
    lags = rng.integers(0, 50, 500)
    pids = rng.permutation(500).astype(np.int32)
    for C in (1, 7, 600):
        np.testing.assert_array_equal(native.assign_topic_native(lags, pids, C),
                                      jax_native.assign_topic_native(lags, pids, C))
    for C in (0, -3):
        with pytest.raises(ValueError, match="code 1"):
            native.assign_topic_native(lags, pids, C)
        with pytest.raises(ValueError):
            jax_native.assign_topic_native(lags, pids, C)
    with pytest.raises(ValueError, match="one length"):
        native.assign_topic_native(lags, pids[:10], 3)
    assert native.assign_topic_native(lags[:0], pids[:0], 3).shape == (0,)


def test_library_is_built_into_the_build_dir():
    native.load()
    path = native.library_path()
    assert path.exists() and path.parent == _build.BUILD_DIR
    assert native.available()


def fresh_build(monkeypatch, tmp_path):
    """A loader with nothing loaded and nothing built."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")


def test_missing_compiler_raises(monkeypatch, tmp_path):
    fresh_build(monkeypatch, tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    rows = lag_rows(baseline_workload(1)[0])
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.assign_native(rows, {"C0": ["t0"], "C1": ["t0"]})
    assert not native.available()
    assert native._lib is None


def test_failed_build_raises(monkeypatch, tmp_path):
    fresh_build(monkeypatch, tmp_path)
    broken = tmp_path / "greedy.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.assign_topic_native(np.arange(4), np.arange(4), 2)
    assert not native.library_path().exists()
