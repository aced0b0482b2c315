"""The port stands alone: no JAX, devices resolved loudly, state carried.

* no module of ``kafka_lag_based_assignor_tpu_torch`` (nor ``chip_smoke.py``)
  imports ``jax`` or ``kafka_lag_based_assignor_tpu`` — by an AST walk, and
  by importing every module in a fresh interpreter;
* every module of the streaming slice and of the solver surface (the scan
  kernel's wrapper, the native core's loader) is covered by both checks;
* entry points default to the CUDA card and raise without one;
* CPU tensors take the plain path and never count a kernel launch;
* ``convert.group_tensors`` carries a JAX ``TopicGroup`` over unchanged.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kafka_lag_based_assignor_tpu.ops import packing as jax_packing  # noqa: E402
from kafka_lag_based_assignor_tpu_torch import convert, native  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.assignor import (  # noqa: E402
    LagBasedPartitionAssignor,
)
from kafka_lag_based_assignor_tpu_torch.models import sinkhorn  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops import (  # noqa: E402
    dispatch,
    linear_ot,
    linear_ot_cuda,
    packing,
    plan_stats,
    refine,
    rounds_cuda,
    scan_cuda,
)
from kafka_lag_based_assignor_tpu_torch.ops.streaming import (  # noqa: E402
    StreamingAssignor,
)
from kafka_lag_based_assignor_tpu_torch.testing import (  # noqa: E402
    baseline_workload,
    lag_rows,
)
from kafka_lag_based_assignor_tpu_torch.utils.device import resolve_device  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "kafka_lag_based_assignor_tpu_torch"
FORBIDDEN = ("jax", "kafka_lag_based_assignor_tpu")


def port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def imported_modules(path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize(
    "path", port_sources(), ids=lambda p: str(p.relative_to(REPO))
)
def test_no_jax_imports(path):
    for name in imported_modules(path):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{path.name} imports {name}"


STREAMING_SLICE = ("ops/streaming.py", "ops/delta.py", "ops/state_digest_cuda.py",
                   "utils/scrub.py", "utils/watchdog.py")


SOLVER_SLICE = ("ops/scan_cuda.py", "ops/scan_kernel.py", "ops/refine.py",
                "ops/batched.py", "native/__init__.py")


def test_import_checks_cover_the_streaming_slice():
    walked = {p.relative_to(PORT).as_posix() for p in port_sources() if PORT in p.parents}
    assert set(STREAMING_SLICE) <= walked
    assert (PORT / "csrc" / "state_digest.cu").exists()


def test_import_checks_cover_the_solver_surface():
    walked = {p.relative_to(PORT).as_posix() for p in port_sources() if PORT in p.parents}
    assert set(SOLVER_SLICE) <= walked
    assert (PORT / "csrc" / "scan_greedy.cu").exists()
    assert (PORT / "native" / "greedy.cpp").exists()


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import kafka_lag_based_assignor_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'kafka_lag_based_assignor_tpu'))\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120, check=True,
    )
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(device)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LagBasedPartitionAssignor()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dispatch.assign_device({}, {"m": ["t"]})
    # The quality entry points resolve device=None the same way.
    for entry in (sinkhorn.assign_sinkhorn, linear_ot.assign_linear):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry({}, {"m": ["t"]})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingAssignor(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.resident_from_numpy(np.zeros(8), np.zeros((2, 5)), np.zeros(2),
                                    np.zeros(8))
    lags_p, pids_p, valid = packing.pad_topic_rows(np.arange(20))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sinkhorn.assign_topic_sinkhorn(lags_p, pids_p, valid, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        linear_ot.assign_topic_linear(lags_p, pids_p, valid, 3)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")
    assert LagBasedPartitionAssignor().device == torch.device("cuda")
    assert StreamingAssignor(4).device == torch.device("cuda")


def launch_counts():
    return (rounds_cuda.rounds_scan.launches, plan_stats.plan_stats.launches,
            linear_ot_cuda.superblock_partials.launches,
            linear_ot_cuda.mirror_prox_step.launches, refine.state_digest.launches,
            scan_cuda.scan_greedy.launches)


def test_cpu_tensors_never_count_a_launch():
    before = launch_counts()
    lags, members = baseline_workload(5, 3000, 40)
    subs = {m: ["t0"] for m in members}
    for kernel in ("rounds", "global", "scan"):
        dispatch.assign_device(lag_rows(lags), subs, kernel=kernel, device="cpu")
    for kernel in ("rounds", "scan"):
        dispatch.assign_device(lag_rows(lags), subs, kernel=kernel, device="cpu",
                               refine_iters=4)
    native.assign_native(lag_rows(lags), subs)
    sinkhorn.assign_sinkhorn(lag_rows(lags), subs, device="cpu")
    with dispatch.quality_scope("linear", tile=64):
        sinkhorn.assign_sinkhorn(lag_rows(lags), subs, device="cpu")
    engine = StreamingAssignor(40, refine_threshold=None, device="cpu")
    for scale in (1, 3):
        engine.rebalance(lags["t0"] * scale)
    assert engine.last_stats.refined
    assert launch_counts() == before


def test_other_devices_never_reach_the_plain_version():
    gains = torch.zeros((1, 1, 4), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        rounds_cuda.rounds_scan(
            gains, torch.ones_like(gains, dtype=torch.uint8),
            torch.zeros(4, dtype=torch.int64, device="meta"),
        )
    with pytest.raises(ValueError, match="cuda or cpu"):
        scan_cuda.scan_greedy(gains[0], torch.ones_like(gains[0], dtype=torch.uint8), 4)
    vec = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        plan_stats.plan_stats(vec, vec, vec, vec, vec)
    rows = torch.zeros((8, 1, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        linear_ot_cuda.superblock_partials(rows, rows, vec, vec)
    with pytest.raises(ValueError, match="cuda or cpu"):
        refine.state_digest(gains.reshape(4), torch.zeros(4, dtype=torch.int32,
                                                          device="meta"),
                            torch.zeros(2, dtype=torch.int32, device="meta"), 2)


@pytest.mark.parametrize(
    "call",
    [
        # more consumers than the kernels take (16384)
        lambda z: plan_stats.plan_stats(z(4), z(4), z(4), z(16385), z(16385)),
        lambda z: linear_ot_cuda.superblock_partials(
            z(8, 1, 8), z(8, 1, 8), z(16385), z(16385)),
        # mismatched shapes, dtypes and scalars
        lambda z: plan_stats.plan_stats(z(4), z(3), z(4), z(2), z(2)),
        lambda z: plan_stats.plan_stats(z(4), z(4), z(4), z(2), z(2).double()),
        lambda z: linear_ot_cuda.superblock_partials(z(8, 1, 8), z(8, 2, 4),
                                                     z(2), z(2)),
        lambda z: linear_ot_cuda.mirror_prox_step(z(8, 1, 8), z(8, 1, 8), z(2), z(2),
                                                  z(1), z(), eta=8.0),
    ],
)
def test_kernel_limits_raise_on_the_cpu_too(call):
    with pytest.raises(ValueError):
        call(lambda *shape: torch.zeros(shape, dtype=torch.float32))


def test_group_tensors_round_trips_a_jax_topic_group():
    lags, members = baseline_workload(3)
    subset = {t: lags[t][: 1 + i % 64] for i, t in enumerate(sorted(lags)[:20])}
    (group,) = jax_packing.build_groups(
        lag_rows(subset), {t: members for t in subset}
    )
    tensors = convert.group_tensors(group, device="cpu")
    arrays = convert.group_tensors(
        group.lags, group.partition_ids, group.valid, device="cpu"
    )
    for got, again, want, dtype in zip(
        tensors, arrays, (group.lags, group.partition_ids, group.valid),
        (torch.int64, torch.int32, torch.bool),
    ):
        assert got.dtype == dtype and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)
        assert torch.equal(got, again)
    with pytest.raises(ValueError, match="one shape"):
        convert.group_tensors(group.lags, group.partition_ids[:1], group.valid,
                              device="cpu")
