"""The port stands alone: no JAX, devices resolved loudly, state carried.

* no module of ``kafka_lag_based_assignor_tpu_torch`` (nor ``chip_smoke.py``)
  imports ``jax`` or ``kafka_lag_based_assignor_tpu`` — by an AST walk, and
  by importing every module in a fresh interpreter;
* every module of the streaming slice, of the solver surface (the scan
  kernel's wrapper, the native core's loader), of the fault ladder and
  telemetry, of the sidecar (the service, overload control, the
  ``/metrics`` listener) and of its boot and restart (the warm-up, the
  snapshots, the scrubber), of the sharded backend and its placements, and
  of federation is covered by both checks;
* no module but ``utils/observability`` imports ``torch.profiler`` at
  import time, and that one only inside ``profile_trace``;
* entry points default to the CUDA card and raise without one;
* CPU tensors take the plain path and never count a kernel launch;
* ``convert.group_tensors`` carries a JAX ``TopicGroup`` over unchanged.
"""

import ast
import subprocess
import sys
import threading
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
    batched,
    dispatch,
    linear_ot,
    linear_ot_cuda,
    packing,
    plan_stats,
    refine,
    rounds_cuda,
    scan_cuda,
)
from kafka_lag_based_assignor_tpu_torch.ops.coalesce import MegabatchCoalescer  # noqa: E402
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


LADDER_SLICE = ("utils/trace.py", "utils/snapshot.py", "utils/metrics.py",
                "utils/faults.py", "utils/observability.py", "utils/watchdog.py",
                "utils/config.py", "utils/scrub.py", "utils/device.py",
                "models/greedy.py", "lag.py", "ops/dispatch.py", "ops/streaming.py",
                "ops/linear_ot.py", "models/sinkhorn.py", "ops/_build.py",
                "assignor.py")


SIDECAR_SLICE = ("service.py", "utils/overload.py", "utils/metrics_http.py")


LIFECYCLE_SLICE = ("warmup.py", "utils/snapshot.py", "utils/scrub.py", "service.py",
                   "testing.py", "utils/config.py", "assignor.py")


SHARDED_SLICE = ("sharded/__init__.py", "sharded/mesh.py", "sharded/collectives.py",
                 "sharded/solve.py", "sharded/topics.py", "parallel/__init__.py",
                 "parallel/mesh.py")


PLACEMENT_FEDERATION_SLICE = ("sharded/resident.py", "sharded/megabatch.py",
                              "federated/__init__.py", "federated/wire.py",
                              "federated/peers.py", "ops/fedsolve.py")


def test_import_checks_cover_placement_and_federation():
    walked = {p.relative_to(PORT).as_posix() for p in port_sources() if PORT in p.parents}
    assert set(PLACEMENT_FEDERATION_SLICE) <= walked


def test_import_checks_cover_the_sharded_slice():
    walked = {p.relative_to(PORT).as_posix() for p in port_sources() if PORT in p.parents}
    assert set(SHARDED_SLICE) <= walked


def test_import_checks_cover_the_lifecycle_slice():
    walked = {p.relative_to(PORT).as_posix() for p in port_sources() if PORT in p.parents}
    assert set(LIFECYCLE_SLICE) <= walked


def test_import_checks_cover_the_sidecar():
    walked = {p.relative_to(PORT).as_posix() for p in port_sources() if PORT in p.parents}
    assert set(SIDECAR_SLICE) <= walked


def test_import_checks_cover_the_ladder_slice():
    walked = {p.relative_to(PORT).as_posix() for p in port_sources() if PORT in p.parents}
    assert set(LADDER_SLICE) <= walked


def module_level_imports(path):
    """Names imported outside any function or class body."""
    def visit(nodes):
        for node in nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            if isinstance(node, ast.Import):
                yield from (alias.name for alias in node.names)
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                yield base
                yield from (f"{base}.{alias.name}" for alias in node.names)
            else:
                for field in ("body", "orelse", "finalbody", "handlers"):
                    yield from visit(getattr(node, field, []) or [])
    yield from visit(ast.parse(path.read_text(encoding="utf-8")).body)


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")), ids=lambda p: str(p.relative_to(REPO))
)
def test_no_module_imports_the_profiler_at_import_time(path):
    names = set(module_level_imports(path))
    assert not any(n == "torch.profiler" or n.startswith("torch.profiler.")
                   for n in names), f"{path.name} imports torch.profiler at import time"
    if path.relative_to(PORT).as_posix() == "utils/observability.py":
        assert "torch.profiler" in path.read_text(encoding="utf-8")  # inside a function


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
    assert MegabatchCoalescer().device == torch.device("cuda")


def launch_counts():
    return (rounds_cuda.rounds_scan.launches, plan_stats.plan_stats.launches,
            linear_ot_cuda.superblock_partials.launches,
            linear_ot_cuda.mirror_prox_step.launches, refine.state_digest.launches,
            scan_cuda.scan_greedy.launches, refine.state_digest_rows.launches)


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
    dense = np.stack([lags["t0"][:64] * k for k in (1, 2, 3)])
    batched.assign_stream_batch(dense, 8, device="cpu")
    batched.assign_stream_global(dense, 8, device="cpu")
    # A coalesced wave: two engines' warm epochs through one CPU coalescer.
    coal = MegabatchCoalescer(window_s=60.0, max_batch=2, device="cpu")
    engines = [StreamingAssignor(8, refine_threshold=None, device="cpu")
               for _ in range(2)]
    try:
        for eng in engines:
            eng.rebalance(lags["t0"])
        threads = [threading.Thread(target=eng.submit_epoch, args=(lags["t0"] * 2, coal))
                   for eng in engines]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert all(eng.last_stats.refined for eng in engines)
    finally:
        coal.close(timeout_s=60)
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
        # totals that could reach the round scan's int64 sentinel, and a
        # device that is neither cuda nor cpu (consumer counts have no cap)
        lambda z: rounds_cuda.rounds_scan(
            torch.full((1, 2, 2), 2**62, dtype=torch.int64),
            torch.ones((1, 2, 2), dtype=torch.uint8), torch.zeros(2, dtype=torch.int64)),
        lambda z: linear_ot_cuda.superblock_partials(
            *(x.to("meta") for x in (z(8, 1, 8), z(8, 1, 8), z(16385), z(16385)))),
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


def pyproject():
    import tomllib

    return tomllib.loads((REPO / "pyproject.toml").read_text(encoding="utf-8"))


def test_packaging_lists_every_port_subpackage():
    """Every directory of the port with an ``__init__.py`` is in
    pyproject's explicit package list, so an installed port has it."""
    declared = set(pyproject()["tool"]["setuptools"]["packages"])
    on_disk = {str(init.parent.relative_to(REPO)).replace("/", ".")
               for init in PORT.rglob("__init__.py")}
    assert on_disk <= declared, sorted(on_disk - declared)
    assert {"kafka_lag_based_assignor_tpu_torch.federated",
            "kafka_lag_based_assignor_tpu_torch.native"} <= on_disk


def test_packaging_ships_every_port_source():
    """Every CUDA source and header (built by ``ops/_build``) and C++ source
    (``native/greedy.cpp``, built by ``native``) of the port matches the
    port's package-data, so an installed port can build its kernels."""
    import fnmatch

    globs = pyproject()["tool"]["setuptools"]["package-data"][PORT.name]
    sources = [p.relative_to(PORT).as_posix() for ext in ("*.cu", "*.cuh", "*.cpp")
               for p in PORT.rglob(ext)]
    assert {"csrc/rounds_scan.cu", "csrc/slot_sort.cuh", "native/greedy.cpp"} <= set(sources)
    unshipped = [s for s in sources if not any(fnmatch.fnmatch(s, g) for g in globs)]
    assert not unshipped, unshipped


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
