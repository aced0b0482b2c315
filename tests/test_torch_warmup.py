"""The port's warm-up against the JAX package's, on the CPU.

* ``parse_warmup_shapes`` and ``tpu.assignor.warmup.shapes``: the same
  shapes from the same text, the same errors from the same bad text;
* ``bucket_range``: the same buckets;
* ``warmup``: the same rows minus seconds for the solvers the port serves
  (every job the JAX warm-up builds but the megabatch and sharded ones), the
  ``stream`` job's returned choice equal, a failing job logged and skipped
  in both; an inactive mesh manager adds no job (the sharded jobs are in
  ``tests/test_torch_sharded.py``);
* the plugin's configure-time warm-up: the same ``warmup`` calls for a
  device solver, none for ``native``.
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from kafka_lag_based_assignor_tpu import assignor as jax_assignor  # noqa: E402
from kafka_lag_based_assignor_tpu import warmup as jax_warmup  # noqa: E402
from kafka_lag_based_assignor_tpu.ops import batched as jax_batched  # noqa: E402
from kafka_lag_based_assignor_tpu.ops import streaming as jax_streaming  # noqa: E402
from kafka_lag_based_assignor_tpu.utils import config as jax_config  # noqa: E402
from kafka_lag_based_assignor_tpu_torch import assignor, warmup  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops import batched, streaming  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.utils import config  # noqa: E402

SHAPE_TEXTS = ["100:4", "100000:1000", "64:8:3", "1:1", "20:3,64:4:2",
               "100", "1:2:3:4", "a:4", "0:4", "10:-1", "10:4:0", ""]


def outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as exc:
        return ("error", str(exc))


@pytest.mark.parametrize("text", SHAPE_TEXTS)
def test_parse_warmup_shapes_matches_jax(text):
    got = outcome(config.parse_warmup_shapes, text)
    assert got == outcome(jax_config.parse_warmup_shapes, text)


@pytest.mark.parametrize("text", SHAPE_TEXTS)
def test_warmup_shapes_key_matches_jax(text):
    cfg = {"group.id": "g", "tpu.assignor.warmup.shapes": text}

    def shapes(parse):
        return parse(cfg).warmup_shapes

    assert outcome(shapes, config.parse_config) == outcome(
        shapes, jax_config.parse_config)


@pytest.mark.parametrize("value,minimum", [(1, 8), (8, 8), (9, 8), (100, 8),
                                           (131072, 8), (5, 1), (1000, 64)])
def test_bucket_range_matches_jax(value, minimum):
    assert warmup.bucket_range(value, minimum) == jax_warmup.bucket_range(
        value, minimum)


def run_both(monkeypatch, **kw):
    """(JAX rows, port rows) minus seconds, and each ``stream`` job's
    returned choice (the JAX one caught at ``jax.block_until_ready``, the
    port's at ``warmup._ready``)."""
    outs = {"jax": [], "port": []}
    real_block, real_ready = jax.block_until_ready, warmup._ready
    monkeypatch.setattr(jax, "block_until_ready",
                        lambda x: outs["jax"].append(x) or real_block(x))
    monkeypatch.setattr(warmup, "_ready",
                        lambda x, dev: outs["port"].append(x) or real_ready(x, dev))
    rows_jax = jax_warmup.warmup(**kw)
    rows_port = warmup.warmup(device="cpu", **kw)
    return ([r[:4] for r in rows_jax], [r[:4] for r in rows_port], outs)


def test_warmup_rows_and_stream_choice_match_jax(monkeypatch):
    """Every job the port serves, at two topic buckets, with the parity
    refine on: the same rows in the same order; the stream job returns the
    warm epoch's choice, equal in both."""
    kw = dict(max_partitions=20, consumers=[3], topics=[1, 3],
              solvers=("rounds", "scan", "global", "stream", "sinkhorn",
                       "linear"),
              refine_iters=4, delta_buckets=2)
    rows_jax, rows_port, outs = run_both(monkeypatch, **kw)
    assert rows_port == rows_jax
    assert [r[0] for r in rows_port] == [
        "stream", "stream_delta", "stream_delta", "sinkhorn", "linear",
        "rounds", "scan", "global", "rounds", "scan", "global"]
    assert ("rounds", 4, 32, 3) in rows_port
    np.testing.assert_array_equal(np.asarray(outs["port"][0]),
                                  np.asarray(outs["jax"][0]))


def test_failing_job_is_skipped_as_in_jax(monkeypatch, caplog):
    """A job that raises is logged with its traceback and skipped; the
    other jobs still run, at every bucket."""
    def boom(*a, **k):
        raise RuntimeError("simulated build failure")

    for mod in (jax_batched, jax_streaming, batched, streaming):
        monkeypatch.setattr(mod, "assign_stream", boom)
    kw = dict(max_partitions=20, consumers=[2], solvers=("stream", "rounds"),
              all_partition_buckets=True, delta_buckets=0)
    with caplog.at_level(logging.WARNING):
        rows_jax, rows_port, _ = run_both(monkeypatch, **kw)
    assert rows_port == rows_jax
    assert rows_port == [("rounds", 1, P, 2) for P in (8, 16, 32)]
    skipped = [r for r in caplog.records
               if r.name == warmup.LOGGER.name and "failed (skipped)" in r.getMessage()]
    assert len(skipped) == 3 and all(r.exc_info for r in skipped)


@pytest.mark.parametrize("kw", [{"mesh_manager": object()}])
def test_unported_jobs_raise(kw):
    """A mesh manager no longer raises: an inactive one adds no sharded job,
    as in the JAX warm-up (tests/test_torch_sharded.py runs the sharded
    jobs of an active one, and reports the P-sharded resident job, which
    the port does not have, as not run)."""
    from kafka_lag_based_assignor_tpu_torch.sharded.mesh import MeshManager

    inactive = MeshManager(devices="off").configure()
    rows = warmup.warmup(16, [2], solvers=("stream",), delta_buckets=0,
                         device="cpu", mesh_manager=inactive)
    assert [r[0] for r in rows] == ["stream"]
    # Something that is not a manager fails as in the JAX warm-up.
    with pytest.raises(AttributeError):
        warmup.warmup(16, [2], solvers=("stream",), device="cpu", **kw)


def test_warmup_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        warmup.warmup(16, [2], solvers=("rounds",))


@pytest.mark.parametrize("solver", ["rounds", "sinkhorn", "native"])
def test_configure_time_warmup_matches_jax(monkeypatch, solver):
    """``configure()`` with ``tpu.assignor.warmup.shapes`` warms the
    configured device solver at each shape with the JAX plugin's arguments
    (plus the device); ``native`` warms nothing in either."""
    calls = {"jax": [], "port": []}
    monkeypatch.setattr(jax_warmup, "warmup",
                        lambda **kw: calls["jax"].append(kw) or [])
    monkeypatch.setattr(warmup, "warmup",
                        lambda **kw: calls["port"].append(kw) or [])
    cfg = {"group.id": "g", "tpu.assignor.solver": solver,
           "tpu.assignor.warmup.shapes": "64:4,128:8:2",
           "tpu.assignor.refine.iters": "0" if solver != "sinkhorn" else "auto"}
    jax_assignor.LagBasedPartitionAssignor().configure(cfg)
    assignor.LagBasedPartitionAssignor(device="cpu").configure(cfg)
    for kw in calls["port"]:
        assert kw.pop("device") == torch.device("cpu")
    assert calls["port"] == calls["jax"]
    assert len(calls["port"]) == (0 if solver == "native" else 2)
