"""Consumer groups wider than the register network (16,384 slots) against
the JAX package, on the CPU.

The port once refused every group of more than 16,384 members; the JAX
package answers them, and so must the port.  Here the port's CPU path (the
plain versions of K1/K2, K7, K6 and K3-K5, which the card's wide forms are
held to in ``chip_smoke.py``) answers such groups as JAX does:

* ``rounds``, ``global`` and ``scan`` through ``ops.dispatch.assign_device``
  at 16,385 and 20,000 consumers, ``rounds`` and ``global`` at 65,537 and
  131,073 (the widest cluster form and the scratch form on the card), and
  ``rounds`` with a 16-round refine at 20,000, bit for bit against
  ``kafka_lag_based_assignor_tpu.ops.dispatch``; ``scan`` at 65,537 and
  131,073 against the port's ``rounds``;
* the scratch the wrapper allocates (none up to 131,072 slots), and the
  cluster kernels' names in the CUDA sources;
* the refine's 14-bit pair-id field: both packages raise the same
  ``ValueError`` at 32,768 consumers;
* the plugin's ``assign()`` at 20,000 consumers with the host rung off;
* the resident-state digest at 20,000 consumers, clean and with each
  corruption class, against ``ops/refine._state_digest_xla`` and
  ``_row_tab_lane_xla``;
* ``StreamingAssignor``: a cold epoch and two warm epochs at 20,000
  consumers, bit for bit against the JAX engine;
* the f32 kernels' plain versions (``plan_stats`` in each ``need``,
  ``superblock_partials``, ``mirror_prox_step``) at 16,385, 20,000 and
  60,000 consumers against ``plan_stats_lax`` and ``ops/linear_ot``'s XLA
  functions, to ``tests/test_torch_quality.py``'s tolerance.

Integer paths: exact equality.  Inputs are made with numpy from a seed.
"""

import ast
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from kafka_lag_based_assignor_tpu.ops import dispatch as jax_dispatch  # noqa: E402
from kafka_lag_based_assignor_tpu.ops import linear_ot as jax_linear  # noqa: E402
from kafka_lag_based_assignor_tpu.ops import plan_stats as jax_plan  # noqa: E402
from kafka_lag_based_assignor_tpu.ops.streaming import (  # noqa: E402
    StreamingAssignor as JaxEngine,
)
from kafka_lag_based_assignor_tpu_torch.assignor import (  # noqa: E402
    LagBasedPartitionAssignor,
)
from kafka_lag_based_assignor_tpu_torch.ops import (  # noqa: E402
    linear_ot,
    linear_ot_cuda,
    plan_stats,
    refine,
    rounds_cuda,
)
from kafka_lag_based_assignor_tpu_torch.ops.dispatch import assign_device  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops.streaming import (  # noqa: E402
    StreamingAssignor,
)
from kafka_lag_based_assignor_tpu_torch.testing import broker_for, lag_rows  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.types import (  # noqa: E402
    GroupSubscription,
    Subscription,
)
from test_torch_digest import KINDS, both_digests, corrupt, resident_state  # noqa: E402
from test_torch_quality import assert_close, duals_case, jax_step  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
T = torch.from_numpy
WIDE = 20_000
ABOVE = rounds_cuda.REGISTER_SLOTS + 1


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's torch work, restored after.
    The suite runs six workers on the machine's cores, and at these widths
    each worker's own thread pool made a torch step a row (K7's plain
    version, the refine rounds) tens of times slower than on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def group(C, P, seed=0):
    """One topic of P uniform lags in [0, 10^6) subscribed by C members."""
    lags = {"t0": np.random.default_rng(seed).integers(0, 10**6, P)}
    members = [f"m{i:05d}" for i in range(C)]
    return lags, members, {m: ["t0"] for m in members}


def pairs(assignment):
    return {m: [(tp.topic, tp.partition) for tp in tps] for m, tps in assignment.items()}


def spread_ok(got, C):
    counts = [len(tps) for tps in got.values()] + [0] * (C - len(got))
    return max(counts) - min(counts) <= 1


#: The cluster form's widest slot count and the scratch form's least
#: consumer count.
CLUSTER = rounds_cuda.CLUSTER_SLOTS // 2 + 1
SCRATCH = rounds_cuda.CLUSTER_SLOTS + 1


@pytest.mark.parametrize("solver,C", [
    *((solver, C) for C in (ABOVE, WIDE) for solver in ("rounds", "global", "scan")),
    *((solver, C) for C in (CLUSTER, SCRATCH) for solver in ("rounds", "global")),
])
def test_parity_solvers_match_jax(solver, C):
    """P 60,000 for ``rounds`` and ``global`` at 16,385 and 20,000 consumers
    (K1's cluster form on the card, 32,768 slots), 2C + 5 at 65,537 (the
    cluster form at 131,072 slots) and 131,073 (the scratch form); about 2C
    for ``scan`` (K7's cluster form), whose JAX scan takes a step a row."""
    P = 2 * C + 17 if solver == "scan" else 60_000 if C <= WIDE else 2 * C + 5
    lags, _, subs = group(C, P, seed=C)
    rows = lag_rows(lags)
    got = pairs(assign_device(rows, subs, kernel=solver, device="cpu"))
    assert got == pairs(jax_dispatch.assign_device(rows, subs, kernel=solver))
    assert spread_ok(got, C)


@pytest.mark.parametrize("C", [CLUSTER, SCRATCH])
def test_scan_matches_rounds_at_cluster_and_scratch_widths(C):
    """``scan`` (K7's cluster and scratch forms on the card) is held to the
    port's own ``rounds`` answer, the identity phase 4l of ``chip_smoke.py``
    holds on the card.  The CPU runs K7's plain version, a torch step a row
    (1.4-1.8 ms each at these widths), so the topic has 3,000 rows: less
    than one round."""
    lags, _, subs = group(C, 3_000, seed=C + 1)
    rows = lag_rows(lags)
    got = pairs(assign_device(rows, subs, kernel="scan", device="cpu"))
    assert got == pairs(assign_device(rows, subs, kernel="rounds", device="cpu"))
    assert spread_ok(got, C)


@pytest.mark.parametrize("slots", [1024, rounds_cuda.REGISTER_SLOTS, 32768,
                                   rounds_cuda.CLUSTER_SLOTS, 2 * rounds_cuda.CLUSTER_SLOTS,
                                   1 << 20])
@pytest.mark.parametrize("blocks", [1, 3])
def test_wide_scratch_only_for_the_scratch_form(slots, blocks):
    """No scratch up to 131,072 slots (the register and cluster forms keep
    their slots on chip); above, 12 bytes a slot a block."""
    got = rounds_cuda.wide_scratch(blocks, slots, "cpu")
    if slots <= rounds_cuda.CLUSTER_SLOTS:
        assert got is None
    else:
        assert got.dtype == torch.uint8 and got.numel() == blocks * slots * 12


def test_each_source_defines_a_cluster_kernel_chip_smoke_can_name():
    """K1's and K7's sources define a ``_cluster`` kernel whose name starts
    with the prefix ``chip_smoke.py``'s ``KERNEL_NAMES`` finds it by."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text(encoding="utf-8"))
    names = next(ast.literal_eval(node.value) for node in tree.body
                 if isinstance(node, ast.Assign)
                 and any(getattr(t, "id", None) == "KERNEL_NAMES" for t in node.targets))
    csrc = REPO / "kafka_lag_based_assignor_tpu_torch" / "csrc"
    for source, key in (("rounds_scan.cu", "rounds_scan"), ("scan_greedy.cu", "scan_greedy")):
        kernels = re.findall(r"__global__ void __launch_bounds__\([^;]*?\)\s+(\w+)\(",
                             (csrc / source).read_text(encoding="utf-8"))
        cluster = [k for k in kernels if k.endswith("_cluster")]
        assert cluster == [names[key] + "_cluster"], (source, kernels)


def test_rounds_refine_matches_jax():
    lags, _, subs = group(WIDE, 60_000, seed=1)
    rows = lag_rows(lags)
    got = pairs(assign_device(rows, subs, kernel="rounds", device="cpu", refine_iters=16))
    want = pairs(jax_dispatch.assign_device(rows, subs, kernel="rounds", refine_iters=16))
    assert got == want
    assert spread_ok(got, WIDE)


def test_refine_pair_field_limit_raises_in_both_packages():
    """The refine packs a pair id in 14 bits: at 32,768 consumers (16,384
    pairs) both packages raise the same ``ValueError``; the port raises
    nowhere the JAX package does not."""
    C = 32_768
    lags, _, subs = group(C, C + 5, seed=2)
    rows = lag_rows(lags)
    with pytest.raises(ValueError) as port:
        assign_device(rows, subs, kernel="rounds", device="cpu", refine_iters=16)
    with pytest.raises(ValueError) as jax:
        jax_dispatch.assign_device(rows, subs, kernel="rounds", refine_iters=16)
    assert str(port.value) == str(jax.value)
    assert "pair-id field" in str(port.value)


def test_plugin_assign_answers_without_the_host_rung():
    lags, members, subs = group(WIDE, 60_000, seed=3)
    broker = broker_for(lags)
    assignor = LagBasedPartitionAssignor(lambda props: broker, device="cpu")
    assignor.configure({"group.id": "wide", "tpu.assignor.host.fallback": "false"})
    out = assignor.assign(broker.cluster(),
                          GroupSubscription({m: Subscription(("t0",)) for m in members}))
    assert assignor.last_stats.fallback_used is False
    got = {m: [(tp.topic, tp.partition) for tp in a.partitions]
           for m, a in out.group_assignment.items()}
    want = pairs(jax_dispatch.assign_device(lag_rows(lags), subs, kernel="rounds"))
    assert {m: ps for m, ps in got.items() if ps} == want


@pytest.mark.parametrize("kind", KINDS)
def test_state_digest_matches_jax(kind):
    """The digest at 20,000 consumers (K6's shared-memory histogram on the
    card) in every lane."""
    B, P = 65536, 60_000
    lags, choice, tab, counts = resident_state(WIDE, B, P, WIDE)
    corrupt(kind, lags, choice, tab, counts, WIDE)
    (base, lane), (jbase, jlane) = both_digests(lags, choice, tab, counts, WIDE)
    np.testing.assert_array_equal(base, jbase)
    assert lane == jlane
    full = refine.state_digest(T(lags), T(choice), T(counts), WIDE, row_tab=T(tab))
    np.testing.assert_array_equal(full.numpy(), np.append(jbase, jlane))


def test_streaming_epochs_match_jax():
    """A cold epoch (K1's wide form in the cold chain on the card), then
    two warm epochs, each with drift on the median consumer's partitions so
    that it refines (K6 on the card): the choices and every stats field
    equal to the JAX engine's."""
    P = 60_000
    kw = dict(num_consumers=WIDE, refine_iters=16, imbalance_guardrail=1.25)
    jax_engine, port = JaxEngine(mesh_backend=None, **kw), StreamingAssignor(device="cpu", **kw)
    rng = np.random.default_rng(4)
    lags = rng.integers(0, 10**6, P)
    refined = []
    for epoch in range(3):
        want = jax_engine.rebalance(lags)
        got = port.rebalance(lags)
        np.testing.assert_array_equal(got, want)
        assert (dataclasses.asdict(port.last_stats)
                == dataclasses.asdict(jax_engine.last_stats))
        assert port.last_stats.cold_start == (epoch == 0)
        refined.append(port.last_stats.refined)
        totals = np.bincount(got, weights=lags, minlength=WIDE)
        median = np.argsort(totals, kind="stable")[WIDE // 2]
        lags = (lags * rng.lognormal(0, 0.05, P)).astype(np.int64)
        lags[got == median] *= 3
    assert refined[1] and refined[2]


@pytest.mark.parametrize("C", [ABOVE, WIDE, 60_000])
@pytest.mark.parametrize("need", ["both", "load", "colsum"])
def test_plan_stats_matches_jax(need, C):
    """K3 past 16,384 consumers (on the card its column form, 17 to 59
    column tiles): each ``need`` against ``plan_stats_lax``."""
    ws, cnt, wsum, A, B = duals_case(C, 40, C)
    got = plan_stats.plan_stats(*(T(x) for x in (ws, cnt, wsum, A, B)), need=need)
    want = jax_plan.plan_stats_lax(*(jnp.asarray(x) for x in (ws, cnt, wsum, A, B)),
                                   need=need)
    assert [g is None for g in got] == [w is None for w in want]
    for g, w in zip(got, want):
        if w is not None:
            assert_close(g.numpy(), w)


def linear_case(C, seed):
    rng = np.random.default_rng(seed)
    ws = rng.gamma(0.5, 2.0, (8, 2, 8)).astype(np.float32)
    cnt = (rng.random((8, 2, 8)) < 0.8).astype(np.float32)
    A = rng.normal(0, 0.5, C).astype(np.float32)
    B = rng.normal(0, 0.1, C).astype(np.float32)
    return ws, cnt, A, B


@pytest.mark.parametrize("C", [ABOVE, WIDE, 60_000])
def test_superblock_partials_match_jax(C):
    ws, cnt, A, B = linear_case(C, C)
    got = linear_ot_cuda.superblock_partials(T(ws), T(cnt), T(A), T(B))
    want = jax_linear._superblock_partials(*(jnp.asarray(x) for x in (ws, cnt, A, B)))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert_close(g.numpy(), w)


@pytest.mark.parametrize("C", [ABOVE, WIDE, 60_000])
@pytest.mark.parametrize("sc,prev_spread", [(1.0, np.inf), (0.5, 0.0)])
def test_mirror_prox_step_matches_jax(sc, prev_spread, C):
    ws, cnt, A, B = linear_case(C, C + 1)
    got = linear_ot_cuda.mirror_prox_step(
        T(ws), T(cnt), T(A), T(B), torch.tensor(sc, dtype=torch.float32),
        torch.tensor(prev_spread, dtype=torch.float32), eta=linear_ot.MIRROR_PROX_ETA)
    want = jax_step(ws, cnt, A, B, np.float32(sc), np.float32(prev_spread))
    for g, w in zip(got, want):
        assert_close(g.numpy(), w)
