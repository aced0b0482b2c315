"""The port's federation at 16,385 and 20,000 consumers against the JAX
package, on the CPU.

* ``shard_marginals`` (K3's column form with ``need="both"`` on the card)
  within ``tests/test_torch_fedsolve.py``'s f32 tolerance of JAX at C
  16,385 and 20,000, at the duals of two JAX exchange rounds;
* ``round_local_shard`` on the first of three shards of 16,384 rows at C
  16,385, at the duals of two rounds of a three-shard JAX exchange and
  with the other two shards' load as its base: the counts exactly, the
  global quality within 2 % of the JAX rounding's;
* one JAX sidecar and one port sidecar peered over loopback TCP at C
  16,385, 1,024 rows each, 4 exchange rounds: each one's
  ``federated_assign`` reaches rung ``global`` over the other's marginals,
  and each shard is count-balanced.

Inputs are made with numpy from a seed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kafka_lag_based_assignor_tpu.ops import fedsolve as jax_fedsolve  # noqa: E402
from kafka_lag_based_assignor_tpu.service import AssignorService as JaxService  # noqa: E402
from kafka_lag_based_assignor_tpu.service import (  # noqa: E402
    AssignorServiceClient as JaxClient,
)
from kafka_lag_based_assignor_tpu_torch.ops import fedsolve  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.service import (  # noqa: E402
    AssignorService,
    AssignorServiceClient,
)
from test_torch_fedsolve import _free_ports, _rows  # noqa: E402
from test_torch_wide_groups import one_torch_thread  # noqa: E402

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

ABOVE, WIDE = 16_385, 20_000
SHARD_P = 16_384
PAIR_P = 1_024
DEV = "cpu"


def shard(seed, P=SHARD_P):
    return np.random.default_rng(seed).integers(0, 10**6, P).astype(np.int64)


def jax_exchange(shards, C, rounds):
    """The JAX exchange over ``shards``: the global scale, each shard's
    deduplicated rows, and the duals after ``rounds`` summed-marginal
    rounds."""
    n = sum(s.shape[0] for s in shards)
    scale = max(float(sum(s.sum() for s in shards)), 1.0) / C
    ws = [jax_fedsolve.shard_dedup(s, np.ones(s.shape[0], bool), scale) for s in shards]
    A, B = jax_fedsolve.initial_duals(C)
    step, prev = 1.0, float("inf")
    for _ in range(rounds):
        parts = [jax_fedsolve.shard_marginals(*w, A, B) for w in ws]
        load = sum(np.asarray(p[0], np.float64) for p in parts)
        col = sum(np.asarray(p[1], np.float64) for p in parts)
        A, B, step, prev, _ = jax_fedsolve.dual_step(A, B, load, col, n / C, step, prev)
    return scale, ws, np.array(A), np.array(B)


@pytest.mark.parametrize("C", [ABOVE, WIDE])
def test_shard_marginals_within_f32_tolerance(C):
    _, (w,), A, B = jax_exchange([shard(C)], C, 2)
    assert w[0].shape[0] == 4096  # the dedup's value cap: U_pad 4,096
    got = fedsolve.shard_marginals(*w, A, B, device=DEV)
    want = jax_fedsolve.shard_marginals(*w, A, B)
    for g, x in zip(got, want):
        assert g.shape == (C,)
        np.testing.assert_allclose(g, np.asarray(x), rtol=1e-4, atol=1e-5)


def test_round_local_shard_counts_exact_quality_within_2pct():
    C = ABOVE
    shards = [shard(30 + k) for k in range(3)]
    scale, ws, A, B = jax_exchange(shards, C, 2)
    base = sum(np.asarray(jax_fedsolve.shard_marginals(*w, A, B)[0], np.float64)
               for w in ws[1:]).astype(np.float32)
    lags = shards[0]
    got = fedsolve.round_local_shard(lags, C, A, B, scale, base, device=DEV)
    want = jax_fedsolve.round_local_shard(lags, C, A, B, scale, base)
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    np.testing.assert_array_equal(np.bincount(got[0], minlength=C), np.asarray(want[1]))
    assert got[1].max() - got[1].min() <= 1
    base_lag = base.astype(np.float64) * scale

    def quality(choice):
        totals = np.bincount(choice, weights=lags.astype(np.float64), minlength=C) + base_lag
        return totals.max() / totals.mean()

    assert quality(got[0]) <= quality(np.asarray(want[0])) * 1.02


def test_mixed_pair_converges_global_at_16385_members():
    """Shards of 1,024 rows each and 4 exchange rounds: each round runs K3
    over every deduplicated value against all 16,385 consumers on each
    side, and the JAX side compiles each new shape."""
    members = [f"m{i:05d}" for i in range(ABOVE)]
    ports = _free_ports(2)
    common = dict(coalesce_max_batch=1, scrub_interval_ms=0, federation_rounds=4,
                  federation_sync_timeout_s=120.0)
    jax_svc = JaxService(port=ports[0], federation_self_id="jax",
                         federation_peers=f"port=127.0.0.1:{ports[1]}", **common)
    port_svc = AssignorService(port=ports[1], federation_self_id="port",
                               federation_peers=f"jax=127.0.0.1:{ports[0]}",
                               device=DEV, **common)
    jax_svc.start()
    port_svc.start()
    shards = {"jax": shard(41, PAIR_P), "port": shard(42, PAIR_P)}
    try:
        with JaxClient("127.0.0.1", ports[0], timeout_s=300.0) as jc, \
                AssignorServiceClient("127.0.0.1", ports[1], timeout_s=300.0) as pc:
            clients = {"jax": jc, "port": pc}
            # The port registers first (no peer shard yet), then each side
            # converges over the other's.
            clients["port"].federated_assign("t0", _rows(shards["port"]), members)
            for sid in ("jax", "port"):
                r = clients[sid].federated_assign("t0", _rows(shards[sid]), members)
                assert r["federation"]["rung"] == "global", (sid, r["federation"])
                assert 1 <= r["federation"]["rounds"] <= 4
                sizes = [len(r["assignments"].get(m, [])) for m in members]
                assert max(sizes) - min(sizes) <= 1 and sum(sizes) == PAIR_P
            assert pc.federation()["peers"]["jax"]["epoch_seen"] >= 1
            assert jc.federation()["peers"]["port"]["epoch_seen"] >= 1
    finally:
        jax_svc.stop()
        port_svc.stop()
