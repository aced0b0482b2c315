"""The port's federated device math (``ops/fedsolve``) against the JAX
package's: the cases of ``tests/test_federated.py``'s ``TestFedsolve`` and
``TestWeightedShards`` run on the port (``device="cpu"``), and twin checks on
the same inputs — the host helpers and the integer rounding bit for bit, the
f32 marginals and dual step within a stated tolerance."""

import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kafka_lag_based_assignor_tpu.ops import fedsolve as jax_fedsolve  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.federated import wire  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.ops import fedsolve  # noqa: E402
from kafka_lag_based_assignor_tpu_torch.service import (  # noqa: E402
    AssignorService,
    AssignorServiceClient,
)
from kafka_lag_based_assignor_tpu_torch.utils import metrics  # noqa: E402

C = 4
SHARD_P = 128
MEMBERS = [f"m{i}" for i in range(C)]
# The port's entry points default to the card; the tests run the CPU path.
DEV = "cpu"


def _counter(name, labels=None):
    return metrics.REGISTRY.counter(name, labels or {}).value


def _shard(seed, p=SHARD_P):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1_000_000, size=p).astype(np.int64)


def _rows(lags):
    return [[int(i), int(v)] for i, v in enumerate(lags)]


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _assert_balanced(result, members=None):
    members = members or MEMBERS
    sizes = [len(result["assignments"][m]) for m in members]
    assert max(sizes) - min(sizes) <= 1, sizes
    return sizes


def _run_exchange(shards, max_rounds=24, refine_iters=32):
    """Host-side reference of the coordinator's exchange loop."""
    total = sum(int(s.sum()) for s in shards)
    n = sum(int(s.shape[0]) for s in shards)
    scale = max(float(total), 1.0) / C
    cap = float(n) / C
    weights = [
        fedsolve.shard_dedup(s, np.ones(s.shape[0], bool), scale)
        for s in shards
    ]
    A, B = fedsolve.initial_duals(C, device=DEV)
    step, prev = 1.0, float("inf")
    for _ in range(max_rounds):
        margs = [fedsolve.shard_marginals(*w, A, B, device=DEV) for w in weights]
        load = sum(np.asarray(m[0], np.float64) for m in margs)
        col = sum(np.asarray(m[1], np.float64) for m in margs)
        A, B, step, spread, delta = fedsolve.dual_step(
            A, B, load, col, cap, step, prev, device=DEV
        )
        prev = spread  # the damping test carries the SPREAD
        if delta <= fedsolve.DUAL_TOL:
            break
    margs = [fedsolve.shard_marginals(*w, A, B, device=DEV) for w in weights]
    all_load = sum(np.asarray(m[0], np.float64) for m in margs)
    totals = np.zeros(C)
    choices = []
    for i, s in enumerate(shards):
        remote = all_load - np.asarray(margs[i][0], np.float64)
        ch, _, _ = fedsolve.round_local_shard(
            s, C, A, B, scale, remote, refine_iters=refine_iters, device=DEV
        )
        choices.append(ch)
        cnts = np.bincount(ch, minlength=C)
        assert cnts.max() - cnts.min() <= 1  # local count balance
        totals += np.bincount(
            ch, weights=s.astype(np.float64), minlength=C
        )
    return choices, totals


class TestFedsolve:
    def test_three_shard_quality_within_5pct_of_leader(self):
        from kafka_lag_based_assignor_tpu_torch.models.sinkhorn import (
            assign_topic_sinkhorn,
        )
        from kafka_lag_based_assignor_tpu_torch.ops.packing import (
            pad_topic_rows,
        )

        shards = [_shard(seed) for seed in (11, 12, 13)]
        _, fed_totals = _run_exchange(shards)
        full = np.concatenate(shards)
        lags_p, pids_p, valid = pad_topic_rows(full)
        _, _, leader_totals = assign_topic_sinkhorn(
            lags_p, pids_p, valid, num_consumers=C, device=DEV
        )
        leader_totals = leader_totals.cpu().numpy()
        leader_totals = np.asarray(leader_totals, np.float64)
        fed_q = fed_totals.max() / fed_totals.mean()
        leader_q = leader_totals.max() / leader_totals.mean()
        assert fed_q <= leader_q * 1.05, (fed_q, leader_q)

    def test_single_shard_matches_leader_trajectory(self):
        """With ONE shard the summed marginals are the leader's own, so
        the exchange loop must land at comparable quality."""
        shard = _shard(21)
        _, totals = _run_exchange([shard])
        q = totals.max() / totals.mean()
        assert q < 1.01

    def test_marginals_sum_equals_whole(self):
        """Shard marginal sums == the undivided vector's marginals
        (the federation identity): splitting the rows cannot change
        what the duals see."""
        full = _shard(31)
        scale = max(float(full.sum()), 1.0) / C
        A, B = fedsolve.initial_duals(C, device=DEV)
        w_full = fedsolve.shard_dedup(
            full, np.ones(full.shape[0], bool), scale
        )
        l_full, c_full = fedsolve.shard_marginals(*w_full, A, B, device=DEV)
        parts = np.split(full, [40, 90])
        l_sum = np.zeros(C, np.float64)
        c_sum = np.zeros(C, np.float64)
        for p in parts:
            w = fedsolve.shard_dedup(p, np.ones(p.shape[0], bool),
                                     scale)
            lo, co = fedsolve.shard_marginals(*w, A, B, device=DEV)
            l_sum += lo
            c_sum += co
        np.testing.assert_allclose(l_sum, l_full, rtol=1e-4)
        np.testing.assert_allclose(c_sum, c_full, rtol=1e-4)



class TestWeightedShards:
    def test_wire_capacity_is_consumer_axis_bounded(self):
        body = wire.sync_response(
            "a", 1, 0, C, total_lag=10, n_valid=4,
            capacity=[2.0, 1.0, 1.0, 1.0],
        )
        assert body["capacity"] == [2.0, 1.0, 1.0, 1.0]
        with pytest.raises(wire.PayloadViolation, match="length"):
            wire.sync_response(
                "a", 1, 0, C, total_lag=10, n_valid=4,
                capacity=[1.0] * (C + 3),  # partition-axis smuggle
            )

    def test_apportion_counts(self):
        cap = fedsolve.apportion_counts(10, [2.0, 1.0, 1.0])
        assert cap.tolist() == [5, 3, 2]
        assert cap.sum() == 10
        # Degenerate weights fall back to uniform.
        uni = fedsolve.apportion_counts(9, [0.0, 0.0, 0.0])
        assert sorted(uni.tolist()) == [3, 3, 3]

    def test_round_local_shard_weighted_counts_hold_exactly(self):
        """Capacity-proportional seats are seated exactly AND survive
        the (swap-only) exchange refinement — count-changing moves are
        disabled on the weighted path."""
        rng = np.random.default_rng(21)
        P = 512
        lags = rng.integers(1, 10**6, P).astype(np.int64)
        cap_frac = np.array([0.5, 1 / 6, 1 / 6, 1 / 6])
        A, B = fedsolve.initial_duals(C, device=DEV)
        choice, counts, _ = fedsolve.round_local_shard(
            lags, C, A, B, scale=float(lags.sum()) / C,
            base_load=np.zeros(C, np.float32),
            capacity_frac=cap_frac, device=DEV
        )
        target = fedsolve.apportion_counts(P, cap_frac)
        np.testing.assert_array_equal(counts, target)
        np.testing.assert_array_equal(
            np.bincount(choice, minlength=C), target
        )

    def test_weighted_quality_load_stays_bounded(self):
        """Heterogeneous-capacity QUALITY gate: with a 4x-capacity
        consumer, converged duals + the weighted rounding keep the
        load imbalance bounded (the high-count consumer absorbs the
        SMALL rows) — well under the ~4x a capacity-blind count skew
        would produce."""
        rng = np.random.default_rng(22)
        P = 1024
        lags = rng.integers(1, 10**6, P).astype(np.int64)
        capw = np.array([4.0, 1.0, 1.0, 1.0])
        cap_frac = capw / capw.sum()
        scale = max(float(lags.sum()), 1.0) / C
        weights = fedsolve.shard_dedup(lags, np.ones(P, bool), scale)
        A, B = fedsolve.initial_duals(C, device=DEV)
        ss, spread = 1.0, float("inf")
        for _ in range(60):
            load, col = fedsolve.shard_marginals(*weights, A, B, device=DEV)
            A, B, ss, spread, delta = fedsolve.dual_step(
                A, B, load, col, P * cap_frac, ss, spread, device=DEV
            )
            if delta <= fedsolve.DUAL_TOL:
                break
        choice, counts, _ = fedsolve.round_local_shard(
            lags, C, A, B, scale, np.zeros(C, np.float32),
            capacity_frac=cap_frac, device=DEV
        )
        np.testing.assert_array_equal(
            counts, fedsolve.apportion_counts(P, cap_frac)
        )
        totals = np.bincount(choice, weights=lags, minlength=C)
        assert totals.max() / totals.mean() <= 1.35

    def test_config_capacity_knob(self):
        from kafka_lag_based_assignor_tpu_torch.utils.config import (
            parse_config,
        )

        cfg = parse_config({
            "group.id": "g",
            "tpu.assignor.federation.capacity": "3,1,1,1",
        })
        assert cfg.federation_capacity == [3.0, 1.0, 1.0, 1.0]
        with pytest.raises(ValueError, match="capacity"):
            parse_config({
                "group.id": "g",
                "tpu.assignor.federation.capacity": "3,zero",
            })
        with pytest.raises(ValueError, match="> 0"):
            parse_config({
                "group.id": "g",
                "tpu.assignor.federation.capacity": "3,-1",
            })

    def test_two_sidecars_converge_weighted_counts(self):
        """End-to-end: both sidecars advertise a 3x-capacity first
        consumer through the audited hello handshake; the converged
        GLOBAL assignment seats capacity-proportional counts on each
        local shard (and the payloads stay lag-free)."""
        ports = _free_ports(2)
        ids = ("wa", "wb")
        svcs = []
        for i in range(2):
            j = 1 - i
            svc = AssignorService(
                port=ports[i],
                coalesce_max_batch=1,
                scrub_interval_ms=0,
                federation_self_id=ids[i],
                federation_peers=f"{ids[j]}=127.0.0.1:{ports[j]}",
                federation_rounds=8,
                federation_sync_timeout_s=60.0,
                federation_capacity=[3.0, 1.0, 1.0, 1.0], device=DEV
            )
            svc.start()
            svcs.append(svc)
        try:
            clients = [
                AssignorServiceClient("127.0.0.1", p, timeout_s=180.0)
                for p in ports
            ]
            shards = {ids[0]: _shard(51), ids[1]: _shard(52)}
            # Register both shards, then a converged pass.
            for sid, cl in zip(ids, clients):
                cl.federated_assign(
                    "t0", _rows(shards[sid]), MEMBERS
                )
            r = clients[0].federated_assign(
                "t0", _rows(shards[ids[0]]), MEMBERS
            )
            assert r["federation"]["rung"] == "global"
            sizes = np.array(
                [len(r["assignments"][m]) for m in MEMBERS]
            )
            # Summed capacity [6,2,2,2] -> frac [.5,1/6,1/6,1/6]:
            # the local shard's seats follow the apportionment.
            target = fedsolve.apportion_counts(
                SHARD_P, np.array([0.5, 1 / 6, 1 / 6, 1 / 6])
            )
            np.testing.assert_array_equal(np.sort(sizes)[::-1][:1],
                                          np.sort(target)[::-1][:1])
            assert sizes[0] == target[0]
            assert abs(int(sizes.sum()) - SHARD_P) == 0
            for cl in clients:
                cl.close()
        finally:
            for s in svcs:
                s.stop()




# -- twins: the port's functions against the JAX package's on one input -----


def _twin_shard(seed, P):
    """A Zipf-skewed shard with repeated values (the dedup axis matters)."""
    rng = np.random.default_rng(seed)
    return (rng.zipf(1.4, P) * 97).astype(np.int64)


@pytest.mark.parametrize("seed,P", [(1, 256), (2, 2048), (3, 6000)])
def test_host_helpers_bit_equal_jax(seed, P):
    """shard_summary, shard_dedup (6,000 rows: past the 4,096-value dedup
    cap, so the log-bucketed tail too), apportion_counts: exact."""
    lags = _twin_shard(seed, P)
    valid = np.arange(P) % 7 != 3
    assert fedsolve.shard_summary(lags, valid) == jax_fedsolve.shard_summary(lags, valid)
    scale = max(float(lags[valid].sum()) * 2.5, 1.0) / 8
    for got, want in zip(fedsolve.shard_dedup(lags, valid, scale),
                         jax_fedsolve.shard_dedup(lags, valid, scale)):
        np.testing.assert_array_equal(got, want)
    w = np.random.default_rng(seed).random(8) * (np.arange(8) != 2)
    np.testing.assert_array_equal(fedsolve.apportion_counts(P, w),
                                  jax_fedsolve.apportion_counts(P, w))


@pytest.mark.parametrize("C", [4, 8, 64])
def test_initial_duals_bit_equal_jax(C):
    for got, want in zip(fedsolve.initial_duals(C, device=DEV),
                         jax_fedsolve.initial_duals(C)):
        np.testing.assert_array_equal(got, np.asarray(want))


def _jax_exchange_state(lags, C, rounds):
    """The JAX exchange's duals after ``rounds`` single-shard rounds."""
    scale = max(float(lags.sum()), 1.0) / C
    w = jax_fedsolve.shard_dedup(lags, np.ones(lags.shape[0], bool), scale)
    A, B = jax_fedsolve.initial_duals(C)
    step, prev = 1.0, float("inf")
    for _ in range(rounds):
        load, col = jax_fedsolve.shard_marginals(*w, A, B)
        A, B, step, prev, _ = jax_fedsolve.dual_step(
            A, B, load, col, lags.shape[0] / C, step, prev)
    return w, scale, np.array(A), np.array(B), step, prev


@pytest.mark.parametrize("seed,P,C", [(4, 512, 4), (5, 2048, 8), (6, 4096, 64)])
def test_marginals_and_dual_step_within_f32_tolerance(seed, P, C):
    """The f32 marginals (K3's plain version on the CPU) and one dual step
    on the same duals: within rtol 1e-4 / atol 1e-5 of the JAX package
    (XLA's exp and reduction order are not bit-reproducible); the step
    scale and spread to the same tolerance."""
    lags = _twin_shard(seed, P)
    w, _, A, B, step, prev = _jax_exchange_state(lags, C, 3)
    got = fedsolve.shard_marginals(*w, A, B, device=DEV)
    want = jax_fedsolve.shard_marginals(*w, A, B)
    for g, x in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(x), rtol=1e-4, atol=1e-5)
    load, col = (np.asarray(x, np.float64) for x in want)
    got = fedsolve.dual_step(A, B, load, col, P / C, step, prev, device=DEV)
    want = jax_fedsolve.dual_step(A, B, load, col, P / C, step, prev)
    for g, x in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(x), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("weights", [None, [3.0, 1.0, 1.0, 2.0, 1.0, 1.0, 4.0, 1.0]])
@pytest.mark.parametrize("seed,P", [(7, 600), (8, 2048)])
def test_round_parallel_cap_vec_bit_equal_jax(seed, P, weights):
    """``_round_parallel`` on the same padded arrays and duals, uniform
    floor/ceil or explicit ``cap_vec`` / ``cap_max`` seats: the same choice."""
    import jax.numpy as jnp

    from kafka_lag_based_assignor_tpu.models.sinkhorn import _round_parallel as jax_rp
    from kafka_lag_based_assignor_tpu_torch.models.sinkhorn import _round_parallel
    from kafka_lag_based_assignor_tpu_torch.ops.packing import pad_topic_rows

    C = 8
    lags = _twin_shard(seed, P)
    _, _, A, B, _, _ = _jax_exchange_state(lags, C, 4)
    lags_p, _, valid = pad_topic_rows(lags)
    scale = max(float(lags.sum()), 1.0) / C
    ws = (np.where(valid, lags_p, 0) / scale).astype(np.float32)
    n = int(valid.sum())
    kw, jkw = {}, {}
    if weights is not None:
        cap = fedsolve.apportion_counts(n, weights)
        cap_max = 1 << max(int(cap.max()) - 1, 0).bit_length()
        kw = dict(cap_vec=torch.from_numpy(cap), cap_max=cap_max)
        jkw = dict(cap_vec=jnp.asarray(cap), cap_max=cap_max)
    got = _round_parallel(torch.from_numpy(lags_p), torch.from_numpy(ws),
                          torch.from_numpy(valid), torch.from_numpy(A),
                          torch.from_numpy(B), C, n // C, n % C, **kw)
    want = jax_rp(jnp.asarray(lags_p), jnp.asarray(ws), jnp.asarray(valid),
                  jnp.asarray(A), jnp.asarray(B), C, n // C, n % C, **jkw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if weights is not None:
        np.testing.assert_array_equal(
            np.bincount(got.numpy()[valid], minlength=C), cap)


@pytest.mark.parametrize("capacity", [None, [0.4, 0.1, 0.2, 0.3]])
@pytest.mark.parametrize("seed,P", [(9, 700), (10, 2048)])
def test_round_local_shard_counts_exact_quality_within_2pct(seed, P, capacity):
    """The dual-seeded local rounding against the JAX package's on the same
    duals, scale and base: the counts exactly, and the global quality
    (local totals + the base) within 2 % of the JAX run's."""
    lags = _twin_shard(seed, P)
    _, scale, A, B, _, _ = _jax_exchange_state(lags, C, 6)
    base = np.random.default_rng(seed).random(C).astype(np.float32) * 40.0
    got = fedsolve.round_local_shard(lags, C, A, B, scale, base,
                                     capacity_frac=capacity, device=DEV)
    want = jax_fedsolve.round_local_shard(lags, C, A, B, scale, base,
                                          capacity_frac=capacity)
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    np.testing.assert_array_equal(np.bincount(got[0], minlength=C), np.asarray(want[1]))
    base_lag = base.astype(np.float64) * scale

    def quality(choice):
        totals = np.bincount(choice, weights=lags.astype(np.float64), minlength=C) + base_lag
        return totals.max() / totals.mean()

    assert quality(got[0]) <= quality(np.asarray(want[0])) * 1.02
