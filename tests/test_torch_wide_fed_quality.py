"""The port's federated quality at the wide group's density against the JAX
package's, on the CPU.

Phase 4l's group (200,000 partitions, 20,000 members) has 10 partitions a
member; split over three federated sidecars, each shard holds about 3.3 a
member and is count-balanced on its own, so the federated answer cannot
reach the single-leader ``sinkhorn``'s balance.  Here three JAX sidecars
and three port sidecars (``device="cpu"``) get the same split of 9,000
uniform lags in [0, 10^6) (seed 0) over 900 members, the same density,
with 16 exchange rounds: every answer is at rung ``global`` and
count-balanced, and the port's quality (max over mean member load) is
within 0.5 % of the JAX package's: how far a federated answer at this
density stays from a single leader's is the algorithm's, in either
package (``chip_smoke.py`` phase 4m (e) bounds it at the wide group).

Run as a script, it prints both packages' federated and single-leader
``sinkhorn`` qualities and the exchange's convergence at another shape and
round budget, e.g. at 2,000 members, where the port's K3 takes its column
form on the card::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_wide_fed_quality.py \
        --partitions 20000 --members 2000 --rounds 16 64
"""

import argparse
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kafka_lag_based_assignor_tpu import service as jax_service  # noqa: E402
from kafka_lag_based_assignor_tpu_torch import service  # noqa: E402
from test_torch_fedsolve import _free_ports as free_ports  # noqa: E402
from test_torch_wide_groups import one_torch_thread  # noqa: E402

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

P, C, N, ROUNDS = 9_000, 900, 3, 16


def quality(full, members, assignments) -> float:
    """Max over mean member load of ``assignments`` (member -> [t, pid])."""
    owner = {m: j for j, m in enumerate(members)}
    totals = np.zeros(len(members))
    for m, tps in assignments.items():
        totals[owner[m]] += full[[p for _, p in tps]].sum()
    return float(totals.max() / totals.mean())


def federated_quality(module, full, members, rounds=ROUNDS, **kw):
    """Three sidecars of ``module`` in full mesh, the group split
    round-robin by partition id: every shard registered, then each one's
    ``federated_assign``; returns (the answers, the quality)."""
    P = full.shape[0]
    ports = free_ports(N)
    ids = [f"s{i}" for i in range(N)]
    svcs, clients = [], []
    try:
        for i in range(N):
            peers = ",".join(f"{ids[j]}=127.0.0.1:{ports[j]}" for j in range(N) if j != i)
            svcs.append(module.AssignorService(
                port=ports[i], coalesce_max_batch=1, scrub_interval_ms=0,
                federation_self_id=ids[i], federation_peers=peers,
                federation_rounds=rounds, federation_sync_timeout_s=300.0, **kw).start())
            clients.append(module.AssignorServiceClient(*svcs[i].address, timeout_s=300.0))
        rows = [[[int(p), int(full[p])] for p in range(i, P, N)] for i in range(N)]
        for i in range(N):
            clients[i].federated_assign("t0", rows[i], members)
        out = [clients[i].federated_assign("t0", rows[i], members) for i in range(N)]
    finally:
        for c in clients:
            c.close()
        for s in svcs:
            s.stop()
    merged = {m: [tp for r in out for tp in r["assignments"].get(m, [])] for m in members}
    return out, quality(full, members, merged)


def test_federated_quality_at_ten_rows_a_member_matches_jax():
    full = np.random.default_rng(0).integers(0, 10**6, P)
    members = [f"m{i:04d}" for i in range(C)]
    port_out, port_q = federated_quality(service, full, members, device="cpu")
    _, jax_q = federated_quality(jax_service, full, members)
    for r in port_out:
        assert r["federation"]["rung"] == "global"
        sizes = [len(r["assignments"].get(m, [])) for m in members]
        assert max(sizes) - min(sizes) <= 1 and sum(sizes) == P // N
    assert abs(port_q / jax_q - 1.0) <= 0.005, (port_q, jax_q)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--partitions", type=int, default=20_000)
    ap.add_argument("--members", type=int, default=2_000)
    ap.add_argument("--rounds", type=int, nargs="+", default=[ROUNDS])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    full = np.random.default_rng(args.seed).integers(0, 10**6, args.partitions)
    members = [f"m{i:05d}" for i in range(args.members)]
    topics = {"t0": [[p, int(lag)] for p, lag in enumerate(full)]}
    subs = {m: ["t0"] for m in members}
    leaders = {
        "port": service._solve(topics, subs, "sinkhorn", device="cpu")[0],
        "jax": jax_service._solve(topics, subs, "sinkhorn")[0]}
    for rounds in args.rounds:
        for name, module, kw in (("port", service, {"device": "cpu"}), ("jax", jax_service, {})):
            t0 = time.perf_counter()
            out, q = federated_quality(module, full, members, rounds=rounds, **kw)
            print(json.dumps({
                "package": name, "partitions": args.partitions, "members": args.members,
                "seed": args.seed, "max_rounds": rounds, "quality": q,
                "leader_sinkhorn_quality": quality(full, members, leaders[name]),
                "rungs": [r["federation"]["rung"] for r in out],
                "rounds": [r["federation"]["rounds"] for r in out],
                "converged": [r["federation"]["converged"] for r in out],
                "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
