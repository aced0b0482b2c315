"""Federated multi-cluster assignment (DEPLOYMENT.md "Federated
assignment").

Counterpart of ``kafka_lag_based_assignor_tpu/federated/``: the same
protocol, wire and ladder, so port and JAX sidecars peer with each other;
the device math (:mod:`..ops.fedsolve`) runs on the port's kernels (K3 for
the marginals, the resident refine for the local rounding).

Several sidecars, each co-located with its own Kafka cluster and
holding only its LOCAL lag shard, converge one global assignment by
exchanging consumer-axis duals/marginals — raw per-partition lags never
leave a cluster (the Federated Sinkhorn split, arXiv:2502.07021;
device math in :mod:`..ops.fedsolve`).  This package owns the protocol
and the robustness around it:

* :mod:`.wire` — THE audited serializer for every peer-bound payload
  (lint L019 confines construction here): whitelisted keys, C-bounded
  vectors, and the raw-lag byte audit the bench gate runs on-wire.
* :mod:`.peers` — the coordination layer: per-peer links with circuit
  breakers (utils/watchdog), synchronized dual-exchange rounds inside
  the request's deadline budget, bounded-staleness dual caching with
  monotone epoch + fencing-token rejection, and the degradation ladder
  ``global`` -> ``last_good_global`` -> ``local_only`` that fails open
  to exactly the single-cluster behavior when every peer is gone.
"""

from .peers import (
    FEDERATION_RUNGS,
    FederationCoordinator,
    PeerSpec,
    parse_peer_specs,
)
from .wire import PEER_SYNC_METHOD, assert_lag_free

__all__ = [
    "FEDERATION_RUNGS",
    "FederationCoordinator",
    "PeerSpec",
    "parse_peer_specs",
    "PEER_SYNC_METHOD",
    "assert_lag_free",
]
