"""Adversarial scenario fleet of the PyTorch port: composable trace
replay with gated degradation envelopes (DEPLOYMENT.md "Adversarial
scenarios"), against the port's sidecar.

The repository's ``scenarios/`` (the JAX fleet, which imports JAX)
copied module for module, so the port keeps its own: the same generators and
digests, fault planes, envelopes and catalog; the replay engines boot
the port's :class:`..service.AssignorService` on a ``device`` (None =
the card) and gate the kernel-build delta where JAX gates XLA compiles.

The hardening planes this repo grew — the degraded-mode ladder, SLO
shedding, megabatch coalescing, delta epochs, snapshot recovery, the
resident-state integrity plane — were each proven by targeted tests and
bench probes.  What none of those exercise is the *composition*: a
realistic adversarial workload (hot-partition storms, flapping rosters,
correlated lag waves, zipf tenant mixes) hitting a real wire-level
sidecar while several fault planes fire on a deterministic schedule.
This package is that drill, as a regression gate:

``traces``
    Seeded, fully deterministic workload generators: (scenario name,
    seed) -> a typed per-epoch event stream (lags per stream, roster,
    SLO class, phase tag).  Pinned by digest tests — a generator edit
    that changes the bytes fails loudly.
``compose``
    The fault-schedule composer: declarative per-plane fault events
    (point, mode, epochs) overlaid into ONE ``utils/faults`` injector
    via its exact-schedule API.
``replay``
    The replay engine: drives a real :class:`..service.AssignorService`
    over the wire (line protocol, ephemeral port — never
    engine-internal calls), advancing the injector's epoch clock in
    lockstep, recording per-epoch observables (validity, churn,
    quality ratio, degraded rung, sheds by class, warm-loop builds,
    corruption quarantines) — including a mid-trace crash/restart
    through the snapshot recovery path.
``envelopes``
    Declarative per-scenario degradation envelopes and their
    evaluator: how far the service may degrade under that scenario's
    stress before the gate trips.
``corpus``
    The scenario catalog (trace x fault planes x envelope) and the
    fleet runner behind ``python -m kafka_lag_based_assignor_tpu_torch.
    scenarios`` and ``chip_smoke.py --scenarios``.

Reproducing a failure::

    python -m kafka_lag_based_assignor_tpu_torch.scenarios \
        --only <name> --seed <seed from the artifact> --device cpu
"""

from .compose import FaultEvent, FaultPlane, build_injector  # noqa: F401
from .corpus import CORPUS, get_scenario, run_fleet, run_scenario  # noqa: F401
from .envelopes import Envelope, evaluate  # noqa: F401
from .replay import ReplayResult, replay  # noqa: F401
from .traces import GENERATORS, Trace, generate, trace_digest  # noqa: F401
