"""``python -m kafka_lag_based_assignor_tpu_torch.scenarios`` — run the
port's adversarial fleet from a shell.

Exit code 0 iff every selected scenario stayed inside its envelope;
1 on violations, 2 on usage errors.  ``--json`` writes the fleet
artifact in the layout ``python -m scenarios`` writes — every row
carries its ``reproduce`` command line with the exact seed.
``--device`` picks the sidecars' device (default the card; ``cpu``
runs the plain PyTorch path).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from ..utils import trace as trace_mod
from .corpus import CORPUS, run_fleet


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m kafka_lag_based_assignor_tpu_torch.scenarios",
        description=(
            "adversarial scenario fleet (DEPLOYMENT.md 'Adversarial "
            "scenarios'): composable trace replay against a real "
            "sidecar, gated by per-scenario degradation envelopes"
        ),
    )
    parser.add_argument(
        "--fast", action="store_true",
        help="run only the fast CI subset of the corpus",
    )
    parser.add_argument(
        "--only", nargs="+", metavar="NAME",
        help="run only the named scenario(s)",
    )
    parser.add_argument(
        "--seed", type=int,
        help=(
            "override every selected scenario's seed (reproducing a "
            "CI failure from its artifact row)"
        ),
    )
    parser.add_argument(
        "--json", type=Path, metavar="FILE",
        help="write the fleet artifact (scenario rows + verdicts)",
    )
    parser.add_argument(
        "--trace-json", type=Path, metavar="FILE",
        help=(
            "write one kept anomalous trace (utils/trace tail sampler) "
            "from the run, so every fleet run leaves a reconstructable "
            "causal trace behind"
        ),
    )
    parser.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help=(
            "the sidecars' device (cpu runs the plain PyTorch path); "
            "the cross-axis mesh scenario takes 8 virtual shards of it"
        ),
    )
    parser.add_argument(
        "--list", action="store_true",
        help="list the catalog and exit",
    )
    args = parser.parse_args(argv)

    if args.list:
        for sc in CORPUS:
            planes = ",".join(p.name for p in sc.planes) or "-"
            flags = []
            if sc.fast:
                flags.append("fast")
            if sc.crash_epoch is not None:
                flags.append(f"crash@{sc.crash_epoch}")
            if sc.parallel:
                flags.append("parallel")
            print(
                f"{sc.name:22s} trace={sc.trace:20s} seed={sc.seed} "
                f"planes={planes:30s} [{','.join(flags) or '-'}]"
            )
        return 0

    try:
        fleet = run_fleet(
            fast_only=args.fast, only=args.only, seed=args.seed,
            log=lambda m: print(m, flush=True), device=args.device,
        )
    except KeyError as exc:
        print(f"scenarios: {exc}", file=sys.stderr)
        return 2

    if args.json is not None:
        args.json.write_text(
            json.dumps(fleet, indent=2, default=str), encoding="utf-8"
        )
        print(f"artifact written to {args.json}")

    if args.trace_json is not None:
        coll = trace_mod.collector()
        want = coll.last_anomalous_trace_id
        entries = coll.traces(trace_id=want) if want is not None else []
        args.trace_json.write_text(
            json.dumps(
                {
                    "trace_id": want,
                    "stats": coll.stats(),
                    "entries": entries,
                },
                indent=2, default=str,
            ),
            encoding="utf-8",
        )
        print(
            f"anomalous trace {want or '<none kept>'} written to "
            f"{args.trace_json}"
        )

    failed = [r for r in fleet["scenarios"] if r["violations"]]
    print(
        f"{len(fleet['scenarios'])} scenario(s), "
        f"{len(failed)} failed, {fleet['violations']} violation(s)"
    )
    for row in failed:
        print(f"  {row['scenario']}: {'; '.join(row['violations'])}")
        print(f"    reproduce: {row['reproduce']}")
    return 0 if fleet["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
