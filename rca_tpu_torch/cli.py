"""Command-line interface of the port (the ``analyze`` command of
``rca_tpu.cli``).

``python -m rca_tpu_torch analyze``: one agent or the comprehensive
pipeline over a fixture world → findings JSON, exit 0 when the analysis
completed.  Fixtures: ``--fixture 5svc`` (the faulted hermetic world) or
``--fixture <N>svc`` (a synthetic cascade, e.g. ``50svc``, ``2000svc``).
It runs on the CUDA card unless ``--device cpu`` asks for the CPU.  A live
cluster is not supported yet.
"""

from __future__ import annotations

import argparse
import json
import re
import sys


def _make_client(fixture: str, seed: int = 0, fault_mix: str = "crash"):
    from rca_tpu_torch.cluster.mock_client import MockClusterClient

    if fixture == "5svc":
        from rca_tpu_torch.cluster.fixtures import NS, five_service_world

        return MockClusterClient(five_service_world()), NS
    m = re.fullmatch(r"(\d+)svc", fixture)
    if m:
        from rca_tpu_torch.cluster.generator import synthetic_cascade_world

        world = synthetic_cascade_world(
            int(m.group(1)), n_roots=1, seed=seed, fault_mix=fault_mix,
        )
        return MockClusterClient(world), "synthetic"
    raise SystemExit(f"unknown fixture: {fixture!r} (want 5svc or <N>svc)")


def cmd_analyze(args) -> int:
    from rca_tpu_torch.coordinator import RCACoordinator

    if args.fixture in (None, "", "live"):
        print("rca_tpu_torch: a live cluster is not supported yet; pass "
              "--fixture 5svc or --fixture <N>svc", file=sys.stderr)
        return 2
    client, ns = _make_client(args.fixture, args.seed, args.fault_mix)
    namespace = args.namespace or ns
    coord = RCACoordinator(client, backend=args.backend, device=args.device)
    record = coord.run_analysis(args.type, namespace)
    out = record if args.full else {
        "status": record["status"],
        "summary": record.get("summary", ""),
        "root_causes": record.get("results", {})
        .get("correlated", {})
        .get("root_causes", [])
        if args.type == "comprehensive"
        else record.get("results", {}).get(args.type, {}).get("findings", []),
        **({"error": record["error"]} if "error" in record else {}),
    }
    print(json.dumps(out, indent=None if args.compact else 2, default=str))
    return 0 if record["status"] == "completed" else 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rca_tpu_torch",
        description="Kubernetes root-cause analysis on an NVIDIA GPU",
    )
    sub = p.add_subparsers(dest="command", required=True)
    sp = sub.add_parser("analyze", help="run an analysis")
    sp.add_argument("--fixture", default=None, help="5svc | <N>svc")
    sp.add_argument("--fault-mix", default="crash", dest="fault_mix",
                    help="synthetic fixtures' root fault archetypes: "
                    "crash | mixed | oom | image | config | pending")
    sp.add_argument("--namespace", default=None)
    sp.add_argument("--backend", default=None,
                    choices=("torch", "deterministic"),
                    help="default: $RCA_BACKEND or torch")
    sp.add_argument("--device", default=None,
                    help="cuda | cpu (default: cuda)")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--full", action="store_true",
                    help="print the full record")
    sp.add_argument("--compact", action="store_true",
                    help="single-line JSON")
    sp.add_argument("--type", default="comprehensive",
                    help="comprehensive | resources | metrics | logs | "
                    "events | topology | traces")
    sp.set_defaults(fn=cmd_analyze)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    return args.fn(args)
