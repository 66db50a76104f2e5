"""``python -m rca_tpu_torch.analysis`` / ``python -m rca_tpu_torch lint``:
the port's graftlint CLI (the twin of ``python -m rca_tpu.analysis``).

Exit-code contract (stable for CI):

- **0** — no findings (suppressed/baselined hits do not count); with
  ``--tracecheck``, additionally no second-call compile; with ``--rsan``,
  additionally a clean runtime lock cross-check (no order contradiction,
  no observed race, stress totals exact); with ``--specsan``,
  additionally every observed device→host transfer unifies with the
  contract tables and fits its byte budget; ``--all`` = the rules,
  ``--tracecheck``, ``--rsan`` and ``--specsan`` in one run with a single
  summary;
- **1** — findings (or a tracecheck recompile, or an rsan / specsan
  failure);
- **2** — usage or internal error (unknown rule, malformed baseline,
  ``--changed`` mixed with explicit paths, or a device that does not
  exist).

``--changed`` lints only git-dirty files plus files whose content differs
from the cached fingerprint index under ``.graftlint_torch/`` (refreshed
by every default-scan run); interprocedural rules still see the whole
package, so per-file findings match a full run.  ``--tracecheck`` and
``--specsan`` run on ``--device`` (the CUDA card unless the caller names
the CPU); ``--rsan``'s stress drives the serve scheduler's host path and
touches no device.

``--json`` emits one machine-readable JSON object on stdout and nothing
else.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from rca_tpu_torch.analysis.core import (
    all_rules,
    changed_files,
    default_baseline_path,
    discover_files,
    repo_root,
    run_lint,
    update_index,
    write_baseline,
)

EPILOG = """\
suppressions:
  # graftlint: disable=<rule>[,<rule>]    on the flagged line
  # graftlint: disable-file=<rule>        anywhere in the file
  (the rule name `all` disables every rule)

baseline:
  accepted legacy hits live in rca_tpu_torch/analysis/baseline.json as
  content fingerprints; --write-baseline regenerates it from the current
  findings (policy: violations get FIXED, not baselined; it ships empty)
"""


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rca_tpu_torch lint",
        description=("graftlint for the PyTorch port: static analysis — "
                     "tick-sync and fetch-seam contracts, kernel "
                     "dispatch, RNG, lock, thread and env discipline, "
                     "races and lock order, swallowed faults — with the "
                     "runtime recompile, lock-sanitizer and fetch-budget "
                     "checks"),
        epilog=EPILOG,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("paths", nargs="*",
                   help="files/dirs to scan (default: the repo scan set)")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule subset (see --list-rules)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable JSON on stdout (sole output)")
    p.add_argument("--baseline", default=None,
                   help="baseline file (default: rca_tpu_torch/analysis/"
                   "baseline.json)")
    p.add_argument("--no-baseline", action="store_true",
                   help="report baselined hits too")
    p.add_argument("--write-baseline", action="store_true",
                   help="accept all current findings into the baseline")
    p.add_argument("--list-rules", action="store_true",
                   help="print the registered rules and exit")
    p.add_argument("--tracecheck", action="store_true",
                   help="also call the public engine entry points twice "
                   "and fail on a second-call compile")
    p.add_argument("--changed", action="store_true",
                   help="incremental: lint only git-dirty files and "
                   "files whose content differs from the cached "
                   ".graftlint_torch/ fingerprint index")
    p.add_argument("--rsan", action="store_true",
                   help="also run the gravelock runtime cross-check: a "
                   "sanitized multi-thread stress whose observed lock "
                   "orders and access pairs must agree with the static "
                   "concurrency model")
    p.add_argument("--specsan", action="store_true",
                   help="also run the fetch-budget cross-check: a seeded "
                   "engine session + serve selftest with both entries of "
                   "engine.fetch instrumented; observed transfer shapes/"
                   "dtypes/bytes must unify with the FETCH_BUDGETS "
                   "contract tables")
    p.add_argument("--all", action="store_true", dest="run_all",
                   help="the full gate: default rules + --tracecheck + "
                   "--rsan + --specsan in one run, one summary, one "
                   "exit code")
    p.add_argument("--device", default=None,
                   help="device of --tracecheck and --specsan (default: "
                   "the CUDA card; 'cpu' for the plain versions)")
    p.add_argument("--root", default=None, help=argparse.SUPPRESS)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    root = args.root or repo_root()
    if args.run_all:
        args.tracecheck = args.rsan = args.specsan = True

    if args.list_rules:
        rules = all_rules()
        if args.as_json:
            print(json.dumps({
                name: {"summary": r.summary, "why": r.why}
                for name, r in rules.items()
            }, indent=2))
        else:
            for name, r in rules.items():
                print(f"{name:18s} {r.summary}")
        return 0

    rules = ([r.strip() for r in args.rules.split(",") if r.strip()]
             if args.rules else None)
    paths = args.paths or None
    changed: Optional[List[str]] = None
    if args.changed:
        if paths:
            print("graftlint: error: --changed takes no explicit paths",
                  file=sys.stderr)
            return 2
        changed = changed_files(root)
        paths = changed
    try:
        if changed is not None and not changed:
            # nothing changed: vacuously clean, no scan at all
            from rca_tpu_torch.analysis.core import LintResult

            result = LintResult(
                findings=[], suppressed=0, baselined=0,
                stale_baseline=[], files_scanned=0, wall_ms=0.0,
                per_rule_ms={},
            )
        else:
            result = run_lint(
                root=root, rules=rules,
                baseline_path=args.baseline,
                paths=paths,
                use_baseline=not args.no_baseline,
            )
    except (KeyError, FileNotFoundError, ValueError) as exc:
        print(f"graftlint: error: {exc}", file=sys.stderr)
        return 2
    # refresh the fingerprint index for whatever this run scanned (the
    # default set on full runs, the changed subset on --changed)
    if not args.paths:
        update_index(root, changed if changed is not None
                     else discover_files(root))

    if args.write_baseline:
        bpath = args.baseline or default_baseline_path(root)
        write_baseline(bpath, result.findings)
        if not args.as_json:
            print(f"graftlint: wrote {len(result.findings)} entr"
                  f"{'y' if len(result.findings) == 1 else 'ies'} to "
                  f"{bpath}")
        return 0

    trace = rsan_report = specsan_report = None
    try:
        if args.tracecheck:
            from rca_tpu_torch.analysis.tracecheck import run_tracecheck

            trace = run_tracecheck(device=args.device)
        if args.rsan:
            from rca_tpu_torch.analysis.concurrency.crosscheck import (
                run_rsan_crosscheck,
            )

            # the sanitizer is process-global: it runs before specsan,
            # never beside it
            rsan_report = run_rsan_crosscheck(root=root)
        if args.specsan:
            from rca_tpu_torch.analysis.dataplane.specsan import run_specsan
            from rca_tpu_torch.config import env_int

            # specsan judges the port's own code, wherever --root points
            specsan_report = run_specsan(
                seed=env_int("RCA_SPECSAN_SEED", 0, 0, 2**31 - 1),
                n_requests=env_int("RCA_SPECSAN_REQUESTS", 8, 1, 10_000),
                device=args.device,
            )
    except (RuntimeError, ValueError) as exc:
        # a device that does not exist: the checks never move elsewhere
        print(f"graftlint: error: {exc}", file=sys.stderr)
        return 2

    if args.as_json:
        out = result.to_dict()
        if changed is not None:
            out["changed_files"] = changed
        if trace is not None:
            out["tracecheck"] = trace
            out["clean"] = out["clean"] and trace["ok"]
        if rsan_report is not None:
            out["rsan"] = rsan_report
            out["clean"] = out["clean"] and rsan_report["ok"]
        if specsan_report is not None:
            from rca_tpu_torch.analysis.dataplane.specsan import (
                confirm_findings,
            )

            confirm_findings(out["findings"], specsan_report)
            out["specsan"] = specsan_report
            out["clean"] = out["clean"] and specsan_report["ok"]
        print(json.dumps(out))
        return 0 if out["clean"] else 1

    for f in result.findings:
        print(f"{f.path}:{f.line}: [{f.rule}] {f.message}")
        if f.snippet:
            print(f"  | {f.snippet}")
    for e in result.stale_baseline:
        print(f"graftlint: stale baseline entry {e['rule']} @ {e['path']} "
              f"({e['fingerprint']}) — the code it excused is gone; "
              "remove it (or --write-baseline)")
    counts = (f"{len(result.findings)} finding(s), "
              f"{result.suppressed} suppressed, "
              f"{result.baselined} baselined, "
              f"{result.files_scanned} files in "
              f"{result.wall_ms:.0f} ms")
    if changed is not None:
        print(f"graftlint: --changed scanned {len(changed)} file(s)")
    if trace is not None:
        for e in trace["entries"]:
            status = "ok" if e["ok"] else (
                f"RECOMPILED {e['recompiles']}x ({', '.join(e['recompiled'])})"
            )
            print(f"tracecheck: {e['entry']}: {status} "
                  f"[warmup {e['warmup_compiles']} compiles, "
                  f"{e['wall_ms']:.0f} ms]")
    if rsan_report is not None:
        r = rsan_report
        print(f"rsan: {'ok' if r['ok'] else 'FAILED'} "
              f"[{r['acquires']} acquires over "
              f"{len(r['locks_observed'])} locks "
              f"({len(r['multi_thread_locks'])} multi-thread), "
              f"{len(r['observed_edges'])} order edges, "
              f"{len(r['contradictions'])} contradiction(s), "
              f"{len(r['races_observed'])} race(s) observed, "
              f"{r['wall_ms']:.0f} ms]")
        for c in r["contradictions"]:
            print(f"rsan: ORDER CONTRADICTION {c['edge'][0]} -> "
                  f"{c['edge'][1]} (threads {', '.join(c['threads'])}; "
                  f"chain {' -> '.join(c['chain'])})")
        for race in r["races_observed"]:
            predicted = ("statically predicted" if
                         race["statically_predicted"]
                         else "NOT statically predicted — model gap")
            print(f"rsan: OBSERVED RACE {race['owner']}.{race['attr']} "
                  f"between {', '.join(race['threads'])} ({predicted})")
    if specsan_report is not None:
        s = specsan_report
        print(f"specsan: {'ok' if s['ok'] else 'FAILED'} "
              f"[{s['fetches']} fetches over "
              f"{len(s['surfaces_confirmed'])} budgeted surface(s), "
              f"{len(s['violations'])} violation(s), "
              f"serve {'ok' if s['serve']['ok'] else 'FAILED'}, "
              f"{s['wall_ms']:.0f} ms]")
        for v in s["violations"]:
            detail = {
                "unmatched_roles": "leaves do not unify with declared "
                                   "roles",
                "over_budget": "transfer exceeds the declared byte "
                               "budget",
                "unaudited": "a transfer outside the allowlisted "
                             "functions of an audited module",
            }.get(v["kind"], v["kind"])
            print(f"specsan: {v['kind'].upper()} at {v['surface']}: "
                  f"{detail} (shapes {v['shapes']}, dtypes "
                  f"{v['dtypes']}, {v['nbytes']} B)")
    clean = (result.clean and (trace is None or trace["ok"])
             and (rsan_report is None or rsan_report["ok"])
             and (specsan_report is None or specsan_report["ok"]))
    print(f"graftlint: {'clean' if clean else 'FAILED'} ({counts})")
    return 0 if clean else 1


if __name__ == "__main__":
    sys.exit(main())
