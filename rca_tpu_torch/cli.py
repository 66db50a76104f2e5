"""Command-line interface of the port (the commands of ``rca_tpu.cli``
that the port has).

- ``python -m rca_tpu_torch analyze``: one agent or the comprehensive
  pipeline over a fixture world → findings JSON, exit 0 when the analysis
  completed (``RCA_EXPLAIN=1`` adds the causelens ``provenance`` block;
  ``--provider``, ``--llm-agents`` and ``--log-dir`` as for ``chat``);
- ``python -m rca_tpu_torch chat``: one chat turn (structured response
  and suggestions); ``--investigation new|<id>`` persists it in the
  investigation store under ``--log-dir``;
- ``python -m rca_tpu_torch report``: the comprehensive analysis as a
  markdown report (``--out`` writes it to a file);
- ``python -m rca_tpu_torch suggest``: run one suggestion action (JSON);
- ``python -m rca_tpu_torch why``: the causelens blame tree of a stored
  investigation's latest explained ranking;
- ``python -m rca_tpu_torch investigations``: list the stored
  investigations, or show one (``--id``);
- ``python -m rca_tpu_torch hypotheses``: the what-if-healthy batch over
  the top candidates, every hypothesis a lane of one batched analysis;
- ``python -m rca_tpu_torch kernels``: the kernel registry's table, each
  row with its engaged kernel, why, its timings, its cost (``--no-cost``,
  ``--cost-max-pad``) and every candidate's eligibility;
- ``python -m rca_tpu_torch profile``: a ``torch.profiler`` trace of N
  live ticks over a synthetic world, and the capture's summary;
- ``python -m rca_tpu_torch stream``: the live streaming session, one
  JSON line per poll (``--pipeline-depth 2`` overlaps each tick's device
  work with the next poll's capture);
- ``python -m rca_tpu_torch serve``: the serving scheduler in one process
  — ``--selftest`` checks its contract (every request answered or shed,
  coalesced rankings bitwise equal to solo ones; ``--chaos`` injects
  seeded dispatch/fetch faults, ``--replicas`` / ``--replica-mix`` /
  ``--kill-replica`` run the pool), ``--federation N`` runs the
  cross-process federation's selftest over N worker processes
  (``--kill-worker`` SIGKILLs one mid-wave, ``--bind-external`` joins
  them through the host's non-loopback address), ``--listen HOST:PORT``
  serves it over HTTP through the gateway until SIGTERM (in front of a
  federation of N workers with ``--federation N``), without any of them
  a synthetic ``<N>svc`` load prints the per-tenant metrics;
- ``python -m rca_tpu_torch ingest``: the federated capture fleet:
  ingest-class worker processes own synthetic clusters' columnar
  mirrors, one owner each, and the coordinator's cluster table arbitrates
  their ticks exactly once;
- ``python -m rca_tpu_torch canary``: the replay-driven regression
  canary (sample, mint, replay against a candidate; exit 1 names the
  bisected tick); ``--listen-url`` samples through a running gateway;
- ``python -m rca_tpu_torch fleet URL``: a federation gateway's worker
  table from its ``/healthz`` (exit 1 against a gateway with no fleet);
- ``python -m rca_tpu_torch replay``: re-drive the engine from a flight
  recording (``stream --record`` / ``serve --record`` / ``chaos
  --record``) and check parity tick for tick or request for request;
  ``--seek``, ``--bisect``, ``--mint`` and ``--trace-out``;
- ``python -m rca_tpu_torch chaos``: the seeded chaos soak of the live
  session (five fault classes) and, from 100 ticks, the federation's
  process-level legs (``process_kill``, ``worker_hang``,
  ``coordinator_partition``, ``ingest_death``), exit 0 only when its
  contract holds;
- ``python -m rca_tpu_torch train``: fit the propagation weights on
  synthetic cascades, gate them (``shippability_report``) and write the
  JSON checkpoint that ``RCA_WEIGHTS`` loads;
- ``python -m rca_tpu_torch ui``: the Streamlit app
  (:mod:`rca_tpu_torch.ui.app`) on ``--port`` over ``--device``; exit 1
  when ``streamlit`` is not installed;
- ``python -m rca_tpu_torch lint``: graftlint over the port (the rules,
  ``--tracecheck``, ``--specsan``, ``--all``); every argument goes to
  :mod:`rca_tpu_torch.analysis.__main__`, with its exit codes.

``RCA_KERNEL`` forces a kernel registry row for ``analyze``,
``hypotheses`` and ``stream``: ``torch``, ``kernels``, ``quantized`` or
``doubling``.

Fixtures: ``--fixture 5svc`` (the faulted hermetic world) or ``--fixture
<N>svc`` (a synthetic cascade, e.g. ``50svc``, ``2000svc``); omit
``--fixture`` (or pass ``live``) for a live cluster through
:class:`rca_tpu_torch.cluster.k8s_client.K8sApiClient` (kubeconfig or
``kubectl``; with neither, the analysis reports the degraded, empty
capture).  Every command runs on the CUDA card unless ``--device cpu``
asks for the CPU.  ``analyze``, ``hypotheses`` and ``stream`` build their
engine through ``make_engine``: node-sharded when ``RCA_SHARD`` asks for
it or more than one CUDA device is visible.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from typing import Optional


def _make_client(fixture: Optional[str], seed: int = 0,
                 fault_mix: str = "crash"):
    from rca_tpu_torch.cluster.mock_client import MockClusterClient

    if fixture in (None, "", "live"):
        from rca_tpu_torch.cluster.k8s_client import K8sApiClient

        return K8sApiClient(), None
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
    raise SystemExit(f"unknown fixture: {fixture!r} (want 5svc, <N>svc, live)")


def _log_dir(args) -> str:
    from rca_tpu_torch.config import log_dir

    return getattr(args, "log_dir", None) or log_dir()


def _coordinator(args):
    """The coordinator of ``analyze``, ``chat``, ``report`` and
    ``suggest``: its cluster client from ``--fixture``, an LLM client over
    ``--provider`` whose prompts are logged under ``<log-dir>/prompts``,
    and ``--backend`` / ``--llm-agents`` / ``--device``."""
    from rca_tpu_torch.coordinator import RCACoordinator
    from rca_tpu_torch.llm import LLMClient, make_provider
    from rca_tpu_torch.obslog import get_logger

    client, ns = _make_client(args.fixture, args.seed, args.fault_mix)
    namespace = args.namespace or ns or "default"
    prompt_logger = get_logger(_log_dir(args) + "/prompts")
    llm = LLMClient(
        provider=make_provider(args.provider),
        log_fn=prompt_logger.as_log_fn(namespace=namespace),
    )
    coord = RCACoordinator(client, llm_client=llm, backend=args.backend,
                           use_llm_agents=args.llm_agents,
                           device=args.device)
    return coord, namespace


def cmd_analyze(args) -> int:
    coord, namespace = _coordinator(args)
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


def cmd_hypotheses(args) -> int:
    """Counterfactual hypothesis batch: for each of the analysis's top
    candidates, score a what-if-it-were-healthy feature set, all of them
    lanes of ONE batched analysis (``GraphEngine.analyze_batch``).  A
    candidate's SUPPORT is the anomaly its removal leaves unexplained
    elsewhere: muting a true root frees its victims from explain-away
    suppression, so their scores rise; muting a victim changes little.
    Prints the candidates ranked by support."""
    import numpy as np

    from rca_tpu_torch.cluster.snapshot import ClusterSnapshot
    from rca_tpu_torch.engine import make_engine
    from rca_tpu_torch.features.extract import extract_features
    from rca_tpu_torch.graph.build import service_dependency_edges

    client, ns = _make_client(args.fixture, args.seed, args.fault_mix)
    namespace = args.namespace or ns or "default"
    snap = ClusterSnapshot.capture(client, namespace)
    fs = extract_features(snap)
    src, dst = service_dependency_edges(snap, fs)
    engine = make_engine(device=args.device)
    base = engine.analyze_features(fs, src, dst, k=args.candidates)
    cands = [r["component"] for r in base.ranked[: args.candidates]]
    indent = None if args.compact else 2
    if not cands:
        print(json.dumps({
            "namespace": namespace, "engine": base.engine,
            "batch_width": 0, "hypotheses": [],
            "note": "no ranked candidates (empty namespace?)",
        }, indent=indent))
        return 0
    name_to_idx = {n_: i for i, n_ in enumerate(base.service_names)}
    feats = np.asarray(fs.service_features, np.float32)
    batch = np.repeat(feats[None], len(cands), axis=0)
    for b, comp in enumerate(cands):
        batch[b, name_to_idx[comp]] = 0.0     # the counterfactual: healthy
    results = engine.analyze_batch(batch, src, dst,
                                   names=base.service_names, k=args.top)
    base_total = float(np.sum(base.score))
    out = []
    for comp, res in zip(cands, results):
        i = name_to_idx[comp]
        # support: anomaly left unexplained elsewhere once comp is healthy
        others = float(np.sum(np.delete(res.score, i)))
        base_others = float(base_total - base.score[i])
        out.append({
            "candidate": comp,
            "base_score": round(float(base.score[i]), 4),
            "support": round(others - base_others, 4),
            "counterfactual_top": res.top_components(3),
        })
    out.sort(key=lambda r: -r["support"])
    print(json.dumps({
        "namespace": namespace,
        "engine": results[0].engine,
        "batch_width": len(cands),
        "batch_latency_ms_per_hypothesis": round(results[0].latency_ms, 3),
        "hypotheses": out,
    }, indent=indent))
    return 0


def cmd_chat(args) -> int:
    """One chat turn; with ``--investigation`` the turn is a persisted part
    of that conversation (``new`` creates one): prior accumulated findings
    feed the prompt, and the messages, suggestions and findings land back
    in the store, the first turn titling it."""
    coord, namespace = _coordinator(args)
    store = inv = None
    if args.investigation:
        from rca_tpu_torch.store import InvestigationStore

        store = InvestigationStore(root=_log_dir(args))
        inv = store.get_investigation(args.investigation)
        if inv is None and args.investigation != "new":
            print(json.dumps(
                {"error": f"no investigation {args.investigation}"}
            ))
            return 1
        if inv is None:
            inv = store.create_investigation(
                args.query[:60], namespace=namespace
            )
    out = coord.process_user_query(
        args.query, namespace,
        previous_findings=(inv or {}).get("accumulated_findings"),
    )
    if store is not None:
        iid = inv["id"]
        first_turn = len(inv.get("conversation", [])) == 0
        store.record_chat_turn(iid, args.query, out)
        if first_turn:
            store.set_title(
                iid, coord.generate_summary_from_query(args.query, out)
            )
        out["investigation_id"] = iid
    if not args.full:
        out.pop("cluster_state", None)
    print(json.dumps(out, indent=None if args.compact else 2, default=str))
    return 0


def cmd_report(args) -> int:
    """The comprehensive analysis rendered as the markdown report."""
    coord, namespace = _coordinator(args)
    record = coord.run_analysis("comprehensive", namespace)
    if record["status"] != "completed":
        print(json.dumps({"error": record.get("error", "analysis failed")}))
        return 1
    from rca_tpu_torch.ui.render import report_markdown

    md = report_markdown(record["results"])
    if args.out:
        with open(args.out, "w") as f:
            f.write(md)
        print(json.dumps({"written": args.out, "bytes": len(md)}))
    else:
        print(md)
    return 0


def cmd_suggest(args) -> int:
    coord, namespace = _coordinator(args)
    action = json.loads(args.action)
    out = coord.process_suggestion(action, namespace)
    print(json.dumps(out, indent=None if args.compact else 2, default=str))
    return 0


def cmd_why(args) -> int:
    """The stored causelens provenance of an investigation rendered as its
    blame tree (evidence channels → blame edges → ranked service).  It
    lands in the store when an explained serve request names the
    investigation; without it, the newest chat turn that carried one."""
    from rca_tpu_torch.observability.causelens import render_blame_tree
    from rca_tpu_torch.store import InvestigationStore

    store = InvestigationStore(root=_log_dir(args))
    inv = store.get_investigation(args.investigation_id)
    if inv is None:
        print(json.dumps(
            {"error": f"no investigation {args.investigation_id}"}
        ))
        return 1
    provenance = inv.get("provenance")
    if provenance is None:
        # fall back to the newest chat turn that carried one
        for msg in reversed(inv.get("conversation", []) or []):
            content = msg.get("content")
            if isinstance(content, dict):
                rd = content.get("response_data") or {}
                cand = (
                    content.get("provenance")
                    or rd.get("provenance")
                    or (rd.get("correlated") or {}).get("provenance")
                )
                if cand is not None:
                    provenance = cand
                    break
    if provenance is None:
        hint = {
            "error": f"investigation {args.investigation_id} carries no "
            "provenance block",
            "hint": "serve the analysis with explain=true (wire: "
            "?explain=1) naming this investigation_id, or run the "
            "correlate flow with RCA_EXPLAIN=1",
        }
        if inv.get("recording_ref"):
            hint["recording_ref"] = inv["recording_ref"]
            hint["hint"] += (
                "; the investigation has a recording — `replay "
                "--explain` can recompute attributions from the tape "
                "when it was recorded with RCA_EXPLAIN=1"
            )
        print(json.dumps(hint, indent=None if args.compact else 2))
        return 1
    if args.json:
        print(json.dumps(provenance, indent=None if args.compact else 2))
        return 0
    print(f"investigation {args.investigation_id} · "
          f"{inv.get('title', '')}".rstrip(" ·"))
    print(render_blame_tree(provenance))
    return 0


def cmd_investigations(args) -> int:
    from rca_tpu_torch.store import InvestigationStore

    store = InvestigationStore(root=_log_dir(args))
    if args.id:
        inv = store.get_investigation(args.id)
        if inv is None:
            print(json.dumps({"error": f"no investigation {args.id}"}))
            return 1
        print(json.dumps(inv, indent=2, default=str))
    else:
        print(json.dumps(store.list_investigations(), indent=2, default=str))
    return 0


def _ints(raw: str, flag: str):
    out = []
    for part in (raw or "").split(","):
        part = part.strip()
        if not part:
            continue
        try:
            out.append(int(part))
        except ValueError:
            raise SystemExit(f"{flag} expects comma-separated ints, got "
                             f"{part!r}")
    return out


def cmd_profile(args) -> int:
    """A ``torch.profiler`` capture around ``--ticks`` polls of a live
    session over a synthetic world (``observability/profile.py``): the
    Chrome trace under ``--out``, the summary (the row each shape engaged
    included) as JSON on stdout."""
    from rca_tpu_torch.observability.profile import profile_ticks

    summary = profile_ticks(args.out, ticks=args.ticks,
                            services=args.services, seed=args.seed,
                            device=args.device)
    print(json.dumps(summary, indent=None if args.compact else 2))
    return 0


def cmd_kernels(args) -> int:
    """The kernel registry as a table: one row per ``(variant, n_pad,
    e_pad)`` on the device, with the engaged row, why it won, the timings
    of the race and the row's cost (the model's operations and bytes of
    the canonical call, the allocator's peak and the output bytes of one
    run of the winner; ``--no-cost`` skips the run, ``--cost-max-pad``
    bounds it).  ``--services`` (paired with ``--edges``) resolves the
    dense and the attribution rows of those graph sizes first;
    ``--explain`` prints every candidate per row: engaged, its
    eligibility reason, or the timing it lost with, and the form of a
    dense row's recursions or of a sharded row's front and recursions
    (``--sp``: over that many logical shards of the device; with
    ``--json`` under ``shard_steps``)."""
    from rca_tpu_torch.config import KERNELS, RCAConfig, bucket_for
    from rca_tpu_torch.engine.registry import (
        get_registry,
        kernel_table,
        layout_note,
        steps_note,
    )
    from rca_tpu_torch.engine.runner import resolve_device
    from rca_tpu_torch.parallel.sharded import (
        shard_steps_form,
        shard_steps_note,
    )

    device = resolve_device(args.device)
    reg = get_registry()
    buckets = RCAConfig().shape_buckets
    services = _ints(args.services, "--services")
    edges = _ints(args.edges, "--edges")
    for i, n in enumerate(services):
        e = edges[i] if i < len(edges) else max(1, int(n * 2.5))
        for variant in ("dense", "attribution"):
            reg.resolve(bucket_for(n + 1, buckets),
                        e_pad=bucket_for(e, buckets), variant=variant,
                        device=device)
        if args.sp:
            # the sharded row at the node tier rounded up to sp shards,
            # with the edges spread evenly over them
            n_pad = -(-bucket_for(n + 1, buckets) // args.sp) * args.sp
            reg.resolve(n_pad, e_pad=bucket_for(-(-e // args.sp), buckets),
                        variant="sharded", device=device)
    rows = kernel_table(ensure_cost=not args.no_cost,
                        cost_max_pad=args.cost_max_pad)
    if args.json:
        out = {"rows": rows}
        if args.sp:
            # the sharded plan's recursions over sp logical shards here
            out["shard_steps"] = {
                "sp": args.sp, "form": shard_steps_form([device] * args.sp),
                "note": shard_steps_note(args.sp, device)}
        print(json.dumps(out, indent=None if args.compact else 2))
        return 0

    def fmt(x):
        if x is None:
            return "-"
        return f"{x:.4g}" if isinstance(x, float) else str(x)

    cols = ("n_pad", "e_pad", "variant", "backend", "winner", "source",
            "layout", "t_torch_ms", "t_win_ms", "flops", "bytes",
            "peak_temp", "output")
    table = [cols]
    for row in rows:
        timings = row["timings_ms"]
        cost = row["cost"] or {}
        # attribution rows time the whole causelens attribution, under
        # "attribution" rather than the winner's name
        t_win = timings.get("attribution" if row["variant"] == "attribution"
                            else row["winner"])
        table.append((str(row["n_pad"]), fmt(row["e_pad"]), row["variant"],
                      row["backend"], row["winner"], row["source"],
                      row["layout"], fmt(timings.get("torch")), fmt(t_win),
                      fmt(cost.get("flops")), fmt(cost.get("bytes_accessed")),
                      fmt(cost.get("peak_temp_bytes")),
                      fmt(cost.get("output_bytes"))))
    widths = [max(len(r[i]) for r in table) for i in range(len(cols))]
    for i, r in enumerate(table):
        print("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())
        if i == 0:
            print("  ".join("-" * w for w in widths))
    if args.explain:
        for row in rows:
            print(f"\n{row['variant']} n_pad={row['n_pad']} "
                  f"e_pad={fmt(row['e_pad'])}: winner={row['winner']} "
                  f"({row['source']}), layout={row['layout']}")
            timings = row["timings_ms"]
            for k in KERNELS:
                elig = row["eligible"].get(k)
                if k == row["winner"]:
                    t = timings.get(k)
                    detail = "engaged" + (f" ({t:.4g} ms)" if t else "")
                elif elig is not True:
                    detail = f"ineligible: {elig}"
                elif k in timings:
                    detail = (f"lost the timing: {timings[k]:.4g} ms vs "
                              f"{fmt(timings.get(row['winner']))} ms")
                else:
                    detail = f"not raced (decision source: {row['source']})"
                print(f"  {k:8s} {detail}")
            if row["variant"] == "dense":
                steps = steps_note(row["n_pad"], row["e_pad"], device)
                print(f"  steps    {steps}")
            elif row["variant"] == "sharded" and args.sp:
                print(f"  steps    {shard_steps_note(args.sp, device)}")
            note = layout_note(row["variant"], row["layout"])
            if note:
                print(f"  note     the reference declines its segscan row "
                      f"({note}); the seg steps here reduce the same "
                      f"sorted edges under every layout")
    return 0


def cmd_stream(args) -> int:
    """Poll-driven live streaming: one JSON line per tick, with the
    reference's keys and its conditional channels (``degraded``,
    ``sanitized_rows``, ``degradation_rung``, and at depth >= 2
    ``pipeline_depth`` / ``result_lag`` / ``pipeline_fill``).  Exits 1
    when a tick degraded (it may have served a stale ranking)."""
    import time

    from rca_tpu_torch.engine import LiveStreamingSession, make_engine

    client, ns = _make_client(args.fixture, args.seed, args.fault_mix)
    recorder = None
    if args.record:
        from rca_tpu_torch.replay import Recorder

        recorder = Recorder(args.record, mode="stream")
    live = LiveStreamingSession(
        client, args.namespace or ns or "default", k=args.top,
        engine=make_engine(device=args.device),
        pipeline_depth=args.pipeline_depth, recorder=recorder,
    )
    degraded = 0
    for i in range(args.ticks):
        out = live.poll()
        line = {
            "tick": out["tick"],
            "latency_ms": round(out["latency_ms"], 3),
            "capture_ms": out["capture_ms"],
            "quiet": out.get("quiet", False),
            "changed_rows": out["changed_rows"],
            "upload_rows": out["upload_rows"],
            "resynced": out["resynced"],
            "ranked": out["ranked"],
        }
        # the resilience channel: printed only when something degraded
        health = out.get("health", {})
        if out.get("degraded"):
            line["degraded"] = True
            degraded += 1
        if health.get("sanitized_rows"):
            line["sanitized_rows"] = health["sanitized_rows"]
        if health.get("degradation"):
            line["degradation_rung"] = health["degradation_rung"]
        # the pipeline channel: only at depth >= 2
        if health.get("pipeline_depth", 1) > 1:
            line["pipeline_depth"] = health["pipeline_depth"]
            line["result_lag"] = health["result_lag"]
            if health.get("pipeline_fill"):
                line["pipeline_fill"] = True
        print(json.dumps(line, default=str), flush=True)
        if args.interval > 0 and i + 1 < args.ticks:
            time.sleep(args.interval)
    if recorder is not None:
        recorder.close()
        print(json.dumps({
            "recording": recorder.path,
            "ticks_recorded": recorder.ticks_recorded,
            "bytes": recorder.bytes_written,
        }), file=sys.stderr)
    if degraded:
        print(f"rca_tpu_torch: {degraded} of {args.ticks} ticks degraded",
              file=sys.stderr)
        return 1
    return 0


def _parse_autoscale(spec: str):
    """``MIN:MAX`` → (min, max) with loud validation."""
    m = re.fullmatch(r"(\d+):(\d+)", (spec or "").strip())
    if not m:
        raise SystemExit(
            f"--autoscale wants MIN:MAX (e.g. 2:8), got {spec!r}"
        )
    mn, mx = int(m.group(1)), int(m.group(2))
    if not 1 <= mn <= mx:
        raise SystemExit(
            f"--autoscale {spec!r}: need 1 <= MIN <= MAX"
        )
    return mn, mx


def cmd_serve(args) -> int:
    """The serving scheduler.  ``--selftest`` runs the end-to-end contract
    check (mixed-tenant requests over three shape buckets, concurrent
    submitters, deadline sheds, coalesced-vs-solo bit parity) and exits 0
    only when the contract holds.  Without it, a synthetic load over a
    ``<N>svc`` graph prints throughput, the per-tenant metrics and the
    plane's kernelscope summary (the registry row that served the shape);
    it exits 0 only when every request was served ok.  ``--listen``
    serves over the wire instead (:func:`_serve_listen`).  ``--autoscale
    MIN:MAX`` alone runs the load-ramp soak: a thread fleet on one engine
    on ``--device`` scales MIN→MAX→MIN under continuous traffic; exit 0
    only when every request is terminal, none completed twice and the
    windowed queue p99 stayed bounded through both transitions.
    ``--federation N`` (or ``--kill-worker``) runs the cross-process
    selftest: N worker processes on ``--device``, wire load, optionally
    one SIGKILLed mid-wave; exit 0 only when every request is terminal,
    every ok ranking is bitwise a solo analysis in this process and no
    request completed twice."""
    import time

    import numpy as np

    from rca_tpu_torch.config import ServeConfig

    overrides = {
        k: v for k, v in (
            ("max_batch", args.max_batch),
            ("max_wait_us", args.max_wait_us),
            ("queue_cap", args.queue_cap),
            ("replicas", args.replicas),
            ("replica_mix", args.replica_mix),
        ) if v is not None
    }
    if args.no_steal:
        overrides["steal"] = False
    config = ServeConfig.from_env(**overrides)
    if args.listen:
        return _serve_listen(args, config)
    indent = None if args.compact else 2
    if args.autoscale and args.federation is None:
        from rca_tpu_torch.serve.autoscale import run_scale_ramp_soak

        mn, mx = _parse_autoscale(args.autoscale)
        summary = run_scale_ramp_soak(
            seed=args.seed, min_workers=mn, max_workers=mx,
            config=config, device=args.device,
        )
        print(json.dumps(summary, indent=indent, default=str))
        return 0 if summary["ok"] else 1
    if args.federation is not None or args.kill_worker:
        from rca_tpu_torch.serve.federation import federation_selftest

        summary = federation_selftest(
            workers=args.federation or 3,
            n_requests=args.requests,
            seed=args.seed,
            kill_worker=args.kill_worker,
            submitters=args.submitters,
            config=config,
            bind_external=args.bind_external,
            device=args.device,
        )
        print(json.dumps(summary, indent=indent, default=str))
        return 0 if summary["ok"] else 1
    if args.selftest:
        from rca_tpu_torch.serve import serve_selftest

        summary = serve_selftest(
            n_requests=args.requests, seed=args.seed, chaos=args.chaos,
            config=config, submitters=args.submitters,
            replicas=config.replicas, replica_mix=config.replica_mix,
            kill_replica=args.kill_replica, device=args.device,
        )
        print(json.dumps(summary, indent=indent, default=str))
        return 0 if summary["ok"] else 1

    from rca_tpu_torch.cluster.generator import synthetic_cascade_arrays
    from rca_tpu_torch.engine import make_engine
    from rca_tpu_torch.engine.runner import resolve_device
    from rca_tpu_torch.parallel.mesh import visible_devices
    from rca_tpu_torch.serve import ServeClient, ServeLoop, ServePool

    m = re.fullmatch(r"(\d+)svc", args.fixture or "500svc")
    if not m:
        raise SystemExit(
            f"serve needs a synthetic fixture (<N>svc), got {args.fixture!r}"
        )
    case = synthetic_cascade_arrays(
        int(m.group(1)), n_roots=1, seed=args.seed
    )
    rng = np.random.default_rng(args.seed)
    recorder = None
    if args.record:
        from rca_tpu_torch.replay import Recorder

        recorder = Recorder(args.record, mode="serve")
    if len(config.replica_specs()) > 1:
        # the pool: engines and device groups from the replica mix
        loop = ServePool(config=config, recorder=recorder,
                         devices=visible_devices(resolve_device(args.device)))
    else:
        loop = ServeLoop(engine=make_engine(device=args.device),
                         config=config, recorder=recorder)
    tenants = [f"tenant-{i}" for i in range(args.tenants)]
    t0 = time.perf_counter()
    with loop:
        client = ServeClient(loop)
        reqs = [
            client.submit(
                np.clip(case.features + rng.uniform(
                    0, 0.05, case.features.shape
                ).astype(np.float32), 0, 1),
                case.dep_src, case.dep_dst, names=case.names,
                tenant=tenants[i % len(tenants)], k=args.top,
            )
            for i in range(args.requests)
        ]
        responses = [r.result(timeout=300.0) for r in reqs]
        # before the plane stops: stopping closes its recompile window
        kernelscope = loop.kernelscope_summary()
    wall_s = time.perf_counter() - t0
    if recorder is not None:
        recorder.close()
    by_status = {}
    for resp in responses:
        by_status[resp.status] = by_status.get(resp.status, 0) + 1
    print(json.dumps({
        "requests": args.requests,
        "tenants": len(tenants),
        **({"recording": recorder.path,
            "serve_recorded": recorder.serve_recorded}
           if recorder is not None else {}),
        "by_status": by_status,
        "wall_s": round(wall_s, 3),
        "analyses_per_sec": round(
            by_status.get("ok", 0) / max(wall_s, 1e-9), 1
        ),
        "device_batches": loop.device_batches,
        "metrics": loop.metrics.summary(),
        "kernelscope": kernelscope,
    }, indent=indent, default=str))
    return 0 if by_status.get("ok", 0) == args.requests else 1


#: the routes a ``serve --listen`` banner names
_LISTEN_ENDPOINTS = ["/v1/analyze", "/v1/subscribe", "/v1/traces",
                     "/metrics", "/healthz"]


def _serve_listen(args, config) -> int:
    """``serve --listen HOST:PORT``: start the serving plane (a
    ``ServeLoop``, or the pool when more than one replica resolves) on
    ``--device``, put the gateway in front, print ONE JSON line naming the
    bound address (port 0 = kernel-chosen, so callers read it here) and
    serve until SIGTERM / SIGINT.  The shutdown summary goes to stderr, so
    stdout stays machine-readable.  ``--record`` flight-records every
    served request; wire requests naming an ``investigation_id`` land
    serve notes in the store under ``--log-dir``.  With ``--federation
    N`` the gateway fronts a :class:`FederationPlane` of N worker
    processes on ``--device`` instead (its ``/healthz`` carries the
    worker table that ``fleet`` reads); ``--autoscale MIN:MAX`` then
    attaches an :class:`AutoscaleController` that walks the fleet inside
    MIN..MAX (N must lie in those bounds; ``--autoscale`` without
    ``--federation`` is refused)."""
    import signal
    import threading

    from rca_tpu_torch.config import gateway_port
    from rca_tpu_torch.engine import make_engine
    from rca_tpu_torch.engine.runner import resolve_device
    from rca_tpu_torch.gateway import GatewayServer
    from rca_tpu_torch.parallel.mesh import visible_devices
    from rca_tpu_torch.serve import ServeLoop, ServePool
    from rca_tpu_torch.store import InvestigationStore
    from rca_tpu_torch.util.net import parse_hostport

    host, port = parse_hostport(args.listen, gateway_port())
    recorder = None
    if args.record:
        from rca_tpu_torch.replay import Recorder

        recorder = Recorder(args.record, mode="serve")
    store = InvestigationStore(root=_log_dir(args))
    federated = args.federation
    pooled = len(config.replica_specs()) > 1
    if federated and recorder is not None:
        raise SystemExit(
            "--record is not supported with --federation: serve frames "
            "live in the worker processes (use `canary --listen-url` to "
            "mint recordings off the live gateway)"
        )
    autoscale_spec = args.autoscale
    if autoscale_spec and not federated:
        raise SystemExit(
            "--autoscale with --listen needs --federation N (an elastic "
            "fleet is a federation property; in-process pools resize "
            "via RCA_SERVE_REPLICAS)"
        )
    if autoscale_spec:
        # --federation N is the starting width and must sit inside the
        # bounds: refused before a worker is spawned
        bounds = _parse_autoscale(autoscale_spec)
        if not bounds[0] <= federated <= bounds[1]:
            raise SystemExit(
                f"--autoscale {autoscale_spec}: --federation "
                f"{federated} is outside [{bounds[0]}, {bounds[1]}]"
            )
    controller = None
    if federated:
        # the front door over a whole worker fleet
        from rca_tpu_torch.serve.federation import FederationPlane

        plane_kwargs = {}
        if args.bind_external:
            from rca_tpu_torch.util.net import primary_host_ip

            plane_kwargs.update(
                host="0.0.0.0", advertise_host=primary_host_ip(),
            )
        loop = FederationPlane(
            workers=federated, config=config, store=store,
            device=args.device, **plane_kwargs,
        )
        loop.start()
        if not loop.wait_ready(federated, timeout_s=120.0):
            loop.stop()
            raise SystemExit(
                f"federation: only {len(loop.live_workers())}/"
                f"{federated} workers joined"
            )
        if autoscale_spec:
            # the controller watches queue-time p99 / SLO burn /
            # occupancy and walks the fleet inside MIN..MAX through
            # SCALE_RULES
            from rca_tpu_torch.serve.autoscale import AutoscaleController

            controller = AutoscaleController(
                loop, min_workers=bounds[0], max_workers=bounds[1],
            )
            controller.start(spawn_min=False)
    elif pooled:
        loop = ServePool(config=config, recorder=recorder, store=store,
                         devices=visible_devices(resolve_device(args.device)))
        loop.start()
    else:
        loop = ServeLoop(engine=make_engine(device=args.device),
                         config=config, recorder=recorder, store=store)
        loop.start()
    gw = GatewayServer(loop, host=host, port=port)
    gw.start()
    stop = threading.Event()

    def _on_signal(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    print(json.dumps({
        "listening": gw.address,
        **({"workers": len(loop.live_workers()), "control": loop.address}
           if federated else
           {"replicas": len(loop.replicas) if pooled else 1}),
        **({"autoscale": f"{controller.min_workers}:"
                         f"{controller.max_workers}"}
           if controller is not None else {}),
        "tls": gw.tls_context is not None,
        "authn": bool(gw.tokens),
        "max_body": gw.max_body,
        "endpoints": list(_LISTEN_ENDPOINTS),
        **({"recording": recorder.path} if recorder is not None else {}),
    }), flush=True)
    try:
        while not stop.is_set():
            stop.wait(0.5)
    finally:
        if controller is not None:
            controller.stop()
        gw.close()
        loop.stop()
        if recorder is not None:
            recorder.close()
        snap = gw.metrics.snapshot()
        print(json.dumps({
            "stopped": True,
            "gateway_requests": {
                f"{route}:{code}": n
                for (route, code), n in snap["requests"].items()
            },
            "metrics": loop.metrics.summary(),
        }, default=str), file=sys.stderr)
    return 0


def cmd_fleet(args) -> int:
    """``fleet URL``: the operator's view of a running federation, one
    ``/healthz`` call rendered as a worker table (state, outstanding,
    served, placement evidence, engine, pid).  ``--json`` prints the raw
    health body.  A gateway with no fleet in its ``/healthz`` (one in
    front of a loop or a pool) exits 1."""
    from rca_tpu_torch.gateway.client import GatewayClient

    client = GatewayClient.from_url(
        args.url, token=args.token, ca_file=args.ca_file,
        cert_file=args.cert_file, key_file=args.key_file,
        timeout_s=args.timeout,
    )
    status, body = client.healthz()
    if args.json:
        print(json.dumps(body, indent=2, default=str))
        return 0 if status == 200 else 1
    fleet = body.get("fleet")
    if fleet is None:
        print(json.dumps({
            "error": "not a federation gateway (no fleet in /healthz)",
            "health": body,
        }, indent=2, default=str))
        return 1
    cols = ("worker", "state", "outstanding", "served", "shapes",
            "mem_bytes", "engine", "pid")
    rows = [
        (str(w.get("worker_id")), str(w.get("state")),
         str(w.get("outstanding")), str(w.get("served")),
         str(w.get("shapes_known")), str(w.get("mem_bytes") or "-"),
         str(w.get("engine") or "-"), str(w.get("pid") or "-"))
        for w in fleet
    ]
    widths = [
        max(len(cols[i]), *(len(r[i]) for r in rows)) if rows
        else len(cols[i])
        for i in range(len(cols))
    ]
    print("  ".join(c.ljust(widths[i]) for i, c in enumerate(cols)))
    for r in rows:
        print("  ".join(v.ljust(widths[i]) for i, v in enumerate(r)))
    line = {
        "ok": body.get("ok"),
        "queue_depth": body.get("queue_depth"),
        "pending": body.get("pending"),
    }
    auto = body.get("autoscale")
    if auto:
        line["autoscale"] = {
            "bounds": f"{auto.get('min')}:{auto.get('max')}",
            "running": auto.get("running"),
            "decisions": auto.get("decisions"),
            "last": (auto.get("last_decision") or {}).get("action"),
        }
    print(json.dumps(line, default=str))
    return 0 if status == 200 and body.get("ok") else 1


def cmd_canary(args) -> int:
    """The replay-driven regression canary: sample live investigations
    into minted recordings (each stamped into the store as a replayable
    ``recording_ref``), replay them — and any ``--corpus`` recordings —
    against the candidate build or config on ``--device``, and exit 1 on
    a ranking divergence; the report names the bisected tick (stream) or
    request index (serve)."""
    import glob
    import os

    from rca_tpu_torch.gateway import build_candidate_engine, run_canary

    m = re.fullmatch(r"(\d+)svc", args.fixture or "20svc")
    if not m:
        raise SystemExit(
            f"canary needs a synthetic fixture (<N>svc), got "
            f"{args.fixture!r}"
        )
    candidate, info = build_candidate_engine(
        kind=args.candidate_engine,
        weights=args.candidate_weights,
        decay=args.candidate_decay,
        explain_strength=args.candidate_explain_strength,
        impact_bonus=args.candidate_impact_bonus,
        device=args.device,
    )
    corpus = []
    if args.corpus:
        if os.path.isdir(args.corpus):
            corpus = sorted(glob.glob(os.path.join(args.corpus, "*.rcz")))
        else:
            corpus = [args.corpus]
    store = None
    if not args.no_store:
        from rca_tpu_torch.store import InvestigationStore

        store = InvestigationStore(root=_log_dir(args))
    report = run_canary(
        args.out,
        rounds=args.rounds,
        ticks=args.ticks,
        services=int(m.group(1)),
        seed=args.seed,
        sample_rate=args.sample_rate,
        mode=args.mode,
        k=args.top,
        candidate=candidate,
        candidate_info=info,
        corpus=corpus,
        store=store,
        serve_requests=args.requests,
        listen_url=args.listen_url,
        token=args.token,
        ca_file=args.ca_file,
        device=args.device,
    )
    print(json.dumps(report, indent=None if args.compact else 2,
                     default=str))
    return 0 if report["ok"] else 1


def cmd_chaos(args) -> int:
    """Seeded chaos soak: a live session over a fault-injecting
    :class:`ChaosClusterClient` for N ticks, scored on the resilience
    contract: no uncaught exception, every fault class observed (from 100
    ticks), fault-free ticks bitwise a fault-free baseline, and with
    ``--record`` the replay of its own recording in parity.  From 100
    ticks (without ``--no-federation``) the soak adds the process-level
    legs: the federation's (``process_kill``, ``worker_hang``,
    ``coordinator_partition`` against a live fleet of
    ``--federation-workers`` worker processes on ``--device``, gated on
    every request terminal, no double completion, every class observed
    and a rejoin), without ``--no-autoscale`` the elastic fleet's
    ``scaling_storm`` (forced scale transitions racing those faults on a
    thread fleet on ``--device``, gated on every request terminal, no
    double completion, bounded stale drops and every race observed) and,
    without ``--no-ingest``, the ingest fleet's ``ingest_death`` (gated
    on the move to a survivor, the reclaim on rejoin and no double-applied
    capture tick).  Exit 0 only when the contract holds."""
    from rca_tpu_torch.config import chaos_seed
    from rca_tpu_torch.resilience.chaos import ChaosConfig, run_chaos_soak

    m = re.fullmatch(r"(\d+)svc", args.fixture or "50svc")
    if not m:
        raise SystemExit(
            f"chaos needs a synthetic fixture (<N>svc), got {args.fixture!r}"
        )
    federation = args.ticks >= 100 and not args.no_federation
    n_services = int(m.group(1))
    seed = args.seed if args.seed is not None else chaos_seed()

    def make_world():
        from rca_tpu_torch.cluster.generator import synthetic_cascade_world

        return synthetic_cascade_world(
            n_services, n_roots=1, seed=args.world_seed,
            fault_mix=args.fault_mix,
        )

    summary = run_chaos_soak(
        make_world, "synthetic", seed=seed, ticks=args.ticks, k=args.top,
        config=ChaosConfig(seed=seed),
        topology_check_every=args.topology_check_every,
        record_path=args.record, pipeline_depth=args.pipeline_depth,
        device=args.device,
    )
    # the federation leg: the three PROCESS-level fault classes driven
    # against a live worker fleet under wire load
    fed_ok = True
    if federation:
        from rca_tpu_torch.serve.federation import run_federation_chaos

        summary["federation"] = run_federation_chaos(
            seed=seed, workers=args.federation_workers, device=args.device,
        )
        fed_ok = summary["federation"]["ok"]
    # the scaling_storm leg: forced scale transitions racing the
    # federation's fault seams (scale-up vs SIGKILL, rejoin vs drain,
    # partition during scale-down)
    auto_ok = True
    if federation and not args.no_autoscale:
        from rca_tpu_torch.serve.autoscale import run_scaling_storm

        summary["autoscale"] = run_scaling_storm(seed=seed,
                                                 device=args.device)
        auto_ok = (
            summary["autoscale"]["ok"]
            and "scaling_storm"
            in summary["autoscale"]["fault_classes_observed"]
        )
    # the ingest leg: SIGKILL the ingest worker that owns capture
    # mirrors mid-soak; the coordinator's cluster table must move them
    # to a survivor and apply no tick twice
    ingest_ok = True
    if federation and not args.no_ingest:
        from rca_tpu_torch.serve.federation import (
            INGEST_FAULT_CLASS,
            run_ingest_chaos,
        )

        summary["ingest"] = run_ingest_chaos(seed=seed)
        ingest_ok = (
            summary["ingest"]["ok"]
            and INGEST_FAULT_CLASS
            in summary["ingest"]["fault_classes_observed"]
            and summary["ingest"]["double_applied"] == 0
        )
    print(json.dumps(summary, indent=None if args.compact else 2,
                     default=str))
    scope = summary["kernelscope"]
    ok = (
        summary["uncaught_exceptions"] == 0
        and summary["parity_ok"]
        and (summary["all_classes_observed"] or args.ticks < 100)
        and fed_ok
        and auto_ok
        and ingest_ok
        # --record adds the record → replay parity leg
        and summary.get("replay", {}).get("parity_ok", True)
        and scope["recompiles_post_warm"] == 0
        and scope["memory_gate"].get("ok", True)
    )
    return 0 if ok else 1


def cmd_ingest(args) -> int:
    """The federated capture fleet: spawn ``--workers`` ingest-class
    worker processes, register ``--clusters`` synthetic clusters
    (rendezvous-routed, exactly one capture-mirror owner each), soak for
    ``--duration`` seconds, and print the coordinator's cluster table:
    owner, epoch, ticks, sweep latency, coldiff bytes.  Exits 0 only when
    every cluster is owned and ticking with no double-applied tick.  The
    ingest workers never touch the card, so the command takes no
    ``--device``."""
    import time

    from rca_tpu_torch.serve.federation import FederationPlane

    plane = FederationPlane(
        workers=0, heartbeat_s=args.heartbeat_s, spawn_workers=False,
    )
    with plane:
        for i in range(args.workers):
            plane.spawn_worker(i, role="ingest")
        if not plane.wait_ready(args.workers, timeout_s=90.0):
            print(json.dumps({"ok": False, "error": "workers never joined",
                              "workers": plane.worker_table()}))
            return 1
        specs = {
            f"c{j}": {
                "digest": f"ingest-{args.seed}-{j}",
                "services": args.services,
                "pods_per_service": args.pods_per_service,
                "seed": args.seed + j,
                "namespace": "synthetic",
            }
            for j in range(args.clusters)
        }
        plane.register_clusters(specs)
        deadline = time.monotonic() + args.duration
        while time.monotonic() < deadline:
            time.sleep(0.1)
        status = plane.ingest_status()
        double = sum(c["double_applied"] for c in status.values())
        summary = {
            "clusters": status,
            "workers": plane.worker_table(),
            "double_applied": double,
            "stale_stats_dropped": plane.ingest_stale,
            "ok": bool(status) and double == 0 and all(
                c["owner"] is not None and c["ticks"] > 0
                for c in status.values()
            ),
        }
    print(json.dumps(summary, indent=None if args.compact else 2))
    return 0 if summary["ok"] else 1


def _replay_engine(choice: Optional[str], device):
    """The engine of a replay run: ``auto`` (None) lets the replayer pick
    the RECORDED engine kind (bitwise claims hold like-for-like);
    ``single`` / ``sharded`` force a cross-engine replay."""
    if choice in (None, "", "auto"):
        return None
    if choice == "single":
        from rca_tpu_torch.engine.runner import GraphEngine

        return GraphEngine(device=device)
    if choice == "sharded":
        from rca_tpu_torch.engine.sharded_runner import ShardedGraphEngine

        return ShardedGraphEngine(device=device)
    raise SystemExit(f"unknown engine {choice!r} (want auto|single|sharded)")


def cmd_replay(args) -> int:
    """Deterministic incident replay: re-drive the engine from a flight
    recording and check tick-for-tick (stream) or request-for-request
    (serve) parity; exit 0 when it holds.  ``--seek`` replays up to one
    tick and reports its detail, ``--bisect`` finds the first divergent
    tick and dumps both sides' tensors, ``--mint`` compacts a recording
    into one file, ``--trace-out`` writes its span timeline and
    ``--investigation`` resolves the log from a stored investigation's
    ``recording_ref``."""
    from rca_tpu_torch.replay import (
        bisect_divergence,
        load_recording,
        mint_recording,
        replay_serve,
        replay_stream,
    )

    indent = None if args.compact else 2
    path = args.log
    if args.investigation:
        from rca_tpu_torch.store import InvestigationStore

        store = InvestigationStore(root=_log_dir(args))
        path = store.get_recording_ref(args.investigation)
        if not path:
            print(json.dumps({
                "error": f"investigation {args.investigation} has no "
                "recording_ref",
            }))
            return 1
    if not path:
        raise SystemExit("replay needs a LOG path or --investigation ID")
    if args.mint:
        print(json.dumps(mint_recording(path, args.mint), indent=indent))
        return 0
    if args.trace_out:
        # the timeline from the spans embedded in the tick frames: the
        # times the session had, no re-run
        from rca_tpu_torch.observability.export import (
            recording_trace,
            write_chrome_trace,
        )

        trace = recording_trace(path)
        write_chrome_trace(trace, args.trace_out)
        print(json.dumps({
            "trace_out": args.trace_out,
            "trace_events": len(trace["traceEvents"]),
        }, indent=indent))
        return 0 if trace["traceEvents"] else 1
    engine = _replay_engine(args.engine, args.device)
    rec = load_recording(path)
    if rec.mode == "serve":
        report = replay_serve(path, engine=engine, device=args.device)
    elif args.bisect:
        report = bisect_divergence(
            path, engine=engine, pipeline_depth=args.pipeline_depth,
            dump_path=args.dump, device=args.device,
        )
    else:
        report = replay_stream(
            path, engine=engine, pipeline_depth=args.pipeline_depth,
            seek=args.seek, ticks=args.ticks,
            parity="rank" if args.rank_parity else "exact",
            explain=args.explain, device=args.device,
        )
    print(json.dumps(report, indent=indent, default=str))
    ok = report.get("parity_ok", not report.get("divergent", False))
    return 0 if ok else 1


def cmd_lint(args) -> int:
    """graftlint: delegate to the analyzer CLI so ``lint ...`` and
    ``python -m rca_tpu_torch.analysis ...`` are the same tool with the
    same exit-code contract (0 clean / 1 findings / 2 usage error)."""
    from rca_tpu_torch.analysis.__main__ import main as lint_main

    return lint_main(args.lint_args)


def cmd_ui(args) -> int:
    """Launch the Streamlit app on ``--port`` with the app's ``--device``;
    exit 1 when ``streamlit`` is not installed (the CLI covers the same
    ground)."""
    try:
        import streamlit  # noqa: F401
    except ImportError:
        print(
            "streamlit is not installed; the coordinator API and CLI expose "
            "the same capabilities (try: python -m rca_tpu_torch analyze "
            "--fixture 5svc).",
            file=sys.stderr,
        )
        return 1
    import subprocess

    from rca_tpu_torch.ui import app as ui_app

    return subprocess.call(
        [sys.executable, "-m", "streamlit", "run", ui_app.__file__,
         "--server.port", str(args.port), "--",
         "--device", args.device or "cuda"]
    )


def cmd_train(args) -> int:
    """Fit, gate, save: the reference's ``train`` with its JSON keys and
    exit codes.  The gate runs only when a checkpoint is asked for, and a
    checkpoint that fails it is refused unless ``--allow-unshippable``."""
    from rca_tpu_torch.engine.train import (
        TrainConfig,
        hit_at_1,
        save_params,
        shippability_report,
        train,
    )

    cfg = TrainConfig(
        n_services=args.services, n_cases=args.cases,
        iters=args.iters, lr=args.lr, seed=args.seed,
        modes=tuple(args.modes.split(",")),
    )
    params, history = train(cfg, device=args.device)
    acc = hit_at_1(params, cfg, device=args.device)
    report = (shippability_report(params, device=args.device)
              if args.out else None)
    saved = None
    if args.out:
        if report["ships"] or args.allow_unshippable:
            save_params(params, args.out)
            saved = args.out
        else:
            print("refusing to save: shippability gate failed "
                  "(--allow-unshippable overrides)", file=sys.stderr)
    print(json.dumps({
        "final_loss": round(history[-1], 5),
        "initial_loss": round(history[0], 5),
        "holdout_hit_at_1": acc,
        "checkpoint": saved,
        "decay": round(params.decay, 4),
        "explain_strength": round(params.explain_strength, 4),
        "impact_bonus": round(params.impact_bonus, 4),
        "shippability": report,
    }))
    return 0 if (report is None or report["ships"] or saved) else 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rca_tpu_torch",
        description="Kubernetes root-cause analysis on an NVIDIA GPU",
    )
    sub = p.add_subparsers(dest="command", required=True)
    def common(sp):
        sp.add_argument("--fixture", default=None,
                        help="5svc | <N>svc | live (default: live)")
        sp.add_argument("--fault-mix", default="crash", dest="fault_mix",
                        help="synthetic fixtures' root fault archetypes: "
                        "crash | mixed | oom | image | config | pending")
        sp.add_argument("--namespace", default=None)
        sp.add_argument("--backend", default=None,
                        choices=("torch", "deterministic"),
                        help="default: $RCA_BACKEND or torch")
        sp.add_argument("--provider", default=None,
                        help="openai | anthropic | offline (default: "
                        "$LLM_PROVIDER or offline)")
        sp.add_argument("--llm-agents", action="store_true",
                        dest="llm_agents",
                        help="use LLM agents instead of deterministic rules")
        sp.add_argument("--log-dir", default=None, dest="log_dir",
                        help="investigations, evidence and prompt logs "
                        "(default: $RCA_LOG_DIR or logs)")
        sp.add_argument("--device", default=None,
                        help="cuda | cpu (default: cuda)")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--full", action="store_true",
                        help="print the full record")
        sp.add_argument("--compact", action="store_true",
                        help="single-line JSON")

    sp = sub.add_parser("analyze", help="run an analysis")
    common(sp)
    sp.add_argument("--type", default="comprehensive",
                    help="comprehensive | resources | metrics | logs | "
                    "events | topology | traces")
    sp.set_defaults(fn=cmd_analyze)

    sp = sub.add_parser("chat", help="one chat turn")
    common(sp)
    sp.add_argument("query")
    sp.add_argument("--investigation", default=None,
                    help="persist the turn into this investigation id "
                    "('new' creates one); prior findings feed the prompt")
    sp.set_defaults(fn=cmd_chat)

    sp = sub.add_parser(
        "report", help="comprehensive analysis as a markdown report"
    )
    common(sp)
    sp.add_argument("--out", default=None,
                    help="write the report here instead of stdout")
    sp.set_defaults(fn=cmd_report)

    sp = sub.add_parser("suggest", help="execute one suggestion action")
    common(sp)
    sp.add_argument("action", help='JSON, e.g. {"type": "check_logs", '
                    '"pod_name": "x"}')
    sp.set_defaults(fn=cmd_suggest)

    sp = sub.add_parser(
        "why",
        help="render an investigation's causelens blame tree: which "
        "evidence channels, dependency edges and counterfactual rows "
        "produced its ranking (kernel dispatch decisions are `kernels "
        "--explain`)",
    )
    sp.add_argument("investigation_id",
                    help="stored investigation id (see `investigations`)")
    sp.add_argument("--json", action="store_true",
                    help="print the raw provenance block instead of the "
                    "ASCII tree")
    sp.add_argument("--log-dir", default=None, dest="log_dir",
                    help="the investigation store (default: $RCA_LOG_DIR "
                    "or logs)")
    sp.add_argument("--compact", action="store_true")
    sp.set_defaults(fn=cmd_why)

    sp = sub.add_parser("investigations", help="list/show investigations")
    sp.add_argument("--id", default=None)
    sp.add_argument("--log-dir", default=None, dest="log_dir",
                    help="the investigation store (default: $RCA_LOG_DIR "
                    "or logs)")
    sp.set_defaults(fn=cmd_investigations)

    sp = sub.add_parser(
        "hypotheses",
        help="counterfactual hypothesis batch: what-if-healthy scoring of "
        "the top candidates as lanes of one batched analysis",
    )
    sp.add_argument("--fixture", default=None,
                    help="5svc | <N>svc | live (default: live)")
    sp.add_argument("--namespace", default=None)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--fault-mix", default="crash", dest="fault_mix")
    sp.add_argument("--candidates", type=int, default=8,
                    help="batch width: top-N candidates to counterfactual")
    sp.add_argument("--top", type=int, default=5)
    sp.add_argument("--device", default=None,
                    help="cuda | cpu (default: cuda)")
    sp.add_argument("--compact", action="store_true")
    sp.set_defaults(fn=cmd_hypotheses)

    sp = sub.add_parser(
        "kernels",
        help="print the kernel registry: the engaged row per padded shape, "
        "why, its timings and every candidate's eligibility",
    )
    sp.add_argument("--services", default="500,2000",
                    help="comma-separated service counts whose shape "
                    "buckets to resolve before printing (default 500,2000)")
    sp.add_argument("--edges", default="",
                    help="comma-separated edge counts paired with "
                    "--services (default: ~2.5 edges per service)")
    sp.add_argument("--explain", action="store_true",
                    help="per row, each candidate: engaged, its "
                    "eligibility reason, or the timing it lost with")
    sp.add_argument("--sp", type=int, default=0,
                    help="also resolve the node-sharded engine's row for "
                    "this many shards (default 0: none)")
    sp.add_argument("--no-cost", action="store_true", dest="no_cost",
                    help="skip the cost capture (one run of each row's "
                    "winner at its shape)")
    sp.add_argument("--cost-max-pad", type=int, default=4096,
                    dest="cost_max_pad",
                    help="largest padded shape the cost capture may run "
                    "(default 4096; bigger rows still show winner and "
                    "timings)")
    sp.add_argument("--device", default=None,
                    help="cuda | cpu (default: cuda)")
    sp.add_argument("--json", action="store_true",
                    help="machine-readable rows instead of the table")
    sp.add_argument("--compact", action="store_true")
    sp.set_defaults(fn=cmd_kernels)

    sp = sub.add_parser(
        "profile",
        help="torch.profiler capture around N live ticks: a Chrome trace "
        "(Perfetto-loadable) and the row each shape engaged",
    )
    sp.add_argument("--out", default="logs/profile", metavar="DIR",
                    help="profile output directory (default logs/profile)")
    sp.add_argument("--ticks", type=int, default=20)
    sp.add_argument("--services", type=int, default=200,
                    help="synthetic world size the capture runs over")
    sp.add_argument("--seed", type=int, default=7)
    sp.add_argument("--device", default=None,
                    help="cuda | cpu (default: cuda)")
    sp.add_argument("--compact", action="store_true")
    sp.set_defaults(fn=cmd_profile)

    sp = sub.add_parser(
        "stream", help="poll-driven live streaming analysis (1 Hz loop)"
    )
    sp.add_argument("--fixture", default=None,
                    help="5svc | <N>svc | live (default: live)")
    sp.add_argument("--fault-mix", default="crash", dest="fault_mix",
                    help="synthetic fixtures' root fault archetypes")
    sp.add_argument("--namespace", default=None)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--ticks", type=int, default=5)
    sp.add_argument("--interval", type=float, default=1.0,
                    help="seconds between polls (0 = as fast as possible)")
    sp.add_argument("--top", type=int, default=5)
    sp.add_argument("--pipeline-depth", type=int, default=None,
                    dest="pipeline_depth",
                    help="tick pipeline depth (default $RCA_PIPELINE_DEPTH "
                    "or 1): 2 overlaps each tick's device work with the "
                    "next poll's capture; rankings arrive depth-1 ticks "
                    "late")
    sp.add_argument("--record", default=None, metavar="PATH",
                    help="flight-record every tick to PATH (a directory); "
                    "re-drive later with `replay PATH`")
    sp.add_argument("--device", default=None,
                    help="cuda | cpu (default: cuda)")
    sp.set_defaults(fn=cmd_stream)

    sp = sub.add_parser(
        "serve",
        help="multi-tenant serving scheduler: continuous shape-bucketed "
        "batching of concurrent analyze requests",
    )
    sp.add_argument("--selftest", action="store_true",
                    help="run the serving-contract selftest (all requests "
                    "answered or shed, coalesced-vs-solo bit parity); "
                    "exit 0 only when the contract holds")
    sp.add_argument("--chaos", action="store_true",
                    help="selftest with seeded dispatch/fetch fault "
                    "injection (breaker and degraded path)")
    sp.add_argument("--requests", type=int, default=32)
    sp.add_argument("--submitters", type=int, default=4,
                    help="concurrent submitter threads (selftest)")
    sp.add_argument("--tenants", type=int, default=4,
                    help="logical tenants (load demo)")
    sp.add_argument("--fixture", default="500svc",
                    help="<N>svc synthetic graph (load demo)")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--top", type=int, default=5)
    sp.add_argument("--max-batch", type=int, default=None, dest="max_batch",
                    help="override RCA_SERVE_MAX_BATCH")
    sp.add_argument("--max-wait-us", type=int, default=None,
                    dest="max_wait_us",
                    help="override RCA_SERVE_MAX_WAIT_US")
    sp.add_argument("--queue-cap", type=int, default=None, dest="queue_cap",
                    help="override RCA_SERVE_QUEUE_CAP")
    sp.add_argument("--replicas", type=int, default=None,
                    help="serve-pool width: N engine replicas behind the "
                    "shared queue (override RCA_SERVE_REPLICAS; >1 "
                    "selects the pool)")
    sp.add_argument("--replica-mix", default=None, dest="replica_mix",
                    metavar="SPEC",
                    help="replica kinds and device groups, e.g. "
                    "'dense:2,sharded@4:1' (override RCA_SERVE_REPLICA_MIX;"
                    " defines the replica count when given)")
    sp.add_argument("--no-steal", action="store_true",
                    help="disable the work-stealing rebalance "
                    "(RCA_SERVE_STEAL=0): a dead replica's staged work "
                    "rides the degradation ladder instead")
    sp.add_argument("--kill-replica", action="store_true",
                    dest="kill_replica",
                    help="selftest chaos: kill replica 0 mid-wave and "
                    "check the steal protocol drops nothing (implies a "
                    "pool of >= 2 replicas)")
    sp.add_argument("--record", default=None, metavar="PATH",
                    help="flight-record every served request (load demo) "
                    "to PATH; re-run them solo with `replay PATH`")
    sp.add_argument("--listen", default=None, metavar="HOST:PORT",
                    help="serve over the wire: the gateway (POST "
                    "/v1/analyze, GET /v1/subscribe, /v1/traces, /metrics, "
                    "/healthz) in front of the scheduler until SIGTERM; "
                    "port 0 binds an ephemeral port (the bound address is "
                    "the first stdout line); default port "
                    "$RCA_GATEWAY_PORT")
    sp.add_argument("--log-dir", default=None, dest="log_dir",
                    help="investigation store of --listen: wire requests "
                    "naming an investigation_id append serve notes there "
                    "(default: $RCA_LOG_DIR or logs)")
    sp.add_argument("--device", default=None,
                    help="cuda | cpu (default: cuda)")
    sp.add_argument("--compact", action="store_true")
    sp.add_argument("--federation", type=int, default=None, metavar="N",
                    help="cross-process federation: N worker PROCESSES on "
                    "--device under one control plane.  Alone: run the "
                    "federation selftest (every request terminal, rankings "
                    "bitwise a solo analysis, no double completion).  With "
                    "--listen: the gateway fronts the federation instead "
                    "of an in-process plane")
    sp.add_argument("--kill-worker", action="store_true",
                    dest="kill_worker",
                    help="federation selftest chaos: SIGKILL one worker "
                    "process mid-wave; drain-and-reroute must leave every "
                    "request terminal with no double completion")
    sp.add_argument("--bind-external", action="store_true",
                    dest="bind_external",
                    help="bind the federation control port on 0.0.0.0 and "
                    "advertise this host's primary IP, so workers on other "
                    "hosts can join through --connect")
    sp.add_argument("--autoscale", default=None, metavar="MIN:MAX",
                    help="elastic fleet bounds.  Alone: run the load-ramp "
                    "soak (a thread fleet on --device scales MIN→MAX→MIN "
                    "under continuous traffic; exit 0 only when every "
                    "request is terminal, none completed twice and the "
                    "windowed queue p99 stayed bounded).  With --listen "
                    "--federation N: attach the SCALE_RULES controller to "
                    "the live fleet (N within MIN..MAX)")
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser(
        "fleet",
        help="status table of a running elastic federation: one /healthz "
        "call rendered as worker rows (exit 1 against a gateway with no "
        "fleet)",
    )
    sp.add_argument("url", metavar="URL",
                    help="gateway address, http[s]://host:port")
    sp.add_argument("--token", default=None,
                    help="bearer token for a gateway with "
                    "RCA_GATEWAY_TOKENS set")
    sp.add_argument("--ca-file", default=None, dest="ca_file",
                    metavar="PEM",
                    help="verify a TLS gateway against this cert")
    sp.add_argument("--cert-file", default=None, dest="cert_file",
                    metavar="PEM",
                    help="client certificate for an mTLS gateway "
                    "(RCA_GATEWAY_TLS_CLIENT_CA)")
    sp.add_argument("--key-file", default=None, dest="key_file",
                    metavar="PEM",
                    help="client key (defaults to the cert file)")
    sp.add_argument("--timeout", type=float, default=10.0)
    sp.add_argument("--json", action="store_true",
                    help="print the raw /healthz body instead of the "
                    "rendered table")
    sp.set_defaults(fn=cmd_fleet)

    sp = sub.add_parser(
        "canary",
        help="replay-driven regression canary: sample live investigations "
        "into minted recordings, replay them against a candidate build or "
        "config, exit 1 on ranking divergence (the bisected tick is in "
        "the report)",
    )
    sp.add_argument("--out", default="logs/canary",
                    help="directory the minted canary corpus grows in")
    sp.add_argument("--corpus", default=None, metavar="PATH",
                    help="existing recordings added to the replay gate (a "
                    "directory of *.rcz, or one file)")
    sp.add_argument("--rounds", type=int, default=2,
                    help="sampling rounds (each records one session at "
                    "the sample rate)")
    sp.add_argument("--ticks", type=int, default=12,
                    help="streaming ticks per sampled session")
    sp.add_argument("--requests", type=int, default=8,
                    help="serve requests per sampled wave (mode "
                    "serve/both, or --listen-url)")
    sp.add_argument("--fixture", default="20svc",
                    help="<N>svc synthetic world per sampled session")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--sample-rate", type=float, default=None,
                    dest="sample_rate",
                    help="per-round recording probability (override "
                    "$RCA_CANARY_SAMPLE_RATE; default 1.0)")
    sp.add_argument("--mode", default="stream",
                    choices=["stream", "serve", "both", "multicluster"],
                    help="what each round samples: streaming "
                    "investigations (bisect names the exact tick), serve "
                    "waves (first divergent request index), both, or "
                    "merged multi-cluster sessions captured through the "
                    "live columnar adapter")
    sp.add_argument("--listen-url", default=None, dest="listen_url",
                    metavar="URL",
                    help="sample through a RUNNING gateway "
                    "(http[s]://host:port) instead of in process; "
                    "overrides --mode")
    sp.add_argument("--token", default=None,
                    help="bearer token for a --listen-url gateway with "
                    "RCA_GATEWAY_TOKENS set")
    sp.add_argument("--ca-file", default=None, dest="ca_file",
                    metavar="PEM",
                    help="verify a --listen-url TLS gateway against this "
                    "cert")
    sp.add_argument("--top", type=int, default=5)
    sp.add_argument("--candidate-engine", default="auto",
                    dest="candidate_engine",
                    help="auto (= current build, recorded kind) | single "
                    "| sharded (needs more than one device)")
    sp.add_argument("--candidate-weights", default=None,
                    dest="candidate_weights", metavar="CKPT",
                    help="candidate scoring checkpoint (rca-weights-v1 "
                    "JSON) the corpus replays against")
    sp.add_argument("--candidate-decay", type=float, default=None,
                    dest="candidate_decay",
                    help="perturb the candidate's per-hop decay")
    sp.add_argument("--candidate-explain-strength", type=float,
                    default=None, dest="candidate_explain_strength")
    sp.add_argument("--candidate-impact-bonus", type=float,
                    default=None, dest="candidate_impact_bonus")
    sp.add_argument("--no-store", action="store_true", dest="no_store",
                    help="skip stamping sampled recordings into the "
                    "investigation store")
    sp.add_argument("--log-dir", default=None, dest="log_dir",
                    help="the investigation store (default: $RCA_LOG_DIR "
                    "or logs)")
    sp.add_argument("--device", default=None,
                    help="cuda | cpu (default: cuda)")
    sp.add_argument("--compact", action="store_true")
    sp.set_defaults(fn=cmd_canary)

    sp = sub.add_parser(
        "replay",
        help="deterministic incident replay from a flight recording: "
        "parity check, --seek, --bisect, --mint, --trace-out",
    )
    sp.add_argument("log", nargs="?", default=None,
                    help="recording directory (or minted single file)")
    sp.add_argument("--seek", type=int, default=None, metavar="TICK",
                    help="replay up to TICK and attach its detail (both "
                    "rankings, feature digests) to the report")
    sp.add_argument("--ticks", type=int, default=None,
                    help="replay only the first N ticks")
    sp.add_argument("--bisect", action="store_true",
                    help="binary-search the FIRST divergent tick and dump "
                    "both sides' feature and ranking tensors")
    sp.add_argument("--dump", default=None, metavar="PATH",
                    help="where --bisect writes the divergence tensors "
                    "(default: <log>.divergence.json)")
    sp.add_argument("--mint", default=None, metavar="OUT",
                    help="compact the recording into one compressed file")
    sp.add_argument("--engine", default="auto",
                    help="auto (= the recorded engine kind) | single | "
                    "sharded")
    sp.add_argument("--pipeline-depth", type=int, default=None,
                    dest="pipeline_depth",
                    help="replay at this depth (default: the recorded one; "
                    "another depth compares lag-stripped serial sequences)")
    sp.add_argument("--rank-parity", action="store_true",
                    dest="rank_parity",
                    help="judge ticks by hit@1 / hit@3 + Kendall-tau "
                    "instead of bitwise digests (a replay on another "
                    "device)")
    sp.add_argument("--explain", action="store_true",
                    help="require the recorded attribution digests "
                    "(RCA_EXPLAIN=1 recordings) and match them")
    sp.add_argument("--trace-out", default=None, dest="trace_out",
                    metavar="PATH",
                    help="write the recording's span timeline as Chrome "
                    "trace JSON (recorded with RCA_TRACE=1) and exit")
    sp.add_argument("--investigation", default=None, metavar="ID",
                    help="resolve the recording from this stored "
                    "investigation's recording_ref")
    sp.add_argument("--log-dir", default=None, dest="log_dir",
                    help="the investigation store of --investigation "
                    "(default: $RCA_LOG_DIR or logs)")
    sp.add_argument("--device", default=None,
                    help="cuda | cpu (default: cuda)")
    sp.add_argument("--compact", action="store_true")
    sp.set_defaults(fn=cmd_replay)

    sp = sub.add_parser(
        "chaos",
        help="seeded chaos soak: fault injection over a synthetic world; "
        "no uncaught exception and fault-free tick parity",
    )
    sp.add_argument("--fixture", default="50svc", help="<N>svc synthetic")
    sp.add_argument("--seed", type=int, default=None,
                    help="chaos schedule seed (default: $RCA_CHAOS_SEED "
                    "or 7)")
    sp.add_argument("--world-seed", type=int, default=0, dest="world_seed")
    sp.add_argument("--fault-mix", default="crash", dest="fault_mix")
    sp.add_argument("--ticks", type=int, default=200)
    sp.add_argument("--top", type=int, default=5)
    sp.add_argument("--topology-check-every", type=int, default=5,
                    dest="topology_check_every")
    sp.add_argument("--record", default=None, metavar="PATH",
                    help="flight-record the chaos session to PATH and add "
                    "the record → replay parity leg to the contract")
    sp.add_argument("--pipeline-depth", type=int, default=None,
                    dest="pipeline_depth",
                    help="tick pipeline depth of the soaked session")
    sp.add_argument("--no-federation", action="store_true",
                    dest="no_federation",
                    help="soak the live session alone: skip the "
                    "process-level legs (worker kill / hang / partition "
                    "over a live fleet, the ingest owner's death)")
    sp.add_argument("--federation-workers", type=int, default=3,
                    dest="federation_workers",
                    help="worker processes in the federation chaos leg")
    sp.add_argument("--no-autoscale", action="store_true",
                    dest="no_autoscale",
                    help="skip the scaling_storm leg (forced scale "
                    "transitions racing worker kill / hang / partition "
                    "on a thread fleet)")
    sp.add_argument("--no-ingest", action="store_true", dest="no_ingest",
                    help="skip the ingest_death leg (SIGKILL the "
                    "capture-mirror owner; exactly-once tick gate)")
    sp.add_argument("--device", default=None,
                    help="cuda | cpu (default: cuda)")
    sp.add_argument("--compact", action="store_true")
    sp.set_defaults(fn=cmd_chaos)

    sp = sub.add_parser(
        "ingest",
        help="federated capture fleet: ingest-class workers owning "
        "columnar cluster mirrors, rendezvous-routed",
    )
    sp.add_argument("--workers", type=int, default=2,
                    help="ingest worker processes")
    sp.add_argument("--clusters", type=int, default=3,
                    help="synthetic clusters to register")
    sp.add_argument("--services", type=int, default=20,
                    help="services per synthetic cluster")
    sp.add_argument("--pods-per-service", type=int, default=1,
                    dest="pods_per_service")
    sp.add_argument("--duration", type=float, default=5.0,
                    help="soak seconds before scoring")
    sp.add_argument("--heartbeat-s", type=float, default=0.25,
                    dest="heartbeat_s")
    sp.add_argument("--seed", type=int, default=17)
    sp.add_argument("--compact", action="store_true")
    sp.set_defaults(fn=cmd_ingest)

    sp = sub.add_parser("train", help="fit propagation weights on "
                        "synthetic cascades; save a JSON checkpoint")
    sp.add_argument("--services", type=int, default=256)
    sp.add_argument("--cases", type=int, default=64)
    sp.add_argument("--iters", type=int, default=150)
    sp.add_argument("--lr", type=float, default=0.05)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--modes", default="standard,crashing_victims,"
                    "correlated_noise,adversarial",
                    help="comma-separated cascade modes for the dataset")
    sp.add_argument("--out", default=None,
                    help="checkpoint file, rca-weights-v1 JSON (loadable "
                    "via RCA_WEIGHTS)")
    sp.add_argument("--allow-unshippable", action="store_true",
                    help="save the checkpoint even when the shippability "
                    "gate fails (research use)")
    sp.add_argument("--device", default=None,
                    help="cuda | cpu (default: cuda)")
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("ui", help="launch the Streamlit app")
    sp.add_argument("--port", type=int, default=5000)
    sp.add_argument("--device", default=None,
                    help="cuda | cpu (default: cuda)")
    sp.set_defaults(fn=cmd_ui)

    sp = sub.add_parser(
        "lint",
        help="graftlint over the port: tick-sync and fetch-seam "
        "contracts, kernel dispatch, RNG, lock/thread/env discipline, "
        "swallowed faults; --tracecheck and --specsan add the runtime "
        "checks",
        add_help=False,  # every flag (incl. --help) goes to the analyzer
    )
    sp.set_defaults(fn=cmd_lint, lint_args=[])
    return p


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    # `lint` forwards its whole tail to the analyzer's own parser
    # (argparse.REMAINDER cannot: it refuses leading optionals)
    if argv and argv[0] == "lint":
        from rca_tpu_torch.analysis.__main__ import main as lint_main

        return lint_main(list(argv[1:]))
    args = build_parser().parse_args(argv)
    return args.fn(args)
