"""The port's investigation commands against ``python -m rca_tpu``'s, and
its render helpers against the reference's.

``chat`` (plain, ``--full`` and persisted with ``--investigation``),
``suggest`` (the five action types), ``report`` (stdout and ``--out``),
``investigations`` (list and ``--id``), ``why`` (with and without a stored
provenance block) and ``analyze --provider offline --llm-agents
--log-dir`` run through both packages' ``main(argv)`` in process, the port
with ``--device cpu``, each package over its own store under
``tmp_path``.  Their outputs are equal once the volatile keys are gone
(ids, timestamps, ``latency_ms``, ``profile``) and the engine's stamps
are read apart (the backend's name, the engine's, the fusion summary and
the latency line of the report name the port's engine and device).  The
two ``why`` commands read the SAME store file and print the same tree.

The render helpers (``ui/render.py``) run the cases of
``tests/test_cli_ui.py`` through both packages and must return the same
values; the report's latency line is the one deliberate difference.
"""

import json
import re

import pytest

from rca_tpu.cli import main as ref_main
from rca_tpu_torch.cli import main

VOLATILE = {"id", "timestamp", "started_at", "finished_at", "latency_ms",
            "engine_latency_ms", "profile", "created_at", "updated_at",
            "investigation_id", "logged_at"}

_FUSION = [
    re.compile(r"TPU propagation over (\d+) services / (\d+) edges in "
               r"[0-9.]+ ms; top root cause: (.+)"),
    re.compile(r"propagation over (\d+) services / (\d+) edges in [0-9.]+ "
               r"ms on cpu; top root cause: (.+)"),
]


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for name in ("RCA_BACKEND", "RCA_EXPLAIN", "RCA_KERNEL", "RCA_LOG_DIR",
                 "RCA_EDGE_LAYOUT", "LLM_PROVIDER", "OPENAI_API_KEY",
                 "ANTHROPIC_API_KEY"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("RCA_KERNEL_CACHE", "off")


def _norm(obj):
    if isinstance(obj, dict):
        out = {}
        for key, value in obj.items():
            if key in VOLATILE:
                continue
            if key == "backend" and value in ("jax", "torch"):
                value = "<backend>"
            elif key == "engine" and value in ("single",
                                               "sharded(dp=1,sp=8)"):
                value = "<engine>"
            elif key == "summary" and isinstance(value, str):
                for pattern in _FUSION:
                    m = pattern.fullmatch(value)
                    if m:
                        value = ["<fusion>", *m.groups()]
                        break
            elif key == "score" and isinstance(value, float):
                value = round(value, 3)
            out[key] = _norm(value)
        return out
    if isinstance(obj, list):
        return [_norm(x) for x in obj]
    return obj


def _both(capsys, tmp_path, argv, device=True):
    """Run ``argv`` through both CLIs, each over its own log directory (the
    port's on the CPU when the command takes ``--device``); returns
    ``((code, out), (code, out))`` port first."""
    outs = []
    for pkg, fn in (("port", main), ("ref", ref_main)):
        extra = ["--log-dir", str(tmp_path / pkg)]
        extra += ["--device", "cpu"] if pkg == "port" and device else []
        code = fn(list(argv) + extra)
        outs.append((code, capsys.readouterr().out))
    return outs


def _json_pair(capsys, tmp_path, argv):
    (pc, po), (rc, ro) = _both(capsys, tmp_path, argv)
    assert pc == rc == 0, (po, ro)
    return json.loads(po), json.loads(ro)


@pytest.mark.parametrize("fixture", ["5svc", "50svc"])
@pytest.mark.parametrize("full", [False, True])
def test_chat_matches_reference(fixture, full, capsys, tmp_path):
    argv = ["chat", "--fixture", fixture, "--compact",
            "why is the database down?"] + ["--full"] * full
    port, ref = _json_pair(capsys, tmp_path, argv)
    assert _norm(port) == _norm(ref)
    assert ("cluster_state" in port) == full
    assert port["response_data"]["points"] and port["suggestions"]


def test_persisted_chat_matches_reference(capsys, tmp_path):
    """``--investigation new`` creates and titles the investigation; the
    next turn resumes it with its accumulated findings.  The stored files
    are equal, and each package's store reads the other's."""
    from rca_tpu.store import InvestigationStore as RefStore
    from rca_tpu_torch.store import InvestigationStore

    base = ["chat", "--fixture", "5svc", "--compact"]
    port, ref = _json_pair(capsys, tmp_path, base + [
        "--investigation", "new", "why is the database down?"])
    assert _norm(port) == _norm(ref)
    ids = {"port": port["investigation_id"], "ref": ref["investigation_id"]}
    # a second turn on each package's own investigation
    outs = []
    for pkg, fn in (("port", main), ("ref", ref_main)):
        argv = base + ["--investigation", ids[pkg], "--log-dir",
                       str(tmp_path / pkg), "what should I fix first?"]
        argv += ["--device", "cpu"] if pkg == "port" else []
        assert fn(argv) == 0
        outs.append(json.loads(capsys.readouterr().out))
    assert _norm(outs[0]) == _norm(outs[1])
    stored = {
        pkg: RefStore(root=str(tmp_path / pkg)).get_investigation(iid)
        for pkg, iid in ids.items()
    }
    assert _norm(stored["port"]) == _norm(stored["ref"])
    assert len(stored["port"]["conversation"]) == 4
    assert stored["port"]["title"] == "why is the database down"
    assert InvestigationStore(root=str(tmp_path / "ref")).get_investigation(
        ids["ref"]) == stored["ref"]
    # an unknown id is refused the same way
    (pc, po), (rc, ro) = _both(capsys, tmp_path, base + [
        "--investigation", "missing", "hello?"])
    assert pc == rc == 1 and po == ro


@pytest.mark.parametrize("action", [
    {"type": "run_agent", "agent_type": "comprehensive"},
    {"type": "run_agent", "agent_type": "events"},
    {"type": "check_resource", "kind": "Deployment", "name": "database"},
    {"type": "check_logs", "pod_name": "database-7c9f8b6d5e-3x5qp",
     "previous": True},
    {"type": "check_events", "kind": "Pod",
     "name": "database-7c9f8b6d5e-3x5qp"},
    {"type": "query", "query": "what is failing?"},
], ids=lambda a: f"{a['type']}-{a.get('agent_type', a.get('kind', ''))}")
def test_suggest_matches_reference(action, capsys, tmp_path):
    port, ref = _json_pair(capsys, tmp_path, [
        "suggest", "--fixture", "5svc", "--compact", json.dumps(action)])
    assert _norm(port) == _norm(ref)
    assert sorted(port) == ["evidence", "evidence_tag", "key_findings",
                            "response", "suggestions"]


def _report_norm(md: str) -> str:
    md = re.sub(r"\((jax|torch) backend\)", "(<backend> backend)", md)
    return re.sub(r"\*(TPU p|P)ropagation latency: [0-9.]+ ms\*",
                  "<latency>", md)


@pytest.mark.parametrize("fixture", ["5svc", "50svc"])
def test_report_matches_reference(fixture, capsys, tmp_path):
    (pc, po), (rc, ro) = _both(capsys, tmp_path,
                               ["report", "--fixture", fixture])
    assert pc == rc == 0
    assert _report_norm(po) == _report_norm(ro)
    assert po.startswith("# Root Cause Analysis Report")
    assert "TPU" not in po and "*Propagation latency: " in po
    outs = []
    for pkg, fn in (("port", main), ("ref", ref_main)):
        path = tmp_path / f"{pkg}.md"
        argv = ["report", "--fixture", fixture, "--out", str(path)]
        argv += ["--device", "cpu"] if pkg == "port" else []
        assert fn(argv) == 0
        written = json.loads(capsys.readouterr().out)
        assert written["written"] == str(path)
        assert written["bytes"] == len(path.read_text())
        outs.append(path.read_text())
    assert _report_norm(outs[0]) == _report_norm(outs[1])


def test_investigations_match_reference(capsys, tmp_path):
    for pkg, fn in (("port", main), ("ref", ref_main)):
        argv = ["chat", "--fixture", "5svc", "--investigation", "new",
                "--log-dir", str(tmp_path / pkg), "why is the db down?"]
        argv += ["--device", "cpu"] if pkg == "port" else []
        assert fn(argv) == 0
    capsys.readouterr()
    (pc, po), (rc, ro) = _both(capsys, tmp_path, ["investigations"],
                               device=False)
    assert pc == rc == 0
    port, ref = json.loads(po), json.loads(ro)
    assert len(port) == 1 and _norm(port) == _norm(ref)
    port_one, ref_one = (
        json.loads(_both(capsys, tmp_path, ["investigations", "--id",
                                            rows[0]["id"]],
                         device=False)[i][1])
        for i, rows in ((0, port), (1, ref)))
    assert _norm(port_one) == _norm(ref_one)
    (pc, po), (rc, ro) = _both(capsys, tmp_path,
                               ["investigations", "--id", "nope"],
                               device=False)
    assert pc == rc == 1 and po == ro


def _stored_with_provenance(tmp_path):
    """An investigation whose provenance an explained port analysis wrote
    (the port's attribution block of the 50-service fixture)."""
    from rca_tpu_torch import GraphEngine
    from rca_tpu_torch.cluster.generator import synthetic_cascade_arrays
    from rca_tpu_torch.store import InvestigationStore

    case = synthetic_cascade_arrays(50, n_roots=1, seed=7)
    res = GraphEngine(device="cpu").analyze_case(case, k=5)
    store = InvestigationStore(root=str(tmp_path / "shared"))
    iid = store.create_investigation("explained")["id"]
    store.set_provenance(iid, res.attribution())
    return store, iid


@pytest.mark.parametrize("as_json", [False, True])
def test_why_renders_the_same_tree(as_json, capsys, tmp_path):
    store, iid = _stored_with_provenance(tmp_path)
    outs = []
    for fn in (main, ref_main):
        argv = ["why", iid, "--log-dir", str(store.root)]
        argv += ["--json"] * as_json
        assert fn(argv) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    if as_json:
        assert json.loads(outs[0]) == store.get_provenance(iid)
    else:
        assert outs[0].startswith(f"investigation {iid} · explained")


def test_why_falls_back_to_chat_turns_and_hints(capsys, tmp_path):
    from rca_tpu_torch.store import InvestigationStore

    store = InvestigationStore(root=str(tmp_path / "shared"))
    bare = store.create_investigation("no provenance")["id"]
    recorded = store.create_investigation("recorded",
                                          recording_ref="/tapes/x")["id"]
    chat = store.create_investigation("chat turn")["id"]
    block = {"schema": 1, "engine": "single",
             "attribution": {"candidates": [], "k": 0}}
    store.add_message(chat, "assistant",
                      {"response_data": {"correlated": {"provenance": block}}})
    for iid, code in ((bare, 1), (recorded, 1), (chat, 0), ("nope", 1)):
        outs = []
        for fn in (main, ref_main):
            assert fn(["why", iid, "--log-dir", str(store.root), "--json",
                       "--compact"]) == code
            outs.append(capsys.readouterr().out)
        if iid == recorded:
            port, ref = (json.loads(o) for o in outs)
            assert port["recording_ref"] == ref["recording_ref"]
            assert port["error"] == ref["error"]
            assert "`replay --explain`" in port["hint"]
        else:
            assert outs[0] == outs[1]
    assert json.loads(outs[0]) == {"error": "no investigation nope"}


def test_analyze_llm_flags_match_reference(capsys, tmp_path, monkeypatch):
    """``--provider offline --llm-agents --log-dir``: the LLM agents run
    their tool loop and degrade to the rules; the prompts land in the log
    directory (the prompt logger is a process singleton: dropped here so
    that this run makes it)."""
    from rca_tpu.obslog import prompts as ref_prompts
    from rca_tpu_torch.obslog import prompts

    monkeypatch.setattr(prompts, "_logger", None)
    monkeypatch.setattr(ref_prompts, "_logger", None)
    argv = ["analyze", "--fixture", "5svc", "--provider", "offline",
            "--llm-agents", "--compact"]
    port, ref = _json_pair(capsys, tmp_path, argv)
    assert port["status"] == "completed"
    assert _norm(port) == _norm(ref)
    records = [prompts.get_logger().read_all(),
               ref_prompts.get_logger().read_all()]
    assert records[0] and len(records[0]) == len(records[1])
    for pkg in ("port", "ref"):
        assert list((tmp_path / pkg / "prompts").glob("prompt_log_*.jsonl"))


def test_log_dir_defaults_to_rca_log_dir(capsys, tmp_path, monkeypatch):
    monkeypatch.setenv("RCA_LOG_DIR", str(tmp_path / "env_logs"))
    assert main(["chat", "--fixture", "5svc", "--device", "cpu",
                 "--investigation", "new", "--compact", "hello?"]) == 0
    iid = json.loads(capsys.readouterr().out)["investigation_id"]
    assert (tmp_path / "env_logs" / f"{iid}.json").exists()
    assert main(["investigations", "--id", iid]) == 0
    assert json.loads(capsys.readouterr().out)["id"] == iid


# -- the render helpers -------------------------------------------------------

_FINDING = {"component": "Pod/x", "issue": "boom", "severity": "critical",
            "recommendation": "fix it", "source": "logs"}
_CORRELATED = {
    "backend": "torch",
    "root_causes": [{"component": "database", "score": 1.5,
                     "finding_count": 3, "severity": "critical"},
                    {"component": "cache", "score": 0.25,
                     "finding_count": 1, "severity": "low"}],
    "groups": {
        "database": [{"severity": "critical", "source": "logs"},
                     {"severity": "high", "source": "events"}],
        "cache": [{"severity": "low", "source": "metrics"}],
    },
}
_GRAPH = {
    "nodes": [{"id": "service/a", "type": "service"},
              {"id": "service/b", "type": "service"},
              {"id": "workload/w", "type": "workload"}],
    "edges": [{"source": "service/a", "target": "workload/w",
               "relation": "selects"},
              {"source": "service/a", "target": "ghost",
               "relation": "routes"}],
}
_VIZ = [
    ("logs", {"findings": [{"component": "Pod/x", "severity": "high",
                            "evidence": {"pattern": "oom_kill",
                                         "count": 3}}]}),
    ("metrics", {"findings": [
        {"component": "Pod/y", "severity": "high",
         "evidence": {"usage_percentage": 95.0, "resource": "cpu"},
         "issue": "CPU utilization at 95% of its limit"},
        {"component": "Pod/y", "severity": "medium",
         "evidence": {"usage_percentage": 61.0, "resource": "memory"}}]}),
    ("resources", {"findings": [],
                   "data": {"pod_buckets": {"crashloop": 2, "pending": 0}}}),
    ("topology", {"findings": [], "data": {
        "service_pod_mapping": {"svc-a": {"ready": 1, "total": 2}}}}),
    ("events", {"findings": [], "data": {
        "reason_counts": {"BackOff": 12, "Unhealthy": 3},
        "type_counts": {"Warning": 15}}}),
    ("traces", {"findings": [], "data": {
        "latency": {"svc-a": {"p50": 10, "p95": 120, "p99": 300}}}}),
]
_TIMELINE = [{"step": {"description": "Check logs of db-0"},
              "verdict": {"verdict": "supported", "confidence": 0.8,
                          "reasoning": "exit 1 in previous logs"}},
             {"step": {"description": "Describe db"},
              "verdict": {"verdict": "refuted", "confidence": 0.3,
                          "reasoning": "healthy"}}]

RENDER_CASES = [
    ("initial_suggestions", ("prod",)),
    ("finding_markdown", (_FINDING,)),
    ("root_causes_markdown", (_CORRELATED,)),
    ("root_causes_markdown", ({"root_causes": []},)),
    ("diagnostic_timeline_markdown", ([],)),
    ("diagnostic_timeline_markdown", (_TIMELINE,)),
    ("response_markdown", ({"points": ["p1"], "sections": [
        {"title": "T", "content": ["c1"]}, {"title": "U",
                                            "content": "text"}]},)),
    ("report_markdown", ({"correlated": _CORRELATED,
                          "summary": "all broken",
                          "logs": {"findings": [_FINDING],
                                   "summary": "1 log finding"}},)),
    ("topology_plot_data", (_GRAPH,)),
    ("correlated_markdown", (_CORRELATED,)),
    ("correlated_markdown", ({},)),
] + [("viz", case) for case in _VIZ]


@pytest.mark.parametrize("name,args", RENDER_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(RENDER_CASES)])
def test_render_helpers_match_reference(name, args):
    from rca_tpu.ui import render as ref_render
    from rca_tpu_torch.ui import render

    if name == "viz":
        agent, result = args
        port = render.analysis_chart_series(
            render.analysis_viz_data(agent, result))
        ref = ref_render.analysis_chart_series(
            ref_render.analysis_viz_data(agent, result))
    else:
        port = getattr(render, name)(*args)
        ref = getattr(ref_render, name)(*args)
    assert port == ref


def test_report_latency_line_names_no_device():
    """The one deliberate difference: the latency line of the ranked root
    causes does not call the port's engine a TPU."""
    from rca_tpu.ui import render as ref_render
    from rca_tpu_torch.ui import render

    correlated = dict(_CORRELATED, engine_latency_ms=12.5)
    port = render.root_causes_markdown(correlated)
    ref = ref_render.root_causes_markdown(correlated)
    assert port.endswith("\n*Propagation latency: 12.5 ms*")
    assert ref.endswith("\n*TPU propagation latency: 12.5 ms*")
    assert _report_norm(port) == _report_norm(ref)
