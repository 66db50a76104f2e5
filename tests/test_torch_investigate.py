"""The port's investigation layer against the JAX package's.

One scripted investigation runs through the port's ``RCACoordinator``
(``backend="torch"``, ``device="cpu"``) and the reference's
(``backend="jax"``) over each package's own copy of the same world:

- a comprehensive analysis, then the guided hypothesis workflow on the
  top root cause (hypotheses, plan, every step, the report);
- a chat turn (``process_user_query``) with accumulated findings;
- the five suggestion types (``process_suggestion``), each followed by
  ``update_suggestions_after_action``, plus every action the chat turn
  suggested;
- the comprehensive analysis again with ``use_llm_agents=True`` (the
  offline provider: the agents degrade to the rules).

Every output must equal the reference's once the volatile keys are gone
(ids, timestamps, ``latency_ms``, ``profile``) and the engine's own
stamps are read apart: the backend is ``torch`` where the reference says
``jax``, the engine ``single`` where the reference shards over the test
session's 8 virtual devices, and the fusion summary names the device
where the reference says "TPU"; root-cause scores (rounded to 4 places by
both) agree within 1e-4.  The worlds: the 5-service fixture and
60-service cascades over the six fault mixes, so the follow-up rules,
which read feature columns by index, fire on every kind of fault.  The
evidence logger's files match file for file.
"""

import json
import re

import pytest

from rca_tpu.cluster.fixtures import five_service_world as ref_five
from rca_tpu.cluster.generator import synthetic_cascade_world as ref_world
from rca_tpu.cluster.mock_client import MockClusterClient as RefClient
from rca_tpu.coordinator import RCACoordinator as RefCoordinator
from rca_tpu.obslog import EvidenceLogger as RefEvidenceLogger
from rca_tpu_torch.cluster.fixtures import NS, five_service_world
from rca_tpu_torch.cluster.generator import synthetic_cascade_world
from rca_tpu_torch.cluster.mock_client import MockClusterClient
from rca_tpu_torch.coordinator import RCACoordinator
from rca_tpu_torch.obslog import EvidenceLogger

FAULT_MIXES = ("crash", "oom", "image", "config", "pending", "mixed")

WORLDS = {"5svc": (five_service_world, ref_five, NS)}
for _mix in FAULT_MIXES:
    WORLDS[f"60svc_{_mix}"] = (
        lambda m=_mix: synthetic_cascade_world(60, n_roots=2, seed=3,
                                               fault_mix=m),
        lambda m=_mix: ref_world(60, n_roots=2, seed=3, fault_mix=m),
        "synthetic",
    )

VOLATILE = {"id", "timestamp", "started_at", "finished_at", "latency_ms",
            "engine_latency_ms", "profile", "logged_at"}

_SUMMARY = {
    "jax": re.compile(r"TPU propagation over (\d+) services / (\d+) edges "
                      r"in [0-9.]+ ms; top root cause: (.+)"),
    "torch": re.compile(r"propagation over (\d+) services / (\d+) edges "
                        r"in [0-9.]+ ms on cpu; top root cause: (.+)"),
}


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for name in ("RCA_BACKEND", "RCA_EXPLAIN", "RCA_COLUMNAR", "RCA_KERNEL",
                 "RCA_EDGE_LAYOUT", "LLM_PROVIDER", "OPENAI_API_KEY",
                 "ANTHROPIC_API_KEY"):
        monkeypatch.delenv(name, raising=False)


def _norm(obj, backend: str):
    """The volatile keys dropped; a correlated block's engine stamps
    reduced to what both packages share."""
    if isinstance(obj, dict):
        out = {}
        for key, value in obj.items():
            if key in VOLATILE:
                continue
            if key == "backend" and value == backend:
                value = "<engine>"
            elif key == "engine" and value in ("single",
                                               "sharded(dp=1,sp=8)"):
                value = "<engine>"
            elif key == "summary" and isinstance(value, str):
                m = _SUMMARY[backend].fullmatch(value)
                if m:
                    value = ("<fusion>",) + m.groups()
            out[key] = _norm(value, backend)
        return out
    if isinstance(obj, (list, tuple)):
        return [_norm(x, backend) for x in obj]
    return obj


def _assert_same(port, ref, path="$"):
    """Equal after :func:`_norm`, floats named ``score`` within 1e-4 and
    other floats within rel 1e-5 / abs 1e-6."""
    if isinstance(ref, dict):
        assert isinstance(port, dict) and sorted(port) == sorted(ref), path
        for key in ref:
            if key == "score" and isinstance(ref[key], float):
                assert abs(port[key] - ref[key]) <= 1e-4, f"{path}.{key}"
            else:
                _assert_same(port[key], ref[key], f"{path}.{key}")
    elif isinstance(ref, list):
        assert isinstance(port, list) and len(port) == len(ref), path
        for i, (p, r) in enumerate(zip(port, ref)):
            _assert_same(p, r, f"{path}[{i}]")
    elif isinstance(ref, float):
        assert port == pytest.approx(ref, rel=1e-5, abs=1e-6), path
    else:
        assert port == ref, path


def _pod_finding(results):
    """The first pod-level finding of the agents, in their order."""
    for agent in ("resources", "logs", "events", "metrics", "traces",
                  "topology"):
        for f in results.get(agent, {}).get("findings", []):
            if str(f.get("component", "")).startswith("Pod/"):
                return f
    return None


def _actions(ns, top, pod_finding):
    """The five suggestion types, aimed at the top root cause and the
    first pod-level finding."""
    comp = top["findings"][0]["component"] if top.get("findings") else ""
    kind, _, name = comp.partition("/")
    pod = (pod_finding["component"].partition("/")[2] if pod_finding
           else top["component"])
    return [
        {"type": "run_agent", "agent_type": "comprehensive"},
        {"type": "run_agent", "agent_type": "logs"},
        {"type": "check_resource", "kind": kind or "Pod", "name": name},
        {"type": "check_logs", "pod_name": pod, "previous": True,
         "tail_lines": 50},
        {"type": "check_resource", "kind": "Pod", "name": pod},
        {"type": "check_logs", "pod_name": pod},
        {"type": "check_events", "kind": kind or "Pod", "name": name},
        {"type": "check_events", "kind": "Pod", "name": pod},
        {"type": "check_events"},
        {"type": "query", "query": f"what broke {top['component']}?"},
    ]


def investigate(coord, ns):
    """The scripted investigation; returns every output by stage."""
    out = {}
    rec = coord.run_analysis("comprehensive", ns)
    assert rec["status"] == "completed", rec.get("error")
    out["analysis"] = rec
    top = rec["results"]["correlated"]["root_causes"][0]
    pod_finding = _pod_finding(rec["results"])
    # the workflow on the top root cause's first finding and on the first
    # pod-level finding (its logs step reads the pod's logs)
    out["hypotheses"], out["plan"], out["steps"], out["report"] = (
        [], [], [], [])
    for finding in [top["findings"][0]] + [pod_finding] * bool(pod_finding):
        comp = finding["component"]
        hyps = coord.generate_hypotheses(comp, finding, ns,
                                         investigation_id="inv-test")
        plan = coord.get_investigation_plan(hyps[0], ns)
        steps = [coord.execute_investigation_step(
            step, hyps[0], ns, investigation_id="inv-test")
            for step in plan["steps"]]
        out["hypotheses"] += hyps
        out["plan"].append(plan)
        out["steps"] += steps
        out["report"].append(coord.generate_root_cause_report({
            "component": comp, "accepted_hypothesis": hyps[0],
            "steps": steps, "finding": finding,
        }))
    chat = coord.process_user_query(
        "why is the top service down?", ns,
        previous_findings=[f"{top['component']} is {top['severity']}"])
    out["chat"] = chat
    actions = (_actions(ns, top, pod_finding)
               + [s["action"] for s in chat["suggestions"]])
    out["suggestions"] = []
    for action in actions:
        res = coord.process_suggestion(action, ns)
        fresh = coord.update_suggestions_after_action(action, res, ns)
        taken = json.dumps(action, sort_keys=True)
        assert all(json.dumps(s.get("action", {}), sort_keys=True) != taken
                   for s in fresh)
        out["suggestions"].append({"action": action, "result": res,
                                   "after": fresh})
    return out


def _pair(name, tmp_path, **kw):
    port_world, ref_world_fn, ns = WORLDS[name]
    port = RCACoordinator(MockClusterClient(port_world()), backend="torch",
                          device="cpu",
                          evidence_logger=EvidenceLogger(
                              str(tmp_path / "port_ev")), **kw)
    ref = RefCoordinator(RefClient(ref_world_fn()), backend="jax",
                         evidence_logger=RefEvidenceLogger(
                             str(tmp_path / "ref_ev")), **kw)
    return port, ref, ns


def _evidence_files(root):
    files = sorted(root.iterdir(), key=lambda p: p.name[15:])
    return [(p.name[15:], _norm(json.loads(p.read_text()), "torch"))
            for p in files]


@pytest.mark.parametrize("name", WORLDS)
def test_investigation_matches_reference(name, tmp_path):
    port, ref, ns = _pair(name, tmp_path)
    p, r = investigate(port, ns), investigate(ref, ns)
    for stage in r:
        _assert_same(_norm(p[stage], "torch"), _norm(r[stage], "jax"),
                     stage)
    # the engine stamps that _norm reads apart
    pc = p["analysis"]["results"]["correlated"]
    rc = r["analysis"]["results"]["correlated"]
    assert (pc["backend"], pc["engine"]) == ("torch", "single")
    assert rc["backend"] == "jax"
    assert "TPU" not in pc["summary"]
    # every suggestion type ran, and the run_agent analysis ranked the
    # same root first
    types = {s["action"]["type"] for s in p["suggestions"]}
    assert types == {"run_agent", "check_resource", "check_logs",
                     "check_events", "query"}
    # the evidence logger wrote the same files, contents equal
    pe = _evidence_files(tmp_path / "port_ev")
    re_ = _evidence_files(tmp_path / "ref_ev")
    assert len(pe) == len(re_) == len(p["hypotheses"]) + len(p["steps"])
    assert any(st["step"]["type"] == "logs" for st in p["steps"])
    for (pn, pj), (rn, rj) in zip(pe, re_):
        assert pn == rn
        _assert_same(pj, rj, pn)
    if name != "5svc":
        roots = WORLDS[name][0]().ground_truth["fault_roots"]
        assert pc["root_causes"][0]["component"] in roots


@pytest.mark.parametrize("name", ["5svc", "60svc_mixed"])
def test_llm_agents_analysis_matches_reference(name, tmp_path):
    """``use_llm_agents=True`` on the offline provider: the agents run
    their tool loop, degrade to the rules, and the analysis equals the
    reference's."""
    port, ref, ns = _pair(name, tmp_path, use_llm_agents=True)
    p = port.run_analysis("comprehensive", ns)
    r = ref.run_analysis("comprehensive", ns)
    assert p["status"] == r["status"] == "completed", p.get("error")
    _assert_same(_norm(p, "torch"), _norm(r, "jax"))
    assert port._agent_for("logs") is port._agent_for("logs")


def test_single_agent_suggestion_followups(tmp_path):
    """Evidence-conditioned follow-ups differ by what was gathered: the
    logs of a crash-looping pod suggest its previous logs, and the action
    just taken never comes back."""
    port, ref, ns = _pair("5svc", tmp_path)
    pod = next(p["metadata"]["name"] for p in port.cluster.get_pods(ns)
               if p["metadata"]["name"].startswith("database"))
    action = {"type": "check_logs", "pod_name": pod}
    p = port.process_suggestion(action, ns)
    r = ref.process_suggestion(action, ns)
    _assert_same(_norm(p, "torch"), _norm(r, "jax"))
    assert p["evidence_tag"]["kind"] == "logs"
    fresh = port.update_suggestions_after_action(action, p, ns)
    assert fresh and all(s["action"] != action for s in fresh)
    _assert_same(fresh, ref.update_suggestions_after_action(action, r, ns))


def test_scripted_llm_tier_matches_reference(tmp_path):
    """A capable provider's structured answers flow through the chat turn,
    the follow-up LLM tier, the hypotheses and the verdicts the same way
    in both packages."""
    from rca_tpu.llm import LLMClient as RefLLM
    from rca_tpu.llm import OfflineProvider as RefOffline
    from rca_tpu.llm import ProviderReply as RefReply
    from rca_tpu_torch.llm import LLMClient, OfflineProvider, ProviderReply

    answers = {
        "suggestions": [{"text": "check the db logs", "priority": "high",
                         "action": {"type": "check_logs",
                                    "pod_name": "database-0"}},
                        {"text": "bad", "action": {"type": "rm -rf"}}],
        "response_data": {"points": ["the database crash loops"],
                          "sections": []},
        "summary": "database down",
        "key_findings": ["database crash loops", ""],
        "hypotheses": [{"description": "init script fails",
                        "confidence": 0.8,
                        "investigation_steps": ["read the logs"]}],
        "verdict": "supported", "confidence": 0.7, "reasoning": "logs say so",
    }

    def scripted(base, reply_cls):
        class Scripted(base):
            name = "scripted"

            def complete(self, messages, tools=None, temperature=0.2,
                         max_tokens=2000, json_mode=False):
                if json_mode:
                    return reply_cls(text=json.dumps(answers))
                return reply_cls(text="A polished answer.")
        return Scripted()

    port, ref, ns = _pair("5svc", tmp_path)
    port.llm = LLMClient(provider=scripted(OfflineProvider, ProviderReply))
    ref.llm = RefLLM(provider=scripted(RefOffline, RefReply))
    p, r = investigate(port, ns), investigate(ref, ns)
    for stage in r:
        _assert_same(_norm(p[stage], "torch"), _norm(r[stage], "jax"),
                     stage)
    assert p["chat"]["summary"] == "database down"
    assert p["report"] == ["A polished answer."] * len(p["report"])
    assert p["hypotheses"][0]["description"] == "init script fails"


@pytest.mark.parametrize("llm_out", [
    None,
    "not a dict",
    {},
    {"response_data": {"points": []}, "summary": "   "},
    {"summary": "Offline deterministic placeholder"},
    {"response_data": {"points": ["p1"], "sections": [{"title": "t",
                                                       "content": ["c"]}]},
     "summary": " a summary ",
     "suggestions": [{"text": "do x"}, {"no_text": 1},
                     {"text": "do y", "priority": "low", "reasoning": "r",
                      "action": {"type": "check_events"}}],
     "key_findings": ["k1", "", None, "k2"] + [f"k{i}" for i in range(20)]},
    {"suggestions": ["not a dict"], "key_findings": []},
])
def test_merge_llm_structured_backfill(llm_out):
    """Whatever the model leaves out or gets wrong falls back to the
    deterministic response, as the reference's backfill does."""
    from rca_tpu.agents import AnalysisContext as RefContext
    from rca_tpu.cluster.snapshot import ClusterSnapshot as RefSnapshot
    from rca_tpu.coordinator.structured import (
        format_structured_response as ref_format,
    )
    from rca_tpu.coordinator.structured import (
        merge_llm_structured as ref_merge,
    )
    from rca_tpu_torch.agents import AnalysisContext
    from rca_tpu_torch.cluster.snapshot import ClusterSnapshot
    from rca_tpu_torch.coordinator.structured import (
        format_structured_response,
        merge_llm_structured,
    )

    ctx = AnalysisContext(ClusterSnapshot.capture(
        MockClusterClient(five_service_world()), NS), "cpu")
    rctx = RefContext(RefSnapshot.capture(RefClient(ref_five()), NS))
    base = format_structured_response(ctx, "why?")
    rbase = ref_format(rctx, "why?")
    assert json.dumps(base, sort_keys=True) == json.dumps(rbase,
                                                          sort_keys=True)
    merged = merge_llm_structured(base, llm_out)
    assert (json.dumps(merged, sort_keys=True)
            == json.dumps(ref_merge(rbase, llm_out), sort_keys=True))
    if not isinstance(llm_out, dict) or not llm_out:
        assert merged == base
