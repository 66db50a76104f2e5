"""The port's LLM layer against the JAX package's tests of it.

``tests/test_llm.py`` (the tool loop really executes tools, offline
determinism, JSON rescue parsing, provider resolution, LLM agents
degrading to the rules, the coordinator's LLM agents, quota failover) and
``tests/test_provider_contracts.py`` (the OpenAI and Anthropic bindings'
wire format and tool round trip through stub ``openai`` / ``anthropic``
modules in ``sys.modules``, quota classification and failover) run here
against ``rca_tpu_torch.llm`` and ``rca_tpu_torch.agents.llm_agent``, with
the same stubs: the port imports both SDKs lazily under the same module
names.  Neither SDK is installed and no test touches a network.  The last
tests hold the offline provider, the JSON rescue and the prompts to the
reference's, output for output.
"""

from __future__ import annotations

import json
import sys
import types
from typing import Any, Dict, List, Optional

import pytest

from rca_tpu_torch.agents import AnalysisContext
from rca_tpu_torch.agents.llm_agent import LLMAgent, make_llm_agents
from rca_tpu_torch.cluster.fixtures import NS, five_service_world
from rca_tpu_torch.cluster.mock_client import MockClusterClient
from rca_tpu_torch.cluster.snapshot import ClusterSnapshot
from rca_tpu_torch.llm import (
    LLMClient,
    OfflineProvider,
    ProviderReply,
    ToolCall,
    cluster_toolsets,
    make_provider,
    parse_json_response,
)
from rca_tpu_torch.llm.providers import (
    LLMQuotaExceeded,
    LLMUnavailable,
)
from rca_tpu_torch.llm.tools import ToolSpec


@pytest.fixture(scope="module")
def client():
    return MockClusterClient(five_service_world())


@pytest.fixture(scope="module")
def ctx(client):
    return AnalysisContext(ClusterSnapshot.capture(client, NS), "cpu")


def test_offline_provider_resolution(monkeypatch):
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    monkeypatch.delenv("ANTHROPIC_API_KEY", raising=False)
    monkeypatch.delenv("RCA_LLM_PROVIDER", raising=False)
    assert make_provider().name == "offline"
    monkeypatch.setenv("RCA_LLM_PROVIDER", "offline")
    assert make_provider().name == "offline"


def test_tool_loop_executes_real_tools(client):
    """The loop must run the declared tools against the cluster client and
    feed their output back — the reference never did this."""
    llm = LLMClient(provider=OfflineProvider())
    tools = cluster_toolsets(client, NS)["traces"]
    out = llm.analyze("analyze traces", tools=tools)
    executed = {s["tool"] for s in out["reasoning_steps"] if "tool" in s}
    assert "get_service_latency_stats" in executed
    assert "get_error_rate_by_service" in executed
    # tool output flowed into the final answer (offline echoes evidence)
    assert "api-gateway" in out["final_analysis"]


def test_tool_execution_rejects_unknown_args(client):
    tools = cluster_toolsets(client, NS)["logs"]
    get_logs = next(t for t in tools if t.name == "get_pod_logs")
    # unknown argument keys are dropped, not passed through
    text = get_logs.execute(
        {"pod_name": "database-7c9f8b6d5e-3x5qp", "bogus": 1}
    )
    assert "Database initialization failed" in text


def test_tool_execution_returns_error_payload(client):
    tools = cluster_toolsets(client, NS)["traces"]
    details = next(t for t in tools if t.name == "get_trace_details")
    out = json.loads(details.execute({"trace_id": "no-such-trace"}))
    assert "error" in out or out == {}


def test_parse_json_rescue_paths():
    assert parse_json_response('{"a": 1}') == {"a": 1}
    assert parse_json_response('text\n```json\n{"a": 1}\n```\nmore') == {"a": 1}
    assert parse_json_response('prefix {"a": {"b": 2}} suffix') == {"a": {"b": 2}}
    assert parse_json_response("no json here") is None
    assert parse_json_response("") is None


def test_prompt_log_hook_records_interactions():
    records = []
    llm = LLMClient(provider=OfflineProvider(), log_fn=records.append)
    llm.generate_completion("hello")
    llm.generate_structured_output("give json")
    assert len(records) == 2
    assert records[0]["additional_context"]["provider"] == "offline"
    assert records[1]["additional_context"]["kind"] == "structured"


def test_llm_agents_degrade_to_deterministic_rules(client, ctx):
    """Offline provider yields no structured findings -> every LLM agent
    falls back to its rule twin and still produces findings."""
    llm = LLMClient(provider=OfflineProvider())
    agents = make_llm_agents(llm, cluster_client=client, namespace=NS)
    assert set(agents) == {
        "resources", "metrics", "logs", "events", "topology", "traces",
    }
    res = agents["resources"].analyze(ctx)
    assert res.findings  # deterministic fallback fired
    assert any("database" in f["component"] for f in res.findings)


def test_llm_agent_parses_structured_findings(ctx):
    """A provider that returns findings JSON populates findings directly."""

    class ScriptedProvider(OfflineProvider):
        def complete(self, messages, tools=None, temperature=0.2,
                     max_tokens=2000, json_mode=False):
            if json_mode:
                return ProviderReply(text=json.dumps({
                    "findings": [{
                        "component": "Pod/database-7c9f8b6d5e-3x5qp",
                        "issue": "crash looping",
                        "severity": "critical",
                        "evidence": "restart count 5",
                        "recommendation": "fix the init script",
                    }],
                    "summary": "database down",
                }))
            return ProviderReply(text="the database pod is crash looping")

    agent = LLMAgent("logs", LLMClient(provider=ScriptedProvider()))
    res = agent.analyze(ctx)
    assert len(res.findings) == 1
    f = res.findings[0]
    assert f["severity"] == "critical"
    assert f["source"] == "llm"
    assert res.summary == "database down"


def test_coordinator_llm_agents_bind_namespace_and_cache():
    """Coordinator-level LLM path: agents are built once (cached), tools are
    bound to the SNAPSHOT's namespace at analyze time (regression: they were
    bound to namespace "" at construction), and structured findings flow
    through without the deterministic fallback firing."""
    from rca_tpu_torch.coordinator import RCACoordinator

    calls = []

    class SpyClient(MockClusterClient):
        def get_pods(self, namespace):
            calls.append(namespace)
            return super().get_pods(namespace)

    class ScriptedProvider(OfflineProvider):
        def complete(self, messages, tools=None, temperature=0.2,
                     max_tokens=2000, json_mode=False):
            if json_mode:
                return ProviderReply(text=json.dumps({
                    "findings": [{
                        "component": "Pod/database-7c9f8b6d5e-3x5qp",
                        "issue": "crash looping",
                        "severity": "critical",
                        "evidence": "restart count 5",
                        "recommendation": "fix the init script",
                    }],
                    "summary": "database down",
                }))
            return super().complete(
                messages, tools=tools, temperature=temperature,
                max_tokens=max_tokens, json_mode=json_mode,
            )

    coord = RCACoordinator(
        SpyClient(five_service_world()),
        llm_client=LLMClient(provider=ScriptedProvider()),
        use_llm_agents=True, device="cpu",
    )
    assert coord._agent_for("logs") is coord._agent_for("logs")  # cached

    rec = coord.run_analysis("logs", NS)
    assert rec["status"] == "completed"
    res = rec["results"]["logs"]
    # the tool loop really executed the logs toolset's get_pods
    assert any(s.get("tool") == "get_pods" for s in res["reasoning_steps"])
    # every cluster call (snapshot capture AND tools) hit the real namespace
    assert NS in calls
    assert "" not in calls
    # structured findings were adopted from the provider, not the fallback
    assert res["findings"][0]["source"] == "llm"
    assert res["summary"] == "database down"


def test_quota_error_classification_of_exceptions():
    from rca_tpu_torch.llm.providers import LLMQuotaExceeded, _classify_error

    assert isinstance(
        _classify_error(Exception("Rate limit exceeded")), LLMQuotaExceeded
    )
    assert not isinstance(
        _classify_error(Exception("boom")), LLMQuotaExceeded
    )


def test_runtime_quota_failover_lands_on_offline(monkeypatch):
    """A provider that 429s mid-session fails over (reference: app.py:50-67)
    and, with no API keys available, lands on the offline provider."""
    from rca_tpu_torch.llm.providers import LLMQuotaExceeded, OfflineProvider

    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    monkeypatch.delenv("ANTHROPIC_API_KEY", raising=False)

    class QuotaProvider(OfflineProvider):
        name = "openai"

        def complete(self, *a, **k):
            raise LLMQuotaExceeded("429 rate limit")

    events = []
    llm = LLMClient(provider=QuotaProvider(), log_fn=events.append)
    out = llm.generate_completion("hello")
    assert out  # offline provider answered
    assert llm.provider.name == "offline"
    assert any(
        e["additional_context"].get("kind") == "provider_failover"
        for e in events
    )


# -- SDK stubs ---------------------------------------------------------------

class _Obj:
    """Attribute bag mimicking SDK response objects."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _openai_text_response(text: str, finish: str = "stop"):
    return _Obj(choices=[_Obj(
        message=_Obj(content=text, tool_calls=None), finish_reason=finish,
    )])


def _openai_toolcall_response(calls: List[Dict[str, Any]]):
    return _Obj(choices=[_Obj(
        message=_Obj(
            content=None,
            tool_calls=[
                _Obj(id=c["id"], function=_Obj(
                    name=c["name"], arguments=json.dumps(c["arguments"]),
                ))
                for c in calls
            ],
        ),
        finish_reason="tool_calls",
    )])


class _FakeOpenAIClient:
    def __init__(self, replies: List[Any]):
        self.requests: List[Dict[str, Any]] = []
        self._replies = list(replies)
        outer = self

        class _Completions:
            def create(self, **kwargs):
                outer.requests.append(kwargs)
                reply = outer._replies.pop(0)
                if isinstance(reply, Exception):
                    raise reply
                return reply

        self.chat = _Obj(completions=_Completions())


def install_openai_stub(monkeypatch, replies: List[Any]) -> _FakeOpenAIClient:
    fake_client = _FakeOpenAIClient(replies)
    mod = types.ModuleType("openai")
    mod.OpenAI = lambda api_key: fake_client  # binding passes api_key only
    monkeypatch.setitem(sys.modules, "openai", mod)
    monkeypatch.setenv("OPENAI_API_KEY", "sk-test")
    return fake_client


def _anthropic_text_response(text: str, stop: str = "end_turn"):
    return _Obj(
        content=[_Obj(type="text", text=text)], stop_reason=stop,
    )


def _anthropic_tooluse_response(calls: List[Dict[str, Any]]):
    return _Obj(
        content=[
            _Obj(type="tool_use", id=c["id"], name=c["name"],
                 input=c["arguments"])
            for c in calls
        ],
        stop_reason="tool_use",
    )


class _FakeAnthropicClient:
    def __init__(self, replies: List[Any]):
        self.requests: List[Dict[str, Any]] = []
        self._replies = list(replies)
        outer = self

        class _Messages:
            def create(self, **kwargs):
                outer.requests.append(kwargs)
                reply = outer._replies.pop(0)
                if isinstance(reply, Exception):
                    raise reply
                return reply

        self.messages = _Messages()


def install_anthropic_stub(
    monkeypatch, replies: List[Any]
) -> _FakeAnthropicClient:
    fake_client = _FakeAnthropicClient(replies)
    mod = types.ModuleType("anthropic")
    mod.Anthropic = lambda api_key: fake_client
    monkeypatch.setitem(sys.modules, "anthropic", mod)
    monkeypatch.setenv("ANTHROPIC_API_KEY", "sk-ant-test")
    return fake_client


def _make_provider(name: str):
    # import AFTER stubs are installed; the classes import the SDK lazily
    # in __init__ so construction under the stub exercises the real path
    from rca_tpu_torch.llm.providers import AnthropicProvider, OpenAIProvider

    return OpenAIProvider() if name == "openai" else AnthropicProvider()


ECHO_TOOL = ToolSpec(
    name="get_pod_logs",
    description="fetch pod logs",
    parameters={
        "type": "object",
        "properties": {"pod_name": {"type": "string"}},
        "required": ["pod_name"],
    },
    fn=lambda pod_name="": f"logs-of-{pod_name}: ERROR connection refused",
)


# -- OpenAI wire format ------------------------------------------------------

def test_openai_request_shape_and_tool_roundtrip(monkeypatch):
    fake = install_openai_stub(monkeypatch, [
        _openai_toolcall_response(
            [{"id": "call_1", "name": "get_pod_logs",
              "arguments": {"pod_name": "db-0"}}]
        ),
        _openai_text_response("db-0 is crash-looping"),
    ])
    client = LLMClient(provider=_make_provider("openai"))
    out = client.analyze(
        "why is db-0 failing?", tools=[ECHO_TOOL],
        system_prompt="you are an SRE",
    )

    # round trip: the tool executed and its output reached the final turn
    assert out["final_analysis"] == "db-0 is crash-looping"
    assert out["reasoning_steps"][0]["tool"] == "get_pod_logs"
    assert out["reasoning_steps"][0]["arguments"] == {"pod_name": "db-0"}

    first, second = fake.requests
    # OpenAI wire shape: tools wrapped as {"type": "function", "function"}
    assert first["tools"] == [{
        "type": "function",
        "function": ECHO_TOOL.schema(),
    }]
    assert first["messages"][0] == {
        "role": "system", "content": "you are an SRE",
    }
    assert first["messages"][1] == {
        "role": "user", "content": "why is db-0 failing?",
    }
    # second request replays the assistant tool call in OpenAI's nested
    # function shape with JSON-ENCODED arguments, then the tool result
    # bound by tool_call_id
    assistant = second["messages"][2]
    assert assistant["role"] == "assistant"
    assert assistant["tool_calls"] == [{
        "id": "call_1",
        "type": "function",
        "function": {
            "name": "get_pod_logs",
            "arguments": json.dumps({"pod_name": "db-0"}),
        },
    }]
    tool_msg = second["messages"][3]
    assert tool_msg["role"] == "tool"
    assert tool_msg["tool_call_id"] == "call_1"
    assert "logs-of-db-0" in tool_msg["content"]


def test_openai_json_mode_flag(monkeypatch):
    fake = install_openai_stub(monkeypatch, [
        _openai_text_response('{"a": 1}'),
    ])
    client = LLMClient(provider=_make_provider("openai"))
    out = client.generate_structured_output("give json")
    assert out == {"a": 1}
    assert fake.requests[0]["response_format"] == {"type": "json_object"}


def test_openai_malformed_tool_arguments_degrade_to_empty(monkeypatch):
    """SDKs deliver arguments as a JSON string; garbage must not crash the
    loop (providers._safe_json)."""
    resp = _Obj(choices=[_Obj(
        message=_Obj(content=None, tool_calls=[
            _Obj(id="x", function=_Obj(name="get_pod_logs",
                                       arguments="{not json")),
        ]),
        finish_reason="tool_calls",
    )])
    install_openai_stub(monkeypatch, [resp, _openai_text_response("done")])
    client = LLMClient(provider=_make_provider("openai"))
    out = client.analyze("q", tools=[ECHO_TOOL])
    assert out["final_analysis"] == "done"
    assert out["reasoning_steps"][0]["arguments"] == {}


# -- Anthropic wire format ---------------------------------------------------

def test_anthropic_request_shape_and_tool_roundtrip(monkeypatch):
    fake = install_anthropic_stub(monkeypatch, [
        _anthropic_tooluse_response(
            [{"id": "toolu_1", "name": "get_pod_logs",
              "arguments": {"pod_name": "db-0"}}]
        ),
        _anthropic_text_response("db-0 is crash-looping"),
    ])
    client = LLMClient(provider=_make_provider("anthropic"))
    out = client.analyze(
        "why is db-0 failing?", tools=[ECHO_TOOL],
        system_prompt="you are an SRE",
    )

    assert out["final_analysis"] == "db-0 is crash-looping"
    assert out["reasoning_steps"][0]["tool"] == "get_pod_logs"

    first, second = fake.requests
    # Anthropic wire shape: system is a TOP-LEVEL param, not a message
    assert first["system"] == "you are an SRE"
    assert all(m["role"] != "system" for m in first["messages"])
    # tools carry input_schema (not "parameters")
    assert first["tools"] == [{
        "name": "get_pod_logs",
        "description": "fetch pod logs",
        "input_schema": ECHO_TOOL.parameters,
    }]
    # the replayed assistant turn uses tool_use content blocks with DICT
    # input; the result returns as a user-role tool_result block
    assistant = second["messages"][1]
    assert assistant["role"] == "assistant"
    assert {"type": "tool_use", "id": "toolu_1", "name": "get_pod_logs",
            "input": {"pod_name": "db-0"}} in assistant["content"]
    result_msg = second["messages"][2]
    assert result_msg["role"] == "user"
    block = result_msg["content"][0]
    assert block["type"] == "tool_result"
    assert block["tool_use_id"] == "toolu_1"
    assert "logs-of-db-0" in block["content"]


def test_anthropic_json_mode_appends_instruction(monkeypatch):
    fake = install_anthropic_stub(monkeypatch, [
        _anthropic_text_response('```json\n{"b": 2}\n```'),
    ])
    client = LLMClient(provider=_make_provider("anthropic"))
    out = client.generate_structured_output("give json")
    # fenced-block rescue still applies to real-provider output
    assert out == {"b": 2}
    assert "valid JSON" in fake.requests[0]["system"]


def test_anthropic_multiblock_text_joined(monkeypatch):
    resp = _Obj(
        content=[
            _Obj(type="text", text="part one"),
            _Obj(type="text", text="part two"),
        ],
        stop_reason="end_turn",
    )
    install_anthropic_stub(monkeypatch, [resp])
    client = LLMClient(provider=_make_provider("anthropic"))
    assert client.generate_completion("q") == "part one\npart two"


# -- quota classification & failover ----------------------------------------

class _FakeRateLimitError(Exception):
    """Shaped like SDK rate-limit errors: classification is message-based
    (providers._classify_error), matching the reference's string checks
    (reference: utils/llm_client_improved.py:465-495)."""


@pytest.mark.parametrize("msg,expect_quota", [
    ("Error code: 429 - Rate limit reached for gpt-4o", True),
    ("You exceeded your current quota, please check your plan", True),
    ("rate_limit_error: Number of request tokens has exceeded", True),
    ("Error code: 500 - internal server error", False),
])
def test_quota_error_classification(monkeypatch, msg, expect_quota):
    install_openai_stub(monkeypatch, [_FakeRateLimitError(msg)])
    provider = _make_provider("openai")
    with pytest.raises(LLMUnavailable) as exc_info:
        provider.complete([{"role": "user", "content": "q"}])
    assert isinstance(exc_info.value, LLMQuotaExceeded) == expect_quota


def test_quota_failover_openai_to_anthropic(monkeypatch):
    """End-to-end runtime failover through LLMClient._complete: OpenAI 429s,
    the client fails over to Anthropic (stub) and sticks with it."""
    install_openai_stub(monkeypatch, [
        _FakeRateLimitError("Error code: 429 - rate limit"),
    ])
    install_anthropic_stub(monkeypatch, [
        _anthropic_text_response("anthropic took over"),
        _anthropic_text_response("still anthropic"),
    ])
    client = LLMClient(provider=_make_provider("openai"))
    assert client.generate_completion("q") == "anthropic took over"
    assert client.provider.name == "anthropic"  # sticky failover
    assert client.generate_completion("q2") == "still anthropic"


def test_quota_failover_lands_offline_when_all_keys_missing(monkeypatch):
    """Anthropic quota error with no other provider configured degrades to
    the deterministic offline provider instead of dying."""
    install_anthropic_stub(monkeypatch, [
        _FakeRateLimitError("rate_limit_error"),
    ])
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    client = LLMClient(provider=_make_provider("anthropic"))
    text = client.generate_completion("q")
    assert text.startswith("Offline analysis")
    assert client.provider.name == "offline"


def test_missing_key_raises_unavailable(monkeypatch):
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    from rca_tpu_torch.llm.providers import OpenAIProvider

    with pytest.raises(LLMUnavailable):
        OpenAIProvider()


# -- the port against the reference, output for output ------------------------

_KINDS = ("summary", "title", "chat_turn", "hypotheses", "verdict", "report",
          "suggestion_logs", "followups", "agent_findings", None)


@pytest.mark.parametrize("kind", _KINDS)
def test_offline_outputs_equal_reference(kind):
    """The offline provider's completions and structured outputs are the
    reference's for every prompt kind the investigation layer sends."""
    from rca_tpu.llm import LLMClient as RefClient
    from rca_tpu.llm import OfflineProvider as RefOffline

    prompt = f"Kubernetes question about {kind}: why is the database down?"
    port = LLMClient(provider=OfflineProvider())
    ref = RefClient(provider=RefOffline())
    kw = {} if kind is None else {"kind": kind}
    assert port.generate_completion(prompt, **kw) == ref.generate_completion(
        prompt, **kw)
    assert (port.generate_structured_output(prompt, **kw)
            == ref.generate_structured_output(prompt, **kw))


@pytest.mark.parametrize("text", [
    '{"a": 1}', '```json\n{"a": [1, 2]}\n```', 'noise {"b": "x"} tail',
    "not json at all", '{"unterminated": ', "[1, 2, 3]", "",
])
def test_parse_json_response_equals_reference(text):
    from rca_tpu.llm import parse_json_response as ref_parse

    assert parse_json_response(text) == ref_parse(text)


@pytest.mark.parametrize("world", ["5svc", "60svc_mixed"])
def test_prompts_and_toolsets_equal_reference(world):
    """The prompts, and every tool of every signal's toolset executed over
    each package's copy of one world, equal the reference's."""
    from rca_tpu.cluster.fixtures import five_service_world as ref_five
    from rca_tpu.cluster.generator import synthetic_cascade_world as ref_gen
    from rca_tpu.cluster.mock_client import MockClusterClient as RefClient
    from rca_tpu.llm import cluster_toolsets as ref_toolsets
    from rca_tpu.llm import prompts as ref_prompts
    from rca_tpu_torch.cluster.generator import synthetic_cascade_world
    from rca_tpu_torch.llm import prompts

    names = [n for n in dir(ref_prompts) if n.isupper()]
    assert names and names == [n for n in dir(prompts) if n.isupper()]
    for name in names:
        assert getattr(prompts, name) == getattr(ref_prompts, name), name
    if world == "5svc":
        port_world, ref_world, ns = five_service_world(), ref_five(), NS
    else:
        kw = dict(n_roots=2, seed=3, fault_mix="mixed", pods_per_service=2)
        port_world = synthetic_cascade_world(60, **kw)
        ref_world, ns = ref_gen(60, **kw), "synthetic"
    port_sets = cluster_toolsets(MockClusterClient(port_world), ns)
    ref_sets = ref_toolsets(RefClient(ref_world), ns)
    assert sorted(port_sets) == sorted(ref_sets)
    for signal, tools in ref_sets.items():
        assert ([(t.name, t.description, t.parameters) for t in port_sets[
            signal]] == [(t.name, t.description, t.parameters)
                         for t in tools]), signal
        for p, r in zip(port_sets[signal], tools):
            args = {k: "database-7c9f8b6d5e-3x5qp" if k.endswith("name")
                    else "Pod" if k == "kind" else 20
                    for k in r.parameters.get("required", [])}
            assert p.execute(args) == r.execute(args), (signal, r.name)
            assert p.execute({}) == r.execute({}), (signal, r.name)
