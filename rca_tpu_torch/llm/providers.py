"""LLM provider backends: OpenAI, Anthropic, and a hermetic offline fake.

Parity with the reference's provider handling (reference:
utils/llm_client_improved.py:39-66 provider init, gpt-4o /
claude-3-5-sonnet-20241022 defaults) with three deliberate changes:

- a missing API key raises :class:`LLMUnavailable` instead of hard-exiting
  the process (reference: llm_client_improved.py:44-48 called ``sys.exit``);
- every provider implements one small surface — ``complete(messages, tools)``
  returning text plus structured tool calls — so the tool loop in
  :meth:`rca_tpu_torch.llm.client.LLMClient.analyze` actually executes tools (the
  reference accepted a ``tools`` argument and ignored it, reference:
  llm_client_improved.py:68);
- an :class:`OfflineProvider` provides deterministic, network-free behavior
  so the hermetic path has zero network deps (SURVEY.md §7 hard parts).
"""

from __future__ import annotations

import dataclasses
import json
import os

from rca_tpu_torch.config import env_raw, env_str
from typing import Any, Callable, Dict, List, Optional

DEFAULT_OPENAI_MODEL = "gpt-4o"
DEFAULT_ANTHROPIC_MODEL = "claude-3-5-sonnet-20241022"


class LLMUnavailable(RuntimeError):
    """Provider cannot run (missing SDK, missing key, or quota exhausted)."""


class LLMQuotaExceeded(LLMUnavailable):
    """Rate-limit / quota error — callers may fail over to another provider
    (reference: app.py:50-67 OpenAI→Anthropic failover)."""


@dataclasses.dataclass
class ToolCall:
    id: str
    name: str
    arguments: Dict[str, Any]


@dataclasses.dataclass
class ProviderReply:
    text: str
    tool_calls: List[ToolCall] = dataclasses.field(default_factory=list)
    stop_reason: str = "end"


class Provider:
    """Minimal chat-completion surface shared by all backends.

    ``messages`` is a provider-neutral list of
    ``{"role": "system"|"user"|"assistant"|"tool", "content": str,
    "tool_calls"?: [...], "tool_call_id"?: str}``.
    ``tools`` is a list of ``{"name", "description", "parameters"}`` JSON
    schemas.
    """

    name = "base"
    model = ""

    def complete(
        self,
        messages: List[dict],
        tools: Optional[List[dict]] = None,
        temperature: float = 0.2,
        max_tokens: int = 2000,
        json_mode: bool = False,
    ) -> ProviderReply:
        raise NotImplementedError


class OpenAIProvider(Provider):
    name = "openai"

    def __init__(self, model: str = DEFAULT_OPENAI_MODEL):
        key = env_raw("OPENAI_API_KEY")
        if not key:
            raise LLMUnavailable("OPENAI_API_KEY is not set")
        try:
            import openai  # noqa: F401
        except ImportError as e:  # pragma: no cover - env dependent
            raise LLMUnavailable("openai SDK not installed") from e
        from openai import OpenAI

        self._client = OpenAI(api_key=key)
        self.model = model

    def complete(self, messages, tools=None, temperature=0.2,
                 max_tokens=2000, json_mode=False) -> ProviderReply:
        kwargs: Dict[str, Any] = {}
        if tools:
            kwargs["tools"] = [
                {"type": "function", "function": t} for t in tools
            ]
        if json_mode:
            kwargs["response_format"] = {"type": "json_object"}
        oai_messages = []
        for m in messages:
            if m["role"] == "tool":
                oai_messages.append(
                    {"role": "tool", "tool_call_id": m["tool_call_id"],
                     "content": m["content"]}
                )
            elif m["role"] == "assistant" and m.get("tool_calls"):
                oai_messages.append(
                    {
                        "role": "assistant",
                        "content": m.get("content") or None,
                        "tool_calls": [
                            {
                                "id": tc["id"],
                                "type": "function",
                                "function": {
                                    "name": tc["name"],
                                    "arguments": json.dumps(tc["arguments"]),
                                },
                            }
                            for tc in m["tool_calls"]
                        ],
                    }
                )
            else:
                oai_messages.append({"role": m["role"], "content": m["content"]})
        try:
            resp = self._client.chat.completions.create(
                model=self.model, messages=oai_messages,
                temperature=temperature, max_tokens=max_tokens, **kwargs,
            )
        except Exception as e:  # pragma: no cover - network dependent
            raise _classify_error(e, self.name) from e
        choice = resp.choices[0]
        calls = [
            ToolCall(
                id=tc.id, name=tc.function.name,
                arguments=_safe_json(tc.function.arguments),
            )
            for tc in (choice.message.tool_calls or [])
        ]
        return ProviderReply(
            text=choice.message.content or "",
            tool_calls=calls,
            stop_reason=choice.finish_reason or "end",
        )


class AnthropicProvider(Provider):
    name = "anthropic"

    def __init__(self, model: str = DEFAULT_ANTHROPIC_MODEL):
        key = env_raw("ANTHROPIC_API_KEY")
        if not key:
            raise LLMUnavailable("ANTHROPIC_API_KEY is not set")
        try:
            import anthropic  # noqa: F401
        except ImportError as e:  # pragma: no cover - env dependent
            raise LLMUnavailable("anthropic SDK not installed") from e
        from anthropic import Anthropic

        self._client = Anthropic(api_key=key)
        self.model = model

    def complete(self, messages, tools=None, temperature=0.2,
                 max_tokens=2000, json_mode=False) -> ProviderReply:
        system = "\n".join(
            m["content"] for m in messages if m["role"] == "system"
        )
        if json_mode:
            system = (system + "\nRespond ONLY with valid JSON.").strip()
        conv: List[dict] = []
        for m in messages:
            if m["role"] == "system":
                continue
            if m["role"] == "tool":
                conv.append(
                    {
                        "role": "user",
                        "content": [
                            {
                                "type": "tool_result",
                                "tool_use_id": m["tool_call_id"],
                                "content": m["content"],
                            }
                        ],
                    }
                )
            elif m["role"] == "assistant" and m.get("tool_calls"):
                blocks: List[dict] = []
                if m.get("content"):
                    blocks.append({"type": "text", "text": m["content"]})
                blocks += [
                    {
                        "type": "tool_use",
                        "id": tc["id"],
                        "name": tc["name"],
                        "input": tc["arguments"],
                    }
                    for tc in m["tool_calls"]
                ]
                conv.append({"role": "assistant", "content": blocks})
            else:
                conv.append({"role": m["role"], "content": m["content"]})
        kwargs: Dict[str, Any] = {}
        if tools:
            kwargs["tools"] = [
                {
                    "name": t["name"],
                    "description": t.get("description", ""),
                    "input_schema": t.get(
                        "parameters", {"type": "object", "properties": {}}
                    ),
                }
                for t in tools
            ]
        try:
            resp = self._client.messages.create(
                model=self.model,
                system=system or None,
                messages=conv,
                temperature=temperature,
                max_tokens=max_tokens,
                **kwargs,
            )
        except Exception as e:  # pragma: no cover - network dependent
            raise _classify_error(e, self.name) from e
        text_parts, calls = [], []
        for block in resp.content:
            if block.type == "text":
                text_parts.append(block.text)
            elif block.type == "tool_use":
                calls.append(
                    ToolCall(id=block.id, name=block.name,
                             arguments=dict(block.input or {}))
                )
        return ProviderReply(
            text="\n".join(text_parts),
            tool_calls=calls,
            stop_reason=resp.stop_reason or "end",
        )


class OfflineProvider(Provider):
    """Deterministic hermetic provider.

    Behavior contract (what tests rely on):

    - when tools are offered and none has been called yet, it requests every
      offered tool once (exercising the real tool loop);
    - after tool results arrive, it emits a final text that embeds the tool
      outputs, so the loop's result provably contains executed-tool data;
    - in ``json_mode`` it returns a minimal valid JSON object echoing the
      prompt's requested shape when recognizable.
    """

    name = "offline"
    model = "offline-deterministic"

    def __init__(self, scripted: Optional[Callable[[List[dict]], str]] = None):
        self._scripted = scripted
        self._counter = 0

    def complete(self, messages, tools=None, temperature=0.2,
                 max_tokens=2000, json_mode=False) -> ProviderReply:
        if self._scripted is not None:
            return ProviderReply(text=self._scripted(messages))
        called = {
            tc["name"]
            for m in messages
            if m["role"] == "assistant"
            for tc in m.get("tool_calls", [])
        }
        if tools and not called:
            calls = []
            for t in tools:
                self._counter += 1
                args = {
                    k: v.get("default", "")
                    for k, v in (
                        t.get("parameters", {}).get("properties", {}) or {}
                    ).items()
                    if k in t.get("parameters", {}).get("required", [])
                }
                calls.append(
                    ToolCall(id=f"offline-{self._counter}", name=t["name"],
                             arguments=args)
                )
            return ProviderReply(text="", tool_calls=calls,
                                 stop_reason="tool_use")
        tool_payloads = [
            m["content"] for m in messages if m["role"] == "tool"
        ]
        if json_mode:
            return ProviderReply(
                text=json.dumps(
                    {
                        "summary": "offline deterministic analysis",
                        "observations": [p[:2000] for p in tool_payloads[:5]],
                    }
                )
            )
        body = "\n".join(p[:2000] for p in tool_payloads)
        return ProviderReply(
            text="Offline analysis over gathered evidence:\n" + body
            if body
            else "Offline analysis: no tool evidence gathered.",
        )


def _safe_json(s: str) -> Dict[str, Any]:
    try:
        out = json.loads(s)
        return out if isinstance(out, dict) else {}
    except (json.JSONDecodeError, TypeError):
        return {}


def _classify_error(e: Exception, provider: str = "") -> LLMUnavailable:
    # the provider name rides in the message: a failure surfacing
    # mid-failover must say WHICH backend died, and callers chain the
    # original via ``raise _classify_error(e, name) from e`` so the root
    # quota error is never dropped
    prefix = f"{provider}: " if provider else ""
    msg = str(e).lower()
    if any(k in msg for k in ("quota", "rate limit", "rate_limit", "429")):
        return LLMQuotaExceeded(f"{prefix}{e}")
    return LLMUnavailable(f"{prefix}{e}")


def make_provider(name: Optional[str] = None) -> Provider:
    """Resolve a provider by name or environment.

    ``RCA_LLM_PROVIDER`` ∈ {openai, anthropic, offline}; unset → first of
    anthropic/openai whose key+SDK is available, else offline (reference
    default order: app.py:45-67).
    """
    name = (name or env_str("RCA_LLM_PROVIDER", "")).lower()
    if name == "openai":
        return OpenAIProvider()
    if name == "anthropic":
        return AnthropicProvider()
    if name == "offline":
        return OfflineProvider()
    for cls in (AnthropicProvider, OpenAIProvider):
        try:
            return cls()
        except LLMUnavailable:
            continue
    return OfflineProvider()
