"""LLMClient: analyze / structured output / completion, with a REAL tool loop.

Surface parity with the reference (reference: utils/llm_client_improved.py —
``analyze(context, tools, system_prompt)`` :68, ``generate_structured_output``
:163 with fenced-block rescue :257-262, ``generate_completion`` :384 with
max_tokens=2000 / temperature=0.2 defaults) plus the tool-execution loop the
reference declared but never ran (its ``tools`` argument was ignored,
reference: llm_client_improved.py:68; SURVEY.md §2.3 "the loop is
vestigial").  Every LLM interaction is reported to an optional ``log_fn``
hook (wired to the PromptLogger, reference format:
utils/prompt_logger.py:76-89).
"""

from __future__ import annotations

import json
import re
from typing import Any, Callable, Dict, List, Optional, Sequence

from rca_tpu_torch.llm.providers import (
    LLMQuotaExceeded,
    LLMUnavailable,
    OfflineProvider,
    Provider,
    ProviderReply,
    make_provider,
)
from rca_tpu_torch.llm.tools import ToolSpec
from rca_tpu_torch.resilience.policy import CircuitBreaker, CircuitOpen, suppressed

MAX_TOOL_ROUNDS = 6

LogFn = Callable[[Dict[str, Any]], None]

# quota-failover chain (reference: app.py:50-67 fell over from OpenAI to
# Anthropic on quota errors; here any provider can fail over, ending at the
# deterministic offline provider so analysis never dies on a 429)
_FAILOVER_ORDER = ("anthropic", "openai", "offline")

# breaker defaults: a provider that 429s twice in a row is held out of the
# rotation for BREAKER_RESET_S, then probed half-open — replaces the
# a one-shot failover, which hammered a quota-exhausted provider on
# every completion until the process died or the quota reset
BREAKER_FAILURES = 2
BREAKER_RESET_S = 30.0


class LLMClient:
    def __init__(
        self,
        provider: Optional[Provider] = None,
        provider_name: Optional[str] = None,
        log_fn: Optional[LogFn] = None,
        breakers: Optional[Dict[str, CircuitBreaker]] = None,
    ):
        self.provider = provider or make_provider(provider_name)
        self.log_fn = log_fn
        # one breaker per provider NAME (injectable for hermetic tests)
        self._breakers: Dict[str, CircuitBreaker] = breakers or {}

    def _breaker(self, name: str) -> CircuitBreaker:
        br = self._breakers.get(name)
        if br is None:
            br = self._breakers[name] = CircuitBreaker(
                failure_threshold=BREAKER_FAILURES,
                reset_after=BREAKER_RESET_S, name=f"llm.{name}",
            )
        return br

    def _complete(self, messages, **kwargs) -> ProviderReply:
        """One completion with breaker-gated provider rotation.

        The current provider runs only when its circuit allows; a quota
        failure (or an open circuit) rotates through ``_FAILOVER_ORDER``,
        skipping providers whose breakers are open, sticking with the
        first that answers.  The offline provider ends every chain, so
        analysis never dies on a 429.  If the whole rotation fails, the
        raised error CHAINS the original quota failure (satellite fix:
        an earlier version dropped it)."""
        primary = self.provider
        first_exc: Optional[LLMUnavailable] = None
        br = self._breaker(primary.name)
        if br.allow():
            try:
                reply = primary.complete(messages, **kwargs)
                br.record_success()
                return reply
            except LLMQuotaExceeded as exc:
                br.record_failure()
                first_exc = exc
        else:
            first_exc = CircuitOpen(
                f"provider {primary.name!r} circuit open "
                "(recent quota failures)"
            )
        for name in _FAILOVER_ORDER:
            if name == primary.name:
                continue
            cand_br = self._breaker(name)
            if not cand_br.allow():
                continue
            try:
                candidate = (
                    OfflineProvider() if name == "offline"
                    else make_provider(name)
                )
                reply = candidate.complete(messages, **kwargs)
            except LLMUnavailable:
                cand_br.record_failure()
                continue
            cand_br.record_success()
            self.provider = candidate  # stick with the working provider
            self._log(
                "", "", kind="provider_failover",
                failed_provider=primary.name, new_provider=candidate.name,
            )
            return reply
        raise LLMUnavailable(
            f"all providers exhausted after failure on {primary.name!r}"
        ) from first_exc

    # -- logging -----------------------------------------------------------
    def _log(self, prompt: str, response: str, **context: Any) -> None:
        if self.log_fn is None:
            return
        # observability must never break analysis — but the swallow goes
        # through the policy channel so it is still visible in health
        with suppressed("llm.log_fn"):
            self.log_fn(
                {
                    "prompt": prompt,
                    "response": response,
                    "additional_context": {
                        "provider": self.provider.name,
                        "model": self.provider.model,
                        **context,
                    },
                }
            )

    # -- tool loop ----------------------------------------------------------
    def analyze(
        self,
        context: str,
        tools: Optional[Sequence[ToolSpec]] = None,
        system_prompt: str = "",
        max_rounds: int = MAX_TOOL_ROUNDS,
    ) -> Dict[str, Any]:
        """Multi-round tool-calling analysis.

        Returns ``{final_analysis, reasoning_steps}`` where each reasoning
        step records a real executed tool call (name, arguments, result
        excerpt) — the audit trail the reference's vestigial loop never
        produced.
        """
        tool_map = {t.name: t for t in tools or []}
        schemas = [t.schema() for t in tools or []]
        messages: List[dict] = []
        if system_prompt:
            messages.append({"role": "system", "content": system_prompt})
        messages.append({"role": "user", "content": context})
        steps: List[dict] = []

        reply: ProviderReply = self._complete(messages, tools=schemas or None)
        rounds = 0
        while reply.tool_calls and rounds < max_rounds:
            rounds += 1
            messages.append(
                {
                    "role": "assistant",
                    "content": reply.text,
                    "tool_calls": [
                        {"id": tc.id, "name": tc.name,
                         "arguments": tc.arguments}
                        for tc in reply.tool_calls
                    ],
                }
            )
            for tc in reply.tool_calls:
                spec = tool_map.get(tc.name)
                if spec is None:
                    result = json.dumps({"error": f"unknown tool {tc.name}"})
                else:
                    result = spec.execute(tc.arguments)
                steps.append(
                    {
                        "observation": (
                            f"tool {tc.name}({json.dumps(tc.arguments)}) -> "
                            f"{result[:400]}"
                        ),
                        "conclusion": "evidence gathered",
                        "tool": tc.name,
                        "arguments": tc.arguments,
                    }
                )
                messages.append(
                    {"role": "tool", "tool_call_id": tc.id, "content": result}
                )
            reply = self._complete(messages, tools=schemas or None)

        self._log(context, reply.text, kind="analyze", tool_rounds=rounds)
        return {"final_analysis": reply.text, "reasoning_steps": steps}

    # -- structured output ---------------------------------------------------
    def generate_structured_output(
        self,
        prompt: str,
        system_prompt: str = "",
        **log_context: Any,
    ) -> Optional[Dict[str, Any]]:
        messages: List[dict] = []
        if system_prompt:
            messages.append({"role": "system", "content": system_prompt})
        messages.append({"role": "user", "content": prompt})
        reply = self._complete(messages, json_mode=True)
        self._log(prompt, reply.text, **{"kind": "structured", **log_context})
        return parse_json_response(reply.text)

    # -- plain completion ----------------------------------------------------
    def generate_completion(
        self,
        prompt: str,
        system_prompt: str = "",
        temperature: float = 0.2,
        max_tokens: int = 2000,
        **log_context: Any,
    ) -> str:
        messages: List[dict] = []
        if system_prompt:
            messages.append({"role": "system", "content": system_prompt})
        messages.append({"role": "user", "content": prompt})
        reply = self._complete(
            messages, temperature=temperature, max_tokens=max_tokens
        )
        self._log(prompt, reply.text, **{"kind": "completion", **log_context})
        return reply.text


_FENCED = re.compile(r"```(?:json)?\s*(\{.*?\}|\[.*?\])\s*```", re.S)


def parse_json_response(text: str) -> Optional[Dict[str, Any]]:
    """Parse a JSON object from model output, rescuing fenced blocks and
    leading/trailing prose (reference: llm_client_improved.py:257-262)."""
    if not text:
        return None
    for candidate in (text, *(m for m in _FENCED.findall(text))):
        try:
            out = json.loads(candidate)
            if isinstance(out, dict):
                return out
        except json.JSONDecodeError:
            continue
    # last resort: widest braces span
    start, end = text.find("{"), text.rfind("}")
    if 0 <= start < end:
        try:
            out = json.loads(text[start : end + 1])
            if isinstance(out, dict):
                return out
        except json.JSONDecodeError:
            pass
    return None
