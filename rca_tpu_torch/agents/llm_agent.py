"""LLM agent family: tool-driven evidence gathering behind the Agent API.

The reference's MCP agents (reference: agents/mcp_agent.py:33-69) sent one
context blob to the LLM, declared tools that were never invoked, and parsed
findings out of ``Issue:/Component:/Severity:`` markdown headers
(reference: agents/mcp_agent.py:170-251).  This family:

- runs a REAL tool loop (rca_tpu_torch.llm.client.LLMClient.analyze) against the
  typed cluster client, so evidence in the answer is evidence that was
  actually fetched;
- requests findings as structured JSON instead of header-parsing;
- degrades deterministically: with the offline provider (or on any LLM
  failure) it falls back to the deterministic rule agent of the same signal,
  so `analyze` always returns findings (reference behavior on failure was an
  empty findings list swallowed by try/except, mcp_agent.py:60-69).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from rca_tpu_torch.agents.base import Agent, AgentResult, AnalysisContext, summarize
from rca_tpu_torch.findings import SEVERITY_ORDER
from rca_tpu_torch.llm.client import LLMClient
from rca_tpu_torch.llm.tools import ToolSpec, cluster_toolsets

_SEVERITY_GUIDE = (
    " Severity scale: info, low, medium, high, critical. Be specific: name "
    "components, cite the evidence you fetched."
)

# Per-signal system prompts (reference declares these per agent class:
# agents/mcp_metrics_agent.py / mcp_logs_agent.py / mcp_events_agent.py /
# mcp_topology_agent.py / mcp_traces_agent.py, each _get_system_prompt; the
# resources signal maps to resource_analyzer.py's sweep).  Unlike the
# reference, these prompts instruct the model to USE the tools, because our
# loop really executes them.
_SIGNAL_PROMPTS: Dict[str, str] = {
    "metrics": (
        "You are a Kubernetes metrics analyst. Use the tools to fetch pod "
        "and node CPU/memory usage, HPA state, and resource quotas. Flag "
        "utilization above 80% (above 90% is high severity), missing "
        "requests/limits, HPAs pinned at max or with desired > current "
        "replicas, and node pressure."
    ),
    "logs": (
        "You are a Kubernetes log analyst. Use the tools to pull logs from "
        "suspicious pods (crash-looping, restarting, failed) and search for "
        "error patterns: OOM kills, connection refused, permission denied, "
        "timeouts, crash loops, API errors, volume mounts, image pulls, DNS "
        "failures, auth errors, config errors, 5xx, exceptions."
    ),
    "events": (
        "You are a Kubernetes events analyst. Use the tools to fetch "
        "namespace and per-resource events. Group events by involved "
        "object; flag scheduling failures, volume problems, frequently "
        "repeating warnings, control-plane component errors, and node "
        "condition problems (NotReady, MemoryPressure, DiskPressure)."
    ),
    "topology": (
        "You are a Kubernetes topology analyst. Use the tools to map "
        "services, endpoints, deployments, ingresses, and network "
        "policies. Flag services whose selectors match no ready pods, "
        "ingresses routing to missing backends, dependency cycles, "
        "single points of failure (high-fanin services with replicas < 2), "
        "and over-permissive or missing network policies."
    ),
    "traces": (
        "You are a distributed-tracing analyst. Use the tools to fetch "
        "per-service latency percentiles, error rates, the service "
        "dependency map, and slow operations. Flag services with elevated "
        "p99 latency or error rate, and trace the failure to the most "
        "upstream unhealthy dependency."
    ),
    "resources": (
        "You are a Kubernetes resource-health analyst. Use the tools to "
        "sweep pods, deployments, and events in the namespace. Flag "
        "crash-looping / image-pull-failed / pending / evicted pods, "
        "deployments with ready < desired replicas, selector mismatches, "
        "and correlate warning events with the affected objects."
    ),
}

_SYSTEM_TEMPLATE = (
    "{prompt} Investigate the {signal} signal for the namespace described "
    "by the user, calling tools to gather real evidence before concluding."
    + _SEVERITY_GUIDE
)

_FINDINGS_PROMPT = (
    "Convert this {signal} analysis into JSON: "
    '{{"findings": [{{"component": "Kind/name", "issue": "...", '
    '"severity": "info|low|medium|high|critical", "evidence": "...", '
    '"recommendation": "..."}}], "summary": "one line"}}.\n'
    "Analysis:\n{analysis}"
)


class LLMAgent(Agent):
    """One LLM-driven signal agent with a deterministic fallback twin."""

    def __init__(
        self,
        agent_type: str,
        client: LLMClient,
        tools: Optional[List[ToolSpec]] = None,
        fallback: Optional[Agent] = None,
        cluster_client=None,
        tools_namespace: Optional[str] = None,
    ):
        self.agent_type = agent_type
        self.client = client
        self.tools = tools or []
        self.fallback = fallback
        self.cluster_client = cluster_client
        self._tools_ns = tools_namespace if self.tools else None
        self._toolset_cache: Dict[str, List[ToolSpec]] = {}

    # tools are bound per-namespace at ANALYZE time (from the snapshot's
    # namespace) unless preset for that same namespace — binding at
    # construction time with an unknown namespace would aim every tool at
    # the wrong place.
    def _tools_for(self, ctx: AnalysisContext, client) -> List[ToolSpec]:
        ns = ctx.snapshot.namespace
        # preset tools are trusted only for the namespace they were bound
        # to (or when no client is available to rebind them)
        if self.tools and (self._tools_ns == ns or client is None):
            return self.tools
        if client is None:
            return []
        if client is not self.cluster_client:
            # ad-hoc client for this one call: build fresh, don't retain it
            return cluster_toolsets(client, ns).get(self.agent_type, [])
        if ns not in self._toolset_cache:
            self._toolset_cache[ns] = cluster_toolsets(client, ns).get(
                self.agent_type, []
            )
        return self._toolset_cache[ns]

    def analyze(
        self, ctx: AnalysisContext, cluster_client=None
    ) -> AgentResult:
        r = AgentResult(self.agent_type, as_of=ctx.snapshot.captured_at)
        tools = self._tools_for(ctx, cluster_client or self.cluster_client)
        context = self._context_blob(ctx)
        system_prompt = _SYSTEM_TEMPLATE.format(
            prompt=_SIGNAL_PROMPTS.get(
                self.agent_type,
                f"You are a Kubernetes {self.agent_type} analyst.",
            ),
            signal=self.agent_type,
        )
        try:
            out = self.client.analyze(
                context, tools=tools, system_prompt=system_prompt,
            )
        except Exception as e:
            return self._fall_back(ctx, r, f"LLM analyze failed: {e}")
        r.reasoning_steps.extend(out.get("reasoning_steps", []))
        analysis = out.get("final_analysis", "")

        try:
            structured = self.client.generate_structured_output(
                _FINDINGS_PROMPT.format(
                    signal=self.agent_type, analysis=analysis[:6000]
                )
            )
        except Exception as e:
            return self._fall_back(
                ctx, r, f"structured output failed: {e}", narrative=analysis,
            )
        findings = (structured or {}).get("findings")
        if isinstance(findings, list) and findings:
            for f in findings:
                if not isinstance(f, dict):
                    continue
                sev = str(f.get("severity", "info")).lower()
                r.add_finding(
                    str(f.get("component", "unknown")),
                    str(f.get("issue", "")),
                    sev if sev in SEVERITY_ORDER else "info",
                    f.get("evidence", ""),
                    str(f.get("recommendation", "")),
                    source="llm",
                )
            r.summary = str((structured or {}).get("summary", "")) or analysis[:200]
            r.data["final_analysis"] = analysis
            return r
        # no structured findings (offline provider or parse failure):
        # deterministic twin provides findings, LLM text kept as narrative
        return self._fall_back(
            ctx, r, "no structured findings from provider",
            narrative=analysis,
        )

    # ------------------------------------------------------------------
    def _fall_back(
        self,
        ctx: AnalysisContext,
        r: AgentResult,
        reason: str,
        narrative: str = "",
    ) -> AgentResult:
        r.add_step(
            f"LLM path degraded ({reason}); using deterministic "
            f"{self.agent_type} rules.",
            "Findings below come from the rule agent.",
        )
        if narrative:
            r.data["final_analysis"] = narrative
        if self.fallback is not None:
            det = self.fallback.analyze(ctx)
            r.findings.extend(det.findings)
            r.reasoning_steps.extend(det.reasoning_steps)
            r.data.update(det.data)
        summarize(r, self.agent_type)
        return r

    def _context_blob(self, ctx: AnalysisContext) -> str:
        """Compact cluster context for the first LLM turn (counts, not dumps —
        the tools exist to fetch detail)."""
        snap = ctx.snapshot
        fs = ctx.features
        phases: Dict[str, int] = {}
        for p in snap.pods:
            ph = p.get("status", {}).get("phase", "Unknown")
            phases[ph] = phases.get(ph, 0) + 1
        blob: Dict[str, Any] = {
            "namespace": snap.namespace,
            "captured_at": snap.captured_at,
            "pods_by_phase": phases,
            "services": fs.service_names,
            "warning_events": sum(
                1 for e in snap.events if e.get("type") != "Normal"
            ),
            "task": (
                f"Analyze the {self.agent_type} signal for this namespace "
                "and identify problems with evidence."
            ),
        }
        return json.dumps(blob)


def make_llm_agents(
    client: LLMClient, cluster_client=None, namespace: str = ""
) -> Dict[str, LLMAgent]:
    """LLM agent per signal, each with its deterministic twin as fallback.

    When ``namespace`` is given, tools are pre-bound to it; otherwise each
    agent binds its toolset at analyze time from the snapshot's namespace
    (so one agent set serves every namespace the coordinator analyzes).
    """
    from rca_tpu_torch.agents import make_agents

    det = make_agents()
    toolsets = (
        cluster_toolsets(cluster_client, namespace)
        if (cluster_client and namespace) else {}
    )
    return {
        name: LLMAgent(
            name, client,
            tools=toolsets.get(name),
            fallback=det[name],
            cluster_client=cluster_client,
            tools_namespace=namespace or None,
        )
        for name in det
    }
