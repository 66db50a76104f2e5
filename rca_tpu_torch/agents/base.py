"""Agent contract + shared analysis context (the port's copy of
``rca_tpu.agents.base``).

Parity with the reference's two agent families (reference:
agents/base_agent.py:18-52 ``analyze() -> {agent_type, findings,
reasoning_steps}``; agents/mcp_agent.py:33-69 ``analyze(context) ->
{findings, reasoning_steps}``) with two deliberate changes:

- agents are **stateless**: ``analyze`` returns a fresh :class:`AgentResult`
  instead of mutating ``self.findings`` (the reference accumulated state
  across calls, reference: agents/base_agent.py:28-31 cleared lists by hand);
- agents share one :class:`AnalysisContext` so the snapshot is captured once
  and the packed feature arrays / typed graph are computed once, not
  re-fetched per agent (reference re-fetched per runner, reference:
  agents/mcp_coordinator.py:322-620).
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Any, Dict, List, Optional

from rca_tpu_torch.cluster.snapshot import ClusterSnapshot
from rca_tpu_torch.findings import make_finding, make_reasoning_step


@dataclasses.dataclass
class AnalysisContext:
    """One snapshot + lazily-computed derived arrays, shared by all agents.
    ``device`` is where the device passes of the analysis run (the
    topology agent's betweenness): CUDA unless the caller names another."""

    snapshot: ClusterSnapshot
    device: Any = None

    @cached_property
    def features(self):
        from rca_tpu_torch.features.extract import extract_features

        return extract_features(self.snapshot)

    @cached_property
    def graph(self):
        from rca_tpu_torch.graph.build import build_typed_graph

        return build_typed_graph(self.snapshot)

    @cached_property
    def dep_edges(self):
        from rca_tpu_torch.graph.build import service_dependency_edges

        return service_dependency_edges(self.snapshot, self.features, self.graph)

    @classmethod
    def capture(cls, client, namespace: str, device=None,
                **kw) -> "AnalysisContext":
        return cls(ClusterSnapshot.capture(client, namespace, **kw), device)


@dataclasses.dataclass
class AgentResult:
    agent_type: str
    findings: List[dict] = dataclasses.field(default_factory=list)
    reasoning_steps: List[dict] = dataclasses.field(default_factory=list)
    summary: str = ""
    data: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # findings are "as of the snapshot": one timestamp for the whole
    # analysis, taken from ClusterSnapshot.captured_at.  Per-finding
    # wall-clock stamps made two pipeline runs over the SAME world state
    # byte-differ whenever they straddled a second boundary (frozen mock
    # time makes them deterministic; live captures get one consistent
    # capture stamp).
    as_of: Optional[str] = None

    def add_finding(
        self,
        component: str,
        issue: str,
        severity: str,
        evidence: Any,
        recommendation: str,
        **extra: Any,
    ) -> dict:
        extra.setdefault("timestamp", self.as_of)
        f = make_finding(component, issue, severity, evidence, recommendation, **extra)
        self.findings.append(f)
        return f

    def add_step(self, observation: str, conclusion: str) -> dict:
        s = make_reasoning_step(observation, conclusion, timestamp=self.as_of)
        self.reasoning_steps.append(s)
        return s

    def to_dict(self) -> Dict[str, Any]:
        out = {
            "agent_type": self.agent_type,
            "findings": self.findings,
            "reasoning_steps": self.reasoning_steps,
            "summary": self.summary,
        }
        if self.data:
            out["data"] = self.data
        return out


class Agent:
    """Base class for the deterministic signal agents."""

    agent_type: str = "base"

    def analyze(self, ctx: AnalysisContext) -> AgentResult:
        raise NotImplementedError

    def analyze_snapshot(self, snapshot: ClusterSnapshot,
                         device=None) -> AgentResult:
        return self.analyze(AnalysisContext(snapshot, device))


def pod_component(name: str) -> str:
    return f"Pod/{name}"


def summarize(result: AgentResult, what: str) -> None:
    """Fill ``result.summary`` with a one-line severity rollup."""
    if not result.findings:
        result.summary = f"No {what} issues detected."
        return
    counts: Dict[str, int] = {}
    for f in result.findings:
        counts[f["severity"]] = counts.get(f["severity"], 0) + 1
    parts = ", ".join(
        f"{counts[s]} {s}"
        for s in ("critical", "high", "medium", "low", "info")
        if s in counts
    )
    result.summary = f"{len(result.findings)} {what} finding(s): {parts}."
