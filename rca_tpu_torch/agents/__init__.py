"""Deterministic signal agents: the port's copy of ``rca_tpu.agents``
(their tool-driven LLM twins are in :mod:`.llm_agent`).

Six agents mirroring the reference's signal coverage (reference: agents/ —
metrics, logs, events, topology, traces, resource_analyzer), each a stateless
``analyze(AnalysisContext) -> AgentResult`` over one shared snapshot +
packed-feature view.
"""

from rca_tpu_torch.agents.base import Agent, AgentResult, AnalysisContext
from rca_tpu_torch.agents.events import EventsAgent
from rca_tpu_torch.agents.logs import LogsAgent
from rca_tpu_torch.agents.metrics import MetricsAgent
from rca_tpu_torch.agents.resources import ResourceAgent
from rca_tpu_torch.agents.topology import TopologyAgent
from rca_tpu_torch.agents.traces import TracesAgent

ALL_AGENT_TYPES = [
    "resources", "metrics", "logs", "events", "topology", "traces",
]


def make_agents():
    """All six signal agents in comprehensive-pipeline order (reference:
    agents/mcp_coordinator.py:637-645)."""
    return {
        "resources": ResourceAgent(),
        "metrics": MetricsAgent(),
        "logs": LogsAgent(),
        "events": EventsAgent(),
        "topology": TopologyAgent(),
        "traces": TracesAgent(),
    }


__all__ = [
    "Agent",
    "AgentResult",
    "AnalysisContext",
    "ALL_AGENT_TYPES",
    "EventsAgent",
    "LogsAgent",
    "MetricsAgent",
    "ResourceAgent",
    "TopologyAgent",
    "TracesAgent",
    "make_agents",
]
