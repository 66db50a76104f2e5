"""Evidence fusion: agent findings → ranked root causes (the port's copy of
``rca_tpu.coordinator.correlate``).

Two backends behind one function (``RCA_BACKEND``):

- ``deterministic`` — group by component, rank by max-severity ×
  related-finding count (parity with the reference's legacy coordinator,
  reference: agents/coordinator.py:118-184);
- ``torch`` — the port's engine: explain-away propagation over the
  service dependency graph (:mod:`rca_tpu_torch.engine`), agent findings
  attached as supporting evidence per ranked service.  Scores differ from
  the deterministic rank but the grouped findings JSON is identical.  It is
  the twin of the JAX package's ``jax`` backend.

The LLM backend of the JAX package is not ported.

Both backends return the same schema:
``{root_causes: [{component, severity, score, finding_count, findings[]}],
groups: {component: [finding,...]}, backend, summary}``.
"""

from __future__ import annotations

import re
from typing import AbstractSet, Any, Dict, List, Optional

from rca_tpu_torch.agents.base import AnalysisContext
from rca_tpu_torch.config import env_str, explain_enabled
from rca_tpu_torch.findings import attach_provenance, max_severity, severity_rank

_SERVICE_SUFFIX = re.compile(r"-[a-z0-9]{8,10}-[a-z0-9]{5}$")


BACKENDS = ("torch", "deterministic")


def default_backend() -> str:
    return env_str("RCA_BACKEND", "torch", choices=BACKENDS, lower=True)


def resolve_backend(backend: Optional[str] = None) -> str:
    """``backend``, else ``RCA_BACKEND``, else ``torch``; raises on a
    backend the port does not have."""
    name = (backend or default_backend()).lower()
    if name not in BACKENDS:
        raise ValueError(
            f"unknown backend {name!r}: expected one of {BACKENDS}"
        )
    return name


def _component_service(
    component: str, service_names: AbstractSet[str]
) -> Optional[str]:
    """Map 'Pod/frontend-7d8f675c7b-jk2x5' / 'Deployment/frontend' /
    'Service/frontend' onto a service name.  Pass a SET — with a list the
    membership probes make the grouping O(findings × services), which
    measured 2.6 s of a 3.1 s correlate at 10k services."""
    if "/" not in component:
        return component if component in service_names else None
    kind, name = component.split("/", 1)
    if name in service_names:
        return name
    if kind == "Pod":
        base = _SERVICE_SUFFIX.sub("", name)
        if base in service_names:
            return base
        # single-suffix forms (statefulset ordinals, bare replicaset hash)
        while "-" in base:
            base = base.rsplit("-", 1)[0]
            if base in service_names:
                return base
    return None


def group_findings(
    agent_results: Dict[str, Any]
) -> Dict[str, List[dict]]:
    """Flatten every agent's findings, tag source, group by component
    (reference: mcp_coordinator.py:666-698 flatten+tag; coordinator.py:118
    group-by-component)."""
    groups: Dict[str, List[dict]] = {}
    for agent_type, result in agent_results.items():
        findings = (
            result.get("findings", []) if isinstance(result, dict)
            else getattr(result, "findings", [])
        )
        for f in findings:
            tagged = {**f, "source": f.get("source", agent_type)}
            groups.setdefault(str(f.get("component", "unknown")), []).append(
                tagged
            )
    return groups


def _rank_entry(component: str, findings: List[dict], score: float) -> dict:
    return {
        "component": component,
        "severity": max_severity(f.get("severity", "info") for f in findings),
        "score": round(float(score), 4),
        "finding_count": len(findings),
        "findings": findings,
    }


def correlate_deterministic(
    agent_results: Dict[str, Any], top_k: int = 10
) -> Dict[str, Any]:
    groups = group_findings(agent_results)
    ranked = []
    for component, findings in groups.items():
        sev = max(severity_rank(f.get("severity", "info")) for f in findings)
        score = (sev + 1) * 10 + len(findings)
        ranked.append(_rank_entry(component, findings, score))
    ranked.sort(key=lambda r: (-r["score"], r["component"]))
    top = ranked[:top_k]
    summary = (
        f"{len(groups)} component(s) with findings; top root cause: "
        f"{top[0]['component']} ({top[0]['severity']})"
        if top else "No findings to correlate."
    )
    return {
        "root_causes": top,
        "groups": groups,
        "backend": "deterministic",
        "summary": summary,
    }


def correlate_torch(
    agent_results: Dict[str, Any],
    ctx: AnalysisContext,
    top_k: int = 10,
    engine=None,
) -> Dict[str, Any]:
    """Engine propagation ranking with agent findings as supporting
    evidence.  ``engine`` defaults to :func:`make_engine` on the context's
    device: sharded when ``RCA_SHARD`` asks for it or more than one device
    is visible (a misconfigured ``RCA_SHARD`` raises
    :class:`ShardConfigError`), single-device otherwise; the result names
    the engine that ran.

    Components that do not map onto a graph service (nodes, namespaces,
    HPAs…) are appended after the engine-ranked services, ordered by the
    deterministic severity rank.
    """
    from rca_tpu_torch.engine import make_engine

    engine = engine or make_engine(device=ctx.device)
    fs = ctx.features
    src, dst = ctx.dep_edges
    result = engine.analyze_features(fs, src, dst, k=max(top_k, 5))

    groups = group_findings(agent_results)
    by_service: Dict[str, List[dict]] = {}
    unmapped: Dict[str, List[dict]] = {}
    service_set = frozenset(fs.service_names)
    for component, findings in groups.items():
        svc = _component_service(component, service_set)
        if svc is None:
            unmapped[component] = findings
        else:
            by_service.setdefault(svc, []).extend(findings)

    ranked: List[dict] = []
    for entry in result.ranked:
        svc = entry["component"]
        findings = by_service.pop(svc, [])
        if entry["score"] <= 0 and not findings:
            continue
        e = _rank_entry(svc, findings, entry["score"])
        e["anomaly"] = entry["anomaly"]
        e["explained_by_upstream"] = entry["explained_by_upstream"]
        e["downstream_impact"] = entry["downstream_impact"]
        ranked.append(e)
    # services the engine didn't surface but agents flagged
    leftovers = [
        _rank_entry(svc, findings, 0.0)
        for svc, findings in by_service.items()
    ] + [
        _rank_entry(comp, findings, 0.0)
        for comp, findings in unmapped.items()
    ]
    leftovers.sort(
        key=lambda r: (-severity_rank(r["severity"]), r["component"])
    )
    ranked.extend(leftovers)
    top = ranked[:top_k]
    summary = (
        f"propagation over {result.n_services} services / "
        f"{result.n_edges} edges in {result.latency_ms:.1f} ms on "
        f"{engine.device.type}; top root cause: {top[0]['component']}"
        if top else "No findings to correlate."
    )
    out = {
        "root_causes": top,
        "groups": groups,
        "backend": "torch",
        "engine": result.engine,
        "summary": summary,
        "engine_latency_ms": result.latency_ms,
    }
    if explain_enabled():
        # the schema-versioned provenance block rides the findings JSON;
        # an attribution failure degrades to a named error, never loses the
        # ranking (same honesty rule as the backend fallback)
        try:
            attach_provenance(out, result.attribution())
        except Exception as exc:  # noqa: BLE001 - degrade, but say so
            out["provenance_error"] = f"{type(exc).__name__}: {exc}"
    return out


def correlate_findings(
    agent_results: Dict[str, Any],
    ctx: Optional[AnalysisContext] = None,
    backend: Optional[str] = None,
    top_k: int = 10,
    engine=None,
) -> Dict[str, Any]:
    """Dispatch on backend.

    The ``torch`` backend without an :class:`AnalysisContext` degrades to
    deterministic, and the result says so in ``fallback_from`` /
    ``fallback_reason`` — "deterministic by choice" stays distinguishable
    from "deterministic because the engine had nothing to rank".  An error
    of the engine itself (a kernel that does not build or launch, a missing
    card) propagates: a ranking that never ran the engine is not reported as
    a torch ranking."""
    requested = resolve_backend(backend)
    fallback_reason = None
    if requested == "torch":
        if ctx is not None:
            return correlate_torch(agent_results, ctx, top_k=top_k,
                                   engine=engine)
        fallback_reason = "no AnalysisContext for the torch engine"
    out = correlate_deterministic(agent_results, top_k=top_k)
    if fallback_reason is not None:
        out["fallback_from"] = requested
        out["fallback_reason"] = fallback_reason
    return out
