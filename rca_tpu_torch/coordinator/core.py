"""RCACoordinator: session registry and analysis pipelines (the port's copy of
the deterministic part of ``rca_tpu.coordinator.core``).

One snapshot is captured per analysis and shared by the six signal agents;
the comprehensive pipeline then fuses their findings through the port's
engine (``RCA_BACKEND``, default ``torch``), or through a shared serving
plane (``serve=``), whose queue coalesces concurrent coordinators'
analyses into batched dispatches.  Chat turns, suggestions, hypotheses,
LLM agents and the evidence logger are not ported.
"""

from __future__ import annotations

import datetime
import uuid
from typing import Any, Dict, List, Optional

from rca_tpu_torch.agents import ALL_AGENT_TYPES, AnalysisContext, make_agents
from rca_tpu_torch.coordinator.correlate import (
    correlate_findings,
    resolve_backend,
)
from rca_tpu_torch.obslog.profiling import StageTimer


def _now() -> str:
    return datetime.datetime.now(datetime.timezone.utc).isoformat()


def _degraded_note(errors: List[Dict[str, str]]) -> str:
    ops = sorted({e.get("op", "?") for e in errors})
    return (
        f"⚠ analysis ran against PARTIAL cluster state — "
        f"{len(errors)} fetch failure(s) ({', '.join(ops[:5])})"
    )


class RCACoordinator:
    """Runs analyses over ``cluster_client`` on ``device`` (CUDA unless the
    caller names another; raises here when that device does not exist).
    With the ``torch`` backend the engine (``engine``; the serving plane's
    facade with ``serve``, on the plane's device; else :func:`make_engine`
    on ``device``: sharded when ``RCA_SHARD`` asks for it or more than one
    device is visible), and on the card its kernel library, are built now,
    so a missing card, a misconfigured ``RCA_SHARD`` or a kernel that does
    not build fails the construction instead of the first analysis."""

    def __init__(self, cluster_client, backend: Optional[str] = None,
                 device=None, engine=None, serve=None,
                 tenant: Optional[str] = None):
        from rca_tpu_torch.engine import make_engine
        from rca_tpu_torch.engine.runner import resolve_device
        from rca_tpu_torch.kernels.build import library

        self.cluster = cluster_client
        self.backend = resolve_backend(backend)
        # ``serve``: a ServeClient (or a ServeLoop / ServePool) — the
        # correlation analyses then ride the shared multi-tenant serving
        # queue instead of owning the device, so concurrent coordinators
        # coalesce into batched dispatches.  Mutually exclusive with a
        # directly-pinned ``engine``.
        if serve is not None:
            if engine is not None:
                raise ValueError("pass either engine= or serve=, not both")
            from rca_tpu_torch.serve.client import ServeClient

            if not isinstance(serve, ServeClient):
                serve = ServeClient(serve)
            engine = serve.as_engine(
                tenant=tenant or f"coordinator-{uuid.uuid4().hex[:6]}"
            )
        self.serve = serve
        self.device = resolve_device(device if engine is None
                                     else engine.device)
        if self.backend != "torch":
            engine = None
        elif engine is None:
            engine = make_engine(device=self.device)
        self.engine = engine
        if self.engine is not None and self.device.type == "cuda":
            library()
        self.agents = make_agents()
        self.analyses: Dict[str, Dict[str, Any]] = {}

    # -- session registry (reference: mcp_coordinator.py:243-975) ----------
    def init_analysis(
        self, analysis_type: str, namespace: str, **config: Any
    ) -> str:
        analysis_id = str(uuid.uuid4())
        self.analyses[analysis_id] = {
            "id": analysis_id,
            "config": {
                "type": analysis_type, "namespace": namespace, **config,
            },
            "status": "initialized",
            "started_at": _now(),
            "results": {},
            "summary": "",
        }
        return analysis_id

    def get_analysis_status(self, analysis_id: str) -> Dict[str, Any]:
        a = self.analyses.get(analysis_id)
        if a is None:
            return {"error": f"unknown analysis {analysis_id}"}
        return {
            "id": a["id"], "status": a["status"],
            "config": a["config"], "started_at": a["started_at"],
        }

    def list_analyses(self) -> List[Dict[str, Any]]:
        return [self.get_analysis_status(aid) for aid in self.analyses]

    def get_analysis_results(self, analysis_id: str) -> Dict[str, Any]:
        a = self.analyses.get(analysis_id)
        if a is None:
            return {"error": f"unknown analysis {analysis_id}"}
        return a

    # -- context capture -----------------------------------------------------
    def capture(self, namespace: str) -> AnalysisContext:
        return AnalysisContext.capture(self.cluster, namespace,
                                       device=self.device)

    # -- analysis runners ----------------------------------------------------
    def run_analysis(
        self,
        analysis_type: str,
        namespace: str,
        ctx: Optional[AnalysisContext] = None,
        **config: Any,
    ) -> Dict[str, Any]:
        """Run one signal agent or the comprehensive pipeline.  Returns the
        analysis record (registry entry) with ``results`` filled."""
        analysis_id = self.init_analysis(analysis_type, namespace, **config)
        record = self.analyses[analysis_id]
        record["status"] = "running"
        try:
            ctx = ctx or self.capture(namespace)
            if analysis_type == "comprehensive":
                record["results"] = self._run_comprehensive(ctx)
                # the cross-agent summary carries the degraded-state note;
                # fall back to the fusion one-liner
                record["summary"] = (
                    record["results"].get("summary")
                    or record["results"]["correlated"]["summary"]
                )
            elif analysis_type in ALL_AGENT_TYPES:
                res = self.agents[analysis_type].analyze(ctx)
                record["results"][analysis_type] = res.to_dict()
                record["summary"] = res.summary
            else:
                raise ValueError(f"unknown analysis type: {analysis_type}")
            record["status"] = "completed"
            # degraded-mode honesty for EVERY analysis type: a snapshot
            # captured through fetch failures is PARTIAL — say so instead
            # of letting an RBAC error read as "no issues detected"
            if ctx.snapshot.errors:
                note = _degraded_note(ctx.snapshot.errors)
                record["results"]["degraded"] = {
                    "errors": ctx.snapshot.errors, "note": note,
                }
                record["summary"] = f"{note}. {record['summary']}"
        except Exception as e:
            record["status"] = "failed"
            record["error"] = f"{type(e).__name__}: {e}"
        record["finished_at"] = _now()
        return record

    def _run_comprehensive(self, ctx: AnalysisContext) -> Dict[str, Any]:
        """All six signals over ONE shared snapshot, then fusion + summary.
        Per-stage latency recorded under ``results["profile"]``."""
        timer = StageTimer()
        results: Dict[str, Any] = {}
        with timer.stage("features"):
            ctx.features  # materialize the shared packed arrays once
        with timer.stage("graph"):
            ctx.graph
            ctx.dep_edges
        for agent_type in ALL_AGENT_TYPES:
            with timer.stage(f"agent.{agent_type}"):
                res = self.agents[agent_type].analyze(ctx)
            results[agent_type] = res.to_dict()
        with timer.stage("correlate"):
            correlated = correlate_findings(
                results, ctx=ctx, backend=self.backend, engine=self.engine,
            )
        results["correlated"] = correlated
        with timer.stage("summary"):
            results["summary"] = self.generate_summary(results)
        results["profile"] = timer.report()
        return results

    # -- summaries -----------------------------------------------------------
    @staticmethod
    def generate_summary(results: Dict[str, Any]) -> str:
        """Condensed cross-agent summary: the deterministic rollup (what the
        JAX package prints when no LLM provider is configured)."""
        top = results.get("correlated", {}).get("root_causes", [])[:3]
        det = "; ".join(
            f"{r['component']} ({r['severity']}, {r['finding_count']} findings)"
            for r in top
        )
        return f"Top root causes: {det}." if det else "No issues detected."
