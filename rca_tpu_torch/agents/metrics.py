"""Metrics agent: utilization thresholds, node pressure, limits audit, HPA.

Rule parity with the reference's metrics agent (reference:
agents/metrics_agent.py — pod CPU >80% flag / >90% high :88-104, memory same
:135-151, node pressure >80% :182-199, missing requests/limits audit
:234-261, HPA at-max / narrow-range / desired>current :302-322), but the
threshold scan runs vectorized over the packed pod-feature array instead of
one dict at a time.
"""

from __future__ import annotations

import numpy as np

from rca_tpu_torch.agents.base import Agent, AgentResult, AnalysisContext, summarize
from rca_tpu_torch.features.schema import PodF

CPU_WARN, CPU_HIGH = 0.80, 0.90
MEM_WARN, MEM_HIGH = 0.80, 0.90
NODE_PRESSURE = 0.80


class MetricsAgent(Agent):
    agent_type = "metrics"

    def analyze(self, ctx: AnalysisContext) -> AgentResult:
        r = AgentResult(self.agent_type, as_of=ctx.snapshot.captured_at)
        fs = ctx.features
        snap = ctx.snapshot

        pf = fs.pod_features
        r.add_step(
            f"Scanned utilization for {fs.num_pods} pods and "
            f"{len(fs.node_names)} nodes from packed metric channels.",
            "Threshold comparison runs as one vector op per resource.",
        )

        # -- pod cpu/mem thresholds (vectorized prefilter, detail on hits) --
        for channel, warn, high, kind in (
            (PodF.CPU_PCT, CPU_WARN, CPU_HIGH, "CPU"),
            (PodF.MEM_PCT, MEM_WARN, MEM_HIGH, "memory"),
        ):
            vals = pf[:, channel]
            for i in np.nonzero(vals > warn)[0].tolist():
                pct = float(vals[i]) * 100.0
                sev = "high" if vals[i] > high else "medium"
                r.add_finding(
                    f"Pod/{fs.pod_names[i]}",
                    f"{kind} utilization at {pct:.0f}% of its limit",
                    sev,
                    {"usage_percentage": round(pct, 1), "resource": kind.lower()},
                    (
                        f"Raise the {kind.lower()} limit, scale the workload out, "
                        "or reduce the container's load"
                    ),
                )

        # -- node pressure ---------------------------------------------------
        for i, name in enumerate(fs.node_names):
            cpu, mem = float(fs.node_features[i, 0]), float(fs.node_features[i, 1])
            if max(cpu, mem) > NODE_PRESSURE:
                hot = "CPU" if cpu >= mem else "memory"
                pct = max(cpu, mem) * 100.0
                r.add_finding(
                    f"Node/{name}",
                    f"node under {hot} pressure ({pct:.0f}% used)",
                    "high" if max(cpu, mem) > 0.9 else "medium",
                    {"cpu_percentage": round(cpu * 100, 1),
                     "memory_percentage": round(mem * 100, 1)},
                    "Add capacity or rebalance workloads off the pressured node",
                )

        # -- missing requests/limits audit ----------------------------------
        missing = []
        for pod in snap.pods:
            name = pod.get("metadata", {}).get("name", "")
            for c in pod.get("spec", {}).get("containers", []) or []:
                res = c.get("resources") or {}
                lacks = [k for k in ("requests", "limits") if not res.get(k)]
                if lacks:
                    missing.append(
                        {"pod": name, "container": c.get("name", ""),
                         "missing": lacks}
                    )
        if missing:
            r.add_finding(
                "Namespace/" + snap.namespace,
                f"{len(missing)} container(s) run without resource "
                "requests and/or limits",
                "low",
                missing[:20],
                "Set resource requests and limits so the scheduler and "
                "evictions behave predictably",
            )

        # -- HPA posture -----------------------------------------------------
        for hpa in snap.hpas:
            name = hpa.get("metadata", {}).get("name", "")
            spec = hpa.get("spec", {}) or {}
            status = hpa.get("status", {}) or {}
            mn = int(spec.get("minReplicas", 1) or 1)
            mx = int(spec.get("maxReplicas", 1) or 1)
            cur = int(status.get("currentReplicas", 0) or 0)
            want = int(status.get("desiredReplicas", 0) or 0)
            if cur >= mx > 0:
                r.add_finding(
                    f"HPA/{name}",
                    f"autoscaler pinned at its max of {mx} replicas",
                    "medium",
                    {"current": cur, "max": mx},
                    "Raise maxReplicas or reduce per-replica load; the "
                    "autoscaler has no headroom left",
                )
            elif want > cur:
                r.add_finding(
                    f"HPA/{name}",
                    f"autoscaler wants {want} replicas but only {cur} are up",
                    "medium",
                    {"desired": want, "current": cur},
                    "Check scheduling capacity and pod health — scale-up "
                    "is not completing",
                )
            if mx - mn < 2 and mn > 1:
                r.add_finding(
                    f"HPA/{name}",
                    f"autoscaling range [{mn}, {mx}] is too narrow to absorb load swings",
                    "low",
                    {"min": mn, "max": mx},
                    "Widen the min/max replica range so the HPA can react",
                )

        summarize(r, "metrics")
        return r
