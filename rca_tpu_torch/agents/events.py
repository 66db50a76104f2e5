"""Events agent: grouping, scheduling/volume classes, frequency, node health.

Parity with the reference's events agent (reference: agents/events_agent.py —
group by involvedObject :105, scheduling failures :169, volume failures :230,
frequent events count>5 / >20 :292-328, control-plane source components →
critical :330-376, node conditions NodeNotReady/MemoryPressure/DiskPressure/
NetworkUnavailable → critical with per-condition recommendations :377-446).
"""

from __future__ import annotations

from typing import Dict, List

from rca_tpu_torch.agents.base import Agent, AgentResult, AnalysisContext, summarize

SCHEDULING_REASONS = {"FailedScheduling", "FailedPlacement", "Preempted"}
VOLUME_REASONS = {
    "FailedMount", "FailedAttachVolume", "FailedBinding", "VolumeFailedDelete",
    "ProvisioningFailed",
}
CONTROL_PLANE_COMPONENTS = {
    "kube-apiserver", "kube-controller-manager", "kube-scheduler", "etcd",
    "kube-proxy", "cloud-controller-manager",
}
NODE_CONDITION_RECS = {
    "MemoryPressure": "Free node memory: evict/rebalance pods or add nodes",
    "DiskPressure": "Reclaim node disk: prune images/logs or grow the volume",
    "PIDPressure": "Reduce process counts on the node or raise pid limits",
    "NetworkUnavailable": "Check CNI health and node network configuration",
    "Ready": "Investigate kubelet health and node connectivity",
}

FREQUENT, VERY_FREQUENT = 5, 20


def _obj_key(ev: dict) -> str:
    obj = ev.get("involvedObject", {}) or {}
    return f"{obj.get('kind', 'Unknown')}/{obj.get('name', 'unknown')}"


class EventsAgent(Agent):
    agent_type = "events"

    def analyze(self, ctx: AnalysisContext) -> AgentResult:
        r = AgentResult(self.agent_type, as_of=ctx.snapshot.captured_at)
        snap = ctx.snapshot
        warnings = [e for e in snap.events if e.get("type") != "Normal"]

        by_obj: Dict[str, List[dict]] = {}
        for ev in warnings:
            by_obj.setdefault(_obj_key(ev), []).append(ev)
        r.add_step(
            f"{len(warnings)} non-Normal events grouped into "
            f"{len(by_obj)} involved objects.",
            "Per-object classification follows.",
        )

        for key, evs in by_obj.items():
            reasons = {e.get("reason", "") for e in evs}
            messages = [e.get("message", "") for e in evs][:5]
            total = sum(int(e.get("count", 1) or 1) for e in evs)

            sched = reasons & SCHEDULING_REASONS
            if sched:
                r.add_finding(
                    key,
                    f"scheduling failures ({', '.join(sorted(sched))})",
                    "high",
                    {"reasons": sorted(sched), "messages": messages},
                    "Check node capacity, taints/tolerations, affinity rules, "
                    "and PVC binding — the pod cannot be placed",
                )
            vol = reasons & VOLUME_REASONS
            if vol:
                r.add_finding(
                    key,
                    f"volume failures ({', '.join(sorted(vol))})",
                    "high",
                    {"reasons": sorted(vol), "messages": messages},
                    "Verify the PVC, storage class, and attach/mount path",
                )
            if total > FREQUENT:
                r.add_finding(
                    key,
                    f"warning events recurring {total} times",
                    "high" if total > VERY_FREQUENT else "medium",
                    {"count": total, "reasons": sorted(reasons),
                     "messages": messages},
                    "A persistently recurring warning indicates an unresolved "
                    "failure loop — investigate the earliest occurrence",
                )
            cp = {
                (e.get("source", {}) or {}).get("component", "")
                for e in evs
            } & CONTROL_PLANE_COMPONENTS
            if cp:
                r.add_finding(
                    key,
                    f"control-plane component(s) {', '.join(sorted(cp))} "
                    "reporting warnings",
                    "critical",
                    {"components": sorted(cp), "messages": messages},
                    "Control-plane warnings affect the whole cluster — "
                    "triage these before workload-level symptoms",
                )

        # -- node conditions --------------------------------------------------
        for node in snap.nodes:
            name = node.get("metadata", {}).get("name", "")
            for cond in node.get("status", {}).get("conditions", []) or []:
                ctype = cond.get("type", "")
                status = cond.get("status", "")
                bad = (ctype == "Ready" and status != "True") or (
                    ctype != "Ready" and status == "True"
                )
                if ctype in NODE_CONDITION_RECS and bad:
                    label = "NotReady" if ctype == "Ready" else ctype
                    r.add_finding(
                        f"Node/{name}",
                        f"node condition {label}",
                        "critical",
                        {"condition": ctype, "status": status,
                         "message": cond.get("message", "")},
                        NODE_CONDITION_RECS[ctype],
                    )

        # viz payload: namespace-wide breakdowns by reason and by type
        # (reference: components/visualization.py event breakdown charts)
        reason_counts: Dict[str, int] = {}
        type_counts: Dict[str, int] = {}
        for ev in snap.events:
            n = int(ev.get("count", 1) or 1)
            reason = str(ev.get("reason", "") or "unknown")
            reason_counts[reason] = reason_counts.get(reason, 0) + n
            etype = str(ev.get("type", "") or "unknown")
            type_counts[etype] = type_counts.get(etype, 0) + n
        if reason_counts:
            r.data["reason_counts"] = reason_counts
            r.data["type_counts"] = type_counts

        summarize(r, "event")
        return r
