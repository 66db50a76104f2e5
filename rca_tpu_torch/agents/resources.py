"""Resource agent: full-namespace sweep (the reference's ResourceAnalyzer).

Parity with reference: agents/resource_analyzer.py — service selector /
unhealthy-target checks :96-148, deployment ready<desired + selector drift
:150-196, statefulset/daemonset shortfalls :198-262, pod status bucketing
into groups with a per-group analyzer :275-351, :382-712, event correlation
attaching related events to findings or minting new ones :714-833,
``_is_pod_healthy`` :856-895.

The pod bucketing here is a set of boolean masks over the packed pod-feature
array — one vector op per bucket instead of a 12-way Python if/elif chain
per pod.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from rca_tpu_torch.agents.base import Agent, AgentResult, AnalysisContext, summarize
from rca_tpu_torch.cluster.labels import selector_matches
from rca_tpu_torch.features.schema import PodF

# event keyword classes for correlation (reference:
# agents/resource_analyzer.py:714-833 keyword-class matching)
EVENT_CLASSES = {
    "crash": ("BackOff", "Unhealthy", "Killing", "Failed"),
    "scheduling": ("FailedScheduling", "Preempted"),
    "volume": ("FailedMount", "FailedAttachVolume", "FailedBinding"),
    "image": ("Failed", "ErrImagePull", "BackOff", "InspectFailed"),
    "network": ("NetworkNotReady", "DNSConfigForming"),
    "resource": ("OOMKilling", "Evicted", "FailedCreate"),
}


class ResourceAgent(Agent):
    agent_type = "resources"

    def analyze(self, ctx: AnalysisContext) -> AgentResult:
        r = AgentResult(self.agent_type, as_of=ctx.snapshot.captured_at)
        snap = ctx.snapshot
        fs = ctx.features
        r.add_step(
            f"Swept namespace '{snap.namespace}': {len(snap.pods)} pods, "
            f"{len(snap.deployments)} deployments, {len(snap.services)} "
            f"services, {len(snap.events)} events.",
            "Pod buckets computed as vector masks over packed features.",
        )

        self._services(r, ctx)
        self._workloads(r, snap)
        self._pod_buckets(r, ctx)
        self._correlate_events(r, ctx)

        summarize(r, "resource")
        return r

    # -- services ----------------------------------------------------------
    @staticmethod
    def _services(r: AgentResult, ctx: AnalysisContext) -> None:
        fs = ctx.features
        snap = ctx.snapshot
        pf = fs.pod_features
        healthy = (
            (pf[:, PodF.PHASE_RUNNING] > 0)
            & (pf[:, PodF.NOT_READY] == 0)
            & (pf[:, PodF.WAIT_CRASHLOOP] == 0)
        )
        for j, svc in enumerate(snap.services):
            sname = svc.get("metadata", {}).get("name", "")
            sel = (svc.get("spec") or {}).get("selector") or {}
            if not sel:
                continue
            members = fs.service_members(j)
            if len(members) == 0:
                r.add_finding(
                    f"Service/{sname}",
                    "service selector matches no pods",
                    "high",
                    {"selector": sel},
                    "Deploy the backing workload or fix the selector labels",
                )
            elif not healthy[members].any():
                r.add_finding(
                    f"Service/{sname}",
                    "every pod behind this service is unhealthy",
                    "high",
                    {"pods": [fs.pod_names[i] for i in members.tolist()]},
                    "The service is effectively down — fix the backing pods",
                )

    # -- workloads ----------------------------------------------------------
    @staticmethod
    def _workloads(r: AgentResult, snap) -> None:
        for dep in snap.deployments:
            name = dep.get("metadata", {}).get("name", "")
            spec = dep.get("spec", {}) or {}
            status = dep.get("status", {}) or {}
            want = int(spec.get("replicas", 1) or 0)
            ready = int(status.get("readyReplicas", 0) or 0)
            if ready < want:
                r.add_finding(
                    f"Deployment/{name}",
                    f"{ready}/{want} replicas ready",
                    "high" if ready == 0 else "medium",
                    {"desired": want, "ready": ready,
                     "conditions": status.get("conditions", [])},
                    "Inspect the deployment's pods and recent events for why "
                    "replicas are not becoming ready",
                )
            sel = ((spec.get("selector") or {}).get("matchLabels")) or {}
            tlabels = (
                (spec.get("template") or {}).get("metadata", {}).get("labels")
                or {}
            )
            if sel and not selector_matches(sel, tlabels):
                r.add_finding(
                    f"Deployment/{name}",
                    "selector does not match the pod template labels",
                    "high",
                    {"selector": sel, "template_labels": tlabels},
                    "Align selector and template labels; the deployment "
                    "cannot adopt its own pods",
                )
        for kind, coll, ready_key, want_key in (
            ("StatefulSet", snap.statefulsets, "readyReplicas", "replicas"),
            ("DaemonSet", snap.daemonsets, "numberReady",
             "desiredNumberScheduled"),
        ):
            for w in coll:
                name = w.get("metadata", {}).get("name", "")
                status = w.get("status", {}) or {}
                want = int(
                    status.get(want_key, (w.get("spec", {}) or {}).get(
                        "replicas", 0)) or 0
                )
                ready = int(status.get(ready_key, 0) or 0)
                if want and ready < want:
                    r.add_finding(
                        f"{kind}/{name}",
                        f"{ready}/{want} replicas ready",
                        "high" if ready == 0 else "medium",
                        {"desired": want, "ready": ready},
                        f"Investigate the {kind.lower()}'s pods and events",
                    )

    # -- pod buckets --------------------------------------------------------
    @staticmethod
    def _pod_buckets(r: AgentResult, ctx: AnalysisContext) -> None:
        fs = ctx.features
        snap = ctx.snapshot
        pf = fs.pod_features

        buckets = [
            (
                "crashloop",
                pf[:, PodF.WAIT_CRASHLOOP] > 0,
                "pod stuck in CrashLoopBackOff",
                "critical",
                "Read the previous container logs and fix the crashing "
                "process; check liveness probes and required env/config",
            ),
            (
                "imagepull",
                pf[:, PodF.WAIT_IMAGEPULL] > 0,
                "pod cannot pull its container image",
                "high",
                "Verify image name/tag, registry reachability, and "
                "imagePullSecrets",
            ),
            (
                "config_error",
                pf[:, PodF.WAIT_CONFIG] > 0,
                "pod blocked on container configuration",
                "high",
                "Create the missing ConfigMap/Secret or fix its keys",
            ),
            (
                "init_failure",
                pf[:, PodF.INIT_FAILED] > 0,
                "pod blocked by a failing init container",
                "high",
                "Fix the init container; the main containers cannot start",
            ),
            (
                "oom",
                pf[:, PodF.TERM_OOM] > 0,
                "pod container was OOM-killed",
                "high",
                "Raise the memory limit or shrink the workload's footprint",
            ),
            (
                "failed",
                (pf[:, PodF.PHASE_FAILED] > 0)
                & (pf[:, PodF.WAIT_CRASHLOOP] == 0),
                "pod in Failed phase",
                "high",
                "Describe the pod for its termination reason and exit codes",
            ),
            (
                "pending",
                pf[:, PodF.PHASE_PENDING] > 0,
                "pod stuck Pending (unscheduled or not started)",
                "high",
                "Check scheduling events, node capacity, taints, and PVC "
                "binding",
            ),
            (
                "terminated_error",
                (pf[:, PodF.TERM_NONZERO] > 0)
                & (pf[:, PodF.WAIT_CRASHLOOP] == 0)
                & (pf[:, PodF.PHASE_FAILED] == 0),
                "container exited nonzero",
                "medium",
                "Inspect the exit code and last logs of the terminated "
                "container",
            ),
            (
                "not_ready",
                (pf[:, PodF.PHASE_RUNNING] > 0)
                & (pf[:, PodF.NOT_READY] > 0)
                & (pf[:, PodF.WAIT_CRASHLOOP] == 0)
                & (pf[:, PodF.WAIT_IMAGEPULL] == 0)
                & (pf[:, PodF.WAIT_CONFIG] == 0),
                "running pod not passing readiness",
                "medium",
                "Check the readiness probe and the app's startup/health state",
            ),
            (
                "restart_churn",
                (pf[:, PodF.RESTARTS] >= 3)
                & (pf[:, PodF.WAIT_CRASHLOOP] == 0),
                "pod restarting repeatedly",
                "medium",
                "Correlate restart times with probe failures and OOM events",
            ),
            (
                "unknown_phase",
                pf[:, PodF.PHASE_UNKNOWN] > 0,
                "pod phase Unknown (node unreachable?)",
                "high",
                "Check the pod's node health and kubelet connectivity",
            ),
        ]

        counts: Dict[str, int] = {}
        for key, mask, issue, sev, rec in buckets:
            idx = np.nonzero(mask)[0]
            counts[key] = int(len(idx))
            for i in idx.tolist():
                pod = snap.pod_by_name(fs.pod_names[i]) or {}
                status = pod.get("status", {}) or {}
                r.add_finding(
                    f"Pod/{fs.pod_names[i]}",
                    issue,
                    sev,
                    {
                        "phase": status.get("phase"),
                        "restarts": int(pf[i, PodF.RESTARTS]),
                        "containerStatuses": status.get(
                            "containerStatuses", []),
                    },
                    rec,
                    bucket=key,
                )
        r.data["pod_buckets"] = counts

    # -- event correlation ---------------------------------------------------
    @staticmethod
    def _correlate_events(r: AgentResult, ctx: AnalysisContext) -> None:
        snap = ctx.snapshot
        by_component: Dict[str, List[dict]] = {}
        for ev in snap.events:
            if ev.get("type") == "Normal":
                continue
            obj = ev.get("involvedObject", {}) or {}
            key = f"{obj.get('kind', 'Unknown')}/{obj.get('name', '')}"
            by_component.setdefault(key, []).append(
                {
                    "reason": ev.get("reason", ""),
                    "message": ev.get("message", ""),
                    "count": int(ev.get("count", 1) or 1),
                }
            )

        # attach to existing findings on the same component
        claimed = set()
        for f in r.findings:
            evs = by_component.get(f["component"])
            if evs:
                if isinstance(f["evidence"], dict):
                    f["evidence"].setdefault("related_events", evs[:5])
                claimed.add(f["component"])

        # mint findings from warning events on components nothing else flagged
        for key, evs in by_component.items():
            if key in claimed:
                continue
            total = sum(e["count"] for e in evs)
            reasons = sorted({e["reason"] for e in evs})
            r.add_finding(
                key,
                f"warning events ({', '.join(reasons)}) with no matching "
                "resource finding",
                "medium" if total > 3 else "low",
                {"events": evs[:5], "total": total},
                "Investigate these events — they flag a condition the "
                "resource sweep did not surface",
            )
