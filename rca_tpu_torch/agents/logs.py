"""Logs agent: 13-class error-pattern scan + container-state classification.

Parity with the reference's log agent (reference: agents/logs_agent.py —
pattern table :20-34, per-container scan :146-149, severity map :416-437,
recommendation table :451-477, container-status / pod-condition / init /
no-logs checks :183-414).  The scan itself already ran once inside the
feature extractor (counts live in the packed pod array); this agent reads
those counts as a vectorized prefilter and only re-touches the raw text of
pods that actually hit, to pull example lines for evidence.
"""

from __future__ import annotations

import numpy as np

from rca_tpu_torch.agents.base import Agent, AgentResult, AnalysisContext, summarize
from rca_tpu_torch.features.logscan import (
    LOG_PATTERN_NAMES,
    LOG_PATTERNS,
    pattern_recommendation,
    pattern_severity,
)
from rca_tpu_torch.features.schema import PodF

MAX_EXAMPLE_LINES = 3


def _example_lines(logs_by_container: dict, pattern_name: str) -> list:
    pat = LOG_PATTERNS[pattern_name]
    out = []
    for cname, text in logs_by_container.items():
        if not text:
            continue
        for line in text.splitlines():
            if pat.search(line):
                out.append({"container": cname, "line": line.strip()[:300]})
                if len(out) >= MAX_EXAMPLE_LINES:
                    return out
    return out


class LogsAgent(Agent):
    agent_type = "logs"

    def analyze(self, ctx: AnalysisContext) -> AgentResult:
        r = AgentResult(self.agent_type, as_of=ctx.snapshot.captured_at)
        fs = ctx.features
        snap = ctx.snapshot
        pf = fs.pod_features

        log_block = pf[:, PodF.LOG0 : PodF.LOG0 + len(LOG_PATTERN_NAMES)]
        hit_pods = np.nonzero(log_block.sum(axis=1) > 0)[0]
        r.add_step(
            f"Log-pattern counts for {fs.num_pods} pods read from the packed "
            f"feature array; {len(hit_pods)} pod(s) show error-class hits.",
            "Only hitting pods' raw logs are re-read for example lines.",
        )

        for i in hit_pods.tolist():
            pod_name = fs.pod_names[i]
            logs = snap.logs.get(pod_name, {})
            for j in np.nonzero(log_block[i] > 0)[0].tolist():
                name = LOG_PATTERN_NAMES[j]
                count = int(log_block[i, j])
                r.add_finding(
                    f"Pod/{pod_name}",
                    f"log pattern '{name}' matched {count} time(s)",
                    pattern_severity(name),
                    {
                        "pattern": name,
                        "count": count,
                        "examples": _example_lines(logs, name),
                    },
                    pattern_recommendation(name),
                )

        # -- container state classification (from packed flags) --------------
        flag_rules = [
            (PodF.WAIT_CRASHLOOP, "container in CrashLoopBackOff", "high",
             "Inspect the previous container logs for the crash cause"),
            (PodF.WAIT_IMAGEPULL, "container cannot pull its image", "high",
             "Verify the image name/tag, registry access, and pull secrets"),
            (PodF.WAIT_CONFIG, "container blocked on missing config "
             "(CreateContainerConfigError)", "high",
             "Create the referenced ConfigMap/Secret or fix the key names"),
            (PodF.INIT_FAILED, "init container failing", "high",
             "Fix the init container — the main containers will never start"),
            (PodF.TERM_OOM, "container OOM-killed", "high",
             "Raise the memory limit or reduce the container's footprint"),
        ]
        for channel, issue, sev, rec in flag_rules:
            for i in np.nonzero(pf[:, channel] > 0)[0].tolist():
                pod = snap.pod_by_name(fs.pod_names[i]) or {}
                statuses = pod.get("status", {}).get("containerStatuses", [])
                r.add_finding(
                    f"Pod/{fs.pod_names[i]}", issue, sev,
                    {"containerStatuses": statuses},
                    rec,
                )

        # restart pressure without a waiting reason (flapping but Running now)
        flapping = (pf[:, PodF.RESTARTS] >= 3) & (pf[:, PodF.WAIT_CRASHLOOP] == 0)
        for i in np.nonzero(flapping)[0].tolist():
            r.add_finding(
                f"Pod/{fs.pod_names[i]}",
                f"container restarted {int(pf[i, PodF.RESTARTS])} times",
                "medium",
                {"restart_count": int(pf[i, PodF.RESTARTS])},
                "Check previous-instance logs; the container is flapping",
            )

        # running pods that produced no logs at all
        for i in np.nonzero(pf[:, PodF.NO_LOGS] > 0)[0].tolist():
            r.add_finding(
                f"Pod/{fs.pod_names[i]}",
                "running pod produced no log output",
                "low",
                {},
                "Confirm the application logs to stdout/stderr; silent "
                "containers hide failures",
            )

        summarize(r, "log")
        return r
