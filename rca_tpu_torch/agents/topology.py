"""Topology agent: structural analyses over the typed resource graph (the
port's copy of ``rca_tpu.agents.topology``).

Parity with the reference's topology agent (reference: agents/topology_agent.py
— graph build :94-260, cycles :268, longest chain :294-305, SPOF via
betweenness>0.5 with replicas<2 :329-346, isolated nodes :363, network-policy
permissiveness/coverage :403-499, ingress TLS / broken backends :501-590,
missing ConfigMap/Secret refs :592-655, service→pod mapping :407-481, graph
export :657-693) — but on the COO array representation with linear-time
algorithms (rca_tpu_torch.graph.analysis) instead of networkx all-pairs paths.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from rca_tpu_torch.agents.base import Agent, AgentResult, AnalysisContext, summarize
from rca_tpu_torch.cluster.labels import selector_matches
from rca_tpu_torch.graph.analysis import (
    betweenness_centrality,
    find_cycles,
    isolated_nodes,
    longest_dependency_chain,
)

SPOF_CENTRALITY = 0.5
LONG_CHAIN = 4


class TopologyAgent(Agent):
    agent_type = "topology"

    def analyze(self, ctx: AnalysisContext) -> AgentResult:
        r = AgentResult(self.agent_type, as_of=ctx.snapshot.captured_at)
        snap = ctx.snapshot
        fs = ctx.features
        graph = ctx.graph
        src, dst = ctx.dep_edges
        names = fs.service_names
        n = fs.num_services
        r.add_step(
            f"Typed graph: {graph.num_nodes} nodes / {graph.num_edges} edges; "
            f"service dependency graph: {n} services / {len(src)} edges.",
            "Structural analyses run on COO arrays in linear time.",
        )
        r.data["graph"] = graph.to_dict()

        # -- cycles ----------------------------------------------------------
        for cyc in find_cycles(n, src, dst):
            chain = " -> ".join(names[i] for i in cyc)
            r.add_finding(
                f"Service/{names[cyc[0]]}",
                f"circular dependency: {chain}",
                "high",
                {"cycle": [names[i] for i in cyc]},
                "Break the cycle (extract the shared piece or invert one "
                "dependency); circular services cannot start or fail cleanly",
            )

        # -- longest dependency chain ---------------------------------------
        chain = longest_dependency_chain(n, src, dst)
        if len(chain) >= LONG_CHAIN:
            r.add_finding(
                f"Service/{names[chain[0]]}",
                f"dependency chain of depth {len(chain)}: "
                + " -> ".join(names[i] for i in chain),
                "medium",
                {"chain": [names[i] for i in chain]},
                "Deep chains multiply failure probability and latency — "
                "consider collapsing or parallelizing hops",
            )
        elif chain:
            r.add_step(
                f"Longest dependency chain has depth {len(chain)}.",
                "Below the reporting threshold.",
            )

        # -- SPOF: high centrality + low replication -------------------------
        replicas = self._service_replicas(snap, names)
        if len(src):
            bc = betweenness_centrality(n, src, dst, device=ctx.device)
            for i in np.nonzero(bc > SPOF_CENTRALITY)[0].tolist():
                if replicas.get(names[i], 0) < 2:
                    r.add_finding(
                        f"Service/{names[i]}",
                        "single point of failure: high graph centrality "
                        f"({bc[i]:.2f}) with {replicas.get(names[i], 0)} "
                        "replica(s)",
                        "high",
                        {"centrality": round(float(bc[i]), 3),
                         "replicas": replicas.get(names[i], 0)},
                        "Run at least 2 replicas of this service; many "
                        "dependency paths flow through it",
                    )

        # -- isolated services ----------------------------------------------
        if len(src):
            for i in isolated_nodes(n, src, dst).tolist():
                r.add_finding(
                    f"Service/{names[i]}",
                    "service participates in no dependency edges",
                    "low",
                    {},
                    "Confirm the service is still used; unused services add "
                    "surface without value",
                )

        # -- service → pod mapping -------------------------------------------
        self._service_pod_mapping(r, ctx)

        # -- network policies ------------------------------------------------
        self._network_policies(r, ctx)

        # -- ingress ---------------------------------------------------------
        for ing in snap.ingresses:
            iname = ing.get("metadata", {}).get("name", "")
            if not (ing.get("spec") or {}).get("tls"):
                r.add_finding(
                    f"Ingress/{iname}",
                    "ingress terminates no TLS",
                    "low",
                    {},
                    "Add a TLS section unless plaintext exposure is intended",
                )
        for miss in graph.missing_refs:
            if miss["kind"] == "ingress_backend":
                r.add_finding(
                    f"Ingress/{miss['from']}",
                    f"ingress routes to nonexistent service "
                    f"'{miss['missing']}'",
                    "high",
                    miss,
                    "Create the backend service or fix the ingress rule",
                )
            else:  # missing_configmap / missing_secret
                kind = miss["kind"].replace("missing_", "")
                r.add_finding(
                    f"Workload/{miss['from']}",
                    f"references a {kind} '{miss['missing']}' that does not "
                    "exist",
                    "high",
                    miss,
                    f"Create the {kind} or remove the dangling reference — "
                    "pods will fail to start or run misconfigured",
                )

        summarize(r, "topology")
        return r

    # ------------------------------------------------------------------
    @staticmethod
    def _service_replicas(snap, names: List[str]) -> Dict[str, int]:
        """Ready-replica count of each service's backing workload(s).
        One pass over workloads via the inverted selector index."""
        from rca_tpu_torch.cluster.labels import SelectorIndex

        svc_names = [
            s.get("metadata", {}).get("name", "") for s in snap.services
        ]
        index = SelectorIndex(
            [(s.get("spec") or {}).get("selector") or {}
             for s in snap.services]
        )
        out: Dict[str, int] = {
            name: 0
            for s, name in zip(snap.services, svc_names)
            if (s.get("spec") or {}).get("selector")
        }
        workloads = (
            list(snap.deployments) + list(snap.statefulsets) + list(snap.daemonsets)
        )
        for w in workloads:
            tlabels = (
                ((w.get("spec") or {}).get("template") or {})
                .get("metadata", {})
                .get("labels", {})
                or {}
            )
            st = w.get("status", {}) or {}
            ready = int(st.get("readyReplicas", st.get("numberReady", 0)) or 0)
            for j in index.matches(tlabels):
                out[svc_names[j]] = out.get(svc_names[j], 0) + ready
        return out

    @staticmethod
    def _service_pod_mapping(r: AgentResult, ctx: AnalysisContext) -> None:
        """Selector matching + ready/unready split (reference:
        agents/topology_agent.py:407-481)."""
        fs = ctx.features
        snap = ctx.snapshot
        pf = fs.pod_features
        from rca_tpu_torch.features.schema import PodF

        ready = (pf[:, PodF.PHASE_RUNNING] > 0) & (pf[:, PodF.NOT_READY] == 0)
        mapping = {}
        for j, sname in enumerate(fs.service_names):
            sel = (snap.services[j].get("spec") or {}).get("selector") or {}
            if not sel:
                continue
            members = fs.service_members(j)
            n_ready = int(ready[members].sum()) if len(members) else 0
            mapping[sname] = {
                "pods": [fs.pod_names[i] for i in members.tolist()],
                "ready": n_ready,
                "unready": int(len(members) - n_ready),
            }
            if len(members) == 0:
                r.add_finding(
                    f"Service/{sname}",
                    "selector matches no pods",
                    "high",
                    {"selector": sel},
                    "Fix the selector or deploy the backing workload; the "
                    "service has nothing to route to",
                )
            elif n_ready == 0:
                r.add_finding(
                    f"Service/{sname}",
                    f"all {len(members)} backing pod(s) are unready",
                    "high",
                    mapping[sname],
                    "Traffic to this service is failing — investigate the "
                    "backing pods",
                )
        r.data["service_pod_mapping"] = mapping

    @staticmethod
    def _network_policies(r: AgentResult, ctx: AnalysisContext) -> None:
        """Permissiveness, coverage, and dead selectors (reference:
        agents/topology_agent.py:403-499)."""
        snap = ctx.snapshot
        fs = ctx.features
        pod_labels = [
            p.get("metadata", {}).get("labels", {}) or {} for p in snap.pods
        ]
        covered = np.zeros(len(pod_labels), dtype=bool)
        for pol in snap.network_policies:
            pname = pol.get("metadata", {}).get("name", "")
            spec = pol.get("spec", {}) or {}
            sel = (spec.get("podSelector") or {}).get("matchLabels", {}) or {}
            if not sel and not (spec.get("podSelector") or {}).get(
                "matchExpressions"
            ):
                covered[:] = True
            else:
                for i, labels in enumerate(pod_labels):
                    if selector_matches(sel, labels):
                        covered[i] = True
            if not spec.get("ingress") and not spec.get("egress"):
                r.add_finding(
                    f"NetworkPolicy/{pname}",
                    "policy defines no ingress or egress rules "
                    "(default-deny for selected pods)",
                    "medium",
                    {"podSelector": sel},
                    "Confirm default-deny is intended; selected pods accept "
                    "no traffic",
                )
            # 'from' selectors that match no pod in the namespace
            for rule in spec.get("ingress", []) or []:
                for frm in rule.get("from", []) or []:
                    fsel = (frm.get("podSelector") or {}).get(
                        "matchLabels", {}
                    ) or {}
                    if fsel and not any(
                        selector_matches(fsel, labels) for labels in pod_labels
                    ):
                        r.add_finding(
                            f"NetworkPolicy/{pname}",
                            f"ingress 'from' selector {fsel} matches no pods",
                            "medium",
                            {"from_selector": fsel},
                            "The allow rule is dead — traffic it was meant to "
                            "admit is being dropped; fix the selector labels",
                        )
        if snap.network_policies and not covered.all():
            uncovered = [
                fs.pod_names[i] for i in np.nonzero(~covered)[0].tolist()
            ][:10]
            r.add_finding(
                f"Namespace/{snap.namespace}",
                f"{int((~covered).sum())} pod(s) not covered by any "
                "network policy",
                "low",
                {"examples": uncovered},
                "Extend policy coverage for a consistent security posture",
            )
