"""Typed resource-graph builder.

Node/edge taxonomy mirrors the reference's topology agent (reference:
agents/topology_agent.py:94-260): nodes are services / workloads / ingresses
/ configmaps / secrets; edges are

- ``SELECTS``     service → workload   (service selector ⊆ pod-template labels)
- ``ROUTES``      ingress → service    (ingress backend)
- ``MOUNTS``      workload → configmap (volume mount)
- ``ENV_FROM``    workload → configmap/secret (envFrom)
- ``ENV_VAR``     workload → configmap/secret (env valueFrom)
- ``DEPENDS_ON``  workload → service   (service DNS name in env values)

plus the service-level condensation ``service_dependency_edges`` the causal
engine consumes: service A depends on service B when A's backing workload
carries a DEPENDS_ON edge to B, or the trace backend reports the dependency.
"""

from __future__ import annotations

import dataclasses
import enum
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from rca_tpu_torch.cluster.labels import SelectorIndex
from rca_tpu_torch.cluster.snapshot import ClusterSnapshot
from rca_tpu_torch.features.extract import FeatureSet


class NodeType(enum.IntEnum):
    SERVICE = 0
    WORKLOAD = 1
    INGRESS = 2
    CONFIGMAP = 3
    SECRET = 4


class EdgeType(enum.IntEnum):
    SELECTS = 0
    ROUTES = 1
    MOUNTS = 2
    ENV_FROM = 3
    ENV_VAR = 4
    DEPENDS_ON = 5


@dataclasses.dataclass
class TypedGraph:
    node_names: List[str]          # qualified "<type>/<name>"
    node_types: np.ndarray         # int8 [N]
    edge_src: np.ndarray           # int32 [E]
    edge_dst: np.ndarray           # int32 [E]
    edge_types: np.ndarray         # int8 [E]
    # bookkeeping for findings / viz
    missing_refs: List[dict] = dataclasses.field(default_factory=list)

    @property
    def num_nodes(self) -> int:
        return len(self.node_names)

    @property
    def num_edges(self) -> int:
        return len(self.edge_src)

    def to_dict(self) -> dict:
        """{nodes, edges} export for visualization (reference:
        agents/topology_agent.py:657-693)."""
        type_names = {t.value: t.name.lower() for t in NodeType}
        edge_names = {t.value: t.name.lower() for t in EdgeType}
        return {
            "nodes": [
                {"id": n, "type": type_names[int(t)]}
                for n, t in zip(self.node_names, self.node_types)
            ],
            "edges": [
                {
                    "source": self.node_names[int(s)],
                    "target": self.node_names[int(d)],
                    "relation": edge_names[int(t)],
                }
                for s, d, t in zip(self.edge_src, self.edge_dst, self.edge_types)
            ],
        }


class _Builder:
    def __init__(self) -> None:
        self.names: List[str] = []
        self.types: List[int] = []
        self.index: Dict[str, int] = {}
        self.src: List[int] = []
        self.dst: List[int] = []
        self.et: List[int] = []
        self.missing: List[dict] = []

    def node(self, ntype: NodeType, name: str) -> int:
        key = f"{ntype.name.lower()}/{name}"
        if key not in self.index:
            self.index[key] = len(self.names)
            self.names.append(key)
            self.types.append(int(ntype))
        return self.index[key]

    def maybe(self, ntype: NodeType, name: str) -> Optional[int]:
        return self.index.get(f"{ntype.name.lower()}/{name}")

    def edge(self, src: int, dst: int, etype: EdgeType) -> None:
        self.src.append(src)
        self.dst.append(dst)
        self.et.append(int(etype))

    def build(self) -> TypedGraph:
        # dedup: pods restate their workload template, producing repeats
        triples = sorted(set(zip(self.src, self.dst, self.et)))
        src = [t[0] for t in triples]
        dst = [t[1] for t in triples]
        et = [t[2] for t in triples]
        seen = set()
        missing = []
        for m in self.missing:
            key = (m["kind"], m["from"], m["missing"])
            if key not in seen:
                seen.add(key)
                missing.append(m)
        return TypedGraph(
            node_names=self.names,
            node_types=np.asarray(self.types, dtype=np.int8),
            edge_src=np.asarray(src, dtype=np.int32),
            edge_dst=np.asarray(dst, dtype=np.int32),
            edge_types=np.asarray(et, dtype=np.int8),
            missing_refs=missing,
        )


def _workloads(snapshot: ClusterSnapshot) -> List[Tuple[str, dict]]:
    out = []
    for coll in (snapshot.deployments, snapshot.statefulsets, snapshot.daemonsets):
        for w in coll:
            out.append((w.get("metadata", {}).get("name", ""), w))
    return out


def _dns_service_names(value: str, svc_set: set, namespace: str):
    """Service DNS inference from env values (reference:
    agents/topology_agent.py:228-260): match a bare '<svc>' host or a
    qualified '<svc>.<ns>[.svc...]' host.  The namespace component must be
    THIS namespace — '<svc>.<other-ns>.svc' points at a different cluster
    tenant and must not create a local dependency edge.

    ``svc_set`` is a prebuilt set: this runs once per container env var, so
    building the set here made graph construction O(S²) — 17.6 s at 10k
    services, vs ~1 s with the set hoisted to the per-graph caller."""
    hits = set()
    hosts = re.findall(r"[a-z0-9][a-z0-9.-]*", value.lower())
    for host in hosts:
        parts = host.split(".")
        if parts[0] in svc_set:
            if len(parts) == 1 or parts[1] == namespace:
                hits.add(parts[0])
    return hits


def build_typed_graph(snapshot: ClusterSnapshot) -> TypedGraph:
    b = _Builder()
    service_names = snapshot.service_names()
    svc_set = set(service_names)
    for name in service_names:
        b.node(NodeType.SERVICE, name)
    cm_names = {c.get("metadata", {}).get("name", "") for c in snapshot.configmaps}
    sec_names = {s.get("metadata", {}).get("name", "") for s in snapshot.secrets}
    for name in sorted(cm_names):
        b.node(NodeType.CONFIGMAP, name)
    for name in sorted(sec_names):
        b.node(NodeType.SECRET, name)

    # inverted selector index: O(labels) per workload instead of O(services)
    svc_selector_index = SelectorIndex(
        [(s.get("spec") or {}).get("selector") or {}
         for s in snapshot.services]
    )

    workloads = _workloads(snapshot)
    for wname, w in workloads:
        widx = b.node(NodeType.WORKLOAD, wname)
        spec = w.get("spec", {}) or {}
        template = (spec.get("template") or {})
        tlabels = (template.get("metadata") or {}).get("labels", {}) or {}
        tspec = template.get("spec") or {}

        # SELECTS: service selector ⊆ template labels
        for j in svc_selector_index.matches(tlabels):
            b.edge(
                b.node(NodeType.SERVICE, service_names[j]),
                widx,
                EdgeType.SELECTS,
            )

        # MOUNTS: volumes referencing configmaps/secrets
        for vol in tspec.get("volumes", []) or []:
            _volume_edges(b, widx, wname, vol, cm_names, sec_names)

        _scan_containers(
            b, widx, wname, tspec.get("containers", []) or [],
            cm_names, sec_names, svc_set, snapshot.namespace,
        )

    # Pods restate their workload's template; scanning them too catches
    # references when workload objects weren't captured (edges dedup below).
    for pod in snapshot.pods:
        app = (pod.get("metadata", {}).get("labels") or {}).get("app")
        if app is None:
            continue
        widx = b.maybe(NodeType.WORKLOAD, app)
        if widx is None:
            continue
        pspec = pod.get("spec", {}) or {}
        for vol in pspec.get("volumes", []) or []:
            _volume_edges(b, widx, app, vol, cm_names, sec_names)
        _scan_containers(
            b, widx, app, pspec.get("containers", []) or [],
            cm_names, sec_names, svc_set, snapshot.namespace,
        )

    # ROUTES: ingress backends (missing backends recorded, reference:
    # agents/topology_agent.py:525-533)
    for ing in snapshot.ingresses:
        iname = ing.get("metadata", {}).get("name", "")
        iidx = b.node(NodeType.INGRESS, iname)
        for rule in (ing.get("spec") or {}).get("rules", []) or []:
            for path in ((rule.get("http") or {}).get("paths", []) or []):
                svc = (((path.get("backend") or {}).get("service")) or {}).get("name")
                if not svc:
                    continue
                if svc in svc_set:
                    b.edge(iidx, b.node(NodeType.SERVICE, svc), EdgeType.ROUTES)
                else:
                    b.missing.append(
                        {"kind": "ingress_backend", "from": iname, "missing": svc}
                    )

    return b.build()


def _volume_edges(b: "_Builder", widx: int, wname: str, vol: dict,
                  cm_names: set, sec_names: set) -> None:
    cm = (vol.get("configMap") or {}).get("name")
    if cm:
        _config_edge(b, widx, NodeType.CONFIGMAP, cm, cm_names,
                     EdgeType.MOUNTS, wname)
    sec = (vol.get("secret") or {}).get("secretName")
    if sec:
        _config_edge(b, widx, NodeType.SECRET, sec, sec_names,
                     EdgeType.MOUNTS, wname)


def _scan_containers(
    b: "_Builder", widx: int, wname: str, containers: list,
    cm_names: set, sec_names: set, svc_set: set, namespace: str,
) -> None:
    for c in containers:
        for ef in c.get("envFrom", []) or []:
            cm = (ef.get("configMapRef") or {}).get("name")
            if cm:
                _config_edge(b, widx, NodeType.CONFIGMAP, cm, cm_names,
                             EdgeType.ENV_FROM, wname)
            sec = (ef.get("secretRef") or {}).get("name")
            if sec:
                _config_edge(b, widx, NodeType.SECRET, sec, sec_names,
                             EdgeType.ENV_FROM, wname)
        for env in c.get("env", []) or []:
            vf = env.get("valueFrom") or {}
            cm = (vf.get("configMapKeyRef") or {}).get("name")
            if cm:
                _config_edge(b, widx, NodeType.CONFIGMAP, cm, cm_names,
                             EdgeType.ENV_VAR, wname)
            sec = (vf.get("secretKeyRef") or {}).get("name")
            if sec:
                _config_edge(b, widx, NodeType.SECRET, sec, sec_names,
                             EdgeType.ENV_VAR, wname)
            value = env.get("value")
            if value:
                for dep in _dns_service_names(
                    str(value), svc_set, namespace
                ):
                    b.edge(widx, b.node(NodeType.SERVICE, dep),
                           EdgeType.DEPENDS_ON)


def _config_edge(b: _Builder, widx: int, ntype: NodeType, name: str,
                 existing: set, etype: EdgeType, wname: str) -> None:
    if name in existing:
        b.edge(widx, b.node(ntype, name), etype)
    else:
        b.missing.append(
            {"kind": f"missing_{ntype.name.lower()}", "from": wname, "missing": name}
        )


def service_dependency_edges(
    snapshot: ClusterSnapshot,
    features: FeatureSet,
    graph: Optional[TypedGraph] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Service-level dependency COO aligned with ``features.service_names``.

    Edge (s, d): service s depends on service d.  Union of env-DNS-inferred
    workload dependencies (via the typed graph) and trace-reported
    dependencies; self-edges and duplicates removed.
    """
    if graph is None:
        graph = build_typed_graph(snapshot)
    svc_index = {n: i for i, n in enumerate(features.service_names)}

    # workload -> owning service(s) via SELECTS edges
    workload_services: Dict[int, List[int]] = {}
    for s, d, t in zip(graph.edge_src, graph.edge_dst, graph.edge_types):
        if t == EdgeType.SELECTS:
            svc_name = graph.node_names[int(s)].split("/", 1)[1]
            if svc_name in svc_index:
                workload_services.setdefault(int(d), []).append(svc_index[svc_name])

    pairs = set()
    for s, d, t in zip(graph.edge_src, graph.edge_dst, graph.edge_types):
        if t != EdgeType.DEPENDS_ON:
            continue
        dep_name = graph.node_names[int(d)].split("/", 1)[1]
        if dep_name not in svc_index:
            continue
        for owner in workload_services.get(int(s), []):
            if owner != svc_index[dep_name]:
                pairs.add((owner, svc_index[dep_name]))

    deps = (snapshot.traces or {}).get("dependencies") or {}
    for src_name, dst_names in deps.items():
        if src_name not in svc_index:
            continue
        for dst_name in dst_names or []:
            if dst_name in svc_index and dst_name != src_name:
                pairs.add((svc_index[src_name], svc_index[dst_name]))

    if not pairs:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32))
    arr = np.asarray(sorted(pairs), dtype=np.int32)
    return arr[:, 0].copy(), arr[:, 1].copy()
