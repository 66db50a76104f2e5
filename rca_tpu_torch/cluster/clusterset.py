"""ClusterSet: one engine over many clusters (the port's copy of
``rca_tpu.cluster.clusterset``).

A :class:`ClusterSet` holds N member ClusterClients keyed by cluster id
and presents the fleet two ways:

- **per cluster**: merged namespaces are ``"<cluster>/<ns>"``
  (:meth:`ClusterSet.namespaces`); :meth:`ClusterSet.bound` binds one of
  them to a routed proxy whose whole client surface (``get_nodes``
  included) hits exactly that member, so a capture through it is that
  member's own capture;
- **merged**: :meth:`ClusterSet.merged_client` returns a
  :class:`MergedClusterClient` presenting ONE namespace that unions the
  member namespaces of the same name — object and node names are
  prefixed ``"<cluster>/"``, every pod grows a synthetic
  ``rca.tpu/cluster`` label and every service selector requires it (so
  selector matching, and with it every service-membership edge, stays
  inside one cluster), and trace-derived service-dependency edges are
  prefixed within their own cluster only.  ``get_columnar`` on the merged
  view is a :class:`~rca_tpu_torch.cluster.live_columnar.LiveColumnarFeed`
  over the merged client itself, the live adapter the real
  ``K8sApiClient`` uses, so the merged columnar and dict captures agree by
  construction.

Identity rules: cluster ids must be unique, non-empty and free of
``"/"`` (the separator), and member namespaces must be free of ``"/"`` —
a member namespace carrying the separator could alias another cluster's
prefixed path and is rejected rather than merged.

:meth:`ClusterSet.cluster_digest` is a stable hash of one member's
topology (a routing key) and :meth:`ClusterSet.graph_digest` covers the
merged topology, independent of member order.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Mapping, Optional, Tuple

#: the synthetic label pair that keeps merged-view selector matching
#: cluster-local: injected into every pod's labels AND every service's
#: selector, so a c0 service can never adopt a c1 pod with the same app
#: label
CLUSTER_LABEL = "rca.tpu/cluster"

SEP = "/"

#: member-client list getters forwarded per namespace (first positional
#: arg is the namespace on every one of them)
_NS_LIST_GETTERS = (
    "get_pods", "get_services", "get_deployments", "get_statefulsets",
    "get_daemonsets", "get_cronjobs", "get_endpoints", "get_ingresses",
    "get_network_policies", "get_configmaps", "get_secrets", "get_pvcs",
    "get_resource_quotas", "get_hpas", "get_events",
    "get_recently_terminated_pods",
)

#: which stores carry a flat ``spec.selector`` that must grow the
#: cluster pair in the merged view
_SELECTOR_GETTERS = ("get_services",)


def _name_of(obj: dict) -> str:
    return (obj.get("metadata") or {}).get("name", "")


def _check_id(cid: str) -> str:
    if not cid or not isinstance(cid, str):
        raise ValueError(f"cluster id must be a non-empty string: {cid!r}")
    if SEP in cid or cid != cid.strip():
        raise ValueError(
            f"cluster id {cid!r} may not contain {SEP!r} or edge "
            "whitespace — it prefixes merged namespaces and names"
        )
    return cid


def _check_ns(cid: str, ns: str) -> str:
    if SEP in ns:
        raise ValueError(
            f"cluster {cid!r} namespace {ns!r} contains {SEP!r}: it "
            "would alias another cluster's prefixed path in the merged "
            "world — rejected, not merged"
        )
    return ns


class ClusterSet:
    """N member clients, one merged world.  See module docstring."""

    def __init__(self, members: Mapping[str, Any]):
        if not members:
            raise ValueError("ClusterSet needs at least one member")
        seen = set()
        for cid in members:
            _check_id(cid)
            if cid in seen:
                raise ValueError(f"duplicate cluster id {cid!r}")
            seen.add(cid)
        #: sorted by id so every merged surface (namespaces, digests,
        #: concatenated object lists) is member-insertion-order-free
        self.members: Dict[str, Any] = {
            cid: members[cid] for cid in sorted(members)
        }

    @property
    def ids(self) -> List[str]:
        return list(self.members)

    def member(self, cid: str) -> Any:
        return self.members[cid]

    # -- namespaces ----------------------------------------------------------
    def namespaces(self) -> List[str]:
        """Every member namespace, cluster-prefixed, collision-checked."""
        out = []
        for cid, m in self.members.items():
            for ns in m.get_namespaces():
                out.append(f"{cid}{SEP}{_check_ns(cid, ns)}")
        return sorted(out)

    def split(self, merged_ns: str) -> Tuple[str, str]:
        """``"<cluster>/<ns>"`` -> (cluster id, member namespace)."""
        cid, sep, ns = merged_ns.partition(SEP)
        if not sep or cid not in self.members or not ns:
            raise KeyError(
                f"{merged_ns!r} is not a <cluster>{SEP}<namespace> of "
                f"this set (clusters: {', '.join(self.members)})"
            )
        return cid, ns

    def bound(self, merged_ns: str) -> "BoundClusterClient":
        """A full ClusterClient for ONE merged namespace's cluster:
        namespace args arrive cluster-prefixed and route stripped; the
        namespace-free surface (``get_nodes`` et al) hits the same
        member — capture through this proxy is single-cluster-consistent
        by construction."""
        cid, _ns = self.split(merged_ns)
        return BoundClusterClient(self.members[cid], cid)

    # -- digests (rendezvous routing + stability tests) ----------------------
    def cluster_digest(self, cid: str) -> str:
        """Stable topology digest of one member (a routing key): its
        namespaces, service names and dependency edges, all sorted, so
        world construction order and dict insertion order cannot move
        it."""
        from rca_tpu_torch.engine.streaming import topology_digest

        m = self.members[cid]
        parts = []
        for ns in sorted(m.get_namespaces()):
            svcs = sorted(_name_of(s) for s in m.get_services(ns) or [])
            deps = m.get_service_dependencies(ns) or {}
            edges = sorted(
                (src, dst)
                for src, dsts in deps.items()
                for dst in (dsts or [])
            )
            parts.append((ns, tuple(svcs), tuple(edges)))
        return topology_digest(cid, parts)

    def graph_digest(self) -> str:
        """One digest over the MERGED topology: the fleet's identity for
        routing and replay labelling, order-independent over members."""
        from rca_tpu_torch.engine.streaming import topology_digest

        return topology_digest(
            "clusterset",
            [(cid, self.cluster_digest(cid)) for cid in self.members],
        )

    def merged_client(self) -> "MergedClusterClient":
        return MergedClusterClient(self)


class BoundClusterClient:
    """One member, addressed by merged (cluster-prefixed) namespaces.
    Unknown attributes forward to the member verbatim (``get_nodes``,
    ``get_node_metrics``, ``is_connected``, ...)."""

    def __init__(self, member: Any, cid: str):
        self._member = member
        self._cid = cid

    def _strip(self, ns: str) -> str:
        prefix = f"{self._cid}{SEP}"
        return ns[len(prefix):] if ns.startswith(prefix) else ns

    def __getattr__(self, name: str) -> Any:
        inner = getattr(self._member, name)
        if name in _NS_FORWARDED and callable(inner):
            def stripped(ns, *args, **kwargs):
                return inner(self._strip(ns), *args, **kwargs)

            return stripped
        return inner


#: every member method whose FIRST positional argument is a namespace
_NS_FORWARDED = frozenset(_NS_LIST_GETTERS) | {
    "get_pod", "get_pod_logs", "get_pod_metrics", "get_trace_ids",
    "get_service_latency_stats", "get_error_rate_by_service",
    "get_service_dependencies", "find_slow_operations",
    "watch_changes", "watch_close", "get_columnar",
}


class MergedClusterClient:
    """The union view: one namespace merging every member's namespace of
    that name, names ``"<cluster>/"``-prefixed, selector matching and
    dependency edges cluster-local.  ``get_columnar`` runs the live
    columnar adapter over this client itself — merged capture pays
    column-diff costs, not per-object re-scans."""

    def __init__(self, cluster_set: ClusterSet):
        self.set = cluster_set
        self._token_seq = itertools.count(1)
        #: merged watch token -> {cluster id -> member cursor}
        self._tokens: Dict[str, Dict[str, str]] = {}
        #: merged namespace -> LiveColumnarFeed over self
        self._feeds: Dict[str, Any] = {}

    # -- identity ------------------------------------------------------------
    def is_connected(self) -> bool:
        return all(m.is_connected() for m in self.set.members.values())

    def get_current_time(self) -> str:
        first = next(iter(self.set.members.values()))
        return first.get_current_time()

    def get_cluster_info(self) -> Dict[str, Any]:
        return {
            "clusters": {
                cid: m.get_cluster_info()
                for cid, m in self.set.members.items()
            },
            "merged": True,
            "graph_digest": self.set.graph_digest(),
        }

    def collect_errors(self, clear: bool = True) -> List[Dict[str, str]]:
        out: List[Dict[str, str]] = []
        for cid, m in self.set.members.items():
            for e in m.collect_errors(clear) or []:
                out.append({**e, "cluster": cid})
        return out

    def get_namespaces(self) -> List[str]:
        """The union namespace names (each merges every member that has
        it); the per-cluster prefixed list lives on the ClusterSet."""
        names = set()
        for cid, m in self.set.members.items():
            for ns in m.get_namespaces():
                names.add(_check_ns(cid, ns))
        return sorted(names)

    # -- prefixing -----------------------------------------------------------
    def _prefixed_obj(self, obj: dict, cid: str,
                      with_selector: bool = False) -> dict:
        """Copy-on-write cluster prefixing: name, node binding, and the
        cluster label pair (selector too, for services).  Member objects
        are never mutated — only the touched sub-dicts are copied."""
        md = dict(obj.get("metadata") or {})
        md["name"] = f"{cid}{SEP}{md.get('name', '')}"
        labels = dict(md.get("labels") or {})
        labels[CLUSTER_LABEL] = cid
        md["labels"] = labels
        out = dict(obj)
        out["metadata"] = md
        spec = obj.get("spec")
        if isinstance(spec, dict):
            spec2 = dict(spec)
            if spec.get("nodeName"):
                spec2["nodeName"] = f"{cid}{SEP}{spec['nodeName']}"
            if with_selector and isinstance(spec.get("selector"), dict):
                sel = dict(spec["selector"])
                sel[CLUSTER_LABEL] = cid
                spec2["selector"] = sel
            out["spec"] = spec2
        io = obj.get("involvedObject")
        if isinstance(io, dict) and io.get("name"):
            out["involvedObject"] = {
                **io, "name": f"{cid}{SEP}{io['name']}",
            }
        return out

    def _merge_lists(self, getter: str, ns: str) -> List[dict]:
        with_sel = getter in _SELECTOR_GETTERS
        out: List[dict] = []
        for cid, m in self.set.members.items():
            for obj in getattr(m, getter)(ns) or []:
                out.append(self._prefixed_obj(obj, cid, with_sel))
        return out

    # -- routed single-object access ----------------------------------------
    def _route_name(self, name: str) -> Tuple[str, Any, str]:
        cid, sep, rest = name.partition(SEP)
        if not sep or cid not in self.set.members:
            raise KeyError(f"{name!r} carries no known cluster prefix")
        return cid, self.set.members[cid], rest

    def get_pod(self, namespace: str, name: str) -> Optional[dict]:
        try:
            cid, m, rest = self._route_name(name)
        except KeyError:
            return None
        obj = m.get_pod(namespace, rest)
        return None if obj is None else self._prefixed_obj(obj, cid)

    def get_pod_logs(self, namespace: str, pod_name: str,
                     container: Optional[str] = None,
                     previous: bool = False,
                     tail_lines: Optional[int] = None) -> str:
        try:
            _cid, m, rest = self._route_name(pod_name)
        except KeyError:
            return ""
        return m.get_pod_logs(
            namespace, rest, container=container, previous=previous,
            tail_lines=tail_lines,
        )

    # -- cluster-scoped ------------------------------------------------------
    def get_nodes(self) -> List[dict]:
        out: List[dict] = []
        for cid, m in self.set.members.items():
            for node in m.get_nodes() or []:
                out.append(self._prefixed_obj(node, cid))
        return out

    def get_node_metrics(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for cid, m in self.set.members.items():
            for name, rec in (m.get_node_metrics() or {}).items():
                out[f"{cid}{SEP}{name}"] = rec
        return out

    def get_pod_metrics(self, namespace: str) -> Dict[str, Any]:
        pods: Dict[str, Any] = {}
        for cid, m in self.set.members.items():
            recs = (m.get_pod_metrics(namespace) or {}).get("pods", {}) or {}
            for name, rec in recs.items():
                pods[f"{cid}{SEP}{name}"] = rec
        return {"pods": pods}

    # -- traces (edges stay cluster-local by prefixing within a member) ------
    def get_service_latency_stats(self, namespace: str) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for cid, m in self.set.members.items():
            for svc, v in (
                m.get_service_latency_stats(namespace) or {}
            ).items():
                out[f"{cid}{SEP}{svc}"] = v
        return out

    def get_error_rate_by_service(self, namespace: str) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for cid, m in self.set.members.items():
            for svc, v in (
                m.get_error_rate_by_service(namespace) or {}
            ).items():
                out[f"{cid}{SEP}{svc}"] = v
        return out

    def get_service_dependencies(self, namespace: str) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for cid, m in self.set.members.items():
            deps = m.get_service_dependencies(namespace) or {}
            for src, dsts in deps.items():
                out[f"{cid}{SEP}{src}"] = [
                    f"{cid}{SEP}{d}" for d in (dsts or [])
                ]
        return out

    def find_slow_operations(self, namespace: str,
                             threshold_ms: float = 500.0) -> List[dict]:
        out: List[dict] = []
        for cid, m in self.set.members.items():
            for op in m.find_slow_operations(namespace, threshold_ms) or []:
                op2 = dict(op)
                if op2.get("service"):
                    op2["service"] = f"{cid}{SEP}{op2['service']}"
                out.append(op2)
        return out

    def get_trace_ids(self, namespace: str, limit: int = 20) -> List[str]:
        out: List[str] = []
        for cid, m in self.set.members.items():
            out.extend(
                f"{cid}{SEP}{t}"
                for t in m.get_trace_ids(namespace, limit) or []
            )
        return out[:limit]

    # -- watch (fan-out; one merged token covers every member) ---------------
    def watch_changes(self, namespace: str,
                      cursor: Optional[str]) -> Dict[str, Any]:
        if cursor is None:
            per: Dict[str, str] = {}
            for cid, m in self.set.members.items():
                r = m.watch_changes(namespace, None)
                if not r.get("supported"):
                    for done_cid, tok in per.items():
                        self._member_close(done_cid, namespace, tok)
                    return {"supported": False, "cursor": None,
                            "expired": False, "changes": []}
                per[cid] = r.get("cursor")
            token = f"mc{next(self._token_seq)}"
            self._tokens[token] = per
            return {"supported": True, "cursor": token,
                    "expired": False, "changes": []}
        per = self._tokens.get(cursor)
        if per is None:
            return {"supported": True, "cursor": cursor,
                    "expired": True, "changes": []}
        changes: List[Dict[str, str]] = []
        for cid, m in self.set.members.items():
            r = m.watch_changes(namespace, per.get(cid))
            if not r.get("supported") or r.get("expired"):
                # ONE member expiring expires the merged feed: partial
                # resync would leave that cluster's slice silently stale
                self.watch_close(namespace, cursor)
                return {"supported": True, "cursor": cursor,
                        "expired": True, "changes": []}
            # member cursors advance per drain (journal-seq feeds mint a
            # new one each time); holding the original would replay every
            # change since registration on every sweep
            per[cid] = r.get("cursor", per.get(cid))
            for c in r.get("changes") or []:
                c2 = dict(c)
                if c2.get("name"):
                    c2["name"] = f"{cid}{SEP}{c2['name']}"
                changes.append(c2)
        return {"supported": True, "cursor": cursor,
                "expired": False, "changes": changes}

    def _member_close(self, cid: str, namespace: str, tok: Any) -> None:
        # journal-seq feeds (mock worlds) are stateless and have no close
        close = getattr(self.set.members[cid], "watch_close", None)
        if callable(close):
            close(namespace, tok)

    def watch_close(self, namespace: str, cursor: Optional[str]) -> None:
        per = self._tokens.pop(cursor, None) if cursor else None
        if per:
            for cid, tok in per.items():
                self._member_close(cid, namespace, tok)

    # -- columnar (the live adapter over the merged view) --------------------
    def get_columnar(self, namespace: str,
                     cursor: Optional[str] = None) -> Dict[str, Any]:
        from rca_tpu_torch.cluster.live_columnar import LiveColumnarFeed

        feed = self._feeds.get(namespace)
        if feed is None:
            feed = self._feeds[namespace] = LiveColumnarFeed(
                self, namespace
            )
        return feed.payload(cursor)

    def close(self) -> None:
        for feed in self._feeds.values():
            feed.close()
        self._feeds.clear()


# forwarded plain list getters: merged union with prefixing
def _make_merged_getter(getter: str):
    def merged(self: MergedClusterClient, namespace: str, *args, **kwargs):
        return self._merge_lists(getter, namespace)

    merged.__name__ = getter
    merged.__doc__ = (
        f"Merged union of every member's ``{getter}`` for this "
        "namespace, cluster-prefixed."
    )
    return merged


for _g in _NS_LIST_GETTERS:
    setattr(MergedClusterClient, _g, _make_merged_getter(_g))
del _g
