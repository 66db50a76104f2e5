"""Live columnar ingestion: ``get_columnar`` for watch-backed clients (the
port's copy of ``rca_tpu.cluster.live_columnar``).

Only a client with a mutation journal (the mock) can feed a columnar
master directly.  This module extends the columnar capture to any
watch-capable client without forking the encode path: a
:class:`LiveColumnarFeed` maintains a **shadow**
:class:`~rca_tpu_torch.cluster.world.World` for one namespace of the
client (the real :class:`~rca_tpu_torch.cluster.k8s_client.K8sApiClient`,
or a mock standing in for it), journals every observed change into it,
and runs the SAME :class:`~rca_tpu_torch.cluster.columnar.ColumnarWorld`
master on top.  Every pod row is encoded by the shared
:func:`~rca_tpu_torch.cluster.columnar._extract_columnar` — live-vs-dict
bit-parity is therefore structural, and tests/test_torch_k8s_client.py
holds the feed to the mock's own ``get_columnar``.

Sync model (one ``payload()`` call = one sweep):

- the watch feed (``client.watch_changes``, the watch-pump surface whose
  entries carry per-event resourceVersions) names what changed; changed
  pods are re-fetched individually (object + tail-200 logs), changed
  topology kinds re-list their store and diff by ``resourceVersion``;
- a watch **expiry** (410 Gone, pump death, journal overrun) re-opens
  the feed FIRST and then reconciles every store against a fresh list —
  re-list-after-reopen means nothing that changes during the recovery
  can fall between feed positions (no silent gap);
- pod metrics re-fetch and diff every sweep (metrics have no watch),
  topology re-lists every ``RCA_INGEST_TOPO_EVERY``-th sweep even
  without watch entries (real pumps only stream pods + events).

Shadow-journal note: :meth:`World.touch` deliberately rewrites the
touched object's ``resourceVersion`` (mock worlds need write stamps);
the shadow must NOT — its objects carry the API server's versions
verbatim, and snapshot parity compares them — so the feed appends
journal entries itself (:meth:`LiveColumnarFeed._journal`).

Cursor note: mirrors parse cursors with ``int()``, and a feed torn down
by a reconnect restarts its shadow journal at zero — so every feed
instance offsets its cursors by a process-monotonic generation base.  A
cursor minted by a dead feed lands below the new feed's base, reads as
out-of-range, and is answered with a full dump instead of silently
aliasing onto unrelated diff ops.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Set

from rca_tpu_torch.cluster.columnar import (
    KIND_STORES,
    LOG_TAIL_LINES,
    ColumnarWorld,
    _extract_columnar,  # noqa: F401  (re-exported: THE shared encoder)
)
from rca_tpu_torch.cluster.world import World

#: store name -> the ClusterClient list getter that serves it
STORE_GETTERS: Dict[str, str] = {
    "pods": "get_pods", "services": "get_services",
    "deployments": "get_deployments", "statefulsets": "get_statefulsets",
    "daemonsets": "get_daemonsets", "cronjobs": "get_cronjobs",
    "endpoints": "get_endpoints", "ingresses": "get_ingresses",
    "network_policies": "get_network_policies",
    "configmaps": "get_configmaps", "secrets": "get_secrets",
    "pvcs": "get_pvcs", "resource_quotas": "get_resource_quotas",
    "hpas": "get_hpas",
}

#: generation bases are (counter << _GEN_SHIFT): shadow journal seqs stay
#: far below 2**40, so bases from distinct feed instances can never
#: overlap each other's cursor ranges
_GEN_SHIFT = 40
_GEN = itertools.count(1)


def _name_of(obj: dict) -> str:
    return (obj.get("metadata") or {}).get("name", "")


def _rv_of(obj: dict) -> Optional[str]:
    return (obj.get("metadata") or {}).get("resourceVersion")


class LiveColumnarFeed:
    """One namespace's columnar master over a live (watch-capable)
    client — see module docstring.  ``payload(cursor)`` is the whole
    surface; it returns exactly what the mock's ``get_columnar`` does."""

    def __init__(self, client: Any, namespace: str,
                 topo_every: Optional[int] = None,
                 fetch_logs: Optional[bool] = None):
        from rca_tpu_torch.config import ingest_log_fetch, ingest_topo_every

        self.client = client
        self.namespace = namespace
        self.topo_every = int(
            ingest_topo_every() if topo_every is None else topo_every
        )
        self.fetch_logs = bool(
            ingest_log_fetch() if fetch_logs is None else fetch_logs
        )
        self.world = World(cluster_name=f"live-shadow:{namespace}")
        self.master = ColumnarWorld.master(self.world, namespace)
        self._gen_base = next(_GEN) << _GEN_SHIFT
        self._token: Optional[str] = None
        self._syncs = 0
        self._order_dirty = False
        #: observability: full re-list reconciles (1 bootstrap + expiries)
        self.resyncs = 0
        #: observability: forced master rebuilds after object inserts
        self.order_rebuilds = 0

    # -- the get_columnar surface -------------------------------------------
    def payload(self, cursor: Optional[str] = None) -> Dict[str, Any]:
        """[no-dict-scan] One sweep: drain the watch feed (per-MUTATION
        work lives in ``_sync``), then assemble the coldiff payload as
        the master's column ops — no per-pod Python may run here."""
        if not self._sync():
            return {"supported": False, "reason": "no live watch feed"}
        p = self.master.payload(self._internal_cursor(cursor))
        if p.get("supported") and p.get("cursor") is not None:
            p["cursor"] = str(int(p["cursor"]) + self._gen_base)
        return p

    def close(self) -> None:
        if self._token is not None and hasattr(self.client, "watch_close"):
            self.client.watch_close(self.namespace, self._token)
            self._token = None

    def _internal_cursor(self, cursor: Optional[str]) -> Optional[str]:
        if cursor is None:
            return None
        try:
            c = int(cursor) - self._gen_base
        except (TypeError, ValueError):
            return None
        # a cursor from another generation (an older feed instance) is
        # out of range by construction -> master serves a full dump
        return str(c) if c >= 0 else None

    # -- sync: watch feed -> shadow world -----------------------------------
    def _sync(self) -> bool:
        self._syncs += 1
        if self._token is None:
            res = self.client.watch_changes(self.namespace, None)
            if not res.get("supported"):
                return False
            self._token = res.get("cursor")
            self._reconcile_all()
            return True
        res = self.client.watch_changes(self.namespace, self._token)
        if not res.get("supported"):
            self._token = None
            return False
        # advance: journal-seq feeds (mock, merged) mint a NEW cursor per
        # drain; pump feeds echo the token back — either way the result's
        # cursor is the position of everything this drain delivered
        self._token = res.get("cursor", self._token)
        if res.get("expired"):
            # 410-expiry recovery: reopen the feed FIRST, then re-list —
            # anything that changes mid-recovery lands in the new feed
            res = self.client.watch_changes(self.namespace, None)
            if not res.get("supported"):
                self._token = None
                return False
            self._token = res.get("cursor")
            self._reconcile_all()
            return True
        self._apply_changes(res.get("changes") or [])
        if self.topo_every > 0 and self._syncs % self.topo_every == 0:
            for store in KIND_STORES:
                if store != "pods":
                    self._reconcile_store(store)
            self._reconcile_nodes()
        self._reconcile_metrics()
        if self._order_dirty:
            # an INSERT landed this sweep: incremental master rows
            # append at the tail, but the client's list getter places
            # new objects at their canonical position (segment order on
            # the merged client, name order on a real API server).  The
            # stores were re-listed into client order above; force the
            # master to rebuild from the shadow so row order matches the
            # dict path bit-for-bit.  Updates/deletes stay incremental.
            self._force_rebuild()
        return True

    def _apply_changes(self, changes: List[Dict[str, str]]) -> None:
        pods_changed: Set[str] = set()
        logs_changed: Set[str] = set()
        topo: Set[str] = set()
        events_dirty = nodes_dirty = False
        for c in changes:
            kind = c.get("kind", "")
            if kind == "pod":
                pods_changed.add(c.get("name", ""))
            elif kind == "logs":
                logs_changed.add(c.get("name", ""))
            elif kind == "event":
                events_dirty = True
            elif kind == "node":
                nodes_dirty = True
            elif kind in ("pod_metrics", "traces"):
                continue  # metrics diff every sweep; traces ride snapshots
            else:
                store = World._KIND_PLURAL.get(kind, "")
                if store in STORE_GETTERS and store != "pods":
                    topo.add(store)
        shadow_pods = {
            _name_of(o) for o in self.world.pods.get(self.namespace, [])
        }
        if pods_changed - shadow_pods:
            # at least one changed pod is NEW to the shadow: re-list the
            # whole store so it lands at its canonical list position
            # (and flags the order-dirty rebuild below).  The re-list
            # rv-diffs EVERY pod, so the per-name syncs are covered.
            self._reconcile_store("pods")
            pods_changed.clear()
        for name in sorted(pods_changed):
            self._sync_pod(name)
        for name in sorted(logs_changed - pods_changed):
            self._sync_logs(name)
        for store in sorted(topo):
            self._reconcile_store(store)
        if events_dirty:
            self._reconcile_events()
        if nodes_dirty:
            self._reconcile_nodes()

    # -- per-object sync -----------------------------------------------------
    def _journal(self, kind: str, name: str) -> None:
        """World.touch minus the resourceVersion rewrite: shadow objects
        keep the API server's versions verbatim (parity compares them)."""
        w = self.world
        w.journal_seq += 1
        w.journal.append({
            "seq": w.journal_seq, "kind": kind,
            "namespace": self.namespace, "name": name,
        })
        if len(w.journal) > w.journal_cap:
            drop = len(w.journal) - w.journal_cap
            del w.journal[:drop]
            w.journal_floor = w.journal[0]["seq"]

    def _fetch_logs(self, obj: dict, name: str) -> Dict[str, str]:
        if not self.fetch_logs:
            return {}
        out: Dict[str, str] = {}
        for c in (obj.get("spec", {}) or {}).get("containers", []) or []:
            cname = c.get("name", "")
            try:
                out[cname] = self.client.get_pod_logs(
                    self.namespace, name, container=cname,
                    tail_lines=LOG_TAIL_LINES,
                ) or ""
            except Exception:
                out[cname] = ""
        return out

    def _sync_pod(self, name: str) -> None:
        w, ns = self.world, self.namespace
        obj = self.client.get_pod(ns, name)
        lst = w.pods.setdefault(ns, [])
        if not isinstance(obj, dict) or not obj:
            for i, o in enumerate(lst):
                if _name_of(o) == name:
                    del lst[i]
                    w.logs.get(ns, {}).pop(name, None)
                    self._journal("pod", name)
                    return
            return
        for i, o in enumerate(lst):
            if _name_of(o) == name:
                lst[i] = obj
                break
        else:
            lst.append(obj)
        w.logs.setdefault(ns, {})[name] = self._fetch_logs(obj, name)
        self._journal("pod", name)

    def _sync_logs(self, name: str) -> None:
        w, ns = self.world, self.namespace
        pod = None
        for o in w.pods.get(ns, []):
            if _name_of(o) == name:
                pod = o
                break
        if pod is None:
            return
        w.logs.setdefault(ns, {})[name] = self._fetch_logs(pod, name)
        self._journal("logs", name)

    # -- store-level reconcile ----------------------------------------------
    def _reconcile_store(self, store: str,
                         fetched: Optional[List[dict]] = None) -> None:
        """List one store and diff against the shadow by resourceVersion
        (deep equality for rv-less objects): upserts and deletes journal,
        unchanged rows cost nothing downstream (the master's rv-skip)."""
        w, ns = self.world, self.namespace
        if fetched is None:
            fetched = getattr(self.client, STORE_GETTERS[store])(ns) or []
        kind = World._KIND_SINGULAR.get(store, store)
        cur = getattr(w, store).setdefault(ns, [])
        want = {_name_of(o): o for o in fetched}
        for o in [o for o in cur if _name_of(o) not in want]:
            name = _name_of(o)
            cur.remove(o)
            if store == "pods":
                w.logs.get(ns, {}).pop(name, None)
            self._journal(kind, name)
        pos = {_name_of(o): i for i, o in enumerate(cur)}
        inserted = False
        for name, obj in want.items():
            i = pos.get(name)
            if i is not None:
                rv_new, rv_old = _rv_of(obj), _rv_of(cur[i])
                if (rv_new is not None and rv_new == rv_old) \
                        or cur[i] == obj:
                    continue
                cur[i] = obj
            else:
                cur.append(obj)
                inserted = True
            if store == "pods":
                w.logs.setdefault(ns, {})[name] = \
                    self._fetch_logs(obj, name)
            self._journal(kind, name)
        if inserted:
            # restore the client's canonical list order (new objects
            # were appended at the tail above); master row order is
            # fixed up by the caller's forced rebuild
            by_name = {_name_of(o): o for o in cur}
            cur[:] = [by_name[n] for n in want if n in by_name]
            # in-place reorder keeps the list's id() and len() — the
            # world's position index would go stale-on-MISS (find()
            # only self-heals on hit mismatch), and a stale miss reads
            # as a deletion to the columnar master
            w._pos_index.pop((store, ns), None)
            self._order_dirty = True

    def _reconcile_events(self) -> None:
        w, ns = self.world, self.namespace
        evs = self.client.get_events(ns) or []
        if evs != w.events.get(ns, []):
            w.events[ns] = list(evs)
            self._journal("event", "")

    def _reconcile_nodes(self) -> None:
        nodes = self.client.get_nodes() or []
        if nodes != self.world.nodes:
            self.world.nodes = list(nodes)
            self._journal("node", "")

    def _reconcile_metrics(self) -> None:
        w, ns = self.world, self.namespace
        mets = self.client.get_pod_metrics(ns) or {}
        new_pods = dict(mets.get("pods", {}) or {})
        old_pods = (w.pod_metrics.get(ns) or {}).get("pods", {}) or {}
        changed = [
            n for n, rec in new_pods.items() if old_pods.get(n) != rec
        ] + [n for n in old_pods if n not in new_pods]
        w.pod_metrics[ns] = {**mets, "pods": new_pods}
        for name in sorted(changed):
            self._journal("pod_metrics", name)

    def _force_rebuild(self) -> None:
        """Expire every master/mirror cursor at or below the current
        journal seq: the next ``payload()`` rebuilds columns from the
        shadow world (in client list order) and serves mirrors a full
        dump.  Used when list ORDER changed (inserts), which incremental
        ops cannot express."""
        w = self.world
        w.journal.clear()
        w.journal_floor = w.journal_seq + 2
        w.journal_seq += 1
        self._order_dirty = False
        self.order_rebuilds += 1

    def _reconcile_all(self) -> None:
        """Full re-list of every store — bootstrap and expiry recovery.
        Rebuilds ride the forced-expiry path: the master re-derives the
        columns from the shadow world instead of chewing an op flood,
        and every outstanding mirror cursor gets a full dump."""
        self.resyncs += 1
        self._reconcile_store("pods")
        for store in KIND_STORES:
            if store != "pods":
                self._reconcile_store(store)
        self._reconcile_events()
        self._reconcile_nodes()
        self._reconcile_metrics()
        self._force_rebuild()
