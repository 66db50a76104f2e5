"""Columnar world state: vectorized capture (the port's copy of
``rca_tpu.cluster.columnar``).

The dict capture re-walks the namespace one object at a time —
``sanitize_objects`` over every collection plus the per-pod
``_pod_feature_row`` loop.  This module turns that O(objects) per-sweep
cost into O(dirty rows) per MUTATION plus O(1) vectorized slices per
sweep:

- a :class:`ColumnarWorld` **master** binds to one namespace of a mock
  :class:`~rca_tpu_torch.cluster.world.World` and consumes its mutation
  journal (the same feed ``watch_changes`` serves): each journal entry
  becomes a **row write** — the touched object is sanitized once, its
  derived feature fields are encoded once (``_pod_feature_row``, the
  log-pattern scan, the metric percentages — THE same scalar encoders the
  dict path runs, so bit-parity holds by construction), and a dirty-row
  bitmap marks what changed;
- a **mirror** (``mode="mirror"``) holds the same tables on the consumer
  side of the client boundary, fed by :meth:`payload` dicts — a full
  table dump once, then **column diffs** (ordered row ops) from a cursor;
  a mirror fed the same payloads reconstructs byte-identical tables;
- :meth:`build_view` assembles the extractor's inputs — the packed pod
  feature matrix, the pod->service membership COO pairs, the pod->node
  index — as vectorized slices over the columns (no per-pod Python).

Contract: mutations must be journal-mediated (``World.touch`` /
``World.add``), the same visibility rule the watch feed already has —
out-of-band dict edits are invisible to both until touched.  Worlds with
duplicate object names in one store are degenerate for name-keyed
maintenance; ``payload`` reports ``supported: False`` and capture falls
back to the dict scans.  Bit-parity of the columnar-vs-dict
:class:`~rca_tpu_torch.features.extract.FeatureSet` is property-tested
across update/delete/NaN/gone-storm sequences
(tests/test_torch_columnar.py).
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np

from rca_tpu_torch.cluster.sanitize import sanitize_objects
from rca_tpu_torch.cluster.world import World
from rca_tpu_torch.features.logscan import LOG_PATTERN_NAMES, scan_text_cached
from rca_tpu_torch.features.schema import NUM_POD_FEATURES, PodF

N_LOG = len(LOG_PATTERN_NAMES)

#: namespaced object stores carried as columnar kind tables, in the
#: (stable) order the payload serializes them.  Events and nodes ride
#: separately (append-only diffs / cluster-scoped wholesale).
KIND_STORES: Tuple[str, ...] = (
    "pods", "services", "deployments", "statefulsets", "daemonsets",
    "cronjobs", "endpoints", "ingresses", "network_policies",
    "configmaps", "secrets", "pvcs", "resource_quotas", "hpas",
)

#: fixed log-tail policy the columns are encoded under — the same
#: ``tail_lines`` the dict capture path passes; a capture asking for a
#: different tail cannot use the columnar path (snapshot.py guards)
LOG_TAIL_LINES = 200

#: retained column-diff ops before old cursors are answered with a full
#: payload instead (mirrors the world journal's expire semantics)
OP_LOG_CAP = 10_000


def digest_array_crc(arr: np.ndarray) -> str:
    """Content digest of an ndarray in ONE vectorized CRC pass (shape +
    dtype + raw bytes through crc32), the cheap identity of a column block:
    two captures whose feature matrices digest alike are bitwise equal up
    to crc32."""
    a = np.ascontiguousarray(arr)
    crc = zlib.crc32(f"{a.shape}{a.dtype}".encode())
    crc = zlib.crc32(a.tobytes(), crc)
    return f"{crc:08x}"


class ColumnarUnsupported(Exception):
    """The world cannot be maintained columnar (duplicate names)."""


def _tail(text: str, lines: int = LOG_TAIL_LINES) -> str:
    """The mock client's tail_lines semantics, verbatim."""
    if lines <= 0:
        return ""
    return "\n".join(text.splitlines()[-lines:])


def _pod_base_row(pod: dict) -> np.ndarray:
    """The pod-OBJECT-derived feature block: ``_pod_feature_row`` with
    zeroed sidecars (metrics/events/logs ride in their own columns and
    are overlaid vectorized at assembly).  One row definition for both
    paths — this is what makes columnar-vs-dict bit-parity structural."""
    from rca_tpu_torch.features.extract import _pod_feature_row

    return _pod_feature_row(pod, 0, None, None)


def _pod_log_fields(pod: dict, texts_by_container: Dict[str, str],
                    ) -> Tuple[np.ndarray, bool]:
    """(pattern counts int32 [13], any-nonblank flag) for one pod, from
    the world's log store — the same per-container tail-200 view
    ``get_pod_logs`` serves the dict capture."""
    counts = np.zeros(N_LOG, dtype=np.int32)
    nonblank = False
    for c in (pod.get("spec", {}) or {}).get("containers", []) or []:
        text = _tail(texts_by_container.get(c.get("name", ""), "") or "")
        if text:
            counts += scan_text_cached(text)
            nonblank = nonblank or bool(text.strip())
    return counts, nonblank


def _metric_pcts_pair(rec: Optional[dict]) -> Tuple[float, float]:
    from rca_tpu_torch.features.extract import _metric_pcts

    return _metric_pcts(rec)


def _extract_columnar(obj_s: dict, rec: Optional[dict],
                      texts_by_container: Dict[str, str]) -> dict:
    """ONE (sanitized) pod object + its metric record + its log texts ->
    the pod's full columnar scalar block, as the wire-op dict shape.  THE
    shared encoder: the journal-fed master (``_encode_pod_op``), the full
    rebuild, and the live ``K8sApiClient`` adapter (cluster/
    live_columnar.py) all route through here, which is what makes
    live-vs-mock-vs-dict bit-parity structural rather than aspirational."""
    logc, lnb = _pod_log_fields(obj_s, texts_by_container or {})
    return {
        "obj": obj_s, "rec": rec,
        "logc": [int(x) for x in logc], "lnb": bool(lnb),
    }


def _warn_counts_of(events: List[dict]) -> Dict[str, int]:
    """Warning-event counts by involved pod — the extractor's
    ``_warn_counts`` over a plain event list."""
    out: Dict[str, int] = {}
    for ev in events:
        if ev.get("type") == "Normal":
            continue
        obj = ev.get("involvedObject", {}) or {}
        if obj.get("kind") == "Pod":
            name = obj.get("name", "")
            out[name] = out.get(name, 0) + int(ev.get("count", 1) or 1)
    return out


@dataclasses.dataclass
class ColumnarView:
    """Frozen per-capture bundle of the extractor's vectorized inputs.
    Attached to a :class:`~rca_tpu_torch.cluster.snapshot.ClusterSnapshot` as
    ``snapshot.columnar``; every array is materialized at capture time so
    later world mutation cannot drift a retained snapshot."""

    pod_names: List[str]
    pod_features: np.ndarray       # [P, NUM_POD_FEATURES] float32
    pod_service: np.ndarray        # [P] int32
    memb_pod: np.ndarray           # [M] int32
    memb_svc: np.ndarray           # [M] int32
    pod_node: np.ndarray           # [P] int32
    service_names: List[str]
    selectors: List[dict]
    node_names: List[str]
    sampled_names: List[str]       # pods the log policy selected


class _KindTable:
    """One namespaced store as (objects list, name->row index): row order
    mirrors the store list (appends at the end, deletes shift up) so the
    snapshot's object lists stay order-identical to the dict path's."""

    def __init__(self) -> None:
        self.objects: List[dict] = []
        self.pos: Dict[str, int] = {}
        self.rv: List[Optional[str]] = []

    def reset(self, objects: List[dict]) -> None:
        self.objects = list(objects)
        self.pos = {
            (o.get("metadata") or {}).get("name", ""): i
            for i, o in enumerate(self.objects)
        }
        self.rv = [
            (o.get("metadata") or {}).get("resourceVersion")
            for o in self.objects
        ]

    def set(self, name: str, obj: dict) -> int:
        """Upsert; returns the row index."""
        row = self.pos.get(name)
        rv = (obj.get("metadata") or {}).get("resourceVersion")
        if row is None:
            row = len(self.objects)
            self.objects.append(obj)
            self.pos[name] = row
            self.rv.append(rv)
        else:
            self.objects[row] = obj
            self.rv[row] = rv
        return row

    def delete(self, name: str) -> Optional[int]:
        row = self.pos.pop(name, None)
        if row is None:
            return None
        del self.objects[row]
        del self.rv[row]
        for n, i in self.pos.items():
            if i > row:
                self.pos[n] = i - 1
        return row


class _PodColumns:
    """The pod table's numpy columns (amortized-growth capacity arrays).
    Row i aligns with ``_KindTable.objects[i]`` of the pods table."""

    def __init__(self) -> None:
        self.n = 0
        cap = 64
        self.base = np.zeros((cap, NUM_POD_FEATURES), np.float32)
        self.cpu = np.zeros(cap, np.float32)
        self.mem = np.zeros(cap, np.float32)
        self.warn = np.zeros(cap, np.int64)
        self.logc = np.zeros((cap, N_LOG), np.int32)
        self.lnb = np.zeros(cap, bool)
        self.label_sig = np.zeros(cap, np.int32)
        self.node_id = np.full(cap, -1, np.int32)
        # dirty-row bitmap: rows written since the last build_view —
        # observability for tests/bench (the view itself is assembled
        # from full column slices, which is cheaper than gather at the
        # densities a busy tick sees)
        self.dirty = np.zeros(cap, bool)

    def _grow(self, need: int) -> None:
        cap = len(self.cpu)
        if need <= cap:
            return
        new_cap = max(need, cap * 2)

        def grown(a: np.ndarray) -> np.ndarray:
            shape = (new_cap,) + a.shape[1:]
            out = np.zeros(shape, a.dtype)
            out[: self.n] = a[: self.n]
            return out

        self.base = grown(self.base)
        self.cpu = grown(self.cpu)
        self.mem = grown(self.mem)
        self.warn = grown(self.warn)
        self.logc = grown(self.logc)
        self.lnb = grown(self.lnb)
        self.label_sig = grown(self.label_sig)
        node = np.full(new_cap, -1, np.int32)
        node[: self.n] = self.node_id[: self.n]
        self.node_id = node
        self.dirty = grown(self.dirty)

    def ensure_row(self, row: int) -> None:
        if row >= self.n:
            self._grow(row + 1)
            self.n = row + 1

    def delete_rows(self, rows: List[int]) -> None:
        if not rows:
            return
        keep = np.ones(self.n, bool)
        keep[np.asarray(rows, np.int64)] = False
        m = int(keep.sum())
        for attr in ("base", "cpu", "mem", "warn", "logc", "lnb",
                     "label_sig", "node_id", "dirty"):
            a = getattr(self, attr)
            a[:m] = a[: self.n][keep]
            if attr == "node_id":
                a[m: self.n] = -1
            else:
                a[m: self.n] = 0
        self.n = m


class ColumnarWorld:
    """Columnar tables for ONE namespace — master (bound to a World,
    journal-fed) or mirror (payload-fed, the client-side twin)."""

    def __init__(self, namespace: str, world: Optional[World] = None):
        self.namespace = namespace
        self.world = world                      # None = mirror mode
        self.kinds: Dict[str, _KindTable] = {
            k: _KindTable() for k in KIND_STORES
        }
        self.cols = _PodColumns()
        self.events: List[dict] = []
        self.nodes: List[dict] = []
        self.metric_recs: Dict[str, Any] = {}
        self.warn_by_name: Dict[str, int] = {}
        # label-set / node-name registries (append-only; row columns hold
        # int ids into them so membership matching runs per DISTINCT set)
        self.label_registry: List[tuple] = []
        self.label_index: Dict[tuple, int] = {}
        self.node_registry: List[str] = []
        self.node_index: Dict[str, int] = {}
        # master cursor + column-diff op log
        self.cursor: Optional[int] = None
        self._op_log: List[Tuple[int, List[dict]]] = []
        self._op_floor: int = 0
        self._ops_retained = 0
        # selector/membership memo (svc_gen bumps on services mutation)
        self._svc_gen = 0
        self._svc_state: Optional[Dict[str, Any]] = None

    # -- master construction ------------------------------------------------
    @classmethod
    def master(cls, world: World, namespace: str) -> "ColumnarWorld":
        return cls(namespace, world=world)

    def _degenerate(self) -> bool:
        w = self.world
        return any(
            w.store_degenerate(k, self.namespace) for k in KIND_STORES
        )

    # -- encode (master side: world object -> row op) -----------------------
    def _encode_pod_op(self, name: str) -> Optional[dict]:
        w, ns = self.world, self.namespace
        obj = w.find("pods", ns, name)
        if obj is None or not isinstance(obj, dict):
            if name in self.kinds["pods"].pos:
                return {"op": "delpod", "name": name}
            return None
        rv = (obj.get("metadata") or {}).get("resourceVersion")
        tbl = self.kinds["pods"]
        row = tbl.pos.get(name)
        if row is not None and rv is not None and tbl.rv[row] == rv:
            return None  # duplicate journal entry for an already-encoded rv
        clean = sanitize_objects([obj])
        if not clean:
            return None
        obj_s = clean[0]
        rec = (
            w.pod_metrics.get(ns, {}).get("pods", {}) or {}
        ).get(name)
        ext = _extract_columnar(
            obj_s, rec, w.logs.get(ns, {}).get(name, {}) or {}
        )
        return {"op": "pod", "name": name, **ext}

    def _encode_kind_op(self, store: str, name: str) -> Optional[dict]:
        w, ns = self.world, self.namespace
        obj = w.find(store, ns, name)
        if obj is None or not isinstance(obj, dict):
            if name in self.kinds[store].pos:
                return {"op": "del", "kind": store, "name": name}
            return None
        rv = (obj.get("metadata") or {}).get("resourceVersion")
        tbl = self.kinds[store]
        row = tbl.pos.get(name)
        if row is not None and rv is not None and tbl.rv[row] == rv:
            return None
        clean = sanitize_objects([obj])
        if not clean:
            return None
        return {"op": "set", "kind": store, "name": name, "obj": clean[0]}

    def _encode_entries(self, entries: List[dict]) -> List[dict]:
        """Journal entries -> ordered column-diff ops.  Entries process in
        journal order so table row order tracks store list order (deletes
        shift, re-adds append) — the rv skip makes repeats free."""
        ops: List[dict] = []
        events_dirty = False
        nodes_dirty = False
        w, ns = self.world, self.namespace
        plural = World._KIND_PLURAL
        for e in entries:
            if e.get("namespace") != ns and e.get("kind") != "node":
                continue
            kind = e.get("kind", "")
            name = e.get("name", "")
            if kind == "pod":
                op = self._encode_pod_op(name)
                if op:
                    ops.append(op)
            elif kind == "logs":
                obj = self.kinds["pods"].pos.get(name)
                pod = w.find("pods", ns, name)
                if obj is not None and pod is not None:
                    clean = sanitize_objects([pod])
                    if clean:
                        logc, lnb = _pod_log_fields(
                            clean[0], w.logs.get(ns, {}).get(name, {}) or {}
                        )
                        ops.append({
                            "op": "logs", "name": name,
                            "logc": [int(x) for x in logc],
                            "lnb": bool(lnb),
                        })
            elif kind == "pod_metrics":
                rec = (
                    w.pod_metrics.get(ns, {}).get("pods", {}) or {}
                ).get(name)
                ops.append({"op": "metrics", "name": name, "rec": rec})
            elif kind == "event":
                events_dirty = True
            elif kind == "node":
                nodes_dirty = True
            elif kind == "traces":
                continue  # traces ride the snapshot, not the tables
            else:
                store = plural.get(kind)
                if store and store in self.kinds and store != "pods":
                    op = self._encode_kind_op(store, name)
                    if op:
                        ops.append(op)
        if events_dirty:
            cur = self.world.events.get(ns, [])
            known = len(self.events)
            if len(cur) > known:
                ops.append({
                    "op": "events",
                    "append": sanitize_objects(cur[known:]),
                })
            else:
                # shrink or in-place edit: re-sanitize wholesale (events
                # are small next to pods; append-only is the common case)
                ops.append({"op": "events", "full": sanitize_objects(cur)})
        if nodes_dirty:
            ops.append({
                "op": "nodes", "objects": sanitize_objects(self.world.nodes),
            })
        return ops

    # -- refresh (master): drain the world journal --------------------------
    def refresh(self) -> None:
        w = self.world
        if self.cursor is None:
            self._rebuild()
            return
        entries = w.changes_since(self.cursor)
        if entries is None:
            # journal trimmed past our cursor (gone storm): rebuild; old
            # consumer cursors get a full payload
            self._rebuild()
            return
        if not entries:
            return
        ops = self._encode_entries(entries)
        self.cursor = int(entries[-1]["seq"])
        if ops:
            self._apply_ops(ops)
            self._op_log.append((self.cursor, ops))
            self._ops_retained += len(ops)
            while self._op_log and self._ops_retained > OP_LOG_CAP:
                seq, dropped = self._op_log.pop(0)
                self._ops_retained -= len(dropped)
                self._op_floor = seq

    def _rebuild(self) -> None:
        """Full rebuild from the world's stores (initialization, or
        journal-expiry recovery — the columnar analogue of a resync)."""
        w, ns = self.world, self.namespace
        self.cursor = int(w.journal_seq)
        self._op_log = []
        self._ops_retained = 0
        self._op_floor = self.cursor
        self.events = sanitize_objects(w.events.get(ns, []))
        self.nodes = sanitize_objects(w.nodes)
        self.warn_by_name = _warn_counts_of(self.events)
        self.metric_recs = dict(
            w.pod_metrics.get(ns, {}).get("pods", {}) or {}
        )
        for store, tbl in self.kinds.items():
            if store == "pods":
                continue
            tbl.reset(sanitize_objects(
                getattr(w, store).get(ns, [])
            ))
        self._svc_gen += 1
        pods = sanitize_objects(w.pods.get(ns, []))
        self.kinds["pods"].reset(pods)
        self.cols = _PodColumns()
        self.cols._grow(len(pods))
        self.cols.n = len(pods)
        logs_store = w.logs.get(ns, {})
        for i, pod in enumerate(pods):
            name = (pod.get("metadata") or {}).get("name", "")
            rec = self.metric_recs.get(name)
            ext = _extract_columnar(pod, rec, logs_store.get(name, {}) or {})
            self._write_pod_row(i, pod, rec, ext["logc"], ext["lnb"])

    # -- shared row write (master + mirror) ---------------------------------
    def _label_sig(self, labels: Dict[str, str]) -> int:
        key = tuple(sorted(labels.items()))
        sig = self.label_index.get(key)
        if sig is None:
            sig = len(self.label_registry)
            self.label_registry.append(key)
            self.label_index[key] = sig
        return sig

    def _node_sig(self, node: Any) -> int:
        if not node:
            return -1
        sig = self.node_index.get(node)
        if sig is None:
            sig = len(self.node_registry)
            self.node_registry.append(node)
            self.node_index[node] = sig
        return sig

    def _write_pod_row(self, row: int, obj: dict, rec: Optional[dict],
                       logc: Any, lnb: bool) -> None:
        c = self.cols
        c.ensure_row(row)
        c.base[row] = _pod_base_row(obj)
        cpu, mem = _metric_pcts_pair(rec)
        c.cpu[row] = cpu
        c.mem[row] = mem
        md = obj.get("metadata") or {}
        name = md.get("name", "")
        c.warn[row] = self.warn_by_name.get(name, 0)
        c.logc[row] = np.asarray(logc, np.int32)
        c.lnb[row] = bool(lnb)
        c.label_sig[row] = self._label_sig(md.get("labels", {}) or {})
        c.node_id[row] = self._node_sig(
            (obj.get("spec", {}) or {}).get("nodeName")
        )
        c.dirty[row] = True

    def _apply_events(self, op: dict) -> None:
        pos = self.kinds["pods"].pos
        if "append" in op:
            new = list(op["append"])
            self.events.extend(new)
            delta = _warn_counts_of(new)
            for name, cnt in delta.items():
                self.warn_by_name[name] = (
                    self.warn_by_name.get(name, 0) + cnt
                )
            touched = list(delta)
        else:
            self.events = list(op["full"])
            self.warn_by_name = _warn_counts_of(self.events)
            # full recompute: pods whose events disappeared must zero too
            touched = list(pos)
        for name in touched:
            row = pos.get(name)
            if row is not None:
                self.cols.warn[row] = self.warn_by_name.get(name, 0)
                self.cols.dirty[row] = True

    def _apply_ops(self, ops: List[dict]) -> None:
        i = 0
        pods = self.kinds["pods"]
        while i < len(ops):
            op = ops[i]
            k = op["op"]
            if k == "delpod":
                # table delete shifts later rows up; the column compaction
                # uses the row index valid at that same moment
                row = pods.delete(op["name"])
                if row is not None:
                    self.cols.delete_rows([row])
                i += 1
                continue
            if k == "pod":
                obj = op["obj"]
                row = pods.set(op["name"], obj)
                rec = op.get("rec")
                if rec is not None:
                    self.metric_recs[op["name"]] = rec
                else:
                    self.metric_recs.pop(op["name"], None)
                self._write_pod_row(
                    row, obj, rec, op["logc"], op["lnb"]
                )
            elif k == "logs":
                row = pods.pos.get(op["name"])
                if row is not None:
                    self.cols.logc[row] = np.asarray(op["logc"], np.int32)
                    self.cols.lnb[row] = bool(op["lnb"])
                    self.cols.dirty[row] = True
            elif k == "metrics":
                rec = op.get("rec")
                name = op["name"]
                if rec is not None:
                    self.metric_recs[name] = rec
                else:
                    self.metric_recs.pop(name, None)
                row = pods.pos.get(name)
                if row is not None:
                    cpu, mem = _metric_pcts_pair(rec)
                    self.cols.cpu[row] = cpu
                    self.cols.mem[row] = mem
                    self.cols.dirty[row] = True
            elif k == "set":
                self.kinds[op["kind"]].set(op["name"], op["obj"])
                if op["kind"] == "services":
                    self._svc_gen += 1
            elif k == "del":
                self.kinds[op["kind"]].delete(op["name"])
                if op["kind"] == "services":
                    self._svc_gen += 1
            elif k == "events":
                self._apply_events(op)
            elif k == "nodes":
                self.nodes = list(op["objects"])
            i += 1

    # -- payload (master serves; mirror applies) ----------------------------
    def payload(self, cursor: Optional[str] = None) -> Dict[str, Any]:
        """Full table dump (``cursor`` None/expired) or the column-diff
        ops since ``cursor``.  The wire shape is JSON-able except the
        full dump's numpy columns."""
        if self._degenerate():
            return {"supported": False, "reason": "duplicate object names"}
        self.refresh()
        cur: Optional[int] = None
        if cursor is not None:
            try:
                cur = int(cursor)
            except (TypeError, ValueError):
                cur = None
        if cur is not None and self._op_floor <= cur <= self.cursor:
            ops: List[dict] = []
            for seq, batch in self._op_log:
                if seq > cur:
                    ops.extend(batch)
            return {
                "supported": True, "full": False,
                "cursor": str(self.cursor), "ops": ops,
            }
        n = self.cols.n
        return {
            "supported": True, "full": True, "cursor": str(self.cursor),
            "kinds": {
                k: list(t.objects) for k, t in self.kinds.items()
            },
            "events": list(self.events),
            "nodes": list(self.nodes),
            "pods_aux": {
                "metrics": dict(self.metric_recs),
                "base": self.cols.base[:n],
                "cpu": self.cols.cpu[:n],
                "mem": self.cols.mem[:n],
                "warn": self.cols.warn[:n],
                "logc": self.cols.logc[:n],
                "lnb": self.cols.lnb[:n],
                "label_sig": self.cols.label_sig[:n],
                "node_id": self.cols.node_id[:n],
                "label_sets": [list(map(list, t))
                               for t in self.label_registry],
                "node_names": list(self.node_registry),
            },
        }

    # -- mirror: apply a payload -------------------------------------------
    def apply_payload(self, payload: Dict[str, Any]
                      ) -> Tuple[bool, Set[str], Set[str]]:
        """Apply one :meth:`payload` to mirror tables; returns
        ``(full, changed_pod_names, removed_pod_names)`` so the capture
        layer knows which log-text cache entries went stale."""
        if not payload.get("supported"):
            raise ColumnarUnsupported(payload.get("reason", ""))
        raw = payload.get("cursor")
        self.cursor = int(raw) if raw is not None else None
        if payload.get("full"):
            self._reset_from_full(payload)
            return True, set(), set()
        changed: Set[str] = set()
        removed: Set[str] = set()
        ops = payload.get("ops", [])
        for op in ops:
            k = op["op"]
            if k in ("pod", "logs"):
                changed.add(op["name"])
            elif k == "delpod":
                removed.add(op["name"])
        self._apply_ops(ops)
        return False, changed, removed

    def _reset_from_full(self, payload: Dict[str, Any]) -> None:
        for k, tbl in self.kinds.items():
            tbl.reset(payload["kinds"].get(k, []))
        self._svc_gen += 1
        self.events = list(payload.get("events", []))
        self.nodes = list(payload.get("nodes", []))
        self.warn_by_name = _warn_counts_of(self.events)
        aux = payload["pods_aux"]
        self.metric_recs = dict(aux.get("metrics", {}))
        n = len(self.kinds["pods"].objects)
        cols = _PodColumns()
        cols._grow(n)
        cols.n = n
        cols.base[:n] = np.asarray(aux["base"], np.float32)
        cols.cpu[:n] = np.asarray(aux["cpu"], np.float32)
        cols.mem[:n] = np.asarray(aux["mem"], np.float32)
        cols.warn[:n] = np.asarray(aux["warn"], np.int64)
        cols.logc[:n] = np.asarray(aux["logc"], np.int32)
        cols.lnb[:n] = np.asarray(aux["lnb"], bool)
        cols.label_sig[:n] = np.asarray(aux["label_sig"], np.int32)
        cols.node_id[:n] = np.asarray(aux["node_id"], np.int32)
        cols.dirty[:n] = True
        self.cols = cols
        self.label_registry = [
            tuple(tuple(kv) for kv in entry)
            for entry in aux.get("label_sets", [])
        ]
        self.label_index = {
            t: i for i, t in enumerate(self.label_registry)
        }
        self.node_registry = list(aux.get("node_names", []))
        self.node_index = {
            t: i for i, t in enumerate(self.node_registry)
        }

    # -- vectorized assembly (the extractor's fast path) --------------------
    def _selector_state(self) -> Dict[str, Any]:
        """Service names/selectors + per-distinct-label-set match lists,
        memoized across captures (selectors invalidate on any services
        mutation; the hits list only ever EXTENDS for new label sets)."""
        from rca_tpu_torch.cluster.labels import SelectorIndex

        st = self._svc_state
        if st is None or st["gen"] != self._svc_gen:
            services = self.kinds["services"].objects
            service_names = [
                s.get("metadata", {}).get("name", f"svc-{j}")
                for j, s in enumerate(services)
            ]
            selectors = [
                (s.get("spec", {}) or {}).get("selector") or {}
                for s in services
            ]
            st = {
                "gen": self._svc_gen,
                "names": service_names,
                "selectors": selectors,
                "index": SelectorIndex(selectors),
                "hits": [],
            }
            self._svc_state = st
        hits: List[np.ndarray] = st["hits"]
        while len(hits) < len(self.label_registry):
            items = self.label_registry[len(hits)]
            hits.append(np.asarray(
                st["index"].matches(dict(items)), np.int32
            ))
        return st

    def _sampled_mask(self, max_log_pods: Optional[int]) -> np.ndarray:
        """[no-dict-scan] The log-fetch priority policy
        (``_prioritize_pods_for_logs``) as a vectorized mask: all
        unhealthy pods, then healthy ones up to the cap, in pod order."""
        n = self.cols.n
        b = self.cols.base[:n]
        healthy = (
            ((b[:, PodF.PHASE_RUNNING] == 1.0)
             | (b[:, PodF.PHASE_SUCCEEDED] == 1.0))
            & (b[:, PodF.NOT_READY] == 0.0)
            & (b[:, PodF.RESTARTS] == 0.0)
        )
        uidx = np.flatnonzero(~healthy)
        hidx = np.flatnonzero(healthy)
        if max_log_pods is None:
            sel = np.concatenate([uidx, hidx[:25]])
        else:
            sel = np.concatenate([uidx, hidx])[:max_log_pods]
        mask = np.zeros(n, bool)
        mask[sel] = True
        return mask

    def build_view(self, max_log_pods: Optional[int] = None) -> ColumnarView:
        """[no-dict-scan] Assemble the extractor's inputs as vectorized
        slices over the columns — the whole per-capture cost is a few
        array copies; no per-pod Python runs here."""
        c = self.cols
        n = c.n
        feat = c.base[:n].copy()
        feat[:, PodF.CPU_PCT] = c.cpu[:n]
        feat[:, PodF.MEM_PCT] = c.mem[:n]
        w = c.warn[:n]
        feat[:, PodF.WARN_EVENTS] = w
        feat[:, PodF.WARN_EVENTS_SAT] = np.minimum(1.0, w / 10.0)
        sampled = self._sampled_mask(max_log_pods)
        if sampled.any():
            feat[sampled, PodF.LOG0: PodF.LOG0 + N_LOG] = (
                c.logc[:n][sampled].astype(np.float32)
            )
            silent = (
                sampled
                & (c.base[:n, PodF.PHASE_RUNNING] == 1.0)
                & ~c.lnb[:n]
            )
            feat[silent, PodF.NO_LOGS] = 1.0
        c.dirty[:n] = False

        st = self._selector_state()
        hits: List[np.ndarray] = st["hits"]
        sig = c.label_sig[:n]
        if hits:
            lens = np.asarray([len(h) for h in hits], np.int64)
            flat = (
                np.concatenate(hits) if lens.sum()
                else np.zeros(0, np.int32)
            )
            offs = np.concatenate([[0], np.cumsum(lens)])[:-1]
            firsts = np.asarray(
                [int(h[0]) if len(h) else -1 for h in hits], np.int32
            )
            counts = lens[sig]
            total = int(counts.sum())
            memb_pod = np.repeat(
                np.arange(n, dtype=np.int64), counts
            ).astype(np.int32)
            starts = np.repeat(offs[sig], counts)
            within = (
                np.arange(total, dtype=np.int64)
                - np.repeat(np.cumsum(counts) - counts, counts)
            )
            memb_svc = (
                flat[starts + within].astype(np.int32) if total
                else np.zeros(0, np.int32)
            )
            pod_service = np.where(
                counts > 0, firsts[sig], np.int32(-1)
            ).astype(np.int32)
        else:
            memb_pod = np.zeros(0, np.int32)
            memb_svc = np.zeros(0, np.int32)
            pod_service = np.full(n, -1, np.int32)

        node_names = [
            nd.get("metadata", {}).get("name", "") for nd in self.nodes
        ]
        node_pos = {name: i for i, name in enumerate(node_names)}
        lut = np.asarray(
            [node_pos.get(nm, -1) for nm in self.node_registry] or [-1],
            np.int32,
        )
        nid = c.node_id[:n]
        pod_node = np.where(
            nid >= 0, lut[np.clip(nid, 0, None)], np.int32(-1)
        ).astype(np.int32)

        names = self.kinds["pods"].objects
        pod_names = [
            p.get("metadata", {}).get("name", f"pod-{i}")
            for i, p in enumerate(names)
        ]
        sampled_names = [pod_names[i] for i in np.flatnonzero(sampled)]
        return ColumnarView(
            pod_names=pod_names,
            pod_features=feat,
            pod_service=pod_service,
            memb_pod=memb_pod,
            memb_svc=memb_svc,
            pod_node=pod_node,
            service_names=list(st["names"]),
            selectors=list(st["selectors"]),
            node_names=node_names,
            sampled_names=sampled_names,
        )


class ColumnarClientState:
    """The consumer-side columnar session state a capture loop carries
    across polls: the mirror tables, the feed cursor, and the log-text
    cache (texts refetch only for pods whose rows changed — the same
    refetch-on-journal contract the dict patch path has)."""

    def __init__(self) -> None:
        self.tables: Optional[ColumnarWorld] = None
        self.log_texts: Dict[str, Dict[str, str]] = {}

    @property
    def cursor(self) -> Optional[str]:
        if self.tables is None or self.tables.cursor is None:
            return None
        return str(self.tables.cursor)

    def apply(self, namespace: str, payload: Dict[str, Any]
              ) -> Tuple[bool, Set[str], Set[str]]:
        if self.tables is None:
            self.tables = ColumnarWorld(namespace)
        full, changed, removed = self.tables.apply_payload(payload)
        if full:
            self.log_texts.clear()
        else:
            for name in changed:
                self.log_texts.pop(name, None)
            for name in removed:
                self.log_texts.pop(name, None)
        return full, changed, removed
