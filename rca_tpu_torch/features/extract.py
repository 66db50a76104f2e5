"""Snapshot → packed feature arrays (the engine's host-side front end): the
port's copy of ``rca_tpu.features.extract`` (the dict path, full and
incremental, and the vectorized assembly off a columnar capture).

One pass over the snapshot builds:

- ``pod_features``  float32 [P, NUM_POD_FEATURES]
- ``service_features`` float32 [S, NUM_SERVICE_FEATURES] (segment-aggregated
  from pods + traces + endpoints)
- index maps (pod→service, pod→node) for segment ops on device.

Parse once, aggregate with numpy segment ops, ship dense arrays to the
device.  Regex scanning stays on the host; only its counts go on device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np

from rca_tpu_torch.cluster.labels import SelectorIndex
from rca_tpu_torch.cluster.snapshot import ClusterSnapshot
from rca_tpu_torch.features.logscan import LOG_PATTERN_NAMES, scan_pod_logs
from rca_tpu_torch.features.schema import (
    NUM_POD_FEATURES,
    NUM_SERVICE_FEATURES,
    PodF,
    SvcF,
    derive_silent_channel,
)

_PHASES = {
    "Pending": PodF.PHASE_PENDING,
    "Running": PodF.PHASE_RUNNING,
    "Succeeded": PodF.PHASE_SUCCEEDED,
    "Failed": PodF.PHASE_FAILED,
}


@dataclasses.dataclass
class FeatureSet:
    namespace: str
    pod_names: List[str]
    pod_features: np.ndarray        # [P, NUM_POD_FEATURES] float32
    service_names: List[str]
    service_features: np.ndarray    # [S, NUM_SERVICE_FEATURES] float32
    pod_service: np.ndarray         # [P] int32 primary owner, -1 unmatched
    # full pod↔service membership as COO pairs — one pod can back several
    # services (e.g. a ClusterIP and a headless service sharing a selector)
    memb_pod: np.ndarray            # [M] int32 pod indices
    memb_svc: np.ndarray            # [M] int32 service indices
    node_names: List[str]
    pod_node: np.ndarray            # [P] int32, -1 when unknown
    node_features: np.ndarray       # [N, 2] float32 (cpu_pct, mem_pct)

    def service_members(self, j: int) -> np.ndarray:
        """Pod indices backing service ``j`` (all matches, not just primary)."""
        return self.memb_pod[self.memb_svc == j]

    @property
    def num_pods(self) -> int:
        return len(self.pod_names)

    @property
    def num_services(self) -> int:
        return len(self.service_names)


def _container_status_flags(pod: dict, feat: np.ndarray) -> None:
    statuses = pod.get("status", {}).get("containerStatuses", []) or []
    restarts = 0
    any_not_ready = False
    for cs in statuses:
        restarts += int(cs.get("restartCount", 0) or 0)
        if not cs.get("ready", False):
            any_not_ready = True
        state = cs.get("state") or {}
        waiting = state.get("waiting") or {}
        reason = waiting.get("reason", "")
        if reason:
            if "CrashLoopBackOff" in reason:
                feat[PodF.WAIT_CRASHLOOP] = 1.0
            elif reason in ("ImagePullBackOff", "ErrImagePull", "InvalidImageName"):
                feat[PodF.WAIT_IMAGEPULL] = 1.0
            elif reason in ("CreateContainerConfigError", "CreateContainerError"):
                feat[PodF.WAIT_CONFIG] = 1.0
            else:
                feat[PodF.WAIT_OTHER] = 1.0
        for key in ("state", "lastState"):
            term = (cs.get(key) or {}).get("terminated") or {}
            if term:
                if int(term.get("exitCode", 0) or 0) != 0:
                    feat[PodF.TERM_NONZERO] = 1.0
                if term.get("reason") == "OOMKilled":
                    feat[PodF.TERM_OOM] = 1.0
    for ics in pod.get("status", {}).get("initContainerStatuses", []) or []:
        state = ics.get("state") or {}
        waiting = state.get("waiting") or {}
        term = state.get("terminated") or {}
        if "CrashLoopBackOff" in waiting.get("reason", "") or (
            term and int(term.get("exitCode", 0) or 0) != 0
        ):
            feat[PodF.INIT_FAILED] = 1.0
    feat[PodF.NOT_READY] = 1.0 if any_not_ready else 0.0
    feat[PodF.RESTARTS] = float(restarts)
    feat[PodF.RESTARTS_SAT] = 1.0 - math.exp(-restarts / 5.0)


def _metric_pcts(rec: Optional[dict]) -> tuple:
    if not rec:
        return 0.0, 0.0
    cpu = (rec.get("cpu") or {}).get("usage_percentage")
    mem = (rec.get("memory") or {}).get("usage_percentage")
    return (float(cpu or 0.0) / 100.0, float(mem or 0.0) / 100.0)


def _warn_counts(snapshot: ClusterSnapshot) -> Dict[str, int]:
    """Warning-event counts grouped by involved pod (one pass)."""
    warn_counts: Dict[str, int] = {}
    for ev in snapshot.events:
        if ev.get("type") == "Normal":
            continue
        obj = ev.get("involvedObject", {}) or {}
        if obj.get("kind") == "Pod":
            warn_counts[obj.get("name", "")] = warn_counts.get(
                obj.get("name", ""), 0
            ) + int(ev.get("count", 1) or 1)
    return warn_counts


def _pod_feature_row(
    pod: dict,
    warn_count: int,
    metrics_rec: Optional[dict],
    logs: Optional[Dict[str, str]],
    log_counts=None,
) -> np.ndarray:
    """One pod's feature row, the one definition the full and the
    incremental extraction share.  ``log_counts`` supplies memoized
    regex-scan counts (a pure function of the log text)."""
    feat = np.zeros(NUM_POD_FEATURES, dtype=np.float32)
    status = pod.get("status", {}) or {}
    phase = status.get("phase", "Unknown")
    feat[_PHASES.get(phase, PodF.PHASE_UNKNOWN)] = 1.0
    _container_status_flags(pod, feat)
    cpu, mem = _metric_pcts(metrics_rec)
    feat[PodF.CPU_PCT] = cpu
    feat[PodF.MEM_PCT] = mem
    feat[PodF.WARN_EVENTS] = float(warn_count)
    feat[PodF.WARN_EVENTS_SAT] = min(1.0, warn_count / 10.0)
    if logs is not None:
        counts = log_counts if log_counts is not None else scan_pod_logs(logs)
        feat[PodF.LOG0 : PodF.LOG0 + len(LOG_PATTERN_NAMES)] = counts
        if phase == "Running" and not any(t.strip() for t in logs.values()):
            feat[PodF.NO_LOGS] = 1.0
    return feat


class IncrementalExtractor:
    """Snapshot → FeatureSet with memoization across repeated captures
    (the live session's busy polls re-derive only the changed rows).
    Three caches, each keyed so a stale hit is impossible:

    - **row cache**: pod feature rows keyed by the pod's
      ``metadata.resourceVersion`` plus the row's other inputs (warn-event
      count, cpu/mem percentages, log content key).  Consulted only on
      ``incremental=True`` extractions (the watch patch path, where every
      mutation bumps the resourceVersion); full extractions recompute
      every row and refresh the cache.  Pods without one are recomputed.
    - **log-scan cache**: regex pattern counts keyed by the log text.
    - **selector memo**: pod→service matches keyed by the pod's label set,
      reset whenever any service selector changes.

    :func:`extract_features` runs a fresh instance in full mode, so the
    one-shot path computes every row as before.
    """

    def __init__(self) -> None:
        self._rows: Dict[str, tuple] = {}
        self._log_counts: Dict[tuple, np.ndarray] = {}
        self._hits_memo: Dict[tuple, List[int]] = {}
        self._selector_sig: Optional[tuple] = None

    def extract(self, snapshot: ClusterSnapshot,
                incremental: bool = True) -> FeatureSet:
        if getattr(snapshot, "columnar", None) is not None:
            # columnar capture: the per-pod work was already done as row
            # writes when the world mutated; the view carries the
            # assembled matrix + memberships, so extraction is just the
            # (vectorized) service aggregation, and the row cache is
            # skipped.  Bit-identical to the dict loop below —
            # property-tested in tests/test_torch_columnar.py.
            return _extract_columnar(snapshot)
        pods = snapshot.pods
        P = len(pods)
        pod_names = [
            p.get("metadata", {}).get("name", f"pod-{i}")
            for i, p in enumerate(pods)
        ]
        warn_counts = _warn_counts(snapshot)
        metrics_by_pod = (snapshot.pod_metrics or {}).get("pods", {})

        node_names = [
            n.get("metadata", {}).get("name", "") for n in snapshot.nodes
        ]
        node_index = {n: i for i, n in enumerate(node_names)}
        pod_node = np.full(P, -1, dtype=np.int32)

        # -- pod → service assignment (selector ⊆ labels) ------------------
        service_names = [
            s.get("metadata", {}).get("name", f"svc-{j}")
            for j, s in enumerate(snapshot.services)
        ]
        selectors = [
            (s.get("spec", {}) or {}).get("selector") or {}
            for s in snapshot.services
        ]
        try:
            selector_sig = tuple(
                (service_names[j], tuple(sorted(selectors[j].items())))
                for j in range(len(service_names))
            )
        except TypeError:
            selector_sig = None  # unhashable selector values: no memo
        if selector_sig != self._selector_sig or selector_sig is None:
            self._hits_memo = {}
            self._selector_sig = selector_sig
        # inverted selector index: O(labels) per pod.  Every matching
        # service is recorded (one pod may back several services, e.g.
        # ClusterIP + headless sharing a selector); pod_service keeps the
        # first match as primary owner.
        index = SelectorIndex(selectors)
        hits_memo = self._hits_memo

        pod_features = np.zeros((P, NUM_POD_FEATURES), dtype=np.float32)
        pod_service = np.full(P, -1, dtype=np.int32)
        memb_pod: List[int] = []
        memb_svc: List[int] = []
        new_rows: Dict[str, tuple] = {}
        new_log_counts: Dict[tuple, np.ndarray] = {}

        for i, pod in enumerate(pods):
            name = pod_names[i]
            md = pod.get("metadata", {}) or {}
            wc = warn_counts.get(name, 0)
            rec = metrics_by_pod.get(name)
            logs = snapshot.logs.get(name)
            logs_key: Optional[tuple] = None
            counts = None
            if logs is not None:
                try:
                    logs_key = tuple(sorted(logs.items()))
                except TypeError:
                    logs_key = None
                if logs_key is not None:
                    counts = self._log_counts.get(logs_key)
            rv = md.get("resourceVersion")
            sig = (rv, wc, _metric_pcts(rec), logs_key)
            row = None
            if incremental and rv is not None:
                cached = self._rows.get(name)
                if cached is not None and cached[0] == sig:
                    row = cached[1]
            if row is None:
                if logs is not None and counts is None:
                    counts = scan_pod_logs(logs)
                row = _pod_feature_row(pod, wc, rec, logs, counts)
            if logs_key is not None and counts is not None:
                new_log_counts[logs_key] = counts
            if rv is not None:
                new_rows[name] = (sig, row)
            pod_features[i] = row

            labels = md.get("labels", {}) or {}
            try:
                labels_key: Optional[tuple] = tuple(sorted(labels.items()))
            except TypeError:
                labels_key = None
            hits = (
                hits_memo.get(labels_key) if labels_key is not None else None
            )
            if hits is None:
                hits = index.matches(labels)
                if labels_key is not None:
                    hits_memo[labels_key] = hits
            if hits:
                pod_service[i] = hits[0]
                memb_pod.extend([i] * len(hits))
                memb_svc.extend(hits)

            node = pod.get("spec", {}).get("nodeName")
            if node in node_index:
                pod_node[i] = node_index[node]

        # replace (not merge) the per-name/content caches: entries of
        # deleted pods and superseded log tails drop out here
        self._rows = new_rows
        self._log_counts = new_log_counts

        memb_pod_arr = np.asarray(memb_pod, dtype=np.int32)
        memb_svc_arr = np.asarray(memb_svc, dtype=np.int32)
        return _aggregate_services(
            snapshot, pod_names, pod_features, service_names, selectors,
            pod_service, memb_pod_arr, memb_svc_arr,
            node_names, pod_node,
        )


def extract_features(snapshot: ClusterSnapshot) -> FeatureSet:
    """Snapshot → FeatureSet, every row computed afresh: a fresh
    :class:`IncrementalExtractor` in full mode."""
    return IncrementalExtractor().extract(snapshot, incremental=False)


def _aggregate_services(
    snapshot: ClusterSnapshot,
    pod_names: List[str],
    pod_features: np.ndarray,
    service_names: List[str],
    selectors: List[dict],
    pod_service: np.ndarray,
    memb_pod_arr: np.ndarray,
    memb_svc_arr: np.ndarray,
    node_names: List[str],
    pod_node: np.ndarray,
) -> FeatureSet:

    # -- service-level aggregation (numpy segment ops over memberships) ----
    S = len(service_names)
    svc = np.zeros((S, NUM_SERVICE_FEATURES), dtype=np.float32)
    seg = memb_svc_arr
    pf = pod_features[memb_pod_arr]
    pods_per_svc = np.zeros(S, dtype=np.float32)
    np.add.at(pods_per_svc, seg, 1.0)
    denom = np.maximum(pods_per_svc, 1.0)

    def frac(channel: int) -> np.ndarray:
        acc = np.zeros(S, dtype=np.float32)
        np.add.at(acc, seg, pf[:, channel])
        return acc / denom

    def seg_max(channel: int) -> np.ndarray:
        acc = np.zeros(S, dtype=np.float32)
        # NaN from poisoned telemetry propagates into the service row by
        # design (the engine's finite-mask pass zeroes the whole row on
        # device); suppress numpy's warning — this is the intended path
        with np.errstate(invalid="ignore"):
            np.maximum.at(acc, seg, pf[:, channel])
        return acc

    crashy = np.clip(
        pf[:, PodF.WAIT_CRASHLOOP] + pf[:, PodF.PHASE_FAILED] + pf[:, PodF.TERM_NONZERO],
        0.0, 1.0,
    )
    acc = np.zeros(S, dtype=np.float32)
    np.add.at(acc, seg, crashy)
    svc[:, SvcF.CRASH] = acc / denom
    svc[:, SvcF.RESTARTS] = seg_max(PodF.RESTARTS_SAT)
    svc[:, SvcF.EVENTS] = seg_max(PodF.WARN_EVENTS_SAT)
    log_total = pf[:, PodF.LOG0 : PodF.LOG0 + len(LOG_PATTERN_NAMES)].sum(axis=1)
    acc = np.zeros(S, dtype=np.float32)
    np.add.at(acc, seg, log_total)
    svc[:, SvcF.LOG_ERRORS] = np.minimum(1.0, acc / 5.0)
    svc[:, SvcF.NOT_READY] = frac(PodF.NOT_READY)
    svc[:, SvcF.RESOURCE] = np.minimum(
        1.0, np.maximum(seg_max(PodF.CPU_PCT), seg_max(PodF.MEM_PCT))
    )
    svc[:, SvcF.IMAGE] = frac(PodF.WAIT_IMAGEPULL)
    svc[:, SvcF.CONFIG] = frac(PodF.WAIT_CONFIG)
    svc[:, SvcF.PENDING] = frac(PodF.PHASE_PENDING)
    svc[:, SvcF.OOM] = seg_max(PodF.TERM_OOM)

    # -- endpoints: a selector-bearing service with no ready addresses ------
    ep_by_name = {
        e.get("metadata", {}).get("name", ""): e for e in snapshot.endpoints
    }
    for j, name in enumerate(service_names):
        if not selectors[j]:
            continue
        ep = ep_by_name.get(name)
        if ep is not None:
            has_addr = any(
                (sub.get("addresses") or []) for sub in ep.get("subsets", []) or []
            )
            if not has_addr:
                svc[j, SvcF.NOT_READY] = 1.0

    # -- derived absence evidence (after endpoints finalize NOT_READY) -----
    derive_silent_channel(svc)

    # -- traces: error rates + latency degradation -------------------------
    traces = snapshot.traces or {}
    err = traces.get("error_rates") or {}
    for j, name in enumerate(service_names):
        if name in err:
            svc[j, SvcF.ERROR_RATE] = float(err[name])
    lat = traces.get("latency") or {}
    p99s = {
        name: float((lat.get(name) or {}).get("p99", 0.0)) for name in service_names
    }
    nonzero = [v for v in p99s.values() if v > 0]
    if nonzero:
        baseline = float(np.median(nonzero))
        if baseline > 0:
            for j, name in enumerate(service_names):
                v = p99s.get(name, 0.0)
                if v > 0:
                    svc[j, SvcF.LATENCY] = float(
                        np.clip((v / baseline - 1.0) / 4.0, 0.0, 1.0)
                    )

    # -- node features -----------------------------------------------------
    node_feat = np.zeros((len(node_names), 2), dtype=np.float32)
    nm = snapshot.node_metrics or {}
    for i, name in enumerate(node_names):
        rec = nm.get(name) or {}
        node_feat[i, 0] = float((rec.get("cpu") or {}).get("usage_percentage", 0.0)) / 100.0
        node_feat[i, 1] = float((rec.get("memory") or {}).get("usage_percentage", 0.0)) / 100.0

    return FeatureSet(
        namespace=snapshot.namespace,
        pod_names=pod_names,
        pod_features=pod_features,
        service_names=service_names,
        service_features=svc,
        pod_service=pod_service,
        memb_pod=memb_pod_arr,
        memb_svc=memb_svc_arr,
        node_names=node_names,
        pod_node=pod_node,
        node_features=node_feat,
    )


def _extract_columnar(snapshot: ClusterSnapshot) -> FeatureSet:
    """[no-dict-scan] Vectorized extraction off a columnar capture: every
    per-pod quantity (feature rows, selector memberships, node indices)
    was assembled from column slices at capture time
    (:meth:`rca_tpu_torch.cluster.columnar.ColumnarWorld.build_view`);
    only the shared service aggregation — already numpy segment ops —
    runs here."""
    v = snapshot.columnar
    return _aggregate_services(
        snapshot, v.pod_names, v.pod_features, v.service_names,
        v.selectors, v.pod_service, v.memb_pod, v.memb_svc,
        v.node_names, v.pod_node,
    )
