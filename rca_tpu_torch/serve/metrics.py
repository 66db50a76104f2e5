"""Per-tenant serving metrics (the port's copy of
``rca_tpu.serve.metrics``).

One :class:`ServeMetrics` per :class:`rca_tpu_torch.serve.loop.ServeLoop`
or :class:`rca_tpu_torch.serve.pool.ServePool`: counters per tenant
(submitted / answered / shed / rejected / degraded / errors), time-in-queue
samples per tenant (p50/p99 through
:class:`rca_tpu_torch.obslog.profiling.PhaseStats`), submit→completion
duration histograms with the SLO burn count, the queue depth peak, batch
occupancy per device dispatch, the prepared-graph cache and resident
reuse, the pool's per-replica rows, the federation's placement
outcomes and the autoscaler's signals (a windowed queue-time p99, the
SLO-burn total) and action counters.  Everything is thread-safe: the
submit path and the serve workers record concurrently; :meth:`snapshot`
copies under the lock and :meth:`summary` derives off it.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional

from rca_tpu_torch.config import slo_ms
from rca_tpu_torch.observability.export import LatencyHistogram
from rca_tpu_torch.obslog.profiling import PhaseStats
from rca_tpu_torch.util.threads import make_lock

_COUNTER_KEYS = (
    "submitted", "answered", "shed", "rejected", "degraded", "errors",
)

#: recent time-in-queue samples kept for the autoscaler's WINDOWED p99.
#: PhaseStats quantiles are all-time: after one surge the all-time p99
#: never falls again, so a scale-down signal fed by it could never fire;
#: the controller reads this bounded window instead
_RECENT_QUEUE_CAP = 512

_SCALE_EVENTS = (
    "scale_ups", "scale_downs", "holds", "cooldown_skips", "clamps",
    "forced",
)


class ServeMetrics:
    def __init__(self, slo_ms_target: Optional[float] = None) -> None:
        self._lock = make_lock("ServeMetrics._lock")
        # per-tenant SLO telemetry: submit→completion durations in le
        # buckets, and the burn counter (completions slower than
        # RCA_SLO_MS, or terminal failures)
        self.slo_ms_target = (
            float(slo_ms_target) if slo_ms_target is not None else slo_ms()
        )
        self._duration: Dict[str, LatencyHistogram] = {}
        self._slo_breaches: Dict[str, int] = {}
        self._counts: Dict[str, Dict[str, int]] = {}
        self._queue_ms = PhaseStats()      # one phase per tenant
        self._occupancy: List[int] = []
        self._depth_peak = 0
        self.dispatched_requests = 0
        # the dispatcher's prepared-graph cache (hits/misses/evictions)
        # and per-tenant resident reuse: requests that rode the delta
        # path and the feature rows the resident base saved them
        self._graph_cache = {"hit": 0, "miss": 0, "eviction": 0}
        self._resident: Dict[str, Dict[str, int]] = {}
        # per-tenant explain-request counts
        self._explained: Dict[str, int] = {}
        # serve pool: per-replica dispatch counters and occupancy samples,
        # work-steal accounting, the last reported breaker/liveness state
        self._replicas: Dict[int, Dict[str, object]] = {}
        self._replica_occ = PhaseStats()   # one phase per replica id
        # the autoscaler's windowed queue-time signal and its action
        # counters; the federation's routing picks: preferred = a
        # registry/headroom-informed pick, rendezvous = the hash-ring
        # fallback
        self._recent_queue_ms: "collections.deque[float]" = (
            collections.deque(maxlen=_RECENT_QUEUE_CAP)
        )
        self._scale_events: Dict[str, int] = {k: 0 for k in _SCALE_EVENTS}
        self._placement: Dict[str, int] = {"preferred": 0, "rendezvous": 0}

    def _tenant(self, tenant: str) -> Dict[str, int]:
        return self._counts.setdefault(
            tenant, {k: 0 for k in _COUNTER_KEYS}
        )

    # -- recording -----------------------------------------------------------
    def submitted(self, tenant: str, queue_depth: int) -> None:
        with self._lock:
            self._tenant(tenant)["submitted"] += 1
            self._depth_peak = max(self._depth_peak, queue_depth)

    def answered(self, tenant: str, queue_ms: float) -> None:
        with self._lock:
            self._tenant(tenant)["answered"] += 1
            self._queue_ms.record(tenant, queue_ms)
            self._recent_queue_ms.append(float(queue_ms))

    def shed(self, tenant: str) -> None:
        with self._lock:
            self._tenant(tenant)["shed"] += 1

    def rejected(self, tenant: str) -> None:
        with self._lock:
            self._tenant(tenant)["rejected"] += 1

    def degraded(self, tenant: str) -> None:
        with self._lock:
            self._tenant(tenant)["degraded"] += 1

    def errors(self, tenant: str) -> None:
        with self._lock:
            self._tenant(tenant)["errors"] += 1

    def explained(self, tenant: str) -> None:
        """One request served with its causelens attribution."""
        with self._lock:
            self._explained[tenant] = self._explained.get(tenant, 0) + 1

    def request_duration(
        self, tenant: str, seconds: float, ok: bool,
    ) -> None:
        """One terminal completion's submit→completion wall time.  A
        completion burns SLO budget when it was slower than the target
        (``RCA_SLO_MS``) or was not served (``shed``/``error``)."""
        with self._lock:
            hist = self._duration.get(tenant)
            if hist is None:
                hist = self._duration[tenant] = LatencyHistogram()
            hist.record(seconds)
            if not ok or seconds * 1e3 > self.slo_ms_target:
                self._slo_breaches[tenant] = (
                    self._slo_breaches.get(tenant, 0) + 1
                )

    def record_batch(self, size: int) -> None:
        with self._lock:
            self._occupancy.append(int(size))
            self.dispatched_requests += int(size)

    def graph_cache(self, event: str) -> None:
        """One prepared-graph cache event: ``hit``/``miss``/``eviction``."""
        with self._lock:
            self._graph_cache[event] += 1

    def resident_reuse(self, tenant: str, rows_saved: int) -> None:
        """One request served through the resident delta path:
        ``rows_saved`` feature rows came from the device-pinned base
        instead of the host upload."""
        with self._lock:
            rec = self._resident.setdefault(
                tenant, {"delta_requests": 0, "rows_saved": 0}
            )
            rec["delta_requests"] += 1
            rec["rows_saved"] += int(rows_saved)

    # -- serve pool ----------------------------------------------------------
    def _replica(self, replica_id: int) -> Dict[str, object]:
        return self._replicas.setdefault(int(replica_id), {
            "batches": 0, "requests": 0,
            "stolen_from": 0, "stolen_to": 0,
            "state": "closed",
        })

    def replica_batch(self, replica_id: int, width: int) -> None:
        """One device batch fetched OK on a replica."""
        with self._lock:
            rec = self._replica(replica_id)
            rec["batches"] += 1
            rec["requests"] += int(width)

    def replica_occupancy(self, replica_id: int, occupancy: int) -> None:
        """One occupancy sample: staged + in-flight requests the replica
        held (taken per scheduling iteration that did work)."""
        with self._lock:
            self._replica(replica_id)
            self._replica_occ.record(f"r{int(replica_id)}", float(occupancy))

    def stolen(self, from_replica: int, to_replica: int, n: int) -> None:
        """``n`` staged requests moved off a dead/open replica onto a
        survivor by the work-stealing rebalance."""
        with self._lock:
            self._replica(from_replica)["stolen_from"] += int(n)
            self._replica(to_replica)["stolen_to"] += int(n)

    def replica_state(self, replica_id: int, state: str) -> None:
        """Latest breaker/liveness state (``closed``/``open``/
        ``half-open``/``dead``) the replica reported."""
        with self._lock:
            self._replica(replica_id)["state"] = state

    # -- federation and its autoscaler ----------------------------------------
    def scale_event(self, kind: str) -> None:
        """One autoscaler outcome: ``scale_ups``/``scale_downs``/
        ``holds``/``cooldown_skips``/``clamps``/``forced``."""
        with self._lock:
            self._scale_events[kind] += 1

    def placement(self, outcome: str) -> None:
        """One routing pick: ``preferred`` (registry/headroom-informed)
        or ``rendezvous`` (the hash-ring fallback)."""
        with self._lock:
            self._placement[outcome] += 1

    def autoscale_signals(self) -> Dict[str, object]:
        """The controller's metric-side inputs in one lock acquisition:
        the WINDOWED cross-tenant queue-time p99 (the last
        ``_RECENT_QUEUE_CAP`` answers) and the running SLO-breach total
        (the controller differentiates it into a burn between sweeps)."""
        with self._lock:
            recent = sorted(self._recent_queue_ms)
            breaches = sum(self._slo_breaches.values())
        p99 = (
            recent[min(len(recent) - 1, int(len(recent) * 0.99))]
            if recent else None
        )
        return {
            "queue_ms_p99_recent": p99,
            "recent_samples": len(recent),
            "slo_breach_total": breaches,
        }

    # -- reporting -----------------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """One consistent deep copy of all raw state, taken under the
        lock; derivation (quantiles, sorts) happens on the caller's thread
        over data no worker can touch."""
        with self._lock:
            return {
                "counts": {t: dict(c) for t, c in self._counts.items()},
                "queue_ms": self._queue_ms.snapshot(),
                "occupancy": list(self._occupancy),
                "depth_peak": self._depth_peak,
                "dispatched_requests": self.dispatched_requests,
                "graph_cache": dict(self._graph_cache),
                "resident": {
                    t: dict(r) for t, r in self._resident.items()
                },
                "explained": dict(self._explained),
                "replicas": {
                    rid: dict(rec)
                    for rid, rec in self._replicas.items()
                },
                "replica_occ": self._replica_occ.snapshot(),
                "duration": {
                    t: h.to_dict() for t, h in self._duration.items()
                },
                "slo_breaches": dict(self._slo_breaches),
                "slo_ms": self.slo_ms_target,
                "scale_events": dict(self._scale_events),
                "placement": dict(self._placement),
            }

    def summary(self) -> Dict[str, object]:
        snap = self.snapshot()
        counts: Dict[str, Dict[str, int]] = snap["counts"]
        resident: Dict[str, Dict[str, int]] = snap["resident"]
        queue_ms = snap["queue_ms"]
        per_tenant = {}
        # union: a tenant that only ever rode the delta path (direct
        # dispatcher callers) still shows its reuse counters
        for tenant in sorted(set(counts) | set(resident)):
            tcounts = counts.get(tenant, {k: 0 for k in _COUNTER_KEYS})
            treuse = resident.get(
                tenant, {"delta_requests": 0, "rows_saved": 0}
            )
            per_tenant[tenant] = {
                **tcounts,
                "queue_ms_p50": queue_ms.quantile(tenant, 0.50),
                "queue_ms_p99": queue_ms.quantile(tenant, 0.99),
                "resident_delta_requests": treuse["delta_requests"],
                "resident_rows_saved": treuse["rows_saved"],
                "explain_requests": snap["explained"].get(tenant, 0),
            }
        occ = snap["occupancy"]
        occ_sorted = sorted(occ)
        replica_occ = snap["replica_occ"]
        replicas = {
            str(rid): {
                **rec,
                "occupancy_p50": replica_occ.quantile(f"r{rid}", 0.50),
                "occupancy_max": replica_occ.quantile(f"r{rid}", 1.0),
            }
            for rid, rec in sorted(snap["replicas"].items())
        }
        return {
            **({
                "replicas": replicas,
                "steals_total": sum(
                    r["stolen_from"]
                    for r in snap["replicas"].values()
                ),
            } if replicas else {}),
            "tenants": per_tenant,
            "batches": len(occ),
            "dispatched_requests": snap["dispatched_requests"],
            "batch_occupancy_mean": (
                round(sum(occ) / len(occ), 2) if occ else None
            ),
            "batch_occupancy_p50": (
                occ_sorted[len(occ_sorted) // 2] if occ_sorted else None
            ),
            "batch_occupancy_max": max(occ) if occ else None,
            "queue_depth_peak": snap["depth_peak"],
            "graph_cache": snap["graph_cache"],
            "duration": snap["duration"],
            "slo_breaches": snap["slo_breaches"],
            "slo_ms": snap["slo_ms"],
            "shed_total": sum(c["shed"] for c in counts.values()),
            "rejected_total": sum(
                c["rejected"] for c in counts.values()
            ),
            **self._autoscale_summary(snap),
        }

    @staticmethod
    def _autoscale_summary(snap: Dict[str, object]) -> Dict[str, object]:
        """The autoscale and placement blocks, only when the autoscaler
        acted or the federation routed anything: a loop's or a pool's
        summary keeps its keys."""
        events: Dict[str, int] = snap["scale_events"]   # type: ignore
        placement: Dict[str, int] = snap["placement"]   # type: ignore
        picks = sum(placement.values())
        if not any(events.values()) and picks == 0:
            return {}
        return {
            "autoscale": dict(events),
            "placement": {
                **placement,
                "hit_rate": (
                    round(placement["preferred"] / picks, 4)
                    if picks else None
                ),
            },
        }
