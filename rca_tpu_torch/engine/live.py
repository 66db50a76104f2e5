"""Live streaming: cluster changes → feature deltas → one device tick.

Counterpart of the JAX package's ``engine/live.py``.
:class:`LiveStreamingSession` feeds a :class:`.streaming.StreamingSession`
from a cluster client, with two capture strategies, chosen
automatically:

- **watch-driven** (the client serves ``watch_changes``): a poll drains
  the change feed.  A QUIET poll (no changes) costs one feed drain and
  one device tick, no capture; a busy poll re-fetches only the changed
  objects, patches the previous snapshot and re-derives only the changed
  rows (:class:`rca_tpu_torch.features.extract.IncrementalExtractor`).  A
  change to a topology-shaping kind, or an expired feed, forces a resync
  or the expiry recovery;
- **sweep** (no feed): every poll re-lists the namespace, re-extracts
  features and uploads the rows that changed.

Every ``topology_check_every``-th poll does a full sweep and an edge
compare (trace-derived dependency drift is invisible to the feed); a
changed graph is a new streaming session (``resyncs``).

``pipeline_depth`` (``RCA_PIPELINE_DEPTH``, default 1) threads the tick
pipeline through :meth:`LiveStreamingSession.poll`: at depth N >= 2 each
poll dispatches this capture's tick and fetches the one issued N-1 polls
ago, so the device round trip hides behind the next capture; rankings
are the serial sequence delivered N-1 polls late.

The engine follows the analyze boundary (:func:`make_engine`: sharded
when ``RCA_SHARD`` asks for it or more than one CUDA device is visible), and
a sharded engine gets the sharded streaming session
(:func:`.streaming.make_streaming_session`).

A failing capture, patch or tick returns the last known ranking with
``degraded: True`` and a per-tick health record.  Repeated device failure
walks the degradation ladder: ``single-device`` rebuilds the session on a
fresh :class:`GraphEngine` on the same device (the first shard's device
for a sharded engine; the same kernels), and
``interpret`` (the reference's op-by-op run) runs every later tick on the
plain ``torch`` row, on the CPU only.  On the CUDA card the kernels have
no plain stand-in: where the ladder would step to ``interpret``,
``poll()`` raises :class:`KernelPathFailed` instead.  A rung is never
silent: the tick says ``degraded``, the fault is recorded and the health
record names the rung.

Columnar capture (``RCA_COLUMNAR``, default on, or ``use_columnar``):
when the client serves ``get_columnar`` (the mock world, and the live
client through :class:`rca_tpu_torch.cluster.live_columnar.LiveColumnarFeed`),
every capture — sweep, resync, busy poll — goes through the table mirror
(row writes and a vectorized assembly) instead of the per-object dict
scans; quiet polls still skip capture entirely.  A degenerate world
(duplicate object names) falls back to the dict sweep for good.  Above
the healthy-pod log sample the two paths sample other pods' logs, so a
busy poll may count other ``changed_rows`` on each (the rankings agree).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np

from rca_tpu_torch.cluster.snapshot import ClusterSnapshot
from rca_tpu_torch.config import (
    columnar_enabled,
    compile_cache_status,
    pipeline_depth_from_env,
)
from rca_tpu_torch.engine.runner import GraphEngine
from rca_tpu_torch.engine.sharded_runner import make_engine
from rca_tpu_torch.engine.streaming import make_streaming_session
from rca_tpu_torch.features.extract import IncrementalExtractor
from rca_tpu_torch.graph.build import service_dependency_edges
from rca_tpu_torch.resilience.policy import (
    drain_faults,
    record_fault,
    retry_counter,
    suppressed,
)

# degradation ladder rungs: repeated device-dispatch failure walks the
# session down one rung at a time instead of crashing poll()
DEGRADATION_LADDER = ("full", "single-device", "interpret")
# consecutive tick failures before stepping down a rung
_TICK_FAILURES_TO_DEGRADE = 2


class KernelPathFailed(RuntimeError):
    """The card's ticks kept failing on a fresh engine too: the next rung,
    ``interpret``, would run the kernels' plain versions on the card."""


def _on_card(engine) -> bool:
    return engine.device.type == "cuda"

# change kinds that shape the dependency graph: cheaper to rebuild the
# session than to prove a patch preserves the edges
_TOPOLOGY_KINDS = frozenset({
    "service", "deployment", "statefulset", "daemonset", "cronjob",
    "endpoints", "ingress", "networkpolicy", "configmap", "secret",
    "pvc", "resourcequota", "hpa", "node",
})


class LiveStreamingSession:
    """Change-driven streaming analysis over a live (or mock) cluster."""

    def __init__(
        self,
        client,
        namespace: str,
        k: int = 5,
        engine: Optional[GraphEngine] = None,
        topology_check_every: int = 5,
        use_watch: bool = True,
        pipeline_depth: Optional[int] = None,
        recorder=None,
        clock=None,
        use_columnar: Optional[bool] = None,
        tracer=None,
        explain: Optional[bool] = None,
    ):
        """``topology_check_every``: a full sweep and edge compare on every
        Nth poll.  ``use_watch=False`` forces the sweep strategy.
        ``pipeline_depth`` (default ``RCA_PIPELINE_DEPTH``, else 1): 1 runs
        each poll serially; N >= 2 keeps N-1 ticks in flight (the first
        N-1 polls are pipeline-fill ticks carrying the last known
        ranking).  ``engine`` defaults to :func:`make_engine` on the CUDA
        devices.  ``recorder`` (a
        :class:`rca_tpu_torch.replay.recorder.Recorder`) flight-records the
        session: the client is wrapped before the bootstrap capture, so
        every call it answers lands in the log, and each poll seals a tick
        frame with the delivered ranking.  ``clock`` is the injectable
        monotonic timer.
        ``use_columnar`` (default ``RCA_COLUMNAR``) captures through the
        client's columnar feed where it serves one.  ``explain`` (default
        ``RCA_EXPLAIN``) attributes every delivered ranking."""
        self.namespace = namespace
        self.k = k
        self._clock = clock or time.perf_counter
        # one trace per session, one root span per tick with its
        # capture/dispatch/fetch children, embedded in the health record
        from rca_tpu_torch.config import explain_enabled
        from rca_tpu_torch.observability.kernelscope import (
            DeviceMemoryAccountant,
            RecompileMonitor,
        )
        from rca_tpu_torch.observability.spans import default_tracer

        self.tracer = tracer if tracer is not None else default_tracer()
        self._trace_ctx = self.tracer.new_context()
        self.recompile_monitor = RecompileMonitor().start()
        self.memory_accountant = DeviceMemoryAccountant()
        self._warm_marked = False
        self.pipeline_depth = (
            pipeline_depth_from_env() if pipeline_depth is None
            else max(1, int(pipeline_depth))
        )
        self._explain = (
            explain_enabled() if explain is None else bool(explain)
        )
        self._use_columnar = (
            columnar_enabled() if use_columnar is None else bool(use_columnar)
        )
        self.recorder = recorder
        if recorder is not None:
            # wrap BEFORE the bootstrap capture: the recording replays the
            # session from its construction
            recorder.begin_session({
                "namespace": namespace, "k": int(k),
                "topology_check_every": int(max(1, topology_check_every)),
                "use_watch": bool(use_watch),
                "pipeline_depth": self.pipeline_depth,
                "use_columnar": self._use_columnar,
                "explain": self._explain,
            })
            client = recorder.wrap_client(client)
        self.client = client
        self._inflight: "collections.deque" = collections.deque()
        self.pipeline_flushed = 0  # in-flight ticks dropped by degradation
        self._extractor = IncrementalExtractor()
        # columnar capture: the state carries the table mirror, its cursor
        # and the log-text cache across polls
        self._colstate = None
        # the compile cache (the kernel build directory) at session start;
        # the first post-tick health record adds what this session built
        self._compile_cache = compile_cache_status()
        self.engine = engine if engine is not None else make_engine()
        if recorder is not None:
            # forensics, and replay's default engine kind
            recorder.begin_session({"engine": type(self.engine).__name__,
                                    "device": str(self.engine.device)})
        self.topology_check_every = max(1, int(topology_check_every))
        self._polls = 0
        self.resyncs = -1  # first _resync is initialization, not a resync
        self.resyncs_expired = 0
        self.resyncs_topology = 0
        self.degradation = 0
        self._tick_failures = 0
        self._retries_mark = retry_counter()
        self._last_ranked: List[dict] = []
        self._cursor: Optional[str] = None
        # set when a poll drained the feed but failed to apply the
        # changes: the next poll recovers them with a full resync
        self._pending_resync = False
        # set by expiry recovery: the next poll runs the topology check
        self._force_topology_check = False
        self._watch = bool(use_watch)
        self._resync()

    # -- capture (columnar fast path) ---------------------------------------
    def _columnar_active(self) -> bool:
        return self._use_columnar and callable(
            getattr(self.client, "get_columnar", None)
        )

    def _capture_full(self, traces_from=None) -> ClusterSnapshot:
        """One namespace capture through the preferred path: the columnar
        tables when the client serves them, else the dict sweep.  A
        degenerate world (columnar unsupported) falls back permanently —
        capture() already returned the dict-path snapshot in that case."""
        if self._columnar_active():
            if self._colstate is None:
                from rca_tpu_torch.cluster.columnar import ColumnarClientState

                self._colstate = ColumnarClientState()
            snap = ClusterSnapshot.capture(
                self.client, self.namespace,
                columnar_state=self._colstate, traces_from=traces_from,
            )
            if snap.columnar is None:
                self._use_columnar = False
                self._colstate = None
            return snap
        return ClusterSnapshot.capture(
            self.client, self.namespace, columnar=False,
        )

    # -- topology (re)build -------------------------------------------------
    def _new_session(self, src, dst):
        """A streaming session over the retained features on the current
        engine, on the plain ``torch`` row once the ladder reached
        ``interpret`` (on the CPU only)."""
        session = make_streaming_session(
            self._names, src, dst, num_features=self._features.shape[1],
            engine=self.engine, k=self.k, clock=self._clock,
        )
        if self.degradation >= 2:
            session.use_torch_row()
        session.set_all(self._features)
        return session

    def _resync(self, snap=None, fs=None, edges=None,
                cause: str = "topology") -> None:
        """Rebuild from an already-captured snapshot when the caller has
        one, else reopen the feed and capture.  ``cause`` feeds the split
        resync counters (``expired`` / ``topology``)."""
        if snap is None:
            # reopen the change feed BEFORE listing: changes that land
            # during the capture get re-reported next poll
            self._reopen_feed()
            snap = self._capture_full()
        if fs is None:
            # full mode: a resync must not trust the row cache
            fs = self._extractor.extract(snap, incremental=False)
        src, dst = edges if edges is not None else service_dependency_edges(
            snap, fs
        )
        if self._watch and snap.errors:
            # a resync from a PARTIAL capture has not recovered
            self._pending_resync = True
        self._snap = snap if self._watch else None
        self._names = list(fs.service_names)
        self._edge_key = (src.tobytes(), dst.tobytes())
        # raw edges retained so the ladder can rebuild without capturing
        self._edges_raw = (np.asarray(src), np.asarray(dst))
        self._features = np.array(fs.service_features, np.float32)
        self.session = self._new_session(src, dst)
        is_init = self.resyncs < 0
        self.resyncs += 1
        if not is_init:
            if cause == "expired":
                self.resyncs_expired += 1
            else:
                self.resyncs_topology += 1
        self._last_resync_cause = None if is_init else cause

    def _reopen_feed(self) -> None:
        if self._watch:
            # release the superseded cursor first (an abandoned consumer
            # token would pin a shared journal's trim floor)
            if self._cursor is not None:
                close = getattr(self.client, "watch_close", None)
                if close is not None:
                    with suppressed("live.watch_close"):
                        close(self.namespace, self._cursor)
            try:
                probe = self.client.watch_changes(self.namespace, None)
            except (AttributeError, TypeError):
                probe = {"supported": False}
            self._watch = bool(probe.get("supported"))
            self._cursor = probe.get("cursor")

    def _refetch_pod_logs(self, pod: dict, name: str) -> Dict[str, str]:
        """Per-container tail refetch, shared by the busy-poll patch and
        the expiry recovery."""
        per_container: Dict[str, str] = {}
        for c in pod.get("spec", {}).get("containers", []) or []:
            try:
                per_container[c["name"]] = self.client.get_pod_logs(
                    self.namespace, name, container=c["name"],
                    tail_lines=200,
                )
            except Exception:
                per_container[c["name"]] = ""
        return per_container

    def _fetch_traces(self) -> Dict[str, Any]:
        ns = self.namespace
        return {
            "latency": self.client.get_service_latency_stats(ns),
            "error_rates": self.client.get_error_rate_by_service(ns),
            "dependencies": self.client.get_service_dependencies(ns),
            "slow_ops": self.client.find_slow_operations(ns),
        }

    # -- expiry recovery ----------------------------------------------------
    def _recover_from_expiry(self, t0: float) -> Dict[str, Any]:
        """Feed-expiry recovery: re-list the pods once, value-diff against
        the retained snapshot, refetch logs only for the pods that
        changed, refresh the one-call payloads, and force the topology
        check on the next poll (the lost notifications may have been
        topology)."""
        from rca_tpu_torch.cluster.sanitize import sanitize_objects

        snap = self._snap
        self._reopen_feed()
        if not self._watch:
            # the feed is gone for good: the sweep strategy from here on
            return self._poll_sweep()
        can_check_errors = hasattr(self.client, "collect_errors")
        if can_check_errors:
            self.client.collect_errors()  # drain stale errors
        new_pods = sanitize_objects(self.client.get_pods(self.namespace))
        old_by_name = {
            p.get("metadata", {}).get("name"): p for p in snap.pods
        }
        new_by_name = {
            p.get("metadata", {}).get("name"): p for p in new_pods
        }
        changed = [
            n for n, p in new_by_name.items() if old_by_name.get(n) != p
        ]
        removed = [n for n in old_by_name if n not in new_by_name]
        logs = dict(snap.logs)
        for n in removed:
            logs.pop(n, None)
        for n in changed:
            logs[n] = self._refetch_pod_logs(new_by_name[n], n)
        try:
            traces = self._fetch_traces()
        except Exception:
            traces = snap.traces
        events = sanitize_objects(self.client.get_events(self.namespace))
        metrics = self.client.get_pod_metrics(self.namespace) or {}
        if can_check_errors and self.client.collect_errors():
            # a fetch failed: an empty pod list here means an API flake,
            # not mass deletion; keep the state and resync next poll
            self._pending_resync = True
            out = self._finish(t0, changed=0, resynced=False, quiet=False)
            out["recovered"] = False
            return out
        snap2 = dataclasses.replace(
            snap,
            captured_at=self.client.get_current_time(),
            pods=new_pods,
            logs=logs,
            events=events,
            pod_metrics=metrics,
            traces=traces,
            errors=[],
            # a columnar view describes exactly the capture that built
            # it; this grafted snapshot must extract through the dict path
            columnar=None,
        )
        self._force_topology_check = True
        # full mode: the lost notifications are exactly the drift the
        # resourceVersion-keyed row cache cannot see
        fs = self._extractor.extract(snap2, incremental=False)
        if list(fs.service_names) != self._names:
            self._resync(snap=snap2, fs=fs, cause="expired")
            return self._finish(
                t0, changed=len(self._names), resynced=True, quiet=False,
            )
        self._snap = snap2
        n_changed = self._upload_diff(fs)
        out = self._finish(t0, changed=n_changed, resynced=False, quiet=False)
        out["recovered"] = True
        out["drift_pods"] = len(changed) + len(removed)
        return out

    # -- snapshot patching --------------------------------------------------
    def _patch_snapshot(self, changes: List[Dict[str, str]]) -> ClusterSnapshot:
        """Re-fetch only what changed and graft it onto the previous
        snapshot: changed pods (object and logs) by name, the event list
        and pod metrics wholesale when touched.  Topology kinds never
        reach here."""
        from rca_tpu_torch.cluster.sanitize import sanitize_objects

        snap = self._snap
        pod_names = {c["name"] for c in changes if c["kind"] == "pod"}
        log_names = {c["name"] for c in changes if c["kind"] == "logs"}
        events_touched = any(c["kind"] == "event" for c in changes)
        metrics_touched = any(c["kind"] == "pod_metrics" for c in changes)
        traces_touched = any(c["kind"] == "traces" for c in changes)

        patch: Dict[str, Any] = {
            "captured_at": self.client.get_current_time(),
            # patched snapshots extract through the dict path (a columnar
            # view is only valid for the capture that assembled it)
            "columnar": None,
        }
        can_check_errors = hasattr(self.client, "collect_errors")
        if traces_touched:
            with suppressed("live.patch_traces"):
                patch["traces"] = self._fetch_traces()
        if pod_names:
            by_name_old = {
                p.get("metadata", {}).get("name"): p for p in snap.pods
            }
            kept = [
                p for p in snap.pods
                if p.get("metadata", {}).get("name") not in pod_names
            ]
            refetched = []
            for name in sorted(pod_names):
                if can_check_errors:
                    self.client.collect_errors()  # drain stale errors
                pod = self.client.get_pod(self.namespace, name)
                if pod is not None:
                    refetched.append(pod)
                elif can_check_errors and self.client.collect_errors():
                    # None and a recorded fetch error is a transient
                    # failure, not a deletion: keep the stale object
                    old = by_name_old.get(name)
                    if old is not None:
                        refetched.append(old)
            patch["pods"] = kept + sanitize_objects(refetched)
        if pod_names or log_names:
            logs = dict(snap.logs)
            by_name = {
                p.get("metadata", {}).get("name"): p
                for p in patch.get("pods", snap.pods)
            }
            for name in sorted(pod_names | log_names):
                pod = by_name.get(name)
                if pod is None:
                    logs.pop(name, None)
                    continue
                logs[name] = self._refetch_pod_logs(pod, name)
            patch["logs"] = logs
        if events_touched or pod_names:
            patch["events"] = sanitize_objects(
                self.client.get_events(self.namespace)
            )
        if metrics_touched or pod_names:
            patch["pod_metrics"] = (
                self.client.get_pod_metrics(self.namespace) or {}
            )
        return dataclasses.replace(snap, **patch)

    # -- one poll+tick ------------------------------------------------------
    def poll(self) -> Dict[str, Any]:
        """Drain changes (or sweep) → diff → delta upload → tick.

        Returns the tick result plus ``changed_rows``, ``resynced``,
        ``capture_ms``, ``quiet`` (watch path, no changes: no capture ran),
        ``degraded`` and ``health``.  A failing capture, patch or tick
        returns the last known ranking with ``degraded: True``; the next
        poll recovers with a full resync.  Raises :class:`KernelPathFailed`
        on the card when the ticks fail on both of its rungs."""
        self._polls += 1
        t_poll0 = self._clock()
        if self.recorder is not None:
            self.recorder.begin_tick(self._polls)
        try:
            out = self._poll_inner()
            out["degraded"] = bool(out.pop("_tick_degraded", False))
        except KernelPathFailed:
            raise
        except Exception as exc:
            record_fault("live.poll", exc)
            self._pending_resync = True
            out = {
                "ranked": list(self._last_ranked),
                "latency_ms": 0.0, "capture_ms": 0.0,
                "changed_rows": 0, "upload_rows": 0,
                "sanitized_rows": 0, "quiet": False, "resynced": False,
                "resyncs": self.resyncs, "tick": self._polls,
                "degraded": True,
            }
        self._last_ranked = list(out.get("ranked", []))
        if self._explain:
            self._explain_tick(out)
        if not self._warm_marked:
            # warm-up ends after the first completed poll
            self.recompile_monitor.mark_warm()
            self._warm_marked = True
        out["health"] = self._health_record(out)
        self._trace_tick(out, t_poll0)
        if self.recorder is not None:
            self.recorder.end_tick(out, features=self._features)
        return out

    def _explain_tick(self, out: Dict[str, Any]) -> None:
        """Attribute this poll's DELIVERED ranking against the session's
        host mirror; a failing attribution records a fault and stamps the
        error, it never takes poll() down."""
        try:
            from rca_tpu_torch.engine.attribution import compute_attribution
            from rca_tpu_torch.observability.causelens import (
                attribution_digest,
            )

            src, dst = self._edges_raw
            ctx = self.engine._attribution_ctx(self._features, src, dst,
                                               self._names)
            block = compute_attribution(ctx, out.get("ranked") or [])
            out["attribution"] = block
            out["attribution_digest"] = attribution_digest(block)
        except Exception as exc:  # noqa: BLE001 - explain never kills a tick
            record_fault("live.explain", exc)
            out["attribution_digest"] = None
            out["attribution_error"] = f"{type(exc).__name__}: {exc}"

    def _trace_tick(self, out: Dict[str, Any], t0: float) -> None:
        """Record this poll's spans and embed them in the health record:
        a root ``tick`` span and its capture/dispatch/fetch children laid
        end to end from the measured durations."""
        if not self.tracer.enabled:
            return
        t_end = self._clock()
        tick_ctx = self.tracer.new_context(parent=self._trace_ctx)
        root = self.tracer.record(
            "tick", t0, t_end, context=tick_ctx,
            attrs={
                "tick": out.get("tick"),
                "quiet": bool(out.get("quiet", False)),
                "resynced": bool(out.get("resynced", False)),
                "degraded": bool(out.get("degraded", False)),
                "changed_rows": int(out.get("changed_rows", 0) or 0),
                "upload_rows": int(out.get("upload_rows", 0) or 0),
                "kernel_path": getattr(self.session, "kernel_path", None),
            },
        )
        spans = [root.to_dict()]
        t = t0
        for name, key in (("tick.capture", "capture_ms"),
                          ("tick.dispatch", "dispatch_ms"),
                          ("tick.fetch", "fetch_ms")):
            dur_s = float(out.get(key, 0.0) or 0.0) / 1e3
            child = self.tracer.record(
                name, t, t + dur_s, parent=tick_ctx,
                attrs={"ms": round(dur_s * 1e3, 3)},
            )
            t += dur_s
            spans.append(child.to_dict())
        out["health"]["spans"] = spans

    def _health_record(self, out: Dict[str, Any]) -> Dict[str, Any]:
        """Per-tick health: what degraded, why, and the recovery effort."""
        injected: List[Dict[str, str]] = []
        drain = getattr(self.client, "drain_injected", None)
        if drain is not None:
            with suppressed("live.drain_injected"):
                injected = drain()
        retries_now = retry_counter()
        spent = retries_now - self._retries_mark
        self._retries_mark = retries_now
        if (self._compile_cache.get("enabled")
                and "new_entries" not in self._compile_cache
                and getattr(self.session, "ticks", 0) > 0):
            # first post-tick record: how many build-directory entries
            # this session added (0: everything was built already)
            now = compile_cache_status().get("entries", 0)
            self._compile_cache["new_entries"] = (
                now - self._compile_cache.get("entries", 0)
            )
            self._compile_cache["warm"] = (
                self._compile_cache["new_entries"] == 0
            )
        scope = self.recompile_monitor.snapshot()
        kernelscope = {
            "recompiles": scope["recompiles"],
            "recompiles_post_warm": scope["recompiles_post_warm"],
            "compiles": scope["compiles"],
        }
        if scope["recompiled"]:
            kernelscope["recompiled"] = scope["recompiled"]
        mem = self.memory_accountant.maybe_sample(self._polls)
        if mem is not None:
            kernelscope["device_memory"] = mem
        return {
            "sanitized_rows": int(out.get("sanitized_rows", 0)),
            "kernelscope": kernelscope,
            "pipeline_depth": self.pipeline_depth,
            "result_lag": (
                0 if self.pipeline_depth == 1 or out.get("pipeline_fill")
                else self.pipeline_depth - 1
            ),
            "inflight": len(self._inflight),
            "pipeline_flushed": self.pipeline_flushed,
            "pipeline_fill": bool(out.get("pipeline_fill", False)),
            # the engaged registry row of this session's padded shape
            "kernel_path": getattr(self.session, "kernel_path", None),
            "compile_cache": dict(self._compile_cache),
            "resyncs_expired": self.resyncs_expired,
            "resyncs_topology": self.resyncs_topology,
            "resync_cause": (
                self._last_resync_cause if out.get("resynced") else None
            ),
            "retries": int(spent),
            "faults": drain_faults(),
            "injected": injected,
            "degradation": self.degradation,
            "degradation_rung": DEGRADATION_LADDER[self.degradation],
        }

    # -- degradation ladder -------------------------------------------------
    def _degrade(self) -> None:
        """Step one rung down: a fresh GraphEngine on the same device (a
        sharded engine's first shard's), then
        (on the CPU) the plain ``torch`` row; on the card the second step
        raises :class:`KernelPathFailed`.  The ladder is sticky for the
        session's life (a resync keeps the rung).  In-flight handles were
        dispatched on the failing engine: they are dropped (counted), and
        the retained feature matrix re-uploads, so no data is lost."""
        if self.degradation >= 1 and _on_card(self.engine):
            raise KernelPathFailed(
                "the card's ticks failed on a fresh engine too; the "
                "interpret rung (plain PyTorch) is not taken on the card"
            )
        self.degradation = min(self.degradation + 1,
                               len(DEGRADATION_LADDER) - 1)
        self._tick_failures = 0
        self.pipeline_flushed += len(self._inflight)
        self._inflight.clear()
        if self.degradation == 1:
            self.engine = GraphEngine(device=self.engine.device)
            self.session = self._new_session(*self._edges_raw)
        else:
            self.session.use_torch_row()

    def _guarded_tick(self) -> Dict[str, Any]:
        """session.tick() under the degradation ladder: a failure records
        the fault, steps the ladder after repeated failure, and retries;
        when every rung fails (on the CPU) the tick serves the last
        ranking."""
        last_exc: Optional[Exception] = None
        for _ in range(len(DEGRADATION_LADDER) + 1):
            try:
                out = self.session.tick()
                self._tick_failures = 0
                if last_exc is not None or self.degradation > 0:
                    out["_tick_degraded"] = True
                return out
            except Exception as exc:
                last_exc = exc
                record_fault(
                    f"live.tick[{DEGRADATION_LADDER[self.degradation]}]", exc
                )
                self._tick_failures += 1
                if self.degradation >= len(DEGRADATION_LADDER) - 1:
                    break
                if self._tick_failures >= _TICK_FAILURES_TO_DEGRADE:
                    self._degrade()
        return {
            "ranked": list(self._last_ranked), "latency_ms": 0.0,
            "tick": self._polls, "upload_rows": 0, "sanitized_rows": 0,
            "_tick_degraded": True,
        }

    # -- pipelined tick (pipeline_depth >= 2) --------------------------------
    def _guarded_dispatch(self):
        """session.dispatch() under the degradation ladder; None only when
        every rung failed (on the CPU)."""
        for _ in range(len(DEGRADATION_LADDER) + 1):
            try:
                handle = self.session.dispatch()
                self._tick_failures = 0
                return handle
            except Exception as exc:
                record_fault(
                    "live.dispatch"
                    f"[{DEGRADATION_LADDER[self.degradation]}]", exc
                )
                self._tick_failures += 1
                if self.degradation >= len(DEGRADATION_LADDER) - 1:
                    break
                if self._tick_failures >= _TICK_FAILURES_TO_DEGRADE:
                    self._degrade()
        return None

    def _guarded_fetch(self, handle) -> Optional[Dict[str, Any]]:
        """Fetch one in-flight tick; a fault surfacing at the fetch (where
        asynchronous launch errors land) counts like a tick failure and
        returns None."""
        try:
            out = handle.session.fetch(handle)
            self._tick_failures = 0
            return out
        except Exception as exc:
            record_fault(
                f"live.fetch[{DEGRADATION_LADDER[self.degradation]}]", exc
            )
            self._tick_failures += 1
            if (self._tick_failures >= _TICK_FAILURES_TO_DEGRADE
                    and self.degradation < len(DEGRADATION_LADDER) - 1):
                self._degrade()
            return None

    def _tick_pipelined(self) -> Dict[str, Any]:
        """Dispatch THIS capture's tick, then return the one issued
        ``pipeline_depth - 1`` polls ago; while the pipeline fills (and
        after a flush) the poll returns the last known ranking with
        ``pipeline_fill``."""
        handle = self._guarded_dispatch()
        degraded = handle is None or self.degradation > 0
        if handle is not None:
            self._inflight.append(handle)
        out: Optional[Dict[str, Any]] = None
        fill = False
        if len(self._inflight) > self.pipeline_depth - 1 or (
            handle is None and self._inflight
        ):
            # queue full, or dispatch is broken: drain what exists
            out = self._guarded_fetch(self._inflight.popleft())
            if out is None:
                degraded = True
        elif handle is not None and not degraded:
            fill = True  # healthy, pipeline still filling
        if out is None:
            out = {
                "ranked": list(self._last_ranked), "latency_ms": 0.0,
                "tick": self._polls,
                "upload_rows": handle.upload_rows if handle else 0,
                "sanitized_rows": 0,
                "dispatch_ms": (
                    round(handle.dispatch_ms, 3) if handle else 0.0
                ),
            }
        if fill:
            out["pipeline_fill"] = True
        if degraded:
            out["_tick_degraded"] = True
        return out

    def _poll_inner(self) -> Dict[str, Any]:
        if not self._watch:
            return self._poll_sweep()
        t0 = self._clock()
        if self._pending_resync:
            self._pending_resync = False
            self._resync(cause="expired")
            return self._finish(
                t0, changed=len(self._names), resynced=True, quiet=False,
            )
        if self._force_topology_check or (
            self._polls % self.topology_check_every == 0
        ):
            # periodic full check: drain the feed first so the cursor
            # stays current, and reopen an expired feed now
            self._force_topology_check = False
            resp = self.client.watch_changes(self.namespace, self._cursor)
            self._cursor = resp.get("cursor")
            if resp.get("expired"):
                self._reopen_feed()
            try:
                return self._poll_sweep(check_edges=True)
            except Exception:
                self._pending_resync = True
                raise
        resp = self.client.watch_changes(self.namespace, self._cursor)
        if not resp.get("supported"):
            self._watch = False
            return self._poll_sweep()
        self._cursor = resp.get("cursor")
        if resp.get("expired"):
            try:
                return self._recover_from_expiry(t0)
            except Exception:
                self._pending_resync = True
                raise
        changes = resp.get("changes", [])
        if not changes:
            return self._finish(t0, changed=0, resynced=False, quiet=True)
        try:
            if any(c["kind"] in _TOPOLOGY_KINDS for c in changes):
                self._resync()
                return self._finish(
                    t0, changed=len(self._names), resynced=True, quiet=False,
                )
            if self._columnar_active():
                # busy-poll columnar capture: the get_columnar diff IS the
                # patch (row writes for exactly the journaled names);
                # trace payloads carry forward unless journaled, the same
                # contract _patch_snapshot has
                traces_touched = any(
                    c["kind"] == "traces" for c in changes
                )
                snap = self._capture_full(
                    traces_from=(
                        None if traces_touched else self._snap.traces
                    ),
                )
            else:
                snap = self._patch_snapshot(changes)
            # every mutation reaching here bumped a resourceVersion, so
            # the incremental extractor re-derives only the changed rows
            # (a columnar snapshot skips the row cache: its rows were
            # assembled at capture)
            fs = self._extractor.extract(snap)
            if list(fs.service_names) != self._names:
                self._resync(snap=snap, fs=fs)
                return self._finish(
                    t0, changed=len(self._names), resynced=True, quiet=False,
                )
            if any(c["kind"] == "traces" for c in changes):
                # trace dependencies shape the pinned edges
                edges = service_dependency_edges(snap, fs)
                if (edges[0].tobytes(), edges[1].tobytes()) != self._edge_key:
                    self._resync(snap=snap, fs=fs, edges=edges)
                    return self._finish(
                        t0, changed=len(self._names), resynced=True,
                        quiet=False,
                    )
        except Exception:
            self._pending_resync = True
            raise
        self._snap = snap
        changed = self._upload_diff(fs)
        return self._finish(t0, changed=changed, resynced=False, quiet=False)

    def _upload_diff(self, fs) -> int:
        new = np.asarray(fs.service_features, np.float32)
        changed = np.flatnonzero(np.any(new != self._features, axis=1))
        if len(changed):
            self.session.update_rows(changed, new[changed])
            self._features[changed] = new[changed]
        return int(len(changed))

    def _finish(self, t0: float, changed: int, resynced: bool,
                quiet: bool) -> Dict[str, Any]:
        capture_ms = (self._clock() - t0) * 1e3
        out = (
            self._tick_pipelined() if self.pipeline_depth > 1
            else self._guarded_tick()
        )
        out.update(
            changed_rows=changed, resynced=resynced, quiet=quiet,
            capture_ms=round(capture_ms, 2), resyncs=self.resyncs,
            # session-lifetime counter (the inner session restarts at 1
            # on every resync)
            tick=self._polls,
        )
        return out

    def _poll_sweep(self, check_edges: bool = False) -> Dict[str, Any]:
        """Full list + extract + diff: the strategy without a change feed,
        and the watch path's periodic topology check.  With columnar
        capture the "full list" is the table mirror: the sweep sees what
        the journal carries plus the trace payloads it refetches, the
        same visibility the watch feed has."""
        t0 = self._clock()
        snap = self._capture_full()
        # full mode: sweeps exist to catch out-of-band drift
        fs = self._extractor.extract(snap, incremental=False)
        resynced = False
        edges = None
        if list(fs.service_names) != self._names:
            resynced = True
        elif check_edges or (
            not self._watch
            and self._polls % self.topology_check_every == 0
        ):
            edges = service_dependency_edges(snap, fs)
            if (edges[0].tobytes(), edges[1].tobytes()) != self._edge_key:
                resynced = True
        if resynced:
            if self._watch:
                # reopen-THEN-capture: _resync with no snapshot orders it
                self._resync()
            else:
                self._resync(snap=snap, fs=fs, edges=edges)
            return self._finish(
                t0, changed=len(self._names), resynced=True, quiet=False,
            )
        if self._watch:
            self._snap = snap
            if snap.errors:
                # a PARTIAL capture standing in for drained notifications
                self._pending_resync = True
        changed = self._upload_diff(fs)
        return self._finish(t0, changed=changed, resynced=False, quiet=False)
