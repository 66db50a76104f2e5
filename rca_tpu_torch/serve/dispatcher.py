"""Batched device dispatch for the serving scheduler (dispatch/fetch split;
the port's copy of ``rca_tpu.serve.dispatcher``).

One :class:`BatchDispatcher` turns a batcher flush — requests sharing one
:func:`rca_tpu_torch.serve.request.graph_key` — into ONE ranked
propagation over ``[b_pad, n_pad, C]`` lanes of that graph, and renders
per-request :class:`rca_tpu_torch.engine.runner.EngineResult` objects at
fetch time.  On the card's ``kernels`` row that is the hypothesis batch's
body (``GraphEngine.analyze_batch``), for the whole batch at any width:
``evidence_front_fused`` once (the front), then the two recursions once
each in the form the plan names (``KernelPlan.steps_form``):
``seg_up_steps`` and ``seg_down_steps`` where both layouts fit one CTA
(``cta``, up to 2047 services), else ``seg_up_steps_grid`` and
``seg_down_steps_grid``, one cooperative launch each over the card
(``grid``).

:meth:`BatchDispatcher.dispatch` packs, pads, uploads through pinned
memory, ENQUEUES the propagation and starts the top-k copies into pinned
host buffers (:class:`rca_tpu_torch.engine.fetch.HostCopy`), and returns
a :class:`BatchHandle` without a host sync.  :meth:`BatchDispatcher.fetch`
waits on the handle's event — THE sync point of the serve path — so the
serve loop dispatches batch N, assembles batch N+1 from the queue, and only
then fetches batch N.  Everything runs on the device's current stream, so
a later dispatch's writes stay behind an earlier one's reads.

Staging is DEVICE-RESIDENT per graph: the prepared-graph cache pins the
padded ``dep_dst`` (int64), the kernel plan's layouts and a resident base
feature buffer; a hot graph's dispatch uploads each lane as its changed
rows against that base (``runner.propagate_ranked_batch_delta``: one
``index_copy_`` of ``[B, U]`` ids and ``[B, U, C]`` rows, pad slots aiming
zero rows at the dummy row, as ``runner.check_batch_delta`` requires)
instead of restaging the full stack; the fetch moves only the ``[B, 4,
kk]`` top-k diagnostic gather, the top-k pair and the sanitized-row count
— the full stack stays on the device behind each result's lazy
diagnostics.  Cache hits / misses / evictions and per-tenant delta reuse
flow into :class:`rca_tpu_torch.serve.metrics.ServeMetrics`.

Parity contract: a request served at any batch width is bit-identical to
the same request analyzed alone, because every width runs the SAME
propagation body over the same padded graph and plan (each lane gets its
own launches' lane, its own median and its own top-k), whether the lanes
were staged full or as deltas (base + changed rows reconstructs the exact
request features).  Batch width is padded to a power of two (pad lanes
are zeros, dropped at render).  The batch runs the solo row: the
reference keeps its Pallas front off its batch path, having no vmapped
form of it; the port's front and seg steps have lane-batched launches.
Sharded engines ride :func:`rca_tpu_torch.parallel.sharded.
stage_batch_ranked` (sanitized on the host, as the sharded engine's own
batch is), with the batch padded to the mesh's dp multiple.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from rca_tpu_torch.config import bucket_for, serve_graph_cache_cap
from rca_tpu_torch.serve.request import GraphKey, K_CAP, ServeRequest
from rca_tpu_torch.util.threads import make_lock


@dataclasses.dataclass
class _PreparedGraph:
    """Per-graph staging state shared by every dispatch over that graph."""

    n: int                        # live services; the propagation's
    #                               n_live (a host int: the port compiles
    #                               nothing per value)
    n_pad: int
    n_edges: int
    kk: int
    kernel: str                   # the registry row this shape engages
    dd: object = None             # [e_pad] int64 padded dep_dst (dense)
    plan: object = None           # runner KernelPlan (dense)
    sharded_graph: object = None  # ShardedGraph (sharded engine)
    # resident base feature buffer: the last full staging's lane-0
    # features, pinned on the device as the delta base.  Only a FINITE
    # base engages the delta path — a NaN row in the base would leak into
    # pad lanes' sanitize count
    base_host: object = None      # np [n_pad, C] raw mirror (diff base)
    base_dev: object = None       # device [n_pad, C]
    base_clean: bool = False


@dataclasses.dataclass
class BatchHandle:
    """One in-flight coalesced batch: what the dispatch left on the device
    and what the fetch needs to render each lane.  ``copy`` holds the
    started top-k copies (diag, vals, idx and, on a dense engine, the
    sanitized-row count); ``stacks`` the lanes' full diagnostic stacks,
    which stay on the device behind each result's lazy diagnostics."""

    requests: List[ServeRequest]
    stacks: List[object]          # per request: [4, n_pad] device stack
    copy: object                  # fetch.HostCopy
    n_bad: Optional[int]          # host count (sharded), else in ``copy``
    n: int                        # real (unpadded) service count
    engine_tag: str
    dispatch_ms: float
    dispatched_at: float          # scheduler-clock stamp at dispatch
    kernel: str = "torch"         # engaged registry row for this shape
    resident_delta: bool = False  # lanes rode the delta path
    plan: object = None           # runner KernelPlan (dense), else None


class BatchDispatcher:
    """Coalesced analyze dispatch over one engine (dense or sharded)."""

    def __init__(
        self,
        engine=None,
        fault_hook: Optional[Callable[[str], None]] = None,
        cache_cap: Optional[int] = None,
        clock: Callable[[], float] = time.perf_counter,
        metrics=None,
    ):
        from rca_tpu_torch.engine.runner import GraphEngine
        from rca_tpu_torch.engine.sharded_runner import ShardedGraphEngine

        self.engine = engine if engine is not None else GraphEngine()
        self._clock = clock
        # chaos surface (tests, `serve --selftest --chaos`): called with
        # "dispatch"/"fetch" before the device work; a raise exercises the
        # serve loop's breaker and degraded-response path
        self.fault_hook = fault_hook
        self._cache_cap = max(
            1,
            int(cache_cap) if cache_cap is not None
            else serve_graph_cache_cap(),
        )
        # the serve loop points this at its ServeMetrics
        self.metrics = metrics
        # the serve pool's router reads the prepared-graph cache (bucket
        # stickiness asks "is this graph resident HERE?") while the owning
        # replica stages into it: one lock covers lookup/insert/evict
        self._graphs_lock = make_lock("BatchDispatcher._graphs_lock")
        self._graphs: "collections.OrderedDict[GraphKey, _PreparedGraph]" = (
            collections.OrderedDict()
        )
        self._sharded = isinstance(self.engine, ShardedGraphEngine)
        self.engine_tag = (
            f"serve+{self.engine.engine_tag}" if self._sharded
            else "serve+single"
        )

    # -- per-graph staging ---------------------------------------------------
    def has_graph(self, key: GraphKey) -> bool:
        """Is this graph's staging state (edges, plan, resident base)
        already pinned here?  The serve pool's router uses this for bucket
        stickiness."""
        with self._graphs_lock:
            return key in self._graphs

    def _prepared(self, req: ServeRequest) -> _PreparedGraph:
        key = req.graph_key
        with self._graphs_lock:
            gs = self._graphs.get(key)
            if gs is not None:
                self._graphs.move_to_end(key)
        if gs is not None:
            if self.metrics is not None:
                self.metrics.graph_cache("hit")
            return gs
        if self.metrics is not None:
            self.metrics.graph_cache("miss")
        n = req.features.shape[0]
        if self._sharded:
            from rca_tpu_torch.parallel.sharded import engaged_row

            graph = self.engine._shard(n, req.dep_src, req.dep_dst)
            gs = _PreparedGraph(
                n=n, n_pad=graph.n_pad, n_edges=len(req.dep_src),
                kk=min(K_CAP + 8, graph.n_pad),
                kernel=engaged_row(graph, self.engine.mesh.flat,
                                   self.engine.params.steps),
                sharded_graph=graph,
            )
        else:
            from rca_tpu_torch.engine.runner import upload

            buckets = self.engine.config.shape_buckets
            n_pad = bucket_for(n + 1, buckets)
            e_pad = bucket_for(max(len(req.dep_src), 1), buckets)
            d = np.full(e_pad, n_pad - 1, np.int64)
            d[: len(req.dep_dst)] = req.dep_dst
            # the row and its layouts from the one dispatch seam
            plan = self.engine.plan_for(n_pad, e_pad, req.dep_src,
                                        req.dep_dst)
            gs = _PreparedGraph(
                n=n, n_pad=n_pad, n_edges=len(req.dep_src),
                kk=min(K_CAP + 8, n_pad), kernel=plan.kernel,
                dd=upload(d, self.engine.device), plan=plan,
            )
        evictions = 0
        with self._graphs_lock:
            self._graphs[key] = gs
            while len(self._graphs) > self._cache_cap:
                self._graphs.popitem(last=False)
                evictions += 1
        if self.metrics is not None:
            for _ in range(evictions):
                self.metrics.graph_cache("eviction")
        return gs

    def _b_pad(self, b: int) -> int:
        """Padded batch width: a power of two; sharded batches also round
        to a dp multiple so the lanes tile the mesh."""
        b_pad = 1 << max(0, (b - 1).bit_length())
        if self._sharded:
            dp = self.engine.dp
            b_pad = -(-b_pad // dp) * dp
        return b_pad

    @staticmethod
    def _stack_lanes(gs: _PreparedGraph, batch: List[ServeRequest],
                     b_pad: int) -> np.ndarray:
        fb = np.zeros(
            (b_pad, gs.n_pad, batch[0].features.shape[1]), np.float32
        )
        for i, req in enumerate(batch):
            fb[i, : gs.n] = req.features
        return fb

    # -- delta staging -------------------------------------------------------
    def _lane_deltas(
        self, gs: _PreparedGraph, batch: List[ServeRequest],
    ) -> Optional[List[np.ndarray]]:
        """Per-lane changed-row sets against the resident base, or None
        when delta staging does not pay: no (finite) base yet, or the
        batch has drifted so far from it that scattering moves no fewer
        bytes than restaging.  NaN rows always diff as changed (NaN !=
        NaN), so poisoned requests upload raw and sanitize on the device —
        bit parity with full staging holds."""
        if gs.base_host is None or not gs.base_clean:
            return None
        base = gs.base_host[: gs.n]
        deltas = [
            np.flatnonzero(np.any(req.features != base, axis=1))
            for req in batch
        ]
        # the delta ships a common padded width per lane: worth it only
        # while the widest lane stays well under the full matrix
        u_max = max((len(d) for d in deltas), default=0)
        if 2 * u_max >= gs.n_pad:
            return None
        return deltas

    # -- the split -----------------------------------------------------------
    def dispatch(
        self, batch: List[ServeRequest], now: Optional[float] = None
    ) -> BatchHandle:
        """Stack, pad, upload and ENQUEUE one coalesced batch, start its
        top-k copies; returns without synchronizing.  All requests must
        share a graph_key (the batcher guarantees it)."""
        from rca_tpu_torch.engine.fetch import HostCopy

        if not batch:
            raise ValueError("empty batch")
        if any(r.graph_key != batch[0].graph_key for r in batch[1:]):
            raise ValueError("batch members must share a graph_key")
        if self.fault_hook is not None:
            self.fault_hook("dispatch")
        t0 = self._clock()
        gs = self._prepared(batch[0])
        b_pad = self._b_pad(len(batch))
        deltas = None
        if self._sharded:
            stacks, diag, vals, idx, n_bad = self._dispatch_sharded(
                gs, batch, b_pad)
        else:
            deltas = self._lane_deltas(gs, batch)
            if deltas is not None:
                out = self._dispatch_delta(gs, batch, b_pad, deltas)
            else:
                out = self._dispatch_full(gs, batch, b_pad)
            stacked, diag, vals, idx, n_bad = out
            stacks = [stacked[b] for b in range(len(batch))]
        copied = [diag, vals, idx.to(torch.int32)]
        if isinstance(n_bad, torch.Tensor):   # the dense front's count
            copied.append(n_bad)
            n_bad = None
        return BatchHandle(
            requests=list(batch), stacks=stacks, copy=HostCopy(*copied),
            n_bad=n_bad, n=gs.n, engine_tag=self.engine_tag,
            dispatch_ms=(self._clock() - t0) * 1e3,
            # direct (loop-less) callers get a self-consistent stamp; the
            # serve loop passes its scheduler clock's ``now``
            dispatched_at=now if now is not None else self._clock(),
            kernel=gs.kernel, resident_delta=deltas is not None,
            plan=gs.plan,
        )

    def _dispatch_full(
        self, gs: _PreparedGraph, batch: List[ServeRequest], b_pad: int,
    ):
        """Full staging: upload the whole ``[b_pad, n_pad, C]`` stack and
        refresh the resident base from lane 0, so the NEXT dispatch over
        this graph can go delta."""
        from rca_tpu_torch.engine.runner import propagate_ranked, upload

        dev = self.engine.device
        fb = self._stack_lanes(gs, batch, b_pad)
        out = propagate_ranked(self.engine.model, upload(fb, dev), gs.dd,
                               gs.n, gs.kk, gs.plan)
        gs.base_host = fb[0].copy()
        gs.base_dev = upload(gs.base_host, dev)
        gs.base_clean = bool(np.isfinite(gs.base_host).all())
        return out

    def _dispatch_delta(
        self,
        gs: _PreparedGraph,
        batch: List[ServeRequest],
        b_pad: int,
        deltas: List[np.ndarray],
    ):
        """Delta staging against the resident base: per lane one ``[U]``
        index block and one ``[U, C]`` row block, written on the device —
        the full feature stack never crosses the host boundary.  Pad slots
        (and whole pad lanes) aim zero rows at the dummy row."""
        from rca_tpu_torch.engine.runner import (
            check_batch_delta,
            propagate_ranked_batch_delta,
            upload,
        )

        C = batch[0].features.shape[1]
        u_max = max((len(d) for d in deltas), default=0)
        u_pad = 1 << max(0, (max(u_max, 1) - 1).bit_length())
        idx_b = np.full((b_pad, u_pad), gs.n_pad - 1, np.int64)
        rows_b = np.zeros((b_pad, u_pad, C), np.float32)
        for i, (req, changed) in enumerate(zip(batch, deltas)):
            u = len(changed)
            idx_b[i, :u] = changed
            rows_b[i, :u] = req.features[changed]
            if self.metrics is not None:
                self.metrics.resident_reuse(req.tenant, gs.n - u)
        idx_b, rows_b = check_batch_delta(idx_b, rows_b, gs.n_pad)
        dev = self.engine.device
        return propagate_ranked_batch_delta(
            self.engine.model, gs.base_dev, upload(idx_b, dev),
            upload(rows_b, dev), gs.dd, gs.n, gs.kk, gs.plan,
        )

    def _dispatch_sharded(
        self, gs: _PreparedGraph, batch: List[ServeRequest], b_pad: int,
    ):
        """The sharded engine's batch: lanes over dp, nodes over sp,
        sanitized on the host (as the sharded engine's own batch is: the
        features are being staged from the host anyway)."""
        from rca_tpu_torch.engine.runner import finite_mask_rows_np
        from rca_tpu_torch.parallel.sharded import (
            ShardedStack,
            stage_batch_ranked,
        )

        fb, n_bad = finite_mask_rows_np(self._stack_lanes(gs, batch, b_pad))
        grid, diag, vals, idx = stage_batch_ranked(
            self.engine.mesh, fb, gs.sharded_graph, self.engine.params,
            gs.kk,
        )
        per = b_pad // self.engine.dp
        stacks = [ShardedStack(grid[b // per])[b % per]
                  for b in range(len(batch))]
        return stacks, diag, vals, idx, int(n_bad)

    def fetch(self, handle: BatchHandle) -> List[object]:
        """Wait for an in-flight batch and render one EngineResult per
        request (lane order = request order; pad lanes dropped).

        THE device-sync point of the serve path — asynchronous launch
        errors also surface here, which is why the serve loop's breaker
        wraps the fetch.  Moves only top-k-sized values: the ``[b_pad, 4,
        kk]`` diagnostic gather, the top-k pair and the sanitized-row
        count."""
        from rca_tpu_torch.engine.runner import (
            finite_mask_rows_np,
            render_result,
        )

        if self.fault_hook is not None:
            self.fault_hook("fetch")
        t1 = self._clock()
        fetched = handle.copy.numpy()
        diag, vals, idx = fetched[:3]
        n_bad = handle.n_bad if handle.n_bad is not None else fetched[3]
        fetch_ms = (self._clock() - t1) * 1e3
        per_req_ms = (handle.dispatch_ms + fetch_ms) / len(handle.requests)
        results = []
        for b, req in enumerate(handle.requests):
            # the attribution runs on what the engine ranked: the sharded
            # engine sanitizes on the host first
            features = (finite_mask_rows_np(req.features)[0]
                        if self._sharded else req.features)
            results.append(render_result(
                diag[b], vals[b], idx[b], req.names, handle.n, req.k,
                per_req_ms, int(len(req.dep_src)),
                engine=handle.engine_tag,
                # batch-wide count, as in analyze_batch: a poisoned row
                # poisons every hypothesis built from the same snapshot
                sanitized_rows=int(n_bad),
                stacked_dev=handle.stacks[b],
                # the request's own copied arrays back the lazy attribution
                attribution_ctx=self.engine._attribution_ctx(
                    features, req.dep_src, req.dep_dst, req.names),
                plan=handle.plan,
            ))
        return results
