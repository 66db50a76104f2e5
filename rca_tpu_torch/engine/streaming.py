"""Streaming analysis session: repeated ticks over a fixed service graph.

Counterpart of the JAX package's ``engine/streaming.py`` (the dense
session).  A :class:`StreamingSession` pins the padded edges, the kernel
plan's layouts and the ``[n_pad, C]`` feature matrix on the engine's
device for the whole session; between ticks only the changed rows travel
host→device.  A delta tick is one flush: an ``index_copy_`` of the padded
delta rows into the buffer, in place on the current stream, then the
ranked propagation whose front sanitizes the buffer and PERSISTS the
zeroed rows (the ``evidence_front_fused`` kernel's persisting launch on
the card), so a NaN/Inf row reads as "no signal" until a clean row
arrives.  On the ``kernels`` row that is one launch for the front, then
one per recursion where the plan fuses them, else 8 per recursion, with
no separate sanitize pass.  A quiet tick runs the
same ranked propagation over the buffer without writing it.

The tick is split in two host-visible halves so callers can pipeline
ticks: :meth:`StreamingHostState.dispatch` packs the pending deltas,
enqueues the flush and starts the top-k copies into pinned host buffers
of the handle's own, and returns a :class:`TickHandle` without a host
sync; :meth:`StreamingHostState.fetch` waits on the handle's event, the
ONLY sync of the tick path, and renders the ranking.  ``tick()`` is
``fetch(dispatch())``.  Everything runs on one stream, so tick N's reads
of the buffer stay ahead of tick N+1's in-place write.

The buffer holds SANITIZED rows after a delta tick, but RAW rows after
:meth:`StreamingSession.set_all` until the next delta tick, as in the
reference: quiet ticks in that window report ``sanitized_rows`` every
time.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from rca_tpu_torch.config import bucket_for
from rca_tpu_torch.engine.fetch import HostCopy
from rca_tpu_torch.engine.resident import pow2_pad
from rca_tpu_torch.engine.runner import (
    GraphEngine,
    propagate_ranked,
    upload,
)
from rca_tpu_torch.observability.spans import device_annotation


def topology_digest(tag: str, parts) -> str:
    """Stable hex digest over a topology description: ``parts`` is any
    JSON-serializable nested structure (tuples canonicalized to lists,
    dicts by sorted key); the same sha256 digest as the reference's."""
    import hashlib
    import json

    def _canon(x):
        if isinstance(x, (list, tuple)):
            return [_canon(v) for v in x]
        if isinstance(x, dict):
            return {str(k): _canon(v) for k, v in sorted(x.items())}
        return x

    blob = json.dumps([tag, _canon(parts)], sort_keys=True,
                      separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


def flush_propagate_ranked(model, features, idx, rows, dep_dst, n_live: int,
                           kk: int, plan):
    """A delta tick on the device: write ``rows`` at ``idx`` (int64) into
    the ``[n_pad, C]`` buffer ``features`` in place, then the ranked
    propagation, whose front persists the sanitized rows into the buffer.
    Returns ``(vals, idx, n_bad)`` of the top-k, device tensors."""
    features.index_copy_(0, idx, rows)
    _stacked, _diag, vals, top, n_bad = propagate_ranked(
        model, features, dep_dst, n_live, kk, plan, persist=True)
    return vals, top, n_bad


def make_streaming_session(names: Sequence[str], dep_src: np.ndarray,
                           dep_dst: np.ndarray, num_features: int,
                           engine=None, k: int = 5, clock=None):
    """The streaming session for ``engine``: the sharded
    :class:`rca_tpu_torch.parallel.streaming.ShardedStreamingSession` for a
    :class:`ShardedGraphEngine`, else the dense :class:`StreamingSession`."""
    from rca_tpu_torch.engine.sharded_runner import ShardedGraphEngine

    if isinstance(engine, ShardedGraphEngine):
        from rca_tpu_torch.parallel.streaming import ShardedStreamingSession

        return ShardedStreamingSession(names, dep_src, dep_dst,
                                       num_features=num_features,
                                       engine=engine, k=k, clock=clock)
    return StreamingSession(names, dep_src, dep_dst,
                            num_features=num_features, engine=engine, k=k,
                            clock=clock)


@dataclasses.dataclass
class TickHandle:
    """One in-flight tick: the top-k copies its dispatch started (host
    buffers of its own, so a later tick cannot overwrite them) and what
    the fetch needs to render it without the session's CURRENT host
    state.  ``session`` is the session that dispatched it: rankings render
    with its names, so a handle stays fetchable across a resync."""

    session: "StreamingHostState"
    result: HostCopy             # vals [kk], idx [kk] int32, n_bad
    upload_rows: int             # padded rows this tick uploaded
    dispatch_ms: float           # host time to pack + enqueue


class StreamingHostState:
    """Host-side state of a streaming session: the pending deltas, their
    padded packing, the upload-rows accounting and the rendering.  Rows
    are copied on update (callers reuse scratch buffers), deltas are
    cleared only after the dispatch is accepted, and set_all's bulk upload
    is reported by the next tick."""

    # set by subclasses: names, k, _n, _n_pad, _num_features
    def _init_host_state(self, clock=None) -> None:
        self._clock = clock or time.perf_counter
        # pending row updates by service index (last write wins); bulk
        # dirty-row slices stage as (idx, rows) blocks beside them
        self._pending: Dict[int, np.ndarray] = {}
        self._pending_blocks: list = []
        self.ticks = 0
        self.last_upload_rows = 0  # padded rows uploaded by the last flush
        self._bulk_upload = 0      # set by set_all; reported by next tick

    def update(self, service_index: int, features: np.ndarray) -> None:
        """Replace one service's feature row (delta update between ticks)."""
        self._pending[int(service_index)] = np.array(features, np.float32)

    def update_many(self, rows: Dict[int, np.ndarray]) -> None:
        for i, f in rows.items():
            self.update(i, f)

    def update_rows(self, indices: np.ndarray, rows: np.ndarray) -> None:
        """Bulk delta staging: an ``[U]`` index vector and its ``[U, C]``
        row block, the same as ``update_many`` over the pairs (the last
        write per index wins, earlier ``update`` calls included)."""
        idx = np.asarray(indices, np.int64).ravel()
        if idx.size == 0:
            return
        block = np.array(rows, np.float32).reshape(idx.size, -1)
        self._pending_blocks.append((idx, block))
        if self._pending:
            for i in idx.tolist():
                self._pending.pop(int(i), None)

    def _pack_pending(self, drop_index: int):
        """Pending deltas as power-of-two-padded ``(count, u_pad, idx,
        rows)``, host int32 indices with unique entries (the last write
        wins: a scatter with duplicate indices has no defined winner on
        CUDA); pad slots aim at ``drop_index`` with zero rows."""
        blocks = self._pending_blocks
        if blocks:
            all_idx = np.concatenate(
                [b[0] for b in blocks]
                + ([np.fromiter(self._pending, np.int64, len(self._pending))]
                   if self._pending else [])
            )
            all_rows = np.concatenate(
                [b[1] for b in blocks]
                + ([np.stack(list(self._pending.values()))]
                   if self._pending else [])
            )
            rev = all_idx[::-1]
            _uniq, first_in_rev = np.unique(rev, return_index=True)
            keep = np.sort(len(all_idx) - 1 - first_in_rev)
            u = int(len(keep))
            u_pad = pow2_pad(u)
            idx_h = np.full(u_pad, drop_index, np.int32)
            rows_h = np.zeros((u_pad, self._num_features), np.float32)
            idx_h[:u] = all_idx[keep]
            rows_h[:u] = all_rows[keep]
            return u, u_pad, idx_h, rows_h
        u = len(self._pending)
        u_pad = pow2_pad(u)
        idx_h = np.full(u_pad, drop_index, np.int32)
        rows_h = np.zeros((u_pad, self._num_features), np.float32)
        for j, (i, f) in enumerate(self._pending.items()):
            idx_h[j] = i
            rows_h[j] = f
        return u, u_pad, idx_h, rows_h

    def _account_upload(self, uploaded_rows: int) -> int:
        """Drop the applied deltas and fold in any preceding set_all.
        Call only once the dispatch is accepted."""
        self._pending.clear()
        self._pending_blocks.clear()
        total = uploaded_rows + self._bulk_upload
        self._bulk_upload = 0
        self.last_upload_rows = total
        return total

    def _render_tick(self, vals, idx, latency_ms: float,
                     sanitized_rows: int = 0,
                     upload_rows: Optional[int] = None) -> Dict[str, object]:
        ranked: List[dict] = []
        for j, i in enumerate(np.asarray(idx).tolist()):
            if i >= self._n or len(ranked) >= self.k:
                continue
            ranked.append(
                {"component": self.names[i], "score": float(vals[j])}
            )
        self.ticks += 1
        return {"ranked": ranked, "latency_ms": latency_ms,
                "tick": self.ticks,
                "upload_rows": (self.last_upload_rows
                                if upload_rows is None else upload_rows),
                "sanitized_rows": int(sanitized_rows)}

    def dispatch(self) -> TickHandle:
        """Pack the pending deltas and enqueue the tick without a host
        sync; implemented by each session kind."""
        raise NotImplementedError

    def fetch(self, handle: TickHandle) -> Dict[str, object]:
        """Wait for an in-flight tick's top-k and render the ranking: THE
        sync point of the tick path.  ``latency_ms`` is dispatch_ms +
        fetch_ms, the host time the tick cost, not the handle's age."""
        clock = handle.session._clock
        t1 = clock()
        with device_annotation("tick.fetch"):
            vals, idx, n_bad = handle.result.numpy()
        fetch_ms = (clock() - t1) * 1e3
        out = handle.session._render_tick(
            vals, idx, handle.dispatch_ms + fetch_ms, int(n_bad),
            upload_rows=handle.upload_rows,
        )
        out["dispatch_ms"] = round(handle.dispatch_ms, 3)
        out["fetch_ms"] = round(fetch_ms, 3)
        return out

    def tick(self) -> Dict[str, object]:
        """One serial tick: the dispatch immediately fetched."""
        return self.fetch(self.dispatch())


class StreamingSession(StreamingHostState):
    def __init__(self, names: Sequence[str], dep_src: np.ndarray,
                 dep_dst: np.ndarray, num_features: int,
                 engine: Optional[GraphEngine] = None, k: int = 5,
                 clock=None):
        self.engine = engine or GraphEngine()
        self.names = list(names)
        self.k = k
        n = len(self.names)
        cfg = self.engine.config
        dev = self.engine.device
        self._n = n
        self._n_pad = bucket_for(n + 1, cfg.shape_buckets)
        self._num_features = num_features
        e_pad = bucket_for(max(len(dep_src), 1), cfg.shape_buckets)
        d = np.full(e_pad, self._n_pad - 1, np.int64)
        d[: len(dep_dst)] = dep_dst
        self._dep_dst = upload(d, dev)
        self._src_raw = np.asarray(dep_src, np.int32)
        self._dst_raw = np.asarray(dep_dst, np.int32)
        # the engaged row for THIS padded shape and its layouts, from the
        # one dispatch seam; health records carry the row
        self._plan = self.engine.plan_for(self._n_pad, e_pad, dep_src,
                                          dep_dst)
        self._features = torch.zeros((self._n_pad, num_features),
                                     dtype=torch.float32, device=dev)
        self._kk = min(k + 8, self._n_pad)
        self.kernel_path = self._plan.kernel
        self._init_host_state(clock)

    def use_torch_row(self) -> None:
        """Run every later tick on the plain ``torch`` row on the same
        device, over the same buffer: the live session's bottom rung of
        its degradation ladder (the reference's op-by-op run)."""
        from rca_tpu_torch.engine.ell import up_ell_for

        self._plan = self._plan._replace(
            kernel="torch",
            up_ell=up_ell_for(self._n_pad, self._src_raw, self._dst_raw,
                              self.engine.device))
        self.kernel_path = "torch"

    def set_all(self, features: np.ndarray) -> None:
        """Full upload (session start or resync), RAW; the next tick
        reports the padded matrix in ``upload_rows``."""
        f = np.zeros((self._n_pad, self._num_features), np.float32)
        f[: len(features)] = features
        self._features = upload(f, self.engine.device)
        self._pending.clear()
        self._pending_blocks.clear()
        self._bulk_upload = self._n_pad

    def dispatch(self) -> TickHandle:
        """Enqueue one tick (the flush on pending deltas, else the ranked
        propagation over the buffer) and start its top-k copies; returns
        the in-flight handle without a host sync."""
        t0 = self._clock()
        dev = self.engine.device
        with device_annotation("tick.dispatch"):
            if self._pending or self._pending_blocks:
                _, u_pad, idx_h, rows_h = self._pack_pending(self._n_pad - 1)
                vals, idx, n_bad = flush_propagate_ranked(
                    self.engine.model, self._features,
                    upload(idx_h, dev).long(), upload(rows_h, dev),
                    self._dep_dst, self._n, self._kk, self._plan)
                # drop the deltas only once the dispatch is accepted
                upload_rows = self._account_upload(u_pad)
            else:
                upload_rows = self._account_upload(0)
                _stacked, _diag, vals, idx, n_bad = propagate_ranked(
                    self.engine.model, self._features, self._dep_dst,
                    self._n, self._kk, self._plan)
            result = HostCopy(vals, idx.to(torch.int32), n_bad)
        return TickHandle(
            session=self, result=result, upload_rows=upload_rows,
            dispatch_ms=(self._clock() - t0) * 1e3,
        )
