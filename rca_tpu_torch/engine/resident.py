"""Device-resident analyze sessions: repeat requests over a known graph
upload only their changed rows.

Counterpart of the JAX package's ``engine/resident.py``.  A
:class:`ResidentSession` per graph digest keeps the padded edges, the
kernel plan's layouts and the ``[n_pad, C]`` feature matrix on the engine's
device for as long as the graph stays hot:

- the first request (or one whose delta is no cheaper than the matrix,
  ``2 * changed >= n_pad``) stages the full padded buffer;
- an identical request uploads nothing;
- a delta request uploads the changed rows only, padded to a power of two
  with the pad slots aimed at the dummy row carrying zero rows, and
  writes them into the buffer with one ``index_copy_`` on the current
  stream, in place, before the ranked propagation;
- every fetch moves only top-k-sized results (the ``[4, kk]`` gather, the
  top-k pair with the indices cast to int32 on the device, the bad-row
  count), so the byte accounting counts what the reference's counts.

The buffer keeps the RAW request rows, NaN included: the front's sanitize
feeds the propagation without persisting (unlike the streaming flush), so
every request computes from exactly what full staging would upload, and
results are bitwise equal to :meth:`GraphEngine.analyze_arrays` with the
cache off.  A NaN row never equals its mirror, so it re-uploads raw on
every request.  A request that raises drops the mirror, so the next one
restages.  A :class:`ResidentCache` LRU (``RCA_RESIDENT_CACHE``)
bounds the pinned device memory; ``RCA_RESIDENT=0`` restages every call.
"""

from __future__ import annotations

import collections
import hashlib
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from rca_tpu_torch.config import bucket_for, resident_cache_cap
from rca_tpu_torch.engine.fetch import HostCopy
from rca_tpu_torch.util.threads import make_lock

GraphDigest = Tuple[int, int, int, str]


def graph_digest(n: int, num_features: int, dep_src: np.ndarray,
                 dep_dst: np.ndarray) -> GraphDigest:
    """Identity of the graph an analyze call runs over: ``(n_services,
    n_channels, n_edges, edge-digest)``, the sha1 over the int32 edge
    bytes, as the reference's."""
    digest = hashlib.sha1(
        np.asarray(dep_src, np.int32).tobytes() + b"|"
        + np.asarray(dep_dst, np.int32).tobytes()
    ).hexdigest()[:16]
    return (int(n), int(num_features), int(len(dep_src)), digest)


def pow2_pad(u: int) -> int:
    """The delta width a count of ``u`` changed rows pads to (1 for 0)."""
    return 1 << max(0, (u - 1).bit_length()) if u else 1


class ResidentSession:
    """One graph's device-resident analyze state.  Not thread-safe on its
    own: :class:`ResidentCache` serializes whole requests.

    The request contract (the mirror diff, the restage rule, the padded
    delta, dropping the mirror on a raise, the byte accounting) lives here
    once; a subclass places the graph and the rows on its devices through
    :meth:`_stage_graph`, :meth:`_request_rows`, :meth:`_upload_full`,
    :meth:`_scatter_rows` and :meth:`_launch` (the sharded engine's
    :class:`rca_tpu_torch.parallel.sharded.ShardedResidentSession`)."""

    #: the results' ``engine`` tag
    engine_tag = "single"

    def __init__(self, engine, key: GraphDigest, dep_src: np.ndarray,
                 dep_dst: np.ndarray):
        self.engine = engine
        self.key = key
        n, num_features, n_edges, _ = key
        self._n = n
        self._num_features = num_features
        self._n_edges = n_edges
        # raw edges retained for the plan and the lazy attribution context
        self._src_raw = np.asarray(dep_src, np.int32)
        self._dst_raw = np.asarray(dep_dst, np.int32)
        # raw host mirror of the buffer's live rows (the diff base); None
        # until the first request stages the buffer
        self._mirror: Optional[np.ndarray] = None
        self.requests = 0
        self.delta_requests = 0      # served by the delta or no upload
        self.last_upload_rows = 0    # padded rows the last request staged
        self.upload_bytes = 0        # cumulative host->device request bytes
        self.fetch_bytes = 0         # cumulative device->host result bytes
        self._stage_graph()

    # -- the device placement (what a subclass overrides) -------------------

    def _stage_graph(self) -> None:
        """Pin the padded edges and the per-shape plan on the device."""
        from rca_tpu_torch.engine.runner import upload

        cfg = self.engine.config
        self._n_pad = bucket_for(self._n + 1, cfg.shape_buckets)
        self._e_pad = bucket_for(max(self._n_edges, 1), cfg.shape_buckets)
        d = np.full(self._e_pad, self._n_pad - 1, np.int64)
        d[: self._n_edges] = self._dst_raw
        self._dep_dst = upload(d, self.engine.device)
        # the per-shape plan: the same dispatch seam as every surface;
        # the registry's row is kept beside it, since a declined doubling
        # layout makes the plan's row differ from the elected one
        self._row = self._elected_row()
        self._plan = self.engine.plan_for(self._n_pad, self._e_pad,
                                          self._src_raw, self._dst_raw)
        self._features: Optional[torch.Tensor] = None   # [n_pad, C]

    def _elected_row(self) -> str:
        from rca_tpu_torch.engine.registry import engaged_kernel

        return engaged_kernel(self._n_pad, self._e_pad,
                              steps=self.engine.params.steps,
                              device=self.engine.device)

    def _current_plan(self):
        """The session's plan, re-made when the registry now engages
        another row for its shape (an ``RCA_KERNEL`` flip) or the edge
        layout changed (``RCA_EDGE_LAYOUT``), so a request always runs what
        a restaged one would."""
        from rca_tpu_torch.engine.runner import plan_layout

        row = self._elected_row()
        if row != self._row or self._plan.layout != plan_layout():
            self._row = row
            self._plan = self.engine.plan_for(self._n_pad, self._e_pad,
                                              self._src_raw, self._dst_raw)
        return self._plan

    def _request_rows(self, features):
        """The rows the buffer takes and the host's bad-row count: here
        the RAW rows and None (the front sanitizes and counts on the
        device)."""
        return features, None

    def _upload_full(self, f: np.ndarray) -> None:
        from rca_tpu_torch.engine.runner import upload

        self._features = upload(f, self.engine.device)

    def _scatter_rows(self, idx_h: np.ndarray, rows_h: np.ndarray) -> None:
        from rca_tpu_torch.engine.runner import upload

        dev = self.engine.device
        self._features.index_copy_(0, upload(idx_h, dev).long(),
                                   upload(rows_h, dev))

    def _launch(self, kk: int, n_bad):
        """Enqueue the ranked propagation over the buffer: ``(stacked,
        diag, vals, idx, n_bad)``, the count on the device."""
        from rca_tpu_torch.engine.runner import propagate_ranked

        return propagate_ranked(self.engine.model, self._features,
                                self._dep_dst, self._n, kk,
                                self._current_plan())

    # -- the request contract ------------------------------------------------

    def _fetch_topk(self, diag, vals, idx, n_bad):
        """The session's one sync point: the ``[4, kk]`` gather, the top-k
        pair (indices as int32, cast on the device) and the bad-row count
        when the device counted it (a host count is not fetched)."""
        on_device = torch.is_tensor(n_bad)
        fetched = HostCopy(diag, vals, idx.to(torch.int32),
                           *((n_bad,) if on_device else ())).numpy()
        self.fetch_bytes += sum(a.nbytes for a in fetched)
        diag, vals, idx = fetched[:3]
        return diag, vals, idx, int(fetched[3] if on_device else n_bad)

    def analyze(self, features: np.ndarray, names, k: int):
        from rca_tpu_torch.engine.runner import render_result

        t0 = time.perf_counter()
        kk = min(k + 8, self._n_pad)
        features = np.asarray(features, np.float32)
        changed = (
            None if self._mirror is None
            else np.flatnonzero(np.any(features != self._mirror, axis=1))
        )
        try:
            stacked, diag, vals, idx, n_bad = self._stage_and_propagate(
                features, changed, kk)
            diag, vals, idx, n_bad = self._fetch_topk(diag, vals, idx, n_bad)
        except BaseException:
            # a raise after the scatter (a launch error lands at the
            # fetch) leaves the buffer ahead of the mirror: drop the
            # mirror, so the next request restages
            self._mirror = None
            raise
        self.requests += 1
        latency_ms = (time.perf_counter() - t0) * 1e3
        return render_result(
            diag, vals, idx, names, self._n, k, latency_ms, self._n_edges,
            engine=self.engine_tag, sanitized_rows=n_bad,
            stacked_dev=stacked,
            attribution_ctx=self.engine._attribution_ctx(
                features, self._src_raw, self._dst_raw, names),
            plan=self._plan,
        )

    def _stage_and_propagate(self, features, changed, kk):
        """Stage the request (the full matrix, nothing, or the padded
        delta rows, pad slots on the dummy row with zero rows, scattered
        in place into the buffer) and launch the ranked propagation; the
        mirror follows the buffer."""
        rows, n_bad = self._request_rows(features)
        if changed is None or 2 * len(changed) >= self._n_pad:
            # first request, or a delta no cheaper than the matrix
            f = np.zeros((self._n_pad, self._num_features), np.float32)
            f[: self._n] = rows
            self._upload_full(f)
            self._mirror = features.copy()
            self.last_upload_rows = self._n_pad
            self.upload_bytes += f.nbytes
        elif len(changed) == 0:
            self.delta_requests += 1
            self.last_upload_rows = 0
        else:
            u = len(changed)
            u_pad = pow2_pad(u)
            idx_h = np.full(u_pad, self._n_pad - 1, np.int32)
            rows_h = np.zeros((u_pad, self._num_features), np.float32)
            idx_h[:u] = changed
            rows_h[:u] = rows[changed]
            self._scatter_rows(idx_h, rows_h)
            self._mirror[changed] = features[changed]
            self.delta_requests += 1
            self.last_upload_rows = u_pad
            self.upload_bytes += idx_h.nbytes + rows_h.nbytes
        return self._launch(kk, n_bad)


class ResidentCache:
    """LRU of :class:`ResidentSession` per graph digest.  The lock
    serializes whole analyze calls: one session's in-place buffer update
    must not interleave with another thread's request over it."""

    def __init__(self, engine, cap: Optional[int] = None,
                 session_factory=None):
        self._engine = engine
        # the session kind per graph: ResidentSession, or the sharded
        # engine's ShardedResidentSession
        self._factory = session_factory or ResidentSession
        self._cap = int(cap) if cap is not None else resident_cache_cap()
        self._sessions: "collections.OrderedDict[GraphDigest, ResidentSession]" = (
            collections.OrderedDict()
        )
        self._lock = make_lock("ResidentCache._lock")
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def analyze(self, features: np.ndarray, dep_src: np.ndarray,
                dep_dst: np.ndarray, names: Optional[Sequence[str]], k: int):
        key = graph_digest(features.shape[0], features.shape[1], dep_src,
                           dep_dst)
        with self._lock:
            sess = self._sessions.get(key)
            if sess is not None:
                self._sessions.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
                sess = self._factory(self._engine, key, dep_src, dep_dst)
                self._sessions[key] = sess
                while len(self._sessions) > self._cap:
                    self._sessions.popitem(last=False)
                    self.evictions += 1
            return sess.analyze(features, names, k)

    def stats(self) -> dict:
        with self._lock:
            sessions = list(self._sessions.values())
            return {
                "sessions": len(sessions),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "requests": sum(s.requests for s in sessions),
                "delta_requests": sum(s.delta_requests for s in sessions),
                "upload_bytes": sum(s.upload_bytes for s in sessions),
                "fetch_bytes": sum(s.fetch_bytes for s in sessions),
            }
