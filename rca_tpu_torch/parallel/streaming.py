"""Sharded streaming session: delta ticks over the shards' resident blocks.

Counterpart of the JAX package's ``parallel/streaming.py``.  A
:class:`ShardedStreamingSession` runs the dense session's tick contract
(:class:`rca_tpu_torch.engine.streaming.StreamingHostState`: pending
deltas, ``dispatch`` / ``fetch``, the rendering) on a
:class:`ShardedGraphEngine`'s mesh:

- each shard keeps its own ``[block, C]`` node rows on its device (plus
  one scratch row); no device holds the full matrix;
- a tick's delta rows are sanitized on the host (the reference's
  ``finite_mask_rows_np`` on the delta, so ``sanitized_rows`` matches),
  replicated to every device, and each shard ``index_copy_`` s the rows
  that land in its block (:func:`rca_tpu_torch.parallel.sharded.
  scatter_delta`);
- the propagation is the sharded analyze path's
  (:func:`~rca_tpu_torch.parallel.sharded.propagate_blocks`), so streaming
  and one-shot scores cannot drift; the top-k merges on the device.

``dispatch`` never syncs with the host: the top-k leaves through pinned
``HostCopy`` buffers that ``fetch`` waits on, the one sync of a tick.
The buffers hold sanitized rows (``set_all`` sanitizes on the host too,
and its bad rows are reported by the next tick).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from rca_tpu_torch.engine.fetch import HostCopy
from rca_tpu_torch.engine.runner import finite_mask_rows_np
from rca_tpu_torch.engine.streaming import StreamingHostState, TickHandle
from rca_tpu_torch.observability.spans import device_annotation
from rca_tpu_torch.parallel.sharded import (
    _stage_weights,
    engaged_row,
    merge_topk,
    new_block_buffers,
    propagate_blocks,
    scatter_delta,
    shard_plans,
)


class ShardedStreamingSession(StreamingHostState):
    """Drop-in twin of :class:`rca_tpu_torch.engine.streaming.
    StreamingSession` on a :class:`ShardedGraphEngine`'s mesh."""

    def __init__(self, names: Sequence[str], dep_src: np.ndarray,
                 dep_dst: np.ndarray, num_features: int, engine=None,
                 k: int = 5, clock=None):
        from rca_tpu_torch.engine.sharded_runner import ShardedGraphEngine

        self.engine = engine or ShardedGraphEngine()
        self.names = list(names)
        self.k = k
        n = len(self.names)
        self._n = n
        self._num_features = num_features
        self.mesh = self.engine._exec_mesh
        self._devices = self.mesh.row(0)
        self._graph = self.engine._shard(n, dep_src, dep_dst)
        self._n_pad = self._graph.n_pad
        self._block = self._graph.block
        self._kk = min(k + 8, self._n_pad)
        # the registry's sharded row for this shape, and the staged layouts
        # (built once per pinned edge set)
        self.kernel_path = engaged_row(self._graph, self._devices,
                                       self.engine.params.steps)
        self._plan = shard_plans(self.mesh, self._graph, self.kernel_path)[0]
        self._aw, self._hw = (w[0] for w in _stage_weights(
            self.mesh, self.engine.params))
        self._buffers = new_block_buffers(
            np.zeros((self._n_pad, num_features), np.float32),
            self._devices, self._block)
        self._san_pending = 0
        self._init_host_state(clock)

    def use_torch_row(self) -> None:
        """Run every later tick on the plain ``torch`` row, over the same
        buffers (the ladder's bottom rung, on the CPU)."""
        self.kernel_path = "torch"
        self._plan = shard_plans(self.mesh, self._graph, "torch")[0]

    def blocks(self):
        """The shards' ``[block, C]`` resident rows (views)."""
        return [b[: self._block] for b in self._buffers]

    def set_all(self, features: np.ndarray) -> None:
        """Full upload (session start or resync), sanitized on the host;
        the next tick reports the padded matrix in ``upload_rows`` and the
        bad rows in ``sanitized_rows``."""
        clean, n_bad = finite_mask_rows_np(features)
        self._san_pending += n_bad
        f = np.zeros((self._n_pad, self._num_features), np.float32)
        f[: len(clean)] = clean
        self._buffers = new_block_buffers(f, self._devices, self._block)
        self._pending.clear()
        self._pending_blocks.clear()
        self._bulk_upload = self._n_pad

    def dispatch(self) -> TickHandle:
        """Enqueue one tick (the delta scatter on pending deltas, then the
        sharded propagation and top-k merge) and start its top-k copies;
        returns the in-flight handle without a host sync."""
        t0 = self._clock()
        with device_annotation("tick.dispatch"):
            sanitized = self._san_pending
            u_pad = 0
            if self._pending or self._pending_blocks:
                # pad slots aim at n_pad: outside every block, so every
                # shard writes them to its scratch row
                _, u_pad, idx_h, rows_h = self._pack_pending(self._n_pad)
                rows_h, n_bad = finite_mask_rows_np(rows_h)
                sanitized += n_bad
                scatter_delta(self._buffers, self._devices, self._block,
                              idx_h, rows_h)
            stacks = propagate_blocks(self.blocks(), self._plan, self._n,
                                      self._aw, self._hw,
                                      self.engine.params)
            vals, idx, _ = merge_topk([st[3] for st in stacks], self._kk)
            result = HostCopy(vals, idx.to(torch.int32),
                              torch.tensor(sanitized, dtype=torch.int32))
            # deltas and the pending count drop only once the dispatch is
            # accepted
            self._san_pending = 0
            upload_rows = self._account_upload(u_pad)
        return TickHandle(session=self, result=result,
                          upload_rows=upload_rows,
                          dispatch_ms=(self._clock() - t0) * 1e3)
