"""Flagged segmented scans and the seg-step propagation layouts.

Counterpart of the JAX package's ``engine/segscan.py``.  The propagation's
two recursions are segment reductions over the dependency edges:

- the impact down-step is a SUM per destination over dst-sorted edges;
- the explain-away up-step is a MAX per source over src-sorted edges.

Both run as a flagged inclusive segmented scan of the sorted per-edge
values, reading each segment's total at its last element (``s[ends]``):
float error is bounded by the longest segment, never by the edge array.

On a CUDA tensor :func:`segscan_sum` / :func:`segscan_max` launch the
hand-written kernel in ``csrc/segscan.cu`` (which replaces the TPU kernels
``pallas_segscan`` / ``pallas_segscan_max``; the source note there says what
bounds it); on a CPU tensor they compute :func:`segscan_plain`, the TPU
kernel's own flagged Hillis-Steele recurrence over the flat array.  There
is no fallback between the two.

The layout builders are host-side numpy, byte-for-byte the JAX package's.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple

import numpy as np
import torch

from rca_tpu_torch.kernels import LAUNCHES

_OPS = {"sum": 0, "max": 1}


def segscan_plain(x: torch.Tensor, flags: torch.Tensor, op: str) -> torch.Tensor:
    """Segment-local flagged Hillis-Steele doubling over a flat ``[N]``
    array: ``log2(N)`` shifted passes of ``v = v (+|max) shift(v)*(1-f)``,
    ``f = max(f, shift(f))``.  Every input must be NONNEGATIVE, so a
    boundary-masked contribution ``v*(1-f)`` is the combine's identity."""
    v, f = x, flags
    n = v.shape[0]
    k = 1
    while k < n:
        v_s = torch.cat([v.new_zeros(k), v[:-k]])
        f_s = torch.cat([f.new_zeros(k), f[:-k]])
        masked = v_s * (1.0 - f)
        v = v + masked if op == "sum" else torch.maximum(v, masked)
        f = torch.maximum(f, f_s)
        k *= 2
    return v


def _segscan(x: torch.Tensor, flags: torch.Tensor, op: str) -> torch.Tensor:
    if x.dim() != 1 or tuple(flags.shape) != tuple(x.shape):
        raise ValueError(f"segscan takes two equal flat arrays, got "
                         f"{tuple(x.shape)} and {tuple(flags.shape)}")
    if x.dtype != torch.float32 or flags.dtype != torch.float32:
        raise TypeError(f"segscan takes float32, got {x.dtype}/{flags.dtype}")
    if flags.device != x.device:
        raise ValueError(f"flags on {flags.device}, values on {x.device}")
    if x.device.type == "cpu":
        return segscan_plain(x, flags, op)
    if x.device.type != "cuda":
        raise ValueError(f"no segscan kernel for device {x.device}")
    from rca_tpu_torch.kernels.build import check, library

    lib = library()
    x = x.contiguous()
    flags = flags.contiguous()
    n = x.shape[0]
    out = torch.empty_like(x)
    if n == 0:
        return out
    n_blocks = -(-n // lib.rca_segscan_block_size())
    agg_v = torch.empty(n_blocks, dtype=torch.float32, device=x.device)
    agg_i = torch.empty(2 * n_blocks, dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.rca_segscan(
        x.data_ptr(), flags.data_ptr(), out.data_ptr(), agg_v.data_ptr(),
        agg_i.data_ptr(), n, _OPS[op], stream,
    )
    check(err, f"segscan_{op}")
    LAUNCHES[f"segscan_{op}"] += 1
    return out


def segscan_sum(x: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """Flagged inclusive segmented SUM of a flat nonnegative ``[N]``."""
    return _segscan(x, flags, "sum")


def segscan_max(x: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """Flagged inclusive segmented MAX of a flat nonnegative ``[N]``."""
    return _segscan(x, flags, "max")


class SegLayout(NamedTuple):
    """One scan direction over a padded graph: edges sorted by their
    SEGMENT index (dst for the down-scan, src for the up-scan), the OTHER
    endpoint per sorted edge, segment-start flags, each segment's last
    edge position, and a has-edges mask (segments with no edges keep their
    reduction identity).  numpy on the host; :meth:`to` moves it."""

    other_sorted: np.ndarray   # int32 [e_pad] — other endpoint, seg-sorted
    flags: np.ndarray          # float32 [e_pad], 1 = first edge of its run
    ends: np.ndarray           # int32 [n_pad] — last edge pos per segment
    has_edges: np.ndarray      # float32 [n_pad]

    def to(self, device) -> "SegLayout":
        """The layout as tensors on ``device`` (indices as int64, widened
        by numpy: torch's own CPU cast spreads over its thread pool)."""
        return SegLayout(
            other_sorted=torch.from_numpy(
                self.other_sorted.astype(np.int64)).to(device),
            flags=torch.from_numpy(self.flags).to(device),
            ends=torch.from_numpy(self.ends.astype(np.int64)).to(device),
            has_edges=torch.from_numpy(self.has_edges).to(device),
        )


def build_seg_layout(n_pad: int, e_pad: int, seg_idx, other_idx) -> SegLayout:
    """Host-side metadata for one scan direction.  Padded edge slots
    self-loop on the dummy node (slot ``n_pad - 1``), so they sort into the
    dummy's run and contribute only to a row that stays zero."""
    dummy = n_pad - 1
    seg = np.full(e_pad, dummy, np.int32)
    other = np.full(e_pad, dummy, np.int32)
    seg[: len(seg_idx)] = seg_idx
    other[: len(other_idx)] = other_idx
    order = np.argsort(seg, kind="stable")
    seg_sorted = seg[order]
    counts = np.bincount(seg_sorted, minlength=n_pad)
    ends = np.cumsum(counts)
    starts = ends - counts
    flags = np.zeros(e_pad, np.float32)
    flags[starts[counts > 0]] = 1.0
    return SegLayout(
        other_sorted=other[order],
        flags=flags,
        ends=(ends - 1).clip(0).astype(np.int32),
        has_edges=(counts > 0).astype(np.float32),
    )


def build_down_seg(n_pad: int, e_pad: int, dep_src, dep_dst) -> SegLayout:
    """Down-scan (impact): segments are DESTINATIONS, values come from
    sources."""
    return build_seg_layout(n_pad, e_pad, dep_dst, dep_src)


def build_up_seg(n_pad: int, e_pad: int, dep_src, dep_dst) -> SegLayout:
    """Up-scan (explain-away): segments are SOURCES (the dependents),
    values come from their dependencies."""
    return build_seg_layout(n_pad, e_pad, dep_src, dep_dst)


# Built layouts keyed by an edge-set digest: the host-side argsort and
# bincount, and the upload, cost milliseconds at 50k services, paid on every
# repeat analysis of a known graph otherwise.  Each entry holds the host
# layouts (key None) and their copies per device.  Insertion-ordered dict
# as a bounded FIFO.
_LAYOUT_CACHE: dict = {}
_LAYOUT_CACHE_MAX = 32


def arrays_digest(ints, arrays) -> bytes:
    """16-byte blake2b over shape scalars + array contents."""
    h = hashlib.blake2b(digest_size=16)
    h.update(np.asarray(list(ints), np.int64).tobytes())
    for arr in arrays:
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.digest()


def build_seg_layouts(n_pad: int, e_pad: int, dep_src, dep_dst, device=None):
    """Digest-cached ``(down_seg, up_seg)``: numpy host layouts, or with
    ``device`` their tensors on that device."""
    src = np.asarray(dep_src)
    dst = np.asarray(dep_dst)
    key = arrays_digest((n_pad, e_pad), (src, dst))
    hit = _LAYOUT_CACHE.get(key)
    if hit is None:
        hit = {None: (
            build_down_seg(n_pad, e_pad, src, dst),
            build_up_seg(n_pad, e_pad, src, dst),
        )}
        while len(_LAYOUT_CACHE) >= _LAYOUT_CACHE_MAX:
            _LAYOUT_CACHE.pop(next(iter(_LAYOUT_CACHE)))
        _LAYOUT_CACHE[key] = hit
    if device is None:
        return hit[None]
    dev = str(torch.device(device))
    if dev not in hit:
        hit[dev] = tuple(layout.to(device) for layout in hit[None])
    return hit[dev]


def down_seg_step(m, a_ex, decay: float, seg: SegLayout, inv_deg):
    """One impact step: ``m'[d] = inv_deg[d] * sum over (s, d) of
    (a_ex[s] + decay*m[s])``, as a segmented sum over dst-sorted edges."""
    vals = a_ex[seg.other_sorted] + decay * m[seg.other_sorted]
    s = segscan_sum(vals, seg.flags)
    return torch.where(seg.has_edges > 0, s[seg.ends], 0.0) * inv_deg


def up_seg_step(u, h, decay: float, seg: SegLayout):
    """One explain-away step as a segmented MAX over src-sorted edges of
    the dense per-node signal ``max(h, decay*u)``; fp32 max is
    order-invariant, so this is bit-identical to any scatter-max form."""
    w = torch.maximum(h, decay * u)
    s = segscan_max(w[seg.other_sorted], seg.flags)
    upd = torch.where(seg.has_edges > 0, s[seg.ends], 0.0)
    return torch.maximum(u, upd)
