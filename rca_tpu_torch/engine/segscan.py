"""Seg-step kernels, flagged segmented scans and the seg-step layouts.

Counterpart of the JAX package's ``engine/segscan.py``.  The propagation's
two recursions are segment reductions over the dependency edges:

- the impact down-step is a SUM per destination over dst-sorted edges;
- the explain-away up-step is a MAX per source over src-sorted edges.

On CUDA tensors each step is one launch of a hand-written kernel in
``csrc/segstep.cu`` (:func:`down_seg_step` / :func:`up_seg_step`), which
reduces each segment of the layout's CSR form where it lies, gather and
epilogue included; it replaces the TPU kernels ``pallas_segscan`` /
``pallas_segscan_max`` with the step bodies around them (the source note
says what bounds it).  On CPU tensors the steps compute their plain
versions (:func:`down_seg_step_plain` / :func:`up_seg_step_plain`): the
reference's composition of a gather, a flagged inclusive segmented scan of
the sorted per-edge values, and each segment's total read at its last
element (``s[ends]``), so float error is bounded by the longest segment.

The flagged scans themselves stay as the twins of the reference's public
``pallas_segscan`` / ``pallas_segscan_max``: :func:`segscan_sum` /
:func:`segscan_max` launch ``csrc/segscan.cu`` on a CUDA tensor and
compute :func:`segscan_plain`, the TPU kernel's own flagged Hillis-Steele
recurrence, on a CPU tensor.  There is no fallback between the two.

The layout builders are host-side numpy, byte-for-byte the JAX package's
in the reference's four fields.
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
    reduction identity) — the reference's four fields, byte-equal — plus
    the CSR form the seg-step kernels read: the row pointer, the other
    endpoints as int32, and the segment ids split by length into the ones
    a block reduces and the ones a thread reduces.  numpy on the host;
    :meth:`to` moves it."""

    other_sorted: np.ndarray   # int32 [e_pad] — other endpoint, seg-sorted
    flags: np.ndarray          # float32 [e_pad], 1 = first edge of its run
    ends: np.ndarray           # int32 [n_pad] — last edge pos per segment
    has_edges: np.ndarray      # float32 [n_pad]
    offsets: np.ndarray        # int32 [n_pad + 1] — segment s owns
    #                            edges offsets[s] .. offsets[s+1]-1
    other32: np.ndarray        # int32 [e_pad] — other_sorted, kept int32
    long_ids: np.ndarray       # int32 — segments of > SHORT_SEGMENT_MAX
    short_ids: np.ndarray      # int32 — the rest, empty ones included

    def to(self, device) -> "SegLayout":
        """The layout as tensors on ``device``: the reference's index fields
        as int64 for torch indexing (widened by numpy: torch's own CPU cast
        spreads over its thread pool), the kernels' CSR fields as int32."""
        def put(arr):
            return torch.from_numpy(arr).to(device)

        return SegLayout(
            other_sorted=put(self.other_sorted.astype(np.int64)),
            flags=put(self.flags),
            ends=put(self.ends.astype(np.int64)),
            has_edges=put(self.has_edges),
            offsets=put(self.offsets),
            other32=put(self.other32),
            long_ids=put(self.long_ids),
            short_ids=put(self.short_ids),
        )


#: Longest segment that one thread of the seg-step kernels reduces; longer
#: ones (hubs, the padding run on the dummy slot) get a block each.  16 was
#: the fastest down-step at both tiers of ``chip_smoke.py --sweep`` (8-256
#: tried; the up-step barely moves): a thread's walk sets its warp's time,
#: while shorter cuts launch many blocks for a few edges each.
SHORT_SEGMENT_MAX = 16


def build_seg_layout(n_pad: int, e_pad: int, seg_idx, other_idx,
                     short_max: int = SHORT_SEGMENT_MAX) -> SegLayout:
    """Host-side metadata for one scan direction.  Padded edge slots
    self-loop on the dummy node (slot ``n_pad - 1``), so they sort into the
    dummy's run and contribute only to a row that stays zero.  Segments of
    more than ``short_max`` edges go to ``long_ids``."""
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
    other_sorted = other[order]
    long_seg = counts > short_max
    return SegLayout(
        other_sorted=other_sorted,
        flags=flags,
        ends=(ends - 1).clip(0).astype(np.int32),
        has_edges=(counts > 0).astype(np.float32),
        offsets=np.concatenate([[0], ends]).astype(np.int32),
        other32=other_sorted,
        long_ids=np.flatnonzero(long_seg).astype(np.int32),
        short_ids=np.flatnonzero(~long_seg).astype(np.int32),
    )


def build_down_seg(n_pad: int, e_pad: int, dep_src, dep_dst,
                   short_max: int = SHORT_SEGMENT_MAX) -> SegLayout:
    """Down-scan (impact): segments are DESTINATIONS, values come from
    sources."""
    return build_seg_layout(n_pad, e_pad, dep_dst, dep_src, short_max)


def build_up_seg(n_pad: int, e_pad: int, dep_src, dep_dst,
                 short_max: int = SHORT_SEGMENT_MAX) -> SegLayout:
    """Up-scan (explain-away): segments are SOURCES (the dependents),
    values come from their dependencies."""
    return build_seg_layout(n_pad, e_pad, dep_src, dep_dst, short_max)


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


def down_seg_step_plain(m, a_ex, decay: float, seg: SegLayout, inv_deg,
                        out=None, scan=None):
    """One impact step in plain PyTorch: the gather of the per-edge values
    ``a_ex[s] + decay*m[s]``, a flagged segmented sum over the dst-sorted
    edges, each segment's total read at its end, times ``inv_deg``.
    ``scan(x, flags)`` takes the place of the plain flagged sum when given
    (the step as composed around the scan kernel); ``out`` receives the
    result."""
    vals = a_ex[seg.other_sorted] + decay * m[seg.other_sorted]
    s = (segscan_plain(vals, seg.flags, "sum") if scan is None
         else scan(vals, seg.flags))
    return torch.mul(torch.where(seg.has_edges > 0, s[seg.ends], 0.0),
                     inv_deg, out=out)


def up_seg_step_plain(u, h, decay: float, seg: SegLayout, out=None,
                      scan=None):
    """One explain-away step in plain PyTorch: a flagged segmented MAX over
    the src-sorted edges of the dense per-node signal ``max(h, decay*u)``;
    fp32 max is order-invariant, so this is bit-identical to any
    scatter-max form.  ``scan`` and ``out`` as in
    :func:`down_seg_step_plain`."""
    w = torch.maximum(h, decay * u)
    vals = w[seg.other_sorted]
    s = (segscan_plain(vals, seg.flags, "max") if scan is None
         else scan(vals, seg.flags))
    upd = torch.where(seg.has_edges > 0, s[seg.ends], 0.0)
    return torch.maximum(u, upd, out=out)


def check_step(name: str, seg: SegLayout, out, vectors: dict):
    """The step kernels' input contract, held on every device: float32,
    contiguous ``[n_pad]`` vectors on one device, the layout's tensors on
    that device, and an output that is none of the inputs."""
    if not isinstance(seg.offsets, torch.Tensor):
        raise TypeError(f"{name}: the layout is on the host; move it with "
                        f".to(device)")
    n_pad = seg.offsets.shape[0] - 1
    device = next(iter(vectors.values())).device
    named = vectors if out is None else {**vectors, "out": out}
    for key, t in named.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name}: {key} on {t.device}, inputs on "
                             f"{device}")
        if tuple(t.shape) != (n_pad,):
            raise ValueError(f"{name}: {key} must be [{n_pad}], got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if seg.offsets.device != device:
        raise ValueError(f"{name}: layout on {seg.offsets.device}, inputs "
                         f"on {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {device}")
    if out is not None and any(out.data_ptr() == t.data_ptr()
                               for t in vectors.values()):
        raise ValueError(f"{name}: the step is out of place; out must not "
                         f"be an input")
    return device.type == "cuda"


def launch_step(entry: str, name: str, seg: SegLayout, out, *args):
    from rca_tpu_torch.kernels.build import check, library

    stream = torch.cuda.current_stream(out.device).cuda_stream
    err = getattr(library(), entry)(
        *args, seg.offsets.data_ptr(), seg.other32.data_ptr(),
        seg.long_ids.data_ptr(), seg.long_ids.shape[0],
        seg.short_ids.data_ptr(), seg.short_ids.shape[0],
        out.data_ptr(), stream,
    )
    check(err, name)
    LAUNCHES[name] += 1
    return out


def down_seg_step(m, a_ex, decay: float, seg: SegLayout, inv_deg, out=None):
    """One impact step, ``m'[d] = inv_deg[d] * sum over (s, d) of
    (a_ex[s] + decay*m[s])``: on CUDA tensors one launch of the
    ``seg_down_step`` kernel into ``out`` (fresh when not given), on CPU
    tensors :func:`down_seg_step_plain`."""
    on_card = check_step("seg_down_step", seg, out,
                          {"m": m, "a_ex": a_ex, "inv_deg": inv_deg})
    if not on_card:
        return down_seg_step_plain(m, a_ex, decay, seg, inv_deg, out=out)
    return launch_step("rca_seg_down_step", "seg_down_step", seg,
                   torch.empty_like(m) if out is None else out,
                   m.data_ptr(), a_ex.data_ptr(), inv_deg.data_ptr(),
                   as_float32(decay))


def up_seg_step(u, h, decay: float, seg: SegLayout, out=None):
    """One explain-away step, ``u'[s] = max(u[s], max over (s, d) of
    max(h[d], decay*u[d]))``: on CUDA tensors one launch of the
    ``seg_up_step`` kernel into ``out`` (fresh when not given), on CPU
    tensors :func:`up_seg_step_plain`."""
    on_card = check_step("seg_up_step", seg, out, {"u": u, "h": h})
    if not on_card:
        return up_seg_step_plain(u, h, decay, seg, out=out)
    return launch_step("rca_seg_up_step", "seg_up_step", seg,
                   torch.empty_like(u) if out is None else out,
                   u.data_ptr(), h.data_ptr(), as_float32(decay))


def as_float32(x: float) -> float:
    """``x`` rounded to float32: the value torch multiplies a float32
    tensor by when it is given the Python float ``x``."""
    return float(np.float32(x))
