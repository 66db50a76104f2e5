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
says what bounds it).  The engine's main path runs each whole recursion
in one launch instead, in the form the plan names (:func:`steps_form`):
where the graph fits one CTA's shared memory :func:`down_seg_steps` /
:func:`up_seg_steps` (``csrc/segsteps.cu``: one CTA per lane, the layout
and the evolving vector in its shared memory), above it
:func:`down_seg_steps_grid` / :func:`up_seg_steps_grid`
(``csrc/seggrid.cu``: one cooperative launch over the card, a grid
barrier a step), both bitwise equal to the per-step launches; those stay
for the node-sharded engine's ``step`` form and as the yardstick.
The node-sharded engine's shards on one card run
:func:`up_seg_steps_shard` / :func:`down_seg_steps_shard` instead
(``csrc/segshard.cu``: one cooperative launch per recursion over every
shard, over the shards' joined layouts, :class:`ShardGrid`), bitwise the
per-step composition of the per-shard entries and the collectives, whose
plain form is their plain version; its shards one a card on distinct
cards run :func:`up_seg_steps_peer` / :func:`down_seg_steps_peer`
(``csrc/segpeer.cu``: one cooperative launch a card per recursion, the
blocks stored into the peers' memory, a barrier across the cards on
flags; :func:`launch_peer` enqueues the cards' launches back to back on
dedicated streams under one lock), bitwise the same composition.  On CPU
tensors the steps compute their plain versions
(:func:`down_seg_step_plain` / :func:`up_seg_step_plain`): the
reference's composition of a gather, a flagged inclusive segmented scan
of the sorted per-edge values, and each segment's total read at its last
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

import ctypes
import functools
import hashlib
import operator
from typing import NamedTuple

import numpy as np
import torch

from rca_tpu_torch.kernels import count_launch
from rca_tpu_torch.util.threads import make_lock

_OPS = {"sum": 0, "max": 1}


def segscan_plain(x: torch.Tensor, flags: torch.Tensor, op: str) -> torch.Tensor:
    """Segment-local flagged Hillis-Steele doubling along the last axis of
    ``x`` (``[N]``, or ``[B, N]`` lanes sharing the ``[N]`` flags):
    ``log2(N)`` shifted passes of ``v = v (+|max) shift(v)*(1-f)``,
    ``f = max(f, shift(f))``.  Every input must be NONNEGATIVE, so a
    boundary-masked contribution ``v*(1-f)`` is the combine's identity."""
    v, f = x, flags
    n = v.shape[-1]
    k = 1
    while k < n:
        v_s = torch.cat([v.new_zeros(v.shape[:-1] + (k,)), v[..., :-k]],
                        dim=-1)
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
    count_launch(f"segscan_{op}")
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
    a block reduces and the ones a thread reduces; and the same CSR in
    the grid recursions' item order (:func:`item_layout`).  numpy on the
    host; :meth:`to` moves it."""

    other_sorted: np.ndarray   # int32 [e_pad] — other endpoint, seg-sorted
    flags: np.ndarray          # float32 [e_pad], 1 = first edge of its run
    ends: np.ndarray           # int32 [n_pad] — last edge pos per segment
    has_edges: np.ndarray      # float32 [n_pad]
    offsets: np.ndarray        # int32 [n_pad + 1] — segment s owns
    #                            edges offsets[s] .. offsets[s+1]-1
    other32: np.ndarray        # int32 [e_pad] — other_sorted, kept int32
    long_ids: np.ndarray       # int32 — segments of > SHORT_SEGMENT_MAX
    short_ids: np.ndarray      # int32 — the rest, empty ones included
    item_seg: np.ndarray       # int32 [n_pad] — big, other long, short ids
    item_offsets: np.ndarray   # int32 [n_pad + 1] — their edges' offsets
    item_other: np.ndarray     # int32 [e_pad] — other32 in that order
    n_big: int                 # the big segments, item_seg's first ones
    pad_item: int              # the certified padding run's position, or -1

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
            item_seg=put(self.item_seg),
            item_offsets=put(self.item_offsets),
            item_other=put(self.item_other),
            n_big=self.n_big,
            pad_item=self.pad_item,
        )


#: Longest segment that one thread of the seg-step kernels reduces; longer
#: ones (hubs, the padding run on the dummy slot) get a block each.  16 was
#: the fastest down-step at both tiers of ``chip_smoke.py --sweep`` (8-256
#: tried; the up-step barely moves): a thread's walk sets its warp's time,
#: while shorter cuts launch many blocks for a few edges each.
SHORT_SEGMENT_MAX = 16
#: Longest segment that one warp of the grid recursions reduces
#: (``csrc/seggrid.cu``): one load per lane and per played thread, all in
#: flight; longer ones take a whole CTA each, a walk of several loads a
#: thread.
GRID_BIG_MIN = 256


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
    long_ids = np.flatnonzero(long_seg).astype(np.int32)
    short_ids = np.flatnonzero(~long_seg).astype(np.int32)
    return SegLayout(
        other_sorted=other_sorted,
        flags=flags,
        ends=(ends - 1).clip(0).astype(np.int32),
        has_edges=(counts > 0).astype(np.float32),
        offsets=np.concatenate([[0], ends]).astype(np.int32),
        other32=other_sorted,
        long_ids=long_ids,
        short_ids=short_ids,
        **item_layout(other_sorted, starts, counts, long_ids, short_ids),
    )


def item_layout(other_sorted, starts, counts, long_ids, short_ids) -> dict:
    """The CSR in the grid recursions' item order (``csrc/seggrid.cu``):
    the big segments (more than ``GRID_BIG_MIN`` edges, ``n_big`` of
    them), the other long ones, then the short ones (``item_seg``, each
    kind in id order), each with its edges' other endpoints contiguous
    (``item_other``, from ``item_offsets``), so a CTA's run of items owns
    one run of edges.  ``pad_item`` is the position of the dummy slot's
    segment where it is long and holds only padding self-loops (every
    edge gathers the dummy itself, which the kernel's exact shortcut
    needs), else -1."""
    big = counts[long_ids] > GRID_BIG_MIN
    item_seg = np.concatenate([long_ids[big], long_ids[~big],
                               short_ids]).astype(np.int32)
    n_item = counts[item_seg]
    item_offsets = np.concatenate([[0], np.cumsum(n_item)]).astype(np.int32)
    moved = np.repeat(starts[item_seg] - item_offsets[:-1], n_item)
    dummy = len(counts) - 1
    run = other_sorted[starts[dummy]:starts[dummy] + counts[dummy]]
    # the dummy, the largest id, ends its kind's run of long segments
    pad = (len(long_ids) > 0 and long_ids[-1] == dummy
           and bool(np.all(run == dummy)))
    n_big = int(big.sum())
    return {
        "item_seg": item_seg,
        "item_offsets": item_offsets,
        "item_other": other_sorted[np.arange(len(other_sorted)) + moved],
        "n_big": n_big,
        "pad_item": ((n_big if big[-1] else len(long_ids)) - 1 if pad
                     else -1),
    }


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


def segment_totals(vals, seg, op: str, scan=None):
    """Each segment's total of the seg-sorted per-edge ``vals`` (``[...,
    e_pad]``, nonnegative): the flagged segmented scan (``scan(vals,
    flags)`` when given, else :func:`segscan_plain`) read at each
    segment's last edge, 0 for a segment with no edge.  ``seg`` is a
    :class:`SegLayout` or a :class:`ShardSeg`."""
    s = (segscan_plain(vals, seg.flags, op) if scan is None
         else scan(vals, seg.flags))
    return torch.where(seg.has_edges > 0, s[..., seg.ends], 0.0)


def scatter_max(like, idx, vals):
    """``zeros_like(like).at[..., idx].max(vals)`` along the last axis
    (``idx`` shared by the lanes): order-free, so every device gives the
    same bits, and a tie's gradient splits evenly, as ``.at[].max``
    splits it."""
    return torch.zeros_like(like).scatter_reduce(
        -1, idx.expand(vals.shape), vals, reduce="amax", include_self=True)


def down_seg_step_plain(m, a_ex, decay: float, seg: SegLayout, inv_deg,
                        out=None, scan=None):
    """One impact step in plain PyTorch: the gather of the per-edge values
    ``a_ex[s] + decay*m[s]``, a flagged segmented sum over the dst-sorted
    edges, each segment's total read at its end, times ``inv_deg``.  ``m``
    and ``a_ex`` are ``[n_pad]`` or ``[B, n_pad]`` lanes; ``inv_deg`` is
    ``[n_pad]``, shared.  ``scan(x, flags)`` takes the place of the plain
    flagged sum when given (the step as composed around the scan kernel);
    ``out`` receives the result."""
    vals = a_ex[..., seg.other_sorted] + decay * m[..., seg.other_sorted]
    return torch.mul(segment_totals(vals, seg, "sum", scan), inv_deg,
                     out=out)


def up_seg_step_plain(u, h, decay: float, seg: SegLayout, out=None,
                      scan=None):
    """One explain-away step in plain PyTorch: a flagged segmented MAX over
    the src-sorted edges of the dense per-node signal ``max(h, decay*u)``;
    fp32 max is order-invariant, so this is bit-identical to any
    scatter-max form.  Lanes, ``scan`` and ``out`` as in
    :func:`down_seg_step_plain`."""
    w = torch.maximum(h, decay * u)
    upd = segment_totals(w[..., seg.other_sorted], seg, "max", scan)
    return torch.maximum(u, upd, out=out)


def check_step(name: str, offsets, out, vectors: dict, shared: dict = None,
               local: dict = None, base: int = None):
    """The step kernels' input contract, held on every device: float32,
    contiguous tensors on one device, the layout's row pointer
    ``offsets`` on that device, and an output that is none of the
    inputs.  ``n_seg`` is the row pointer's segment count.  A dense step
    (``base`` None): the lane ``vectors`` and ``out`` all ``[n_seg]`` or
    all ``[B, n_seg]``, the ``shared`` ones ``[n_seg]``.  A shard's step
    (``base`` given): the ``vectors`` ``[n_val]`` or ``[B, n_val]`` (the
    full gathered vectors), ``local`` and ``out`` ``[n_seg]`` or ``[B,
    n_seg]``, and ``base + n_seg <= n_val``.  Returns ``(lanes,
    n_val)``: lanes is B (1 for flat vectors) on CUDA tensors and 0 on
    CPU tensors."""
    if not isinstance(offsets, torch.Tensor):
        raise TypeError(f"{name}: the layout is on the host; move it with "
                        f".to(device)")
    n_seg = offsets.shape[0] - 1
    first = next(iter(vectors.values()))
    device = first.device
    shape = tuple(first.shape)
    if base is None:
        if shape not in ((n_seg,), shape[:1] + (n_seg,)):
            raise ValueError(f"{name}: vectors must be [{n_seg}] or "
                             f"[B, {n_seg}], got {shape}")
    elif len(shape) not in (1, 2) or not 0 <= base <= shape[-1] - n_seg:
        raise ValueError(f"{name}: {n_seg} segments from base {base} do not "
                         f"fit vectors {shape}")
    lead = shape[:-1]
    lanes = {**(local or {}), **({} if out is None else {"out": out})}
    named = [(key, t, shape) for key, t in vectors.items()] + [
        (key, t, lead + (n_seg,)) for key, t in lanes.items()] + [
        (key, t, (n_seg,)) for key, t in (shared or {}).items()]
    for key, t, want in named:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name}: {key} on {t.device}, inputs on "
                             f"{device}")
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: {key} must be {list(want)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if offsets.device != device:
        raise ValueError(f"{name}: layout on {offsets.device}, inputs "
                         f"on {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {device}")
    inputs = [*vectors.values(), *(local or {}).values(),
              *(shared or {}).values()]
    if out is not None and any(out.data_ptr() == t.data_ptr()
                               for t in inputs):
        raise ValueError(f"{name}: the step is out of place; out must not "
                         f"be an input")
    if device.type != "cuda":
        return 0, shape[-1]
    return (shape[0] if len(shape) == 2 else 1), shape[-1]


def launch_step(entry: str, name: str, seg, lanes: int, out, *args,
                shard: bool = False):
    """One launch of a seg-step kernel over ``lanes`` lanes (one grid row
    per lane) of the layout's segments, sharing the layout, on the
    output's device and its current stream.  ``shard``: a per-shard entry,
    counted in ``SHARD_LAUNCHES`` too."""
    from rca_tpu_torch.kernels.build import check, library

    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = getattr(library(), entry)(
            *args, seg.offsets.data_ptr(), seg.other32.data_ptr(),
            seg.long_ids.data_ptr(), seg.long_ids.shape[0],
            seg.short_ids.data_ptr(), seg.short_ids.shape[0],
            lanes, seg.offsets.shape[0] - 1, out.data_ptr(), stream,
        )
    check(err, name)
    count_launch(name, shard=shard)
    return out


def down_seg_step(m, a_ex, decay: float, seg: SegLayout, inv_deg, out=None):
    """One impact step, ``m'[d] = inv_deg[d] * sum over (s, d) of
    (a_ex[s] + decay*m[s])``, on ``[n_pad]`` vectors or ``[B, n_pad]``
    lanes (``inv_deg`` ``[n_pad]``, shared): on CUDA tensors one launch of
    the ``seg_down_step`` kernel for all lanes into ``out`` (fresh when not
    given), on CPU tensors :func:`down_seg_step_plain`."""
    lanes, _ = check_step("seg_down_step", seg.offsets, out,
                          {"m": m, "a_ex": a_ex}, {"inv_deg": inv_deg})
    if not lanes:
        return down_seg_step_plain(m, a_ex, decay, seg, inv_deg, out=out)
    return launch_step("rca_seg_down_step", "seg_down_step", seg, lanes,
                       torch.empty_like(m) if out is None else out,
                       m.data_ptr(), a_ex.data_ptr(), inv_deg.data_ptr(),
                       as_float32(decay))


def up_seg_step(u, h, decay: float, seg: SegLayout, out=None):
    """One explain-away step, ``u'[s] = max(u[s], max over (s, d) of
    max(h[d], decay*u[d]))``, on ``[n_pad]`` vectors or ``[B, n_pad]``
    lanes: on CUDA tensors one launch of the ``seg_up_step`` kernel for all
    lanes into ``out`` (fresh when not given), on CPU tensors
    :func:`up_seg_step_plain`."""
    lanes, _ = check_step("seg_up_step", seg.offsets, out, {"u": u, "h": h})
    if not lanes:
        return up_seg_step_plain(u, h, decay, seg, out=out)
    return launch_step("rca_seg_up_step", "seg_up_step", seg, lanes,
                       torch.empty_like(u) if out is None else out,
                       u.data_ptr(), h.data_ptr(), as_float32(decay))


def as_float32(x: float) -> float:
    """``x`` rounded to float32: the value torch multiplies a float32
    tensor by when it is given the Python float ``x``."""
    return float(np.float32(x))


# -- the fused recursions (csrc/segsteps.cu) ---------------------------------

#: the forms a plan's two recursions take (``KernelPlan.steps_form``):
#: one launch a step (``step``), one launch with one CTA a lane (``cta``),
#: one cooperative launch over the card (``grid``)
STEPS_FORMS = ("step", "cta", "grid")


def steps_form(down_seg, up_seg, device) -> str:
    """The form of the ``kernels`` row's recursions over these layouts on
    ``device``: ``cta`` where each layout fits one CTA's shared memory
    there (:func:`steps_smem`), else ``grid``; off a CUDA device ``step``
    (there every form computes the same loop of plain steps)."""
    if torch.device(device).type != "cuda":
        return "step"
    fits = all(need <= limit for need, limit in (
        steps_smem(seg, device) for seg in (down_seg, up_seg)))
    return "cta" if fits else "grid"


def steps_smem(seg: SegLayout, device) -> tuple:
    """``(need, limit)``: the dynamic shared memory a fused launch over
    ``seg`` takes and the most one CTA may take on the CUDA ``device``,
    both from the kernel library (``csrc/segsteps.cu``), so the plan and
    the launch count alike."""
    from rca_tpu_torch.kernels.build import check, library

    need, limit = ctypes.c_longlong(0), ctypes.c_longlong(0)
    with torch.cuda.device(torch.device(device)):
        check(library().rca_seg_steps_smem(
            seg.offsets.shape[0] - 1, seg.other32.shape[0],
            seg.long_ids.shape[0], ctypes.byref(need), ctypes.byref(limit)),
            "seg_steps shared memory")
    return need.value, limit.value


def up_seg_steps_plain(h, decay: float, steps: int, seg: SegLayout,
                       out=None):
    """The explain-away recursion in plain PyTorch: ``u_0 = 0``, then
    ``steps`` of :func:`up_seg_step_plain`.  ``h`` is ``[n_pad]`` or
    ``[B, n_pad]`` lanes; ``out`` receives ``u_steps``."""
    u = torch.zeros_like(h)
    for _ in range(steps):
        u = up_seg_step_plain(u, h, decay, seg)
    return u if out is None else out.copy_(u)


def down_seg_steps_plain(a_ex, decay: float, steps: int, seg: SegLayout,
                         inv_deg, out=None):
    """The impact recursion in plain PyTorch: ``m_0 = 0``, then ``steps``
    of :func:`down_seg_step_plain`.  Lanes and ``out`` as in
    :func:`up_seg_steps_plain`; ``inv_deg`` is ``[n_pad]``, shared."""
    m = torch.zeros_like(a_ex)
    for _ in range(steps):
        m = down_seg_step_plain(m, a_ex, decay, seg, inv_deg)
    return m if out is None else out.copy_(m)


def _step_count(name: str, steps) -> int:
    steps = operator.index(steps)
    if steps < 0:
        raise ValueError(f"{name}: steps must be >= 0, got {steps}")
    return steps


def launch_steps(entry: str, name: str, seg: SegLayout, steps: int,
                 lanes: int, out, *args):
    """One launch of a fused recursion, ``steps`` >= 1 steps over
    ``lanes`` lanes (one CTA per lane), on the output's device and its
    current stream.  A layout above the CTA's shared memory raises: the
    plan runs the grid recursions for it."""
    from rca_tpu_torch.kernels.build import check, library

    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = getattr(library(), entry)(
            *args, steps, seg.offsets.data_ptr(), seg.other32.data_ptr(),
            seg.long_ids.data_ptr(), seg.long_ids.shape[0],
            seg.other32.shape[0], lanes, seg.offsets.shape[0] - 1,
            out.data_ptr(), stream,
        )
    check(err, name)
    count_launch(name)
    return out


def up_seg_steps(h, decay: float, steps: int, seg: SegLayout, out=None):
    """The explain-away recursion, ``u_0 = 0``, ``u_{k+1}[s] = max(u_k[s],
    max over (s, d) of max(h[d], decay*u_k[d]))``, returning ``u_steps``,
    on ``[n_pad]`` vectors or ``[B, n_pad]`` lanes: on CUDA tensors one
    launch of the ``seg_up_steps`` kernel for every step and lane (none
    for ``steps == 0``), bitwise ``steps`` launches of
    :func:`up_seg_step`, into ``out`` (fresh when not given); on CPU
    tensors :func:`up_seg_steps_plain`."""
    steps = _step_count("seg_up_steps", steps)
    lanes, _ = check_step("seg_up_steps", seg.offsets, out, {"h": h})
    if not lanes:
        return up_seg_steps_plain(h, decay, steps, seg, out=out)
    out = torch.empty_like(h) if out is None else out
    if steps == 0:
        return out.zero_()
    return launch_steps("rca_seg_up_steps", "seg_up_steps", seg, steps,
                        lanes, out, h.data_ptr(), as_float32(decay))


def down_seg_steps(a_ex, decay: float, steps: int, seg: SegLayout, inv_deg,
                   out=None):
    """The impact recursion, ``m_0 = 0``, ``m_{k+1}[d] = inv_deg[d] * sum
    over (s, d) of (a_ex[s] + decay*m_k[s])``, returning ``m_steps``, on
    ``[n_pad]`` vectors or ``[B, n_pad]`` lanes (``inv_deg`` ``[n_pad]``,
    shared): on CUDA tensors one launch of the ``seg_down_steps`` kernel
    for every step and lane (none for ``steps == 0``), bitwise ``steps``
    launches of :func:`down_seg_step`, into ``out`` (fresh when not
    given); on CPU tensors :func:`down_seg_steps_plain`."""
    steps = _step_count("seg_down_steps", steps)
    lanes, _ = check_step("seg_down_steps", seg.offsets, out,
                          {"a_ex": a_ex}, {"inv_deg": inv_deg})
    if not lanes:
        return down_seg_steps_plain(a_ex, decay, steps, seg, inv_deg,
                                    out=out)
    out = torch.empty_like(a_ex) if out is None else out
    if steps == 0:
        return out.zero_()
    return launch_steps("rca_seg_down_steps", "seg_down_steps", seg, steps,
                        lanes, out, a_ex.data_ptr(), inv_deg.data_ptr(),
                        as_float32(decay))


# -- the grid recursions (csrc/seggrid.cu) -----------------------------------

#: segments of one grid work item (``csrc/seggrid.cu``): one big segment
#: (more than ``GRID_BIG_MIN`` edges) reduced by the whole CTA, 8 other
#: long ones a warp each, 256 short ones a thread each
GRID_LONG_ITEM = 8
GRID_SHORT_ITEM = 256

# Per device and stream, the double-buffered scratch of the grid
# recursions' gathered values, kept between calls (a stream's launches
# run in order, so they may share one buffer; serve threads call on
# streams of their own).  Insertion-ordered dict as a bounded FIFO, under
# its lock.
_GRID_SCRATCH: dict = {}
_GRID_SCRATCH_MAX = 16
_GRID_SCRATCH_LOCK = make_lock("segscan._GRID_SCRATCH_LOCK")


def grid_items(n_pad: int, n_long: int, n_big: int) -> int:
    """Work items of one lane of a grid recursion over ``n_pad``
    segments, ``n_long`` of them long and ``n_big`` of those big: the big
    segments, the groups of the other long ones, then the blocks of short
    ones."""
    return (n_big + -(-(n_long - n_big) // GRID_LONG_ITEM)
            + -(-(n_pad - n_long) // GRID_SHORT_ITEM))


def steps_grid(n_items: int, lanes: int, cap: int) -> tuple:
    """``(g_items, g_lanes)``: the grid of a grid recursion's cooperative
    launch over ``lanes`` lanes of ``n_items`` items, ``g_items`` CTAs
    along the items (one each while they fit under ``cap``) times
    ``g_lanes`` along the lanes (as many as still fit), so the grid never
    passes ``cap``, the CTAs that can be resident at once.  CTA ``c =
    lg * g_items + jg`` takes items ``[jg * n_items // g_items, (jg + 1)
    * n_items // g_items)`` of lanes ``[lg * lanes // g_lanes, (lg + 1) *
    lanes // g_lanes)`` at every step (the kernel computes the ranges)."""
    if cap < 1:
        raise ValueError(f"seg_steps_grid: no CTA of the grid recursion "
                         f"fits the device (co-resident bound {cap})")
    g_items = min(n_items, cap)
    return g_items, max(1, min(lanes, cap // g_items))


@functools.lru_cache(maxsize=None)
def grid_cap(device_index: int, down: bool) -> int:
    """The most CTAs of the ``down`` (else up) grid recursion that CUDA
    device ``device_index`` holds at once, from the kernel library's
    occupancy query; read once per device and recursion.  The up shard
    recursion runs the up grid recursion's kernel, so this is its bound
    too."""
    from rca_tpu_torch.kernels.build import check, library

    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        check(library().rca_seg_steps_grid_cap(int(down), ctypes.byref(out)),
              "seg_steps_grid co-resident bound")
    return out.value


@functools.lru_cache(maxsize=None)
def shard_down_cap(device_index: int) -> int:
    """The most CTAs of the impact shard recursion that CUDA device
    ``device_index`` holds at once; read once per device."""
    from rca_tpu_torch.kernels.build import check, library

    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        check(library().rca_seg_steps_shard_cap(ctypes.byref(out)),
              "seg_down_steps_shard co-resident bound")
    return out.value


def grid_scratch(device, stream: int, floats: int) -> torch.Tensor:
    """The ``stream``'s scratch of at least ``floats`` float32 on
    ``device``, grown where a call needs more."""
    key = (device.index, stream)
    with _GRID_SCRATCH_LOCK:
        buf = _GRID_SCRATCH.get(key)
        if buf is None or buf.numel() < floats:
            while len(_GRID_SCRATCH) >= _GRID_SCRATCH_MAX:
                _GRID_SCRATCH.pop(next(iter(_GRID_SCRATCH)))
            buf = _GRID_SCRATCH[key] = torch.empty(
                floats, dtype=torch.float32, device=device)
        return buf


def launch_grid(entry: str, name: str, seg: SegLayout, steps: int,
                lanes: int, out, *args):
    """One cooperative launch of a grid recursion, ``steps`` >= 1 steps
    over ``lanes`` lanes, on the output's device and its current stream.
    A refused launch raises: there is no other form to fall back to."""
    from rca_tpu_torch.kernels.build import check, library

    device = out.device
    n_pad = seg.offsets.shape[0] - 1
    n_long = seg.long_ids.shape[0]
    grid = steps_grid(grid_items(n_pad, n_long, seg.n_big), lanes, grid_cap(
        device.index, entry == "rca_seg_down_steps_grid"))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(library(), entry)(
            *args, steps, seg.item_seg.data_ptr(),
            seg.item_offsets.data_ptr(), seg.item_other.data_ptr(), n_long,
            seg.n_big, seg.pad_item, lanes, n_pad,
            grid_scratch(device, stream, 2 * lanes * n_pad).data_ptr(),
            out.data_ptr(), *grid, stream,
        )
    check(err, name)
    count_launch(name)
    return out


def up_seg_steps_grid(h, decay: float, steps: int, seg: SegLayout,
                      out=None):
    """The explain-away recursion as :func:`up_seg_steps` computes it, for
    graphs of any size: on CUDA tensors one cooperative launch of the
    ``seg_up_steps_grid`` kernel over the card for every step and lane
    (none for ``steps == 0``), bitwise ``steps`` launches of
    :func:`up_seg_step`, into ``out`` (fresh when not given); on CPU
    tensors :func:`up_seg_steps_plain`."""
    steps = _step_count("seg_up_steps_grid", steps)
    lanes, _ = check_step("seg_up_steps_grid", seg.offsets, out, {"h": h})
    if not lanes:
        return up_seg_steps_plain(h, decay, steps, seg, out=out)
    out = torch.empty_like(h) if out is None else out
    if steps == 0:
        return out.zero_()
    return launch_grid("rca_seg_up_steps_grid", "seg_up_steps_grid", seg,
                       steps, lanes, out, h.data_ptr(), as_float32(decay))


def down_seg_steps_grid(a_ex, decay: float, steps: int, seg: SegLayout,
                        inv_deg, out=None):
    """The impact recursion as :func:`down_seg_steps` computes it, for
    graphs of any size: on CUDA tensors one cooperative launch of the
    ``seg_down_steps_grid`` kernel over the card for every step and lane
    (none for ``steps == 0``), bitwise ``steps`` launches of
    :func:`down_seg_step`, into ``out`` (fresh when not given); on CPU
    tensors :func:`down_seg_steps_plain`."""
    steps = _step_count("seg_down_steps_grid", steps)
    lanes, _ = check_step("seg_down_steps_grid", seg.offsets, out,
                          {"a_ex": a_ex}, {"inv_deg": inv_deg})
    if not lanes:
        return down_seg_steps_plain(a_ex, decay, steps, seg, inv_deg,
                                    out=out)
    out = torch.empty_like(a_ex) if out is None else out
    if steps == 0:
        return out.zero_()
    return launch_grid("rca_seg_down_steps_grid", "seg_down_steps_grid", seg,
                       steps, lanes, out, a_ex.data_ptr(),
                       inv_deg.data_ptr(), as_float32(decay))


# -- the per-shard entries (the node-sharded engine) -------------------------

class ShardSeg(NamedTuple):
    """One shard's layout for one scan direction, as tensors on the
    shard's device: the reference's per-shard fields (``other_sorted``
    widened to int64 for torch indexing, the edge ``mask``, ``flags``,
    ``ends`` as int64, ``has_edges``) over the shard's padded edge rows,
    whose padding sorts into the last segment with mask 0, and the CSR
    form the per-shard kernels read: ``offsets`` over REAL edges only
    (the last segment stops before the padding, so a pad edge adds or
    maxes nothing into any node), ``other32`` (the sorted other
    endpoints, int32) and the segment ids split by length."""

    other_sorted: torch.Tensor   # int64 [e_pad]
    mask: torch.Tensor           # float32 [e_pad]
    flags: torch.Tensor          # float32 [e_pad]
    ends: torch.Tensor           # int64 [n_seg]
    has_edges: torch.Tensor      # float32 [n_seg]
    offsets: torch.Tensor        # int32 [n_seg + 1], real edges only
    other32: torch.Tensor        # int32 [e_pad]
    long_ids: torch.Tensor       # int32, segments of > SHORT_SEGMENT_MAX
    short_ids: torch.Tensor      # int32, the rest


def up_seg_step_shard_plain(u_full, h_full, decay: float, seg: ShardSeg,
                            base: int, out=None):
    """One shard's explain-away step in plain PyTorch, the reference's
    per-block composition: the masked gather of ``max(h, decay*u)`` from
    the full gathered vectors, a flagged segmented MAX over the shard's
    src-sorted edges, each segment's total at its end, then the max with
    the node's own ``u`` (``u_full[base + s]``).  Returns ``[..., n_seg]``."""
    n_seg = seg.ends.shape[0]
    w = torch.maximum(h_full, decay * u_full)
    upd = segment_totals(seg.mask * w[..., seg.other_sorted], seg, "max")
    return torch.maximum(u_full[..., base:base + n_seg], upd, out=out)


def down_seg_step_shard_plain(m_full, a_ex_full, decay: float,
                              seg: ShardSeg, out=None):
    """One shard's impact contributions in plain PyTorch: the masked
    per-edge values ``a_ex[s] + decay*m[s]`` over the shard's dst-sorted
    edge partition, a flagged segmented SUM, each destination's total at
    its end, unscaled (the reduce-scatter and ``inv_deg`` finish the
    step).  Returns ``[..., n_pad]``."""
    o = seg.other_sorted
    vals = seg.mask * (a_ex_full[..., o] + decay * m_full[..., o])
    contrib = segment_totals(vals, seg, "sum")
    return contrib if out is None else out.copy_(contrib)


def up_seg_step_shard(u_full, h_full, decay: float, seg: ShardSeg,
                      base: int, out=None):
    """One shard's explain-away step, ``u'[s] = max(u[base+s], max over
    (s, d) of max(h[d], decay*u[d]))`` for the shard's ``n_seg`` own
    sources, from full ``[n_pad]`` (or ``[B, n_pad]``) gathered vectors:
    on CUDA tensors one launch of the ``seg_up_step`` kernel's per-shard
    entry, on CPU tensors :func:`up_seg_step_shard_plain`."""
    lanes, n_val = check_step("seg_up_step", seg.offsets, out,
                              {"u_full": u_full, "h_full": h_full},
                              base=base)
    if not lanes:
        return up_seg_step_shard_plain(u_full, h_full, decay, seg, base,
                                       out=out)
    if out is None:
        out = u_full.new_empty(u_full.shape[:-1] + (seg.ends.shape[0],))
    return launch_step("rca_seg_up_step_shard", "seg_up_step", seg, lanes,
                       out, u_full.data_ptr(), h_full.data_ptr(),
                       as_float32(decay), int(base), n_val, shard=True)


def down_seg_step_shard(m_full, a_ex_full, decay: float, seg: ShardSeg,
                        out=None):
    """One shard's unscaled impact contributions, ``c[d] = sum over the
    shard's edges (s, d) of (a_ex[s] + decay*m[s])`` for every
    destination, from full ``[n_pad]`` (or ``[B, n_pad]``) vectors: on
    CUDA tensors one launch of the ``seg_down_step`` kernel's per-shard
    entry, on CPU tensors :func:`down_seg_step_shard_plain`."""
    lanes, n_val = check_step("seg_down_step", seg.offsets, out,
                              {"m_full": m_full, "a_ex_full": a_ex_full})
    if not lanes:
        return down_seg_step_shard_plain(m_full, a_ex_full, decay, seg,
                                         out=out)
    if out is None:
        out = torch.empty_like(m_full)
    return launch_step("rca_seg_down_step_shard", "seg_down_step", seg,
                       lanes, out, m_full.data_ptr(), a_ex_full.data_ptr(),
                       as_float32(decay), n_val, shard=True)


# -- every shard of one card (csrc/segshard.cu) -------------------------------

class ShardGrid(NamedTuple):
    """The recursions' layouts of every shard of one device, as the shard
    recursions read them (``csrc/segshard.cu``), in the grid recursions'
    item order (:func:`item_layout`):

    - ``up_*``: the shards' up layouts (real edges only) joined in shard
      order, one layout over the ``n_pad`` nodes, segment ``k * block + s``
      holding shard ``k``'s own source ``s``;
    - ``dn_*``: every (shard, destination) pair the shard's edges reach,
      slot ``v`` in shard-major order, as one layout of ``pairs``
      positions whose ``dn_seg`` are the slots;
    - ``reach_offsets`` / ``reach``: each node's pair slots in shard order
      (the fixed order the impact step adds the shards' contributions in).

    numpy on the host; :meth:`to` moves it."""

    up_seg: np.ndarray          # int32 [n_pad] node ids in item order
    up_offsets: np.ndarray      # int32 [n_pad + 1]
    up_other: np.ndarray        # int32 [e] the edges' destinations
    up_n_long: int
    up_n_big: int
    dn_seg: np.ndarray          # int32 [pairs] pair slots in item order
    dn_offsets: np.ndarray      # int32 [pairs + 1]
    dn_other: np.ndarray        # int32 [e] the edges' sources
    dn_n_long: int
    dn_n_big: int
    reach_offsets: np.ndarray   # int32 [n_pad + 1]
    reach: np.ndarray           # int32 [pairs]

    @property
    def pairs(self) -> int:
        return self.dn_seg.shape[0]

    def to(self, device) -> "ShardGrid":
        return ShardGrid(*(torch.from_numpy(f).to(device)
                           if isinstance(f, np.ndarray) else f
                           for f in self))


def _joined_items(other, counts) -> tuple:
    """:func:`item_layout` over segments of ``counts`` edges each, laid out
    one after another in ``other``: ``(item_seg, item_offsets,
    item_other, n_long, n_big)``.  No padding run: shard layouts hold real
    edges only."""
    counts = np.asarray(counts, np.int64)
    if not len(counts):
        empty = np.zeros(0, np.int32)
        return empty, np.zeros(1, np.int32), empty, 0, 0
    starts = np.cumsum(counts) - counts
    long_seg = counts > SHORT_SEGMENT_MAX
    long_ids = np.flatnonzero(long_seg).astype(np.int32)
    items = item_layout(other, starts, counts, long_ids,
                        np.flatnonzero(~long_seg).astype(np.int32))
    return (items["item_seg"], items["item_offsets"], items["item_other"],
            len(long_ids), items["n_big"])


def build_shard_grid(up_offsets, up_other, dn_offsets, dn_other) -> ShardGrid:
    """The :class:`ShardGrid` of ``sp`` shards from their per-shard CSR
    layouts (``ShardedSegLayouts``' ``[sp, ...]`` fields: offsets over
    real edges, the sorted other endpoints)."""
    sp = len(up_offsets)
    n_pad = dn_offsets.shape[1] - 1
    up_counts = np.diff(up_offsets, axis=1).reshape(-1)
    up = _joined_items(
        np.concatenate([up_other[k][:up_offsets[k][-1]] for k in range(sp)]),
        up_counts)
    dn_counts = np.diff(dn_offsets, axis=1)
    pair_shard, pair_dst = np.nonzero(dn_counts)   # shard-major
    dn = _joined_items(
        np.concatenate([dn_other[k][:dn_offsets[k][-1]] for k in range(sp)]),
        dn_counts[pair_shard, pair_dst])
    return ShardGrid(
        *up, *dn,
        reach_offsets=np.concatenate([[0], np.cumsum(np.bincount(
            pair_dst, minlength=n_pad))]).astype(np.int32),
        reach=np.lexsort((pair_shard, pair_dst)).astype(np.int32))


def grid_shares(n_items: int, lanes: int, grid: tuple) -> list:
    """What each CTA of a grid or shard recursion's launch of ``grid =
    (g_items, g_lanes)`` CTAs takes at every step, as the kernel computes
    it (``csrc/seggrid.cuh::share_of``): ``((j0, j1), (b0, b1))`` per CTA
    in launch order, the items and lanes of its share."""
    g_items, g_lanes = grid
    return [((jg * n_items // g_items, (jg + 1) * n_items // g_items),
             (lg * lanes // g_lanes, (lg + 1) * lanes // g_lanes))
            for lg in range(g_lanes) for jg in range(g_items)]


def up_shard_recursion(h_full, decay: float, steps: int, segs, step=None):
    """The explain-away recursion of ``sp`` shards, step by step, as the
    node-sharded engine composes it between collectives: each shard's
    ``u`` block starts at 0; each step all-gathers the blocks onto every
    shard's device and runs ``step`` (default
    :func:`up_seg_step_shard_plain`) per shard over its up layout.
    ``h_full``: each shard's gathered ``[..., n_pad]`` ``h`` on its
    device.  Returns the ``[..., block]`` blocks."""
    from rca_tpu_torch.parallel.collectives import all_gather

    step = step or up_seg_step_shard_plain
    block = segs[0].ends.shape[0]
    devices = [h.device for h in h_full]
    u_blk = [h.new_zeros(h.shape[:-1] + (block,)) for h in h_full]
    for _ in range(steps):
        u_full = all_gather(u_blk, devices)
        u_blk = [step(u_full[k], h_full[k], decay, segs[k], k * block)
                 for k in range(len(segs))]
    return u_blk


def down_shard_recursion(a_ex_full, decay: float, steps: int, segs,
                         inv_deg_blk, step=None):
    """The impact recursion of ``sp`` shards, step by step, as the
    node-sharded engine composes it: each shard's ``m`` block starts at 0;
    each step all-gathers the blocks, runs ``step`` (default
    :func:`down_seg_step_shard_plain`) per shard for its unscaled
    contributions, reduce-scatters them in shard order and scales each
    block by its ``inv_deg_blk``.  Returns the ``[..., block]`` blocks."""
    from rca_tpu_torch.parallel.collectives import all_gather, psum_scatter

    step = step or down_seg_step_shard_plain
    block = a_ex_full[0].shape[-1] // len(segs)
    devices = [a.device for a in a_ex_full]
    m_blk = [a.new_zeros(a.shape[:-1] + (block,)) for a in a_ex_full]
    for _ in range(steps):
        m_full = all_gather(m_blk, devices)
        contrib = [step(m_full[k], a_ex_full[k], decay, segs[k])
                   for k in range(len(segs))]
        m_blk = [c * inv for c, inv in zip(psum_scatter(contrib, devices),
                                           inv_deg_blk)]
    return m_blk


def up_seg_steps_shard_plain(h, decay: float, steps: int, segs, out=None):
    """The explain-away recursion of the shards ``segs`` (their up
    layouts) on ``h``'s device in plain PyTorch: the per-step composition
    (:func:`up_shard_recursion` with the plain per-shard step and the
    collectives), joined into ``[..., n_pad]``; ``out`` receives it."""
    u = torch.cat(up_shard_recursion([h] * len(segs), decay, steps, segs),
                  dim=-1)
    return u if out is None else out.copy_(u)


def down_seg_steps_shard_plain(a_ex, decay: float, steps: int, segs,
                               inv_deg, out=None):
    """The impact recursion of the shards ``segs`` (their down layouts) on
    ``a_ex``'s device in plain PyTorch: the per-step composition
    (:func:`down_shard_recursion`, ``inv_deg`` ``[n_pad]`` cut into the
    shards' blocks), joined into ``[..., n_pad]``."""
    block = a_ex.shape[-1] // len(segs)
    m = torch.cat(down_shard_recursion(
        [a_ex] * len(segs), decay, steps, segs,
        [inv_deg[k * block:(k + 1) * block] for k in range(len(segs))]),
        dim=-1)
    return m if out is None else out.copy_(m)


def launch_shard(name: str, n_seg: int, n_long: int, n_big: int,
                 lanes: int, out, scratch_floats: int, args):
    """One cooperative launch of a shard recursion ``name`` over a layout of
    ``n_seg`` positions and ``lanes`` lanes, on the output's device and
    its current stream, with the leading ``args`` and ``scratch_floats``
    of the stream's scratch.  A refused launch raises: there is no other
    form to fall back to."""
    from rca_tpu_torch.kernels.build import check, library

    device = out.device
    down = name == "seg_down_steps_shard"
    grid = steps_grid(max(1, grid_items(n_seg, n_long, n_big)), lanes,
                      shard_down_cap(device.index) if down
                      else grid_cap(device.index, False))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        scratch = grid_scratch(device, stream, scratch_floats)
        err = getattr(library(), f"rca_{name}")(
            *args, lanes, out.shape[-1], scratch.data_ptr(),
            out.data_ptr(), *grid, stream)
    check(err, name)
    count_launch(name, shard=True)
    return out


def up_seg_steps_shard(h, decay: float, steps: int, segs, grid: ShardGrid,
                       out=None):
    """The explain-away recursion of every shard of one device, ``u_0 =
    0``, ``u_{k+1}[s] = max(u_k[s], max over the shard's edges (s, d) of
    max(h[d], decay*u_k[d]))``, returning ``u_steps`` as ``[n_pad]`` or
    ``[B, n_pad]`` lanes (each shard's block at ``k * block``): on CUDA
    tensors one cooperative launch of the ``seg_up_steps_shard`` kernel
    over ``grid`` for every step, shard and lane (none for ``steps ==
    0``), bitwise the per-step composition; on CPU tensors
    :func:`up_seg_steps_shard_plain` over the shards' layouts ``segs``."""
    steps = _step_count("seg_up_steps_shard", steps)
    lanes, n_pad = check_step("seg_up_steps_shard", grid.reach_offsets,
                              out, {"h": h})
    if not lanes:
        return up_seg_steps_shard_plain(h, decay, steps, segs, out=out)
    out = torch.empty_like(h) if out is None else out
    if steps == 0:
        return out.zero_()
    return launch_shard(
        "seg_up_steps_shard", n_pad, grid.up_n_long, grid.up_n_big, lanes,
        out, 2 * lanes * n_pad,
        (h.data_ptr(), as_float32(decay), steps, grid.up_seg.data_ptr(),
         grid.up_offsets.data_ptr(), grid.up_other.data_ptr(),
         grid.up_n_long, grid.up_n_big))


def down_seg_steps_shard(a_ex, decay: float, steps: int, segs,
                         grid: ShardGrid, inv_deg, out=None):
    """The impact recursion of every shard of one device, ``m_0 = 0``,
    ``m_{k+1}[i] = inv_deg[i] * (c_0[i] + c_1[i] + ... + c_{sp-1}[i])``
    with ``c_j[d]`` the sum over shard ``j``'s edges ``(s, d)`` of
    ``a_ex[s] + decay*m_k[s]``, the shards added in that order, returning
    ``m_steps`` as ``[n_pad]`` or ``[B, n_pad]`` lanes (``inv_deg``
    ``[n_pad]``, shared): on CUDA tensors one cooperative launch of the
    ``seg_down_steps_shard`` kernel over ``grid`` (none for ``steps ==
    0``), bitwise the per-step composition; on CPU tensors
    :func:`down_seg_steps_shard_plain`."""
    steps = _step_count("seg_down_steps_shard", steps)
    lanes, n_pad = check_step("seg_down_steps_shard", grid.reach_offsets,
                              out, {"a_ex": a_ex}, {"inv_deg": inv_deg})
    if not lanes:
        return down_seg_steps_shard_plain(a_ex, decay, steps, segs, inv_deg,
                                          out=out)
    out = torch.empty_like(a_ex) if out is None else out
    if steps == 0:
        return out.zero_()
    pairs = grid.pairs
    return launch_shard(
        "seg_down_steps_shard", pairs, grid.dn_n_long, grid.dn_n_big, lanes,
        out, lanes * (n_pad + pairs),
        (a_ex.data_ptr(), inv_deg.data_ptr(), as_float32(decay), steps,
         grid.dn_seg.data_ptr(), grid.dn_offsets.data_ptr(),
         grid.dn_other.data_ptr(), pairs, grid.dn_n_long, grid.dn_n_big,
         grid.reach_offsets.data_ptr(), grid.reach.data_ptr()))


# -- the recursions over distinct cards (csrc/segpeer.cu) ---------------------

#: cards one peer launch reaches (``csrc/segpeer.cu``'s ``kMaxCards``)
MAX_PEER_CARDS = 16
#: the bound of one wait at the peer recursions' barrier across the cards:
#: past it the kernel traps, the context is lost and the next CUDA call
#: raises (a peer that never arrives cannot hang the caller)
PEER_WAIT_NS = 2_000_000_000


class PeerSeg(NamedTuple):
    """One card's layout of one recursion in the grid recursions' item
    order (:func:`item_layout`, real edges only): ``seg`` the positions'
    segments as global node ids (up: the card's own sources; down: the
    destinations its edges reach, one (card, destination) pair a
    position), ``offsets`` / ``other`` their CSR, ``n_long`` long and the
    first ``n_big`` big.  numpy on the host; :meth:`to` moves it."""

    seg: np.ndarray        # int32 [n_seg]
    offsets: np.ndarray    # int32 [n_seg + 1]
    other: np.ndarray      # int32 [e_k]
    n_long: int
    n_big: int

    @property
    def n_seg(self) -> int:
        return self.seg.shape[0]

    def to(self, device) -> "PeerSeg":
        return PeerSeg(*(torch.from_numpy(f).to(device)
                         if isinstance(f, np.ndarray) else f for f in self))


def build_peer_layouts(up_offsets, up_other, dn_offsets, dn_other) -> tuple:
    """Each card's ``(up, down)`` :class:`PeerSeg` of ``sp`` shards, one a
    card, from their per-shard CSR layouts (``ShardedSegLayouts``'
    ``[sp, ...]`` fields): card ``k``'s part of :func:`build_shard_grid`'s
    joined layouts, in the same item order."""
    block = up_offsets.shape[1] - 1
    out = []
    for k in range(len(up_offsets)):
        up = _joined_items(up_other[k][:up_offsets[k][-1]],
                           np.diff(up_offsets[k]))
        counts = np.diff(dn_offsets[k])
        reached = np.flatnonzero(counts)
        dn = _joined_items(dn_other[k][:dn_offsets[k][-1]], counts[reached])
        out.append((PeerSeg((up[0] + k * block).astype(np.int32), *up[1:]),
                    PeerSeg(reached[dn[0]].astype(np.int32), *dn[1:])))
    return tuple(out)


# The peer launches' streams and cards.  Every launch of the peer form is
# enqueued under _PEER_LOCK on one dedicated stream per card, shared by
# every thread, so the sp launches of one recursion sit back to back in
# every card's queue and no card holds a peer launch behind another's that
# waits for it.
_PEER_LOCK = make_lock("segscan._PEER_LOCK")
_PEER_STREAMS: dict = {}
_PEER_GROUPS: dict = {}


class PeerGroup:
    """The cards of one peer row, one shard a card, shared by every graph
    that runs on them: each card's dedicated launch stream; its flag words
    (``MAX_PEER_CARDS`` int32, zeroed and synchronized once, before any
    card stores into them) and the barrier count the next launch numbers
    from; and the buffers the peers store into, each card's up copy of
    ``w`` and inbox (two halves of ``floats`` each, ``floats`` the
    capacity, so that the halves sit at the same place whatever a
    launch's width) and impact copy of ``w`` (``floats``), with their
    pointer tables and parities, which run on across launches.  Those
    buffers come from an allocation stream of their own and are never
    freed (an outgrown set is kept): memory that a peer may still write
    is never handed to anything else.  Peer access is granted for every
    ordered pair of cards through PyTorch's own copy path, which also
    maps the caching allocator's segments for the peer."""

    def __init__(self, devices):
        self.devices = tuple(devices)
        for i in self.devices:
            for j in self.devices:
                if i != j:
                    torch.empty(1, device=j).copy_(torch.empty(1, device=i))
        self.streams = []
        for d in self.devices:
            if d.index not in _PEER_STREAMS:
                _PEER_STREAMS[d.index] = torch.cuda.Stream(device=d)
            self.streams.append(_PEER_STREAMS[d.index])
        self.alloc = [torch.cuda.Stream(device=d) for d in self.devices]
        self.flags = []
        for d, s in zip(self.devices, self.alloc):
            with torch.cuda.stream(s):
                self.flags.append(torch.zeros(MAX_PEER_CARDS,
                                              dtype=torch.int32, device=d))
        for d in self.devices:
            torch.cuda.synchronize(d)
        self.flag_table = _pointers(self.flags)
        self.epoch = 0
        self.up_parity = 0
        self.dn_parity = 0
        self.floats = 0
        self.retired: list = []

    def ensure(self, floats: int) -> None:
        """Exchange buffers for ``floats`` = lanes x n_pad (a power of two
        at least that; under the peer lock)."""
        if floats <= self.floats:
            return
        cap = 1 << (floats - 1).bit_length()
        if self.floats:
            self.retired.append((self.up_w, self.dn_w, self.inbox))
        self.up_w, self.dn_w, self.inbox = [], [], []
        for d, s in zip(self.devices, self.alloc):
            with torch.cuda.stream(s):
                self.up_w.append(torch.empty(2 * cap, device=d))
                self.dn_w.append(torch.empty(cap, device=d))
                self.inbox.append(torch.empty(2 * cap, device=d))
        self.tables = {name: _pointers(getattr(self, name))
                       for name in ("up_w", "dn_w", "inbox")}
        self.floats = cap


def _pointers(tensors):
    return (ctypes.c_ulonglong * len(tensors))(*(t.data_ptr()
                                                 for t in tensors))


def peer_group(devices) -> PeerGroup:
    """The :class:`PeerGroup` of one device list (made once, synchronizing
    its cards once)."""
    devices = tuple(torch.device(d) for d in devices)
    key = tuple(str(d) for d in devices)
    with _PEER_LOCK:
        if key not in _PEER_GROUPS:
            _PEER_GROUPS[key] = PeerGroup(devices)
        return _PEER_GROUPS[key]


class PeerGrid(NamedTuple):
    """The ``peer`` form's state of one ``dp`` row of one graph, one shard
    a card: each card's up and down :class:`PeerSeg` on its card; on CUDA
    devices the cards' :class:`PeerGroup` and each card's dense impact
    contributions (``contrib``, ``[B, n_pad]`` on its launch stream, zero
    where the card reaches nothing, kept between launches and grown where
    a call needs more lanes; only the card itself writes them).  The CPU
    holds no group: the wrappers compute their plain versions there."""

    up: tuple
    dn: tuple
    group: "PeerGroup | None" = None
    contrib: "list | None" = None


def peer_grid(layouts, devices) -> PeerGrid:
    """The :class:`PeerGrid` of :func:`build_peer_layouts`' ``layouts`` on
    ``devices`` (one a card)."""
    devices = [torch.device(d) for d in devices]
    up = tuple(lay[0].to(d) for lay, d in zip(layouts, devices))
    dn = tuple(lay[1].to(d) for lay, d in zip(layouts, devices))
    if devices[0].type != "cuda":
        return PeerGrid(up, dn)
    return PeerGrid(up, dn, peer_group(devices), [None] * len(devices))


def _contrib(peer: PeerGrid, k: int, floats: int) -> torch.Tensor:
    """Card ``k``'s contributions of at least ``floats`` (under the peer
    lock)."""
    have = peer.contrib[k]
    if have is None or have.numel() < floats:
        with torch.cuda.stream(peer.group.streams[k]):
            peer.contrib[k] = torch.zeros(floats,
                                          device=peer.group.devices[k])
    return peer.contrib[k]


@functools.lru_cache(maxsize=None)
def peer_cap(device_index: int, down: bool) -> int:
    """The most CTAs of the ``down`` (else up) peer recursion that CUDA
    device ``device_index`` holds at once; read once per device."""
    from rca_tpu_torch.kernels.build import check, library

    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        check(library().rca_seg_steps_peer_cap(int(down), ctypes.byref(out)),
              "seg_steps_peer co-resident bound")
    return out.value


def _peer_lanes(name: str, plan, vectors: dict, shared: dict = None) -> int:
    """The peer wrappers' input contract, card by card (:func:`check_step`
    with each card's block at ``k * block`` of its full vectors, the
    ``shared`` ones ``[block]``): lanes as :func:`check_step` gives them,
    equal on every card."""
    got = set()
    for k, seg in enumerate(plan.up):
        lanes, n_val = check_step(
            name, seg.offsets, None,
            {key: v[k] for key, v in vectors.items()},
            {key: v[k] for key, v in (shared or {}).items()},
            base=k * (seg.offsets.shape[0] - 1))
        got.add((lanes, n_val, tuple(next(iter(vectors.values()))[k].shape)))
    if len(got) != 1 or next(iter(got))[1] != plan.n_pad:
        raise ValueError(f"{name}: the cards' vectors differ or are not "
                         f"[{plan.n_pad}] lanes: {sorted(got)}")
    return next(iter(got))[0]


def launch_peer(name: str, peer: PeerGrid, steps: int, lanes: int,
                n_pad: int, outs, card_args):
    """The cooperative launches of one peer recursion ``name``, one a card,
    enqueued back to back under the peer lock on the cards' dedicated
    streams, each after its card's current stream and before it again (no
    host sync), each counted once.  ``card_args(k, epoch, parity)``: card
    ``k``'s leading arguments (:func:`up_peer_args` /
    :func:`down_peer_args`; the impact's contributions follow them).  A
    refused launch raises: there is no other form to fall back to (the
    launches already made then trap at their first barrier)."""
    from rca_tpu_torch.kernels.build import check, library
    from rca_tpu_torch.parallel.collectives import count_moved

    entry = getattr(library(), f"rca_{name}")
    down = name == "seg_down_steps_peer"
    group = peer.group
    segs = peer.dn if down else peer.up
    grids = [steps_grid(max(1, grid_items(seg.n_seg, seg.n_long, seg.n_big)),
                        lanes, peer_cap(d.index, down))
             for seg, d in zip(segs, group.devices)]
    floats = lanes * n_pad
    with _PEER_LOCK:
        group.ensure(floats)
        epoch = group.epoch
        parity = group.dn_parity if down else group.up_parity
        for k, (d, stream) in enumerate(zip(group.devices, group.streams)):
            stream.wait_stream(torch.cuda.current_stream(d))
            args = card_args(k, epoch, parity)
            if down:
                args += (_contrib(peer, k, floats).data_ptr(),)
            with torch.cuda.device(d):
                err = entry(*args, outs[k].data_ptr(), *grids[k],
                            stream.cuda_stream)
            check(err, name)
            count_launch(name, shard=True)
        for d, stream in zip(group.devices, group.streams):
            torch.cuda.current_stream(d).wait_stream(stream)
        # the barriers the launches numbered, and the buffers they pushed
        group.epoch = (epoch + (2 * steps - 1 if down else steps - 1)) \
            & 0xFFFFFFFF
        if down:
            group.dn_parity += steps
        else:
            group.up_parity += steps - 1
    # what the launches moved between the cards, under the collectives'
    # kinds: each step's contributions as the reduce-scatter moves them,
    # and each pushed block of w as the all-gather moves it
    sp = len(group.devices)
    per_push = (sp - 1) * lanes * n_pad * 4
    count_moved("all_gather", (steps - 1) * per_push)
    if down:
        count_moved("reduce_scatter", steps * per_push)
    return outs


def up_seg_steps_peer_plain(h_full, decay: float, steps: int, plan):
    """The explain-away recursion of the plan's shards in plain PyTorch:
    the per-step composition, :func:`up_shard_recursion` with the plain
    per-shard step.  Returns each shard's ``[..., block]`` block."""
    return up_shard_recursion(h_full, decay, steps, plan.up)


def down_seg_steps_peer_plain(a_ex_full, decay: float, steps: int, plan,
                              inv_deg_blk):
    """The impact recursion of the plan's shards in plain PyTorch:
    :func:`down_shard_recursion` with the plain per-shard step."""
    return down_shard_recursion(a_ex_full, decay, steps, plan.dn,
                                inv_deg_blk)


def up_seg_steps_peer(h_full, decay: float, steps: int, plan):
    """The explain-away recursion of a ``peer`` plan's shards, one a card,
    ``u_0 = 0``, ``u_{k+1}[s] = max(u_k[s], max over the shard's edges
    (s, d) of max(h[d], decay*u_k[d]))``, from each card's full ``[n_pad]``
    (or ``[B, n_pad]``) ``h_full[k]``, returning each card's ``[...,
    block]`` block of ``u_steps``: on CUDA tensors one cooperative launch
    of the ``seg_up_steps_peer`` kernel a card for every step and lane
    (none for ``steps == 0``), the blocks exchanged through peer memory,
    bitwise the per-step composition; on CPU tensors
    :func:`up_seg_steps_peer_plain`."""
    steps = _step_count("seg_up_steps_peer", steps)
    lanes = _peer_lanes("seg_up_steps_peer", plan, {"h_full": h_full})
    if not lanes:
        return up_seg_steps_peer_plain(h_full, decay, steps, plan)
    block = plan.block
    outs = [h.new_empty(h.shape[:-1] + (block,)) for h in h_full]
    if steps == 0:
        return [o.zero_() for o in outs]
    return launch_peer("seg_up_steps_peer", plan.peer, steps, lanes,
                       plan.n_pad, outs,
                       up_peer_args(plan, h_full, decay, steps, lanes))


def up_peer_args(plan, h_full, decay: float, steps: int, lanes: int,
                 wait_ns: int = PEER_WAIT_NS):
    """``card_args(k, epoch, parity)``: card ``k``'s leading arguments of
    ``rca_seg_up_steps_peer`` (through the barrier's wait bound) for
    :func:`launch_peer`, read from the group under the peer lock."""
    peer, sp, gamma = plan.peer, len(h_full), as_float32(decay)
    group = peer.group

    def card_args(k, epoch, parity):
        seg = peer.up[k]
        return (h_full[k].data_ptr(), gamma, steps, seg.seg.data_ptr(),
                seg.offsets.data_ptr(), seg.other.data_ptr(), seg.n_seg,
                seg.n_long, seg.n_big, lanes, plan.n_pad, k, sp,
                ctypes.addressof(group.tables["up_w"]),
                ctypes.addressof(group.flag_table), group.floats, epoch,
                parity & 1, wait_ns)

    return card_args


def down_seg_steps_peer(a_ex_full, decay: float, steps: int, plan,
                        inv_deg_blk):
    """The impact recursion of a ``peer`` plan's shards, one a card, ``m_0
    = 0``, ``m_{k+1}[i] = inv_deg[i] * (c_0[i] + c_1[i] + ... +
    c_{sp-1}[i])`` with ``c_j[d]`` the sum over shard ``j``'s edges ``(s,
    d)`` of ``a_ex[s] + decay*m_k[s]``, the shards added in that order,
    from each card's full ``a_ex_full[k]`` and its ``[block]``
    ``inv_deg_blk[k]``, returning each card's block of ``m_steps``: on
    CUDA tensors one cooperative launch of the ``seg_down_steps_peer``
    kernel a card (none for ``steps == 0``), bitwise the per-step
    composition; on CPU tensors :func:`down_seg_steps_peer_plain`."""
    steps = _step_count("seg_down_steps_peer", steps)
    lanes = _peer_lanes("seg_down_steps_peer", plan,
                        {"a_ex_full": a_ex_full}, {"inv_deg": inv_deg_blk})
    if not lanes:
        return down_seg_steps_peer_plain(a_ex_full, decay, steps, plan,
                                         inv_deg_blk)
    block = plan.block
    outs = [a.new_empty(a.shape[:-1] + (block,)) for a in a_ex_full]
    if steps == 0:
        return [o.zero_() for o in outs]
    return launch_peer("seg_down_steps_peer", plan.peer, steps, lanes,
                       plan.n_pad, outs,
                       down_peer_args(plan, a_ex_full, decay, steps, lanes,
                                      inv_deg_blk))


def down_peer_args(plan, a_ex_full, decay: float, steps: int, lanes: int,
                   inv_deg_blk):
    """``card_args(k, epoch, parity)``: card ``k``'s leading arguments of
    ``rca_seg_down_steps_peer`` (through the barrier's wait bound) for
    :func:`launch_peer`, read from the group under the peer lock."""
    peer, sp, gamma = plan.peer, len(a_ex_full), as_float32(decay)
    group = peer.group

    def card_args(k, epoch, parity):
        seg = peer.dn[k]
        return (a_ex_full[k].data_ptr(), inv_deg_blk[k].data_ptr(), gamma,
                steps, seg.seg.data_ptr(), seg.offsets.data_ptr(),
                seg.other.data_ptr(), seg.n_seg, seg.n_long, seg.n_big,
                lanes, plan.n_pad, k, sp,
                ctypes.addressof(group.tables["dn_w"]),
                ctypes.addressof(group.tables["inbox"]),
                ctypes.addressof(group.flag_table), group.floats, epoch,
                parity & 1, PEER_WAIT_NS)

    return card_args
