"""The propagation's evidence front: kernel wrappers and plain versions.

Counterpart of the JAX package's ``engine/pallas_kernels.py`` and of the
front of its ranked propagation (``engine/runner.py::_propagate_ranked``
and ``engine/propagate.py``): the finite-mask sanitize, the noisy-OR
evidence pair and the error-source contrast.

- :func:`evidence_front` is the engine's dense front.  On CUDA tensors
  it is one cooperative launch of the hand-written kernel in
  ``csrc/front.cu`` (counted as ``evidence_front_fused``): the row pass
  (sanitize, the pair, the error rate and the bad-row count over the raw
  features; with ``persist`` also the sanitized rows written back into
  its input, the streaming flush's launch), one grid barrier, then the
  error-source contrast over the up layout (no fold when the contrast's
  weight is 0, as the reference skips it).  On CPU tensors it computes
  :func:`evidence_front_plain`, the reference's composition of
  :func:`finite_mask_rows`, :func:`noisy_or_pair_plain`,
  :func:`error_source_excess` and :func:`fold_error_contrast`.
- :func:`evidence_front_shard` is the node-sharded engine's front where
  every shard of a ``dp`` row lies on one card: one cooperative launch
  of ``csrc/frontshard.cu`` over the shards' separate row buffers and
  their joined up layout, whose joined ``a`` / ``h`` take the place of
  the per-shard launches and the gathers.  On CPU tensors it computes
  :func:`evidence_front_shard_plain`, the per-shard composition.
- The front's two halves stay as launches of their own: the row pass in
  ``csrc/evidence.cu`` (:func:`evidence_front_rows`) and the contrast
  step in ``csrc/segstep.cu`` (:func:`seg_contrast_step`,
  :func:`seg_contrast_step_shard`).  The node-sharded engine runs them
  between its collectives where its shards span cards, and the fused
  launches are bitwise equal to the two in a row.
- :func:`noisy_or_pair` is the twin of the reference's public
  ``noisy_or_pair_pallas``: the pair alone, one kernel launch on a CUDA
  tensor, :func:`noisy_or_pair_plain` on a CPU tensor.  The engine does
  not call it.

The source notes in ``csrc/`` say what bounds each kernel.  There is no
fallback between a kernel and its plain version.

The pair is, over row-major ``[S, C]`` features,

    a = 1 - prod_c (1 - clip(f_c, 0, 1) * wa_c),   h likewise with wh,

with the rounding of the reference's compiled propagation on the CPU:
every factor ``1 - x*w`` but the last rounded once (XLA contracts it to a
fused multiply-add), the last one multiplied then subtracted, the factors
multiplied left to right in float32, then ``1 - p``.  ``h`` feeds the
order-free max of the up-scan, so matching its bits makes ``u`` bit-equal
to the reference's.  The plain version gets each fused factor's single
rounding by computing it in float64, where ``x*w`` of two float32 values
is exact; only a float64 result that lands exactly on a float32 rounding
midpoint (odds near 2**-29 per factor) can round differently from the
kernel's true fused multiply-add.  The contrast's kernel spells the plain
version's separate torch ops one rounding each, and its dependency max is
exact in any order, so the front's ``a`` is bit-equal to the plain
version's too.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from rca_tpu_torch.engine.segscan import (
    SegLayout,
    ShardSeg,
    as_float32,
    check_step,
    launch_step,
    scatter_max,
    segment_totals,
)
from rca_tpu_torch.features.schema import SvcF
from rca_tpu_torch.kernels import count_launch

#: the widest feature row the kernels take (their weights sit in shared
#: memory)
MAX_CHANNELS = 32
#: rows per tile of the fused front's row pass, which is also its threads
#: per CTA and the short segments one CTA of its contrast reduces
FRONT_TILE_ROWS = 256


def clip01(x: torch.Tensor) -> torch.Tensor:
    """``clip(x, 0, 1)`` spelled as ``jnp.clip`` computes it, a max then a
    min: the same values as ``torch.clamp``, and the same gradient, which
    splits a tie evenly (0.5 at exactly 0 or 1, where ``torch.clamp``
    passes 1).  Most feature values are exactly 0, so the saliency of the
    ``torch`` row depends on it."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def noisy_or_plain(features: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """One noisy-OR over row-major ``[..., S, C]`` float32 features."""
    x = clip01(features)
    # every factor but the last as fma(-x, w, 1): x*w of two float32
    # values is exact in float64, so the difference rounds once
    terms = (1.0 - x.double() * weights.double()).float()
    terms[..., -1] = 1.0 - x[..., -1] * weights[-1]
    p = terms[..., 0]
    for c in range(1, terms.shape[-1]):
        p = p * terms[..., c]
    return 1.0 - p


def noisy_or_pair_plain(features, anomaly_w, hard_w):
    """``(a, h)``, the plain PyTorch version of the evidence kernel."""
    return noisy_or_plain(features, anomaly_w), noisy_or_plain(features, hard_w)


def finite_mask_rows(features: torch.Tensor):
    """Zero every feature row carrying a NaN/Inf; return ``(clean, n_bad)``
    with ``n_bad`` a 0-dim int32 tensor on the features' device (fetched
    with the top-k, so the sanitize costs no extra sync), counting across
    every lane of ``[B, S, C]`` features."""
    ok = torch.isfinite(features).all(dim=-1, keepdim=True)
    clean = torch.where(ok, features, torch.zeros_like(features))
    n_bad = (~ok).sum(dtype=torch.int32)
    return clean, n_bad


def error_rate(features: torch.Tensor) -> torch.Tensor:
    """``clip(f[..., ERROR_RATE], 0, 1)``, the contrast's per-node signal."""
    return clip01(features[..., SvcF.ERROR_RATE])


def error_source_excess(e: torch.Tensor, dep_src: torch.Tensor,
                        dep_dst: torch.Tensor) -> torch.Tensor:
    """Per-node error rate in excess of its dependencies' max,
    ``relu(e - max over edges (s, d) of e[d])``, over ``[..., S]`` lanes.
    Padded edges self-loop on the dummy slot whose error rate is 0 (the
    max's identity here).  The max over the zero-initialised rows and the
    relu split a tie's gradient evenly, as ``.at[].max`` and
    ``jnp.maximum`` do."""
    dep_max = scatter_max(e, dep_src, e[..., dep_dst])
    return torch.maximum(e - dep_max, e.new_zeros(()))


def fold_error_contrast(a, err_src, weight: float):
    """Noisy-OR the error-source contrast into the anomaly evidence."""
    return 1.0 - (1.0 - a) * (1.0 - weight * err_src)


def segment_sources(seg: SegLayout) -> torch.Tensor:
    """The segment of each sorted edge of ``seg`` (int64 ``[e_pad]``): with
    ``other_sorted`` the layout's edges, for the up layout ``(dep_src,
    dep_dst)`` in sorted order."""
    counts = (seg.offsets[1:] - seg.offsets[:-1]).long()
    ids = torch.arange(counts.shape[0], device=counts.device)
    return torch.repeat_interleave(ids, counts,
                                   output_size=seg.other_sorted.shape[0])


def seg_contrast_step_plain(a_raw, e, weight: float, seg: SegLayout):
    """The error-source contrast in plain PyTorch over the up layout's
    edges: :func:`error_source_excess` folded into ``a_raw``."""
    err_src = error_source_excess(e, segment_sources(seg), seg.other_sorted)
    return fold_error_contrast(a_raw, err_src, weight)


def evidence_front_rows_plain(features, anomaly_w, hard_w,
                              persist: bool = False):
    """``(a_raw, h, e, n_bad)``: the row pass in plain PyTorch, over the
    sanitized features; ``persist`` copies the sanitized matrix back into
    ``features``."""
    clean, n_bad = finite_mask_rows(features)
    if persist:
        features.copy_(clean)
    a_raw, h = noisy_or_pair_plain(clean, anomaly_w, hard_w)
    return a_raw, h, error_rate(clean), n_bad


def evidence_front_plain(features, anomaly_w, hard_w, error_contrast: float,
                         up_seg: SegLayout, persist: bool = False):
    """``(a, h, n_bad)`` from the raw padded features: the reference's
    front in plain PyTorch (``persist``: the sanitized rows are copied
    back into ``features``)."""
    a, h, e, n_bad = evidence_front_rows_plain(features, anomaly_w, hard_w,
                                               persist)
    if error_contrast:
        a = seg_contrast_step_plain(a, e, error_contrast, up_seg)
    return a, h, n_bad


def _check(features, anomaly_w, hard_w):
    if features.dim() not in (2, 3):
        raise ValueError(f"features must be [S, C] or [B, S, C], got "
                         f"{tuple(features.shape)}")
    n_channels = features.shape[-1]
    for name, t in (("features", features), ("anomaly_w", anomaly_w),
                    ("hard_w", hard_w)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != features.device:
            raise ValueError(f"{name} is on {t.device}, features on "
                             f"{features.device}")
    for name, w in (("anomaly_w", anomaly_w), ("hard_w", hard_w)):
        if tuple(w.shape) != (n_channels,):
            raise ValueError(f"{name} must be [{n_channels}], got "
                             f"{tuple(w.shape)}")
    if features.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no evidence kernel for device {features.device}")
    return features.device.type == "cuda"


def noisy_or_pair(features: torch.Tensor, anomaly_w: torch.Tensor,
                  hard_w: torch.Tensor):
    """``(a, h)`` evidence vectors from float32 ``[S, C]`` features: the
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if not _check(features, anomaly_w, hard_w):
        return noisy_or_pair_plain(features, anomaly_w, hard_w)
    from rca_tpu_torch.kernels.build import check, library

    features = features.contiguous()
    anomaly_w = anomaly_w.contiguous()
    hard_w = hard_w.contiguous()
    n_channels = features.shape[-1]
    n_rows = features.numel() // n_channels
    a = torch.empty(features.shape[:-1], dtype=torch.float32,
                    device=features.device)
    h = torch.empty_like(a)
    if n_rows == 0:
        return a, h
    stream = torch.cuda.current_stream(features.device).cuda_stream
    err = library().rca_noisy_or_pair(
        features.data_ptr(), anomaly_w.data_ptr(), hard_w.data_ptr(),
        a.data_ptr(), h.data_ptr(), n_rows, n_channels, stream,
    )
    check(err, "noisy_or_pair")
    count_launch("noisy_or_pair")
    return a, h


def _check_rows(features, anomaly_w, hard_w):
    on_card = _check(features, anomaly_w, hard_w)
    if not SvcF.ERROR_RATE < features.shape[-1] <= MAX_CHANNELS:
        raise ValueError(f"the front takes {SvcF.ERROR_RATE + 1} to "
                         f"{MAX_CHANNELS} channels, got {features.shape[-1]}")
    return on_card


def evidence_front_rows(features: torch.Tensor, anomaly_w: torch.Tensor,
                        hard_w: torch.Tensor, persist: bool = False):
    """``(a_raw, h, e, n_bad)`` from raw float32 ``[S, C]`` features, or
    ``[B, S, C]`` lanes, the sanitize included: one launch of the
    ``evidence_front`` kernel on a CUDA tensor (lanes are B*S rows of one
    row pass), :func:`evidence_front_rows_plain` on a CPU tensor.  The
    vectors are ``[S]`` or ``[B, S]``; ``n_bad`` is a 0-dim int32 tensor
    counting across the lanes.  ``persist``: every bad row of ``features``
    (which must be contiguous) is also zeroed in place, as the sanitize
    left it."""
    on_card = _check_rows(features, anomaly_w, hard_w)
    if persist and not features.is_contiguous():
        raise ValueError("evidence_front: a persisting launch writes its "
                         "input in place, which must be contiguous")
    if not on_card:
        return evidence_front_rows_plain(features, anomaly_w, hard_w,
                                         persist)
    from rca_tpu_torch.kernels.build import check, library

    features = features.contiguous()
    anomaly_w = anomaly_w.contiguous()
    hard_w = hard_w.contiguous()
    n_channels = features.shape[-1]
    n_rows = features.numel() // n_channels
    a_raw, h, e = (torch.empty(features.shape[:-1], dtype=torch.float32,
                               device=features.device) for _ in range(3))
    if n_rows == 0:
        return a_raw, h, e, torch.zeros((), dtype=torch.int32,
                                        device=features.device)
    n_bad = torch.empty((), dtype=torch.int32, device=features.device)
    with torch.cuda.device(features.device):
        stream = torch.cuda.current_stream(features.device).cuda_stream
        err = library().rca_evidence_front(
            features.data_ptr(), anomaly_w.data_ptr(), hard_w.data_ptr(),
            a_raw.data_ptr(), h.data_ptr(), e.data_ptr(), n_bad.data_ptr(),
            n_rows, n_channels, int(SvcF.ERROR_RATE), int(persist), stream,
        )
    check(err, "evidence_front")
    count_launch("evidence_front", persist=bool(persist))
    return a_raw, h, e, n_bad


def seg_contrast_step(a_raw: torch.Tensor, e: torch.Tensor, weight: float,
                      seg: SegLayout) -> torch.Tensor:
    """``a = 1 - (1 - a_raw) * (1 - weight * relu(e - dep_max))`` with
    ``dep_max[s]`` the max of ``e`` over the dependencies of ``s`` in the
    up layout ``seg``, on ``[S]`` vectors or ``[B, S]`` lanes: one launch
    of the ``seg_contrast_step`` kernel for all lanes on CUDA tensors,
    :func:`seg_contrast_step_plain` on CPU tensors."""
    lanes, _ = check_step("seg_contrast_step", seg.offsets, None,
                          {"a_raw": a_raw, "e": e})
    if not lanes:
        return seg_contrast_step_plain(a_raw, e, weight, seg)
    return launch_step("rca_seg_contrast_step", "seg_contrast_step", seg,
                       lanes, torch.empty_like(a_raw), a_raw.data_ptr(),
                       e.data_ptr(), as_float32(weight))


def seg_contrast_step_shard_plain(a_raw, e_full, weight: float,
                                  seg: ShardSeg, base: int):
    """One shard's error-source contrast in plain PyTorch, the reference's
    per-block form: the masked gather of the dependencies' error rates
    from the full gathered ``e``, a flagged segmented MAX over the shard's
    src-sorted edges, then :func:`fold_error_contrast` of ``relu(e[base +
    s] - dep_max)`` into the shard's own ``a_raw``."""
    n_seg = seg.ends.shape[0]
    dep_max = segment_totals(seg.mask * e_full[..., seg.other_sorted], seg,
                             "max")
    e_own = e_full[..., base:base + n_seg]
    return fold_error_contrast(
        a_raw, torch.maximum(e_own - dep_max, e_own.new_zeros(())), weight)


def seg_contrast_step_shard(a_raw: torch.Tensor, e_full: torch.Tensor,
                            weight: float, seg: ShardSeg,
                            base: int) -> torch.Tensor:
    """One shard's contrast: the shard's ``[block]`` (or ``[B, block]``)
    ``a_raw`` folded with the excess of its own error rate
    ``e_full[base + s]`` over its dependencies' max, read from the full
    gathered ``e``: on CUDA tensors one launch of the
    ``seg_contrast_step`` kernel's per-shard entry, on CPU tensors
    :func:`seg_contrast_step_shard_plain`."""
    lanes, n_val = check_step("seg_contrast_step", seg.offsets, None,
                              {"e_full": e_full}, local={"a_raw": a_raw},
                              base=base)
    if not lanes:
        return seg_contrast_step_shard_plain(a_raw, e_full, weight, seg,
                                             base)
    return launch_step("rca_seg_contrast_step_shard", "seg_contrast_step",
                       seg, lanes, torch.empty_like(a_raw),
                       a_raw.data_ptr(), e_full.data_ptr(),
                       as_float32(weight), int(base), n_val, shard=True)


def front_grid(n_rows: int, lanes: int, n_long: int, n_short: int,
               fold: bool, cap: int, shards: int = 1) -> int:
    """CTAs of a fused front's cooperative launch: as many as its work
    has items, the row pass's tiles of ``n_rows`` rows (counted per shard
    of ``n_rows / shards`` rows: the sharded front's tiles never straddle
    two shards' buffers) or, where the contrast runs (``fold``), its
    ``lanes`` x (the ``n_long`` long segments + the blocks of ``n_short``
    short ones) if there are more, and never more than ``cap``, the CTAs
    that can be resident at once (every CTA of a cooperative launch must
    be)."""
    if cap < 1:
        raise ValueError(f"evidence_front_fused: no CTA of the front fits "
                         f"the device (co-resident bound {cap})")
    tiles = shards * -(-(n_rows // shards) // FRONT_TILE_ROWS)
    segments = lanes * (n_long + -(-n_short // FRONT_TILE_ROWS)) if fold \
        else 0
    return min(max(tiles, segments, 1), cap)


_ERR_COL = int(SvcF.ERROR_RATE)


#: each front's co-resident bound query: its C entry and the arguments
#: before the result (the fused front reading or persisting, the sharded
#: front)
_FRONT_CAPS = {"fused": ("rca_evidence_front_fused_cap", (0,)),
               "persist": ("rca_evidence_front_fused_cap", (1,)),
               "shard": ("rca_evidence_front_shard_cap", ())}


@functools.lru_cache(maxsize=None)
def front_cap(device_index: int, n_channels: int, kernel: str) -> int:
    """The most CTAs of the front ``kernel`` (``"fused"``, the fused front;
    ``"persist"``, its persisting form; ``"shard"``, the sharded front)
    that CUDA device ``device_index`` holds at once, from the kernel
    library's occupancy query; read once per device, width and kernel."""
    from rca_tpu_torch.kernels.build import check, library

    entry, lead = _FRONT_CAPS[kernel]
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = getattr(library(), entry)(n_channels, *lead, ctypes.byref(out))
        check(err, f"evidence_front {kernel} co-resident bound")
    return out.value


def evidence_front(features: torch.Tensor, anomaly_w: torch.Tensor,
                   hard_w: torch.Tensor, error_contrast: float,
                   up_seg: SegLayout, persist: bool = False):
    """``(a, h, n_bad)`` from the RAW padded ``[n_pad, C]`` features, or
    ``[B, n_pad, C]`` lanes, over the up layout ``up_seg`` (its tensors on
    the features' device): on CUDA tensors one launch of the
    ``evidence_front_fused`` kernel for all lanes, bitwise
    :func:`evidence_front_rows` then, unless ``error_contrast`` is 0,
    :func:`seg_contrast_step`; on CPU tensors
    :func:`evidence_front_plain`.  ``a`` and ``h`` are views of one
    buffer; ``n_bad`` is a 0-dim int32 tensor counting across the lanes.
    ``persist`` leaves the sanitized rows in ``features`` (the streaming
    flush), which must then be contiguous."""
    on_card = _check_rows(features, anomaly_w, hard_w)
    if not isinstance(up_seg.offsets, torch.Tensor):
        raise TypeError("evidence_front: the layout is on the host; move it "
                        "with .to(device)")
    if up_seg.offsets.device != features.device:
        raise ValueError(f"evidence_front: layout on {up_seg.offsets.device}"
                         f", features on {features.device}")
    n_pad = up_seg.offsets.shape[0] - 1
    if n_pad != features.shape[-2]:
        raise ValueError(f"evidence_front: layout of {n_pad} segments, "
                         f"features of {features.shape[-2]} rows")
    if persist and not features.is_contiguous():
        raise ValueError("evidence_front: a persisting launch writes its "
                         "input in place, which must be contiguous")
    if not on_card:
        return evidence_front_plain(features, anomaly_w, hard_w,
                                    error_contrast, up_seg, persist)
    from rca_tpu_torch.kernels.build import check, library

    features = features.contiguous()
    anomaly_w = anomaly_w.contiguous()
    hard_w = hard_w.contiguous()
    n_channels = features.shape[-1]
    n_rows = features.numel() // n_channels
    device = features.device
    out = torch.empty((3,) + features.shape[:-1], dtype=torch.float32,
                      device=device)
    a, h, e = out[0], out[1], out[2]
    if n_rows == 0:
        return a, h, torch.zeros((), dtype=torch.int32, device=device)
    fold = bool(error_contrast)
    n_long = up_seg.long_ids.shape[0]
    n_short = up_seg.short_ids.shape[0]
    with torch.cuda.device(device):
        grid = front_grid(n_rows, n_rows // n_pad, n_long, n_short, fold,
                          front_cap(device.index, n_channels,
                                    "persist" if persist else "fused"))
        counts = torch.empty(grid + 1, dtype=torch.int32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = library().rca_evidence_front_fused(
            features.data_ptr(), anomaly_w.data_ptr(), hard_w.data_ptr(),
            a.data_ptr(), h.data_ptr(), e.data_ptr(), counts.data_ptr(),
            n_rows // n_pad, n_pad, n_channels, _ERR_COL,
            as_float32(error_contrast) if fold else 0.0, int(fold),
            int(persist), up_seg.offsets.data_ptr(),
            up_seg.other32.data_ptr(), up_seg.long_ids.data_ptr(), n_long,
            up_seg.short_ids.data_ptr(), n_short, grid, stream,
        )
    check(err, "evidence_front_fused")
    count_launch("evidence_front_fused", persist=bool(persist))
    return a, h, counts[0]


# -- every shard of one card (csrc/frontshard.cu) -----------------------------

#: the most shards one launch of the sharded front takes: its table of the
#: shards' row pointers is a kernel parameter of fixed size
MAX_FRONT_SHARDS = 64


def evidence_front_shard_plain(f_blks, anomaly_w, hard_w,
                               error_contrast: float, segs,
                               rows=evidence_front_rows_plain,
                               contrast=seg_contrast_step_shard_plain):
    """``(a, h)`` joined over the shards, ``[..., sp * block]`` with shard
    ``k``'s block at ``k * block``: the node-sharded engine's per-shard
    front, :func:`evidence_front_rows_plain` per shard block ``f_blks[k]``
    (``[block, C]`` or ``[B, block, C]``), then, unless ``error_contrast``
    is 0, :func:`seg_contrast_step_shard_plain` per shard over the
    concatenated ``e`` and the shard's up layout ``segs[k]``.  ``rows`` and
    ``contrast`` take the place of the two halves when given (on the card:
    their kernels, the composition the one launch replaces)."""
    block = f_blks[0].shape[-2]
    front = [rows(f, anomaly_w, hard_w) for f in f_blks]
    a_blk = [r[0] for r in front]
    if error_contrast:
        e_full = torch.cat([r[2] for r in front], dim=-1)
        a_blk = [contrast(a_blk[k], e_full, error_contrast, segs[k],
                          k * block) for k in range(len(f_blks))]
    return torch.cat(a_blk, dim=-1), torch.cat([r[1] for r in front], dim=-1)


def _check_shard_front(f_blks, anomaly_w, hard_w, segs, grid):
    """The sharded front's contract, held on every device; returns whether
    the blocks are on a CUDA device."""
    sp = len(f_blks)
    if not 1 <= sp <= MAX_FRONT_SHARDS:
        raise ValueError(f"evidence_front_shard: {sp} shards, the launch "
                         f"takes 1 to {MAX_FRONT_SHARDS}")
    if len(segs) != sp:
        raise ValueError(f"evidence_front_shard: {len(segs)} layouts for "
                         f"{sp} shards")
    first = f_blks[0]
    for k, f in enumerate(f_blks):
        if f.device != first.device:
            raise ValueError(f"evidence_front_shard: shard {k} on "
                             f"{f.device}, shard 0 on {first.device}")
        if f.shape != first.shape:
            raise ValueError(f"evidence_front_shard: shard {k} is "
                             f"{tuple(f.shape)}, shard 0 {tuple(first.shape)}")
        if not f.is_contiguous():
            raise ValueError(f"evidence_front_shard: shard {k}'s rows must "
                             f"be contiguous")
    on_card = _check_rows(first, anomaly_w, hard_w)
    if not isinstance(grid.up_offsets, torch.Tensor):
        raise TypeError("evidence_front_shard: the joined layout is on the "
                        "host; move it with .to(device)")
    if grid.up_offsets.device != first.device:
        raise ValueError(f"evidence_front_shard: layout on "
                         f"{grid.up_offsets.device}, rows on {first.device}")
    n_pad = grid.up_offsets.shape[0] - 1
    if n_pad != sp * first.shape[-2]:
        raise ValueError(f"evidence_front_shard: a joined layout of {n_pad} "
                         f"segments for {sp} blocks of {first.shape[-2]} "
                         f"rows")
    return on_card


def evidence_front_shard(f_blks, anomaly_w: torch.Tensor,
                         hard_w: torch.Tensor, error_contrast: float, segs,
                         grid):
    """``(a, h)`` of every shard of one device, joined ``[n_pad]`` (or
    ``[B, n_pad]``) vectors with shard ``k``'s block at ``k * block``,
    from the shards' RAW ``[block, C]`` (or ``[B, block, C]``) rows
    ``f_blks``, contiguous, equal in shape, on one device: on CUDA tensors
    one cooperative launch of the ``evidence_front_shard`` kernel over
    every shard and lane (the row pass, one grid barrier, the contrast
    over ``grid``'s joined up layout, a :class:`ShardGrid`; no fold where
    ``error_contrast`` is 0), bitwise the per-shard composition; on CPU
    tensors :func:`evidence_front_shard_plain` over the shards' up
    layouts ``segs``.  ``a`` and ``h`` are views of one buffer.  A refused
    launch raises: there is no per-shard form to fall back to."""
    if not _check_shard_front(f_blks, anomaly_w, hard_w, segs, grid):
        return evidence_front_shard_plain(f_blks, anomaly_w, hard_w,
                                          error_contrast, segs)
    from rca_tpu_torch.kernels.build import check, library

    first = f_blks[0]
    device = first.device
    sp, block, n_channels = len(f_blks), first.shape[-2], first.shape[-1]
    lanes = first.numel() // (block * n_channels)
    out = torch.empty((3,) + first.shape[:-2] + (sp * block,),
                      dtype=torch.float32, device=device)
    a, h, e = out[0], out[1], out[2]
    if lanes == 0:
        return a, h
    anomaly_w = anomaly_w.contiguous()
    hard_w = hard_w.contiguous()
    fold = bool(error_contrast)
    n_long = grid.up_n_long
    # the shards' row pointers, copied into the kernel's parameters
    table = (ctypes.c_void_p * sp)(*(f.data_ptr() for f in f_blks))
    with torch.cuda.device(device):
        ctas = front_grid(sp * lanes * block, lanes, n_long,
                          sp * block - n_long, fold,
                          front_cap(device.index, n_channels, "shard"),
                          shards=sp)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = library().rca_evidence_front_shard(
            table, sp, block, lanes, anomaly_w.data_ptr(),
            hard_w.data_ptr(), a.data_ptr(), h.data_ptr(),
            e.data_ptr(), n_channels, _ERR_COL,
            as_float32(error_contrast) if fold else 0.0, int(fold),
            grid.up_seg.data_ptr(), grid.up_offsets.data_ptr(),
            grid.up_other.data_ptr(), n_long, ctas, stream,
        )
    check(err, "evidence_front_shard")
    count_launch("evidence_front_shard", shard=True)
    return a, h
