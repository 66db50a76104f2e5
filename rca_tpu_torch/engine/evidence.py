"""The propagation's evidence front: kernel wrappers and plain versions.

Counterpart of the JAX package's ``engine/pallas_kernels.py`` and of the
front of its ranked propagation (``engine/runner.py::_propagate_ranked``
and ``engine/propagate.py``): the finite-mask sanitize, the noisy-OR
evidence pair and the error-source contrast.

- :func:`evidence_front` is the engine's front.  On CUDA tensors it is
  two launches of hand-written kernels: the row pass in
  ``csrc/evidence.cu`` (:func:`evidence_front_rows`: sanitize, the pair,
  the error rate and the bad-row count over the raw features) and the
  contrast step in ``csrc/segstep.cu`` (:func:`seg_contrast_step`,
  skipped when the contrast's weight is 0, as the reference skips it).
  On CPU tensors it computes :func:`evidence_front_plain`, the reference's
  composition of :func:`finite_mask_rows`, :func:`noisy_or_pair_plain`,
  :func:`error_source_excess` and :func:`fold_error_contrast`.
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

import torch

from rca_tpu_torch.engine.segscan import (
    SegLayout,
    as_float32,
    check_step,
    launch_step,
)
from rca_tpu_torch.features.schema import SvcF
from rca_tpu_torch.kernels import LAUNCHES

#: the widest feature row the kernels take (their weights sit in shared
#: memory)
MAX_CHANNELS = 32


def noisy_or_plain(features: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """One noisy-OR over row-major ``[S, C]`` float32 features."""
    x = features.clamp(0.0, 1.0)
    # every factor but the last as fma(-x, w, 1): x*w of two float32
    # values is exact in float64, so the difference rounds once
    terms = (1.0 - x.double() * weights.double()).float()
    terms[:, -1] = 1.0 - x[:, -1] * weights[-1]
    p = terms[:, 0]
    for c in range(1, terms.shape[1]):
        p = p * terms[:, c]
    return 1.0 - p


def noisy_or_pair_plain(features, anomaly_w, hard_w):
    """``(a, h)``, the plain PyTorch version of the evidence kernel."""
    return noisy_or_plain(features, anomaly_w), noisy_or_plain(features, hard_w)


def finite_mask_rows(features: torch.Tensor):
    """Zero every feature row carrying a NaN/Inf; return ``(clean, n_bad)``
    with ``n_bad`` a 0-dim int32 tensor on the features' device (fetched
    with the top-k, so the sanitize costs no extra sync)."""
    ok = torch.isfinite(features).all(dim=-1, keepdim=True)
    clean = torch.where(ok, features, torch.zeros_like(features))
    n_bad = (~ok).sum(dtype=torch.int32)
    return clean, n_bad


def error_rate(features: torch.Tensor) -> torch.Tensor:
    """``clip(f[:, ERROR_RATE], 0, 1)``, the contrast's per-node signal."""
    return features[:, SvcF.ERROR_RATE].clamp(0.0, 1.0)


def error_source_excess(e: torch.Tensor, dep_src: torch.Tensor,
                        dep_dst: torch.Tensor) -> torch.Tensor:
    """Per-node error rate in excess of its dependencies' max,
    ``relu(e - max over edges (s, d) of e[d])``.  Padded edges self-loop on
    the dummy slot whose error rate is 0 (the max's identity here)."""
    dep_max = torch.zeros_like(e).scatter_reduce_(
        0, dep_src, e[dep_dst], reduce="amax", include_self=True,
    )
    return torch.clamp(e - dep_max, min=0.0)


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


def evidence_front_rows_plain(features, anomaly_w, hard_w):
    """``(a_raw, h, e, n_bad)``: the row pass in plain PyTorch, over the
    sanitized features."""
    clean, n_bad = finite_mask_rows(features)
    a_raw, h = noisy_or_pair_plain(clean, anomaly_w, hard_w)
    return a_raw, h, error_rate(clean), n_bad


def evidence_front_plain(features, anomaly_w, hard_w, error_contrast: float,
                         up_seg: SegLayout):
    """``(a, h, n_bad)`` from the raw padded features: the reference's
    front in plain PyTorch."""
    a, h, e, n_bad = evidence_front_rows_plain(features, anomaly_w, hard_w)
    if error_contrast:
        a = seg_contrast_step_plain(a, e, error_contrast, up_seg)
    return a, h, n_bad


def _check(features, anomaly_w, hard_w):
    if features.dim() != 2:
        raise ValueError(f"features must be [S, C], got {tuple(features.shape)}")
    n_channels = features.shape[1]
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
    n_rows, n_channels = features.shape
    a = torch.empty(n_rows, dtype=torch.float32, device=features.device)
    h = torch.empty_like(a)
    if n_rows == 0:
        return a, h
    stream = torch.cuda.current_stream(features.device).cuda_stream
    err = library().rca_noisy_or_pair(
        features.data_ptr(), anomaly_w.data_ptr(), hard_w.data_ptr(),
        a.data_ptr(), h.data_ptr(), n_rows, n_channels, stream,
    )
    check(err, "noisy_or_pair")
    LAUNCHES["noisy_or_pair"] += 1
    return a, h


def _check_rows(features, anomaly_w, hard_w):
    on_card = _check(features, anomaly_w, hard_w)
    if not SvcF.ERROR_RATE < features.shape[1] <= MAX_CHANNELS:
        raise ValueError(f"the front takes {SvcF.ERROR_RATE + 1} to "
                         f"{MAX_CHANNELS} channels, got {features.shape[1]}")
    return on_card


def evidence_front_rows(features: torch.Tensor, anomaly_w: torch.Tensor,
                        hard_w: torch.Tensor):
    """``(a_raw, h, e, n_bad)`` from raw float32 ``[S, C]`` features, the
    sanitize included: one launch of the ``evidence_front`` kernel on a
    CUDA tensor, :func:`evidence_front_rows_plain` on a CPU tensor.
    ``n_bad`` is a 0-dim int32 tensor."""
    if not _check_rows(features, anomaly_w, hard_w):
        return evidence_front_rows_plain(features, anomaly_w, hard_w)
    from rca_tpu_torch.kernels.build import check, library

    features = features.contiguous()
    anomaly_w = anomaly_w.contiguous()
    hard_w = hard_w.contiguous()
    n_rows, n_channels = features.shape
    a_raw, h, e = (torch.empty(n_rows, dtype=torch.float32,
                               device=features.device) for _ in range(3))
    if n_rows == 0:
        return a_raw, h, e, torch.zeros((), dtype=torch.int32,
                                        device=features.device)
    n_bad = torch.empty((), dtype=torch.int32, device=features.device)
    stream = torch.cuda.current_stream(features.device).cuda_stream
    err = library().rca_evidence_front(
        features.data_ptr(), anomaly_w.data_ptr(), hard_w.data_ptr(),
        a_raw.data_ptr(), h.data_ptr(), e.data_ptr(), n_bad.data_ptr(),
        n_rows, n_channels, int(SvcF.ERROR_RATE), stream,
    )
    check(err, "evidence_front")
    LAUNCHES["evidence_front"] += 1
    return a_raw, h, e, n_bad


def seg_contrast_step(a_raw: torch.Tensor, e: torch.Tensor, weight: float,
                      seg: SegLayout) -> torch.Tensor:
    """``a = 1 - (1 - a_raw) * (1 - weight * relu(e - dep_max))`` with
    ``dep_max[s]`` the max of ``e`` over the dependencies of ``s`` in the
    up layout ``seg``: one launch of the ``seg_contrast_step`` kernel on
    CUDA tensors, :func:`seg_contrast_step_plain` on CPU tensors."""
    on_card = check_step("seg_contrast_step", seg, None,
                         {"a_raw": a_raw, "e": e})
    if not on_card:
        return seg_contrast_step_plain(a_raw, e, weight, seg)
    return launch_step("rca_seg_contrast_step", "seg_contrast_step", seg,
                       torch.empty_like(a_raw), a_raw.data_ptr(),
                       e.data_ptr(), as_float32(weight))


def evidence_front(features: torch.Tensor, anomaly_w: torch.Tensor,
                   hard_w: torch.Tensor, error_contrast: float,
                   up_seg: SegLayout):
    """``(a, h, n_bad)`` from the RAW padded ``[n_pad, C]`` features over
    the up layout ``up_seg`` (its tensors on the features' device): on CUDA
    tensors :func:`evidence_front_rows` then, unless ``error_contrast`` is
    0, :func:`seg_contrast_step`; on CPU tensors
    :func:`evidence_front_plain`."""
    on_card = _check_rows(features, anomaly_w, hard_w)
    if not isinstance(up_seg.offsets, torch.Tensor):
        raise TypeError("evidence_front: the layout is on the host; move it "
                        "with .to(device)")
    if up_seg.offsets.device != features.device:
        raise ValueError(f"evidence_front: layout on {up_seg.offsets.device}"
                         f", features on {features.device}")
    n_pad = up_seg.offsets.shape[0] - 1
    if n_pad != features.shape[0]:
        raise ValueError(f"evidence_front: layout of {n_pad} segments, "
                         f"features of {features.shape[0]} rows")
    if not on_card:
        return evidence_front_plain(features, anomaly_w, hard_w,
                                    error_contrast, up_seg)
    a, h, e, n_bad = evidence_front_rows(features, anomaly_w, hard_w)
    if error_contrast:
        a = seg_contrast_step(a, e, error_contrast, up_seg)
    return a, h, n_bad
