"""The fused noisy-OR evidence pair: kernel wrapper and plain version.

Counterpart of the JAX package's ``engine/pallas_kernels.py``.  On a CUDA
tensor :func:`noisy_or_pair` launches the hand-written kernel in
``csrc/evidence.cu`` (which replaces the TPU kernel ``noisy_or_pair_pallas``;
the source note there says what bounds it); on a CPU tensor it computes
:func:`noisy_or_pair_plain`.  There is no fallback between the two.

Both compute, over row-major ``[S, C]`` features,

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
kernel's true fused multiply-add.
"""

from __future__ import annotations

import torch

from rca_tpu_torch.kernels import LAUNCHES


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


def noisy_or_pair(features: torch.Tensor, anomaly_w: torch.Tensor,
                  hard_w: torch.Tensor):
    """``(a, h)`` evidence vectors from float32 ``[S, C]`` features: the
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    _check(features, anomaly_w, hard_w)
    if features.device.type == "cpu":
        return noisy_or_pair_plain(features, anomaly_w, hard_w)
    if features.device.type != "cuda":
        raise ValueError(f"no evidence kernel for device {features.device}")
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
