"""Quantized propagation: bf16 evidence and int8 messages, and the
rank-parity gate the row is held to.

Counterpart of the JAX package's ``engine/quantized.py``, the registry's
``quantized`` row (``RCA_KERNEL=quantized``):

- **bf16 evidence** (:func:`noisy_or_pair_bf16`): the noisy-OR pair over a
  bfloat16 cast of the feature matrix, half the feature-read bytes;
- **per-row int8 messages** (:func:`quantize_rows`): each propagation step
  quantizes its dense per-node signal to int8 with one float32 scale per
  128-lane row (:data:`QUANT_ROW`), and the edge gather reads the int8
  vector (:func:`dequant_gather`).  The reductions stay float32: the
  up-step's max (:func:`quant_up_step`, order-free) and the down-step's
  sum (:func:`quant_imp_step`), which the reference takes with a scatter-
  add and the port with the flagged segmented sum over the dst-sorted
  layout, so that two runs on one device give the same bits.

On ``[B, n_pad]`` lanes each lane's rows are quantized on their own.  The
reference's row runs no Pallas body, and neither does this one: on every
device it is plain PyTorch ops (:func:`quantized_front` for the front).
Its contract is RANK parity, not bit parity (:func:`rank_parity`): an
int8 lane carries about two decimal digits, so scores move in the fourth
decimal; the gates are hit@1 / hit@k equality and a Kendall-tau floor.
"""

from __future__ import annotations

import torch

from rca_tpu_torch.engine.evidence import (
    clip01,
    error_rate,
    finite_mask_rows,
    seg_contrast_step_plain,
)
from rca_tpu_torch.engine.segscan import (
    SegLayout,
    scatter_max,
    segment_totals,
)

#: per-row quantization granularity: one float32 scale per 128 message
#: lanes.  Shapes are power-of-two buckets (or multiples of 1024), so any
#: ``n_pad`` divides into ``min(n_pad, QUANT_ROW)`` rows exactly.
QUANT_ROW = 128


def quant_row(n_pad: int) -> int:
    """The effective row width for an ``n_pad``-padded vector."""
    return min(QUANT_ROW, int(n_pad))


def quantize_rows(x: torch.Tensor):
    """Per-row symmetric int8 quantization of float32 ``[S]`` (or each lane
    of ``[B, S]``): returns ``(q int8 [..., S], scale float32 [...,
    S // row])``.  An all-zero row keeps scale 1.0, so its dequant is
    exactly zero, never 0/0.  ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    row = quant_row(x.shape[-1])
    r = x.reshape(*x.shape[:-1], -1, row)
    amax = r.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.round(r / scale[..., None]).to(torch.int8)
    return q.reshape(x.shape), scale


def dequant_gather(q: torch.Tensor, scale: torch.Tensor,
                   idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` through the quantized representation: an int8
    gather plus a gather of the row scales."""
    row = quant_row(q.shape[-1])
    return q[..., idx].to(torch.float32) * scale[..., idx // row]


def quant_up_step(u, h, decay: float, dep_src, dep_dst):
    """One explain-away step with the per-node signal ``max(h, decay*u)``
    quantized before the edge gather (at the dependency ``dep_dst``); the
    float32 max lands on the dependent ``dep_src``."""
    q, scale = quantize_rows(torch.maximum(h, decay * u))
    vals = dequant_gather(q, scale, dep_dst)
    return torch.maximum(u, scatter_max(u, dep_src, vals))


def quant_imp_step(m, a_ex, decay: float, down_seg: SegLayout, inv_deg):
    """One impact step with ``a_ex + decay*m`` quantized before the edge
    gather; the sum per destination is the flagged segmented sum over the
    dst-sorted layout (``down_seg_step_plain``'s form, independent of any
    atomic order), then the degree normalization, both float32."""
    q, scale = quantize_rows(a_ex + decay * m)
    vals = dequant_gather(q, scale, down_seg.other_sorted)
    return segment_totals(vals, down_seg, "sum") * inv_deg


def noisy_or_pair_bf16(features, anomaly_w, hard_w):
    """The evidence pair over a bfloat16 cast of the ``[..., S, C]``
    features, float32 out, rounded as the reference's compiled executable
    rounds it: each ``f*w`` product of two bf16 values rounded to bf16,
    the factors ``1 - x`` and their product in float32 (left to right),
    the product rounded to bf16 once, then ``1 - p`` in float32.  (The
    reference run op by op, outside a compiled executable, rounds every
    step to bf16 and lands up to one bf16 step, 2**-7, away.)"""
    f = clip01(features.to(torch.bfloat16).to(torch.float32))

    def one(w):
        wb = w.to(torch.bfloat16).to(torch.float32)
        terms = 1.0 - (f * wb).to(torch.bfloat16).to(torch.float32)
        p = terms[..., 0]
        for c in range(1, terms.shape[-1]):
            p = p * terms[..., c]
        return 1.0 - p.to(torch.bfloat16).to(torch.float32)

    return one(anomaly_w), one(hard_w)


def quantized_front(features, anomaly_w, hard_w, error_contrast: float,
                    up_seg: SegLayout, persist: bool = False):
    """``(a, h, n_bad)``, the quantized row's front from the RAW padded
    features: the finite-mask sanitize, :func:`noisy_or_pair_bf16`, then
    the reference's float32 error-source contrast over the up layout.
    Plain ops on every device (the reference's row has no Pallas body).
    ``persist`` leaves the sanitized rows in ``features``."""
    clean, n_bad = finite_mask_rows(features)
    if persist:
        features.copy_(clean)
    a, h = noisy_or_pair_bf16(clean, anomaly_w, hard_w)
    if error_contrast:
        a = seg_contrast_step_plain(a, error_rate(clean), error_contrast,
                                    up_seg)
    return a, h, n_bad


# -- the rank-parity gate -----------------------------------------------------

def kendall_tau(order_a, order_b) -> float:
    """Kendall rank correlation between two orderings of the same item
    set (1.0 = identical order, -1.0 = reversed), over the items of
    ``order_a`` that ``order_b`` holds."""
    items = [x for x in order_a if x in set(order_b)]
    k = len(items)
    if k < 2:
        return 1.0
    pos_b = {x: i for i, x in enumerate(order_b)}
    concordant = discordant = 0
    for i in range(k):
        for j in range(i + 1, k):
            d = pos_b[items[i]] - pos_b[items[j]]
            if d < 0:
                concordant += 1
            elif d > 0:
                discordant += 1
    return (concordant - discordant) / (k * (k - 1) / 2)


#: the score precision the row promises: the symmetric int8 step is about
#: 1/254 of a row's signal max per quantize, and the 8-step scans
#: accumulate it geometrically, so score moves up to ~1e-2 are within
#: spec.  Pairs the float32 path separates by less carry no rank signal.
SCORE_EPS = 1e-2


def topk_score_tau(scores_ref, scores_got, k: int = 25,
                   tie_eps: float = SCORE_EPS) -> float:
    """Tie-aware Kendall tau over the top-k of the REFERENCE score
    vector: pairs whose reference scores differ by at most ``tie_eps``
    are left out; the rest must keep their order."""
    import numpy as np

    ref = np.asarray(scores_ref, np.float64)
    got = np.asarray(scores_got, np.float64)
    top = np.argsort(-ref)[:k]
    concordant = discordant = 0
    for a in range(len(top)):
        for b in range(a + 1, len(top)):
            i, j = int(top[a]), int(top[b])
            if ref[i] - ref[j] <= tie_eps:
                continue
            if got[i] > got[j]:
                concordant += 1
            elif got[i] < got[j]:
                discordant += 1
    total = concordant + discordant
    return 1.0 if total == 0 else (concordant - discordant) / total


def rank_parity(ranked_ref, ranked_got, k: int = 3,
                tau_floor: float = 0.99) -> dict:
    """hit@1 and hit@k equality (the same leaders, as SETS for k > 1; the
    order within the tail is judged by tau) plus a Kendall-tau floor over
    the common top-k.  ``ranked_*`` are ranked dicts (``[{"component":
    ...}]``) or plain name lists."""
    def names(r):
        return [x["component"] if isinstance(x, dict) else x for x in r]

    ref, got = names(ranked_ref), names(ranked_got)
    hit1 = bool(ref[:1] == got[:1])
    hitk = bool(set(ref[:k]) == set(got[:k]))
    tau = kendall_tau(ref, got)
    return {
        "hit1_equal": hit1,
        f"hit{k}_equal": hitk,
        "kendall_tau": round(float(tau), 4),
        "ok": hit1 and hitk and tau >= tau_floor,
    }
