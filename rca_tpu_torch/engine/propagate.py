"""Explain-away propagation over the service graph, in PyTorch.

Counterpart of the JAX package's ``engine/propagate.py`` for the seg-step
path (S services, E dependency edges ``(s -> d)``, "s depends on d"):

    a  = 1 - prod_c (1 - w_c f_c)            anomaly evidence (noisy-OR)
    h  = 1 - prod_c (1 - v_c f_c)            hard "I am broken" evidence
    u_s = max_{(s,d)} max(h_d, g*u_d)        upstream explanation (K steps)
    m_d = (1/deg_d) sum_{(s,d)} (a~_s + g*m_s)   downstream impact (K steps)
    score = a * (1 + b*tanh(m)) * (1 - mu*u*(1-h))

where a~ is the anomaly excess over the live-median background, and ``a``
carries the error-source contrast.  The front (finite-mask sanitize,
evidence pair, contrast) and every seg step go through the port's kernels
on the card (:mod:`.evidence`: two launches; :mod:`.segscan`: one launch
per step); every other op is plain PyTorch.  The JAX ``lax.scan`` over
steps is a Python loop here.

No float SUM on this path depends on the order of atomics: ``deg`` sums
integer-valued ones (exact in any order), the bad-row count is an integer
sum, and the contrast takes a max.  Two runs on one device give the same
bits.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from rca_tpu_torch.engine.evidence import evidence_front
from rca_tpu_torch.engine.segscan import SegLayout, down_seg_step, up_seg_step


def background_excess(a: torch.Tensor, n_live: Optional[int] = None):
    """Anomaly excess over the MEDIAN of the live services (slots
    ``0..n_live-1``; later slots are shape padding and get 0).  The median
    is the midpoint of the two middle values, as ``jnp.nanmedian`` takes it
    (``torch.median`` would return the lower one); 0 when nothing is live."""
    if n_live is None:
        n_live = a.shape[0]
    if n_live > 0:
        a_bg = torch.quantile(a[:n_live], 0.5, interpolation="midpoint")
    else:
        a_bg = a.new_zeros(())
    live = torch.arange(a.shape[0], device=a.device) < n_live
    return torch.where(live, torch.clamp(a - a_bg, min=0.0), 0.0)


def combine_score(a, h, u, m, explain_strength: float, impact_bonus: float):
    """Final root-cause score: impact amplifies own evidence, an anomalous
    upstream explains away soft symptoms (damped by own hard evidence)."""
    return (
        a
        * (1.0 + impact_bonus * torch.tanh(m))
        * (1.0 - explain_strength * u * (1.0 - h))
    )


def propagate_core(a, h, dep_dst, steps: int, decay: float,
                   explain_strength: float, impact_bonus: float,
                   n_live: Optional[int], down_seg: SegLayout,
                   up_seg: SegLayout):
    """Propagation from precomputed evidence over the seg-step layouts.
    Returns ``(a, h, u, m, score)``, all ``[S]``."""
    # each step reads its input at other segments' nodes, so it writes a
    # fresh vector: two buffers per recursion, alternating
    u, spare = torch.zeros_like(a), torch.empty_like(a)
    for _ in range(steps):
        u, spare = up_seg_step(u, h, decay, up_seg, out=spare), u

    a_ex = background_excess(a, n_live)
    # dependent count per service for the impact MEAN (padded edges point
    # at the dummy slot, so live degrees come from real edges only)
    deg = torch.zeros_like(a).index_add_(0, dep_dst, torch.ones_like(
        dep_dst, dtype=a.dtype))
    inv_deg = 1.0 / torch.clamp(deg, min=1.0)

    m, spare = torch.zeros_like(a), torch.empty_like(a)
    for _ in range(steps):
        m, spare = down_seg_step(m, a_ex, decay, down_seg, inv_deg,
                                 out=spare), m

    score = combine_score(a, h, u, m, explain_strength, impact_bonus)
    return a, h, u, m, score


def propagate(features, dep_dst, anomaly_w, hard_w, steps: int, decay: float,
              explain_strength: float, impact_bonus: float,
              n_live: Optional[int], down_seg: SegLayout, up_seg: SegLayout,
              error_contrast: float = 0.0):
    """The evidence front (sanitize, evidence pair, error-source contrast:
    two kernels on the card), then the core.  ``features`` is the RAW
    padded ``[n_pad, C]`` float32 matrix; ``dep_dst`` is int64 ``[e_pad]``.
    Returns ``(a, h, u, m, score, n_bad)``, ``n_bad`` the 0-dim int32 count
    of the rows the sanitize zeroed."""
    a, h, n_bad = evidence_front(features, anomaly_w, hard_w, error_contrast,
                                 up_seg)
    return (*propagate_core(a, h, dep_dst, steps, decay, explain_strength,
                            impact_bonus, n_live, down_seg, up_seg), n_bad)


class Propagation(nn.Module):
    """The propagation as a module: the two weight vectors are buffers (so
    ``.to(device)`` moves them) and the scalars are attributes."""

    def __init__(self, params):
        super().__init__()
        aw, hw = params.weight_arrays()
        self.register_buffer("anomaly_w", torch.from_numpy(aw))
        self.register_buffer("hard_w", torch.from_numpy(hw))
        self.steps = int(params.steps)
        self.decay = float(params.decay)
        self.explain_strength = float(params.explain_strength)
        self.impact_bonus = float(params.impact_bonus)
        self.error_contrast = float(params.error_contrast)

    def forward(self, features, dep_dst, n_live: int, down_seg: SegLayout,
                up_seg: SegLayout):
        return propagate(
            features, dep_dst, self.anomaly_w, self.hard_w,
            self.steps, self.decay, self.explain_strength,
            self.impact_bonus, n_live, down_seg, up_seg,
            error_contrast=self.error_contrast,
        )
