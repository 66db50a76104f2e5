"""Explain-away propagation over the service graph, in PyTorch.

Counterpart of the JAX package's ``engine/propagate.py`` (S services, E
dependency edges ``(s -> d)``, "s depends on d"):

    a  = 1 - prod_c (1 - w_c f_c)            anomaly evidence (noisy-OR)
    h  = 1 - prod_c (1 - v_c f_c)            hard "I am broken" evidence
    u_s = max_{(s,d)} max(h_d, g*u_d)        upstream explanation (K steps)
    m_d = (1/deg_d) sum_{(s,d)} (a~_s + g*m_s)   downstream impact (K steps)
    score = a * (1 + b*tanh(m)) * (1 - mu*u*(1-h))

where a~ is the anomaly excess over the live-median background, and ``a``
carries the error-source contrast.  Every function takes one ``[n_pad, C]``
feature matrix or ``[B, n_pad, C]`` lanes over one graph (the reference's
vmap, written out as a leading dimension); each lane gets its own median
and its own top-k, and comes out bitwise equal to a solo run.

The body runs the kernel registry's row that its :class:`KernelPlan`
names (:mod:`rca_tpu_torch.engine.registry`); the plan's ``kernel`` is
the one place the row is decided, and the body branches on it once:

- ``kernels``: the front (finite-mask sanitize, evidence pair, contrast)
  and the recursions go through the port's kernels on the card
  (:mod:`.evidence`: one launch; :mod:`.segscan`: each recursion in the
  form the plan's ``steps_form`` names, one launch with one CTA a lane
  where the graph fits one CTA's shared memory (``cta``), else one
  cooperative launch over the card (``grid``), each for all lanes); on
  the CPU through their plain versions (``step``);
- ``torch``: plain PyTorch ops on every device, differentiable with the
  reference's gradient at ties, which attribution's saliency needs: the
  front's plain version, the up-steps over the plan's hybrid up-table
  (:func:`.ell.ell_up_step`) and the down-steps as the sorted segment sum
  of :func:`.segscan.down_seg_step_plain`;
- ``doubling``: the ``kernels`` row's front (its kernels on the card),
  then the log-depth scans of :mod:`.doubling` over the plan's frontier
  layouts (``plan.dbl``);
- ``quantized``: the bf16 front and the int8-message steps of
  :mod:`.quantized`, plain ops on every device (the reference's row has
  no Pallas body).

The plan's ``layout`` (``RCA_EDGE_LAYOUT``) changes the ``torch`` row's
up-steps alone: under ``coo`` they are the segmented max over the up
layout's sorted edges (:func:`.segscan.up_seg_step_plain`, bitwise the
up-table's, since a max is order-free) and the plan carries no up-table.
The other rows run the same steps over the same seg layouts under every
layout, so the stamp ``layout`` changes no bit of theirs.  The full-ELL
layout runs through :func:`propagate` with ``ell``
(:func:`.ell.ell_core` after the row's front).

The JAX ``lax.scan`` over steps is a Python loop here.  No float SUM on
this path depends on the order of atomics: ``deg`` sums integer-valued
ones (exact in any order), the bad-row count is an integer sum, the
contrast and the up-scans take maxima, and every other sum is a
segmented sum in a fixed order.  Two runs on one device give the same bits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from rca_tpu_torch.engine.doubling import (
    DoublingLayout,
    doubling_down,
    doubling_up,
)
from rca_tpu_torch.engine.ell import UpEll, ell_core, ell_up_step
from rca_tpu_torch.engine.evidence import (
    evidence_front,
    evidence_front_plain,
    segment_sources,
)
from rca_tpu_torch.engine.quantized import (
    quant_imp_step,
    quant_up_step,
    quantized_front,
)
from rca_tpu_torch.engine.segscan import (
    STEPS_FORMS,
    SegLayout,
    down_seg_step,
    down_seg_step_plain,
    down_seg_steps,
    down_seg_steps_grid,
    up_seg_step,
    up_seg_step_plain,
    up_seg_steps,
    up_seg_steps_grid,
)

#: the one-launch recursions of each ``steps_form``, (up, down)
_WHOLE = {"cta": (up_seg_steps, down_seg_steps),
          "grid": (up_seg_steps_grid, down_seg_steps_grid)}


class KernelPlan(NamedTuple):
    """One shape's resolved dispatch: the engaged registry row, the edge
    layout its steps run over and the device layouts.  Every row reads the
    seg layouts (the front's contrast the up layout); the ``torch`` row on
    the ``hybrid`` layout also the up-table, the ``doubling`` row also its
    frontier layouts.  ``layout`` is ``hybrid``, ``coo`` or ``ell``: the
    stamp of what ran, beside the row.  ``steps_form`` (one of
    :data:`.segscan.STEPS_FORMS`): the form of the ``kernels`` row's
    recursions, ``cta`` (one launch each, one CTA a lane: the graph fits
    one CTA's shared memory on the CUDA device), ``grid`` (one
    cooperative launch each over the card) or ``step`` (one launch a
    step; on the CPU the plain steps)."""

    kernel: str                       # the engaged row (config.KERNELS)
    down_seg: SegLayout
    up_seg: SegLayout
    up_ell: Optional[UpEll] = None    # the torch row's hybrid up-table
    dbl: Optional[DoublingLayout] = None  # the doubling row's frontiers
    layout: str = "hybrid"            # the edge layout (RCA_EDGE_LAYOUT)
    steps_form: str = "step"          # the recursions' form


def _row(plan: KernelPlan) -> str:
    if plan.steps_form not in STEPS_FORMS:
        raise ValueError(f"unknown steps form {plan.steps_form!r}")
    if plan.kernel in ("kernels", "quantized"):
        return plan.kernel
    if plan.kernel == "torch":
        if plan.up_ell is None and plan.layout == "hybrid":
            raise ValueError("the torch row needs the plan's up-table")
        return "torch"
    if plan.kernel == "doubling":
        if plan.dbl is None:
            raise ValueError("the doubling row needs the plan's frontier "
                             "layouts")
        return "doubling"
    raise ValueError(f"unknown kernel row {plan.kernel!r}")


def live_median(a: torch.Tensor, n_live: int) -> torch.Tensor:
    """The median of each lane's live slots ``0..n_live-1`` (``[...]`` from
    ``[..., S]``), as ``jnp.nanmedian`` takes it over the NaN-masked pads:
    a STABLE sort, then the midpoint ``(lo + hi) * 0.5`` of the two middle
    values (``torch.median`` would return the lower one).  The stable sort
    puts a tie's gradient on the same index as the reference's; 0 when
    nothing is live."""
    if n_live <= 0:
        return a.new_zeros(a.shape[:-1])
    vals = torch.sort(a[..., :n_live], dim=-1, stable=True).values
    return (vals[..., (n_live - 1) // 2] + vals[..., n_live // 2]) * 0.5


def background_excess(a: torch.Tensor, n_live: Optional[int] = None):
    """Anomaly excess over the MEDIAN of the live services (slots
    ``0..n_live-1``; later slots are shape padding and get 0), per lane of
    ``[..., S]``.  The relu is a max with 0, which splits a tie's gradient
    as ``jnp.maximum`` does (the median's own slot always ties)."""
    if n_live is None:
        n_live = a.shape[-1]
    a_bg = live_median(a, n_live)[..., None]
    live = torch.arange(a.shape[-1], device=a.device) < n_live
    return torch.where(live, torch.maximum(a - a_bg, a.new_zeros(())), 0.0)


def combine_score(a, h, u, m, explain_strength: float, impact_bonus: float):
    """Final root-cause score: impact amplifies own evidence, an anomalous
    upstream explains away soft symptoms (damped by own hard evidence)."""
    return (
        a
        * (1.0 + impact_bonus * torch.tanh(m))
        * (1.0 - explain_strength * u * (1.0 - h))
    )


def inverse_degree(like: torch.Tensor, dep_dst: torch.Tensor):
    """``1 / max(deg, 1)`` over ``[n_pad]``, ``deg`` each service's
    dependent count for the impact MEAN (padded edges point at the dummy
    slot, so live degrees come from real edges only); one graph, so one
    vector for every lane.  It sums integer-valued ones, exact in any
    order."""
    n_pad = like.shape[-1]
    deg = like.new_zeros(n_pad).index_add_(0, dep_dst, like.new_ones(
        dep_dst.shape[0]))
    return 1.0 / torch.clamp(deg, min=1.0)


def propagate_core(a, h, dep_dst, steps: int, decay: float,
                   explain_strength: float, impact_bonus: float,
                   n_live: Optional[int], plan: KernelPlan):
    """Propagation from precomputed ``[..., n_pad]`` evidence on the
    plan's row: the one-launch recursions of the plan's ``steps_form`` or
    the seg-step wrappers (``kernels``), plain ops over the
    up-table (the segmented max under ``coo``) and the sorted segment sum
    (``torch``), the log-depth scans (``doubling``) or the int8-message
    steps (``quantized``).  Returns
    ``(a, h, u, m, score)``, each shaped like ``a``."""
    row = _row(plan)
    if row == "doubling":
        u = doubling_up(h, decay, plan.dbl)
        a_ex = background_excess(a, n_live)
        m = doubling_down(a_ex, decay, plan.dbl, inverse_degree(a, dep_dst))
        return a, h, u, m, combine_score(a, h, u, m, explain_strength,
                                         impact_bonus)

    # a one-launch recursion starts from zeros itself; the loops start here
    whole = _WHOLE.get(plan.steps_form) if row == "kernels" else None
    u = (whole[0](h, decay, steps, plan.up_seg) if whole
         else torch.zeros_like(a))
    if row == "torch" and plan.up_ell is None:
        # the coo layout: the segmented max over the up layout's edges
        for _ in range(steps):
            u = up_seg_step_plain(u, h, decay, plan.up_seg)
    elif row == "torch":
        for _ in range(steps):
            u = ell_up_step(u, h, decay, plan.up_ell)
    elif row == "quantized":
        # the up layout's edges, (dependent, dependency) in sorted order
        src, dst = segment_sources(plan.up_seg), plan.up_seg.other_sorted
        for _ in range(steps):
            u = quant_up_step(u, h, decay, src, dst)
    elif not whole:
        # each step reads its input at other segments' nodes, so it writes
        # a fresh vector: two buffers per recursion, alternating
        spare = torch.empty_like(a)
        for _ in range(steps):
            u, spare = up_seg_step(u, h, decay, plan.up_seg, out=spare), u

    a_ex = background_excess(a, n_live)
    inv_deg = inverse_degree(a, dep_dst)

    m = (whole[1](a_ex, decay, steps, plan.down_seg, inv_deg) if whole
         else torch.zeros_like(a))
    if row == "torch":
        for _ in range(steps):
            m = down_seg_step_plain(m, a_ex, decay, plan.down_seg, inv_deg)
    elif row == "quantized":
        for _ in range(steps):
            m = quant_imp_step(m, a_ex, decay, plan.down_seg, inv_deg)
    elif not whole:
        spare = torch.empty_like(a)
        for _ in range(steps):
            m, spare = down_seg_step(m, a_ex, decay, plan.down_seg, inv_deg,
                                     out=spare), m

    score = combine_score(a, h, u, m, explain_strength, impact_bonus)
    return a, h, u, m, score


_FRONTS = {"torch": evidence_front_plain, "kernels": evidence_front,
           "doubling": evidence_front, "quantized": quantized_front}


def propagate(features, dep_dst, anomaly_w, hard_w, steps: int, decay: float,
              explain_strength: float, impact_bonus: float,
              n_live: Optional[int], plan: KernelPlan,
              error_contrast: float = 0.0, persist: bool = False, ell=None):
    """The evidence front (sanitize, evidence pair, error-source contrast:
    one kernel launch on the card for the ``kernels`` and ``doubling`` rows,
    the plain version for the ``torch`` row, the bf16 front for the
    ``quantized`` row), then the core, both on the plan's row.
    ``features`` is the RAW padded ``[n_pad, C]`` float32 matrix or
    ``[B, n_pad, C]`` lanes; ``dep_dst`` is int64 ``[e_pad]``.  Returns
    ``(a, h, u, m, score, n_bad)``, ``n_bad`` the 0-dim int32 count of the
    rows the sanitize zeroed, across the lanes.  ``persist`` leaves the
    sanitized rows in ``features`` (the streaming flush); otherwise
    ``features`` is only read.  ``ell`` (:class:`.ell.EllTables`, one
    ``[n_pad, C]`` graph) runs the full-ELL recursions after the front
    instead of the core."""
    front = _FRONTS[_row(plan)]
    a, h, n_bad = front(features, anomaly_w, hard_w, error_contrast,
                        plan.up_seg, persist)
    if ell is not None:
        return (*ell_core(a, h, ell, steps, decay, explain_strength,
                          impact_bonus, n_live), n_bad)
    return (*propagate_core(a, h, dep_dst, steps, decay, explain_strength,
                            impact_bonus, n_live, plan), n_bad)


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

    def forward(self, features, dep_dst, n_live: int, plan: KernelPlan,
                persist: bool = False, ell=None):
        return propagate(
            features, dep_dst, self.anomaly_w, self.hard_w,
            self.steps, self.decay, self.explain_strength,
            self.impact_bonus, n_live, plan,
            error_contrast=self.error_contrast, persist=persist, ell=ell,
        )
