"""Gather-table edge layouts: the hybrid layout's up-table, and the
full-ELL layout of ``RCA_EDGE_LAYOUT=ell``.

Counterpart of the JAX package's ``engine/ell.py`` (``build_ell_segments``,
``EllGraph``, ``ell_up_step``, ``propagate_ell``) and ``engine/runner.py``
(``build_up_ell``, ``up_ell_for``).  The ``torch`` row of the kernel
registry takes its explain-away up-steps over the hybrid up-table, as the
reference's differentiable ``xla`` body does.  That is more than a layout
choice: the gradient of a max splits evenly among tied entries, the
table's padded slots included, so attribution's saliency matches the
reference's only over the same table, width ``UP_WIDTH_CAP`` and overflow
included.

The full-ELL layout (:class:`EllGraph`, :func:`propagate_ell`) pads BOTH
directions to width-capped ``[n_pad, D]`` tables (D at most
``DEFAULT_WIDTH_CAP``), hub residue in a COO overflow list per direction.
Its sums come out the same on every run: each table row is a dense row
sum, and the down overflow is the flagged segmented sum over the
segment-sorted overflow edges (``segscan_sum``, the scan kernel on the
card; never a float ``index_add_``); maxima are order-free.  The tables are made on the host in numpy, byte for byte the
reference's.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


DEFAULT_WIDTH_CAP = 32
#: dependencies per service are few; hub FAN-IN is not
UP_WIDTH_CAP = 8


@dataclasses.dataclass(frozen=True)
class EllSegments:
    """Per-segment padded neighbor lists + COO overflow for one direction."""

    idx: np.ndarray        # int32 [S_pad, D] neighbor ids (dummy-padded)
    mask: np.ndarray       # float32 [S_pad, D] 1=real
    ovf_seg: np.ndarray    # int32 [O_pad] segment ids of overflow edges
    ovf_other: np.ndarray  # int32 [O_pad] neighbor ids of overflow edges
    n_overflow: int


def build_ell_segments(seg: np.ndarray, other: np.ndarray, n_pad: int,
                       width_cap: int = DEFAULT_WIDTH_CAP) -> EllSegments:
    """Group ``other`` by ``seg`` into an [n_pad, D] table, D <= width_cap.

    Edges past the cap for a hub segment land in the overflow COO arrays
    (dummy-padded to a power of two so shapes bucket)."""
    dummy = n_pad - 1
    E = len(seg)
    if E == 0:
        return EllSegments(
            idx=np.full((n_pad, 1), dummy, np.int32),
            mask=np.zeros((n_pad, 1), np.float32),
            ovf_seg=np.full(1, dummy, np.int32),
            ovf_other=np.full(1, dummy, np.int32),
            n_overflow=0,
        )
    order = np.argsort(seg, kind="stable")
    s_sorted = seg[order].astype(np.int64)
    o_sorted = other[order].astype(np.int32)
    counts = np.bincount(s_sorted, minlength=n_pad)
    starts = np.zeros(n_pad + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    col = np.arange(E, dtype=np.int64) - starts[s_sorted]

    D = int(min(max(counts.max(), 1), width_cap))
    in_table = col < D
    idx = np.full((n_pad, D), dummy, np.int32)
    mask = np.zeros((n_pad, D), np.float32)
    idx[s_sorted[in_table], col[in_table]] = o_sorted[in_table]
    mask[s_sorted[in_table], col[in_table]] = 1.0

    ovf = ~in_table
    n_ovf = int(ovf.sum())
    o_pad = 1 << max(int(np.ceil(np.log2(max(n_ovf, 1)))), 0)
    ovf_seg = np.full(o_pad, dummy, np.int32)
    ovf_other = np.full(o_pad, dummy, np.int32)
    ovf_seg[:n_ovf] = s_sorted[ovf]
    ovf_other[:n_ovf] = o_sorted[ovf]
    return EllSegments(
        idx=idx, mask=mask, ovf_seg=ovf_seg, ovf_other=ovf_other,
        n_overflow=n_ovf,
    )


class UpEll(NamedTuple):
    """The hybrid up-table: ``[n_pad, UP_WIDTH_CAP]`` dependency ids and
    their real-slot mask, and the overflow edges (segment, dependency),
    dummy-padded to a power-of-two length of at least 8.  numpy on the
    host, the reference's arrays; :meth:`to` moves it."""

    idx: np.ndarray
    mask: np.ndarray
    ovf_seg: np.ndarray
    ovf_other: np.ndarray

    def to(self, device) -> "UpEll":
        """The table as tensors on ``device``, ids as int64 for torch
        indexing.  A masked slot gathers its own row instead of the dummy
        row: the mask zeroes its value and its gradient either way, but the
        backward of a gather accumulates by index, serially within one
        index's run on the card, and the dummy would own most of the table
        (every slot past a service's few dependencies)."""
        def put(arr, dtype=None):
            arr = arr if dtype is None else arr.astype(dtype)
            return torch.from_numpy(arr).to(device)

        rows = np.arange(self.idx.shape[0])[:, None]
        idx = np.where(self.mask > 0, self.idx, rows)
        return UpEll(put(idx, np.int64), put(self.mask),
                     put(self.ovf_seg, np.int64),
                     put(self.ovf_other, np.int64))


def build_up_ell(n_pad: int, dep_src, dep_dst) -> UpEll:
    """The host arrays of the up-table for RAW (unpadded) edges, grouping
    each service's dependencies (edges src -> dst keyed by src).  Slot
    ``n_pad - 1`` is the engine's dummy row and must stay free.  The width
    is always ``UP_WIDTH_CAP`` and the overflow length a power of two of at
    least 8, so the shapes depend on the bucket, not on the graph."""
    src = np.asarray(dep_src)
    dst = np.asarray(dep_dst)
    if len(src) and (int(src.max()) >= n_pad - 1
                     or int(dst.max()) >= n_pad - 1):
        raise ValueError(
            "build_up_ell needs slot n_pad-1 free as the dummy row; pass "
            "raw edges with n_pad = bucket(n_services + 1)"
        )
    seg = build_ell_segments(src, dst, n_pad, width_cap=UP_WIDTH_CAP)
    dummy = n_pad - 1
    idx = np.full((n_pad, UP_WIDTH_CAP), dummy, np.int32)
    mask = np.zeros((n_pad, UP_WIDTH_CAP), np.float32)
    idx[:, : seg.idx.shape[1]] = seg.idx
    mask[:, : seg.mask.shape[1]] = seg.mask
    # the table's shape must not hang on the producer's own round-up
    o_pad = max(8, 1 << max(0, (len(seg.ovf_seg) - 1).bit_length()))
    ovf_seg = np.full(o_pad, dummy, np.int32)
    ovf_other = np.full(o_pad, dummy, np.int32)
    ovf_seg[: len(seg.ovf_seg)] = seg.ovf_seg
    ovf_other[: len(seg.ovf_other)] = seg.ovf_other
    return UpEll(idx, mask, ovf_seg, ovf_other)


def up_ell_for(n_pad: int, dep_src, dep_dst, device) -> UpEll:
    """The up-table of one graph's RAW edges, on ``device``."""
    return build_up_ell(n_pad, dep_src, dep_dst).to(device)


def ell_up_step(u, h, decay: float, up: UpEll):
    """One explain-away step over the up-table, on ``[..., n_pad]`` vectors
    (a leading lane dimension shares the table): gather each service's
    dependencies, take the row max, fold the overflow edges in with a
    scatter-max over the zero-initialised rows, keep the dummy slot at 0.
    Plain PyTorch ops throughout, differentiable; a max splits its gradient
    evenly among ties, as ``jnp.max`` and ``.at[].max`` do."""
    vals = torch.maximum(h[..., up.idx], decay * u[..., up.idx]) * up.mask
    u_new = vals.amax(dim=-1)
    ovf = torch.maximum(h[..., up.ovf_other], decay * u[..., up.ovf_other])
    u_new = u_new.scatter_reduce(-1, up.ovf_seg.expand(ovf.shape), ovf,
                                 reduce="amax", include_self=True)
    # padded overflow slots may have written the dummy slot
    dummy = torch.arange(u.shape[-1], device=u.device) == u.shape[-1] - 1
    u_new = torch.where(dummy, 0.0, u_new)
    return torch.maximum(u, u_new)


@dataclasses.dataclass(frozen=True)
class EllGraph:
    """Both directions of a graph as width-capped gather tables (host
    numpy, the reference's arrays); :meth:`to` stages them."""

    n_pad: int
    up: EllSegments    # segment = src (the dependent); neighbors = dsts
    down: EllSegments  # segment = dst (the dependency); neighbors = srcs

    @classmethod
    def build(cls, n_pad: int, src: np.ndarray, dst: np.ndarray,
              width_cap: int = DEFAULT_WIDTH_CAP) -> "EllGraph":
        return cls(
            n_pad=n_pad,
            up=build_ell_segments(src, dst, n_pad, width_cap),
            down=build_ell_segments(dst, src, n_pad, width_cap),
        )

    def nbytes(self) -> int:
        """Host bytes of the tables and overflow lists, both directions."""
        return sum(arr.nbytes for seg in (self.up, self.down)
                   for arr in (seg.idx, seg.mask, seg.ovf_seg,
                               seg.ovf_other))

    def to(self, device) -> "EllTables":
        """The tables as tensors on ``device``: the up direction as an
        :class:`UpEll` (dummy ids kept: no gradient runs here), the down
        direction with its overflow as a seg layout (the flagged sum's
        flags and ends) and the inverse dependent count."""
        from rca_tpu_torch.engine.segscan import build_seg_layout

        def put(arr, dtype=None):
            arr = arr if dtype is None else arr.astype(dtype)
            return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

        up, down = self.up, self.down
        n_ovf = down.n_overflow
        ovf = build_seg_layout(self.n_pad, len(down.ovf_seg),
                               down.ovf_seg[:n_ovf], down.ovf_other[:n_ovf])
        # dependent count for the degree-normalized impact mean: table
        # lanes from the mask, hub residue one per overflow edge (padded
        # overflow lanes point at the dummy node and only inflate its
        # count); integer-valued, so exact in any order
        deg = down.mask.sum(axis=1) + np.bincount(
            down.ovf_seg, minlength=self.n_pad).astype(np.float32)
        return EllTables(
            up=UpEll(put(up.idx, np.int64), put(up.mask),
                     put(up.ovf_seg, np.int64),
                     put(up.ovf_other, np.int64)),
            dn_idx=put(down.idx, np.int64),
            dn_mask=put(down.mask),
            dn_ovf=ovf.to(device),
            inv_deg=put((np.float32(1.0) / np.maximum(deg, np.float32(1.0)))
                        .astype(np.float32)),
        )


class EllTables(NamedTuple):
    """One graph's full-ELL layout on a device (:meth:`EllGraph.to`)."""

    up: UpEll              # dependencies per service, with overflow
    dn_idx: torch.Tensor   # int64 [n_pad, Dd] dependents per service
    dn_mask: torch.Tensor  # float32 [n_pad, Dd]
    dn_ovf: object         # segscan.SegLayout of the down overflow edges
    inv_deg: torch.Tensor  # float32 [n_pad] 1 / max(dependents, 1)


# Staged tables keyed by an edge-set digest, as the seg layouts are: a
# bounded FIFO of host builds and their copies per device.
_ELL_CACHE: dict = {}
_ELL_CACHE_MAX = 8


def ell_tables_for(n_pad: int, dep_src, dep_dst, device,
                   width_cap: int = DEFAULT_WIDTH_CAP) -> EllTables:
    """The full-ELL tables of one graph's RAW edges, on ``device``."""
    from rca_tpu_torch.engine.segscan import arrays_digest

    src = np.asarray(dep_src, np.int32)
    dst = np.asarray(dep_dst, np.int32)
    key = arrays_digest((n_pad, width_cap), (src, dst))
    hit = _ELL_CACHE.get(key)
    if hit is None:
        hit = {None: EllGraph.build(n_pad, src, dst, width_cap)}
        while len(_ELL_CACHE) >= _ELL_CACHE_MAX:
            _ELL_CACHE.pop(next(iter(_ELL_CACHE)))
        _ELL_CACHE[key] = hit
    dev = str(torch.device(device))
    if dev not in hit:
        hit[dev] = hit[None].to(device)
    return hit[dev]


def ell_down_step(m, a_ex, decay: float, ell: EllTables):
    """One impact step over the down table of one graph (``[n_pad]``
    vectors): gather each service's dependents, a row sum, the overflow
    edges' flagged segmented sum added in (:func:`.segscan.segscan_sum`,
    the scan kernel on a CUDA tensor), times the inverse dependent count,
    the dummy slot kept at 0."""
    from rca_tpu_torch.engine.segscan import segment_totals, segscan_sum

    vals = (a_ex[..., ell.dn_idx] + decay * m[..., ell.dn_idx]) * ell.dn_mask
    m_new = vals.sum(dim=-1)
    other = ell.dn_ovf.other_sorted
    ovf = a_ex[..., other] + decay * m[..., other]
    m_new = (m_new + segment_totals(ovf, ell.dn_ovf, "sum", segscan_sum)
             ) * ell.inv_deg
    dummy = torch.arange(m.shape[-1], device=m.device) == m.shape[-1] - 1
    return torch.where(dummy, 0.0, m_new)


def ell_core(a, h, ell: EllTables, steps: int, decay: float,
             explain_strength: float, impact_bonus: float, n_live):
    """The two recursions over the full-ELL tables from precomputed
    ``[n_pad]`` evidence, then the score: ``(a, h, u, m, score)``."""
    from rca_tpu_torch.engine.propagate import (
        background_excess,
        combine_score,
    )

    u = torch.zeros_like(a)
    for _ in range(steps):
        u = ell_up_step(u, h, decay, ell.up)
    a_ex = background_excess(a, n_live)
    m = torch.zeros_like(a)
    for _ in range(steps):
        m = ell_down_step(m, a_ex, decay, ell)
    score = combine_score(a, h, u, m, explain_strength, impact_bonus)
    return a, h, u, m, score


def propagate_ell(features, ell: EllTables, anomaly_w, hard_w, steps: int,
                  decay: float, explain_strength: float,
                  impact_bonus: float, n_live=None,
                  error_contrast: float = 0.0):
    """The reference's ``propagate_ell`` in plain PyTorch, from SANITIZED
    ``[n_pad, C]`` features: the noisy-OR pair, the error-source contrast
    over the up table (table lanes masked to the max identity 0, hub
    residue through the overflow scatter-max: the COO form's result), then
    :func:`ell_core`.  Returns ``(a, h, u, m, score)``.  The engine runs
    the registry row's own front instead (the kernels on the card) and
    then :func:`ell_core`."""
    from rca_tpu_torch.engine.evidence import (
        error_rate,
        fold_error_contrast,
        noisy_or_pair_plain,
    )
    from rca_tpu_torch.engine.segscan import scatter_max

    a, h = noisy_or_pair_plain(features, anomaly_w, hard_w)
    if error_contrast:
        e = error_rate(features)
        up = ell.up
        dep_max = (e[..., up.idx] * up.mask).amax(dim=-1)
        dep_max = torch.maximum(dep_max,
                                scatter_max(e, up.ovf_seg,
                                            e[..., up.ovf_other]))
        a = fold_error_contrast(a, torch.clamp(e - dep_max, min=0.0),
                                error_contrast)
    if n_live is None:
        n_live = features.shape[-2]
    return ell_core(a, h, ell, steps, decay, explain_strength, impact_bonus,
                    n_live)
