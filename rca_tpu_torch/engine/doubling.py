"""Log-depth operator doubling: the 8-step serial chain in base + 3
applications.

Counterpart of the JAX package's ``engine/doubling.py``, the registry's
``doubling`` row (``RCA_KERNEL=doubling``).  Both recursions of the
propagation admit doubling:

- **up-scan (max semiring)**: with the exact ``2^k``-hop frontier
  precomputed on the host, ``u_2k[s] = max(u_k[s], (decay*)^(2^k) max
  over the frontier of u_k)``, where ``(decay*)^(2^k)`` is ``2^k``
  SEQUENTIAL multiplies.  Every candidate value is ``h`` multiplied by
  the decay exactly as often, and in the same order, as the serial chain
  multiplies it, and float32 max is order-free, so :func:`doubling_up` is
  bitwise equal to the serial up-scan.
- **down-scan (affine map)**: one impact step is ``f(m) = decay*W m + W
  a_ex`` with ``W = D^-1 A^T``; with the weighted edge lists of
  ``W^(2^k)`` precomputed, ``v_{k+1} = decay^(2^k) (W^(2^k) v_k) + v_k``
  reaches ``m_8`` in base + 3 applications (:func:`doubling_down`).  The
  sums reassociate, so this direction is allclose to the serial chain,
  not bitwise.  Each level's sum is the flagged segmented sum over a
  dst-sorted layout of that level with its weights, never an atomic
  scatter-add, so two runs on one device give the same bits.

The frontier build (:func:`build_doubling`) is host numpy, byte for byte
the reference's, and declines (None) a depth that is not a power of two
or a graph whose frontiers pass :data:`MAX_FRONTIER_MULT` times the
padded edge tier; the kernel plan then falls back to the device's
default row.  The scans are plain PyTorch ops on every device (the
reference's row has no Pallas body); on the card the row's front is the
``kernels`` row's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from rca_tpu_torch.engine.segscan import (
    arrays_digest,
    build_seg_layout,
    scatter_max,
    segment_totals,
)

#: frontier blowup cap: a doubling layout whose total edge count exceeds
#: this multiple of the padded edge tier is declined (hub-heavy graphs
#: square into dense frontiers; the serial chain is cheaper there)
MAX_FRONTIER_MULT = 16


class DoublingLayout(NamedTuple):
    """One padded graph's doubled operators, per level ``k`` (tuples):

    - ``up_src/up_dst[k]``: the exact ``2^k``-hop dependency frontier;
    - ``dn_src/dn_dst/dn_w[k]``: the weighted edge list of ``W^(2^k)``;
    - ``dn_seg[k]`` / ``dn_w_sorted[k]``: that list sorted by destination
      (the segmented sum's layout) and its weights in the same order.

    The first five fields are the reference's arrays, padded to a
    power-of-two length per level with dummy self-loops of weight 0.
    numpy on the host; :meth:`to` moves them (ids as int64 for torch
    indexing)."""

    up_src: Tuple
    up_dst: Tuple
    dn_src: Tuple
    dn_dst: Tuple
    dn_w: Tuple
    dn_seg: Tuple
    dn_w_sorted: Tuple

    def to(self, device) -> "DoublingLayout":
        def ids(level):
            return tuple(torch.from_numpy(a.astype(np.int64)).to(device)
                         for a in level)

        def vals(level):
            return tuple(torch.from_numpy(a).to(device) for a in level)

        return DoublingLayout(
            ids(self.up_src), ids(self.up_dst), ids(self.dn_src),
            ids(self.dn_dst), vals(self.dn_w),
            tuple(seg.to(device) for seg in self.dn_seg),
            vals(self.dn_w_sorted))


def doubling_eligible(steps: int) -> bool:
    """Structural gate: the doubled ladder reaches exactly ``steps`` only
    when it is a power of two (>= 2)."""
    return steps >= 2 and (steps & (steps - 1)) == 0


def _compose_pairs(src1, dst1, src2, dst2, n_pad: int, cap: int,
                   w1=None, w2=None):
    """Relational composition of two edge lists: pairs (s, e) with s->x in
    (src1, dst1) and x->e in (src2, dst2), deduplicated; with weights,
    parallel paths aggregate by sum (operator product).  None when the
    join before deduplication exceeds ``cap``."""
    order = np.argsort(src2, kind="stable")
    s2, d2 = src2[order], dst2[order]
    w2s = w2[order] if w2 is not None else None
    left = np.searchsorted(s2, dst1, "left")
    right = np.searchsorted(s2, dst1, "right")
    counts = right - left
    total = int(counts.sum())
    if total > cap:
        return None
    if total == 0:
        empty = np.zeros(0, np.int32)
        return (empty, empty, np.zeros(0, np.float32)) \
            if w1 is not None else (empty, empty, None)
    rep = np.repeat(np.arange(len(src1)), counts)
    offs = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    idx2 = np.repeat(left, counts) + offs
    out_s = src1[rep].astype(np.int64)
    out_e = d2[idx2].astype(np.int64)
    key = out_s * n_pad + out_e
    if w1 is None:
        uniq = np.unique(key)
        return ((uniq // n_pad).astype(np.int32),
                (uniq % n_pad).astype(np.int32), None)
    uniq, inv = np.unique(key, return_inverse=True)
    agg = np.zeros(len(uniq), np.float64)
    np.add.at(agg, inv, (w1[rep] * w2s[idx2]).astype(np.float64))
    return ((uniq // n_pad).astype(np.int32),
            (uniq % n_pad).astype(np.int32), agg.astype(np.float32))


def _pad_level(src, dst, n_pad: int, w=None):
    """Pad one level to a power-of-two length with dummy self-loops
    (weight 0): a stable shape per tier, contributions that change
    nothing (a max of a zeroed row, an add of 0)."""
    e = max(1, len(src))
    e_pad = 1 << (e - 1).bit_length()
    dummy = n_pad - 1
    s = np.full(e_pad, dummy, np.int32)
    d = np.full(e_pad, dummy, np.int32)
    s[: len(src)] = src
    d[: len(dst)] = dst
    if w is None:
        return s, d, None
    wv = np.zeros(e_pad, np.float32)
    wv[: len(w)] = w
    return s, d, wv


def build_doubling(n_pad: int, e_pad: int, dep_src, dep_dst,
                   steps: int) -> Optional[DoublingLayout]:
    """Host-side frontier construction for one padded graph from its RAW
    edges, or None when the depth is not a power of two or the frontiers
    pass the cap."""
    if not doubling_eligible(steps):
        return None
    src = np.asarray(dep_src, np.int64)
    dst = np.asarray(dep_dst, np.int64)
    cap = MAX_FRONTIER_MULT * max(int(e_pad), 1)
    # down-scan base weights: W[d, s] = inv_deg[d] per edge (s, d), the
    # degree over real edges only (padded slots land on the dummy row)
    deg = np.bincount(dst, minlength=n_pad).astype(np.float32)
    inv_deg = 1.0 / np.maximum(deg, 1.0)
    levels = steps.bit_length() - 1        # steps = 2 ** levels
    up_s, up_d = [src.astype(np.int32)], [dst.astype(np.int32)]
    dn_s = [src.astype(np.int32)]
    dn_d = [dst.astype(np.int32)]
    dn_w = [inv_deg[dst].astype(np.float32)]
    total = len(src)
    for _ in range(1, levels):
        nxt = _compose_pairs(up_s[-1], up_d[-1], up_s[-1], up_d[-1],
                             n_pad, cap)
        if nxt is None:
            return None
        up_s.append(nxt[0])
        up_d.append(nxt[1])
        wnxt = _compose_pairs(dn_s[-1], dn_d[-1], dn_s[-1], dn_d[-1],
                              n_pad, cap, w1=dn_w[-1], w2=dn_w[-1])
        if wnxt is None:
            return None
        dn_s.append(wnxt[0])
        dn_d.append(wnxt[1])
        dn_w.append(wnxt[2])
        total += len(nxt[0]) + len(wnxt[0])
        if total > cap:
            return None
    fields = ([], [], [], [], [], [], [])
    for k in range(levels):
        s, d, _ = _pad_level(up_s[k], up_d[k], n_pad)
        ds, dd, dw = _pad_level(dn_s[k], dn_d[k], n_pad, dn_w[k])
        # the level's sum layout: segments are destinations, and the
        # weights follow the same stable sort
        order = np.argsort(dd, kind="stable")
        seg = build_seg_layout(n_pad, len(dd), dd, ds)
        for field, value in zip(fields, (s, d, ds, dd, dw, seg, dw[order])):
            field.append(value)
    return DoublingLayout(*(tuple(f) for f in fields))


def doubling_up(h, decay: float, dbl: DoublingLayout):
    """The whole up-scan in log depth over ``[n_pad]`` (or ``[B, n_pad]``
    lanes): a max of ``h`` over the 1-hop edges (serial step 1 from
    ``u = 0``), then per level the max over the ``2^k``-hop frontier after
    ``2^k`` sequential decay multiplies, bitwise the serial chain."""
    u = scatter_max(h, dbl.up_src[0], h[..., dbl.up_dst[0]])
    for k in range(len(dbl.up_src)):
        vals = u[..., dbl.up_dst[k]]
        for _ in range(1 << k):
            vals = decay * vals
        u = torch.maximum(u, scatter_max(u, dbl.up_src[k], vals))
    return u


def doubling_down(a_ex, decay: float, dbl: DoublingLayout, inv_deg):
    """The whole impact scan in log depth: the base ``v_0 = W a_ex`` (the
    serial step from ``m = 0``, summed then normalized), then ``v_{k+1} =
    decay^(2^k) (W^(2^k) v_k) + v_k`` per level, each sum over its level's
    dst-sorted layout."""
    base = dbl.dn_seg[0]
    v = segment_totals(a_ex[..., base.other_sorted], base, "sum") * inv_deg
    for k, seg in enumerate(dbl.dn_seg):
        applied = segment_totals(
            dbl.dn_w_sorted[k] * v[..., seg.other_sorted], seg, "sum")
        v = (decay ** (1 << k)) * applied + v
    return v


# -- the per-graph layout cache (the seg layouts' digest discipline) ----------

_DOUBLING_CACHE: dict = {}
_DOUBLING_CACHE_MAX = 32


def doubling_layouts_for(n_pad: int, e_pad: int, dep_src, dep_dst,
                         steps: int, device=None) -> Optional[DoublingLayout]:
    """Digest-cached :func:`build_doubling` for one edge set (the host
    join costs milliseconds at the 50k tier, paid once per graph): the
    host layout, or with ``device`` its tensors there.  A cached None
    records a decline, so a hub graph does not re-pay the join on every
    request."""
    src = np.asarray(dep_src)
    dst = np.asarray(dep_dst)
    key = arrays_digest((n_pad, e_pad, steps), (src, dst))
    hit = _DOUBLING_CACHE.get(key)
    if hit is None:
        hit = {None: build_doubling(n_pad, e_pad, src, dst, steps)}
        while len(_DOUBLING_CACHE) >= _DOUBLING_CACHE_MAX:
            _DOUBLING_CACHE.pop(next(iter(_DOUBLING_CACHE)))
        _DOUBLING_CACHE[key] = hit
    if device is None or hit[None] is None:
        return hit[None]
    dev = str(torch.device(device))
    if dev not in hit:
        hit[dev] = hit[None].to(device)
    return hit[dev]
