"""The hybrid layout's up-table: each service's dependencies in a narrow
gather table, the residue of hub rows in a short overflow list.

Counterpart of the JAX package's ``engine/ell.py`` (``build_ell_segments``,
``ell_up_step``) and ``engine/runner.py`` (``build_up_ell``,
``up_ell_for``).  The ``torch`` row of the kernel registry takes its
explain-away up-steps over this table, as the reference's differentiable
``xla`` body does.  That is more than a layout choice: the gradient of a
max splits evenly among tied entries, the table's padded slots included,
so attribution's saliency matches the reference's only over the same
table, width ``UP_WIDTH_CAP`` and overflow included.  The tables are made
on the host in numpy, byte for byte the reference's.
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
