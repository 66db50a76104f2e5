"""The cost model: the bytes each of the port's kernels, and each stage of
one ranked propagation, must move and the operations it must do.

One model serves two readers: ``chip_smoke.py`` divides it by the card's
peaks for each kernel's bound (:func:`bound_ms`), and the kernel
registry's cost capture (``engine/registry.py::_capture_cost``) sums the
stages of the canonical call (:func:`propagation`) into a row's
``flops`` and ``bytes_accessed``.

Every function returns ``(bytes, operations)`` as Python ints, for one
call over ``lanes`` lanes of one graph of ``n_pad`` padded nodes and
``e_pad`` padded edges.  Bytes count each input read once and each output
written once, whatever a kernel reads again; operations count the float
and integer operations of the arithmetic (3 per edge and 1 per node of a
seg step, the noisy-OR's per-channel terms), not the instructions a
kernel issues.  The CSR a seg step reads is the row pointer and the other
endpoints, int32 (:func:`csr_bytes`); the fused recursions also read their
layout's long-segment ids (``n_long``: segments longer than one thread
reduces, so this count is the graph's, not the shape's).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

from rca_tpu_torch.features.schema import NUM_SERVICE_FEATURES

#: published peaks of one H100 SXM (data sheet, dense, at 700 W): HBM
#: bytes/s and float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
#: one H100 SXM's NVLink rate in each direction, all its links together:
#: 18 links at 26.562 GB/s each, as ``nvidia-smi nvlink -s`` reads them
#: on a four-card host (``chip_smoke.py --multi-card`` records the
#: reading); the data sheet's 900 GB/s counts both directions
NVLINK_BYTES_PER_S = 18 * 26.562e9

#: the service feature channels
C = NUM_SERVICE_FEATURES

Cost = Tuple[int, int]


def bound_ms(n_bytes: float, n_ops: float) -> Tuple[float, str]:
    """The least time the card could take for this work: the larger of the
    bytes over the memory rate and the operations over the float32 rate,
    in ms, and which of the two bounds it (``"bytes"`` / ``"operations"``)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def csr_bytes(n_pad: int, e_pad: int) -> int:
    """A seg layout's CSR: the other endpoint of every edge and the row
    pointer, int32."""
    return e_pad * 4 + (n_pad + 1) * 4


def _noisy_ops(n_pad: int, lanes: int, channels: int) -> int:
    # 7 a channel (the clip, then for each of the pair the weighted term,
    # its complement and the running product), 8 a row (the complements,
    # the error rate, the sanitize)
    return lanes * n_pad * (channels * (1 + 2 + 2 * 2) + 2 * 2 + 2 + 2)


# -- the kernels ----------------------------------------------------------

def noisy_or_pair(n_pad: int, channels: int = C) -> Cost:
    """``noisy_or_pair``: the features and both weight vectors read, ``a``
    and ``h`` written."""
    return (n_pad * channels * 4 + 2 * channels * 4 + 2 * n_pad * 4,
            n_pad * (channels * 2 * 3 + 2 * 2 + 2))


def segscan(e_pad: int) -> Cost:
    """``segscan_sum`` / ``segscan_max``: values and flags read, the scan
    written; one operation an element."""
    return 3 * e_pad * 4, e_pad


def front_rows(n_pad: int, lanes: int = 1, channels: int = C) -> Cost:
    """``evidence_front``, the front's row pass: the raw features and the
    weights read, ``a_raw``, ``h`` and the error rate written, the bad-row
    count."""
    return (lanes * n_pad * channels * 4 + 2 * channels * 4
            + 3 * lanes * n_pad * 4 + 4, _noisy_ops(n_pad, lanes, channels))


def contrast(n_pad: int, e_pad: int, lanes: int = 1) -> Cost:
    """``seg_contrast_step``, the front's error-source contrast over the up
    layout: the CSR, ``a_raw`` and the error rate read, ``a`` written."""
    return (csr_bytes(n_pad, e_pad) + 3 * lanes * n_pad * 4,
            lanes * (e_pad + 6 * n_pad))


def front(n_pad: int, e_pad: int, lanes: int = 1, channels: int = C) -> Cost:
    """``evidence_front_fused``, the whole front in one launch: the features
    and weights read, the up layout's CSR and its segment bins (``n_pad``
    ids), ``a`` and ``h`` written, the bad-row count; the row pass's and
    the contrast's operations."""
    return (lanes * n_pad * channels * 4 + 2 * channels * 4
            + csr_bytes(n_pad, e_pad) + n_pad * 4 + 2 * lanes * n_pad * 4 + 4,
            _noisy_ops(n_pad, lanes, channels) + lanes * (e_pad + 6 * n_pad))


def front_shard(n_pad: int, e: int, lanes: int = 1,
                channels: int = C) -> Cost:
    """``evidence_front_shard``, the front of every shard of one card over
    their ``n_pad`` joined rows and ``e`` real edges: the rows and weights
    read, the joined up layout's CSR, ``a`` and ``h`` written; the
    operations of :func:`front`.  No segment order (the launch's own
    permutation of the work) and no bad-row count (it writes none)."""
    return (lanes * n_pad * channels * 4 + 2 * channels * 4
            + csr_bytes(n_pad, e) + 2 * lanes * n_pad * 4,
            _noisy_ops(n_pad, lanes, channels) + lanes * (e + 6 * n_pad))


def up_step(n_pad: int, e_pad: int, lanes: int = 1) -> Cost:
    """``seg_up_step``, one explain-away step: the CSR, ``u`` and ``h``
    read, the next ``u`` written; 3 operations an edge, 1 a node."""
    return (csr_bytes(n_pad, e_pad) + 3 * lanes * n_pad * 4,
            lanes * (3 * e_pad + n_pad))


def down_step(n_pad: int, e_pad: int, lanes: int = 1) -> Cost:
    """``seg_down_step``, one impact step: the CSR, the shared inverse
    degree, ``m`` and ``a_ex`` read, the next ``m`` written."""
    return (csr_bytes(n_pad, e_pad) + n_pad * 4 + 3 * lanes * n_pad * 4,
            lanes * (3 * e_pad + n_pad))


def _steps(n_pad: int, e_pad: int, n_long: int, lanes: int, steps: int,
           shared: int) -> Cost:
    csr = (n_pad + 1 + e_pad + n_long) * 4
    vec = (2 * lanes + shared) * n_pad * 4
    return csr + vec, lanes * steps * (3 * e_pad + n_pad)


def up_steps(n_pad: int, e_pad: int, n_long: int, lanes: int = 1,
             steps: int = 8) -> Cost:
    """``seg_up_steps``, the fused explain-away recursion, its grid form
    ``seg_up_steps_grid`` and its shard form ``seg_up_steps_shard`` (the
    same work, so the bound reads the same whatever form runs it; the
    shard form over the real edges, ``n_long`` 0): one pass over the CSR
    and its long-segment ids, ``h`` read, ``u`` written; each step's
    operations."""
    return _steps(n_pad, e_pad, n_long, lanes, steps, 0)


def down_steps(n_pad: int, e_pad: int, n_long: int, lanes: int = 1,
               steps: int = 8, pairs: int = 0) -> Cost:
    """``seg_down_steps``, the fused impact recursion, its grid form
    ``seg_down_steps_grid`` and its shard form ``seg_down_steps_shard``:
    as :func:`up_steps`, with ``a_ex`` and the shared inverse degree read,
    ``m`` written; the shard form also adds each of its ``pairs``
    (shard, destination) contributions a step, in the fixed shard
    order."""
    n_bytes, n_ops = _steps(n_pad, e_pad, n_long, lanes, steps, 1)
    return n_bytes, n_ops + lanes * steps * pairs


PeerCost = Tuple[int, int, int]


def bound_peer_ms(hbm_bytes: float, link_bytes: float, n_ops: float,
                  link_rate: float = NVLINK_BYTES_PER_S) -> Tuple[float, str]:
    """:func:`bound_ms` of a card that also pushes ``link_bytes`` into its
    peers' memory: the larger of its own HBM bytes over the memory rate,
    its pushed bytes over the NVLink rate in one direction, and its
    operations over the float32 rate (``"bytes"`` for either bytes
    term)."""
    t, by = bound_ms(hbm_bytes, n_ops)
    t_link = link_bytes / link_rate * 1e3
    return (t_link, "bytes") if t_link > t else (t, by)


def up_steps_peer(n_pad: int, sp: int, e_k: int, lanes: int = 1,
                  steps: int = 8) -> PeerCost:
    """``seg_up_steps_peer``, one card's launch of the explain-away
    recursion over distinct cards, ``(hbm bytes, nvlink bytes,
    operations)``: its up CSR over its ``block = n_pad / sp`` sources and
    ``e_k`` real edges, its full ``h`` read, its block of ``u`` written;
    pushed, its block of ``w`` to each of the ``sp - 1`` peers at every
    step but the last; each step's operations over its edges."""
    block = n_pad // sp
    return ((block + 1 + e_k) * 4 + lanes * (n_pad + block) * 4,
            (steps - 1) * (sp - 1) * lanes * block * 4,
            lanes * steps * (3 * e_k + block))


def down_steps_peer(n_pad: int, sp: int, e_k: int, pairs_k: int,
                    lanes: int = 1, steps: int = 8) -> PeerCost:
    """``seg_down_steps_peer``, one card's launch of the impact recursion
    over distinct cards: its CSR over its ``pairs_k`` (card, destination)
    pairs and ``e_k`` real edges, ``a_ex`` at its own sources and its
    block of ``inv_deg`` read, its block of ``m`` written; pushed, every
    step its contributions to the ``sp - 1`` other owners (the
    reduce-scatter's volume, zeros included) and at every step but the
    last its block of ``w`` to each peer; each step's operations over its
    edges, the ``sp - 1`` adds and the multiply of each of its nodes."""
    block = n_pad // sp
    return ((pairs_k + 1 + e_k) * 4 + block * 4 + 2 * lanes * block * 4,
            (2 * steps - 1) * (sp - 1) * lanes * block * 4,
            lanes * steps * (3 * e_k + sp * block))


def up_step_shard(e_k: int, b_k: int, n_dst: int, n_dst_own: int) -> Cost:
    """``seg_up_step``'s per-shard entry over a block of ``b_k`` nodes and
    ``e_k`` edges: the block's CSR and ids, ``u`` at the ``n_dst`` distinct
    destinations read, ``h`` at the ``n_dst_own`` ones the block owns or
    reads, the block's ``u`` written."""
    up_csr = e_k * 4 + (b_k + 1) * 4 + b_k * 4
    return up_csr + (n_dst + n_dst_own + b_k) * 4, 3 * e_k + b_k


def down_step_shard(e_k: int, np_k: int, n_src: int) -> Cost:
    """``seg_down_step``'s per-shard entry: the block's CSR over ``np_k``
    segments, ``m`` and ``a_ex`` at the ``n_src`` distinct sources read,
    the sums written."""
    dn_csr = e_k * 4 + (np_k + 1) * 4 + np_k * 4
    return dn_csr + (2 * n_src + np_k) * 4, 3 * e_k


def contrast_shard(e_k: int, b_k: int, n_dst_own: int) -> Cost:
    """``seg_contrast_step``'s per-shard entry: the block's up CSR, the
    error rate at ``n_dst_own`` nodes, ``a_raw`` read and ``a`` written."""
    up_csr = e_k * 4 + (b_k + 1) * 4 + b_k * 4
    return up_csr + (n_dst_own + 2 * b_k) * 4, e_k + 7 * b_k


# -- the stages of one ranked propagation around the kernels ---------------

def _sort_ops(n: int) -> int:
    return n * max(1, math.ceil(math.log2(max(n, 2))))


def background(n_pad: int, e_pad: int, lanes: int = 1) -> Cost:
    """The live-median background and the inverse degree: ``a`` read and
    ``a_ex`` written; the int64 edge destinations read and the inverse
    degree written.  Operations: the median's sort (``n log2 n``
    comparisons), the excess's subtract and max, a count an edge and a
    reciprocal a node."""
    return (2 * lanes * n_pad * 4 + e_pad * 8 + n_pad * 4,
            lanes * (_sort_ops(n_pad) + 2 * n_pad) + e_pad + n_pad)


def score(n_pad: int, lanes: int = 1) -> Cost:
    """``combine_score`` and the diagnostic stack: ``a``, ``h``, ``u`` and
    ``m`` read, the ``[4, n_pad]`` stack of ``a``, ``u``, ``m`` and the
    score written; 9 operations a node (a tanh, five products, three
    sums)."""
    return 8 * lanes * n_pad * 4, 9 * lanes * n_pad


def top_k(n_pad: int, k: int, lanes: int = 1) -> Cost:
    """The top-k: the score read, ``k`` values, ``k`` int64 indices and the
    ``[4, k]`` diagnostic gather written; its stable sort's comparisons."""
    return lanes * (n_pad * 4 + k * (4 + 8) + 4 * k * 4), \
        lanes * _sort_ops(n_pad)


def propagation(n_pad: int, e_pad: int, n_long_up: int, n_long_down: int,
                k: int, steps: int = 8, lanes: int = 1,
                channels: int = C) -> Dict[str, Cost]:
    """The stages of one ranked propagation, whichever row runs it: the
    front (:func:`front`), the two recursions as one pass each
    (:func:`up_steps`, :func:`down_steps`), :func:`background`,
    :func:`score` and :func:`top_k`.  Each stage reads its inputs and
    writes its outputs once; what passes between stages goes through
    memory, as it does on every row."""
    return {
        "front": front(n_pad, e_pad, lanes, channels),
        "up": up_steps(n_pad, e_pad, n_long_up, lanes, steps),
        "background": background(n_pad, e_pad, lanes),
        "down": down_steps(n_pad, e_pad, n_long_down, lanes, steps),
        "score": score(n_pad, lanes),
        "top_k": top_k(n_pad, k, lanes),
    }
