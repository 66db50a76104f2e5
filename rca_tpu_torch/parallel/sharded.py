"""Node-sharded propagation over a device mesh, in one process.

Counterpart of the JAX package's ``parallel/sharded.py``.  The service
graph's node arrays split over the mesh's ``sp`` axis: shard ``k`` owns
the contiguous node block ``[k*block, (k+1)*block)`` and the edge
partition whose SOURCES lie in its block.  Every propagation step
exchanges cross-shard state with the collectives of
:mod:`rca_tpu_torch.parallel.collectives`:

- explain-away (segment max): ``all_gather`` the per-block ``u``, then each
  shard reduces its own sources over its edges into its block;
- impact (segment sum): each shard computes its full-length contribution
  vector over its edges, then ``psum_scatter`` hands every shard its
  reduced block, which ``inv_deg`` scales.

Per shard and step that is one launch of a seg-step kernel's per-shard
entry on the card (``csrc/segstep.cu``; on the CPU its plain version),
the reference's ``pallas_segscan_max`` (``sharded.py:252``) and
``pallas_segscan`` (``:285``) with the step bodies around them: the
``step`` form of the plan (:func:`shard_steps_form`), where the shards
mix cards or their cards do not reach each other's memory.  Where every
shard of a ``dp`` row lies on one card (logical shards), the plan's form
is ``shard_grid``: each recursion is one cooperative launch over every
shard of the card (``csrc/segshard.cu``), ``u`` and ``m`` one ``[...,
n_pad]`` vector each whose blocks are the shards', and the exchange
between steps a grid barrier, bitwise the ``step`` form.  Where the
shards lie one a card on cards that all reach each other's memory (the
multi-card default), the form is ``peer``: each recursion is one
cooperative launch a card (``csrc/segpeer.cu``) that stores its block
into every peer's copy over NVLink and crosses a barrier of all the
cards on flags in peer memory, bitwise the ``step`` form too; the front
and its gathers stay as the ``step`` form runs them.  The front in the
``step`` form is ``evidence_front``'s row pass over the shard's ``[block,
C]`` rows (one launch: the sanitize, ``a``, ``h``, ``e``) and the
contrast's per-shard entry over the one-time ``e`` gather, then the ``h``
/ ``a`` gathers; in the ``shard_grid`` form
it is one cooperative launch over every shard's rows
(``csrc/frontshard.cu``) whose joined ``[..., n_pad]`` ``a`` and ``h`` are
what the gathers would hand each shard, so the score and the stack run
once over the joined vectors and each shard's stack is a view.
Hypothesis batches split over ``dp``: each ``dp`` row of the mesh runs its
lanes through its own shards.

The shards' work runs in a Python loop, shard after shard, each on its own
device's current stream; nothing here synchronizes with the host.  ``a``,
``h`` and ``u`` come out bitwise the dense engine's (the same row pass and
max reductions); ``m`` and the score differ from it only by the order of
the impact sum (each shard's partial sums, then the shards in order
``0..sp-1``), and two runs give the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from rca_tpu_torch.engine.evidence import (
    evidence_front_rows,
    evidence_front_rows_plain,
    evidence_front_shard,
    seg_contrast_step_shard,
    seg_contrast_step_shard_plain,
)
from rca_tpu_torch.engine.fetch import device_get
from rca_tpu_torch.engine.propagate import background_excess, combine_score
from rca_tpu_torch.engine.resident import ResidentSession
from rca_tpu_torch.engine.runner import top_k, topk_diag
from rca_tpu_torch.engine.segscan import (
    MAX_PEER_CARDS,
    SHORT_SEGMENT_MAX,
    PeerGrid,
    ShardGrid,
    ShardSeg,
    arrays_digest,
    build_peer_layouts,
    build_shard_grid,
    down_seg_step_shard,
    down_seg_steps_peer,
    down_seg_steps_shard,
    down_shard_recursion,
    peer_grid,
    up_seg_step_shard,
    up_seg_steps_peer,
    up_seg_steps_shard,
    up_shard_recursion,
)
from rca_tpu_torch.parallel.collectives import (
    all_gather,
    gather_to,
    psum_scatter,
)
from rca_tpu_torch.parallel.rules import (
    GRAPH_RULES,
    make_shard_fns,
    match_partition_rules,
)


@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """Edge partition for an sp-way node sharding."""

    n_pad: int                 # padded node count (multiple of sp)
    n: int                     # real node count (slots n..n_pad-1 are pad)
    block: int                 # nodes per shard = n_pad // sp
    sp: int
    src_local: np.ndarray      # int32 [sp, e_pad], src index within block
    src_global: np.ndarray     # int32 [sp, e_pad]
    dst_global: np.ndarray     # int32 [sp, e_pad]
    mask: np.ndarray           # float32 [sp, e_pad], 1 real, 0 padding


def shard_graph(n: int, src: np.ndarray, dst: np.ndarray, sp: int, *,
                n_pad_to: int = 0, e_pad_fn=None) -> ShardedGraph:
    """Partition edges by source-node shard; pad shards to equal length.
    ``n_pad_to``: pad the node axis to at least this many slots, rounded
    up to a multiple of ``sp``; ``e_pad_fn`` buckets the per-shard edge
    row length.  Byte-equal to the reference's."""
    block = -(-max(n, 1, n_pad_to) // sp)
    n_pad = block * sp
    shard_of = ((src // block).astype(np.int64) if len(src)
                else np.zeros(0, np.int64))
    per_shard = [np.nonzero(shard_of == k)[0] for k in range(sp)]
    e_pad = max(1, max((len(ix) for ix in per_shard), default=1))
    if e_pad_fn is not None:
        e_pad = max(e_pad, int(e_pad_fn(e_pad)))
    src_local = np.zeros((sp, e_pad), dtype=np.int32)
    src_global = np.zeros((sp, e_pad), dtype=np.int32)
    dst_global = np.zeros((sp, e_pad), dtype=np.int32)
    mask = np.zeros((sp, e_pad), dtype=np.float32)
    for k, ix in enumerate(per_shard):
        m = len(ix)
        if m:
            src_global[k, :m] = src[ix]
            src_local[k, :m] = src[ix] - k * block
            dst_global[k, :m] = dst[ix]
            mask[k, :m] = 1.0
    return ShardedGraph(n_pad=n_pad, n=n, block=block, sp=sp,
                        src_local=src_local, src_global=src_global,
                        dst_global=dst_global, mask=mask)


class ShardedSegLayouts(NamedTuple):
    """Per-shard seg layouts, stacked ``[sp, ...]`` on the host.  The first
    ten fields are the reference's, byte-equal: each shard's edges sorted
    by segment (destinations for ``dn``, the shard's own sources for
    ``up``), padding in the last segment with mask 0.  The last six are
    the CSR form the per-shard kernels read, as :class:`SegLayout` carries
    it: ``offsets`` over the REAL edges only (the sorted ``*_other`` is the
    CSR's endpoint array, the padding trailing past the last offset), and
    the segment ids ordered long ones first, ``*_n_long`` of them (more
    than ``SHORT_SEGMENT_MAX`` edges: a block each), then the short
    ones."""

    dn_other: np.ndarray      # int32 [sp, e_pad], src, dst-sorted
    dn_mask: np.ndarray       # f32 [sp, e_pad]
    dn_flags: np.ndarray      # f32 [sp, e_pad], 1 at each dst-run start
    dn_ends: np.ndarray       # int32 [sp, n_pad], last edge pos per dst
    dn_has: np.ndarray        # f32 [sp, n_pad], dst has local edges
    up_other: np.ndarray      # int32 [sp, e_pad], dst, src-local-sorted
    up_mask: np.ndarray       # f32 [sp, e_pad]
    up_flags: np.ndarray      # f32 [sp, e_pad]
    up_ends: np.ndarray       # int32 [sp, block], last edge pos per src
    up_has: np.ndarray        # f32 [sp, block]
    dn_offsets: np.ndarray    # int32 [sp, n_pad + 1], real edges
    dn_seg_order: np.ndarray  # int32 [sp, n_pad], long segments first
    dn_n_long: np.ndarray     # int32 [sp]
    up_offsets: np.ndarray    # int32 [sp, block + 1]
    up_seg_order: np.ndarray  # int32 [sp, block]
    up_n_long: np.ndarray     # int32 [sp]


def _seg_direction(seg, other, mask, n_seg: int,
                   short_max: int = SHORT_SEGMENT_MAX):
    """One shard, one scan direction: the reference's five arrays (padded
    slots sort into segment ``n_seg - 1``, after its real edges, since the
    sort is stable and the padding trails the real rows), then the CSR
    offsets over real edges, the segment order and the long count."""
    real = mask > 0
    seg_all = np.where(real, seg, n_seg - 1).astype(np.int64)
    order = np.argsort(seg_all, kind="stable")
    seg_s = seg_all[order]
    counts = np.bincount(seg_s, minlength=n_seg)
    ends = np.cumsum(counts)
    starts = ends - counts
    flags = np.zeros(len(seg_all), np.float32)
    flags[starts[counts > 0]] = 1.0
    real_counts = np.bincount(seg_all[real], minlength=n_seg)
    long_seg = real_counts > short_max
    return (
        other[order].astype(np.int32),
        mask[order].astype(np.float32),
        flags,
        (ends - 1).clip(0).astype(np.int32),
        (counts > 0).astype(np.float32),
    ), (
        np.concatenate([[0], np.cumsum(real_counts)]).astype(np.int32),
        np.concatenate([np.flatnonzero(long_seg),
                        np.flatnonzero(~long_seg)]).astype(np.int32),
        np.int32(long_seg.sum()),
    )


# built layouts keyed on the graph's edge digest: the per-shard argsort and
# bincount cost host milliseconds at the 50k tier, paid once per edge set.
# Each entry holds the host layouts (key None) and their device plans per
# (devices, row).  Insertion-ordered dict as a bounded FIFO.
_SHARD_LAYOUT_CACHE: dict = {}
_SHARD_LAYOUT_CACHE_MAX = 16


def _layout_key(graph: ShardedGraph) -> bytes:
    return arrays_digest(
        (graph.n_pad, graph.sp, graph.src_local.shape[1]),
        (graph.src_global, graph.dst_global, graph.mask),
    )


def _cache_entry(graph: ShardedGraph) -> dict:
    key = _layout_key(graph)
    hit = _SHARD_LAYOUT_CACHE.get(key)
    if hit is None:
        ref_cols = [[] for _ in range(10)]
        csr_cols = [[] for _ in range(6)]
        for k in range(graph.sp):
            dn, dn_csr = _seg_direction(graph.dst_global[k],
                                        graph.src_global[k], graph.mask[k],
                                        graph.n_pad)
            up, up_csr = _seg_direction(graph.src_local[k],
                                        graph.dst_global[k], graph.mask[k],
                                        graph.block)
            for i, arr in enumerate(dn + up):
                ref_cols[i].append(arr)
            for i, arr in enumerate(dn_csr + up_csr):
                csr_cols[i].append(arr)
        hit = {None: ShardedSegLayouts(
            *(np.stack(c) for c in ref_cols),
            *(np.stack(c) for c in csr_cols))}
        while len(_SHARD_LAYOUT_CACHE) >= _SHARD_LAYOUT_CACHE_MAX:
            _SHARD_LAYOUT_CACHE.pop(next(iter(_SHARD_LAYOUT_CACHE)))
        _SHARD_LAYOUT_CACHE[key] = hit
    return hit


def build_sharded_seg_layouts(graph: ShardedGraph) -> ShardedSegLayouts:
    """Host-side per-shard layouts (digest-cached)."""
    return _cache_entry(graph)[None]


# -- the device plan ----------------------------------------------------------

def _peer_reach(devs) -> bool:
    """Whether every ordered pair of the distinct CUDA devices ``devs``
    reaches the other's memory (``torch.cuda.can_device_access_peer``),
    each a visible card, at most ``MAX_PEER_CARDS`` of them."""
    index = [d.index for d in devs]
    if len(devs) > MAX_PEER_CARDS or None in index or \
            max(index) >= torch.cuda.device_count():
        return False
    return all(torch.cuda.can_device_access_peer(i, j)
               for i in index for j in index if i != j)


def shard_steps_form(devices) -> str:
    """The form of the ``kernels`` row's recursions over one ``dp`` row's
    shard ``devices`` (``ShardPlan.steps_form``), from the hardware's
    facts: ``shard_grid``, one cooperative launch per recursion over every
    shard, where every shard lies on one CUDA device (logical shards);
    ``peer``, one cooperative launch per card and recursion exchanging
    blocks through peer memory, where the shards lie one a card on
    distinct CUDA devices that all reach each other's memory; ``step``, a
    launch a shard and step between collectives, elsewhere: mixed
    placements, cards without peer access, and the CPU (there every form
    computes the same composition of plain steps).  No form falls back to
    another: a launch that fails raises."""
    devs = [torch.device(d) for d in devices]
    if any(d.type != "cuda" for d in devs):
        return "step"
    if len(set(devs)) == 1:
        return "shard_grid"
    if len(set(devs)) == len(devs) and _peer_reach(devs):
        return "peer"
    return "step"


def shard_steps_note(sp: int, device, devices=None) -> str:
    """What a sharded ``kernels`` plan runs for its two recursions
    (:func:`shard_steps_form`): over ``sp`` logical shards of ``device``,
    or over the shard ``devices`` given."""
    devices = list(devices) if devices else [device] * sp
    form = shard_steps_form(devices)
    if form == "shard_grid":
        return (f"shard_grid: {sp} logical shards of {device}, one "
                f"cooperative launch for the front and one per recursion "
                f"over every shard (evidence_front_shard, "
                f"seg_up_steps_shard, seg_down_steps_shard); shards one a "
                f"card on cards that reach each other's memory take peer, "
                f"other placements step")
    if form == "peer":
        return (f"peer: {len(devices)} shards one a card on "
                f"{', '.join(map(str, devices))}, one cooperative launch "
                f"a card per recursion exchanging blocks through peer "
                f"memory (seg_up_steps_peer, seg_down_steps_peer); the "
                f"front per shard between the collectives")
    where = ", ".join(map(str, dict.fromkeys(devices)))
    return (f"step: a launch a shard and step between collectives; on "
            f"{where} the plan runs the "
            + ("per-shard kernels (mixed placements or cards without "
               "peer access)" if torch.device(devices[0]).type == "cuda"
               else "plain steps"))


class ShardPlan(NamedTuple):
    """One ``dp`` row's staged graph: the engaged row (``kernels`` or
    ``torch``), the shards' devices, and per shard its two layouts and its
    edge rows' destinations and mask (the degree count), on its device;
    ``grid``, the shards' joined layouts on their card where the
    recursions take the ``shard_grid`` form, and ``peer``, each card's
    layouts, exchange buffers and flags where they take the ``peer`` form
    (each only on the ``kernels`` row, where :func:`shard_steps_form`
    gives it), else None."""

    kernel: str
    devices: Tuple[torch.device, ...]
    block: int
    n_pad: int
    dn: Tuple[ShardSeg, ...]
    up: Tuple[ShardSeg, ...]
    dst_global: Tuple[torch.Tensor, ...]   # int64 [e_pad]
    mask: Tuple[torch.Tensor, ...]         # float32 [e_pad]
    grid: Optional[ShardGrid] = None
    peer: Optional[PeerGrid] = None

    @property
    def steps_form(self) -> str:
        """The recursions' form: ``shard_grid`` where the plan holds a
        grid, ``peer`` where it holds the peer state, else ``step``."""
        if self.grid is not None:
            return "shard_grid"
        return "step" if self.peer is None else "peer"


_EDGE_NAMES = ("dst_global", "mask")


def _grid_on(entry: dict, device) -> ShardGrid:
    """The graph's :class:`ShardGrid` on ``device`` (digest-cached with the
    graph's layouts: built on the host once, moved once per device)."""
    key = ("grid", str(device))
    if key not in entry:
        if "grid" not in entry:
            lay = entry[None]
            entry["grid"] = build_shard_grid(lay.up_offsets, lay.up_other,
                                             lay.dn_offsets, lay.dn_other)
        entry[key] = entry["grid"].to(device)
    return entry[key]


def _peer_on(entry: dict, devices) -> PeerGrid:
    """The graph's :class:`PeerGrid` on ``devices`` (digest-cached with the
    graph's layouts: each card's layouts built on the host once, moved
    once per device list)."""
    key = ("peer", tuple(str(d) for d in devices))
    if key not in entry:
        lay = entry[None]
        if "peer" not in entry:
            entry["peer"] = build_peer_layouts(lay.up_offsets, lay.up_other,
                                               lay.dn_offsets, lay.dn_other)
        entry[key] = peer_grid(entry["peer"], devices)
    return entry[key]


def _as_row(entry: dict, plan: ShardPlan, kernel: str) -> ShardPlan:
    """``plan`` for the registry row ``kernel``, in the form it takes
    there."""
    form = shard_steps_form(plan.devices) if kernel == "kernels" else "step"
    return plan._replace(
        kernel=kernel,
        grid=_grid_on(entry, plan.devices[0]) if form == "shard_grid"
        else None,
        peer=_peer_on(entry, plan.devices) if form == "peer" else None)


def _shard_seg(fields: dict, prefix: str, n_long: int) -> ShardSeg:
    """A :class:`ShardSeg` from one shard's ``[1, ...]`` pieces."""
    get = {name: t[0] for name, t in fields.items()}
    order = get[f"{prefix}_seg_order"]
    other = get[f"{prefix}_other"]
    return ShardSeg(
        other_sorted=other.long(), mask=get[f"{prefix}_mask"],
        flags=get[f"{prefix}_flags"], ends=get[f"{prefix}_ends"].long(),
        has_edges=get[f"{prefix}_has"], offsets=get[f"{prefix}_offsets"],
        other32=other, long_ids=order[:n_long], short_ids=order[n_long:])


def shard_plans(mesh, graph: ShardedGraph, kernel: str) -> List[ShardPlan]:
    """The staged graph on every ``dp`` row of ``mesh`` for the registry
    row ``kernel`` (the tensors digest-cached per mesh): the layouts and
    edge rows placed by the rule table (``GRAPH_RULES``: each over
    ``sp``), and the recursions' form for the row."""
    entry = _cache_entry(graph)
    key = (tuple(str(d) for d in mesh.flat), mesh.shape["dp"])
    if key in entry:
        return [_as_row(entry, plan, kernel) for plan in entry[key]]
    layouts = entry[None]
    names = (*_EDGE_NAMES, *ShardedSegLayouts._fields)
    shard_fns = make_shard_fns(
        match_partition_rules(GRAPH_RULES, names), mesh)
    arrays = {**{n: getattr(graph, n) for n in _EDGE_NAMES},
              **layouts._asdict()}
    grids = {name: shard_fns[name](arrays[name]) for name in names}
    plans = []
    for g in range(mesh.shape["dp"]):
        devices = tuple(mesh.row(g))
        per = [{name: grids[name][g][k] for name in names}
               for k in range(graph.sp)]
        plans.append(ShardPlan(
            kernel=kernel, devices=devices, block=graph.block,
            n_pad=graph.n_pad,
            dn=tuple(_shard_seg(f, "dn", int(layouts.dn_n_long[k]))
                     for k, f in enumerate(per)),
            up=tuple(_shard_seg(f, "up", int(layouts.up_n_long[k]))
                     for k, f in enumerate(per)),
            dst_global=tuple(f["dst_global"][0].long() for f in per),
            mask=tuple(f["mask"][0] for f in per)))
    entry[key] = plans
    return [_as_row(entry, plan, kernel) for plan in plans]


def engaged_row(graph: ShardedGraph, devices, steps: int) -> str:
    """The registry's ``sharded`` row for this graph's shape on the
    devices' type: ``kernels`` on CUDA, ``torch`` on the CPU and under
    ``RCA_KERNEL=torch``."""
    from rca_tpu_torch.engine.registry import engaged_kernel

    return engaged_kernel(graph.n_pad, graph.src_local.shape[1],
                          steps=steps, variant="sharded", device=devices[0])


# -- the per-block propagation -------------------------------------------------

def _blocks(full: torch.Tensor, block: int, sp: int) -> List[torch.Tensor]:
    return [full[..., k * block:(k + 1) * block] for k in range(sp)]


def _degree_blocks(plan: ShardPlan) -> List[torch.Tensor]:
    """Each node's dependent count in its shard's block: the shards' local
    counts reduce-scattered like the contributions (integer-valued,
    exact)."""
    return psum_scatter(
        [torch.zeros(plan.n_pad, dtype=torch.float32, device=d).index_add_(
            0, plan.dst_global[k], plan.mask[k])
         for k, d in enumerate(plan.devices)], plan.devices)


def _stack(a, h, u, m, params) -> torch.Tensor:
    return torch.stack([a, u, m, combine_score(
        a, h, u, m, params.explain_strength, params.impact_bonus)], dim=-2)


def _propagate_card(f_blks, plan: ShardPlan, n_live: int, aw, hw,
                    params) -> List[torch.Tensor]:
    """:func:`propagate_blocks` in the ``shard_grid`` form: every shard of
    the row on one card, so the front and each recursion are one launch
    over all of them on joined ``[..., n_pad]`` vectors whose blocks are
    the shards' (the front's joined ``a`` and ``h`` are what the gathers
    would hand each shard; the weights are equal there), the degree's
    reduce-scatter the one collective, and the score and the stack run
    once (elementwise, so each block has the per-shard stack's bits)."""
    grid = plan.grid
    a, h = evidence_front_shard(f_blks, aw[0], hw[0], params.error_contrast,
                                plan.up, grid)
    u = up_seg_steps_shard(h, params.decay, params.steps, plan.up, grid)
    # the background over the whole anomaly vector: the dense path's
    # global median
    a_ex = background_excess(a, n_live)
    inv_deg = 1.0 / torch.clamp(torch.cat(_degree_blocks(plan)), min=1.0)
    m = down_seg_steps_shard(a_ex, params.decay, params.steps, plan.dn, grid,
                             inv_deg)
    return _blocks(_stack(a, h, u, m, params), plan.block, len(plan.devices))


def propagate_blocks(f_blks: Sequence[torch.Tensor], plan: ShardPlan,
                     n_live: int, aw, hw, params) -> List[torch.Tensor]:
    """The reference's ``_propagate_block`` for every shard of one ``dp``
    row, in its order: the front, the error-source contrast over the
    one-time ``e`` gather, the ``h`` / ``a`` gathers, the up-steps, the
    background excess over the gathered ``a``, the degree reduce-scatter,
    the down-steps, ``combine_score``.  In the plan's ``steps_form``:
    ``step``, the front's two halves a shard around the gathers and each
    recursion step an all-gather (and for the impact a reduce-scatter)
    around a launch a shard; ``peer``, the same front and gathers, then
    each recursion one launch a card exchanging blocks in the kernel
    (:func:`up_seg_steps_peer`, :func:`down_seg_steps_peer`);
    ``shard_grid``, :func:`_propagate_card`.

    ``f_blks``: each shard's SANITIZED ``[block, C]`` (or ``[B, block,
    C]``) rows on its device; ``aw`` / ``hw``: the weights per shard.
    Returns each shard's ``[4, block]`` (or ``[B, 4, block]``) stack in the
    dense engine's ``[a, u, m, score]`` order (in the ``shard_grid`` form
    views of one joined stack)."""
    if plan.kernel not in ("kernels", "torch"):
        raise ValueError(f"unknown kernel row {plan.kernel!r}")
    if plan.grid is not None:
        return _propagate_card(f_blks, plan, n_live, aw, hw, params)
    devs, block, sp = plan.devices, plan.block, len(plan.devices)
    kern = plan.kernel == "kernels"
    rows = evidence_front_rows if kern else evidence_front_rows_plain
    front = [rows(f, aw[k], hw[k]) for k, f in enumerate(f_blks)]
    a_blk = [r[0] for r in front]
    h_blk = [r[1] for r in front]
    if params.error_contrast:
        contrast = (seg_contrast_step_shard if kern
                    else seg_contrast_step_shard_plain)
        e_full = all_gather([r[2] for r in front], devs)
        a_blk = [contrast(a_blk[k], e_full[k], params.error_contrast,
                          plan.up[k], k * block) for k in range(sp)]
    h_full = all_gather(h_blk, devs)
    a_full = all_gather(a_blk, devs)
    if plan.peer is not None:
        u_blk = up_seg_steps_peer(h_full, params.decay, params.steps, plan)
    else:
        u_blk = up_shard_recursion(h_full, params.decay, params.steps,
                                   plan.up, up_seg_step_shard if kern
                                   else None)

    # the background over the FULL gathered anomaly vector, so every shard
    # subtracts the dense path's global median; shards on one device share
    # the gathered vector, so they share its background too
    excess = {}
    for a, d in zip(a_full, devs):
        if d not in excess:
            excess[d] = background_excess(a, n_live)
    a_ex = [excess[d] for d in devs]
    inv_blk = [1.0 / torch.clamp(d, min=1.0) for d in _degree_blocks(plan)]
    if plan.peer is not None:
        m_blk = down_seg_steps_peer(a_ex, params.decay, params.steps, plan,
                                    inv_blk)
    else:
        m_blk = down_shard_recursion(a_ex, params.decay, params.steps,
                                     plan.dn, inv_blk,
                                     down_seg_step_shard if kern else None)
    return [_stack(a, h, u, m, params)
            for a, h, u, m in zip(a_blk, h_blk, u_blk, m_blk)]


class ShardedStack:
    """The diagnostic stack of a sharded analysis, left on its shards: the
    shards' ``[..., 4, block]`` blocks.  ``numpy()`` joins them on the host
    (the lazy full-diagnostics fetch, one block a copy); ``stack[b]`` is
    lane ``b``."""

    def __init__(self, blocks: Sequence[torch.Tensor]):
        self.blocks = list(blocks)

    def numpy(self) -> np.ndarray:
        # each block is a [..., 4, block] slice of the stacked role
        return np.concatenate([device_get(stacked) for stacked in self.blocks],
                              axis=-1)

    def __getitem__(self, lane) -> "ShardedStack":
        return ShardedStack([b[lane] for b in self.blocks])


def _check_k(k: int, block: int, sp: int) -> None:
    if k > block * sp:
        raise ValueError(f"sharded_topk: k={k} exceeds the sharded vector "
                         f"length {block * sp} (block {block} x sp {sp})")


def merge_topk(score_blocks: Sequence[torch.Tensor], kk: int, device=None,
               stacks: Optional[Sequence[torch.Tensor]] = None):
    """The cross-shard top-k: each shard ranks its block of scores (a
    stable sort: ties lowest index first) to at most ``kk`` local
    candidates; the ``k * sp`` candidates (values, global indices and,
    given the shards' ``stacks``, their ``[4, k]`` diagnostic columns)
    move to ``device`` (default: the first shard's) in shard order, and a
    stable sort there merges them.  Shard order is global index order, so
    ties keep lowest global index first, as the dense ``top_k``.  Returns
    ``(vals, idx, diag)``: ``[..., kk]``, int64 ``[..., kk]`` and ``[...,
    4, kk]`` (None without ``stacks``)."""
    block, sp = score_blocks[0].shape[-1], len(score_blocks)
    _check_k(kk, block, sp)
    k_local = min(kk, block)
    device = score_blocks[0].device if device is None else device
    local = [top_k(s, k_local) for s in score_blocks]
    vg = gather_to([v for v, _ in local], device, kind="topk_gather")
    ig = gather_to([i + k * block for k, (_, i) in enumerate(local)], device,
                   kind="topk_gather")
    vals, pos = top_k(vg, kk)
    diag = None
    if stacks is not None:
        dg = gather_to([topk_diag(st, i) for st, (_, i) in zip(stacks, local)],
                       device, kind="topk_gather")
        diag = topk_diag(dg, pos)
    return vals, torch.gather(ig, -1, pos), diag


def merge_stacks_topk(stacks: Sequence[torch.Tensor], kk: int, device=None):
    """:func:`merge_topk` of the shards' ``[..., 4, block]`` stacks (the
    score is row 3), with the diagnostic columns."""
    return merge_topk([st[..., 3, :] for st in stacks], kk, device,
                      stacks=stacks)


def sharded_topk(mesh, score_blocks: Sequence[torch.Tensor], k: int):
    """On-device cross-shard top-k merge of one ``dp`` row's score blocks
    (each ``[..., block]`` on its shard's device); returns ``(values,
    global indices)`` on the row's first device."""
    vals, idx, _ = merge_topk(score_blocks, k, device=mesh.row(0)[0])
    return vals, idx


# -- staging -------------------------------------------------------------------

def _stage_weights(mesh, params):
    aw, hw = params.weight_arrays()
    shard_fns = make_shard_fns(
        match_partition_rules(GRAPH_RULES, ("aw", "hw")), mesh)
    return shard_fns["aw"](np.asarray(aw)), shard_fns["hw"](np.asarray(hw))


def stage_sharded(mesh, features_batch: np.ndarray, graph: ShardedGraph,
                  params, kernel: Optional[str] = None):
    """Upload the ``[B, n_pad, C]`` batch (sanitized) and the graph's
    layouts to their mesh placements ONCE (``GRAPH_RULES``: lanes over
    ``dp``, nodes over ``sp``) and return a zero-argument callable that
    runs the propagation on the staged buffers, giving the stacks as a
    ``[dp][sp]`` grid of ``[B/dp, 4, block]`` tensors.  ``kernel``
    defaults to the registry's ``sharded`` row."""
    kernel = kernel or engaged_row(graph, mesh.flat, params.steps)
    plans = shard_plans(mesh, graph, kernel)
    shard_fns = make_shard_fns(
        match_partition_rules(GRAPH_RULES, ("features_batch",)), mesh)
    fb = shard_fns["features_batch"](np.asarray(features_batch, np.float32))
    aw, hw = _stage_weights(mesh, params)

    def invoke():
        return [propagate_blocks(fb[g], plans[g], graph.n, aw[g], hw[g],
                                 params) for g in range(mesh.shape["dp"])]

    return invoke


def gather_stack(grid, device=None) -> torch.Tensor:
    """A ``[dp][sp]`` grid of ``[B/dp, 4, block]`` stacks as one ``[B, 4,
    n_pad]`` tensor on ``device`` (default: the first shard's)."""
    device = grid[0][0].device if device is None else device
    return torch.cat([gather_to(row, device) for row in grid], dim=0)


def sharded_propagate_full(mesh, features_batch: np.ndarray,
                           graph: ShardedGraph, params,
                           kernel: Optional[str] = None) -> torch.Tensor:
    """Diagnostic stack ``[B, 4, n_pad]`` in the dense engine's ``[a, u,
    m, score]`` order, joined on the mesh's first device."""
    return gather_stack(stage_sharded(mesh, features_batch, graph, params,
                                      kernel)())


def sharded_propagate(mesh, features_batch: np.ndarray, graph: ShardedGraph,
                      params, kernel: Optional[str] = None) -> torch.Tensor:
    """Scores ``[B, n_pad]`` (the last row of the diagnostic stack)."""
    return sharded_propagate_full(mesh, features_batch, graph, params,
                                  kernel)[:, 3]


def stage_batch_ranked(mesh, features_batch: np.ndarray,
                       graph: ShardedGraph, params, kk: int,
                       kernel: Optional[str] = None):
    """Enqueue the sharded hypothesis batch, each ``dp`` row's cross-shard
    top-k merge and its ``[4, kk]`` diagnostic gather; returns ``(stack,
    diag, vals, idx)``: the stacks left on their shards (a ``[dp][sp]``
    grid) and ``[B, 4, kk]`` / ``[B, kk]`` device tensors on the mesh's
    first device.  Nothing synchronizes with the host."""
    grid = stage_sharded(mesh, features_batch, graph, params, kernel)()
    first = mesh.flat[0]
    merged = [merge_stacks_topk(row, kk, device=first) for row in grid]
    vals = torch.cat([m[0] for m in merged], dim=0)
    idx = torch.cat([m[1] for m in merged], dim=0)
    diag = torch.cat([m[2] for m in merged], dim=0)
    return grid, diag, vals, idx


# -- deltas into the shards' buffers -------------------------------------------

def new_block_buffers(features: np.ndarray, devices, block: int):
    """Per-shard ``[block + 1, C]`` buffers of the padded ``[n_pad, C]``
    host matrix: shard ``k``'s rows, then one scratch row that takes the
    delta rows landing outside its block (never read)."""
    from rca_tpu_torch.engine.runner import upload

    out = []
    for k, dev in enumerate(devices):
        buf = np.zeros((block + 1, features.shape[1]), np.float32)
        buf[:block] = features[k * block:(k + 1) * block]
        out.append(upload(buf, dev))
    return out


def scatter_delta(buffers, devices, block: int, idx_h: np.ndarray,
                  rows_h: np.ndarray) -> None:
    """Write the padded delta (host int32 ids, unique but for pad slots
    that carry zero rows to the dummy row or past every block, and their
    rows) into the shards' buffers: the
    ids and rows are replicated to each device, and each shard
    ``index_copy_`` s the rows that land in its block into it, every other
    row into its scratch row.  No host sync."""
    from rca_tpu_torch.engine.runner import upload

    staged = {}
    for k, (buf, dev) in enumerate(zip(buffers, devices)):
        if dev not in staged:
            staged[dev] = (upload(idx_h, dev).long(), upload(rows_h, dev))
        idx, rows = staged[dev]
        local = idx - k * block
        inside = (local >= 0) & (local < block)
        buf.index_copy_(0, torch.where(inside, local, block), rows)


# -- the resident session ------------------------------------------------------

class ShardedResidentSession(ResidentSession):
    """One graph's device-resident SHARDED analyze state: the
    :class:`rca_tpu_torch.engine.resident.ResidentSession` request contract
    (and its :class:`ResidentCache`, whose lock serializes requests) over
    the shards' ``[block + 1, C]`` buffers.

    A delta's rows are ``index_copy_`` d by each shard into its own block
    (:func:`scatter_delta`).  As in the reference's sharded session the
    buffers hold SANITIZED rows: the host's finite mask runs per request
    over the raw input (the mirror stays raw), so the values, rankings and
    ``sanitized_rows`` are bitwise those of a restaged request."""

    @property
    def engine_tag(self) -> str:
        return self.engine.engine_tag

    def _stage_graph(self) -> None:
        self._graph = self.engine._shard(self._n, self._src_raw,
                                         self._dst_raw)
        self._n_pad = self._graph.n_pad
        self._mesh = self.engine._exec_mesh
        self._devices = self._mesh.row(0)
        self._aw, self._hw = (w[0] for w in _stage_weights(
            self._mesh, self.engine.params))
        self._buffers = None
        self._plan = None  # per-shard steps: no dense plan to stamp

    def _request_rows(self, features):
        from rca_tpu_torch.engine.runner import finite_mask_rows_np

        return finite_mask_rows_np(features)

    def _upload_full(self, f: np.ndarray) -> None:
        self._buffers = new_block_buffers(f, self._devices, self._graph.block)

    def _scatter_rows(self, idx_h: np.ndarray, rows_h: np.ndarray) -> None:
        scatter_delta(self._buffers, self._devices, self._graph.block, idx_h,
                      rows_h)

    def _launch(self, kk: int, n_bad):
        """The shards' propagation and the cross-shard top-k merge;
        ``n_bad`` is the host's count."""
        block = self._graph.block
        kernel = engaged_row(self._graph, self._devices,
                             self.engine.params.steps)
        stacks = propagate_blocks(
            [b[:block] for b in self._buffers],
            shard_plans(self._mesh, self._graph, kernel)[0], self._n,
            self._aw, self._hw, self.engine.params)
        vals, idx, diag = merge_stacks_topk(stacks, kk)
        return ShardedStack(stacks), diag, vals, idx, n_bad
