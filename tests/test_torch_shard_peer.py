"""The node-sharded engine's recursions over distinct cards (the ``peer``
form), against the per-step composition and against the JAX package's
sharded propagation.

Where a ``dp`` row's shards lie one a card on CUDA devices that all reach
each other's memory, the plan's ``steps_form`` is ``peer``:
``up_seg_steps_peer`` / ``down_seg_steps_peer`` run each recursion as one
cooperative launch a card (``rca_tpu_torch/csrc/segpeer.cu``), the blocks
exchanged through peer memory, over each card's part of the shards'
joined layouts (``build_peer_layouts``).  On CPU tensors each computes its
plain version, the per-step composition.  These tests hold:

- the form's election from the hardware's facts, table-driven over
  ``torch.device("cuda", i)`` lists with peer access and the card count
  patched: ``peer`` only for distinct cards that all reach each other;
- the plain versions bitwise the composition written out step by step
  here, and the wrappers on CPU tensors bitwise the plain versions, at 1
  and 8 lanes, with NaN / Inf entries, decay 0 and 0.7, on the graphs of
  ``test_torch_shard_steps.py`` (a cascade, a star, a hub, a shard with
  no edges);
- each card's layouts: its part of the joined layouts, every segment with
  its edges in order and the reduction kind its length picks; a model of
  the kernels' arithmetic over them (each card's step, the exchange of
  ``w``, the inbox added in shard order) against the composition; each
  card's launch covering each of its segments and lanes once a step;
- ``ShardedGraphEngine`` with the plan forced to ``peer`` on CPU tensors
  bitwise the ``step`` form and against the reference's sharded engine on
  the CPU's 8 host devices;
- each card's launch arguments: the library's signature, and the
  exchange buffers' two halves the group's capacity apart at every width;
- the cost rows' bytes by hand at 2047 and 49,999 services;
- the new lock's name as gravelock sees it;
- the kernels on two cards or more (marker ``cuda``; they skip here:
  ``python3 chip_smoke.py --multi-card`` runs the same checks there).
"""

import os

import numpy as np
import pytest
import torch

import jax

from rca_tpu.cluster.generator import synthetic_cascade_arrays as ref_cascade
from rca_tpu.engine.sharded_runner import ShardedGraphEngine as RefSharded
from rca_tpu.engine.train import packaged_params as ref_packaged_params
from rca_tpu.parallel.mesh import make_mesh as ref_make_mesh
from rca_tpu.parallel.sharded import shard_graph as ref_shard_graph
from rca_tpu.parallel.sharded import sharded_propagate_full as ref_full
from rca_tpu_torch import params_from_jax
from rca_tpu_torch.analysis.concurrency.model import model_for
from rca_tpu_torch.config import RCAConfig, bucket_for
from rca_tpu_torch.engine import ShardedGraphEngine
from rca_tpu_torch.engine import segscan
from rca_tpu_torch.engine.registry import reset_registry
from rca_tpu_torch.engine.segscan import (
    GRID_BIG_MIN,
    MAX_PEER_CARDS,
    SHORT_SEGMENT_MAX,
    build_peer_layouts,
    build_shard_grid,
    down_seg_step_shard_plain,
    down_seg_steps_peer,
    down_seg_steps_peer_plain,
    grid_items,
    grid_shares,
    steps_grid,
    up_seg_step_shard_plain,
    up_seg_steps_peer,
    up_seg_steps_peer_plain,
)
from rca_tpu_torch.kernels import cost
from rca_tpu_torch.parallel import sharded
from rca_tpu_torch.parallel.collectives import all_gather, psum_scatter
from rca_tpu_torch.parallel.sharded import (
    build_sharded_seg_layouts,
    shard_graph,
    shard_plans,
    shard_steps_form,
    shard_steps_note,
    sharded_propagate_full,
)
from test_torch_shard_steps import (
    GRAPHS,
    _batch,
    _bits,
    _hub,
    _mesh,
    _shape_graph,
)

C = 13
CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def env(monkeypatch):
    for name in ("RCA_SHARD", "RCA_KERNEL", "RCA_SEGSCAN", "RCA_RESIDENT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("RCA_KERNEL_CACHE", "off")
    reset_registry()
    yield monkeypatch
    reset_registry()


@pytest.fixture(scope="module")
def ref_params():
    return ref_packaged_params()


def _port_params(ref, error_contrast=None):
    aw, hw = ref.weight_arrays()
    return params_from_jax(
        np.array(aw), np.array(hw), ref.steps, ref.decay,
        ref.explain_strength, ref.impact_bonus,
        ref.error_contrast if error_contrast is None else error_contrast)


def _as_peer(monkeypatch):
    """Plans of the ``kernels`` row in the ``peer`` form on the CPU, where
    its wrappers compute their plain versions."""
    monkeypatch.setattr(sharded, "shard_steps_form", lambda devices: "peer")


def _peer_plan(graph, sp, monkeypatch, kernel="kernels"):
    _as_peer(monkeypatch)
    (plan,) = shard_plans(_mesh(1, sp), graph, kernel)
    return plan


def _vectors(n_pad, sp, lanes, seed, poison=True):
    """Each card's full ``h`` and ``a_ex`` (the same on every card, as the
    gathers hand them) and its ``inv_deg`` block, from numpy; with
    ``poison`` a NaN and an Inf in the last lane."""
    rng = np.random.default_rng(seed)
    shape = (n_pad,) if lanes == 1 else (lanes, n_pad)
    h = rng.uniform(0, 1, shape).astype(np.float32)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    a[..., rng.choice(n_pad, n_pad // 4, replace=False)] = 0.0
    if poison:
        last = h if lanes == 1 else h[-1]
        last[3] = np.nan
        last_a = a if lanes == 1 else a[-1]
        last_a[5], last_a[9] = np.nan, np.inf
    inv = (1.0 / rng.integers(1, 6, n_pad)).astype(np.float32)
    block = n_pad // sp
    h, a, inv = (torch.from_numpy(x) for x in (h, a, inv))
    return ([h] * sp, [a] * sp,
            [inv[k * block:(k + 1) * block] for k in range(sp)])


def _composed_up(h_full, decay, steps, plan):
    """The explain-away recursion exactly as the ``step`` form composes it:
    an all-gather of the blocks, then the per-shard step."""
    sp, block = len(plan.up), plan.block
    devs = [h.device for h in h_full]
    u_blk = [torch.zeros(h.shape[:-1] + (block,)) for h in h_full]
    for _ in range(steps):
        u_full = all_gather(u_blk, devs)
        u_blk = [up_seg_step_shard_plain(u_full[k], h_full[k], decay,
                                         plan.up[k], k * block)
                 for k in range(sp)]
    return u_blk


def _composed_down(a_ex_full, decay, steps, plan, inv_blk):
    sp, block = len(plan.dn), plan.block
    devs = [a.device for a in a_ex_full]
    m_blk = [torch.zeros(a.shape[:-1] + (block,)) for a in a_ex_full]
    for _ in range(steps):
        m_full = all_gather(m_blk, devs)
        contrib = [down_seg_step_shard_plain(m_full[k], a_ex_full[k], decay,
                                             plan.dn[k]) for k in range(sp)]
        m_blk = [c * inv for c, inv in zip(psum_scatter(contrib, devs),
                                           inv_blk)]
    return m_blk


# -- the form's election ------------------------------------------------------

def _cards(*index):
    return [torch.device("cuda", i) for i in index]


@pytest.mark.parametrize("devices,denied,form", [
    (_cards(0, 1), (), "peer"),
    (_cards(0, 1, 2, 3), (), "peer"),
    (_cards(3, 1, 0, 2), (), "peer"),
    (_cards(0), (), "shard_grid"),
    (_cards(2, 2, 2, 2), (), "shard_grid"),
    (_cards(0, 0, 1, 1), (), "step"),
    (_cards(0, 1, 1), (), "step"),
    (_cards(0, 1, 2, 3), ((2, 1),), "step"),
    (_cards(0, 1), ((0, 1),), "step"),
    (_cards(0, 4), (), "step"),                     # cuda:4 is not visible
    ([torch.device("cuda", 0), CPU], (), "step"),
    ([CPU] * 4, (), "step"),
    ([CPU], (), "step"),
])
def test_the_form_is_elected_from_the_hardware(devices, denied, form,
                                               monkeypatch):
    """``peer`` for distinct visible cards that all reach each other's
    memory; one card ``shard_grid``; mixed placements, a pair without
    access, an invisible card and the CPU ``step``."""
    asked = []

    def can_access(i, j):
        asked.append((i, j))
        return (i, j) not in denied

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "can_device_access_peer", can_access)
    assert shard_steps_form(devices) == form
    assert shard_steps_form([str(d) for d in devices]) == form
    if form == "peer":
        # every ordered pair asked, both ways
        index = [d.index for d in devices]
        assert sorted(set(asked)) == sorted(
            (i, j) for i in index for j in index if i != j)
    note = shard_steps_note(len(devices), devices[0], devices)
    assert note.startswith(f"{form}:"), note


def test_more_cards_than_a_launch_reaches_take_the_step_form(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 32)
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda i, j: True)
    assert shard_steps_form(_cards(*range(MAX_PEER_CARDS))) == "peer"
    assert shard_steps_form(_cards(*range(MAX_PEER_CARDS + 1))) == "step"


@pytest.mark.parametrize("kernel", ["kernels", "torch"])
def test_only_the_kernels_row_takes_the_peer_form(kernel, monkeypatch):
    """Where the devices give ``peer``, the ``kernels`` row's plan holds
    each card's layouts (on the CPU no group and no buffers: the
    wrappers compute their plain versions); the ``torch`` row's takes the
    ``step`` form over the same devices."""
    n, src, dst = _hub()
    graph = shard_graph(n, src, dst, 4, n_pad_to=n + 1)
    plan = _peer_plan(graph, 4, monkeypatch, kernel)
    assert plan.kernel == kernel and plan.grid is None
    if kernel == "torch":
        assert plan.peer is None and plan.steps_form == "step"
        return
    assert plan.steps_form == "peer"
    assert plan.peer.group is None and plan.peer.contrib is None
    assert len(plan.peer.up) == len(plan.peer.dn) == 4
    assert plan._replace(peer=None).steps_form == "step"


# -- the plain versions and the wrappers --------------------------------------

@pytest.mark.parametrize("decay", [0.0, 0.7])
@pytest.mark.parametrize("steps", [0, 1, 8])
@pytest.mark.parametrize("lanes", [1, 8])
@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_plain_recursions_are_the_per_step_composition(name, sp, lanes,
                                                       steps, decay,
                                                       monkeypatch):
    n, src, dst = GRAPHS[name]()
    graph = shard_graph(n, src, dst, sp, n_pad_to=n + 1)
    plan = _peer_plan(graph, sp, monkeypatch)
    h_full, a_full, inv_blk = _vectors(graph.n_pad, sp, lanes,
                                       seed=sp * 100 + steps)
    u = up_seg_steps_peer_plain(h_full, decay, steps, plan)
    m = down_seg_steps_peer_plain(a_full, decay, steps, plan, inv_blk)
    want_u = _composed_up(h_full, decay, steps, plan)
    want_m = _composed_down(a_full, decay, steps, plan, inv_blk)
    # the wrappers compute the plain versions on CPU tensors
    got_u = up_seg_steps_peer(h_full, decay, steps, plan)
    got_m = down_seg_steps_peer(a_full, decay, steps, plan, inv_blk)
    for blocks in (u, m, got_u, got_m):
        assert len(blocks) == sp
        assert all(b.shape == h_full[0].shape[:-1] + (graph.block,)
                   for b in blocks)
    for got, want in ((u, want_u), (m, want_m), (got_u, want_u),
                      (got_m, want_m)):
        assert torch.equal(_bits(torch.cat(got, -1)),
                           _bits(torch.cat(want, -1)))
    if steps == 0:
        assert not torch.cat(u, -1).any() and not torch.cat(m, -1).any()


@pytest.mark.parametrize("bad", ["dtype", "shape", "steps", "inv_deg",
                                 "cards", "lanes"])
def test_peer_wrappers_check_their_inputs(bad, monkeypatch):
    n, src, dst = _hub()
    graph = shard_graph(n, src, dst, 4, n_pad_to=n + 1)
    plan = _peer_plan(graph, 4, monkeypatch)
    h_full, a_full, inv_blk = _vectors(graph.n_pad, 4, 1, seed=1)
    steps = 8
    if bad == "dtype":
        a_full = [a.double() for a in a_full]
    elif bad == "shape":
        a_full = [a[:-1] for a in a_full]
    elif bad == "steps":
        steps = -1
    elif bad == "inv_deg":
        inv_blk = [i[:-1] for i in inv_blk]
    elif bad == "cards":
        a_full = a_full[:3]
    elif bad == "lanes":
        a_full = [a_full[0], a_full[1], a_full[2],
                  torch.stack([a_full[3]] * 2)]
    with pytest.raises((TypeError, ValueError, IndexError)):
        down_seg_steps_peer(a_full, 0.7, steps, plan, inv_blk)
    if bad in ("dtype", "shape", "steps", "cards", "lanes"):
        with pytest.raises((TypeError, ValueError, IndexError)):
            up_seg_steps_peer(a_full, 0.7, steps, plan)


# -- each card's layouts ------------------------------------------------------

def _kind(count):
    return ("short" if count <= SHORT_SEGMENT_MAX else
            "long" if count <= GRID_BIG_MIN else "big")


def _position_kinds(n_seg, n_long, n_big):
    return ["big"] * n_big + ["long"] * (n_long - n_big) + \
        ["short"] * (n_seg - n_long)


def _layouts(graph):
    lay = build_sharded_seg_layouts(graph)
    return lay, build_peer_layouts(lay.up_offsets, lay.up_other,
                                   lay.dn_offsets, lay.dn_other)


@pytest.mark.parametrize("sp", [2, 4, 8])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_each_card_holds_its_part_of_the_joined_layouts(name, sp):
    n, src, dst = GRAPHS[name]()
    graph = shard_graph(n, src, dst, sp, n_pad_to=n + 1)
    lay, cards = _layouts(graph)
    grid = build_shard_grid(lay.up_offsets, lay.up_other, lay.dn_offsets,
                            lay.dn_other)
    block = graph.block
    counts = np.diff(lay.dn_offsets, axis=1)
    for k, (up, dn) in enumerate(cards):
        # up: the card's own sources as global ids, each once, with the
        # shard's edges in order and the kind their count picks
        assert sorted(up.seg.tolist()) == list(range(k * block,
                                                     (k + 1) * block))
        kinds = _position_kinds(up.n_seg, up.n_long, up.n_big)
        for q, node in enumerate(up.seg):
            s = int(node) - k * block
            want = lay.up_other[k][lay.up_offsets[k][s]:
                                   lay.up_offsets[k][s + 1]]
            assert np.array_equal(up.other[up.offsets[q]:up.offsets[q + 1]],
                                  want)
            assert kinds[q] == _kind(len(want))
        # down: every destination the shard reaches, once, with its edges
        reached = np.flatnonzero(counts[k])
        assert sorted(dn.seg.tolist()) == reached.tolist()
        kinds = _position_kinds(dn.n_seg, dn.n_long, dn.n_big)
        for q, d in enumerate(dn.seg):
            want = lay.dn_other[k][lay.dn_offsets[k][d]:
                                   lay.dn_offsets[k][d + 1]]
            assert len(want) and np.array_equal(
                dn.other[dn.offsets[q]:dn.offsets[q + 1]], want)
            assert kinds[q] == _kind(len(want))
    # the cards' parts are the joined layouts' segments, no more
    assert sum(up.n_seg for up, _ in cards) == graph.n_pad
    assert sum(dn.n_seg for _, dn in cards) == grid.pairs
    assert sum(len(up.other) for up, _ in cards) == len(grid.up_other)


def _model_peer(cards, h, a_ex, inv, decay, steps, sp, block):
    """The peer kernels' arithmetic in torch: every card's up step over its
    own layout from its copy of ``w``, the blocks of the next ``w``
    stored into every copy; every card's dense contributions of its pairs
    (float64 sums), each owner's inbox rows added in shard order, scaled,
    the next ``w`` stored into every copy.  Returns ``(u, m)``."""
    g = np.float32(decay)

    def segs(layout):
        pos = torch.repeat_interleave(
            torch.arange(layout.n_seg),
            torch.from_numpy(np.diff(layout.offsets)))
        return (torch.from_numpy(layout.seg).long()[pos],
                torch.from_numpy(layout.other).long())

    u = torch.zeros_like(h)
    w = [h.clone() for _ in range(sp)]     # step 0 gathers max(h, g*0)
    w = [torch.maximum(x, g * torch.zeros_like(h)) for x in w]
    for _ in range(steps):
        new = []
        for k, (up, _) in enumerate(cards):
            seg, other = segs(up)
            total = torch.zeros_like(h).scatter_reduce(
                -1, seg.expand(h.shape[:-1] + seg.shape), w[k][..., other],
                "amax")
            sl = slice(k * block, (k + 1) * block)
            new.append(torch.maximum(u[..., sl], total[..., sl]))
        u = torch.cat(new, -1)
        nxt = torch.maximum(h, g * u)
        w = [nxt.clone() for _ in range(sp)]
    a64, inv64 = a_ex.double(), inv.double()
    m = torch.zeros_like(a64)
    w = [a64.clone() for _ in range(sp)]
    for _ in range(steps):
        inbox = []
        for k, (_, dn) in enumerate(cards):
            seg, other = segs(dn)
            c = torch.zeros_like(a64)
            c.index_add_(-1, seg, w[k][..., other])
            inbox.append(c)
        acc = inbox[0]
        for r in range(1, sp):
            acc = acc + inbox[r]
        m = acc * inv64
        w = [a64 + decay * m for _ in range(sp)]
    return u, m


@pytest.mark.parametrize("sp", [2, 4, 8])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_a_model_of_the_kernels_over_the_cards_layouts(name, sp,
                                                       monkeypatch):
    """The kernels' arithmetic over each card's layout, with the exchange,
    against the composition: ``u`` bitwise (a max), ``m`` at rtol 1e-5 /
    atol 1e-6 (float64 against the composition's float32 sums); finite
    inputs."""
    n, src, dst = GRAPHS[name]()
    graph = shard_graph(n, src, dst, sp, n_pad_to=n + 1)
    _, cards = _layouts(graph)
    plan = _peer_plan(graph, sp, monkeypatch)
    h_full, a_full, inv_blk = _vectors(graph.n_pad, sp, 2, seed=sp,
                                       poison=False)
    u, m = _model_peer(cards, h_full[0], a_full[0], torch.cat(inv_blk), 0.7,
                       8, sp, graph.block)
    assert torch.equal(_bits(u), _bits(torch.cat(
        up_seg_steps_peer_plain(h_full, 0.7, 8, plan), -1)))
    np.testing.assert_allclose(
        m.numpy(), torch.cat(down_seg_steps_peer_plain(
            a_full, 0.7, 8, plan, inv_blk), -1).numpy(),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("lanes", [1, 8, 16])
@pytest.mark.parametrize("cap", [132, 528])
@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("n,e", [(2047, 4087), (49999, 99867)])
def test_each_card_launch_covers_its_segments_once(n, e, sp, cap, lanes):
    """Each (segment, lane) of a card's layout is one CTA's, once a step,
    under the grid the wrapper sizes (``steps_grid`` over the card's
    items, at most ``cap`` CTAs), as ``grid_shares`` computes the
    kernel's shares."""
    buckets = RCAConfig().shape_buckets
    graph = shard_graph(n, *_shape_graph(n, e, seed=n), sp,
                        n_pad_to=bucket_for(n + 1, buckets))
    _, cards = _layouts(graph)
    for layouts in cards:
        for lay in layouts:
            n_items = grid_items(lay.n_seg, lay.n_long, lay.n_big)
            launch = steps_grid(max(1, n_items), lanes, cap)
            assert launch[0] * launch[1] <= cap
            starts = (list(range(lay.n_big))
                      + [lay.n_big + j * 8 for j in
                         range(-(-(lay.n_long - lay.n_big) // 8))]
                      + [lay.n_long + j * 256 for j in
                         range(-(-(lay.n_seg - lay.n_long) // 256))]
                      + [lay.n_seg])
            assert len(starts) == n_items + 1
            seen = np.zeros((lanes, lay.n_seg), np.int64)
            for (j0, j1), (b0, b1) in grid_shares(n_items, lanes, launch):
                seen[b0:b1, starts[j0]:starts[j1]] += 1
            assert (seen == 1).all()


# -- the engine in the peer form ----------------------------------------------

@pytest.mark.parametrize("dp,sp", [(1, 8), (2, 4), (4, 2)])
def test_peer_form_is_the_step_form_and_the_reference(dp, sp, env,
                                                      ref_params):
    if len(jax.devices()) < 8:
        pytest.skip("the reference needs 8 devices")
    case = ref_cascade(500, n_roots=2, seed=3)
    buckets = RCAConfig().shape_buckets
    kw = dict(n_pad_to=bucket_for(case.n + 1, buckets),
              e_pad_fn=lambda e: bucket_for(e, buckets))
    graph = shard_graph(case.n, case.dep_src, case.dep_dst, sp, **kw)
    fb = _batch(case, graph.n_pad, 8, seed=dp * 10 + sp)
    params = _port_params(ref_params)
    step = sharded_propagate_full(_mesh(dp, sp), fb, graph, params,
                                  "kernels")
    _as_peer(env)
    plans = shard_plans(_mesh(dp, sp), graph, "kernels")
    assert all(p.steps_form == "peer" for p in plans)
    got = sharded_propagate_full(_mesh(dp, sp), fb, graph, params, "kernels")
    assert torch.equal(_bits(got), _bits(step))
    ref = np.asarray(ref_full(
        ref_make_mesh([("dp", dp), ("sp", sp)]), fb,
        ref_shard_graph(case.n, case.dep_src, case.dep_dst, sp, **kw),
        ref_params))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("weight", [0.0, 0.7])
@pytest.mark.parametrize("poison", [False, True])
def test_peer_engine_matches_the_step_engine_and_the_reference(
        poison, weight, env, ref_params):
    """``ShardedGraphEngine`` over 8 shards, restaged and resident, with
    the plan forced to ``peer``: bitwise the ``step`` form; at the
    packaged contrast weight against the reference's sharded engine
    (values at rtol 1e-5 / atol 1e-6, top-k identical)."""
    if len(jax.devices()) < 8:
        pytest.skip("the reference needs 8 devices")
    env.setenv("RCA_KERNEL", "kernels")
    case = ref_cascade(700, n_roots=2, seed=4)
    feats = case.features.copy()
    if poison:
        feats[[3, 90, 400], [2, 12, 0]] = (np.nan, np.inf, -np.inf)
    params = _port_params(ref_params, weight)
    want = ShardedGraphEngine(params=params, mesh=_mesh(1, 8),
                              resident=False).analyze_arrays(
        feats, case.dep_src, case.dep_dst, case.names, k=10)
    _as_peer(env)
    for eng in (ShardedGraphEngine(params=params, mesh=_mesh(1, 8),
                                   resident=False),
                ShardedGraphEngine(params=params, mesh=_mesh(1, 8))):
        for _ in range(2):
            got = eng.analyze_arrays(feats, case.dep_src, case.dep_dst,
                                     case.names, k=10)
            assert np.array_equal(got.full_diagnostics().view(np.int32),
                                  want.full_diagnostics().view(np.int32))
            assert got.top_components() == want.top_components()
            assert got.sanitized_rows == (3 if poison else 0)
    if weight == ref_params.error_contrast:
        env.delenv("RCA_KERNEL")   # the reference reads its own rows' names
        ref = RefSharded(params=ref_params, spec="sp=8",
                         resident=False).analyze_arrays(
            feats, case.dep_src, case.dep_dst, case.names, k=10)
        assert got.top_components() == ref.top_components()
        assert got.sanitized_rows == ref.sanitized_rows
        np.testing.assert_allclose(got.score, ref.score, rtol=1e-5,
                                   atol=1e-6)


# -- the cost rows ------------------------------------------------------------

@pytest.mark.parametrize("n_pad,sp,e_k,pairs_k,want_up,want_down", [
    # 2047 services (n_pad 2048) on 2 cards: block 1024
    (2048, 2, 2000, 1500,
     ((1024 + 1 + 2000) * 4 + (2048 + 1024) * 4, 7 * 1 * 1024 * 4,
      8 * (3 * 2000 + 1024)),
     ((1500 + 1 + 2000) * 4 + 1024 * 4 + 2 * 1024 * 4, 15 * 1 * 1024 * 4,
      8 * (3 * 2000 + 2 * 1024))),
    # 49,999 services (n_pad 53,248) on 4 cards: block 13,312; u pushes
    # 13,312 x 4 B x 3 = 159,744 B a step
    (53248, 4, 25000, 20000,
     ((13312 + 1 + 25000) * 4 + (53248 + 13312) * 4, 7 * 159744,
      8 * (75000 + 13312)),
     ((20000 + 1 + 25000) * 4 + 13312 * 4 + 2 * 13312 * 4, 15 * 159744,
      8 * (75000 + 4 * 13312))),
])
def test_the_cost_rows_by_hand(n_pad, sp, e_k, pairs_k, want_up, want_down):
    assert cost.up_steps_peer(n_pad, sp, e_k) == want_up
    assert cost.down_steps_peer(n_pad, sp, e_k, pairs_k) == want_down
    # 8 lanes scale the vectors, the pushes and the operations
    up8 = cost.up_steps_peer(n_pad, sp, e_k, lanes=8)
    assert up8[1] == 8 * want_up[1] and up8[2] == 8 * want_up[2]
    # the bound: the pushes over NVLink where they are the larger term
    t, by = cost.bound_peer_ms(*want_up)
    assert by == "bytes"
    assert t == pytest.approx(max(want_up[0] / cost.HBM_BYTES_PER_S,
                                  want_up[1] / cost.NVLINK_BYTES_PER_S,
                                  want_up[2] / cost.FP32_OPS_PER_S) * 1e3)
    assert cost.bound_peer_ms(1e6, 0, 0) == cost.bound_ms(1e6, 0)


# -- the lock and the profile's symbols ---------------------------------------

def test_the_profile_names_the_peer_kernels():
    from rca_tpu_torch.observability.profile import device_kernel_counts

    events = [{"cat": "kernel", "name": f"(anonymous namespace)::{sym}"}
              for sym in ("seg_peer_up_kernel(PeerUp)",
                          "seg_peer_down_kernel(PeerDown)",
                          "seg_peer_down_kernel(PeerDown)")]
    counts = device_kernel_counts({"traceEvents": events})
    assert (counts["seg_up_steps_peer"], counts["seg_down_steps_peer"],
            counts["other"]) == (1, 2, 0)


@pytest.mark.parametrize("kind", ["up", "down"])
def test_launch_arguments_place_the_halves_at_the_groups_capacity(
        kind, monkeypatch):
    """Each card's arguments match the library's signature, and the two
    halves of the exchange buffers sit the group's capacity apart at
    every width: a narrow launch right after a wide one cannot push into
    the half that a slower card still reads."""
    import ctypes
    import types

    from rca_tpu_torch.kernels.build import _SIGNATURES

    n, src, dst = GRAPHS[sorted(GRAPHS)[0]]()
    graph = shard_graph(n, src, dst, 2, n_pad_to=n + 1)
    plan = _peer_plan(graph, 2, monkeypatch)
    table = (ctypes.c_ulonglong * 2)()
    group = types.SimpleNamespace(
        tables={"up_w": table, "dn_w": table, "inbox": table},
        flag_table=table, floats=1 << 20)
    plan = plan._replace(peer=plan.peer._replace(group=group))
    name = f"rca_seg_{kind}_steps_peer"
    # the leading arguments, then out (and the contributions before it),
    # the grid's two sizes and the stream
    tail = 5 if kind == "down" else 4
    signature = _SIGNATURES[name]
    half_at = signature.index(ctypes.c_ulonglong)
    halves = set()
    for lanes in (16, 1):
        h_full, a_full, inv_blk = _vectors(graph.n_pad, 2, lanes, seed=1)
        make = (segscan.up_peer_args(plan, h_full, 0.7, 8, lanes)
                if kind == "up" else
                segscan.down_peer_args(plan, a_full, 0.7, 8, lanes, inv_blk))
        for k in range(2):
            args = make(k, 7, 3)
            assert len(args) + tail == len(signature)
            assert args[half_at + 1] == 7       # the epoch
            assert args[half_at + 2] == 1       # the parity, masked
            halves.add(args[half_at])
    assert halves == {group.floats}


def test_gravelock_sees_the_peer_lock():
    model = model_for(ROOT)
    idx = model.indexers["rca_tpu_torch/engine/segscan.py"]
    assert idx.module_locks["_PEER_LOCK"] == "segscan._PEER_LOCK"
    assert segscan.PEER_WAIT_NS > 0


# -- on two cards or more -----------------------------------------------------

@pytest.fixture
def cards():
    if torch.cuda.device_count() < 2:
        pytest.skip("fewer than two CUDA devices: the peer recursions run "
                    "only over distinct cards (python3 chip_smoke.py "
                    "--multi-card runs them there)")
    return [torch.device("cuda", i) for i in range(2)]


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 8, 16])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_peer_kernels_are_the_composition_on_cards(name, lanes, cards):
    from rca_tpu_torch.engine.segscan import (
        down_seg_step_shard,
        down_shard_recursion,
        up_seg_step_shard,
        up_shard_recursion,
    )
    from rca_tpu_torch.kernels import SHARD_LAUNCHES

    n, src, dst = GRAPHS[name]()
    graph = shard_graph(n, src, dst, 2, n_pad_to=n + 1)
    (plan,) = shard_plans(_mesh(1, 2, cards), graph, "kernels")
    assert plan.steps_form == "peer"
    h_full, a_full, inv_blk = _vectors(graph.n_pad, 2, lanes, seed=lanes,
                                       poison=False)
    h_full, a_full, inv_blk = ([x.to(d) for x, d in zip(v, cards)]
                               for v in (h_full, a_full, inv_blk))
    for steps in (1, 8):
        before = dict(SHARD_LAUNCHES)
        u = [up_seg_steps_peer(h_full, 0.7, steps, plan) for _ in range(2)]
        m = [down_seg_steps_peer(a_full, 0.7, steps, plan, inv_blk)
             for _ in range(2)]
        assert SHARD_LAUNCHES["seg_up_steps_peer"] == \
            before["seg_up_steps_peer"] + 4
        assert SHARD_LAUNCHES["seg_down_steps_peer"] == \
            before["seg_down_steps_peer"] + 4
        want_u = up_shard_recursion(h_full, 0.7, steps, plan.up,
                                    up_seg_step_shard)
        want_m = down_shard_recursion(a_full, 0.7, steps, plan.dn, inv_blk,
                                      down_seg_step_shard)
        for d in cards:
            torch.cuda.synchronize(d)
        for got in u:
            assert all(torch.equal(_bits(g), _bits(w))
                       for g, w in zip(got, want_u))
        for got in m:
            assert all(torch.equal(_bits(g), _bits(w))
                       for g, w in zip(got, want_m))


@pytest.mark.cuda
def test_peer_launches_of_different_widths_back_to_back_on_cards(cards):
    """Launches of one kind at 16 lanes then 1, over two graphs on the same
    cards, enqueued with no sync between them, each bitwise the
    composition of its own inputs."""
    from rca_tpu_torch.engine.segscan import (
        down_seg_step_shard,
        down_shard_recursion,
        up_seg_step_shard,
        up_shard_recursion,
    )

    plans, runs = [], []
    for name in sorted(GRAPHS)[:2]:
        n, src, dst = GRAPHS[name]()
        graph = shard_graph(n, src, dst, 2, n_pad_to=n + 1)
        (plan,) = shard_plans(_mesh(1, 2, cards), graph, "kernels")
        assert plan.steps_form == "peer"
        plans.append((graph, plan))
    for kind in ("up", "down"):
        for gi, lanes in ((0, 16), (0, 1), (1, 16), (1, 1)):
            graph, plan = plans[gi]
            vecs = _vectors(graph.n_pad, 2, lanes, seed=lanes + gi)
            runs.append((kind, plan, [[x.to(d) for x, d in zip(v, cards)]
                                      for v in vecs]))
    got = [up_seg_steps_peer(h, 0.7, 8, plan) if kind == "up"
           else down_seg_steps_peer(a, 0.7, 8, plan, inv)
           for kind, plan, (h, a, inv) in runs]
    for d in cards:
        torch.cuda.synchronize(d)
    for (kind, plan, (h, a, inv)), blocks in zip(runs, got):
        want = (up_shard_recursion(h, 0.7, 8, plan.up, up_seg_step_shard)
                if kind == "up" else
                down_shard_recursion(a, 0.7, 8, plan.dn, inv,
                                     down_seg_step_shard))
        assert all(torch.equal(_bits(g), _bits(w))
                   for g, w in zip(blocks, want))
