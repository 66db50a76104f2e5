"""The node-sharded engine's recursions over every shard of one card,
against the per-step composition and against the JAX package's sharded
propagation.

Where every shard of a ``dp`` row lies on one CUDA device, the plan's
``steps_form`` is ``shard_grid``: ``up_seg_steps_shard`` /
``down_seg_steps_shard`` run each recursion in one cooperative launch over
every shard of the card (``rca_tpu_torch/csrc/segshard.cu``), over the
shards' joined layouts (``ShardGrid``).  On a CPU tensor each computes its
plain version, the per-step composition: the plain per-shard step between
an all-gather (and, for the impact, a reduce-scatter in shard order and
the multiply by ``inv_deg``).  These tests hold:

- the plain versions bitwise the composition as the engine ran it step by
  step, and the wrappers bitwise the plain versions, at sp 1 / 2 / 4 / 8,
  1 and 3 lanes, depths 0 / 1 / 8 / 13, over a cascade, a star split
  across the shards, a hub cut by a shard boundary and a graph where a
  shard has no edge;
- ``propagate_blocks`` in the ``shard_grid`` form bitwise the ``step``
  form, against the reference's ``sharded_propagate_full`` at rtol 1e-5 /
  atol 1e-6, and ``a`` / ``u`` bitwise the dense engine (``m`` and the
  score at the same tolerance), with NaN / Inf rows;
- the joined layouts: every shard's segments with their edges in order
  and their reduction kind, each node's pairs in shard order, a model of
  the kernels' arithmetic over them against the composition;
- the launch's partition of the items: each (shard, segment, lane) once a
  step at the 2047- and 49,999-service shapes;
- the plan's form from its device list, a pure function of
  ``torch.device`` objects, and the collectives each form moves;
- the kernels on the card (marker ``cuda``; they skip here: ``python3
  chip_smoke.py`` runs the same checks there).
"""

import numpy as np
import pytest
import torch

import jax

from rca_tpu.cluster.generator import synthetic_cascade_arrays as ref_cascade
from rca_tpu.engine.train import packaged_params as ref_packaged_params
from rca_tpu.parallel.mesh import make_mesh as ref_make_mesh
from rca_tpu.parallel.sharded import shard_graph as ref_shard_graph
from rca_tpu.parallel.sharded import sharded_propagate_full as ref_full
from rca_tpu_torch import params_from_jax
from rca_tpu_torch.cli import main
from rca_tpu_torch.config import RCAConfig, bucket_for
from rca_tpu_torch.engine import GraphEngine, ShardedGraphEngine
from rca_tpu_torch.engine.registry import reset_registry
from rca_tpu_torch.engine.runner import finite_mask_rows_np
from rca_tpu_torch.engine.segscan import (
    GRID_BIG_MIN,
    SHORT_SEGMENT_MAX,
    build_shard_grid,
    down_seg_step_shard_plain,
    down_seg_steps_shard,
    down_seg_steps_shard_plain,
    grid_items,
    grid_shares,
    steps_grid,
    up_seg_step_shard_plain,
    up_seg_steps_shard,
    up_seg_steps_shard_plain,
)
from rca_tpu_torch.parallel import sharded
from rca_tpu_torch.parallel.collectives import (
    COLLECTIVE_BYTES,
    COLLECTIVE_CALLS,
    all_gather,
    psum_scatter,
    reset_collectives,
)
from rca_tpu_torch.parallel.mesh import make_mesh
from rca_tpu_torch.parallel.sharded import (
    build_sharded_seg_layouts,
    shard_graph,
    shard_plans,
    shard_steps_form,
    sharded_propagate_full,
)

C = 13
CPU = torch.device("cpu")
DECAY = 0.6
STEPS = [0, 1, 8, 13]
SPS = [1, 2, 4, 8]


def _mesh(dp, sp, devices=None):
    return make_mesh([("dp", dp), ("sp", sp)], devices or [CPU] * (dp * sp))


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


def _port_params(ref):
    aw, hw = ref.weight_arrays()
    return params_from_jax(np.array(aw), np.array(hw), ref.steps, ref.decay,
                           ref.explain_strength, ref.impact_bonus,
                           ref.error_contrast)


def _star(n=96):
    """Every service depends on node 5 (one destination segment in every
    shard), and node 5 has 300 dependencies drawn with repeats (a source
    segment above one warp's 256 edges in shard 0)."""
    rng = np.random.default_rng(3)
    others = np.setdiff1d(np.arange(n), [5])
    src = np.concatenate([others, np.full(300, 5)])
    dst = np.concatenate([np.full(len(others), 5), rng.choice(others, 300)])
    return n, src.astype(np.int32), dst.astype(np.int32)


def _hub(n=128):
    """A hub at node 15, the last of shard 0 at sp 8 (and inside it at
    lower sp): 40 dependencies and 40 dependents over every shard, beside
    a random sparse graph."""
    rng = np.random.default_rng(4)
    src = np.concatenate([rng.integers(0, n, 2 * n), np.full(40, 15),
                          rng.integers(0, n, 40)])
    dst = np.concatenate([rng.integers(0, n, 2 * n), rng.integers(0, n, 40),
                          np.full(40, 15)])
    keep = src != dst
    return n, src[keep].astype(np.int32), dst[keep].astype(np.int32)


def _lonely(n=64):
    """Edges only among the first half of the nodes: at sp >= 2 the last
    shard owns no source and its edge partition is empty."""
    rng = np.random.default_rng(5)
    src = rng.integers(0, n // 2, 3 * n)
    dst = rng.integers(0, n, 3 * n)
    keep = src != dst
    return n, src[keep].astype(np.int32), dst[keep].astype(np.int32)


def _cascade():
    case = ref_cascade(300, n_roots=2, seed=5, mode="adversarial",
                       fault_mix="mixed")
    return case.n, case.dep_src, case.dep_dst


GRAPHS = {"cascade_300": _cascade, "star_96": _star, "hub_128": _hub,
          "lonely_64": _lonely}


def _plan(graph, sp, kernel="kernels"):
    (plan,) = shard_plans(_mesh(1, sp), graph, kernel)
    return plan


def _grid(graph):
    lay = build_sharded_seg_layouts(graph)
    return build_shard_grid(lay.up_offsets, lay.up_other, lay.dn_offsets,
                            lay.dn_other)


def _vectors(n_pad, lanes, seed, poison=True):
    """``h``, ``a_ex`` and ``inv_deg`` from numpy, with a few zeros (the
    background excess leaves many) and, ``poison``: in each lane a NaN and
    an Inf."""
    rng = np.random.default_rng(seed)
    shape = (n_pad,) if lanes is None else (lanes, n_pad)
    h = rng.uniform(0, 1, shape).astype(np.float32)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    a[..., rng.choice(n_pad, n_pad // 4, replace=False)] = 0.0
    if poison:
        h[..., 3], a[..., 5], a[..., 9] = np.nan, np.nan, np.inf
    inv = (1.0 / rng.integers(1, 6, n_pad)).astype(np.float32)
    return (torch.from_numpy(h), torch.from_numpy(a), torch.from_numpy(inv))


def _bits(t):
    return t.contiguous().view(torch.int32)


def _composed_up(h, steps, plan):
    """The explain-away recursion exactly as the engine composed it step by
    step before the one-launch form (all-gather, then the per-shard
    step)."""
    sp, block = len(plan.up), plan.block
    devs = [h.device] * sp
    u_blk = [torch.zeros(h.shape[:-1] + (block,)) for _ in range(sp)]
    for _ in range(steps):
        u_full = all_gather(u_blk, devs)
        u_blk = [up_seg_step_shard_plain(u_full[k], h, DECAY, plan.up[k],
                                         k * block) for k in range(sp)]
    return torch.cat(u_blk, dim=-1)


def _composed_down(a_ex, inv_deg, steps, plan):
    sp, block = len(plan.dn), plan.block
    devs = [a_ex.device] * sp
    inv_blk = [inv_deg[k * block:(k + 1) * block] for k in range(sp)]
    m_blk = [torch.zeros(a_ex.shape[:-1] + (block,)) for _ in range(sp)]
    for _ in range(steps):
        m_full = all_gather(m_blk, devs)
        contrib = [down_seg_step_shard_plain(m_full[k], a_ex, DECAY,
                                             plan.dn[k]) for k in range(sp)]
        m_blk = [c * inv for c, inv in zip(psum_scatter(contrib, devs),
                                           inv_blk)]
    return torch.cat(m_blk, dim=-1)


# -- the plain versions and the wrappers ---------------------------------------

@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("lanes", [None, 3])
@pytest.mark.parametrize("sp", SPS)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_plain_recursions_are_the_per_step_composition(name, sp, lanes,
                                                       steps):
    n, src, dst = GRAPHS[name]()
    graph = shard_graph(n, src, dst, sp, n_pad_to=n + 1)
    plan = _plan(graph, sp)
    grid = _grid(graph).to(CPU)
    h, a_ex, inv = _vectors(graph.n_pad, lanes, seed=sp * 100 + steps)
    u = up_seg_steps_shard_plain(h, DECAY, steps, plan.up)
    m = down_seg_steps_shard_plain(a_ex, DECAY, steps, plan.dn, inv)
    assert u.shape == m.shape == h.shape
    assert torch.equal(_bits(u), _bits(_composed_up(h, steps, plan)))
    assert torch.equal(_bits(m), _bits(_composed_down(a_ex, inv, steps,
                                                      plan)))
    # the wrappers compute the plain versions on CPU tensors, into out too
    assert torch.equal(_bits(up_seg_steps_shard(h, DECAY, steps, plan.up,
                                                grid)), _bits(u))
    out = torch.empty_like(a_ex)
    got = down_seg_steps_shard(a_ex, DECAY, steps, plan.dn, grid, inv,
                               out=out)
    assert got is out and torch.equal(_bits(out), _bits(m))
    if steps == 0:
        assert not u.any() and not m.any()


def test_lanes_are_solo_recursions():
    n, src, dst = _hub()
    graph = shard_graph(n, src, dst, 4, n_pad_to=n + 1)
    plan = _plan(graph, 4)
    h, a_ex, inv = _vectors(graph.n_pad, 3, seed=9)
    u = up_seg_steps_shard_plain(h, DECAY, 8, plan.up)
    m = down_seg_steps_shard_plain(a_ex, DECAY, 8, plan.dn, inv)
    for b in range(3):
        assert torch.equal(_bits(u[b]), _bits(up_seg_steps_shard_plain(
            h[b].contiguous(), DECAY, 8, plan.up)))
        assert torch.equal(_bits(m[b]), _bits(down_seg_steps_shard_plain(
            a_ex[b].contiguous(), DECAY, 8, plan.dn, inv)))


@pytest.mark.parametrize("bad", ["dtype", "shape", "steps", "inv_deg",
                                 "out_is_input", "device"])
def test_shard_wrappers_check_their_inputs(bad):
    n, src, dst = _hub()
    graph = shard_graph(n, src, dst, 4, n_pad_to=n + 1)
    plan = _plan(graph, 4)
    grid = _grid(graph).to(CPU)
    h, a_ex, inv = _vectors(graph.n_pad, None, seed=1)
    steps, out = 8, None
    if bad == "dtype":
        a_ex = a_ex.double()
    elif bad == "shape":
        a_ex = a_ex[:-1]
    elif bad == "steps":
        steps = -1
    elif bad == "inv_deg":
        inv = inv[:-1]
    elif bad == "out_is_input":
        out = a_ex
    elif bad == "device":
        grid = _grid(graph)   # host numpy: not moved to a device
    with pytest.raises((TypeError, ValueError)):
        down_seg_steps_shard(a_ex, DECAY, steps, plan.dn, grid, inv, out=out)
    if bad in ("dtype", "shape", "steps", "out_is_input", "device"):
        with pytest.raises((TypeError, ValueError)):
            up_seg_steps_shard(a_ex, DECAY, steps, plan.up, grid, out=out)


# -- the joined layouts ----------------------------------------------------------

def _kind(count):
    return ("short" if count <= SHORT_SEGMENT_MAX else
            "long" if count <= GRID_BIG_MIN else "big")


def _position_kinds(n_seg, n_long, n_big):
    return ["big"] * n_big + ["long"] * (n_long - n_big) + \
        ["short"] * (n_seg - n_long)


@pytest.mark.parametrize("sp", SPS)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_joined_layouts_hold_every_shard_segment_in_order(name, sp):
    n, src, dst = GRAPHS[name]()
    graph = shard_graph(n, src, dst, sp, n_pad_to=n + 1)
    lay = build_sharded_seg_layouts(graph)
    grid = _grid(graph)
    block, n_pad = graph.block, graph.n_pad
    # up: position q holds node up_seg[q], shard k's own source s
    assert sorted(grid.up_seg.tolist()) == list(range(n_pad))
    kinds = _position_kinds(n_pad, grid.up_n_long, grid.up_n_big)
    for q, node in enumerate(grid.up_seg):
        k, s = divmod(int(node), block)
        want = lay.up_other[k][lay.up_offsets[k][s]:lay.up_offsets[k][s + 1]]
        got = grid.up_other[grid.up_offsets[q]:grid.up_offsets[q + 1]]
        assert np.array_equal(got, want)
        assert kinds[q] == _kind(len(want))
    # down: every (shard, destination) pair shard k reaches, once, slot v
    # in shard-major order
    counts = np.diff(lay.dn_offsets, axis=1)
    pair_shard, pair_dst = np.nonzero(counts)
    assert grid.pairs == len(pair_shard)
    assert sorted(grid.dn_seg.tolist()) == list(range(grid.pairs))
    kinds = _position_kinds(grid.pairs, grid.dn_n_long, grid.dn_n_big)
    for q, v in enumerate(grid.dn_seg):
        k, d = int(pair_shard[v]), int(pair_dst[v])
        want = lay.dn_other[k][lay.dn_offsets[k][d]:lay.dn_offsets[k][d + 1]]
        got = grid.dn_other[grid.dn_offsets[q]:grid.dn_offsets[q + 1]]
        assert len(want) and np.array_equal(got, want)
        assert kinds[q] == _kind(len(want))
    assert len(grid.up_other) == len(grid.dn_other) == int(graph.mask.sum())
    # each node's pairs: the shards that reach it, in shard order
    for d in range(n_pad):
        slots = grid.reach[grid.reach_offsets[d]:grid.reach_offsets[d + 1]]
        assert (pair_dst[slots] == d).all()
        assert pair_shard[slots].tolist() == \
            np.flatnonzero(counts[:, d]).tolist()


def _model_up(grid, h, steps):
    """The up kernel's arithmetic over the joined layout, in torch: each
    step the gathered values of every node, each position's max over its
    edges into its node."""
    u = torch.zeros_like(h)
    pos = torch.repeat_interleave(torch.arange(len(grid.up_seg)),
                                  torch.from_numpy(np.diff(grid.up_offsets)))
    seg = torch.from_numpy(grid.up_seg).long()[pos]
    other = torch.from_numpy(grid.up_other).long()
    for _ in range(steps):
        w = torch.maximum(h, np.float32(DECAY) * u)
        total = torch.zeros_like(h).scatter_reduce(
            -1, seg.expand(h.shape[:-1] + seg.shape), w[..., other], "amax")
        u = torch.maximum(u, total)
    return u


def _model_down(grid, a_ex, inv, steps):
    """The down kernel's two phases over the joined layout in float64:
    each pair's sum over its edges, then each node's pairs added through
    its reach list, scaled."""
    a64, inv64 = a_ex.double(), inv.double()
    pos = torch.repeat_interleave(torch.arange(grid.pairs),
                                  torch.from_numpy(np.diff(grid.dn_offsets)))
    slot = torch.from_numpy(grid.dn_seg).long()[pos]
    other = torch.from_numpy(grid.dn_other).long()
    node = torch.repeat_interleave(
        torch.arange(len(grid.reach_offsets) - 1),
        torch.from_numpy(np.diff(grid.reach_offsets)))
    reach = torch.from_numpy(grid.reach).long()
    m = torch.zeros_like(a64)
    for _ in range(steps):
        w = a64 + DECAY * m
        c = torch.zeros(a64.shape[:-1] + (grid.pairs,), dtype=torch.float64)
        c.index_add_(-1, slot, w[..., other])
        m = torch.zeros_like(a64).index_add_(-1, node, c[..., reach]) * inv64
    return m


@pytest.mark.parametrize("sp", [2, 4, 8])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_a_model_of_the_kernels_over_the_joined_layouts(name, sp):
    """The kernels' arithmetic over the joined layouts against the
    composition: ``u`` bitwise (a max), ``m`` at rtol 1e-5 / atol 1e-6
    (float64 against the composition's float32 sums); finite inputs."""
    n, src, dst = GRAPHS[name]()
    graph = shard_graph(n, src, dst, sp, n_pad_to=n + 1)
    plan, grid = _plan(graph, sp), _grid(graph)
    rng = np.random.default_rng(sp)
    h = torch.from_numpy(rng.uniform(0, 1, (2, graph.n_pad))
                         .astype(np.float32))
    a_ex = torch.from_numpy(rng.uniform(0, 1, (2, graph.n_pad))
                            .astype(np.float32))
    inv = torch.from_numpy((1.0 / rng.integers(1, 6, graph.n_pad))
                           .astype(np.float32))
    assert torch.equal(_bits(_model_up(grid, h, 8)),
                       _bits(up_seg_steps_shard_plain(h, DECAY, 8, plan.up)))
    np.testing.assert_allclose(
        _model_down(grid, a_ex, inv, 8).numpy(),
        down_seg_steps_shard_plain(a_ex, DECAY, 8, plan.dn, inv).numpy(),
        rtol=1e-5, atol=1e-6)


def _shape_graph(n, e, seed):
    """A graph of ``n`` services and about ``e`` edges with a hub of up to
    3000 dependents and as many dependencies: the shape of a tier's
    cascade, made in numpy (the tier's generator takes seconds at
    49,999)."""
    rng = np.random.default_rng(seed)
    hub = min(3000, e // 4)
    src = np.concatenate([rng.integers(0, n, e - 2 * hub), np.full(hub, 7),
                          rng.integers(0, n, hub)])
    dst = np.concatenate([rng.integers(0, n, e - 2 * hub),
                          rng.integers(0, n, hub), np.full(hub, 7)])
    keep = src != dst
    return src[keep].astype(np.int32), dst[keep].astype(np.int32)


@pytest.mark.parametrize("lanes", [1, 8, 16])
@pytest.mark.parametrize("cap", [132, 1056])
@pytest.mark.parametrize("sp", [4, 8])
@pytest.mark.parametrize("n,e", [(2047, 4087), (49999, 99867)])
def test_the_launch_partitions_every_shard_segment_once(n, e, sp, cap, lanes):
    """Each (shard, segment, lane) of both recursions is one CTA's, once a
    step, under the grid the wrapper sizes (``steps_grid`` over the
    layout's items, at most ``cap`` CTAs), with the kernel's own
    arithmetic for each CTA's share (``grid_shares``)."""
    buckets = RCAConfig().shape_buckets
    graph = shard_graph(n, *_shape_graph(n, e, seed=n), sp,
                        n_pad_to=bucket_for(n + 1, buckets))
    grid = _grid(graph)
    pair_shard, pair_dst = np.nonzero(np.diff(
        build_sharded_seg_layouts(graph).dn_offsets, axis=1))
    for n_seg, n_long, n_big, ids in (
            (graph.n_pad, grid.up_n_long, grid.up_n_big,
             [divmod(int(s), graph.block) for s in grid.up_seg]),
            (grid.pairs, grid.dn_n_long, grid.dn_n_big,
             [(int(pair_shard[v]), int(pair_dst[v]))
              for v in grid.dn_seg])):
        n_items = grid_items(n_seg, n_long, n_big)
        launch = steps_grid(max(1, n_items), lanes, cap)
        assert launch[0] * launch[1] <= cap
        starts = (list(range(n_big))
                  + [n_big + j * 8 for j in range(-(-(n_long - n_big) // 8))]
                  + [n_long + j * 256
                     for j in range(-(-(n_seg - n_long) // 256))] + [n_seg])
        assert len(starts) == n_items + 1
        seen = np.zeros((lanes, n_seg), np.int64)
        for (j0, j1), (b0, b1) in grid_shares(n_items, lanes, launch):
            seen[b0:b1, starts[j0]:starts[j1]] += 1
        assert (seen == 1).all()
        assert len(set(ids)) == n_seg


# -- the engine's propagation in both forms --------------------------------------

def _batch(case, n_pad, lanes, seed):
    rng = np.random.default_rng(seed)
    fb = np.zeros((lanes, n_pad, C), np.float32)
    fb[:, :case.n] = case.features
    for b in range(1, lanes):
        rows = rng.integers(0, case.n, 6)
        fb[b, rows] = rng.uniform(0, 1, (6, C))
    # NaN / Inf rows, sanitized on the host as the sharded engine stages
    # them (both packages' propagations take sanitized rows)
    fb[1, [4, 40, 90], [2, 6, 11]] = (np.nan, np.inf, -np.inf)
    return finite_mask_rows_np(fb)[0]


def _as_shard_grid(monkeypatch):
    """Plans of the ``kernels`` row in the ``shard_grid`` form on the CPU,
    where its wrappers compute their plain versions."""
    monkeypatch.setattr(sharded, "shard_steps_form", lambda devices:
                        "shard_grid")


@pytest.mark.parametrize("dp,sp", [(1, 8), (2, 4), (4, 2), (8, 1)])
def test_shard_grid_form_is_the_step_form_and_the_reference(dp, sp, env,
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
    _as_shard_grid(env)
    plans = shard_plans(_mesh(dp, sp), graph, "kernels")
    assert all(p.steps_form == "shard_grid" and p.grid is not None
               for p in plans)
    got = sharded_propagate_full(_mesh(dp, sp), fb, graph, params, "kernels")
    assert torch.equal(_bits(got), _bits(step))
    ref = np.asarray(ref_full(
        ref_make_mesh([("dp", dp), ("sp", sp)]), fb,
        ref_shard_graph(case.n, case.dep_src, case.dep_dst, sp, **kw),
        ref_params))
    # a (and so u) differ from the reference's in the last bit where the
    # two fronts round the noisy-OR products apart: allclose, as the step
    # form is (test_torch_parallel.py)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sp", [2, 4])
def test_shard_grid_engine_matches_the_step_engine(sp, env):
    """``ShardedGraphEngine`` restaged, resident and batched: the
    ``shard_grid`` form bitwise the ``step`` form, NaN / Inf rows
    included; ``a`` and ``u`` bitwise the dense engine, ``m`` and the
    score within rtol 1e-5 / atol 1e-6 of it."""
    env.setenv("RCA_KERNEL", "kernels")
    case = ref_cascade(700, n_roots=2, seed=4)
    feats = case.features.copy()
    feats[[3, 90, 400], [2, 12, 0]] = (np.nan, np.inf, -np.inf)
    want = ShardedGraphEngine(mesh=_mesh(1, sp), resident=False)
    want_r = want.analyze_arrays(feats, case.dep_src, case.dep_dst, k=10)
    dense = GraphEngine(device="cpu", resident=False).analyze_arrays(
        feats, case.dep_src, case.dep_dst, k=10).full_diagnostics()
    batch = np.repeat(feats[None], 4, axis=0)
    batch[2, 50] = 0.0
    want_b = ShardedGraphEngine(mesh=_mesh(2, sp)).analyze_batch(
        batch, case.dep_src, case.dep_dst)
    _as_shard_grid(env)
    for eng in (ShardedGraphEngine(mesh=_mesh(1, sp), resident=False),
                ShardedGraphEngine(mesh=_mesh(1, sp))):
        for _ in range(2):
            got = eng.analyze_arrays(feats, case.dep_src, case.dep_dst,
                                     k=10)
            assert np.array_equal(got.full_diagnostics().view(np.int32),
                                  want_r.full_diagnostics().view(np.int32))
            assert got.top_components() == want_r.top_components()
            assert got.sanitized_rows == want_r.sanitized_rows == 3
            diag, n = got.full_diagnostics(), case.n
            assert np.array_equal(diag[:2, :n], dense[:2, :n]), "a, u"
            np.testing.assert_allclose(diag[2:, :n], dense[2:, :n],
                                       rtol=1e-5, atol=1e-6)
    got_b = ShardedGraphEngine(mesh=_mesh(2, sp)).analyze_batch(
        batch, case.dep_src, case.dep_dst)
    for g, w in zip(got_b, want_b):
        assert np.array_equal(g.score.view(np.int32), w.score.view(np.int32))
        assert g.top_components() == w.top_components()


# -- the plan's form -------------------------------------------------------------

@pytest.mark.parametrize("devices,form", [
    (["cuda:0"] * 4, "shard_grid"),
    (["cuda:1"] * 2, "shard_grid"),
    (["cuda:0"], "shard_grid"),
    (["cuda:0", "cuda:1"], "step"),
    (["cuda:0", "cuda:0", "cuda:1", "cuda:1"], "step"),
    (["cuda:0", "cpu"], "step"),
    (["cpu"] * 4, "step"),
    (["cpu"], "step"),
])
def test_the_form_follows_the_device_list(devices, form):
    assert shard_steps_form([torch.device(d) for d in devices]) == form
    assert shard_steps_form(devices) == form


@pytest.mark.parametrize("kernel", ["kernels", "torch"])
def test_plans_off_the_card_take_the_step_form(kernel):
    n, src, dst = _hub()
    graph = shard_graph(n, src, dst, 4, n_pad_to=n + 1)
    plan = _plan(graph, 4, kernel)
    assert plan.steps_form == "step" and plan.grid is None
    assert plan.kernel == kernel


def test_plan_form_follows_its_grid_and_row(env):
    """Only the ``kernels`` row takes the grid: where the devices give
    ``shard_grid``, its plan holds the joined layouts on the card and
    says so; the ``torch`` row's plan over the same devices holds none
    and takes the ``step`` form."""
    n, src, dst = _hub()
    graph = shard_graph(n, src, dst, 4, n_pad_to=n + 1)
    _as_shard_grid(env)
    kern, plain = _plan(graph, 4, "kernels"), _plan(graph, 4, "torch")
    assert kern.steps_form == "shard_grid"
    assert kern.grid.reach_offsets.device == CPU
    want = _grid(graph)
    for got, ref in zip(kern.grid, want):
        if isinstance(ref, np.ndarray):
            assert np.array_equal(got.numpy(), ref)
        else:
            assert got == ref
    assert plain.steps_form == "step" and plain.grid is None
    assert kern._replace(grid=None).steps_form == "step"


def test_kernels_command_prints_the_sharded_form(capsys, env):
    assert main(["kernels", "--services", "2047", "--sp", "4", "--explain",
                 "--no-cost", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    steps = [line for line in out.splitlines()
             if line.strip().startswith("steps") and "step:" in line]
    assert steps, out
    assert sharded.shard_steps_note(4, "cuda:0").startswith("shard_grid:")
    assert sharded.shard_steps_note(4, "cpu").startswith("step:")


# -- what moves between shards -----------------------------------------------------

def test_shard_grid_moves_only_the_one_time_collectives(env, monkeypatch):
    """In the ``shard_grid`` form a step moves nothing between shards, and
    neither does the front, whose one launch writes the joined ``a`` and
    ``h`` the gathers would hand each shard: an analysis runs no
    all-gather and the degree reduce-scatter alone, moving ``(sp - 1) *
    block * 4`` bytes through every shard.  (The ``step`` form's budget is
    ``test_torch_parallel.py::test_collective_bytes_are_the_round5_budget``.)
    The wrappers here stand in for the kernels, which move nothing."""
    env.setenv("RCA_KERNEL", "kernels")
    case = ref_cascade(2047, n_roots=3, seed=0)
    sp = 8
    _as_shard_grid(monkeypatch)
    monkeypatch.setattr(sharded, "up_seg_steps_shard",
                        lambda h, *args: torch.zeros_like(h))
    monkeypatch.setattr(sharded, "down_seg_steps_shard",
                        lambda a_ex, *args: torch.zeros_like(a_ex))
    eng = ShardedGraphEngine(mesh=_mesh(1, sp), resident=False)
    graph = eng._shard(case.n, case.dep_src, case.dep_dst)
    reset_collectives()
    eng.analyze_case(case)
    per_shard = (sp - 1) * graph.block * 4
    assert COLLECTIVE_CALLS["all_gather"] == 0
    assert COLLECTIVE_CALLS["reduce_scatter"] == 1
    assert COLLECTIVE_BYTES["all_gather"] == 0
    assert COLLECTIVE_BYTES["reduce_scatter"] == 1 * sp * per_shard
    assert COLLECTIVE_CALLS["topk_gather"] == 3


# -- on the card ------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the shard recursions run only on the "
                    "card (python3 chip_smoke.py runs them there)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("sp", SPS)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_shard_kernels_are_the_per_step_launches_on_card(name, sp, steps,
                                                         cuda_device):
    from rca_tpu_torch.engine.segscan import (
        down_seg_step_shard,
        down_shard_recursion,
        up_seg_step_shard,
        up_shard_recursion,
    )

    n, src, dst = GRAPHS[name]()
    graph = shard_graph(n, src, dst, sp, n_pad_to=n + 1)
    (plan,) = shard_plans(_mesh(1, sp, [cuda_device] * sp), graph, "kernels")
    assert plan.steps_form == "shard_grid"
    block = plan.block
    for lanes in (None, 3, 16):
        for poison in (True, False):
            h, a_ex, inv = (t.to(cuda_device) for t in _vectors(
                graph.n_pad, lanes, seed=steps, poison=poison))
            u = up_seg_steps_shard(h, DECAY, steps, plan.up, plan.grid)
            m = down_seg_steps_shard(a_ex, DECAY, steps, plan.dn, plan.grid,
                                     inv)
            u_step = torch.cat(up_shard_recursion(
                [h] * sp, DECAY, steps, plan.up, up_seg_step_shard), -1)
            m_step = torch.cat(down_shard_recursion(
                [a_ex] * sp, DECAY, steps, plan.dn,
                [inv[k * block:(k + 1) * block] for k in range(sp)],
                down_seg_step_shard), -1)
            assert torch.equal(_bits(u), _bits(u_step))
            assert torch.equal(_bits(m), _bits(m_step))
            if poison:
                # on NaN / Inf the kernels' fmaxf and sums part ways with
                # the plain scan's torch.maximum and masked products
                continue
            assert torch.equal(_bits(u), _bits(up_seg_steps_shard_plain(
                h, DECAY, steps, plan.up)))
            torch.testing.assert_close(m, down_seg_steps_shard_plain(
                a_ex, DECAY, steps, plan.dn, inv), rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_sharded_analysis_launches_each_recursion_once_on_card(cuda_device,
                                                               env):
    from rca_tpu_torch.kernels import LAUNCHES, SHARD_LAUNCHES, reset_launches

    case = ref_cascade(2047, n_roots=3, seed=0)
    eng = ShardedGraphEngine(mesh=_mesh(1, 4, [cuda_device] * 4),
                             resident=False)
    eng.analyze_arrays(case.features, case.dep_src, case.dep_dst)
    reset_launches()
    eng.analyze_arrays(case.features, case.dep_src, case.dep_dst)
    assert SHARD_LAUNCHES == {"seg_up_step": 0, "seg_down_step": 0,
                              "seg_contrast_step": 0,
                              "seg_up_steps_shard": 1,
                              "seg_down_steps_shard": 1,
                              "evidence_front_shard": 1}
    assert LAUNCHES["evidence_front"] == 0
