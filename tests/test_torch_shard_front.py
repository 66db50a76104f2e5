"""The node-sharded engine's front over every shard of one card, against
the per-shard composition and against the JAX package's sharded
propagation.

Where every shard of a ``dp`` row lies on one CUDA device (the plan's
``shard_grid`` form), ``evidence_front_shard`` runs the front of every
shard in one cooperative launch (``rca_tpu_torch/csrc/frontshard.cu``):
the row pass over the shards' separate row buffers, a grid barrier, the
contrast over the shards' joined up layout (``ShardGrid.up_*``), into
joined ``[..., n_pad]`` ``a`` and ``h``.  On a CPU tensor it computes its
plain version, the per-shard composition (the row pass per shard, the
``e`` gather, the per-shard contrast).  These tests hold:

- the plain version bitwise the composition as the engine's ``step`` form
  runs it (gathers included), and the joined ``a`` / ``h`` bitwise the
  dense front, over a cascade, a star split across the shards, a hub cut
  by a shard boundary, a graph where a shard has no edge and the
  2047-service cascade, at sp 2 / 4 / 8, lanes None / 3 / 16, a contrast
  weight of 0 and the packaged one, NaN / Inf rows included;
- a model of the kernel's arithmetic over the joined layout bitwise the
  composition, and a model of its work partition: every row of every
  shard once, every joined segment of every lane once, at the 2047- and
  49,999-service shapes under several caps and lane counts;
- the bound of the launch: the bytes of its function, the fused front's
  count less the segment order and the bad-row count, as PERF.md prints
  it;
- the wrapper's contract (mixed devices, unequal or non-contiguous blocks,
  more shards than its table, a layout on the host or of another size);
- ``propagate_blocks`` in the ``shard_grid`` form bitwise the ``step``
  form and within rtol 1e-5 / atol 1e-6 of the reference's
  ``sharded_propagate_full``, its stacks views of one joined stack, and
  the sharded streaming session in both forms bitwise;
- the kernel on the card (marker ``cuda``; it skips here: ``python3
  chip_smoke.py`` runs the same checks there).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from rca_tpu.cluster.generator import synthetic_cascade_arrays as ref_cascade
from rca_tpu.engine.train import packaged_params as ref_packaged_params
from rca_tpu.parallel.mesh import make_mesh as ref_make_mesh
from rca_tpu.parallel.sharded import shard_graph as ref_shard_graph
from rca_tpu.parallel.sharded import sharded_propagate_full as ref_full
from rca_tpu_torch.config import RCAConfig, bucket_for
from rca_tpu_torch.engine.evidence import (
    FRONT_TILE_ROWS,
    MAX_FRONT_SHARDS,
    evidence_front_plain,
    evidence_front_rows_plain,
    evidence_front_shard,
    evidence_front_shard_plain,
    fold_error_contrast,
    front_grid,
    seg_contrast_step_shard_plain,
)
from rca_tpu_torch.engine.registry import reset_registry
from rca_tpu_torch.engine.segscan import SHORT_SEGMENT_MAX, build_seg_layouts
from rca_tpu_torch.features.schema import SvcF
from rca_tpu_torch.kernels import cost
from rca_tpu_torch.parallel import sharded
from rca_tpu_torch.parallel.collectives import all_gather
from rca_tpu_torch.parallel.sharded import (
    shard_graph,
    shard_plans,
    sharded_propagate_full,
)
from rca_tpu_torch.parallel.streaming import ShardedStreamingSession
from test_torch_shard_steps import (
    GRAPHS,
    _as_shard_grid,
    _batch,
    _bits,
    _grid,
    _mesh,
    _port_params,
    _shape_graph,
)

C = 13
CPU = torch.device("cpu")
SPS = [2, 4, 8]
LANES = [None, 3, 16]


def _cascade_2047():
    case = ref_cascade(2047, n_roots=3, seed=0)
    return case.n, case.dep_src, case.dep_dst


FRONT_GRAPHS = {**GRAPHS, "cascade_2047": _cascade_2047}


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


@pytest.fixture(scope="module")
def weights(ref_params):
    aw, hw = _port_params(ref_params).weight_arrays()
    return torch.from_numpy(aw), torch.from_numpy(hw)


def _features(n_pad, lanes, seed):
    """Raw ``[n_pad, C]`` (or ``[lanes, n_pad, C]``) rows from numpy: mostly
    zeros, as the extractor leaves them, a few rows of evidence and error
    rates, and NaN / Inf rows (in every lane)."""
    rng = np.random.default_rng(seed)
    shape = (n_pad, C) if lanes is None else (lanes, n_pad, C)
    f = np.zeros(shape, np.float32)
    hot = rng.random(shape[:-1]) < 0.3
    f[hot] = rng.uniform(-0.2, 1.2, (int(hot.sum()), C)).astype(np.float32)
    f[..., SvcF.ERROR_RATE] = np.where(rng.random(shape[:-1]) < 0.5,
                                       rng.uniform(0, 1, shape[:-1]), 0.0)
    f[..., 4, 2], f[..., 9, 6], f[..., n_pad // 2, 11] = (np.nan, np.inf,
                                                          -np.inf)
    return torch.from_numpy(f)


def _blocks(f, sp, block):
    return [f[..., k * block:(k + 1) * block, :].contiguous()
            for k in range(sp)]


def _composed(f_blks, aw, hw, weight, plan):
    """The front exactly as the engine's ``step`` form composes it: the
    row pass per shard, the ``e`` all-gather, the contrast per shard, the
    ``h`` / ``a`` all-gathers; the joined vectors."""
    sp, block = len(f_blks), plan.block
    devs = [CPU] * sp
    front = [evidence_front_rows_plain(f, aw, hw) for f in f_blks]
    a_blk = [r[0] for r in front]
    if weight:
        e_full = all_gather([r[2] for r in front], devs)
        a_blk = [seg_contrast_step_shard_plain(a_blk[k], e_full[k], weight,
                                               plan.up[k], k * block)
                 for k in range(sp)]
    return (all_gather(a_blk, devs)[0],
            all_gather([r[1] for r in front], devs)[0])


# -- the plain version and the wrapper on the CPU --------------------------------

@pytest.mark.parametrize("weight", [0.0, 0.7])
@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("sp", SPS)
@pytest.mark.parametrize("name", sorted(FRONT_GRAPHS))
def test_plain_front_is_the_per_shard_composition(name, sp, lanes, weight,
                                                  weights):
    n, src, dst = FRONT_GRAPHS[name]()
    graph = shard_graph(n, src, dst, sp, n_pad_to=n + 1)
    (plan,) = shard_plans(_mesh(1, sp), graph, "kernels")
    grid = _grid(graph).to(CPU)
    aw, hw = weights
    f = _features(graph.n_pad, lanes, seed=sp * 10 + (lanes or 1))
    f_blks = _blocks(f, sp, graph.block)
    a, h = evidence_front_shard_plain(f_blks, aw, hw, weight, plan.up)
    assert a.shape == h.shape == f.shape[:-1]
    want_a, want_h = _composed(f_blks, aw, hw, weight, plan)
    assert torch.equal(_bits(a), _bits(want_a))
    assert torch.equal(_bits(h), _bits(want_h))
    # the wrapper computes the plain version on CPU tensors
    got_a, got_h = evidence_front_shard(f_blks, aw, hw, weight, plan.up, grid)
    assert torch.equal(_bits(got_a), _bits(a))
    assert torch.equal(_bits(got_h), _bits(h))
    # and the joined vectors are the dense front's over the same rows
    _, up = build_seg_layouts(graph.n_pad, len(src), src, dst, device=CPU)
    dense_a, dense_h, _ = evidence_front_plain(f, aw, hw, weight, up)
    assert torch.equal(_bits(a), _bits(dense_a))
    assert torch.equal(_bits(h), _bits(dense_h))
    assert torch.isfinite(a).all() and torch.isfinite(h).all()


def test_resident_buffers_take_the_first_block_rows(weights):
    """The resident and streaming sessions hand the front the first
    ``block`` rows of ``[block + 1, C]`` buffers (views, contiguous)."""
    n, src, dst = _cascade_2047()
    graph = shard_graph(n, src, dst, 4, n_pad_to=n + 1)
    (plan,) = shard_plans(_mesh(1, 4), graph, "kernels")
    aw, hw = weights
    f = _features(graph.n_pad, None, seed=5)
    bufs = [torch.cat([b, torch.full((1, C), 7.0)])
            for b in _blocks(f, 4, graph.block)]
    views = [b[:graph.block] for b in bufs]
    assert all(v.is_contiguous() for v in views)
    got = evidence_front_shard(views, aw, hw, 0.7, plan.up,
                               _grid(graph).to(CPU))
    want = evidence_front_shard_plain(_blocks(f, 4, graph.block), aw, hw,
                                      0.7, plan.up)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))


# -- a model of the launch ---------------------------------------------------------

def _model_contrast(grid, a_raw, e, weight):
    """The kernel's phase 2 over the joined layout, in torch: each
    position's max of ``e`` over its edges (0 for none) folded into its
    node."""
    counts = torch.from_numpy(np.diff(grid.up_offsets).astype(np.int64))
    pos = torch.repeat_interleave(torch.arange(len(grid.up_seg)), counts)
    node = torch.from_numpy(grid.up_seg).long()[pos]
    other = torch.from_numpy(grid.up_other).long()
    dep_max = torch.zeros_like(e).scatter_reduce(
        -1, node.expand(e.shape[:-1] + node.shape), e[..., other], "amax")
    return fold_error_contrast(a_raw, torch.maximum(e - dep_max, e.new_zeros(
        ())), weight)


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("sp", SPS)
@pytest.mark.parametrize("name", sorted(FRONT_GRAPHS))
def test_a_model_of_the_kernel_over_the_joined_layout(name, sp, lanes,
                                                      weights):
    """The row pass per shard into the joined vectors, then the contrast
    over the joined layout, is bitwise the per-shard composition: the
    layout holds every node's own edges, and a max is order-free."""
    n, src, dst = FRONT_GRAPHS[name]()
    graph = shard_graph(n, src, dst, sp, n_pad_to=n + 1)
    (plan,) = shard_plans(_mesh(1, sp), graph, "kernels")
    grid = _grid(graph)
    aw, hw = weights
    f = _features(graph.n_pad, lanes, seed=sp)
    a_raw, h, e, _ = evidence_front_rows_plain(f, aw, hw)
    a = _model_contrast(grid, a_raw, e, 0.7)
    want_a, want_h = evidence_front_shard_plain(_blocks(f, sp, graph.block),
                                                aw, hw, 0.7, plan.up)
    assert torch.equal(_bits(a), _bits(want_a))
    assert torch.equal(_bits(h), _bits(want_h))
    # long positions first (more than SHORT_SEGMENT_MAX real edges), then
    # the short ones: the kernel's two kinds of item
    counts = np.diff(grid.up_offsets)
    assert (counts[:grid.up_n_long] > SHORT_SEGMENT_MAX).all()
    assert (counts[grid.up_n_long:] <= SHORT_SEGMENT_MAX).all()


def _launch_partition(sp, block, lanes, n_long, n_pad, fold, cap):
    """What each CTA of the launch takes, as the kernel computes it: the
    grid from ``front_grid``, phase 1's tiles ``t = c, c + G, ...`` (tile
    ``t`` of shard ``t // tiles``), phase 2's items ``w = c, c + G, ...``
    (lane ``w // per_lane``: a long position, or 256 short ones).  Returns
    how often each (lane, node) row was staged and each (lane, position)
    reduced."""
    shard_rows = lanes * block
    tiles = -(-shard_rows // FRONT_TILE_ROWS)
    n_short = n_pad - n_long
    ctas = front_grid(sp * shard_rows, lanes, n_long, n_short, fold, cap,
                      shards=sp)
    assert 1 <= ctas <= cap
    rows = np.zeros((lanes, n_pad), np.int64)
    per_lane = n_long + -(-n_short // FRONT_TILE_ROWS)
    seen = np.zeros((lanes, n_pad), np.int64)
    for c in range(ctas):
        for t in range(c, sp * tiles, ctas):
            k, first = divmod(t, tiles)
            r = np.arange(first * FRONT_TILE_ROWS,
                          min((first + 1) * FRONT_TILE_ROWS, shard_rows))
            np.add.at(rows, (r // block, k * block + r % block), 1)
        for w in range(c, per_lane * lanes if fold else 0, ctas):
            lane, j = divmod(w, per_lane)
            if j < n_long:
                seen[lane, j] += 1
            else:
                lo = n_long + (j - n_long) * FRONT_TILE_ROWS
                seen[lane, lo:min(lo + FRONT_TILE_ROWS, n_pad)] += 1
    return ctas, tiles, rows, seen


@pytest.mark.parametrize("lanes", [1, 8, 16])
@pytest.mark.parametrize("cap", [132, 1056])
@pytest.mark.parametrize("sp", [4, 8])
@pytest.mark.parametrize("n,e", [(2047, 4087), (49999, 99867)])
def test_the_launch_takes_every_row_and_segment_once(n, e, sp, cap, lanes):
    buckets = RCAConfig().shape_buckets
    graph = shard_graph(n, *_shape_graph(n, e, seed=n), sp,
                        n_pad_to=bucket_for(n + 1, buckets))
    grid = _grid(graph)
    assert sorted(grid.up_seg.tolist()) == list(range(graph.n_pad))
    for fold in (True, False):
        ctas, tiles, rows, seen = _launch_partition(
            sp, graph.block, lanes, grid.up_n_long, graph.n_pad, fold, cap)
        assert (rows == 1).all()
        assert (seen == (1 if fold else 0)).all()
        # the grid: the work's items where they fit under the cap
        work = max(sp * tiles, lanes * (grid.up_n_long + -(
            -(graph.n_pad - grid.up_n_long) // FRONT_TILE_ROWS)) if fold
            else 0)
        assert ctas == min(work, cap)


def test_front_grid_counts_tiles_per_shard():
    # 3 shards of 300 rows: 2 tiles each (the last ragged), not 4
    assert front_grid(900, 1, 0, 900, False, 1000, shards=3) == 6
    assert front_grid(900, 1, 0, 900, False, 1000) == 4
    assert front_grid(900, 1, 0, 900, False, 5, shards=3) == 5


# -- the bound ---------------------------------------------------------------------

#: (services, n_pad, the cascade's real edges, PERF.md's bound of the
#: sharded front in ms)
SHARD_FRONT_BOUNDS = [(2047, 2048, 4087, "0.0000440"),
                      (49999, 53248, 99867, "0.001137")]


@pytest.mark.parametrize("services,n_pad,e,printed", SHARD_FRONT_BOUNDS)
def test_the_bound_counts_only_the_functions_bytes(services, n_pad, e,
                                                   printed):
    """The rows and weights read, the joined up CSR over the real edges,
    ``a`` and ``h`` written: the fused front's count over the same rows
    and edges less its segment order (``n_pad`` ids, the launch's own
    permutation of its work) and its bad-row count (not written here),
    with the same operations."""
    n_bytes, n_ops = cost.front_shard(n_pad, e)
    fused_bytes, fused_ops = cost.front(n_pad, e)
    assert (n_bytes, n_ops) == (fused_bytes - n_pad * 4 - 4, fused_ops)
    ms, by = cost.bound_ms(n_bytes, n_ops)
    assert by == "bytes"
    assert round(ms, len(printed.split(".")[1])) == float(printed)
    if services == 2047:
        assert len(ref_cascade(2047, n_roots=3, seed=0).dep_src) == e


# -- the wrapper's contract ----------------------------------------------------------

@pytest.mark.parametrize("bad", ["mixed_devices", "unequal", "too_many",
                                 "strided", "dtype", "host_layout",
                                 "layout_size", "segs", "weights"])
def test_the_wrapper_checks_its_inputs(bad, weights):
    n, src, dst = GRAPHS["hub_128"]()
    sp = 4
    graph = shard_graph(n, src, dst, sp, n_pad_to=n + 1)
    (plan,) = shard_plans(_mesh(1, sp), graph, "kernels")
    grid = _grid(graph).to(CPU)
    aw, hw = weights
    f_blks = _blocks(_features(graph.n_pad, 3, seed=1), sp, graph.block)
    segs = plan.up
    if bad == "mixed_devices":
        f_blks[2] = torch.empty(f_blks[2].shape, device="meta")
    elif bad == "unequal":
        f_blks[1] = f_blks[1][:, :-1].contiguous()
    elif bad == "too_many":
        f_blks = [f_blks[0]] * (MAX_FRONT_SHARDS + 1)
        segs = [segs[0]] * (MAX_FRONT_SHARDS + 1)
    elif bad == "strided":
        f_blks[0] = f_blks[0].transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "dtype":
        f_blks = [f.double() for f in f_blks]
    elif bad == "host_layout":
        grid = _grid(graph)
    elif bad == "layout_size":
        other = shard_graph(n, src, dst, sp, n_pad_to=2 * n)
        grid = _grid(other).to(CPU)
    elif bad == "segs":
        segs = segs[:-1]
    elif bad == "weights":
        aw = aw[:-1]
    with pytest.raises((TypeError, ValueError)):
        evidence_front_shard(f_blks, aw, hw, 0.7, segs, grid)


# -- the engine in the shard_grid form -------------------------------------------------

@pytest.mark.parametrize("contrast", ["packaged", "none"])
@pytest.mark.parametrize("dp,sp", [(1, 8), (2, 4), (4, 2)])
def test_shard_grid_front_is_the_step_form_and_the_reference(dp, sp,
                                                             contrast, env,
                                                             ref_params):
    if len(jax.devices()) < 8:
        pytest.skip("the reference needs 8 devices")
    ref = (ref_params if contrast == "packaged"
           else dataclasses.replace(ref_params, error_contrast=0.0))
    case = ref_cascade(500, n_roots=2, seed=6)
    buckets = RCAConfig().shape_buckets
    kw = dict(n_pad_to=bucket_for(case.n + 1, buckets),
              e_pad_fn=lambda e: bucket_for(e, buckets))
    graph = shard_graph(case.n, case.dep_src, case.dep_dst, sp, **kw)
    fb = _batch(case, graph.n_pad, 8, seed=dp * 100 + sp)
    params = _port_params(ref)
    step = sharded_propagate_full(_mesh(dp, sp), fb, graph, params,
                                  "kernels")
    _as_shard_grid(env)
    mesh = _mesh(dp, sp)
    stacks = sharded.stage_sharded(mesh, fb, graph, params, "kernels")()
    for row in stacks:
        # the per-shard stacks are views of one joined stack
        assert len({s.untyped_storage().data_ptr() for s in row}) == 1
    got = sharded_propagate_full(mesh, fb, graph, params, "kernels")
    assert torch.equal(_bits(got), _bits(step))
    want = np.asarray(ref_full(
        ref_make_mesh([("dp", dp), ("sp", sp)]), fb,
        ref_shard_graph(case.n, case.dep_src, case.dep_dst, sp, **kw), ref))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_shard_grid_streaming_is_the_step_form(env):
    """A sharded streaming session's ticks in the ``shard_grid`` form (the
    front over the resident buffers' views) bitwise the ``step`` form's."""
    from rca_tpu_torch.engine import ShardedGraphEngine

    env.setenv("RCA_KERNEL", "kernels")
    case = ref_cascade(300, n_roots=2, seed=2)
    names = [f"svc-{i}" for i in range(case.n)]
    feats = case.features.copy()
    feats[[4, 40]] = np.nan

    def run():
        s = ShardedStreamingSession(
            names, case.dep_src, case.dep_dst, C,
            engine=ShardedGraphEngine(mesh=_mesh(1, 4)), k=5)
        s.set_all(feats)
        out = []
        for t in range(4):
            idx = rng.choice(case.n, 6, replace=False)
            rows = rng.uniform(0, 1, (6, C)).astype(np.float32)
            rows[0, 2] = np.inf if t == 1 else rows[0, 2]
            s.update_rows(idx, rows)
            out.append(s.tick())
        return out

    rng = np.random.default_rng(3)
    want = run()
    _as_shard_grid(env)
    rng = np.random.default_rng(3)
    got = run()
    for g, w in zip(got, want):
        assert [r["component"] for r in g["ranked"]] == \
            [r["component"] for r in w["ranked"]]
        assert np.array_equal(
            np.asarray([r["score"] for r in g["ranked"]], np.float32).view(
                np.int32),
            np.asarray([r["score"] for r in w["ranked"]], np.float32).view(
                np.int32))
        assert g["sanitized_rows"] == w["sanitized_rows"]


# -- on the card ------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the sharded front runs only on the "
                    "card (python3 chip_smoke.py runs it there)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("sp", SPS)
@pytest.mark.parametrize("name", sorted(FRONT_GRAPHS))
def test_shard_front_kernel_is_the_composition_on_card(name, sp,
                                                       cuda_device, weights):
    from rca_tpu_torch.engine.evidence import (
        evidence_front_rows,
        seg_contrast_step_shard,
    )
    from rca_tpu_torch.kernels import SHARD_LAUNCHES

    n, src, dst = FRONT_GRAPHS[name]()
    graph = shard_graph(n, src, dst, sp, n_pad_to=n + 1)
    (plan,) = shard_plans(_mesh(1, sp, [cuda_device] * sp), graph, "kernels")
    assert plan.steps_form == "shard_grid"
    aw, hw = (w.to(cuda_device) for w in weights)
    for lanes in LANES:
        f_blks = [b.to(cuda_device) for b in _blocks(
            _features(graph.n_pad, lanes, seed=sp), sp, graph.block)]
        for weight in (0.0, 0.7):
            before = SHARD_LAUNCHES["evidence_front_shard"]
            k1 = evidence_front_shard(f_blks, aw, hw, weight, plan.up,
                                      plan.grid)
            k2 = evidence_front_shard(f_blks, aw, hw, weight, plan.up,
                                      plan.grid)
            assert SHARD_LAUNCHES["evidence_front_shard"] == before + 2
            composed = evidence_front_shard_plain(
                f_blks, aw, hw, weight, plan.up, rows=evidence_front_rows,
                contrast=seg_contrast_step_shard)
            plain = evidence_front_shard_plain(f_blks, aw, hw, weight,
                                               plan.up)
            torch.cuda.synchronize()
            for got, again, want, ref in zip(k1, k2, composed, plain):
                assert torch.equal(_bits(got), _bits(again))
                assert torch.equal(_bits(got), _bits(want))
                assert torch.equal(_bits(got), _bits(ref))
