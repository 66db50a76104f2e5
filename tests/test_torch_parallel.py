"""The port's node-sharded engine against the JAX package's, and against
the port's dense engine.

The reference runs sharded on the test session's 8 virtual CPU devices;
the port runs on logical CPU shards, a mesh whose device list repeats the
CPU.  The contract:

- ``shard_graph`` and the ten per-shard layout fields are byte-equal to
  the reference's for sp in 1, 2, 4, 8; the CSR fields cover each
  segment's REAL edges only (a shard's padding lands in no node, also
  where the shard's last node has edges);
- ``parse_shard_spec``, ``ShardConfigError`` and ``make_engine`` behave as
  the reference's;
- ``sharded_propagate_full`` is allclose (rtol 1e-5 / atol 1e-6) to the
  reference's for (dp, sp) in (1, 8), (2, 4), (4, 2), (8, 1), the
  reference under ``RCA_SEGSCAN=0`` and ``=1`` (its Pallas scans in
  interpret mode); ``a``, ``h`` (through ``u``) and ``u`` are bitwise the
  port's dense engine and two runs are bitwise equal;
- ``sharded_topk`` gives the dense top-k's indices, ties included;
- ``ShardedGraphEngine`` matches the reference's at 50 and 2047 services
  (scores allclose, top-k identical, ``sanitized_rows`` identical) with
  NaN/Inf rows, restaged and resident (resident bitwise restaged), and so
  does ``analyze_batch``;
- the per-shard kernel entries hold to their plain versions on the card
  (marker ``cuda``; they skip here).
"""

import json

import numpy as np
import pytest
import torch

import jax

from rca_tpu.cluster.generator import synthetic_cascade_arrays as ref_cascade
from rca_tpu.engine.sharded_runner import ShardedGraphEngine as RefSharded
from rca_tpu.engine.sharded_runner import parse_shard_spec as ref_parse
from rca_tpu.engine.train import packaged_params as ref_packaged_params
from rca_tpu.parallel.mesh import make_mesh as ref_make_mesh
from rca_tpu.parallel.sharded import build_sharded_seg_layouts as ref_layouts
from rca_tpu.parallel.sharded import shard_graph as ref_shard_graph
from rca_tpu.parallel.sharded import sharded_propagate_full as ref_full
from rca_tpu.parallel.sharded import sharded_topk as ref_sharded_topk
from rca_tpu_torch import GraphEngine, params_from_jax
from rca_tpu_torch.config import RCAConfig, bucket_for
from rca_tpu_torch.engine import (
    ShardConfigError,
    ShardedGraphEngine,
    make_engine,
)
from rca_tpu_torch.engine.evidence import (
    seg_contrast_step_shard,
    seg_contrast_step_shard_plain,
)
from rca_tpu_torch.engine.registry import reset_registry
from rca_tpu_torch.engine.runner import top_k
from rca_tpu_torch.engine.segscan import (
    down_seg_step_shard,
    down_seg_step_shard_plain,
    up_seg_step_shard,
    up_seg_step_shard_plain,
)
from rca_tpu_torch.engine.sharded_runner import parse_shard_spec
from rca_tpu_torch.parallel.collectives import (
    COLLECTIVE_BYTES,
    COLLECTIVE_CALLS,
    all_gather,
    psum_scatter,
    reset_collectives,
)
from rca_tpu_torch.parallel.mesh import make_mesh
from rca_tpu_torch.parallel.sharded import (
    ShardedSegLayouts,
    build_sharded_seg_layouts,
    shard_graph,
    shard_plans,
    sharded_propagate_full,
    sharded_topk,
)

C = 13
CPU = torch.device("cpu")


def _mesh(dp, sp):
    return make_mesh([("dp", dp), ("sp", sp)], [CPU] * (dp * sp))


@pytest.fixture(scope="module")
def ref_params():
    return ref_packaged_params()


def _port_params(ref):
    aw, hw = ref.weight_arrays()
    return params_from_jax(np.array(aw), np.array(hw), ref.steps, ref.decay,
                           ref.explain_strength, ref.impact_bonus,
                           ref.error_contrast)


@pytest.fixture
def env(monkeypatch):
    for name in ("RCA_SHARD", "RCA_KERNEL", "RCA_SEGSCAN", "RCA_RESIDENT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("RCA_KERNEL_CACHE", "off")
    reset_registry()
    yield monkeypatch
    reset_registry()


def _hub_graph():
    """64 services whose shard boundaries cut hubs at sp 2, 4 and 8
    (blocks of 32, 16, 8): node 7, the last of shard 0 at sp = 8, has 30
    dependencies and 20 dependents spread over every shard, node 31 has
    25 dependencies, and every node 8j + 7 (each shard's last node at
    every sp) has dependencies of its own."""
    rng = np.random.default_rng(11)
    lasts = np.repeat(np.arange(7, 64, 8), 3)
    src = [rng.integers(0, 64, 40), np.full(30, 7), np.full(25, 31), lasts]
    dst = [rng.integers(0, 64, 40), rng.integers(0, 64, 30),
           rng.integers(0, 64, 25), rng.integers(0, 64, len(lasts))]
    src += [rng.integers(0, 64, 20)]
    dst += [np.full(20, 7)]
    src, dst = np.concatenate(src), np.concatenate(dst)
    keep = src != dst
    return 64, src[keep].astype(np.int32), dst[keep].astype(np.int32)


def _graphs():
    case = ref_cascade(300, n_roots=2, seed=5, mode="adversarial",
                       fault_mix="mixed")
    return {"cascade_300": (case.n, case.dep_src, case.dep_dst),
            "hubs_64": _hub_graph()}


# -- the partition and the layouts ---------------------------------------------

@pytest.mark.parametrize("sp", [1, 2, 4, 8])
@pytest.mark.parametrize("graph", ["cascade_300", "hubs_64"])
def test_shard_graph_and_layouts_are_the_reference_bytes(graph, sp):
    n, src, dst = _graphs()[graph]
    buckets = RCAConfig().shape_buckets
    kw = dict(n_pad_to=bucket_for(n + 1, buckets),
              e_pad_fn=lambda e: bucket_for(e, buckets))
    port = shard_graph(n, src, dst, sp, **kw)
    ref = ref_shard_graph(n, src, dst, sp, **kw)
    for field in ("n_pad", "n", "block", "sp"):
        assert getattr(port, field) == getattr(ref, field), field
    for field in ("src_local", "src_global", "dst_global", "mask"):
        want, got = getattr(ref, field), getattr(port, field)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    lay, ref_lay = build_sharded_seg_layouts(port), ref_layouts(ref)
    for field in ref_lay._fields:
        want, got = getattr(ref_lay, field), getattr(lay, field)
        assert got.dtype == want.dtype, field
        assert got.shape == want.shape and got.tobytes() == want.tobytes()
    assert ShardedSegLayouts._fields[:10] == ref_lay._fields


@pytest.mark.parametrize("sp", [2, 4, 8])
def test_csr_fields_hold_each_shards_real_edges_only(sp):
    """Walking the CSR fields as the kernels do reaches exactly each
    segment's real edges: the padding of every shard (which sorts into
    its last segment, a real node for every shard but the last) is past
    the last offset.  The hub graph puts edges on a shard's last node."""
    n, src, dst = _hub_graph()
    # padded rows in every shard, the fullest one too
    g = shard_graph(n, src, dst, sp, n_pad_to=64, e_pad_fn=lambda e: e + 5)
    lay = build_sharded_seg_layouts(g)
    for k in range(sp):
        real = g.mask[k] > 0
        for d, seg_of, other_of, n_seg in (
                ("dn", g.dst_global[k], g.src_global[k], g.n_pad),
                ("up", g.src_local[k], g.dst_global[k], g.block)):
            offsets = getattr(lay, f"{d}_offsets")[k]
            other = getattr(lay, f"{d}_other")[k]
            order = getattr(lay, f"{d}_seg_order")[k]
            n_long = int(getattr(lay, f"{d}_n_long")[k])
            assert offsets[-1] == real.sum()
            assert sorted(order.tolist()) == list(range(n_seg))
            for s in range(n_seg):
                got = sorted(other[offsets[s]:offsets[s + 1]].tolist())
                want = sorted(other_of[real & (seg_of == s)].tolist())
                assert got == want, (d, k, s)
                long = offsets[s + 1] - offsets[s] > 16
                assert (s in order[:n_long]) == long
        # this shard's last node has edges of its own, and the shard's
        # padding sorts into that node's segment
        assert np.any(real & (g.src_local[k] == g.block - 1))
        assert not real.all()


# -- the rule table --------------------------------------------------------------

_REF_NAMES = ("features_batch", "src_local", "dst_global", "mask", "dn_other",
              "up_has", "n_live", "aw", "delta_rows", "stack", "scores",
              "topk_idx")


@pytest.mark.parametrize("name", _REF_NAMES)
def test_rule_table_places_names_as_the_reference(name):
    from rca_tpu.parallel.rules import GRAPH_RULES as REF_RULES
    from rca_tpu_torch.parallel.rules import GRAPH_RULES

    assert GRAPH_RULES.spec_for(name) == tuple(REF_RULES.spec_for(name))


def test_rule_table_fails_loudly_and_stages_each_piece():
    from rca_tpu_torch.parallel.rules import (
        GRAPH_RULES,
        make_shard_fns,
        match_partition_rules,
    )

    with pytest.raises(ValueError, match="no partition rule"):
        GRAPH_RULES.spec_for("mystery")
    mesh = _mesh(2, 4)
    rng = np.random.default_rng(0)
    arrays = {"features_batch": rng.uniform(0, 1, (6, 64, C)).astype(
                  np.float32),
              "src_local": rng.integers(0, 16, (4, 32)).astype(np.int32),
              "aw": rng.uniform(0, 1, C).astype(np.float32)}
    # each device's piece, by hand: lanes over dp, nodes / edge rows over
    # sp, weights whole
    want = {"features_batch": lambda g, k: arrays["features_batch"][
                3 * g:3 * (g + 1), 16 * k:16 * (k + 1)],
            "src_local": lambda g, k: arrays["src_local"][k:k + 1],
            "aw": lambda g, k: arrays["aw"]}
    shard_fns = make_shard_fns(match_partition_rules(GRAPH_RULES, arrays),
                               mesh)
    for name, arr in arrays.items():
        grid = shard_fns[name](arr)
        assert len(grid) == 2 and all(len(row) == 4 for row in grid)
        for g in range(2):
            for k in range(4):
                assert np.array_equal(grid[g][k].numpy(), want[name](g, k))
    with pytest.raises(ValueError, match="does not split"):
        shard_fns["src_local"](np.zeros((3, 8), np.int32))


# -- the shard spec and engine selection ---------------------------------------

@pytest.mark.parametrize("spec,n_dev", [
    ("", 8), ("auto", 8), ("1", 3), ("on", 2), ("sp=4,dp=2", 8),
    ("dp=2", 8), ("sp=3", 8), ("SP=2, dp=1", 4), ("dp=4", 2),
])
def test_parse_shard_spec_matches_reference(spec, n_dev):
    assert parse_shard_spec(spec, n_dev) == ref_parse(spec, n_dev)


@pytest.mark.parametrize("bad", ["sp=0", "dp=0,sp=4", "sp=-1", "sp=banana",
                                 "tp=2", "sp=²"])
def test_bad_shard_specs_fail_as_the_reference(bad):
    with pytest.raises(ShardConfigError) as port:
        parse_shard_spec(bad, 8)
    with pytest.raises(ValueError) as ref:
        ref_parse(bad, 8)
    assert str(port.value) == str(ref.value)


def test_make_engine_selection(env):
    """RCA_SHARD drives the choice at call time; on the CPU one device is
    visible, so only a one-shard layout fits."""
    assert type(make_engine(device="cpu")) is GraphEngine
    env.setenv("RCA_SHARD", "off")
    assert type(make_engine(device="cpu")) is GraphEngine
    for spec in ("auto", "sp=1", "1"):
        env.setenv("RCA_SHARD", spec)
        e = make_engine(device="cpu")
        assert isinstance(e, ShardedGraphEngine)
        assert (e.dp, e.sp, e.engine_tag) == (1, 1, "sharded(dp=1,sp=1)")
    env.setenv("RCA_SHARD", "sp=4")
    with pytest.raises(ShardConfigError,
                       match=r"RCA_SHARD wants 4 devices \(sp=4,dp=1\), "
                             r"have 1"):
        make_engine(device="cpu")
    env.setenv("RCA_SHARD", "sp=banana")
    with pytest.raises(ShardConfigError, match="RCA_SHARD"):
        make_engine(device="cpu")
    env.delenv("RCA_SHARD")
    # an explicit mesh repeats a device: logical shards
    e = ShardedGraphEngine(mesh=_mesh(2, 4))
    assert (e.dp, e.sp, e.engine_tag) == (2, 4, "sharded(dp=2,sp=4)")
    assert e._exec_mesh.shape == {"dp": 1, "sp": 4}
    assert e.device == CPU


def test_misconfigured_shard_is_loud_in_the_correlation_path(env):
    from rca_tpu_torch.agents import AnalysisContext
    from rca_tpu_torch.cluster.fixtures import NS, five_service_world
    from rca_tpu_torch.cluster.mock_client import MockClusterClient
    from rca_tpu_torch.cluster.snapshot import ClusterSnapshot
    from rca_tpu_torch.coordinator import RCACoordinator, correlate_findings

    env.setenv("RCA_SHARD", "sp=64")
    client = MockClusterClient(five_service_world())
    ctx = AnalysisContext(ClusterSnapshot.capture(client, NS), device="cpu")
    with pytest.raises(ShardConfigError, match="devices"):
        correlate_findings({}, ctx=ctx, backend="torch")
    with pytest.raises(ShardConfigError, match="devices"):
        RCACoordinator(client, backend="torch", device="cpu")
    # the deterministic backend builds no engine
    RCACoordinator(client, backend="deterministic", device="cpu")


def test_sharded_engine_without_a_card_raises(env):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedGraphEngine()
    env.setenv("RCA_SHARD", "sp=2")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_engine()


# -- the propagation against the reference's -----------------------------------

def _batch(case, n_pad, lanes, seed):
    rng = np.random.default_rng(seed)
    fb = np.zeros((lanes, n_pad, C), np.float32)
    fb[:, :case.n] = case.features
    for b in range(1, lanes):
        rows = rng.integers(0, case.n, 6)
        fb[b, rows] = rng.uniform(0, 1, (6, C))
    return fb


@pytest.mark.parametrize("segscan", ["0", "1"])
@pytest.mark.parametrize("dp,sp", [(1, 8), (2, 4), (4, 2), (8, 1)])
def test_sharded_propagate_full_matches_reference(dp, sp, segscan, env,
                                                  ref_params):
    if len(jax.devices()) < 8:
        pytest.skip("the reference needs 8 devices")
    env.setenv("RCA_SEGSCAN", segscan)
    case = ref_cascade(500, n_roots=2, seed=3)
    buckets = RCAConfig().shape_buckets
    kw = dict(n_pad_to=bucket_for(case.n + 1, buckets),
              e_pad_fn=lambda e: bucket_for(e, buckets))
    graph = shard_graph(case.n, case.dep_src, case.dep_dst, sp, **kw)
    fb = _batch(case, graph.n_pad, 8, seed=dp * 10 + sp)
    ref = np.asarray(ref_full(
        ref_make_mesh([("dp", dp), ("sp", sp)]), fb,
        ref_shard_graph(case.n, case.dep_src, case.dep_dst, sp, **kw),
        ref_params))
    params = _port_params(ref_params)
    port = sharded_propagate_full(_mesh(dp, sp), fb, graph, params).numpy()
    assert port.shape == ref.shape == (8, 4, graph.n_pad)
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-6)
    again = sharded_propagate_full(_mesh(dp, sp), fb, graph, params)
    assert np.array_equal(again.numpy(), port)


@pytest.mark.parametrize("sp", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("kernel", ["torch", "kernels"])
def test_a_and_u_are_bitwise_the_dense_engine(sp, kernel, env, ref_params):
    """``a`` and ``u`` (whose max reads ``h``) bitwise, ``m`` and the score
    within the tolerance: the dense engine and the sharded one on the same
    features, NaN/Inf rows included, under either registry row."""
    env.setenv("RCA_KERNEL", kernel)
    case = ref_cascade(700, n_roots=2, seed=4)
    feats = case.features.copy()
    feats[[3, 90, 400], [2, 12, 0]] = (np.nan, np.inf, -np.inf)
    params = _port_params(ref_params)
    dense = GraphEngine(params=params, device="cpu", resident=False)
    shard = ShardedGraphEngine(params=params, mesh=_mesh(1, sp),
                               resident=False)
    d = dense.analyze_arrays(feats, case.dep_src, case.dep_dst, k=10)
    s = shard.analyze_arrays(feats, case.dep_src, case.dep_dst, k=10)
    ds, ss = d.full_diagnostics(), s.full_diagnostics()
    n = case.n
    assert np.array_equal(ss[0][:n], ds[0][:n]), "a"
    assert np.array_equal(ss[1][:n], ds[1][:n]), "u"
    np.testing.assert_allclose(ss[2][:n], ds[2][:n], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ss[3][:n], ds[3][:n], rtol=1e-5, atol=1e-6)
    assert s.top_components() == d.top_components()
    assert s.sanitized_rows == d.sanitized_rows == 3
    assert s.engine == f"sharded(dp=1,sp={sp})" and d.engine == "single"


def test_collective_bytes_are_the_round5_budget(env, ref_params):
    """Per analysis in the ``step`` form (the plan's form off the card and
    over distinct cards): 19 all-gathers (e, h, a, 8 up, 8 down) and 9
    reduce-scatters (the degree, 8 down), each moving ``(sp - 1) * block
    * 4`` bytes through every shard.  (The ``shard_grid`` form's, logical
    shards of one card, is test_torch_shard_steps.py::
    test_shard_grid_moves_only_the_one_time_collectives.)"""
    case = ref_cascade(2047, n_roots=3, seed=0)
    sp = 8
    eng = ShardedGraphEngine(params=_port_params(ref_params),
                             mesh=_mesh(1, sp), resident=False)
    graph = eng._shard(case.n, case.dep_src, case.dep_dst)
    (plan,) = shard_plans(_mesh(1, sp), graph, "kernels")
    assert plan.steps_form == "step"
    reset_collectives()
    eng.analyze_case(case)
    per_shard = (sp - 1) * graph.block * 4
    assert COLLECTIVE_CALLS["all_gather"] == 19
    assert COLLECTIVE_CALLS["reduce_scatter"] == 9
    assert COLLECTIVE_BYTES["all_gather"] == 19 * sp * per_shard
    assert COLLECTIVE_BYTES["reduce_scatter"] == 9 * sp * per_shard
    assert COLLECTIVE_CALLS["topk_gather"] == 3


# -- top-k ----------------------------------------------------------------------

@pytest.mark.parametrize("sp", [2, 4, 8])
def test_collectives_share_a_device_and_keep_the_bits(sp):
    """Shards on one device share one concatenation; a reduce-scatter
    summed once over one device's span is bitwise the same placement
    summed shard by shard (here: two keys for the one CPU, alternating, so
    every shard is a run of its own) and the fixed-order sum by hand."""
    rng = np.random.default_rng(sp)
    block = 96

    def vec(shape):
        return torch.from_numpy((rng.uniform(-1, 1, shape)
                                 * 10.0 ** rng.uniform(-4, 4, shape))
                                .astype(np.float32))

    blocks = [vec((2, block)) for _ in range(sp)]
    fulls = [vec((2, sp * block)) for _ in range(sp)]
    one = [torch.device("cpu")] * sp
    apart = [torch.device("cpu") if k % 2 == 0 else "cpu" for k in range(sp)]
    gathered = all_gather(blocks, one)
    assert all(g is gathered[0] for g in gathered)
    assert torch.equal(gathered[0], torch.cat(blocks, dim=-1))
    spread = all_gather(blocks, apart)
    assert spread[0] is not spread[1]
    assert all(torch.equal(g, gathered[0]) for g in spread)
    joined, split = psum_scatter(fulls, one), psum_scatter(fulls, apart)
    for k in range(sp):
        want = fulls[0][..., k * block:(k + 1) * block].clone()
        for f in fulls[1:]:
            want += f[..., k * block:(k + 1) * block]
        assert torch.equal(joined[k], want) and torch.equal(split[k], want)


@pytest.mark.parametrize("sp,k", [(2, 5), (4, 12), (8, 16), (8, 40)])
def test_sharded_topk_breaks_ties_lowest_index_first(sp, k):
    """Ties within a shard, across shard boundaries and past a shard's
    local k: the merged indices are the dense top-k's and the
    reference's."""
    n_pad = 64
    score = np.zeros(n_pad, np.float32)
    score[[1, 5, 6, 9, 17, 30, 31, 32, 33, 47, 60, 63]] = 0.7
    score[[2, 8, 40]] = 0.9
    score[[10, 11, 12, 13, 14, 15]] = 0.5
    block = n_pad // sp
    blocks = [torch.from_numpy(score[i * block:(i + 1) * block])
              for i in range(sp)]
    vals, idx = sharded_topk(_mesh(1, sp), blocks, k)
    dense_vals, dense_idx = top_k(torch.from_numpy(score), k)
    assert idx.tolist() == dense_idx.tolist()
    assert np.array_equal(vals.numpy(), dense_vals.numpy())
    if len(jax.devices()) >= sp:
        mesh = ref_make_mesh([("dp", 1), ("sp", sp)], jax.devices()[:sp])
        _, ref_idx = ref_sharded_topk(mesh, jax.numpy.asarray(score[None]), k)
        assert idx.tolist() == np.asarray(ref_idx)[0].tolist()


def test_sharded_topk_rejects_k_past_the_vector():
    blocks = [torch.zeros(4) for _ in range(2)]
    with pytest.raises(ValueError, match="exceeds the sharded vector"):
        sharded_topk(_mesh(1, 2), blocks, 9)


# -- the engine against the reference's ----------------------------------------

def _case(n, poison):
    case = ref_cascade(n, n_roots=max(1, min(3, n // 500)), seed=2)
    feats = case.features.copy()
    if poison:
        feats[[1, 17, 40], [0, 5, 12]] = (np.nan, np.inf, -np.inf)
    return case, feats


def _assert_close(port, ref):
    assert port.top_components() == ref.top_components()
    assert port.sanitized_rows == ref.sanitized_rows
    np.testing.assert_allclose(port.score, ref.score, rtol=1e-5, atol=1e-6)
    for p, r in zip(port.ranked, ref.ranked):
        for key in ("score", "anomaly", "explained_by_upstream",
                    "downstream_impact"):
            assert p[key] == pytest.approx(r[key], rel=1e-5, abs=1e-6)


@pytest.mark.parametrize("poison", [False, True])
@pytest.mark.parametrize("n", [50, 2047])
def test_engine_matches_reference_restaged_and_resident(n, poison, env,
                                                        ref_params):
    if len(jax.devices()) < 8:
        pytest.skip("the reference needs 8 devices")
    case, feats = _case(n, poison)
    ref = RefSharded(params=ref_params, spec="sp=8", resident=False)
    want = ref.analyze_arrays(feats, case.dep_src, case.dep_dst, case.names)
    assert want.engine == "sharded(dp=1,sp=8)"
    params = _port_params(ref_params)
    restaged = ShardedGraphEngine(params=params, mesh=_mesh(1, 8),
                                  resident=False)
    resident = ShardedGraphEngine(params=params, mesh=_mesh(1, 8))
    got = restaged.analyze_arrays(feats, case.dep_src, case.dep_dst,
                                  case.names)
    _assert_close(got, want)
    assert got.engine == want.engine
    assert got.sanitized_rows == (3 if poison else 0)
    # the resident path: first, identical, then an 8-row delta request
    rng = np.random.default_rng(n)
    changed = feats.copy()
    rows = rng.choice(n, size=min(8, n // 4), replace=False)
    changed[rows] = rng.uniform(0, 1, (len(rows), C))
    changed[rows[0], 3] = np.nan
    for step in (feats, feats, changed):
        a = resident.analyze_arrays(step, case.dep_src, case.dep_dst,
                                    case.names)
        b = restaged.analyze_arrays(step, case.dep_src, case.dep_dst,
                                    case.names)
        assert np.array_equal(a.full_diagnostics(), b.full_diagnostics())
        assert a.ranked == b.ranked
        assert a.sanitized_rows == b.sanitized_rows
    _assert_close(a, ref.analyze_arrays(changed, case.dep_src, case.dep_dst,
                                        case.names))
    stats = resident._resident_cache.stats()
    assert (stats["requests"], stats["delta_requests"]) == (3, 2)
    # the reference's formula: the padded matrix, then per delta its rows
    # padded to a power of two (a NaN row never equals its mirror)
    graph = resident._shard(n, case.dep_src, case.dep_dst)
    want_bytes = graph.n_pad * C * 4
    for prev, step in ((feats, feats), (feats, changed)):
        u = int(np.any(step != prev, axis=1).sum())
        if u:
            u_pad = 1 << (u - 1).bit_length()
            want_bytes += u_pad * 4 + u_pad * C * 4
    assert stats["upload_bytes"] == want_bytes
    assert stats["fetch_bytes"] == 3 * (4 * 13 * 4 + 13 * 4 + 13 * 4)


def test_resident_request_that_raises_restages_next(env, ref_params):
    case, feats = _case(300, False)
    eng = ShardedGraphEngine(params=_port_params(ref_params),
                             mesh=_mesh(1, 4))
    eng.analyze_arrays(feats, case.dep_src, case.dep_dst)
    (sess,) = eng._resident_cache._sessions.values()
    assert sess._mirror is not None
    bad = feats.copy()
    bad[5] += 0.25
    env.setenv("RCA_KERNEL", "bogus")
    with pytest.raises(ValueError, match="RCA_KERNEL"):
        eng.analyze_arrays(bad, case.dep_src, case.dep_dst)
    assert sess._mirror is None
    env.delenv("RCA_KERNEL")
    a = eng.analyze_arrays(bad, case.dep_src, case.dep_dst)
    b = ShardedGraphEngine(params=_port_params(ref_params), mesh=_mesh(1, 4),
                           resident=False).analyze_arrays(
        bad, case.dep_src, case.dep_dst)
    assert np.array_equal(a.full_diagnostics(), b.full_diagnostics())
    assert sess.last_upload_rows == sess._n_pad


def test_analyze_batch_matches_reference_and_dense(env, ref_params):
    if len(jax.devices()) < 8:
        pytest.skip("the reference needs 8 devices")
    case, feats = _case(2047, True)
    rng = np.random.default_rng(1)
    batch = np.repeat(feats[None], 6, axis=0)
    for b in range(1, 6):
        batch[b, rng.integers(0, case.n, 10)] = 0.0
    ref = RefSharded(params=ref_params, spec="sp=4,dp=2", resident=False)
    want = ref.analyze_batch(batch, case.dep_src, case.dep_dst, case.names)
    params = _port_params(ref_params)
    got = ShardedGraphEngine(params=params, mesh=_mesh(2, 4)).analyze_batch(
        batch, case.dep_src, case.dep_dst, case.names)
    dense = GraphEngine(params=params, device="cpu").analyze_batch(
        batch, case.dep_src, case.dep_dst, case.names)
    assert len(got) == len(want) == 6
    for g, w, d in zip(got, want, dense):
        _assert_close(g, w)
        assert g.engine == w.engine == "sharded(dp=2,sp=4)-batch"
        assert g.top_components() == d.top_components()
        assert np.array_equal(g.upstream, d.upstream)
        np.testing.assert_allclose(g.score, d.score, rtol=1e-5, atol=1e-6)
    # a lane of the batch is its solo sharded analysis
    solo = ShardedGraphEngine(params=params, mesh=_mesh(1, 4),
                              resident=False).analyze_arrays(
        batch[3], case.dep_src, case.dep_dst, case.names)
    assert np.array_equal(got[3].full_diagnostics(),
                          solo.full_diagnostics())


def test_registry_sharded_row(env):
    from rca_tpu_torch.engine.registry import engaged_kernel, kernel_table

    assert engaged_kernel(2048, 512, variant="sharded", device="cpu") == \
        "torch"
    env.setenv("RCA_KERNEL", "kernels")
    assert engaged_kernel(2048, 512, variant="sharded", device="cpu") == \
        "kernels"
    rows = [r for r in kernel_table() if r["variant"] == "sharded"]
    assert {(r["winner"], r["source"]) for r in rows} == {
        ("torch", "cpu-default"), ("kernels", "forced")}


def test_kernels_cli_shows_the_sharded_row(env, capsys):
    from rca_tpu_torch.cli import main

    assert main(["kernels", "--services", "2047", "--sp", "4", "--json",
                 "--device", "cpu"]) == 0
    rows = json.loads(capsys.readouterr().out)["rows"]
    sharded = [r for r in rows if r["variant"] == "sharded"]
    assert [(r["n_pad"], r["winner"]) for r in sharded] == [(2048, "torch")]


# -- the per-shard kernel entries: plain versions here, kernels on the card ----

def _shard_inputs(sp=4, lanes=None, seed=0):
    n, src, dst = _hub_graph()
    g = shard_graph(n, src, dst, sp, n_pad_to=64)
    (plan,) = shard_plans(_mesh(1, sp), g, "kernels")
    rng = np.random.default_rng(seed)
    shape = (g.n_pad,) if lanes is None else (lanes, g.n_pad)

    def vec(*s):
        return torch.from_numpy(rng.uniform(0, 1, s).astype(np.float32))

    return g, plan, vec, shape


def test_shard_step_plain_versions_match_a_scatter_over_real_edges():
    """Each per-shard plain version against a direct scatter over the
    shard's real edges (the reference's scatter body), for every shard of
    the hub graph."""
    g, plan, vec, shape = _shard_inputs()
    u, h, m, a_ex, e = (vec(*shape) for _ in range(5))
    decay, weight = 0.7, 0.6
    for k in range(g.sp):
        real = g.mask[k] > 0
        s_loc = torch.from_numpy(g.src_local[k][real].astype(np.int64))
        s_glb = torch.from_numpy(g.src_global[k][real].astype(np.int64))
        d_glb = torch.from_numpy(g.dst_global[k][real].astype(np.int64))
        base = k * g.block
        w = torch.maximum(h, decay * u)
        upd = torch.zeros(g.block).scatter_reduce(0, s_loc, w[d_glb], "amax")
        want_u = torch.maximum(u[base:base + g.block], upd)
        got_u = up_seg_step_shard_plain(u, h, decay, plan.up[k], base)
        assert torch.equal(got_u, want_u)
        want_c = torch.zeros(g.n_pad).index_add_(0, d_glb,
                                                 a_ex[s_glb] + decay * m[s_glb])
        got_c = down_seg_step_shard_plain(m, a_ex, decay, plan.dn[k])
        torch.testing.assert_close(got_c, want_c, rtol=1e-5, atol=1e-6)
        a_raw = vec(g.block)
        dep = torch.zeros(g.block).scatter_reduce(0, s_loc, e[d_glb], "amax")
        excess = torch.clamp(e[base:base + g.block] - dep, min=0.0)
        want_a = 1.0 - (1.0 - a_raw) * (1.0 - weight * excess)
        got_a = seg_contrast_step_shard_plain(a_raw, e, weight, plan.up[k],
                                              base)
        assert torch.equal(got_a, want_a)
        # the wrappers compute the plain versions on CPU tensors
        assert torch.equal(up_seg_step_shard(u, h, decay, plan.up[k], base),
                           got_u)
        assert torch.equal(down_seg_step_shard(m, a_ex, decay, plan.dn[k]),
                           got_c)
        assert torch.equal(seg_contrast_step_shard(a_raw, e, weight,
                                                   plan.up[k], base), got_a)


def test_shard_step_lanes_are_solo_steps():
    g, plan, vec, shape = _shard_inputs(lanes=3)
    u, h, m, a_ex = (vec(*shape) for _ in range(4))
    for k in range(g.sp):
        base = k * g.block
        lanes = up_seg_step_shard(u, h, 0.7, plan.up[k], base)
        for b in range(3):
            assert torch.equal(lanes[b], up_seg_step_shard(
                u[b].contiguous(), h[b].contiguous(), 0.7, plan.up[k], base))
        lanes = down_seg_step_shard(m, a_ex, 0.7, plan.dn[k])
        for b in range(3):
            assert torch.equal(lanes[b], down_seg_step_shard(
                m[b].contiguous(), a_ex[b].contiguous(), 0.7, plan.dn[k]))


@pytest.mark.parametrize("bad", ["dtype", "shape", "base", "out_is_input",
                                 "down_layout"])
def test_shard_step_contract_is_checked(bad):
    g, plan, vec, shape = _shard_inputs()
    u, h = vec(*shape), vec(*shape)
    seg, base, out = plan.up[1], g.block, None
    if bad == "dtype":
        u = u.double()
    elif bad == "shape":
        h = h[:-1]
    elif bad == "base":
        base = g.n_pad - g.block + 1
    elif bad == "out_is_input":
        # a step whose output is its own input: only the first shard's
        # block of a full vector could alias, so take a block-long vector
        seg, base = plan.up[0], 0
        u = h = out = vec(g.block)
    elif bad == "down_layout":
        # the up layout has `block` segments, the down step needs n_pad
        with pytest.raises(ValueError, match="vectors must be"):
            down_seg_step_shard(u, h, 0.7, plan.up[1])
        return
    with pytest.raises((TypeError, ValueError)):
        up_seg_step_shard(u, h, 0.7, seg, base, out=out)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the per-shard kernel entries run only "
                    "on the card (python3 chip_smoke.py runs them there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sp", [2, 4, 8])
def test_shard_kernels_match_plain_on_card(sp, cuda_device):
    n, src, dst = _hub_graph()
    g = shard_graph(n, src, dst, sp, n_pad_to=64)
    mesh = make_mesh([("dp", 1), ("sp", sp)], [cuda_device] * sp)
    (plan,) = shard_plans(mesh, g, "kernels")
    rng = np.random.default_rng(sp)

    def vec(*s):
        return torch.from_numpy(rng.uniform(0, 1, s).astype(np.float32)).to(
            cuda_device)

    for shape in ((g.n_pad,), (3, g.n_pad)):
        u, h, m, a_ex, e = (vec(*shape) for _ in range(5))
        for k in range(sp):
            base = k * g.block
            assert torch.equal(
                up_seg_step_shard(u, h, 0.7, plan.up[k], base),
                up_seg_step_shard_plain(u, h, 0.7, plan.up[k], base))
            torch.testing.assert_close(
                down_seg_step_shard(m, a_ex, 0.7, plan.dn[k]),
                down_seg_step_shard_plain(m, a_ex, 0.7, plan.dn[k]),
                rtol=1e-5, atol=1e-6)
            a_raw = vec(*shape[:-1], g.block)
            assert torch.equal(
                seg_contrast_step_shard(a_raw, e, 0.6, plan.up[k], base),
                seg_contrast_step_shard_plain(a_raw, e, 0.6, plan.up[k],
                                              base))


@pytest.mark.cuda
def test_sharded_engine_on_card_matches_dense_on_card(cuda_device):
    case = ref_cascade(2047, n_roots=3, seed=0)
    dense = GraphEngine(resident=False).analyze_case(case)
    shard = ShardedGraphEngine(
        mesh=make_mesh([("dp", 1), ("sp", 4)], [cuda_device] * 4),
        resident=False).analyze_case(case)
    ds, ss = dense.full_diagnostics(), shard.full_diagnostics()
    assert np.array_equal(ss[1][:case.n], ds[1][:case.n])
    np.testing.assert_allclose(ss[3][:case.n], ds[3][:case.n], rtol=1e-5,
                               atol=1e-6)
    assert shard.top_components() == dense.top_components()
