"""The grid recursions of the PyTorch port against the plain recursions and
against the JAX package's.

``up_seg_steps_grid`` / ``down_seg_steps_grid`` run all the steps of the
explain-away and the impact recursion in one cooperative launch over the
card (``rca_tpu_torch/csrc/seggrid.cu``), the form the engine's plan takes
(``steps_form == "grid"``) where a graph does not fit one CTA's shared
memory; on a CPU tensor each computes its plain version, the loop of plain
steps.  These tests hold the CPU path to that loop bitwise and to the
reference's recursions (``rca_tpu/engine/propagate.py``: ``lax.scan`` over
``segscan.up_seg_step`` / ``down_seg_step``, whose Pallas scans run in
interpret mode, as the JAX package's own tests run them on the CPU) on the
same numpy inputs: ``u`` bitwise (a float32 max does not depend on
order), ``m`` at rtol 1e-5 / atol 1e-6 (the sum runs in another order),
and the engine's top-k with its tie order identical.  They also pin the
wrappers' input contract, the layout in the kernel's item order, and the
grid's partition of the work.  The CUDA kernels run only on the card: the
tests marked ``cuda`` hold them bitwise to the per-step launches there and
the plan to its form, and skip elsewhere (``python3 chip_smoke.py`` runs
the same checks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rca_tpu.cluster.generator import synthetic_cascade_arrays as ref_cascade
from rca_tpu.engine import GraphEngine as RefEngine
from rca_tpu.engine import segscan as ref_segscan
from rca_tpu.engine.train import packaged_params as ref_packaged_params
from rca_tpu_torch import params_from_jax
from rca_tpu_torch.cluster.generator import synthetic_cascade_arrays
from rca_tpu_torch.engine import propagate, registry, runner
from rca_tpu_torch.engine import segscan as port_segscan
from rca_tpu_torch.engine.runner import GraphEngine
from rca_tpu_torch.kernels import LAUNCHES

DECAY = 0.6
STEPS = [0, 1, 8, 13]
#: the graph sizes held to the reference (padded as the engine pads them)
SERVICES = [129, 1025, 2047]


def _padded(n):
    """``(n_pad, e_pad, dep_src, dep_dst)`` of the ``n``-service cascade as
    the engine pads it."""
    case = synthetic_cascade_arrays(n, n_roots=2, seed=n)
    f, src, _ = GraphEngine(device="cpu")._pad(case.features, case.dep_src,
                                               case.dep_dst)
    return f.shape[0], len(src), case.dep_src, case.dep_dst


def _layout_specs():
    """(n_pad, e_pad, seg_idx, other_idx) per layout: both directions of
    cascades at each size of ``SERVICES``, a star whose one segment holds
    4096 edges, a graph with no edges (every slot a padding self-loop on
    the dummy) and one of self-loops with duplicate edges."""
    specs = {}
    for n in SERVICES:
        n_pad, e_pad, src, dst = _padded(n)
        specs[f"down_{n}"] = (n_pad, e_pad, dst, src)
        specs[f"up_{n}"] = (n_pad, e_pad, src, dst)
    rng = np.random.default_rng(12)
    loops = np.arange(50, dtype=np.int32)
    specs.update({
        "star_4096": (2048, 4096, np.full(4096, 7, np.int32),
                      rng.integers(0, 2047, 4096).astype(np.int32)),
        "no_edges": (64, 128, np.zeros(0, np.int32), np.zeros(0, np.int32)),
        "self_loops_dups": (
            64, 128,
            np.concatenate([loops, np.full(20, 3), np.full(40, 9)]).astype(
                np.int32),
            np.concatenate([loops, np.full(20, 5),
                            rng.integers(0, 63, 40)]).astype(np.int32)),
    })
    return specs


SPECS = _layout_specs()
LAYOUTS = list(SPECS)


def _layout(name):
    return port_segscan.build_seg_layout(*SPECS[name])


def _vectors(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0.0, 1.0, shape).astype(np.float32)
            for _ in range(2)]


def _inv_deg(n_pad, seed):
    rng = np.random.default_rng(seed)
    return (1.0 / rng.integers(1, 9, n_pad)).astype(np.float32)


# -- the CPU path: the plain recursions ---------------------------------------

@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_grid_steps_on_cpu_are_the_plain_recursions(layout, steps):
    seg = _layout(layout).to("cpu")
    n_pad = seg.offsets.shape[0] - 1
    inv_deg = torch.from_numpy(_inv_deg(n_pad, 3))
    before = dict(LAUNCHES)
    for shape in ((n_pad,), (3, n_pad)):
        h, a_ex = (torch.from_numpy(v) for v in _vectors(shape, steps))
        u = port_segscan.up_seg_steps_grid(h, DECAY, steps, seg)
        m = port_segscan.down_seg_steps_grid(a_ex, DECAY, steps, seg,
                                             inv_deg)
        assert torch.equal(u, port_segscan.up_seg_steps_plain(
            h, DECAY, steps, seg))
        assert torch.equal(m, port_segscan.down_seg_steps_plain(
            a_ex, DECAY, steps, seg, inv_deg))
        if len(shape) == 2:
            # each lane is its own flat recursion
            for b in range(shape[0]):
                assert torch.equal(u[b], port_segscan.up_seg_steps_grid(
                    h[b].contiguous(), DECAY, steps, seg))
                assert torch.equal(m[b], port_segscan.down_seg_steps_grid(
                    a_ex[b].contiguous(), DECAY, steps, seg, inv_deg))
        if steps == 0:
            assert not u.any() and not m.any()
    assert LAUNCHES == before


def test_grid_wrappers_write_out():
    seg = _layout("up_2047").to("cpu")
    h, a_ex = (torch.from_numpy(v) for v in _vectors((2048,), 4))
    inv_deg = torch.from_numpy(_inv_deg(2048, 4))
    out = torch.full((2048,), 7.0)
    assert port_segscan.up_seg_steps_grid(h, DECAY, 8, seg, out=out) is out
    assert torch.equal(out, port_segscan.up_seg_steps_plain(h, DECAY, 8,
                                                            seg))
    assert port_segscan.down_seg_steps_grid(a_ex, DECAY, 0, seg, inv_deg,
                                            out=out) is out
    assert not out.any()


def _bad_call(bad):
    host = _layout("up_2047")
    seg = host.to("cpu")
    h, a_ex = (torch.from_numpy(v) for v in _vectors((2048,), 6))
    inv_deg = torch.from_numpy(_inv_deg(2048, 6))
    steps, out, fn = 8, None, "up"
    if bad == "dtype":
        h, err = h.double(), TypeError
    elif bad == "length":
        h, err = h[:-1].clone(), ValueError
    elif bad == "contiguity":
        h, err = torch.stack([h, h], dim=1)[:, 0], ValueError
    elif bad == "device":
        h, err = h.to("meta"), ValueError
    elif bad == "host_layout":
        seg, err = host, TypeError
    elif bad == "negative_steps":
        steps, err = -1, ValueError
    elif bad == "fractional_steps":
        steps, err = 2.5, TypeError
    elif bad == "inv_deg_shape":
        inv_deg, fn, err = inv_deg[:-1].clone(), "down", ValueError
    else:  # out is an input
        a_ex, out, fn, err = a_ex, a_ex, "down", ValueError
    if fn == "up":
        return (lambda: port_segscan.up_seg_steps_grid(
            h, DECAY, steps, seg, out=out)), err
    return (lambda: port_segscan.down_seg_steps_grid(
        a_ex, DECAY, steps, seg, inv_deg, out=out)), err


@pytest.mark.parametrize("bad", [
    "dtype", "length", "contiguity", "device", "host_layout",
    "negative_steps", "fractional_steps", "inv_deg_shape", "out_is_input"])
def test_grid_wrappers_reject_bad_inputs(bad):
    call, err = _bad_call(bad)
    before = dict(LAUNCHES)
    with pytest.raises(err):
        call()
    assert LAUNCHES == before


# -- the layout in item order and the grid's partition ------------------------

@pytest.mark.parametrize("layout", LAYOUTS)
def test_item_layout_is_the_csr_in_item_order(layout):
    seg = _layout(layout)
    n_pad = len(seg.offsets) - 1
    counts = np.diff(seg.offsets)
    big = counts[seg.long_ids] > port_segscan.GRID_BIG_MIN
    want = np.concatenate([seg.long_ids[big], seg.long_ids[~big],
                           seg.short_ids])
    assert np.array_equal(seg.item_seg, want)
    assert seg.n_big == int(big.sum())
    assert np.array_equal(np.sort(seg.item_seg), np.arange(n_pad))
    assert seg.item_offsets[0] == 0
    assert seg.item_offsets[-1] == len(seg.other32) == len(seg.item_other)
    for q, s in enumerate(seg.item_seg):
        got = seg.item_other[seg.item_offsets[q]:seg.item_offsets[q + 1]]
        assert np.array_equal(got, seg.other32[seg.offsets[s]:
                                               seg.offsets[s + 1]])
    for field in ("item_seg", "item_offsets", "item_other"):
        assert getattr(seg, field).dtype == np.int32
    again = _layout(layout)
    for field in ("item_seg", "item_offsets", "item_other", "n_big",
                  "pad_item"):
        assert np.array_equal(getattr(seg, field), getattr(again, field))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_pad_item_certifies_only_a_pure_padding_run(layout):
    seg = _layout(layout)
    dummy = len(seg.offsets) - 2
    run = seg.other32[seg.offsets[dummy]:seg.offsets[dummy + 1]]
    pure = len(run) > port_segscan.SHORT_SEGMENT_MAX and np.all(run == dummy)
    assert (seg.pad_item >= 0) == bool(pure)
    if pure:
        assert seg.item_seg[seg.pad_item] == dummy


def test_pad_item_in_each_kind_of_long_segment():
    # the padding run on the dummy: big (more than 256 edges), or another
    # long one, or neither
    src = np.arange(10, dtype=np.int32)
    big = port_segscan.build_seg_layout(64, 512, src, src + 1)
    assert big.n_big == 1 and big.pad_item == 0
    assert big.item_seg[0] == 63
    for name in ("no_edges", "self_loops_dups"):
        seg = _layout(name)
        assert seg.n_big == 0 and seg.pad_item == len(seg.long_ids) - 1
    # a real edge in the dummy's run, or a short run, certifies nothing
    src = np.arange(10, dtype=np.int32)
    mixed = port_segscan.build_seg_layout(
        64, 128, np.full(10, 63, np.int32), src)
    assert mixed.pad_item == -1
    short = port_segscan.build_seg_layout(64, 64, np.arange(50) % 60,
                                          (np.arange(50) + 1) % 60)
    assert short.pad_item == -1


def _ranges(g_items, g_lanes, n_items, lanes):
    """Each CTA's (item range, lane range), as the kernel computes them
    from the grid (``csrc/seggrid.cu``'s ``seg_grid_kernel``)."""
    return [((jg * n_items // g_items, (jg + 1) * n_items // g_items),
             (lg * lanes // g_lanes, (lg + 1) * lanes // g_lanes))
            for lg in range(g_lanes) for jg in range(g_items)]


@pytest.mark.parametrize("n_pad,n_long,n_big,lanes,cap", [
    (53248, 877, 21, 1, 528), (53248, 877, 21, 16, 528),
    (53248, 1, 1, 16, 528), (10240, 152, 7, 8, 528), (2048, 38, 0, 16, 528),
    (64, 3, 0, 2, 528), (53248, 877, 21, 4, 100),
    (1 << 20, 5000, 60, 16, 1056), (64, 0, 0, 1, 1),
])
def test_steps_grid_covers_every_item_once(n_pad, n_long, n_big, lanes,
                                           cap):
    n_items = port_segscan.grid_items(n_pad, n_long, n_big)
    assert n_items == (n_big + -(-(n_long - n_big) // 8)
                       + -(-(n_pad - n_long) // 256))
    g_items, g_lanes = port_segscan.steps_grid(n_items, lanes, cap)
    assert (g_items, g_lanes) == port_segscan.steps_grid(n_items, lanes, cap)
    assert 1 <= g_items <= n_items and 1 <= g_lanes <= lanes
    assert g_items * g_lanes <= cap
    # as many CTAs as the work has items and lanes, under the cap
    assert g_items == min(n_items, cap)
    assert g_lanes == min(lanes, max(1, cap // g_items))
    seen = np.zeros((lanes, n_items), np.int64)
    shares = []
    for (j0, j1), (b0, b1) in _ranges(g_items, g_lanes, n_items, lanes):
        seen[b0:b1, j0:j1] += 1
        shares.append((j1 - j0, b1 - b0))
    assert (seen == 1).all()
    items, lane_counts = zip(*shares)
    assert max(items) - min(items) <= 1 and min(items) >= 1
    assert max(lane_counts) - min(lane_counts) <= 1 and min(lane_counts) >= 1


@pytest.mark.parametrize("cap", [0, -1])
def test_steps_grid_refuses_a_device_with_no_room(cap):
    with pytest.raises(ValueError, match="co-resident"):
        port_segscan.steps_grid(10, 1, cap)


# -- the plan ------------------------------------------------------------------

@pytest.fixture
def fresh(monkeypatch, tmp_path):
    monkeypatch.setenv("RCA_KERNEL_CACHE", str(tmp_path / "cache.json"))
    registry.reset_registry()
    yield
    registry.reset_registry()


def test_grid_plan_propagates_bitwise_the_step_plan(fresh, monkeypatch):
    """A ``kernels`` plan with its recursions in the ``grid`` form and the
    same plan per step give the same bits for every output, one graph and
    a batch of lanes (on the CPU the grid wrappers compute their plain
    versions)."""
    monkeypatch.setenv("RCA_KERNEL", "kernels")
    case = synthetic_cascade_arrays(700, n_roots=2, seed=3)
    engine = GraphEngine(device="cpu")
    f, src, dst = engine._pad(case.features, case.dep_src, case.dep_dst)
    plan = engine.plan_for(f.shape[0], len(src), case.dep_src, case.dep_dst)
    assert plan.kernel == "kernels" and plan.steps_form == "step"
    model = engine.model
    dd = torch.from_numpy(dst.astype(np.int64))
    for feats in (torch.from_numpy(f), torch.from_numpy(np.stack([f, f])).
                  mul_(torch.linspace(0.5, 1.0, 2)[:, None, None])):
        grid = model(feats, dd, case.n, plan._replace(steps_form="grid"))
        steps = model(feats, dd, case.n, plan)
        for got, want in zip(grid, steps):
            assert torch.equal(got, want)


def test_plan_refuses_an_unknown_steps_form(fresh, monkeypatch):
    monkeypatch.setenv("RCA_KERNEL", "kernels")
    case = synthetic_cascade_arrays(100, n_roots=1, seed=3)
    engine = GraphEngine(device="cpu")
    f, src, dst = engine._pad(case.features, case.dep_src, case.dep_dst)
    plan = engine.plan_for(f.shape[0], len(src), case.dep_src, case.dep_dst)
    with pytest.raises(ValueError, match="steps form"):
        engine.model(torch.from_numpy(f), torch.from_numpy(
            dst.astype(np.int64)), case.n, plan._replace(steps_form="fused"))


def test_steps_form_is_step_off_the_card(monkeypatch):
    from rca_tpu_torch.kernels import build

    def no_library():
        raise AssertionError("a CPU plan loaded the kernel library")

    monkeypatch.setattr(build, "library", no_library)
    down, up = port_segscan.build_seg_layouts(*_padded(1025), device="cpu")
    assert port_segscan.steps_form(down, up, "cpu") == "step"
    assert port_segscan.STEPS_FORMS == ("step", "cta", "grid")


# -- against the JAX package --------------------------------------------------

@pytest.mark.parametrize("steps", [1, 8])
@pytest.mark.parametrize("services", SERVICES)
def test_grid_recursions_match_reference_recursions(services, steps,
                                                    monkeypatch):
    monkeypatch.setenv("SEGSCAN_INTERPRET", "1")
    n_pad = _padded(services)[0]
    inv_deg = _inv_deg(n_pad, steps)
    h, a_ex = _vectors((n_pad,), services + steps)
    for name in (f"down_{services}", f"up_{services}"):
        spec = SPECS[name]
        ref_seg = ref_segscan.build_seg_layout(*spec)
        seg = port_segscan.build_seg_layout(*spec).to("cpu")

        def up_step(u, _):
            return ref_segscan.up_seg_step(u, jnp.asarray(h), DECAY,
                                           ref_seg), None

        def imp_step(m, _):
            return ref_segscan.down_seg_step(
                m, jnp.asarray(a_ex), DECAY, ref_seg,
                jnp.asarray(inv_deg)), None

        zeros = jnp.zeros(n_pad, jnp.float32)
        u_ref, _ = jax.lax.scan(up_step, zeros, None, length=steps)
        m_ref, _ = jax.lax.scan(imp_step, zeros, None, length=steps)
        u = port_segscan.up_seg_steps_grid(torch.from_numpy(h), DECAY, steps,
                                           seg)
        m = port_segscan.down_seg_steps_grid(torch.from_numpy(a_ex), DECAY,
                                             steps, seg,
                                             torch.from_numpy(inv_deg))
        assert np.array_equal(u.numpy(), np.asarray(u_ref))
        np.testing.assert_allclose(m.numpy(), np.asarray(m_ref), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("services", SERVICES)
def test_grid_plan_engine_matches_reference(services, monkeypatch):
    """The port's engine with its recursions in the ``grid`` form (the
    form the card takes above 2047 services; the plain versions here)
    against the reference's engine on its ``segscan`` plan: top-k with
    its tie order identical, ``u`` bitwise, scores at rtol 1e-5 / atol
    1e-6."""
    monkeypatch.setenv("RCA_KERNEL_CACHE", "off")
    monkeypatch.setattr(runner, "steps_form", lambda *_: "grid")
    calls = []

    def spy(fn):
        def called(*args, **kwargs):
            calls.append(fn.__name__)
            return fn(*args, **kwargs)
        return called

    monkeypatch.setitem(propagate._WHOLE, "grid", tuple(
        spy(fn) for fn in propagate._WHOLE["grid"]))
    ref_params = ref_packaged_params()
    aw, hw = ref_params.weight_arrays()
    params = params_from_jax(
        np.array(aw), np.array(hw), ref_params.steps, ref_params.decay,
        ref_params.explain_strength, ref_params.impact_bonus,
        ref_params.error_contrast)
    case = ref_cascade(services, n_roots=2, seed=services)
    args = (case.features, case.dep_src, case.dep_dst, case.names)
    monkeypatch.setenv("RCA_KERNEL", "segscan")
    ref = RefEngine(params=ref_params, resident=False).analyze_arrays(*args)
    monkeypatch.setenv("RCA_KERNEL", "kernels")
    port = GraphEngine(params=params, device="cpu").analyze_arrays(*args)
    assert calls == ["up_seg_steps_grid", "down_seg_steps_grid"]
    ps, rs = port.full_diagnostics(), ref.full_diagnostics()
    assert port.top_components() == ref.top_components()
    assert np.array_equal(ps[1], rs[1])
    np.testing.assert_allclose(ps[3], rs[3], rtol=1e-5, atol=1e-6)


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's CUDA kernels run only on "
                    "the card (python3 chip_smoke.py runs them there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 2, 16])
@pytest.mark.parametrize("services", [129, 2047, 10000, 49999])
def test_grid_kernels_are_the_per_step_launches_on_card(services, lanes,
                                                         cuda_device):
    n_pad, e_pad, src, dst = _padded(services)
    down, up = port_segscan.build_seg_layouts(n_pad, e_pad, src, dst,
                                              device=cuda_device)
    inv_deg = torch.from_numpy(_inv_deg(n_pad, 2)).to(cuda_device)
    shape = (n_pad,) if lanes == 1 else (lanes, n_pad)
    h, a_ex = (torch.from_numpy(v).to(cuda_device)
               for v in _vectors(shape, 9))
    for steps in STEPS:
        u_want = torch.zeros_like(h)
        m_want = torch.zeros_like(a_ex)
        for _ in range(steps):
            u_want = port_segscan.up_seg_step(u_want, h, DECAY, up)
            m_want = port_segscan.down_seg_step(m_want, a_ex, DECAY, down,
                                                inv_deg)
        u = port_segscan.up_seg_steps_grid(h, DECAY, steps, up)
        m = port_segscan.down_seg_steps_grid(a_ex, DECAY, steps, down,
                                             inv_deg)
        assert torch.equal(u, u_want) and torch.equal(m, m_want)
        # two runs give the same bits
        assert torch.equal(u, port_segscan.up_seg_steps_grid(h, DECAY, steps,
                                                             up))
        assert torch.equal(m, port_segscan.down_seg_steps_grid(
            a_ex, DECAY, steps, down, inv_deg))
        assert torch.equal(u, port_segscan.up_seg_steps_plain(
            h, DECAY, steps, up))
        torch.testing.assert_close(m, port_segscan.down_seg_steps_plain(
            a_ex, DECAY, steps, down, inv_deg), rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("services,form", [
    (2047, "cta"), (10000, "grid"), (49999, "grid")])
def test_plan_takes_the_grid_above_one_cta_on_card(services, form,
                                                   cuda_device, fresh):
    case = synthetic_cascade_arrays(services, n_roots=3, seed=0)
    engine = GraphEngine(device=cuda_device)
    f, src, _ = engine._pad(case.features, case.dep_src, case.dep_dst)
    plan = engine.plan_for(f.shape[0], len(src), case.dep_src, case.dep_dst)
    assert plan.kernel == "kernels" and plan.steps_form == form
