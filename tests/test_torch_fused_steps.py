"""The fused recursions of the PyTorch port against the loops they replace
and against the JAX package's recursions.

``up_seg_steps`` / ``down_seg_steps`` run all the steps of the
explain-away and the impact recursion in one launch on the card
(``rca_tpu_torch/csrc/segsteps.cu``); on a CPU tensor each computes its
plain version, the loop of plain steps.  These tests hold the CPU path to
that loop bitwise, and to the reference's recursions
(``rca_tpu/engine/propagate.py``: ``lax.scan`` over
``segscan.up_seg_step`` / ``down_seg_step``, whose Pallas scans run in
interpret mode, as the JAX package's own tests run them on the CPU) on the
same numpy inputs: ``u`` bitwise (a float32 max does not depend on
order), ``m`` at rtol 1e-5 / atol 1e-6 (the repo's segscan tolerance: the
sum runs in another order).  They also pin the wrappers' input contract
and the plan's ``steps_form``, which only a CUDA device can set (the
kernel library counts the shared memory a layout needs and reads the
device's limit).  The CUDA kernels run only on the card: the tests marked
``cuda`` hold them bitwise to the per-step launches there, and the plan
to its decision, and skip elsewhere (``python3 chip_smoke.py`` runs the
same checks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rca_tpu.cluster.generator import synthetic_cascade_arrays
from rca_tpu.engine import segscan as ref_segscan
from rca_tpu_torch import cli
from rca_tpu_torch.engine import registry
from rca_tpu_torch.engine import segscan as port_segscan
from rca_tpu_torch.engine.runner import GraphEngine, kernel_plan
from rca_tpu_torch.kernels import LAUNCHES

DECAY = 0.6
STEPS = [0, 1, 8, 13]


def _layout_specs():
    """(n_pad, e_pad, seg_idx, other_idx) per layout: both directions of
    a 2047-service cascade, a star whose one segment holds 4096 edges
    (longer than the kernels' 256-thread stride), a graph with no edges
    (every slot a padding self-loop on the dummy) and one of self-loops
    with duplicate edges."""
    case = synthetic_cascade_arrays(2047, n_roots=2, seed=0)
    rng = np.random.default_rng(12)
    loops = np.arange(50, dtype=np.int32)
    return {
        "down_2047": (2048, 4096, case.dep_dst, case.dep_src),
        "up_2047": (2048, 4096, case.dep_src, case.dep_dst),
        "star_4096": (2048, 4096, np.full(4096, 7, np.int32),
                      rng.integers(0, 2047, 4096).astype(np.int32)),
        "no_edges": (64, 128, np.zeros(0, np.int32), np.zeros(0, np.int32)),
        "self_loops_dups": (
            64, 128,
            np.concatenate([loops, np.full(20, 3), np.full(40, 9)]).astype(
                np.int32),
            np.concatenate([loops, np.full(20, 5),
                            rng.integers(0, 63, 40)]).astype(np.int32)),
    }


LAYOUTS = list(_layout_specs())


def _layout(name):
    return port_segscan.build_seg_layout(*_layout_specs()[name])


def _vectors(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0.0, 1.0, shape).astype(np.float32)
            for _ in range(2)]


def _inv_deg(n_pad, seed):
    rng = np.random.default_rng(seed)
    return (1.0 / rng.integers(1, 9, n_pad)).astype(np.float32)


def _loop_up(h, seg, steps):
    u = torch.zeros_like(h)
    for _ in range(steps):
        u = port_segscan.up_seg_step_plain(u, h, DECAY, seg)
    return u


def _loop_down(a_ex, seg, inv_deg, steps):
    m = torch.zeros_like(a_ex)
    for _ in range(steps):
        m = port_segscan.down_seg_step_plain(m, a_ex, DECAY, seg, inv_deg)
    return m


# -- the CPU path: the loop of plain steps ------------------------------------

@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_fused_steps_on_cpu_are_the_loop_of_plain_steps(layout, steps):
    seg = _layout(layout).to("cpu")
    n_pad = seg.offsets.shape[0] - 1
    inv_deg = torch.from_numpy(_inv_deg(n_pad, 3))
    before = dict(LAUNCHES)
    for shape in ((n_pad,), (3, n_pad)):
        h, a_ex = (torch.from_numpy(v) for v in _vectors(shape, steps))
        u = port_segscan.up_seg_steps(h, DECAY, steps, seg)
        m = port_segscan.down_seg_steps(a_ex, DECAY, steps, seg, inv_deg)
        assert torch.equal(u, _loop_up(h, seg, steps))
        assert torch.equal(m, _loop_down(a_ex, seg, inv_deg, steps))
        assert torch.equal(u, port_segscan.up_seg_steps_plain(
            h, DECAY, steps, seg))
        if len(shape) == 2:
            # each lane is its own flat recursion
            for b in range(shape[0]):
                assert torch.equal(u[b], port_segscan.up_seg_steps(
                    h[b].contiguous(), DECAY, steps, seg))
                assert torch.equal(m[b], port_segscan.down_seg_steps(
                    a_ex[b].contiguous(), DECAY, steps, seg, inv_deg))
        if steps == 0:
            assert not u.any() and not m.any()
    assert LAUNCHES == before


@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("layout", ["down_2047", "up_2047", "star_4096"])
def test_fused_steps_match_reference_recursions(layout, steps,
                                                monkeypatch):
    monkeypatch.setenv("SEGSCAN_INTERPRET", "1")
    spec = _layout_specs()[layout]
    n_pad = spec[0]
    ref_seg = ref_segscan.build_seg_layout(*spec)
    seg = port_segscan.build_seg_layout(*spec).to("cpu")
    h, a_ex = _vectors((n_pad,), len(layout) + steps)
    inv_deg = _inv_deg(n_pad, steps)

    def up_step(u, _):
        return ref_segscan.up_seg_step(u, jnp.asarray(h), DECAY, ref_seg), None

    def imp_step(m, _):
        return ref_segscan.down_seg_step(m, jnp.asarray(a_ex), DECAY, ref_seg,
                                         jnp.asarray(inv_deg)), None

    zeros = jnp.zeros(n_pad, jnp.float32)
    u_ref, _ = jax.lax.scan(up_step, zeros, None, length=steps)
    m_ref, _ = jax.lax.scan(imp_step, zeros, None, length=steps)
    u = port_segscan.up_seg_steps(torch.from_numpy(h), DECAY, steps, seg)
    m = port_segscan.down_seg_steps(torch.from_numpy(a_ex), DECAY, steps,
                                    seg, torch.from_numpy(inv_deg))
    assert np.array_equal(u.numpy(), np.asarray(u_ref))
    np.testing.assert_allclose(m.numpy(), np.asarray(m_ref), rtol=1e-5,
                               atol=1e-6)


def test_fused_wrappers_write_out():
    seg = _layout("up_2047").to("cpu")
    h, a_ex = (torch.from_numpy(v) for v in _vectors((2048,), 4))
    inv_deg = torch.from_numpy(_inv_deg(2048, 4))
    out = torch.full((2048,), 7.0)
    assert port_segscan.up_seg_steps(h, DECAY, 8, seg, out=out) is out
    assert torch.equal(out, _loop_up(h, seg, 8))
    assert port_segscan.down_seg_steps(a_ex, DECAY, 0, seg, inv_deg,
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
        return (lambda: port_segscan.up_seg_steps(h, DECAY, steps, seg,
                                                  out=out)), err
    return (lambda: port_segscan.down_seg_steps(a_ex, DECAY, steps, seg,
                                                inv_deg, out=out)), err


@pytest.mark.parametrize("bad", [
    "dtype", "length", "contiguity", "device", "host_layout",
    "negative_steps", "fractional_steps", "inv_deg_shape", "out_is_input"])
def test_fused_wrappers_reject_bad_inputs(bad):
    call, err = _bad_call(bad)
    before = dict(LAUNCHES)
    with pytest.raises(err):
        call()
    assert LAUNCHES == before


# -- the plan's decision ------------------------------------------------------

@pytest.fixture
def fresh(monkeypatch, tmp_path):
    monkeypatch.setenv("RCA_KERNEL_CACHE", str(tmp_path / "cache.json"))
    registry.reset_registry()
    yield
    registry.reset_registry()


def _ring(n_pad):
    n = n_pad - 1
    src = np.arange(n, dtype=np.int32)
    return src, (src + 1) % n


@pytest.mark.parametrize("row", ["kernels", "torch"])
@pytest.mark.parametrize("n_pad", [2048, 53248])
def test_kernel_plan_decides_steps_fused(n_pad, row, fresh, monkeypatch):
    """Off a CUDA device every form of the ``kernels`` row's recursions
    computes the same loop of plain steps, so the plan's ``steps_form``
    is ``step`` there, whatever the shape or row, and the plan never asks
    the kernel library."""
    from rca_tpu_torch.kernels import build

    def no_library():
        raise AssertionError("a CPU plan loaded the kernel library")

    monkeypatch.setattr(build, "library", no_library)
    src, dst = _ring(n_pad)
    monkeypatch.setenv("RCA_KERNEL", row)
    plan = kernel_plan(n_pad, 2 * n_pad, src, dst, "cpu")
    assert plan.kernel == row and plan.steps_form == "step"
    assert port_segscan.steps_form(plan.down_seg, plan.up_seg,
                                   "cpu") == "step"


def test_fused_plan_propagates_bitwise_the_per_step_plan(fresh, monkeypatch):
    """A ``kernels`` plan with its recursions fused into one CTA a lane
    (``cta``) and the same plan per step give the same bits for every
    output, one graph and a batch of lanes (on the CPU the fused wrappers
    compute their plain versions)."""
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
        fused = model(feats, dd, case.n, plan._replace(steps_form="cta"))
        steps = model(feats, dd, case.n, plan)
        for got, want in zip(fused, steps):
            assert torch.equal(got, want)


def test_kernels_explain_shows_the_steps_decision(capsys, fresh):
    assert cli.main(["kernels", "--device", "cpu", "--services",
                     "2047,49999", "--explain"]) == 0
    out = capsys.readouterr().out
    assert out.count("steps    per step: the fused recursions are CUDA "
                     "kernels; on cpu the plan runs the plain steps") == 2


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's CUDA kernels run only on "
                    "the card (python3 chip_smoke.py runs them there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("services,fused", [(2047, True), (49999, False)])
def test_kernel_plan_fuses_where_the_graph_fits_on_card(services, fused,
                                                        cuda_device, fresh):
    """On the card the ``kernels`` row fuses the recursions into one CTA
    a lane where both layouts fit one CTA's shared memory (the
    2047-service tier, ``cta``) and runs them over the card's grid above
    (the 49,999-service tier, ``grid``)."""
    case = synthetic_cascade_arrays(services, n_roots=3, seed=0)
    engine = GraphEngine(device=cuda_device)
    f, src, _ = engine._pad(case.features, case.dep_src, case.dep_dst)
    plan = engine.plan_for(f.shape[0], len(src), case.dep_src, case.dep_dst)
    assert plan.kernel == "kernels"
    assert plan.steps_form == ("cta" if fused else "grid")
    fits = [need <= limit for need, limit in (
        port_segscan.steps_smem(seg, cuda_device)
        for seg in (plan.down_seg, plan.up_seg))]
    assert all(fits) is fused


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
def test_fused_kernels_are_the_per_step_launches_on_card(layout,
                                                         cuda_device):
    seg = _layout(layout).to(cuda_device)
    n_pad = seg.offsets.shape[0] - 1
    inv_deg = torch.from_numpy(_inv_deg(n_pad, 2)).to(cuda_device)
    for shape in ((n_pad,), (16, n_pad)):
        h, a_ex = (torch.from_numpy(v).to(cuda_device)
                   for v in _vectors(shape, 9))
        for steps in STEPS:
            u_want = torch.zeros_like(h)
            m_want = torch.zeros_like(a_ex)
            for _ in range(steps):
                u_want = port_segscan.up_seg_step(u_want, h, DECAY, seg)
                m_want = port_segscan.down_seg_step(m_want, a_ex, DECAY, seg,
                                                    inv_deg)
            u = port_segscan.up_seg_steps(h, DECAY, steps, seg)
            m = port_segscan.down_seg_steps(a_ex, DECAY, steps, seg, inv_deg)
            assert torch.equal(u, u_want) and torch.equal(m, m_want)
            assert torch.equal(u, port_segscan.up_seg_steps_plain(
                h, DECAY, steps, seg))
            torch.testing.assert_close(m, port_segscan.down_seg_steps_plain(
                a_ex, DECAY, steps, seg, inv_deg), rtol=1e-5, atol=1e-6)
