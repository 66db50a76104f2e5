"""The fused evidence front of the PyTorch port against the JAX package's
front and against the two launches it replaces.

``evidence_front`` runs the whole front (the finite-mask sanitize, the
noisy-OR pair, the error rate, the error-source contrast over the up
layout and, with ``persist``, the sanitized rows written back) as one
cooperative launch on the card (``rca_tpu_torch/csrc/front.cu``, counted
as ``evidence_front_fused``); on a CPU tensor it computes its plain
version, ``evidence_front_plain``.  These tests hold the CPU path to the
reference's front on the same numpy inputs: ``finite_mask_rows``, then
``noisy_or_pair_pallas`` in interpret mode (as the JAX package's own tests
run it on the CPU) on the channel-major transpose, ``error_source_excess``
and ``fold_error_contrast``.  Tolerances: ``n_bad`` and the persisted rows
identical; ``a`` and ``h`` allclose at rtol 1e-6 / atol 1e-7, the
reference's noisy-OR tolerance (ROADMAP C: its compiled noisy-OR rounds
differently from one program to another in the last bit).  They also pin
the wrapper's input contract and the grid-size helper.  The kernel runs
only on the card: the tests marked ``cuda`` hold it bitwise to
``evidence_front_rows`` + ``seg_contrast_step`` and to the plain version
there, and skip elsewhere (``python3 chip_smoke.py`` runs the same
checks).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rca_tpu.cluster.generator import synthetic_cascade_arrays
from rca_tpu.engine.pallas_kernels import noisy_or_pair_pallas
from rca_tpu.engine.propagate import (
    error_source_excess as ref_error_source_excess,
)
from rca_tpu.engine.propagate import (
    finite_mask_rows as ref_finite_mask_rows,
)
from rca_tpu.engine.propagate import (
    fold_error_contrast as ref_fold_error_contrast,
)
from rca_tpu.engine.train import packaged_params
from rca_tpu_torch.engine import evidence as port_evidence
from rca_tpu_torch.engine import segscan as port_segscan
from rca_tpu_torch.features.schema import SvcF
from rca_tpu_torch.kernels import LAUNCHES, PERSIST_LAUNCHES

C = 13
LANES = [1, 3, 16]
WEIGHTS = [0.0, 0.7]
ERR = int(SvcF.ERROR_RATE)


def _edge_specs():
    """(n_pad, e_pad, dep_src, dep_dst) per graph: a 2047-service cascade,
    a star whose one up segment (dependent 7) holds 300 edges, more than a
    CTA's 256 threads stride over, a graph with no edges (every slot a
    padding self-loop on the dummy) and one of self-loops with duplicate
    edges."""
    case = synthetic_cascade_arrays(2047, n_roots=2, seed=0)
    rng = np.random.default_rng(21)
    loops = np.arange(50, dtype=np.int32)
    return {
        "cascade_2047": (2048, 4096, case.dep_src, case.dep_dst),
        "star_300": (512, 512, np.full(300, 7, np.int32),
                     rng.integers(0, 511, 300).astype(np.int32)),
        "no_edges": (64, 128, np.zeros(0, np.int32), np.zeros(0, np.int32)),
        "self_loops_dups": (
            64, 128,
            np.concatenate([loops, np.full(20, 3), np.full(40, 9)]).astype(
                np.int32),
            np.concatenate([loops, np.full(20, 5),
                            rng.integers(0, 63, 40)]).astype(np.int32)),
    }


GRAPHS = list(_edge_specs())


def _padded_edges(n_pad, e_pad, src, dst):
    """The reference's edge lists: padded slots self-loop on the dummy."""
    dummy = n_pad - 1
    s = np.full(e_pad, dummy, np.int32)
    d = np.full(e_pad, dummy, np.int32)
    s[: len(src)] = src
    d[: len(dst)] = dst
    return s, d


def _weights():
    aw, hw = packaged_params().weight_arrays()
    return np.array(aw, np.float32), np.array(hw, np.float32)


def _features(graph: str, lanes: int, seed: int) -> np.ndarray:
    """``[lanes, n_pad, C]`` raw features, partly past [0, 1], with in
    every lane a NaN row, a NaN in the error column alone, a NaN beside a
    finite error rate, an Inf in a dependency's other column and a -Inf."""
    n_pad, _, _, dst = _edge_specs()[graph]
    rng = np.random.default_rng(seed)
    f = rng.uniform(-0.2, 1.2, (lanes, n_pad, C)).astype(np.float32)
    f[:, ::3] = rng.uniform(0.0, 0.3, f[:, ::3].shape)
    dep = int(dst[0]) if len(dst) else 5
    others = np.setdiff1d(np.arange(n_pad - 1), [dep])
    for b in range(lanes):
        rows = rng.choice(others, 4, replace=False)
        f[b, rows[0]] = np.nan
        f[b, rows[1], ERR] = np.nan
        f[b, rows[2], [ERR, 4]] = (0.9, np.nan)
        f[b, rows[3], 2] = -np.inf
        f[b, dep, 4] = np.inf
    return f


def _ref_front(f, src, dst, aw, hw, weight):
    """The reference's front on one ``[n_pad, C]`` lane: ``(a, h, n_bad,
    clean)``."""
    clean, n_bad = ref_finite_mask_rows(jnp.asarray(f))
    a, h = noisy_or_pair_pallas(clean.T, jnp.asarray(aw), jnp.asarray(hw),
                                interpret=True)
    if weight:
        a = ref_fold_error_contrast(
            a, ref_error_source_excess(clean, jnp.asarray(src),
                                       jnp.asarray(dst)), weight)
    return np.asarray(a), np.asarray(h), int(n_bad), np.asarray(clean)


def _up(graph: str, device="cpu"):
    n_pad, e_pad, src, dst = _edge_specs()[graph]
    return port_segscan.build_up_seg(n_pad, e_pad, src, dst).to(device)


# -- the CPU path against the reference's front -------------------------------

@pytest.mark.parametrize("persist", [False, True])
@pytest.mark.parametrize("weight", WEIGHTS)
@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("graph", GRAPHS)
def test_front_on_cpu_matches_reference_front(graph, lanes, weight,
                                              persist):
    n_pad, e_pad, src, dst = _edge_specs()[graph]
    ref_src, ref_dst = _padded_edges(n_pad, e_pad, src, dst)
    aw, hw = _weights()
    f = _features(graph, lanes, seed=lanes + len(graph))
    up = _up(graph)
    ft = torch.from_numpy((f if lanes > 1 else f[0]).copy())
    before = dict(LAUNCHES)
    a, h, n_bad = port_evidence.evidence_front(
        ft, torch.from_numpy(aw), torch.from_numpy(hw), weight, up, persist)
    assert LAUNCHES == before
    refs = [_ref_front(f[b], ref_src, ref_dst, aw, hw, weight)
            for b in range(lanes)]
    shape = (lanes, n_pad) if lanes > 1 else (n_pad,)
    ref_a = np.stack([r[0] for r in refs]).reshape(shape)
    ref_h = np.stack([r[1] for r in refs]).reshape(shape)
    ref_clean = np.stack([r[3] for r in refs]).reshape(ft.shape)
    assert n_bad.dtype == torch.int32 and n_bad.shape == ()
    assert int(n_bad) == sum(r[2] for r in refs) == 5 * lanes
    np.testing.assert_allclose(h.numpy(), ref_h, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(a.numpy(), ref_a, rtol=1e-6, atol=1e-7)
    if persist:
        assert np.array_equal(ft.numpy(), ref_clean)
    else:
        assert np.array_equal(ft.numpy(), f.reshape(ft.shape),
                              equal_nan=True)


@pytest.mark.parametrize("weight", WEIGHTS)
@pytest.mark.parametrize("graph", GRAPHS)
def test_front_on_cpu_is_the_two_steps_and_lanes_are_solo(graph, weight):
    """The CPU path is bitwise the composition the card's launch replaces
    (the row pass, then the contrast unless the weight is 0), and each
    lane of a batch is bitwise its solo front."""
    aw, hw = (torch.from_numpy(w) for w in _weights())
    up = _up(graph)
    f = torch.from_numpy(_features(graph, 3, seed=9))
    a, h, n_bad = port_evidence.evidence_front(f, aw, hw, weight, up)
    a_raw, h_rows, e, n_rows = port_evidence.evidence_front_rows(f, aw, hw)
    want = (port_evidence.seg_contrast_step(a_raw, e, weight, up) if weight
            else a_raw)
    assert torch.equal(a, want) and torch.equal(h, h_rows)
    assert torch.equal(n_bad, n_rows)
    for b in range(3):
        sa, sh, sb = port_evidence.evidence_front(f[b].contiguous(), aw, hw,
                                                  weight, up)
        assert torch.equal(a[b], sa) and torch.equal(h[b], sh)
        assert int(sb) == 5


# -- the grid of the cooperative launch ---------------------------------------

@pytest.mark.parametrize("args,want", [
    # the 2047-service tier: 8 tiles, 8 blocks of short segments
    ((2048, 1, 0, 2048, True, 1056), 8),
    # the 49,999 tier: 208 tiles, the dummy's long run + 208 blocks
    ((53248, 1, 1, 53247, True, 1056), 209),
    # no contrast: the tiles alone
    ((53248, 1, 1, 53247, False, 1056), 208),
    # 16 lanes at 49,999: capped at the co-resident bound
    ((16 * 53248, 16, 1, 53247, True, 1056), 1056),
    # many long segments outnumber the tiles
    ((2048, 4, 40, 2008, True, 1056), 4 * (40 + 8)),
    # a ragged tile rounds up; a graph of one row still takes one CTA
    ((64, 1, 0, 64, False, 1056), 1),
    ((1, 1, 0, 1, True, 1056), 1),
    ((300, 1, 0, 300, False, 7), 2),
    ((53248, 1, 1, 53247, True, 7), 7),
])
def test_front_grid_sizes_to_the_work_under_the_cap(args, want):
    assert port_evidence.front_grid(*args) == want
    assert port_evidence.FRONT_TILE_ROWS == 256


@pytest.mark.parametrize("cap", [0, -1])
def test_front_grid_refuses_a_device_with_no_room(cap):
    with pytest.raises(ValueError, match="co-resident"):
        port_evidence.front_grid(2048, 1, 0, 2048, True, cap)


# -- the wrapper's contract ---------------------------------------------------

def _bad_front_call(bad):
    aw, hw = (torch.from_numpy(w) for w in _weights())
    up = _up("no_edges")
    f = torch.from_numpy(_features("no_edges", 2, seed=3))
    persist, err = False, ValueError
    if bad == "dtype":
        f, err = f.double(), TypeError
    elif bad == "weight_dtype":
        aw, err = aw.double(), TypeError
    elif bad == "weight_shape":
        hw = hw[:-1]
    elif bad == "rank":
        f = f.reshape(-1)
    elif bad == "channels":
        f, aw, hw = f[..., :ERR].contiguous(), aw[:ERR], hw[:ERR]
    elif bad == "too_many_channels":
        f = torch.zeros(2, 64, port_evidence.MAX_CHANNELS + 1)
        aw = hw = torch.zeros(port_evidence.MAX_CHANNELS + 1)
    elif bad == "device":
        f, aw, hw = f.to("meta"), aw.to("meta"), hw.to("meta")
    elif bad == "host_layout":
        up, err = port_segscan.build_up_seg(64, 128, [0], [1]), TypeError
    elif bad == "layout_device":
        up = port_segscan.build_up_seg(64, 128, [0], [1]).to("meta")
    elif bad == "layout_rows":
        up = port_segscan.build_up_seg(128, 128, [0], [1]).to("cpu")
    else:  # a persisting launch on a strided view
        f, persist = f.transpose(0, 1).contiguous().transpose(0, 1), True
    return (lambda: port_evidence.evidence_front(f, aw, hw, 0.7, up,
                                                 persist)), err


@pytest.mark.parametrize("bad", [
    "dtype", "weight_dtype", "weight_shape", "rank", "channels",
    "too_many_channels", "device", "host_layout", "layout_device",
    "layout_rows", "persist_strided"])
def test_front_wrapper_rejects_bad_inputs(bad):
    call, err = _bad_front_call(bad)
    before = dict(LAUNCHES)
    with pytest.raises(err):
        call()
    assert LAUNCHES == before


def test_front_on_cpu_never_loads_the_kernel_library(monkeypatch):
    from rca_tpu_torch.kernels import build

    def no_library():
        raise AssertionError("a CPU front loaded the kernel library")

    monkeypatch.setattr(build, "library", no_library)
    aw, hw = (torch.from_numpy(w) for w in _weights())
    f = torch.from_numpy(_features("star_300", 2, seed=5))
    before = (dict(LAUNCHES), dict(PERSIST_LAUNCHES))
    a, h, n_bad = port_evidence.evidence_front(f, aw, hw, 0.7,
                                               _up("star_300"), persist=True)
    assert (dict(LAUNCHES), dict(PERSIST_LAUNCHES)) == before
    assert a.shape == h.shape == (2, 512) and int(n_bad) == 10
    assert torch.isfinite(f).all()


def test_launch_counters_name_the_fused_front():
    assert LAUNCHES["evidence_front_fused"] >= 0
    assert PERSIST_LAUNCHES["evidence_front_fused"] >= 0
    # the row pass and the contrast keep their own counters: the sharded
    # engine launches them
    assert {"evidence_front", "seg_contrast_step"} <= set(LAUNCHES)


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the fused front is a CUDA kernel "
                    "(python3 chip_smoke.py runs these checks on the card)")
    return torch.device("cuda")


def _two_launches(f, aw, hw, weight, up, persist):
    a, h, e, n_bad = port_evidence.evidence_front_rows(f, aw, hw, persist)
    if weight:
        a = port_evidence.seg_contrast_step(a, e, weight, up)
    return a, h, n_bad


@pytest.mark.cuda
@pytest.mark.parametrize("persist", [False, True])
@pytest.mark.parametrize("weight", WEIGHTS)
@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("graph", GRAPHS)
def test_fused_front_is_the_two_launches_on_card(graph, lanes, weight,
                                                 persist, cuda_device):
    aw, hw = (torch.from_numpy(w).to(cuda_device) for w in _weights())
    up = _up(graph, cuda_device)
    f = _features(graph, lanes, seed=lanes)
    f = f if lanes > 1 else f[0]
    fused, two, plain = (torch.from_numpy(f.copy()).to(cuda_device)
                         for _ in range(3))
    before = dict(LAUNCHES)
    persisting = PERSIST_LAUNCHES["evidence_front_fused"]
    got = port_evidence.evidence_front(fused, aw, hw, weight, up, persist)
    assert LAUNCHES["evidence_front_fused"] == \
        before["evidence_front_fused"] + 1
    assert PERSIST_LAUNCHES["evidence_front_fused"] == \
        persisting + int(persist)
    want = _two_launches(two, aw, hw, weight, up, persist)
    ref = port_evidence.evidence_front_plain(plain, aw, hw, weight, up,
                                             persist)
    again = port_evidence.evidence_front(fused.clone(), aw, hw, weight, up,
                                         persist)
    for g, w, r, a2 in zip(got, want, ref, again):
        assert torch.equal(g, w) and torch.equal(g, r)
        if not persist:
            assert torch.equal(g, a2)
    assert torch.equal(fused, two) and torch.equal(fused, plain)
    assert int(got[2]) == 5 * lanes


@pytest.mark.cuda
def test_dense_analysis_on_card_launches_the_fused_front(cuda_device,
                                                         monkeypatch,
                                                         tmp_path):
    from rca_tpu_torch import GraphEngine
    from rca_tpu_torch.cluster.generator import (
        synthetic_cascade_arrays as port_cascade,
    )
    from rca_tpu_torch.kernels import reset_launches

    monkeypatch.setenv("RCA_KERNEL_CACHE", str(tmp_path / "cache.json"))
    case = port_cascade(2047, n_roots=3, seed=0)
    engine = GraphEngine(device=cuda_device)
    engine.analyze_case(case)   # the race launches kernels
    reset_launches()
    engine.analyze_case(case)
    assert LAUNCHES["evidence_front_fused"] == 1
    assert LAUNCHES["evidence_front"] == 0
    assert LAUNCHES["seg_contrast_step"] == 0


@pytest.mark.cuda
def test_fused_front_grid_fits_the_card(cuda_device):
    cap = port_evidence.front_cap(torch.cuda.current_device(), C, "fused")
    assert cap >= torch.cuda.get_device_properties(
        cuda_device).multi_processor_count
    assert port_evidence.front_grid(16 * 53248, 16, 1, 53247, True,
                                    cap) <= cap
