"""The PyTorch port's kernels against the JAX package's.

On the CPU each kernel wrapper of ``rca_tpu_torch`` computes its plain
PyTorch version; these tests hold those plain versions to the JAX
package's Pallas kernels (run in interpret mode, as that package's own
tests run them on the CPU) on the same numpy inputs.  The CUDA kernels
themselves run only on the card: the tests marked ``cuda`` hold them to
the plain versions there and skip elsewhere.

Tolerances: the evidence pair allclose at rtol 1e-6 / atol 1e-7 (one
product of 13 float32 factors); the segmented max bitwise (float32 max
does not depend on order); the segmented sum allclose at rtol 1e-5 /
atol 1e-6, the repo's segscan-vs-scatter tolerance (the sum is taken in
another order).  The evidence front against the reference's front
compiled as one program: ``a`` and ``h`` allclose at rtol 1e-6 / atol
1e-7, the bad-row count equal.  ``h`` is not held bitwise there: the
reference's own compiled noisy-OR rounds differently from one program to
another (its Pallas kernel in interpret mode, its front alone and its
whole propagation disagree with each other in the last bit on many rows
with the packaged weights), so the bitwise checks are the port's kernels against their plain versions on
the card, and ``u`` against the reference's engine
(``tests/test_torch_engine.py``).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rca_tpu.cluster.generator import synthetic_cascade_arrays
from rca_tpu.engine import segscan as ref_segscan
from rca_tpu.engine.pallas_kernels import (
    noisy_or_pair_pallas,
    noisy_or_pair_xla,
)
from rca_tpu.engine.propagate import _noisy_or as ref_noisy_or
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
from rca_tpu_torch.engine.evidence import noisy_or_pair, noisy_or_pair_plain
from rca_tpu_torch.features.schema import SvcF
from rca_tpu_torch.kernels import LAUNCHES

C = 13


def _weights():
    aw, hw = packaged_params().weight_arrays()
    return np.array(aw), np.array(hw)


def _features(n_rows: int, seed: int) -> np.ndarray:
    # past [0, 1] on purpose: the clip is part of the kernel
    return np.random.default_rng(seed).uniform(
        -0.2, 1.2, (n_rows, C)).astype(np.float32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's CUDA kernels run only on "
                    "the card (python3 chip_smoke.py runs them there)")
    return torch.device("cuda")


# -- K1: the noisy-OR evidence pair -------------------------------------------

@pytest.mark.parametrize("n_rows,seed", [(64, 0), (1024, 1), (2048, 2)])
def test_noisy_or_plain_matches_pallas_and_xla(n_rows, seed):
    f = _features(n_rows, seed)
    aw, hw = _weights()
    ref_pallas = noisy_or_pair_pallas(
        jnp.asarray(f.T), jnp.asarray(aw), jnp.asarray(hw), interpret=True)
    ref_xla = noisy_or_pair_xla(jnp.asarray(f), jnp.asarray(aw),
                                jnp.asarray(hw))
    a, h = noisy_or_pair_plain(torch.from_numpy(f), torch.from_numpy(aw),
                               torch.from_numpy(hw))
    for ref in (ref_pallas, ref_xla):
        np.testing.assert_allclose(a.numpy(), np.asarray(ref[0]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(h.numpy(), np.asarray(ref[1]),
                                   rtol=1e-6, atol=1e-7)


def test_noisy_or_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    f = torch.from_numpy(_features(256, 3))
    aw, hw = (torch.from_numpy(w) for w in _weights())
    before = dict(LAUNCHES)
    a, h = noisy_or_pair(f, aw, hw)
    pa, ph = noisy_or_pair_plain(f, aw, hw)
    assert torch.equal(a, pa) and torch.equal(h, ph)
    assert LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "rank", "device"])
def test_noisy_or_wrapper_rejects_bad_inputs(bad):
    f = torch.from_numpy(_features(64, 4))
    aw, hw = (torch.from_numpy(w) for w in _weights())
    if bad == "dtype":
        f, err = f.double(), TypeError
    elif bad == "shape":
        aw, err = aw[:-1], ValueError
    elif bad == "rank":
        f, err = f.reshape(-1), ValueError
    else:
        f, aw, hw, err = f.to("meta"), aw.to("meta"), hw.to("meta"), ValueError
    with pytest.raises(err):
        noisy_or_pair(f, aw, hw)


@pytest.mark.cuda
def test_noisy_or_kernel_matches_plain_on_card(cuda_device):
    f = torch.from_numpy(_features(53248, 5)).to(cuda_device)
    aw, hw = (torch.from_numpy(w).to(cuda_device) for w in _weights())
    a, h = noisy_or_pair(f, aw, hw)
    pa, ph = noisy_or_pair_plain(f, aw, hw)
    torch.testing.assert_close(a, pa, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(h, ph, rtol=1e-6, atol=1e-7)


# -- K1 redesigned: the evidence front (sanitize, pair, contrast) -------------

@functools.partial(jax.jit, static_argnames=("error_contrast",))
def _ref_front(features, dep_src, dep_dst, aw, hw, error_contrast):
    """The front of the reference's ranked propagation, compiled as one
    program as its ``_propagate_ranked`` is."""
    clean, n_bad = ref_finite_mask_rows(features)
    a = ref_noisy_or(clean, aw)
    h = ref_noisy_or(clean, hw)
    if error_contrast:
        a = ref_fold_error_contrast(
            a, ref_error_source_excess(clean, dep_src, dep_dst),
            error_contrast)
    return a, h, n_bad


def _front_case(n: int, poison: str):
    """A padded cascade of ``n`` services, a few rows past [0, 1], and the
    rows ``poison`` names made non-finite.  Returns the features, the
    padded edges, the port's up layout on the CPU and the poisoned row
    whose finite error rate the sanitize must drop (or None)."""
    case = synthetic_cascade_arrays(n, n_roots=2, seed={50: 7, 700: 3,
                                                         2047: 0}[n])
    n_pad = {50: 64, 700: 1024, 2047: 2048}[n]
    e_pad = 4096 if n == 2047 else (128 if n == 50 else 2048)
    rng = np.random.default_rng(n)
    f = np.zeros((n_pad, C), np.float32)
    f[:n] = case.features
    f[: n : 5] = rng.uniform(-0.2, 1.2, f[: n : 5].shape)
    dropped = None
    if poison == "error_rate_only":
        f[3, SvcF.ERROR_RATE] = np.nan
    elif poison == "nan_elsewhere":
        dropped = 11
        f[dropped, SvcF.ERROR_RATE] = 0.9
        f[dropped, 4] = np.nan
    elif poison == "inf":
        f[[2, 20], [7, 12]] = (np.inf, -np.inf)
    elif poison == "all_rows":
        f[:] = np.nan
    dummy = n_pad - 1
    src = np.full(e_pad, dummy, np.int32)
    dst = np.full(e_pad, dummy, np.int32)
    src[: len(case.dep_src)] = case.dep_src
    dst[: len(case.dep_dst)] = case.dep_dst
    up = port_segscan.build_up_seg(n_pad, e_pad, case.dep_src,
                                   case.dep_dst).to("cpu")
    return f, src, dst, up, dropped


POISONS = ["clean", "error_rate_only", "nan_elsewhere", "inf", "all_rows"]


@pytest.mark.parametrize("poison", POISONS)
@pytest.mark.parametrize("error_contrast", [0.0, 0.7])
@pytest.mark.parametrize("n", [50, 700, 2047])
def test_evidence_front_plain_matches_reference_front(n, error_contrast,
                                                      poison):
    f, src, dst, up, dropped = _front_case(n, poison)
    aw, hw = _weights()
    ref_a, ref_h, ref_bad = _ref_front(
        jnp.asarray(f), jnp.asarray(src), jnp.asarray(dst), jnp.asarray(aw),
        jnp.asarray(hw), error_contrast)
    ft, awt, hwt = (torch.from_numpy(v) for v in (f, aw, hw))
    a, h, n_bad = port_evidence.evidence_front_plain(ft, awt, hwt,
                                                     error_contrast, up)
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(a.numpy(), np.asarray(ref_a), rtol=1e-6,
                               atol=1e-7)
    assert n_bad.dtype == torch.int32
    assert int(n_bad) == int(ref_bad)
    assert int(n_bad) == {"clean": 0, "error_rate_only": 1,
                          "nan_elsewhere": 1, "inf": 2,
                          "all_rows": f.shape[0]}[poison]
    _, _, e, _ = port_evidence.evidence_front_rows_plain(ft, awt, hwt)
    if dropped is not None:
        assert e[dropped] == 0.0 and a[dropped] == 0.0 and h[dropped] == 0.0
    if poison == "all_rows":
        assert not a.any() and not h.any() and not e.any()


def _front_inputs(n: int = 700, poison: str = "inf"):
    f, _, _, up, _ = _front_case(n, poison)
    aw, hw = (torch.from_numpy(w) for w in _weights())
    return torch.from_numpy(f), aw, hw, up


def test_evidence_front_wrappers_on_cpu_are_the_plain_versions():
    f, aw, hw, up = _front_inputs()
    before = dict(LAUNCHES)
    for weight in (0.0, 0.7):
        got = port_evidence.evidence_front(f, aw, hw, weight, up)
        want = port_evidence.evidence_front_plain(f, aw, hw, weight, up)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    rows = port_evidence.evidence_front_rows(f, aw, hw)
    for g, w in zip(rows, port_evidence.evidence_front_rows_plain(f, aw, hw)):
        assert torch.equal(g, w)
    a_raw, _, e, _ = rows
    assert torch.equal(port_evidence.seg_contrast_step(a_raw, e, 0.7, up),
                       port_evidence.seg_contrast_step_plain(a_raw, e, 0.7,
                                                             up))
    assert LAUNCHES == before


def test_front_is_the_pair_on_clean_rows_and_the_contrast_over_the_layout():
    """Pieces of the front against the functions they stand for: the row
    pass's pair is the evidence pair of the sanitized rows, and the
    layout's segment of each sorted edge recovers the dependency max of
    the scatter over the raw edge lists."""
    f, aw, hw, up = _front_inputs(2047, "clean")
    a_raw, h, e, n_bad = port_evidence.evidence_front_rows(f, aw, hw)
    pa, ph = noisy_or_pair(f, aw, hw)
    assert torch.equal(a_raw, pa) and torch.equal(h, ph) and int(n_bad) == 0
    _, src, dst, _, _ = _front_case(2047, "clean")
    want = port_evidence.error_source_excess(
        e, torch.from_numpy(src.astype(np.int64)),
        torch.from_numpy(dst.astype(np.int64)))
    got = port_evidence.error_source_excess(
        e, port_evidence.segment_sources(up), up.other_sorted)
    assert torch.equal(got, want)
    assert int((got > 0).sum()) > 0


def _bad_front_call(bad):
    f, aw, hw, up = _front_inputs(50, "clean")
    err = ValueError
    if bad == "dtype":
        f, err = f.double(), TypeError
    elif bad == "weight_shape":
        hw = hw[:-1]
    elif bad == "rank":
        f = f.reshape(-1)
    elif bad == "channels":
        f, aw, hw = f[:, :1].contiguous(), aw[:1], hw[:1]
    elif bad == "device":
        f, aw, hw = f.to("meta"), aw.to("meta"), hw.to("meta")
    elif bad == "host_layout":
        up, err = port_segscan.build_up_seg(64, 128, [0], [1]), TypeError
    elif bad == "layout_device":
        up = port_segscan.build_up_seg(64, 128, [0], [1]).to("meta")
    else:  # a layout of another bucket
        up = port_segscan.build_up_seg(128, 128, [0], [1]).to("cpu")
    return lambda: port_evidence.evidence_front(f, aw, hw, 0.7, up), err


@pytest.mark.parametrize("bad", ["dtype", "weight_shape", "rank", "channels",
                                 "device", "host_layout", "layout_device",
                                 "layout_rows"])
def test_evidence_front_wrapper_rejects_bad_inputs(bad):
    call, err = _bad_front_call(bad)
    with pytest.raises(err):
        call()


@pytest.mark.cuda
@pytest.mark.parametrize("poison", POISONS)
@pytest.mark.parametrize("error_contrast", [0.0, 0.7])
def test_evidence_front_kernels_match_plain_on_card(error_contrast, poison,
                                                    cuda_device):
    f, aw, hw, up = _front_inputs(2047, poison)
    f, aw, hw = (t.to(cuda_device) for t in (f, aw, hw))
    up = up.to(cuda_device)
    got = port_evidence.evidence_front(f, aw, hw, error_contrast, up)
    again = port_evidence.evidence_front(f, aw, hw, error_contrast, up)
    want = port_evidence.evidence_front_plain(f, aw, hw, error_contrast, up)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        assert torch.equal(g, w)


# -- K2/K3: the flagged segmented scans ---------------------------------------

def _cascade_flags(e_pad_tier: int):
    """Segment flags of a real layout: the dst-sorted (down) and
    src-sorted (up) edges of a cascade padded to ``e_pad_tier``."""
    n, seed, n_pad = {4096: (2047, 0, 2048), 512: (200, 11, 256)}[e_pad_tier]
    case = synthetic_cascade_arrays(n, n_roots=2, seed=seed)
    down = ref_segscan.build_down_seg(n_pad, e_pad_tier, case.dep_src,
                                      case.dep_dst)
    up = ref_segscan.build_up_seg(n_pad, e_pad_tier, case.dep_src,
                                  case.dep_dst)
    return {"down": np.array(down.flags), "up": np.array(up.flags)}


def _edge_case_flags(name: str) -> np.ndarray:
    if name == "one_segment":
        flags = np.zeros(1024, np.float32)
        flags[0] = 1.0
    elif name == "all_singletons":
        flags = np.ones(1024, np.float32)
    else:  # a 2,000-long hub run between short segments
        flags = np.zeros(4096, np.float32)
        flags[[0, 3, 10, 2010, 2011, 2500]] = 1.0
    return flags


def _flag_cases():
    cases = []
    for tier in (4096, 512):
        for direction in ("down", "up"):
            cases.append(pytest.param(("layout", tier, direction),
                                      id=f"e_pad{tier}-{direction}"))
    for name in ("one_segment", "all_singletons", "hub_run_2000"):
        cases.append(pytest.param(("edge", name), id=name))
    return cases


def _flags_for(spec) -> np.ndarray:
    if spec[0] == "layout":
        return _cascade_flags(spec[1])[spec[2]]
    return _edge_case_flags(spec[1])


@pytest.mark.parametrize("spec", _flag_cases())
def test_segscan_plain_matches_pallas(spec, monkeypatch):
    monkeypatch.setenv("SEGSCAN_INTERPRET", "1")
    flags = _flags_for(spec)
    x = np.random.default_rng(len(flags)).uniform(
        0.0, 1.0, len(flags)).astype(np.float32)
    xt, ft = torch.from_numpy(x), torch.from_numpy(flags)

    ref_max = np.asarray(ref_segscan.pallas_segscan_max(
        jnp.asarray(x), jnp.asarray(flags)))
    port_max = port_segscan.segscan_max(xt, ft).numpy()
    assert np.array_equal(port_max, ref_max)

    ref_sum = np.asarray(ref_segscan.pallas_segscan(
        jnp.asarray(x), jnp.asarray(flags)))
    port_sum = port_segscan.segscan_sum(xt, ft).numpy()
    np.testing.assert_allclose(port_sum, ref_sum, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [1, 2, 127, 1000, 1025])
def test_segscan_plain_matches_a_python_loop(n):
    """Any length (the TPU kernel took multiples of 128 only), checked
    against the obvious sequential definition."""
    rng = np.random.default_rng(n)
    x = rng.uniform(0.0, 1.0, n).astype(np.float32)
    flags = (rng.random(n) < 0.1).astype(np.float32)
    want_sum, want_max = np.zeros(n, np.float64), np.zeros(n, np.float32)
    for i in range(n):
        start = i == 0 or flags[i]
        want_sum[i] = x[i] + (0.0 if start else want_sum[i - 1])
        want_max[i] = x[i] if start else max(x[i], want_max[i - 1])
    xt, ft = torch.from_numpy(x), torch.from_numpy(flags)
    assert np.array_equal(port_segscan.segscan_max(xt, ft).numpy(), want_max)
    np.testing.assert_allclose(port_segscan.segscan_sum(xt, ft).numpy(),
                               want_sum, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bad", ["dtype", "shape", "device"])
def test_segscan_wrapper_rejects_bad_inputs(bad):
    x = torch.rand(256)
    flags = torch.zeros(256)
    if bad == "dtype":
        x, err = x.double(), TypeError
    elif bad == "shape":
        flags, err = flags[:-1], ValueError
    else:
        x, flags, err = x.to("meta"), flags.to("meta"), ValueError
    with pytest.raises(err):
        port_segscan.segscan_sum(x, flags)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["sum", "max"])
def test_segscan_kernel_matches_plain_on_card(op, cuda_device):
    flags = np.zeros(106496, np.float32)
    flags[np.sort(np.random.default_rng(7).choice(106496, 40000,
                                                  replace=False))] = 1.0
    flags[0] = 1.0
    x = np.random.default_rng(8).uniform(0, 1, 106496).astype(np.float32)
    xt = torch.from_numpy(x).to(cuda_device)
    ft = torch.from_numpy(flags).to(cuda_device)
    fn = port_segscan.segscan_sum if op == "sum" else port_segscan.segscan_max
    got = fn(xt, ft)
    want = port_segscan.segscan_plain(xt, ft, op)
    assert torch.equal(got, fn(xt, ft))
    if op == "max":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


# -- the host-side layout builders --------------------------------------------

@pytest.mark.parametrize("n,seed", [(50, 7), (700, 3), (2047, 0)])
def test_layout_builders_match_reference(n, seed):
    case = synthetic_cascade_arrays(n, n_roots=2, seed=seed)
    n_pad = {50: 64, 700: 1024, 2047: 2048}[n]
    e_pad = 4096 if n == 2047 else (128 if n == 50 else 2048)
    for name in ("build_down_seg", "build_up_seg"):
        ref = getattr(ref_segscan, name)(n_pad, e_pad, case.dep_src,
                                         case.dep_dst)
        port = getattr(port_segscan, name)(n_pad, e_pad, case.dep_src,
                                           case.dep_dst)
        for field in ref._fields:
            want = np.asarray(getattr(ref, field))
            got = getattr(port, field)
            assert got.dtype == want.dtype, (name, field)
            assert np.array_equal(got, want), (name, field)
    down, up = port_segscan.build_seg_layouts(n_pad, e_pad, case.dep_src,
                                              case.dep_dst)
    assert np.array_equal(down.flags, port_segscan.build_down_seg(
        n_pad, e_pad, case.dep_src, case.dep_dst).flags)
    moved = up.to("cpu")
    assert moved.other_sorted.dtype == torch.int64
    assert np.array_equal(moved.ends.numpy(), up.ends)


# -- the seg steps: CSR layout fields, plain versions, wrappers ----------------

def _layout_case(n):
    case = synthetic_cascade_arrays(n, n_roots=2, seed={50: 7, 700: 3,
                                                         2047: 0}[n])
    n_pad = {50: 64, 700: 1024, 2047: 2048}[n]
    e_pad = 4096 if n == 2047 else (128 if n == 50 else 2048)
    return case, n_pad, e_pad


@pytest.mark.parametrize("n", [50, 700, 2047])
def test_layout_csr_fields_and_length_bins(n):
    case, n_pad, e_pad = _layout_case(n)
    for name in ("build_down_seg", "build_up_seg"):
        seg = getattr(port_segscan, name)(n_pad, e_pad, case.dep_src,
                                          case.dep_dst)
        for field in ("offsets", "other32", "long_ids", "short_ids"):
            assert getattr(seg, field).dtype == np.int32, (name, field)
        offsets = seg.offsets.astype(np.int64)
        assert offsets.shape == (n_pad + 1,)
        assert offsets[0] == 0 and offsets[-1] == e_pad
        has = seg.has_edges > 0
        assert np.array_equal(offsets[1:][has] - 1, seg.ends[has])
        assert np.array_equal(np.diff(offsets) > 0, has)
        assert np.array_equal(seg.other32, seg.other_sorted)
        lengths = np.diff(offsets)
        ids = np.concatenate([seg.long_ids, seg.short_ids])
        assert np.array_equal(np.sort(ids), np.arange(n_pad)), name
        limit = port_segscan.SHORT_SEGMENT_MAX
        assert (lengths[seg.long_ids] > limit).all()
        assert (lengths[seg.short_ids] <= limit).all()
        # the dummy slot's padding run is binned by its length like any
        # other run
        assert (n_pad - 1 in seg.long_ids) == (lengths[-1] > limit)


def _step_layouts():
    """(id, n_pad, e_pad, seg_idx, other_idx) of the step tests: both
    directions of a 2047-service cascade, and a star whose one segment
    holds every edge (longer than a block of the kernel)."""
    case, n_pad, e_pad = _layout_case(2047)
    star_other = np.random.default_rng(12).integers(0, 2047, 4096)
    return {
        "down_2047": (n_pad, e_pad, case.dep_dst, case.dep_src),
        "up_2047": (n_pad, e_pad, case.dep_src, case.dep_dst),
        "star_4096": (2048, 4096, np.full(4096, 7, np.int32),
                      star_other.astype(np.int32)),
    }


def _step_inputs(n_pad, seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0.0, 1.0, n_pad).astype(np.float32)
            for _ in range(3)]


DECAY = 0.6


@pytest.mark.parametrize("layout", ["down_2047", "up_2047", "star_4096"])
def test_seg_step_plain_versions_match_reference(layout, monkeypatch):
    monkeypatch.setenv("SEGSCAN_INTERPRET", "1")
    n_pad, e_pad, seg_idx, other_idx = _step_layouts()[layout]
    ref_seg = ref_segscan.build_seg_layout(n_pad, e_pad, seg_idx, other_idx)
    seg = port_segscan.build_seg_layout(n_pad, e_pad, seg_idx,
                                        other_idx).to("cpu")
    x, y, inv_deg = _step_inputs(n_pad, e_pad + len(layout))
    xt, yt, dt = (torch.from_numpy(v) for v in (x, y, inv_deg))

    ref_up = ref_segscan.up_seg_step(jnp.asarray(x), jnp.asarray(y), DECAY,
                                     ref_seg)
    port_up = port_segscan.up_seg_step_plain(xt, yt, DECAY, seg)
    assert np.array_equal(port_up.numpy(), np.asarray(ref_up))

    ref_down = ref_segscan.down_seg_step(jnp.asarray(x), jnp.asarray(y),
                                         DECAY, ref_seg, jnp.asarray(inv_deg))
    port_down = port_segscan.down_seg_step_plain(xt, yt, DECAY, seg, dt)
    np.testing.assert_allclose(port_down.numpy(), np.asarray(ref_down),
                               rtol=1e-5, atol=1e-6)


def test_seg_step_wrappers_on_cpu_are_the_plain_versions_and_count_nothing():
    n_pad, e_pad, seg_idx, other_idx = _step_layouts()["down_2047"]
    seg = port_segscan.build_seg_layout(n_pad, e_pad, seg_idx,
                                        other_idx).to("cpu")
    u, h, inv_deg = (torch.from_numpy(v) for v in _step_inputs(n_pad, 5))
    before = dict(LAUNCHES)
    out = torch.empty(n_pad)
    got = port_segscan.up_seg_step(u, h, DECAY, seg, out=out)
    assert got is out
    assert torch.equal(got, port_segscan.up_seg_step_plain(u, h, DECAY, seg))
    down = port_segscan.down_seg_step(u, h, DECAY, seg, inv_deg)
    assert torch.equal(down, port_segscan.down_seg_step_plain(
        u, h, DECAY, seg, inv_deg))
    assert LAUNCHES == before


def _bad_step_call(bad):
    n_pad, e_pad, seg_idx, other_idx = _step_layouts()["up_2047"]
    host = port_segscan.build_seg_layout(n_pad, e_pad, seg_idx, other_idx)
    seg = host.to("cpu")
    u, h = (torch.from_numpy(v) for v in _step_inputs(n_pad, 6)[:2])
    out = None
    if bad == "dtype":
        h, err = h.double(), TypeError
    elif bad == "length":
        u, err = u[:-1].clone(), ValueError
    elif bad == "contiguity":
        h, err = torch.stack([h, h], dim=1)[:, 0], ValueError
    elif bad == "device":
        u, h, err = u.to("meta"), h.to("meta"), ValueError
    elif bad == "host_layout":
        seg, err = host, TypeError
    elif bad == "layout_device":
        seg, err = host.to("meta"), ValueError
    else:  # in place
        out, err = u, ValueError
    return lambda: port_segscan.up_seg_step(u, h, DECAY, seg, out=out), err


@pytest.mark.parametrize("bad", ["dtype", "length", "contiguity", "device",
                                 "host_layout", "layout_device", "in_place"])
def test_seg_step_wrappers_reject_bad_inputs(bad):
    call, err = _bad_step_call(bad)
    with pytest.raises(err):
        call()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["down_2047", "up_2047", "star_4096"])
def test_seg_step_kernels_match_plain_on_card(layout, cuda_device):
    n_pad, e_pad, seg_idx, other_idx = _step_layouts()[layout]
    seg = port_segscan.build_seg_layout(n_pad, e_pad, seg_idx,
                                        other_idx).to(cuda_device)
    x, y, inv_deg = (torch.from_numpy(v).to(cuda_device)
                     for v in _step_inputs(n_pad, 9))
    up = port_segscan.up_seg_step(x, y, DECAY, seg)
    assert torch.equal(up, port_segscan.up_seg_step(x, y, DECAY, seg))
    assert torch.equal(up, port_segscan.up_seg_step_plain(x, y, DECAY, seg))
    down = port_segscan.down_seg_step(x, y, DECAY, seg, inv_deg)
    assert torch.equal(down, port_segscan.down_seg_step(x, y, DECAY, seg,
                                                        inv_deg))
    torch.testing.assert_close(
        down, port_segscan.down_seg_step_plain(x, y, DECAY, seg, inv_deg),
        rtol=1e-5, atol=1e-6)
