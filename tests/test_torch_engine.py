"""The PyTorch port's one-shot engine against the JAX package's.

The same inputs (numpy, from seeds or from the JAX package's own feature
extractor) go through ``rca_tpu.engine.GraphEngine`` and
``rca_tpu_torch.GraphEngine(device="cpu")`` with the same weights, under
the reference's default plan and under its forced ``segscan`` plan.  The
contract: scores allclose at rtol 1e-5 / atol 1e-6 (sums are taken in
another order), the up-scan ``u`` bitwise (float32 max does not depend on
order), top-k identical with its tie order, ``sanitized_rows`` identical.
"""

import json

import numpy as np
import pytest
import torch

import jax

from rca_tpu.cluster.fixtures import NS, five_service_world
from rca_tpu.cluster.generator import synthetic_cascade_arrays as ref_cascade
from rca_tpu.cluster.mock_client import MockClusterClient
from rca_tpu.cluster.snapshot import ClusterSnapshot
from rca_tpu.coordinator import RCACoordinator
from rca_tpu.engine import GraphEngine as RefEngine
from rca_tpu.engine.propagate import (
    background_excess as ref_background_excess,
)
from rca_tpu.engine.propagate import propagate_core as ref_propagate_core
from rca_tpu.engine.segscan import build_down_seg as ref_build_down_seg
from rca_tpu.engine.segscan import build_up_seg as ref_build_up_seg
from rca_tpu.engine.train import PACKAGED_WEIGHTS as REF_WEIGHTS_FILE
from rca_tpu.engine.train import packaged_params as ref_packaged_params
from rca_tpu.features.extract import extract_features
from rca_tpu.graph.build import service_dependency_edges
from rca_tpu_torch import GraphEngine, params_from_jax
from rca_tpu_torch.cluster.generator import synthetic_cascade_arrays
from rca_tpu_torch.engine import params as port_params
from rca_tpu_torch.engine.propagate import (
    KernelPlan,
    background_excess,
    propagate_core,
)
from rca_tpu_torch.engine.segscan import build_seg_layouts
from rca_tpu_torch.engine.runner import top_k


def _port_params(ref):
    aw, hw = ref.weight_arrays()
    return params_from_jax(
        np.array(aw), np.array(hw), ref.steps, ref.decay,
        ref.explain_strength, ref.impact_bonus, ref.error_contrast,
    )


@pytest.fixture(scope="module")
def ref_params():
    return ref_packaged_params()


def _five_service_input():
    snap = ClusterSnapshot.capture(MockClusterClient(five_service_world()), NS)
    fs = extract_features(snap)
    src, dst = service_dependency_edges(snap, fs)
    return (np.array(fs.service_features, np.float32), np.asarray(src),
            np.asarray(dst), list(fs.service_names))


def _cascade_input(n, roots, seed, poison=False):
    case = ref_cascade(n, n_roots=roots, seed=seed)
    feats = case.features.copy()
    if poison:
        feats[[1, 17, 40], [0, 5, 12]] = (np.nan, np.inf, -np.inf)
    return feats, case.dep_src, case.dep_dst, case.names


INPUTS = {
    "five_service_world": _five_service_input,
    "cascade_50": lambda: _cascade_input(50, 1, 7),
    "cascade_2047": lambda: _cascade_input(2047, 3, 0),
    "cascade_2047_nan_inf": lambda: _cascade_input(2047, 3, 0, poison=True),
}


def _assert_matches(port, ref):
    ps, rs = port.full_diagnostics(), ref.full_diagnostics()
    assert ps.shape == rs.shape
    np.testing.assert_allclose(ps[3], rs[3], rtol=1e-5, atol=1e-6)
    assert np.array_equal(ps[1], rs[1]), "u is not bit-equal"
    assert port.top_components() == ref.top_components()
    assert port.sanitized_rows == ref.sanitized_rows
    for p, r in zip(port.ranked, ref.ranked):
        for key in ("score", "anomaly", "explained_by_upstream",
                    "downstream_impact"):
            assert p[key] == pytest.approx(r[key], rel=1e-5, abs=1e-6)


#: each reference plan beside the port's registry row that mirrors it: the
#: default ``xla`` body against the ``torch`` row, the ``segscan`` kernels
#: against the ``kernels`` row (their plain versions on the CPU)
PORT_ROW = {"default": "", "segscan": "kernels"}


@pytest.mark.parametrize("plan", ["default", "segscan"])
@pytest.mark.parametrize("name", list(INPUTS))
def test_port_engine_matches_reference(name, plan, ref_params, monkeypatch):
    monkeypatch.setenv("RCA_KERNEL_CACHE", "off")
    feats, src, dst, names = INPUTS[name]()
    n = feats.shape[0]
    port_engine = GraphEngine(params=_port_params(ref_params), device="cpu")
    ref_engine = RefEngine(params=ref_params, resident=False)
    for k in (None, min(n, 12)):
        monkeypatch.setenv("RCA_KERNEL", "" if plan == "default" else plan)
        ref = ref_engine.analyze_arrays(feats, src, dst, names, k=k)
        monkeypatch.setenv("RCA_KERNEL", PORT_ROW[plan])
        port = port_engine.analyze_arrays(feats, src, dst, names, k=k)
        _assert_matches(port, ref)
    if name.endswith("nan_inf"):
        assert port.sanitized_rows == 3


def test_median_is_the_midpoint_of_the_middle_pair():
    a = np.array([0.1, 0.4, 0.2, 0.9], np.float32)
    port = background_excess(torch.from_numpy(a), 4).numpy()
    ref = np.asarray(ref_background_excess(jax.numpy.asarray(a), 4))
    assert np.array_equal(port, ref)
    assert np.array_equal(port, np.maximum(a - np.float32(0.3), 0.0))


def test_background_excess_matches_reference_with_padding():
    a = np.random.default_rng(3).uniform(0, 1, 64).astype(np.float32)
    for n_live in (0, 1, 2, 37, 64):
        port = background_excess(torch.from_numpy(a), n_live)
        ref = ref_background_excess(jax.numpy.asarray(a), n_live)
        assert np.array_equal(port.numpy(), np.asarray(ref)), n_live


def test_top_k_breaks_ties_lowest_index_first():
    score = np.array([0.5, 0.7, 0.7, 0.2, 0.7], np.float32)
    vals, idx = top_k(torch.from_numpy(score), 3)
    ref_vals, ref_idx = jax.lax.top_k(jax.numpy.asarray(score), 3)
    assert idx.tolist() == [1, 2, 4] == np.asarray(ref_idx).tolist()
    assert np.array_equal(vals.numpy(), np.asarray(ref_vals))


def _ranked_causes(rec):
    corr = rec["results"]["correlated"]
    assert rec["status"] == "completed"
    assert corr["backend"] == "jax", corr.get("fallback_reason")
    assert "fallback_from" not in corr
    return corr


def test_coordinator_with_port_engine_matches_reference(fifty_svc_client,
                                                        ref_params):
    port = RCACoordinator(
        fifty_svc_client, backend="jax",
        engine=GraphEngine(params=_port_params(ref_params), device="cpu"),
    ).run_analysis("comprehensive", "synthetic")
    ref = RCACoordinator(
        fifty_svc_client, backend="jax",
        engine=RefEngine(params=ref_params, resident=False),
    ).run_analysis("comprehensive", "synthetic")
    pc, rc = _ranked_causes(port), _ranked_causes(ref)
    assert ([r["component"] for r in pc["root_causes"]]
            == [r["component"] for r in rc["root_causes"]])
    assert (json.dumps(pc["groups"], sort_keys=True, default=str)
            == json.dumps(rc["groups"], sort_keys=True, default=str))
    for p, r in zip(pc["root_causes"], rc["root_causes"]):
        for key, value in r.items():
            if isinstance(value, float):
                assert p[key] == pytest.approx(value, rel=1e-5, abs=1e-6), key
            else:
                assert p[key] == value, key


@pytest.mark.parametrize("n,roots,seed,kwargs", [
    (2047, 3, 0, {}),
    (500, 1, 3, {}),
    (300, 2, 5, {"mode": "adversarial", "fault_mix": "mixed"}),
    (300, 2, 9, {"mode": "overlapping_roots", "fault_mix": "oom"}),
])
def test_generator_copy_is_bitwise_equal(n, roots, seed, kwargs):
    port = synthetic_cascade_arrays(n, n_roots=roots, seed=seed, **kwargs)
    ref = ref_cascade(n, n_roots=roots, seed=seed, **kwargs)
    for field in ("n", "names", "root_kinds"):
        assert getattr(port, field) == getattr(ref, field), field
    for field in ("dep_src", "dep_dst", "features", "roots", "anomaly",
                  "decoys", "hops"):
        want, got = getattr(ref, field), getattr(port, field)
        if want is None:
            assert got is None, field
            continue
        assert got.dtype == want.dtype, field
        assert np.array_equal(got, want), field


def test_params_from_jax_round_trips(ref_params):
    port = _port_params(ref_params)
    for field in ("anomaly_weights", "hard_weights", "steps", "decay",
                  "explain_strength", "impact_bonus", "error_contrast"):
        assert getattr(port, field) == getattr(ref_params, field), field
    for got, want in zip(port.weight_arrays(), ref_params.weight_arrays()):
        assert got.dtype == np.float32
        assert np.array_equal(got, np.asarray(want))


def test_packaged_weights_are_the_reference_checkpoint(ref_params):
    assert (port_params.PACKAGED_WEIGHTS.read_bytes()
            == REF_WEIGHTS_FILE.read_bytes())
    assert port_params.packaged_params() == _port_params(ref_params)


def test_resolve_params_follows_rca_weights(ref_params, monkeypatch):
    from rca_tpu.config import RCAConfig as RefConfig
    from rca_tpu.engine.runner import resolve_params as ref_resolve
    from rca_tpu_torch.config import RCAConfig

    monkeypatch.delenv("RCA_WEIGHTS", raising=False)
    assert (port_params.resolve_params(RCAConfig(), None)
            == _port_params(ref_resolve(RefConfig(), None)))
    monkeypatch.setenv("RCA_WEIGHTS", "off")
    assert (port_params.resolve_params(RCAConfig(), None)
            == _port_params(ref_resolve(RefConfig(), None)))
    assert (port_params.resolve_params(RCAConfig(propagation_steps=4), None)
            .steps == 4)


def test_bucket_for_matches_reference():
    from rca_tpu.config import RCAConfig as RefConfig
    from rca_tpu.config import bucket_for as ref_bucket
    from rca_tpu_torch.config import RCAConfig, bucket_for

    buckets = RCAConfig().shape_buckets
    assert buckets == RefConfig().shape_buckets
    for n in (1, 5, 64, 65, 2048, 4097, 50000, 99867, 106497, 1 << 20):
        assert bucket_for(n, buckets) == ref_bucket(n, buckets)


def test_engine_result_diagnostics_are_lazy_and_attribution_is_cached():
    """The diagnostics and the attribution are lazy: neither is computed
    by the analysis; the attribution is cached for the default arguments,
    and a result that retained no inputs raises."""
    from rca_tpu_torch.engine.runner import render_result

    case = synthetic_cascade_arrays(60, n_roots=1, seed=2)
    res = GraphEngine(device="cpu").analyze_case(case)
    assert res._stacked is None
    assert res._provenance is None
    assert res.full_diagnostics().shape == (4, 64)
    assert res.score.shape == (60,) and res.anomaly.shape == (60,)
    block = res.attribution()
    assert block["attribution"]["k"] == len(res.ranked)
    assert res.attribution() is block
    assert res.attribution(paths=2) is not block
    bare = render_result(np.zeros((4, 1), np.float32), [1.0], [0], None, 1,
                         1, 0.0, 0, "single")
    with pytest.raises(ValueError):
        bare.attribution()


def test_analyze_batch_is_the_loop_of_single_analyses():
    case = synthetic_cascade_arrays(80, n_roots=1, seed=4)
    engine = GraphEngine(device="cpu")
    batch = np.stack([case.features, np.clip(case.features * 1.5, 0, 1)])
    out = engine.analyze_batch(batch, case.dep_src, case.dep_dst, case.names)
    for feats, res in zip(batch, out):
        solo = engine.analyze_arrays(feats, case.dep_src, case.dep_dst,
                                     case.names)
        assert np.array_equal(res.full_diagnostics(), solo.full_diagnostics())


@pytest.mark.parametrize("steps", [1, 2, 8])
def test_propagate_core_matches_reference_over_seg_layouts(steps,
                                                          monkeypatch):
    """The core's steps, which alternate between two output buffers, give
    the reference core's ``u`` bit for bit and its ``m`` and scores
    within the contract, over the same seg layouts."""
    monkeypatch.setenv("SEGSCAN_INTERPRET", "1")
    case = ref_cascade(700, n_roots=2, seed=3)
    n_pad, e_pad = 1024, 2048
    dummy = n_pad - 1
    src = np.full(e_pad, dummy, np.int32)
    dst = np.full(e_pad, dummy, np.int32)
    src[: len(case.dep_src)] = case.dep_src
    dst[: len(case.dep_dst)] = case.dep_dst
    rng = np.random.default_rng(steps)
    a, h = (rng.uniform(0.0, 1.0, n_pad).astype(np.float32)
            for _ in range(2))
    a[case.n:] = h[case.n:] = 0.0
    args = (steps, 0.6, 0.7, 0.5, case.n)

    down, up = build_seg_layouts(n_pad, e_pad, case.dep_src, case.dep_dst,
                                 device="cpu")
    port = propagate_core(torch.from_numpy(a), torch.from_numpy(h),
                          torch.from_numpy(dst.astype(np.int64)), *args,
                          KernelPlan("kernels", down, up))
    ref = ref_propagate_core(
        jax.numpy.asarray(a), jax.numpy.asarray(h), jax.numpy.asarray(src),
        jax.numpy.asarray(dst), *args,
        down_seg=ref_build_down_seg(n_pad, e_pad, case.dep_src,
                                    case.dep_dst),
        up_seg=ref_build_up_seg(n_pad, e_pad, case.dep_src, case.dep_dst),
    )
    assert np.array_equal(port[2].numpy(), np.asarray(ref[2]))
    for i in (3, 4):
        np.testing.assert_allclose(port[i].numpy(), np.asarray(ref[i]),
                                   rtol=1e-5, atol=1e-6)
