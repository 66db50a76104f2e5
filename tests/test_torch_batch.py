"""The port's hypothesis batch against the JAX package's, and against itself.

- ``GraphEngine.analyze_batch`` lanes against the reference's
  ``analyze_batch`` on the same seeded features: ``u`` bitwise, scores
  within rtol 1e-5 / atol 1e-6, top-k identical with its tie order, and
  ``sanitized_rows`` counting across the batch;
- each port lane bitwise equal to a port solo analysis of its features,
  under both registry rows (``RCA_KERNEL=kernels`` runs the kernels' plain
  versions here);
- the batch delta (each lane the base buffer plus its own rows) bitwise
  equal to full staging, and its staging contract;
- each kernel's batched plain version equal to its solo plain version per
  lane, and the wrappers taking ``[B, n_pad]`` lanes beside ``[n_pad]``
  shared vectors;
- ``python -m rca_tpu_torch hypotheses`` against ``python -m rca_tpu
  hypotheses``: the same candidates in the same order, support within
  1e-4.

Card-only cases carry the ``cuda`` marker and skip here.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rca_tpu.cluster.fixtures import NS, five_service_world
from rca_tpu.cluster.generator import synthetic_cascade_arrays as ref_cascade
from rca_tpu.cluster.mock_client import MockClusterClient
from rca_tpu.cluster.snapshot import ClusterSnapshot
from rca_tpu.engine import GraphEngine as RefEngine
from rca_tpu.features.extract import extract_features
from rca_tpu.graph.build import service_dependency_edges
from rca_tpu_torch import GraphEngine
from rca_tpu_torch.engine import evidence as port_evidence
from rca_tpu_torch.engine import segscan as port_segscan
from rca_tpu_torch.engine.runner import (
    check_batch_delta,
    propagate_ranked,
    propagate_ranked_batch_delta,
)
from rca_tpu_torch.kernels import LAUNCHES

ROOT = Path(__file__).resolve().parent.parent
LANES = 4


def _five_service_input():
    snap = ClusterSnapshot.capture(MockClusterClient(five_service_world()),
                                   NS)
    fs = extract_features(snap)
    src, dst = service_dependency_edges(snap, fs)
    return (np.array(fs.service_features, np.float32), np.asarray(src),
            np.asarray(dst), list(fs.service_names))


def _cascade_input(n, roots, seed):
    case = ref_cascade(n, n_roots=roots, seed=seed)
    return case.features.copy(), case.dep_src, case.dep_dst, case.names


INPUTS = {
    "five_service_world": _five_service_input,
    "cascade_50": lambda: _cascade_input(50, 1, 7),
    "cascade_300": lambda: _cascade_input(300, 2, 5),
    "cascade_2047": lambda: _cascade_input(2047, 3, 0),
}


def _hypotheses(feats, seed, poison=False):
    """``LANES`` what-if feature sets: the base, two candidates muted, and
    a seeded rescale; with ``poison`` NaN/Inf rows in two lanes."""
    rng = np.random.default_rng(seed)
    batch = np.repeat(feats[None], LANES, axis=0)
    n = feats.shape[0]
    batch[1, 0] = 0.0
    batch[2, n // 2] = 0.0
    batch[3] = np.clip(batch[3] * rng.uniform(0.5, 1.5, feats.shape), 0, 1
                       ).astype(np.float32)
    if poison:
        batch[1, 1, 0] = np.nan
        batch[3, [2, n - 1], [4, 12]] = (np.inf, -np.inf)
    return batch


@pytest.fixture
def clean_env(monkeypatch):
    for name in ("RCA_KERNEL", "RCA_EDGE_LAYOUT", "RCA_WEIGHTS"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("RCA_KERNEL_CACHE", "off")


@pytest.mark.parametrize("poison", [False, True])
@pytest.mark.parametrize("name", list(INPUTS))
def test_batch_lanes_match_reference(name, poison, clean_env):
    feats, src, dst, names = INPUTS[name]()
    batch = _hypotheses(feats, 3, poison)
    k = min(feats.shape[0], 7)
    ref = RefEngine(resident=False).analyze_batch(batch, src, dst, names,
                                                  k=k)
    port = GraphEngine(device="cpu").analyze_batch(batch, src, dst, names,
                                                   k=k)
    assert len(port) == len(ref) == LANES
    for p, r in zip(port, ref):
        ps, rs = p.full_diagnostics(), r.full_diagnostics()
        assert np.array_equal(ps[1], rs[1]), "u is not bit-equal"
        np.testing.assert_allclose(ps[3], rs[3], rtol=1e-5, atol=1e-6)
        assert p.top_components() == r.top_components()
        assert p.sanitized_rows == r.sanitized_rows == (3 if poison else 0)
        assert p.engine == "single-batch"
        for pr, rr in zip(p.ranked, r.ranked):
            for key in ("score", "anomaly", "explained_by_upstream",
                        "downstream_impact"):
                assert pr[key] == pytest.approx(rr[key], rel=1e-5, abs=1e-6)


@pytest.mark.parametrize("row", ["torch", "kernels"])
@pytest.mark.parametrize("name", list(INPUTS))
def test_batch_lanes_are_bitwise_solo_runs(name, row, clean_env,
                                           monkeypatch):
    monkeypatch.setenv("RCA_KERNEL", row)
    feats, src, dst, names = INPUTS[name]()
    batch = _hypotheses(feats, 4, poison=True)
    engine = GraphEngine(device="cpu")
    lanes = engine.analyze_batch(batch, src, dst, names)
    for f, lane in zip(batch, lanes):
        solo = engine.analyze_arrays(f, src, dst, names)
        assert np.array_equal(lane.full_diagnostics(),
                              solo.full_diagnostics())
        assert lane.ranked == solo.ranked
    assert lanes[0].latency_ms > 0


def _delta_case(name, row, monkeypatch):
    monkeypatch.setenv("RCA_KERNEL", row)
    feats, src, dst, _ = INPUTS[name]()
    engine = GraphEngine(device="cpu")
    f, s, d = engine._pad(feats, src, dst)
    n_pad = f.shape[0]
    rng = np.random.default_rng(8)
    n = feats.shape[0]
    changes = min(3, n - 1)
    idx_b = np.full((LANES, changes + 2), n_pad - 1, np.int64)
    rows_b = np.zeros((LANES, changes + 2, f.shape[1]), np.float32)
    for lane in range(LANES):
        ids = rng.choice(n, size=changes - (lane % 2), replace=False)
        idx_b[lane, : len(ids)] = ids
        rows_b[lane, : len(ids)] = rng.uniform(0, 1, (len(ids), f.shape[1]))
    rows_b[2, 0, 3] = np.nan
    plan = engine.plan_for(n_pad, len(s), src, dst)
    return engine, f, d, n, idx_b, rows_b, plan


@pytest.mark.parametrize("row", ["torch", "kernels"])
@pytest.mark.parametrize("name", ["cascade_50", "cascade_2047"])
def test_batch_delta_is_bitwise_full_staging(name, row, clean_env,
                                             monkeypatch):
    engine, f, d, n, idx_b, rows_b, plan = _delta_case(name, row, monkeypatch)
    idx_c, rows_c = check_batch_delta(idx_b, rows_b, f.shape[0])
    dd = torch.from_numpy(d.astype(np.int64))
    kk = 13
    delta = propagate_ranked_batch_delta(
        engine.model, torch.from_numpy(f), torch.from_numpy(idx_c),
        torch.from_numpy(rows_c), dd, n, kk, plan)
    full_b = np.repeat(f[None], LANES, axis=0)
    for lane in range(LANES):
        full_b[lane, idx_b[lane]] = rows_b[lane]
    full = propagate_ranked(engine.model, torch.from_numpy(full_b), dd, n,
                            kk, plan)
    for got, want in zip(delta, full):
        assert torch.equal(got, want)
    assert int(delta[4]) == 1


@pytest.mark.parametrize("bad", ["repeat", "dummy_row", "range", "shape"])
def test_batch_delta_staging_contract(bad):
    idx = np.array([[3, 7, 63], [5, 63, 63]])
    rows = np.zeros((2, 3, 13), np.float32)
    rows[0, :2] = 1.0
    rows[1, 0] = 1.0
    check_batch_delta(idx, rows, 64)
    if bad == "repeat":
        idx[1, 1] = 5
    elif bad == "dummy_row":
        rows[1, 2, 0] = 0.5
    elif bad == "range":
        idx[0, 0] = 64
    else:
        rows = rows[:, :2]
    with pytest.raises(ValueError):
        check_batch_delta(idx, rows, 64)


def _lane_inputs(n=300, lanes=3, seed=2, device="cpu"):
    feats, src, dst, _ = _cascade_input(n, 2, 5)
    engine = GraphEngine(device="cpu")
    f, s, d = engine._pad(feats, src, dst)
    rng = np.random.default_rng(seed)
    fb = np.repeat(f[None], lanes, axis=0)
    fb[1:, :n] = rng.uniform(-0.2, 1.2, fb[1:, :n].shape)
    fb[2, 4, 1] = np.nan
    down, up = port_segscan.build_seg_layouts(f.shape[0], len(s), src, dst,
                                              device=device)
    aw, hw = (torch.from_numpy(w) for w in engine.params.weight_arrays())
    inv_deg = torch.from_numpy((1.0 / np.maximum(np.bincount(
        d, minlength=f.shape[0]), 1)).astype(np.float32))
    return (*(t.to(device) for t in (torch.from_numpy(fb), aw, hw)), down,
            up, inv_deg.to(device))


def test_batched_plain_versions_are_the_solo_ones_per_lane():
    fb, aw, hw, down, up, inv_deg = _lane_inputs()
    lanes = fb.shape[0]
    a_raw, h, e, n_bad = port_evidence.evidence_front_rows_plain(fb, aw, hw)
    assert int(n_bad) == 1 and a_raw.shape == (lanes, fb.shape[1])
    solo = [port_evidence.evidence_front_rows_plain(f, aw, hw) for f in fb]
    for name, got, idx in (("a_raw", a_raw, 0), ("h", h, 1), ("e", e, 2)):
        assert torch.equal(got, torch.stack([s[idx] for s in solo])), name
    a = port_evidence.seg_contrast_step_plain(a_raw, e, 0.7, up)
    u = port_segscan.up_seg_step_plain(a, h, 0.7, up)
    m = port_segscan.down_seg_step_plain(u, a, 0.7, down, inv_deg)
    for lane in range(lanes):
        a1 = port_evidence.seg_contrast_step_plain(a_raw[lane], e[lane], 0.7,
                                                   up)
        u1 = port_segscan.up_seg_step_plain(a1, h[lane], 0.7, up)
        m1 = port_segscan.down_seg_step_plain(u1, a1, 0.7, down, inv_deg)
        assert torch.equal(a[lane], a1)
        assert torch.equal(u[lane], u1)
        assert torch.equal(m[lane], m1)


def test_wrappers_take_lanes_on_cpu_and_count_nothing():
    fb, aw, hw, down, up, inv_deg = _lane_inputs()
    before = dict(LAUNCHES)
    got = port_evidence.evidence_front(fb, aw, hw, 0.7, up)
    want = port_evidence.evidence_front_plain(fb, aw, hw, 0.7, up)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    a, h, _ = got
    out = torch.empty_like(a)
    step = port_segscan.down_seg_step(a, h, 0.7, down, inv_deg, out=out)
    assert step is out
    assert torch.equal(out, port_segscan.down_seg_step_plain(a, h, 0.7, down,
                                                             inv_deg))
    assert torch.equal(port_segscan.up_seg_step(a, h, 0.7, up),
                       port_segscan.up_seg_step_plain(a, h, 0.7, up))
    assert LAUNCHES == before


@pytest.mark.parametrize("bad", ["shared_as_lanes", "lanes_mismatch",
                                 "three_dims"])
def test_wrappers_reject_bad_lanes(bad):
    fb, aw, hw, down, up, inv_deg = _lane_inputs()
    a, h, _ = port_evidence.evidence_front_plain(fb, aw, hw, 0.7, up)
    if bad == "shared_as_lanes":
        inv_deg = inv_deg.expand_as(a).contiguous()
    elif bad == "lanes_mismatch":
        h = h[:2].contiguous()
    else:
        a, h = a[None], h[None]
    with pytest.raises(ValueError):
        port_segscan.down_seg_step(a, h, 0.7, down, inv_deg)


def _cli(pkg, device_args):
    proc = subprocess.run(
        [sys.executable, "-m", pkg, "hypotheses", "--fixture", "50svc",
         "--seed", "7", "--compact", *device_args], cwd=str(ROOT),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout)


def test_hypotheses_command_matches_reference():
    port = _cli("rca_tpu_torch", ["--device", "cpu"])
    ref = _cli("rca_tpu", [])
    assert port["engine"] == "single-batch"
    assert (port["namespace"], port["batch_width"]) == (ref["namespace"],
                                                        ref["batch_width"])
    assert port["batch_width"] == 8
    assert ([h["candidate"] for h in port["hypotheses"]]
            == [h["candidate"] for h in ref["hypotheses"]])
    for p, r in zip(port["hypotheses"], ref["hypotheses"]):
        assert abs(p["support"] - r["support"]) <= 1e-4, r["candidate"]
        assert abs(p["base_score"] - r["base_score"]) <= 1e-4
        assert p["counterfactual_top"] == r["counterfactual_top"]
    assert port["hypotheses"][0]["candidate"] == "svc-00003"


@pytest.mark.cuda
def test_batched_kernels_match_their_plain_versions_on_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: python3 chip_smoke.py runs the batched "
                    "kernels on the card")
    fb, aw, hw, down, up, inv_deg = _lane_inputs(device="cuda")
    before = dict(LAUNCHES)
    got = port_evidence.evidence_front(fb, aw, hw, 0.7, up)
    want = port_evidence.evidence_front_plain(fb, aw, hw, 0.7, up)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    a, h, _ = got
    assert torch.equal(port_segscan.up_seg_step(a, h, 0.7, up),
                       port_segscan.up_seg_step_plain(a, h, 0.7, up))
    torch.testing.assert_close(
        port_segscan.down_seg_step(a, h, 0.7, down, inv_deg),
        port_segscan.down_seg_step_plain(a, h, 0.7, down, inv_deg),
        rtol=1e-5, atol=1e-6)
    assert (LAUNCHES["evidence_front_fused"]
            == before["evidence_front_fused"] + 1)
