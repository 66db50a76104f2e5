"""The port's quantized and doubling registry rows against the JAX
package's.

- quantized: ``quantize_rows`` byte-equal (all-zero rows included, per
  lane), ``dequant_gather`` and ``quant_up_step`` bitwise,
  ``quant_imp_step`` at rtol 1e-5 / atol 1e-6, ``noisy_or_pair_bf16``
  bitwise the reference's compiled executable (and within one bf16 step,
  2**-7, of the reference run op by op), and the engine's quantized
  ranking in rank parity with the reference's quantized ranking and with
  the port's float32 one over update / delete / NaN sequences;
- doubling: ``build_doubling`` byte-equal, ``u`` bitwise the reference's
  doubling and the port's serial chain, ``m`` and the score at rtol 1e-5
  / atol 1e-6, top-k identical; the non-power-of-two decline, the
  frontier-cap fallback to the CPU's default row, and ``analyze_case``
  under ``RCA_KERNEL=doubling`` against the reference's;
- every staging surface (one-shot, resident, batch, streaming) takes the
  new rows through the kernel plan;
- the registry: the new rows' eligibility reasons equal the reference's
  for the ``dense``, ``attribution`` and ``sharded`` variants, forcing
  each row, the card's race timing only ``torch`` and ``kernels``, and
  ``kernels --explain`` listing the four rows.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rca_tpu.cluster.generator import synthetic_cascade_arrays as ref_cascade
from rca_tpu.engine import doubling as ref_doubling
from rca_tpu.engine import quantized as ref_quant
from rca_tpu.engine import registry as ref_registry
from rca_tpu.engine.propagate import _noisy_or as ref_noisy_or
from rca_tpu.engine.propagate import default_params as ref_default_params
from rca_tpu.engine.propagate import propagate_core as ref_propagate_core
from rca_tpu.engine.runner import GraphEngine as RefEngine
from rca_tpu_torch import GraphEngine
from rca_tpu_torch.config import RCAConfig, bucket_for
from rca_tpu_torch.engine import doubling as port_doubling
from rca_tpu_torch.engine import quantized as port_quant
from rca_tpu_torch.engine import registry
from rca_tpu_torch.engine.ell import up_ell_for
from rca_tpu_torch.engine.propagate import KernelPlan, propagate_core
from rca_tpu_torch.engine.runner import kernel_plan
from rca_tpu_torch.engine.segscan import build_seg_layouts
from rca_tpu_torch.engine.streaming import StreamingSession

ROOT = Path(__file__).resolve().parent.parent
DECAY = 0.7


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """Clean registries in both packages, no cache file, no forced row."""
    monkeypatch.delenv("RCA_KERNEL", raising=False)
    monkeypatch.setenv("RCA_KERNEL_CACHE", "0")
    registry.reset_registry()
    ref_registry.reset_registry()
    yield
    registry.reset_registry()
    ref_registry.reset_registry()


def _padded(n, seed=3, n_roots=2):
    """A cascade and its engine padding: ``(case, n_pad, e_pad, src, dst)``
    with the padded edge arrays (int32, dummy self-loops)."""
    c = ref_cascade(n, n_roots=n_roots, seed=seed)
    buckets = RCAConfig().shape_buckets
    n_pad = bucket_for(n + 1, buckets)
    e_pad = bucket_for(len(c.dep_src), buckets)
    s = np.full(e_pad, n_pad - 1, np.int32)
    d = np.full(e_pad, n_pad - 1, np.int32)
    s[: len(c.dep_src)] = c.dep_src
    d[: len(c.dep_dst)] = c.dep_dst
    return c, n_pad, e_pad, s, d


def _signal(n, seed, zero_rows=(), lanes=None):
    rng = np.random.default_rng(seed)
    shape = (n,) if lanes is None else (lanes, n)
    x = rng.uniform(0.0, 3.0, shape).astype(np.float32)
    row = min(128, n)
    for r in zero_rows:
        x[..., r * row:(r + 1) * row] = 0.0
    return x


# -- quantized ----------------------------------------------------------------

@pytest.mark.parametrize("n,zero_rows", [(128, (0,)), (1024, (0, 3, 7)),
                                         (2048, (5, 15))])
def test_quantize_rows_byte_equal_reference(n, zero_rows):
    x = _signal(n, n, zero_rows)
    q_ref, s_ref = ref_quant.quantize_rows(jnp.asarray(x))
    q, s = port_quant.quantize_rows(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.numpy().tobytes() == np.asarray(q_ref).tobytes()
    assert s.numpy().tobytes() == np.asarray(s_ref).tobytes()
    for r in zero_rows:
        assert s[r] == 1.0
    # lanes: each lane's rows quantized on their own
    lanes = _signal(n, n + 1, zero_rows, lanes=3)
    ql, sl = port_quant.quantize_rows(torch.from_numpy(lanes))
    for b in range(3):
        qr, sr = ref_quant.quantize_rows(jnp.asarray(lanes[b]))
        assert ql[b].numpy().tobytes() == np.asarray(qr).tobytes()
        assert sl[b].numpy().tobytes() == np.asarray(sr).tobytes()


@pytest.mark.parametrize("n", [50, 300, 2047])
def test_dequant_gather_and_quant_up_step_bitwise(n):
    c, n_pad, e_pad, s, d = _padded(n)
    rng = np.random.default_rng(n)
    u = rng.uniform(0, 1.5, n_pad).astype(np.float32)
    h = rng.uniform(0, 1, n_pad).astype(np.float32)
    u[-1] = h[-1] = 0.0
    q, scale = ref_quant.quantize_rows(jnp.asarray(h))
    qt, st = port_quant.quantize_rows(torch.from_numpy(h))
    got = port_quant.dequant_gather(qt, st, torch.from_numpy(d.astype(
        np.int64)))
    want = ref_quant.dequant_gather(q, scale, jnp.asarray(d))
    assert np.array_equal(got.numpy(), np.asarray(want))
    want = ref_quant.quant_up_step(jnp.asarray(u), jnp.asarray(h), DECAY,
                                   jnp.asarray(s), jnp.asarray(d))
    _, up = build_seg_layouts(n_pad, e_pad, c.dep_src, c.dep_dst,
                              device="cpu")
    from rca_tpu_torch.engine.evidence import segment_sources

    got = port_quant.quant_up_step(torch.from_numpy(u), torch.from_numpy(h),
                                   DECAY, segment_sources(up),
                                   up.other_sorted)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [50, 300, 2047])
def test_quant_imp_step_matches_reference(n):
    c, n_pad, e_pad, s, d = _padded(n)
    rng = np.random.default_rng(n + 7)
    m = rng.uniform(0, 2, n_pad).astype(np.float32)
    a_ex = rng.uniform(0, 1, n_pad).astype(np.float32)
    m[-1] = a_ex[-1] = 0.0
    deg = np.bincount(d, minlength=n_pad).astype(np.float32)
    inv_deg = (1.0 / np.maximum(deg, 1.0)).astype(np.float32)
    want = ref_quant.quant_imp_step(jnp.asarray(m), jnp.asarray(a_ex), DECAY,
                                    jnp.asarray(s), jnp.asarray(d),
                                    jnp.asarray(inv_deg))
    down, _ = build_seg_layouts(n_pad, e_pad, c.dep_src, c.dep_dst,
                                device="cpu")
    got = port_quant.quant_imp_step(torch.from_numpy(m),
                                    torch.from_numpy(a_ex), DECAY, down,
                                    torch.from_numpy(inv_deg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("weights", ["packaged", "random"])
def test_noisy_or_pair_bf16_bitwise_compiled_reference(weights):
    """Bitwise equal to the reference's COMPILED pair (the form its engine
    runs); the reference run op by op rounds every step to bf16 and lands
    at most one bf16 step (2**-7) away (0.0078125 measured)."""
    rng = np.random.default_rng(11)
    f = rng.uniform(-0.2, 1.2, (4096, 13)).astype(np.float32)
    f[rng.random(f.shape) < 0.4] = 0.0
    if weights == "packaged":
        aw, hw = (np.array(w) for w in ref_default_params().weight_arrays())
    else:
        aw, hw = rng.uniform(0, 1, (2, 13)).astype(np.float32)
    a, h = port_quant.noisy_or_pair_bf16(
        torch.from_numpy(f), torch.from_numpy(aw), torch.from_numpy(hw))
    ra, rh = jax.jit(ref_quant.noisy_or_pair_bf16)(
        jnp.asarray(f), jnp.asarray(aw), jnp.asarray(hw))
    assert np.array_equal(a.numpy(), np.asarray(ra))
    assert np.array_equal(h.numpy(), np.asarray(rh))
    ea, eh = ref_quant.noisy_or_pair_bf16(jnp.asarray(f), jnp.asarray(aw),
                                          jnp.asarray(hw))
    assert np.abs(a.numpy() - np.asarray(ea)).max() <= 2.0 ** -7
    assert np.abs(h.numpy() - np.asarray(eh)).max() <= 2.0 ** -7


def _ref_engine(monkeypatch, kernel=None):
    if kernel is None:
        monkeypatch.delenv("RCA_KERNEL", raising=False)
    else:
        monkeypatch.setenv("RCA_KERNEL", kernel)
    return RefEngine()


@pytest.mark.parametrize("n", [48, 200, 600])
def test_quantized_rank_parity_over_update_delete_nan_sequences(
        monkeypatch, n):
    """The reference's landing gate of the row (its test of the same
    name), held on the port: over random update / delete / NaN sequences
    the port's quantized ranking keeps rank parity with the reference's
    quantized ranking and with the port's float32 ranking (hit@1 equal,
    hit@3 on the roots equal, the tie-aware tau over the top 25 >=
    0.99), with the same sanitized rows."""
    c = ref_cascade(n, n_roots=2, seed=11)
    root_names = {c.names[i] for i in c.roots.tolist()}
    f32 = GraphEngine(device="cpu")
    quant = GraphEngine(device="cpu")
    ref_q = _ref_engine(monkeypatch, "quantized")
    rng = np.random.default_rng(5)
    feats = c.features.copy()
    taus = []
    for step in range(6):
        monkeypatch.setenv("RCA_KERNEL", "quantized")
        q_res = quant.analyze_arrays(feats, c.dep_src, c.dep_dst, c.names,
                                     k=5)
        r_res = ref_q.analyze_arrays(feats, c.dep_src, c.dep_dst, c.names,
                                     k=5)
        monkeypatch.delenv("RCA_KERNEL")
        f_res = f32.analyze_arrays(feats, c.dep_src, c.dep_dst, c.names,
                                   k=5)
        assert port_quant.rank_parity(r_res.ranked, q_res.ranked)["ok"], (
            n, step)
        assert port_quant.topk_score_tau(r_res.score, q_res.score) == 1.0
        rep = port_quant.rank_parity(f_res.ranked, q_res.ranked)
        assert rep["hit1_equal"], (n, step, rep)
        f_top, q_top = f_res.top_components(), q_res.top_components()
        assert (f_top[0] in root_names) == (q_top[0] in root_names)
        assert (bool(root_names & set(f_top[:3]))
                == bool(root_names & set(q_top[:3])))
        taus.append(port_quant.topk_score_tau(f_res.score, q_res.score))
        assert q_res.sanitized_rows == f_res.sanitized_rows \
            == r_res.sanitized_rows
        for i in rng.integers(0, n, 4):
            feats[i] = np.clip(
                feats[i] + rng.uniform(-0.3, 0.3, feats.shape[1]), 0, 1
            ).astype(np.float32)
        feats[int(rng.integers(0, n))] = 0.0
        feats[int(rng.integers(0, n)), 0] = np.nan
    assert min(taus) >= 0.99, taus


def test_rank_parity_helpers_match_reference():
    for a, b in ((list("abcde"), list("abcde")), (list("abc"), list("cba")),
                 (list("abcde"), list("abced")), (list("abcde"),
                                                  list("bacde"))):
        assert port_quant.kendall_tau(a, b) == ref_quant.kendall_tau(a, b)
        assert port_quant.rank_parity(a, b) == ref_quant.rank_parity(a, b)
    rng = np.random.default_rng(2)
    s1 = rng.uniform(0, 1, 200)
    s2 = s1 + rng.normal(0, 0.01, 200)
    assert port_quant.topk_score_tau(s1, s2) == ref_quant.topk_score_tau(
        s1, s2)


# -- doubling -----------------------------------------------------------------

CASES = [(180, 8), (700, 8), (120, 4), (90, 2)]


@pytest.mark.parametrize("n,steps", CASES)
def test_build_doubling_layouts_byte_equal_reference(n, steps):
    c, n_pad, e_pad, _, _ = _padded(n)
    want = ref_doubling.build_doubling(n_pad, e_pad, c.dep_src, c.dep_dst,
                                       steps)
    got = port_doubling.build_doubling(n_pad, e_pad, c.dep_src, c.dep_dst,
                                       steps)
    assert want is not None and got is not None
    for field in ("up_src", "up_dst", "dn_src", "dn_dst", "dn_w"):
        ours, theirs = getattr(got, field), getattr(want, field)
        assert len(ours) == len(theirs) == steps.bit_length() - 1
        for o, t in zip(ours, theirs):
            assert o.dtype == np.asarray(t).dtype
            assert o.tobytes() == np.asarray(t).tobytes(), field


@pytest.mark.parametrize("n,steps", CASES)
def test_doubling_matches_reference_and_the_serial_chain(n, steps):
    """``u`` bitwise the reference's doubling and the port's serial chain,
    ``m`` and the score at rtol 1e-5 / atol 1e-6, top-k identical."""
    c, n_pad, e_pad, s, d = _padded(n)
    aw, hw = ref_default_params().weight_arrays()
    f = np.zeros((n_pad, c.features.shape[1]), np.float32)
    f[:n] = c.features
    a = ref_noisy_or(jnp.asarray(f), aw)
    h = ref_noisy_or(jnp.asarray(f), hw)
    args = (a, h, jnp.asarray(s), jnp.asarray(d), steps, DECAY, 0.85, 1.6)
    want = ref_propagate_core(
        *args, dbl=ref_doubling.build_doubling(n_pad, e_pad, c.dep_src,
                                               c.dep_dst, steps))
    down, up = build_seg_layouts(n_pad, e_pad, c.dep_src, c.dep_dst,
                                 device="cpu")
    dbl = port_doubling.doubling_layouts_for(n_pad, e_pad, c.dep_src,
                                             c.dep_dst, steps, device="cpu")
    at, ht = torch.from_numpy(np.array(a)), torch.from_numpy(np.array(h))
    dd = torch.from_numpy(d.astype(np.int64))
    got = propagate_core(at, ht, dd, steps, DECAY, 0.85, 1.6, None,
                         KernelPlan("doubling", down, up, dbl=dbl))
    serial = propagate_core(at, ht, dd, steps, DECAY, 0.85, 1.6, None,
                            KernelPlan("torch", down, up, up_ell_for(
                                n_pad, c.dep_src, c.dep_dst, "cpu")))
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    assert torch.equal(got[2], serial[2])
    for i in (3, 4):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got[i].numpy(), serial[i].numpy(),
                                   rtol=1e-5, atol=1e-6)
    top = torch.sort(got[4], descending=True, stable=True).indices[:5]
    assert top.tolist() == np.argsort(-np.asarray(want[4]),
                                      kind="stable")[:5].tolist()
    assert top.tolist() == torch.sort(serial[4], descending=True,
                                      stable=True).indices[:5].tolist()


def test_doubling_declines_non_power_of_two_depth():
    assert port_doubling.doubling_eligible(8)
    assert port_doubling.doubling_eligible(2)
    assert not port_doubling.doubling_eligible(6)
    assert not port_doubling.doubling_eligible(1)
    c = ref_cascade(60, n_roots=1, seed=0)
    assert port_doubling.build_doubling(64, 128, c.dep_src, c.dep_dst,
                                        6) is None


def test_doubling_frontier_cap_falls_back_to_the_default_row(monkeypatch):
    """A graph whose frontiers pass the cap runs the device's default row
    (``torch`` on the CPU), and the PLAN says so; the engine still
    answers as the ``torch`` row does."""
    monkeypatch.setenv("RCA_KERNEL", "doubling")
    monkeypatch.setattr(port_doubling, "MAX_FRONTIER_MULT", 0)
    port_doubling._DOUBLING_CACHE.clear()
    try:
        c = ref_cascade(100, n_roots=1, seed=1)
        plan = kernel_plan(128, 256, c.dep_src, c.dep_dst, "cpu", steps=8)
        assert plan.kernel == "torch" and plan.dbl is None
        assert plan.up_ell is not None
        assert registry.engaged_kernel(128, 256, device="cpu") == "doubling"
        got = GraphEngine(device="cpu").analyze_case(c, k=3)
        monkeypatch.setenv("RCA_KERNEL", "torch")
        want = GraphEngine(device="cpu").analyze_case(c, k=3)
        assert np.array_equal(got.full_diagnostics(),
                              want.full_diagnostics())
    finally:
        port_doubling._DOUBLING_CACHE.clear()


@pytest.mark.parametrize("seed", [17, 4])
def test_doubling_engine_matches_reference(monkeypatch, seed):
    c = ref_cascade(400, n_roots=3, seed=seed)
    want = _ref_engine(monkeypatch, "doubling").analyze_case(c, k=5)
    got = GraphEngine(device="cpu").analyze_case(c, k=5)
    assert GraphEngine(device="cpu").plan_for(
        512, 1024, c.dep_src, c.dep_dst).kernel == "doubling"
    assert np.array_equal(got.upstream, want.upstream)
    np.testing.assert_allclose(got.impact, want.impact, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.score, want.score, rtol=1e-5, atol=1e-6)
    assert got.top_components() == want.top_components()
    monkeypatch.delenv("RCA_KERNEL")
    serial = GraphEngine(device="cpu").analyze_case(c, k=5)
    assert np.array_equal(got.upstream, serial.upstream)
    assert got.top_components() == serial.top_components()


# -- the staging surfaces take the new rows through the plan ------------------

@pytest.mark.parametrize("row", ["quantized", "doubling"])
def test_batch_resident_and_stream_run_the_forced_row(monkeypatch, row):
    """``analyze_batch`` lanes, resident repeat requests and streaming
    ticks on the forced row, each bitwise equal to a restaged solo
    analysis on the same row."""
    monkeypatch.setenv("RCA_KERNEL", row)
    c = ref_cascade(300, n_roots=2, seed=9)
    solo = GraphEngine(device="cpu", resident=False)
    feats = [c.features.copy() for _ in range(3)]
    feats[1][4] = np.clip(feats[1][4] + 0.4, 0, 1)
    feats[2][7, 0] = np.nan
    want = [solo.analyze_arrays(f, c.dep_src, c.dep_dst, c.names)
            for f in feats]
    lanes = solo.analyze_batch(np.stack(feats), c.dep_src, c.dep_dst,
                               c.names)
    resident = GraphEngine(device="cpu")
    for w, lane, f in zip(want, lanes, feats):
        res = resident.analyze_arrays(f, c.dep_src, c.dep_dst, c.names)
        for got in (lane, res):
            assert np.array_equal(got.full_diagnostics(),
                                  w.full_diagnostics())
            assert got.top_components() == w.top_components()
    sess = resident._resident_cache.stats()
    assert sess["sessions"] == 1
    stream = StreamingSession(c.names, c.dep_src, c.dep_dst,
                              num_features=13, engine=solo, k=5)
    assert stream.kernel_path == row
    stream.set_all(feats[0])
    ticks = [stream.tick()]
    stream.update(4, feats[1][4])
    ticks.append(stream.tick())
    for tick, w in zip(ticks, want[:2]):
        assert [r["component"] for r in tick["ranked"]] \
            == w.top_components()
        assert [r["score"] for r in tick["ranked"]] \
            == [r["score"] for r in w.ranked]


# -- the registry -------------------------------------------------------------

@pytest.mark.parametrize("variant,e_pad,steps", [
    ("dense", 1024, 8), ("dense", 1024, 6), ("dense", None, 8),
    ("attribution", 1024, 8), ("sharded", 1024, 8), ("sharded", None, 6),
])
def test_new_rows_eligibility_matches_reference(variant, e_pad, steps):
    row = registry.get_registry().resolve(512, e_pad, steps=steps,
                                          variant=variant, device="cpu")
    want = ref_registry._eligibility(variant, 512, e_pad, steps)
    assert row.eligible["torch"] is want["xla"] is True
    for name in ("quantized", "doubling"):
        assert row.eligible[name] == want[name], name
    assert set(row.eligible) == set(registry.KERNELS)


@pytest.mark.parametrize("row", ["torch", "kernels", "quantized",
                                 "doubling"])
def test_forcing_engages_each_row(monkeypatch, row):
    monkeypatch.setenv("RCA_KERNEL", row)
    reg = registry.get_registry()
    dense = reg.resolve(512, 1024, device="cpu")
    assert (dense.winner, dense.source) == (row, "forced")
    c = ref_cascade(300, n_roots=2, seed=2)
    plan = kernel_plan(512, 1024, c.dep_src, c.dep_dst, "cpu")
    assert plan.kernel == row
    assert (plan.dbl is not None) == (row == "doubling")
    assert (plan.up_ell is not None) == (row == "torch")
    assert GraphEngine(device="cpu").analyze_case(c, k=3).ranked
    attribution = reg.resolve(512, 1024, variant="attribution",
                              device="cpu")
    assert (attribution.winner, attribution.source) == ("torch",
                                                        "attribution")
    sharded = reg.resolve(512, 128, variant="sharded", device="cpu")
    if row in ("quantized", "doubling"):
        # no sharded form: the CPU's default row, and the source says why
        assert (sharded.winner, sharded.source) == ("torch", "ineligible")
    else:
        assert (sharded.winner, sharded.source) == (row, "forced")


def test_forced_row_that_the_shape_declines_runs_the_default(monkeypatch):
    monkeypatch.setenv("RCA_KERNEL", "doubling")
    row = registry.get_registry().resolve(512, 1024, steps=6, device="cpu")
    assert (row.winner, row.source) == ("torch", "ineligible")
    assert "power of two" in row.eligible["doubling"]


class _Card:
    """The card's race with fed timings: the device is ``cuda`` by name
    only, and nothing launches."""

    def __init__(self, monkeypatch):
        self.candidates = []

        def fake_time(n_pad, e_pad, steps, candidates, device):
            self.candidates.append(list(candidates))
            return {"torch": 1.0, "kernels": 0.2}

        monkeypatch.setattr(registry, "_time_candidates", fake_time)
        monkeypatch.setattr(registry, "_device_name",
                            lambda dev: "NVIDIA H100 80GB HBM3")


def test_card_race_times_only_torch_and_kernels(monkeypatch):
    card = _Card(monkeypatch)
    row = registry.KernelRegistry().resolve(2048, 4096, device="cuda")
    assert (row.winner, row.source) == ("kernels", "timed")
    assert card.candidates == [["torch", "kernels"]]
    for name in ("quantized", "doubling"):
        assert row.eligible[name] == registry.CARD_OPT_IN
    # a structural reason comes before the opt-in one
    row6 = registry.KernelRegistry().resolve(2048, 4096, steps=6,
                                             device="cuda")
    assert "power of two" in row6.eligible["doubling"]
    assert row6.eligible["quantized"] == registry.CARD_OPT_IN
    assert card.candidates == [["torch", "kernels"]] * 2
    # forcing a new row on the card engages it without a race
    for name in ("quantized", "doubling"):
        monkeypatch.setenv("RCA_KERNEL", name)
        forced = registry.KernelRegistry().resolve(2048, 4096,
                                                   device="cuda")
        assert (forced.winner, forced.source) == (name, "forced")
    monkeypatch.setenv("RCA_KERNEL", "doubling")
    declined = registry.KernelRegistry().resolve(2048, 4096, steps=6,
                                                 device="cuda")
    assert (declined.winner, declined.source) == ("kernels", "ineligible")
    sharded = registry.KernelRegistry().resolve(2048, 1024,
                                                variant="sharded",
                                                device="cuda")
    assert (sharded.winner, sharded.source) == ("kernels", "ineligible")
    assert card.candidates == [["torch", "kernels"]] * 2


def test_kernels_explain_lists_the_four_rows():
    proc = subprocess.run(
        [sys.executable, "-m", "rca_tpu_torch", "kernels", "--device", "cpu",
         "--services", "500", "--sp", "4", "--explain"], cwd=str(ROOT),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    for name in registry.KERNELS:
        assert f"\n  {name} " in out
    assert "quantized ineligible: int8 messages are not differentiable" \
        in out
    assert ("doubling ineligible: frontier layouts have no per-row "
            "counterfactual twin") in out
    assert "doubling ineligible: no shard_map twin" in out
    assert "quantized not raced (decision source: cpu-default)" in out
