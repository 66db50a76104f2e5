"""The port's ``RCA_EDGE_LAYOUT`` (``hybrid`` / ``coo`` / ``ell``) against
the JAX package's.

- :class:`EllGraph` tables are byte-equal to the reference's;
- :func:`propagate_ell` is held to the reference's at width caps 32, 2 and
  1 (scores and ``u`` at atol 1e-6, ``m`` at 1e-5, the reference's own
  layout tolerance), and its sums are the same bits on every run;
- the three layouts through ``GraphEngine.analyze_arrays`` on the ``torch``
  and ``kernels`` rows (the kernels' plain versions on the CPU): ``coo``
  bitwise ``hybrid``, ``ell`` within 1e-6 with the top-k identical, each
  bitwise itself over two runs, and each within the engine contract of the
  reference's engine under the same layout;
- an ``ell`` batch equals its solo runs and bypasses the resident path;
  a ``coo`` resident request, streaming tick, serve batch and attribution
  equal their ``hybrid`` counterparts;
- the registry keys rows by the layout and gives the reference's reasons;
- a typo'd layout raises.
"""

import numpy as np
import pytest
import torch

from rca_tpu.cluster.generator import synthetic_cascade_arrays as ref_cascade
from rca_tpu.engine import GraphEngine as RefEngine
from rca_tpu.engine.ell import EllGraph as RefEllGraph
from rca_tpu.engine.ell import propagate_ell as ref_propagate_ell
from rca_tpu.engine.registry import _eligibility as ref_eligibility
from rca_tpu_torch import GraphEngine
from rca_tpu_torch.config import edge_layout
from rca_tpu_torch.engine.ell import EllGraph, propagate_ell
from rca_tpu_torch.engine.params import default_params
from rca_tpu_torch.engine.registry import get_registry, reset_registry

LAYOUTS = ("hybrid", "coo", "ell")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for name in ("RCA_KERNEL", "RCA_EDGE_LAYOUT", "RCA_WEIGHTS",
                 "RCA_EXPLAIN", "RCA_RESIDENT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("RCA_KERNEL_CACHE", "off")
    reset_registry()
    yield
    reset_registry()


def _case(n, roots, seed, poison=False):
    case = ref_cascade(n, n_roots=roots, seed=seed)
    feats = case.features.copy()
    if poison:
        feats[[1, 17, 40], [0, 5, 12]] = (np.nan, np.inf, -np.inf)
    return feats, case.dep_src, case.dep_dst, case.names


def _hub_graph(n=300, hub_fan_in=120, seed=2):
    """A star of dependents onto one hub (a long overflow run at cap 32)
    beside a random sparse graph."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([np.arange(1, hub_fan_in + 1),
                          rng.integers(0, n, 400)]).astype(np.int32)
    dst = np.concatenate([np.zeros(hub_fan_in, np.int64),
                          rng.integers(0, n, 400)]).astype(np.int32)
    keep = src != dst
    feats = rng.uniform(0, 1, (n, 13)).astype(np.float32)
    feats[rng.random(n) < 0.7] *= 0.05
    return feats, src[keep], dst[keep], None


CASES = {
    "cascade_50": lambda: _case(50, 1, 7),
    "cascade_300": lambda: _case(300, 2, 5),
    "cascade_300_nan_inf": lambda: _case(300, 2, 5, poison=True),
    "cascade_2047": lambda: _case(2047, 3, 0),
    "hub_300": _hub_graph,
}


# -- the tables ---------------------------------------------------------------

@pytest.mark.parametrize("cap", [32, 8, 2, 1])
@pytest.mark.parametrize("name", ["cascade_300", "cascade_2047", "hub_300"])
def test_ell_tables_byte_equal_reference(name, cap):
    _, src, dst, _ = CASES[name]()
    n_pad = int(max(src.max(), dst.max())) + 2
    port = EllGraph.build(n_pad, src, dst, width_cap=cap)
    ref = RefEllGraph.build(n_pad, src, dst, width_cap=cap)
    for side in ("up", "down"):
        p, r = getattr(port, side), getattr(ref, side)
        for field in ("idx", "mask", "ovf_seg", "ovf_other"):
            a, b = getattr(p, field), getattr(r, field)
            assert a.dtype == b.dtype and a.shape == b.shape, (side, field)
            assert a.tobytes() == b.tobytes(), (side, field)
        assert p.n_overflow == r.n_overflow


def test_ell_tables_of_an_empty_graph():
    empty = np.zeros(0, np.int32)
    port = EllGraph.build(8, empty, empty)
    ref = RefEllGraph.build(8, empty, empty)
    assert port.down.idx.tobytes() == ref.down.idx.tobytes()
    assert port.nbytes() == sum(
        getattr(getattr(ref, s), f).nbytes for s in ("up", "down")
        for f in ("idx", "mask", "ovf_seg", "ovf_other"))


# -- propagate_ell ------------------------------------------------------------

@pytest.mark.parametrize("contrast", [False, True])
@pytest.mark.parametrize("n,n_roots,cap", [(300, 2, 32), (300, 2, 2),
                                           (50, 1, 1)])
def test_propagate_ell_matches_reference(n, n_roots, cap, contrast):
    case = ref_cascade(n, n_roots=n_roots, seed=3)
    p = default_params()
    aw, hw = p.weight_arrays()
    n_pad = n + 1
    f = np.zeros((n_pad, case.features.shape[1]), np.float32)
    f[:n] = case.features
    ec = p.error_contrast if contrast else 0.0
    ref_ell = RefEllGraph.build(n_pad, case.dep_src, case.dep_dst,
                                width_cap=cap)
    ref = ref_propagate_ell(
        f, ref_ell.up.idx, ref_ell.up.mask, ref_ell.up.ovf_seg,
        ref_ell.up.ovf_other, ref_ell.down.idx, ref_ell.down.mask,
        ref_ell.down.ovf_seg, ref_ell.down.ovf_other, aw, hw, p.steps,
        p.decay, p.explain_strength, p.impact_bonus, error_contrast=ec)
    ell = EllGraph.build(n_pad, case.dep_src, case.dep_dst,
                         width_cap=cap).to("cpu")
    args = (torch.from_numpy(f), ell, torch.from_numpy(aw),
            torch.from_numpy(hw), p.steps, p.decay, p.explain_strength,
            p.impact_bonus)
    a, h, u, m, s = (t.numpy() for t in propagate_ell(*args,
                                                       error_contrast=ec))
    ra, rh, ru, rm, rs = (np.asarray(x) for x in ref)
    np.testing.assert_allclose(a, ra, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(h, rh, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(s, rs, atol=1e-6)
    np.testing.assert_allclose(u, ru, atol=1e-6)
    np.testing.assert_allclose(m, rm, atol=1e-5)
    # the same bits on a second run: no sum depends on an atomic order
    again = propagate_ell(*args, error_contrast=ec)
    for x, y in zip((a, h, u, m, s), again):
        assert np.array_equal(x, y.numpy())


# -- the engine under each layout --------------------------------------------

def _run(monkeypatch, layout, feats, src, dst, names, kernel="torch",
         resident=False, k=10):
    monkeypatch.setenv("RCA_EDGE_LAYOUT", layout)
    monkeypatch.setenv("RCA_KERNEL", kernel)
    eng = GraphEngine(device="cpu", resident=resident)
    res = eng.analyze_arrays(feats, src, dst, names, k=k)
    return eng, res


def _same_contract(port, ref):
    """Scores within rtol 1e-5 / atol 1e-6, ``u`` bitwise, top-k equal."""
    assert port.top_components() == ref.top_components()
    np.testing.assert_array_equal(port.upstream, ref.upstream)
    np.testing.assert_allclose(port.score, ref.score, rtol=1e-5, atol=1e-6)
    assert port.sanitized_rows == ref.sanitized_rows


@pytest.mark.parametrize("kernel", ["torch", "kernels"])
@pytest.mark.parametrize("name", list(CASES))
def test_layouts_through_analyze_arrays(name, kernel, monkeypatch):
    feats, src, dst, names = CASES[name]()
    out = {}
    for layout in LAYOUTS:
        eng, res = _run(monkeypatch, layout, feats, src, dst, names, kernel)
        assert (res.kernel, res.layout) == (kernel, layout)
        f, s, _ = eng._pad(feats, src, dst)
        plan = eng.plan_for(f.shape[0], len(s), src, dst)
        assert plan.layout == ("coo" if layout == "ell" else layout)
        assert (plan.up_ell is None) == (
            layout != "hybrid" or kernel == "kernels")
        again = eng.analyze_arrays(feats, src, dst, names, k=10)
        for attr in ("score", "upstream", "impact", "anomaly"):
            assert np.array_equal(getattr(res, attr), getattr(again, attr))
        out[layout] = res
    hyb, coo, ell = out["hybrid"], out["coo"], out["ell"]
    for attr in ("score", "upstream", "impact", "anomaly"):
        assert np.array_equal(getattr(coo, attr), getattr(hyb, attr)), attr
    assert coo.ranked == hyb.ranked
    np.testing.assert_array_equal(ell.upstream, hyb.upstream)
    np.testing.assert_allclose(ell.score, hyb.score, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ell.impact, hyb.impact, rtol=1e-5, atol=1e-6)
    assert ell.top_components() == hyb.top_components()
    assert ell.sanitized_rows == hyb.sanitized_rows


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", ["cascade_300_nan_inf", "hub_300"])
def test_layouts_match_reference_engine(name, layout, monkeypatch):
    feats, src, dst, names = CASES[name]()
    _, port = _run(monkeypatch, layout, feats, src, dst, names)
    monkeypatch.delenv("RCA_KERNEL")
    ref = RefEngine().analyze_arrays(feats, src, dst, names, k=10)
    _same_contract(port, ref)


def test_ell_batch_equals_solo_and_skips_resident(monkeypatch):
    feats, src, dst, names = CASES["cascade_300_nan_inf"]()
    monkeypatch.setenv("RCA_EDGE_LAYOUT", "ell")
    eng = GraphEngine(device="cpu", resident=True)
    rng = np.random.default_rng(4)
    batch = np.repeat(feats[None], 4, axis=0)
    for b in range(1, 4):
        batch[b, rng.integers(0, len(feats), 6)] = 0.0
    lanes = eng.analyze_batch(batch, src, dst, names, k=8)
    for b, lane in enumerate(lanes):
        solo = eng.analyze_arrays(batch[b], src, dst, names, k=8)
        assert lane.ranked == solo.ranked
        assert np.array_equal(lane.score, solo.score)
        assert np.array_equal(lane.impact, solo.impact)
    # the full-ELL path never went through the resident cache
    assert not eng._resident_cache._sessions
    assert {lane.layout for lane in lanes} == {"ell"}


def test_coo_resident_and_batch_equal_restaged(monkeypatch):
    feats, src, dst, names = CASES["cascade_300_nan_inf"]()
    monkeypatch.setenv("RCA_EDGE_LAYOUT", "coo")
    resident = GraphEngine(device="cpu", resident=True)
    restaged = GraphEngine(device="cpu", resident=False)
    rng = np.random.default_rng(1)
    f = feats.copy()
    for _ in range(3):
        f[rng.integers(0, len(f), 5)] = rng.uniform(0, 1, (5, f.shape[1]))
        a = resident.analyze_arrays(f, src, dst, names, k=8)
        b = restaged.analyze_arrays(f, src, dst, names, k=8)
        assert a.ranked == b.ranked and np.array_equal(a.score, b.score)
        assert a.layout == b.layout == "coo"
    # a flip of the layout re-plans the resident session
    monkeypatch.setenv("RCA_EDGE_LAYOUT", "hybrid")
    c = resident.analyze_arrays(f, src, dst, names, k=8)
    assert np.array_equal(c.score, b.score)
    assert c.layout == "hybrid"
    monkeypatch.setenv("RCA_EDGE_LAYOUT", "coo")
    lanes = restaged.analyze_batch(np.stack([f, feats]), src, dst, names,
                                   k=8)
    assert {lane.layout for lane in lanes} == {"coo"}
    assert np.array_equal(lanes[0].score, b.score)


@pytest.mark.parametrize("layout", ["coo", "ell"])
def test_streaming_and_serve_run_the_coo_form(layout, monkeypatch):
    """Every surface but the one-shot analysis runs the COO form under
    ``ell``, as the reference's ``kernel_plan`` gives it to them; both
    equal the hybrid layout's answers."""
    from rca_tpu_torch.engine.streaming import StreamingSession
    from rca_tpu_torch.serve.dispatcher import BatchDispatcher
    from rca_tpu_torch.serve.request import ServeRequest

    feats, src, dst, names = CASES["cascade_300"]()
    out = {}
    for lay in ("hybrid", layout):
        monkeypatch.setenv("RCA_EDGE_LAYOUT", lay)
        eng = GraphEngine(device="cpu", resident=False)
        sess = StreamingSession(names, src, dst, feats.shape[1],
                                engine=eng, k=5)
        assert sess._plan.layout == ("coo" if lay != "hybrid" else "hybrid")
        sess.set_all(feats)
        sess.tick()
        sess.update_rows(np.array([3, 9], np.int64),
                         np.full((2, feats.shape[1]), 0.9, np.float32))
        tick = sess.tick()
        disp = BatchDispatcher(eng)
        reqs = [ServeRequest(tenant="t", features=feats, dep_src=src,
                             dep_dst=dst, names=names, k=5)]
        served = disp.fetch(disp.dispatch(reqs))[0]
        assert served.layout == sess._plan.layout
        out[lay] = (tick["ranked"], served.ranked, served.score)
    assert out["hybrid"][:2] == out[layout][:2]
    assert np.array_equal(out["hybrid"][2], out[layout][2])


def test_attribution_under_coo_matches_reference(monkeypatch):
    """Under ``coo`` attribution's saliency differentiates the COO
    scatter-max (no up-table), as the reference's does."""
    from test_torch_attribution import assert_blocks_match

    feats, src, dst, names = CASES["cascade_300"]()
    monkeypatch.setenv("RCA_EDGE_LAYOUT", "coo")
    monkeypatch.setenv("RCA_KERNEL", "")
    port = GraphEngine(device="cpu", resident=False).analyze_arrays(
        feats, src, dst, names, k=5)
    ref = RefEngine().analyze_arrays(feats, src, dst, names, k=5)
    assert_blocks_match(port.attribution()["attribution"],
                        ref.attribution()["attribution"])


# -- the registry -------------------------------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("variant", ["dense", "sharded", "attribution"])
def test_registry_reasons_match_reference(layout, variant, monkeypatch):
    from rca_tpu_torch.engine.registry import _eligibility, layout_note

    monkeypatch.setenv("RCA_EDGE_LAYOUT", layout)
    port = _eligibility(variant, 4096, 8, "cpu", edge_layout())
    ref = ref_eligibility(variant, 2048, 4096, 8)
    for name in ("quantized", "doubling"):
        assert port[name] == ref[name], name
    # the port has no segscan row: the reference's reason is a note, and
    # the kernels row stays eligible under every layout
    assert port["kernels"] is True or variant == "attribution"
    note = layout_note(variant, layout)
    if variant == "dense" and layout != "hybrid":
        assert note == ref["segscan"] == (
            f"RCA_EDGE_LAYOUT={layout} pins the scan layout")
    else:
        assert note is None


def test_registry_rows_keyed_by_layout(monkeypatch, capsys):
    from rca_tpu_torch.cli import main

    reg = get_registry()
    rows = {}
    for layout in LAYOUTS:
        monkeypatch.setenv("RCA_EDGE_LAYOUT", layout)
        rows[layout] = reg.resolve(2048, e_pad=4096, device="cpu")
        assert rows[layout].layout == layout
    assert len({id(r) for r in rows.values()}) == 3
    # a forced row the ell layout declines engages the default row
    monkeypatch.setenv("RCA_EDGE_LAYOUT", "ell")
    monkeypatch.setenv("RCA_KERNEL", "doubling")
    row = reg.resolve(2048, e_pad=4096, device="cpu")
    assert (row.winner, row.source) == ("torch", "ineligible")
    monkeypatch.setenv("RCA_KERNEL", "")
    assert main(["kernels", "--device", "cpu", "--services", "300",
                 "--explain"]) == 0
    text = capsys.readouterr().out
    assert "layout=ell" in text
    assert ("note     the reference declines its segscan row "
            "(RCA_EDGE_LAYOUT=ell pins the scan layout)") in text
    assert ("doubling ineligible: RCA_EDGE_LAYOUT=ell pins the gather-table"
            " layout") in text


def test_card_races_under_every_layout(monkeypatch, tmp_path):
    """On the card every layout races its rows (the kernels row runs the
    same kernels under each), and each layout caches its winner under its
    own key: a second registry reads all three back."""
    from rca_tpu_torch.engine import registry

    calls = []
    monkeypatch.setattr(registry, "_time_candidates",
                        lambda *a, **k: calls.append(a) or {
                            "torch": 1.0, "kernels": 0.2})
    monkeypatch.setattr(registry, "_device_name", lambda d: "fake card")
    monkeypatch.setenv("RCA_KERNEL_CACHE", str(tmp_path / "rows.json"))
    cuda = torch.device("cuda", 0)
    for source in ("timed", "cache"):
        reg = registry.KernelRegistry()
        for layout in LAYOUTS:
            monkeypatch.setenv("RCA_EDGE_LAYOUT", layout)
            row = reg.resolve(2048, e_pad=4096, device=cuda)
            assert (row.winner, row.source, row.layout) == (
                "kernels", source, layout)
    assert len(calls) == 3


@pytest.mark.parametrize("value", ["cooo", "dense", "ELLX"])
def test_unknown_layout_raises(value, monkeypatch):
    feats, src, dst, names = CASES["cascade_50"]()
    monkeypatch.setenv("RCA_EDGE_LAYOUT", value)
    with pytest.raises(ValueError, match="RCA_EDGE_LAYOUT"):
        edge_layout()
    with pytest.raises(ValueError, match="RCA_EDGE_LAYOUT"):
        GraphEngine(device="cpu").analyze_arrays(feats, src, dst, names)


def test_layout_names_are_case_and_blank_tolerant(monkeypatch):
    monkeypatch.setenv("RCA_EDGE_LAYOUT", " ELL ")
    assert edge_layout() == "ell"
    monkeypatch.setenv("RCA_EDGE_LAYOUT", "")
    assert edge_layout() == "hybrid"


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["coo", "ell"])
def test_layouts_on_card_run_the_kernels(layout, monkeypatch):
    """On the card ``coo`` launches the K1 front's two kernels and the
    seg steps as ``hybrid`` does; ``ell`` the front and the overflow's
    flagged segmented sum once a step.  Both agree with their CPU run."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: python3 chip_smoke.py runs the "
                    "layouts leg on the card")
    from rca_tpu_torch.kernels import LAUNCHES, reset_launches

    feats, src, dst, names = CASES["cascade_2047"]()
    monkeypatch.setenv("RCA_EDGE_LAYOUT", layout)
    engine = GraphEngine(resident=False)
    engine.analyze_arrays(feats, src, dst, names)
    reset_launches()
    got = engine.analyze_arrays(feats, src, dst, names)
    # coo: each recursion fused into one launch at 2047 services
    fused = int(layout == "coo")
    assert LAUNCHES == {"noisy_or_pair": 0, "segscan_sum": 8 * (1 - fused),
                        "segscan_max": 0, "seg_up_step": 0,
                        "seg_down_step": 0, "evidence_front": 0,
                        "seg_contrast_step": 0, "seg_up_steps": fused,
                        "seg_down_steps": fused, "evidence_front_fused": 1,
                        "seg_up_steps_grid": 0, "seg_down_steps_grid": 0,
                        "seg_up_steps_shard": 0, "seg_down_steps_shard": 0}
    assert got.layout == layout
    cpu = GraphEngine(device="cpu", resident=False).analyze_arrays(
        feats, src, dst, names)
    _same_contract(got, cpu)
