"""The port's causelens attribution against the JAX package's.

The same inputs (numpy, from the reference's seeded generator or its
feature extractor) go through ``rca_tpu``'s ``GraphEngine`` and the port's
``GraphEngine(device="cpu")``, and each ranking's ``attribution()`` block
is held to the reference's (:func:`assert_blocks_match`):

- channels, values, weights and contributions, the evidence rows and the
  evidence factor exactly equal;
- the ``[5, K]`` diagnostics under the engine contract: ``upstream``
  bitwise, the rest within rtol 1e-5 / atol 1e-6;
- every ``score_drop`` within rtol 1e-5 / atol 1e-6, in the same
  counterfactual order outside ties (drops within 1e-6);
- blame paths identical (rows), their terms within 1e-6;
- saliency channels within rtol 1e-4 / atol 1e-6 with the same nonzero
  set, and the same ``saliency_rows`` outside ties.

``kernel``, ``digest`` and ``engine`` are not compared: the port's
``torch`` row stands against the reference's ``xla``.  The gradient at
ties is pinned op by op: the clip, the maxes, the relu of the excess and
the median.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rca_tpu.cluster.fixtures import NS, five_service_world
from rca_tpu.cluster.generator import synthetic_cascade_arrays as ref_cascade
from rca_tpu.cluster.mock_client import MockClusterClient
from rca_tpu.cluster.snapshot import ClusterSnapshot
from rca_tpu.engine import GraphEngine as RefEngine
from rca_tpu.engine.propagate import (
    background_excess as ref_background_excess,
)
from rca_tpu.engine.propagate import (
    error_source_excess as ref_error_source_excess,
)
from rca_tpu.features.extract import extract_features
from rca_tpu.graph.build import service_dependency_edges
from rca_tpu.observability.causelens import (
    attribution_digest as ref_digest,
)
from rca_tpu.observability.causelens import (
    render_blame_tree as ref_render,
)
from rca_tpu_torch import GraphEngine
from rca_tpu_torch.engine import attribution as port_attribution
from rca_tpu_torch.engine import evidence as port_evidence
from rca_tpu_torch.engine.propagate import background_excess
from rca_tpu_torch.features.schema import SvcF
from rca_tpu_torch.observability.causelens import (
    attribution_digest,
    render_blame_tree,
)


def _five_service_input():
    snap = ClusterSnapshot.capture(MockClusterClient(five_service_world()),
                                   NS)
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
    "cascade_300": lambda: _cascade_input(300, 2, 5),
    "cascade_300_nan_inf": lambda: _cascade_input(300, 2, 5, poison=True),
    "cascade_2047": lambda: _cascade_input(2047, 3, 0),
}


@pytest.fixture
def clean_env(monkeypatch):
    for name in ("RCA_KERNEL", "RCA_EDGE_LAYOUT", "RCA_EXPLAIN_PATHS",
                 "RCA_EXPLAIN_TOPM", "RCA_WEIGHTS"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("RCA_KERNEL_CACHE", "off")


def _close(a, b, rtol=1e-5, atol=1e-6):
    return abs(a - b) <= atol + rtol * abs(b)


def _in_order(port_rows, ref_value, tie):
    """``port_rows`` is sorted descending by ``ref_value`` up to ``tie``."""
    values = [ref_value[r] for r in port_rows]
    return all(a >= b - tie for a, b in zip(values, values[1:]))


def assert_blocks_match(port, ref, kernel="torch"):
    """The port's attribution block against the reference's (the module
    docstring's contract); ``kernel`` is the row the port's sweep ran."""
    for key in ("schema", "k", "topm", "paths", "n_services", "n_edges",
                "score_formula_version", "evidence_rows"):
        assert port[key] == ref[key], key
    assert port["kernel"] == kernel
    assert "saliency_unavailable" not in port
    assert len(port["candidates"]) == len(ref["candidates"])
    for p, r in zip(port["candidates"], ref["candidates"]):
        who = r["component"]
        for key in ("component", "row", "rank", "channels"):
            assert p[key] == r[key], (who, key)
        assert p["upstream"] == r["upstream"], who
        for key in ("score", "anomaly", "hard", "impact_mean",
                    "reconstructed_score"):
            assert _close(p[key], r[key]), (who, key, p[key], r[key])
        assert p["factors"]["evidence"] == r["factors"]["evidence"], who
        for key in ("impact", "suppression"):
            assert _close(p["factors"][key], r["factors"][key]), (who, key)
        assert p["reconstruction_error"] <= 1e-5, who
        drops = {c["row"]: c["score_drop"] for c in r["counterfactuals"]}
        got = {c["row"]: c["score_drop"] for c in p["counterfactuals"]}
        assert sorted(got) == sorted(drops), who
        for row, drop in drops.items():
            assert _close(got[row], drop), (who, row, got[row], drop)
        assert _in_order([c["row"] for c in p["counterfactuals"]], drops,
                         1e-6), who
        assert ([h["row"] for h in p["blame_path"]]
                == [h["row"] for h in r["blame_path"]]), who
        for hp, hr in zip(p["blame_path"], r["blame_path"]):
            assert hp["to"] == hr["to"]
            for key in ("term", "hard", "upstream"):
                assert abs(hp[key] - hr[key]) <= 1e-6, (who, key)
        ps, rs = p["saliency"]["channels"], r["saliency"]["channels"]
        assert sorted(ps) == sorted(rs), (who, ps, rs)
        for c, v in rs.items():
            assert _close(ps[c], v, rtol=1e-4), (who, c, ps[c], v)
    ref_rows = {s["row"]: s["grad_l1"] for s in ref["saliency_rows"]}
    port_rows = [s["row"] for s in port["saliency_rows"]]
    assert len(port_rows) == len(ref_rows)
    for s in port["saliency_rows"]:
        assert s["row"] in ref_rows, s
        assert _close(s["grad_l1"], ref_rows[s["row"]], rtol=1e-4), s
    assert _in_order(port_rows, ref_rows, 1e-6 * max(ref_rows.values()))


def _blocks(feats, src, dst, names, **kw):
    ref = RefEngine(resident=False).analyze_arrays(feats, src, dst, names)
    port = GraphEngine(device="cpu").analyze_arrays(feats, src, dst, names)
    assert port.top_components() == ref.top_components()
    return port.attribution(**kw), ref.attribution(**kw)


@pytest.mark.parametrize("name", list(INPUTS))
def test_attribution_matches_reference(name, clean_env):
    port, ref = _blocks(*INPUTS[name]())
    assert port["schema"] == ref["schema"] and port["source"] == "causelens"
    assert port["engine"] == "single"
    assert_blocks_match(port["attribution"], ref["attribution"])
    assert port["digest"] == attribution_digest(port["attribution"])


@pytest.mark.parametrize("name", ["five_service_world", "cascade_50",
                                  "cascade_300_nan_inf"])
def test_sweep_on_the_kernels_row_matches_reference(name, clean_env,
                                                    monkeypatch):
    """The sweep runs the dense row, so under ``RCA_KERNEL=kernels`` it
    takes the kernels' route (their plain versions on the CPU) while the
    saliency stays on ``torch``: the block still meets the contract."""
    feats, src, dst, names = INPUTS[name]()
    ref = RefEngine(resident=False).analyze_arrays(feats, src, dst,
                                                   names).attribution()
    monkeypatch.setenv("RCA_KERNEL", "kernels")
    port = GraphEngine(device="cpu").analyze_arrays(feats, src, dst,
                                                    names).attribution()
    assert_blocks_match(port["attribution"], ref["attribution"],
                        kernel="kernels")


@pytest.mark.parametrize("paths,topm", [(1, 1), (2, 3), (6, 12)])
def test_explain_sizes_match_reference(paths, topm, clean_env, monkeypatch):
    port, ref = _blocks(*INPUTS["cascade_300"](), paths=paths, topm=topm)
    assert_blocks_match(port["attribution"], ref["attribution"])
    monkeypatch.setenv("RCA_EXPLAIN_PATHS", str(paths))
    monkeypatch.setenv("RCA_EXPLAIN_TOPM", str(topm))
    port_env, ref_env = _blocks(*INPUTS["cascade_300"]())
    assert port_env["attribution"]["topm"] == topm
    assert_blocks_match(port_env["attribution"], ref_env["attribution"])


def test_two_runs_give_identical_blocks(clean_env):
    feats, src, dst, names = INPUTS["cascade_300"]()
    engine = GraphEngine(device="cpu")
    one = engine.analyze_arrays(feats, src, dst, names).attribution()
    two = engine.analyze_arrays(feats, src, dst, names).attribution()
    assert one == two


def test_blame_tree_and_digest_match_the_reference_renderer(clean_env):
    port, _ = _blocks(*INPUTS["five_service_world"]())
    assert render_blame_tree(port) == ref_render(port)
    assert attribution_digest(port["attribution"]) == ref_digest(
        port["attribution"])
    assert attribution_digest(None) is None
    assert "blame path" in render_blame_tree(port)


def test_saliency_failure_is_named_in_the_block(clean_env, monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("no gradient here")

    monkeypatch.setattr(port_attribution, "attribution_saliency", broken)
    port, _ = _blocks(*INPUTS["cascade_50"]())
    block = port["attribution"]
    assert block["saliency_unavailable"] == "RuntimeError: no gradient here"
    assert "saliency_rows" not in block
    assert all("saliency" not in c for c in block["candidates"])


def test_clamp_would_break_the_tied_zero_saliency(clean_env, monkeypatch):
    """Most feature values are exactly 0: the clip's gradient there is 0.5
    in the reference (a max then a min, each splitting the tie); with
    ``torch.clamp`` (gradient 1) the saliency leaves the contract."""
    feats, src, dst, names = INPUTS["five_service_world"]()
    assert np.mean(feats == 0.0) > 0.5
    port, ref = _blocks(feats, src, dst, names)
    assert_blocks_match(port["attribution"], ref["attribution"])
    monkeypatch.setattr(port_evidence, "clip01",
                        lambda x: torch.clamp(x, 0.0, 1.0))
    clamped, _ = _blocks(feats, src, dst, names)
    with pytest.raises(AssertionError):
        assert_blocks_match(clamped["attribution"], ref["attribution"])


@pytest.mark.parametrize("x", [[-0.5, 0.0, 0.3, 1.0, 1.5],
                               [0.0, 0.0, 0.0, 1.0, 1.0]])
def test_clip_gradient_splits_ties_as_jnp_clip(x):
    xt = torch.tensor(x, requires_grad=True)
    port_evidence.clip01(xt).sum().backward()
    want = jax.grad(lambda v: jnp.clip(v, 0.0, 1.0).sum())(jnp.asarray(x))
    assert np.array_equal(xt.grad.numpy(), np.asarray(want))
    clamp = torch.tensor(x, requires_grad=True)
    torch.clamp(clamp, 0.0, 1.0).sum().backward()
    assert not np.array_equal(clamp.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_live", [1, 2, 7, 40, 63])
@pytest.mark.parametrize("equal_share", [0.0, 0.8])
def test_median_excess_gradient_matches_reference(n_live, equal_share):
    """Where most ``a`` are equal the median ties with its neighbours; the
    stable sort puts the gradient on the same index as the reference's
    nanmedian, and the relu splits the median's own tie."""
    rng = np.random.default_rng(n_live)
    a = rng.uniform(0, 1, 64).astype(np.float32)
    a[rng.uniform(0, 1, 64) < equal_share] = 0.25
    weights = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    at = torch.from_numpy(a).requires_grad_(True)
    got = background_excess(at, n_live)
    (got * torch.from_numpy(weights)).sum().backward()
    want = ref_background_excess(jnp.asarray(a), n_live)
    assert np.array_equal(got.detach().numpy(), np.asarray(want))
    grad = jax.grad(lambda v: jnp.sum(ref_background_excess(v, n_live)
                                      * weights))(jnp.asarray(a))
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(grad),
                               rtol=1e-6, atol=1e-7)


def test_error_source_gradient_matches_reference():
    """Dependencies with equal error rates, zero rates against the
    scatter's zero start, and a node tying its dependency's max: every tie
    splits as ``.at[].max`` and ``jnp.maximum`` split it."""
    n = 16
    rng = np.random.default_rng(5)
    f = np.zeros((n, 13), np.float32)
    f[:, SvcF.ERROR_RATE] = rng.choice([0.0, 0.3, 0.6], n)
    src = np.array([0, 0, 1, 2, 2, 3, 4, 5, 6, 7, 7, 15], np.int64)
    dst = np.array([1, 2, 3, 3, 4, 5, 6, 7, 8, 9, 10, 15], np.int64)
    weights = rng.uniform(0.5, 1.5, n).astype(np.float32)
    ft = torch.from_numpy(f).requires_grad_(True)
    e = port_evidence.error_rate(ft)
    got = port_evidence.error_source_excess(e, torch.from_numpy(src),
                                            torch.from_numpy(dst))
    (got * torch.from_numpy(weights)).sum().backward()

    def ref(v):
        return ref_error_source_excess(v, jnp.asarray(src), jnp.asarray(dst))

    assert np.array_equal(got.detach().numpy(), np.asarray(ref(f)))
    grad = jax.grad(lambda v: jnp.sum(ref(v) * weights))(jnp.asarray(f))
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(grad), rtol=1e-6,
                               atol=1e-7)
