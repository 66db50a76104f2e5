"""Degenerate graphs through the port's ``analyze_arrays`` against the JAX
package's, at k = 1, 5 and 300 (more than the services): graphs of 1, 2,
5 and 130 services with no edges; self-loops, duplicate edges and NaN/Inf
rows; random graphs of 100–600 services with no structure.  Each input is
made from a seed with numpy and goes through both engines under the
reference's default plan (the port's ``torch`` row) and its ``segscan``
plan (the port's ``kernels`` row, the kernels' plain versions here).  The
engine contract holds: scores at rtol 1e-5 / atol 1e-6, ``u`` bitwise,
top-k identical with its tie order, ``sanitized_rows`` identical.
"""

import numpy as np
import pytest

from rca_tpu.engine import GraphEngine as RefEngine
from rca_tpu.engine.train import packaged_params as ref_packaged_params
from rca_tpu_torch import GraphEngine
from test_torch_engine import PORT_ROW, _assert_matches, _port_params

C = 13


def _features(rng, n):
    return rng.uniform(0, 1, (n, C)).astype(np.float32)


def _no_edges(n):
    def make():
        rng = np.random.default_rng(n)
        empty = np.zeros(0, np.int32)
        return _features(rng, n), empty, empty
    return make


def _random_edges(rng, n, e):
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    return src, dst


def _self_loops():
    rng = np.random.default_rng(21)
    src, dst = _random_edges(rng, 100, 220)
    loops = rng.integers(0, 100, 30).astype(np.int32)
    return (_features(rng, 100), np.concatenate([src, loops]),
            np.concatenate([dst, loops]))


def _duplicate_edges():
    rng = np.random.default_rng(22)
    src, dst = _random_edges(rng, 100, 200)
    dup = rng.integers(0, 200, 120)
    return (_features(rng, 100), np.concatenate([src, src[dup]]),
            np.concatenate([dst, dst[dup]]))


def _nan_inf_rows():
    rng = np.random.default_rng(23)
    feats = _features(rng, 150)
    feats[[2, 40, 41, 99], [0, 6, 12, 3]] = (np.nan, np.inf, -np.inf, np.nan)
    feats[77] = np.nan                       # a whole row
    src, dst = _random_edges(rng, 150, 300)
    return feats, src, dst


def _random_graph(seed):
    def make():
        rng = np.random.default_rng(seed)
        n = int(rng.integers(100, 601))
        src, dst = _random_edges(rng, n, int(rng.integers(n, 4 * n)))
        return _features(rng, n), src, dst
    return make


GRAPHS = {
    **{f"no_edges_{n}": _no_edges(n) for n in (1, 2, 5, 130)},
    "self_loops": _self_loops,
    "duplicate_edges": _duplicate_edges,
    "nan_inf_rows": _nan_inf_rows,
    **{f"random_{seed}": _random_graph(seed) for seed in (1, 2, 3)},
}


@pytest.fixture(scope="module")
def engines():
    ref_params = ref_packaged_params()
    return (GraphEngine(params=_port_params(ref_params), device="cpu"),
            RefEngine(params=ref_params, resident=False))


@pytest.mark.parametrize("plan", ["default", "segscan"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_degenerate_graph_matches_reference(name, plan, engines, monkeypatch):
    monkeypatch.setenv("RCA_KERNEL_CACHE", "off")
    port_engine, ref_engine = engines
    feats, src, dst = GRAPHS[name]()
    names = [f"svc-{i}" for i in range(feats.shape[0])]
    for k in (1, 5, 300):
        monkeypatch.setenv("RCA_KERNEL", "" if plan == "default" else plan)
        ref = ref_engine.analyze_arrays(feats, src, dst, names, k=k)
        monkeypatch.setenv("RCA_KERNEL", PORT_ROW[plan])
        port = port_engine.analyze_arrays(feats, src, dst, names, k=k)
        _assert_matches(port, ref)
        assert len(port.ranked) == min(k, feats.shape[0])
    if name == "nan_inf_rows":
        assert port.sanitized_rows == 5
