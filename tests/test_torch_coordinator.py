"""The port's comprehensive analysis against the JAX package's coordinator.

Each world comes from each package's own generator with the same seed;
the port's ``RCACoordinator(backend="torch", device="cpu")`` and the
reference's ``RCACoordinator(backend="jax")`` analyze it.  The contract:

- every agent's findings JSON (``json.dumps(..., sort_keys=True)``) and
  the correlated ``groups`` are byte-identical;
- the root causes name the same components in the same order, and every
  other field is equal, floats within rel 1e-5 / abs 1e-6 and ``score``
  (rounded to 4 places by both) within 1e-4;
- only the backend name, the latencies, the profile and the record's ids
  and timestamps differ.  The reference shards over the test session's 8
  virtual devices; the port's dense coordinator names its engine
  ``single``, and the port's coordinator over a ``ShardedGraphEngine`` on
  8 logical CPU shards gives the findings JSON again, the reference's
  ``engine`` key included.

The betweenness device pass is held to the reference's and to the port's
own float64 loop on a seeded 1300-node graph, which takes the device path
in both packages.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rca_tpu.agents import ALL_AGENT_TYPES as REF_AGENT_TYPES
from rca_tpu.cluster.fixtures import five_service_world as ref_five
from rca_tpu.cluster.generator import synthetic_cascade_world as ref_world
from rca_tpu.cluster.mock_client import MockClusterClient as RefClient
from rca_tpu.coordinator import RCACoordinator as RefCoordinator
from rca_tpu.graph.analysis import betweenness_centrality as ref_betweenness
from rca_tpu_torch.agents import ALL_AGENT_TYPES, AnalysisContext
from rca_tpu_torch.cluster.fixtures import NS, five_service_world
from rca_tpu_torch.cluster.generator import synthetic_cascade_world
from rca_tpu_torch.cluster.mock_client import MockClusterClient
from rca_tpu_torch.cluster.snapshot import ClusterSnapshot
from rca_tpu_torch.coordinator import RCACoordinator, correlate_findings
from rca_tpu_torch.graph import analysis as port_analysis
from rca_tpu_torch.graph.analysis import (
    _betweenness_python,
    betweenness_centrality,
)

ROOT = Path(__file__).resolve().parent.parent

WORLDS = {
    "5svc": (lambda: five_service_world(), lambda: ref_five(), NS),
    "50svc": (lambda: synthetic_cascade_world(50, n_roots=1, seed=7,
                                              namespace="synthetic"),
              lambda: ref_world(50, n_roots=1, seed=7, namespace="synthetic"),
              "synthetic"),
    "300svc_mixed": (
        lambda: synthetic_cascade_world(300, n_roots=2, seed=5,
                                        mode="adversarial",
                                        fault_mix="mixed"),
        lambda: ref_world(300, n_roots=2, seed=5, mode="adversarial",
                          fault_mix="mixed"),
        "synthetic"),
}

_SUMMARY = {
    "jax": re.compile(r"TPU propagation over (\d+) services / (\d+) edges "
                      r"in [0-9.]+ ms; top root cause: (.+)"),
    "torch": re.compile(r"propagation over (\d+) services / (\d+) edges "
                        r"in [0-9.]+ ms on cpu; top root cause: (.+)"),
}


@pytest.fixture
def clean_env(monkeypatch):
    for name in ("RCA_BACKEND", "RCA_EXPLAIN", "RCA_COLUMNAR"):
        monkeypatch.delenv(name, raising=False)


def _dumps(obj):
    return json.dumps(obj, sort_keys=True, default=str)


def _assert_causes_match(port, ref):
    assert ([r["component"] for r in port]
            == [r["component"] for r in ref])
    for p, r in zip(port, ref):
        assert sorted(p) == sorted(r), r["component"]
        for key, value in r.items():
            if key == "score":
                assert abs(p[key] - value) <= 1e-4, r["component"]
            elif isinstance(value, float):
                assert p[key] == pytest.approx(value, rel=1e-5, abs=1e-6), key
            elif key == "findings":
                assert _dumps(p[key]) == _dumps(value), r["component"]
            else:
                assert p[key] == value, key


@pytest.mark.parametrize("name", WORLDS)
def test_comprehensive_analysis_matches_reference(name, clean_env):
    port_world, ref_world_fn, ns = WORLDS[name]
    rw = ref_world_fn()
    port = RCACoordinator(MockClusterClient(port_world()), backend="torch",
                          device="cpu").run_analysis("comprehensive", ns)
    ref = RefCoordinator(RefClient(rw), backend="jax").run_analysis(
        "comprehensive", ns)
    assert port["status"] == ref["status"] == "completed", port.get("error")
    pr, rr = port["results"], ref["results"]
    assert ALL_AGENT_TYPES == REF_AGENT_TYPES
    for agent in ALL_AGENT_TYPES:
        assert _dumps(pr[agent]) == _dumps(rr[agent]), agent
    pc, rc = pr["correlated"], rr["correlated"]
    assert pc["backend"] == "torch" and rc["backend"] == "jax"
    assert "fallback_from" not in pc and "fallback_from" not in rc
    assert _dumps(pc["groups"]) == _dumps(rc["groups"])
    _assert_causes_match(pc["root_causes"], rc["root_causes"])
    # the reference shards over the test session's 8 virtual CPU devices;
    # the port's coordinator on the CPU sees one device
    assert pc["engine"] == "single"
    assert rc["engine"] == "sharded(dp=1,sp=8)"
    assert sorted(pc) == sorted(rc)
    assert (_SUMMARY["torch"].fullmatch(pc["summary"]).groups()
            == _SUMMARY["jax"].fullmatch(rc["summary"]).groups())
    assert "TPU" not in pc["summary"]
    assert pr["summary"] == rr["summary"] == port["summary"]
    assert sorted(pr) == sorted(rr)
    assert sorted(pr["profile"]) == sorted(rr["profile"])
    assert port["config"] == ref["config"]
    if name == "5svc":
        top2 = {r["component"] for r in pc["root_causes"][:2]}
        assert top2 == {"database", "api-gateway"}
    else:
        assert pc["root_causes"][0]["component"] in rw.ground_truth[
            "fault_roots"]


@pytest.mark.parametrize("name", WORLDS)
def test_sharded_coordinator_matches_reference_engine_key_included(
        name, clean_env, monkeypatch):
    """The port's coordinator over 8 logical CPU shards against the
    reference's, which shards over the session's 8 virtual devices: every
    agent's JSON, the groups and the summary byte-identical, the root
    causes under the contract, and the ``engine`` key equal."""
    import jax

    from rca_tpu_torch.engine import ShardedGraphEngine
    from rca_tpu_torch.parallel.mesh import make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("the reference needs 8 devices")
    monkeypatch.delenv("RCA_SHARD", raising=False)
    port_world, ref_world_fn, ns = WORLDS[name]
    engine = ShardedGraphEngine(
        mesh=make_mesh([("dp", 1), ("sp", 8)], [torch.device("cpu")] * 8))
    port = RCACoordinator(MockClusterClient(port_world()), backend="torch",
                          engine=engine).run_analysis("comprehensive", ns)
    ref = RefCoordinator(RefClient(ref_world_fn()), backend="jax"
                         ).run_analysis("comprehensive", ns)
    assert port["status"] == ref["status"] == "completed", port.get("error")
    pr, rr = port["results"], ref["results"]
    for agent in ALL_AGENT_TYPES:
        assert _dumps(pr[agent]) == _dumps(rr[agent]), agent
    pc, rc = pr["correlated"], rr["correlated"]
    assert _dumps(pc["groups"]) == _dumps(rc["groups"])
    _assert_causes_match(pc["root_causes"], rc["root_causes"])
    assert pc["engine"] == rc["engine"] == "sharded(dp=1,sp=8)"
    assert sorted(pc) == sorted(rc)
    assert (_SUMMARY["torch"].fullmatch(pc["summary"]).groups()
            == _SUMMARY["jax"].fullmatch(rc["summary"]).groups())
    assert pr["summary"] == rr["summary"] == port["summary"]


def _random_dag(n, seed):
    """Each node depends on 1-3 earlier nodes: many shortest paths, counts
    far inside float32's exact integers."""
    rng = np.random.default_rng(seed)
    src, dst = [], []
    for v in range(1, n):
        for u in rng.choice(v, size=min(v, int(rng.integers(1, 4))),
                            replace=False):
            src.append(v)
            dst.append(int(u))
    return (np.asarray(src, np.int32), np.asarray(dst, np.int32))


def test_betweenness_device_path_matches_reference_and_float64():
    n = 1300
    assert (port_analysis._BC_DEVICE_MIN_NODES <= n
            <= port_analysis._BC_DEVICE_MAX_NODES)
    src, dst = _random_dag(n, seed=11)
    got = betweenness_centrality(n, src, dst, device="cpu")
    ref = ref_betweenness(n, src, dst)
    exact = _betweenness_python(n, src, dst)
    assert got.dtype == np.float64 and got.shape == (n,)
    assert got.max() > 0
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got, exact, rtol=1e-5, atol=1e-7)
    # a repeated edge collapses to one in the adjacency, as the reference's
    # max-scatter collapses it (the float64 loop would count it twice)
    dup = (np.append(src, src[:7]), np.append(dst, dst[:7]))
    assert np.array_equal(betweenness_centrality(n, *dup, device="cpu"), got)
    np.testing.assert_allclose(got, ref_betweenness(n, *dup),
                               rtol=1e-5, atol=1e-7)
    bc, finite, levels = port_analysis._bc_kernel(src, dst, 1536,
                                                   torch.device("cpu"))
    assert finite and levels > 2
    assert np.all(bc[n:].numpy() == 0)


def test_betweenness_overflow_falls_back_to_float64(monkeypatch):
    """A ladder of 140 2-node layers, each node linked to both of the next
    layer's: 2^140 shortest paths overflow float32, which the kernel
    reports; the caller then runs the float64 loop."""
    src, dst = [], []
    for layer in range(140):
        for a in (2 * layer, 2 * layer + 1):
            for b in (2 * layer + 2, 2 * layer + 3):
                src.append(a)
                dst.append(b)
    src, dst = np.asarray(src, np.int32), np.asarray(dst, np.int32)
    _, finite, _ = port_analysis._bc_kernel(src, dst, 512,
                                            torch.device("cpu"))
    assert not finite
    n = 1300
    dag = _random_dag(n, seed=4)
    calls = []

    def overflowed(src, dst, n_pad, device):
        calls.append(n_pad)
        return torch.zeros(n_pad), False, 1

    monkeypatch.setattr(port_analysis, "_bc_kernel", overflowed)
    got = betweenness_centrality(n, *dag, device="cpu")
    assert calls == [1536]
    assert np.array_equal(got, _betweenness_python(n, *dag))


def test_betweenness_refuses_tf32_products(monkeypatch):
    monkeypatch.setattr(torch, "get_float32_matmul_precision",
                        lambda: "high")
    src, dst = _random_dag(1300, seed=1)
    with pytest.raises(RuntimeError, match="TF32"):
        betweenness_centrality(1300, src, dst, device="cpu")


def test_betweenness_small_and_large_graphs_take_the_host_paths():
    src, dst = _random_dag(60, seed=2)
    got = betweenness_centrality(60, src, dst)   # no device needed
    assert np.array_equal(got, ref_betweenness(60, src, dst))
    deg = betweenness_centrality(5000, *_random_dag(5000, seed=3))
    assert np.array_equal(deg, ref_betweenness(5000,
                                               *_random_dag(5000, seed=3)))


@pytest.fixture
def ctx():
    return AnalysisContext(ClusterSnapshot.capture(
        MockClusterClient(five_service_world()), NS), device="cpu")


@pytest.fixture
def coord(clean_env):
    return RCACoordinator(MockClusterClient(five_service_world()),
                          device="cpu")


def test_single_agent_analysis(coord, ctx):
    rec = coord.run_analysis("logs", NS, ctx=ctx)
    assert rec["status"] == "completed"
    assert rec["results"]["logs"]["findings"]
    assert rec["summary"]
    assert list(rec["results"]) == ["logs"]


def test_unknown_analysis_type_fails_cleanly(coord, ctx):
    rec = coord.run_analysis("bogus", NS, ctx=ctx)
    assert rec["status"] == "failed"
    assert "unknown analysis type" in rec["error"]
    assert coord.get_analysis_status(rec["id"])["status"] == "failed"
    assert "error" in coord.get_analysis_results("nope")
    assert [a["id"] for a in coord.list_analyses()] == [rec["id"]]


def test_backend_follows_env_and_rejects_unknown(monkeypatch):
    client = MockClusterClient(five_service_world())
    monkeypatch.setenv("RCA_BACKEND", "deterministic")
    coord = RCACoordinator(client, device="cpu")
    assert coord.backend == "deterministic" and coord.engine is None
    corr = coord.run_analysis("comprehensive", NS)["results"]["correlated"]
    assert corr["backend"] == "deterministic"
    assert "fallback_from" not in corr
    monkeypatch.setenv("RCA_BACKEND", "jax")
    with pytest.raises(ValueError, match="RCA_BACKEND"):
        RCACoordinator(client, device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        RCACoordinator(client, backend="llm", device="cpu")


class _BrokenEngine:
    device = torch.device("cpu")

    def analyze_features(self, *args, **kwargs):
        raise RuntimeError("engine exploded")


def test_engine_failure_propagates_and_no_context_degrades(ctx, clean_env):
    results = {"logs": {"findings": [{"component": "Pod/x", "issue": "i",
                                      "severity": "high"}]}}
    with pytest.raises(RuntimeError, match="engine exploded"):
        correlate_findings(results, ctx=ctx, backend="torch",
                           engine=_BrokenEngine())
    out = correlate_findings(results, backend="torch")
    assert out["backend"] == "deterministic"
    assert out["fallback_from"] == "torch"
    assert out["fallback_reason"] == "no AnalysisContext for the torch engine"


def test_engine_failure_fails_the_analysis(ctx, clean_env):
    coord = RCACoordinator(MockClusterClient(five_service_world()),
                           backend="torch", device="cpu")
    coord.engine = _BrokenEngine()
    rec = coord.run_analysis("comprehensive", NS, ctx=ctx)
    assert rec["status"] == "failed"
    assert rec["error"] == "RuntimeError: engine exploded"
    assert "correlated" not in rec["results"]


@pytest.mark.parametrize("name", ["5svc", "50svc"])
def test_explain_block_matches_reference(name, clean_env, monkeypatch):
    """Under ``RCA_EXPLAIN=1`` the port's findings JSON carries the
    causelens ``provenance`` block, held to the reference's block within
    the attribution contract (``test_torch_attribution``); no
    ``provenance_error`` remains."""
    from test_torch_attribution import assert_blocks_match

    monkeypatch.setenv("RCA_EXPLAIN", "1")
    monkeypatch.setenv("RCA_KERNEL_CACHE", "off")
    port_world, ref_world_fn, ns = WORLDS[name]
    port = RCACoordinator(MockClusterClient(port_world()), backend="torch",
                          device="cpu").run_analysis("comprehensive", ns)
    ref = RefCoordinator(RefClient(ref_world_fn()), backend="jax"
                         ).run_analysis("comprehensive", ns)
    pc, rc = port["results"]["correlated"], ref["results"]["correlated"]
    assert pc["backend"] == "torch"
    assert "provenance_error" not in pc and "provenance_error" not in rc
    _assert_causes_match(pc["root_causes"], rc["root_causes"])
    pp, rp = pc["provenance"], rc["provenance"]
    assert (pp["schema"], pp["source"]) == (rp["schema"], rp["source"])
    assert pp["engine"] == "single"
    assert_blocks_match(pp["attribution"], rp["attribution"])


def _cli(*args, env_extra=None):
    env = None
    if env_extra is not None:
        # no kubectl on the PATH, whatever the host has
        path = os.pathsep.join(
            d for d in os.environ.get("PATH", "").split(os.pathsep)
            if d and not os.path.exists(os.path.join(d, "kubectl")))
        env = {**os.environ, "PATH": path, **env_extra}
    return subprocess.run(
        [sys.executable, "-m", "rca_tpu_torch", "analyze", *args],
        cwd=str(ROOT), capture_output=True, text=True, timeout=300, env=env,
    )


def test_cli_analyze_on_cpu():
    proc = _cli("--fixture", "50svc", "--seed", "7", "--device", "cpu",
                "--compact")
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout)
    assert out["status"] == "completed"
    roots = synthetic_cascade_world(50, n_roots=1, seed=7).ground_truth[
        "fault_roots"]
    assert out["root_causes"][0]["component"] in roots
    assert out["summary"].startswith("Top root causes:")
    proc = _cli("--fixture", "5svc", "--device", "cpu", "--type", "logs",
                "--full")
    assert proc.returncode == 0, proc.stderr
    full = json.loads(proc.stdout)
    assert full["status"] == "completed" and full["results"]["logs"]


def test_cli_fails_without_a_fixture_or_on_a_bad_type(tmp_path):
    """Without a fixture the command analyzes a live cluster: with no
    kubeconfig and no ``kubectl`` it reports an empty, completed analysis
    (tests/test_torch_k8s_client.py holds it to the reference's report);
    an unknown analysis type fails."""
    proc = _cli("--device", "cpu", "--compact",
                env_extra={"KUBECONFIG": str(tmp_path / "missing")})
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)["root_causes"] == []
    proc = _cli("--fixture", "5svc", "--device", "cpu", "--type", "bogus",
                "--compact")
    assert proc.returncode == 1
    assert "unknown analysis type" in json.loads(proc.stdout)["error"]
