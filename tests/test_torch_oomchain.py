"""The 200-pod OOMKill-chain configuration (BASELINE.md row 3) in the port
(``rca_tpu_torch/cluster/oomchain.py``) against the JAX package's.

- ``oom_chain_topology`` and ``oom_chain_world`` equal the reference's:
  services, parents, replicas, every world field, the ground truth, and
  the captured snapshot's feature arrays bit for bit;
- ``measure_analyze(..., device="cpu")`` returns the reference's keys and
  ranks as the reference's ``measure_analyze`` does on the same world
  (``top5``, ``hit1``, ``hit3``), both engines on the packaged weights
  (held equal through ``params_from_jax``), with ``backend`` ``torch``
  and no ``fallback_reason``;
- with no card and no device named, the coordinator it builds raises.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rca_tpu.cluster.mock_client import MockClusterClient as RefClient
from rca_tpu.cluster.oomchain import measure_analyze as ref_measure
from rca_tpu.cluster.oomchain import oom_chain_topology as ref_topology
from rca_tpu.cluster.oomchain import oom_chain_world as ref_world
from rca_tpu.cluster.snapshot import ClusterSnapshot as RefSnapshot
from rca_tpu.engine import GraphEngine as RefEngine
from rca_tpu.features.extract import extract_features as ref_extract
from rca_tpu.graph.build import build_typed_graph as ref_typed_graph
from rca_tpu.graph.build import service_dependency_edges as ref_dep_edges
from rca_tpu_torch.cluster.mock_client import MockClusterClient
from rca_tpu_torch.cluster.oomchain import (
    OOM_NS,
    OOM_ROOT,
    ROOT_REPLICAS,
    measure_analyze,
    oom_chain_topology,
    oom_chain_world,
)
from rca_tpu_torch.cluster.snapshot import ClusterSnapshot
from rca_tpu_torch.engine import GraphEngine
from rca_tpu_torch.engine.params import params_from_jax
from rca_tpu_torch.features.extract import extract_features
from rca_tpu_torch.graph.build import (
    build_typed_graph,
    service_dependency_edges,
)

WORLD_FIELDS = ("cluster_name", "pods", "services", "deployments",
                "statefulsets", "daemonsets", "cronjobs", "events",
                "endpoints", "ingresses", "network_policies", "configmaps",
                "secrets", "pvcs", "resource_quotas", "hpas", "logs",
                "previous_logs", "pod_metrics", "nodes", "node_metrics",
                "traces", "ground_truth")


@pytest.fixture
def clean_env(monkeypatch):
    for name in ("RCA_BACKEND", "RCA_EXPLAIN", "RCA_COLUMNAR", "RCA_KERNEL",
                 "RCA_WEIGHTS"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("RCA_KERNEL_CACHE", "off")


@pytest.mark.parametrize("n_pods,replicas", [(200, 3), (50, 3), (500, 2)])
def test_topology_equals_reference(n_pods, replicas):
    port = oom_chain_topology(n_pods, replicas)
    assert port == ref_topology(n_pods, replicas)
    services, parent, reps = port
    assert services[0] == OOM_ROOT and reps[OOM_ROOT] == ROOT_REPLICAS
    assert set(parent) == set(services[1:])


@pytest.fixture(scope="module")
def worlds():
    return oom_chain_world(200), ref_world(200)


def test_world_equals_reference(worlds):
    port, ref = worlds
    for field in WORLD_FIELDS:
        assert getattr(port, field) == getattr(ref, field), field
    assert port.ground_truth["n_pods"] == 200
    assert port.ground_truth["fault_roots"] == [OOM_ROOT]
    services, parent, _ = oom_chain_topology(200)
    assert port.traces["dependencies"][OOM_NS] == {
        svc: [parent[svc]] for svc in services if svc in parent}


@pytest.mark.parametrize("columnar", ["1", "0"])
def test_snapshot_features_equal_reference_bitwise(worlds, columnar,
                                                   monkeypatch):
    monkeypatch.setenv("RCA_COLUMNAR", columnar)
    port_w, ref_w = worlds
    port_snap = ClusterSnapshot.capture(MockClusterClient(port_w), OOM_NS)
    ref_snap = RefSnapshot.capture(RefClient(ref_w), OOM_NS)
    port, ref = extract_features(port_snap), ref_extract(ref_snap)
    assert port.service_names == ref.service_names
    assert len(port.service_names) == 67
    for field in ("pod_features", "service_features", "pod_service",
                  "memb_pod", "memb_svc", "pod_node", "node_features"):
        got, want = getattr(port, field), np.asarray(getattr(ref, field))
        assert got.dtype == want.dtype, field
        assert np.array_equal(got, want), field
    port_e = service_dependency_edges(port_snap, port,
                                      build_typed_graph(port_snap))
    ref_e = ref_dep_edges(ref_snap, ref, ref_typed_graph(ref_snap))
    for got, want in zip(port_e, ref_e):
        assert np.array_equal(got, want)
    assert len(port_e[0]) == 66  # the tree: one edge per victim


def test_both_engines_rank_on_the_same_weights():
    ref = RefEngine().params
    carried = params_from_jax(
        np.asarray(ref.anomaly_weights), np.asarray(ref.hard_weights),
        ref.steps, ref.decay, ref.explain_strength, ref.impact_bonus,
        ref.error_contrast)
    assert GraphEngine(device="cpu").params == carried


def test_measure_analyze_matches_reference(worlds, clean_env):
    port_w, ref_w = worlds
    out = measure_analyze(MockClusterClient(port_w), OOM_NS, OOM_ROOT,
                          device="cpu")
    ref = ref_measure(RefClient(ref_w), OOM_NS, OOM_ROOT)
    assert set(out) == set(ref)
    assert out["status"] == ref["status"] == "completed"
    assert out["backend"] == "torch" and ref["backend"] == "jax"
    assert out["fallback_reason"] is None and ref["fallback_reason"] is None
    assert out["environment"] == ref["environment"] == "hermetic-mock"
    for key in ("metric", "namespace", "expected_root", "top5", "hit1",
                "hit3"):
        assert out[key] == ref[key], key
    assert out["hit1"] is True and out["top5"][0] == OOM_ROOT
    assert out["engine"] == "single"
    assert out["latency_warm_ms"] > 0 and out["engine_latency_ms"] > 0


def test_measure_analyze_deterministic_backend(worlds, clean_env):
    port_w, ref_w = worlds
    out = measure_analyze(MockClusterClient(port_w), OOM_NS, OOM_ROOT,
                          backend="deterministic", device="cpu")
    ref = ref_measure(RefClient(ref_w), OOM_NS, OOM_ROOT,
                      backend="deterministic")
    assert out["status"] == ref["status"] == "completed"
    assert out["backend"] == ref["backend"] == "deterministic"
    assert out["top5"] == ref["top5"]
    assert any(OOM_ROOT in c for c in out["top5"])


def test_measure_analyze_names_a_live_client_live(monkeypatch):
    """Any client but the mock is recorded as a live cluster, so a mock
    measurement never reads as a live one."""
    import rca_tpu_torch.coordinator as coordinator

    class Live:
        pass

    class _Coord:
        def __init__(self, client, backend=None, device=None):
            self.device = device

        def run_analysis(self, kind, namespace):
            return {"status": "completed", "results": {"correlated": {
                "backend": "torch", "root_causes": [
                    {"component": OOM_ROOT}]}}}

    monkeypatch.setattr(coordinator, "RCACoordinator", _Coord)
    out = measure_analyze(Live(), OOM_NS, OOM_ROOT, device="cpu")
    assert out["environment"] == "live-kind"
    assert out["hit1"] and out["top5"] == [OOM_ROOT]


def test_measure_analyze_without_a_card_raises(worlds):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card rule does not "
                    "apply")
    with pytest.raises(RuntimeError, match="CUDA device"):
        measure_analyze(MockClusterClient(worlds[0]), OOM_NS, OOM_ROOT)
