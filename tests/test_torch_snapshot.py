"""The port's host layer against the JAX package's, bit for bit.

Each world is generated by each package's own generator from the same
seed and captured by each package's own mock client; the port's snapshot,
extracted features, typed graph and service dependency edges must equal
the reference's exactly.  Both packages run under their default settings
(columnar capture) and again with ``RCA_COLUMNAR=0`` (the dict sweep).
The log scanner and the object sanitizer are held to the reference's
functions on the same worlds' logs and objects.
"""

import copy
import dataclasses

import numpy as np
import pytest

from rca_tpu.cluster.fixtures import NS as REF_NS
from rca_tpu.cluster.fixtures import five_service_world as ref_five
from rca_tpu.cluster.generator import synthetic_cascade_world as ref_world
from rca_tpu.cluster.mock_client import MockClusterClient as RefClient
from rca_tpu.cluster.sanitize import sanitize_object as ref_sanitize
from rca_tpu.cluster.snapshot import ClusterSnapshot as RefSnapshot
from rca_tpu.engine import GraphEngine as RefEngine
from rca_tpu.features.extract import extract_features as ref_extract
from rca_tpu.features.logscan import scan_text as ref_scan_text
from rca_tpu.features.logscan import scan_text_python as ref_scan_python
from rca_tpu.graph.build import build_typed_graph as ref_typed_graph
from rca_tpu.graph.build import service_dependency_edges as ref_dep_edges
from rca_tpu_torch.cluster.fixtures import NS, five_service_world
from rca_tpu_torch.cluster.generator import synthetic_cascade_world
from rca_tpu_torch.cluster.mock_client import MockClusterClient
from rca_tpu_torch.cluster.sanitize import sanitize_object, sanitize_objects
from rca_tpu_torch.cluster.snapshot import ClusterSnapshot
from rca_tpu_torch.engine import GraphEngine
from rca_tpu_torch.features.extract import extract_features
from rca_tpu_torch.features.logscan import scan_text_python
from rca_tpu_torch.graph.build import (
    build_typed_graph,
    service_dependency_edges,
)

# (name, port world + namespace, reference world + namespace)
WORLDS = {
    "5svc": (lambda: (five_service_world(), NS),
             lambda: (ref_five(), REF_NS)),
    "50svc": (lambda: (synthetic_cascade_world(
                  50, n_roots=1, seed=7, namespace="synthetic"), "synthetic"),
              lambda: (ref_world(
                  50, n_roots=1, seed=7, namespace="synthetic"),
                  "synthetic")),
    "300svc_mixed": (
        lambda: (synthetic_cascade_world(
            300, n_roots=2, seed=5, mode="adversarial", fault_mix="mixed"),
            "synthetic"),
        lambda: (ref_world(
            300, n_roots=2, seed=5, mode="adversarial", fault_mix="mixed"),
            "synthetic")),
}
WORLD_FIELDS = ("cluster_name", "pods", "services", "deployments",
                "statefulsets", "daemonsets", "cronjobs", "events",
                "endpoints", "ingresses", "network_policies", "configmaps",
                "secrets", "pvcs", "resource_quotas", "hpas", "logs",
                "previous_logs", "pod_metrics", "nodes", "node_metrics",
                "traces", "ground_truth")


@pytest.fixture(scope="module")
def worlds():
    return {name: (port(), ref()) for name, (port, ref) in WORLDS.items()}


@pytest.fixture(params=["default", "dict_sweep"])
def columnar_setting(request, monkeypatch):
    """Both packages' default capture (columnar), then their dict sweep."""
    if request.param == "dict_sweep":
        monkeypatch.setenv("RCA_COLUMNAR", "0")
    else:
        monkeypatch.delenv("RCA_COLUMNAR", raising=False)
    return request.param


def _captures(worlds, name):
    (pw, ns), (rw, rns) = worlds[name]
    assert ns == rns
    port = ClusterSnapshot.capture(MockClusterClient(pw), ns)
    ref = RefSnapshot.capture(RefClient(rw), rns)
    return port, ref


@pytest.mark.parametrize("name", WORLDS)
def test_world_copy_is_equal(worlds, name):
    (pw, _), (rw, _) = worlds[name]
    for field in WORLD_FIELDS:
        assert getattr(pw, field) == getattr(rw, field), field


@pytest.mark.parametrize("mode,fault_mix", [
    *[("standard", mix) for mix in ("crash", "mixed", "oom", "image",
                                    "config", "pending")],
    *[(mode, "mixed") for mode in ("crashing_victims", "missing_signals",
                                   "correlated_noise", "overlapping_roots",
                                   "adversarial")],
])
def test_world_generator_copy_every_mode_and_fault_mix(mode, fault_mix):
    pw = synthetic_cascade_world(40, n_roots=2, seed=3, mode=mode,
                                 fault_mix=fault_mix)
    rw = ref_world(40, n_roots=2, seed=3, mode=mode, fault_mix=fault_mix)
    for field in WORLD_FIELDS:
        assert getattr(pw, field) == getattr(rw, field), field
    port = extract_features(ClusterSnapshot.capture(MockClusterClient(pw),
                                                    "synthetic"))
    ref = ref_extract(RefSnapshot.capture(RefClient(rw), "synthetic"))
    assert np.array_equal(port.service_features, ref.service_features)
    assert np.array_equal(port.pod_features, ref.pod_features)


@pytest.mark.parametrize("name", WORLDS)
def test_snapshot_equals_reference(worlds, name, columnar_setting):
    port, ref = _captures(worlds, name)
    names = [f.name for f in dataclasses.fields(port)]
    assert names == [f.name for f in dataclasses.fields(ref)]
    # the columnar view is never part of the value
    for field in names[:-1]:
        assert getattr(port, field) == getattr(ref, field), field
    assert names[-1] == "columnar"
    assert port.errors == []
    # the default captures through the columnar feed on both
    on = columnar_setting == "default"
    assert (port.columnar is not None) == (ref.columnar is not None) == on


@pytest.mark.parametrize("name", WORLDS)
def test_features_equal_reference(worlds, name, columnar_setting):
    port_snap, ref_snap = _captures(worlds, name)
    port, ref = extract_features(port_snap), ref_extract(ref_snap)
    assert port.namespace == ref.namespace
    for field in ("pod_names", "service_names", "node_names"):
        assert getattr(port, field) == getattr(ref, field), field
    for field in ("pod_features", "service_features", "pod_service",
                  "memb_pod", "memb_svc", "pod_node", "node_features"):
        got, want = getattr(port, field), np.asarray(getattr(ref, field))
        assert got.dtype == want.dtype, field
        assert np.array_equal(got, want), field


@pytest.mark.parametrize("name", WORLDS)
def test_typed_graph_and_dependency_edges_equal_reference(
        worlds, name, columnar_setting):
    port_snap, ref_snap = _captures(worlds, name)
    port_g, ref_g = build_typed_graph(port_snap), ref_typed_graph(ref_snap)
    assert port_g.node_names == ref_g.node_names
    assert port_g.missing_refs == ref_g.missing_refs
    for field in ("node_types", "edge_src", "edge_dst", "edge_types"):
        got, want = getattr(port_g, field), getattr(ref_g, field)
        assert got.dtype == want.dtype, field
        assert np.array_equal(got, want), field
    assert port_g.to_dict() == ref_g.to_dict()
    port_e = service_dependency_edges(port_snap, extract_features(port_snap),
                                      port_g)
    ref_e = ref_dep_edges(ref_snap, ref_extract(ref_snap), ref_g)
    for got, want in zip(port_e, ref_e):
        assert got.dtype == want.dtype
        assert np.array_equal(got, want)
    if name != "5svc":
        assert len(port_e[0]) > 0


@pytest.mark.parametrize("name", WORLDS)
def test_log_scan_equals_reference(worlds, name):
    (pw, _), _ = worlds[name]
    texts = [text for by_pod in pw.logs.values()
             for by_container in by_pod.values()
             for text in by_container.values()]
    texts += ["", "Connection refused; ECONNREFUSED\nTimed-out after 5s",
              "panic: OOMKilled ImagePullBackOff StatusCode=503 "
              "configmap \"x\" not found"]
    assert len(texts) > 3
    for text in texts:
        got = scan_text_python(text)
        assert got.dtype == np.int32
        assert np.array_equal(got, ref_scan_python(text))
        assert np.array_equal(got, ref_scan_text(text))


# objects a live API server can return: null subtrees, nameless containers,
# non-string labels, a status string inside a condition
_MALFORMED = [
    {"metadata": None, "spec": None, "status": {"phase": None}},
    {"metadata": {"name": None, "labels": {"app": 3, "tier": None}},
     "spec": {"containers": [None, {"image": "x"}],
              "volumes": None},
     "status": {"conditions": [{"type": "Ready", "status": "True"}],
                "containerStatuses": [{"restartCount": None,
                                       "state": None}]}},
    {"metadata": {"name": "p", "labels": None},
     "spec": {"containers": [{"name": "c", "env": [{"name": "A"},
                                                   None]}]}},
    "not an object",
]


@pytest.mark.parametrize("name", WORLDS)
def test_sanitize_equals_reference(worlds, name):
    (pw, _), _ = worlds[name]
    objects = [obj for store in (pw.pods, pw.services, pw.deployments,
                                 pw.events, pw.endpoints, pw.network_policies,
                                 pw.ingresses, pw.hpas)
               for objs in store.values() for obj in objs] + list(pw.nodes)
    assert objects
    for obj in objects + _MALFORMED:
        got = sanitize_object(copy.deepcopy(obj))
        assert got == ref_sanitize(copy.deepcopy(obj))
    cleaned = sanitize_objects(_MALFORMED)
    assert len(cleaned) == 3
    assert all(c["metadata"]["name"] == "" or c["metadata"]["name"] == "p"
               for c in cleaned)


def test_features_of_an_empty_namespace_equal_reference(worlds):
    (pw, _), (rw, _) = worlds["5svc"]
    port = extract_features(
        ClusterSnapshot.capture(MockClusterClient(pw), "absent"))
    ref = ref_extract(RefSnapshot.capture(RefClient(rw), "absent"))
    assert port.pod_names == ref.pod_names == []
    assert port.service_names == ref.service_names == []
    assert port.node_names == ref.node_names
    for field in ("pod_features", "service_features", "pod_service",
                  "memb_pod", "memb_svc", "pod_node", "node_features"):
        got, want = getattr(port, field), np.asarray(getattr(ref, field))
        assert got.shape == want.shape and got.dtype == want.dtype, field
        assert np.array_equal(got, want), field


@pytest.mark.parametrize("name", ["5svc", "50svc"])
def test_analyze_snapshot_matches_reference(worlds, name):
    port_snap, ref_snap = _captures(worlds, name)
    port = GraphEngine(device="cpu").analyze_snapshot(port_snap)
    ref = RefEngine(resident=False).analyze_snapshot(ref_snap)
    assert port.top_components() == ref.top_components()
    assert (port.n_services, port.n_edges) == (ref.n_services, ref.n_edges)
    np.testing.assert_allclose(port.score, np.asarray(ref.score),
                               rtol=1e-5, atol=1e-6)
