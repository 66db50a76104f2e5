"""The port's multi-cluster merged client
(``rca_tpu_torch.cluster.clusterset``) against the JAX package's.

Three synthetic worlds (each package's own generator, the same seeds) sit
behind each package's ``ClusterSet``; every getter of the port's
``MergedClusterClient`` and ``BoundClusterClient`` returns the
reference's answer, the merged watch feed drains the same changes after
the same touches, ``get_columnar`` (the live columnar adapter over the
merged view) returns the reference's payload, and the digests and the
identity rules agree.
"""

import math

import numpy as np
import pytest

from rca_tpu.cluster.clusterset import ClusterSet as RefClusterSet
from rca_tpu.cluster.generator import synthetic_cascade_world as ref_world
from rca_tpu.cluster.mock_client import MockClusterClient as RefMock
from rca_tpu_torch.cluster.clusterset import (
    CLUSTER_LABEL,
    ClusterSet,
    _NS_LIST_GETTERS,
)
from rca_tpu_torch.cluster.generator import synthetic_cascade_world
from rca_tpu_torch.cluster.mock_client import MockClusterClient

NS = "synthetic"
SEEDS = {"c0": 11, "c1": 12, "c2": 13}


def _same(a, b) -> bool:
    """Deep equality with ndarrays compared by dtype, shape and bytes and
    NaN equal to NaN."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return (a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return type(a) is type(b) and a == b


def _sets():
    """A fresh pair of (port, reference) cluster sets over 3 worlds of 30
    services each; the worlds too, to touch."""
    port_worlds = {c: synthetic_cascade_world(30, n_roots=1, seed=s)
                   for c, s in SEEDS.items()}
    ref_worlds = {c: ref_world(30, n_roots=1, seed=s)
                  for c, s in SEEDS.items()}
    port = ClusterSet({c: MockClusterClient(w)
                       for c, w in port_worlds.items()})
    ref = RefClusterSet({c: RefMock(w) for c, w in ref_worlds.items()})
    return port, ref, port_worlds, ref_worlds


@pytest.fixture(scope="module")
def merged():
    port, ref, _, _ = _sets()
    pm, rm = port.merged_client(), ref.merged_client()
    yield port, ref, pm, rm
    pm.close()
    rm.close()


@pytest.mark.parametrize("getter", _NS_LIST_GETTERS)
def test_merged_list_getter_matches_reference(merged, getter):
    _, _, pm, rm = merged
    got, want = getattr(pm, getter)(NS), getattr(rm, getter)(NS)
    assert _same(got, want)


@pytest.mark.parametrize("call", [
    ("get_namespaces", ()),
    ("get_nodes", ()),
    ("get_node_metrics", ()),
    ("get_pod_metrics", (NS,)),
    ("get_service_latency_stats", (NS,)),
    ("get_error_rate_by_service", (NS,)),
    ("get_service_dependencies", (NS,)),
    ("find_slow_operations", (NS, 100.0)),
    ("get_trace_ids", (NS, 50)),
    ("get_cluster_info", ()),
    ("collect_errors", ()),
    ("is_connected", ()),
    ("get_current_time", ()),
], ids=lambda c: c[0])
def test_merged_getter_matches_reference(merged, call):
    _, _, pm, rm = merged
    name, args = call
    assert _same(getattr(pm, name)(*args), getattr(rm, name)(*args))


def test_routed_single_object_access_matches_reference(merged):
    _, _, pm, rm = merged
    pods = pm.get_pods(NS)
    assert pods and all(
        p["metadata"]["labels"][CLUSTER_LABEL] == p["metadata"]["name"]
        .split("/")[0] for p in pods)
    for pod in pods[::7]:
        name = pod["metadata"]["name"]
        assert _same(pm.get_pod(NS, name), rm.get_pod(NS, name))
        assert pm.get_pod_logs(NS, name, tail_lines=20) == rm.get_pod_logs(
            NS, name, tail_lines=20)
    # a name with no known cluster prefix routes nowhere, in both
    for bad in ("nope", "c9/pod-x"):
        assert pm.get_pod(NS, bad) is None and rm.get_pod(NS, bad) is None
        assert pm.get_pod_logs(NS, bad) == rm.get_pod_logs(NS, bad) == ""


def test_merged_watch_and_columnar_match_reference():
    port, ref, port_worlds, ref_worlds = _sets()
    pm, rm = port.merged_client(), ref.merged_client()
    try:
        pc, rc = pm.watch_changes(NS, None), rm.watch_changes(NS, None)
        assert _same(pc, rc)
        p_col, r_col = pm.get_columnar(NS), rm.get_columnar(NS)
        assert _same(p_col, r_col)
        for cid, i in (("c0", 3), ("c2", 17), ("c1", 5), ("c0", 29)):
            name = f"pod-svc-{i:05d}"
            port_worlds[cid].touch("pod_metrics", NS, name)
            ref_worlds[cid].touch("pod_metrics", NS, name)
            got = pm.watch_changes(NS, pc["cursor"])
            want = rm.watch_changes(NS, rc["cursor"])
            assert _same(got, want)
            assert any(c.get("name", "").startswith(f"{cid}/")
                       for c in got["changes"])
            p_col = pm.get_columnar(NS, p_col.get("cursor"))
            r_col = rm.get_columnar(NS, r_col.get("cursor"))
            assert _same(p_col, r_col)
        # an unknown merged cursor is expired, in both
        assert _same(pm.watch_changes(NS, "mc999"),
                     rm.watch_changes(NS, "mc999"))
        pm.watch_close(NS, pc["cursor"])
        rm.watch_close(NS, rc["cursor"])
    finally:
        pm.close()
        rm.close()


def test_bound_client_and_digests_match_reference():
    port, ref, _, _ = _sets()
    assert port.ids == ref.ids == sorted(SEEDS)
    assert port.namespaces() == ref.namespaces()
    for merged_ns in port.namespaces():
        assert port.split(merged_ns) == ref.split(merged_ns)
        pb, rb = port.bound(merged_ns), ref.bound(merged_ns)
        assert _same(pb.get_pods(merged_ns), rb.get_pods(merged_ns))
        assert _same(pb.get_service_dependencies(merged_ns),
                     rb.get_service_dependencies(merged_ns))
        assert _same(pb.get_nodes(), rb.get_nodes())
    for cid in port.ids:
        assert port.cluster_digest(cid) == ref.cluster_digest(cid)
    assert port.graph_digest() == ref.graph_digest()
    # the digest does not depend on member order
    worlds = {c: MockClusterClient(synthetic_cascade_world(30, n_roots=1,
                                                           seed=s))
              for c, s in reversed(list(SEEDS.items()))}
    assert ClusterSet(worlds).graph_digest() == port.graph_digest()


@pytest.mark.parametrize("members", [
    {},
    {"": None},
    {"a/b": None},
    {" a": None},
], ids=["empty", "blank-id", "separator-id", "edge-whitespace"])
def test_identity_rules_reject_as_the_reference(members):
    with pytest.raises(ValueError) as got:
        ClusterSet(members)
    with pytest.raises(ValueError) as want:
        RefClusterSet(members)
    assert str(got.value) == str(want.value)


def test_split_rejects_as_the_reference():
    port, ref, _, _ = _sets()
    for bad in ("synthetic", "c9/synthetic", "c0/"):
        with pytest.raises(KeyError) as got:
            port.split(bad)
        with pytest.raises(KeyError) as want:
            ref.split(bad)
        assert str(got.value) == str(want.value)
