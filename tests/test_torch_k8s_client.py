"""The port's live-cluster client against the JAX package's: the watch
pumps, the kubeconfig and context surface, the quantity parsers, the
Jaeger trace backend, the live columnar feed, the retry policy and the
``analyze`` command with no cluster.

The ``kubernetes`` SDK is not installed, so the pump and watch-surface
tests install an in-process stub of it (``sys.modules`` and
``HAVE_K8S_LIB`` through ``monkeypatch``); every test that starts pumps
stops them in ``finally``, waits with a bounded poll and leaves no pump
thread running.  The trace backend is driven from recorded Jaeger JSON
through an injected opener (no request leaves the process).  The live
columnar feed runs over the mock client, as the live client would run it
over a connected cluster, and is held to the reference's feed and to the
mock's own columnar feed.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import threading
import time
import types
import urllib.parse
from pathlib import Path

import numpy as np
import pytest

from rca_tpu.cluster.generator import synthetic_cascade_world as ref_world
from rca_tpu.cluster.k8s_client import K8sApiClient as RefK8s
from rca_tpu.cluster.k8s_client import parse_cpu as ref_parse_cpu
from rca_tpu.cluster.k8s_client import parse_memory as ref_parse_memory
from rca_tpu.cluster.live_columnar import LiveColumnarFeed as RefFeed
from rca_tpu.cluster.columnar import ColumnarClientState as RefState
from rca_tpu.cluster.mock_client import MockClusterClient as RefClient
from rca_tpu.cluster.snapshot import ClusterSnapshot as RefSnapshot
from rca_tpu.cluster.trace_backend import JaegerTraceBackend as RefJaeger
from rca_tpu_torch.cluster.columnar import ColumnarClientState
from rca_tpu_torch.cluster.generator import synthetic_cascade_world
from rca_tpu_torch.cluster.k8s_client import (
    K8sApiClient,
    parse_cpu,
    parse_memory,
)
from rca_tpu_torch.cluster.live_columnar import LiveColumnarFeed
from rca_tpu_torch.cluster.mock_client import MockClusterClient
from rca_tpu_torch.cluster.protocol import (
    CLUSTER_CLIENT_METHODS,
    ClusterClient,
)
from rca_tpu_torch.cluster.snapshot import ClusterSnapshot
from rca_tpu_torch.cluster.trace_backend import JaegerTraceBackend
from rca_tpu_torch.cluster.world import make_pod
from rca_tpu_torch.features.extract import extract_features

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def no_kubectl(monkeypatch):
    """Whatever the host has, no ``kubectl`` on the PATH."""
    path = os.pathsep.join(
        d for d in os.environ.get("PATH", "").split(os.pathsep)
        if d and not os.path.exists(os.path.join(d, "kubectl")))
    monkeypatch.setenv("PATH", path)


# -- the kubernetes SDK stub -------------------------------------------------

class _Meta:
    def __init__(self, name, rv):
        self.name = name
        self.resource_version = rv


class _Involved:
    def __init__(self, name):
        self.name = name


class _PodObj:
    def __init__(self, name, rv="101"):
        self.metadata = _Meta(name, rv)


class _EventObj:
    def __init__(self, involved, rv="201"):
        self.metadata = _Meta("evt-x", rv)
        self.involved_object = _Involved(involved)


class _BookmarkObj:
    def __init__(self, rv):
        self.metadata = _Meta("", rv)


def _install_kubernetes_stub(monkeypatch, pod_events, event_events,
                             die_after=False, seen_rvs=None):
    """A stub ``kubernetes.watch.Watch`` whose stream yields canned events
    once, then (optionally) raises like a 410, else idles briefly."""
    mod = types.ModuleType("kubernetes")
    watch_mod = types.ModuleType("kubernetes.watch")

    class _Watch:
        def stream(self, list_fn, namespace=None, timeout_seconds=None,
                   resource_version=None, allow_watch_bookmarks=None):
            if seen_rvs is not None:
                seen_rvs.append(resource_version)
            batch = pod_events if "pod" in list_fn.__name__ else event_events
            yield from batch
            batch.clear()  # the second round yields nothing
            if die_after:
                raise RuntimeError("Expired: too old resource version (410)")
            time.sleep(0.05)

        def stop(self):
            pass

    watch_mod.Watch = _Watch
    mod.watch = watch_mod
    monkeypatch.setitem(sys.modules, "kubernetes", mod)
    monkeypatch.setitem(sys.modules, "kubernetes.watch", watch_mod)


class _ListResp:
    def __init__(self, rv):
        self.metadata = _Meta("", rv)
        self.items = []


class _FakeCore:
    """The initial limit=1 list returns the collection RV the pump pins
    its first stream to."""

    def list_namespaced_pod(self, *a, **k):
        return _ListResp("100")

    def list_namespaced_event(self, *a, **k):
        return _ListResp("200")


def _wait_until(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def _stop(*pump_sets):
    """Stop the sets and wait (bounded) until none of their threads runs."""
    for pumps in pump_sets:
        pumps.stop()
    for pumps in pump_sets:
        for t in pumps._threads:
            t.join(timeout=5)
            assert not t.is_alive(), t.name


def _stub_client(monkeypatch):
    from rca_tpu_torch.cluster import k8s_client as kc

    monkeypatch.setattr(kc, "HAVE_K8S_LIB", True)
    client = K8sApiClient.__new__(K8sApiClient)  # skip kubeconfig loading
    client._connected = True
    client._core = _FakeCore()
    client._errors = []
    client._kubectl = None
    client._kubeconfig = None
    client._context = None
    client._verify_ssl = True
    return client


def _client_pumps(client):
    return list(getattr(client, "_pumps", {}).values())


# -- watch pumps -------------------------------------------------------------

def test_watch_pumps_queue_changes(monkeypatch):
    _install_kubernetes_stub(
        monkeypatch,
        pod_events=[{"type": "ADDED", "object": _PodObj("db-0")},
                    {"type": "MODIFIED", "object": _PodObj("db-0")},
                    {"type": "ADDED", "object": _PodObj("web-1")}],
        event_events=[{"type": "ADDED", "object": _EventObj("db-0")}],
    )
    from rca_tpu_torch.cluster.watch_pump import WatchPumpSet

    pumps = WatchPumpSet(_FakeCore(), "prod")
    token = pumps.register()
    pumps.start()
    try:
        assert _wait_until(lambda: len(pumps._journal) >= 3)
        changes = pumps.drain(token)
        # dedup within a drain; the involved object's name from events
        assert {(c["kind"], c["name"]) for c in changes} == {
            ("pod", "db-0"), ("pod", "web-1"), ("event", "db-0"),
        }
        # the delivered object's resourceVersion rides along
        assert {c.get("rv") for c in changes if c["kind"] == "pod"} == \
            {"101"}
        assert not pumps.expired
    finally:
        _stop(pumps)


def test_watch_pump_tracks_resource_version(monkeypatch):
    """The no-replay contract: the first stream resumes from the initial
    list's collection RV, later streams from the last event or bookmark
    RV."""
    seen_rvs = []
    _install_kubernetes_stub(
        monkeypatch,
        pod_events=[{"type": "MODIFIED", "object": _PodObj("db-0", rv="150")},
                    {"type": "BOOKMARK", "object": _BookmarkObj("175")}],
        event_events=[],
        seen_rvs=seen_rvs,
    )
    from rca_tpu_torch.cluster.watch_pump import WatchPumpSet

    pumps = WatchPumpSet(_FakeCore(), "prod")
    token = pumps.register()
    pumps.start()
    try:
        assert _wait_until(lambda: "175" in seen_rvs)
        assert "100" in seen_rvs and "200" in seen_rvs
        # a bookmark advances the RV but enqueues nothing
        assert {(c["kind"], c["name"]) for c in pumps.drain(token)} == {
            ("pod", "db-0"),
        }
    finally:
        _stop(pumps)


def test_watch_pump_error_marks_expired(monkeypatch):
    _install_kubernetes_stub(
        monkeypatch,
        pod_events=[{"type": "ADDED", "object": _PodObj("p")}],
        event_events=[],
        die_after=True,
    )
    from rca_tpu_torch.cluster.watch_pump import WatchPumpSet

    pumps = WatchPumpSet(_FakeCore(), "prod")
    token = pumps.register()
    pumps.start()
    try:
        assert _wait_until(lambda: pumps.expired)
        assert pumps.drain(token) is None      # every consumer expires
    finally:
        _stop(pumps)


def test_k8s_client_watch_changes_lifecycle(monkeypatch):
    """Open, drain, namespace isolation, and a stale or foreign token
    reported as expired."""
    _install_kubernetes_stub(
        monkeypatch,
        pod_events=[{"type": "MODIFIED", "object": _PodObj("db-0")}],
        event_events=[],
    )
    client = _stub_client(monkeypatch)
    try:
        head = client.watch_changes("prod", None)
        assert head["supported"] and not head["expired"]
        assert _wait_until(
            lambda: client.watch_changes("prod", head["cursor"])["changes"]
            or client._pumps["prod"].expired
        )
        other = client.watch_changes("staging", None)
        assert other["cursor"] != head["cursor"]
        assert set(client._pumps) == {"prod", "staging"}
        assert not client.watch_changes("prod", head["cursor"])["expired"]
        stale = client.watch_changes("prod", "pumps-does-not-exist")
        assert stale["expired"] is True
    finally:
        _stop(*_client_pumps(client))


def test_pump_journal_overflow_expires_only_laggards():
    """A consumer that falls behind the journal window expires on its
    own; the set and up-to-date consumers keep working."""
    from rca_tpu_torch.cluster import watch_pump
    from rca_tpu_torch.cluster.watch_pump import WatchPumpSet

    pumps = WatchPumpSet(_FakeCore(), "prod")   # never started
    laggard = pumps.register()
    for i in range(watch_pump.QUEUE_CAP + 10):
        pumps.push("pod", f"p{i}")
    fresh = pumps.register()
    pumps.push("pod", "after-registration")
    assert pumps.drain(laggard) is None
    assert not pumps.expired
    assert pumps.drain(fresh) == [{"kind": "pod",
                                   "name": "after-registration"}]
    assert pumps.drain(laggard) is None         # stays expired


def test_watch_close_releases_journal_pin():
    """An abandoned token pins the journal's trim floor; deregistering it
    lets the window trim back down."""
    from rca_tpu_torch.cluster.watch_pump import WatchPumpSet

    pumps = WatchPumpSet(_FakeCore(), "prod")
    a = pumps.register()
    b = pumps.register()
    for i in range(100):
        pumps.push("pod", f"p{i}")
    assert len(pumps.drain(b)) == 100
    assert len(pumps._journal) == 100           # a pins the floor
    pumps.deregister(a)
    assert len(pumps._journal) == 0
    pumps.push("pod", "next")
    assert pumps.drain(b) == [{"kind": "pod", "name": "next"}]


def test_two_consumers_share_one_namespace_feed(monkeypatch):
    """Two sessions on one namespace hold their own tokens over ONE pump
    set; the second open does not invalidate the first's cursor."""
    _install_kubernetes_stub(
        monkeypatch,
        pod_events=[{"type": "MODIFIED", "object": _PodObj("db-0")}],
        event_events=[],
    )
    client = _stub_client(monkeypatch)
    try:
        a = client.watch_changes("prod", None)
        b = client.watch_changes("prod", None)
        assert a["cursor"] != b["cursor"]
        assert len(client._pumps) == 1
        pumps = client._pumps["prod"]
        assert _wait_until(lambda: pumps._next > 0)
        ra = client.watch_changes("prod", a["cursor"])
        rb = client.watch_changes("prod", b["cursor"])
        assert not ra["expired"] and not rb["expired"]
        assert ra["changes"]     # a registered before the pumps started
        ra2 = client.watch_changes("prod", a["cursor"])
        assert not ra2["expired"] and ra2["changes"] == []
        client.watch_close("prod", b["cursor"])   # releases b's token
        assert client.watch_changes("prod", b["cursor"])["expired"]
    finally:
        _stop(*_client_pumps(client))


def test_reconnect_tears_down_stale_pumps(monkeypatch):
    """Rebuilding the connection stops and clears the pump sets, so a
    stale token can never re-attach to the old cluster's feed."""
    _install_kubernetes_stub(
        monkeypatch,
        pod_events=[{"type": "MODIFIED", "object": _PodObj("db-0")}],
        event_events=[],
    )
    client = _stub_client(monkeypatch)
    head = client.watch_changes("prod", None)
    old_set = client._pumps["prod"]
    try:
        client._connect()  # the stub has no config loader: reconnect fails
        assert old_set._stop.is_set()
        assert client._pumps == {}
        assert client.collect_errors()[0]["op"] == "connect"
        client._connected = True
        client._core = _FakeCore()
        assert client.watch_changes("prod", head["cursor"])["expired"] is True
    finally:
        _stop(old_set, *_client_pumps(client))


def test_pump_stop_breaks_stream_promptly(monkeypatch):
    """``stop()`` breaks each pump's stream through ``Watch.stop()`` and
    both threads end; a teardown is not an expiry."""
    stopped = []
    mod = types.ModuleType("kubernetes")
    watch_mod = types.ModuleType("kubernetes.watch")

    class _BlockingWatch:
        def __init__(self):
            self._stopped = False

        def stream(self, list_fn, **kwargs):
            while True:  # emits nothing; only stop() breaks the loop
                if self._stopped:
                    return
                time.sleep(0.01)
                yield from ()

        def stop(self):
            self._stopped = True
            stopped.append(self)

    watch_mod.Watch = _BlockingWatch
    mod.watch = watch_mod
    monkeypatch.setitem(sys.modules, "kubernetes", mod)
    monkeypatch.setitem(sys.modules, "kubernetes.watch", watch_mod)
    from rca_tpu_torch.cluster.watch_pump import WatchPumpSet

    pumps = WatchPumpSet(_FakeCore(), "prod")
    pumps.start()
    try:
        assert _wait_until(
            lambda: all(t.watch_handle is not None for t in pumps._threads))
    finally:
        _stop(pumps)
    assert len(stopped) >= 2
    assert not pumps.expired
    assert not [t for t in threading.enumerate()
                if t in pumps._threads and t.is_alive()]


def test_looks_like_gone_matches_the_reference():
    from rca_tpu.cluster.watch_pump import _looks_like_gone as ref_gone
    from rca_tpu_torch.cluster.watch_pump import _looks_like_gone

    class ApiError(Exception):
        def __init__(self, status):
            super().__init__(f"status {status}")
            self.status = status

    for exc in (RuntimeError("Expired: too old resource version (410)"),
                ApiError(410), ApiError(500), RuntimeError("timeout"),
                RuntimeError("410 Gone")):
        assert _looks_like_gone(exc) == ref_gone(exc), exc


# -- the live client with no cluster ------------------------------------------

def test_backends_conform_to_the_protocol():
    assert CLUSTER_CLIENT_METHODS
    for cls in (MockClusterClient, K8sApiClient):
        for m in CLUSTER_CLIENT_METHODS:
            assert callable(getattr(cls, m, None)), f"{cls.__name__}.{m}"
    assert isinstance(MockClusterClient(synthetic_cascade_world(
        3, n_roots=1, seed=0)), ClusterClient)


def test_no_cluster_returns_empty_results_and_never_raises(tmp_path):
    """No kubeconfig, no ``kubectl``, no SDK: every getter answers empty,
    the watch and columnar feeds say unsupported, a capture falls back to
    the (empty) dict sweep — exactly what the reference's client does."""
    missing = str(tmp_path / "missing.yaml")
    port, ref = K8sApiClient(kubeconfig=missing), RefK8s(kubeconfig=missing)
    assert port.is_connected() is False
    calls = [("get_namespaces", ()), ("get_pods", ("ns",)),
             ("get_pod", ("ns", "p")), ("get_pod_logs", ("ns", "p")),
             ("get_recently_terminated_pods", ("ns",)),
             ("get_deployments", ("ns",)), ("get_deployment", ("ns", "d")),
             ("get_statefulsets", ("ns",)), ("get_daemonsets", ("ns",)),
             ("get_cronjobs", ("ns",)), ("get_services", ("ns",)),
             ("get_service", ("ns", "s")), ("get_endpoints", ("ns",)),
             ("get_ingresses", ("ns",)), ("get_network_policies", ("ns",)),
             ("get_configmaps", ("ns",)), ("get_secrets", ("ns",)),
             ("get_pvcs", ("ns",)), ("get_pvc", ("ns", "v")),
             ("get_resource_quotas", ("ns",)), ("get_nodes", ()),
             ("get_node_metrics", ()), ("get_pod_metrics", ("ns",)),
             ("get_hpas", ("ns",)), ("get_events", ("ns",)),
             ("get_trace_ids", ("ns",)),
             ("get_service_latency_stats", ("ns",)),
             ("get_error_rate_by_service", ("ns",)),
             ("get_service_dependencies", ("ns",)),
             ("find_slow_operations", ("ns",)),
             ("get_resource_details", ("ns", "Pod", "p")),
             ("get_cluster_info", ()), ("list_contexts", ())]
    for name, args in calls:
        assert getattr(port, name)(*args) == getattr(ref, name)(*args), name
    assert port.collect_errors() == ref.collect_errors()
    assert port.watch_changes("ns", None)["supported"] is False
    assert port.get_columnar("ns") == ref.get_columnar("ns")
    assert port.get_columnar("ns")["supported"] is False
    snap = ClusterSnapshot.capture(port, "ns")
    assert snap.columnar is None and snap.pods == [] and snap.errors == []


def test_quantity_parsers_match_the_reference():
    values = ["100m", "2", "1500000n", "250u", "0.5", "", None, "junk",
              "128Mi", "1Gi", "1G", "500K", "1Ki", "3Ti", "2Pi", "7E",
              "12345", "1e3", "2.5Gi", 3, 4.5]
    assert parse_cpu("100m") == 100.0 and parse_cpu("2") == 2000.0
    assert parse_memory("128Mi") == 128 * 2**20
    assert parse_memory("1G") == 10**9
    for v in values:
        assert parse_cpu(v) == ref_parse_cpu(v), v
        assert parse_memory(v) == ref_parse_memory(v), v


def _write_yaml(path, data):
    import yaml

    path.write_text(yaml.safe_dump(data))
    return path


def test_list_and_switch_contexts(tmp_path):
    """Contexts across a multi-file KUBECONFIG with the active one named;
    switching to an unreachable context restores the previous one; an
    unparseable file degrades to empty with the error recorded — each as
    the reference's client answers."""
    a = _write_yaml(tmp_path / "a.yaml", {
        "current-context": "dev",
        "contexts": [{"name": "dev", "context": {"cluster": "c1"}}],
        "clusters": [], "users": []})
    b = _write_yaml(tmp_path / "b.yaml", {
        "contexts": [{"name": "prod", "context": {"cluster": "c2"}}],
        "clusters": [], "users": []})
    bad = tmp_path / "bad.yaml"
    bad.write_text("{unclosed")
    for cfg in (f"{a}{os.pathsep}{b}", str(bad), f"{a}{os.pathsep}{bad}"):
        port, ref = K8sApiClient(kubeconfig=cfg), RefK8s(kubeconfig=cfg)
        assert port.list_contexts() == ref.list_contexts(), cfg
        assert [e["op"] for e in port.collect_errors(clear=False)] == \
            [e["op"] for e in ref.collect_errors(clear=False)], cfg
    client = K8sApiClient(kubeconfig=f"{a}{os.pathsep}{b}")
    ctxs = client.list_contexts()
    assert ctxs["contexts"] == ["dev", "prod"] and ctxs["current"] == "dev"
    assert client.switch_context("prod") is False
    assert client._context is None or client._context != "prod"
    client3 = K8sApiClient(kubeconfig=f"{a}{os.pathsep}{bad}")
    assert client3.list_contexts()["contexts"] == ["dev"]
    assert any(e["op"] == "list_contexts" and "bad.yaml" in e["error"]
               for e in client3.collect_errors(clear=False))


def test_update_server_url_scoped_to_active_context(tmp_path):
    """The repair rewrites only the current context's cluster, keeps a
    .bak of the original and fails loudly when nothing matches."""
    import yaml

    cfg = {
        "apiVersion": "v1", "current-context": "dev",
        "contexts": [
            {"name": "dev", "context": {"cluster": "dev-cluster"}},
            {"name": "prod", "context": {"cluster": "prod-cluster"}}],
        "clusters": [
            {"name": "dev-cluster",
             "cluster": {"server": "https://old-tunnel:6443"}},
            {"name": "prod-cluster",
             "cluster": {"server": "https://prod:6443"}}],
        "users": [],
    }
    path = _write_yaml(tmp_path / "kubeconfig.yaml", cfg)
    ref_path = _write_yaml(tmp_path / "ref.yaml", cfg)
    ok = K8sApiClient(kubeconfig=str(path)).update_server_url(
        "https://tunnel.example:443")
    ref_ok = RefK8s(kubeconfig=str(ref_path)).update_server_url(
        "https://tunnel.example:443")
    assert ok == ref_ok
    assert yaml.safe_load(path.read_text()) == \
        yaml.safe_load(ref_path.read_text())
    servers = {c["name"]: c["cluster"]["server"]
               for c in yaml.safe_load(path.read_text())["clusters"]}
    assert servers == {"dev-cluster": "https://tunnel.example:443",
                       "prod-cluster": "https://prod:6443"}
    backup = yaml.safe_load((tmp_path / "kubeconfig.yaml.bak").read_text())
    assert backup["clusters"][0]["cluster"]["server"] == \
        "https://old-tunnel:6443"
    empty = _write_yaml(tmp_path / "empty.yaml", {"clusters": []})
    client2 = K8sApiClient(kubeconfig=str(empty))
    assert client2.update_server_url("https://x") is False
    assert any(e["op"] == "update_server_url"
               for e in client2.collect_errors(clear=False))


def test_update_server_url_multi_file_kubeconfig(tmp_path):
    first = _write_yaml(tmp_path / "first.yaml", {
        "clusters": [{"name": "other",
                      "cluster": {"server": "https://other:6443"}}],
        "contexts": [{"name": "o", "context": {"cluster": "other"}}]})
    second = _write_yaml(tmp_path / "second.yaml", {
        "current-context": "dev",
        "contexts": [{"name": "dev", "context": {"cluster": "dev-cluster"}}],
        "clusters": [{"name": "dev-cluster",
                      "cluster": {"server": "https://old:6443"}}]})
    client = K8sApiClient(kubeconfig=os.pathsep.join([str(first),
                                                      str(second)]))
    client.update_server_url("https://new:443")
    assert "https://other:6443" in first.read_text()
    assert "https://new:443" in second.read_text()


def test_reload_config_reports_connection_state(tmp_path):
    client = K8sApiClient(kubeconfig=str(tmp_path / "missing.yaml"))
    assert client.reload_config() is False
    assert client.get_pods("default") == []


def test_update_server_url_retry_preserves_first_backup(tmp_path):
    import yaml

    path = _write_yaml(tmp_path / "kc.yaml", {
        "current-context": "dev",
        "contexts": [{"name": "dev", "context": {"cluster": "c1"}}],
        "clusters": [{"name": "c1",
                      "cluster": {"server": "https://original:6443"}}]})
    client = K8sApiClient(kubeconfig=str(path))
    client.update_server_url("https://typo:443")
    client.update_server_url("https://corrected:443")
    backup = yaml.safe_load((tmp_path / "kc.yaml.bak").read_text())
    assert backup["clusters"][0]["cluster"]["server"] == \
        "https://original:6443"
    assert "https://corrected:443" in path.read_text()


# -- the Jaeger trace backend over recorded JSON -------------------------------

US = 1000  # microseconds per ms
ENDPOINT = "http://localhost:16686"


def _span(span_id, op, start_ms, dur_ms, process="p1", error=False,
          status=None, trace_id="t1"):
    tags = []
    if error:
        tags.append({"key": "error", "value": True})
    if status is not None:
        tags.append({"key": "http.status_code", "value": status})
    return {"traceID": trace_id, "spanID": span_id, "operationName": op,
            "startTime": start_ms * US, "duration": dur_ms * US,
            "processID": process, "tags": tags}


PROCS = {"p1": {"serviceName": "frontend"}, "p2": {"serviceName": "backend"}}
TRACE_A = {"traceID": "abc123", "processes": PROCS, "spans": [
    _span("s1", "GET /", 1000, 200, "p1", trace_id="abc123"),
    _span("s2", "SELECT", 1050, 600, "p2", error=True, trace_id="abc123")]}
TRACE_B = {"traceID": "def456", "processes": PROCS, "spans": [
    _span("s3", "GET /", 2000, 40, "p1", trace_id="def456"),
    _span("s4", "SELECT", 2010, 20, "p2", status="503", trace_id="def456")]}
RECORDED = {
    "/api/services": {"data": ["frontend", "backend"]},
    "/api/traces?service=frontend": {"data": [TRACE_A, TRACE_B]},
    "/api/traces?service=backend": {"data": [TRACE_A, TRACE_B]},
    "/api/traces/abc123": {"data": [TRACE_A]},
    "/api/dependencies": {"data": [
        {"parent": "frontend", "child": "backend", "callCount": 42}]},
}


def _opener(url: str) -> bytes:
    parsed = urllib.parse.urlparse(url)
    assert parsed.netloc == "localhost:16686", url
    key = parsed.path
    qs = urllib.parse.parse_qs(parsed.query)
    if key == "/api/traces" and "service" in qs:
        key = f"/api/traces?service={qs['service'][0]}"
    payload = RECORDED.get(key)
    if payload is None:
        raise AssertionError(f"unexpected request: {url}")
    return json.dumps(payload).encode()


def _dead(url):
    raise OSError("connection refused")


def test_trace_backend_matches_the_reference_on_recorded_json():
    port = JaegerTraceBackend(ENDPOINT, opener=_opener)
    ref = RefJaeger(ENDPOINT, opener=_opener)
    for method, args in (("trace_ids", ("ns",)),
                         ("trace_details", ("abc123",)),
                         ("service_latency_stats", ("ns",)),
                         ("error_rate_by_service", ("ns",)),
                         ("service_dependencies", ("ns",)),
                         ("find_slow_operations", ("ns", 100.0))):
        assert getattr(port, method)(*args) == getattr(ref, method)(*args), \
            method
    assert port.trace_ids("ns", limit=10) == ["abc123", "def456"]
    det = port.trace_details("abc123")
    assert det["services"] == ["backend", "frontend"]
    assert det["span_count"] == 2
    assert det["duration_ms"] == pytest.approx(650.0)
    stats = port.service_latency_stats("ns")
    assert set(stats["backend"]) == {"p50", "p95", "p99"}
    assert stats["backend"]["p99"] == pytest.approx(600.0)
    rates = port.error_rate_by_service("ns")
    assert rates == {"backend": pytest.approx(1.0),
                     "frontend": pytest.approx(0.0)}
    assert port.service_dependencies("ns") == {"frontend": ["backend"]}
    ops = port.find_slow_operations("ns", threshold_ms=100.0)
    assert ops[0]["duration_ms"] >= ops[-1]["duration_ms"] >= 100.0
    assert {"service", "operation", "duration_ms", "trace_id"} <= set(ops[0])


def test_trace_transport_failure_degrades_and_records():
    port = JaegerTraceBackend(ENDPOINT, opener=_dead)
    assert port.service_latency_stats("ns") == {}
    assert port.trace_ids("ns") == []
    ref = RefJaeger(ENDPOINT, opener=_dead)
    ref.service_latency_stats("ns")
    ref.trace_ids("ns")
    assert port.errors and port.errors == ref.errors


def test_live_client_gates_the_trace_backend_on_env(monkeypatch):
    """Unset ``RCA_TRACE_ENDPOINT``: empty structures; set: the adapter's
    structures, the live client's capture carrying them."""
    monkeypatch.delenv("RCA_TRACE_ENDPOINT", raising=False)
    client = K8sApiClient.__new__(K8sApiClient)
    client._errors = []
    assert client._traces() is None
    assert client.get_service_latency_stats("ns") == {}
    assert client.get_trace_ids("ns") == []

    monkeypatch.setenv("RCA_TRACE_ENDPOINT", f"jaeger:{ENDPOINT}")
    client2 = K8sApiClient.__new__(K8sApiClient)
    client2._errors = []
    client2._connected = False
    client2._kubectl = None
    for attr in ("_core", "_apps", "_net", "_batch", "_autoscaling"):
        setattr(client2, attr, None)
    backend = client2._traces()
    assert backend is not None and backend.endpoint == ENDPOINT
    backend._opener = _opener           # before any request
    assert set(client2.get_service_latency_stats("ns")) == \
        {"frontend", "backend"}
    assert client2.get_service_dependencies("ns") == \
        {"frontend": ["backend"]}
    snap = ClusterSnapshot.capture(client2, "ns")
    assert snap.columnar is None and snap.pods == []
    assert snap.traces["error_rates"]["backend"] == pytest.approx(1.0)
    assert snap.traces["dependencies"] == {"frontend": ["backend"]}


def test_make_trace_backend_parses_the_endpoint_as_the_reference(
        monkeypatch):
    from rca_tpu.cluster.trace_backend import make_trace_backend as ref_make
    from rca_tpu_torch.cluster.trace_backend import make_trace_backend

    for raw in ("", ENDPOINT, f"jaeger:{ENDPOINT}", "zipkin:http://localhost:1",
                "localhost:16686"):
        monkeypatch.setenv("RCA_TRACE_ENDPOINT", raw)
        monkeypatch.setenv("RCA_TRACE_SERVICE_SUFFIX", ".ns")
        try:
            want = ref_make()
        except ValueError as exc:
            with pytest.raises(ValueError) as got:
                make_trace_backend()
            assert str(got.value) == str(exc)
            continue
        got = make_trace_backend()
        assert (got is None) == (want is None), raw
        if got is not None:
            assert (got.endpoint, got.service_suffix) == \
                (want.endpoint, want.service_suffix), raw


# -- the live columnar feed ----------------------------------------------------

class LiveShim:
    """A mock client whose ``get_columnar`` is the live feed instead of
    the mock's own columnar master: captures through it pay what a live
    client's capture pays.  Pod metrics come back as fresh objects on
    every call, as a live API server returns them (the mock hands out its
    own records, which an in-place edit would change under the feed's
    diff)."""

    def __init__(self, inner, ns, feed_cls=LiveColumnarFeed):
        self._inner = inner
        self.feed = feed_cls(self, ns)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def get_columnar(self, namespace, cursor=None):
        return self.feed.payload(cursor)

    def get_pod_metrics(self, namespace):
        return copy.deepcopy(self._inner.get_pod_metrics(namespace))

    def close(self):
        self.feed.close()


def _bits(fs):
    return (fs.pod_names, fs.service_names, fs.node_names,
            fs.pod_features.tobytes(), fs.service_features.tobytes(),
            fs.node_features.tobytes(), fs.pod_service.tobytes(),
            fs.pod_node.tobytes(), fs.memb_pod.tobytes(),
            fs.memb_svc.tobytes())


def _expire_watch(world) -> None:
    """The 410 analogue: trim the journal past every registered cursor."""
    world.journal.clear()
    world.journal_floor = world.journal_seq + 2
    world.journal_seq += 1


def _churn(world, ns, rng, step, mk_pod):
    pods = world.pods.get(ns, [])
    op = int(rng.integers(0, 5))
    if op == 0 and pods:
        name = pods[int(rng.integers(0, len(pods)))]["metadata"]["name"]
        world.touch("pod_metrics", ns, name)
    elif op == 1 and pods:
        pod = pods[int(rng.integers(0, len(pods)))]
        pod["status"]["phase"] = (
            "Failed" if pod["status"]["phase"] == "Running" else "Running")
        world.touch("pod", ns, pod["metadata"]["name"])
    elif op == 2 and len(pods) > 2:
        pod = pods[int(rng.integers(0, len(pods)))]
        pods.remove(pod)
        world.touch("pod", ns, pod["metadata"]["name"])
    elif op == 3:
        node = world.nodes[0]["metadata"]["name"]
        name = f"clone-{step}"
        world.add("pods", ns, mk_pod(name, ns, app=f"clone{step}",
                                     node_name=node))
        world.touch("pod", ns, name)
    else:
        recs = (world.pod_metrics.get(ns) or {}).get("pods") or {}
        if recs:
            names = sorted(recs)
            name = names[int(rng.integers(0, len(names)))]
            rec = recs[name]
            recs[name] = {**rec, "cpu": {**rec["cpu"],
                                         "usage_percentage": float("nan")}}
            world.touch("pod_metrics", ns, name)


def _strip_cursor(payload, base):
    out = dict(payload)
    if out.get("cursor") is not None:
        out["cursor"] = int(out["cursor"]) - base
    return out


def test_live_feed_matches_the_reference_feed_and_the_dict_path():
    """Seeded churn on twin worlds: the port's live feed serves the
    reference feed's payloads (cursors net of each feed's generation
    base), and a capture through it equals the dict sweep bitwise."""
    from rca_tpu.cluster.world import make_pod as ref_make_pod
    from test_torch_columnar import _same

    ns = "live"
    pw = synthetic_cascade_world(14, n_roots=1, seed=5, namespace=ns,
                                 pods_per_service=2)
    rw = ref_world(14, n_roots=1, seed=5, namespace=ns, pods_per_service=2)
    port = LiveShim(MockClusterClient(pw), ns)
    ref = LiveShim(RefClient(rw), ns, feed_cls=RefFeed)
    state, rstate = ColumnarClientState(), RefState()
    prng, rrng = np.random.default_rng(17), np.random.default_rng(17)
    pcur = rcur = None
    try:
        snap = ClusterSnapshot.capture(port, ns, columnar_state=state)
        rsnap = RefSnapshot.capture(ref, ns, columnar_state=rstate)
        for step in range(24):
            _churn(pw, ns, prng, step, make_pod)
            _churn(rw, ns, rrng, step, ref_make_pod)
            p, r = port.feed.payload(pcur), ref.feed.payload(rcur)
            assert _same(_strip_cursor(p, port.feed._gen_base),
                         _strip_cursor(r, ref.feed._gen_base)), step
            pcur, rcur = p["cursor"], r["cursor"]
            snap = ClusterSnapshot.capture(port, ns, columnar_state=state,
                                           traces_from=snap.traces)
            rsnap = RefSnapshot.capture(ref, ns, columnar_state=rstate,
                                        traces_from=rsnap.traces)
            assert snap.columnar is not None and rsnap.columnar is not None
            dict_snap = ClusterSnapshot.capture(
                port._inner, ns, columnar=False, traces_from=snap.traces)
            assert _bits(extract_features(snap)) == \
                _bits(extract_features(dict_snap)), step
    finally:
        port.close()
        ref.close()


def test_cursor_expiry_rebuilds_without_gap():
    """Changes made while the journal was trimmed past the feed's cursor
    appear in the post-expiry capture: one full re-list, no gap."""
    ns = "gap"
    world = synthetic_cascade_world(10, n_roots=1, seed=3, namespace=ns)
    client = LiveShim(MockClusterClient(world), ns)
    state = ColumnarClientState()
    try:
        snap = ClusterSnapshot.capture(client, ns, columnar_state=state)
        resyncs = client.feed.resyncs
        victim = world.pods[ns][0]
        victim["status"]["phase"] = "Failed"
        world.touch("pod", ns, victim["metadata"]["name"])
        gone = world.pods[ns][1]
        world.pods[ns].remove(gone)
        world.touch("pod", ns, gone["metadata"]["name"])
        _expire_watch(world)
        snap = ClusterSnapshot.capture(client, ns, columnar_state=state,
                                       traces_from=snap.traces)
        fs = extract_features(snap)
        dict_fs = extract_features(ClusterSnapshot.capture(
            client._inner, ns, columnar=False, traces_from=snap.traces))
        assert client.feed.resyncs == resyncs + 1
        assert gone["metadata"]["name"] not in fs.pod_names
        assert _bits(fs) == _bits(dict_fs)
    finally:
        client.close()


def test_stale_and_foreign_cursors_get_a_full_dump():
    """A pre-expiry cursor, a cursor minted by another feed instance and
    a malformed one are each answered with a full dump, never an empty
    diff; the feed's own fresh cursor gets a diff."""
    ns = "cur"
    world = synthetic_cascade_world(8, n_roots=1, seed=2, namespace=ns)
    feed = LiveColumnarFeed(MockClusterClient(world), ns)
    other = LiveColumnarFeed(MockClusterClient(copy.deepcopy(world)), ns)
    try:
        first = feed.payload(None)
        assert first["supported"] and first["full"]
        foreign = other.payload(None)["cursor"]
        assert int(foreign) >> 40 != int(first["cursor"]) >> 40
        again = feed.payload(first["cursor"])
        assert again["supported"] and again["full"] is False
        assert feed.payload(foreign)["full"] is True
        assert feed.payload("not-a-cursor")["full"] is True
        world.touch("pod_metrics", ns, world.pods[ns][0]["metadata"]["name"])
        _expire_watch(world)
        assert feed.payload(again["cursor"])["full"] is True
    finally:
        feed.close()
        other.close()


def _feed_session(world, ns, wrap, ops):
    from rca_tpu_torch.engine import GraphEngine, LiveStreamingSession
    from test_torch_live import _mutate
    from rca_tpu_torch.cluster.world import waiting_status

    inner = MockClusterClient(world)
    client = LiveShim(inner, ns) if wrap else inner
    live = LiveStreamingSession(client, ns, k=3,
                                engine=GraphEngine(device="cpu"),
                                topology_check_every=5, use_columnar=True)
    outs = []
    for t, op in enumerate(ops):
        if t % 3 != 2:
            _mutate(world, ns, op, waiting_status)
        outs.append(live.poll())
    if wrap:
        client.close()
    return outs


def test_live_session_over_the_feed_matches_the_mocks_own_feed(monkeypatch):
    """A live session whose client's ``get_columnar`` is the live feed
    ranks every tick as a session over the mock's own columnar feed, with
    the same changed rows."""
    from test_torch_live import _op_sequence

    monkeypatch.setenv("RCA_KERNEL_CACHE", "off")
    ops = _op_sequence(seed=29, n=20)
    fed = _feed_session(synthetic_cascade_world(60, n_roots=2, seed=4,
                                                namespace="f"), "f", True,
                        ops)
    own = _feed_session(synthetic_cascade_world(60, n_roots=2, seed=4,
                                                namespace="f"), "f", False,
                        ops)
    for t, (a, b) in enumerate(zip(fed, own)):
        assert a["ranked"] == b["ranked"], t
        assert a["changed_rows"] == b["changed_rows"], t
        assert not a["degraded"], t
    # the injected root leads until the mix's late crashes outrank it
    roots = synthetic_cascade_world(60, n_roots=2, seed=4).ground_truth[
        "fault_roots"]
    assert fed[0]["ranked"][0]["component"] in roots


# -- policies --------------------------------------------------------------------

def test_retry_and_deadline_match_the_reference():
    from rca_tpu.resilience.policy import Deadline as RefDeadline
    from rca_tpu.resilience.policy import DeadlineExceeded as RefExceeded
    from rca_tpu.resilience.policy import Retry as RefRetry
    from rca_tpu_torch.resilience.policy import (
        Deadline,
        DeadlineExceeded,
        PolicyError,
        Retry,
        retry_counter,
    )

    port = Retry(attempts=3, seed=11, sleep=lambda s: None)
    ref = RefRetry(attempts=3, seed=11, sleep=lambda s: None)
    assert [port.delay(a) for a in range(1, 8)] == \
        [ref.delay(a) for a in range(1, 8)]
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("flake")
        return "ok"

    before = retry_counter()
    assert port.call(flaky) == "ok" and port.retries_spent == 2
    assert retry_counter() - before == 2
    with pytest.raises(OSError):
        Retry(attempts=1, sleep=lambda s: None).call(_dead, "x")
    now = [0.0]
    deadline = Deadline.after(1.0, clock=lambda: now[0])
    ref_deadline = RefDeadline.after(1.0, clock=lambda: now[0])
    now[0] = 0.4
    assert deadline.remaining() == ref_deadline.remaining()
    now[0] = 2.0
    assert deadline.expired and ref_deadline.expired
    with pytest.raises(DeadlineExceeded) as got:
        deadline.check("op")
    with pytest.raises(RefExceeded) as want:
        ref_deadline.check("op")
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, PolicyError)
    tight = Deadline(budget_s=0.05, clock=lambda: 0.0)
    with pytest.raises(DeadlineExceeded):
        Retry(attempts=3, base_delay=1.0, jitter=0.0,
              sleep=lambda s: None).call(_dead, "x", deadline=tight)


def test_threads_are_named_and_locks_plain():
    from rca_tpu_torch.util.threads import make_lock, make_thread, spawn

    lock = make_lock("Probe._lock")
    with lock:
        assert lock.locked()
    t = make_thread(lambda: None, name="probe-thread", daemon=True)
    assert (t.name, t.daemon, t.is_alive()) == ("probe-thread", True, False)
    box = []
    s = spawn(box.append, name="probe-spawn", args=(1,))
    s.join(timeout=5)
    assert box == [1] and not s.is_alive() and s.daemon


# -- the analyze command with no cluster -------------------------------------

_TIME_KEYS = ("started_at", "finished_at", "id", "profile",
              "engine_latency_ms", "timestamp", "backend")


def _without_times(obj):
    if isinstance(obj, dict):
        return {k: _without_times(v) for k, v in obj.items()
                if k not in _TIME_KEYS}
    if isinstance(obj, list):
        return [_without_times(v) for v in obj]
    return obj


def _analyze(pkg, *args, env):
    proc = subprocess.run(
        [sys.executable, "-m", pkg, "analyze", *args], cwd=str(ROOT),
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout)


def test_cli_without_a_fixture_prints_the_reference_report(tmp_path):
    """No fixture, no ``kubectl`` and a ``KUBECONFIG`` naming a missing
    file: the port's ``analyze`` builds a ``K8sApiClient`` and prints the
    report the reference's prints, in every key but times (and the
    backend's name, ``torch`` where the reference says ``jax``)."""
    # one device on both sides: the reference's test session forces
    # eight virtual ones, on which its make_engine() would shard
    env = {**os.environ, "KUBECONFIG": str(tmp_path / "missing"),
           "JAX_PLATFORMS": "cpu", "RCA_SHARD": "0"}
    for extra in (("--compact",), ("--compact", "--full")):
        port = _analyze("rca_tpu_torch", *extra, "--device", "cpu", env=env)
        ref = _analyze("rca_tpu", *extra, env=env)
        assert _without_times(port) == _without_times(ref), extra
        assert port["status"] == "completed"
    assert port["results"]["correlated"]["backend"] == "torch"


@pytest.mark.parametrize("argv", [
    ["hypotheses", "--compact"],
    ["stream", "--ticks", "2", "--interval", "0"],
], ids=["hypotheses", "stream"])
def test_hypotheses_and_stream_without_a_fixture_match_the_reference(
        argv, tmp_path):
    """``hypotheses`` and ``stream`` with no fixture run against the
    (unreachable) live cluster and print the reference's lines."""
    env = {**os.environ, "KUBECONFIG": str(tmp_path / "missing"),
           "JAX_PLATFORMS": "cpu", "RCA_SHARD": "0"}
    lines = {}
    for pkg, extra in (("rca_tpu_torch", ["--device", "cpu"]),
                       ("rca_tpu", [])):
        proc = subprocess.run(
            [sys.executable, "-m", pkg, *argv, *extra], cwd=str(ROOT),
            capture_output=True, text=True, timeout=300, env=env)
        assert proc.returncode == 0, (pkg, proc.stderr[-2000:])
        lines[pkg] = [_without_times(json.loads(line))
                      for line in proc.stdout.splitlines()]
        for line in lines[pkg]:
            line.pop("latency_ms", None)
            line.pop("capture_ms", None)
    assert lines["rca_tpu_torch"] == lines["rca_tpu"]
    assert lines["rca_tpu_torch"]
