"""The port's columnar capture against its own dict capture and against the
JAX package's columnar capture, bit for bit.

Twin worlds come from each package's own generator with the same seed and
take the same journaled mutations.  At every step the port's columnar
snapshot and features equal its dict sweep's and the reference's columnar
ones, and the port's ``get_columnar`` payloads (the full table dump and
the column diffs) equal the reference's.  The live session on the
columnar capture is held to the reference's columnar session tick for
tick (counters, health keys, rankings); the gone storm, the degenerate
world and a failing feed behave as in the reference.  Also: the world's
position index, the dirty-row bitmap, the content-memoized scan, the crc
digest, ``update_rows`` against ``update_many`` and the ``RCA_COLUMNAR``
knob.
"""

from __future__ import annotations

import copy
import dataclasses
import math

import numpy as np
import pytest

from rca_tpu.cluster.columnar import ColumnarClientState as RefState
from rca_tpu.cluster.fixtures import NS as REF_NS
from rca_tpu.cluster.fixtures import five_service_world as ref_five
from rca_tpu.cluster.generator import synthetic_cascade_world as ref_world
from rca_tpu.cluster.mock_client import MockClusterClient as RefClient
from rca_tpu.cluster.snapshot import ClusterSnapshot as RefSnapshot
from rca_tpu.cluster import world as ref_world_mod
from rca_tpu.engine import GraphEngine as RefEngine
from rca_tpu.engine import LiveStreamingSession as RefLive
from rca_tpu.features.extract import extract_features as ref_extract
from rca_tpu_torch.cluster import world as port_world_mod
from rca_tpu_torch.cluster.columnar import ColumnarClientState
from rca_tpu_torch.cluster.fixtures import NS, five_service_world
from rca_tpu_torch.cluster.generator import synthetic_cascade_world
from rca_tpu_torch.cluster.mock_client import MockClusterClient
from rca_tpu_torch.cluster.snapshot import ClusterSnapshot
from rca_tpu_torch.engine import GraphEngine, LiveStreamingSession
from rca_tpu_torch.features.extract import extract_features

PORT = {"world": synthetic_cascade_world, "client": MockClusterClient,
        "mk": port_world_mod, "live": LiveStreamingSession,
        "engine": lambda: GraphEngine(device="cpu")}
REF = {"world": ref_world, "client": RefClient, "mk": ref_world_mod,
       "live": RefLive, "engine": lambda: RefEngine(resident=False)}

#: the poll keys and health keys the live runs agree on exactly
POLL_KEYS = ("changed_rows", "upload_rows", "resynced", "quiet", "resyncs",
             "tick", "degraded")
HEALTH_KEYS = ("sanitized_rows", "degradation", "resyncs_expired",
               "resyncs_topology", "pipeline_fill", "retries")


def _bits(fs):
    return (
        fs.pod_names, fs.service_names, fs.node_names,
        fs.pod_features.tobytes(), fs.service_features.tobytes(),
        fs.pod_service.tobytes(), fs.memb_pod.tobytes(),
        fs.memb_svc.tobytes(), fs.pod_node.tobytes(),
        fs.node_features.tobytes(),
    )


def _same(a, b) -> bool:
    """Deep equality with ndarrays compared by dtype, shape and bytes and
    NaN equal to NaN (a payload carries both)."""
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


def _snap_values(snap):
    return {f.name: getattr(snap, f.name) for f in dataclasses.fields(snap)
            if f.name != "columnar"}


class _Recording:
    """Wraps a package's mock client class so every ``get_columnar``
    payload is kept for comparison."""

    def __init__(self, cls, world):
        self.payloads = []
        outer = self

        class Client(cls):
            def get_columnar(self, namespace, cursor=None):
                p = super().get_columnar(namespace, cursor)
                outer.payloads.append(copy.deepcopy(p))
                return p

        self.client = Client(world)


def _assert_twin_capture(port_client, ref_client, ns, port_state=None,
                         ref_state=None, ctx=""):
    """Port columnar == port dict == reference columnar, bitwise."""
    col = ClusterSnapshot.capture(port_client, ns, columnar_state=port_state)
    assert col.columnar is not None, f"{ctx}: columnar path not taken"
    dic = ClusterSnapshot.capture(port_client, ns, columnar=False)
    ref = RefSnapshot.capture(ref_client, ns, columnar_state=ref_state)
    assert ref.columnar is not None, ctx
    assert _same(_snap_values(col), _snap_values(dic)), ctx
    assert _same(_snap_values(col), _snap_values(ref)), ctx
    fs = extract_features(col)
    assert _bits(fs) == _bits(extract_features(dic)), ctx
    assert _bits(fs) == _bits(ref_extract(ref)), ctx
    return fs


# -- direct capture parity ---------------------------------------------------

WORLDS = {
    "5svc": (lambda pkg: (pkg["five"](), pkg["ns"])),
    "50svc": (lambda pkg: (pkg["world"](50, n_roots=1, seed=7,
                                        namespace="synthetic"),
                           "synthetic")),
    "300svc": (lambda pkg: (pkg["world"](300, n_roots=2, seed=5,
                                         mode="adversarial",
                                         fault_mix="mixed"), "synthetic")),
}


@pytest.mark.parametrize("name", WORLDS)
def test_capture_parity_against_dict_and_reference(name):
    port_world, ns = WORLDS[name]({**PORT, "five": five_service_world,
                                   "ns": NS})
    ref_w, rns = WORLDS[name]({**REF, "five": ref_five, "ns": REF_NS})
    assert ns == rns
    port, ref = _Recording(MockClusterClient, port_world), \
        _Recording(RefClient, ref_w)
    _assert_twin_capture(port.client, ref.client, ns, ctx=name)
    # the table dump that crossed the client boundary is the reference's
    assert len(port.payloads) == len(ref.payloads) == 1
    assert port.payloads[0]["full"] is True
    assert _same(port.payloads[0], ref.payloads[0])


def _mutate(world, mk, ns, rng, step):
    """One of the reference property gate's journaled mutations (the same
    draws on twin worlds keep them identical)."""
    op = int(rng.integers(0, 8))
    pods = world.pods[ns]
    if op == 0:      # status flip (replacement + touch)
        idx = int(rng.integers(0, len(pods)))
        pod = copy.deepcopy(pods[idx])
        app = pod["metadata"]["labels"].get("app", "x")
        if rng.random() < 0.5:
            pod["status"]["phase"] = "Running"
            pod["status"]["containerStatuses"] = [mk.waiting_status(
                app, "CrashLoopBackOff",
                restarts=int(rng.integers(1, 9)), last_exit_code=1,
            )]
        else:
            pod["status"]["phase"] = "Pending"
            pod["status"]["containerStatuses"] = []
        pods[idx] = pod
        world.touch("pod", ns, pod["metadata"]["name"])
    elif op == 1:    # NaN-poisoned metrics
        recs = world.pod_metrics[ns]["pods"]
        name = list(recs)[int(rng.integers(0, len(recs)))]
        rec = copy.deepcopy(recs[name])
        rec["cpu"]["usage_percentage"] = float("nan")
        rec["memory"]["usage_percentage"] = float(rng.uniform(5, 99))
        recs[name] = rec
        world.touch("pod_metrics", ns, name)
    elif op == 2:    # log rewrite
        logs = world.logs[ns]
        name = list(logs)[int(rng.integers(0, len(logs)))]
        cont = next(iter(logs[name]))
        logs[name][cont] = (
            "ERROR: connection refused\n" * int(rng.integers(1, 4))
        )
        world.touch("logs", ns, name)
    elif op == 3:    # pod deletion
        if len(pods) > 12:
            idx = int(rng.integers(0, len(pods)))
            pod = pods.pop(idx)
            world.touch("pod", ns, pod["metadata"]["name"])
    elif op == 4:    # pod addition
        world.add("pods", ns, mk.make_pod(f"late-{step}", ns, "late"))
    elif op == 5:    # warning-event storm for one pod
        victim = pods[int(rng.integers(0, len(pods)))]
        world.add("events", ns, mk.make_event(
            ns, "Pod", victim["metadata"]["name"], "BackOff", "storm",
            count=int(rng.integers(1, 9)),
        ))
    elif op == 6:    # topology move
        svc = f"newsvc-{step}"
        world.add("services", ns, mk.make_service(svc, ns))
        world.add("deployments", ns, mk.make_deployment(svc, ns, svc))
    else:            # gone storm: trim the journal past every cursor
        old_cap = world.journal_cap
        world.journal_cap = 2
        for i in range(5):
            world.touch("pod", ns, f"ghost-{step}-{i}")
        world.journal_cap = old_cap


def test_capture_parity_property_update_delete_nan_gone():
    """After any journaled sequence of pod replacements, deletions,
    additions, NaN metrics, log rewrites, event storms, service adds and
    gone storms, the port's incrementally maintained tables extract
    bit-identically to its dict sweep and to the reference's tables, and
    every payload (dump or column diff) equals the reference's."""
    ns = "prop"
    pw = synthetic_cascade_world(25, n_roots=2, seed=9, namespace=ns)
    rw = ref_world(25, n_roots=2, seed=9, namespace=ns)
    port, ref = _Recording(MockClusterClient, pw), _Recording(RefClient, rw)
    pstate, rstate = ColumnarClientState(), RefState()
    prng, rrng = np.random.default_rng(42), np.random.default_rng(42)
    kinds = set()
    for step in range(24):
        for _ in range(int(prng.integers(1, 4))):
            _mutate(pw, port_world_mod, ns, prng, step)
        for _ in range(int(rrng.integers(1, 4))):
            _mutate(rw, ref_world_mod, ns, rrng, step)
        _assert_twin_capture(port.client, ref.client, ns, pstate, rstate,
                             ctx=f"step {step}")
        kinds.add(port.payloads[-1]["full"])
    assert len(port.payloads) == len(ref.payloads) == 24
    for t, (p, r) in enumerate(zip(port.payloads, ref.payloads)):
        assert _same(p, r), f"payload {t}"
    assert kinds == {True, False}     # both dumps and diffs were compared


# -- the live session --------------------------------------------------------

def _live_mutation(world, mk, ns, rng, step):
    op = int(rng.integers(0, 5))
    pods = world.pods[ns]
    if op == 0:
        idx = int(rng.integers(0, len(pods)))
        pod = copy.deepcopy(pods[idx])
        pod["status"]["phase"] = (
            "Pending" if rng.random() < 0.5 else "Running"
        )
        pods[idx] = pod
        world.touch("pod", ns, pod["metadata"]["name"])
    elif op == 1:
        recs = world.pod_metrics[ns]["pods"]
        name = list(recs)[int(rng.integers(0, len(recs)))]
        rec = copy.deepcopy(recs[name])
        rec["cpu"]["usage_percentage"] = float(rng.uniform(5, 99))
        recs[name] = rec
        world.touch("pod_metrics", ns, name)
    elif op == 2:
        logs = world.logs[ns]
        name = list(logs)[int(rng.integers(0, len(logs)))]
        cont = next(iter(logs[name]))
        logs[name][cont] = "ERROR: timeout\n" * int(rng.integers(1, 3))
        world.touch("logs", ns, name)
    elif op == 3:
        if len(pods) > 10:
            idx = int(rng.integers(0, len(pods)))
            pod = pods.pop(idx)
            world.touch("pod", ns, pod["metadata"]["name"])
    else:
        svc = f"newsvc-{step}"
        world.add("services", ns, mk.make_service(svc, ns))
        world.add("deployments", ns, mk.make_deployment(svc, ns, svc))


def _live_run(pkg, depth, use_columnar):
    ns = "live"
    world = pkg["world"](20, n_roots=2, seed=5, namespace=ns)
    live = pkg["live"](pkg["client"](world), ns, k=5,
                       topology_check_every=4, engine=pkg["engine"](),
                       pipeline_depth=depth, use_columnar=use_columnar)
    rng = np.random.default_rng(0)
    outs = []
    for step in range(16):
        for _ in range(int(rng.integers(1, 4))):
            _live_mutation(world, pkg["mk"], ns, rng, step)
        outs.append(live.poll())
    assert live._use_columnar is use_columnar
    return outs


def _ranked(out):
    return [r["component"] for r in out["ranked"]]


@pytest.mark.parametrize("depth", [1, 2])
def test_live_session_columnar_matches_reference(depth, monkeypatch):
    """Topology moves, deletes, metric and log churn: the port's columnar
    session against the reference's, tick for tick (counters, health
    keys, rankings), and against the port's dict session (rankings)."""
    monkeypatch.setenv("RCA_KERNEL_CACHE", "off")
    port = _live_run(PORT, depth, True)
    ref = _live_run(REF, depth, True)
    dict_run = _live_run(PORT, depth, False)
    for t, (p, r, d) in enumerate(zip(port, ref, dict_run)):
        assert _ranked(p) == _ranked(r) == _ranked(d), t
        np.testing.assert_allclose([x["score"] for x in p["ranked"]],
                                   [x["score"] for x in r["ranked"]],
                                   rtol=1e-5, atol=1e-6, err_msg=str(t))
        assert [x["score"] for x in p["ranked"]] == \
            [x["score"] for x in d["ranked"]], t
        assert {k: p[k] for k in POLL_KEYS} == {k: r[k] for k in POLL_KEYS}, t
        assert {k: p["health"][k] for k in HEALTH_KEYS} == \
            {k: r["health"][k] for k in HEALTH_KEYS}, t
    assert any(p["resynced"] for p in port[1:])


def _storm(pkg):
    ns = "storm"
    world = pkg["world"](18, n_roots=1, seed=6, namespace=ns)
    client = pkg["client"](world)
    eng = pkg["engine"]()
    live = pkg["live"](client, ns, k=5, topology_check_every=10_000,
                       engine=eng, use_columnar=True)
    outs = [live.poll()]
    old_cap = world.journal_cap
    world.journal_cap = 2
    for i in range(6):
        world.touch("pod", ns, f"ghost-{i}")
    world.journal_cap = old_cap
    outs += [live.poll(), live.poll()]   # expiry recovery, then settled
    fresh = pkg["live"](client, ns, k=5, topology_check_every=10_000,
                        engine=eng, use_columnar=True)
    return outs, fresh.poll()


def test_gone_storm_resets_mirror_and_recovers():
    """A journal trim expires both feeds; the next polls recover off a
    full columnar payload and rank as a fresh session does, as the
    reference's session does."""
    port, fresh = _storm(PORT)
    ref, _ = _storm(REF)
    assert _ranked(port[-1]) == _ranked(fresh)
    assert not port[-1].get("degraded")
    for p, r in zip(port, ref):
        assert _ranked(p) == _ranked(r)
        assert {k: p[k] for k in POLL_KEYS} == {k: r[k] for k in POLL_KEYS}
        assert p.get("recovered") == r.get("recovered")


def test_degenerate_world_falls_back_to_dict_path():
    """Duplicate object names: the payload says unsupported (as the
    reference's does), the capture answers from the dict sweep and the
    session's fallback is for good."""
    ns = "dup"
    port_w = synthetic_cascade_world(8, n_roots=1, seed=2, namespace=ns)
    ref_w = ref_world(8, n_roots=1, seed=2, namespace=ns)
    for w in (port_w, ref_w):
        w.pods[ns].append(copy.deepcopy(w.pods[ns][0]))  # a name twice
    client = MockClusterClient(port_w)
    payload = client.get_columnar(ns)
    assert payload == RefClient(ref_w).get_columnar(ns)
    assert payload["supported"] is False
    snap = ClusterSnapshot.capture(client, ns)
    assert snap.columnar is None
    assert snap == ClusterSnapshot.capture(client, ns, columnar=False)
    live = LiveStreamingSession(client, ns, k=3, topology_check_every=5,
                                engine=GraphEngine(device="cpu"),
                                use_columnar=True)
    out = live.poll()
    assert out["ranked"]
    assert live._use_columnar is False       # the fallback is sticky
    ref = RefLive(RefClient(ref_w), ns, k=3, topology_check_every=5,
                  use_columnar=True, engine=RefEngine(resident=False))
    assert _ranked(out) == _ranked(ref.poll())


def _flaky(pkg):
    ns = "flaky"
    world = pkg["world"](10, n_roots=1, seed=4, namespace=ns)

    class FlakyColumnar(pkg["client"]):
        broken = False

        def get_columnar(self, namespace, cursor=None):
            if self.broken:
                raise RuntimeError("columnar feed unreachable")
            return super().get_columnar(namespace, cursor)

    client = FlakyColumnar(world)
    live = pkg["live"](client, ns, k=3, topology_check_every=10_000,
                       engine=pkg["engine"](), use_columnar=True)
    outs = [live.poll()]
    client.broken = True
    live._pending_resync = True   # force a capture next poll
    outs.append(live.poll())
    client.broken = False
    outs.append(live.poll())
    return outs


def test_columnar_capture_fault_degrades_then_recovers():
    """A failing feed: the poll never raises, serves the last ranking
    degraded, and the scheduled resync recovers once the feed heals — the
    same three polls as the reference's."""
    healthy, out, out2 = _flaky(PORT)
    assert healthy["degraded"] is False
    assert out["degraded"] is True
    assert out["ranked"] == healthy["ranked"]
    assert out2["resynced"] is True and out2["degraded"] is False
    assert _ranked(out2) == _ranked(healthy)
    for p, r in zip((healthy, out, out2), _flaky(REF)):
        assert _ranked(p) == _ranked(r)
        assert {k: p[k] for k in POLL_KEYS} == {k: r[k] for k in POLL_KEYS}
        assert [f["op"] for f in p["health"]["faults"]] == \
            [f["op"] for f in r["health"]["faults"]]


# -- the world index and table internals -------------------------------------

def test_world_find_handles_replace_delete_and_shift():
    ns = "idx"
    world = synthetic_cascade_world(6, n_roots=1, seed=1, namespace=ns)
    pods = world.pods[ns]
    name3 = pods[3]["metadata"]["name"]
    assert world.find("pods", ns, name3) is pods[3]
    clone = copy.deepcopy(pods[3])
    pods[3] = clone
    assert world.find("pods", ns, name3) is clone
    gone = pods.pop(0)
    assert world.find("pods", ns, gone["metadata"]["name"]) is None
    assert world.find("pods", ns, name3) is clone
    seq_before = world.journal_seq
    world.touch("pod", ns, name3)
    assert clone["metadata"]["resourceVersion"] == str(seq_before + 1)


def test_dirty_row_bitmap_tracks_writes():
    ns = "dirty"
    world = synthetic_cascade_world(12, n_roots=1, seed=8, namespace=ns)
    client = MockClusterClient(world)
    client.get_columnar(ns)             # builds the master
    master = world._columnar[ns]
    master.build_view()                 # consume the build's dirty rows
    assert not master.cols.dirty[: master.cols.n].any()
    name = world.pods[ns][4]["metadata"]["name"]
    world.touch("pod", ns, name)
    master.refresh()
    dirty = np.flatnonzero(master.cols.dirty[: master.cols.n])
    assert dirty.tolist() == [4]        # exactly the touched row
    master.build_view()
    assert not master.cols.dirty[: master.cols.n].any()


def test_scan_text_cached_matches_scan_text():
    from rca_tpu.features.logscan import scan_text as ref_scan
    from rca_tpu_torch.features.logscan import scan_text, scan_text_cached

    texts = ["", "INFO: fine", "ERROR: connection refused\nOOMKilled",
             "deadline exceeded " * 50]
    for t in texts:
        a, b = scan_text(t), scan_text_cached(t)
        assert a.dtype == b.dtype == np.int32
        assert np.array_equal(a, b)
        assert np.array_equal(b, ref_scan(t))
    x = scan_text_cached(texts[2])
    x[0] = 999
    assert scan_text_cached(texts[2])[0] != 999    # no aliased mutation


def test_crc_digest_is_stable_and_content_sensitive():
    from rca_tpu.replay.format import digest_array_crc as ref_digest
    from rca_tpu_torch.cluster.columnar import digest_array_crc

    a = np.arange(24, dtype=np.float32).reshape(4, 6)
    d1 = digest_array_crc(a)
    assert d1 == digest_array_crc(a.copy()) == ref_digest(a)
    b = a.copy()
    b[2, 3] += 1e-3
    assert digest_array_crc(b) != d1
    assert digest_array_crc(a.reshape(6, 4)) != d1   # shape is identity
    fs = extract_features(ClusterSnapshot.capture(
        MockClusterClient(five_service_world()), NS))
    assert digest_array_crc(fs.service_features) == \
        ref_digest(fs.service_features)


def test_update_rows_matches_update_many_bitwise(monkeypatch):
    from rca_tpu_torch.engine.streaming import StreamingSession

    monkeypatch.setenv("RCA_KERNEL_CACHE", "off")
    rng = np.random.default_rng(3)
    n, feats = 50, 13
    names = [f"s{i}" for i in range(n)]
    src = np.arange(n - 1, dtype=np.int32)
    dst = np.arange(1, n, dtype=np.int32)
    eng = GraphEngine(device="cpu")
    base = rng.uniform(0, 1, (n, feats)).astype(np.float32)
    a = StreamingSession(names, src, dst, num_features=feats, engine=eng)
    b = StreamingSession(names, src, dst, num_features=feats, engine=eng)
    a.set_all(base)
    b.set_all(base)
    for step in range(4):
        idx = rng.choice(n, size=int(rng.integers(1, 12)), replace=False)
        rows = rng.uniform(0, 1, (len(idx), feats)).astype(np.float32)
        a.update_many({int(i): rows[j] for j, i in enumerate(idx)})
        b.update_rows(idx.astype(np.int64), rows)
        if step == 2:
            # a later per-index update wins over the block on both
            override = rng.uniform(0, 1, feats).astype(np.float32)
            a.update(int(idx[0]), override)
            b.update(int(idx[0]), override)
        out_a, out_b = a.tick(), b.tick()
        assert out_a["upload_rows"] == out_b["upload_rows"]
        assert [(r["component"], r["score"]) for r in out_a["ranked"]] == \
            [(r["component"], r["score"]) for r in out_b["ranked"]], step


@pytest.mark.parametrize("name,values", [
    ("RCA_COLUMNAR", ["", "1", "0", "on", "OFF", "maybe"]),
    ("RCA_INGEST_TOPO_EVERY", ["", "0", "7", "100000", "-1", "x"]),
    ("RCA_INGEST_LOGS", ["", "1", "0", "off", "2"]),
])
def test_columnar_env_knob_round_trip(monkeypatch, name, values):
    """Each knob gives the reference's value, and raises ``ValueError``
    where the reference raises."""
    from rca_tpu import config as ref_cfg
    from rca_tpu_torch import config as port_cfg

    fn = {"RCA_COLUMNAR": "columnar_enabled",
          "RCA_INGEST_TOPO_EVERY": "ingest_topo_every",
          "RCA_INGEST_LOGS": "ingest_log_fetch"}[name]
    for raw in values:
        monkeypatch.setenv(name, raw)
        try:
            want = getattr(ref_cfg, fn)()
        except ValueError as exc:
            with pytest.raises(ValueError) as got:
                getattr(port_cfg, fn)()
            assert str(got.value) == str(exc)
            continue
        assert getattr(port_cfg, fn)() == want, (name, raw)
    monkeypatch.delenv("RCA_COLUMNAR", raising=False)
    assert port_cfg.columnar_enabled() is True
