"""The port's live streaming session against the JAX package's.

The same worlds (the reference's generators and the port's copies, bit
for bit), mutated by the same seeded op sequence, drive
``rca_tpu.engine.LiveStreamingSession`` and
``rca_tpu_torch.engine.LiveStreamingSession`` (on the CPU).  Per tick the
two agree on the rankings under the engine contract (components and
order exact, scores at rtol 1e-5 / atol 1e-6) and exactly on the poll's
counters, ``degraded`` and the health keys the reference's recorder
replays (spans by name and order, under ``RCA_TRACE=1``), once on both
packages' dict capture and once on their columnar capture (the default).
On the port, depth 2 is depth 1 shifted by one tick, bitwise.  Also: a topology change
forces a resync, an expired feed recovers, the degradation ladder walks
the same rungs with the same flush counts, the incremental extractor
equals full extraction and the reference's, and the ``stream`` command
prints the reference command's lines.
"""

import copy
import functools
import json

import numpy as np
import pytest

from rca_tpu.cluster.fixtures import NS as REF_NS
from rca_tpu.cluster.fixtures import five_service_world as ref_five
from rca_tpu.cluster.generator import synthetic_cascade_world as ref_world
from rca_tpu.cluster.mock_client import MockClusterClient as RefClient
from rca_tpu.cluster.snapshot import ClusterSnapshot as RefSnapshot
from rca_tpu.cluster.world import make_deployment as ref_make_deployment
from rca_tpu.cluster.world import make_event as ref_make_event
from rca_tpu.cluster.world import make_service as ref_make_service
from rca_tpu.cluster.world import waiting_status as ref_waiting_status
from rca_tpu.engine import GraphEngine as RefEngine
from rca_tpu.engine import LiveStreamingSession as RefLive
from rca_tpu.engine.streaming import StreamingSession as RefStreaming
from rca_tpu.features.extract import extract_features as ref_extract
from rca_tpu.observability import spans as ref_spans
from rca_tpu.resilience.policy import drain_faults as ref_drain_faults
from rca_tpu_torch.cluster.fixtures import NS
from rca_tpu_torch.cluster.fixtures import five_service_world
from rca_tpu_torch.cluster.generator import synthetic_cascade_world
from rca_tpu_torch.cluster.mock_client import MockClusterClient
from rca_tpu_torch.cluster.snapshot import ClusterSnapshot
from rca_tpu_torch.cluster.world import make_deployment, make_event
from rca_tpu_torch.cluster.world import make_service, waiting_status
from rca_tpu_torch.engine import GraphEngine, LiveStreamingSession
from rca_tpu_torch.engine.streaming import StreamingSession
from rca_tpu_torch.features.extract import (
    IncrementalExtractor,
    extract_features,
)
from rca_tpu_torch.observability import spans as port_spans
from rca_tpu_torch.resilience.policy import drain_faults

#: poll keys both packages must agree on exactly
POLL_KEYS = ("changed_rows", "upload_rows", "resynced", "quiet", "resyncs",
             "tick", "degraded")
#: the health keys the reference's recorder replays (spans apart)
HEALTH_KEYS = ("sanitized_rows", "degradation", "resyncs_expired",
               "resyncs_topology", "pipeline_fill", "retries")

PORT = {"world": synthetic_cascade_world, "client": MockClusterClient,
        "live": functools.partial(LiveStreamingSession, use_columnar=False),
        "waiting": waiting_status,
        "five": five_service_world, "service": make_service,
        "deployment": make_deployment,
        "engine": lambda: GraphEngine(device="cpu"), "drain": drain_faults}
# both packages on their dict capture; the columnar runs below.  Above
# the healthy-pod log sample the columnar capture samples other pods'
# logs (ticks 41-42 of the 60-tick run: changed_rows 0 where the dict
# path has 1, the same rankings), so each capture is held to its twin
REF = {"world": ref_world, "client": RefClient,
       "live": functools.partial(RefLive, use_columnar=False),
       "waiting": ref_waiting_status, "five": ref_five,
       "service": ref_make_service, "deployment": ref_make_deployment,
       "engine": RefEngine, "drain": ref_drain_faults}
PORT_COLUMNAR = {**PORT, "live": functools.partial(LiveStreamingSession,
                                                   use_columnar=True)}
REF_COLUMNAR = {**REF, "live": functools.partial(RefLive, use_columnar=True)}


def _mutate(world, ns, op, waiting):
    """Apply one descriptor-driven mutation (the same descriptor applied
    to twin worlds keeps them bit-identical)."""
    kind, idx, arg = op
    pods = world.pods[ns]
    pod = pods[idx % len(pods)]
    name = pod["metadata"]["name"]
    app = pod["metadata"]["labels"].get("app", "x")
    if kind == "crash":
        pod["status"]["phase"] = "Running"
        pod["status"]["containerStatuses"] = [
            waiting(app, "CrashLoopBackOff", restarts=arg, last_exit_code=1)
        ]
        world.touch("pod", ns, name)
    elif kind == "heal":
        pod["status"]["phase"] = "Running"
        pod["status"]["containerStatuses"] = [
            {"name": app, "ready": True, "restartCount": 0,
             "state": {"running": {}}}
        ]
        world.touch("pod", ns, name)
    elif kind == "logs":
        world.logs[ns][name] = {app: f"ERROR: failure mode {arg}\n" * arg}
        world.touch("logs", ns, name)
    elif kind == "metrics":
        rec = world.pod_metrics[ns]["pods"].get(name)
        if rec:
            rec["cpu"]["usage_percentage"] = float(arg)
            world.touch("pod_metrics", ns, name)


def _op_sequence(seed, n):
    rng = np.random.default_rng(seed)
    kinds = ("crash", "heal", "logs", "metrics")
    return [
        (kinds[int(rng.integers(0, len(kinds)))],
         int(rng.integers(0, 10_000)), int(rng.integers(1, 9)))
        for _ in range(n)
    ]


def _drive(pkg, depth, ops):
    # start from an empty process fault log: a test that ran earlier in
    # this process (a serve selftest's injected faults) must not show up
    # in this run's first health record
    pkg["drain"]()
    world = pkg["world"](40, n_roots=1, seed=3, namespace="pipe")
    live = pkg["live"](pkg["client"](world), "pipe", k=3,
                       engine=pkg["engine"](), topology_check_every=7,
                       pipeline_depth=depth)
    seq = []
    for t, op in enumerate(ops):
        if t % 3 != 2:          # every third poll stays quiet
            _mutate(world, "pipe", op, pkg["waiting"])
        seq.append(live.poll())
    return seq


@pytest.fixture(scope="module")
def runs():
    """The 60-tick, 40-service run of both packages at depths 1 and 2,
    traced (``RCA_TRACE=1``, each package's process tracer re-resolved)."""
    ops = _op_sequence(seed=13, n=60)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RCA_TRACE", "1")
        mp.setenv("RCA_KERNEL_CACHE", "off")
        for depth in (1, 2):
            for name, pkg, mod in (("port", PORT, port_spans),
                                   ("ref", REF, ref_spans),
                                   ("port_columnar", PORT_COLUMNAR,
                                    port_spans),
                                   ("ref_columnar", REF_COLUMNAR, ref_spans)):
                mp.setattr(mod, "_DEFAULT", None)
                out[name, depth] = _drive(pkg, depth, ops)
    return out


def assert_ranked_close(got, want, ctx=""):
    assert [r["component"] for r in got] == [r["component"] for r in want], \
        ctx
    np.testing.assert_allclose([r["score"] for r in got],
                               [r["score"] for r in want], rtol=1e-5,
                               atol=1e-6, err_msg=ctx)


def _assert_runs_match(port, ref, depth):
    assert len(port) == len(ref) == 60
    for t, (p, r) in enumerate(zip(port, ref)):
        ctx = f"depth {depth}, tick {t + 1}"
        assert_ranked_close(p["ranked"], r["ranked"], ctx)
        assert {k: p[k] for k in POLL_KEYS} == {k: r[k] for k in POLL_KEYS}, \
            ctx
        ph, rh = p["health"], r["health"]
        assert {k: ph[k] for k in HEALTH_KEYS} == \
            {k: rh[k] for k in HEALTH_KEYS}, ctx
        assert [(s["name"], s["parent_id"] is None) for s in ph["spans"]] \
            == [(s["name"], s["parent_id"] is None) for s in rh["spans"]], ctx
        assert ph["faults"] == rh["faults"] == []
        assert ph["degradation_rung"] == rh["degradation_rung"] == "full"
        assert ph["kernel_path"] == "torch"
    assert any(p["quiet"] for p in port)
    assert any(p["changed_rows"] for p in port)


@pytest.mark.parametrize("depth", [1, 2])
def test_live_run_matches_reference(runs, depth):
    _assert_runs_match(runs["port", depth], runs["ref", depth], depth)
    # the dict capture's counts at ticks 41-42
    assert [p["changed_rows"] for p in runs["port", depth][40:42]] == [1, 1]


@pytest.mark.parametrize("depth", [1, 2])
def test_live_columnar_run_matches_reference(runs, depth):
    """The columnar default against the reference's columnar session,
    tick for tick, including its own ``changed_rows`` at ticks 41-42."""
    port = runs["port_columnar", depth]
    _assert_runs_match(port, runs["ref_columnar", depth], depth)
    assert [p["changed_rows"] for p in port[40:42]] == [0, 0]
    # the two captures rank alike on every tick
    for t, (c, d) in enumerate(zip(port, runs["port", depth])):
        assert_ranked_close(c["ranked"], d["ranked"], f"tick {t + 1}")


def test_port_depth_two_is_depth_one_shifted(runs):
    serial, piped = runs["port", 1], runs["port", 2]
    assert piped[0]["health"]["pipeline_fill"] is True
    assert piped[0]["health"]["result_lag"] == 0
    for t in range(1, 60):
        assert piped[t]["ranked"] == serial[t - 1]["ranked"], t
        assert piped[t]["health"]["result_lag"] == 1
        assert piped[t]["health"]["inflight"] == 1
    assert serial[5]["health"]["pipeline_depth"] == 1
    assert serial[5]["health"]["result_lag"] == 0


def _five(pkg, journal_cap=None, **kw):
    world = pkg["five"]()
    if journal_cap is not None:
        world.journal_cap = journal_cap
    ns = NS if pkg is PORT else REF_NS
    live = pkg["live"](pkg["client"](world), ns, k=3,
                       engine=pkg["engine"](), **kw)
    return world, ns, live


@pytest.mark.parametrize("pkg", [PORT, REF], ids=["port", "ref"])
def test_topology_change_forces_a_resync(pkg):
    world, ns, live = _five(pkg, topology_check_every=100)
    n0 = len(live._names)
    world.add("services", ns, pkg["service"]("brandnew", ns))
    world.add("deployments", ns,
              pkg["deployment"]("brandnew", ns, "brandnew"))
    out = live.poll()
    assert out["resynced"] is True
    assert len(live._names) == n0 + 1
    assert out["health"]["resyncs_topology"] == 1
    assert out["health"]["resync_cause"] == "topology"


def _expire(pkg):
    world, ns, live = _five(pkg, journal_cap=5, topology_check_every=100)
    pod = copy.deepcopy(world.pods[ns][0])
    app = pod["metadata"]["labels"].get("app", "frontend")
    pod["status"]["containerStatuses"] = [
        pkg["waiting"](app, "CrashLoopBackOff", restarts=9,
                       last_exit_code=1)
    ]
    world.pods[ns][0] = pod
    for i in range(20):
        world.touch("pod", ns, f"ghost-{i}")  # trim past the cursor
    return [live.poll() for _ in range(3)], live


def test_expired_feed_recovers_as_the_reference_does():
    port, port_live = _expire(PORT)
    ref, _ = _expire(REF)
    assert port[0].get("recovered") is True
    assert port[0]["resynced"] is False and port_live.resyncs == 0
    assert port[0]["drift_pods"] == ref[0]["drift_pods"] == 1
    assert port[0]["changed_rows"] >= 1
    assert port[1]["quiet"] is False and port[1]["resynced"] is False
    assert port[2]["quiet"] is True
    for p, r in zip(port, ref):
        assert_ranked_close(p["ranked"], r["ranked"])
        assert {k: p[k] for k in POLL_KEYS} == {k: r[k] for k in POLL_KEYS}


def _ladder(pkg, streaming_cls, monkeypatch):
    """Dispatch fails on every rung, then heals: the port and the
    reference are driven the same way, through the session class."""
    world = pkg["world"](30, n_roots=1, seed=7, namespace="dg")
    live = pkg["live"](pkg["client"](world), "dg", k=3,
                       engine=pkg["engine"](), topology_check_every=100,
                       pipeline_depth=2)
    outs = [live.poll()]

    def boom(self):
        raise RuntimeError("device dispatch failed")

    with monkeypatch.context() as mp:
        mp.setattr(streaming_cls, "dispatch", boom)
        outs.append(live.poll())
        outs.append(live.poll())
    outs.extend(live.poll() for _ in range(3))
    return outs, live


def test_degradation_ladder_walks_the_reference_rungs(monkeypatch):
    port, port_live = _ladder(PORT, StreamingSession, monkeypatch)
    ref, _ = _ladder(REF, RefStreaming, monkeypatch)
    keys = ("degradation", "degradation_rung", "pipeline_flushed",
            "inflight", "pipeline_fill")
    for t, (p, r) in enumerate(zip(port, ref)):
        assert p["degraded"] == r["degraded"], t
        assert {k: p["health"][k] for k in keys} == \
            {k: r["health"][k] for k in keys}, t
        assert [f["op"] for f in p["health"]["faults"]] == \
            [f["op"] for f in r["health"]["faults"]], t
        assert_ranked_close(p["ranked"], r["ranked"], f"tick {t}")
    # rung 2 (interpret) is sticky, loud, and on the port the torch row
    assert port[1]["health"]["pipeline_flushed"] == 1
    assert port[-1]["health"]["degradation_rung"] == "interpret"
    assert port[-1]["degraded"] is True
    assert port[-1]["health"]["kernel_path"] == "torch"
    assert port_live.session.kernel_path == "torch"
    assert port[-1]["ranked"]


def test_ladder_on_the_card_raises_instead_of_the_interpret_rung(
        monkeypatch):
    """On a CUDA engine the ladder keeps ``single-device`` (a fresh engine
    on the same kernels) and raises where it would step to ``interpret``,
    at depths 1 and 2: the card never runs the plain versions."""
    from rca_tpu_torch.engine import live as live_mod

    monkeypatch.setattr(live_mod, "_on_card", lambda engine: True)

    def boom(self):
        raise RuntimeError("device dispatch failed")

    for depth in (1, 2):
        world = synthetic_cascade_world(30, n_roots=1, seed=7,
                                        namespace="dg")
        live = LiveStreamingSession(
            MockClusterClient(world), "dg", k=3,
            engine=GraphEngine(device="cpu"), topology_check_every=100,
            pipeline_depth=depth)
        first = live.poll()
        with monkeypatch.context() as mp:
            mp.setattr(StreamingSession, "dispatch", boom)
            with pytest.raises(live_mod.KernelPathFailed):
                live.poll()
        # the raise leaves the tick faults in the fault log
        assert [f["op"] for f in drain_faults()] == \
            ["live.tick[full]" if depth == 1 else "live.dispatch[full]"] * 2 \
            + ["live.tick[single-device]" if depth == 1
               else "live.dispatch[single-device]"] * 2, depth
        assert live.degradation == 1, depth
        assert not first["degraded"], depth


def test_stream_cli_exits_nonzero_when_a_tick_degrades(capsys, monkeypatch):
    """One failing dispatch: the retried tick is marked degraded, its line
    says so and the command exits 1."""
    from rca_tpu_torch.cli import main as port_main

    monkeypatch.setenv("RCA_KERNEL_CACHE", "off")
    calls = {"n": 0}
    real = StreamingSession.dispatch

    def flaky(self):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("device dispatch failed")
        return real(self)

    monkeypatch.setattr(StreamingSession, "dispatch", flaky)
    rc = port_main(["stream", "--fixture", "50svc", "--seed", "7",
                    "--ticks", "4", "--interval", "0", "--device", "cpu"])
    lines = [json.loads(line)
             for line in capsys.readouterr().out.splitlines()]
    assert rc == 1
    assert [line.get("degraded", False) for line in lines] == \
        [False, False, True, False]


def test_incremental_extractor_matches_full_and_reference():
    """After seeded update/delete/NaN/event sequences applied to twin
    worlds, the port's incremental extraction equals its full extraction
    and the reference's, bit for bit (NaN rows included)."""
    ns = "inc"
    port_world = synthetic_cascade_world(30, n_roots=1, seed=2, namespace=ns)
    ref_w = ref_world(30, n_roots=1, seed=2, namespace=ns)
    client, rclient = MockClusterClient(port_world), RefClient(ref_w)
    inc = IncrementalExtractor()
    rng = np.random.default_rng(17)
    checked = 0
    for step in range(40):
        roll = int(rng.integers(0, 7))
        pick = int(rng.integers(0, 10_000))
        arg = int(rng.integers(1, 9))
        for world, waiting, event in ((port_world, waiting_status,
                                       make_event),
                                      (ref_w, ref_waiting_status,
                                       ref_make_event)):
            pods = world.pods[ns]
            pod = pods[pick % len(pods)]
            name = pod["metadata"]["name"]
            if roll <= 3:
                _mutate(world, ns, ("crash", pick, arg), waiting)
            elif roll == 4 and len(pods) > 5:      # delete a pod
                pods.remove(pod)
                world.logs[ns].pop(name, None)
                world.pod_metrics[ns]["pods"].pop(name, None)
                world.touch("pod", ns, name)
            elif roll == 5:                        # poison a metric
                rec = world.pod_metrics[ns]["pods"].get(name)
                if rec:
                    rec["memory"]["usage_percentage"] = float("nan")
                    world.touch("pod_metrics", ns, name)
            elif roll == 6:                        # a warning event
                world.add("events", ns, event(
                    ns, "Pod", name, "BackOff",
                    "Back-off restarting failed container", count=arg))
        if step % 4 != 3:
            continue
        snap = ClusterSnapshot.capture(client, ns, columnar=False)
        got = inc.extract(snap, incremental=True)
        want = extract_features(snap)
        ref = ref_extract(RefSnapshot.capture(rclient, ns, columnar=False))
        for other in (want, ref):
            assert got.service_names == other.service_names
            assert got.pod_names == other.pod_names
            for field in ("pod_features", "service_features", "pod_service",
                          "memb_pod", "memb_svc", "pod_node"):
                assert np.array_equal(getattr(got, field),
                                      getattr(other, field), equal_nan=True)
        checked += 1
        if step % 8 == 3:
            full = inc.extract(snap, incremental=False)
            assert np.array_equal(full.service_features,
                                  want.service_features, equal_nan=True)
    assert checked == 10


def test_incremental_extractor_reuses_cached_rows(monkeypatch):
    """An unchanged capture re-scans no log; a one-pod log change
    re-scans one."""
    from rca_tpu_torch.features import extract as ex

    ns = "hot"
    world = synthetic_cascade_world(25, n_roots=1, seed=4, namespace=ns)
    client = MockClusterClient(world)
    inc = IncrementalExtractor()
    snap = ClusterSnapshot.capture(client, ns, columnar=False)
    inc.extract(snap)
    calls = []
    orig = ex.scan_pod_logs
    monkeypatch.setattr(ex, "scan_pod_logs",
                        lambda logs: calls.append(1) or orig(logs))
    inc.extract(ClusterSnapshot.capture(client, ns, columnar=False))
    assert not calls
    name = sorted(snap.logs)[0]
    app = name.rsplit("-", 1)[0]
    world.logs[ns][name] = {app: "ERROR: fresh failure\n" * 4}
    world.touch("logs", ns, name)
    inc.extract(ClusterSnapshot.capture(client, ns, columnar=False))
    assert len(calls) == 1


def _stream_lines(main, argv, capsys):
    assert main(argv) == 0
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


def _stream_cli_matches(depth, capsys, monkeypatch):
    from rca_tpu.cli import main as ref_main
    from rca_tpu_torch.cli import main as port_main

    monkeypatch.setenv("RCA_SHARD", "0")      # the port has one device
    monkeypatch.setenv("RCA_KERNEL_CACHE", "off")
    args = ["stream", "--fixture", "50svc", "--seed", "7", "--ticks", "6",
            "--interval", "0", "--pipeline-depth", depth]
    port = _stream_lines(port_main, args + ["--device", "cpu"], capsys)
    ref = _stream_lines(ref_main, args, capsys)
    assert len(port) == len(ref) == 6
    for p, r in zip(port, ref):
        assert_ranked_close(p.pop("ranked"), r.pop("ranked"))
        for line in (p, r):
            del line["latency_ms"], line["capture_ms"]
        assert p == r
    assert port[-1]["tick"] == 6


@pytest.mark.parametrize("depth", ["1", "2"])
def test_stream_cli_lines_match_reference(depth, capsys, monkeypatch):
    monkeypatch.setenv("RCA_COLUMNAR", "0")   # both on the dict capture
    _stream_cli_matches(depth, capsys, monkeypatch)


@pytest.mark.parametrize("depth", ["1", "2"])
def test_stream_cli_lines_match_reference_columnar(depth, capsys,
                                                   monkeypatch):
    monkeypatch.delenv("RCA_COLUMNAR", raising=False)   # the default
    _stream_cli_matches(depth, capsys, monkeypatch)


def test_health_record_has_every_reference_key(runs):
    for depth in (1, 2):
        assert set(runs["port", depth][5]["health"]) == \
            set(runs["ref", depth][5]["health"])
        assert set(runs["port", depth][5]["health"]["kernelscope"]) == \
            set(runs["ref", depth][5]["health"]["kernelscope"])


@pytest.mark.parametrize("name,values", [
    ("RCA_PIPELINE_DEPTH", ["", "1", "3", "0", "-2", "fast"]),
    ("RCA_TRACE", ["", "1", "off", "ON", "maybe"]),
    ("RCA_TRACE_BUFFER", ["", "64", "100000", "63", "x"]),
    ("RCA_KERNELSCOPE", ["", "0", "on", "2"]),
    ("RCA_MEM_SAMPLE_EVERY", ["", "1", "500", "0", "often"]),
])
def test_live_knobs_parse_as_the_reference(monkeypatch, name, values):
    """Each knob gives the reference's value, and raises ``ValueError``
    where the reference raises."""
    from rca_tpu import config as ref_cfg
    from rca_tpu_torch import config as port_cfg

    fn = {"RCA_PIPELINE_DEPTH": "pipeline_depth_from_env",
          "RCA_TRACE": "trace_enabled",
          "RCA_TRACE_BUFFER": "trace_buffer_cap",
          "RCA_KERNELSCOPE": "kernelscope_enabled",
          "RCA_MEM_SAMPLE_EVERY": "memory_sample_every"}[name]
    for raw in values:
        monkeypatch.setenv(name, raw)
        try:
            want = getattr(ref_cfg, fn)()
        except ValueError:
            with pytest.raises(ValueError):
                getattr(port_cfg, fn)()
            continue
        assert getattr(port_cfg, fn)() == want, (name, raw)


def test_compile_cache_is_the_kernel_build_directory():
    from rca_tpu_torch.config import compile_cache_status
    from rca_tpu_torch.kernels.build import BUILD_DIR

    status = compile_cache_status()
    assert status["enabled"] is True and status["dir"] == str(BUILD_DIR)
    assert status["entries"] >= 0


def test_recompile_monitor_counts_a_registry_re_election(monkeypatch):
    """A plan election is a compile; the same signature elected again in
    the window (after the registry was cleared) is a recompile."""
    from rca_tpu_torch.engine import registry
    from rca_tpu_torch.observability.kernelscope import RecompileMonitor

    monkeypatch.setenv("RCA_KERNEL_CACHE", "off")
    monitor = RecompileMonitor(enabled=True).start()
    registry.get_registry().resolve(4096, 8192, device="cpu")
    registry.get_registry().resolve(4096, 8192, device="cpu")  # cached
    monitor.mark_warm()
    assert monitor.snapshot()["recompiles"] == 0
    registry.reset_registry()
    registry.get_registry().resolve(4096, 8192, device="cpu")
    snap = monitor.snapshot()
    assert snap["compiles"] >= 2
    assert (snap["recompiles"], snap["recompiles_post_warm"]) == (1, 1)
    assert snap["recompiled"] == ["plan dense:4096:8192:8 on cpu"]
    assert RecompileMonitor(enabled=False).start().snapshot()["enabled"] \
        is False


def test_leak_gate_and_accountant_equal_reference():
    from rca_tpu.observability.kernelscope import leak_gate as ref_gate
    from rca_tpu_torch.observability.kernelscope import (
        DeviceMemoryAccountant,
        leak_gate,
    )

    for series in ([5, 5, 5, 5], [1, 2 << 20, 4 << 20, 8 << 20],
                   [1, 3 << 20, 2 << 20, 9 << 20], [7, 8]):
        assert leak_gate(series) == ref_gate(series)
    acct = DeviceMemoryAccountant(sample_every=2, enabled=True)
    assert acct.maybe_sample(1) is None
    sample = acct.maybe_sample(2)
    assert set(sample) == {"devices", "bytes_in_use"}
    assert acct.gate()["ok"]


def test_tracer_mints_the_reference_spans():
    """Seeded tracers record the same span dicts (ids, parents, times)."""
    ref = ref_spans.Tracer(seed=3, cap=64)
    port = port_spans.Tracer(seed=3, cap=64)
    for tracer in (ref, port):
        root = tracer.new_context()
        tracer.record("tick", 1.0, 2.0, context=root, attrs={"tick": 1})
        tracer.record("tick.capture", 1.0, 1.5, parent=root)
        with tracer.span("scope", parent=root):
            pass
    drop_times = [
        {k: v for k, v in s.items() if k not in ("start", "end")}
        for s in ref.spans()]
    assert [{k: v for k, v in s.items() if k not in ("start", "end")}
            for s in port.spans()] == drop_times
    assert port.spans()[:2] == ref.spans()[:2]
    assert port.stats() == ref.stats()
    assert port_spans.NULL_TRACER.record("x", 0, 1) is None


def test_fault_log_suppressed_and_drained():
    from rca_tpu_torch.resilience import policy

    # the retry counter is process-wide: files run before this one in the
    # same worker may have spent retries, none of this test's calls may
    retries = policy.retry_counter()
    policy.drain_faults()
    with policy.suppressed("op.a"):
        raise KeyError("gone")
    policy.record_fault("op.b", "text")
    assert policy.drain_faults() == [
        {"op": "op.a", "error": "KeyError: 'gone'"},
        {"op": "op.b", "error": "text"}]
    assert policy.drain_faults() == []
    with pytest.raises(KeyboardInterrupt):
        with policy.suppressed("op.c"):
            raise KeyboardInterrupt
    assert policy.retry_counter() == retries


def test_explained_ticks_attribute_the_delivered_ranking(monkeypatch):
    monkeypatch.setenv("RCA_KERNEL_CACHE", "off")
    _, _, live = _five(PORT, topology_check_every=100, explain=True)
    out = live.poll()
    assert out["attribution_digest"] and "attribution_error" not in out
    comps = [c["component"] for c in out["attribution"]["candidates"]]
    assert comps == [r["component"] for r in out["ranked"]]
