"""The port's elastic fleet (``rca_tpu_torch.serve.autoscale``: the
controller, its thread fleet, the ramp soak and the scaling storm, and
``ServeMetrics.autoscale_signals``) against the JAX package's.

- the CONTROLLER on a fake clock over a stub plane: each scripted signal
  sequence (surge, a breach interrupted, cooldown, the max and min clamps,
  least-loaded / newest-first victims, the re-arm after an action,
  ``force`` with and without victims, ``ensure_min``, ``status()``) runs
  through ``rca_tpu.serve.autoscale.AutoscaleController`` and the port's
  over twin planes, and the two decision logs (returns, recorded
  decisions, spawns, drains, events, metric counters) are identical apart
  from ``decision_ms``; then the reference's own controller tests, ported;
  then what the port adds: a spawned worker that has not joined counts
  toward the fleet, and no worker id is handed out twice;
- the metrics: ``autoscale_signals()`` and the summary's ``autoscale``
  block equal the reference's over the same samples, past
  ``_RECENT_QUEUE_CAP``;
- the plane: ``health()`` and ``fleet`` carry a live controller's block;
- the thread fleet: a 2→8→2 ramp soak on the CPU passes the reference's
  gates, each ok answer bitwise its solo analysis in this process and its
  top-k the reference engine's on the same features; four loops on one
  engine under concurrent submits answer bitwise solo; the scaling storm
  in thread mode (about 3 s on a CPU host, so not marked ``slow``) and in
  process mode (``--device cpu`` workers) observes ``scaling_storm``.

The rule tables, placement and the hello-evidence parsers are held to the
reference in ``tests/test_torch_federation_rules.py``; the drain that is
never a ``process_kill``, the rejoin backoff and the knobs of the plane
in ``tests/test_torch_federation.py``.  Every plane is stopped and every
worker closed in ``finally``; every wait takes a timeout.
"""

import collections
import json
import threading
import time

import numpy as np
import pytest

from rca_tpu.serve import autoscale as ref_auto
from rca_tpu.serve.metrics import ServeMetrics as RefMetrics
from rca_tpu_torch.serve import autoscale as auto
from rca_tpu_torch.serve.autoscale import (
    AutoscaleController,
    ScaleRule,
    ScaleRuleSet,
    run_scale_ramp_soak,
    run_scaling_storm,
)
from rca_tpu_torch.serve.federation import FederationPlane
from rca_tpu_torch.serve.fedwire import FrameConn, FrameError, PROTO
from rca_tpu_torch.serve.metrics import _RECENT_QUEUE_CAP, ServeMetrics
from rca_tpu_torch.util.net import make_client_socket
from rca_tpu_torch.util.threads import spawn


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


# ---------------------------------------------------------------------------
# The controller on a fake clock over a stub plane
# ---------------------------------------------------------------------------


class StubMetrics:
    def __init__(self):
        self.events = collections.Counter()
        self.signals = {"queue_ms_p99_recent": None, "recent_samples": 0,
                        "slo_breach_total": 0}

    def autoscale_signals(self):
        return dict(self.signals)

    def scale_event(self, kind):
        self.events[kind] += 1


class StubPlane:
    """Just enough surface for the controller: live-set arithmetic,
    spawn / drain recording, and the metrics signal block.  ``spawning``
    lists workers spawned but not joined (what a process fleet's plane
    reports); None leaves the key out, as the reference's plane does."""

    def __init__(self, clock, live=2, window=4, spawning=None):
        self.clock = clock
        self.metrics = StubMetrics()
        self.queue = []
        self.window = window
        self.autoscaler = None
        self.workers = {i: 0 for i in range(live)}   # wid -> outstanding
        self.spawning = spawning
        self.spawned = []
        self.drained = []
        self.events = []

    def scale_status(self):
        live = sorted(self.workers)
        known = set(self.workers) | set(self.spawning or ())
        status = {"live": live, "draining": [],
                  "outstanding": dict(self.workers),
                  "next_id": (max(known) + 1) if known else 0}
        if self.spawning is not None:
            status["spawning"] = list(self.spawning)
        return status

    def pending_count(self):
        return sum(self.workers.values())

    def spawn_worker(self, wid):
        self.workers[wid] = 0
        self.spawned.append(wid)

    def drain_worker(self, wid):
        if wid not in self.workers:
            return False
        del self.workers[wid]
        self.drained.append(wid)
        return True

    def _event(self, name, wid, **kw):
        self.events.append({"event": name, "worker_id": wid, **kw})


def _controller(mod, plane, **kw):
    kw.setdefault("min_workers", 1)
    kw.setdefault("max_workers", 8)
    kw.setdefault("cooldown_s", 10.0)
    kw.setdefault("interval_s", 1.0)
    return mod.AutoscaleController(plane, **kw)


def _surge(mod, plane):
    ctl = _controller(mod, plane)
    plane.queue = [0] * 40                   # queue_depth 40 > 32
    return [ctl.run_once(now=t) for t in (1000.0, 1004.0, 1005.0)], ctl


def _interrupted(mod, plane):
    ctl = _controller(mod, plane)
    out = []
    for t, depth in ((1000.0, 40), (1003.0, 0), (1004.0, 40), (1008.0, 40),
                     (1009.0, 40)):
        plane.queue = [0] * depth
        out.append(ctl.run_once(now=t))
    return out, ctl


def _cooldown(mod, plane):
    ctl = _controller(mod, plane, cooldown_s=10.0)
    plane.queue = [0] * 40
    return [ctl.run_once(now=t) for t in (1000.0, 1005.0, 1006.0, 1012.0,
                                          1016.0)], ctl


def _max_clamp(mod, plane):
    for wid in (2, 3):
        plane.workers[wid] = 0
    ctl = _controller(mod, plane, max_workers=4)
    plane.queue = [0] * 40
    return [ctl.run_once(now=t) for t in (1000.0, 1005.0)], ctl


def _min_clamp(mod, plane):
    ctl = _controller(mod, plane, min_workers=2)
    return [ctl.run_once(now=t) for t in (1000.0, 1030.0)], ctl


def _least_loaded(mod, plane):
    plane.workers = {0: 5, 1: 0, 2: 0, 3: 1}
    ctl = _controller(mod, plane, min_workers=1, cooldown_s=1.0)
    out = [ctl.run_once(now=1000.0)]
    plane.workers = {0: 1, 1: 0, 2: 0, 3: 0}
    out += [ctl.run_once(now=t) for t in (1001.0, 1031.0, 1032.0, 1063.0)]
    return out, ctl


def _rearm(mod, plane):
    ctl = _controller(mod, plane, cooldown_s=0.5)
    plane.queue = [0] * 40
    return [ctl.run_once(now=t) for t in (1000.0, 1005.0, 1006.0, 1011.1)], \
        ctl


def _force_victims(mod, plane):
    ctl = _controller(mod, plane, max_workers=3, cooldown_s=1000.0)
    out = [ctl.force("up", step=5, rule="chaos"),
           ctl.force("down", victims=[0], rule="chaos"),
           ctl.force("down", victims=[7], rule="chaos-unknown")]
    with pytest.raises(ValueError):
        ctl.force("sideways")
    return out, ctl


def _force_no_victims(mod, plane):
    plane.workers = {0: 3, 1: 0, 2: 2, 3: 0}
    ctl = _controller(mod, plane, min_workers=2, cooldown_s=1000.0)
    out = [ctl.force("down", step=1, rule="probe"),
           ctl.force("down", step=3, rule="probe"),
           ctl.force("down", rule="probe"),
           ctl.force("up", step=2, rule="probe")]
    return out, ctl


def _ensure_min(mod, plane):
    plane.workers = {}
    ctl = _controller(mod, plane, min_workers=3)
    first, again = ctl.ensure_min(), ctl.ensure_min()
    return [{"spawned": first}, {"spawned": again}], ctl


def _status(mod, plane):
    ctl = _controller(mod, plane, min_workers=1, max_workers=8)
    out = [ctl.status()]
    ctl.force("up", rule="probe")
    plane.metrics.signals.update(queue_ms_p99_recent=12.5,
                                 slo_breach_total=4)
    out += [ctl.run_once(now=1000.0), ctl.signals(), ctl.signals(),
            ctl.status()]
    return out, ctl


SCRIPTS = {
    "surge": _surge, "breach_interrupted": _interrupted,
    "cooldown": _cooldown, "max_clamp": _max_clamp, "min_clamp": _min_clamp,
    "least_loaded_newest_first": _least_loaded, "rearm": _rearm,
    "force_victims": _force_victims, "force_no_victims": _force_no_victims,
    "ensure_min": _ensure_min, "status": _status,
}


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k != "decision_ms"}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _run_script(mod, name):
    plane = StubPlane(FakeClock(), live=2)
    out, ctl = SCRIPTS[name](mod, plane)
    assert plane.autoscaler is ctl
    return _strip({
        "returns": out, "decisions": list(ctl.decisions),
        "decision_total": ctl.decision_total, "spawned": plane.spawned,
        "drained": plane.drained, "events": plane.events,
        "metrics": dict(plane.metrics.events), "status": ctl.status(),
    })


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_controller_decisions_equal_the_reference(script):
    assert _run_script(auto, script) == _run_script(ref_auto, script)


def test_bounds_validation():
    plane = StubPlane(FakeClock())
    for lo, hi in ((0, 4), (5, 4)):
        with pytest.raises(ValueError) as mine:
            AutoscaleController(plane, min_workers=lo, max_workers=hi)
        with pytest.raises(ValueError) as theirs:
            ref_auto.AutoscaleController(plane, min_workers=lo,
                                         max_workers=hi)
        assert str(mine.value) == str(theirs.value)


def test_sustain_window_gates_the_fire():
    plane = StubPlane(FakeClock(), live=2)
    ctl = _controller(auto, plane)
    plane.queue = [0] * 40
    assert ctl.run_once(now=1000.0)["action"] == "hold"
    assert ctl.run_once(now=1004.0)["action"] == "hold"
    d = ctl.run_once(now=1005.0)
    assert d["action"] == "up" and d["rule"] == "surge-depth"
    assert plane.spawned == [2, 3]
    assert plane.metrics.events["scale_ups"] == 1


def test_breach_interruption_resets_sustain():
    plane = StubPlane(FakeClock(), live=2)
    ctl = _controller(auto, plane)
    plane.queue = [0] * 40
    ctl.run_once(now=1000.0)
    plane.queue = []
    ctl.run_once(now=1003.0)
    plane.queue = [0] * 40
    ctl.run_once(now=1004.0)
    assert ctl.run_once(now=1008.0)["action"] == "hold"
    assert plane.spawned == []


def test_cooldown_blocks_consecutive_actions():
    plane = StubPlane(FakeClock(), live=2)
    ctl = _controller(auto, plane, cooldown_s=10.0)
    plane.queue = [0] * 40
    ctl.run_once(now=1000.0)
    assert ctl.run_once(now=1005.0)["action"] == "up"
    ctl.run_once(now=1006.0)
    assert ctl.run_once(now=1012.0)["action"] == "cooldown"
    assert plane.metrics.events["cooldown_skips"] >= 1
    assert plane.spawned == [2, 3]
    assert ctl.run_once(now=1016.0)["action"] == "up"
    assert plane.spawned == [2, 3, 4, 5]


def test_max_and_min_clamps_hold():
    plane = StubPlane(FakeClock(), live=4)
    ctl = _controller(auto, plane, max_workers=4)
    plane.queue = [0] * 40
    ctl.run_once(now=1000.0)
    assert ctl.run_once(now=1005.0)["action"] == "clamped"
    assert plane.spawned == [] and plane.metrics.events["clamps"] == 1
    plane = StubPlane(FakeClock(), live=2)
    ctl = _controller(auto, plane, min_workers=2)
    ctl.run_once(now=1000.0)
    assert ctl.run_once(now=1030.0)["action"] == "clamped"
    assert plane.drained == []


def test_scale_down_picks_least_loaded_newest_first():
    plane = StubPlane(FakeClock(), live=3)
    ctl = _controller(auto, plane, min_workers=1)
    plane.workers = {0: 0, 1: 0, 2: 0}
    ctl.run_once(now=1001.0)
    d = ctl.run_once(now=1031.0)
    assert d["action"] == "down" and plane.drained == [2]
    assert plane.metrics.events["scale_downs"] == 1


def test_action_rearms_every_sustain_window():
    plane = StubPlane(FakeClock(), live=2)
    ctl = _controller(auto, plane, cooldown_s=0.5)
    plane.queue = [0] * 40
    ctl.run_once(now=1000.0)
    assert ctl.run_once(now=1005.0)["action"] == "up"
    assert ctl.run_once(now=1006.0)["action"] == "hold"
    assert ctl.run_once(now=1011.1)["action"] == "up"


def test_force_bypasses_sustain_and_cooldown_not_clamps():
    plane = StubPlane(FakeClock(), live=2)
    ctl = _controller(auto, plane, max_workers=3, cooldown_s=1000.0)
    d = ctl.force("up", step=5, rule="chaos")
    assert d["forced"] and d["action"] == "up" and plane.spawned == [2]
    ctl.force("down", victims=[0], rule="chaos")
    assert plane.drained == [0] and plane.metrics.events["forced"] == 2
    with pytest.raises(ValueError):
        ctl.force("sideways")


def test_ensure_min_and_status():
    plane = StubPlane(FakeClock(), live=0)
    ctl = _controller(auto, plane, min_workers=3)
    assert ctl.ensure_min() == [0, 1, 2] and ctl.ensure_min() == []
    st = ctl.status()
    assert (st["min"], st["max"], st["running"], st["last_decision"]) == (
        3, 8, False, None)
    ctl.force("up", rule="probe")
    st = ctl.status()
    assert st["decisions"] == 1 and st["last_decision"]["rule"] == "probe"


def test_start_runs_sweeps_on_a_named_thread_and_stops():
    plane = StubPlane(FakeClock(), live=2)
    ctl = _controller(auto, plane, interval_s=0.01, min_workers=3)
    try:
        ctl.start()
        assert plane.spawned == [2]                  # ensure_min
        assert ctl._thread.name == "rca-fed-autoscale"
        assert ctl.status()["running"]
        deadline = time.monotonic() + 30.0
        while (time.monotonic() < deadline
               and plane.metrics.events["holds"] < 3):
            time.sleep(0.01)
        assert plane.metrics.events["holds"] >= 3
    finally:
        ctl.stop()
    assert not ctl.status()["running"]


def test_a_worker_still_joining_counts_toward_the_fleet():
    """A process fleet's plane reports spawned workers that have not
    said hello: a surge sustained past the cooldown spawns only what the
    fleet still lacks, and nothing past ``max_workers``."""
    plane = StubPlane(FakeClock(), live=2, spawning=[2, 3])
    ctl = _controller(auto, plane, max_workers=4, cooldown_s=0.5)
    plane.queue = [0] * 40
    ctl.run_once(now=1000.0)
    d = ctl.run_once(now=1005.0)
    assert d["action"] == "clamped" and d["spawning"] == 2
    assert plane.spawned == []
    plane.spawning = [3]                   # 2 joined, 3 on its way
    plane.workers[2] = 0
    ctl = _controller(auto, plane, max_workers=6, cooldown_s=0.5)
    ctl.run_once(now=2000.0)
    d = ctl.run_once(now=2005.0)
    assert d["action"] == "up" and d["to"] == 6
    assert plane.spawned == [4, 5]         # 3 is the worker still joining


def test_no_worker_id_is_handed_out_twice():
    """A thread member registers with the plane only at its hello: ids
    handed out before then are not handed out again."""
    plane = StubPlane(FakeClock(), live=2)
    late = []
    ctl = _controller(auto, plane, cooldown_s=0.0, max_workers=8,
                      spawner=late.append)
    plane.queue = [0] * 40
    ctl.run_once(now=1000.0)
    ctl.run_once(now=1005.0)
    ctl.run_once(now=1005.5)
    ctl.run_once(now=1011.0)
    assert late == [2, 3, 4, 5]


# ---------------------------------------------------------------------------
# The metrics' signals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("samples", [0, 7, _RECENT_QUEUE_CAP,
                                     _RECENT_QUEUE_CAP + 300])
def test_autoscale_signals_equal_the_reference(samples):
    rng = np.random.default_rng(samples)
    mine, theirs = ServeMetrics(slo_ms_target=50.0), \
        RefMetrics(slo_ms_target=50.0)
    assert _RECENT_QUEUE_CAP == 512
    for i in range(samples):
        tenant = f"t{i % 3}"
        queue_ms = float(rng.exponential(20.0))
        status = ("ok", "ok", "shed", "error")[i % 4]
        for m in (mine, theirs):
            m.answered(tenant, queue_ms)
            m.request_duration(tenant, queue_ms * 2.0, status)
        if i == 100:                      # a surge, then calm
            for m in (mine, theirs):
                for _ in range(50):
                    m.answered(tenant, 5000.0)
    assert mine.autoscale_signals() == theirs.autoscale_signals()
    for kind in ("scale_ups", "holds", "holds", "forced"):
        mine.scale_event(kind)
        theirs.scale_event(kind)
    mine.placement("rendezvous")
    theirs.placement("rendezvous")
    assert mine.summary()["autoscale"] == theirs.summary()["autoscale"]
    assert mine.summary()["placement"] == theirs.summary()["placement"]
    assert mine.snapshot()["scale_events"] == \
        theirs.snapshot()["scale_events"]


def test_a_loops_summary_has_no_autoscale_block():
    mine, theirs = ServeMetrics(), RefMetrics()
    for m in (mine, theirs):
        m.answered("t", 1.0)
    assert "autoscale" not in mine.summary()
    assert "autoscale" not in theirs.summary()
    mine.scale_event("holds")
    assert mine.summary()["autoscale"]["holds"] == 1
    assert mine.summary()["placement"]["hit_rate"] is None


def test_config_scale_knobs_equal_the_reference(monkeypatch):
    from rca_tpu import config as ref_config
    from rca_tpu_torch import config

    names = ("fed_scale_min", "fed_scale_max", "fed_scale_cooldown_s",
             "fed_scale_interval_s")
    for fn in names:
        assert getattr(config, fn)() == getattr(ref_config, fn)()
    monkeypatch.setenv("RCA_FED_SCALE_MIN", "3")
    monkeypatch.setenv("RCA_FED_SCALE_MAX", "12")
    monkeypatch.setenv("RCA_FED_SCALE_COOLDOWN_S", "2.5")
    monkeypatch.setenv("RCA_FED_SCALE_INTERVAL_S", "0.25")
    assert (config.fed_scale_min(), config.fed_scale_max(),
            config.fed_scale_cooldown_s(),
            config.fed_scale_interval_s()) == (3, 12, 2.5, 0.25)
    ctl = AutoscaleController(StubPlane(FakeClock()))
    assert (ctl.min_workers, ctl.max_workers, ctl.cooldown_s,
            ctl.interval_s) == (3, 12, 2.5, 0.25)
    for name, bad in (("RCA_FED_SCALE_MIN", "0"),
                      ("RCA_FED_SCALE_COOLDOWN_S", "0.01"),
                      ("RCA_FED_SCALE_INTERVAL_S", "soon")):
        monkeypatch.setenv(name, bad)
        fn = {"RCA_FED_SCALE_MIN": "fed_scale_min",
              "RCA_FED_SCALE_COOLDOWN_S": "fed_scale_cooldown_s",
              "RCA_FED_SCALE_INTERVAL_S": "fed_scale_interval_s"}[name]
        with pytest.raises(ValueError) as mine:
            getattr(config, fn)()
        with pytest.raises(ValueError) as theirs:
            getattr(ref_config, fn)()
        assert str(mine.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# The plane: health and fleet carry a live controller
# ---------------------------------------------------------------------------


class FakeWorker:
    """An in-process worker over a loopback socket speaking the real
    protocol: heartbeats, answers every request ok, answers a drain."""

    def __init__(self, worker_id, plane, registry=None, heartbeat_s=0.05):
        self.worker_id = worker_id
        self.lease_id = None
        self.served = 0
        self._lock = threading.Lock()
        sock = make_client_socket(f"fake{worker_id}", plane.host,
                                  plane.port)
        self.conn = FrameConn(sock, name=f"fake{worker_id}")
        hello = {"t": "hello", "proto": PROTO, "worker_id": worker_id,
                 "pid": 0, "engine": "fake"}
        if registry is not None:
            hello["registry"] = registry
        self.conn.send(hello)
        self.heartbeat_s = heartbeat_s
        spawn(self._read_loop, name=f"fake{worker_id}-read", daemon=True)
        spawn(self._hb_loop, name=f"fake{worker_id}-hb", daemon=True)

    def _read_loop(self):
        while True:
            try:
                msg = self.conn.recv()
            except (FrameError, OSError):
                return
            if msg is None:
                return
            t = msg.get("t")
            if t == "lease":
                with self._lock:
                    self.lease_id = msg["lease_id"]
            elif t == "req":
                self.conn.send({
                    "t": "resp", "request_id": msg["request_id"],
                    "status": "ok", "batch_size": 1, "engine": "fake",
                    "ranked": [{"component": f"svc-{self.worker_id}",
                                "score": 1.0}]})
                self.served += 1
            elif t == "drain":
                self.conn.send({"t": "drained", "served": self.served})

    def _hb_loop(self):
        seq = 0
        while not self.conn.closed:
            time.sleep(self.heartbeat_s)
            with self._lock:
                lease = self.lease_id
            if lease is None:
                continue
            seq += 1
            if not self.conn.send({"t": "hb", "worker_id": self.worker_id,
                                   "lease_id": lease, "seq": seq}):
                return

    def close(self):
        self.conn.close()


def test_health_and_fleet_carry_a_live_controller(capsys):
    from rca_tpu_torch.cli import main
    from rca_tpu_torch.gateway import GatewayClient, GatewayServer

    plane = FederationPlane(workers=1, spawn_workers=False, heartbeat_s=0.05,
                            lease_misses=3).start()
    fakes = [FakeWorker(0, plane, registry={"64": 1.0})]
    ctl = AutoscaleController(plane, min_workers=1, max_workers=4,
                              interval_s=0.05)
    try:
        assert plane.wait_ready(1, timeout_s=30.0)
        h = plane.health()
        assert [w["worker_id"] for w in h["fleet"]] == [0]
        assert h["fleet"][0]["shapes_known"] == 1
        assert h["fleet"][0]["draining"] is False
        assert (h["autoscale"]["min"], h["autoscale"]["max"],
                h["autoscale"]["running"]) == (1, 4, False)
        ctl.start(spawn_min=False)
        with GatewayServer(plane, port=0) as gw:
            code, body = GatewayClient(gw.host, gw.port,
                                       timeout_s=30).healthz()
            assert code == 200 and body["autoscale"]["running"]
            assert main(["fleet", f"http://{gw.host}:{gw.port}"]) == 0
            line = capsys.readouterr().out.strip().splitlines()[-1]
            fleet = json.loads(line)["autoscale"]
            assert fleet["bounds"] == "1:4" and fleet["running"] is True
    finally:
        ctl.stop()
        plane.stop()
        for f in fakes:
            f.close()


def test_spawned_process_counts_as_spawning_until_its_hello():
    """The plane's ``scale_status`` lists a serve process it spawned
    until that process says hello, and never an ingest one."""
    plane = FederationPlane(workers=1, spawn_workers=False, heartbeat_s=1.0,
                            device="cpu").start()
    try:
        plane.spawn_worker(0)
        plane.spawn_worker(1, role="ingest")
        assert plane.scale_status()["spawning"] == [0]
        assert plane.wait_ready(2, timeout_s=240.0), plane.worker_table()
        status = plane.scale_status()
        assert status["spawning"] == [] and status["live"] == [0, 1]
        assert status["next_id"] == 2
    finally:
        plane.stop()


# ---------------------------------------------------------------------------
# The thread fleet: one engine, the ramp soak, the storm
# ---------------------------------------------------------------------------


def _cascade_request(case, feats, tenant, k=3):
    from rca_tpu_torch.serve.request import ServeRequest

    return ServeRequest(tenant=tenant, features=feats, dep_src=case.dep_src,
                        dep_dst=case.dep_dst, names=case.names, k=k)


def test_four_loops_on_one_engine_answer_bitwise_solo():
    """The thread fleet shares one engine: four ServeLoops on it, each
    fed by concurrent submitters, answer every request bitwise its solo
    analysis, whichever loop served it."""
    from rca_tpu_torch import GraphEngine
    from rca_tpu_torch.cluster.generator import synthetic_cascade_arrays
    from rca_tpu_torch.config import ServeConfig
    from rca_tpu_torch.serve import ServeLoop

    engine = auto._thread_fleet_engine("cpu")
    cases = [synthetic_cascade_arrays(n, n_roots=1, seed=i)
             for i, n in enumerate((24, 48, 120))]
    rng = np.random.default_rng(3)
    items = [(cases[i % 3], np.clip(cases[i % 3].features + rng.uniform(
        0, 0.05, cases[i % 3].features.shape).astype(np.float32), 0, 1))
        for i in range(48)]
    loops = [ServeLoop(engine=engine, config=ServeConfig(max_batch=4))
             for _ in range(4)]
    reqs = [None] * len(items)

    def submitter(w):
        for i in range(w, len(items), 8):
            case, feats = items[i]
            reqs[i] = _cascade_request(case, feats, f"t{w}")
            loops[i % 4].submit(reqs[i])

    for loop in loops:
        loop.start()
    try:
        threads = [spawn(submitter, name=f"sub{w}", args=(w,))
                   for w in range(8)]
        for t in threads:
            t.join(60.0)
        resps = [r.result(120.0) for r in reqs]
    finally:
        for loop in loops:
            loop.stop()
    assert sum(loop.device_batches for loop in loops) < len(items)
    solo = GraphEngine(device="cpu")
    for (case, feats), resp in zip(items, resps):
        assert resp.status == "ok"
        want = solo.analyze_arrays(feats, case.dep_src, case.dep_dst,
                                   case.names, k=3)
        assert resp.ranked == [dict(r) for r in want.ranked]


def test_scale_ramp_soak_2_8_2(monkeypatch):
    """The tentpole contract on the CPU: under continuous traffic the
    thread fleet walks 2→8→2 with every request terminal, no double
    completion and the windowed queue p99 bounded; each ok answer is
    bitwise its solo analysis here and ranks the reference engine's
    top-k on the same features."""
    from rca_tpu.engine import GraphEngine as RefEngine
    from rca_tpu_torch import GraphEngine

    kept = []
    submit = FederationPlane.submit

    def keep(self, req):
        kept.append(req)
        return submit(self, req)

    monkeypatch.setattr(FederationPlane, "submit", keep)
    out = run_scale_ramp_soak(seed=0, min_workers=2, max_workers=8,
                              device="cpu")
    assert out["ok"], out
    assert out["all_terminal"] and out["double_completions"] == 0
    assert out["peaked"] and out["shrunk"] and out["p99_ok"]
    assert out["scale_ups"] >= 1 and out["scale_downs"] >= 1
    assert out["by_status"].get("hung", 0) == 0
    assert out["requests"] == sum(out["by_status"].values()) == len(kept)
    assert out["placement_hit_rate"] == 0.0       # no timed row on the CPU
    assert out["scale_decision_ms_p50"] is not None
    solo, ref = GraphEngine(device="cpu"), RefEngine()
    checked = 0
    for req in kept:
        resp = req.response
        if resp.status != "ok":
            continue
        got = solo.analyze_arrays(req.features, req.dep_src, req.dep_dst,
                                  req.names, k=3)
        assert resp.ranked == [dict(r) for r in got.ranked]
        want = ref.analyze_arrays(req.features, req.dep_src, req.dep_dst,
                                  req.names, k=3)
        assert [r["component"] for r in resp.ranked] == [
            r["component"] for r in want.ranked]
        np.testing.assert_allclose(
            [r["score"] for r in resp.ranked],
            [r["score"] for r in want.ranked], rtol=1e-5, atol=1e-6)
        checked += 1
    assert checked == out["by_status"]["ok"] >= 150


def test_controller_and_thread_fleet_under_rsan():
    """The autoscale controller over a thread fleet on the CPU with every
    lock sanitized: a 2→4→2 ramp soak under eight closed-loop submitters
    stays terminal and exactly-once, rsan observes no race and no
    lock-order contradiction against the port's static model, and the
    controller's, the plane's and the fleet's locks are taken from
    several threads."""
    from rca_tpu_torch.analysis.concurrency import model_for, rsan
    from rca_tpu_torch.analysis.concurrency.crosscheck import (
        order_contradictions,
    )
    from rca_tpu_torch.analysis.core import repo_root

    was = rsan.enabled()
    rsan.enable()
    rsan.RSAN.reset()
    try:
        out = run_scale_ramp_soak(seed=0, min_workers=2, max_workers=4,
                                  heavy_threads=8, heavy_requests_each=4,
                                  device="cpu")
        assert out["ok"], out
        assert out["all_terminal"] and out["double_completions"] == 0
        assert out["scale_ups"] >= 1 and out["scale_downs"] >= 1
        assert rsan.RSAN.races_observed() == []
        lt = rsan.RSAN.lock_threads()
        for name in ("AutoscaleController._lock", "FederationPlane._lock",
                     "LeaseTable._lock", "WorkerAgent._lock",
                     "FrameConn._wlock", "RequestQueue._cond"):
            assert len(lt.get(name, ())) >= 2, name
        assert order_contradictions(
            model_for(repo_root()).static_order_edges(),
            rsan.RSAN.order_edges()) == []
    finally:
        rsan.RSAN.reset()
        if not was:
            rsan.disable()


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_scaling_storm_chaos_gate(mode):
    """Every forced transition racing a fault seam observed, no double
    completion, stale drops bounded; in process mode the half-born worker
    is a ``--device cpu`` process SIGKILLed the moment it joins."""
    out = run_scaling_storm(seed=0, worker_mode=mode, device="cpu")
    assert out["ok"], out
    assert out["worker_mode"] == mode
    assert "scaling_storm" in out["fault_classes_observed"]
    assert {"process_kill", "worker_hang", "coordinator_partition"} <= set(
        out["fault_classes_observed"])
    assert out["double_completions"] == 0
    assert out["stale_responses"] <= out["stale_bound"]
    assert [p["race"] for p in out["phases"]] == [
        "scaleup_vs_kill", "rejoin_vs_drain", "partition_vs_scaledown"]


def test_storm_keeps_its_class_out_of_the_planes_vocabulary():
    from rca_tpu_torch.serve.federation import FED_FAULT_CLASSES

    assert auto.SCALING_FAULT_CLASSES == ref_auto.SCALING_FAULT_CLASSES
    assert not set(auto.SCALING_FAULT_CLASSES) & set(FED_FAULT_CLASSES)
    with pytest.raises(ValueError, match="worker_mode"):
        run_scaling_storm(worker_mode="fiber", device="cpu")


def test_soak_rules_are_a_valid_table():
    """The tables the soak and the storm build pass validation: the
    soak's occupancy band and the storm's wide-open pair."""
    ScaleRuleSet(rules=(
        ScaleRule("soak-depth", "queue_depth", ">", 4.0, 0.10, "up", 2),
        ScaleRule("soak-idle", "occupancy", "<", 0.20, 0.70, "down", 2),
    ))
    with pytest.raises(ValueError, match="hysteresis"):
        ScaleRuleSet(rules=(
            ScaleRule("up", "occupancy", ">", 0.5, 0.1, "up"),
            ScaleRule("down", "occupancy", "<", 0.5, 0.1, "down"),
        ))
