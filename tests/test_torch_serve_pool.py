"""The port's serve pool (``rca_tpu_torch.serve.pool``) against the JAX
package's, and against itself.

- the pool's knobs (``RCA_SERVE_REPLICAS`` / ``RCA_SERVE_STEAL`` /
  ``RCA_SERVE_REPLICA_MIX``) and replica-mix parsing against the
  reference's, device-group carving;
- routing on the host (fake clock, stub dispatchers), as
  ``tests/test_serve_pool.py`` holds the reference's: home stickiness,
  resident stickiness, least-occupied placement for cold buckets, and the
  same placements as the reference's pool for one request stream;
- failover: a killed replica's staged and in-flight work answered with
  ZERO double completions, an open breaker handing work to survivors,
  stealing off riding the degradation ladder, every replica down
  degrading instead of hanging, shutdown resolving everything, deadlines
  shed at every stage; a threaded stress run with a kill;
- the real engine on the CPU: a pool of two dense replicas bitwise equal
  to a solo analysis, the pooled selftest, its kill-replica mode and a
  dense + sharded mix (logical shards), each answer bitwise its own
  kind's solo engine; replica engines built on carved device groups.
"""

from __future__ import annotations

import sys
import threading

import numpy as np
import pytest

from rca_tpu.config import ServeConfig as RefServeConfig
from rca_tpu.config import parse_replica_mix as ref_parse_replica_mix
from rca_tpu_torch import GraphEngine
from rca_tpu_torch.cluster.generator import synthetic_cascade_arrays
from rca_tpu_torch.config import ServeConfig, parse_replica_mix
from rca_tpu_torch.serve import ServeClient, ServePool, ServeRequest
from rca_tpu_torch.serve import serve_selftest


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _req(tenant="t", n=8, k=3, seed=0, cls=ServeRequest, **kw):
    rng = np.random.default_rng(seed)
    feats = rng.uniform(0, 1, (n, 4)).astype(np.float32)
    src = np.arange(n - 1, dtype=np.int32)
    dst = np.arange(1, n, dtype=np.int32)
    return cls(
        tenant=tenant, features=feats, dep_src=src, dep_dst=dst, k=k, **kw
    )


class StubHandle:
    def __init__(self, requests, dispatched_at):
        self.requests = requests
        self.dispatched_at = dispatched_at


class StubResult:
    def __init__(self, tag):
        self.ranked = [{"component": f"svc-{tag}", "score": 1.0}]
        self.engine = "stub"
        self.score = np.ones(1, np.float32)


class StubDispatcher:
    """Device-free dispatcher with scriptable failures and a scriptable
    prepared-graph cache (resident stickiness)."""

    engine = None
    engine_tag = "stub"

    def __init__(self):
        self.dispatched = []   # batch widths in dispatch order
        self.fail_next = []    # ops to fail, consumed front-first
        self.graphs = set()    # keys has_graph answers True for

    def has_graph(self, key):
        return key in self.graphs

    def dispatch(self, batch, now=None):
        if self.fail_next and self.fail_next[0] == "dispatch":
            self.fail_next.pop(0)
            raise RuntimeError("injected dispatch failure")
        self.dispatched.append(len(batch))
        self.graphs.add(batch[0].graph_key)
        return StubHandle(list(batch), now if now is not None else 0.0)

    def fetch(self, handle):
        if self.fail_next and self.fail_next[0] == "fetch":
            self.fail_next.pop(0)
            raise RuntimeError("injected fetch failure")
        return [StubResult(i) for i, _ in enumerate(handle.requests)]


def _policy_pool(n=2, clock=None, pool_cls=ServePool, config_cls=ServeConfig,
                 **cfg_kw):
    """Single-threaded pool over stub dispatchers (never start()ed)."""
    clock = clock or FakeClock()
    cfg_kw.setdefault("max_wait_us", 0)
    stubs = [StubDispatcher() for _ in range(n)]
    pool = pool_cls(
        dispatchers=stubs,
        config=config_cls(replicas=n, **cfg_kw),
        clock=clock,
    )
    return pool, stubs, clock


def _drain(pool, iters=10):
    for _ in range(iters):
        pool.run_once()


@pytest.fixture
def engine(monkeypatch):
    monkeypatch.setenv("RCA_KERNEL_CACHE", "off")
    monkeypatch.delenv("RCA_KERNEL", raising=False)
    return GraphEngine(device="cpu")


# -- config --------------------------------------------------------------------

def test_pool_config_env_round_trip(monkeypatch):
    monkeypatch.setenv("RCA_SERVE_REPLICAS", "4")
    monkeypatch.setenv("RCA_SERVE_STEAL", "0")
    monkeypatch.setenv("RCA_SERVE_REPLICA_MIX", "dense:2,sharded@4:2")
    cfg = ServeConfig.from_env()
    assert cfg.replicas == 4
    assert cfg.steal is False
    assert cfg.replica_specs() == (
        ("dense", None), ("dense", None),
        ("sharded", 4), ("sharded", 4),
    )
    assert cfg.replica_specs() == RefServeConfig.from_env().replica_specs()


def test_pool_config_defaults(monkeypatch):
    for name in ("RCA_SERVE_REPLICAS", "RCA_SERVE_STEAL",
                 "RCA_SERVE_REPLICA_MIX"):
        monkeypatch.delenv(name, raising=False)
    cfg = ServeConfig.from_env()
    assert cfg.replicas == 1 and cfg.steal is True
    assert cfg.replica_specs() == (("dense", None),)


@pytest.mark.parametrize("name,bad", [
    ("RCA_SERVE_REPLICAS", "0"),
    ("RCA_SERVE_REPLICAS", "65"),
    ("RCA_SERVE_REPLICAS", "abc"),
    ("RCA_SERVE_STEAL", "maybe"),
    ("RCA_SERVE_REPLICA_MIX", "gpu:2"),
    ("RCA_SERVE_REPLICA_MIX", "dense:0"),
    ("RCA_SERVE_REPLICA_MIX", "sharded@0:1"),
])
def test_pool_config_rejects_bad_env(monkeypatch, name, bad):
    monkeypatch.setenv(name, bad)
    with pytest.raises(ValueError):
        ServeConfig.from_env()
    with pytest.raises(ValueError):
        RefServeConfig.from_env()


@pytest.mark.parametrize("spec,default", [
    ("", 3), ("sharded@2", 1), ("dense:2, sharded@4:1", 1),
    ("DENSE:1,,sharded", 1), ("dense:64", 1),
])
def test_parse_replica_mix_matches_reference(spec, default):
    assert parse_replica_mix(spec, default) == ref_parse_replica_mix(
        spec, default)


def test_parse_replica_mix_rejects_like_reference():
    for spec in ("quantum:2", "dense:65", "dense:40,sharded:40",
                 "sharded@5000"):
        with pytest.raises(ValueError):
            parse_replica_mix(spec)
        with pytest.raises(ValueError):
            ref_parse_replica_mix(spec)
    with pytest.raises(ValueError, match="kind"):
        parse_replica_mix("quantum:2")


def test_carve_device_groups_wraps_when_oversubscribed():
    from rca_tpu.parallel.mesh import carve_device_groups as ref_carve
    from rca_tpu_torch.parallel.mesh import carve_device_groups

    devices = ["d0", "d1", "d2"]
    groups = carve_device_groups([1, 2, 2], devices)
    assert groups == [["d0"], ["d1", "d2"], ["d0", "d1"]]
    assert groups == ref_carve([1, 2, 2], devices)
    assert carve_device_groups([4], ["cpu"]) == [["cpu"] * 4]
    with pytest.raises(ValueError):
        carve_device_groups([1], [])


def test_build_replica_engines_on_carved_groups():
    import torch

    from rca_tpu_torch.engine.sharded_runner import ShardedGraphEngine
    from rca_tpu_torch.serve import build_replica_engines

    built = build_replica_engines(
        parse_replica_mix("dense:2,sharded@4"), devices=["cpu"])
    assert [kind for kind, _, _ in built] == ["dense", "dense", "sharded"]
    for kind, eng, device in built[:2]:
        assert isinstance(eng, GraphEngine)
        assert eng.device == torch.device("cpu") == device
    _, sharded, device = built[2]
    assert isinstance(sharded, ShardedGraphEngine) and device is None
    assert (sharded.dp, sharded.sp) == (1, 4)
    assert sharded.mesh.flat == [torch.device("cpu")] * 4


def test_pool_without_a_card_raises(monkeypatch):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card rule does not "
                    "apply")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServePool(config=ServeConfig(replicas=2))


def test_pool_rejects_a_recorder(tmp_path):
    """The pool used to refuse a recorder; it now takes one and writes
    its replica mix into the header."""
    from rca_tpu_torch.replay import Recorder, load_recording

    rec = Recorder(str(tmp_path / "rec"), mode="serve")
    ServePool(dispatchers=[StubDispatcher(), StubDispatcher()],
              recorder=rec)
    rec.close()
    info = load_recording(str(tmp_path / "rec")).session_info
    assert info["replicas"] == 2 and info["mix"] == ["stub", "stub"]


# -- routing policy (fake clock, stub devices) ---------------------------------

def test_routing_cold_bucket_goes_least_occupied():
    pool, stubs, _ = _policy_pool(n=2)
    for i in range(4):
        pool.submit(_req("a", n=8, seed=i))
    pool.route_once()
    assert pool.replicas[0].occupancy() == 4
    pool.submit(_req("b", n=16, seed=9))
    pool.route_once()
    assert pool.replicas[1].occupancy() == 1


def test_routing_sticky_home_keeps_bucket_on_replica():
    pool, stubs, _ = _policy_pool(n=2)
    pool.submit(_req("a", n=8, seed=0))
    pool.route_once()
    _drain(pool)
    for i in range(3):
        pool.submit(_req("a", n=8, seed=10 + i))
    pool.route_once()
    assert pool.replicas[0].occupancy() == 3
    assert pool.replicas[1].occupancy() == 0


def test_routing_resident_stickiness_beats_occupancy():
    pool, stubs, _ = _policy_pool(n=2)
    probe = _req("a", n=8, seed=0)
    stubs[1].graphs.add(probe.graph_key)
    pool.submit(probe)
    pool.route_once()
    assert pool.replicas[1].occupancy() == 1


def test_routing_places_as_the_reference_pool():
    """One stream of requests over four graphs, three replicas: every
    request lands on the same replica in both pools, and both dispatch
    the same batches."""
    from rca_tpu.serve import ServePool as RefPool
    from rca_tpu.serve import ServeRequest as RefRequest

    port, port_stubs, port_clock = _policy_pool(n=3, max_batch=3)
    ref, ref_stubs, ref_clock = _policy_pool(
        n=3, max_batch=3, pool_cls=RefPool, config_cls=RefServeConfig)
    rng = np.random.default_rng(2)
    for step in range(40):
        n = int(rng.choice([8, 9, 10, 11]))
        for pool, cls in ((port, ServeRequest), (ref, RefRequest)):
            pool.submit(_req(f"t{step % 3}", n=n, seed=step, cls=cls))
        if step % 3 == 2:
            for pool, clock in ((port, port_clock), (ref, ref_clock)):
                pool.run_once()
                clock.advance(0.001)
    _drain(port)
    _drain(ref)
    assert ([s.dispatched for s in port_stubs]
            == [s.dispatched for s in ref_stubs])
    assert port._home == ref._home


# -- failover ------------------------------------------------------------------

def test_replica_kill_recovers_staged_and_inflight():
    pool, stubs, _ = _policy_pool(n=2, max_batch=4)
    reqs = [_req("a", n=8, seed=i) for i in range(10)]
    reqs += [_req("b", n=16, seed=i) for i in range(4)]
    for r in reqs:
        pool.submit(r)
    pool.route_once()
    pool.replicas[0].run_once()
    assert pool.replicas[0]._inflight is not None
    assert pool.replicas[0].batcher.staged() >= 1
    pool.replicas[0].kill()
    _drain(pool)
    resps = [r.result(timeout=0) for r in reqs]
    assert all(resp.status == "ok" for resp in resps)
    assert pool.sink.double_completions == 0
    m = pool.metrics.summary()
    assert m["replicas"]["0"]["state"] == "dead"
    assert m["steals_total"] >= 1
    assert stubs[1].dispatched


def test_replica_kill_before_dispatch_steals_everything():
    pool, stubs, _ = _policy_pool(n=2)
    reqs = [_req("a", n=8, seed=i) for i in range(5)]
    for r in reqs:
        pool.submit(r)
    pool.route_once()
    victim = next(r for r in pool.replicas if r.occupancy())
    victim.kill()
    _drain(pool)
    assert all(r.result(timeout=0).status == "ok" for r in reqs)
    assert pool.sink.double_completions == 0
    assert pool.metrics.summary()["steals_total"] == 5


def test_breaker_open_hands_staged_work_to_survivors():
    pool, stubs, clock = _policy_pool(n=2)
    stubs[0].fail_next = ["dispatch", "dispatch", "dispatch"]
    burned = []
    for i in range(3):
        r = _req("a", n=8, seed=i)
        burned.append(r)
        pool.submit(r)
        _drain(pool, iters=2)
    assert pool.replicas[0].breaker.state == "open"
    assert {r.result(timeout=0).status for r in burned} == {"error"}
    later = [_req("a", n=8, seed=10 + i) for i in range(4)]
    for r in later:
        pool.submit(r)
    _drain(pool)
    assert all(r.result(timeout=0).status == "ok" for r in later)
    assert stubs[1].dispatched


def test_no_steal_rides_degradation_ladder():
    pool, stubs, _ = _policy_pool(n=2, steal=False)
    first = _req("a", n=8, seed=0)
    pool.submit(first)
    _drain(pool)
    assert first.result(timeout=0).status == "ok"
    home = pool.replicas[pool._home[first.graph_key]]
    stale = [_req("a", n=8, seed=10 + i) for i in range(3)]
    for r in stale:
        pool.submit(r)
    pool.route_once()
    assert home.occupancy() == 3
    home.kill()
    _drain(pool)
    assert {r.result(timeout=0).status for r in stale} == {"degraded"}
    assert pool.metrics.summary()["steals_total"] == 0
    assert pool.sink.double_completions == 0


def test_all_replicas_down_degrades_instead_of_hanging():
    pool, stubs, _ = _policy_pool(n=2)
    for r in pool.replicas:
        r.kill()
    req = _req("a", n=8, seed=0)
    pool.submit(req)
    _drain(pool)
    assert req.result(timeout=0).status == "error"


def test_pool_shutdown_resolves_everything():
    pool, stubs, _ = _policy_pool(n=2, max_wait_us=10_000_000,
                                  max_batch=64)
    reqs = [_req("a", seed=i) for i in range(4)]
    for r in reqs:
        pool.submit(r)
    pool.start()
    pool.stop()
    assert all(r.done() for r in reqs)


def test_pool_expired_requests_shed_at_every_stage():
    clock = FakeClock()
    pool, stubs, clock = _policy_pool(n=2, clock=clock)
    dead = _req("a", deadline_s=5.0)
    live = _req("a", seed=9, deadline_s=100.0)
    pool.submit(dead)
    pool.submit(live)
    clock.advance(10.0)
    _drain(pool)
    assert dead.result(timeout=0).status == "shed"
    assert live.result(timeout=0).status == "ok"
    assert sum(sum(s.dispatched) for s in stubs) == 1


def test_pool_stress_with_a_kill_completes_exactly_once():
    """Eight submitter threads against a STARTED pool of four replicas
    (real worker threads), replica 0 killed mid-run, the interpreter
    switching threads every microsecond: every request resolves and none
    is completed twice."""
    stubs = [StubDispatcher() for _ in range(4)]
    pool = ServePool(dispatchers=stubs,
                     config=ServeConfig(replicas=4, max_wait_us=0))
    reqs = [[] for _ in range(8)]

    def submitter(w: int) -> None:
        for i in range(24):
            r = _req(f"t{w % 3}", n=8 + 8 * (w % 2), seed=w * 100 + i)
            reqs[w].append(r)
            pool.submit(r)
            if w == 0 and i == 12:
                pool.replicas[0].kill()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with pool:
            threads = [threading.Thread(target=submitter, args=(w,))
                       for w in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30)
            assert not any(t.is_alive() for t in threads)
            resps = [r.result(30.0) for lane in reqs for r in lane]
    finally:
        sys.setswitchinterval(interval)
    assert len(resps) == 8 * 24
    assert all(r.status in ("ok", "degraded", "error") for r in resps)
    assert pool.sink.double_completions == 0
    assert not pool.replicas[0].alive()
    assert sum(sum(s.dispatched) for s in stubs) >= sum(
        r.ok for r in resps)


def test_pool_stress_under_rsan():
    """The reference's ``test_pool_stress_under_rsan`` over the port's
    pool: eight submitters through a STARTED pool of four stub replicas,
    replica 0 killed mid-run, every lock sanitized — every request
    resolved once, no observed race, no lock-order contradiction against
    the port's static model, and the pool's locks taken from several
    threads."""
    from rca_tpu_torch.analysis.concurrency import model_for, rsan
    from rca_tpu_torch.analysis.concurrency.crosscheck import (
        order_contradictions,
    )
    from rca_tpu_torch.analysis.core import repo_root

    was = rsan.enabled()
    rsan.enable()
    rsan.RSAN.reset()
    try:
        stubs = [StubDispatcher() for _ in range(4)]
        pool = ServePool(dispatchers=stubs,
                         config=ServeConfig(replicas=4, max_wait_us=0))
        reqs = [[] for _ in range(8)]

        def submitter(w: int) -> None:
            for i in range(24):
                r = _req(f"t{w % 3}", n=8 + 8 * (w % 2), seed=w * 100 + i)
                reqs[w].append(r)
                pool.submit(r)
                if w == 0 and i == 12:
                    pool.replicas[0].kill()

        with pool:
            threads = [threading.Thread(target=submitter, args=(w,))
                       for w in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30)
            resps = [r.result(60.0) for lane in reqs for r in lane]
        assert all(r.status in ("ok", "degraded", "error") for r in resps)
        assert all(r.done() for lane in reqs for r in lane)
        assert pool.sink.double_completions == 0

        assert rsan.RSAN.races_observed() == []
        lt = rsan.RSAN.lock_threads()
        for lock in ("ServePool._route_lock", "ReplicaWorker._lock",
                     "CompletionSink._lock", "RequestQueue._cond"):
            assert len(lt.get(lock, ())) >= 2, lock
        static_edges = model_for(repo_root()).static_order_edges()
        assert order_contradictions(
            static_edges, rsan.RSAN.order_edges()) == []
    finally:
        rsan.RSAN.reset()
        if not was:
            rsan.disable()


# -- the real engine on the CPU ------------------------------------------------

def test_pool_parity_vs_solo(engine):
    case = synthetic_cascade_arrays(60, n_roots=1, seed=3)
    rng = np.random.default_rng(0)
    pool = ServePool(
        engines=[engine, GraphEngine(device="cpu")],
        config=ServeConfig(replicas=2),
    )
    feats = [
        np.clip(case.features + rng.uniform(
            0, 0.05, case.features.shape
        ).astype(np.float32), 0, 1)
        for _ in range(12)
    ]
    with pool:
        client = ServeClient(pool)
        assert client.as_engine().device.type == "cpu"
        reqs = [
            client.submit(
                f, case.dep_src, case.dep_dst, names=case.names,
                tenant=f"t{i % 3}", k=3,
            )
            for i, f in enumerate(feats)
        ]
        resps = [r.result(60.0) for r in reqs]
        scope = pool.kernelscope_summary()
    assert scope["enabled"] and scope["recompiles"] == 0
    assert all(r.status == "ok" for r in resps)
    for f, resp in zip(feats, resps):
        solo = engine.analyze_arrays(
            f, case.dep_src, case.dep_dst, case.names, k=3,
        )
        assert resp.ranked == solo.ranked
        assert np.array_equal(resp.result.score, solo.score)
    assert pool.sink.double_completions == 0


def test_pool_selftest_contract(engine):
    out = serve_selftest(n_requests=24, seed=0, engine=engine, replicas=2,
                         timeout_s=60.0)
    assert out["ok"], out
    assert out["all_resolved"] and out["parity_ok"]
    assert out["replicas"] == 2
    assert out["double_completions"] == 0
    assert set(out["metrics"]["replicas"]) == {"0", "1"}
    assert set(out["breaker_state"]) == {"0", "1"}


def test_pool_selftest_kill_replica(engine):
    out = serve_selftest(
        n_requests=24, seed=1, engine=engine, replicas=2,
        kill_replica=True, timeout_s=60.0,
    )
    assert out["ok"], out
    assert out["all_resolved"] and out["parity_ok"]
    assert out["by_status"].get("error", 0) == 0
    assert out["double_completions"] == 0
    assert "dead" in out["breaker_state"].values()


@pytest.mark.parametrize("mix", ["dense:1,sharded@2:1", "dense,sharded@4"])
def test_pool_mixed_dense_sharded_parity(engine, mix):
    """A dense + sharded mix (logical shards of the CPU) serves with per
    kind bit parity: sharded answers are checked against the replica's
    own sharded engine."""
    out = serve_selftest(n_requests=16, seed=0, engine=engine,
                         replica_mix=mix, timeout_s=60.0)
    assert out["ok"], out
    assert out["parity_ok"]
    assert out["replica_mix"] == ["dense", "sharded"]
    assert out["double_completions"] == 0


def test_sharded_dispatch_lanes_are_bitwise_solo():
    """The sharded dispatcher (host sanitize, ``stage_batch_ranked``)
    against the sharded engine's own solo analysis, lane by lane, on a
    dp = 2, sp = 2 mesh of logical shards."""
    import torch

    from rca_tpu_torch.engine.sharded_runner import ShardedGraphEngine
    from rca_tpu_torch.parallel.mesh import make_mesh
    from rca_tpu_torch.serve import BatchDispatcher

    mesh = make_mesh([("dp", 2), ("sp", 2)], [torch.device("cpu")] * 4)
    sharded = ShardedGraphEngine(mesh=mesh)
    case = synthetic_cascade_arrays(150, n_roots=2, seed=6)
    rng = np.random.default_rng(6)
    feats = [np.clip(case.features + rng.uniform(
        0, 0.05, case.features.shape), 0, 1).astype(np.float32)
        for _ in range(3)]
    feats[1][4] = np.nan
    disp = BatchDispatcher(sharded)
    assert disp.engine_tag == "serve+sharded(dp=2,sp=2)"
    assert disp._b_pad(3) == 4
    reqs = [ServeRequest("t", f, case.dep_src, case.dep_dst,
                         names=case.names, k=5) for f in feats]
    results = disp.fetch(disp.dispatch(reqs))
    for f, res in zip(feats, results):
        solo = sharded.analyze_arrays(f, case.dep_src, case.dep_dst,
                                      case.names, k=5)
        assert res.ranked == solo.ranked
        assert np.array_equal(res.score, solo.score)
        assert res.sanitized_rows == 1
