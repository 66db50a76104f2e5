"""The port's placement and scale-rule tables (``rca_tpu_torch.serve.
autoscale``), the hello-evidence parsers, shape-aware placement, and the
ingest ring (``FederationPlane``'s cluster table and
``rca_tpu_torch.serve.ingest``) against the JAX package's.

- ``SCALE_RULES`` / ``PLACEMENT_RULES`` equal the reference's tables
  field for field; every malformed table the reference's tests build is
  refused by both packages with the same message; ``rule_for`` and
  ``shape_tier_ms`` give the reference's answers on its own cases and on
  a sweep of sizes;
- placement: a plane whose fake workers hello'd registry and headroom
  summaries routes each graph bucket to the worker the reference's rules
  prefer;
- the ingest ring: the same registrations, deaths and rejoins through the
  port's plane and the reference's give the same owners, epochs and
  assign frames (single owner, resume seq, HRW reclaim), and the same
  stat sequence through both cluster tables gives the same counters (the
  exactly-once arbiter); the port's ``IngestRunner`` resumes the dead
  owner's seq and reports the reference runner's frames.
"""

import time
from types import SimpleNamespace

import numpy as np
import pytest

from rca_tpu.serve import autoscale as ref_auto
from rca_tpu.serve import federation as ref_fed
from rca_tpu_torch.serve import autoscale as auto
from rca_tpu_torch.serve import federation as fed


def _rule(mod, **kw):
    base = dict(name="r", signal="queue_depth", op=">", threshold=1.0,
                for_s=1.0, action="up", step=1)
    base.update(kw)
    return mod.ScaleRule(**base)


def test_default_tables_equal_the_reference():
    assert auto.SCALE_RULES.rules == tuple(
        auto.ScaleRule(**vars(r)) for r in ref_auto.SCALE_RULES.rules)
    assert [vars(r) for r in auto.SCALE_RULES.rules] == [
        vars(r) for r in ref_auto.SCALE_RULES.rules]
    assert [vars(r) for r in auto.PLACEMENT_RULES.rules] == [
        vars(r) for r in ref_auto.PLACEMENT_RULES.rules]
    for name in ("SCALE_SIGNALS", "SCALE_OPS", "SCALE_ACTIONS",
                 "PLACEMENT_EVIDENCE", "SCALING_FAULT_CLASSES"):
        assert getattr(auto, name) == getattr(ref_auto, name)


_BAD_SCALE = [
    lambda m: (),
    lambda m: (_rule(m), _rule(m, action="down", op="<")),
    lambda m: (_rule(m, signal="nope"),
               _rule(m, name="d", action="down", op="<")),
    lambda m: (_rule(m, op=">="), _rule(m, name="d", action="down", op="<")),
    lambda m: (_rule(m, action="sideways"),
               _rule(m, name="d", action="down", op="<")),
    lambda m: (_rule(m, threshold=-1.0),
               _rule(m, name="d", action="down", op="<")),
    lambda m: (_rule(m, for_s=-0.1),
               _rule(m, name="d", action="down", op="<")),
    lambda m: (_rule(m, step=0), _rule(m, name="d", action="down", op="<")),
    lambda m: (_rule(m),),
    lambda m: (_rule(m, action="down", op="<"),),
    lambda m: (_rule(m, name="up", signal="occupancy", threshold=0.5),
               _rule(m, name="down", signal="occupancy", op="<",
                     threshold=0.5, action="down")),
]


@pytest.mark.parametrize("case", range(len(_BAD_SCALE)))
def test_scale_ruleset_refuses_what_the_reference_refuses(case):
    build = _BAD_SCALE[case]
    with pytest.raises(ValueError) as mine:
        auto.ScaleRuleSet(rules=build(auto))
    with pytest.raises(ValueError) as theirs:
        ref_auto.ScaleRuleSet(rules=build(ref_auto))
    assert str(mine.value) == str(theirs.value)


def test_scale_ruleset_takes_a_proper_hysteresis_band():
    for mod in (auto, ref_auto):
        mod.ScaleRuleSet(rules=(
            _rule(mod, name="up", signal="occupancy", threshold=0.8),
            _rule(mod, name="down", signal="occupancy", op="<",
                  threshold=0.2, action="down"),
        ))


_BAD_PLACEMENT = [
    lambda m: (),
    lambda m: (m.PlacementRule("a", 10), m.PlacementRule("a", 0)),
    lambda m: (m.PlacementRule("a", 10, ("vibes",)), m.PlacementRule("b", 0)),
    lambda m: (m.PlacementRule("a", 10), m.PlacementRule("b", 10)),
    lambda m: (m.PlacementRule("a", 10),),
    lambda m: (m.PlacementRule("", 0),),
    lambda m: (m.PlacementRule("a", -1),),
]


@pytest.mark.parametrize("case", range(len(_BAD_PLACEMENT)))
def test_placement_ruleset_refuses_what_the_reference_refuses(case):
    build = _BAD_PLACEMENT[case]
    with pytest.raises(ValueError) as mine:
        auto.PlacementRuleSet(rules=build(auto))
    with pytest.raises(ValueError) as theirs:
        ref_auto.PlacementRuleSet(rules=build(ref_auto))
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("n", [0, 3, 10, 47, 48, 99, 100, 191, 192, 500,
                               2047, 49999])
def test_rule_for_equals_the_reference(n):
    rs = {mod: mod.PlacementRuleSet(rules=(
        mod.PlacementRule("big", 100, ("timings", "headroom")),
        mod.PlacementRule("mid", 10, ("timings",)),
        mod.PlacementRule("small", 0),
    )) for mod in (auto, ref_auto)}
    assert rs[auto].rule_for(n).name == rs[ref_auto].rule_for(n).name
    assert vars(auto.PLACEMENT_RULES.rule_for(n)) == vars(
        ref_auto.PLACEMENT_RULES.rule_for(n))


@pytest.mark.parametrize("shapes", [{64: 1.5, 256: 9.0}, {}, {2048: 0.3},
                                    {128: 2.0, 53248: 11.5, 4096: 0.9}])
def test_shape_tier_ms_equals_the_reference(shapes):
    for n in (1, 48, 64, 65, 100, 256, 2047, 4096, 49999, 60000):
        assert auto.shape_tier_ms(shapes, n) == ref_auto.shape_tier_ms(
            shapes, n)
    if shapes == {64: 1.5, 256: 9.0}:
        assert auto.shape_tier_ms(shapes, 48) == 1.5
        assert auto.shape_tier_ms(shapes, 100) == 9.0
        assert auto.shape_tier_ms(shapes, 4096) == 9.0


@pytest.mark.parametrize("registry,headroom", [
    ({"64": 1.5, "256": "9.0", "bad": 2.0, "-3": 1.0, "0": 1.0,
      "32": -1.0}, {"bytes_in_use": 1024}),
    (None, {"bytes_in_use": "1024"}),
    ("garbage", {"bytes_in_use": "lots"}),
    ({"2048": 0.25}, None),
    ({}, {}),
])
def test_hello_evidence_parsers_equal_the_reference(registry, headroom):
    assert fed._parse_shape_summary(registry) == \
        ref_fed._parse_shape_summary(registry)
    assert fed._parse_headroom(headroom) == ref_fed._parse_headroom(headroom)


# ---------------------------------------------------------------------------
# Shape-aware placement through the real router
# ---------------------------------------------------------------------------


class _FakeConn:
    def __init__(self):
        self.sent = []
        self.closed = False

    def send(self, msg):
        self.sent.append(msg)
        return True

    def close(self):
        self.closed = True


def _handle(mod, plane, wid, role="serve", shape_ms=None, mem=None):
    w = mod._WorkerHandle(wid)
    w.role = role
    w.live = True
    w.conn = _FakeConn()
    w.shape_ms = dict(shape_ms or {})
    w.mem_bytes = mem
    plane.workers[wid] = w
    (plane.ingest_ring if role == "ingest" else plane.ring).add(wid)
    return w


def _req(mod, n, seed):
    from rca_tpu.serve.request import ServeRequest as RefRequest
    from rca_tpu_torch.serve.request import ServeRequest

    cls = RefRequest if mod is ref_fed else ServeRequest
    rng = np.random.default_rng(seed)
    return cls(tenant="t", features=rng.random((n, 14), dtype=np.float32),
               dep_src=np.arange(n - 1, dtype=np.int32),
               dep_dst=np.arange(1, n, dtype=np.int32))


@pytest.mark.parametrize("n", [12, 60, 300, 2047])
def test_placement_picks_the_references_worker(n):
    """Three workers with different advertised timings and headroom: the
    router's pick for each graph size is the reference router's."""
    picks = {}
    for mod in (fed, ref_fed):
        plane = mod.FederationPlane(workers=0, spawn_workers=False)
        try:
            _handle(mod, plane, 0, shape_ms={64: 2.0, 4096: 5.0}, mem=900)
            _handle(mod, plane, 1, shape_ms={64: 1.0, 4096: 5.0}, mem=100)
            _handle(mod, plane, 2)
            with plane._lock:
                picks[mod] = [plane._pick_worker(_req(mod, n, s)).worker_id
                              for s in range(6)]
            summary = plane.metrics.summary()
        finally:
            plane._server_sock.close()
        assert sum(summary["placement"][k]
                   for k in ("preferred", "rendezvous")) == 6
    assert picks[fed] == picks[ref_fed]


# ---------------------------------------------------------------------------
# The ingest ring: single owner, resume seq, reclaim, exactly-once stats
# ---------------------------------------------------------------------------


def _ingest_scenario(mod):
    plane = mod.FederationPlane(workers=0, spawn_workers=False)
    try:
        w1, w2 = _handle(mod, plane, 1, "ingest"), _handle(mod, plane, 2,
                                                             "ingest")
        w3 = _handle(mod, plane, 3, "ingest")
        plane.register_clusters({f"k{i}": {"digest": f"d{i}",
                                           "services": 6}
                                 for i in range(9)})
        out = {"first": {c: (e["owner"], e["epoch"])
                         for c, e in plane.clusters.items()}}
        mine = sorted(c for c, e in plane.clusters.items()
                      if e["owner"] == 1)
        for cid in mine:
            plane.clusters[cid]["last_seq"] = 41
        plane.ingest_ring.remove(1)
        w1.live = False
        dead_frames = len(w1.conn.sent)
        plane._ingest_rebalance()
        out["after_death"] = {c: (e["owner"], e["epoch"])
                              for c, e in plane.clusters.items()}
        out["corpse_frames"] = len(w1.conn.sent) - dead_frames
        w1.live = True
        plane.ingest_ring.add(1)
        plane._ingest_rebalance()
        out["after_rejoin"] = {c: (e["owner"], e["epoch"], e["moves"])
                               for c, e in plane.clusters.items()}
        out["reclaimed"] = sorted(c for c, e in plane.clusters.items()
                                  if e["owner"] == 1) == mine
        out["frames"] = {wid: w.conn.sent for wid, w in
                         ((1, w1), (2, w2), (3, w3))}
        out["mine"] = mine
        out["events"] = [(e["event"], e["worker_id"], e.get("cluster"),
                          e.get("epoch")) for e in plane.events]
        return out
    finally:
        plane._server_sock.close()


def test_ingest_rebalance_equals_the_reference():
    got, want = _ingest_scenario(fed), _ingest_scenario(ref_fed)
    assert got == want
    assert got["mine"], "rendezvous should give worker 1 some clusters"
    assert got["corpse_frames"] == 0
    assert got["reclaimed"]
    assert all(e == 1 for _, e in got["first"].values())
    resumed = [m for wid in (2, 3) for m in got["frames"][wid]
               if m["t"] == "ingest_assign" and m["cluster"] in got["mine"]
               and m["epoch"] == 2]
    assert resumed and all(m["resume_seq"] == 41 for m in resumed)


_STATS = [(1, 3, 11), (1, 3, 11), (1, 2, 12), (2, 3, 12), (1, 3, 12),
          (1, 3, 10), (1, 4, 13), (1, 3, 14), (3, 3, 15)]


def _stat_scenario(mod):
    plane = mod.FederationPlane(workers=0, spawn_workers=False)
    try:
        handles = {wid: mod._WorkerHandle(wid) for wid in (1, 2, 3)}
        plane.clusters["c"] = {
            "digest": "d", "spec": {"x": 1}, "owner": 1, "epoch": 3,
            "last_seq": 10, "ticks": 0, "double_applied": 0, "moves": 0,
            "sweep_ms": None, "coldiff_bytes": None,
        }
        trail = []
        for wid, epoch, seq in _STATS:
            plane._on_ingest_stat(handles[wid], {
                "cluster": "c", "epoch": epoch, "tick_seq": seq,
                "sweep_ms": 1.5 + seq, "coldiff_bytes": 64 + seq,
            })
            trail.append((dict(plane.ingest_status()["c"]),
                          plane.ingest_stale))
        plane._on_ingest_stat(handles[1], {"cluster": "nope", "epoch": 3,
                                           "tick_seq": 99})
        return trail, plane.ingest_stale
    finally:
        plane._server_sock.close()


def test_ingest_stat_arbiter_equals_the_reference():
    got, want = _stat_scenario(fed), _stat_scenario(ref_fed)
    assert got == want
    final, stale = got[0][-1]
    assert final["ticks"] == 3 and final["last_seq"] == 14
    assert final["double_applied"] == 2 and "spec" not in final
    assert got[1] == 5


def test_ingest_runner_resumes_seq_like_the_reference():
    from rca_tpu.serve.ingest import IngestRunner as RefRunner
    from rca_tpu_torch.serve.ingest import IngestRunner, NullServePlane

    plane = NullServePlane()
    assert plane.start() is plane and plane.submit(object()) is False
    frames = {}
    for cls in (IngestRunner, RefRunner):
        agent = SimpleNamespace(worker_id=9, conn=_FakeConn())
        runner = cls(agent, tick_s=0.01)
        try:
            runner.handle({
                "t": "ingest_assign", "cluster": "k0", "epoch": 4,
                "resume_seq": 7,
                "spec": {"services": 4, "seed": 1, "namespace": "synthetic"},
            })
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline and len(agent.conn.sent) < 4:
                time.sleep(0.02)
            runner.handle({"t": "ingest_unassign", "cluster": "k0"})
        finally:
            runner.stop()
        frames[cls] = [m for m in agent.conn.sent
                       if m["t"] == "ingest_stat"][:4]
    mine, theirs = frames[IngestRunner], frames[RefRunner]
    assert len(mine) == 4 and len(theirs) == 4
    assert [m["tick_seq"] for m in mine] == [8, 9, 10, 11]
    strip = ("sweep_ms",)
    assert [{k: v for k, v in m.items() if k not in strip} for m in mine] \
        == [{k: v for k, v in m.items() if k not in strip} for m in theirs]
