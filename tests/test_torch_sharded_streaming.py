"""The port's sharded streaming session against the JAX package's, against
the port's dense session, and inside the live session.

The reference's ``ShardedStreamingSession`` runs on the test session's 8
virtual CPU devices, the port's on 8 logical CPU shards.  The contract:

- per tick (a ``set_all`` with NaN rows, deltas with NaN/Inf rows,
  bulk-staged deltas, quiet ticks) the rankings equal the port's dense
  session's and the reference's sharded session's (components exact,
  scores rounded to 5 places), and ``upload_rows`` / ``sanitized_rows``
  equal the reference's;
- ``fetch(dispatch())`` equals ``tick()`` and a manual depth-2 pipeline
  is the serial sequence shifted by one, bitwise;
- the shards' resident blocks are bitwise their ``torch``-row twin's;
- ``make_streaming_session`` and the live session pick the sharded
  session for a sharded engine, and the live session's ladder steps from
  ``full`` to ``single-device``: a ``GraphEngine`` on the first shard's
  device (on the card the next rung raises ``KernelPathFailed``).
"""

import json

import numpy as np
import pytest
import torch

import jax

from rca_tpu.cluster.generator import synthetic_cascade_arrays as ref_cascade
from rca_tpu.engine.sharded_runner import ShardedGraphEngine as RefSharded
from rca_tpu.parallel.streaming import (
    ShardedStreamingSession as RefShardedStreaming,
)
from rca_tpu_torch import GraphEngine
from rca_tpu_torch.cluster.fixtures import NS, five_service_world
from rca_tpu_torch.cluster.generator import synthetic_cascade_world
from rca_tpu_torch.cluster.mock_client import MockClusterClient
from rca_tpu_torch.engine import LiveStreamingSession, ShardedGraphEngine
from rca_tpu_torch.engine import live as live_mod
from rca_tpu_torch.engine.registry import reset_registry
from rca_tpu_torch.engine.streaming import (
    StreamingSession,
    make_streaming_session,
)
from rca_tpu_torch.parallel.mesh import make_mesh
from rca_tpu_torch.parallel.streaming import ShardedStreamingSession

C = 13
CPU = torch.device("cpu")


def _engine(sp=8, dp=1):
    return ShardedGraphEngine(
        mesh=make_mesh([("dp", dp), ("sp", sp)], [CPU] * (dp * sp)))


@pytest.fixture
def env(monkeypatch):
    for name in ("RCA_SHARD", "RCA_KERNEL", "RCA_SEGSCAN"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("RCA_KERNEL_CACHE", "off")
    reset_registry()
    yield monkeypatch
    reset_registry()


def _ranking(out):
    return [(r["component"], round(r["score"], 5)) for r in out["ranked"]]


def _script(case, n_ticks, seed):
    """Per tick: ``("rows", {i: row})``, ``("block", (idx, rows))`` or
    ``("quiet", None)``; NaN / Inf rows on some ticks."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n_ticks):
        if t % 5 == 4:
            out.append(("quiet", None))
            continue
        idx = rng.choice(case.n, 8, replace=False)
        rows = np.clip(case.features[idx] + rng.uniform(
            0, 0.5, (8, C)), 0, 1).astype(np.float32)
        if t % 3 == 1:
            rows[0, 4] = np.nan
            rows[1, 9] = np.inf
        if t % 5 == 2:
            out.append(("block", (idx, rows)))
        else:
            out.append(("rows", {int(i): r for i, r in zip(idx, rows)}))
    return out


def _stage(session, kind, payload):
    if kind == "rows":
        session.update_many(payload)
    elif kind == "block":
        session.update_rows(*payload)


@pytest.mark.parametrize("segscan", ["0", "1"])
def test_ticks_match_dense_and_reference(segscan, env):
    if len(jax.devices()) < 8:
        pytest.skip("the reference needs 8 devices")
    env.setenv("RCA_SEGSCAN", segscan)
    case = ref_cascade(2047, n_roots=3, seed=4)
    names = [f"s{i}" for i in range(case.n)]
    port = ShardedStreamingSession(names, case.dep_src, case.dep_dst, C,
                                   engine=_engine(), k=5)
    dense = StreamingSession(names, case.dep_src, case.dep_dst, C,
                             engine=GraphEngine(device="cpu"), k=5)
    ref = RefShardedStreaming(names, case.dep_src, case.dep_dst, C,
                              engine=RefSharded(spec="sp=8"), k=5)
    start = case.features.copy()
    start[[10, 500]] = np.nan
    for s in (port, dense, ref):
        s.set_all(start)
    outs = [(port.tick(), dense.tick(), ref.tick())]
    for kind, payload in _script(case, 12, seed=int(segscan)):
        for s in (port, dense, ref):
            _stage(s, kind, payload)
        outs.append((port.tick(), dense.tick(), ref.tick()))
    for t, (p, d, r) in enumerate(outs):
        assert _ranking(p) == _ranking(r) == _ranking(d), t
        assert p["upload_rows"] == r["upload_rows"] == d["upload_rows"], t
        assert p["sanitized_rows"] == r["sanitized_rows"], t
    assert outs[0][0]["sanitized_rows"] == 2
    assert outs[0][0]["upload_rows"] == port._n_pad


def test_dispatch_fetch_equals_tick_and_depth_two_is_shifted(env):
    case = ref_cascade(700, n_roots=2, seed=9)
    script = _script(case, 10, seed=5)

    def session():
        s = ShardedStreamingSession(case.names, case.dep_src, case.dep_dst,
                                    C, engine=_engine(sp=4), k=4)
        s.set_all(case.features)
        return s

    serial, fetched, piped = session(), session(), session()
    serial_seq, fetched_seq, piped_seq = [], [], []
    prev = None
    for kind, payload in script:
        for s in (serial, fetched, piped):
            _stage(s, kind, payload)
        serial_seq.append(serial.tick())
        fetched_seq.append(fetched.fetch(fetched.dispatch()))
        handle = piped.dispatch()
        if prev is not None:
            piped_seq.append(piped.fetch(prev))
        prev = handle
    piped_seq.append(piped.fetch(prev))

    def key(outs):
        return [(o["ranked"], o["upload_rows"], o["sanitized_rows"])
                for o in outs]

    assert key(serial_seq) == key(fetched_seq) == key(piped_seq)
    for a, b in zip(serial.blocks(), piped.blocks()):
        assert torch.equal(a, b)
    assert all(o["dispatch_ms"] >= 0 and o["fetch_ms"] >= 0
               for o in fetched_seq)


def test_blocks_are_bitwise_their_torch_row_twins(env):
    """The shards' buffers after a run of delta ticks (NaN rows zeroed by
    the host's sanitize) are bitwise the ``torch`` row's, and the
    rankings equal."""
    case = ref_cascade(500, n_roots=2, seed=2)
    sessions = {}
    for kernel in ("kernels", "torch"):
        env.setenv("RCA_KERNEL", kernel)
        s = ShardedStreamingSession(case.names, case.dep_src, case.dep_dst,
                                    C, engine=_engine(sp=4), k=5)
        assert s.kernel_path == kernel
        s.set_all(case.features)
        sessions[kernel] = (s, [s.tick()])
    for kind, payload in _script(case, 8, seed=1):
        for s, outs in sessions.values():
            _stage(s, kind, payload)
            outs.append(s.tick())
    (a, a_out), (b, b_out) = sessions["kernels"], sessions["torch"]
    assert [o["ranked"] for o in a_out] == [o["ranked"] for o in b_out]
    for x, y in zip(a.blocks(), b.blocks()):
        assert torch.equal(x, y)
        assert torch.isfinite(x).all()
    # the blocks hold the sanitized matrix, padded
    full = torch.cat(a.blocks())
    assert full.shape == (a._n_pad, C)


def test_make_streaming_session_picks_by_engine(env):
    case = ref_cascade(100, n_roots=1, seed=1)
    args = (case.names, case.dep_src, case.dep_dst, C)
    assert type(make_streaming_session(
        *args, engine=GraphEngine(device="cpu"))) is StreamingSession
    assert type(make_streaming_session(
        *args, engine=_engine(sp=2))) is ShardedStreamingSession


def test_live_session_serves_polls_from_the_sharded_session(env):
    world = five_service_world()
    live = LiveStreamingSession(MockClusterClient(world), NS, k=3,
                                engine=_engine())
    assert isinstance(live.session, ShardedStreamingSession)
    out = live.poll()
    assert out["quiet"] is True
    assert [r["component"] for r in out["ranked"]][:2] == [
        "database", "api-gateway"]
    world.touch("pod", NS, world.pods[NS][0]["metadata"]["name"])
    busy = live.poll()
    assert busy["quiet"] is False and not busy["degraded"]
    assert busy["health"]["kernel_path"] == "torch"
    assert busy["health"]["degradation_rung"] == "full"


def _failing_live(depth):
    world = synthetic_cascade_world(40, n_roots=1, seed=7, namespace="dg")
    return LiveStreamingSession(MockClusterClient(world), "dg", k=3,
                                engine=_engine(sp=4),
                                topology_check_every=100,
                                pipeline_depth=depth)


def _boom(self):
    raise RuntimeError("device dispatch failed")


@pytest.mark.parametrize("depth", [1, 2])
def test_ladder_steps_a_sharded_engine_to_single_device(depth, env):
    live = _failing_live(depth)
    first = [live.poll() for _ in range(depth)][-1]   # past the fill
    assert first["ranked"] and not first["degraded"]
    with env.context() as mp:
        mp.setattr(ShardedStreamingSession, "dispatch", _boom)
        degraded = live.poll()
    assert degraded["degraded"] is True
    assert degraded["health"]["degradation_rung"] == "single-device"
    assert type(live.engine) is GraphEngine
    assert live.engine.device == CPU
    assert type(live.session) is StreamingSession
    later = [live.poll() for _ in range(2 + depth)]
    assert later[-1]["ranked"]
    assert [r["component"] for r in later[-1]["ranked"]] == \
        [r["component"] for r in first["ranked"]]


def test_ladder_on_the_card_raises_after_single_device(env):
    env.setattr(live_mod, "_on_card", lambda engine: True)
    live = _failing_live(1)
    live.poll()
    with env.context() as mp:
        mp.setattr(ShardedStreamingSession, "dispatch", _boom)
        mp.setattr(StreamingSession, "dispatch", _boom)
        with pytest.raises(live_mod.KernelPathFailed):
            live.poll()
    assert live.degradation == 1


def test_set_all_reports_its_bad_rows_once(env):
    """The buffers hold sanitized rows: ``set_all``'s bad rows are
    reported by the next tick only (the reference's sharded session)."""
    case = ref_cascade(300, n_roots=1, seed=3)
    s = ShardedStreamingSession(case.names, case.dep_src, case.dep_dst, C,
                                engine=_engine(sp=2), k=3)
    start = case.features.copy()
    start[[0, 7, 299]] = np.inf
    s.set_all(start)
    first, second = s.tick(), s.tick()
    assert (first["sanitized_rows"], second["sanitized_rows"]) == (3, 0)
    assert (first["upload_rows"], second["upload_rows"]) == (s._n_pad, 0)
    assert json.dumps(first["ranked"]) == json.dumps(second["ranked"])
