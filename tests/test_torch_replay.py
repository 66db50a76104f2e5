"""The port's flight recorder (``rca_tpu_torch.replay``) against the JAX
package's.

- the log format: the same bytes as the reference's writer, round trip,
  chunk rotation, a truncated tail and a corrupt CRC stopping cleanly with
  their status, a foreign magic and a foreign schema version raising
  ``ReplayFormatError``, an empty directory; the digests and the ndarray
  codec equal the reference's on seeded numpy inputs (exact); each
  package reads the other's recordings, the committed corpus included;
- record → replay on the port (CPU), bitwise: the live tests' 60-tick,
  40-service op sequence at depths 1 and 2 on the dict and the columnar
  capture; seek, the cross-depth serial compare, mint and its refusal of
  partial evidence, the recording proxy's optional surfaces, the bisect
  (the exact tick in at most 6 probes), the serve path on the selftest's
  48 / 120 / 260-service graphs (one frame per request, a divergence
  naming its request), ``--explain`` digest parity and ``--trace-out``;
- the corpus live A/B: every committed tape drives the reference's live
  session over its ``ReplaySource`` and the port's over its own, on the
  recorded engine kind (the sharded tape on 8 logical CPU shards); per
  tick the rankings agree under the engine contract (components and
  order exact, scores at rtol 1e-5 / atol 1e-6) and the poll and health
  keys exactly;
- the CPU-minted port tape under ``tests/corpus_torch/`` replays bitwise
  and names the CPU in its header.
"""

import glob
import json
import os
import shutil

import numpy as np
import pytest

from rca_tpu.replay import format as ref_format
from rca_tpu.replay.replayer import _engine_for as ref_engine_for
from rca_tpu.replay.replayer import _replay_session as ref_replay_session
from rca_tpu.replay.replayer import load_recording as ref_load_recording
from rca_tpu.replay.source import ReplaySource as RefReplaySource
from rca_tpu_torch.cluster.generator import (
    synthetic_cascade_arrays,
    synthetic_cascade_world,
)
from rca_tpu_torch.cluster.mock_client import MockClusterClient
from rca_tpu_torch.cluster.world import waiting_status
from rca_tpu_torch.config import ServeConfig
from rca_tpu_torch.engine import (
    GraphEngine,
    LiveStreamingSession,
    ShardedGraphEngine,
)
from rca_tpu_torch.parallel.mesh import make_mesh
from rca_tpu_torch.replay import (
    Recorder,
    ReplayFormatError,
    ReplayMismatch,
    ReplaySource,
    bisect_divergence,
    digest_obj,
    load_recording,
    mint_recording,
    read_frames,
    replay,
    replay_serve,
    replay_stream,
)
from rca_tpu_torch.replay import format as port_format
from rca_tpu_torch.replay.replayer import _replay_session
from rca_tpu_torch.resilience.chaos import ChaosClusterClient, ChaosConfig
from rca_tpu_torch.serve import ServeClient, ServeLoop, ServePool
from rca_tpu_torch.serve.metrics import ServeMetrics
from rca_tpu_torch.serve.replica import CompletionSink
from rca_tpu_torch.serve.request import ServeRequest
from test_torch_live import (
    HEALTH_KEYS,
    POLL_KEYS,
    _mutate,
    _op_sequence,
    assert_ranked_close,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = sorted(glob.glob(os.path.join(REPO, "tests", "corpus", "*.rcz")))
PORT_TAPE = os.path.join(REPO, "tests", "corpus_torch",
                         "chaos-20svc-seed11.torch.rcz")


@pytest.fixture(autouse=True)
def _no_kernel_cache(monkeypatch):
    monkeypatch.setenv("RCA_KERNEL_CACHE", "off")
    monkeypatch.delenv("RCA_KERNEL", raising=False)


def _frames(n=30, seed=0):
    """Seeded frames of every kind, large and small (both sides of the
    zlib threshold), with NaN/Inf floats."""
    rng = np.random.default_rng(seed)
    out = [{"kind": "header", "schema": 1, "mode": "stream",
            "session": {"k": 5}}]
    for t in range(1, n + 1):
        out.append({"kind": "call", "tick": t, "method": "get_pods",
                    "key": json.dumps([["ns"], []]), "ok": True,
                    "result": [{"name": f"p{i}", "v": float(rng.random())}
                               for i in range(int(rng.integers(1, 60)))]})
        out.append({"kind": "tick", "tick": t,
                    "ranked": [{"component": "a", "score": float("nan")},
                               {"component": "b", "score": float("inf")}],
                    "features": port_format.encode_array(
                        rng.random((4, 3)).astype(np.float32))})
    out.append({"kind": "end", "ticks": n})
    return out


def _write(module, path, frames, **kw):
    w = module.RecordingWriter(path, **kw)
    for fr in frames:
        w.append(fr)
    w.close()
    return w


def _same(a, b):
    """Frame equality that treats NaN as equal to NaN."""
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


# -- format -------------------------------------------------------------------

def test_writer_bytes_equal_reference(tmp_path):
    frames = _frames()
    _write(port_format, str(tmp_path / "port.rcz"), frames, single_file=True)
    _write(ref_format, str(tmp_path / "ref.rcz"), frames, single_file=True)
    assert (tmp_path / "port.rcz").read_bytes() == \
        (tmp_path / "ref.rcz").read_bytes()
    assert port_format.MAGIC == ref_format.MAGIC == b"RCAREC\x01\n"


def test_round_trip_and_chunk_rotation(tmp_path):
    frames = _frames(200)
    w = _write(port_format, str(tmp_path / "rec"), frames, chunk_bytes=4096)
    chunks = port_format.chunk_files(str(tmp_path / "rec"))
    assert len(chunks) > 3
    got, status = read_frames(str(tmp_path / "rec"))
    assert status.clean and status.chunks == len(chunks)
    assert status.frames == w.frames_written == len(frames)
    assert _same(got, frames)
    ref_got, ref_status = ref_format.read_frames(str(tmp_path / "rec"))
    assert _same(ref_got, frames) and ref_status.to_dict() == status.to_dict()
    with pytest.raises(FileExistsError):
        port_format.RecordingWriter(str(tmp_path / "rec"))


@pytest.mark.parametrize("damage", ["truncated_header", "truncated_payload",
                                    "corrupt_crc"])
def test_damaged_tail_stops_cleanly(tmp_path, damage):
    frames = _frames(10)
    path = str(tmp_path / "one.rcz")
    _write(port_format, path, frames, single_file=True)
    data = bytearray(open(path, "rb").read())
    last = port_format._pack_frame(frames[-1])
    if damage == "truncated_header":
        data = data[:len(data) - len(last) + 5]
    elif damage == "truncated_payload":
        data = data[:-3]
    else:
        data[-2] ^= 0xFF
    open(path, "wb").write(bytes(data))
    got, status = read_frames(path)
    ref_got, ref_status = ref_format.read_frames(path)
    assert _same(got, frames[:-1]) and _same(ref_got, got)
    assert not status.clean
    assert status.truncated == (damage != "corrupt_crc")
    assert status.corrupt == (damage == "corrupt_crc")
    assert status.to_dict() == ref_status.to_dict()


def test_foreign_magic_version_and_empty_dir(tmp_path):
    foreign = tmp_path / "foreign.rcz"
    foreign.write_bytes(b"NOTAREC\n" + b"\0" * 20)
    with pytest.raises(ReplayFormatError, match="not a flight recording"):
        read_frames(str(foreign))
    future = tmp_path / "future.rcz"
    future.write_bytes(b"RCAREC\x02\n")
    with pytest.raises(ReplayFormatError, match="schema version 2"):
        read_frames(str(future))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        read_frames(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError):
        read_frames(str(tmp_path / "missing"))


def test_digests_and_codec_equal_reference():
    rng = np.random.default_rng(11)
    arrays = [rng.random((7, 13)).astype(np.float32),
              rng.integers(-5, 5, 17).astype(np.int32),
              rng.random((3, 2, 4)),
              np.array([np.nan, np.inf, -0.0], np.float32),
              np.zeros((0, 3), np.float32)]
    for a in arrays:
        assert port_format.digest_array(a) == ref_format.digest_array(a)
        assert port_format.digest_array_crc(a) == \
            ref_format.digest_array_crc(a)
        enc = port_format.encode_array(a)
        assert enc == ref_format.encode_array(a)
        back = port_format.decode_array(enc)
        assert back.dtype == a.dtype and back.shape == a.shape
        assert back.tobytes() == a.tobytes()
    payload = {"cols": {"cpu": arrays[0], "ids": arrays[1]},
               "rows": (np.int64(3), np.float32(0.5), np.bool_(True)),
               "name": "x"}
    tagged = port_format.jsonify_ndarrays(payload)
    assert tagged == ref_format.jsonify_ndarrays(payload)
    restored = port_format.restore_ndarrays(json.loads(json.dumps(tagged)))
    for key, a in payload["cols"].items():
        assert restored["cols"][key].dtype == a.dtype
        assert restored["cols"][key].tobytes() == a.tobytes()
    obj = {"ranked": [{"component": "db", "score": 0.25}], "n": 3}
    assert port_format.digest_obj(obj) == ref_format.digest_obj(obj)
    args, kwargs = ("ns", "pod"), {"container": "c", "tail_lines": 200}
    assert port_format.make_call_key(args, kwargs) == \
        ref_format.make_call_key(args, kwargs)


@pytest.mark.parametrize("tape", CORPUS, ids=os.path.basename)
def test_corpus_tapes_read_as_the_reference_reads_them(tape):
    got, status = read_frames(tape)
    want, ref_status = ref_format.read_frames(tape)
    assert status.clean and status.to_dict() == ref_status.to_dict()
    assert _same(got, want)


def test_reference_reads_a_port_recording(tmp_path):
    path = str(tmp_path / "rec")
    _record_live(path, depth=1, columnar=True, polls=12)
    got, status = read_frames(path)
    want, ref_status = ref_format.read_frames(path)
    assert status.clean and ref_status.clean and _same(got, want)
    ref_rec = ref_load_recording(path)
    assert len(ref_rec.ticks) == 12 and ref_rec.clean_close
    assert any(fr["kind"] == "coldiff" for fr in got)


# -- live record → replay (bitwise) -------------------------------------------

def _record_live(path, depth, columnar, polls=60, explain=False):
    """The live tests' 40-service, 60-op run (every third poll quiet),
    flight-recorded; returns the polls' outputs."""
    world = synthetic_cascade_world(40, n_roots=1, seed=3, namespace="pipe")
    rec = Recorder(path, mode="stream")
    live = LiveStreamingSession(
        MockClusterClient(world), "pipe", k=3,
        engine=GraphEngine(device="cpu"), topology_check_every=7,
        pipeline_depth=depth, recorder=rec, use_columnar=columnar,
        explain=explain,
    )
    outs = []
    for t, op in enumerate(_op_sequence(seed=13, n=polls)):
        if t % 3 != 2:
            _mutate(world, "pipe", op, waiting_status)
        outs.append(live.poll())
    rec.close()
    return outs


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """The 60-tick run recorded once per (depth, capture)."""
    root = tmp_path_factory.mktemp("live_rec")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RCA_KERNEL_CACHE", "off")
        for depth in (1, 2):
            for columnar in (False, True):
                path = str(root / f"d{depth}_{int(columnar)}")
                out[depth, columnar] = (path, _record_live(path, depth,
                                                           columnar))
    return out


@pytest.mark.parametrize("columnar", [False, True], ids=["dict", "columnar"])
@pytest.mark.parametrize("depth", [1, 2])
def test_record_replay_is_bitwise(recorded, depth, columnar):
    path, outs = recorded[depth, columnar]
    rec = load_recording(path)
    assert rec.clean_close and len(rec.ticks) == 60
    assert rec.session_info["use_columnar"] is columnar
    assert rec.session_info["engine"] == "GraphEngine"
    assert rec.session_info["device"] == "cpu"
    assert rec.header["env"]["rca_tpu_torch"]
    assert any(fr["kind"] == "coldiff" for fr in rec.calls) is columnar
    for t, out in enumerate(outs, start=1):
        assert rec.ticks[t]["ranked"] == out["ranked"]
    report = replay_stream(path, device="cpu")
    assert report["parity_ok"], report
    assert report["ticks_replayed"] == 60
    assert report["unconsumed_calls"] == 0
    assert report["first_divergent_tick"] is None
    assert report["kernel_paths"] == {"torch": 60}
    assert report["pipeline_depth_replayed"] == depth


def test_seek_replays_up_to_the_tick(recorded):
    path, outs = recorded[1, True]
    report = replay_stream(path, seek=11, device="cpu")
    detail = report["seek"]
    assert report["ticks_replayed"] == 11
    assert detail["replayed_ranked"] == detail["recorded_ranked"] == \
        outs[10]["ranked"]
    assert detail["replayed_features_digest"] == \
        detail["recorded_features_digest"]


@pytest.mark.parametrize("recorded_depth,replay_depth", [(1, 2), (2, 1)])
def test_cross_depth_compares_the_serial_sequences(recorded, recorded_depth,
                                                   replay_depth):
    path, _ = recorded[recorded_depth, False]
    report = replay_stream(path, pipeline_depth=replay_depth, device="cpu")
    assert report["parity_ok"], report
    assert report["serial_ticks_compared"] == 59
    assert report["first_divergent_serial"] is None
    assert "mismatched_ticks" not in report


def test_mint_round_trip_and_refusal_of_partial_evidence(recorded, tmp_path):
    path, _ = recorded[1, False]
    out = str(tmp_path / "minted.rcz")
    stats = mint_recording(path, out)
    assert stats["ticks"] == 60 and stats["bytes_out"] == os.path.getsize(out)
    assert stats["bytes_out"] < stats["bytes_in"]
    assert replay(out, device="cpu")["parity_ok"]
    # a recording whose tail lost 3 bytes: not minted, unless asked
    broken = str(tmp_path / "broken")
    shutil.copytree(path, broken)
    chunk = port_format.chunk_files(broken)[-1]
    with open(chunk, "r+b") as f:
        f.truncate(os.path.getsize(chunk) - 3)
    with pytest.raises(ValueError, match="partial evidence"):
        mint_recording(broken, str(tmp_path / "nope.rcz"))
    stats = mint_recording(broken, str(tmp_path / "partial.rcz"),
                           require_clean=False)
    assert stats["ticks"] == 60   # the end frame was lost, no tick
    # an unclosed recorder (no end frame) is partial evidence too
    unclosed = str(tmp_path / "unclosed")
    rec = Recorder(unclosed)
    rec.begin_tick(1)
    rec.end_tick({"ranked": []})
    rec._writer.close()
    with pytest.raises(ValueError, match="not cleanly closed"):
        mint_recording(unclosed, str(tmp_path / "nope2.rcz"))


class _Plain:
    """A client with one method and one plain attribute."""

    label = "plain"

    def get_pods(self, namespace):
        return [{"metadata": {"name": "p"}}]


def test_recording_proxy_keeps_optional_surfaces(tmp_path):
    rec = Recorder(str(tmp_path / "rec"))
    plain = rec.wrap_client(_Plain())
    assert not hasattr(plain, "collect_errors")
    assert not hasattr(plain, "drain_injected")
    assert plain.label == "plain"                 # passes through unrecorded
    chaos = rec.wrap_client(ChaosClusterClient(
        MockClusterClient(synthetic_cascade_world(5, seed=0)),
        ChaosConfig(enabled=False)))
    assert callable(chaos.drain_injected)
    assert not hasattr(chaos, "get_columnar")     # chaos hides the feed
    rec.begin_tick(1)
    pods = plain.get_pods("ns")
    pods[0]["metadata"]["name"] = "edited"        # cannot retro-edit the tape
    rec.close()
    call = load_recording(str(tmp_path / "rec")).calls[0]
    assert call["result"] == [{"metadata": {"name": "p"}}]
    assert rec.calls_recorded == 1
    # the replay source advertises exactly the recorded methods
    src = ReplaySource([call])
    src.advance(1)
    assert src.get_pods("ns") == call["result"]
    assert src.get_pods("ns") == call["result"]   # a repeat re-serves
    assert not hasattr(src, "get_columnar") and not hasattr(src, "label")
    with pytest.raises(ReplayMismatch, match="tick 1: get_pods"):
        src.get_pods("other")


def test_replay_source_raises_recorded_errors():
    src = ReplaySource([
        {"kind": "call", "tick": 1, "method": "get_pods", "key": "k1",
         "ok": False, "error_type": "InjectedTimeout", "error_msg": "x"},
        {"kind": "call", "tick": 1, "method": "get_events", "key": "k2",
         "ok": False, "error_type": "KeyError", "error_msg": "y"},
    ])
    src.advance(1)
    assert src.unconsumed() == 2
    from rca_tpu_torch.resilience.chaos import InjectedTimeout
    from rca_tpu_torch.replay import ReplayedFault

    with pytest.raises(InjectedTimeout):
        src._consume("get_pods", "k1")
    with pytest.raises(ReplayedFault, match="KeyError: y"):
        src._consume("get_events", "k2")
    assert src.unconsumed() == 0


def _perturb(src, out, from_tick):
    """Every tick >= from_tick's recorded ranking bumped: a persistent
    divergence."""
    frames, status = read_frames(src)
    assert status.clean
    w = port_format.RecordingWriter(out, single_file=True)
    for fr in frames:
        if fr.get("kind") == "tick" and fr["tick"] >= from_tick:
            fr = dict(fr)
            fr["ranked"] = [{**r, "score": r["score"] + 1.0}
                            for r in fr["ranked"]]
            fr["ranked_digest"] = digest_obj(fr["ranked"])
        w.append(fr)
    w.close()


def test_bisect_names_the_first_divergent_tick(tmp_path):
    path = str(tmp_path / "rec")
    _record_live(path, depth=1, columnar=True, polls=30)
    perturbed = str(tmp_path / "p.rcz")
    _perturb(path, perturbed, from_tick=19)
    report = bisect_divergence(perturbed, device="cpu")
    assert report["divergent"] and report["first_divergent_tick"] == 19
    # the last tick, then a binary search over 30: log-bounded probing
    assert report["probes"] <= 6
    dump = json.load(open(report["dump"]))
    assert dump["tick"] == 19
    assert dump["recorded_ranked"] != dump["replayed_ranked"]
    # features untouched: the divergence is on the engine's side
    assert dump["feature_diff"]["max_abs"] == 0.0
    clean = bisect_divergence(path, device="cpu",
                              dump_path=str(tmp_path / "none.json"))
    assert not clean["divergent"] and clean["probes"] == 1


def test_replay_cli_exit_codes(recorded, tmp_path, capsys):
    from rca_tpu_torch.cli import main

    path, _ = recorded[2, False]
    perturbed = str(tmp_path / "p.rcz")
    _perturb(path, perturbed, from_tick=23)
    assert main(["replay", path, "--device", "cpu", "--compact"]) == 0
    capsys.readouterr()
    assert main(["replay", perturbed, "--device", "cpu", "--compact"]) == 1
    report = json.loads(capsys.readouterr().out)
    assert report["first_divergent_tick"] == 23
    assert main(["replay", perturbed, "--bisect", "--device", "cpu",
                 "--dump", str(tmp_path / "d.json"), "--compact"]) == 1
    assert json.loads(capsys.readouterr().out)["first_divergent_tick"] == 23
    # --investigation resolves the log from the store's recording_ref
    from rca_tpu_torch.store import InvestigationStore

    store_root = str(tmp_path / "store")
    assert main(["replay", "--investigation", "x", "--log-dir", store_root,
                 "--device", "cpu"]) == 1
    assert "recording_ref" in json.loads(capsys.readouterr().out)["error"]
    inv = InvestigationStore(root=store_root).create_investigation(
        "replayed", recording_ref=path)
    assert main(["replay", "--investigation", inv["id"], "--log-dir",
                 store_root, "--device", "cpu", "--compact"]) == 0
    capsys.readouterr()


# -- explain digests and the trace timeline -----------------------------------

def test_explain_digest_parity_and_trace_out(tmp_path, monkeypatch, capsys):
    from rca_tpu_torch.cli import main
    from rca_tpu_torch.observability import spans

    monkeypatch.setenv("RCA_TRACE", "1")
    monkeypatch.setattr(spans, "_DEFAULT", None)
    path = str(tmp_path / "explained")
    outs = _record_live(path, depth=1, columnar=True, polls=15, explain=True)
    assert all(o["attribution_digest"] for o in outs)
    report = replay_stream(path, explain=True, device="cpu")
    assert report["parity_ok"] and report["attribution_parity_ok"]
    assert report["attribution_ticks_compared"] == 15
    # a recording without digests cannot satisfy --explain
    plain = str(tmp_path / "plain")
    _record_live(plain, depth=1, columnar=True, polls=4)
    report = replay_stream(plain, explain=True, device="cpu")
    assert not report["parity_ok"] and "attribution_error" in report
    # the timeline from the tape: one tick span and three children a poll
    trace_out = str(tmp_path / "trace.json")
    assert main(["replay", path, "--trace-out", trace_out,
                 "--compact"]) == 0
    trace = json.load(open(trace_out))
    names = [e["name"] for e in trace["traceEvents"] if e["ph"] == "X"]
    assert names.count("tick") == 15 and names.count("tick.capture") == 15
    assert json.loads(capsys.readouterr().out)["trace_events"] == \
        len(trace["traceEvents"])


# -- serve record → replay ----------------------------------------------------

def _serve_items(seed=0):
    """The selftest's three graphs (48 / 120 / 260 services), four
    perturbed feature sets each."""
    rng = np.random.default_rng(seed)
    items = []
    for i, n in enumerate((48, 120, 260)):
        case = synthetic_cascade_arrays(n, n_roots=1, seed=seed + i)
        for _ in range(4):
            items.append((np.clip(case.features + rng.uniform(
                0, 0.05, case.features.shape).astype(np.float32), 0, 1),
                case))
    return items


def _submit_all(plane, items, kill=False):
    client = ServeClient(plane)
    reqs = []
    for i, (feats, case) in enumerate(items):
        reqs.append(client.submit(feats, case.dep_src, case.dep_dst,
                                  names=case.names, tenant=f"t{i % 3}", k=3))
        if kill and i == len(items) // 2:
            plane.replicas[0].kill()
    return reqs, [r.result(60.0) for r in reqs]


def test_serve_record_replays_bitwise(tmp_path):
    path = str(tmp_path / "serve")
    rec = Recorder(path, mode="serve")
    loop = ServeLoop(engine=GraphEngine(device="cpu"), recorder=rec,
                     config=ServeConfig(max_batch=4))
    with loop:
        reqs, resps = _submit_all(loop, _serve_items())
    rec.close()
    assert all(r.status == "ok" for r in resps)
    parsed = load_recording(path)
    assert parsed.mode == "serve" and parsed.clean_close
    assert parsed.session_info["engine"] == "GraphEngine"
    assert sorted(fr["request_id"] for fr in parsed.serve) == \
        sorted(r.request_id for r in resps)
    report = replay_serve(path, device="cpu")
    assert report["parity_ok"], report["mismatched"]
    assert report["requests_recorded"] == 12
    # a divergence names its request
    frames, _ = read_frames(path)
    bad = str(tmp_path / "bad.rcz")
    w = port_format.RecordingWriter(bad, single_file=True)
    for fr in frames:
        if fr["kind"] == "serve" and fr["index"] == 7:
            fr = dict(fr, ranked_digest="0" * 16)
        w.append(fr)
    w.close()
    report = replay(bad, device="cpu")
    assert not report["parity_ok"] and report["first_divergent_index"] == 7
    assert report["mismatched"][0]["request_id"] == \
        parsed.serve[7]["request_id"]


def test_pool_load_records_one_frame_per_request(tmp_path):
    """Two replicas, replica 0 killed mid-load: its staged work is stolen
    and answered once; the recording holds exactly one frame per ``ok``
    response, and each replays bitwise."""
    path = str(tmp_path / "pool")
    rec = Recorder(path, mode="serve")
    pool = ServePool(engines=[GraphEngine(device="cpu"),
                              GraphEngine(device="cpu")],
                     recorder=rec, config=ServeConfig(replicas=2))
    with pool:
        reqs, resps = _submit_all(pool, _serve_items(seed=5), kill=True)
    rec.close()
    ok = [r.request_id for r in resps if r.status == "ok"]
    recorded_ids = [fr["request_id"] for fr in load_recording(path).serve]
    assert sorted(recorded_ids) == sorted(ok) and len(ok) >= 6
    assert pool.sink.double_completions == 0
    assert replay_serve(path, device="cpu")["parity_ok"]


def test_sink_writes_a_frame_only_for_the_winning_completion(tmp_path):
    class _Result:
        ranked = [{"component": "a", "score": 1.0}]

    rec = Recorder(str(tmp_path / "sink"), mode="serve")
    sink = CompletionSink(ServeMetrics(), clock=lambda: 0.0, recorder=rec)
    req = ServeRequest(tenant="t", features=np.zeros((3, 2), np.float32),
                       dep_src=[0], dep_dst=[1])
    sink.ok(req, _Result(), 1, 0.0)
    sink.ok(req, _Result(), 1, 0.0)     # a steal racing the owner
    rec.close()
    assert sink.double_completions == 1
    assert len(load_recording(str(tmp_path / "sink")).serve) == 1


# -- the corpus live A/B ------------------------------------------------------

def _port_engine(tag):
    if tag == "ShardedGraphEngine":
        return ShardedGraphEngine(
            mesh=make_mesh([("dp", 1), ("sp", 8)], ["cpu"] * 8))
    return GraphEngine(device="cpu")


@pytest.mark.parametrize("tape", CORPUS, ids=os.path.basename)
def test_corpus_live_ab(tape):
    """Both packages' live sessions over their own replay sources of one
    tape, on the recorded engine kind: tick for tick the same rankings
    (engine contract), poll keys and health keys, every recorded call
    consumed on both sides."""
    ref_rec = ref_load_recording(tape)
    rec = load_recording(tape)
    tag = rec.session_info["engine"]
    ref_src = RefReplaySource(ref_rec.calls)
    src = ReplaySource(rec.calls)
    ref_live = ref_replay_session(ref_rec, ref_src,
                                  ref_engine_for(ref_rec, None), None)
    live = _replay_session(rec, src, _port_engine(tag), None)
    assert type(live.engine).__name__ == type(ref_live.engine).__name__
    assert live._use_columnar == ref_live._use_columnar
    for t in sorted(rec.ticks):
        ref_src.advance(t)
        src.advance(t)
        want, got = ref_live.poll(), live.poll()
        ctx = f"{os.path.basename(tape)} tick {t}"
        assert_ranked_close(got["ranked"], want["ranked"], ctx)
        assert {k: got[k] for k in POLL_KEYS} == \
            {k: want[k] for k in POLL_KEYS}, ctx
        assert {k: got["health"][k] for k in HEALTH_KEYS} == \
            {k: want["health"][k] for k in HEALTH_KEYS}, ctx
        assert got["health"]["injected"] == want["health"]["injected"], ctx
        assert src.unconsumed() == ref_src.unconsumed() == 0, ctx


# -- the committed port tape --------------------------------------------------

def test_committed_port_tape_replays_bitwise():
    rec = load_recording(PORT_TAPE)
    assert rec.clean_close and rec.header["env"]["device_kind"] == "cpu"
    assert rec.session_info["device"] == "cpu"
    assert rec.header["seeds"] == {"chaos_seed": 11}
    report = replay_stream(PORT_TAPE, device="cpu")
    assert report["parity_ok"], report
    assert report["ticks_replayed"] == len(rec.ticks) == 40
    assert report["unconsumed_calls"] == 0
    # the reference reads it frame for frame
    assert _same(ref_format.read_frames(PORT_TAPE)[0],
                 read_frames(PORT_TAPE)[0])
