"""Deterministic replay: re-drive the real engine from a recording.

The port's copy of ``rca_tpu.replay.replayer``.  ``replay_stream``
rebuilds a :class:`LiveStreamingSession` with the knobs the recording's
header captured, feeds it a :class:`rca_tpu_torch.replay.source.
ReplaySource` instead of a cluster, and checks tick-by-tick bit-identity
of the delivered rankings against the ``tick`` frames (``parity="rank"``
judges hit@1 / hit@3 and Kendall-tau instead, for a replay on another
device).  Any engine kind may replay any recording: the capture path asks
the cluster the same questions whatever the engine, and the dense and
sharded engines rank alike.  The engine runs on the CUDA card unless the
caller passes ``device="cpu"`` or an engine.

``bisect_divergence`` localizes a parity break: probe(T) replays a FRESH
session from tick 1 through T and compares only tick T, and a binary
search finds the minimal divergent T.  A tick that computes from diverged
state stays diverged until a full resync rewrites it, and a resync's
inputs come from the same recorded calls, so the search is sound.  At the
first divergent tick both sides' feature and ranking tensors go to a JSON
file for diffing.

``replay_serve`` replays serve recordings: every ``serve`` frame is
self-contained (full request inputs + the ranking its coalesced batch
produced), so replay re-runs each analysis solo and leans on the serve
contract (any batch width == solo) for bit-identity.

``mint_recording`` compacts a recording directory into one
frame-compressed file, the committed-corpus form.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

from rca_tpu_torch.replay.format import (
    ReadStatus,
    RecordingWriter,
    ReplayFormatError,
    SCHEMA_VERSION,
    decode_array,
    digest_array,
    digest_array_crc,
    digest_obj,
    read_frames,
)
from rca_tpu_torch.replay.recorder import env_fingerprint
from rca_tpu_torch.replay.source import ReplaySource

#: mismatched ticks listed in full before the report truncates (the
#: count and first divergence always survive)
_MISMATCH_DETAIL_CAP = 8


def _feature_digest_like(frame: Optional[dict], arr: np.ndarray) -> str:
    """Digest ``arr`` with the algorithm that sealed the recorded tick
    frame (crc32, or sha1 in older recordings)."""
    if frame is not None and frame.get("digest_algo") == "crc32":
        return digest_array_crc(arr)
    return digest_array(arr)


@dataclasses.dataclass
class Recording:
    """A parsed recording: header + frames partitioned by kind."""

    path: str
    header: Dict[str, Any]
    calls: List[Dict[str, Any]]
    ticks: Dict[int, Dict[str, Any]]
    serve: List[Dict[str, Any]]
    end: Optional[Dict[str, Any]]
    status: ReadStatus

    @property
    def mode(self) -> str:
        return self.header.get("mode", "stream")

    @property
    def session_info(self) -> Dict[str, Any]:
        return self.header.get("session", {}) or {}

    @property
    def clean_close(self) -> bool:
        """The recorder closed properly (end frame present, no broken
        tail); a crashed capture still replays its complete ticks."""
        return self.end is not None and self.status.clean


def load_recording(path: str) -> Recording:
    frames, status = read_frames(path)
    if not frames or frames[0].get("kind") != "header":
        raise ReplayFormatError(f"{path}: recording has no header frame")
    header = frames[0]
    if header.get("schema") != SCHEMA_VERSION:
        raise ReplayFormatError(
            f"{path}: header schema {header.get('schema')!r}, this build "
            f"reads {SCHEMA_VERSION}"
        )
    calls: List[Dict[str, Any]] = []
    ticks: Dict[int, Dict[str, Any]] = {}
    serve: List[Dict[str, Any]] = []
    end = None
    for fr in frames[1:]:
        kind = fr.get("kind")
        if kind in ("call", "coldiff"):
            calls.append(fr)
        elif kind == "tick":
            ticks[int(fr["tick"])] = fr
        elif kind == "serve":
            serve.append(fr)
        elif kind == "end":
            end = fr
    # calls are written before their tick frame seals the poll, so a tick
    # frame's presence implies its calls all survived any truncation
    return Recording(path=str(path), header=header, calls=calls,
                     ticks=ticks, serve=serve, end=end, status=status)


# -- stream replay ----------------------------------------------------------

@dataclasses.dataclass
class _StreamRun:
    session: Any
    delivered: Dict[int, List[dict]]  # tick -> delivered ranking
    mismatched: List[int]             # ticks whose digest diverged
    unconsumed_calls: int             # recorded calls replay never made
    # the registry row each replayed tick ran on (``kernels`` / ``torch``)
    kernel_paths: Dict[int, Optional[str]]
    attribution_compared: int = 0
    attribution_mismatched: List[int] = dataclasses.field(
        default_factory=list
    )


def _engine_for(rec: Recording, engine: Any, device: Any = None) -> Any:
    """Default replay engine: the RECORDED kind, on ``device`` (the CUDA
    card unless the caller names the CPU).  Stream rankings agree across
    engine kinds, but serve results carry per-node channels whose sharded
    reductions may differ from the dense sum at the last ulp: bitwise
    claims hold like-for-like, so like-for-like is the default."""
    if engine is not None:
        return engine
    tag = rec.session_info.get("engine")
    if tag == "GraphEngine":
        from rca_tpu_torch.engine.runner import GraphEngine

        return GraphEngine(device=device)
    if tag == "ShardedGraphEngine":
        from rca_tpu_torch.engine.sharded_runner import ShardedGraphEngine

        return ShardedGraphEngine(device=device)
    from rca_tpu_torch.engine.sharded_runner import make_engine

    return make_engine(device=device)


def _replay_session(rec: Recording, source: ReplaySource, engine: Any,
                    pipeline_depth: Optional[int]) -> Any:
    from rca_tpu_torch.engine.live import LiveStreamingSession

    info = rec.session_info
    return LiveStreamingSession(
        source,
        info.get("namespace", "default"),
        k=int(info.get("k", 5)),
        engine=engine,
        topology_check_every=int(info.get("topology_check_every", 5)),
        use_watch=bool(info.get("use_watch", True)),
        pipeline_depth=pipeline_depth,
        # pin the recorded capture path whatever RCA_COLUMNAR says here;
        # headers without the key default to True, which is harmless:
        # ReplaySource advertises get_columnar only with coldiff frames
        use_columnar=bool(info.get("use_columnar", True)),
        # pin the recorded explain mode the same way: an explained
        # recording recomputes its attribution digests on replay
        explain=bool(info.get("explain", False)),
    )


def _tick_diverged(recorded: dict, delivered: List[dict],
                   parity: str) -> bool:
    """One tick's parity verdict: ``exact`` is the bitwise digest gate;
    ``rank`` judges hit@1 / hit@3 + Kendall-tau."""
    if parity == "rank":
        from rca_tpu_torch.engine.quantized import rank_parity

        return not rank_parity(
            recorded.get("ranked") or [], delivered
        )["ok"]
    return digest_obj(delivered) != recorded["ranked_digest"]


def _run_stream(rec: Recording, engine: Any = None,
                pipeline_depth: Optional[int] = None,
                upto: Optional[int] = None,
                compare: bool = True, parity: str = "exact",
                device: Any = None) -> _StreamRun:
    info = rec.session_info
    depth = (
        int(info.get("pipeline_depth", 1)) if pipeline_depth is None
        else max(1, int(pipeline_depth))
    )
    src_ticks = sorted(rec.ticks)
    if upto is not None:
        src_ticks = [t for t in src_ticks if t <= upto]
    # the bootstrap (tick 0) consumes the recorded initial capture
    source = ReplaySource(rec.calls)
    session = _replay_session(rec, source, _engine_for(rec, engine, device),
                              depth)
    delivered: Dict[int, List[dict]] = {}
    kernel_paths: Dict[int, Optional[str]] = {}
    mismatched: List[int] = []
    attribution_compared = 0
    attribution_mismatched: List[int] = []
    unconsumed = 0
    for t in src_ticks:
        source.advance(t)
        out = session.poll()
        delivered[t] = out["ranked"]
        kernel_paths[t] = out["health"].get("kernel_path")
        unconsumed += source.unconsumed()
        if compare and _tick_diverged(rec.ticks[t], out["ranked"], parity):
            mismatched.append(t)
        recorded_digest = rec.ticks[t].get("attribution_digest")
        if compare and recorded_digest is not None:
            # the replayed session recomputed this tick's attribution from
            # the tape: its digest must match the recorded one
            attribution_compared += 1
            if out.get("attribution_digest") != recorded_digest:
                attribution_mismatched.append(t)
    return _StreamRun(session=session, delivered=delivered,
                      mismatched=mismatched, unconsumed_calls=unconsumed,
                      kernel_paths=kernel_paths,
                      attribution_compared=attribution_compared,
                      attribution_mismatched=attribution_mismatched)


def _serial_sequence(by_tick: Dict[int, List[dict]], depth: int
                     ) -> List[List[dict]]:
    """Strip pipeline lag: delivered tick t carries serial ranking
    t-(depth-1), so the serial sequence is the delivered one with the
    first depth-1 (fill) entries dropped.  Exact for fault-free logs;
    degradation flushes re-fill the pipeline and shift the tail."""
    ordered = [by_tick[t] for t in sorted(by_tick)]
    return ordered[max(0, depth - 1):]


def replay_stream(
    path: str,
    engine: Any = None,
    pipeline_depth: Optional[int] = None,
    seek: Optional[int] = None,
    ticks: Optional[int] = None,
    parity: str = "exact",
    explain: bool = False,
    device: Any = None,
) -> Dict[str, Any]:
    """Replay a stream recording and score per-tick parity.

    ``parity``: ``exact`` (bitwise digests, the default) or ``rank``
    (hit@1 / hit@3 + Kendall-tau per tick).  ``seek`` replays up to that
    tick and attaches its detail (both rankings, feature digests) to the
    report.  When the replay depth differs from the recorded one, the
    delivered rankings shift by the lag difference, so the report
    compares the lag-stripped SERIAL sequences instead.  The report's
    ``kernel_paths`` counts the registry rows the replayed ticks ran on."""
    if parity not in ("exact", "rank"):
        raise ValueError(f"parity={parity!r}: expected 'exact' or 'rank'")
    rec = load_recording(path)
    if rec.mode != "stream":
        raise ValueError(f"{path}: {rec.mode!r} recording; use replay_serve")
    info = rec.session_info
    rec_depth = int(info.get("pipeline_depth", 1))
    depth = rec_depth if pipeline_depth is None else max(1, int(pipeline_depth))
    upto = seek
    if ticks is not None:
        upto = min(ticks, upto) if upto is not None else ticks
    run = _run_stream(rec, engine=engine, pipeline_depth=depth, upto=upto,
                      compare=(depth == rec_depth), parity=parity,
                      device=device)
    paths: Dict[str, int] = {}
    for p in run.kernel_paths.values():
        paths[str(p)] = paths.get(str(p), 0) + 1
    report: Dict[str, Any] = {
        "mode": "stream",
        "parity_mode": parity,
        "recording": rec.path,
        "ticks_recorded": len(rec.ticks),
        "ticks_replayed": len(run.delivered),
        "clean_close": rec.clean_close,
        "read_status": rec.status.to_dict(),
        "pipeline_depth_recorded": rec_depth,
        "pipeline_depth_replayed": depth,
        "engine_recorded": info.get("engine"),
        "engine_replayed": type(run.session.engine).__name__,
        "kernel_paths": paths,
        "unconsumed_calls": run.unconsumed_calls,
        "env_recorded": rec.header.get("env", {}),
        "env_replay": env_fingerprint(),
    }
    if depth == rec_depth:
        report["parity_ok"] = (
            not run.mismatched and run.unconsumed_calls == 0
        )
        report["mismatched_ticks"] = run.mismatched[:_MISMATCH_DETAIL_CAP]
        report["first_divergent_tick"] = (
            run.mismatched[0] if run.mismatched else None
        )
        # attribution digests are compared wherever the recorded frames
        # carry them; ``explain=True`` REQUIRES them
        if run.attribution_compared or explain:
            report["attribution_ticks_compared"] = run.attribution_compared
            report["attribution_mismatched_ticks"] = (
                run.attribution_mismatched[:_MISMATCH_DETAIL_CAP]
            )
            attribution_ok = not run.attribution_mismatched and (
                run.attribution_compared > 0 or not explain
            )
            report["attribution_parity_ok"] = attribution_ok
            if explain and run.attribution_compared == 0:
                report["attribution_error"] = (
                    "recording carries no attribution digests "
                    "(record with RCA_EXPLAIN=1)"
                )
            report["parity_ok"] = bool(
                report["parity_ok"] and attribution_ok
            )
    else:
        recorded_serial = _serial_sequence(
            {t: rec.ticks[t]["ranked"] for t in run.delivered}, rec_depth
        )
        replayed_serial = _serial_sequence(run.delivered, depth)
        n = min(len(recorded_serial), len(replayed_serial))
        if parity == "rank":
            from rca_tpu_torch.engine.quantized import rank_parity

            def same(i):
                return rank_parity(
                    recorded_serial[i], replayed_serial[i]
                )["ok"]
        else:
            def same(i):
                return digest_obj(recorded_serial[i]) == digest_obj(
                    replayed_serial[i]
                )
        first = next((i for i in range(n) if not same(i)), None)
        report["serial_ticks_compared"] = n
        report["parity_ok"] = first is None and run.unconsumed_calls == 0
        report["first_divergent_serial"] = first
        if explain:
            # delivered rankings shift by the lag difference, so the
            # per-tick digest pairing is undefined across depths
            report["attribution_parity_ok"] = None
            report["attribution_error"] = (
                "cross-depth replay: attribution digests compare only "
                "at the recorded pipeline depth"
            )
    if seek is not None:
        t = seek
        recd = rec.ticks.get(t)
        detail: Dict[str, Any] = {
            "tick": t,
            "replayed_ranked": run.delivered.get(t),
            "recorded_ranked": recd["ranked"] if recd else None,
            "recorded_features_digest": (
                recd.get("features_digest") if recd else None
            ),
        }
        feats = getattr(run.session, "_features", None)
        if feats is not None:
            detail["replayed_features_digest"] = _feature_digest_like(
                recd, np.asarray(feats, np.float32)
            )
        report["seek"] = detail
    return report


# -- divergence bisect ------------------------------------------------------

def bisect_divergence(
    path: str,
    engine: Any = None,
    pipeline_depth: Optional[int] = None,
    dump_path: Optional[str] = None,
    device: Any = None,
) -> Dict[str, Any]:
    """Binary-search the FIRST divergent tick of a diverging recording.

    Each probe replays a fresh session from tick 1 through T and judges
    only tick T; O(n log n) tick replays in all.  On divergence both
    sides' tensors at the first divergent tick go to ``dump_path``
    (default ``<recording>.divergence.json``).  One engine serves every
    probe."""
    rec = load_recording(path)
    if rec.mode != "stream":
        raise ValueError(f"{path}: {rec.mode!r} recording; use replay_serve")
    tick_ids = sorted(rec.ticks)
    if not tick_ids:
        raise ValueError(f"{path}: recording holds no ticks")
    engine = _engine_for(rec, engine, device)

    def divergent_at(t: int) -> bool:
        run = _run_stream(rec, engine=engine, pipeline_depth=pipeline_depth,
                          upto=t)
        return t in set(run.mismatched)

    probes = 1
    if not divergent_at(tick_ids[-1]):
        return {
            "mode": "stream", "recording": rec.path, "divergent": False,
            "ticks": len(tick_ids), "probes": probes,
            "first_divergent_tick": None,
        }
    lo, hi = 0, len(tick_ids) - 1  # invariant: tick_ids[hi] divergent
    while lo < hi:
        mid = (lo + hi) // 2
        probes += 1
        if divergent_at(tick_ids[mid]):
            hi = mid
        else:
            lo = mid + 1
    first = tick_ids[lo]

    # dump both sides' tensors at the divergence for offline diffing
    run = _run_stream(rec, engine=engine, pipeline_depth=pipeline_depth,
                      upto=first)
    recd = rec.ticks[first]
    dump: Dict[str, Any] = {
        "tick": first,
        "recorded_ranked": recd["ranked"],
        "replayed_ranked": run.delivered.get(first),
        "recorded_features_digest": recd.get("features_digest"),
        "recorded_features": recd.get("features"),
    }
    feats = getattr(run.session, "_features", None)
    if feats is not None:
        f = np.asarray(feats, np.float32)
        dump["replayed_features_digest"] = _feature_digest_like(recd, f)
        dump["replayed_features_shape"] = list(f.shape)
        if recd.get("features") is not None:
            rf = decode_array(recd["features"])
            if rf.shape == f.shape:
                diff = np.abs(rf - f)
                rows = np.flatnonzero(np.any(rf != f, axis=1))
                dump["feature_diff"] = {
                    "max_abs": float(diff.max()),
                    "rows_differing": [int(r) for r in rows[:32]],
                    "n_rows_differing": int(len(rows)),
                }
    out_path = dump_path or (rec.path.rstrip("/\\") + ".divergence.json")
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(dump, f, default=str)
    return {
        "mode": "stream", "recording": rec.path, "divergent": True,
        "first_divergent_tick": first, "probes": probes,
        "ticks": len(tick_ids), "dump": out_path,
        "recorded_ranked": recd["ranked"],
        "replayed_ranked": run.delivered.get(first),
    }


# -- serve replay -----------------------------------------------------------

def replay_serve(path: str, engine: Any = None,
                 device: Any = None) -> Dict[str, Any]:
    """Re-run every recorded served request solo and check bit-identity
    with the ranking its (arbitrarily coalesced) batch produced."""
    from rca_tpu_torch.serve.dispatcher import BatchDispatcher
    from rca_tpu_torch.serve.request import ServeRequest

    rec = load_recording(path)
    if rec.mode != "serve":
        raise ValueError(f"{path}: {rec.mode!r} recording; use replay_stream")
    disp = BatchDispatcher(_engine_for(rec, engine, device))
    mismatched: List[Dict[str, Any]] = []
    for fr in rec.serve:
        req = ServeRequest(
            tenant=fr["tenant"],
            features=decode_array(fr["features"]),
            dep_src=decode_array(fr["dep_src"]),
            dep_dst=decode_array(fr["dep_dst"]),
            names=fr.get("names"), k=int(fr.get("k", 5)),
        )
        result = disp.fetch(disp.dispatch([req]))[0]
        ranked = [dict(r) for r in result.ranked]
        if digest_obj(ranked) != fr["ranked_digest"]:
            mismatched.append({
                "index": fr.get("index"),
                "request_id": fr.get("request_id"),
                "recorded": fr["ranked"], "replayed": ranked,
            })
    return {
        "mode": "serve",
        "recording": rec.path,
        "requests_recorded": len(rec.serve),
        "clean_close": rec.clean_close,
        "read_status": rec.status.to_dict(),
        "parity_ok": not mismatched,
        "mismatched": mismatched[:_MISMATCH_DETAIL_CAP],
        "first_divergent_index": (
            mismatched[0]["index"] if mismatched else None
        ),
        "engine_replayed": disp.engine_tag,
        "env_recorded": rec.header.get("env", {}),
        "env_replay": env_fingerprint(),
    }


def replay(path: str, **kwargs: Any) -> Dict[str, Any]:
    """Mode-dispatching convenience: stream recordings replay through the
    live session, serve recordings through the solo dispatcher."""
    rec = load_recording(path)
    if rec.mode == "serve":
        return replay_serve(path, engine=kwargs.get("engine"),
                            device=kwargs.get("device"))
    return replay_stream(path, **kwargs)


# -- minting (corpus fixtures) ----------------------------------------------

def mint_recording(src: str, out: str,
                   require_clean: bool = True) -> Dict[str, Any]:
    """Compact a recording into ONE frame-compressed file, the committed
    corpus form.  Refuses (by default) to mint a truncated, corrupt or
    unclosed capture: a fixture must be complete evidence."""
    rec = load_recording(src)
    if require_clean and not rec.clean_close:
        raise ValueError(
            f"{src}: not cleanly closed ({rec.status.to_dict()}) — "
            "refusing to mint a fixture from partial evidence"
        )
    frames, _status = read_frames(src)
    writer = RecordingWriter(out, single_file=True)
    for fr in frames:
        writer.append(fr, compress=True)
    writer.close()
    return {
        "src": str(src), "out": str(out),
        "frames": len(frames),
        "ticks": len(rec.ticks), "serve": len(rec.serve),
        "bytes_in": _tree_bytes(src),
        "bytes_out": os.path.getsize(out),
    }


def _tree_bytes(path: str) -> int:
    if os.path.isdir(path):
        return sum(
            os.path.getsize(os.path.join(path, n))
            for n in os.listdir(path)
            if os.path.isfile(os.path.join(path, n))
        )
    return os.path.getsize(path)
