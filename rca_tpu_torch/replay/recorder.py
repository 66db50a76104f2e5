"""Flight recorder: capture everything a session consumed, per tick.

The port's copy of ``rca_tpu.replay.recorder``, writing the same frames.
A :class:`rca_tpu_torch.engine.live.LiveStreamingSession` is a
deterministic function of its construction knobs and of the sequence of
cluster-client answers it observes: feature extraction, the edge build
and the tick are pure on one device.  So the recorder does NOT snapshot
engine internals; it wraps the client and records every call's (method,
args, result or exception) inside tick boundaries, plus each tick's
delivered ranking and a digest of the host feature mirror.  Replay
(:mod:`rca_tpu_torch.replay.source`) re-serves those answers to the real
engine and the rankings must come back bit-identical.

Chaos runs record faithfully: injected faults surface as client-call
EXCEPTIONS (recorded, re-raised on replay) and ``drain_injected`` results
(recorded like any call), so a replayed chaos soak walks the same
degraded paths the live one did.

Frame kinds written here (format.py owns the byte layout):

- ``header``  once, first: schema, mode (stream/serve), session knobs,
  env fingerprint, optional seeds;
- ``call``    one per client call, tagged with the current tick (tick 0 =
  the session's bootstrap capture); ``coldiff`` for ``get_columnar``
  answers, their numpy columns as tagged raw bytes;
- ``tick``    one per poll: delivered ranking (+ digest), host feature
  digest (full rows too, below the size cap), health excerpt;
- ``serve``   one per served request (serve mode): full request inputs +
  the ranking it got;
- ``end``     on close: tick/serve counts.  A recording without it is a
  crashed (possibly truncated) capture; replay still covers every
  complete tick.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from rca_tpu_torch.replay.format import (
    SCHEMA_VERSION,
    RecordingWriter,
    digest_array_crc,
    digest_obj,
    encode_array,
    jsonify_ndarrays,
    make_call_key,
)

#: record full per-tick feature rows only while the matrix stays under
#: this many elements; above it the digest alone rides along
FEATURES_FULL_CAP = 65536

#: health-record keys copied into each tick frame (forensics; the parity
#: contract itself is on the ranking digest).  ``spans`` (absent with
#: ``RCA_TRACE=0``) lets ``replay --trace-out`` rebuild the timeline.
_HEALTH_KEYS = (
    "sanitized_rows", "degradation", "resyncs_expired", "resyncs_topology",
    "pipeline_fill", "retries", "spans",
)


def wall_now() -> str:
    """Wall-clock stamp for the header's ``created_at``; nothing replayed
    depends on it."""
    import datetime

    return datetime.datetime.now(datetime.timezone.utc).isoformat()


def env_fingerprint() -> Dict[str, Any]:
    """What machine and stack produced a recording, stamped into the
    header so a cross-host parity failure is attributable before any
    bisect: the package, torch and CUDA versions, the device kind and
    name, the device count and the knobs that pick the engine and row."""
    import torch

    from rca_tpu_torch.config import env_raw
    from rca_tpu_torch.version import __version__

    on_card = torch.cuda.is_available()
    return {
        "rca_tpu_torch": __version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "numpy": np.__version__,
        "device_kind": "cuda" if on_card else "cpu",
        "device_name": torch.cuda.get_device_name(0) if on_card else "cpu",
        "device_count": torch.cuda.device_count() if on_card else 1,
        "rca_shard": env_raw("RCA_SHARD"),
        "rca_kernel": env_raw("RCA_KERNEL"),
        "rca_pipeline_depth": env_raw("RCA_PIPELINE_DEPTH"),
    }


class Recorder:
    """One recording in progress.  The streaming path records from one
    thread; the serve path's frames go through the completion sink's
    lock, which serializes the replica workers."""

    def __init__(
        self,
        path: str,
        mode: str = "stream",
        seeds: Optional[Dict[str, int]] = None,
        meta: Optional[Dict[str, Any]] = None,
    ):
        if mode not in ("stream", "serve"):
            raise ValueError(f"mode must be stream|serve, got {mode!r}")
        self._writer = RecordingWriter(str(path))
        self.path = str(path)
        self.mode = mode
        self._tick = 0
        self.ticks_recorded = 0
        self.serve_recorded = 0
        self.calls_recorded = 0
        self._closed = False
        self._header_written = False
        self._pending_header: Dict[str, Any] = {
            "kind": "header", "schema": SCHEMA_VERSION, "mode": mode,
            "created_at": wall_now(), "env": env_fingerprint(),
            "seeds": dict(seeds or {}), "meta": dict(meta or {}),
            "session": {},
        }

    # -- header -------------------------------------------------------------
    def begin_session(self, info: Dict[str, Any]) -> None:
        """Session construction knobs (namespace, k, depth, engine tag...),
        merged into the header, which is written with the first frame so
        it is always frame 0 even when the info arrives in pieces."""
        self._pending_header["session"].update(info)

    def _ensure_header(self) -> None:
        if not self._header_written:
            self._writer.append(self._pending_header)
            self._header_written = True

    # -- client wrapping ----------------------------------------------------
    def wrap_client(self, client: Any) -> "RecordingClusterClient":
        return RecordingClusterClient(client, self)

    def record_call(self, method: str, key: str, ok: bool,
                    result: Any = None,
                    error: Optional[BaseException] = None) -> None:
        self._ensure_header()
        # columnar feed answers are COLUMN-DIFF frames: the full table
        # dump once, then row ops, their numpy columns as tagged raw
        # bytes (bit-exact on replay)
        coldiff = method == "get_columnar"
        frame: Dict[str, Any] = {
            "kind": "coldiff" if coldiff else "call",
            "tick": self._tick, "method": method,
            "key": key, "ok": bool(ok),
        }
        if ok:
            frame["result"] = jsonify_ndarrays(result) if coldiff else result
        else:
            frame["error_type"] = type(error).__name__
            frame["error_msg"] = str(error)
        self._writer.append(frame)
        self.calls_recorded += 1

    # -- tick boundaries ----------------------------------------------------
    def begin_tick(self, tick: int) -> None:
        self._ensure_header()
        self._tick = int(tick)

    def end_tick(self, out: Dict[str, Any],
                 features: Optional[np.ndarray] = None) -> None:
        """Seal one poll: the DELIVERED ranking (depth-lagged at pipeline
        depth >= 2; replay at the same depth reproduces the lag) and the
        host feature mirror's digest, with full rows while small."""
        health = out.get("health", {}) or {}
        frame: Dict[str, Any] = {
            "kind": "tick", "tick": self._tick,
            "ranked": out.get("ranked", []),
            "ranked_digest": digest_obj(out.get("ranked", [])),
            "quiet": bool(out.get("quiet", False)),
            "resynced": bool(out.get("resynced", False)),
            "degraded": bool(out.get("degraded", False)),
            "changed_rows": int(out.get("changed_rows", 0)),
            "health": {k: health.get(k) for k in _HEALTH_KEYS},
        }
        if "attribution_digest" in out:
            # the digest of this tick's attribution block: `replay
            # --explain` recomputes the block from the tape and checks it
            frame["attribution_digest"] = out["attribution_digest"]
        if features is not None:
            f = np.asarray(features, np.float32)
            frame["features_digest"] = digest_array_crc(f)
            frame["digest_algo"] = "crc32"
            frame["features_shape"] = list(f.shape)
            if f.size <= FEATURES_FULL_CAP:
                frame["features"] = encode_array(f)
        self._writer.append(frame)
        self.ticks_recorded += 1

    # -- serve records -------------------------------------------------------
    def record_serve(self, req: Any, ranked: List[dict]) -> None:
        """One served request, self-contained: the full inputs plus the
        ranking its coalesced batch produced.  Replay re-runs the same
        analysis solo; the serve contract (any batch width == solo) makes
        bit-identity the expectation."""
        self._ensure_header()
        trace = getattr(req, "trace", None)
        self._writer.append({
            "kind": "serve", "index": self.serve_recorded,
            "request_id": req.request_id, "tenant": req.tenant,
            "trace_id": trace.trace_id if trace is not None else None,
            "k": int(req.k),
            "names": list(req.names) if req.names is not None else None,
            "features": encode_array(req.features),
            "dep_src": encode_array(req.dep_src),
            "dep_dst": encode_array(req.dep_dst),
            "ranked": ranked,
            "ranked_digest": digest_obj(ranked),
        }, compress=True)
        self.serve_recorded += 1

    # -- lifecycle -----------------------------------------------------------
    @property
    def bytes_written(self) -> int:
        return self._writer.bytes_written

    def close(self) -> None:
        if self._closed:
            return
        self._ensure_header()
        self._writer.append({
            "kind": "end", "ticks": self.ticks_recorded,
            "serve": self.serve_recorded, "calls": self.calls_recorded,
        })
        self._writer.close()
        self._closed = True


class RecordingClusterClient:
    """Transparent recording proxy over any cluster client (or a chaos
    wrapper around one).  Every METHOD call passes through and its result,
    or raised exception, is recorded under the current tick; results are
    serialized at call time, so a later in-place edit by the caller cannot
    retro-edit the tape.  Non-callable attributes pass through unrecorded,
    and attributes the inner client lacks raise ``AttributeError`` as
    before, so ``hasattr``-gated optional surfaces (``collect_errors``,
    ``drain_injected``, ``watch_close``) keep their presence on replay."""

    def __init__(self, inner: Any, recorder: Recorder):
        self._rec_inner = inner
        self._rec_recorder = recorder

    def __getattr__(self, name: str) -> Any:
        attr = getattr(self._rec_inner, name)  # AttributeError propagates
        if not callable(attr):
            return attr
        recorder = self._rec_recorder

        def recorded(*args: Any, **kwargs: Any) -> Any:
            key = make_call_key(args, kwargs)
            try:
                result = attr(*args, **kwargs)
            except Exception as exc:
                recorder.record_call(name, key, ok=False, error=exc)
                raise
            recorder.record_call(name, key, ok=True, result=result)
            return result

        recorded.__name__ = name
        return recorded
