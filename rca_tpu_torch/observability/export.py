"""Trace and latency exports: Chrome trace JSON, NDJSON, histograms.

The port's copy of ``rca_tpu.observability.export``:

- :func:`chrome_trace` renders spans as complete ("ph": "X") Chrome
  trace events, one timeline row per trace, which Perfetto loads;
- :func:`ndjson_spans`: one span JSON per line;
- :func:`recording_trace` rebuilds the same Chrome trace from a flight
  recording's tick frames (spans ride in every tick's health record), so
  ``python -m rca_tpu_torch replay --trace-out`` reconstructs a recorded
  incident's timeline without re-running it;
- :class:`LatencyHistogram`: one histogram per tenant holds the serving
  scheduler's submit→completion durations in cumulative ``le`` buckets,
  the form a burn rate divides by.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

#: bucket upper bounds (seconds); the +Inf bucket is implicit (count)
DURATION_BUCKETS_S = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class LatencyHistogram:
    """One cumulative fixed-bucket histogram (NOT thread-safe: holders
    record under their own lock, as with PhaseStats)."""

    def __init__(self) -> None:
        self.counts = [0] * len(DURATION_BUCKETS_S)
        self.count = 0
        self.sum_s = 0.0

    def record(self, seconds: float) -> None:
        s = float(seconds)
        self.count += 1
        self.sum_s += s
        for i, le in enumerate(DURATION_BUCKETS_S):
            if s <= le:
                self.counts[i] += 1

    def to_dict(self) -> Dict[str, Any]:
        return {
            "buckets": {
                str(le): n for le, n in zip(DURATION_BUCKETS_S, self.counts)
            },
            "count": self.count,
            "sum_s": round(self.sum_s, 6),
        }


# -- Chrome trace-event export ------------------------------------------------

def chrome_trace(spans: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Span dicts → a Chrome trace-event JSON object Perfetto loads.

    One ``pid`` for the process, one ``tid`` lane per trace (first-seen
    order, named by a metadata event), so concurrent requests stack as
    parallel rows.  Events are complete ("ph": "X") with microsecond
    ``ts`` / ``dur`` rebased to the earliest span.  Span identity and
    parentage ride in ``args``."""
    lanes: Dict[str, int] = {}
    events: List[Dict[str, Any]] = []
    t0 = min((float(s["start"]) for s in spans), default=0.0)
    for s in spans:
        trace_id = s["trace_id"]
        tid = lanes.get(trace_id)
        if tid is None:
            tid = len(lanes) + 1
            lanes[trace_id] = tid
            events.append({
                "name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
                "args": {"name": f"trace {trace_id}"},
            })
        start = float(s["start"])
        end = float(s["end"])
        events.append({
            "name": s["name"],
            "cat": s["name"].split(".", 1)[0],
            "ph": "X",
            "pid": 1,
            "tid": tid,
            "ts": round((start - t0) * 1e6, 3),
            "dur": round(max(0.0, end - start) * 1e6, 3),
            "args": {
                "trace_id": trace_id,
                "span_id": s["span_id"],
                "parent_id": s.get("parent_id"),
                **(s.get("attrs") or {}),
            },
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def ndjson_spans(spans: List[Dict[str, Any]]) -> str:
    """One span JSON object per line."""
    return "".join(json.dumps(s) + "\n" for s in spans)


def recording_trace(path: str) -> Dict[str, Any]:
    """The Chrome trace of a RECORDED session: every span embedded in the
    recording's tick-frame health records (plus serve frames' trace ids
    as zero-length markers), in frame order; the times are the ones the
    session had, not a re-run's."""
    from rca_tpu_torch.replay.format import read_frames

    frames, _status = read_frames(path)
    spans: List[Dict[str, Any]] = []
    for frame in frames:
        if frame.get("kind") == "tick":
            for s in (frame.get("health") or {}).get("spans") or []:
                spans.append(s)
        elif frame.get("kind") == "serve" and frame.get("trace_id"):
            spans.append({
                "name": "serve.recorded",
                "trace_id": frame["trace_id"],
                "span_id": f"{int(frame.get('index', 0)):08x}",
                "parent_id": None,
                "start": float(frame.get("index", 0)),
                "end": float(frame.get("index", 0)),
                "attrs": {
                    "request_id": frame.get("request_id"),
                    "tenant": frame.get("tenant"),
                },
            })
    return chrome_trace(spans)


def write_chrome_trace(spans_or_trace, out_path: str) -> str:
    """Dump a Chrome trace JSON file from a span-dict list or an already
    rendered trace object.  Returns ``out_path``."""
    trace = (
        spans_or_trace if isinstance(spans_or_trace, dict)
        else chrome_trace(spans_or_trace)
    )
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(trace, f)
    return out_path
