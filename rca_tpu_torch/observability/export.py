"""The fixed-bucket latency histogram: the port's copy of
``LatencyHistogram`` from ``rca_tpu.observability.export`` (the Chrome
trace and NDJSON exports come with the gateway).

One histogram per tenant holds the serving scheduler's submit→completion
durations in cumulative ``le`` buckets, the form a burn rate divides by.
"""

from __future__ import annotations

from typing import Any, Dict

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
