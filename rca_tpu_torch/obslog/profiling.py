"""Per-stage latency timing: the port's copy of ``StageTimer`` and
``PhaseStats`` from ``rca_tpu.obslog.profiling``.  Every comprehensive
analysis carries the stage breakdown under ``results["profile"]``; the
serving scheduler's per-tenant queue times and per-replica occupancy
samples ride ``PhaseStats``."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional


class StageTimer:
    """Collects (stage, seconds) pairs; nestable via context manager."""

    def __init__(self) -> None:
        self.stages: List[Dict[str, float]] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages.append(
                {"stage": name, "ms": (time.perf_counter() - t0) * 1e3}
            )

    def report(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for s in self.stages:
            out[s["stage"]] = out.get(s["stage"], 0.0) + round(s["ms"], 3)
        out["total_ms"] = round(sum(s["ms"] for s in self.stages), 3)
        return out


class PhaseStats:
    """Per-phase sample accumulator for repeated loops: ``record(phase,
    ms)`` per iteration, :meth:`quantile` at the end.
    Not thread-safe: holders that share one across threads (ServeMetrics)
    record under their own lock and read through :meth:`snapshot`."""

    def __init__(self) -> None:
        self._samples: Dict[str, List[float]] = {}

    def record(self, phase: str, ms: float) -> None:
        self._samples.setdefault(phase, []).append(float(ms))

    def quantile(self, phase: str, q: float) -> Optional[float]:
        """Nearest-rank quantile of one phase's samples (q in [0, 1]);
        None when the phase has no samples."""
        xs = self._samples.get(phase)
        if not xs:
            return None
        s = sorted(xs)
        i = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
        return round(s[i], 3)

    def phases(self) -> List[str]:
        """The phases with samples, in first-recorded order."""
        return list(self._samples)

    def snapshot(self) -> "PhaseStats":
        """A deep-copied twin of the current samples, taken under the
        holder's lock so quantiles are derived off it."""
        twin = PhaseStats()
        twin._samples = {k: list(v) for k, v in self._samples.items()}
        return twin
