"""Per-stage latency timing: the port's copy of ``StageTimer`` from
``rca_tpu.obslog.profiling``.  Every comprehensive analysis carries the
breakdown under ``results["profile"]``."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List


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
