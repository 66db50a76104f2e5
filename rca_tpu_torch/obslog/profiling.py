"""Per-stage latency timing and the optional device trace: the port's
copy of ``StageTimer`` and ``PhaseStats`` from ``rca_tpu.obslog.profiling``,
and :func:`maybe_device_profile`, the twin of its ``maybe_jax_profile``.
Every comprehensive analysis carries the stage breakdown under
``results["profile"]``, and ``RCA_TORCH_PROFILE=<dir>`` wraps its
correlate stage in a ``torch.profiler`` trace; the serving scheduler's
per-tenant queue times and per-replica occupancy samples ride
``PhaseStats``."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

from rca_tpu_torch.config import device_profile_dir


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

    def count(self, phase: str) -> int:
        """How many samples one phase holds (0 for an unknown phase)."""
        return len(self._samples.get(phase, []))

    def phases(self) -> List[str]:
        """The phases with samples, in first-recorded order."""
        return list(self._samples)

    def snapshot(self) -> "PhaseStats":
        """A deep-copied twin of the current samples, taken under the
        holder's lock so quantiles are derived off it."""
        twin = PhaseStats()
        twin._samples = {k: list(v) for k, v in self._samples.items()}
        return twin


@contextlib.contextmanager
def maybe_device_profile(tag: str, device):
    """A ``torch.profiler`` trace of the block when ``RCA_TORCH_PROFILE=<dir>``
    is set, written as Chrome trace JSON (Perfetto loads it) to
    ``<dir>/<tag>/<tag>.<pid>.<ns>.json``; a no-op otherwise.  CPU and CUDA
    activities where the block's work runs on a CUDA ``device``, the CPU's
    alone elsewhere."""
    trace_dir = device_profile_dir()
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out_dir = os.path.join(trace_dir, tag)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        out_dir, f"{tag}.{os.getpid()}.{time.time_ns()}.json"))
