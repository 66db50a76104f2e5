"""Kernelscope's runtime watchdogs, the part the live session's health
record reads: the port's counterpart of ``rca_tpu.observability.
kernelscope``'s :class:`RecompileMonitor`, :func:`sample_device_memory`,
:func:`leak_gate` and :class:`DeviceMemoryAccountant`.

The port compiles nothing per call, so its "compiles" are the two events
that stand for a compile: a build of the kernel library
(``kernels/build.py``) and a registry plan election for a ``(variant,
n_pad, e_pad, steps, device)`` signature (``engine/registry.py``).  Both
note themselves in one process-wide compile log (:func:`note_compile`).
A recompile is the same signature compiled twice inside one monitor's
window (a registry that was cleared and elected the shape again, a
library built twice).  Memory comes from ``torch.cuda.memory_stats`` per
device.  ``RCA_KERNELSCOPE=0`` turns the monitor and the accountant into
no-ops.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Optional

from rca_tpu_torch.config import kernelscope_enabled, memory_sample_every
from rca_tpu_torch.util.threads import make_lock


class _CompileLog:
    """Process-wide, bounded, thread-safe log of compile events; each
    event records the sequence number of the previous event with the same
    signature."""

    def __init__(self, cap: int = 4096):
        self._lock = make_lock("kernelscope._CompileLog._lock")
        self._events: "deque[Dict[str, Any]]" = deque(maxlen=cap)
        self._last: Dict[str, int] = {}
        self._seq = 0

    def note(self, name: str, signature: str) -> None:
        with self._lock:
            self._seq += 1
            self._events.append({"seq": self._seq, "name": name,
                                 "prev_seq": self._last.get(signature)})
            self._last[signature] = self._seq

    def seq(self) -> int:
        with self._lock:
            return self._seq

    def events_since(self, seq: int) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in self._events if e["seq"] > seq]


_LOG = _CompileLog()


def note_compile(name: str, signature) -> None:
    """Record one compile: ``name`` is what the monitor reports,
    ``signature`` what makes a repeat a recompile."""
    _LOG.note(name, repr(signature))


class RecompileMonitor:
    """One session's view over the compile log: counts since ``start()``
    (and since ``mark_warm()``), so concurrent sessions each read their
    own window.  ``start()`` opens the window and ``stop()`` closes it
    (or use the monitor as a context manager); a closed monitor reports
    the disabled form, and a later ``start()`` opens a fresh window.  The
    log is passive (the compiles note themselves), so opening and closing
    a window installs and removes nothing.  Disabled monitors
    (``RCA_KERNELSCOPE=0``) are free no-ops with the same surface."""

    def __init__(self, enabled: Optional[bool] = None):
        self.enabled = (
            kernelscope_enabled() if enabled is None else bool(enabled)
        )
        self._started = False
        self._start_seq = 0
        self._warm_seq: Optional[int] = None

    def start(self) -> "RecompileMonitor":
        if self.enabled and not self._started:
            self._started = True
            self._start_seq = _LOG.seq()
            self._warm_seq = None
        return self

    def stop(self) -> None:
        self._started = False

    def __enter__(self) -> "RecompileMonitor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def mark_warm(self) -> None:
        """The end of warm-up: ``recompiles_post_warm`` counts from here."""
        if self._started:
            self._warm_seq = _LOG.seq()

    def snapshot(self) -> Dict[str, Any]:
        """Counts over THIS monitor's window: a recompile is a compile
        whose signature was already compiled inside the window."""
        if not self._started:
            return {"enabled": False, "compiles": 0, "recompiles": 0,
                    "recompiles_post_warm": 0, "recompiled": []}
        events = _LOG.events_since(self._start_seq)
        warm_seq = (self._warm_seq if self._warm_seq is not None
                    else _LOG.seq())
        repeats = [e for e in events if e["prev_seq"] is not None
                   and e["prev_seq"] > self._start_seq]
        return {
            "enabled": True,
            "compiles": len(events),
            "recompiles": len(repeats),
            "recompiles_post_warm": sum(
                1 for e in repeats if e["seq"] > warm_seq),
            "recompiled": [e["name"] for e in repeats][-8:],
        }


def sample_device_memory() -> Dict[str, Any]:
    """One sample of the process's CUDA footprint from the caching
    allocator: per device ``bytes_in_use`` and ``peak_bytes_in_use``
    (``torch.cuda.memory_stats``), and their sum.  A host without CUDA
    reports no device and 0 bytes."""
    import torch

    devices: Dict[str, Dict[str, Any]] = {}
    total = 0
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            rec = {
                "bytes_in_use": int(stats.get("allocated_bytes.all.current",
                                              0)),
                "peak_bytes_in_use": int(stats.get(
                    "allocated_bytes.all.peak", 0)),
            }
            devices[str(i)] = rec
            total += rec["bytes_in_use"]
    return {"devices": devices, "bytes_in_use": total}


def leak_gate(byte_samples: List[int], warmup: int = 1,
              slack_bytes: int = 1 << 20) -> Dict[str, Any]:
    """The monotonic-growth leak gate over memory samples: FAILS only when
    the post-warmup series never goes down AND ends more than
    ``slack_bytes`` above where it started."""
    series = [int(b) for b in byte_samples][warmup:]
    if len(series) < 3:
        return {"ok": True, "samples": len(series),
                "reason": "too few samples to gate"}
    monotonic = all(b >= a for a, b in zip(series, series[1:]))
    growth = series[-1] - series[0]
    ok = not (monotonic and growth > slack_bytes)
    return {
        "ok": bool(ok),
        "samples": len(series),
        "first_bytes": series[0],
        "last_bytes": series[-1],
        "growth_bytes": int(growth),
        "monotonic_growth": bool(monotonic),
        "slack_bytes": int(slack_bytes),
    }


class DeviceMemoryAccountant:
    """Periodic device-memory sampling for the tick health record:
    ``maybe_sample(tick)`` samples every ``sample_every``-th tick; the
    byte series feeds :func:`leak_gate`."""

    def __init__(self, sample_every: Optional[int] = None,
                 enabled: Optional[bool] = None, cap: int = 1024):
        self.enabled = (
            kernelscope_enabled() if enabled is None else bool(enabled)
        )
        self.sample_every = (
            memory_sample_every() if sample_every is None
            else max(1, int(sample_every))
        )
        self._bytes: "deque[int]" = deque(maxlen=cap)
        self.samples_taken = 0

    def maybe_sample(self, tick: int) -> Optional[Dict[str, Any]]:
        if not self.enabled or int(tick) % self.sample_every != 0:
            return None
        return self.sample()

    def sample(self) -> Optional[Dict[str, Any]]:
        if not self.enabled:
            return None
        out = sample_device_memory()
        self._bytes.append(int(out["bytes_in_use"]))
        self.samples_taken += 1
        return out

    def byte_series(self) -> List[int]:
        return list(self._bytes)

    def gate(self, warmup: int = 1,
             slack_bytes: int = 1 << 20) -> Dict[str, Any]:
        if not self.enabled:
            return {"ok": True, "samples": 0, "reason": "disabled"}
        return leak_gate(self.byte_series(), warmup=warmup,
                         slack_bytes=slack_bytes)
