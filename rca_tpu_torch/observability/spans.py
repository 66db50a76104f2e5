"""Spans and the tracer seam: the port's copy of
``rca_tpu.observability.spans``.

A :class:`Span` is one named time interval inside a trace; a trace is
every span sharing a ``trace_id``, connected by ``parent_id`` edges.
Context enters at the gateway through the ``X-RCA-Trace`` header
(``<trace_id>-<span_id>``, minted when absent, echoed in responses) and
rides the serve request through the queue, the batcher and the replica.
Spans are opened only through a :class:`Tracer`: ``tracer.span(...)`` as a
``with`` block, or ``tracer.record(...)`` for a phase whose ends are known
timestamps.  The tracer times through an injectable ``clock``, mints ids
from a seeded ``random.Random`` and keeps a bounded ring buffer that drops
its oldest spans past ``cap``.  ``RCA_TRACE=0`` (the default) hands out
:data:`NULL_TRACER`, whose calls are constant no-ops.
:func:`device_annotation` names a host scope in a ``torch.profiler``
trace while a profile is being taken.
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import time
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional

from rca_tpu_torch.config import trace_buffer_cap, trace_enabled
from rca_tpu_torch.util.threads import make_lock

#: the wire header carrying trace context across the gateway boundary
TRACE_HEADER = "X-RCA-Trace"


@dataclasses.dataclass(frozen=True)
class SpanContext:
    """The identity a child span parents onto."""

    trace_id: str   # 16 hex chars
    span_id: str    # 8 hex chars

    def to_wire(self) -> str:
        return f"{self.trace_id}-{self.span_id}"

    @staticmethod
    def from_wire(value: Optional[str]) -> Optional["SpanContext"]:
        """Parse an ``X-RCA-Trace`` header; None for anything malformed (a
        bad header starts a fresh trace, it never fails the request)."""
        if not value or not isinstance(value, str):
            return None
        parts = value.strip().split("-")
        if len(parts) != 2:
            return None
        trace_id, span_id = parts
        if not (1 <= len(trace_id) <= 32 and 1 <= len(span_id) <= 16):
            return None
        try:
            int(trace_id, 16), int(span_id, 16)
        except ValueError:
            return None
        return SpanContext(trace_id, span_id)


@dataclasses.dataclass
class Span:
    """One recorded interval.  Times are seconds in the minting tracer's
    clock domain; attributes are JSON-safe."""

    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    start: float
    end: float
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name, "trace_id": self.trace_id,
            "span_id": self.span_id, "parent_id": self.parent_id,
            "start": self.start, "end": self.end,
            "attrs": dict(self.attrs),
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Span":
        return Span(
            name=d["name"], trace_id=d["trace_id"], span_id=d["span_id"],
            parent_id=d.get("parent_id"), start=float(d["start"]),
            end=float(d["end"]), attrs=dict(d.get("attrs") or {}),
        )


class Tracer:
    """Span minting and the lock-disciplined bounded ring buffer.  The
    buffer drops the OLDEST spans past ``cap`` and counts the drops."""

    def __init__(
        self,
        enabled: bool = True,
        cap: Optional[int] = None,
        clock: Callable[[], float] = time.monotonic,
        seed: Optional[int] = None,
    ):
        self.enabled = bool(enabled)
        self.cap = int(cap) if cap is not None else trace_buffer_cap()
        if self.cap < 1:
            raise ValueError(f"trace buffer cap must be >= 1, got {cap}")
        self.clock = clock
        self._rng = random.Random(seed)
        self._lock = make_lock("Tracer._lock")
        self._buffer: "deque[Span]" = deque(maxlen=self.cap)
        self.dropped = 0
        self.recorded = 0

    def _trace_id(self) -> str:
        with self._lock:
            return f"{self._rng.getrandbits(64):016x}"

    def _span_id(self) -> str:
        with self._lock:
            return f"{self._rng.getrandbits(32):08x}"

    def new_context(
        self, parent: Optional[SpanContext] = None
    ) -> Optional[SpanContext]:
        """Mint a span's identity before recording it; a child keeps its
        parent's trace.  None when disabled."""
        if not self.enabled:
            return None
        trace_id = parent.trace_id if parent is not None else self._trace_id()
        return SpanContext(trace_id, self._span_id())

    def _push(self, span: Span) -> Span:
        with self._lock:
            if len(self._buffer) == self.cap:
                self.dropped += 1
            self._buffer.append(span)
            self.recorded += 1
        return span

    def record(
        self,
        name: str,
        start: float,
        end: float,
        parent: Optional[SpanContext] = None,
        context: Optional[SpanContext] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ) -> Optional[Span]:
        """A complete span from caller-supplied timestamps; ``context``
        records under a pre-minted identity, else a fresh child of
        ``parent`` is minted."""
        if not self.enabled:
            return None
        ctx = context if context is not None else self.new_context(parent)
        return self._push(Span(
            name=name, trace_id=ctx.trace_id, span_id=ctx.span_id,
            parent_id=parent.span_id if parent is not None else None,
            start=float(start), end=float(end), attrs=dict(attrs or {}),
        ))

    def event(
        self,
        name: str,
        at: float,
        parent: Optional[SpanContext] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ) -> Optional[Span]:
        """A zero-duration marker (a serve pool's steal moves)."""
        return self.record(name, at, at, parent=parent, attrs=attrs)

    @contextlib.contextmanager
    def span(
        self,
        name: str,
        parent: Optional[SpanContext] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ) -> Iterator[Optional[Span]]:
        """A synchronous scope, timed on the tracer's clock and recorded
        at exit even when the body raises."""
        if not self.enabled:
            yield None
            return
        ctx = self.new_context(parent)
        span = Span(
            name=name, trace_id=ctx.trace_id, span_id=ctx.span_id,
            parent_id=parent.span_id if parent is not None else None,
            start=self.clock(), end=0.0, attrs=dict(attrs or {}),
        )
        try:
            yield span
        finally:
            span.end = self.clock()
            self._push(span)

    def spans(
        self,
        trace_id: Optional[str] = None,
        limit: Optional[int] = None,
    ) -> List[Dict[str, Any]]:
        """A snapshot of the buffer (oldest first), optionally one trace's
        spans and/or the newest ``limit``."""
        with self._lock:
            out = [s.to_dict() for s in self._buffer]
        if trace_id is not None:
            out = [s for s in out if s["trace_id"] == trace_id]
        if limit is not None and limit >= 0:
            out = out[-limit:]
        return out

    def clear(self) -> None:
        with self._lock:
            self._buffer.clear()

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "recorded": self.recorded, "dropped": self.dropped,
                "buffered": len(self._buffer), "cap": self.cap,
            }


class _NullTracer(Tracer):
    """The ``RCA_TRACE=0`` path: the same surface, constant no-ops."""

    def __init__(self) -> None:
        super().__init__(enabled=False, cap=1, seed=0)


#: the shared disabled tracer
NULL_TRACER = _NullTracer()

_DEFAULT: Optional[Tracer] = None


def default_tracer() -> Tracer:
    """The process tracer: a real one when ``RCA_TRACE=1`` (buffer sized
    by ``RCA_TRACE_BUFFER``), else :data:`NULL_TRACER`; resolved once."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Tracer() if trace_enabled() else NULL_TRACER
    return _DEFAULT


def set_default_tracer(tracer: Optional[Tracer]) -> None:
    """Override the process tracer (None: resolve it from the environment
    again on next use)."""
    global _DEFAULT
    _DEFAULT = tracer


_PROFILING = False


def profiling_active() -> bool:
    """Whether a ``profile`` capture is in progress: device annotations
    engage only then (``record_function`` is cheap but not free, and
    outside a capture there is no trace to annotate)."""
    return _PROFILING


def set_profiling(active: bool) -> None:
    """Mark a profile as being taken: device annotations engage only
    then."""
    global _PROFILING
    _PROFILING = bool(active)


def device_annotation(name: str):
    """A ``torch.profiler.record_function`` naming the host scope that
    issues device work, so the profiler's timeline lines up under the
    tick spans; a no-op context outside a profile."""
    if not _PROFILING:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)
