"""The fault log and the retry counter behind the live session's health
record: the port's copy of the part of ``rca_tpu.resilience.policy`` that
the live session uses (``Retry``, ``Deadline`` and ``CircuitBreaker``
come with the modules that use them).

- :func:`suppressed` is the one sanctioned way to swallow an exception:
  the fault is recorded into the bounded module fault log, which each
  tick's health record drains (:func:`drain_faults`);
- :func:`record_fault` records a fault that a caller handled itself;
- :func:`retry_counter` reads the process-wide count of retries spent,
  which the health record reports per tick as a delta.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Tuple, Type

FAULT_LOG_CAP = 256


class _FaultLog:
    """Bounded, thread-safe record of deliberately-swallowed faults."""

    def __init__(self, cap: int = FAULT_LOG_CAP):
        self._lock = threading.Lock()
        self._cap = cap
        self._entries: List[Dict[str, str]] = []

    def record(self, op: str, error: BaseException | str) -> None:
        detail = (
            f"{type(error).__name__}: {error}"
            if isinstance(error, BaseException) else str(error)
        )
        with self._lock:
            if len(self._entries) < self._cap:
                self._entries.append({"op": op, "error": detail[:300]})

    def drain(self, clear: bool = True) -> List[Dict[str, str]]:
        with self._lock:
            out = list(self._entries)
            if clear:
                self._entries.clear()
            return out


FAULTS = _FaultLog()


def record_fault(op: str, error: BaseException | str) -> None:
    """Record a swallowed/handled fault into the module fault log."""
    FAULTS.record(op, error)


def drain_faults(clear: bool = True) -> List[Dict[str, str]]:
    """Swallowed faults since the last drain (health-record channel)."""
    return FAULTS.drain(clear)


@contextlib.contextmanager
def suppressed(op: str, reraise: Tuple[Type[BaseException], ...] = ()):
    """Swallow an ``Exception`` raised in the block, recording it into the
    fault log; ``reraise`` exempts types that must propagate."""
    try:
        yield
    except reraise:
        raise
    except Exception as exc:
        FAULTS.record(op, exc)


class Counter:
    """Thread-safe monotonic counter."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


#: process-wide count of retry sleeps spent; the live session reports
#: per-tick deltas in its health record
RETRIES = Counter()


def retry_counter() -> int:
    """Process-wide retries spent so far (for health-record deltas)."""
    return RETRIES.value
