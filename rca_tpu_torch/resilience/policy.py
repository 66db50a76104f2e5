"""The fault log, the retry counter, the retry/deadline policies and the
circuit breaker: the port's copy of ``rca_tpu.resilience.policy``, which
the live session, the live-cluster client, its watch pumps and the serving
scheduler use.

- :func:`suppressed` is the one sanctioned way to swallow an exception:
  the fault is recorded into the bounded module fault log, which each
  tick's health record drains (:func:`drain_faults`);
- :func:`record_fault` records a fault that a caller handled itself;
- :func:`retry_counter` reads the process-wide count of retries spent,
  which the health record reports per tick as a delta;
- :class:`Retry` (exponential backoff, jitter drawn from the policy's own
  seeded generator, injectable ``sleep`` and ``clock``) and
  :class:`Deadline` (a monotonic budget shared by the steps of one
  operation) guard the live client's API calls and the pumps' streams;
- :class:`CircuitBreaker` (closed → open → half-open) gates the serving
  scheduler's device path, and :class:`CircuitOpen` is what its
  :meth:`CircuitBreaker.call` raises while it is open.
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Type

from rca_tpu_torch.util.threads import make_lock

FAULT_LOG_CAP = 256


class PolicyError(RuntimeError):
    """Base class for policy-raised failures."""


class DeadlineExceeded(PolicyError):
    """The operation's time budget ran out (possibly mid-retry)."""


class CircuitOpen(PolicyError):
    """The breaker is open: the protected operation was not attempted."""


class _FaultLog:
    """Bounded, thread-safe record of deliberately-swallowed faults."""

    def __init__(self, cap: int = FAULT_LOG_CAP):
        self._lock = make_lock("_FaultLog._lock")
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
        self._lock = make_lock("Counter._lock")
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


@dataclasses.dataclass
class Deadline:
    """A monotonic time budget shared by the steps of one operation."""

    budget_s: float
    clock: Callable[[], float] = time.monotonic
    _started: Optional[float] = None

    def __post_init__(self) -> None:
        if self._started is None:
            self._started = self.clock()

    @classmethod
    def after(cls, seconds: float,
              clock: Callable[[], float] = time.monotonic) -> "Deadline":
        return cls(budget_s=seconds, clock=clock)

    def remaining(self) -> float:
        return self.budget_s - (self.clock() - self._started)

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def check(self, op: str = "operation") -> None:
        if self.expired:
            raise DeadlineExceeded(
                f"{op}: deadline of {self.budget_s:.3f}s exceeded"
            )


@dataclasses.dataclass
class Retry:
    """Exponential backoff + jitter.  ``attempts`` counts RE-tries: the
    first call is free, so ``attempts=2`` means at most 3 invocations.

    The jitter draws from the policy's own generator,
    ``random.Random(seed)``, never the process-global one, so a seeded
    policy is reproducible; ``sleep``/``clock`` are injectable so a test
    never waits wall time."""

    attempts: int = 2
    base_delay: float = 0.1
    max_delay: float = 5.0
    jitter: float = 0.25               # fraction of the delay randomized
    retry_on: Tuple[Type[BaseException], ...] = (Exception,)
    sleep: Callable[[float], None] = time.sleep
    clock: Callable[[], float] = time.monotonic
    seed: Optional[int] = None

    def __post_init__(self) -> None:
        self._rng = random.Random(self.seed)
        # one policy is shared across threads (the watch pump set hands
        # one instance to both pump threads): the counter and the jitter
        # draw sit under a lock
        self._lock = make_lock("Retry._lock")
        self.retries_spent = 0  # instance-lifetime count

    def delay(self, attempt: int) -> float:
        """Backoff before re-try number ``attempt`` (1-based)."""
        d = min(self.base_delay * (2.0 ** (attempt - 1)), self.max_delay)
        if self.jitter:
            with self._lock:
                jitter_draw = self._rng.random()
            d *= 1.0 + self.jitter * (2.0 * jitter_draw - 1.0)
        return max(d, 0.0)

    def sleep_for(self, attempt: int) -> None:
        with self._lock:
            self.retries_spent += 1
        RETRIES.add(1)
        self.sleep(self.delay(attempt))

    def call(
        self,
        fn: Callable[..., Any],
        *args: Any,
        deadline: Optional[Deadline] = None,
        on_retry: Optional[Callable[[int, BaseException], None]] = None,
        **kwargs: Any,
    ) -> Any:
        """``fn(*args, **kwargs)`` with up to ``attempts`` re-tries.

        A ``deadline`` bounds the WHOLE call including backoff sleeps:
        when the budget cannot cover the next delay the original failure
        is re-raised chained under :class:`DeadlineExceeded`."""
        attempt = 0
        while True:
            if deadline is not None:
                deadline.check(getattr(fn, "__name__", "call"))
            try:
                return fn(*args, **kwargs)
            except self.retry_on as exc:
                if attempt >= self.attempts:
                    raise
                attempt += 1
                if deadline is not None and (
                    deadline.remaining() <= self.delay(attempt)
                ):
                    raise DeadlineExceeded(
                        f"{getattr(fn, '__name__', 'call')}: budget cannot "
                        f"cover retry {attempt}"
                    ) from exc
                if on_retry is not None:
                    on_retry(attempt, exc)
                self.sleep_for(attempt)


class CircuitBreaker:
    """Classic closed → open → half-open breaker.

    ``failure_threshold`` consecutive failures open the circuit; after
    ``reset_after`` seconds one probe call is allowed (half-open) — its
    success closes the circuit, its failure re-opens it for another full
    window.  ``allow()`` is the gate callers check before attempting the
    protected operation; it consumes the half-open probe slot."""

    def __init__(
        self,
        failure_threshold: int = 2,
        reset_after: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
        name: str = "",
    ):
        self.failure_threshold = max(1, int(failure_threshold))
        self.reset_after = float(reset_after)
        self.clock = clock
        self.name = name
        self._lock = make_lock("CircuitBreaker._lock")
        self._failures = 0
        self._opened_at: Optional[float] = None
        self._half_open = False

    @property
    def state(self) -> str:
        with self._lock:
            if self._opened_at is None:
                return "closed"
            if self._half_open:
                return "half-open"
            if self.clock() - self._opened_at >= self.reset_after:
                return "half-open"
            return "open"

    def allow(self) -> bool:
        """May the caller attempt the protected operation right now?"""
        with self._lock:
            if self._opened_at is None:
                return True
            if self._half_open:
                # one probe is already in flight; hold further callers
                return False
            if self.clock() - self._opened_at >= self.reset_after:
                self._half_open = True  # this caller is the probe
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._opened_at = None
            self._half_open = False

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._half_open or self._failures >= self.failure_threshold:
                self._opened_at = self.clock()
                self._half_open = False

    def call(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> Any:
        """Gate + execute + record in one step."""
        if not self.allow():
            raise CircuitOpen(
                f"circuit {self.name or getattr(fn, '__name__', '?')} is open"
            )
        try:
            out = fn(*args, **kwargs)
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return out
