"""rsan: the runtime lock sanitizer (gravelock's dynamic half; the port's
copy of ``rca_tpu.analysis.concurrency.rsan``).

When enabled (``RCA_RSAN=1`` or :func:`enable`), the constructors in
:mod:`rca_tpu_torch.util.threads` return :class:`SanitizedLock` /
:class:`SanitizedCondition` shims instead of bare ``threading``
primitives.  A shim behaves exactly like the primitive it wraps and
additionally records, into one bounded process-wide :class:`RsanRecorder`:

- **acquisition-order edges**: acquiring lock B while holding lock A
  records the edge ``A -> B`` (per thread, via a thread-local held
  stack).  Locks are identified by the ``"Class.attr"`` names their
  construction sites pass, which are the SAME identities the static
  model uses — so :mod:`crosscheck` can diff observed orders against the
  static lock-order graph directly;
- **same-attribute access pairs**: :func:`note_access` stamps an access
  to ``owner.attr`` with the caller's thread and currently-held lock
  set.  Two writes from different threads with disjoint held sets are an
  *observed* race (the Eraser lockset discipline, run live) — the
  concurrency stress tests and the chaos soak run with rsan on so the
  static findings are validated against real executions.

Zero-cost when off: ``util.threads`` returns bare primitives, nothing
here is imported, and no per-acquire work exists anywhere.  The recorder
itself uses a raw ``threading.Lock`` — the sanitizer cannot sanitize
itself (``thread-discipline`` exempts this module).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, FrozenSet, List, Optional, Set, Tuple

#: bounded-state caps: rsan runs inside stress tests and soaks, never
#: accumulates beyond these whatever the workload does
MAX_EDGES = 4096
MAX_ACCESS_KEYS = 1024
MAX_SAMPLES_PER_KEY = 128

_ENABLED: Optional[bool] = None
_STATE_LOCK = threading.Lock()


def enabled() -> bool:
    """Is the sanitizer on?  Lazily seeded from ``RCA_RSAN`` on first
    ask; :func:`enable`/:func:`disable` override for tests."""
    global _ENABLED
    if _ENABLED is None:
        with _STATE_LOCK:
            if _ENABLED is None:
                from rca_tpu_torch.config import rsan_enabled

                _ENABLED = rsan_enabled()
    return _ENABLED


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


class _Held(threading.local):
    def __init__(self) -> None:
        self.stack: List[str] = []


_HELD = _Held()


def held_locks() -> Tuple[str, ...]:
    """Names of the sanitized locks the CURRENT thread holds, outermost
    first (other threads' holds are invisible by design)."""
    return tuple(_HELD.stack)


class RsanRecorder:
    """Bounded process-wide record of observed orders and access pairs."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # (outer, inner) -> {count, threads, chain} ; chain is the held
        # stack at first observation (the acquire chain evidence)
        self._edges: Dict[Tuple[str, str], Dict[str, Any]] = {}
        # lock name -> thread names that ever acquired it
        self._lock_threads: Dict[str, Set[str]] = {}
        # (owner, attr) -> [(thread, kind, frozenset(held))]
        self._accesses: Dict[
            Tuple[str, str], List[Tuple[str, str, FrozenSet[str]]]
        ] = {}
        self.acquires = 0

    # -- recording (called from the shims) ----------------------------------
    def note_acquire(self, name: str, held: List[str]) -> None:
        thread = threading.current_thread().name
        with self._lock:
            self.acquires += 1
            self._lock_threads.setdefault(name, set()).add(thread)
            for outer in held:
                if outer == name:
                    continue  # reentrant re-acquire, not an order edge
                key = (outer, name)
                rec = self._edges.get(key)
                if rec is not None:
                    rec["count"] += 1
                    rec["threads"].add(thread)
                elif len(self._edges) < MAX_EDGES:
                    self._edges[key] = {
                        "count": 1,
                        "threads": {thread},
                        "chain": list(held) + [name],
                    }

    def note_access(self, owner: str, attr: str, kind: str,
                    held: List[str]) -> None:
        thread = threading.current_thread().name
        key = (owner, attr)
        with self._lock:
            samples = self._accesses.get(key)
            if samples is None:
                if len(self._accesses) >= MAX_ACCESS_KEYS:
                    return
                samples = self._accesses[key] = []
            if len(samples) < MAX_SAMPLES_PER_KEY:
                samples.append((thread, kind, frozenset(held)))

    # -- analysis ------------------------------------------------------------
    def order_edges(self) -> Dict[Tuple[str, str], Dict[str, Any]]:
        with self._lock:
            return {
                k: {"count": v["count"], "threads": sorted(v["threads"]),
                    "chain": list(v["chain"])}
                for k, v in self._edges.items()
            }

    def lock_threads(self) -> Dict[str, List[str]]:
        with self._lock:
            return {k: sorted(v) for k, v in self._lock_threads.items()}

    def races_observed(self) -> List[Dict[str, Any]]:
        """Eraser over the recorded access pairs: two accesses to the
        same ``owner.attr`` from different threads, at least one a write,
        with DISJOINT held-lock sets."""
        with self._lock:
            items = {k: list(v) for k, v in self._accesses.items()}
        out: List[Dict[str, Any]] = []
        for (owner, attr), samples in sorted(items.items()):
            for i, (t1, k1, h1) in enumerate(samples):
                hit = None
                for t2, k2, h2 in samples[i + 1:]:
                    if t1 == t2:
                        continue
                    if "write" not in (k1, k2):
                        continue
                    if h1 & h2:
                        continue
                    hit = {
                        "owner": owner, "attr": attr,
                        "threads": sorted((t1, t2)),
                        "locksets": [sorted(h1), sorted(h2)],
                    }
                    break
                if hit is not None:
                    out.append(hit)
                    break
        return out

    def reset(self) -> None:
        with self._lock:
            self._edges.clear()
            self._lock_threads.clear()
            self._accesses.clear()
            self.acquires = 0


RSAN = RsanRecorder()


def note_access(owner: str, attr: str, kind: str = "write") -> None:
    """Stamp one shared-state access with the caller's thread + held
    sanitized locks.  No-op when the sanitizer is off — safe to call from
    stress harnesses unconditionally."""
    if enabled():
        RSAN.note_access(owner, attr, kind, _HELD.stack)


class SanitizedLock:
    """Drop-in ``threading.Lock``/``RLock`` that records acquisitions."""

    def __init__(self, name: str, reentrant: bool = False):
        self.name = name
        self._reentrant = reentrant
        self._lock = threading.RLock() if reentrant else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            if enabled():
                RSAN.note_acquire(self.name, _HELD.stack)
            _HELD.stack.append(self.name)
        return ok

    def release(self) -> None:
        # pop the innermost matching hold (reentrant locks stack dupes)
        stack = _HELD.stack
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == self.name:
                del stack[i]
                break
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "SanitizedLock":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"SanitizedLock({self.name!r})"


class SanitizedCondition:
    """Drop-in ``threading.Condition`` over a :class:`SanitizedLock`.

    ``wait()`` releases the lock for the duration of the park and
    re-records the re-acquisition — exactly the window where a second
    thread's acquires interleave, which is what the order record needs to
    see."""

    def __init__(self, name: str, lock: Optional[Any] = None):
        self.name = name
        self._cond = threading.Condition(
            getattr(lock, "_lock", lock)  # unwrap a SanitizedLock mutex
        )

    def acquire(self, *args: Any) -> bool:
        ok = self._cond.acquire(*args)
        if ok:
            if enabled():
                RSAN.note_acquire(self.name, _HELD.stack)
            _HELD.stack.append(self.name)
        return ok

    def release(self) -> None:
        stack = _HELD.stack
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == self.name:
                del stack[i]
                break
        self._cond.release()

    def __enter__(self) -> "SanitizedCondition":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        stack = _HELD.stack
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == self.name:
                del stack[i]
                break
        try:
            return self._cond.wait(timeout)
        finally:
            if enabled():
                RSAN.note_acquire(self.name, _HELD.stack)
            _HELD.stack.append(self.name)

    def wait_for(self, predicate: Any, timeout: Optional[float] = None):
        # mirrors threading.Condition.wait_for over OUR wait (so the
        # held-stack bookkeeping stays balanced)
        import time as _time

        endtime = None
        result = predicate()
        while not result:
            if timeout is not None:
                if endtime is None:
                    endtime = _time.monotonic() + timeout
                waittime = endtime - _time.monotonic()
                if waittime <= 0:
                    break
                self.wait(waittime)
            else:
                self.wait(None)
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()

    def __repr__(self) -> str:
        return f"SanitizedCondition({self.name!r})"
