"""The one place the port constructs threads and locks (the port's copy of
``rca_tpu.util.threads``).

Every thread and every lock in the package is built here, for three
reasons the gravelock analyzer (``rca_tpu_torch/analysis/concurrency``)
depends on:

- **named, attributable primitives**: ``make_lock("ServeMetrics._lock")``
  carries the same ``Class.attr`` identity the static concurrency model
  uses for its lock-order graph, so a runtime observation and a static
  edge talk about the same object;
- **reliable thread-root discovery**: ``spawn(...)``/``make_thread(...)``
  call sites (plus ``threading.Thread`` subclasses) are the complete set
  of thread entry points; every thread is named and its daemon flag is
  explicit, never defaulted;
- **the rsan seam**: when the runtime lock sanitizer is enabled
  (``RCA_RSAN=1`` or
  :func:`rca_tpu_torch.analysis.concurrency.rsan.enable`), the
  constructors return :class:`SanitizedLock`-family shims that record
  actual acquisition orders for the static model's cross-check.  When it
  is off (the default), these functions return the bare ``threading``
  primitives — zero wrappers, zero per-acquire cost, and nothing of the
  analysis package imported.

The graftlint rule ``thread-discipline`` (rules/threads.py) makes raw
``threading.Thread(...)`` / ``threading.Lock()`` construction outside
this module unlandable, so the seam cannot silently erode.
"""

from __future__ import annotations

import sys
import threading
from typing import Any, Callable, Iterable, Optional

_RSAN_MODULE = "rca_tpu_torch.analysis.concurrency.rsan"


def _rsan_on() -> bool:
    """Is the runtime lock sanitizer active?  Cheap when off: the rsan
    module is imported only after something enabled it (env or API)."""
    mod = sys.modules.get(_RSAN_MODULE)
    if mod is not None:
        return bool(mod.enabled())
    from rca_tpu_torch.config import rsan_enabled

    if not rsan_enabled():
        return False
    from rca_tpu_torch.analysis.concurrency import rsan

    return bool(rsan.enabled())


def make_lock(name: str) -> Any:
    """A mutex named for the attribute that owns it (``"Class._lock"``)."""
    if _rsan_on():
        from rca_tpu_torch.analysis.concurrency import rsan

        return rsan.SanitizedLock(name)
    return threading.Lock()


def make_rlock(name: str) -> Any:
    """A reentrant mutex, named as :func:`make_lock`'s."""
    if _rsan_on():
        from rca_tpu_torch.analysis.concurrency import rsan

        return rsan.SanitizedLock(name, reentrant=True)
    return threading.RLock()


def make_condition(name: str, lock: Optional[Any] = None) -> Any:
    """A condition variable (its internal mutex counts as the lock the
    name identifies — ``with cond:`` is an acquire of it)."""
    if _rsan_on():
        from rca_tpu_torch.analysis.concurrency import rsan

        return rsan.SanitizedCondition(name, lock=lock)
    return threading.Condition(lock)


def make_thread(
    target: Callable[..., None],
    *,
    name: str,
    daemon: bool,
    args: Iterable[Any] = (),
) -> threading.Thread:
    """A NOT-yet-started thread.  ``name`` and ``daemon`` are mandatory:
    an anonymous thread is invisible to the analyzer's root discovery and
    to every stack dump, and an implicit daemon flag is how shutdown
    hangs are born."""
    return threading.Thread(
        target=target, name=name, daemon=daemon, args=tuple(args)
    )


def spawn(
    target: Callable[..., None],
    *,
    name: str,
    daemon: bool = True,
    args: Iterable[Any] = (),
) -> threading.Thread:
    """``make_thread`` + ``start()`` — the common case."""
    t = make_thread(target, name=name, daemon=daemon, args=args)
    t.start()
    return t
