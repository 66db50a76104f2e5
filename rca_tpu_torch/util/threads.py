"""The one place the port constructs threads and locks (the port's copy of
``rca_tpu.util.threads``, without the runtime lock sanitizer's hook).

Every lock is named for the attribute that owns it
(``make_lock("Retry._lock")``) and every thread has a name and an explicit
daemon flag, so a stack dump attributes each of them.  The constructors
return the bare ``threading`` primitives.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Iterable, Optional


def make_lock(name: str) -> Any:
    """A mutex named for the attribute that owns it (``"Class._lock"``)."""
    del name  # the name documents the owner; the lock is the plain one
    return threading.Lock()


def make_condition(name: str, lock: Optional[Any] = None) -> Any:
    """A condition variable (its internal mutex counts as the lock the
    name identifies — ``with cond:`` is an acquire of it)."""
    del name
    return threading.Condition(lock)


def make_thread(
    target: Callable[..., None],
    *,
    name: str,
    daemon: bool,
    args: Iterable[Any] = (),
) -> threading.Thread:
    """A NOT-yet-started thread.  ``name`` and ``daemon`` are mandatory:
    an anonymous thread is invisible to every stack dump, and an implicit
    daemon flag is how shutdown hangs are born."""
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
