"""ReplaySource: a cluster client served entirely from a recording.

The port's copy of ``rca_tpu.replay.source``.  It satisfies the same
duck-typed client protocol the live and mock clients do, but every method
call is answered from the recording's ``call`` frames for the CURRENT tick
(the harness advances the tick cursor before each ``poll()``).  Recorded
exceptions re-raise with equivalent types, so a replayed chaos soak takes
the same retry, degrade and resync paths the live run did.

Lookup is keyed, not blindly positional: within a tick, calls consume the
first unconsumed record matching ``(method, args)``, so a divergence is
loud and attributable (:class:`ReplayMismatch` names the tick, method and
arguments).  A repeat of an already-consumed key within the same tick
re-serves the last value (idempotent reads); a key the tick never recorded
is a hard mismatch.

Presence semantics matter: ``hasattr(client, "collect_errors")`` and
``getattr(client, "drain_injected", None)`` gate real control flow in the
session, so :meth:`__getattr__` raises ``AttributeError`` for any method
the recording never saw.  ``get_columnar`` is advertised only when the
recording holds ``coldiff`` frames, so a dict-capture recording replays on
the dict path.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, List, Tuple

from rca_tpu_torch.replay.format import make_call_key, restore_ndarrays
from rca_tpu_torch.resilience.chaos import InjectedTimeout


class ReplayMismatch(RuntimeError):
    """The replayed session asked the cluster something the recording
    cannot answer: the replay diverged at the CAPTURE level (before any
    engine math), which almost always means the session's construction
    knobs differ from the header's."""


class ReplayedFault(RuntimeError):
    """Stand-in for a recorded exception type this build does not
    reconstruct exactly; carries the original type name."""


def _rebuild_error(error_type: str, error_msg: str) -> Exception:
    if error_type == "InjectedTimeout":
        return InjectedTimeout(error_msg)
    if "Timeout" in error_type:
        return TimeoutError(error_msg)
    return ReplayedFault(f"{error_type}: {error_msg}")


class ReplaySource:
    """Replay client over parsed ``call`` frames (see replayer.py for the
    full-recording loader).  Drive with :meth:`advance` per tick."""

    def __init__(self, call_frames: List[Dict[str, Any]]):
        # tick -> (method, key) -> FIFO of call records
        by_tick: Dict[int, Dict[Tuple[str, str], collections.deque]] = {}
        methods = set()
        for fr in call_frames:
            methods.add(fr["method"])
            if fr.get("kind") == "coldiff" and fr.get("ok"):
                # column-diff frames carry tagged raw-byte array
                # encodings: restore them once at load, so the replayed
                # mirror sees bit-identical numpy columns
                fr = dict(fr)
                fr["result"] = restore_ndarrays(fr["result"])
            bucket = by_tick.setdefault(int(fr["tick"]), {})
            bucket.setdefault(
                (fr["method"], fr["key"]), collections.deque()
            ).append(fr)
        self._by_tick = by_tick
        self._methods = methods
        self._tick = 0
        # last consumed record per (method, key), reset per tick: repeat
        # reads within one tick re-serve; across ticks they must re-match
        self._served: Dict[Tuple[str, str], Dict[str, Any]] = {}

    # -- harness surface ----------------------------------------------------
    def advance(self, tick: int) -> None:
        self._tick = int(tick)
        self._served = {}

    def unconsumed(self) -> int:
        """Recorded calls of the current tick the session never made:
        nonzero means the replayed session took a DIFFERENT capture path
        (divergence evidence even when the rankings happen to agree)."""
        return sum(
            len(dq) for dq in self._by_tick.get(self._tick, {}).values()
        )

    # -- client surface -----------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name.startswith("_") or name not in self._methods:
            raise AttributeError(name)

        def replayed(*args: Any, **kwargs: Any) -> Any:
            return self._consume(name, make_call_key(args, kwargs))

        replayed.__name__ = name
        return replayed

    def _consume(self, method: str, key: str) -> Any:
        bucket = self._by_tick.get(self._tick, {})
        dq = bucket.get((method, key))
        if dq:
            rec = dq.popleft()
            self._served[(method, key)] = rec
        else:
            rec = self._served.get((method, key))
            if rec is None:
                raise ReplayMismatch(
                    f"tick {self._tick}: {method}({key}) has no recorded "
                    "answer — replayed session diverged from the capture "
                    "path (check pipeline_depth/topology_check_every "
                    "against the recording header)"
                )
        if rec["ok"]:
            return rec["result"]
        raise _rebuild_error(rec["error_type"], rec["error_msg"])
