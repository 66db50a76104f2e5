"""The serving scheduler's seeded fault injector: the port's copy of
``seeded_fault_hook`` and ``InjectedTimeout`` from
``rca_tpu.resilience.chaos`` (the chaos cluster client and the soak
harness come with record/replay).

``python -m rca_tpu_torch serve --selftest --chaos`` wires the hook into
the batch dispatcher: a fault it raises takes the serve loop's breaker and
degraded-response path, and the response says so (``degraded`` with the
last-known ranking, or ``error``).
"""

from __future__ import annotations

import random
from typing import Callable, List, Optional


class InjectedTimeout(TimeoutError):
    """A chaos-injected timeout (distinguishable from real ones)."""


def seeded_fault_hook(
    seed: int,
    rate: float = 0.1,
    ops: Optional[List[str]] = None,
) -> Callable[[str], None]:
    """Seeded fault injector for the serving dispatcher: called with the
    op name (``"dispatch"`` / ``"fetch"``) before the device work; raises
    :class:`InjectedTimeout` at ``rate`` per call from one seeded stream,
    so a (seed, call-sequence) pair replays the exact same fault schedule.
    ``ops`` restricts injection to those call sites (default: all)."""
    rng = random.Random(seed)

    def hook(op: str) -> None:
        if ops is not None and op not in ops:
            return
        if rng.random() < rate:
            raise InjectedTimeout(f"chaos: injected fault in serve {op}")

    return hook
