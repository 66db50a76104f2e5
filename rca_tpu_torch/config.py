"""The engine's configuration: the subset of ``rca_tpu.config`` that the
one-shot engine reads, kept as the port's own copy so that the port loads
nothing of the JAX package.

Copied semantics: :class:`RCAConfig`'s engine knobs, the shape-bucket rule
:func:`bucket_for`, and the free-form env accessor :func:`env_raw`
(``RCA_WEIGHTS``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


def env_raw(name: str, default: Optional[str] = None) -> Optional[str]:
    """A free-form env value (path): pass-through with no validation
    beyond centralizing the read.  None when unset."""
    value = os.environ.get(name)
    return default if value is None else value


@dataclasses.dataclass(frozen=True)
class RCAConfig:
    # propagation iterations (graph-diameter cap) and ranked-output length
    propagation_steps: int = 8
    top_k_root_causes: int = 5
    # Shape-bucket tiers for padded node AND edge counts: explicit
    # power-of-two tiers up to 4096; above, sizes round up to 8 sub-tiers
    # per octave (bucket_for), capping padding waste at 12.5%.
    shape_buckets: tuple = (64, 128, 256, 512, 1024, 2048, 4096)


def bucket_for(n: int, buckets) -> int:
    """Smallest shape bucket >= n.

    Within ``buckets``: the explicit tier list.  Beyond it: round up to the
    next multiple of an eighth of n's power-of-two octave."""
    for b in buckets:
        if n <= b:
            return b
    n = int(n)
    quantum = max(1 << (n.bit_length() - 1), 8) // 8
    return ((n + quantum - 1) // quantum) * quantum
