"""Propagation parameters and the checkpoint they load from.

The port's copy of ``PropagationParams``/``default_params`` (from the JAX
package's ``engine/propagate.py``), the JSON checkpoint loader and the
packaged default checkpoint (``engine/train.py``), ``resolve_params``
(``engine/runner.py``), and the bridges from the JAX package's values:
:func:`params_from_jax` (its params) and :func:`raw_from_jax` (its
trainer's raw values).  ``default_weights.json`` here is a byte copy of
the JAX package's shipped artifact, so both engines answer with the same
weights by default.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from rca_tpu_torch.config import RCAConfig, env_raw
from rca_tpu_torch.features.schema import NUM_SERVICE_FEATURES, SvcF

# Bumped whenever the scoring semantics change; v3 = degree-normalized
# impact mean.  A checkpoint fitted against another version mis-ranks.
SCORE_FORMULA_VERSION = 3

PACKAGED_WEIGHTS = Path(__file__).with_name("default_weights.json")


@dataclasses.dataclass(frozen=True)
class PropagationParams:
    anomaly_weights: tuple       # per-channel weights for a
    hard_weights: tuple          # per-channel weights for h
    steps: int = 8               # propagation iterations (graph diameter cap)
    decay: float = 0.7           # per-hop decay
    explain_strength: float = 0.85  # suppression by an anomalous upstream
    impact_bonus: float = 1.6    # downstream-impact bonus
    error_contrast: float = 0.7  # weight of the error-source contrast

    def weight_arrays(self):
        """The two weight vectors as float32 numpy arrays."""
        return (
            np.asarray(self.anomaly_weights, dtype=np.float32),
            np.asarray(self.hard_weights, dtype=np.float32),
        )


def default_params(steps: int = 8) -> PropagationParams:
    """The hand-set weights (``RCA_WEIGHTS=off``)."""
    aw = np.zeros(NUM_SERVICE_FEATURES, dtype=np.float32)
    aw[SvcF.CRASH] = 1.0
    aw[SvcF.ERROR_RATE] = 0.4
    aw[SvcF.LATENCY] = 0.3
    aw[SvcF.RESTARTS] = 0.6
    aw[SvcF.EVENTS] = 0.4
    aw[SvcF.LOG_ERRORS] = 0.5
    aw[SvcF.NOT_READY] = 0.6
    aw[SvcF.RESOURCE] = 0.5
    aw[SvcF.IMAGE] = 0.9
    aw[SvcF.CONFIG] = 0.9
    aw[SvcF.PENDING] = 0.7
    aw[SvcF.OOM] = 0.95
    aw[SvcF.SILENT] = 0.6
    hw = np.zeros(NUM_SERVICE_FEATURES, dtype=np.float32)
    hw[SvcF.CRASH] = 1.0
    hw[SvcF.IMAGE] = 0.9
    hw[SvcF.CONFIG] = 0.9
    hw[SvcF.PENDING] = 0.6
    hw[SvcF.OOM] = 0.95
    hw[SvcF.RESTARTS] = 0.4
    hw[SvcF.NOT_READY] = 0.5
    hw[SvcF.SILENT] = 0.6
    return PropagationParams(
        anomaly_weights=tuple(float(x) for x in aw),
        hard_weights=tuple(float(x) for x in hw),
        steps=steps,
    )


def _require_formula_version(version: int, path: str) -> None:
    if version != SCORE_FORMULA_VERSION:
        raise ValueError(
            f"checkpoint {path} was trained against score formula "
            f"v{version}, but this engine computes v{SCORE_FORMULA_VERSION} "
            "— weights fitted to a different objective mis-rank silently"
        )


def load_params_json(path: str) -> PropagationParams:
    """Load a single-file JSON checkpoint (``rca-weights-v1``)."""
    with open(path) as f:
        data = json.load(f)
    _require_formula_version(int(data.get("formula_version", 1)), path)
    n = NUM_SERVICE_FEATURES
    short = min(len(data["anomaly_weights"]), len(data["hard_weights"]))
    if short < n:
        raise ValueError(
            f"checkpoint {path} carries {short} weight channels but this "
            f"engine's feature schema has {n}"
        )
    return PropagationParams(
        anomaly_weights=tuple(float(x) for x in data["anomaly_weights"][:n]),
        hard_weights=tuple(float(x) for x in data["hard_weights"][:n]),
        steps=int(data["steps"]),
        decay=float(data["decay"]),
        explain_strength=float(data["explain_strength"]),
        impact_bonus=float(data["impact_bonus"]),
    )


def packaged_params() -> Optional[PropagationParams]:
    """The committed default checkpoint, or None when it is absent."""
    if PACKAGED_WEIGHTS.exists():
        return load_params_json(str(PACKAGED_WEIGHTS))
    return None


def resolve_params(
    config: RCAConfig, params: Optional[PropagationParams]
) -> PropagationParams:
    """Weight resolution: explicit params > ``RCA_WEIGHTS`` checkpoint
    (a JSON file) > the packaged checkpoint > hand-set defaults.
    ``RCA_WEIGHTS=off`` (also ``none``/``defaults``) selects the hand-set
    defaults.  ``config.propagation_steps`` governs the depth in every
    case: steps is a runtime diameter cap, not a fitted weight."""
    if params is None:
        ckpt = env_raw("RCA_WEIGHTS")
        if ckpt and ckpt.lower() in ("off", "none", "defaults"):
            return default_params(config.propagation_steps)
        params = load_params_json(ckpt) if ckpt else packaged_params()
        if params is not None and params.steps != config.propagation_steps:
            params = dataclasses.replace(
                params, steps=config.propagation_steps
            )
    return params or default_params(config.propagation_steps)


def params_from_jax(
    anomaly_weights: Sequence[float],
    hard_weights: Sequence[float],
    steps: int,
    decay: float,
    explain_strength: float,
    impact_bonus: float,
    error_contrast: float,
) -> PropagationParams:
    """The port's params from the JAX package's, passed as numpy arrays
    and plain scalars (so this module needs nothing of that package):
    both engines then compute the same function of the same inputs."""
    return PropagationParams(
        anomaly_weights=tuple(float(x) for x in np.asarray(anomaly_weights)),
        hard_weights=tuple(float(x) for x in np.asarray(hard_weights)),
        steps=int(steps),
        decay=float(decay),
        explain_strength=float(explain_strength),
        impact_bonus=float(impact_bonus),
        error_contrast=float(error_contrast),
    )


RAW_KEYS = ("aw", "hw", "decay", "mu", "beta")


def raw_from_jax(tree, device="cpu"):
    """The port's raw training values (``engine/train.py``) from the JAX
    package's raw pytree, passed as numpy arrays (``aw``, ``hw``,
    ``decay``, ``mu``, ``beta``): float32 tensors on ``device`` with the
    same bits, so both trainers start from the same values."""
    import torch

    return {key: torch.from_numpy(np.array(np.asarray(tree[key]),
                                           dtype=np.float32)).to(device)
            for key in RAW_KEYS}
