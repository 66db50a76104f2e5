"""The port's one-shot root-cause engine (PyTorch, CUDA kernels)."""

from rca_tpu_torch.engine.params import (
    PropagationParams,
    default_params,
    params_from_jax,
    resolve_params,
)
from rca_tpu_torch.engine.runner import EngineAPI, EngineResult, GraphEngine

__all__ = [
    "EngineAPI",
    "EngineResult",
    "GraphEngine",
    "PropagationParams",
    "default_params",
    "params_from_jax",
    "resolve_params",
]
