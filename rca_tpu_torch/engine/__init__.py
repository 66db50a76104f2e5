"""The port's root-cause engine (PyTorch, CUDA kernels): one-shot and
resident analysis, streaming ticks and the live session, on one device or
node-sharded over a device mesh."""

from rca_tpu_torch.engine.live import LiveStreamingSession
from rca_tpu_torch.engine.params import (
    PropagationParams,
    default_params,
    params_from_jax,
    resolve_params,
)
from rca_tpu_torch.engine.resident import ResidentCache
from rca_tpu_torch.engine.runner import EngineAPI, EngineResult, GraphEngine
from rca_tpu_torch.engine.sharded_runner import (
    ShardConfigError,
    ShardedGraphEngine,
    make_engine,
)
from rca_tpu_torch.engine.streaming import StreamingSession

__all__ = [
    "EngineAPI",
    "EngineResult",
    "GraphEngine",
    "LiveStreamingSession",
    "PropagationParams",
    "ResidentCache",
    "ShardConfigError",
    "ShardedGraphEngine",
    "StreamingSession",
    "default_params",
    "make_engine",
    "params_from_jax",
    "resolve_params",
]
