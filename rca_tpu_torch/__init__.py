"""rca_tpu_torch: the root-cause engine of ``rca_tpu`` in PyTorch, with its
TPU kernels written by hand in CUDA for NVIDIA Hopper.

It runs on a CUDA device by default; ``device="cpu"`` runs the plain
PyTorch versions of the kernels.  It imports nothing of JAX or of the
``rca_tpu`` package.
"""

from rca_tpu_torch.engine import EngineResult, GraphEngine, params_from_jax

__all__ = ["EngineResult", "GraphEngine", "params_from_jax"]
