"""The flagship forward step: explain-away propagation over a 2047-service
cascade (the twin of the JAX package's ``__graft_entry__.entry()``)."""

from __future__ import annotations


def entry(device=None):
    """Returns ``(fn, example_args)``: ``fn(features, dep_src, dep_dst)``
    is the engine's propagation on the padded 2047-service cascade
    (``n_pad`` 2048, ``e_pad`` 4096) and returns the ``[n_pad]`` scores;
    the example arguments are tensors on the engine's device (CUDA unless
    ``device`` names another)."""
    import numpy as np
    import torch

    from rca_tpu_torch.cluster.generator import synthetic_cascade_arrays
    from rca_tpu_torch.engine import GraphEngine
    from rca_tpu_torch.engine.segscan import build_seg_layouts

    case = synthetic_cascade_arrays(2048 - 1, n_roots=3, seed=0)
    engine = GraphEngine(device=device)
    f, s, d = engine._pad(case.features, case.dep_src, case.dep_dst)
    dev = engine.device
    down_seg, up_seg = build_seg_layouts(f.shape[0], len(s), case.dep_src,
                                         case.dep_dst, device=dev)
    n_live = case.features.shape[0]

    def forward(features, dep_src, dep_dst):
        # the edges reach the kernels through the layouts; dep_src stays in
        # the signature of the reference's step
        return engine.model(features, dep_dst, n_live, down_seg, up_seg)[4]

    example_args = (
        torch.from_numpy(f).to(dev),
        torch.from_numpy(s.astype(np.int64)).to(dev),
        torch.from_numpy(d.astype(np.int64)).to(dev),
    )
    return forward, example_args
