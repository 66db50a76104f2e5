"""Device-mesh parallelism in one process: the node-sharded propagation,
the sharded sessions, mesh and partition-rule helpers.

Counterpart of the JAX package's ``parallel/``: nodes split over the
mesh's ``sp`` axis with all-gather / reduce-scatter collectives between
the shards, hypothesis batches over ``dp``.  Multi-process runs bring up
a ``torch.distributed`` process group first
(:func:`initialize_distributed`); :func:`make_multislice_mesh` lays an
outer axis over groups of devices.
"""

from rca_tpu_torch.parallel.distributed import initialize_distributed
from rca_tpu_torch.parallel.mesh import (
    DeviceMesh,
    make_mesh,
    make_multislice_mesh,
)
from rca_tpu_torch.parallel.sharded import (
    ShardedGraph,
    ShardedResidentSession,
    ShardedSegLayouts,
    build_sharded_seg_layouts,
    shard_graph,
    sharded_propagate,
    sharded_propagate_full,
    sharded_topk,
)
from rca_tpu_torch.parallel.streaming import ShardedStreamingSession

__all__ = [
    "DeviceMesh",
    "initialize_distributed",
    "make_mesh",
    "make_multislice_mesh",
    "ShardedGraph",
    "ShardedResidentSession",
    "ShardedSegLayouts",
    "ShardedStreamingSession",
    "build_sharded_seg_layouts",
    "shard_graph",
    "sharded_propagate",
    "sharded_propagate_full",
    "sharded_topk",
]
