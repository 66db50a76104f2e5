"""Device-mesh parallelism in one process: the node-sharded propagation,
the sharded sessions, mesh and partition-rule helpers.

Counterpart of the JAX package's ``parallel/``: nodes split over the
mesh's ``sp`` axis with all-gather / reduce-scatter collectives between
the shards, hypothesis batches over ``dp``.  Multi-process runs
(``parallel/distributed.py`` in the reference) are not part of the port
yet.
"""

from rca_tpu_torch.parallel.mesh import DeviceMesh, make_mesh
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
    "make_mesh",
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
