"""Multi-tenant serving scheduler: continuous shape-bucketed batching on
the card, in one process or over a federation of worker processes (the
port's copy of ``rca_tpu.serve``; the autoscaler's controller is not
ported yet, only its rule tables).

Every other entry point (``analyze``, ``hypotheses``, ``stream``) owns the
device; two concurrent investigations serialize with no batching, though
one lane-batched dispatch scores many requests over one graph for little
more than one.  This package is the serving layer:

- :mod:`.request` — the request/response contract;
- :mod:`.queue` — bounded admission, per-tenant weighted fair queuing,
  priorities, deadline shedding;
- :mod:`.batcher` — shape-bucket grouping with the max-batch / max-wait
  flush policy;
- :mod:`.dispatcher` — the coalesced device dispatch: one ranked
  propagation over ``[b_pad, n_pad, C]`` lanes, each main-path kernel
  launched for the whole batch once, the recursions in the form
  ``KernelPlan.steps_form`` names (dispatch never syncs; fetch is the
  one sync);
- :mod:`.loop` — the continuous-batching worker with breaker-gated
  degradation;
- :mod:`.replica` / :mod:`.pool` — N engine replicas (a dense/sharded mix
  over carved device groups) behind the shared queue, shape-bucket-sticky
  routing, per-replica breakers, work-stealing failover with exactly-once
  completion;
- :mod:`.federation` / :mod:`.worker` / :mod:`.fedwire` /
  :mod:`.ingest` — the cross-process plane: worker processes (each with
  its own CUDA context) with lease-based liveness, consistent-hash
  routing on the graph digest, drain-and-reroute on process death under
  the same exactly-once contract across the wire, and ingest workers
  owning cluster capture mirrors; :mod:`.autoscale` holds the placement
  and scale-rule tables;
- :mod:`.client` — the in-process client, the coordinator's EngineAPI
  facade and the ``python -m rca_tpu_torch serve --selftest`` harness;
- :mod:`.metrics` — per-tenant queue, duration and occupancy metrics.
"""

from rca_tpu_torch.serve.batcher import ShapeBucketBatcher
from rca_tpu_torch.serve.client import (
    ServeClient,
    ServeEngineAdapter,
    serve_selftest,
)
from rca_tpu_torch.serve.dispatcher import BatchDispatcher, BatchHandle
from rca_tpu_torch.serve.loop import ServeLoop
from rca_tpu_torch.serve.metrics import ServeMetrics
from rca_tpu_torch.serve.pool import ServePool
from rca_tpu_torch.serve.queue import RequestQueue
from rca_tpu_torch.serve.replica import (
    CompletionSink,
    ReplicaWorker,
    build_replica_engines,
)
from rca_tpu_torch.serve.request import (
    PRIORITY_BATCH,
    PRIORITY_HIGH,
    PRIORITY_NORMAL,
    ServeRequest,
    ServeResponse,
    graph_key,
)

__all__ = [
    "ShapeBucketBatcher",
    "ServePool",
    "ReplicaWorker",
    "CompletionSink",
    "build_replica_engines",
    "ServeClient",
    "ServeEngineAdapter",
    "serve_selftest",
    "BatchDispatcher",
    "BatchHandle",
    "ServeLoop",
    "ServeMetrics",
    "RequestQueue",
    "ServeRequest",
    "ServeResponse",
    "graph_key",
    "PRIORITY_HIGH",
    "PRIORITY_NORMAL",
    "PRIORITY_BATCH",
]
