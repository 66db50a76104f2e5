"""Rule ``resident-fetch``: the analyze/tick/serve hot paths move results
to the host only through the fetch seam, and only in audited functions.

The device-resident design's whole win is that a request moves O(changed
rows) up and O(top-k) down: every designated fetch surface moves the
``[4, k]`` diagnostic gather, the top-k pair and a count, and the full
``[4, n_pad]`` stack stays on the device behind
``EngineResult.full_diagnostics``'s deferred bulk fetch.  One stray
full-width copy on an analyze/tick/serve path silently restores the host
sync floor with no test failing.

Enforcement: in the hot-path modules below, a call of the seam
(:func:`~rca_tpu_torch.engine.fetch.device_get`,
:class:`~rca_tpu_torch.engine.fetch.HostCopy`) or a raw device→host
spelling (``.cpu()``, ``.item()``, ``.to("cpu")``, ``.synchronize()``;
see :mod:`.ticksync` for what is out of static reach) is legal ONLY
inside the listed functions — the audited top-k surfaces plus the
documented bulk seams (the lazy diagnostics fetch and the sharded stack's
per-block join).  Every listed function has a byte budget in
:data:`rca_tpu_torch.analysis.dataplane.contracts.FETCH_BUDGETS`, and
specsan holds each transfer to it at run time.  The copies of a tick or
a serve batch START in ``dispatch`` (where their bytes are decided) and
sync in ``fetch``, so ``dispatch`` is the audited function there.
"""

from __future__ import annotations

from typing import List

from rca_tpu_torch.analysis.core import FileContext, Finding, Rule, register
from rca_tpu_torch.analysis.rules.ticksync import (
    SEAM_COPY,
    is_copy_start,
    sync_spelling,
    walk_calls,
)

# hot-path modules -> functions allowed to move results to the host
FETCH_SURFACES = {
    "rca_tpu_torch/engine/runner.py": {
        "timed_fetch",        # top-k: diag/vals/idx/n_bad of one analysis
        "analyze_batch",      # top-k: per-lane diag/vals/idx/n_bad
        "full_diagnostics",   # BULK, deferred: the documented lazy seam
    },
    # the dense and the sharded resident sessions' one sync point
    "rca_tpu_torch/engine/resident.py": {"_fetch_topk"},
    # causelens: the [5,k] diag, the [m,k] counterfactual deltas, the
    # [k,P] path arrays and the saliency's top-m — top-k/m-sized
    "rca_tpu_torch/engine/attribution.py": {"compute_attribution"},
    "rca_tpu_torch/engine/sharded_runner.py": {"analyze_batch"},
    # streaming tick + serve: the copies start in dispatch
    "rca_tpu_torch/engine/streaming.py": {"dispatch"},
    "rca_tpu_torch/parallel/streaming.py": {"dispatch"},
    # BULK, deferred: the sharded stack's per-block join
    "rca_tpu_torch/parallel/sharded.py": {"numpy"},
    "rca_tpu_torch/engine/live.py": set(),
    "rca_tpu_torch/serve/dispatcher.py": {"dispatch"},
    "rca_tpu_torch/serve/loop.py": set(),
    "rca_tpu_torch/serve/client.py": set(),
    # the pool's replicas and router never fetch directly
    "rca_tpu_torch/serve/replica.py": set(),
    "rca_tpu_torch/serve/pool.py": set(),
}

MESSAGE = (
    "`{spelling}` outside an audited fetch surface on the "
    "analyze/tick/serve hot path — results move to the host only through "
    "engine.fetch in a function listed in FETCH_SURFACES (with a byte "
    "budget in FETCH_BUDGETS); park full arrays on the device behind "
    "EngineResult.full_diagnostics"
)


@register
class ResidentFetchRule(Rule):
    name = "resident-fetch"
    summary = ("hot-path device→host transfers go through engine.fetch "
               "and live only in audited fetch surfaces")
    why = ("the resident design moves O(changed rows) up and O(top-k) "
           "down per request; one stray full-array copy silently re-pays "
           "the host/staging/fetch floor it erased")
    allow = FETCH_SURFACES

    def applies_to(self, relpath: str) -> bool:
        return relpath in FETCH_SURFACES

    def scan(self, ctx: FileContext) -> List[Finding]:
        hits: List[Finding] = []
        for node, func in walk_calls(ctx.tree):
            spelling = sync_spelling(node)
            if spelling is None and is_copy_start(node):
                spelling = SEAM_COPY
            if spelling is not None:
                hits.append(ctx.finding(
                    self, node.lineno, MESSAGE.format(spelling=spelling),
                    func=func,
                ))
        return hits
