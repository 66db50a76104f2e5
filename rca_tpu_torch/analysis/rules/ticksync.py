"""Rule ``tick-sync``: no device synchronization outside fetch on the
tick/serve hot paths, in torch's spellings.

The streaming tick pipeline and the serving scheduler only deliver their
latency wins because CUDA launches are asynchronous: tick N's device work
and its copies hide behind tick N+1's host capture, batch N's behind
batch N+1's assembly.  ONE stray host sync in a capture or dispatch path
re-serializes the whole pipeline — silently, with no test failing, just
the win gone.  The designated sync points are the ``fetch`` functions of
the streaming sessions and of the serve dispatcher; their ``dispatch``
functions may START the copies (a :class:`~rca_tpu_torch.engine.fetch.
HostCopy`, which does not sync) and nothing more.

Flagged, as CALLS (torch's receivers are untyped, so the rule matches
spellings): ``.cpu()``, ``.item()``, ``.to("cpu")`` /
``.to(device="cpu")``, any ``.synchronize()`` (``torch.cuda.synchronize()``,
an event's, a stream's), and the seam's synchronous
:func:`~rca_tpu_torch.engine.fetch.device_get` — each outside the listed
sync functions; and ``HostCopy(...)`` outside the listed sync and
copy-start functions.

Not flagged, on purpose: ``.tolist()`` and ``.numpy()``, which numpy
spells the same way (a ``HostCopy``'s ``numpy()`` is the sync a ``fetch``
makes), and attribute READS such as a columnar table's ``cpu`` column.
``.item()`` is flagged whatever its receiver: in these modules a numpy
scalar converts with ``int()`` / ``float()``.  Out of static reach: the
implicit syncs of a CUDA tensor used as a Python value (``int(t)``,
``float(t)``, ``if t:``, indexing with a CUDA scalar) and a sync reached
through a helper in another module; ``torch.cuda.set_sync_debug_mode``
is the runtime check for those.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from rca_tpu_torch.analysis.core import FileContext, Finding, Rule, register

#: synchronous device→host spellings, as the attribute called
SYNC_METHODS = ("cpu", "item", "synchronize")
#: the seam's entries (:mod:`rca_tpu_torch.engine.fetch`)
SEAM_SYNC = "device_get"
SEAM_COPY = "HostCopy"

# hot-path modules -> function names allowed to synchronize there
TICK_MODULES = {
    "rca_tpu_torch/engine/streaming.py": {"fetch"},
    "rca_tpu_torch/parallel/streaming.py": {"fetch"},
    "rca_tpu_torch/engine/live.py": set(),
    "rca_tpu_torch/features/extract.py": set(),
    "rca_tpu_torch/cluster/snapshot.py": set(),
    # columnar capture is pure host-side table work
    "rca_tpu_torch/cluster/columnar.py": set(),
    # live ingest: watch-pump capture, the multi-cluster merge, and the
    # ingest runner never touch the device
    "rca_tpu_torch/cluster/live_columnar.py": set(),
    "rca_tpu_torch/cluster/clusterset.py": set(),
    "rca_tpu_torch/serve/ingest.py": set(),
    "rca_tpu_torch/serve/dispatcher.py": {"fetch"},
    "rca_tpu_torch/serve/loop.py": set(),
    "rca_tpu_torch/serve/queue.py": set(),
    "rca_tpu_torch/serve/batcher.py": set(),
    "rca_tpu_torch/serve/client.py": set(),
    "rca_tpu_torch/serve/metrics.py": set(),
    # the pool's replicas and router sync only through the dispatcher's
    # fetch, the steal path's orphan fetch included
    "rca_tpu_torch/serve/replica.py": set(),
    "rca_tpu_torch/serve/pool.py": set(),
    # the federation routes wire frames and parks on req.result(); each
    # worker's own ServeLoop keeps fetch as its one sync
    "rca_tpu_torch/serve/federation.py": set(),
    "rca_tpu_torch/serve/worker.py": set(),
    "rca_tpu_torch/serve/fedwire.py": set(),
    # scale decisions are control-plane arithmetic over exported telemetry
    "rca_tpu_torch/serve/autoscale.py": set(),
    "rca_tpu_torch/util/procs.py": set(),
    # the gateway's handlers park on req.result() like any submitter
    "rca_tpu_torch/gateway/server.py": set(),
    "rca_tpu_torch/gateway/wire.py": set(),
    "rca_tpu_torch/gateway/client.py": set(),
    "rca_tpu_torch/gateway/export.py": set(),
    "rca_tpu_torch/gateway/canary.py": set(),
}

#: functions that may START the copies (``HostCopy``, no sync) there
COPY_START = {
    "rca_tpu_torch/engine/streaming.py": {"dispatch"},
    "rca_tpu_torch/parallel/streaming.py": {"dispatch"},
    "rca_tpu_torch/serve/dispatcher.py": {"dispatch"},
}

MESSAGE = (
    "`{spelling}` in the tick capture/dispatch path — a device sync "
    "belongs ONLY in the session's or the dispatcher's fetch(); a "
    "dispatch starts its copies with engine.fetch.HostCopy (it "
    "re-serializes the tick pipeline otherwise)"
)


def _callee(node: ast.Call) -> Optional[str]:
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _is_cpu(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value == "cpu"


def sync_spelling(node: ast.Call) -> Optional[str]:
    """The device→host spelling a call makes (``.cpu()``, ``.item()``,
    ``.to("cpu")``, ``.synchronize()``, ``device_get``), or None."""
    name = _callee(node)
    if name == SEAM_SYNC:
        return SEAM_SYNC
    if not isinstance(node.func, ast.Attribute):
        return None
    if name in SYNC_METHODS:
        return f".{name}()"
    if name == "to" and (
            (node.args and _is_cpu(node.args[0]))
            or any(kw.arg == "device" and _is_cpu(kw.value)
                   for kw in node.keywords)):
        return '.to("cpu")'
    return None


def is_copy_start(node: ast.Call) -> bool:
    return _callee(node) == SEAM_COPY


def walk_calls(tree: ast.AST):
    """``(call, enclosing function name)`` for every call in ``tree``."""
    out = []

    def walk(node: ast.AST, func: str) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            func = node.name
        if isinstance(node, ast.Call):
            out.append((node, func))
        for child in ast.iter_child_nodes(node):
            walk(child, func)

    walk(tree, "<module>")
    return out


@register
class TickSyncRule(Rule):
    name = "tick-sync"
    summary = ("no .cpu() / .item() / .to('cpu') / .synchronize() / "
               "device_get outside fetch() (and no HostCopy outside "
               "dispatch/fetch) on the tick/serve hot paths")
    why = ("a stray sync re-serializes the dispatch/fetch pipeline: the "
           "device round trip stops hiding behind host capture and every "
           "tick pays it in full again")
    allow = TICK_MODULES

    def applies_to(self, relpath: str) -> bool:
        return relpath in TICK_MODULES

    def scan(self, ctx: FileContext) -> List[Finding]:
        hits: List[Finding] = []
        starts = COPY_START.get(ctx.relpath, set())
        for node, func in walk_calls(ctx.tree):
            spelling = sync_spelling(node)
            if spelling is None and is_copy_start(node) \
                    and func not in starts:
                spelling = SEAM_COPY
            if spelling is not None:
                hits.append(ctx.finding(
                    self, node.lineno, MESSAGE.format(spelling=spelling),
                    func=func,
                ))
        return hits
