"""Lock-order graph + deadlock-cycle findings (the port's copy of
``rca_tpu.analysis.concurrency.lockorder``).

Every traversal chain that enters lock B while (interprocedurally)
holding lock A contributes the directed edge ``A -> B``.  A cycle in
that graph is a potential deadlock: two threads walking the cycle from
different entry lock in a state where each holds what the other wants.
The finding carries the full acquire chains — for each edge, where the
outer lock was taken and where the inner acquisition nested under it
(function-qualified, so a cross-call inversion reads as the two call
paths that collide, not just two lock names).

Single-threaded cycles are still reported: a lock order is a global
invariant, and the chain that today only ever runs on one thread is one
``spawn()`` away from not being one (the serve-pool roadmap item is
exactly that change).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from rca_tpu_torch.analysis.concurrency.model import (
    ConcurrencyModel,
    OrderEdge,
)


@dataclasses.dataclass
class CycleFinding:
    locks: Tuple[str, ...]            # cycle members, canonical rotation
    edges: List[OrderEdge]            # one representative edge per hop
    relpath: str                      # attribution: first edge's inner site
    lineno: int
    func: str

    def message(self) -> str:
        hops = []
        for e in self.edges:
            of, ol = e.outer_site
            inf, inl = e.inner_site
            hops.append(
                f"{e.outer} -> {e.inner} "
                f"(held at {_short(of)}:{ol}, nested at {_short(inf)}:{inl}"
                f", root {e.root})"
            )
        chain = "; ".join(hops)
        return (
            "lock-order cycle "
            + " -> ".join(self.locks + (self.locks[0],))
            + " — two threads entering from different edges deadlock; "
            + "acquire chains: " + chain
        )


def _short(qual: str) -> str:
    # "rca_tpu_torch/serve/loop.py::ServeLoop._run"
    #   -> "loop.py::ServeLoop._run"
    path, _, fn = qual.partition("::")
    return f"{path.rsplit('/', 1)[-1]}::{fn}" if fn else path


def _cycles(graph: Dict[str, set]) -> List[Tuple[str, ...]]:
    """Elementary cycles via DFS from each node (graphs here are tiny —
    a handful of locks — so simplicity beats Johnson's algorithm)."""
    out: List[Tuple[str, ...]] = []
    seen: set = set()
    nodes = sorted(graph)
    for start in nodes:
        stack: List[Tuple[str, Tuple[str, ...]]] = [(start, (start,))]
        while stack:
            node, path = stack.pop()
            for nxt in sorted(graph.get(node, ())):
                if nxt == start and len(path) >= 1:
                    # canonical rotation: start from the smallest member
                    i = path.index(min(path))
                    canon = path[i:] + path[:i]
                    if canon not in seen:
                        seen.add(canon)
                        out.append(canon)
                elif nxt not in path and nxt > start:
                    # only explore nodes > start: each cycle found once,
                    # from its smallest member
                    if len(path) < 8:
                        stack.append((nxt, path + (nxt,)))
    return sorted(out)


def analyze_lock_order(model: ConcurrencyModel) -> List[CycleFinding]:
    cached = getattr(model, "_order_findings", None)
    if cached is not None:
        return cached
    graph: Dict[str, set] = {}
    best_edge: Dict[Tuple[str, str], OrderEdge] = {}
    for e in model.order_edges:
        graph.setdefault(e.outer, set()).add(e.inner)
        graph.setdefault(e.inner, set())
        best_edge.setdefault((e.outer, e.inner), e)
    findings: List[CycleFinding] = []
    for cyc in _cycles(graph):
        edges = [
            best_edge[(cyc[i], cyc[(i + 1) % len(cyc)])]
            for i in range(len(cyc))
        ]
        first = edges[0]
        findings.append(CycleFinding(
            locks=cyc, edges=edges,
            relpath=first.inner_site[0].split("::")[0],
            lineno=first.inner_site[1],
            func=first.inner_site[0].split("::")[-1].split(".")[-1],
        ))
    model._order_findings = findings  # one analysis per model build
    return findings
