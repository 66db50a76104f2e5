"""Deterministic graph analyses on the array representation: the port's
copy of ``rca_tpu.graph.analysis``, with the all-sources betweenness in
torch on an explicit device.

Replaces the reference's networkx calls with better asymptotics
(reference: agents/topology_agent.py — ``nx.simple_cycles`` :268, all-pairs
``nx.all_simple_paths`` longest chain :294-305 (O(V²)·paths, its hot spot),
betweenness-centrality SPOF :329-346, isolated nodes :363):

- cycle detection via Kahn peeling (O(V+E)) + one DFS to report a witness,
- longest dependency chain via topological-order DP (O(V+E)),
- Brandes betweenness centrality (exact, O(V·E)) with a size gate,
- isolated nodes via degree counting.

All take COO edge arrays (src depends-on dst) over n nodes.
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional, Tuple

import numpy as np
import torch


def _adjacency(n: int, src: np.ndarray, dst: np.ndarray) -> List[List[int]]:
    adj: List[List[int]] = [[] for _ in range(n)]
    for s, d in zip(src.tolist(), dst.tolist()):
        adj[s].append(d)
    return adj


def _kahn_order(n: int, src: np.ndarray, dst: np.ndarray):
    """Topological peel. Returns (order, on_cycle_mask)."""
    indeg = np.zeros(n, dtype=np.int64)
    np.add.at(indeg, dst, 1)
    adj = _adjacency(n, src, dst)
    stack = [i for i in range(n) if indeg[i] == 0]
    order: List[int] = []
    while stack:
        u = stack.pop()
        order.append(u)
        for v in adj[u]:
            indeg[v] -= 1
            if indeg[v] == 0:
                stack.append(v)
    on_cycle = np.ones(n, dtype=bool)
    on_cycle[order] = False
    return order, on_cycle


def find_cycles(
    n: int, src: np.ndarray, dst: np.ndarray, max_cycles: int = 10
) -> List[List[int]]:
    """Nodes trapped on cycles, reported as witness cycles (node indices)."""
    _, on_cycle = _kahn_order(n, src, dst)
    if not on_cycle.any():
        return []
    adj = _adjacency(n, src, dst)
    # restrict once to the cycle-trapped subgraph
    cyc_adj: List[List[int]] = [
        [v for v in adj[u] if on_cycle[v]] if on_cycle[u] else []
        for u in range(n)
    ]
    cycles: List[List[int]] = []
    visited = np.zeros(n, dtype=bool)
    for start in np.nonzero(on_cycle)[0]:
        if len(cycles) >= max_cycles:
            break
        if visited[start]:
            continue
        # iterative DFS restricted to cycle nodes, tracking the path
        path: List[int] = []
        pos = {}
        stack: List[Tuple[int, int]] = [(int(start), 0)]
        while stack and len(cycles) < max_cycles:
            u, ei = stack[-1]
            if ei == 0:
                pos[u] = len(path)
                path.append(u)
                visited[u] = True
            nbrs = cyc_adj[u]
            if ei < len(nbrs):
                stack[-1] = (u, ei + 1)
                v = nbrs[ei]
                if v in pos:
                    cycles.append(path[pos[v]:] + [v])
                elif not visited[v]:
                    stack.append((v, 0))
            else:
                stack.pop()
                path.pop()
                del pos[u]
    return cycles


def longest_dependency_chain(
    n: int, src: np.ndarray, dst: np.ndarray
) -> List[int]:
    """Longest path in the acyclic part, via topological DP (O(V+E))."""
    order, on_cycle = _kahn_order(n, src, dst)
    adj = _adjacency(n, src, dst)
    dist = np.zeros(n, dtype=np.int64)
    nxt = np.full(n, -1, dtype=np.int64)
    # process in reverse topological order: dist[u] = 1 + max dist[v]
    for u in reversed(order):
        best, arg = 0, -1
        for v in adj[u]:
            if on_cycle[v]:
                continue
            if dist[v] + 1 > best:
                best, arg = dist[v] + 1, v
        dist[u] = best
        nxt[u] = arg
    if n == 0 or dist.max() == 0:
        return []
    u = int(dist.argmax())
    chain = [u]
    while nxt[u] >= 0:
        u = int(nxt[u])
        chain.append(u)
    return chain


def isolated_nodes(n: int, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    deg = np.zeros(n, dtype=np.int64)
    np.add.at(deg, src, 1)
    np.add.at(deg, dst, 1)
    return np.nonzero(deg == 0)[0]


def _bc_kernel(src: np.ndarray, dst: np.ndarray, n_pad: int, device):
    """ALL-SOURCES Brandes on ``device`` for an ``[n_pad, n_pad]`` dense
    adjacency: the JAX package's ``_bc_kernel`` with its two
    ``lax.while_loop``s as Python loops.  Returns ``(bc, finite, levels)``:
    the unnormalized ``[n_pad]`` float32 centrality on ``device``, whether
    every path count and dependency stayed finite, and the number of BFS
    levels the forward loop ran.

    Unweighted Brandes is level-synchronous, so every source advances one
    BFS level per step, which makes each step one ``[n, n]`` product:

    forward (σ = shortest-path counts, one row per source):
        paths    = (σ ⊙ frontier) @ A        # arrivals via current level
        newly    = (paths > 0) ∧ (dist < 0)
        σ       += paths ⊙ newly ;  dist[newly] = level+1
    backward (δ = dependency accumulation, levels descending):
        X        = [dist = d] ⊙ (1 + δ) / σ
        δ       += σ ⊙ (X @ Aᵀ) ⊙ [dist = d-1]
    bc[v] = Σ_s δ[s, v] (v ≠ s)

    An edge (u, v) with dist_u = d-1, dist_v = d is exactly a Brandes
    predecessor pair under BFS, so the masked product reproduces the exact
    algorithm.  Path counts are integers held in float32, exact only while
    the products are full float32: a TF32 product would round them, so the
    call refuses to run with TF32 products enabled.  The forward loop reads
    one flag back per level to stop on an empty frontier."""
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "betweenness needs full float32 products (exact path counts); "
            "TF32 matmuls are enabled"
        )
    f32 = torch.float32
    A = torch.zeros((n_pad, n_pad), dtype=f32, device=device)
    # a scatter of ones: duplicate edges collapse to 1
    A[torch.from_numpy(src.astype(np.int64)).to(device),
      torch.from_numpy(dst.astype(np.int64)).to(device)] = 1.0
    eye = torch.eye(n_pad, dtype=f32, device=device)
    frontier, sigma = eye, eye
    dist = torch.where(eye > 0, 0, -1).to(torch.int32)
    levels = 0
    while bool(frontier.any()):
        paths = (sigma * frontier) @ A
        newly = (paths > 0) & (dist < 0)
        sigma = sigma + torch.where(newly, paths, 0.0)
        dist = torch.where(newly, levels + 1, dist)
        frontier = newly.to(f32)
        levels += 1
    # the last forward level found nothing new: the deepest nodes sit at
    # levels - 1, where the backward sweep starts
    delta = torch.zeros_like(A)
    for d in range(levels - 1, 0, -1):
        x = (dist == d).to(f32) * (1.0 + delta) / torch.clamp(sigma, min=1.0)
        delta = delta + sigma * (x @ A.T) * (dist == d - 1)
    bc = (delta * (1.0 - eye)).sum(dim=0)
    finite = bool(torch.isfinite(sigma).all() and torch.isfinite(delta).all())
    return bc, finite, levels


# The size gate of the JAX package, kept as it is: it decides which
# arithmetic (the float32 all-sources products or the float64 loop)
# produces the numbers, so moving it would change the findings.  The
# ceiling bounds the dense [n, n] buffers; callers that disable the
# degree-approximation gate (max_nodes=None) keep the O(V+E)-memory loop
# beyond it
_BC_DEVICE_MIN_NODES = 1280
_BC_DEVICE_MAX_NODES = 4096


def betweenness_centrality(
    n: int,
    src: np.ndarray,
    dst: np.ndarray,
    normalized: bool = True,
    max_nodes: Optional[int] = 4096,
    device=None,
) -> np.ndarray:
    """Exact Brandes betweenness (directed). Gated by ``max_nodes`` — beyond
    it the SPOF analysis falls back to degree centrality (documented
    approximation for 10k+ graphs).  Mid-size graphs
    (``_BC_DEVICE_MIN_NODES``..``_BC_DEVICE_MAX_NODES`` — a ceiling
    independent of ``max_nodes``) run the all-sources product formulation
    (:func:`_bc_kernel`) on ``device``, CUDA unless the caller names
    another; smaller graphs, larger graphs under ``max_nodes=None``, and
    float32-overflow cases use the float64 loop."""
    bc = np.zeros(n, dtype=np.float64)
    if n == 0 or len(src) == 0:
        return bc
    if max_nodes is not None and n > max_nodes:
        deg = np.zeros(n, dtype=np.float64)
        np.add.at(deg, src, 1.0)
        np.add.at(deg, dst, 1.0)
        return deg / max(1.0, deg.max())
    if _BC_DEVICE_MIN_NODES <= n <= _BC_DEVICE_MAX_NODES:
        from rca_tpu_torch.engine.fetch import device_get
        from rca_tpu_torch.engine.runner import resolve_device

        # nodes padded to a multiple of 256 as the JAX package pads them:
        # padding nodes are isolated, on no real shortest path, bc 0
        n_pad = -(-n // 256) * 256
        bc_dev, finite, _ = _bc_kernel(src, dst, n_pad,
                                       resolve_device(device))
        if finite:
            bc = device_get(bc_dev).astype(np.float64)[:n]
            if normalized and n > 2:
                bc /= (n - 1) * (n - 2)
            return bc
        # float32 path counts overflowed: fall through to the float64 loop
    return _betweenness_python(n, src, dst, normalized)


def _betweenness_python(
    n: int,
    src: np.ndarray,
    dst: np.ndarray,
    normalized: bool = True,
) -> np.ndarray:
    bc = np.zeros(n, dtype=np.float64)
    adj = _adjacency(n, src, dst)
    for s in range(n):
        if not adj[s]:
            continue
        # BFS (unweighted shortest paths)
        sigma = np.zeros(n)
        sigma[s] = 1.0
        dist = np.full(n, -1)
        dist[s] = 0
        order: List[int] = []
        queue = deque([s])
        preds: List[List[int]] = [[] for _ in range(n)]
        while queue:
            u = queue.popleft()
            order.append(u)
            for v in adj[u]:
                if dist[v] < 0:
                    dist[v] = dist[u] + 1
                    queue.append(v)
                if dist[v] == dist[u] + 1:
                    sigma[v] += sigma[u]
                    preds[v].append(u)
        delta = np.zeros(n)
        for v in reversed(order):
            for u in preds[v]:
                delta[u] += sigma[u] / sigma[v] * (1.0 + delta[v])
            if v != s:
                bc[v] += delta[v]
    if normalized and n > 2:
        bc /= (n - 1) * (n - 2)
    return bc
