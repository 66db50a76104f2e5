"""Synthetic fault-cascade arrays: the port's numpy copy of the arrays
half of ``rca_tpu.cluster.generator``.

A random service-dependency DAG (each service depends on 1..3 earlier
services, preferential-attachment flavored so hub services emerge), fault
injection at ``n_roots`` services, and symptom propagation to transitive
dependents with per-hop decay.  The output is the raw arrays the engine
takes (:class:`CascadeArrays`); the same seed gives the same bytes as the
JAX package's generator, so both engines can be held to one input.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from rca_tpu_torch.features.schema import NUM_RAW_SERVICE_FEATURES as NUM_RAW
from rca_tpu_torch.features.schema import NUM_SERVICE_FEATURES as NUM_FEATURES
from rca_tpu_torch.features.schema import SvcF, derive_silent_channel

F_CRASH = int(SvcF.CRASH)
F_ERROR_RATE = int(SvcF.ERROR_RATE)
F_LATENCY = int(SvcF.LATENCY)
F_RESTARTS = int(SvcF.RESTARTS)
F_EVENTS = int(SvcF.EVENTS)
F_LOG_ERRORS = int(SvcF.LOG_ERRORS)
F_NOT_READY = int(SvcF.NOT_READY)
F_RESOURCE = int(SvcF.RESOURCE)
F_IMAGE = int(SvcF.IMAGE)
F_CONFIG = int(SvcF.CONFIG)
F_PENDING = int(SvcF.PENDING)
F_OOM = int(SvcF.OOM)

# Root fault archetypes (fault_mix="mixed"): what KIND of fault the root
# has: crash loop, OOM kill, image pull, missing config, unschedulable.
# The default "crash" keeps every pre-existing seed's cascade byte-stable.
ROOT_ARCHETYPES = ("crash", "oom", "image", "config", "pending")


@dataclasses.dataclass
class CascadeArrays:
    """Raw-array cascade: the direct input to the engine."""

    n: int
    # COO edge list, dependency direction: edge (s, d) means service s
    # depends on service d (faults flow d -> s).
    dep_src: np.ndarray  # int32 [E] — the dependent
    dep_dst: np.ndarray  # int32 [E] — the dependency
    features: np.ndarray  # float32 [n, NUM_FEATURES]
    roots: np.ndarray  # int32 [n_roots] ground-truth fault roots
    anomaly: np.ndarray  # float32 [n] scalar anomaly per service
    names: Optional[List[str]] = None
    # diagnosis metadata (autopsy tooling, not consumed by the engine):
    # decoy service indices (correlated modes), hop distance from the
    # nearest root along dependent edges (INT32_MAX = unaffected), and
    # each root's fault archetype (parallel to ``roots``)
    decoys: Optional[np.ndarray] = None
    hops: Optional[np.ndarray] = None
    root_kinds: Optional[List[str]] = None


def _build_dag(n: int, rng: np.random.Generator, max_deps: int = 3):
    """Random layered DAG with preferential attachment; returns (src, dst)."""
    if n <= 1:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    # weight[i] grows as i acquires dependents -> hub services
    weights = np.ones(n, dtype=np.float64)
    src_list: List[np.ndarray] = []
    dst_list: List[np.ndarray] = []
    for i in range(1, n):
        k = int(rng.integers(1, max_deps + 1))
        k = min(k, i)
        p = weights[:i] / weights[:i].sum()
        deps = rng.choice(i, size=k, replace=False, p=p)
        weights[deps] += 1.0
        src_list.append(np.full(k, i, dtype=np.int32))
        dst_list.append(deps.astype(np.int32))
    return np.concatenate(src_list), np.concatenate(dst_list)


def _dependents_adj(n: int, dep_src: np.ndarray, dep_dst: np.ndarray):
    """dependency -> list of dependents (the direction faults travel)."""
    adj: List[List[int]] = [[] for _ in range(n)]
    for s, d in zip(dep_src.tolist(), dep_dst.tolist()):
        adj[d].append(s)
    return adj


def _bfs_hops(n: int, adj, roots: np.ndarray) -> np.ndarray:
    """Hop distance from the nearest fault root along dependent edges."""
    INF = np.iinfo(np.int32).max
    dist = np.full(n, INF, dtype=np.int64)
    frontier = list(int(r) for r in roots)
    for r in frontier:
        dist[r] = 0
    while frontier:
        nxt = []
        for u in frontier:
            for v in adj[u]:
                if dist[v] > dist[u] + 1:
                    dist[v] = dist[u] + 1
                    nxt.append(v)
        frontier = nxt
    return dist


CASCADE_MODES = (
    "standard",
    "crashing_victims",
    "missing_signals",
    "correlated_noise",
    "overlapping_roots",
    "adversarial",
)


def synthetic_cascade_arrays(
    n_services: int,
    n_roots: int = 1,
    seed: int = 0,
    decay: float = 0.75,
    noise: float = 0.05,
    mode: str = "standard",
    max_deps: int = 3,
    dropout_keep: float = 0.65,
    fault_mix: str = "crash",
) -> CascadeArrays:
    """Generate the raw-array cascade (any scale; used for bench + training).

    ``mode`` selects how adversarial the cascade is (VERDICT round-1: the
    standard generator makes roots nearly separable from the noisy-OR alone,
    so accuracy numbers ride an easy distribution):

    - ``standard`` — roots crash hard, victims degrade softly (no crash).
    - ``crashing_victims`` — probe-kill: victims near the root ALSO crash
      and restart (liveness probes kill pods that time out on a dead
      dependency), while roots crash with a wider, weaker range; the max
      per-service feature no longer identifies the root.
    - ``missing_signals`` — per-(service, channel) dropout: each fault
      signal is observed only with probability ~0.65 (agents miss data in
      real clusters); roots can lose their crash channel entirely.
    - ``correlated_noise`` — low-rank correlated background (shared noise
      factors across services, e.g. a noisy node or scrape jitter) plus
      loud decoy services with error/latency spikes but no downstream
      blast radius.
    - ``overlapping_roots`` — multi-root with overlapping blast radii:
      later roots are drawn from inside the first root's affected set, so
      victim symptoms stack and per-root evidence overlaps.
    - ``adversarial`` — crashing_victims + missing_signals +
      correlated_noise at once.

    ``decay``/``noise``/``max_deps``/``dropout_keep`` are the generator's
    domain knobs (symptom per-hop decay, background noise ceiling, DAG
    fan-out, per-channel observation probability in the dropout modes) —
    exposed so training can domain-randomize over them instead of
    overfitting one fixed world (VERDICT r2 item 4).

    ``fault_mix`` selects the roots' fault ARCHETYPE (round 3: a
    crash-only generator let fitted weights zero the image/config/
    pending/oom channels the real rule agents depend on):

    - ``"crash"`` (default) — every root crash-loops; byte-stable with
      every pre-existing seed;
    - ``"mixed"`` — each root draws an archetype from
      :data:`ROOT_ARCHETYPES` (crash / oom / image / config / pending),
      with archetype-appropriate channels (an image-pull root produces NO
      logs and NO crashes — the container never started);
    - one archetype name — every root has that fault (the shippability
      gate uses this to verify each channel family individually).
    """
    if mode not in CASCADE_MODES:
        raise ValueError(f"unknown cascade mode {mode!r}; one of {CASCADE_MODES}")
    rng = np.random.default_rng(seed)
    dep_src, dep_dst = _build_dag(n_services, rng, max_deps=max_deps)
    adj = _dependents_adj(n_services, dep_src, dep_dst)

    # Prefer roots with real downstream impact (≥1 dependent when possible).
    impact = np.array([len(a) for a in adj])
    candidates = np.nonzero(impact > 0)[0]
    if len(candidates) < n_roots:
        candidates = np.arange(n_services)
    if mode == "overlapping_roots" and n_roots > 1:
        first = rng.choice(candidates, size=1)
        hops0 = _bfs_hops(n_services, adj, first.astype(np.int32))
        blast = np.nonzero(
            (hops0 > 0) & (hops0 < np.iinfo(np.int32).max)
        )[0]
        pool = blast if len(blast) >= n_roots - 1 else np.setdiff1d(
            candidates, first
        )
        rest = rng.choice(pool, size=min(n_roots - 1, len(pool)), replace=False)
        roots = np.concatenate([first, rest])
    else:
        roots = rng.choice(
            candidates, size=min(n_roots, len(candidates)), replace=False
        )
    roots = roots.astype(np.int32)

    hops = _bfs_hops(n_services, adj, roots)
    feats = np.zeros((n_services, NUM_FEATURES), dtype=np.float32)

    correlated = mode in ("correlated_noise", "adversarial")
    # all rng draws cover only the RAW (observed) channels: the derived
    # SILENT channel is computed afterwards with no randomness of its own,
    # so every pre-existing seed's raw channels stay byte-stable
    if correlated:
        # low-rank noise: a few shared factors load onto every service
        # (scrape jitter, a hot node) — raises the background floor in a
        # structured way that per-service thresholds cannot remove.  The
        # factors load only onto SOFT channels: jitter inflates latency /
        # error rates / event counts, it does not fabricate OOM kills or
        # image-pull failures.
        n_factors = 3
        soft = np.zeros(NUM_RAW, dtype=np.float32)
        soft[[F_ERROR_RATE, F_LATENCY, F_EVENTS, F_LOG_ERRORS, F_RESOURCE]] = 1.0
        loadings = rng.uniform(0, 1, (n_services, n_factors)).astype(np.float32)
        factors = (
            rng.uniform(0, 0.25, (n_factors, NUM_RAW)).astype(np.float32)
            * soft[None, :]
        )
        background = loadings @ factors + rng.uniform(
            0.0, noise, size=(n_services, NUM_RAW)
        ).astype(np.float32)
    else:
        background = rng.uniform(
            0.0, noise, size=(n_services, NUM_RAW)
        ).astype(np.float32)
    feats[:, :NUM_RAW] += background

    is_root = np.zeros(n_services, dtype=bool)
    is_root[roots] = True
    affected = (hops < np.iinfo(np.int32).max) & ~is_root
    aff_idx = np.nonzero(affected)[0]
    aff_decay = (decay ** hops[aff_idx]).astype(np.float32)

    crashing_victims = mode in ("crashing_victims", "adversarial")
    if fault_mix == "crash":
        # byte-stable legacy path: identical rng draw sequence to the
        # pre-archetype generator, so every published seed/band reproduces
        if crashing_victims:
            # roots crash over a wider, weaker range (flaky rather than dead)
            feats[roots, F_CRASH] = rng.uniform(0.55, 0.95, size=len(roots))
            feats[roots, F_RESTARTS] = rng.uniform(0.5, 0.9, size=len(roots))
        else:
            feats[roots, F_CRASH] = rng.uniform(0.85, 1.0, size=len(roots))
            feats[roots, F_RESTARTS] = rng.uniform(0.7, 1.0, size=len(roots))
        feats[roots, F_EVENTS] = rng.uniform(0.6, 1.0, size=len(roots))
        feats[roots, F_LOG_ERRORS] = rng.uniform(0.7, 1.0, size=len(roots))
        feats[roots, F_NOT_READY] = rng.uniform(0.8, 1.0, size=len(roots))
        feats[roots, F_ERROR_RATE] = rng.uniform(0.5, 1.0, size=len(roots))
        root_kinds = ["crash"] * len(roots)
    else:
        if fault_mix == "mixed":
            root_kinds = [
                ROOT_ARCHETYPES[k]
                for k in rng.integers(0, len(ROOT_ARCHETYPES), len(roots))
            ]
        elif fault_mix in ROOT_ARCHETYPES:
            root_kinds = [fault_mix] * len(roots)
        else:
            raise ValueError(
                f"unknown fault_mix {fault_mix!r}; one of "
                f"('crash', 'mixed', *{ROOT_ARCHETYPES})"
            )
        for j, r in enumerate(roots.tolist()):
            kind = root_kinds[j]
            # common: the root is down/unready, K8s surfaces warning
            # events, callers see errors
            feats[r, F_EVENTS] = rng.uniform(0.6, 1.0)
            feats[r, F_NOT_READY] = rng.uniform(0.8, 1.0)
            feats[r, F_ERROR_RATE] = rng.uniform(0.5, 1.0)
            if kind == "crash":
                # ranges mirror the legacy crash path exactly (both
                # channels), so one archetype never has two different
                # evidence distributions between train (mixed) and eval
                # (crash) data
                if crashing_victims:
                    feats[r, F_CRASH] = rng.uniform(0.55, 0.95)
                    feats[r, F_RESTARTS] = rng.uniform(0.5, 0.9)
                else:
                    feats[r, F_CRASH] = rng.uniform(0.85, 1.0)
                    feats[r, F_RESTARTS] = rng.uniform(0.7, 1.0)
                feats[r, F_LOG_ERRORS] = rng.uniform(0.7, 1.0)
            elif kind == "oom":
                # memory at limit, kernel kills → restart loop with a
                # strong OOM channel and saturated resource pressure
                feats[r, F_OOM] = rng.uniform(0.8, 1.0)
                feats[r, F_CRASH] = rng.uniform(0.4, 0.8)
                feats[r, F_RESTARTS] = rng.uniform(0.5, 0.9)
                feats[r, F_RESOURCE] = rng.uniform(0.8, 1.0)
                feats[r, F_LOG_ERRORS] = rng.uniform(0.3, 0.8)
            elif kind == "image":
                # the container NEVER starts: no logs, no crashes — the
                # only signals are the waiting reason and events
                feats[r, F_IMAGE] = rng.uniform(0.85, 1.0)
                feats[r, F_LOG_ERRORS] = 0.0
            elif kind == "config":
                # missing ConfigMap/Secret/env: config-error waiting state,
                # possibly a few crash-exits when the app starts then dies
                feats[r, F_CONFIG] = rng.uniform(0.85, 1.0)
                feats[r, F_CRASH] = rng.uniform(0.3, 0.7)
                feats[r, F_LOG_ERRORS] = rng.uniform(0.2, 0.7)
            else:  # pending
                # unschedulable: never placed, no container, no logs
                feats[r, F_PENDING] = rng.uniform(0.8, 1.0)
                feats[r, F_LOG_ERRORS] = 0.0

    # Dependents: soft degradation decaying with hop distance.  In standard
    # mode victims carry NO crash signal (they are victims, not causes);
    # in probe-kill modes close victims saturate latency/errors AND crash,
    # so their max feature routinely exceeds the root's.
    jitter = rng.uniform(0.8, 1.0, size=len(aff_idx)).astype(np.float32)
    feats[aff_idx, F_LOG_ERRORS] = 0.4 * aff_decay * jitter
    feats[aff_idx, F_EVENTS] = 0.3 * aff_decay * jitter
    if crashing_victims:
        feats[aff_idx, F_LATENCY] = np.clip(
            1.1 * aff_decay * jitter, 0, 1.0
        )
        feats[aff_idx, F_ERROR_RATE] = np.clip(
            1.0 * aff_decay * rng.uniform(0.85, 1.0, len(aff_idx)), 0, 1.0
        )
        feats[aff_idx, F_CRASH] = np.clip(
            0.75 * aff_decay * rng.uniform(0.7, 1.0, len(aff_idx)), 0, 1.0
        )
        feats[aff_idx, F_RESTARTS] = np.clip(
            0.7 * aff_decay * rng.uniform(0.6, 1.0, len(aff_idx)), 0, 1.0
        )
        feats[aff_idx, F_NOT_READY] = (aff_decay > 0.5).astype(np.float32)
    else:
        feats[aff_idx, F_ERROR_RATE] = 0.7 * aff_decay * jitter
        feats[aff_idx, F_LATENCY] = 0.8 * aff_decay * jitter

    decoys = None
    if correlated:
        # decoy services: loud but inert (no blast radius) — error/latency
        # spikes from e.g. a bad canary; ~2% of services, never roots or
        # their direct dependents
        n_decoys = max(1, n_services // 50)
        eligible = np.nonzero(~is_root & ~affected)[0]
        if len(eligible) >= n_decoys:
            decoys = rng.choice(eligible, size=n_decoys, replace=False)
            feats[decoys, F_ERROR_RATE] = rng.uniform(0.9, 1.0, n_decoys)
            feats[decoys, F_LATENCY] = rng.uniform(0.9, 1.0, n_decoys)
            feats[decoys, F_LOG_ERRORS] = rng.uniform(0.3, 0.7, n_decoys)

    if mode in ("missing_signals", "adversarial"):
        # per-(service, channel) dropout of the fault signals: each channel
        # is observed with probability ``dropout_keep`` (background survives
        # — missing data looks like *quiet*, not like zeroed noise).  Only
        # the RAW channels drop: SILENT is the analyzer's own derivation
        # from whatever WAS observed, not an independent observation.
        keep = rng.random((n_services, NUM_RAW)) < dropout_keep
        feats[:, :NUM_RAW] = np.where(
            keep, feats[:, :NUM_RAW], background
        ).astype(np.float32)

    derive_silent_channel(feats)
    # the naive max-anomaly baseline reads OBSERVED channels only: scoring
    # the derived SILENT channel would credit "naive" with the analyzer's
    # own engineered absence evidence (and break comparability with every
    # pre-round-4 naive row)
    anomaly = feats[:, :NUM_RAW].max(axis=1)
    names = None
    if n_services <= 4096:
        names = [f"svc-{i:05d}" for i in range(n_services)]
    return CascadeArrays(
        n=n_services,
        dep_src=dep_src,
        dep_dst=dep_dst,
        features=feats,
        roots=np.sort(roots),
        anomaly=anomaly.astype(np.float32),
        names=names,
        decoys=None if decoys is None else np.sort(decoys).astype(np.int32),
        hops=hops.astype(np.int64),
        # roots are returned sorted; reorder the parallel kinds list the
        # same way (fault assignment iterated the UNSORTED draw order,
        # which legacy-seed byte-stability forbids changing)
        root_kinds=[root_kinds[j] for j in np.argsort(roots)],
    )
