"""GraphEngine: bucketing, device transfer, the kernel plan, ranking,
rendering.

Counterpart of the JAX package's ``engine/runner.py`` for one-shot and
batched analysis. The host pads node/edge arrays to shape buckets, asks
the kernel registry which row this shape engages (:func:`kernel_plan`,
THE dispatch seam), builds that row's layouts on the engine's device,
and runs one ranked analysis (:func:`propagate_ranked`): the evidence
front, 8 up-steps and 8 down-steps, the score, top-k, and the ``[4, k]``
diagnostic gather. On the ``kernels`` row the front is one kernel
launch and each recursion one launch (one per step above the fused
kernels' capacity); on the ``torch`` row every op is plain PyTorch. A
hypothesis batch (:meth:`GraphEngine.analyze_batch`) runs the same body
on ``[B, n_pad, C]`` lanes of one graph: each launch covers the whole
batch. Only top-k-sized values cross to the host; the full ``[4,
n_pad]`` stack stays on the device behind the result's lazy diagnostics,
and the inputs stay behind its lazy attribution. With ``RCA_RESIDENT``
on (the default), ``analyze_arrays`` goes through a
:class:`rca_tpu_torch.engine.resident.ResidentCache`: a repeat call over
a known graph writes only its changed rows into a buffer pinned on the
device, bitwise equal to restaging. ``RCA_EDGE_LAYOUT`` picks the scans'
edge layout (:func:`plan_layout`): under ``ell`` a one-shot analysis
runs over the full-ELL tables (:mod:`.ell`) and skips the resident path,
and a batch loops over its lanes, as the reference's does.

Device rule: ``GraphEngine()`` runs on ``cuda`` and raises where there is
no CUDA device; ``device="cpu"`` runs on the CPU, where the registry picks
the ``torch`` row and ``RCA_KERNEL=kernels`` the kernels' plain versions.
Nothing falls back from one device to the other.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from rca_tpu_torch.config import (
    RCAConfig,
    bucket_for,
    edge_layout,
    resident_enabled,
)
from rca_tpu_torch.engine.ell import ell_tables_for, up_ell_for
from rca_tpu_torch.engine.fetch import device_get
from rca_tpu_torch.engine.params import PropagationParams, resolve_params
from rca_tpu_torch.engine.propagate import KernelPlan, Propagation
from rca_tpu_torch.engine.segscan import build_seg_layouts, steps_form


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names a device; raises when the named
    (or default) CUDA device does not exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on a CUDA device and none is available; pass "
            "device='cpu' to run the plain PyTorch versions of its kernels"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def kernel_plan(n_pad: int, e_pad: int, dep_src, dep_dst, device,
                steps: int = 8, variant: str = "dense") -> KernelPlan:
    """THE per-graph dispatch step, shared by every caller that stages a
    padded graph (one-shot analyze, the hypothesis batch, attribution, the
    resident and streaming sessions, the serve dispatcher): ask the
    registry which row this ``(n_pad, e_pad)`` shape engages on
    ``device`` (the forcing knob, the timings and the eligibility all live
    there), then build that row's layouts.  The edges are the RAW ones.

    The doubling row may decline a specific GRAPH (its frontiers pass the
    cap on hub-heavy topologies) even where the shape's row elected it;
    the plan then runs the device's default row (``registry.default_row``)
    and says so in ``plan.kernel``, so the stamped row is always the one
    that ran.  ``plan.layout`` is :func:`plan_layout`'s: under ``coo``
    (and ``ell``, whose one-shot tables only ``analyze_arrays`` runs) the
    plan carries no hybrid up-table.  ``plan.steps_form`` is the
    capacity decision of the ``kernels`` row (:func:`.segscan.steps_form`):
    on the CUDA ``device`` both recursions run as one launch each, with
    one CTA a lane where both layouts fit one CTA's shared memory
    (``cta``), else as one cooperative launch over the card (``grid``);
    the plan says which, and no launch falls back."""
    from rca_tpu_torch.engine.doubling import doubling_layouts_for
    from rca_tpu_torch.engine.registry import default_row, engaged_kernel

    layout = plan_layout()
    kernel = engaged_kernel(n_pad, e_pad, steps=steps, variant=variant,
                            device=device)
    down_seg, up_seg = build_seg_layouts(n_pad, e_pad, dep_src, dep_dst,
                                         device=device)
    dbl = None
    if kernel == "doubling":
        dbl = doubling_layouts_for(n_pad, e_pad, dep_src, dep_dst, steps,
                                   device=device)
        if dbl is None:
            kernel = default_row(device)
    up_ell = (up_ell_for(n_pad, dep_src, dep_dst, device)
              if kernel == "torch" and layout == "hybrid" else None)
    form = (steps_form(down_seg, up_seg, device) if kernel == "kernels"
            else "step")
    return KernelPlan(kernel, down_seg, up_seg, up_ell, dbl, layout, form)


def plan_layout() -> str:
    """The edge layout a staged plan runs: ``RCA_EDGE_LAYOUT``'s, with
    ``ell`` run in its ``coo`` form (only a one-shot analysis stages the
    full-ELL tables, as the reference's ``kernel_plan`` gives every other
    surface its COO form).  The sharded engine stages no plan here and
    keeps its per-shard steps under every layout, as the reference's
    does."""
    layout = edge_layout()
    return "coo" if layout == "ell" else layout


def propagate_auto(model: Propagation, features, dep_dst, n_live: int,
                   plan: KernelPlan, persist: bool = False, ell=None):
    """The propagation body behind every ranked surface (one-shot, the
    batch lanes, the batch delta, attribution, the resident request, the
    streaming tick): the plan's ``kernel`` picks the front and the steps in
    :mod:`.propagate`, so the engaged row cannot drift between the call
    surfaces.  ``persist`` (the streaming flush) leaves the sanitized rows
    in ``features``; ``ell`` (a one-shot analysis under
    ``RCA_EDGE_LAYOUT=ell``) runs the full-ELL recursions after the
    plan's front.  Returns ``(a, h, u, m, score, n_bad)``."""
    return model(features, dep_dst, n_live, plan, persist=persist, ell=ell)


def topk_diag(stacked, idx):
    """Gather of the top-k columns of the ``[4, S]`` diagnostic stack, or
    of each lane's ``[B, 4, S]`` stack at its own ``[B, k]`` indices."""
    if stacked.dim() == 2:
        return stacked[:, idx]
    return torch.gather(stacked, 2, idx[:, None, :].expand(
        -1, stacked.shape[1], -1))


def top_k(score: torch.Tensor, k: int):
    """``(values, indices)`` of the ``k`` largest scores of each lane (the
    last axis), ties broken lowest index first as ``jax.lax.top_k`` breaks
    them (``torch.topk`` does not promise an order): a STABLE descending
    sort."""
    vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def propagate_ranked(model: Propagation, features, dep_dst, n_live: int,
                     kk: int, plan: KernelPlan, persist: bool = False,
                     ell=None):
    """One ranked analysis on the device from the raw padded features, or
    each lane's of ``[B, n_pad, C]`` lanes.  Returns ``(stacked, diag,
    vals, idx, n_bad)``, all device tensors (``[4, n_pad]`` / ``[B, 4,
    n_pad]`` stacks, ``n_bad`` across the lanes).  ``persist`` and
    ``ell``: see :func:`propagate_auto`."""
    a, h, u, m, score, n_bad = propagate_auto(model, features, dep_dst,
                                              n_live, plan, persist, ell)
    vals, idx = top_k(score, kk)
    stacked = torch.stack([a, u, m, score], dim=-2)
    return stacked, topk_diag(stacked, idx), vals, idx, n_bad


def check_batch_delta(idx_b: np.ndarray, rows_b: np.ndarray, n_pad: int):
    """The batch delta's staging contract, checked on the host: ``idx_b``
    ``[B, U]`` rows within ``[0, n_pad)``, ``rows_b`` ``[B, U, C]``; pad
    slots aim at the dummy row ``n_pad - 1`` with zero rows, and the real
    rows of a lane are distinct.  Duplicate indices then all write the
    same zeros: a scatter with duplicates has no defined winner on CUDA."""
    idx_b = np.asarray(idx_b)
    rows_b = np.asarray(rows_b, np.float32)
    if idx_b.ndim != 2 or rows_b.shape[:2] != idx_b.shape:
        raise ValueError(f"batch delta: idx [B, U] and rows [B, U, C], got "
                         f"{idx_b.shape} and {rows_b.shape}")
    if idx_b.size and (idx_b.min() < 0 or idx_b.max() >= n_pad):
        raise ValueError(f"batch delta: row ids outside [0, {n_pad})")
    dummy = n_pad - 1
    pad = idx_b == dummy
    if np.any(rows_b[pad] != 0.0):
        raise ValueError("batch delta: a slot on the dummy row carries a "
                         "nonzero row")
    for lane, ids in enumerate(idx_b):
        real = ids[ids != dummy]
        if len(np.unique(real)) != len(real):
            raise ValueError(f"batch delta: lane {lane} repeats a row")
    return idx_b.astype(np.int64), rows_b


def propagate_ranked_batch_delta(model: Propagation, base, idx_b, rows_b,
                                 dep_dst, n_live: int, kk: int,
                                 plan: KernelPlan):
    """A delta-staged hypothesis batch: each lane is the device-resident
    ``[n_pad, C]`` base buffer with that lane's rows ``idx_b[b]`` replaced
    by ``rows_b[b]`` (device tensors from host arrays that passed
    :func:`check_batch_delta`), scattered on the device, so the host sends
    the ``[B, U]`` ids and ``[B, U, C]`` rows instead of ``[B, n_pad, C]``.
    ``base`` is read, never written.  The ranked body is
    :func:`propagate_ranked`'s, so each lane is bitwise equal to full
    staging of the same features."""
    lanes, n_pad = idx_b.shape[0], base.shape[0]
    features_b = base.expand(lanes, *base.shape).clone()
    # one index_copy_ over the lanes' rows, as a delta tick writes its
    # buffer (no host sync); the duplicates are pad slots, all zeros
    lane = torch.arange(lanes, device=base.device)[:, None] * n_pad
    features_b.view(-1, base.shape[1]).index_copy_(
        0, (lane + idx_b).reshape(-1), rows_b.reshape(-1, base.shape[1]))
    return propagate_ranked(model, features_b, dep_dst, n_live, kk, plan)


class EngineResult:
    """One analysis result.  The ranked findings (top-k components with
    their diagnostic channels) are rendered eagerly from the ``[4, k]``
    fetch; the FULL per-service vectors (``anomaly``/``upstream``/
    ``impact``/``score``) are LAZY — the device-parked ``[4, n_pad]`` stack
    moves to the host on the first access — and so is the causelens
    provenance block (:meth:`attribution`), computed from the retained
    inputs on first call.  ``kernel`` and ``layout`` stamp the registry
    row and the edge layout this call ran (None on a surface that stages
    no plan, the sharded engine's)."""

    def __init__(
        self,
        service_names: Optional[List[str]],
        ranked: List[dict],
        latency_ms: float,
        n_services: int,
        n_edges: int,
        engine: str = "single",
        sanitized_rows: int = 0,
        stacked_dev: object = None,
        attribution_ctx: object = None,
        kernel: Optional[str] = None,
        layout: Optional[str] = None,
    ):
        self._service_names = service_names
        self.ranked = ranked
        self.latency_ms = latency_ms
        self.n_services = n_services
        self.n_edges = n_edges
        self.engine = engine
        self.sanitized_rows = int(sanitized_rows)
        self.kernel = kernel
        self.layout = layout
        self._stacked: Optional[np.ndarray] = None
        self._stacked_dev = stacked_dev
        self._attribution_ctx = attribution_ctx
        self._provenance: Optional[dict] = None

    @property
    def service_names(self) -> List[str]:
        """The services' names: ``svc-<i>`` where the input carried none,
        built on first access (50k of them cost milliseconds, which the
        analyze path does not pay)."""
        if self._service_names is None:
            self._service_names = [f"svc-{i}" for i in range(self.n_services)]
        return self._service_names

    def full_diagnostics(self) -> np.ndarray:
        """The ``[4, n_pad]`` host stack (a, u, m, score), fetched from the
        device on first use — the deferred bulk fetch, off the hot path."""
        if self._stacked is None:
            if self._stacked_dev is None:
                raise ValueError("EngineResult carries no diagnostic stack")
            stacked = self._stacked_dev
            # a sharded stack joins its shards' blocks on the host
            self._stacked = (device_get(stacked) if torch.is_tensor(stacked)
                             else stacked.numpy())
            self._stacked_dev = None
        return self._stacked

    @property
    def anomaly(self) -> np.ndarray:       # [S]
        return np.asarray(self.full_diagnostics()[0][: self.n_services])

    @property
    def upstream(self) -> np.ndarray:      # [S]
        return np.asarray(self.full_diagnostics()[1][: self.n_services])

    @property
    def impact(self) -> np.ndarray:        # [S]
        return np.asarray(self.full_diagnostics()[2][: self.n_services])

    @property
    def score(self) -> np.ndarray:         # [S]
        return np.asarray(self.full_diagnostics()[3][: self.n_services])

    def attribution(self, paths: Optional[int] = None,
                    topm: Optional[int] = None) -> dict:
        """The causelens provenance block for THIS ranking: per-channel
        evidence contributions, counterfactual evidence rows, blame paths
        and gradient saliency for every ranked candidate, computed on the
        engine's device on first call and cached for the default
        arguments.  Raises ``ValueError`` on a result that retained no
        inputs."""
        default_args = paths is None and topm is None
        if self._provenance is not None and default_args:
            return self._provenance
        if self._attribution_ctx is None:
            raise ValueError("EngineResult carries no attribution context")
        from rca_tpu_torch.engine.attribution import compute_attribution
        from rca_tpu_torch.observability.causelens import provenance_block

        block = compute_attribution(self._attribution_ctx, self.ranked,
                                    paths=paths, topm=topm)
        out = provenance_block(block, engine=self.engine)
        if default_args:
            self._provenance = out
        return out

    def top_components(self, k: Optional[int] = None) -> List[str]:
        items = self.ranked if k is None else self.ranked[:k]
        return [r["component"] for r in items]


def render_result(diag, vals, idx, names: Optional[Sequence[str]], n: int,
                  k: int, latency_ms: float, n_edges: int, engine: str,
                  sanitized_rows: int = 0, stacked_dev: object = None,
                  attribution_ctx: object = None,
                  plan: Optional[KernelPlan] = None) -> EngineResult:
    """Host-side rendering from the ``[4, kk]`` top-k gather (host numpy);
    pad slots (index >= n) are skipped.  Unnamed services render as
    ``svc-<i>``.  ``attribution_ctx`` (:func:`make_attribution_ctx`) is
    what the result's lazy :meth:`EngineResult.attribution` runs on;
    ``plan`` stamps its row and layout on the result."""
    diag = np.asarray(diag)
    names = list(names) if names is not None else None
    ranked = []
    for j, i in enumerate(np.asarray(idx).tolist()):
        if i >= n or len(ranked) >= k:
            continue
        ranked.append(
            {
                "component": names[i] if names is not None else f"svc-{i}",
                "score": float(vals[j]),
                "anomaly": float(diag[0, j]),
                "explained_by_upstream": float(diag[1, j]),
                "downstream_impact": float(diag[2, j]),
            }
        )
    return EngineResult(
        service_names=names,
        ranked=ranked,
        latency_ms=latency_ms,
        n_services=n,
        n_edges=n_edges,
        engine=engine,
        sanitized_rows=int(sanitized_rows),
        stacked_dev=stacked_dev,
        attribution_ctx=attribution_ctx,
        kernel=None if plan is None else plan.kernel,
        layout=None if plan is None else plan.layout,
    )


def make_attribution_ctx(features, dep_src, dep_dst, params, names,
                         shape_buckets, device):
    """The one constructor every render surface uses to retain the inputs
    of its lazy attribution: the raw arrays, the resolved params, the
    shape tiers and the device the engine ran on."""
    from rca_tpu_torch.engine.attribution import AttributionContext

    return AttributionContext(
        features=np.asarray(features, np.float32),
        dep_src=np.asarray(dep_src, np.int32),
        dep_dst=np.asarray(dep_dst, np.int32),
        params=params,
        names=list(names) if names is not None else None,
        shape_buckets=tuple(shape_buckets),
        device=device,
    )


def finite_mask_rows_np(features: np.ndarray):
    """Host-side finite mask for paths that stage from the host anyway
    (the sharded engine, its resident and streaming sessions): every row
    carrying a NaN/Inf zeroed in a COPY; returns ``(clean, n_bad)``, the
    zeroing of the device's sanitize."""
    features = np.asarray(features, np.float32)
    ok = np.all(np.isfinite(features), axis=-1)
    if ok.all():
        return features, 0
    clean = features.copy()
    clean[~ok] = 0.0
    return clean, int(np.sum(~ok))


def upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without a host sync: on a card, staged in
    pinned memory and copied non-blocking on the current stream (so it is
    ordered before every later launch there); on the CPU, the array's own
    memory."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def timed_fetch(run, timed: bool):
    """Run ``run()`` (which returns the five device values of
    :func:`propagate_ranked`) and fetch the top-k-sized ones; the ``[4,
    n_pad]`` stack stays on the device.  ``timed``: one warm run (the
    shape's election, the kernel library's build; the port compiles
    nothing ahead of time, so it ends in a top-k pair fetch), then the
    median host wall of 10 runs, each ending in the synchronizing fetch of
    the top-k pair, and the last run's ``[4, kk]`` gather and bad-row count
    fetched once.  Indices cross as int32, cast on the device."""
    if timed:
        out = run()
        device_get(out[2], out[3].to(torch.int32))
        reps = []
        for _ in range(10):
            t0 = time.perf_counter()
            stacked, diag, vals, idx, n_bad = run()
            vals, idx = device_get(vals, idx.to(torch.int32))
            reps.append((time.perf_counter() - t0) * 1e3)
        latency_ms = float(np.median(reps))
        diag, n_bad = device_get(diag, n_bad)
    else:
        t0 = time.perf_counter()
        stacked, diag, vals, idx, n_bad = run()
        diag, vals, idx, n_bad = device_get(diag, vals, idx.to(torch.int32),
                                            n_bad)
        latency_ms = (time.perf_counter() - t0) * 1e3
    return stacked, diag, vals, idx, int(n_bad), latency_ms


class EngineAPI:
    """The shared analyze call surface: every engine implements
    ``analyze_arrays``; these entry points exist once."""

    def analyze_arrays(self, features, dep_src, dep_dst, names=None,
                       k=None, timed=False) -> EngineResult:
        raise NotImplementedError

    def analyze_batch(self, features_batch, dep_src, dep_dst, names=None,
                      k=None) -> List[EngineResult]:
        """Score a batch of fault-hypothesis feature sets over ONE graph.
        Default: a loop of :meth:`analyze_arrays`; engines with a batched
        body override it."""
        return [
            self.analyze_arrays(f, dep_src, dep_dst, names, k=k)
            for f in features_batch
        ]

    def analyze_case(self, case, k: Optional[int] = None, timed: bool = False):
        """Analyze a :class:`rca_tpu_torch.cluster.generator.CascadeArrays`
        (or anything with the same fields)."""
        return self.analyze_arrays(
            case.features, case.dep_src, case.dep_dst, case.names,
            k=k, timed=timed,
        )

    def analyze_snapshot(self, snapshot,
                         k: Optional[int] = None) -> EngineResult:
        """Analyze a :class:`rca_tpu_torch.cluster.snapshot.ClusterSnapshot`:
        extract its features, condense its dependency edges, rank."""
        from rca_tpu_torch.features.extract import extract_features
        from rca_tpu_torch.graph.build import service_dependency_edges

        fs = extract_features(snapshot)
        src, dst = service_dependency_edges(snapshot, fs)
        return self.analyze_features(fs, src, dst, k=k)

    def analyze_features(self, fs, src: np.ndarray, dst: np.ndarray,
                         k: Optional[int] = None) -> EngineResult:
        """Analyze an extracted feature set (``service_features`` and
        ``service_names`` attributes) over its dependency edges."""
        return self.analyze_arrays(
            fs.service_features, src, dst, fs.service_names, k=k
        )


class GraphEngine(EngineAPI):
    """Bucketed causal propagation on one device."""

    def __init__(self, config: Optional[RCAConfig] = None,
                 params: Optional[PropagationParams] = None, device=None,
                 resident: Optional[bool] = None):
        self.device = resolve_device(device)
        self.config = config or RCAConfig()
        self.params = resolve_params(self.config, params)
        self.model = Propagation(self.params).to(self.device)
        # device-resident sessions: a repeat analyze call over a known
        # graph uploads only its changed rows into a buffer pinned on the
        # device.  ``resident=None`` follows RCA_RESIDENT (default on;
        # the results are bitwise equal either way)
        self._resident_cache = None
        if resident if resident is not None else resident_enabled():
            from rca_tpu_torch.engine.resident import ResidentCache

            self._resident_cache = ResidentCache(self)

    # -- shaping -----------------------------------------------------------
    def _pad(self, features: np.ndarray, src: np.ndarray, dst: np.ndarray):
        n = features.shape[0]
        # reserve one dummy slot so padded edges can self-loop harmlessly
        n_pad = bucket_for(n + 1, self.config.shape_buckets)
        e_pad = bucket_for(max(len(src), 1), self.config.shape_buckets)
        dummy = n_pad - 1
        f = np.zeros((n_pad, features.shape[1]), dtype=np.float32)
        f[:n] = features
        s = np.full(e_pad, dummy, dtype=np.int32)
        d = np.full(e_pad, dummy, dtype=np.int32)
        s[: len(src)] = src
        d[: len(dst)] = dst
        return f, s, d

    def plan_for(self, n_pad: int, e_pad: int, dep_src, dep_dst,
                 variant: str = "dense") -> KernelPlan:
        """The kernel plan of one padded graph on this engine's device."""
        return kernel_plan(n_pad, e_pad, dep_src, dep_dst, self.device,
                           steps=self.params.steps, variant=variant)

    def _attribution_ctx(self, features, dep_src, dep_dst, names):
        return make_attribution_ctx(features, dep_src, dep_dst, self.params,
                                    names, self.config.shape_buckets,
                                    self.device)

    # -- core --------------------------------------------------------------
    def analyze_arrays(
        self,
        features: np.ndarray,
        dep_src: np.ndarray,
        dep_dst: np.ndarray,
        names: Optional[Sequence[str]] = None,
        k: Optional[int] = None,
        timed: bool = False,
    ) -> EngineResult:
        n = features.shape[0]
        k = k or min(self.config.top_k_root_causes, n)
        full_ell = edge_layout() == "ell"
        if self._resident_cache is not None and not timed and not full_ell:
            # the resident path; ``timed`` keeps the restaged method, and
            # the full-ELL tables have no resident twin (the reference's
            # neither)
            return self._resident_cache.analyze(features, dep_src, dep_dst,
                                                names, k)
        f, s, d = self._pad(np.asarray(features, np.float32), dep_src, dep_dst)
        n_pad, e_pad = f.shape[0], len(s)
        kk = min(k + 8, n_pad)
        dev = self.device
        plan = self.plan_for(n_pad, e_pad, dep_src, dep_dst)
        ell = None
        if full_ell:
            # the row's front over the plan's up layout, then the
            # recursions over the width-capped tables
            ell = ell_tables_for(n_pad, dep_src, dep_dst, dev)
            plan = plan._replace(layout="ell")
        fd = torch.from_numpy(f).to(dev)
        dd = torch.from_numpy(d.astype(np.int64)).to(dev)

        def run():
            return propagate_ranked(self.model, fd, dd, n, kk, plan, ell=ell)

        stacked, diag, vals, idx, n_bad, latency_ms = timed_fetch(run, timed)
        return render_result(
            diag, vals, idx, names, n, k, latency_ms, int(len(dep_src)),
            engine="single", sanitized_rows=n_bad, stacked_dev=stacked,
            attribution_ctx=self._attribution_ctx(features, dep_src, dep_dst,
                                                  names),
            plan=plan,
        )

    def analyze_batch(
        self,
        features_batch: np.ndarray,
        dep_src: np.ndarray,
        dep_dst: np.ndarray,
        names: Optional[Sequence[str]] = None,
        k: Optional[int] = None,
    ) -> List[EngineResult]:
        """Score ``[B, S, C]`` fault-hypothesis feature sets over ONE graph
        in one ranked dispatch: the lanes share the plan, and on the
        ``kernels`` row every kernel launches for the whole batch: once
        each, the recursions in the form ``KernelPlan.steps_form``
        names (one CTA a lane up to 2047 services, the card's grid
        above).
        Each lane is bitwise equal to :meth:`analyze_arrays` of its
        features; ``latency_ms`` is the batch's wall over B, and
        ``sanitized_rows`` counts across the batch (a poisoned row poisons
        every hypothesis built from the same snapshot)."""
        if edge_layout() == "ell":
            # the full-ELL tables have no batched body: a loop of solo
            # analyses, so every lane is its solo run (the reference's
            # loop too)
            return super().analyze_batch(features_batch, dep_src, dep_dst,
                                         names, k=k)
        features_batch = np.asarray(features_batch, np.float32)
        lanes, n = features_batch.shape[0], features_batch.shape[1]
        k = k or min(self.config.top_k_root_causes, n)
        f0, s, d = self._pad(features_batch[0], dep_src, dep_dst)
        n_pad, e_pad = f0.shape[0], len(s)
        fb = np.zeros((lanes, n_pad, f0.shape[1]), np.float32)
        fb[:, :n] = features_batch
        # the batch runs the solo row: the port's front and seg steps have
        # lane-batched launches (the reference keeps its Pallas front off
        # the batch path, having no vmap twin of it)
        plan = self.plan_for(n_pad, e_pad, dep_src, dep_dst)
        kk = min(k + 8, n_pad)
        dev = self.device
        t0 = time.perf_counter()
        fd = torch.from_numpy(fb).to(dev)
        dd = torch.from_numpy(d.astype(np.int64)).to(dev)
        stacked, diag, vals, idx, n_bad = propagate_ranked(
            self.model, fd, dd, n, kk, plan)
        diag, vals, idx, n_bad = device_get(diag, vals, idx.to(torch.int32),
                                            n_bad)
        latency_ms = (time.perf_counter() - t0) * 1e3
        return [
            render_result(
                diag[b], vals[b], idx[b], names, n, k, latency_ms / lanes,
                int(len(dep_src)), engine="single-batch",
                sanitized_rows=n_bad, stacked_dev=stacked[b],
                attribution_ctx=self._attribution_ctx(
                    features_batch[b], dep_src, dep_dst, names),
                plan=plan,
            )
            for b in range(lanes)
        ]
