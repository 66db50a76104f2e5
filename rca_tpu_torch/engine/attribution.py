"""causelens core: why the engine ranked what it ranked.

Counterpart of the JAX package's ``engine/attribution.py``.  For each
ranked candidate the provenance block decomposes the combined score into
the terms that built it:

- **channel contributions**: the noisy-OR is a product of per-channel
  survival factors, so each channel's ``w_c * clip(f_c)`` (and the
  error-source contrast as a 14th channel) rebuilds the anomaly evidence,
  and ``a * impact_factor * suppression_factor`` rebuilds the score;
- **counterfactual evidence rows**: the propagation re-run with each of the
  top-M evidence rows zeroed, all M as lanes of one batched run, and each
  candidate's score drop;
- **blame paths**: per candidate, a greedy walk over the dependency edges
  following the up-scan's own term ``max(h_d, g*u_d)``;
- **gradient saliency**: ``d(sum of candidate scores)/d(features)`` by
  autograd through the same body, the candidates' channel gradients and
  the top-M rows by gradient L1 norm.

The sweep needs no gradient: it runs the registry's ``dense`` row, on the
card the kernels, the M counterfactual lanes as one lane-batched launch
per kernel and step.  The saliency runs the ``attribution`` variant, the
``torch`` row: the plain-op body is differentiable, and it splits a
gradient at ties (clip, max, the relu of the excess, the median) the way
the reference's ``xla`` body does; the kernels have no backward kernel.
Only top-k / top-m-sized values leave the device.  The block holds no wall time,
so two runs give identical blocks; the sweep's cost goes to the registry
row through ``note_timing``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from rca_tpu_torch.config import (
    RCAConfig,
    bucket_for,
    explain_paths,
    explain_topm,
)
from rca_tpu_torch.engine.fetch import device_get
from rca_tpu_torch.features.schema import SERVICE_FEATURE_NAMES, SvcF

#: provenance block schema (bumped whenever the block layout changes)
ATTRIBUTION_SCHEMA = 1


@dataclasses.dataclass
class AttributionContext:
    """Everything a lazy ``EngineResult.attribution()`` needs: the RAW
    request arrays, the engine's resolved params, its shape tiers and its
    device."""

    features: np.ndarray             # [S, C] raw request features (host)
    dep_src: np.ndarray              # [E] int32
    dep_dst: np.ndarray              # [E] int32
    params: Any                      # engine.params.PropagationParams
    names: Optional[Sequence[str]] = None
    shape_buckets: tuple = RCAConfig.shape_buckets
    device: Any = "cpu"


def attribution_sweep(model, features, dep_src, dep_dst, plan, n_live: int,
                      cand_idx, mask_rows, path_len: int = 4):
    """The base propagation, the M counterfactual lanes (one batched run)
    and the blame walk over the padded ``[n_pad, C]`` features and
    ``[e_pad]`` int64 edges, all on the features' device, on ``plan``'s
    row.  Returns top-k / top-m-sized tensors:

    - ``diag``       [5, K]  (a, h, u, m, score) at the candidates;
    - ``deltas``     [M, K]  base score minus the score with evidence row
                             ``mask_rows[j]`` zeroed;
    - ``path_edge``  [K, P]  edge index per hop (-1 = the walk stopped);
    - ``path_term``  [K, P]  the up-term ``max(h_d, g*u_d)`` of the hop;
    - ``path_dst``   [K, P]  the blamed dependency per hop;
    - ``path_hard`` / ``path_up``  [K, P]  h / u at that dependency.
    """
    from rca_tpu_torch.engine.evidence import finite_mask_rows
    from rca_tpu_torch.engine.runner import propagate_auto

    features, _ = finite_mask_rows(features)
    a, h, u, m, score, _ = propagate_auto(model, features, dep_dst, n_live,
                                          plan)
    diag = torch.stack([a, h, u, m, score])[:, cand_idx]

    # the counterfactual lanes: lane j has evidence row mask_rows[j] zeroed
    n_rows = mask_rows.shape[0]
    lanes = features.expand(n_rows, *features.shape).clone()
    lanes[torch.arange(n_rows, device=features.device), mask_rows] = 0.0
    masked = propagate_auto(model, lanes, dep_dst, n_live, plan)[4]
    deltas = score[cand_idx][None, :] - masked[:, cand_idx]

    # the blame walk: each hop follows the dependency edge whose up-term is
    # largest (the first such edge), the quantity the up-scan propagated
    term_all = torch.maximum(h[dep_dst], model.decay * u[dep_dst])
    neg_inf = torch.tensor(-float("inf"), device=features.device)
    cur = cand_idx.clone()
    edges, terms = [], []
    for _ in range(path_len):
        term = torch.where(dep_src[None, :] == cur[:, None],
                           term_all[None, :], neg_inf)
        j = torch.argmax(term, dim=1)
        t = term.gather(1, j[:, None])[:, 0]
        live = t > 0.0
        edges.append(torch.where(live, j, -1))
        terms.append(torch.where(live, t, 0.0))
        cur = torch.where(live, dep_dst[j], cur)
    path_edge = torch.stack(edges, dim=1)
    path_term = torch.stack(terms, dim=1)
    path_dst = dep_dst[path_edge.clamp(0, dep_dst.shape[0] - 1)]
    return (diag, deltas, path_edge, path_term, path_dst, h[path_dst],
            u[path_dst])


def attribution_saliency(model, features, dep_dst, plan, n_live: int,
                         cand_idx, m: int = 8):
    """Gradient saliency over the propagation, by autograd: ``d(sum of
    candidate scores)/d(features)`` through the sanitize and the ``torch``
    row.  Returns the candidates' own channel gradients ``[K, C]`` and the
    top-``m`` rows by gradient L1 norm (values and indices, ties lowest
    index first)."""
    from rca_tpu_torch.engine.evidence import finite_mask_rows
    from rca_tpu_torch.engine.runner import propagate_auto, top_k

    x = features.detach().clone().requires_grad_(True)
    clean, _ = finite_mask_rows(x)
    score = propagate_auto(model, clean, dep_dst, n_live, plan)[4]
    (sal,) = torch.autograd.grad(score[cand_idx].sum(), x)
    vals, idx = top_k(sal.abs().sum(dim=1), m)
    return sal[cand_idx], vals, idx


def _error_source_excess_np(clipped: np.ndarray, dep_src, dep_dst):
    """Host twin of the error-source excess over ALREADY-clipped features:
    the channel-decomposition mirror of the error-contrast channel."""
    e = clipped[:, SvcF.ERROR_RATE].astype(np.float32)
    dep_max = np.zeros_like(e)
    src = np.asarray(dep_src, np.int64)
    dst = np.asarray(dep_dst, np.int64)
    if len(src):
        np.maximum.at(dep_max, src, e[dst])
    return np.maximum(e - dep_max, 0.0)


def _int32(tensors):
    """Index tensors cast to int32 on the device before they cross to the
    host, as the fetch contract declares them (half the bytes of int64)."""
    return [t.to(torch.int32) if t.dtype == torch.int64 else t
            for t in tensors]


def _f32(x) -> float:
    return float(np.float32(x))


def compute_attribution(ctx: AttributionContext, ranked: List[dict],
                        k: Optional[int] = None, paths: Optional[int] = None,
                        topm: Optional[int] = None) -> Dict[str, Any]:
    """The attribution entry point: pad like the engine, run the sweep on
    the registry's ``dense`` row (``kernel`` in the block) and the saliency
    on its ``attribution`` row, on the context's device, and assemble the
    schema-versioned block.  ``ranked``
    is the engine's rendered ranking (the candidates to explain); entries
    whose component is not a live service are skipped."""
    from rca_tpu_torch.engine.propagate import Propagation
    from rca_tpu_torch.engine.registry import get_registry
    from rca_tpu_torch.engine.runner import kernel_plan
    from rca_tpu_torch.engine.params import SCORE_FORMULA_VERSION

    t0 = time.perf_counter()
    p = ctx.params
    device = torch.device(ctx.device)
    feats = np.asarray(ctx.features, np.float32)
    n = int(feats.shape[0])
    names = (list(ctx.names) if ctx.names is not None
             else [f"svc-{i}" for i in range(n)])
    paths = explain_paths() if paths is None else max(1, int(paths))
    topm = explain_topm() if topm is None else max(1, int(topm))
    index = {nm: i for i, nm in enumerate(names)}
    cand = [index[r["component"]] for r in ranked
            if r.get("component") in index]
    if k is not None:
        cand = cand[: max(1, int(k))]
    block: Dict[str, Any] = {
        "schema": ATTRIBUTION_SCHEMA,
        "k": len(cand), "topm": int(topm), "paths": int(paths),
        "n_services": n, "n_edges": int(len(ctx.dep_src)),
        "candidates": [],
        "score_formula_version": SCORE_FORMULA_VERSION,
    }
    if not cand:
        block["kernel"] = None
        block["evidence_rows"] = []
        return block

    # pad exactly like GraphEngine._pad (same tiers, same dummy slot)
    n_pad = bucket_for(n + 1, ctx.shape_buckets)
    e_pad = bucket_for(max(len(ctx.dep_src), 1), ctx.shape_buckets)
    dummy = n_pad - 1
    f = np.zeros((n_pad, feats.shape[1]), np.float32)
    f[:n] = feats
    s = np.full(e_pad, dummy, np.int64)
    d = np.full(e_pad, dummy, np.int64)
    s[: len(ctx.dep_src)] = np.asarray(ctx.dep_src)
    d[: len(ctx.dep_dst)] = np.asarray(ctx.dep_dst)

    src32 = np.asarray(ctx.dep_src, np.int32)
    dst32 = np.asarray(ctx.dep_dst, np.int32)
    sweep_plan = kernel_plan(n_pad, e_pad, src32, dst32, device,
                             steps=p.steps)
    grad_plan = kernel_plan(n_pad, e_pad, src32, dst32, device,
                            steps=p.steps, variant="attribution")
    block["kernel"] = sweep_plan.kernel
    aw_np, hw_np = p.weight_arrays()
    model = Propagation(p).to(device)

    # host channel decomposition over the SANITIZED features (a row with
    # a NaN/Inf counts as zeros, as in the device pass)
    clean = np.where(np.isfinite(feats).all(axis=-1, keepdims=True), feats,
                     np.float32(0.0))
    clipped = np.clip(clean, 0.0, 1.0).astype(np.float32)
    err = _error_source_excess_np(clipped, ctx.dep_src, ctx.dep_dst)
    a0 = (1.0 - np.prod(np.float32(1.0) - clipped * aw_np[None, :], axis=1,
                        dtype=np.float32)).astype(np.float32)
    if p.error_contrast:
        a_host = (1.0 - (1.0 - a0)
                  * (1.0 - np.float32(p.error_contrast) * err)
                  ).astype(np.float32)
    else:
        a_host = a0

    # counterfactual mask set: the top-M evidence rows by anomaly, in a
    # stable order
    m_rows = int(min(topm, n))
    mask_rows = np.argsort(-a_host, kind="stable")[:m_rows]

    fd = torch.from_numpy(f).to(device)
    sd = torch.from_numpy(s).to(device)
    dd = torch.from_numpy(d).to(device)
    cand_t = torch.tensor(cand, dtype=torch.int64, device=device)
    with torch.no_grad():
        out = attribution_sweep(
            model, fd, sd, dd, sweep_plan, n, cand_t,
            torch.from_numpy(mask_rows.astype(np.int64)).to(device),
            path_len=paths)
    (diag, deltas, path_edge, path_term, path_dst, path_hard,
     path_up) = device_get(*_int32(out))

    sal_cand = sal_vals = sal_idx = None
    saliency_note = None
    try:
        sal_cand, sal_vals, sal_idx = device_get(*_int32(attribution_saliency(
            model, fd, dd, grad_plan, n, cand_t, m=min(m_rows, n_pad))))
    except Exception as exc:  # noqa: BLE001 - saliency is best-effort
        # the counterfactual and channel attribution stand; the block
        # says why the gradient is missing
        saliency_note = f"{type(exc).__name__}: {exc}"

    block["evidence_rows"] = [
        {"row": int(r), "component": names[int(r)],
         "anomaly": _f32(a_host[int(r)])}
        for r in mask_rows
    ]
    for rank, i in enumerate(cand):
        a_dev, h_v, u_v, m_v, score = (_f32(diag[c, rank])
                                       for c in range(5))
        channels = []
        for c, cname in enumerate(SERVICE_FEATURE_NAMES):
            contrib = float(np.float32(aw_np[c] * clipped[i, c]))
            if contrib == 0.0 and clipped[i, c] == 0.0:
                continue
            channels.append({
                "channel": cname,
                "value": _f32(clipped[i, c]),
                "weight": _f32(aw_np[c]),
                "hard_weight": _f32(hw_np[c]),
                "contribution": contrib,
            })
        if p.error_contrast:
            channels.append({
                "channel": "error_contrast",
                "value": _f32(err[i]),
                "weight": _f32(p.error_contrast),
                "hard_weight": 0.0,
                "contribution": _f32(np.float32(p.error_contrast) * err[i]),
            })
        # completeness: the channels' survival product rebuilds a, and
        # a * impact_factor * suppression_factor rebuilds the score
        surv = np.float32(1.0)
        for ch in channels:
            surv = np.float32(surv * np.float32(1.0 - ch["contribution"]))
        a_rec = float(np.float32(1.0) - surv)
        impact_factor = 1.0 + float(p.impact_bonus) * float(np.tanh(m_v))
        suppression = 1.0 - (float(p.explain_strength) * u_v * (1.0 - h_v))
        reconstructed = a_rec * impact_factor * suppression
        counterfactuals = sorted(
            ({
                "row": int(mask_rows[j]),
                "component": names[int(mask_rows[j])],
                "self": bool(int(mask_rows[j]) == i),
                "score_drop": _f32(deltas[j, rank]),
            } for j in range(m_rows)),
            key=lambda e: -e["score_drop"],
        )
        path = []
        for hop in range(paths):
            if int(path_edge[rank, hop]) < 0:
                break
            dst = int(path_dst[rank, hop])
            path.append({
                "to": names[dst] if dst < n else f"row-{dst}",
                "row": dst,
                "term": _f32(path_term[rank, hop]),
                "hard": _f32(path_hard[rank, hop]),
                "upstream": _f32(path_up[rank, hop]),
            })
        entry: Dict[str, Any] = {
            "component": names[i], "row": int(i), "rank": rank + 1,
            "score": score,
            "anomaly": a_dev, "hard": h_v, "upstream": u_v,
            "impact_mean": m_v,
            "factors": {
                "evidence": a_rec,
                "impact": _f32(impact_factor),
                "suppression": _f32(suppression),
            },
            "channels": channels,
            "reconstructed_score": _f32(reconstructed),
            "reconstruction_error": _f32(abs(reconstructed - score)),
            "counterfactuals": counterfactuals,
            "blame_path": path,
        }
        if sal_cand is not None:
            entry["saliency"] = {"channels": {
                SERVICE_FEATURE_NAMES[c]: _f32(sal_cand[rank, c])
                for c in range(sal_cand.shape[1])
                if float(sal_cand[rank, c]) != 0.0
            }}
        block["candidates"].append(entry)
    if sal_idx is not None:
        block["saliency_rows"] = [
            {"row": int(r),
             "component": names[int(r)] if int(r) < n else f"row-{int(r)}",
             "grad_l1": _f32(v)}
            for v, r in zip(sal_vals, sal_idx)
            if int(r) < n and float(v) != 0.0
        ]
    elif saliency_note is not None:
        block["saliency_unavailable"] = saliency_note
    get_registry().note_timing(
        n_pad, e_pad, "attribution", (time.perf_counter() - t0) * 1e3,
        variant="attribution", steps=p.steps, device=device,
    )
    return block
