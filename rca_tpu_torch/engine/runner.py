"""GraphEngine: bucketing, device transfer, ranking, rendering.

Counterpart of the JAX package's ``engine/runner.py`` for one-shot
analysis.  The host pads node/edge arrays to shape buckets, builds the
seg-step layouts, moves everything to the engine's device, and runs one
ranked analysis (:func:`propagate_ranked`): the evidence front
(finite-mask sanitize, evidence pair and error-source contrast, two kernel
launches), 8 up-steps and 8 down-steps (one seg-step kernel launch each),
the score, top-k, and the ``[4, k]`` diagnostic gather.  Only top-k-sized
values cross to the host; the full ``[4, n_pad]`` stack stays on the
device behind the result's lazy diagnostics.

Device rule: ``GraphEngine()`` runs on ``cuda`` and raises where there is
no CUDA device; ``device="cpu"`` selects the plain versions of the kernels
explicitly (the tests).  Nothing falls back from one to the other.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from rca_tpu_torch.config import RCAConfig, bucket_for
from rca_tpu_torch.engine.params import PropagationParams, resolve_params
from rca_tpu_torch.engine.propagate import Propagation
from rca_tpu_torch.engine.segscan import build_seg_layouts


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


def topk_diag(stacked, idx):
    """Gather of the top-k columns of the ``[4, S]`` diagnostic stack."""
    return stacked[:, idx]


def top_k(score: torch.Tensor, k: int):
    """``(values, indices)`` of the ``k`` largest scores, ties broken
    lowest index first as ``jax.lax.top_k`` breaks them (``torch.topk``
    does not promise an order): a STABLE descending sort."""
    vals, idx = torch.sort(score, descending=True, stable=True)
    return vals[:k], idx[:k]


def propagate_ranked(model: Propagation, features, dep_dst, n_live: int,
                     kk: int, down_seg, up_seg):
    """One ranked analysis on the device from the raw padded features.
    Returns ``(stacked, diag, vals, idx, n_bad)``, all device tensors."""
    a, h, u, m, score, n_bad = model(features, dep_dst, n_live, down_seg,
                                     up_seg)
    vals, idx = top_k(score, kk)
    stacked = torch.stack([a, u, m, score])
    return stacked, topk_diag(stacked, idx), vals, idx, n_bad


class EngineResult:
    """One analysis result.  The ranked findings (top-k components with
    their diagnostic channels) are rendered eagerly from the ``[4, k]``
    fetch; the FULL per-service vectors (``anomaly``/``upstream``/
    ``impact``/``score``) are LAZY — the device-parked ``[4, n_pad]`` stack
    moves to the host on the first access."""

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
    ):
        self._service_names = service_names
        self.ranked = ranked
        self.latency_ms = latency_ms
        self.n_services = n_services
        self.n_edges = n_edges
        self.engine = engine
        self.sanitized_rows = int(sanitized_rows)
        self._stacked: Optional[np.ndarray] = None
        self._stacked_dev = stacked_dev

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
            self._stacked = self._stacked_dev.cpu().numpy()
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
        """Not ported yet: the attribution slice brings it."""
        raise ValueError(
            "attribution is not available in the PyTorch engine yet"
        )

    def top_components(self, k: Optional[int] = None) -> List[str]:
        items = self.ranked if k is None else self.ranked[:k]
        return [r["component"] for r in items]


def render_result(diag, vals, idx, names: Optional[Sequence[str]], n: int,
                  k: int, latency_ms: float, n_edges: int, engine: str,
                  sanitized_rows: int = 0,
                  stacked_dev: object = None) -> EngineResult:
    """Host-side rendering from the ``[4, kk]`` top-k gather (host numpy);
    pad slots (index >= n) are skipped.  Unnamed services render as
    ``svc-<i>``."""
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
    )


def _fetch(out):
    stacked, diag, vals, idx, n_bad = out
    # the top-k pair's .cpu() is the sync point; diag and n_bad are as small
    return (stacked, diag.cpu().numpy(), vals.cpu().numpy(),
            idx.cpu().numpy(), int(n_bad.cpu()))


def timed_fetch(run, timed: bool):
    """Run ``run()`` (which returns the five device values of
    :func:`propagate_ranked`) and fetch the top-k-sized ones.  ``timed``:
    one warm run, then the median host wall of 10 runs, each ending in the
    synchronizing top-k fetch."""
    if timed:
        _fetch(run())
        reps = []
        for _ in range(10):
            t0 = time.perf_counter()
            out = _fetch(run())
            reps.append((time.perf_counter() - t0) * 1e3)
        latency_ms = float(np.median(reps))
    else:
        t0 = time.perf_counter()
        out = _fetch(run())
        latency_ms = (time.perf_counter() - t0) * 1e3
    return (*out, latency_ms)


class EngineAPI:
    """The shared analyze call surface: every engine implements
    ``analyze_arrays``; these entry points exist once."""

    def analyze_arrays(self, features, dep_src, dep_dst, names=None,
                       k=None, timed=False) -> EngineResult:
        raise NotImplementedError

    def analyze_batch(self, features_batch, dep_src, dep_dst, names=None,
                      k=None) -> List[EngineResult]:
        """Score a batch of fault-hypothesis feature sets over ONE graph:
        a loop of :meth:`analyze_arrays`."""
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
                 params: Optional[PropagationParams] = None, device=None):
        self.device = resolve_device(device)
        self.config = config or RCAConfig()
        self.params = resolve_params(self.config, params)
        self.model = Propagation(self.params).to(self.device)
        self.plan = "kernels" if self.device.type == "cuda" else "plain"

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
        f, s, d = self._pad(np.asarray(features, np.float32), dep_src, dep_dst)
        n_pad, e_pad = f.shape[0], len(s)
        kk = min(k + 8, n_pad)
        dev = self.device
        down_seg, up_seg = build_seg_layouts(n_pad, e_pad, dep_src, dep_dst,
                                             device=dev)
        fd = torch.from_numpy(f).to(dev)
        dd = torch.from_numpy(d.astype(np.int64)).to(dev)

        def run():
            return propagate_ranked(self.model, fd, dd, n, kk, down_seg,
                                    up_seg)

        stacked, diag, vals, idx, n_bad, latency_ms = timed_fetch(run, timed)
        return render_result(
            diag, vals, idx, names, n, k, latency_ms, int(len(dep_src)),
            engine="single", sanitized_rows=n_bad, stacked_dev=stacked,
        )
