"""ShardedGraphEngine: the node-sharded engine behind the analyze boundary.

Counterpart of the JAX package's ``engine/sharded_runner.py``.
:class:`ShardedGraphEngine` has the :class:`GraphEngine` call surface
(``analyze_arrays`` / ``analyze_batch`` / ``analyze_features`` /
``analyze_snapshot`` / ``analyze_case``) and runs through
:mod:`rca_tpu_torch.parallel.sharded`: nodes split over the mesh's ``sp``
axis, the collectives between the shards, the cross-shard top-k merged on
the device.  :func:`make_engine` is the selector the analyze path calls:
sharded when ``RCA_SHARD`` asks for it or more than one device is
visible, single-device otherwise.

The mesh is one process over an explicit device list
(:mod:`rca_tpu_torch.parallel.mesh`).  ``RCA_SHARD`` counts the devices
that are there: every CUDA device, or the one CPU for ``device="cpu"``.
Several logical shards on one device come only from an explicit
``mesh=``.

Shapes follow the dense engine: the node axis pads to the same shape tier
(then up to a multiple of sp), the per-shard edge rows to a bucketed
length.  The host's finite mask sanitizes the rows before they stage (as
the reference's sharded engine does), so ``sanitized_rows`` is a host
count.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from rca_tpu_torch.config import (
    RCAConfig,
    bucket_for,
    env_str,
    resident_enabled,
)
from rca_tpu_torch.engine.params import PropagationParams, resolve_params
from rca_tpu_torch.engine.runner import (
    EngineAPI,
    EngineResult,
    GraphEngine,
    finite_mask_rows_np,
    make_attribution_ctx,
    render_result,
    resolve_device,
    timed_fetch,
)


class ShardConfigError(ValueError):
    """A misconfigured RCA_SHARD (malformed spec, impossible device
    count): an OPERATOR error the correlation path surfaces loudly, unlike
    runtime engine failures which degrade to the deterministic backend."""


def parse_shard_spec(spec: str, n_devices: int) -> Dict[str, int]:
    """``"sp=4,dp=2"`` → {"sp": 4, "dp": 2}; ``"auto"``/``"1"`` put every
    device on the node axis (dp=1: the analyze path ranks ONE snapshot)."""
    spec = (spec or "").strip().lower()
    if spec in ("", "auto", "1", "on", "true"):
        return {"sp": n_devices, "dp": 1}
    axes: Dict[str, int] = {}
    for part in spec.split(","):
        if not part.strip():
            continue
        key, _, val = part.partition("=")
        key = key.strip()
        if key not in ("sp", "dp") or not val.strip().isdecimal() \
                or int(val) < 1:
            raise ShardConfigError(
                f"RCA_SHARD={spec!r}: expected 'auto' or "
                "'sp=<positive n>[,dp=<positive n>]'"
            )
        axes[key] = int(val)
    axes.setdefault("sp", max(1, n_devices // axes.get("dp", 1)))
    axes.setdefault("dp", 1)
    return axes


class ShardedGraphEngine(EngineAPI):
    """Node-sharded twin of :class:`GraphEngine` (same call surface).

    ``mesh``: a :class:`~rca_tpu_torch.parallel.mesh.DeviceMesh` with axes
    ``dp`` × ``sp`` (a device may repeat: logical shards); without one the
    mesh spans the visible devices of ``device`` (CUDA unless the caller
    names the CPU) as ``spec`` (default ``RCA_SHARD``, else ``auto``)
    lays them out."""

    def __init__(self, config: Optional[RCAConfig] = None,
                 params: Optional[PropagationParams] = None, mesh=None,
                 spec: Optional[str] = None,
                 resident: Optional[bool] = None, device=None):
        from rca_tpu_torch.parallel.mesh import make_mesh, visible_devices

        self.config = config or RCAConfig()
        self.params = resolve_params(self.config, params)
        if mesh is None:
            devices = visible_devices(resolve_device(device))
            if spec is None:
                # constructing this class IS the request to shard: an
                # off-token in RCA_SHARD means the auto layout here
                _, env_spec = shard_requested(device)
                spec = env_spec or "auto"
            axes = parse_shard_spec(spec, len(devices))
            need = axes["sp"] * axes["dp"]
            if need > len(devices):
                raise ShardConfigError(
                    f"RCA_SHARD wants {need} devices "
                    f"(sp={axes['sp']},dp={axes['dp']}), have {len(devices)}"
                )
            mesh = make_mesh([("dp", axes["dp"]), ("sp", axes["sp"])],
                             devices[:need])
        if tuple(mesh.axis_names) != ("dp", "sp"):
            raise ValueError(f"the sharded engine takes a ('dp', 'sp') mesh, "
                             f"got axes {mesh.axis_names}")
        for d in mesh.flat:
            resolve_device(d)
        self.mesh = mesh
        self.sp = int(mesh.shape["sp"])
        self.dp = int(mesh.shape["dp"])
        self.engine_tag = f"sharded(dp={self.dp},sp={self.sp})"
        # one analysis runs on the dp = 1 sub-mesh (the first sp devices);
        # the dp axis is for hypothesis batches
        self._exec_mesh = mesh.sub_mesh()
        # the device of the first shard: where results merge, attribution
        # and the ladder's single-device rung run
        self.device = mesh.flat[0]
        self._resident_cache = None
        if resident if resident is not None else resident_enabled():
            from rca_tpu_torch.engine.resident import ResidentCache
            from rca_tpu_torch.parallel.sharded import ShardedResidentSession

            self._resident_cache = ResidentCache(
                self, session_factory=ShardedResidentSession)

    # -- shaping -----------------------------------------------------------
    def _shard(self, n: int, dep_src: np.ndarray, dep_dst: np.ndarray):
        from rca_tpu_torch.parallel.sharded import shard_graph

        buckets = self.config.shape_buckets
        # the dense engine's node tier (its dummy slot included, for the
        # same bucket boundaries), then up to a multiple of sp
        return shard_graph(
            n, np.asarray(dep_src, np.int32), np.asarray(dep_dst, np.int32),
            self.sp, n_pad_to=bucket_for(n + 1, buckets),
            e_pad_fn=lambda e: bucket_for(e, buckets),
        )

    def _attribution_ctx(self, features, dep_src, dep_dst, names):
        return make_attribution_ctx(features, dep_src, dep_dst, self.params,
                                    names, self.config.shape_buckets,
                                    self.device)

    # -- core --------------------------------------------------------------
    def analyze_arrays(self, features: np.ndarray, dep_src: np.ndarray,
                       dep_dst: np.ndarray,
                       names: Optional[Sequence[str]] = None,
                       k: Optional[int] = None,
                       timed: bool = False) -> EngineResult:
        import torch

        from rca_tpu_torch.parallel.sharded import (
            ShardedStack,
            merge_stacks_topk,
            stage_sharded,
        )

        n = features.shape[0]
        k = k or min(self.config.top_k_root_causes, n)
        if self._resident_cache is not None and not timed:
            return self._resident_cache.analyze(features, dep_src, dep_dst,
                                                names, k)
        clean, n_bad = finite_mask_rows_np(features)
        graph = self._shard(n, dep_src, dep_dst)
        f = np.zeros((1, graph.n_pad, clean.shape[1]), np.float32)
        f[0, :n] = clean
        kk = min(k + 8, graph.n_pad)
        # upload once, outside the (possibly repeated) timed runs
        invoke = stage_sharded(self._exec_mesh, f, graph, self.params)
        bad = torch.tensor(n_bad, dtype=torch.int32)

        def run():
            blocks = [b[0] for b in invoke()[0]]
            vals, idx, diag = merge_stacks_topk(blocks, kk)
            return ShardedStack(blocks), diag, vals, idx, bad

        stack, diag, vals, idx, n_bad, latency_ms = timed_fetch(run, timed)
        return render_result(
            diag, vals, idx, names, n, k, latency_ms, int(len(dep_src)),
            engine=self.engine_tag, sanitized_rows=n_bad, stacked_dev=stack,
            attribution_ctx=self._attribution_ctx(clean, dep_src, dep_dst,
                                                  names),
        )

    def analyze_batch(self, features_batch: np.ndarray, dep_src: np.ndarray,
                      dep_dst: np.ndarray,
                      names: Optional[Sequence[str]] = None,
                      k: Optional[int] = None) -> List[EngineResult]:
        """Hypothesis batch on the FULL mesh: lanes split over ``dp`` (the
        batch padded up to a multiple of dp with zero lanes, dropped from
        the result), nodes over ``sp``."""
        import torch

        from rca_tpu_torch.engine.fetch import HostCopy
        from rca_tpu_torch.parallel.sharded import (
            ShardedStack,
            stage_batch_ranked,
        )

        features_batch = np.asarray(features_batch, np.float32)
        lanes, n = features_batch.shape[0], features_batch.shape[1]
        k = k or min(self.config.top_k_root_causes, n)
        clean, n_bad = finite_mask_rows_np(features_batch)
        graph = self._shard(n, dep_src, dep_dst)
        b_pad = -(-lanes // self.dp) * self.dp
        fb = np.zeros((b_pad, graph.n_pad, clean.shape[2]), np.float32)
        fb[:lanes, :n] = clean
        kk = min(k + 8, graph.n_pad)
        t0 = time.perf_counter()
        grid, diag, vals, idx = stage_batch_ranked(self.mesh, fb, graph,
                                                   self.params, kk)
        # indices cross as int32, cast on the device
        diag, vals, idx = HostCopy(diag, vals, idx.to(torch.int32)).numpy()
        latency_ms = (time.perf_counter() - t0) * 1e3
        per = b_pad // self.dp
        return [
            render_result(
                diag[b], vals[b], idx[b], names, n, k, latency_ms / lanes,
                int(len(dep_src)), engine=self.engine_tag + "-batch",
                sanitized_rows=n_bad,
                stacked_dev=ShardedStack(grid[b // per])[b % per],
                attribution_ctx=self._attribution_ctx(
                    clean[b], dep_src, dep_dst, names),
            )
            for b in range(lanes)
        ]


def shard_requested(device=None) -> Tuple[bool, Optional[str]]:
    """(use the sharded engine?, spec) from ``RCA_SHARD`` and the visible
    devices of ``device`` (CUDA unless the caller names the CPU).

    ``RCA_SHARD`` unset or empty: shard when more than one device is
    visible.  ``0``/``off``/``single``/``none``/``false`` force the
    single-device engine; anything else (``auto``, ``sp=4,dp=2``) forces
    sharding with that layout."""
    from rca_tpu_torch.parallel.mesh import visible_devices

    spec = env_str("RCA_SHARD", "", lower=True)
    if spec in ("0", "off", "single", "none", "false"):
        return False, None
    if spec:
        return True, spec
    return len(visible_devices(device)) > 1, "auto"


def make_engine(config: Optional[RCAConfig] = None,
                params: Optional[PropagationParams] = None, device=None):
    """The engine the analyze path should use RIGHT NOW (``RCA_SHARD`` and
    the visible devices of ``device``)."""
    use_sharded, spec = shard_requested(device)
    if use_sharded:
        return ShardedGraphEngine(config=config, params=params, spec=spec,
                                  device=device)
    return GraphEngine(config=config, params=params, device=device)
