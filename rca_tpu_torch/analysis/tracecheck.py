"""The runtime recompile gate: each public engine entry point compiles
nothing on its second bit-identical call (the port's counterpart of
``rca_tpu.analysis.tracecheck``).

The port compiles nothing per call; its compiles are the events
kernelscope's compile log records (``observability/kernelscope.py``): a
build of the kernel library and a registry plan election for a padded
shape.  A compile on call two means something keyed per call that should
be keyed per shape (a registry cleared, a shape that escaped bucketing, a
library hash that drifted), the regression that lands with every test
green and shows up as a stall on a production tick.  The first call may
compile (the shape's election, the library's build) or not, where the
process already did both.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional, Tuple

N_SERVICES = 24  # a small synthetic graph: compile behaviour, not scale


@contextlib.contextmanager
def compile_log_capture(records: List[str]):
    """Collect the names of the compiles noted in kernelscope's log inside
    the block (library builds and plan elections)."""
    from rca_tpu_torch.observability.kernelscope import _LOG

    start = _LOG.seq()
    try:
        yield
    finally:
        records.extend(e["name"] for e in _LOG.events_since(start))


def _case():
    from rca_tpu_torch.cluster.generator import synthetic_cascade_arrays

    return synthetic_cascade_arrays(N_SERVICES, n_roots=1, seed=0)


def _entry_analyze(device) -> Callable[[], None]:
    from rca_tpu_torch.engine.runner import GraphEngine

    engine = GraphEngine(device=device)
    case = _case()

    def call() -> None:
        engine.analyze_case(case, k=5)

    return call


def _entry_analyze_batch(device) -> Callable[[], None]:
    import numpy as np

    from rca_tpu_torch.engine.sharded_runner import make_engine

    engine = make_engine(device=device)
    case = _case()
    batch = np.repeat(np.asarray(case.features, np.float32)[None], 4, axis=0)

    def call() -> None:
        engine.analyze_batch(batch, case.dep_src, case.dep_dst,
                             names=case.names, k=5)

    return call


def _entry_streaming_tick(device) -> Callable[[], None]:
    import numpy as np

    from rca_tpu_torch.engine.runner import GraphEngine
    from rca_tpu_torch.engine.streaming import StreamingSession

    case = _case()
    session = StreamingSession(
        case.names, case.dep_src, case.dep_dst,
        num_features=case.features.shape[1],
        engine=GraphEngine(device=device), k=5,
    )
    session.set_all(np.asarray(case.features, np.float32))
    row = np.asarray(case.features[0], np.float32)

    def call() -> None:
        # one changed row per tick: the steady-state hot path
        session.update(0, row)
        session.tick()

    return call


def _entry_propagate(device) -> Callable[[], None]:
    """``propagate_jit``'s twin: :func:`rca_tpu_torch.engine.propagate.
    propagate` over features and destinations staged once on ``device``,
    with the plan of the padded shape asked of the dispatch seam
    (``runner.kernel_plan``) on every call, as the engine asks it."""
    import numpy as np
    import torch

    from rca_tpu_torch.config import RCAConfig, bucket_for
    from rca_tpu_torch.engine.params import default_params
    from rca_tpu_torch.engine.propagate import propagate
    from rca_tpu_torch.engine.runner import kernel_plan, resolve_device

    dev = resolve_device(device)
    case = _case()
    cfg = RCAConfig()
    n_pad = bucket_for(N_SERVICES + 1, cfg.shape_buckets)
    e_pad = bucket_for(max(len(case.dep_src), 1), cfg.shape_buckets)
    f = np.zeros((n_pad, case.features.shape[1]), np.float32)
    f[:N_SERVICES] = case.features
    d = np.full(e_pad, n_pad - 1, np.int64)
    d[: len(case.dep_dst)] = case.dep_dst
    features = torch.from_numpy(f).to(dev)
    dep_dst = torch.from_numpy(d).to(dev)
    p = default_params(cfg.propagation_steps)
    aw, hw = (torch.from_numpy(w).to(dev) for w in p.weight_arrays())

    def call() -> None:
        plan = kernel_plan(n_pad, e_pad, case.dep_src, case.dep_dst, dev,
                           steps=p.steps)
        out = propagate(features, dep_dst, aw, hw, p.steps, p.decay,
                        p.explain_strength, p.impact_bonus, N_SERVICES, plan,
                        error_contrast=p.error_contrast)
        out[4].cpu()

    return call


ENTRY_POINTS: Dict[str, Callable[..., Callable[[], None]]] = {
    "engine.analyze_case": _entry_analyze,
    "engine.analyze_batch": _entry_analyze_batch,
    "streaming.tick": _entry_streaming_tick,
    "propagate_jit": _entry_propagate,
}


def run_tracecheck(entries: Optional[List[str]] = None,
                   device=None) -> dict:
    """Each entry point on ``device`` (the CUDA card unless the caller
    names another): a warm-up call (compiles allowed), then a second
    bit-identical call that must compile nothing.  Returns ``ok`` and per
    entry its compile counts, the names compiled on call two and the
    wall of both calls with the set-up."""
    selected: List[Tuple[str, Callable]] = [
        (name, builder) for name, builder in ENTRY_POINTS.items()
        if entries is None or name in entries
    ]
    if entries:
        unknown = set(entries) - {n for n, _ in selected}
        if unknown:
            raise KeyError(f"unknown tracecheck entries: {sorted(unknown)}")
    results = []
    for name, builder in selected:
        t0 = time.perf_counter()
        call = builder(device)
        warm: List[str] = []
        second: List[str] = []
        with compile_log_capture(warm):
            call()
        with compile_log_capture(second):
            call()
        results.append({
            "entry": name,
            "warmup_compiles": len(warm),
            "recompiles": len(second),
            "recompiled": sorted(set(second)),
            "ok": not second,
            "wall_ms": round((time.perf_counter() - t0) * 1e3, 1),
        })
    return {
        "ok": all(r["ok"] for r in results),
        "entries": results,
    }
