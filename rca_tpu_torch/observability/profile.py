"""``profile``: a ``torch.profiler`` capture around N live ticks, the port's
counterpart of ``rca_tpu.observability.profile``.

:func:`profile_ticks` runs a mock-cluster live session for ``ticks`` polls
inside one ``torch.profiler.profile`` (CPU and CUDA activities on the
card), each poll under ``record_function("rca_tick")`` so device work
groups under tick ranges, with :func:`.spans.device_annotation` engaged
inside the tick's dispatch and fetch (``tick.dispatch`` /
``tick.fetch``), and stamps the row the session's padded shape engaged
into the summary.  The trace is Chrome trace JSON, which Perfetto loads.
:func:`device_kernel_counts` names the trace's device kernels after the
port's kernel wrappers.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from typing import Any, Callable, Dict, Optional

from rca_tpu_torch.observability.spans import (
    Tracer,
    default_tracer,
    set_profiling,
)

#: the port's kernels by the symbol of the device kernel each wrapper
#: launches (``csrc/``), as the profiler names them (demangled); a flagged
#: scan by its first kernel, ``tile_scan_kernel<OP>`` (0 sum, 1 max), once
#: a launch
KERNEL_SYMBOLS = {
    "evidence_front_fused": re.compile(r"\bfront_kernel\b"),
    "evidence_front": re.compile(r"\bevidence_front(_persist)?_kernel\b"),
    "evidence_front_shard": re.compile(r"\bfront_shard_kernel\b"),
    "noisy_or_pair": re.compile(r"\bnoisy_or_pair_kernel\b"),
    "seg_up_step": re.compile(r"\bseg_step_kernel<[\w\s():]*\bUpStep>"),
    "seg_down_step": re.compile(
        r"\bseg_step_kernel<[\w\s():]*\bDown(Sum)?Step>"),
    "seg_contrast_step": re.compile(
        r"\bseg_step_kernel<[\w\s():]*\bContrastStep>"),
    "seg_up_steps": re.compile(r"\bseg_steps_kernel<[\w\s():]*\bUpSteps>"),
    "seg_down_steps": re.compile(
        r"\bseg_steps_kernel<[\w\s():]*\bDownSteps>"),
    "seg_up_steps_grid": re.compile(
        r"\bseg_grid_kernel<[\w\s():]*\bUpGrid>"),
    "seg_down_steps_grid": re.compile(
        r"\bseg_grid_kernel<[\w\s():]*\bDownGrid>"),
    "seg_up_steps_shard": re.compile(
        r"\bseg_grid_kernel<[\w\s():]*\bUpShard>"),
    "seg_down_steps_shard": re.compile(r"\bseg_shard_down_kernel\b"),
    "seg_up_steps_peer": re.compile(r"\bseg_peer_up_kernel\b"),
    "seg_down_steps_peer": re.compile(r"\bseg_peer_down_kernel\b"),
    "segscan_sum": re.compile(r"\btile_scan_kernel<[^>]*\b0>"),
    "segscan_max": re.compile(r"\btile_scan_kernel<[^>]*\b1>"),
}


def device_kernel_counts(trace: Dict[str, Any]) -> Dict[str, int]:
    """The device kernel events (``cat`` ``"kernel"``) of a Chrome trace,
    counted by the port kernel whose symbol they carry
    (:data:`KERNEL_SYMBOLS`); every other kernel (torch's own, a flagged
    scan's second and third) counts under ``"other"``."""
    counts = {name: 0 for name in KERNEL_SYMBOLS}
    counts["other"] = 0
    for event in trace.get("traceEvents", []):
        if event.get("cat") != "kernel":
            continue
        name = str(event.get("name", ""))
        hit = next((k for k, pat in KERNEL_SYMBOLS.items()
                    if pat.search(name)), "other")
        counts[hit] += 1
    return counts


def profile_ticks(
    out_dir: str,
    ticks: int = 20,
    services: int = 200,
    seed: int = 7,
    tracer: Optional[Tracer] = None,
    clock: Callable[[], float] = time.perf_counter,
    device=None,
) -> Dict[str, Any]:
    """Capture a ``torch.profiler`` trace around ``ticks`` polls of a live
    session over ``synthetic_cascade_world(services, n_roots=1,
    seed=seed)`` on ``device`` (the CUDA card unless the caller names
    another); returns the capture summary, the reference's keys with
    ``device``.  The trace lands under ``out_dir`` as Chrome trace JSON;
    host spans for every tick land in ``tracer`` (default: the process
    tracer, or a fresh enabled one when that is the null tracer).  On the
    card a capture that holds no CUDA kernel raises: an empty device
    timeline is a failed capture, not a result."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from rca_tpu_torch.cluster.generator import synthetic_cascade_world
    from rca_tpu_torch.cluster.mock_client import MockClusterClient
    from rca_tpu_torch.engine.live import LiveStreamingSession
    from rca_tpu_torch.engine.runner import resolve_device
    from rca_tpu_torch.engine.sharded_runner import make_engine

    dev = resolve_device(device)
    if tracer is None:
        # an explicit capture is its own opt-in: record spans even when
        # RCA_TRACE is off (the process default stays null)
        tracer = default_tracer()
        if not tracer.enabled:
            tracer = Tracer()
    os.makedirs(out_dir, exist_ok=True)
    world = synthetic_cascade_world(
        int(services), n_roots=1, seed=int(seed), namespace="profile"
    )
    session = LiveStreamingSession(
        MockClusterClient(world), "profile", k=5, tracer=tracer,
        engine=make_engine(device=dev),
    )
    kernel_path = getattr(session.session, "kernel_path", None)
    n_pad = getattr(session.session, "_n_pad", None)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    set_profiling(True)
    t0 = clock()
    try:
        with profile(activities=activities) as prof:
            for _ in range(int(ticks)):
                with record_function("rca_tick"):
                    session.poll()
    finally:
        set_profiling(False)
    wall_ms = (clock() - t0) * 1e3
    # a fresh name per capture without reading the wall clock
    fd, path = tempfile.mkstemp(prefix=f"rca_ticks.{os.getpid()}.",
                                suffix=".json", dir=out_dir)
    os.close(fd)
    prof.export_chrome_trace(path)
    if dev.type == "cuda":
        with open(path, encoding="utf-8") as f:
            kernels = device_kernel_counts(json.load(f))
        if not sum(kernels.values()):
            raise RuntimeError(
                f"torch.profiler recorded no CUDA kernel over {ticks} ticks "
                f"on {torch.cuda.get_device_name(dev)} ({path})")
    return {
        "ticks": int(ticks),
        "services": int(services),
        "trace_dir": out_dir,
        "wall_ms": round(wall_ms, 3),
        "ms_per_tick": round(wall_ms / max(1, int(ticks)), 3),
        # which row this session's padded shape engaged
        "kernel_by_shape": (
            {str(n_pad): kernel_path} if n_pad is not None else {}
        ),
        "spans_recorded": tracer.stats()["recorded"],
        "profile_files": sum(
            len(files) for _r, _d, files in os.walk(out_dir)
        ),
        "device": str(dev),
    }
