"""The rsan <-> static-model cross-check (``python -m rca_tpu_torch lint
--rsan``; the port's copy of ``rca_tpu.analysis.concurrency.crosscheck``).

A static concurrency model is only trustworthy if real executions agree
with it — the same discipline the flight recorder applies to the engine
(recorded, checkable execution).  This module drives real
multi-threaded work with the sanitizer on and fails the lint when the
two halves disagree:

- **order contradiction**: an observed acquisition edge ``A -> B`` such
  that ``B`` can already reach ``A`` through the combined (static +
  observed) order graph — the runtime just walked one half of a
  deadlock cycle the static graph didn't bless;
- **observed race**: two same-attribute writes from different threads
  with disjoint held-lock sets (:meth:`RsanRecorder.races_observed`).
  Each is matched against the static race findings: a predicted one
  confirms the model, an unpredicted one means the model missed a root
  or an alias — both fail the check, with the attribution in the
  report;
- **coverage floor**: the stress must actually exercise concurrency —
  every hot lock it touches must be acquired from >=2 distinct threads,
  otherwise the "clean" verdict would be vacuous.

The built-in workload (:func:`queue_metrics_stress`) is the serve
scheduler's admission path under an 8-thread barrage — the same shape
the ``RCA_RSAN=1`` stress tests run — plus, when ``soak_ticks`` is set,
a short seeded chaos soak on ``device`` (the CUDA card unless the caller
names the CPU; no card raises, the soak never moves to the CPU by
itself) so the live session's lock family and the main path's kernels
run under the sanitizer too.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Set, Tuple

from rca_tpu_torch.analysis.concurrency import model_for
from rca_tpu_torch.analysis.concurrency import rsan
from rca_tpu_torch.analysis.concurrency.races import analyze_races
from rca_tpu_torch.analysis.core import repo_root


def _reaches(graph: Dict[str, Set[str]], src: str, dst: str) -> bool:
    seen: Set[str] = set()
    stack = [src]
    while stack:
        n = stack.pop()
        if n == dst:
            return True
        if n in seen:
            continue
        seen.add(n)
        stack.extend(graph.get(n, ()))
    return False


def order_contradictions(
    static_edges: Set[Tuple[str, str]],
    observed: Dict[Tuple[str, str], Dict[str, Any]],
) -> List[Dict[str, Any]]:
    """Observed edges that close a cycle in the combined order graph."""
    graph: Dict[str, Set[str]] = {}
    for a, b in set(static_edges) | set(observed):
        graph.setdefault(a, set()).add(b)
    out = []
    for (a, b), rec in sorted(observed.items()):
        if _reaches(graph, b, a):
            out.append({
                "edge": [a, b],
                "chain": rec["chain"],
                "threads": rec["threads"],
                "count": rec["count"],
            })
    return out


def queue_metrics_stress(
    seed: int = 0,
    threads: int = 8,
    requests_per_thread: int = 24,
) -> Dict[str, Any]:
    """Seeded multi-thread barrage over the serve admission path:
    ``threads`` submitters race a drainer on one :class:`RequestQueue`
    (submit / pop / shed / kick) while every completion path hammers one
    :class:`ServeMetrics`.  Constructed AFTER the sanitizer is enabled,
    so every lock involved is a recording shim.  Returns exact expected
    vs. observed counter totals — a lost update is a hard failure, not a
    flake."""
    import numpy as np

    from rca_tpu_torch.serve.metrics import ServeMetrics
    from rca_tpu_torch.serve.queue import RequestQueue
    from rca_tpu_torch.serve.request import ServeRequest
    from rca_tpu_torch.util.threads import make_lock, spawn

    rng = np.random.default_rng(seed)
    feats = rng.random((4, 3)).astype(np.float32)
    src = np.array([0, 1, 2], np.int32)
    dst = np.array([1, 2, 3], np.int32)
    queue = RequestQueue(cap=threads * requests_per_thread + 8)
    metrics = ServeMetrics()
    total = threads * requests_per_thread
    # a harness-owned guarded counter exercises the access-pair record
    # the honest way: every access holds the lock, so the Eraser check
    # sees a non-empty lockset intersection and stays quiet
    counter_lock = make_lock("StressCounter._lock")
    counter = {"submitted": 0}

    def submitter(w: int) -> None:
        for i in range(requests_per_thread):
            req = ServeRequest(
                tenant=f"t{w % 3}", features=feats, dep_src=src,
                dep_dst=dst,
                # a sprinkle of already-expired deadlines exercises the
                # shed path under contention
                deadline_s=-1.0 if (w + i) % 7 == 0 else None,
            )
            queue.submit(req)
            metrics.submitted(req.tenant, len(queue))
            with counter_lock:
                rsan.note_access("StressCounter", "submitted")
                counter["submitted"] += 1

    drained = []
    stop = []

    def drainer() -> None:
        while not stop or len(drained) < total:
            for req in queue.shed_expired(time.monotonic()):
                metrics.shed(req.tenant)
                drained.append(req)
            req = queue.pop()
            if req is None:
                if stop:
                    break
                queue.wait_for_work(0.001)
                continue
            metrics.answered(req.tenant, 0.1)
            drained.append(req)
        # shutdown drain: everything still queued errors out, nothing
        # is left parked (the ServeLoop._shutdown_drain contract)
        while True:
            req = queue.pop()
            if req is None:
                break
            metrics.errors(req.tenant)
            drained.append(req)

    workers = [
        spawn(submitter, name=f"rsan-stress-{w}", args=(w,))
        for w in range(threads)
    ]
    drain_thread = spawn(drainer, name="rsan-stress-drain")
    for t in workers:
        t.join(30.0)
    stop.append(True)
    queue.kick()
    drain_thread.join(30.0)

    summary = metrics.summary()
    counted = min(
        sum(t["submitted"] for t in summary["tenants"].values()),
        counter["submitted"],
    )
    completed = sum(
        t["answered"] + t["shed"] + t["errors"]
        for t in summary["tenants"].values()
    )
    return {
        "requests": total,
        "submitted_counted": counted,
        "completed_counted": completed,
        "drained": len(drained),
        "queue_leftover": len(queue),
        "ok": (
            counted == total and len(drained) == total
            and completed == total and len(queue) == 0
        ),
    }


def run_rsan_crosscheck(
    root: Optional[str] = None,
    seed: int = 0,
    soak_ticks: int = 0,
    device: Any = None,
) -> Dict[str, Any]:
    """Run the sanitized workload and diff it against the static model.
    ``soak_ticks > 0`` adds a seeded chaos soak on ``device`` (imports the
    engine — noticeably heavier than the pure-scheduler stress).  The
    sanitizer is left on or off as it was found."""
    t0 = time.perf_counter()
    if soak_ticks > 0:
        from rca_tpu_torch.engine.runner import resolve_device

        device = resolve_device(device)  # no card and no "cpu": raises
    root = root or repo_root()
    model = model_for(root)
    static_edges = model.static_order_edges()
    static_race_keys = {
        (f.cls, f.attr) for f in analyze_races(model)
    }

    was_enabled = rsan.enabled()
    rsan.enable()
    rsan.RSAN.reset()
    try:
        stress = queue_metrics_stress(seed=seed)
        soak = None
        if soak_ticks > 0:
            from rca_tpu_torch.cluster.generator import synthetic_cascade_world
            from rca_tpu_torch.resilience.chaos import run_chaos_soak

            soak_summary = run_chaos_soak(
                lambda: synthetic_cascade_world(
                    20, n_roots=1, seed=seed + 1,
                ),
                "synthetic", seed=seed + 1, ticks=soak_ticks,
                replay_check=False, device=device,
            )
            soak = {
                "ticks": soak_summary["ticks"],
                "uncaught_exceptions":
                    soak_summary["uncaught_exceptions"],
                "device": str(device),
                "kernel_paths": soak_summary["kernel_paths"],
                "ok": soak_summary["uncaught_exceptions"] == 0,
            }
    finally:
        if not was_enabled:
            rsan.disable()

    observed = rsan.RSAN.order_edges()
    lock_threads = rsan.RSAN.lock_threads()
    contradictions = order_contradictions(static_edges, observed)
    races = rsan.RSAN.races_observed()
    for r in races:
        r["statically_predicted"] = (
            (r["owner"], r["attr"]) in static_race_keys
        )
    multi_thread_locks = [
        k for k, v in lock_threads.items() if len(v) >= 2
    ]
    coverage_ok = len(multi_thread_locks) >= 1
    ok = (
        stress["ok"]
        and coverage_ok
        and not contradictions
        and not races
        and (soak is None or soak["ok"])
    )
    return {
        "ok": bool(ok),
        "acquires": rsan.RSAN.acquires,
        "locks_observed": sorted(lock_threads),
        "multi_thread_locks": sorted(multi_thread_locks),
        "observed_edges": [
            list(k) for k in sorted(observed)
        ],
        "static_edges": sorted(list(e) for e in static_edges),
        "contradictions": contradictions,
        "races_observed": races,
        "static_race_findings": sorted(
            f"{c}.{a}" for c, a in static_race_keys
        ),
        "stress": stress,
        "soak": soak,
        "wall_ms": round((time.perf_counter() - t0) * 1e3, 1),
    }
