"""specsan: the runtime half of graftspec for the port (``lint
--specsan``; the twin of ``rca_tpu.analysis.dataplane.specsan``).

The contract tables are only trustworthy if real executions agree with
them.  This module runs real engine + serve work with both entries of the
fetch seam (:mod:`rca_tpu_torch.engine.fetch`) instrumented and diffs
every observed device→host transfer against
:data:`~rca_tpu_torch.analysis.dataplane.contracts.FETCH_BUDGETS`:

- **role unification**: the tensors of each transfer must unify with the
  surface's declared roles — same dtype, literal dims equal, symbolic
  dims bound consistently within the call.  A tensor no declared role can
  absorb is an undeclared transfer (``unmatched_roles``);
- **byte budget**: the call's total bytes must fit the surface's budget
  expression evaluated at the unified symbol binding (symbols the call
  does not bind fall back to the surface's most recent binding, else the
  grid maximum — sound because the static domination proof covers the
  whole grid) (``over_budget``);
- **audit scope**: a transfer reached from an audited hot-path module but
  OUTSIDE its allowlisted functions is one the static allowlist never
  blessed (``unaudited``) — the runtime twin of the ``resident-fetch``
  rule.

A transfer is recorded when it STARTS, before any copy: the recorder sits
on the seam's tap and attributes the call to the nearest ``rca_tpu_torch/``
frame outside the seam module and this one.  For a ``HostCopy`` that is
the function that starts the copies (a ``dispatch``), where the bytes are
decided; its ``numpy()`` in a ``fetch`` moves nothing new.

Workload (:func:`run_legs`): a seeded resident session per size (one-shot
timed and delta analyze, deferred bulk diagnostics, causelens
attribution, the batched lane, a streaming tick) plus the serve selftest
(the dispatcher's batched copies under concurrent submitters) — every
budgeted surface the dense engine reaches, on ``device`` (the CUDA card
unless the caller names the CPU; nothing moves to another device).  On
the CPU the seam copies nothing, but every transfer still passes the tap
with the tensors the card would copy.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from rca_tpu_torch.analysis.core import repo_root
from rca_tpu_torch.analysis.dataplane.contracts import (
    FETCH_BUDGETS,
    ITEMSIZE,
    SYMBOL_GRID,
    FetchBudget,
    Role,
    dtype_name,
    eval_budget,
)
from rca_tpu_torch.util.threads import make_lock

#: frames of these files are never a surface: this module and the seam
_SKIP = (
    os.path.join("analysis", "dataplane", "specsan.py"),
    os.path.join("engine", "fetch.py"),
)
#: the sharded engine's surfaces: a dense run leaves them unexercised
SHARDED_SURFACES = frozenset({
    "rca_tpu_torch/engine/sharded_runner.py::analyze_batch",
    "rca_tpu_torch/parallel/streaming.py::dispatch",
    "rca_tpu_torch/parallel/sharded.py::numpy",
})


def _leaf_meta(leaf: Any) -> Tuple[Tuple[int, ...], str, int]:
    """(shape, dtype, nbytes) of one transferred tensor, pre-transfer."""
    shape = tuple(int(d) for d in leaf.shape)
    dtype = dtype_name(leaf.dtype)
    n = ITEMSIZE.get(dtype) or leaf.element_size()
    for d in shape:
        n *= d
    return shape, dtype, n


def unify_roles(
    leaves: Sequence[Tuple[Tuple[int, ...], str]],
    roles: Sequence[Role],
) -> Optional[Dict[str, int]]:
    """Assign each observed leaf to a DISTINCT declared role with one
    consistent symbol binding, or None.  Backtracking: the role lists
    are tiny (<= 10), ambiguity only arises when two symbols share a
    value — any consistent assignment proves conformance."""

    def match(leaf, role: Role, binding: Dict[str, int]):
        shape, dtype = leaf
        if dtype != role.dtype or len(shape) != len(role.shape):
            return None
        new = dict(binding)
        for actual, d in zip(shape, role.shape):
            if isinstance(d, int):
                if actual != d:
                    return None
            elif new.setdefault(d, actual) != actual:
                return None
        return new

    used = [False] * len(roles)

    def solve(i: int, binding: Dict[str, int]):
        if i == len(leaves):
            return binding
        for j, role in enumerate(roles):
            if used[j]:
                continue
            new = match(leaves[i], role, binding)
            if new is not None:
                used[j] = True
                out = solve(i + 1, new)
                if out is not None:
                    return out
                used[j] = False
        return None

    return solve(0, {})


class SpecsanRecorder:
    """Every transfer through the seam, judged against the contracts.
    Serve threads transfer concurrently, so recording takes a lock."""

    def __init__(self, root: str) -> None:
        self.root = root
        self.events: List[Dict[str, Any]] = []
        self.violations: List[Dict[str, Any]] = []
        #: surface -> most recent symbol binding (budget fallback)
        self.bindings: Dict[str, Dict[str, int]] = {}
        #: the workload leg running now (stamped on each event)
        self.leg = ""
        self._audited_files = {path for path, _ in FETCH_BUDGETS}
        self._lock = make_lock("SpecsanRecorder._lock")

    def _surface_for_frame(self) -> Tuple[Optional[str], Optional[str]]:
        """(relpath, func) of the nearest rca_tpu_torch frame below the
        tapped call, skipping the seam's and this module's frames."""
        frame = sys._getframe(1)
        while frame is not None:
            filename = frame.f_code.co_filename
            if not filename.endswith(_SKIP):
                rel = os.path.relpath(filename, self.root).replace(
                    os.sep, "/")
                if rel.startswith("rca_tpu_torch/"):
                    return rel, frame.f_code.co_name
            frame = frame.f_back
        return None, None

    def record(self, tensors: Sequence[Any]) -> None:
        rel, func = self._surface_for_frame()
        if rel is None:
            return  # not our code (test harness, tooling)
        leaves = [_leaf_meta(t) for t in tensors]
        nbytes = sum(n for _, _, n in leaves)
        event: Dict[str, Any] = {
            "surface": f"{rel}::{func}",
            "leg": self.leg,
            "shapes": [list(s) for s, _, _ in leaves],
            "dtypes": [d for _, d, _ in leaves],
            "nbytes": nbytes,
        }
        with self._lock:
            budget = FETCH_BUDGETS.get((rel, func))
            if budget is None:
                if rel in self._audited_files:
                    event["verdict"] = "unaudited"
                    self.violations.append({"kind": "unaudited", **event})
                else:
                    event["verdict"] = "unscoped"
            else:
                self._judge(event, budget, leaves, nbytes)
            self.events.append(event)

    def _judge(self, event: Dict[str, Any], budget: FetchBudget,
               leaves, nbytes: int) -> None:
        surface = event["surface"]
        binding = unify_roles([(s, d) for s, d, _ in leaves], budget.roles)
        if binding is None:
            event["verdict"] = "unmatched_roles"
            self.violations.append({
                "kind": "unmatched_roles",
                "declared": [
                    f"{r.name}{list(r.shape)}:{r.dtype}"
                    for r in budget.roles
                ],
                **event,
            })
            return
        # symbols this call left unbound: the surface's last observed
        # value, else the grid max (the static proof covers the grid)
        merged = {s: max(v) for s, v in SYMBOL_GRID.items()}
        merged.update(self.bindings.get(surface, {}))
        merged.update(binding)
        self.bindings[surface] = merged
        cap = eval_budget(budget.budget, merged)
        event["binding"] = {
            k: v for k, v in binding.items() if k in SYMBOL_GRID
        }
        event["budget_bytes"] = cap
        if nbytes > cap:
            event["verdict"] = "over_budget"
            self.violations.append({"kind": "over_budget", **event})
        else:
            event["verdict"] = "ok"


@contextlib.contextmanager
def capture(root: Optional[str] = None) -> Iterator[SpecsanRecorder]:
    """Install the recorder on both seam entries (``device_get`` and
    ``HostCopy``) for the duration of the block, and restore whatever was
    there before.  The recorder reads only the tensors' metadata before
    the copy starts — transferred values are untouched, so captured
    workloads stay bitwise identical."""
    from rca_tpu_torch.engine import fetch

    rec = SpecsanRecorder(root or repo_root())
    previous = fetch.set_tap(rec.record)
    try:
        yield rec
    finally:
        fetch.set_tap(previous)


def _ranking(ranked: List[dict]) -> List[dict]:
    """A ranking without its timings (what bitwise comparisons read)."""
    return [{k: v for k, v in r.items() if not k.endswith("_ms")}
            for r in ranked]


def _session_leg(rec: Optional[SpecsanRecorder], seed: int,
                 services: int = 20, device=None) -> Dict[str, Any]:
    """Seeded resident-engine pass over every budgeted engine surface."""
    import numpy as np

    from rca_tpu_torch.cluster.generator import synthetic_cascade_arrays
    from rca_tpu_torch.engine.runner import GraphEngine
    from rca_tpu_torch.engine.streaming import make_streaming_session

    if rec is not None:
        rec.leg = f"session@{services}"
    arrays = synthetic_cascade_arrays(services, seed=seed)
    names = arrays.names or [f"svc-{i}" for i in range(arrays.n)]
    engine = GraphEngine(resident=True, device=device)
    # one-shot timed path (timed_fetch), then a delta re-analysis of the
    # same graph so the resident session's _fetch_topk fires too
    first = engine.analyze_case(arrays, k=5, timed=True)
    arrays.features[0, 0] += 0.25
    second = engine.analyze_arrays(
        arrays.features, arrays.dep_src, arrays.dep_dst, names, k=5
    )
    first.full_diagnostics()  # the deferred bulk seam
    attribution = second.attribution()
    batch = engine.analyze_batch(
        np.stack([arrays.features] * 3),
        arrays.dep_src, arrays.dep_dst, names, k=5,
    )
    session = make_streaming_session(
        names, arrays.dep_src, arrays.dep_dst,
        num_features=arrays.features.shape[1], engine=engine, k=5,
    )
    session.update_rows(
        np.arange(3, dtype=np.int32),
        np.asarray(arrays.features[:3], np.float32),
    )
    tick = session.tick()
    return {
        "services": int(arrays.n),
        "one_shot_top1": (first.ranked[0].get("component")
                          if first.ranked else None),
        "attribution_ok": attribution is not None,
        "batch_lanes": len(batch),
        "tick_latency_ms": tick.get("latency_ms"),
        "rankings": {
            "one_shot": _ranking(first.ranked),
            "delta": _ranking(second.ranked),
            "batch": [_ranking(r.ranked) for r in batch],
            "tick": _ranking(tick["ranked"]),
        },
    }


def _serve_leg(rec: Optional[SpecsanRecorder], seed: int, n_requests: int,
               device=None) -> Dict[str, Any]:
    """The dispatcher's batched copies under concurrent submitters."""
    from rca_tpu_torch.serve.client import serve_selftest

    if rec is not None:
        rec.leg = "serve"
    out = serve_selftest(
        n_requests=n_requests, seed=seed, submitters=2, device=device,
    )
    return {
        "requests": out.get("requests", n_requests),
        "ok": bool(out.get("ok", False)),
        "parity_ok": bool(out.get("parity_ok", False)),
        "by_status": out.get("by_status", {}),
    }


def _launches() -> Dict[str, int]:
    from rca_tpu_torch.kernels import LAUNCHES

    return dict(LAUNCHES)


def run_legs(rec: Optional[SpecsanRecorder], seed: int = 0,
             n_requests: int = 8, services: Sequence[int] = (20,),
             device=None) -> Dict[str, Any]:
    """The workload: a session leg per size in ``services``, then the
    serve leg, each with the kernel launches it made (all 0 on the CPU,
    where the kernels' plain versions run).  With ``rec`` None the legs
    run uncaptured (the baseline a captured run must equal bitwise)."""
    out: Dict[str, Any] = {"sessions": {}, "launches": {}}
    for n in services:
        before = _launches()
        out["sessions"][str(n)] = _session_leg(rec, seed, n, device)
        after = _launches()
        out["launches"][f"session@{n}"] = {
            k: after[k] - before[k] for k in after}
    before = _launches()
    out["serve"] = _serve_leg(rec, seed, n_requests, device)
    after = _launches()
    out["launches"]["serve"] = {k: after[k] - before[k] for k in after}
    return out


def _per_surface(events: List[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    per_surface: Dict[str, Dict[str, Any]] = {}
    for e in events:
        s = per_surface.setdefault(e["surface"], {
            "calls": 0, "max_nbytes": 0, "verdicts": {},
        })
        s["calls"] += 1
        s["max_nbytes"] = max(s["max_nbytes"], e["nbytes"])
        v = e.get("verdict", "ok")
        s["verdicts"][v] = s["verdicts"].get(v, 0) + 1
        if "budget_bytes" in e:
            s["budget_bytes"] = max(s.get("budget_bytes", 0),
                                    e["budget_bytes"])
    return per_surface


def run_specsan(
    root: Optional[str] = None,
    seed: int = 0,
    n_requests: int = 8,
    services: Sequence[int] = (20,),
    device=None,
) -> Dict[str, Any]:
    """Drive the workload legs under capture on ``device`` (the card
    unless the caller names another) and report the diff against the
    contract tables: a dict with ``ok`` plus the evidence, per surface
    overall and per leg (``legs``)."""
    t0 = time.perf_counter()
    root = root or repo_root()
    with capture(root) as rec:
        legs = run_legs(rec, seed, n_requests, services, device)

    per_surface = _per_surface(rec.events)
    per_leg = {
        leg: _per_surface([e for e in rec.events if e["leg"] == leg])
        for leg in sorted({e["leg"] for e in rec.events})
    }
    budgeted = {f"{p}::{f}" for p, f in FETCH_BUDGETS}
    confirmed = sorted(s for s in per_surface if s in budgeted)
    serve = legs["serve"]
    ok = (
        not rec.violations
        and serve["ok"]
        and len(confirmed) >= 2  # both legs actually fetched something
    )
    return {
        "ok": bool(ok),
        "fetches": len(rec.events),
        "surfaces": per_surface,
        "legs": per_leg,
        "surfaces_confirmed": confirmed,
        "surfaces_unexercised": sorted(budgeted - set(confirmed)),
        "violations": rec.violations,
        "bindings": rec.bindings,
        "session": legs["sessions"][str(services[0])],
        "sessions": legs["sessions"],
        "serve": serve,
        "launches": legs["launches"],
        "wall_ms": round((time.perf_counter() - t0) * 1e3, 1),
    }


def confirm_findings(
    findings: List[Dict[str, Any]], report: Dict[str, Any],
) -> int:
    """Stamp ``dynamically_confirmed: true`` onto static findings whose
    file a specsan violation also implicates (the static rules and the
    runtime check agreeing on a file is the strongest signal the lint
    can emit).  Returns the number of findings stamped."""
    implicated = {
        v["surface"].split("::", 1)[0]
        for v in report.get("violations", ())
        if "surface" in v
    }
    n = 0
    for f in findings:
        if f.get("rule") in (
            "shape-contract", "dtype-discipline", "donation-guard",
            "resident-fetch", "tick-sync",
        ) and f.get("path") in implicated:
            f["dynamically_confirmed"] = True
            n += 1
    return n
