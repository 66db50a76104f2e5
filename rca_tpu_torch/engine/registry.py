"""KernelRegistry: the per-shape kernel table and THE dispatch seam.

Counterpart of the JAX package's ``engine/registry.py``.  A row per
``(variant, n_pad, e_pad, steps, device)`` records which of the port's
propagation rows the shape engages, WHY (``forced`` / ``cpu-default`` /
``timed`` / ``cache`` / ``attribution``), every candidate's eligibility
(``True`` or the reason it sat out) and the timings of the race.  The rows (:data:`KERNELS`):

- ``torch``: plain PyTorch ops, the default and the counterpart of the
  reference's ``xla`` row: the front's plain version, the up-steps over the
  hybrid up-table, the down-steps as a sorted segment sum;
- ``kernels``: the hand-written CUDA kernels (``csrc/``), one launch for
  the front and one per recursion (or per seg step, where the graph
  does not fit one CTA); on a CPU tensor their plain versions;
- ``quantized``: bf16 evidence and int8 messages (``engine/quantized.py``),
  plain ops on every device, held to the f32 rows by rank parity;
- ``doubling``: the ``kernels`` row's front, then the scans in log depth
  over host-built frontier layouts (``engine/doubling.py``); a graph
  whose frontiers pass the cap runs the device's default row instead
  (``runner.kernel_plan``).

:func:`engaged_kernel` is the one place a propagation surface asks which
row a padded shape runs (through ``runner.kernel_plan``).  A CPU host picks
``torch`` without timing, as the reference does for XLA; on a CUDA card
both rows are timed over a ring graph of the row's shape and ``kernels``
must beat ``torch`` by more than 5% to take it.  ``quantized`` and
``doubling`` sit out the card's race (their eligibility there reads
:data:`CARD_OPT_IN`): a lossy row could take a shape by timing alone and
change the answers silently, so on the card they run only when
``RCA_KERNEL`` names them.  The race never hands the
card's main path to plain ops: a kernel that fails while it is timed
raises, and so does a race that ``torch`` would win (only
``RCA_KERNEL=torch`` runs the plain row on the card).  Timed winners
persist to a file (``RCA_KERNEL_CACHE``, by default in the port's build
directory) whose header holds the torch and CUDA versions, the card's
name and a hash of the kernel sources and their wrappers; a stale or
corrupt file, or a cached ``torch`` verdict, re-times, never crashes.

The ``attribution`` variant is the causelens saliency's row: it engages
``torch``, the differentiable body, and records the other rows as
ineligible with the reference's reasons.  The counterfactual sweep needs
no gradient and runs the ``dense`` row.

The ``sharded`` variant is the node-sharded engine's row, keyed by the
padded node count and the per-shard edge tier: ``kernels`` on a CUDA
card (where every shard of a ``dp`` row shares one card, the front and
each recursion one cooperative launch over every shard; over distinct
cards the per-shard entries, a launch a shard and step), ``torch`` (the per-shard plain versions) on the CPU and
under ``RCA_KERNEL=torch``; it is not raced (the reference's sharded row
is not either), and its ``source`` says why (``sharded`` / ``cpu-default``
/ ``forced``).  ``quantized`` and ``doubling`` have no sharded form: a
forced row that a shape's eligibility declines engages the device's
default row (``kernels`` on the card, ``torch`` on the CPU) with source
``ineligible``, as the reference falls back to its ``xla`` row.

Rows are keyed by ``RCA_EDGE_LAYOUT`` too, and record it (``layout``);
a race under ``coo`` or ``ell`` caches its winner under its own key.
Under ``ell`` ``quantized`` and ``doubling`` are declined, with the
reference's reason.  The reference also declines its segmented-scan row
under ``coo`` / ``ell``; the port has no such row (its seg steps run over
the same sorted edges under every layout), so :func:`layout_note` carries
that reason as text for ``kernels --explain``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from rca_tpu_torch.config import (
    KERNELS,
    edge_layout,
    env_raw,
    forced_kernel,
    kernel_cache_path,
)
from rca_tpu_torch.kernels.build import PKG_DIR
from rca_tpu_torch.observability.kernelscope import note_compile
from rca_tpu_torch.util.threads import make_lock

_CACHE_VERSION = 1

#: the sources whose edit re-times every shape: the kernels, their
#: wrappers, the propagation body and this registry
_HASHED = ("csrc/*.cu", "csrc/*.cuh", "engine/evidence.py",
           "engine/segscan.py", "engine/ell.py", "engine/propagate.py",
           "engine/registry.py", "engine/quantized.py", "engine/doubling.py",
           "kernels/build.py", "kernels/cost.py")

#: why the attribution variant cannot engage the kernels row
ATTRIBUTION_DECLINE = (
    "no backward kernel: the front and the seg steps "
    "(evidence_front_fused, seg_up_steps, seg_down_steps and their grid "
    "forms) have none, so "
    "saliency differentiates the torch row"
)

#: why the card's race leaves out the quantized and doubling rows
CARD_OPT_IN = "opt-in on the card: RCA_KERNEL=quantized|doubling"


def _env_key() -> str:
    """The env knobs of the row key, ``RCA_KERNEL`` and
    ``RCA_EDGE_LAYOUT``: a test flipping either mid-process re-decides
    instead of reading a stale verdict, and a row decided under one
    layout never serves another."""
    return ":".join((env_raw("RCA_KERNEL", "").strip().lower(),
                     edge_layout()))


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def kernel_set_hash() -> str:
    """Hash of the kernel set's sources: the cache invalidation key.  An
    edit to a kernel, a wrapper, the propagation body or this registry
    re-times every shape."""
    global _KERNEL_SET_HASH
    if _KERNEL_SET_HASH is None:
        h = hashlib.sha1(repr(KERNELS).encode())
        for pattern in _HASHED:
            for path in sorted(PKG_DIR.glob(pattern)):
                h.update(path.name.encode())
                h.update(path.read_bytes())
        _KERNEL_SET_HASH = h.hexdigest()[:16]
    return _KERNEL_SET_HASH


_KERNEL_SET_HASH: Optional[str] = None


@dataclasses.dataclass
class KernelRow:
    """One registry row: the engaged row for one padded shape."""

    variant: str                  # dense | attribution | sharded
    n_pad: int
    backend: str                  # the device type: cuda | cpu
    winner: str                   # the engaged row (a KERNELS member)
    source: str                   # forced|cpu-default|timed|cache|
    #                               attribution|sharded
    e_pad: Optional[int] = None   # padded edge tier
    steps: int = 8                # propagation depth the row decided for
    layout: str = "hybrid"        # RCA_EDGE_LAYOUT the row decided under
    eligible: Dict[str, Any] = dataclasses.field(default_factory=dict)
    timings_ms: Dict[str, Optional[float]] = dataclasses.field(
        default_factory=dict
    )
    cost: Optional[Dict[str, Any]] = None  # _capture_cost's, once asked

    def to_dict(self) -> Dict[str, Any]:
        return {
            "variant": self.variant,
            "n_pad": self.n_pad,
            "e_pad": self.e_pad,
            "steps": self.steps,
            "layout": self.layout,
            "backend": self.backend,
            "winner": self.winner,
            "source": self.source,
            "eligible": dict(self.eligible),
            "timings_ms": dict(self.timings_ms),
            "cost": dict(self.cost) if self.cost is not None else None,
        }


def _cache_key(variant: str, n_pad: int, e_pad: Optional[int], steps: int,
               backend: str, layout: str) -> str:
    key = f"{variant}:{n_pad}:{e_pad}:{steps}:{backend}"
    # the torch row's up-steps differ by layout
    return key if layout == "hybrid" else f"{key}:{layout}"


class KernelRegistry:
    """The per-shape kernel table (one per process via
    :func:`get_registry`).  Rows resolve lazily the first time a surface
    asks about a shape.  Elections run one at a time, under
    ``_elect_lock``: serve threads (a loop's worker, a pool's replicas on
    one card) that ask about shapes at once never time two races against
    each other on the card, and a shape is elected, timed and noted to
    kernelscope exactly once.  Lookups of resolved rows take only
    ``_lock`` and never wait on an election."""

    def __init__(self):
        self._lock = make_lock("KernelRegistry._lock")
        self._elect_lock = make_lock("KernelRegistry._elect_lock")
        self._rows: Dict[Tuple, KernelRow] = {}

    # -- cache file (RCA_KERNEL_CACHE, read per lookup) --------------------
    @staticmethod
    def _header(device: torch.device) -> Dict[str, Any]:
        return {
            "version": _CACHE_VERSION,
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "device": _device_name(device),
            "kernel_set": kernel_set_hash(),
        }

    @staticmethod
    def _read_rows(path: Optional[str],
                   header: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """The rows of one cache file whose header matches, else None: a
        corrupt file or a stale header (another torch, CUDA, card or kernel
        set) re-times instead of serving a verdict earned elsewhere."""
        if not path or not os.path.exists(path):
            return None
        try:
            with open(path, encoding="utf-8") as f:
                data = json.load(f)
        except (json.JSONDecodeError, OSError, UnicodeDecodeError):
            return None
        if not isinstance(data, dict) or any(
                data.get(key) != value for key, value in header.items()):
            return None
        rows = data.get("rows")
        return rows if isinstance(rows, dict) else None

    def _load_cached(self, key: str, device: torch.device):
        rows = self._read_rows(kernel_cache_path(device.type),
                               self._header(device))
        row = None if rows is None else rows.get(key)
        if not isinstance(row, dict) or row.get("winner") not in KERNELS:
            return None
        return row

    def _store_cached(self, key: str, row: KernelRow,
                      device: torch.device) -> None:
        path = kernel_cache_path(device.type)
        if not path:
            return
        header = self._header(device)
        rows = self._read_rows(path, header) or {}
        rows[key] = {"winner": row.winner,
                     "timings_ms": dict(row.timings_ms)}
        if row.cost is not None:
            rows[key]["cost"] = dict(row.cost)
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({**header, "rows": rows}, f, indent=1)
                f.write("\n")
            os.replace(tmp, path)
        except OSError:
            pass  # an unwritable cache re-times next time; the row stands

    # -- resolution ----------------------------------------------------------
    def resolve(self, n_pad: int, e_pad: Optional[int] = None,
                steps: int = 8, variant: str = "dense",
                device="cpu") -> KernelRow:
        """The row for one padded shape on ``device``, created on first
        ask.  Rows are keyed by the dispatch env knobs too
        (:func:`_env_key`)."""
        device = torch.device(device)
        n_pad = int(n_pad)
        e_pad = int(e_pad) if e_pad is not None else None
        key = (variant, n_pad, e_pad, int(steps), str(device), _env_key())
        with self._lock:
            row = self._rows.get(key)
        if row is not None:
            return row
        with self._elect_lock:
            with self._lock:
                row = self._rows.get(key)
            if row is not None:
                return row      # elected while this thread waited
            row = self._decide(variant, n_pad, e_pad, int(steps), device)
            note_compile(
                f"plan {variant}:{n_pad}:{e_pad}:{steps} on {device}",
                key[:5])
            with self._lock:
                self._rows[key] = row
        return row

    def note_timing(self, n_pad: int, e_pad: Optional[int], name: str,
                    ms: float, variant: str = "dense", steps: int = 8,
                    device="cpu") -> None:
        """Record one observed wall cost into a row's timings, keeping the
        minimum (the first call carries the start-up).  The attribution
        sweep stamps its per-shape cost here."""
        row = self.resolve(n_pad, e_pad=e_pad, steps=steps, variant=variant,
                           device=device)
        with self._lock:
            prev = row.timings_ms.get(name)
            if prev is None or float(ms) < float(prev):
                row.timings_ms[name] = round(float(ms), 4)

    def _decide(self, variant: str, n_pad: int, e_pad: Optional[int],
                steps: int, device: torch.device) -> KernelRow:
        backend = device.type
        layout = edge_layout()
        eligible = _eligibility(variant, e_pad, steps, backend, layout)
        row = KernelRow(variant=variant, n_pad=n_pad, e_pad=e_pad,
                        steps=steps, layout=layout, backend=backend,
                        winner="torch", source="default", eligible=eligible)
        if variant == "attribution":
            # the saliency's backward pass needs the differentiable body;
            # the attribution's cost lands in the timings through
            # note_timing
            row.source = "attribution"
            return row
        forced = forced_kernel()
        if forced is not None:
            if eligible.get(forced) in (True, CARD_OPT_IN):
                row.winner = forced
                row.source = "forced"
            else:
                # the shape declines the forced row: the device's default
                row.winner = default_row(device)
                row.source = "ineligible"
            return row
        if backend == "cpu":
            # the kernels row runs its plain versions on the CPU: timing
            # them proves nothing about the card
            row.source = "cpu-default"
            return row
        if variant == "sharded":
            # the per-shard launches; no race, as the reference's sharded
            # row runs no race
            row.winner = "kernels"
            row.source = "sharded"
            return row
        cache_key = _cache_key(variant, n_pad, e_pad, steps, backend, layout)
        cached = self._load_cached(cache_key, device)
        if cached is not None and cached["winner"] == "kernels":
            row.winner = "kernels"
            row.source = "cache"
            row.timings_ms = dict(cached.get("timings_ms") or {})
            if cached.get("cost"):
                row.cost = dict(cached["cost"])
            return row
        candidates = [k for k in KERNELS if eligible.get(k) is True]
        row.timings_ms = _time_candidates(n_pad, e_pad, steps, candidates,
                                          device)
        row.winner = _pick_winner(row.timings_ms)
        if row.winner != "kernels":
            raise RuntimeError(
                f"kernel race at n_pad={n_pad}, e_pad={e_pad} on "
                f"{_device_name(device)}: the plain torch row would win "
                f"({row.timings_ms}); the port does not run plain ops on "
                f"the card unless RCA_KERNEL=torch asks for them"
            )
        row.source = "timed"
        self._store_cached(cache_key, row, device)
        return row

    # -- cost --------------------------------------------------------------
    def ensure_cost(self, row: KernelRow) -> KernelRow:
        """Capture the cost of a row that lacks it (:func:`_capture_cost`:
        one canonical call of the row's winner at its shape, on its
        device), and persist it with a timed or cached row.  Explicit,
        never automatic: a ``/metrics`` scrape must not launch work on the
        card, so the ``kernels`` command and ``chip_smoke.py`` call this and
        the serve surfaces export whatever is already captured.  Runs under
        the election lock, so a capture never overlaps a race on the
        card."""
        if row.cost is not None:
            return row
        with self._elect_lock:
            if row.cost is None:
                device = torch.device(row.backend)
                row.cost = _capture_cost(row.n_pad, row.e_pad, row.winner,
                                         row.steps, device)
                if row.source in ("timed", "cache"):
                    self._store_cached(
                        _cache_key(row.variant, row.n_pad, row.e_pad,
                                   row.steps, row.backend, row.layout),
                        row, device)
        return row

    # -- reading -------------------------------------------------------------
    def table(self, ensure_cost: bool = False,
              cost_max_pad: int = 4096) -> List[Dict[str, Any]]:
        """Every resolved row, smallest shape first.  ``ensure_cost``
        captures the missing cost of rows with ``n_pad <= cost_max_pad``
        (the cap bounds what a table dump may run; a bigger row still shows
        its winner and timings)."""
        with self._lock:
            rows = sorted(self._rows.values(),
                          key=lambda r: (r.variant, r.n_pad, r.e_pad or -1,
                                         r.backend))
        out = []
        for row in rows:
            if ensure_cost and row.cost is None and row.n_pad <= cost_max_pad:
                self.ensure_cost(row)
            out.append(row.to_dict())
        return out

    def clear(self) -> None:
        with self._lock:
            self._rows.clear()


def _eligibility(variant: str, e_pad: Optional[int] = None, steps: int = 8,
                 backend: str = "cpu",
                 layout: str = "hybrid") -> Dict[str, Any]:
    """Per-row eligibility at one shape: ``True`` or the reason the row
    sits out, with the reference's reasons for the rows both packages
    have.  The kernels row takes every dense and sharded shape: on the
    card its kernels, on a CPU tensor their plain versions
    (``RCA_KERNEL=kernels`` there).  On the card, ``quantized`` and
    ``doubling`` read :data:`CARD_OPT_IN` where no structural reason
    declines them first."""
    from rca_tpu_torch.engine.doubling import doubling_eligible

    out: Dict[str, Any] = {"torch": True}
    if variant == "attribution":
        out["kernels"] = ATTRIBUTION_DECLINE
        out["quantized"] = "int8 messages are not differentiable"
        out["doubling"] = (
            "frontier layouts have no per-row counterfactual twin"
        )
        return out
    out["kernels"] = True
    for name in ("quantized", "doubling"):
        if variant == "sharded":
            out[name] = "no shard_map twin"
        elif layout == "ell":
            out[name] = "RCA_EDGE_LAYOUT=ell pins the gather-table layout"
        elif e_pad is None:
            out[name] = "edge tier unknown (caller passed no e_pad)"
        else:
            out[name] = True
    if out["doubling"] is True and not doubling_eligible(steps):
        out["doubling"] = (
            f"steps {steps} not a power of two (doubled ladder cannot "
            f"land exactly)"
        )
    if backend == "cuda":
        for name in ("quantized", "doubling"):
            if out[name] is True:
                out[name] = CARD_OPT_IN
    return out


def layout_note(variant: str, layout: str) -> Optional[str]:
    """The reference's reason for declining its segmented-scan row on a
    dense shape under ``RCA_EDGE_LAYOUT=coo|ell``, or None.  It declines
    nothing here: the port's seg steps reduce the same sorted edges under
    every layout (bitwise), so the ``kernels`` row keeps them, and under
    ``ell`` a one-shot analysis runs the gather tables instead."""
    if variant != "dense" or layout == "hybrid":
        return None
    return f"RCA_EDGE_LAYOUT={layout} pins the scan layout"


def steps_note(n_pad: int, e_pad: Optional[int], device) -> str:
    """What a dense ``kernels`` plan of this shape runs for its two
    recursions on ``device`` (:func:`.segscan.steps_form`): on a CUDA
    device one launch each, with one CTA a lane where both layouts of the
    race's graph of the shape fit one CTA's shared memory, else one
    cooperative launch over the card; elsewhere the loop of plain
    steps."""
    if torch.device(device).type != "cuda":
        return (f"per step: the fused recursions are CUDA kernels; on "
                f"{device} the plan runs the plain steps")
    from rca_tpu_torch.engine.segscan import build_seg_layouts, steps_smem

    _, e_pad, src, dst = _timing_harness(n_pad, e_pad)
    live = src != n_pad - 1
    layouts = build_seg_layouts(n_pad, e_pad, src[live], dst[live])
    need, limit = max(steps_smem(seg, device) for seg in layouts)
    if need <= limit:
        return (f"cta: one launch per recursion, one CTA per lane "
                f"({need} of {limit} bytes of shared memory)")
    return (f"grid: one cooperative launch per recursion over the card: "
            f"one CTA would need {need} bytes of shared memory, above the "
            f"{limit} the device allows")


def default_row(device) -> str:
    """The row a shape engages on ``device`` when nothing else is asked
    for: ``kernels`` on the card (the race always elects it there),
    ``torch`` on the CPU."""
    return "kernels" if torch.device(device).type == "cuda" else "torch"


def _pick_winner(timings: Dict[str, Optional[float]]) -> str:
    """Ties go to ``torch``, the plain default: a challenger must beat it
    by more than 5% to take a row."""
    t_torch = timings.get("torch")
    if t_torch is None:
        return "torch"
    best, best_t = "torch", t_torch
    for k, t in timings.items():
        if k != "torch" and t is not None and t < best_t:
            best, best_t = k, t
    return best if best_t < 0.95 * t_torch else "torch"


def _timing_harness(n_pad: int, e_pad: Optional[int]):
    """The synthetic graph the race runs over: a ring over ``n_pad - 1``
    live nodes padded to ``e_pad`` edges, canonical per shape (the row's
    key), not per graph.  Returns ``(n, e_pad, src, dst)``, the edges
    padded with dummy self-loops."""
    import numpy as np

    e_pad = int(e_pad) if e_pad is not None else n_pad
    n = max(1, n_pad - 1)
    dummy = n_pad - 1
    src = np.full(e_pad, dummy, np.int32)
    dst = np.full(e_pad, dummy, np.int32)
    ring = np.arange(min(n, e_pad), dtype=np.int32)
    src[: len(ring)] = ring
    dst[: len(ring)] = (ring + 1) % n
    return n, e_pad, src, dst


def _harness_inputs(n_pad: int, e_pad: Optional[int], device):
    """The race's and the cost capture's inputs over
    :func:`_timing_harness`'s ring: ``(n, e_pad, raw, f, w, dd, down_seg,
    up_seg)``, the raw live edges, seeded features and weights, the padded
    int64 destinations and both seg layouts on ``device``."""
    import numpy as np

    from rca_tpu_torch.engine.segscan import build_seg_layouts
    from rca_tpu_torch.features.schema import NUM_SERVICE_FEATURES

    n, e_pad, src, dst = _timing_harness(n_pad, e_pad)
    raw = src[src != n_pad - 1], dst[src != n_pad - 1]
    rng = np.random.default_rng(0)
    f = torch.from_numpy(rng.uniform(0, 1, (n_pad, NUM_SERVICE_FEATURES))
                         .astype(np.float32)).to(device)
    w = torch.from_numpy(rng.uniform(0.2, 0.9, NUM_SERVICE_FEATURES)
                         .astype(np.float32)).to(device)
    dd = torch.from_numpy(dst.astype(np.int64)).to(device)
    down_seg, up_seg = build_seg_layouts(n_pad, e_pad, *raw, device=device)
    return n, e_pad, raw, f, w, dd, down_seg, up_seg


def _harness_plan(kernel: str, n_pad: int, e_pad: int, raw, steps: int,
                  down_seg, up_seg, device):
    """``kernel``'s plan over the harness graph, its layouts as
    ``runner.kernel_plan`` builds them."""
    from rca_tpu_torch.engine.doubling import doubling_layouts_for
    from rca_tpu_torch.engine.ell import up_ell_for
    from rca_tpu_torch.engine.propagate import KernelPlan
    from rca_tpu_torch.engine.segscan import steps_form

    dbl = None
    if kernel == "doubling":
        dbl = doubling_layouts_for(n_pad, e_pad, *raw, steps, device)
        if dbl is None:
            raise ValueError("doubling frontier declined the harness graph")
    return KernelPlan(kernel, down_seg, up_seg,
                      up_ell_for(n_pad, *raw, device)
                      if kernel == "torch" else None, dbl,
                      steps_form=steps_form(down_seg, up_seg, device)
                      if kernel == "kernels" else "step")


def _time_candidates(n_pad: int, e_pad: Optional[int], steps: int,
                     candidates, device: torch.device,
                     reps: int = 5) -> Dict[str, float]:
    """Host wall per call of each candidate's FULL propagation (front and
    both recursions, as the engine runs it) at this padded shape on the
    card: one warm call, then the best of 3 runs of ``reps`` calls, each
    run ending in a synchronize.  A candidate that fails raises."""
    from rca_tpu_torch.engine.propagate import propagate

    n, e_pad, raw, f, w, dd, down_seg, up_seg = _harness_inputs(
        n_pad, e_pad, device)

    def timed(kernel: str) -> float:
        plan = _harness_plan(kernel, n_pad, e_pad, raw, steps, down_seg,
                             up_seg, device)

        def call():
            return propagate(f, dd, w, w, steps, 0.7, 0.85, 1.6, n, plan,
                             error_contrast=0.7)[4]

        call()
        torch.cuda.synchronize(device)
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(reps):
                call()
            torch.cuda.synchronize(device)
            runs.append(time.perf_counter() - t0)
        return min(runs) * 1e3 / reps

    return {k: timed(k) for k in candidates}


#: why a CPU row carries no peak: torch's CPU allocator keeps no statistics
CPU_MEMORY_UNAVAILABLE = (
    "cpu: the CPU allocator keeps no allocation statistics "
    "(torch.cuda.max_memory_allocated is CUDA's)")


def _tensor_bytes(obj) -> int:
    """The bytes of every tensor in ``obj``: a tensor, a tuple or list (a
    ``KernelPlan``), or a dataclass of them (a layout)."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (tuple, list)):
        return sum(_tensor_bytes(x) for x in obj)
    if dataclasses.is_dataclass(obj):
        return sum(_tensor_bytes(getattr(obj, field.name))
                   for field in dataclasses.fields(obj))
    return 0


def _capture_cost(n_pad: int, e_pad: Optional[int], winner: str,
                  steps: int = 8, device="cpu") -> Dict[str, Any]:
    """The cost of the canonical ranked propagation at this padded shape:
    the row's own ``winner`` run once on ``device`` over
    :func:`_timing_harness`'s ring (the front, both recursions, the score,
    the top-k of ``k = min(13, n_pad)`` and its diagnostic gather).

    ``flops`` and ``bytes_accessed`` are the cost model's
    (:func:`rca_tpu_torch.kernels.cost.propagation`) for the work the call
    does, the same whichever row does it, so rows of different winners
    compare; ``basis: "model"`` says so, ``stages`` keeps each stage's
    ``[bytes, operations]`` and ``n_long`` the harness layouts' long
    segments (up, down) that the recursions' bytes count.
    ``output_bytes`` and ``argument_bytes`` are counted from the call's
    tensors (the arguments: the features, the destinations, the weights
    and the plan's layouts).  On a CUDA device
    ``peak_temp_bytes`` is the allocator's peak during the call less what
    was allocated before it (the call's outputs included: they are live
    at its end); on the CPU ``memory_unavailable`` says why there is
    none.  A winner that cannot run returns ``{"unavailable": reason}``:
    the capture never runs another row in its place."""
    from rca_tpu_torch.engine.propagate import propagate
    from rca_tpu_torch.engine.runner import top_k, topk_diag
    from rca_tpu_torch.kernels import cost

    device = torch.device(device)
    n_pad = int(n_pad)
    kk = min(13, n_pad)
    try:
        n, e_pad, raw, f, w, dd, down_seg, up_seg = _harness_inputs(
            n_pad, e_pad, device)
        plan = _harness_plan(winner, n_pad, e_pad, raw, steps, down_seg,
                             up_seg, device)
        cuda = device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(device)
            before = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        a, h, u, m, score, n_bad = propagate(
            f, dd, w, w, steps, 0.7, 0.85, 1.6, n, plan, error_contrast=0.7)
        vals, idx = top_k(score, kk)
        stacked = torch.stack([a, u, m, score], dim=-2)
        outputs = (stacked, topk_diag(stacked, idx), vals, idx, n_bad)
        if cuda:
            torch.cuda.synchronize(device)
            peak = torch.cuda.max_memory_allocated(device) - before
    except (RuntimeError, ValueError, OSError) as exc:
        return {"unavailable": f"run: {type(exc).__name__}: {exc}"}
    n_long = [int(up_seg.long_ids.shape[0]), int(down_seg.long_ids.shape[0])]
    stages = cost.propagation(n_pad, e_pad, *n_long, kk, steps)
    out: Dict[str, Any] = {
        "kernel": winner, "k": kk, "basis": "model",
        "flops": float(sum(ops for _, ops in stages.values())),
        "bytes_accessed": float(sum(b for b, _ in stages.values())),
        "stages": {name: list(c) for name, c in stages.items()},
        "n_long": n_long,
        "output_bytes": _tensor_bytes(outputs),
        "argument_bytes": _tensor_bytes((f, dd, w, w, plan)),
    }
    if cuda:
        out["peak_temp_bytes"] = int(peak)
    else:
        out["memory_unavailable"] = CPU_MEMORY_UNAVAILABLE
    return out


# -- the process registry and the module-level seam ---------------------------

_REGISTRY: Optional[KernelRegistry] = None
_REGISTRY_LOCK = make_lock("registry._REGISTRY_LOCK")


def get_registry() -> KernelRegistry:
    global _REGISTRY
    with _REGISTRY_LOCK:
        if _REGISTRY is None:
            _REGISTRY = KernelRegistry()
        return _REGISTRY


def reset_registry() -> None:
    """Drop every resolved row (tests flipping env knobs)."""
    get_registry().clear()


def engaged_kernel(n_pad: int, e_pad: Optional[int] = None, steps: int = 8,
                   variant: str = "dense", device="cpu") -> str:
    """THE dispatch seam: which row an ``(n_pad, e_pad)``-padded graph
    engages on ``device``."""
    return get_registry().resolve(n_pad, e_pad=e_pad, steps=steps,
                                  variant=variant, device=device).winner


def kernel_table(ensure_cost: bool = False,
                 cost_max_pad: int = 4096) -> List[Dict[str, Any]]:
    """Every resolved row as dicts: the ``kernels`` CLI, the serve planes'
    ``/metrics`` and ``chip_smoke.py`` read THIS, so they agree by
    construction (``ensure_cost``: see :meth:`KernelRegistry.table`)."""
    return get_registry().table(ensure_cost=ensure_cost,
                                cost_max_pad=cost_max_pad)
