"""graftspec contract tables for the port (the twin of
``rca_tpu.analysis.dataplane.contracts``): the byte budgets of its
device→host transfers, and the static half's shape, dtype and staging
tables.

- :data:`FETCH_BUDGETS` is the quantitative side of the
  ``resident-fetch`` allowlist: every audited fetch surface — the
  ``(path, function)`` that calls the seam
  (:mod:`rca_tpu_torch.engine.fetch`) — declares the named result roles
  it may move (symbolic shapes + dtypes) and a per-call byte budget as an
  expression over the shape symbols.  :func:`budget_violations` proves,
  over the whole :data:`SYMBOL_GRID`, that the declared roles always fit
  the declared budget; specsan
  (:mod:`rca_tpu_torch.analysis.dataplane.specsan`) proves the OBSERVED
  transfers unify with the declared roles at run time.  The roles and
  budget expressions are the JAX package's; the keys are the port's
  functions.  Where the port starts a copy in one function and syncs in
  another (``HostCopy`` in a ``dispatch``, ``numpy()`` in a ``fetch``),
  the budget keys the function that STARTS the copy, which is where the
  bytes are decided.  :data:`REFERENCE_SURFACES` maps each port surface
  to the JAX package's surface(s) it stands for.
- :data:`RANKED_SIGNATURES` — the symbolic (shape, dtype) contract of the
  port's ranked bodies, the plain functions that enqueue the kernels (the
  port has no jit): the input facts the abstract interpreter
  (:mod:`rca_tpu_torch.analysis.dataplane.absint`) seeds each body with,
  and the output facts its returned expressions must prove.  A drift is
  a ``shape-contract`` finding.  :data:`REFERENCE_SIGNATURES` maps each
  to the JAX package's ``JIT_SIGNATURES`` entries, and
  :data:`SIGNATURE_DEVIATIONS` names where the port's outputs differ.
- :data:`DTYPE_RULES` — low precision is legal only in
  ``engine/quantized.py``, and float64 staging nowhere in the staging
  modules (:data:`DATAPLANE_MODULES`); :data:`DEVICE_BODY_MODULES` are
  the modules whose functions ``dtype-discipline`` interprets for
  implicit promotions.

Shape expressions are tuples of ints (exact dims) and symbol names:
``k`` top-k width, ``n_pad`` padded service count, ``B`` padded batch
lanes, ``C`` feature channels, ``E`` padded edge count, ``u`` padded
delta rows, ``m`` counterfactual rows, ``P`` blame-path hops.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

Dim = Union[int, str]

#: itemsizes for the dtypes the contracts speak, by numpy name
ITEMSIZE = {
    "float32": 4, "int32": 4, "float64": 8, "int64": 8,
    "bfloat16": 2, "float16": 2, "int8": 1, "uint8": 1, "bool": 1,
}

#: dtypes legal only inside the quantized kernel module (torch's float8
#: names beside the JAX package's)
LOW_PRECISION_DTYPES = frozenset({
    "bfloat16", "float16", "int8",
    "float8_e4m3fn", "float8_e5m2", "float8_e4m3b11_fnuz",
    "float8_e4m3fnuz", "float8_e5m2fnuz",
})

#: sample values per symbol for the static budget-domination proof;
#: every combination is checked, so a budget expression that ever under-
#: declares its roles fails loudly at lint time
SYMBOL_GRID: Dict[str, Tuple[int, ...]] = {
    "k": (1, 5, 64, 256),
    "n_pad": (8, 256, 4096),
    "B": (1, 8, 64),
    "C": (1, 8, 32),
    "E": (1, 64, 4096),
    "m": (1, 8, 64),
    "P": (1, 4, 16),
}


def dtype_name(dtype) -> str:
    """A dtype's numpy name: ``torch.float32`` and ``float32`` alike give
    ``"float32"``."""
    name = str(dtype)
    return name[len("torch."):] if name.startswith("torch.") else name


class Role(NamedTuple):
    """One named result a fetch surface may move host-ward."""

    name: str
    shape: Tuple[Dim, ...]
    dtype: str


class Fact(NamedTuple):
    """An abstract (shape, dtype) value: ``None`` means unknown — the
    interpreter only ever *proves* with known facts, never guesses."""

    shape: Optional[Tuple[Optional[Dim], ...]]
    dtype: Optional[str]


UNKNOWN = Fact(None, None)


class Sym(NamedTuple):
    """An integer value bound to a shape symbol: a signature's integer
    argument (``kk`` → ``k``) or a dim read off a known shape
    (``x.shape[0]``).  ``dim`` is None for an integer the interpreter
    cannot name."""

    dim: Optional[Dim]


class FetchBudget(NamedTuple):
    roles: Tuple[Role, ...]
    #: per-call byte budget, an expression over SYMBOL_GRID symbols
    #: (evaluated with no builtins)
    budget: str
    #: a documented deferred bulk seam (full diagnostics) — the budget
    #: still holds, but it is O(n_pad) by design, off the latency path
    bulk: bool = False


def _r(name: str, shape: Tuple[Dim, ...], dtype: str = "float32") -> Role:
    return Role(name, shape, dtype)


_TOPK_ROLES = (
    _r("diag", (4, "k")), _r("vals", ("k",)),
    _r("idx", ("k",), "int32"), _r("n_bad", (), "int32"),
)
_BATCH_ROLES = (
    _r("diag", ("B", 4, "k")), _r("vals", ("B", "k")),
    _r("idx", ("B", "k"), "int32"), _r("n_bad", (), "int32"),
)
_TICK_ROLES = (
    _r("vals", ("k",)), _r("idx", ("k",), "int32"),
    _r("n_bad", (), "int32"),
)
_BULK_ROLES = (_r("stacked", (4, "n_pad")),)

_RUNNER = "rca_tpu_torch/engine/runner.py"

#: (repo-relative path, function) -> FetchBudget.  MUST cover every
#: allowlisted function in residentfetch.FETCH_SURFACES (asserted by
#: coverage()) — an audited surface without a byte budget is an
#: unquantified contract.
FETCH_BUDGETS: Dict[Tuple[str, str], FetchBudget] = {
    # one-shot analyze (the sharded engine's restaged analysis too): the
    # [4,k] gather, the top-k pair, the sanitize count
    (_RUNNER, "timed_fetch"): FetchBudget(_TOPK_ROLES, "24*k + 8"),
    (_RUNNER, "analyze_batch"): FetchBudget(_BATCH_ROLES, "24*B*k + 8"),
    # THE deferred bulk seam: the parked [4, n_pad] stack, fetched lazily
    # on first diagnostics use — budgeted, but bulk by design
    (_RUNNER, "full_diagnostics"): FetchBudget(
        _BULK_ROLES, "16*n_pad", bulk=True),
    # the sharded stack's join: one [4, block] block a call
    ("rca_tpu_torch/parallel/sharded.py", "numpy"): FetchBudget(
        _BULK_ROLES, "16*n_pad", bulk=True),
    # the dense and the sharded resident sessions' one sync point
    ("rca_tpu_torch/engine/resident.py", "_fetch_topk"): FetchBudget(
        _TOPK_ROLES, "24*k + 8"),
    # causelens: [5,k] diag + [m,k] counterfactual deltas + five [k,P]
    # path arrays (the sweep's call), then [k,C] saliency + the top-m
    # pair (the saliency's call) — top-k/m-sized
    ("rca_tpu_torch/engine/attribution.py",
     "compute_attribution"): FetchBudget(
        (
            _r("diag", (5, "k")), _r("deltas", ("m", "k")),
            _r("path_edge", ("k", "P"), "int32"),
            _r("path_term", ("k", "P")),
            _r("path_dst", ("k", "P"), "int32"),
            _r("path_hard", ("k", "P")), _r("path_up", ("k", "P")),
            _r("sal_cand", ("k", "C")), _r("sal_vals", ("m",)),
            _r("sal_idx", ("m",), "int32"),
        ),
        "4*(5*k + m*k + 5*k*P + k*C + 2*m) + 64"),
    ("rca_tpu_torch/engine/sharded_runner.py", "analyze_batch"): FetchBudget(
        _BATCH_ROLES, "24*B*k + 8"),
    # streaming tick + serve: the copies start in dispatch
    ("rca_tpu_torch/engine/streaming.py", "dispatch"): FetchBudget(
        _TICK_ROLES, "8*k + 8"),
    ("rca_tpu_torch/parallel/streaming.py", "dispatch"): FetchBudget(
        _TICK_ROLES, "8*k + 8"),
    ("rca_tpu_torch/serve/dispatcher.py", "dispatch"): FetchBudget(
        _BATCH_ROLES, "24*B*k + 8"),
}

#: port surface -> the JAX package's FETCH_BUDGETS surface(s) it stands
#: for: the port starts a tick's or a serve batch's
#: copies in ``dispatch`` (the reference fetches in ``fetch``), runs the
#: sharded resident session through the dense session's ``_fetch_topk``,
#: and joins a sharded stack per block
REFERENCE_SURFACES: Dict[Tuple[str, str], Tuple[Tuple[str, str], ...]] = {
    (_RUNNER, "timed_fetch"): (
        ("rca_tpu/engine/runner.py", "timed_fetch"),),
    (_RUNNER, "analyze_batch"): (
        ("rca_tpu/engine/runner.py", "analyze_batch"),),
    (_RUNNER, "full_diagnostics"): (
        ("rca_tpu/engine/runner.py", "full_diagnostics"),),
    ("rca_tpu_torch/parallel/sharded.py", "numpy"): (
        ("rca_tpu/engine/runner.py", "full_diagnostics"),),
    ("rca_tpu_torch/engine/resident.py", "_fetch_topk"): (
        ("rca_tpu/engine/resident.py", "_fetch_topk"),
        ("rca_tpu/parallel/sharded.py", "_fetch_topk")),
    ("rca_tpu_torch/engine/attribution.py", "compute_attribution"): (
        ("rca_tpu/engine/attribution.py", "compute_attribution"),),
    ("rca_tpu_torch/engine/sharded_runner.py", "analyze_batch"): (
        ("rca_tpu/engine/sharded_runner.py", "analyze_batch"),),
    ("rca_tpu_torch/engine/streaming.py", "dispatch"): (
        ("rca_tpu/engine/streaming.py", "fetch"),),
    ("rca_tpu_torch/parallel/streaming.py", "dispatch"): (
        ("rca_tpu/parallel/streaming.py", "fetch"),),
    ("rca_tpu_torch/serve/dispatcher.py", "dispatch"): (
        ("rca_tpu/serve/dispatcher.py", "fetch"),),
}


_STREAMING = "rca_tpu_torch/engine/streaming.py"

#: the device staging modules: pow2 padding, explicit-dtype staging, and
#: dummy-row fills are enforced here.  The sharded/parallel layouts pad
#: to data-parallel multiples and per-shard maxima by design, so they
#: are deliberately NOT in this scope (their shape stability is pinned
#: per graph, not per bucket).
DATAPLANE_MODULES = frozenset({
    _RUNNER,
    "rca_tpu_torch/engine/resident.py",
    _STREAMING,
    "rca_tpu_torch/serve/dispatcher.py",
    "rca_tpu_torch/engine/ell.py",
})

DTYPE_RULES = {
    # bf16/f16/f8/int8 live ONLY in the quantized row's module — anywhere
    # else an implicit f32<->low-precision promotion silently changes
    # ranking arithmetic (SCORE_EPS is calibrated per dtype)
    "low_precision_ok": frozenset({"rca_tpu_torch/engine/quantized.py"}),
    # float64 staging doubles upload bytes and moves every downstream op
    # to the card's slow float64 path; forbidden in the staging modules
    "no_float64_staging": DATAPLANE_MODULES,
}

#: the modules whose functions are device bodies (the port's twin of the
#: JAX package's jit functions): every function here, and every entry of
#: RANKED_SIGNATURES, is interpreted for implicit promotions
DEVICE_BODY_MODULES = DATAPLANE_MODULES | frozenset({
    "rca_tpu_torch/engine/propagate.py",
    # the fronts: the dense fused front, the sharded front over every shard
    # of one card, their halves and their plain versions
    "rca_tpu_torch/engine/evidence.py",
    # the seg steps, the one-launch, grid and shard recursions and their
    # plain versions
    "rca_tpu_torch/engine/segscan.py",
})

_RANKED_OUTPUTS = (
    _r("stacked", (4, "n_pad")), _r("diag", (4, "k")), _r("vals", ("k",)),
    _r("idx", ("k",), "int64"), _r("n_bad", (), "int32"),
)

#: symbolic signatures of the port's ranked bodies: the input facts the
#: interpreter seeds each body with (a :class:`Sym` binds an integer
#: argument to its symbol), and the output facts the returned expressions
#: must prove equal to, positionally.  What the port's code gives:
#: top-k indices are int64 on the device (``torch.sort``) and become
#: int32 only in the fetch seam; the delta bodies write the ``[n_pad, C]``
#: buffer in place (``index_copy_``) and do not return it; ``n_bad`` comes
#: out of the model's call, whose summary leaves its dtype to the model
#: (every front gives a 0-dim int32, which the CPU tests pin).  The
#: resident request's body is ``propagate_ranked`` itself.
RANKED_SIGNATURES: Dict[Tuple[str, str], Dict[str, object]] = {
    (_RUNNER, "propagate_ranked"): {
        "inputs": {
            "features": Fact(("n_pad", "C"), "float32"),
            "dep_dst": Fact(("E",), "int64"),
            "kk": Sym("k"),
        },
        "outputs": _RANKED_OUTPUTS,
    },
    # a hypothesis batch staged as a delta over the resident base: the
    # ranked outputs gain the lane dim ``B``
    (_RUNNER, "propagate_ranked_batch_delta"): {
        "inputs": {
            "base": Fact(("n_pad", "C"), "float32"),
            "idx_b": Fact(("B", "u"), "int64"),
            "rows_b": Fact(("B", "u", "C"), "float32"),
            "dep_dst": Fact(("E",), "int64"),
            "kk": Sym("k"),
        },
        "outputs": (
            _r("stacked", ("B", 4, "n_pad")), _r("diag", ("B", 4, "k")),
            _r("vals", ("B", "k")), _r("idx", ("B", "k"), "int64"),
            _r("n_bad", (), "int32"),
        ),
        "lanes": "B",
    },
    (_STREAMING, "flush_propagate_ranked"): {
        "inputs": {
            "features": Fact(("n_pad", "C"), "float32"),
            "idx": Fact(("u",), "int64"),
            "rows": Fact(("u", "C"), "float32"),
            "dep_dst": Fact(("E",), "int64"),
            "kk": Sym("k"),
        },
        "outputs": (
            _r("vals", ("k",)), _r("idx", ("k",), "int64"),
            _r("n_bad", (), "int32"),
        ),
    },
}

#: port ranked body -> the JAX package's JIT_SIGNATURES entries it stands
#: for (a ``lanes`` entry against its twin with the lane dim dropped)
REFERENCE_SIGNATURES: Dict[Tuple[str, str], Tuple[Tuple[str, str], ...]] = {
    (_RUNNER, "propagate_ranked"): (
        ("rca_tpu/engine/runner.py", "_propagate_ranked"),
        ("rca_tpu/engine/resident.py", "_resident_delta_ranked")),
    (_RUNNER, "propagate_ranked_batch_delta"): (
        ("rca_tpu/engine/runner.py", "_propagate_ranked"),),
    (_STREAMING, "flush_propagate_ranked"): (
        ("rca_tpu/engine/streaming.py", "_flush_propagate_ranked"),),
}

#: role -> why the port's ranked bodies differ from their twins there
SIGNATURE_DEVIATIONS: Dict[str, str] = {
    "idx": "int64 on the device (torch.sort); the fetch seam casts the "
           "top-k indices to int32 on the card",
    "features": "the delta bodies write the buffer in place "
                "(index_copy_) instead of returning it",
}


def role_bytes(role: Role, binding: Dict[str, int]) -> int:
    n = ITEMSIZE[role.dtype]
    for d in role.shape:
        n *= d if isinstance(d, int) else binding[d]
    return n


def eval_budget(expr: str, binding: Dict[str, int]) -> int:
    return int(eval(expr, {"__builtins__": {}}, dict(binding)))


def _symbols(budget: FetchBudget) -> List[str]:
    syms = {d for r in budget.roles for d in r.shape if isinstance(d, str)}
    syms |= {s for s in SYMBOL_GRID if s in budget.budget}
    return sorted(syms)


def budget_violations() -> List[dict]:
    """The static domination proof: for every surface and every grid
    binding, the declared roles' total bytes must fit the declared
    budget.  Non-empty return = the contract table itself is unsound."""
    out: List[dict] = []
    for (path, func), budget in sorted(FETCH_BUDGETS.items()):
        syms = _symbols(budget)
        grids = [SYMBOL_GRID[s] for s in syms]
        for values in itertools.product(*grids):
            binding = dict(zip(syms, values))
            total = sum(role_bytes(r, binding) for r in budget.roles)
            cap = eval_budget(budget.budget, binding)
            if total > cap:
                out.append({
                    "surface": f"{path}::{func}", "binding": binding,
                    "roles_bytes": total, "budget_bytes": cap,
                })
                break  # one witness per surface is enough
    return out


def coverage() -> List[str]:
    """Allowlisted fetch functions missing a FETCH_BUDGETS row (must be
    empty: an audited surface without a byte budget is unquantified)."""
    from rca_tpu_torch.analysis.rules.residentfetch import FETCH_SURFACES

    missing = []
    for path, funcs in sorted(FETCH_SURFACES.items()):
        for func in sorted(funcs):
            if (path, func) not in FETCH_BUDGETS:
                missing.append(f"{path}::{func}")
    return missing


def role_name(leaf_name: str) -> str:
    """Normalize a fetched expression's terminal name to its role name:
    ``self._stacked_dev`` -> ``stacked``, ``handle.vals`` -> ``vals``,
    ``topi`` -> ``idx``."""
    name = leaf_name.lstrip("_")
    for suffix in ("_dev", "_h", "_b"):
        if name.endswith(suffix):
            name = name[: -len(suffix)]
    return {"topi": "idx"}.get(name, name)
