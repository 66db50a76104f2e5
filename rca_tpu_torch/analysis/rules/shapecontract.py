"""Rule ``shape-contract``: the staging modules' layout invariants hold
statically (the port's twin of the JAX package's rule).

Four checks, all over the declarative tables in
:mod:`rca_tpu_torch.analysis.dataplane.contracts`:

1. **pow2 padding** — every ``*_pad`` assignment in a staging module must
   be PROVABLY produced by a recognized stable-shape producer:
   ``bucket_for``, ``pow2_pad`` (any ``*_pad`` callee), ``1 << ...`` /
   ``2 ** ...``, a pow2 literal, another ``*_pad`` value,
   ``max``/``min``/ternary over provables, or the ceil-to-multiple
   alignment idiom ``-(-x // d) * d``.  A pad that is merely pow2 *at
   run time* but not provably so is one refactor away from a new
   registry election and layout build per graph.
2. **staging discipline** — ``np.zeros/full/empty/ones`` and
   ``torch.zeros/full/empty/ones`` staging buffers carry an explicit
   dtype, and an integer ``full`` fill must not be a non-negative literal
   (a REAL row index: padding must point at the dummy row, spelled as
   ``n_pad - 1`` or a named dummy).
3. **ranked signature conformance** — the abstract interpreter walks
   each body in ``RANKED_SIGNATURES`` with its declared input facts and
   proves the returned expressions match the declared output contract.
4. **fetch-surface roles + budget soundness** — a seam call
   (``device_get(...)``, ``HostCopy(...)``) inside a budgeted surface may
   only move the declared roles (leaf names, a cast on the way unwrapped,
   and the names a seam call's result unpacks into are matched against
   the FETCH_BUDGETS row), and the contract table itself must pass the
   grid domination proof (roles always fit the budget) and cover every
   resident-fetch allowlist entry.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from rca_tpu_torch.analysis.core import FileContext, Finding, Rule, register
from rca_tpu_torch.analysis.dataplane import absint, contracts

CONTRACTS_REL = "rca_tpu_torch/analysis/dataplane/contracts.py"
_STAGING_FNS = ("zeros", "full", "empty", "ones")
_STAGING_ROOTS = ("np", "torch")
_POW2_PRODUCER_SUFFIXES = ("_pad", "_bucket")
_POW2_PRODUCER_NAMES = ("bucket_for", "next_pow2", "pow2_ceil", "int")
#: the seam's entries (rca_tpu_torch/engine/fetch.py)
_SEAM = ("device_get", "HostCopy")
#: the casts a fetched leaf may pass through on its way to the seam
_LEAF_CASTS = frozenset({"to", "type", "contiguous"}) | frozenset(
    absint.METHOD_CASTS)


def _callee_name(func: ast.expr) -> str:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return ""


def _is_pow2_literal(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def pow2_provable(node: ast.expr) -> bool:
    """Can ``node`` be statically proven to come from a sanctioned
    stable-shape producer?  (See the rule docstring for the grammar.)"""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, int) and _is_pow2_literal(node.value)
    if isinstance(node, ast.Name):
        return node.id.endswith(_POW2_PRODUCER_SUFFIXES)
    if isinstance(node, ast.Attribute):
        return node.attr.endswith(_POW2_PRODUCER_SUFFIXES)
    if isinstance(node, ast.IfExp):
        return pow2_provable(node.body) and pow2_provable(node.orelse)
    if isinstance(node, ast.Call):
        name = _callee_name(node.func)
        if name.endswith(_POW2_PRODUCER_SUFFIXES) \
                or name in _POW2_PRODUCER_NAMES:
            if name == "int":
                return bool(node.args) and pow2_provable(node.args[0])
            return True
        if name in ("max", "min"):
            return all(pow2_provable(a) for a in node.args)
        return False
    if isinstance(node, ast.BinOp):
        if isinstance(node.op, ast.LShift):
            return (isinstance(node.left, ast.Constant)
                    and node.left.value in (1, 2))
        if isinstance(node.op, ast.Pow):
            return isinstance(node.left, ast.Constant) \
                and node.left.value == 2
        # the alignment idiom: -(-x // d) * d (ceil to a multiple of d —
        # the batch lanes' data-parallel round-up; x must be provable)
        if isinstance(node.op, ast.Mult):
            left = node.left
            if (isinstance(left, ast.UnaryOp)
                    and isinstance(left.op, ast.USub)
                    and isinstance(left.operand, ast.BinOp)
                    and isinstance(left.operand.op, ast.FloorDiv)
                    and isinstance(left.operand.left, ast.UnaryOp)
                    and isinstance(left.operand.left.op, ast.USub)):
                return pow2_provable(left.operand.left.operand)
        return False
    return False


def _staging_call(node: ast.Call) -> Optional[str]:
    """``"np"`` / ``"torch"`` when ``node`` is a staging constructor."""
    f = node.func
    if (isinstance(f, ast.Attribute) and f.attr in _STAGING_FNS
            and isinstance(f.value, ast.Name)
            and f.value.id in _STAGING_ROOTS):
        return f.value.id
    return None


def _dtype_arg(node: ast.Call) -> Optional[ast.expr]:
    for kw in node.keywords:
        if kw.arg == "dtype":
            return kw.value
    for a in node.args:
        if absint.dtype_of_node(a) is not None:
            return a
    return None


def _leaf_name(node: ast.expr) -> Optional[str]:
    """The resolvable name of one fetched leaf: a name, an attribute's
    leaf, through a cast (``idx.to(torch.int32)`` is ``idx``); None for
    an aggregate or an expression (``out[2]``, a call's result)."""
    while (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
           and node.func.attr in _LEAF_CASTS):
        node = node.func.value
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _seam_call(node: ast.AST) -> Optional[ast.Call]:
    """The seam call behind ``node``: ``device_get(...)``,
    ``HostCopy(...)`` or ``HostCopy(...).numpy()``."""
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "numpy" and not node.args):
        node = node.func.value
    if isinstance(node, ast.Call) and _callee_name(node.func) in _SEAM:
        return node
    return None


@register
class ShapeContractRule(Rule):
    name = "shape-contract"
    summary = ("staging shapes prove their contracts: pow2 pads, "
               "explicit-dtype staging, ranked signature conformance, "
               "budgeted fetch roles")
    why = ("a pad that is pow2 only by accident stages a new shape (an "
           "election and a layout build) per graph the day the producer "
           "changes; a drifted ranked body or an undeclared fetch role "
           "ships as a silent latency cliff, not a test failure")

    def applies_to(self, relpath: str) -> bool:
        return (relpath in contracts.DATAPLANE_MODULES
                or relpath == CONTRACTS_REL
                or any(relpath == p for p, _ in contracts.FETCH_BUDGETS)
                or any(relpath == p for p, _ in contracts.RANKED_SIGNATURES))

    def scan(self, ctx: FileContext) -> List[Finding]:
        hits: List[Finding] = []
        if ctx.relpath == CONTRACTS_REL:
            self._check_tables(ctx, hits)
        if ctx.relpath in contracts.DATAPLANE_MODULES:
            self._check_staging(ctx, hits)
        self._check_signatures(ctx, hits)
        self._check_fetch_roles(ctx, hits)
        return hits

    # -- 4: the contract tables themselves ---------------------------------

    def _check_tables(self, ctx: FileContext, hits: List[Finding]) -> None:
        for v in contracts.budget_violations():
            hits.append(ctx.finding(
                self, 1,
                f"FETCH_BUDGETS unsound: {v['surface']} roles need "
                f"{v['roles_bytes']}B > budget {v['budget_bytes']}B at "
                f"{v['binding']}", func="<module>",
            ))
        for missing in contracts.coverage():
            hits.append(ctx.finding(
                self, 1,
                f"audited fetch surface {missing} has no FETCH_BUDGETS "
                "row — every allowlisted surface declares its byte "
                "budget", func="<module>",
            ))

    # -- 1 + 2: pads and staging constructors ------------------------------

    def _check_staging(self, ctx: FileContext, hits: List[Finding]) -> None:
        def walk(node: ast.AST, func: str) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                func = node.name
            if isinstance(node, ast.Assign):
                pads = [
                    t for t in node.targets
                    if (isinstance(t, ast.Name) and t.id.endswith("_pad"))
                    or (isinstance(t, ast.Attribute)
                        and t.attr.endswith("_pad"))
                ]
                if pads and not pow2_provable(node.value):
                    hits.append(ctx.finding(
                        self, node.lineno,
                        "`*_pad` not provably a stable-shape producer "
                        "(bucket_for / pow2_pad / 1<<ceil-log2 / pow2 "
                        "literal / *_pad / max-min-ternary over those / dp "
                        "alignment) — a pad that is pow2 only by accident "
                        "stages a new shape per graph when the producer "
                        "drifts", func=func,
                    ))
            root = _staging_call(node) if isinstance(node, ast.Call) \
                else None
            if root is not None:
                dtype = _dtype_arg(node)
                if dtype is None:
                    hits.append(ctx.finding(
                        self, node.lineno,
                        f"{root}.{_callee_name(node.func)} staging buffer "
                        "without an explicit dtype — numpy's float64 "
                        "default doubles the upload, torch's default is "
                        "process state; name the staged dtype", func=func,
                    ))
                fill = node.args[1] if len(node.args) >= 2 else None
                if (_callee_name(node.func) == "full"
                        and absint.dtype_of_node(dtype) in ("int32",
                                                            "int64")
                        and isinstance(fill, ast.Constant)
                        and isinstance(fill.value, int)
                        and fill.value >= 0):
                    hits.append(ctx.finding(
                        self, node.lineno,
                        "int index padding filled with a literal row id "
                        f"({fill.value}) — padding must point at the "
                        "dummy row (`n_pad - 1` or a named dummy), or "
                        "padded lanes corrupt a real row", func=func,
                    ))
            for child in ast.iter_child_nodes(node):
                walk(child, func)

        walk(ctx.tree, "<module>")

    # -- 3: ranked signature conformance -----------------------------------

    def _check_signatures(self, ctx: FileContext, hits: List[Finding]) -> None:
        table = {
            fname: spec for (path, fname), spec
            in contracts.RANKED_SIGNATURES.items() if path == ctx.relpath
        }
        if not table:
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.FunctionDef) \
                    or node.name not in table:
                continue
            spec = table[node.name]
            interp = absint.interpret_function(node, spec["inputs"])
            declared = spec["outputs"]
            for ret in interp.returns:
                actual = ret if absint.is_seq(ret) else (ret,)
                if len(actual) != len(declared):
                    hits.append(ctx.finding(
                        self, node.lineno,
                        f"{node.name} returns {len(actual)} values, "
                        f"contract declares {len(declared)}",
                        func=node.name,
                    ))
                    continue
                for got, role in zip(actual, declared):
                    msg = absint.fact_conforms(got, role)
                    if msg:
                        hits.append(ctx.finding(
                            self, node.lineno,
                            f"{node.name} breaks its ranked signature "
                            f"contract: {msg}", func=node.name,
                        ))

    # -- 4: fetch surfaces move only declared roles ------------------------

    def _check_fetch_roles(self, ctx: FileContext, hits: List[Finding]) -> None:
        budgets = {
            fname: b for (path, fname), b in contracts.FETCH_BUDGETS.items()
            if path == ctx.relpath
        }
        if not budgets:
            return

        def check_names(names: List[str], budget, lineno: int,
                        func: str) -> None:
            roles = {r.name for r in budget.roles}
            for n in names:
                rn = contracts.role_name(n)
                if rn not in roles:
                    hits.append(ctx.finding(
                        self, lineno,
                        f"fetch of `{n}` is not a declared FETCH_BUDGETS "
                        f"role for this surface (roles: "
                        f"{', '.join(sorted(roles))}) — audit it into "
                        "the contract or keep it on device", func=func,
                    ))

        def walk(node: ast.AST, func: str) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                func = node.name
            if (isinstance(node, ast.Assign) and func in budgets
                    and _seam_call(node.value) is not None
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], (ast.Tuple, ast.List))):
                names = [t.id for t in node.targets[0].elts
                         if isinstance(t, ast.Name)]
                check_names(names, budgets[func], node.lineno, func)
            if (isinstance(node, ast.Call) and func in budgets
                    and _callee_name(node.func) in _SEAM):
                names = [_leaf_name(a) for a in node.args
                         if not isinstance(a, ast.Starred)]
                check_names([n for n in names if n], budgets[func],
                            node.lineno, func)
            for child in ast.iter_child_nodes(node):
                walk(child, func)

        walk(ctx.tree, "<module>")
