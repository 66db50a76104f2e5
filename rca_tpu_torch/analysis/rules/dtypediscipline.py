"""Rule ``dtype-discipline``: low-precision arithmetic lives ONLY in the
quantized row's module (the port's twin of the JAX package's rule).

The quantized row (bf16 evidence + per-row int8 messages) is legal
precisely because ``engine/quantized.py`` owns the scale bookkeeping and
the rank-parity gate that certifies it.  A bf16 / f16 / f8 / int8 cast
anywhere else — or an implicit f32↔low-precision promotion inside a
device body — changes ranking arithmetic with no test failing until a
tie breaks differently on the card (SCORE_EPS is calibrated per dtype).

Three checks, driven by ``DTYPE_RULES``:

1. an explicit low-precision cast outside the allowlisted module: a
   ``.to(torch.bfloat16)`` / ``.type(...)`` / ``.half()`` /
   ``.bfloat16()`` / ``.char()``, a typed constructor
   (``torch.zeros(..., dtype=torch.float16)``, ``x.new_zeros(...,
   dtype=...)``, ``np.asarray(x, np.int8)``) or ``np.int8(x)``.  A float
   low-precision cast is a finding wherever it is; an int8 cast only in a
   device context (a ``torch`` call or dtype, a tensor method, or a
   staging module): host-side int8 metadata tags (the graph's node and
   edge types) are a compact encoding, not ranking arithmetic;
2. an implicit mixed-precision promotion the abstract interpreter can
   prove inside a device body: every function of
   ``DEVICE_BODY_MODULES`` (the port has no jit; these are the modules
   whose functions enqueue device work), and every ranked body of
   ``RANKED_SIGNATURES`` with its declared inputs;
3. float64 staging in the staging modules (``np.zeros(..., np.float64)``,
   ``.astype(np.float64)``, ``.double()``, ``.to(torch.float64)``) —
   doubles the upload bytes and moves every downstream op to the card's
   float64 path.
"""

from __future__ import annotations

import ast
from typing import List

from rca_tpu_torch.analysis.core import FileContext, Finding, Rule, register
from rca_tpu_torch.analysis.dataplane import absint, contracts

_CONSTRUCTORS = frozenset({
    "zeros", "ones", "full", "empty", "asarray", "array", "arange",
    "zeros_like", "ones_like", "full_like", "empty_like", "astype", "view",
    "tensor", "as_tensor", "new_zeros", "new_ones", "new_full",
    "new_empty", "new_tensor", "to", "type",
})

_FLOAT_LOW = contracts.LOW_PRECISION_DTYPES - {"int8"}


def _is_device_call(node: ast.Call) -> bool:
    """Does this call spell a torch root anywhere in its callee?"""
    f = node.func
    while isinstance(f, ast.Attribute):
        f = f.value
        if isinstance(f, ast.Name) and f.id in ("torch", "F"):
            return True
    return False


def _root_is_torch(node: ast.expr) -> bool:
    while isinstance(node, ast.Attribute):
        node = node.value
    return isinstance(node, ast.Name) and node.id == "torch"


def _cast_dtype(node: ast.Call):
    """``(dtype, dtype_node, tensor_method)`` this call casts or
    constructs to, else ``("", None, False)``; ``tensor_method`` for the
    torch-only spellings (``x.half()``)."""
    f = node.func
    name = f.attr if isinstance(f, ast.Attribute) else (
        f.id if isinstance(f, ast.Name) else "")
    # direct constructor: np.int8(x) / np.float64(x)
    direct = absint.dtype_of_node(f)
    if direct is not None and node.args:
        return direct, f, False
    if (isinstance(f, ast.Attribute) and name in absint.METHOD_CASTS
            and not node.args and not node.keywords
            and not absint.is_module(f.value)):
        return absint.METHOD_CASTS[name], f, True
    if name not in _CONSTRUCTORS:
        return "", None, False
    for kw in node.keywords:
        if kw.arg == "dtype":
            d = absint.dtype_of_node(kw.value)
            if d:
                return d, kw.value, False
    for a in node.args:
        d = absint.dtype_of_node(a)
        if d is not None:
            return d, a, False
    return "", None, False


@register
class DtypeDisciplineRule(Rule):
    name = "dtype-discipline"
    summary = ("bf16/f16/int8 casts only in engine/quantized.py; no "
               "implicit mixed-precision promotion; no float64 staging")
    why = ("the quantized row is legal because quantized.py owns the "
           "scale bookkeeping and the rank-parity gate; a low-precision "
           "cast or implicit promotion anywhere else shifts ranking "
           "arithmetic with no test failing until a tie breaks "
           "differently on the card")

    def applies_to(self, relpath: str) -> bool:
        return (relpath.startswith("rca_tpu_torch/")
                and relpath not in contracts.DTYPE_RULES["low_precision_ok"])

    _TRIGGERS = ("bfloat16", "float16", "float8", "int8", "float64",
                 "half", "double", "char(")

    def scan(self, ctx: FileContext) -> List[Finding]:
        signatures = {
            fname: spec for (path, fname), spec
            in contracts.RANKED_SIGNATURES.items() if path == ctx.relpath
        }
        device_module = ctx.relpath in contracts.DEVICE_BODY_MODULES
        # fast path: every finding this rule can emit requires one of the
        # trigger spellings in the file (facts in the interpreter
        # originate from dtype references), so a file without them
        # cannot fire
        if not any(t in ctx.source for t in self._TRIGGERS):
            return []
        hits: List[Finding] = []
        f64_scope = ctx.relpath in contracts.DTYPE_RULES[
            "no_float64_staging"]
        staging = ctx.relpath in contracts.DATAPLANE_MODULES

        def walk(node: ast.AST, func: str) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                func = node.name
            if isinstance(node, ast.Call):
                dt, dt_node, method = _cast_dtype(node)
                device = (staging or method or _is_device_call(node)
                          or (dt_node is not None
                              and _root_is_torch(dt_node)))
                if dt in _FLOAT_LOW or (dt == "int8" and device):
                    hits.append(ctx.finding(
                        self, node.lineno,
                        f"low-precision cast to {dt} outside "
                        "engine/quantized.py — quantization lives behind "
                        "the rank-parity-gated row, not inline (SCORE_EPS "
                        "is calibrated per dtype)", func=func,
                    ))
                elif dt == "float64" and f64_scope:
                    hits.append(ctx.finding(
                        self, node.lineno,
                        "float64 staging in a staging module — doubles "
                        "host->device upload bytes and moves every "
                        "downstream op to the card's float64 path; stage "
                        "float32", func=func,
                    ))
            for child in ast.iter_child_nodes(node):
                walk(child, func)

        walk(ctx.tree, "<module>")

        # implicit promotions the interpreter can prove inside the device
        # bodies (nested functions are interpreted on their own too; a
        # promotion seen twice is reported once)
        if not (device_module or signatures):
            return hits
        seen = set()
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not device_module and node.name not in signatures:
                continue
            inputs = signatures.get(node.name, {}).get("inputs", {})
            interp = absint.interpret_function(node, inputs)
            for lineno, a, b in interp.events.promotions:
                if (lineno, a, b) in seen:
                    continue
                seen.add((lineno, a, b))
                hits.append(ctx.finding(
                    self, lineno,
                    f"implicit {a}<->{b} promotion inside a device body — "
                    "mixed-precision arithmetic outside the quantized "
                    "row changes ranking results silently",
                    func=node.name,
                ))
        return hits
