"""graftspec's abstract interpreter for the port: symbolic (shape, dtype)
facts over torch expressions (the twin of
``rca_tpu.analysis.dataplane.absint``).

A deliberately honest interpreter: every construct it does not model
evaluates to :data:`~rca_tpu_torch.analysis.dataplane.contracts.UNKNOWN`,
and checks downstream only ever fire on KNOWN facts — so a gap in the op
table costs coverage, never a false positive.  Dims are ints (exact) or
symbol names (``"n_pad"``); ``None`` dims are wildcards.  An integer
value that names a dim (a signature's ``kk``, a ``x.shape[0]``) is a
:class:`~rca_tpu_torch.analysis.dataplane.contracts.Sym`.

The vocabulary is torch's, as the ranked bodies spell it: dtypes by
canonical name, torch's aliases (``torch.float``, ``torch.long``, ...)
and numpy's; casts as ``.to(dtype)``, ``.type(dtype)``, ``.float()`` and
its siblings, numpy's ``.astype``; the typed constructors and
``Tensor.new_*``; torch's promotion (:func:`promote`: a 0-dim tensor or a
Python number does not promote a dimensioned tensor of its category);
``torch.stack(..., dim=)``, ``torch.sort``, slicing with an Ellipsis,
advanced indexing, ``torch.gather``, ``expand``, ``view`` / ``reshape``,
``torch.arange``, in-place ops (which return their receiver);
``propagate_auto``, the model's call, ``top_k``, ``topk_diag`` and
``propagate_ranked`` through :data:`SEMANTICS` (signature-level summaries
— the propagation core is covered by its own tests).  Binops whose
operands straddle the low-precision boundary are recorded as promotion
events for the ``dtype-discipline`` rule; casts likewise.
"""

from __future__ import annotations

import ast
from typing import Callable, Dict, List, Optional, Tuple, Union

from rca_tpu_torch.analysis.dataplane.contracts import (
    ITEMSIZE,
    LOW_PRECISION_DTYPES,
    UNKNOWN,
    Fact,
    Sym,
)

Dims = Tuple[Optional[Union[int, str]], ...]

#: canonical dtype names, as an attribute of any module or as a string
_DTYPE_NAMES = frozenset({
    "float32", "float64", "float16", "bfloat16", "int8", "int16",
    "int32", "int64", "uint8", "uint32", "bool_",
} | LOW_PRECISION_DTYPES)

#: torch's dtype aliases (only as ``torch.<alias>``)
_TORCH_ALIASES = {
    "float": "float32", "double": "float64", "half": "float16",
    "long": "int64", "int": "int32", "short": "int16", "bool": "bool",
}

#: numpy's (only as ``np.<alias>`` / ``numpy.<alias>``)
_NUMPY_ALIASES = {
    "double": "float64", "single": "float32", "half": "float16",
    "bool": "bool",
}

#: the tensor methods that cast to a fixed dtype (``x.half()``)
METHOD_CASTS = {
    "float": "float32", "double": "float64", "half": "float16",
    "bfloat16": "bfloat16", "long": "int64", "int": "int32",
    "short": "int16", "char": "int8", "byte": "uint8", "bool": "bool",
}

#: module roots whose attributes are functions, not tensor methods
_MODULE_ROOTS = frozenset({"torch", "np", "numpy", "F", "nn", "math"})

_ELEMENTWISE = frozenset({
    "maximum", "minimum", "fmax", "fmin", "where", "abs", "exp", "log",
    "log1p", "clamp", "clip", "nan_to_num", "sqrt", "square", "tanh",
    "sigmoid", "relu", "add", "sub", "subtract", "mul", "multiply", "div",
    "divide", "pow", "neg", "negative", "sign", "floor", "ceil", "round",
    "reciprocal", "rsqrt",
})

#: elementwise predicates: their result is bool whatever the inputs
_PREDICATES = frozenset({
    "isfinite", "isnan", "isinf", "logical_and", "logical_or",
    "logical_not", "logical_xor", "eq", "ne", "lt", "le", "gt", "ge",
})

#: ops that return their receiver's fact unchanged
_SAME = frozenset({
    "clone", "contiguous", "detach", "cpu", "cuda", "pin_memory",
    "requires_grad_",
})

_REDUCTIONS = frozenset({
    "sum", "prod", "max", "min", "mean", "all", "any", "amax", "amin",
})

_FLOATS = ("bfloat16", "float16", "float32", "float64")
_INTS = ("uint8", "int8", "int16", "int32", "int64")


def _root_name(node: ast.expr) -> Optional[str]:
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def is_module(node: ast.expr) -> bool:
    """Does ``node`` name a module (``torch``, ``torch.nn.functional``,
    ``np``) rather than a value whose attributes are methods?"""
    while isinstance(node, ast.Attribute):
        node = node.value
    return isinstance(node, ast.Name) and node.id in _MODULE_ROOTS


def dtype_of_node(node: ast.expr) -> Optional[str]:
    """The dtype a ``torch.float32`` / ``torch.long`` / ``np.int8`` /
    ``"float32"`` style reference names, else None."""
    if isinstance(node, ast.Attribute):
        if node.attr in _DTYPE_NAMES:
            return "bool" if node.attr == "bool_" else node.attr
        root = _root_name(node.value)
        if root == "torch":
            return _TORCH_ALIASES.get(node.attr)
        if root in ("np", "numpy"):
            return _NUMPY_ALIASES.get(node.attr)
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        if node.value in ("bool", "bool_"):
            return "bool"
        return node.value if node.value in _DTYPE_NAMES else None
    return None


def _category(dtype: str) -> Optional[int]:
    if dtype == "bool":
        return 0
    if dtype in _INTS:
        return 1
    if dtype in _FLOATS:
        return 2
    return None  # float8, unsigned wider than 8 bits: torch will not mix


def promote_types(a: str, b: str) -> Optional[str]:
    """``torch.promote_types`` over the dtypes this module names; None
    where torch refuses or the pair is not modelled."""
    if a == b:
        return a if _category(a) is not None else None
    ca, cb = _category(a), _category(b)
    if ca is None or cb is None:
        return None
    if ca != cb:
        return a if ca > cb else b
    if ca == 2:
        if {a, b} == {"float16", "bfloat16"}:
            return "float32"
        return max(a, b, key=_FLOATS.index)
    if "uint8" in (a, b):
        other = b if a == "uint8" else a
        return "int16" if other == "int8" else other
    return max(a, b, key=_INTS.index)


def _combine(dimensioned: str, zero_dim: str) -> Optional[str]:
    """The result of a dimensioned operand of ``dimensioned`` with a 0-dim
    one of ``zero_dim``: the 0-dim operand decides only from a higher
    category (torch's ``combine_categories``)."""
    if _category(dimensioned) is None or _category(zero_dim) is None:
        return None
    if _category(dimensioned) == 2:
        return dimensioned
    if dimensioned == "bool" or _category(zero_dim) == 2:
        return promote_types(dimensioned, zero_dim)
    return dimensioned


def promote(a: Optional[str], b: Optional[str],
            a_shape: Optional[Dims] = None,
            b_shape: Optional[Dims] = None) -> Optional[str]:
    """The dtype of a binary op's result under torch's promotion, given
    the operands' dtypes and shapes (``None`` shape: rank unknown).  A
    ``None`` dtype is a weak scalar and takes the other side's.  Where the
    result depends on a rank that is unknown, None (stay silent)."""
    if a is None:
        return b
    if b is None or a == b:
        return a
    ranks_a = (False, True) if a_shape is None else (len(a_shape) > 0,)
    ranks_b = (False, True) if b_shape is None else (len(b_shape) > 0,)
    options = set()
    for ra in ranks_a:
        for rb in ranks_b:
            if ra == rb:
                options.add(promote_types(a, b))
            elif ra:
                options.add(_combine(a, b))
            else:
                options.add(_combine(b, a))
    return options.pop() if len(options) == 1 else None


def broadcast(a: Optional[Dims], b: Optional[Dims]) -> Optional[Dims]:
    if a is None or b is None:
        return None
    if len(a) < len(b):
        a, b = b, a
    pad: Dims = (1,) * (len(a) - len(b)) + tuple(b)
    out = []
    for da, db in zip(a, pad):
        if da == 1:
            out.append(db)
        elif db == 1 or db == da or db is None:
            out.append(da)
        elif da is None:
            out.append(db)
        else:
            return None  # statically incompatible; stay silent here
    return tuple(out)


class Events:
    """What the walk observed, for the dtype/shape rules to judge."""

    def __init__(self) -> None:
        #: (lineno, to_dtype) for every explicit cast/typed constructor
        self.casts: List[Tuple[int, str]] = []
        #: (lineno, dtype_a, dtype_b) for every mixed-precision binop
        self.promotions: List[Tuple[int, str, str]] = []


FactLike = Union[Fact, Sym, Tuple["FactLike", ...]]

#: name -> summary(arg_values) for the engine functions the ranked bodies
#: call.  An integer argument arrives as a :class:`Sym` (a bare name the
#: interpreter cannot bind stands for a symbol of its own name, as a dim
#: would)
SEMANTICS: Dict[str, Callable[[List[FactLike]], FactLike]] = {}


def _sem(name):
    def deco(fn):
        SEMANTICS[name] = fn
        return fn
    return deco


def _arg(args: List[FactLike], i: int) -> FactLike:
    return args[i] if len(args) > i else UNKNOWN


def _vectors(features: FactLike) -> Tuple[Fact, Fact]:
    """A propagation's ``[..., n_pad]`` float32 vector from its
    ``[..., n_pad, C]`` features (the lane dims carried through), and its
    ``n_bad``: a 0-dim count whose dtype is the model's."""
    shape = (tuple(features.shape[:-1]) if isinstance(features, Fact)
             and features.shape else None)
    return Fact(shape, "float32"), Fact((), None)


def _propagation(features: FactLike) -> FactLike:
    vec, n_bad = _vectors(features)
    return (vec, vec, vec, vec, vec, n_bad)


@_sem("propagate_auto")
def _sem_propagate_auto(args: List[FactLike]) -> FactLike:
    # propagate_auto(model, features, dep_dst, n_live, plan, ...)
    return _propagation(_arg(args, 1))


@_sem("model")
@_sem("propagate")
def _sem_model(args: List[FactLike]) -> FactLike:
    # model(features, dep_dst, n_live, plan, ...) -> (a, h, u, m, score,
    # n_bad); propagate(features, dep_dst, anomaly_w, hard_w, ...) alike
    return _propagation(_arg(args, 0))


@_sem("propagate_core")
@_sem("ell_core")
def _sem_core(args: List[FactLike]) -> FactLike:
    # core(a, h, ...) -> (a, h, u, m, score), each like a
    a = _arg(args, 0)
    vec = Fact(a.shape if isinstance(a, Fact) else None, "float32")
    return (vec, vec, vec, vec, vec)


@_sem("finite_mask_rows")
def _sem_finite_mask(args: List[FactLike]) -> FactLike:
    src = _arg(args, 0)
    return (src if isinstance(src, Fact) else UNKNOWN, Fact((), "int32"))


def _k_of(value: FactLike):
    return value.dim if isinstance(value, Sym) else None


@_sem("top_k")
def _sem_top_k(args: List[FactLike]) -> FactLike:
    score, k = _arg(args, 0), _k_of(_arg(args, 1))
    if isinstance(score, Fact) and score.shape and k is not None:
        lead = tuple(score.shape[:-1])
        return (Fact(lead + (k,), score.dtype), Fact(lead + (k,), "int64"))
    return (UNKNOWN, UNKNOWN)


@_sem("topk_diag")
def _sem_topk_diag(args: List[FactLike]) -> FactLike:
    stacked, idx = _arg(args, 0), _arg(args, 1)
    if (isinstance(stacked, Fact) and stacked.shape
            and isinstance(idx, Fact) and idx.shape):
        return Fact(tuple(stacked.shape[:-1]) + (idx.shape[-1],),
                    stacked.dtype)
    return UNKNOWN


@_sem("propagate_ranked")
def _sem_propagate_ranked(args: List[FactLike]) -> FactLike:
    # propagate_ranked(model, features, dep_dst, n_live, kk, plan, ...)
    features, k = _arg(args, 1), _k_of(_arg(args, 4))
    if not (isinstance(features, Fact) and features.shape
            and len(features.shape) >= 2):
        return (UNKNOWN,) * 5
    lead, n = tuple(features.shape[:-2]), features.shape[-2]
    _vec, n_bad = _vectors(features)
    return (Fact(lead + (4, n), "float32"), Fact(lead + (4, k), "float32"),
            Fact(lead + (k,), "float32"), Fact(lead + (k,), "int64"),
            n_bad)


def is_seq(value: FactLike) -> bool:
    """A tuple of values (a returned tuple, a shape), not one Fact or Sym
    (which are named tuples themselves)."""
    return isinstance(value, tuple) and not isinstance(value, (Fact, Sym))


def _neg_one(node: ast.expr) -> bool:
    return (isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub)
            and isinstance(node.operand, ast.Constant)
            and node.operand.value == 1)


def _number(node: Optional[ast.expr]) -> Optional[str]:
    """``"int"`` / ``"float"`` when ``node`` is a Python number literal."""
    if isinstance(node, ast.UnaryOp) and isinstance(node.op,
                                                    (ast.USub, ast.UAdd)):
        node = node.operand
    if isinstance(node, ast.Constant) and not isinstance(node.value, bool):
        if isinstance(node.value, int):
            return "int"
        if isinstance(node.value, float):
            return "float"
    return None


def _wrapped(number: str, dtype: Optional[str]) -> Optional[str]:
    """A tensor of ``dtype`` with a Python number: the number decides only
    from a higher category (a float with an integer or bool tensor gives
    the default float32, an int with a bool tensor int64)."""
    if dtype is None:
        return None
    if number == "float":
        return dtype if _category(dtype) == 2 else "float32"
    return "int64" if dtype == "bool" else dtype


class Interpreter(ast.NodeVisitor):
    """One forward pass over a function body with an initial symbolic
    environment; collects per-name facts, cast/promotion events, and the
    facts of every ``return`` expression."""

    def __init__(self, env: Optional[Dict[str, FactLike]] = None):
        self.env: Dict[str, FactLike] = dict(env or {})
        self.events = Events()
        self.returns: List[FactLike] = []
        self._local_defs: Dict[str, ast.FunctionDef] = {}

    # -- driving ------------------------------------------------------------

    def run(self, fn: ast.FunctionDef) -> None:
        for stmt in fn.body:
            self._stmt(stmt)

    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.FunctionDef):
            self._local_defs[stmt.name] = stmt
            return
        if isinstance(stmt, ast.Assign):
            fact = self.eval(stmt.value)
            for target in stmt.targets:
                self._bind(target, fact)
        elif isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._bind(stmt.target, self.eval(stmt.value))
        elif isinstance(stmt, ast.AugAssign):
            left = self.eval(stmt.target)
            fact = self._binop(left, self.eval(stmt.value), stmt.lineno,
                               stmt.op, stmt.target, stmt.value)
            self._bind(stmt.target, fact)
        elif isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self.returns.append(self.eval(stmt.value))
        elif isinstance(stmt, (ast.If, ast.For, ast.While, ast.With)):
            self.eval(getattr(stmt, "test", None)
                      or getattr(stmt, "iter", None) or ast.Constant(0))
            for s in stmt.body + getattr(stmt, "orelse", []):
                self._stmt(s)
        elif isinstance(stmt, ast.Try):
            for s in (stmt.body + [x for h in stmt.handlers for x in h.body]
                      + stmt.orelse + stmt.finalbody):
                self._stmt(s)
        elif isinstance(stmt, ast.Expr):
            self.eval(stmt.value)
        # everything else (imports, asserts, raises): no fact flow

    def _bind(self, target: ast.expr, fact: FactLike) -> None:
        if isinstance(target, ast.Name):
            self.env[target.id] = fact
        elif isinstance(target, (ast.Tuple, ast.List)):
            if is_seq(fact) and len(fact) == len(target.elts):
                for t, f in zip(target.elts, fact):
                    self._bind(t, f)
            else:
                for t in target.elts:
                    self._bind(t, UNKNOWN)

    # -- expressions --------------------------------------------------------

    def eval(self, node: Optional[ast.expr]) -> FactLike:
        if node is None:
            return UNKNOWN
        if isinstance(node, ast.Name):
            return self.env.get(node.id, UNKNOWN)
        if isinstance(node, ast.Constant):
            if isinstance(node.value, bool):
                return Fact((), "bool")
            if isinstance(node.value, (int, float)):
                return Fact((), None)  # a Python number: see _binop
            return UNKNOWN
        if isinstance(node, (ast.Tuple, ast.List)):
            return tuple(self.eval(e) for e in node.elts)
        if isinstance(node, ast.BinOp):
            return self._binop(self.eval(node.left), self.eval(node.right),
                               node.lineno, node.op, node.left, node.right)
        if isinstance(node, ast.UnaryOp):
            value = self.eval(node.operand)
            if isinstance(node.op, ast.Not):
                return UNKNOWN  # Python truthiness
            return value
        if isinstance(node, ast.Compare):
            left = self.eval(node.left)
            shape = left.shape if isinstance(left, Fact) else None
            for c in node.comparators:
                right = self.eval(c)
                shape = (broadcast(shape, right.shape)
                         if isinstance(right, Fact) else None)
            return Fact(shape, "bool")
        if isinstance(node, ast.IfExp):
            self.eval(node.test)
            a, b = self.eval(node.body), self.eval(node.orelse)
            return a if a != UNKNOWN else b
        if isinstance(node, ast.Call):
            return self._call(node)
        if isinstance(node, ast.Subscript):
            return self._subscript(node)
        if isinstance(node, ast.Attribute):
            if node.attr == "shape":
                base = self.eval(node.value)
                if isinstance(base, Fact) and base.shape is not None:
                    return tuple(Sym(d) for d in base.shape)
            return UNKNOWN
        return UNKNOWN

    def _binop(self, a: FactLike, b: FactLike, lineno: int,
               op: Optional[ast.operator] = None,
               a_node: Optional[ast.expr] = None,
               b_node: Optional[ast.expr] = None) -> FactLike:
        na = "int" if isinstance(a, Sym) else _number(a_node)
        nb = "int" if isinstance(b, Sym) else _number(b_node)
        if isinstance(a, Sym) or isinstance(b, Sym):
            if na and nb:
                return Sym(None)  # integer arithmetic on a dim
        if na and isinstance(b, Fact) and not nb:
            out = Fact(b.shape, _wrapped(na, b.dtype))
        elif nb and isinstance(a, Fact) and not na:
            out = Fact(a.shape, _wrapped(nb, a.dtype))
        elif isinstance(a, Fact) and isinstance(b, Fact):
            if (a.dtype and b.dtype and a.dtype != b.dtype
                    and (a.dtype in LOW_PRECISION_DTYPES)
                    != (b.dtype in LOW_PRECISION_DTYPES)):
                self.events.promotions.append((lineno, a.dtype, b.dtype))
            out = Fact(broadcast(a.shape, b.shape),
                       promote(a.dtype, b.dtype, a.shape, b.shape))
        else:
            return UNKNOWN
        if isinstance(op, ast.MatMult):
            return Fact(None, out.dtype)
        if (isinstance(op, ast.Div) and out.dtype is not None
                and _category(out.dtype) in (0, 1)):
            # true division of integers gives the default float
            return Fact(out.shape, "float32")
        return out

    def _dim(self, node: ast.expr) -> Optional[Union[int, str]]:
        if isinstance(node, ast.Constant) and isinstance(node.value, int) \
                and not isinstance(node.value, bool):
            return node.value
        if isinstance(node, ast.Name):
            value = self.env.get(node.id)
            if isinstance(value, Sym):
                return value.dim
            # an unbound integer name stands for the symbol of its name
            return node.id if value is None else None
        value = self.eval(node)
        return value.dim if isinstance(value, Sym) else None

    def _dims(self, nodes: List[ast.expr]) -> Optional[Dims]:
        """Dims from a size list: ``(a, b)``, ``a, b`` or ``*x.shape``;
        None when its length is not known."""
        if len(nodes) == 1 and isinstance(nodes[0], (ast.Tuple, ast.List)):
            nodes = list(nodes[0].elts)
        out: List[Optional[Union[int, str]]] = []
        for n in nodes:
            if isinstance(n, ast.Starred):
                value = self.eval(n.value)
                if not is_seq(value):
                    return None
                out.extend(v.dim if isinstance(v, Sym) else None
                           for v in value)
            elif _neg_one(n):
                out.append(-1)
            else:
                value = self.eval(n)
                if is_seq(value) and len(nodes) == 1:
                    return tuple(v.dim if isinstance(v, Sym) else None
                                 for v in value)
                out.append(self._dim(n))
        return tuple(out)

    def _args(self, node: ast.Call) -> List[FactLike]:
        """Positional argument values, a starred tuple spliced in; an
        unbound bare name passes as the symbol of its name."""
        out: List[FactLike] = []
        for a in node.args:
            if isinstance(a, ast.Starred):
                value = self.eval(a.value)
                if is_seq(value):
                    out.extend(value)
                else:
                    out.append(UNKNOWN)
                continue
            value = self.eval(a)
            if value == UNKNOWN and isinstance(a, ast.Name) \
                    and a.id not in self.env:
                value = Sym(a.id)
            out.append(value)
        return out

    def _kw(self, node: ast.Call, name: str) -> Optional[ast.expr]:
        for kw in node.keywords:
            if kw.arg == name:
                return kw.value
        return None

    def _axis(self, node: ast.Call, positional: int) -> Optional[object]:
        """The reduction axis: ``dim=`` / ``axis=`` or a positional int;
        ``"all"`` when none is given."""
        kw = self._kw(node, "dim") or self._kw(node, "axis")
        if kw is None and len(node.args) > positional:
            kw = node.args[positional]
        if kw is None:
            return "all"
        if isinstance(kw, ast.UnaryOp) and isinstance(kw.op, ast.USub) \
                and isinstance(kw.operand, ast.Constant):
            return -kw.operand.value
        if isinstance(kw, ast.Constant) and isinstance(kw.value, int):
            return kw.value
        return None

    def _call(self, node: ast.Call) -> FactLike:
        func = node.func
        recv: Optional[FactLike] = None
        if isinstance(func, ast.Attribute):
            name = func.attr
            if not is_module(func.value):
                recv = self.eval(func.value)
        elif isinstance(func, ast.Name):
            name = func.id
        else:
            return UNKNOWN
        args = self._args(node)

        # an explicit dtype anywhere in the call: a cast event
        to_dtype = None
        kw = self._kw(node, "dtype")
        if kw is not None:
            to_dtype = dtype_of_node(kw)
        for a in node.args:
            d = dtype_of_node(a)
            if d is not None:
                to_dtype = d
        if (recv is not None and name in METHOD_CASTS and not node.args
                and not node.keywords):
            to_dtype = METHOD_CASTS[name]
        if to_dtype is not None:
            self.events.casts.append((node.lineno, to_dtype))
        base = recv if isinstance(recv, Fact) else None
        base_shape = base.shape if base is not None else None

        # casts: x.to(dtype), x.type(dtype), x.half(), x.astype(dtype)
        method = recv is not None
        if method and (name in ("to", "type", "astype")
                       or name in METHOD_CASTS):
            if to_dtype is not None:
                return Fact(base_shape, to_dtype)
            if name != "to" or base is None:
                return UNKNOWN
            other = _arg(args, 0)
            if isinstance(other, Fact) and other.shape is not None:
                return Fact(base_shape, other.dtype)  # x.to(tensor)
            return base  # x.to(device)
        if method and name == "view" and to_dtype is not None:
            same = (base is not None and base.dtype in ITEMSIZE
                    and to_dtype in ITEMSIZE
                    and ITEMSIZE[base.dtype] == ITEMSIZE[to_dtype])
            return Fact(base_shape if same else None, to_dtype)

        if name in SEMANTICS and (recv is None or recv == UNKNOWN):
            return SEMANTICS[name](args)
        if method and base is None:
            return UNKNOWN  # a method of a value the walk cannot see

        # in-place ops return their receiver
        if method and name.endswith("_") and not name.startswith("_"):
            return base
        if method and name in _SAME:
            return base

        if name in ("zeros", "ones", "empty", "full") and recv is None:
            sizes = node.args[:1] if name == "full" else node.args
            dims = self._dims(list(sizes)) if sizes else None
            if to_dtype is None:
                to_dtype = self._default_dtype(func, name, node)
            return Fact(dims, to_dtype)
        if name in ("new_zeros", "new_ones", "new_empty", "new_full") \
                and method:
            sizes = node.args[:1] if name == "new_full" else node.args
            dims = self._dims(list(sizes)) if sizes else None
            return Fact(dims, to_dtype or base.dtype)
        if name == "new_tensor" and method:
            return Fact(None, to_dtype or base.dtype)
        if name in ("zeros_like", "ones_like", "full_like", "empty_like") \
                and recv is None:
            first = _arg(args, 0)
            if isinstance(first, Fact):
                return Fact(first.shape, to_dtype or first.dtype)
            return UNKNOWN
        if name in ("tensor", "as_tensor", "asarray", "array", "from_numpy") \
                and recv is None:
            first = _arg(args, 0)
            shape = first.shape if isinstance(first, Fact) else None
            if to_dtype:
                return Fact(shape, to_dtype)
            return first if isinstance(first, Fact) else UNKNOWN
        if name == "arange" and recv is None:
            return self._arange(node, to_dtype)
        if name == "stack" and recv is None:
            return self._stack(node, args)
        if name in ("sort", "argsort"):
            x = base if method else _arg(args, 0)
            if not isinstance(x, Fact):
                return (UNKNOWN, UNKNOWN) if name == "sort" else UNKNOWN
            if name == "argsort":
                return Fact(x.shape, "int64")
            return (x, Fact(x.shape, "int64"))
        if name == "gather":
            x = base if method else _arg(args, 0)
            index = _arg(args, 1 if method else 2)
            if isinstance(x, Fact) and isinstance(index, Fact):
                return Fact(index.shape, x.dtype)
            return UNKNOWN
        if name in ("expand", "view", "reshape") and method:
            dims = self._dims(list(node.args))
            if dims is None:
                return Fact(None, base.dtype)
            if name == "expand":
                have = base.shape
                out: List[Optional[Union[int, str]]] = []
                for i, d in enumerate(dims):
                    j = i - (len(dims) - len(have)) if have is not None \
                        else -1
                    if d == -1:
                        out.append(have[j] if have is not None and j >= 0
                                   else None)
                    else:
                        out.append(d)
                return Fact(tuple(out), base.dtype)
            return Fact(tuple(None if d == -1 else d for d in dims),
                        base.dtype)
        if name in _PREDICATES:
            facts = [f for f in ([base] if base else []) + args
                     if isinstance(f, Fact)]
            shape = facts[0].shape if facts else None
            for f in facts[1:]:
                shape = broadcast(shape, f.shape)
            return Fact(shape, "bool")
        if name in _ELEMENTWISE:
            facts = ([base] if method else []) + args
            if name == "where" and not method and len(facts) == 3:
                facts = facts[1:]
            facts = [f for f in facts if isinstance(f, Fact)]
            out_f: FactLike = facts[0] if facts else UNKNOWN
            for f in facts[1:]:
                if isinstance(out_f, Fact):
                    out_f = Fact(broadcast(out_f.shape, f.shape),
                                 promote(out_f.dtype, f.dtype,
                                         out_f.shape, f.shape))
            return out_f
        if name in _REDUCTIONS and (method or isinstance(func,
                                                        ast.Attribute)):
            return self._reduce(node, name, base, args, to_dtype)
        if name in ("argmax", "argmin"):
            x = base if method else _arg(args, 0)
            axis = self._axis(node, 0 if method else 1)
            return Fact(self._reduced(x, axis, node), "int64") \
                if isinstance(x, Fact) else Fact(None, "int64")
        if name in self._local_defs and not method:
            return self._interp_local(self._local_defs[name], args)
        return UNKNOWN

    def _default_dtype(self, func: ast.expr, name: str,
                       node: ast.Call) -> Optional[str]:
        """The dtype a constructor gives with no ``dtype=``: torch's default
        float (float32) or numpy's float64; ``full`` from its fill."""
        root = _root_name(func)
        if root not in ("torch", "np", "numpy"):
            return None
        floats = "float32" if root == "torch" else "float64"
        if name != "full":
            return floats
        fill = node.args[1] if len(node.args) > 1 else self._kw(
            node, "fill_value")
        kind = _number(fill)
        if isinstance(fill, ast.Constant) and isinstance(fill.value, bool):
            return "bool"
        return {"int": "int64", "float": floats}.get(kind)

    def _arange(self, node: ast.Call, to_dtype: Optional[str]) -> Fact:
        length = self._dim(node.args[0]) if len(node.args) == 1 else None
        if to_dtype is None:
            kinds = {("int" if isinstance(self.eval(n), Sym) else _number(n))
                     for n in node.args}
            if kinds == {"int"}:
                to_dtype = "int64"
            elif "float" in kinds:
                to_dtype = "float32" if _root_name(node.func) == "torch" \
                    else "float64"
        return Fact((length,), to_dtype)

    def _stack(self, node: ast.Call, args: List[FactLike]):
        seq = _arg(args, 0)
        if not is_seq(seq) or not seq:
            return UNKNOWN
        elems = [f for f in seq if isinstance(f, Fact)]
        if len(elems) != len(seq):
            return UNKNOWN
        axis = self._axis(node, 1)
        axis = 0 if axis == "all" else axis
        shape = elems[0].shape
        dtype = elems[0].dtype
        for f in elems[1:]:
            shape = shape if shape == f.shape else None
            dtype = promote(dtype, f.dtype, elems[0].shape, f.shape)
        if shape is None or not isinstance(axis, int):
            return Fact(None, dtype)
        pos = axis if axis >= 0 else len(shape) + 1 + axis
        if not 0 <= pos <= len(shape):
            return Fact(None, dtype)
        return Fact(tuple(shape[:pos]) + (len(elems),) + tuple(shape[pos:]),
                    dtype)

    def _reduced(self, x: Fact, axis, node: ast.Call) -> Optional[Dims]:
        if x.shape is None or axis is None:
            return None
        if axis == "all":
            return ()
        if not -len(x.shape) <= axis < len(x.shape):
            return None
        shape = list(x.shape)
        keep = self._kw(node, "keepdim") or self._kw(node, "keepdims")
        if isinstance(keep, ast.Constant) and keep.value is True:
            shape[axis] = 1
        else:
            del shape[axis]
        return tuple(shape)

    def _reduce(self, node: ast.Call, name: str, base: Optional[Fact],
                args: List[FactLike], to_dtype: Optional[str]) -> FactLike:
        x = base if base is not None else _arg(args, 0)
        positional = 0 if base is not None else 1
        if name in ("max", "min") and len(node.args) > positional \
                and isinstance(_arg(args, positional), Fact) \
                and _number(node.args[positional]) is None:
            # torch.max(a, b): elementwise
            other = _arg(args, positional)
            if isinstance(x, Fact):
                return Fact(broadcast(x.shape, other.shape),
                            promote(x.dtype, other.dtype, x.shape,
                                    other.shape))
            return UNKNOWN
        if not isinstance(x, Fact):
            return UNKNOWN
        axis = self._axis(node, positional)
        shape = self._reduced(x, axis, node)
        if name in ("all", "any"):
            dtype = "bool"
        elif to_dtype is not None:
            dtype = to_dtype
        elif name in ("sum", "prod") and x.dtype is not None \
                and _category(x.dtype) in (0, 1):
            dtype = "int64"
        else:
            dtype = x.dtype
        if name in ("max", "min") and axis != "all":
            # torch's max/min over a dim: (values, indices)
            return (Fact(shape, dtype), Fact(shape, "int64"))
        return Fact(shape, dtype)

    def _interp_local(self, fn: ast.FunctionDef,
                      args: List[FactLike]) -> FactLike:
        params = [a.arg for a in fn.args.args]
        env = dict(self.env)
        env.update(dict(zip(params, args)))
        sub = Interpreter(env)
        sub._local_defs = dict(self._local_defs)
        sub.run(fn)
        self.events.casts += sub.events.casts
        self.events.promotions += sub.events.promotions
        return sub.returns[-1] if sub.returns else UNKNOWN

    def _subscript(self, node: ast.Subscript) -> FactLike:
        base = self.eval(node.value)
        sl = node.slice
        if is_seq(base):
            if isinstance(sl, ast.Constant) and isinstance(sl.value, int):
                if -len(base) <= sl.value < len(base):
                    return base[sl.value]
                return UNKNOWN
            if isinstance(sl, ast.UnaryOp) and isinstance(sl.op, ast.USub) \
                    and isinstance(sl.operand, ast.Constant):
                i = -sl.operand.value
                return base[i] if -len(base) <= i else UNKNOWN
            if isinstance(sl, ast.Slice) and sl.step is None:
                lo = sl.lower.value if isinstance(sl.lower, ast.Constant) \
                    else None
                hi = sl.upper.value if isinstance(sl.upper, ast.Constant) \
                    else None
                if (sl.lower is None or lo is not None) and (
                        sl.upper is None or hi is not None):
                    return base[lo:hi]
            return UNKNOWN
        if not isinstance(base, Fact) or base.shape is None:
            return UNKNOWN
        items = list(sl.elts) if isinstance(sl, ast.Tuple) else [sl]
        return self._index(base, items)

    def _index(self, base: Fact, items: List[ast.expr]) -> FactLike:
        """Basic and single advanced indexing: ``...``, ``None``, full
        slices and ``[:k]``, ints, and ONE tensor index (its dims replace
        the dim it indexes); anything else keeps the dtype only."""
        shape = list(base.shape)
        n_real = sum(1 for it in items
                     if not (isinstance(it, ast.Constant)
                             and (it.value is None or it.value is Ellipsis)))
        out: List[Optional[Union[int, str]]] = []
        pos = 0
        advanced = 0
        for it in items:
            if isinstance(it, ast.Constant) and it.value is Ellipsis:
                keep = len(shape) - n_real
                if keep < 0:
                    return Fact(None, base.dtype)
                out.extend(shape[pos:pos + keep])
                pos += keep
                continue
            if isinstance(it, ast.Constant) and it.value is None:
                out.append(1)
                continue
            if pos >= len(shape):
                return Fact(None, base.dtype)
            if isinstance(it, ast.Slice):
                if it.step is not None or it.lower is not None:
                    out.append(None)
                elif it.upper is None:
                    out.append(shape[pos])
                else:
                    out.append(self._dim(it.upper))
                pos += 1
                continue
            value = self.eval(it)
            if isinstance(value, Sym) or (
                    isinstance(it, ast.Constant)
                    and isinstance(it.value, int)) or (
                    isinstance(it, ast.UnaryOp)
                    and isinstance(it.operand, ast.Constant)):
                pos += 1  # an integer index drops its dim
                continue
            if isinstance(value, Fact) and value.shape is not None \
                    and value.dtype != "bool" and advanced == 0:
                advanced += 1
                out.extend(value.shape)
                pos += 1
                continue
            return Fact(None, base.dtype)
        out.extend(shape[pos:])
        return Fact(tuple(out), base.dtype)


def interpret_function(fn: ast.FunctionDef,
                       inputs: Dict[str, FactLike]) -> Interpreter:
    """Seed the interpreter with ``inputs`` (missing params stay UNKNOWN)
    and run the body; returns the interpreter with env/events/returns."""
    interp = Interpreter(dict(inputs))
    interp.run(fn)
    return interp


def dims_conform(actual, declared) -> bool:
    """Declared dim vs interpreted dim: ints must match, symbols must
    match by name, None (unknown) conforms to anything."""
    if actual is None or declared is None:
        return True
    return actual == declared


def fact_conforms(actual: FactLike, declared) -> Optional[str]:
    """None when ``actual`` (a Fact) proves or is compatible with the
    declared Role; else a human-readable mismatch description."""
    if not isinstance(actual, Fact):
        return None  # tuple-vs-role confusion: stay silent
    if actual.shape is not None:
        if len(actual.shape) != len(declared.shape):
            return (f"rank {len(actual.shape)} != declared "
                    f"{len(declared.shape)} for `{declared.name}`")
        for a, d in zip(actual.shape, declared.shape):
            if not dims_conform(a, d):
                return (f"dim {a!r} != declared {d!r} for "
                        f"`{declared.name}`")
    if actual.dtype is not None and actual.dtype != declared.dtype:
        return (f"dtype {actual.dtype} != declared {declared.dtype} "
                f"for `{declared.name}`")
    return None
