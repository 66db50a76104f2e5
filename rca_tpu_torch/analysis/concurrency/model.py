"""The whole-package static concurrency model gravelock analyzes (the
port's copy of ``rca_tpu.analysis.concurrency.model``, over the port).

One :class:`ConcurrencyModel` per lint run (cached by file mtimes)
indexes every ``rca_tpu_torch/`` module under the linted root — pure AST,
no imports executed — and computes:

- **thread roots** (:attr:`ConcurrencyModel.roots`): every
  ``threading.Thread(target=...)`` / ``util.threads.spawn`` /
  ``make_thread`` call site, every in-package ``threading.Thread``
  subclass (its ``run`` is the root), and executor-style ``.submit(fn)``
  hand-offs.  A root spawned inside a loop or comprehension is marked
  **multi-instance**: two copies of the same entry point are as
  concurrent as two different ones.  The implicit ``main`` root covers
  every chain that starts outside spawned code;
- a **call graph** with best-effort receiver typing (self-attribute
  types from ``__init__`` assignments and parameter annotations, local
  constructor bindings, imported module functions), over which the
  traversal (:meth:`ConcurrencyModel.traverse`) propagates, per
  (root, receiver-context) pair, the set of locks **held on every path**
  to each function — the interprocedural half of both analyses;
- per-class **write sites** of ``self.<attr>`` (plain assign, augmented
  read-modify-write, mutating container calls) with the locks held
  locally at each site, feeding guarded-by inference (:mod:`races`);
- **nested-acquire events** feeding the lock-order graph
  (:mod:`lockorder`).

Receiver contexts are how the model distinguishes *instances* without a
points-to analysis: a chain that reaches ``PhaseStats.record`` through
``ServeMetrics._queue_ms`` and one that reaches it through a streaming
session's own accumulator touch DIFFERENT objects, so their write
observations never pair; chains that converge on the same
``Owner.attr`` hop (or on the spawning object itself) do.  Locks carry
the same ``"Class.attr"`` identities :mod:`rca_tpu_torch.util.threads`
stamps at construction, so the rsan cross-check compares like with like.
Only the port's own package is indexed, and only its own imports
resolve: a root that holds the JAX package beside it (this repository
does) never mixes the two, and an ``import rca_tpu.x`` resolves to
nothing.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

#: constructors whose result counts as a lock (raw + the util.threads seam)
LOCK_FACTORIES = {
    "Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore",
    "make_lock", "make_rlock", "make_condition",
}
#: thread constructors (raw + seam); subclassing threading.Thread also roots
THREAD_FACTORIES = {"Thread", "make_thread", "spawn"}

#: constructor-family methods whose writes are pre-sharing by definition
INIT_METHODS = {"__init__", "__post_init__", "__new__"}

MUTATING_METHODS = {
    "append", "appendleft", "extend", "insert", "add", "update",
    "setdefault", "pop", "popleft", "popitem", "remove", "discard",
    "clear", "sort", "reverse", "move_to_end",
}

#: traversal bounds: states are (context, lockset) pairs per (func, root);
#: past the cap further states are dropped (loses observations — safe in
#: the false-negative direction, never invents a finding)
MAX_STATES_PER_FUNC = 24

MAIN_ROOT = "main"

#: the package the model indexes (a directory under the root) and the
#: dotted prefix its in-package imports carry
PACKAGE = "rca_tpu_torch"


# ---------------------------------------------------------------------------
# index records
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CallSite:
    callee: str                   # resolved function qual
    kind: str                     # self | attr | local | unknown | plain
    owner: str = ""               # attr hop: class owning the attribute
    attr: str = ""                # attr hop: attribute name
    locks: Tuple[Tuple[str, Tuple[str, int]], ...] = ()  # held at site
    lineno: int = 0


@dataclasses.dataclass
class WriteSite:
    cls: str
    attr: str
    kind: str                     # assign | augassign | mutcall
    locks: Tuple[Tuple[str, Tuple[str, int]], ...] = ()
    lineno: int = 0
    func: str = ""                # enclosing function qual


@dataclasses.dataclass
class AcquireSite:
    lock: str
    outer: Tuple[Tuple[str, Tuple[str, int]], ...]  # held when entering
    lineno: int = 0
    func: str = ""


@dataclasses.dataclass
class SpawnSite:
    target: str                   # resolved root function qual ("" = unknown)
    name_hint: str
    multi: bool
    lineno: int = 0
    func: str = ""                # where the spawn happens


@dataclasses.dataclass
class FuncInfo:
    qual: str                     # "<relpath>::Cls.meth" / "<relpath>::fn"
    relpath: str
    cls: str                      # "" for plain functions
    name: str
    lineno: int
    calls: List[CallSite] = dataclasses.field(default_factory=list)
    writes: List[WriteSite] = dataclasses.field(default_factory=list)
    acquires: List[AcquireSite] = dataclasses.field(default_factory=list)
    spawns: List[SpawnSite] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ClassInfo:
    name: str
    relpath: str
    lineno: int
    bases: List[str]
    lock_attrs: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: self.<attr> -> candidate class names (best-effort typing)
    attr_types: Dict[str, Set[str]] = dataclasses.field(default_factory=dict)
    methods: Dict[str, str] = dataclasses.field(default_factory=dict)

    def is_thread(self, classes: Dict[str, "ClassInfo"]) -> bool:
        seen: Set[str] = set()
        stack = list(self.bases)
        while stack:
            b = stack.pop()
            if b in seen:
                continue
            seen.add(b)
            if b == "Thread":
                return True
            info = classes.get(b)
            if info is not None:
                stack.extend(info.bases)
        return False


@dataclasses.dataclass(frozen=True)
class Context:
    """Receiver identity approximation for one call chain.

    kind ``inst``: the receiver was reached as ``<owner>.<attr>`` — two
    chains through the same hop touch the same object.  ``root``: the
    receiver hosts a spawned entry point; it pairs with ANY chain whose
    receiver class matches (``inst`` hops and external ``ext`` entries
    alike) — you start the worker on the same object you keep calling.
    ``local``/``ext`` against anything else: never pairs (distinct or
    unknowable instances).  ``-``: no receiver (plain function)."""

    kind: str
    detail: str
    recv_class: str

    def pairs_with(self, other: "Context") -> bool:
        for a, b in ((self, other), (other, self)):
            if a.kind == "inst" and b.kind == "inst":
                return a.detail == b.detail
            if a.kind == "root" and b.kind in ("inst", "root", "ext"):
                return a.recv_class == b.recv_class \
                    and bool(a.recv_class)
        return False


NO_CTX = Context("-", "", "")


@dataclasses.dataclass(frozen=True)
class RootInfo:
    root_id: str                  # display name ("main", "rca-serve", ...)
    entry: str                    # function qual ("" for main)
    multi: bool                   # >1 concurrent instances of this entry


@dataclasses.dataclass
class Observation:
    """One write site as seen from one traversal chain."""

    site: WriteSite
    root: RootInfo
    ctx: Context
    locks: FrozenSet[str]


@dataclasses.dataclass
class OrderEdge:
    outer: str
    inner: str
    root: str
    outer_site: Tuple[str, int]   # (func qual, line) where outer acquired
    inner_site: Tuple[str, int]


# ---------------------------------------------------------------------------
# per-file extraction
# ---------------------------------------------------------------------------


def _dotted(relpath: str) -> str:
    p = relpath[:-3] if relpath.endswith(".py") else relpath
    parts = p.split("/")
    if parts and parts[0] == PACKAGE:
        parts = parts[1:]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts) or PACKAGE


def _const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _call_factory_name(call: ast.Call) -> Optional[str]:
    """The bare factory name of a constructor call (``threading.Lock`` ->
    ``Lock``, ``make_lock`` -> ``make_lock``), or None."""
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def _ann_names(ann: Optional[ast.AST]) -> Set[str]:
    """Class names referenced by an annotation (handles Optional[...],
    string annotations, unions)."""
    out: Set[str] = set()
    if ann is None:
        return out
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return out
    for node in ast.walk(ann):
        if isinstance(node, ast.Name):
            out.add(node.id)
        elif isinstance(node, ast.Attribute):
            out.add(node.attr)
    out -= {"Optional", "Union", "List", "Dict", "Tuple", "Sequence",
            "Callable", "Any", "None", "Set", "FrozenSet", "Iterable",
            "Type", "str", "int", "float", "bool", "bytes", "object"}
    return out


class _FileIndexer(ast.NodeVisitor):
    """Extract classes/functions of one module (structure pass)."""

    def __init__(self, relpath: str, tree: ast.AST):
        self.relpath = relpath
        self.tree = tree
        self.classes: Dict[str, ClassInfo] = {}
        self.functions: Dict[str, FuncInfo] = {}
        #: imported name -> source module dotted path (package-internal)
        self.imports: Dict[str, str] = {}
        #: module-level lock names -> lock id
        self.module_locks: Dict[str, str] = {}
        self._collect()

    def _collect(self) -> None:
        for node in self.tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                self._collect_import(node)
            elif isinstance(node, ast.Assign):
                self._collect_module_lock(node)
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                self._collect_import(node)

    def _collect_import(self, node: ast.AST) -> None:
        if isinstance(node, ast.Import):
            for alias in node.names:
                name = alias.asname or alias.name.split(".")[0]
                self.imports[name] = alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                self.imports[alias.asname or alias.name] = (
                    f"{node.module}.{alias.name}"
                )

    def _collect_module_lock(self, node: ast.Assign) -> None:
        if not isinstance(node.value, ast.Call):
            return
        fac = _call_factory_name(node.value)
        if fac not in LOCK_FACTORIES:
            return
        for t in node.targets:
            if isinstance(t, ast.Name):
                explicit = (
                    _const_str(node.value.args[0]) if node.value.args
                    else None
                )
                self.module_locks[t.id] = (
                    explicit or f"{_dotted(self.relpath)}.{t.id}"
                )


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


class ConcurrencyModel:
    def __init__(self, root: str, files: Sequence[Tuple[str, ast.AST]]):
        self.root = root
        self.indexers: Dict[str, _FileIndexer] = {
            rel: _FileIndexer(rel, tree) for rel, tree in files
        }
        #: bare class name -> ClassInfo (package-unique in practice)
        self.classes: Dict[str, ClassInfo] = {}
        self.functions: Dict[str, FuncInfo] = {}
        #: dotted module -> {func name -> qual}
        self.module_funcs: Dict[str, Dict[str, str]] = {}
        self.roots: List[RootInfo] = []
        self.observations: Dict[Tuple[str, str], List[Observation]] = {}
        self.order_edges: List[OrderEdge] = []
        self.class_attr_writes: List[WriteSite] = []
        self.functions_traversed = 0
        self._build_structure()
        self._build_bodies()
        self._discover_roots()
        self.traverse()

    # -- structure: classes, methods, typing --------------------------------
    def _build_structure(self) -> None:
        for rel, idx in self.indexers.items():
            dotted = _dotted(rel)
            self.module_funcs.setdefault(dotted, {})
            for node in idx.tree.body:
                if isinstance(node, ast.ClassDef):
                    self._index_class(rel, idx, node)
                elif isinstance(node, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    qual = f"{rel}::{node.name}"
                    self.functions[qual] = FuncInfo(
                        qual=qual, relpath=rel, cls="", name=node.name,
                        lineno=node.lineno,
                    )
                    self.module_funcs[dotted][node.name] = qual

    def _index_class(self, rel: str, idx: _FileIndexer,
                     node: ast.ClassDef) -> None:
        bases = []
        for b in node.bases:
            if isinstance(b, ast.Name):
                bases.append(b.id)
            elif isinstance(b, ast.Attribute):
                bases.append(b.attr)
        info = ClassInfo(name=node.name, relpath=rel, lineno=node.lineno,
                         bases=bases)
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{rel}::{node.name}.{item.name}"
                info.methods[item.name] = qual
                self.functions[qual] = FuncInfo(
                    qual=qual, relpath=rel, cls=node.name, name=item.name,
                    lineno=item.lineno,
                )
                self._harvest_types(info, item)
            elif isinstance(item, ast.AnnAssign) and isinstance(
                    item.target, ast.Name):
                # dataclass-style field annotation
                for t in _ann_names(item.annotation):
                    info.attr_types.setdefault(item.target.id, set()).add(t)
        self.classes.setdefault(node.name, info)
        idx.classes[node.name] = info

    def _harvest_types(self, info: ClassInfo,
                       fn: ast.FunctionDef) -> None:
        """Attribute typing + lock-attr discovery from one method."""
        ann_by_param = {
            a.arg: _ann_names(a.annotation) for a in fn.args.args
        }
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            targets = [
                t for t in node.targets
                if isinstance(t, ast.Attribute)
                and isinstance(t.value, ast.Name) and t.value.id == "self"
            ]
            if not targets:
                continue
            # lock attrs: self._x = Lock()/make_lock("...")-family
            calls = [
                n for n in ast.walk(node.value) if isinstance(n, ast.Call)
            ]
            for c in calls:
                fac = _call_factory_name(c)
                if fac in LOCK_FACTORIES:
                    explicit = _const_str(c.args[0]) if c.args else None
                    for t in targets:
                        info.lock_attrs[t.attr] = (
                            explicit or f"{info.name}.{t.attr}"
                        )
                elif fac is not None and fac[0].isupper():
                    for t in targets:
                        info.attr_types.setdefault(t.attr, set()).add(fac)
            # self.x = <param> carries the param's annotation
            if isinstance(node.value, ast.Name) \
                    and node.value.id in ann_by_param:
                for t in targets:
                    info.attr_types.setdefault(t.attr, set()).update(
                        ann_by_param[node.value.id]
                    )
            # self.x = a or B(...): BoolOp branches both contribute (the
            # Call branch was picked up above; a Name branch may be an
            # annotated param too)
            if isinstance(node.value, ast.BoolOp):
                for v in node.value.values:
                    if isinstance(v, ast.Name) and v.id in ann_by_param:
                        for t in targets:
                            info.attr_types.setdefault(t.attr, set()).update(
                                ann_by_param[v.id]
                            )

    # -- bodies: calls, writes, acquires, spawns ----------------------------
    def _build_bodies(self) -> None:
        for rel, idx in self.indexers.items():
            for node in idx.tree.body:
                if isinstance(node, ast.ClassDef):
                    cls = idx.classes.get(node.name)
                    for item in node.body:
                        if isinstance(item, (ast.FunctionDef,
                                             ast.AsyncFunctionDef)):
                            self._scan_function(rel, idx, cls, item,
                                                f"{node.name}.{item.name}")
                elif isinstance(node, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    self._scan_function(rel, idx, None, node, node.name)

    def _lock_id_for_expr(self, idx: _FileIndexer,
                          cls: Optional[ClassInfo],
                          expr: ast.AST) -> Optional[str]:
        """The lock a ``with <expr>:`` enters, if recognizable."""
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id == "self" and cls is not None:
            if expr.attr in cls.lock_attrs:
                return cls.lock_attrs[expr.attr]
            if "lock" in expr.attr.lower() or "cond" in expr.attr.lower():
                return f"{cls.name}.{expr.attr}"
            return None
        if isinstance(expr, ast.Name):
            return idx.module_locks.get(expr.id)
        return None

    def _scan_function(self, rel: str, idx: _FileIndexer,
                       cls: Optional[ClassInfo],
                       fn: ast.FunctionDef, label: str,
                       outer_types: Optional[Dict] = None,
                       outer_hops: Optional[Dict] = None) -> None:
        qual = f"{rel}::{label}"
        fi = self.functions.get(qual)
        if fi is None:   # nested function discovered below gets its own
            fi = self.functions[qual] = FuncInfo(
                qual=qual, relpath=rel, cls=cls.name if cls else "",
                name=fn.name, lineno=fn.lineno,
            )
        # closures inherit the enclosing scope's variable typing (a spawn
        # target like a submitter closure calls through captured locals)
        local_types: Dict[str, Tuple[str, Set[str]]] = dict(
            outer_types or {}
        )
        local_hops: Dict[str, Tuple[str, str]] = dict(outer_hops or {})
        # param annotations type the locals they name
        for a in fn.args.args:
            names = _ann_names(a.annotation)
            if names:
                local_types[a.arg] = ("unknown", names)

        def infer(expr: ast.AST) -> Tuple[str, str, str, Set[str]]:
            """(kind, owner, attr, classes) of a receiver expression."""
            if isinstance(expr, ast.Name):
                if expr.id == "self" and cls is not None:
                    return ("self", "", "", {cls.name})
                if expr.id in local_types:
                    kind, classes = local_types[expr.id]
                    owner, attr = local_hops.get(expr.id, ("", ""))
                    return (kind, owner, attr, classes)
                return ("unknown", "", "", set())
            if isinstance(expr, ast.Attribute):
                base_kind, _o, _a, base_classes = infer(expr.value)
                owners = set()
                types: Set[str] = set()
                for bc in base_classes:
                    binfo = self.classes.get(bc)
                    if binfo is None:
                        continue
                    if expr.attr in binfo.attr_types:
                        owners.add(bc)
                        types |= binfo.attr_types[expr.attr]
                if owners:
                    owner = sorted(owners)[0]
                    return ("attr", owner, expr.attr, types)
                return ("unknown", "", "", set())
            if isinstance(expr, ast.Call):
                fac = _call_factory_name(expr)
                if fac in self.classes:
                    return ("local", "", "", {fac})
                return ("unknown", "", "", set())
            return ("unknown", "", "", set())

        def resolve_callee(call: ast.Call) -> List[Tuple[str, str, str, str]]:
            """[(callee_qual, kind, owner, attr)] for one call node."""
            f = call.func
            out: List[Tuple[str, str, str, str]] = []
            if isinstance(f, ast.Name):
                name = f.id
                nested = f"{rel}::{label}.{name}"
                if nested in self.functions:
                    return [(nested, "self" if cls else "plain", "", "")]
                dotted = _dotted(rel)
                if name in self.module_funcs.get(dotted, {}):
                    return [(self.module_funcs[dotted][name], "plain",
                             "", "")]
                if name in self.classes:
                    init = self.classes[name].methods.get("__init__")
                    if init:
                        out.append((init, "local", "", ""))
                    return out
                src = idx.imports.get(name)
                if src and src.startswith(PACKAGE + "."):
                    mod, _, fname = src.rpartition(".")
                    mod = mod[len(PACKAGE) + 1:]
                    target = self.module_funcs.get(mod, {}).get(fname)
                    if target:
                        return [(target, "plain", "", "")]
                    if fname in self.classes:
                        init = self.classes[fname].methods.get("__init__")
                        if init:
                            return [(init, "local", "", "")]
                return out
            if isinstance(f, ast.Attribute):
                meth = f.attr
                kind, owner, attr, classes = infer(f.value)
                for c in sorted(classes):
                    target = self._lookup_method(c, meth)
                    if target:
                        out.append((target, kind, owner, attr))
                return out
            return out

        def spawn_target(call: ast.Call) -> Tuple[str, str]:
            """(root function qual, name hint) for a thread spawn."""
            target_expr = None
            name_hint = ""
            for kw in call.keywords:
                if kw.arg == "target":
                    target_expr = kw.value
                if kw.arg == "name":
                    name_hint = _const_str(kw.value) or ""
            if target_expr is None and call.args:
                target_expr = call.args[0]
            if target_expr is None:
                return ("", name_hint)
            if isinstance(target_expr, ast.Name):
                nested = f"{rel}::{label}.{target_expr.id}"
                if nested in self.functions:
                    return (nested, name_hint or target_expr.id)
                dotted = _dotted(rel)
                q = self.module_funcs.get(dotted, {}).get(target_expr.id)
                return (q or "", name_hint or target_expr.id)
            if isinstance(target_expr, ast.Attribute):
                kind, _o, _a, classes = infer(target_expr.value)
                for c in sorted(classes):
                    q = self._lookup_method(c, target_expr.attr)
                    if q:
                        return (q, name_hint or target_expr.attr)
            return ("", name_hint)

        # local variable typing pass (simple forward scan)
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                var = node.targets[0].id
                kind, owner, attr, classes = infer(node.value)
                if classes:
                    local_types[var] = (kind, classes)
                    if kind == "attr":
                        local_hops[var] = (owner, attr)
                elif isinstance(node.value, ast.BoolOp):
                    for v in node.value.values:
                        k2, o2, a2, c2 = infer(v)
                        if c2:
                            local_types[var] = (k2, c2)
                            if k2 == "attr":
                                local_hops[var] = (o2, a2)
                            break

        # body walk with a with-lock stack
        multi_depth = 0

        def walk(node: ast.AST, held: List[Tuple[str, Tuple[str, int]]],
                 in_loop: bool) -> None:
            nonlocal multi_depth
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node is not fn:
                # nested defs scanned separately (with their own label),
                # inheriting this scope's typing for captured variables
                self._scan_function(rel, idx, cls, node,
                                    f"{label}.{node.name}",
                                    outer_types=local_types,
                                    outer_hops=local_hops)
                return
            if isinstance(node, ast.With):
                entered: List[Tuple[str, Tuple[str, int]]] = []
                for item in node.items:
                    lid = self._lock_id_for_expr(idx, cls,
                                                 item.context_expr)
                    if lid is not None:
                        fi.acquires.append(AcquireSite(
                            lock=lid, outer=tuple(held),
                            lineno=node.lineno, func=qual,
                        ))
                        entered.append((lid, (qual, node.lineno)))
                for child in node.body:
                    walk(child, held + entered, in_loop)
                return
            loop_here = in_loop or isinstance(
                node, (ast.For, ast.While, ast.ListComp, ast.SetComp,
                       ast.GeneratorExp, ast.DictComp)
            )
            if isinstance(node, ast.Call):
                fac = _call_factory_name(node)
                if fac in THREAD_FACTORIES or (
                    fac in self.classes
                    and self.classes[fac].is_thread(self.classes)
                ):
                    if fac in THREAD_FACTORIES:
                        tgt, hint = spawn_target(node)
                    else:
                        tgt = self._lookup_method(fac, "run") or ""
                        hint = fac
                    if tgt:
                        fi.spawns.append(SpawnSite(
                            target=tgt, name_hint=hint, multi=loop_here,
                            lineno=node.lineno, func=qual,
                        ))
                elif fac == "submit" and node.args:
                    # executor-style hand-off: first arg is callable
                    a0 = node.args[0]
                    ref = ""
                    if isinstance(a0, ast.Name):
                        dotted = _dotted(rel)
                        nested = f"{rel}::{label}.{a0.id}"
                        ref = (nested if nested in self.functions else
                               self.module_funcs.get(dotted, {})
                               .get(a0.id, ""))
                    if ref:
                        fi.spawns.append(SpawnSite(
                            target=ref, name_hint=a0.id, multi=loop_here,
                            lineno=node.lineno, func=qual,
                        ))
                for callee, kind, owner, attr in resolve_callee(node):
                    fi.calls.append(CallSite(
                        callee=callee, kind=kind, owner=owner, attr=attr,
                        locks=tuple(held), lineno=node.lineno,
                    ))
                # mutating container call on self.<attr>
                w = self._mutcall_write(node, cls)
                if w is not None:
                    fi.writes.append(WriteSite(
                        cls=cls.name if cls else "", attr=w,
                        kind="mutcall", locks=tuple(held),
                        lineno=node.lineno, func=qual,
                    ))
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                self._record_assign_writes(node, fi, cls, held, qual)
            for child in ast.iter_child_nodes(node):
                walk(child, held, loop_here)

        for stmt in fn.body:
            walk(stmt, [], False)

    @staticmethod
    def _base_of(target: ast.AST) -> ast.AST:
        base = target
        while isinstance(base, ast.Subscript):
            base = base.value
        return base

    def _record_assign_writes(self, node: ast.AST, fi: FuncInfo,
                              cls: Optional[ClassInfo],
                              held: List[Tuple[str, Tuple[str, int]]],
                              qual: str) -> None:
        kind = "augassign" if isinstance(node, ast.AugAssign) else "assign"
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target])
        for t in targets:
            base = self._base_of(t)
            if not isinstance(base, ast.Attribute):
                continue
            # subscripted plain assigns (self.d[k] = v) mutate the
            # container in place — treat like a mutating call
            wkind = kind
            if base is not t and kind == "assign":
                wkind = "mutcall"
            if isinstance(base.value, ast.Name) and base.value.id == "self" \
                    and cls is not None:
                if base.attr in cls.lock_attrs:
                    continue
                if fi.name in INIT_METHODS:
                    continue
                fi.writes.append(WriteSite(
                    cls=cls.name, attr=base.attr, kind=wkind,
                    locks=tuple(held), lineno=node.lineno, func=qual,
                ))
            elif isinstance(base.value, ast.Name) and cls is not None \
                    and base.value.id == cls.name:
                # ClassName.attr mutated inside a method: class-shared
                # state behind (at best) a per-instance lock
                if wkind in ("augassign", "mutcall"):
                    self.class_attr_writes.append(WriteSite(
                        cls=cls.name, attr=base.attr, kind=wkind,
                        locks=tuple(held), lineno=node.lineno, func=qual,
                    ))

    def _mutcall_write(self, call: ast.Call,
                       cls: Optional[ClassInfo]) -> Optional[str]:
        if cls is None or not isinstance(call.func, ast.Attribute):
            return None
        if call.func.attr not in MUTATING_METHODS:
            return None
        base = self._base_of(call.func.value)
        if isinstance(base, ast.Attribute) \
                and isinstance(base.value, ast.Name) \
                and base.value.id == "self" \
                and base.attr not in cls.lock_attrs:
            return base.attr
        return None

    def _lookup_method(self, cls_name: str, meth: str) -> Optional[str]:
        seen: Set[str] = set()
        stack = [cls_name]
        while stack:
            c = stack.pop(0)
            if c in seen:
                continue
            seen.add(c)
            info = self.classes.get(c)
            if info is None:
                continue
            if meth in info.methods:
                return info.methods[meth]
            stack.extend(info.bases)
        return None

    # -- roots ---------------------------------------------------------------
    def _discover_roots(self) -> None:
        by_entry: Dict[str, RootInfo] = {}
        for fi in self.functions.values():
            for sp in fi.spawns:
                if not sp.target:
                    continue
                prev = by_entry.get(sp.target)
                multi = sp.multi or (prev.multi if prev else False) or (
                    prev is not None  # spawned from 2+ sites = concurrent
                )
                tgt = self.functions.get(sp.target)
                name = sp.name_hint or (tgt.name if tgt else sp.target)
                by_entry[sp.target] = RootInfo(
                    root_id=name, entry=sp.target, multi=multi,
                )
        # Thread subclasses instantiated nowhere statically still root
        # their run(): the class exists to be started
        for cls in self.classes.values():
            if cls.is_thread(self.classes) and "run" in cls.methods:
                entry = cls.methods["run"]
                if entry not in by_entry:
                    by_entry[entry] = RootInfo(
                        root_id=cls.name, entry=entry, multi=True,
                    )
        self.roots = sorted(by_entry.values(), key=lambda r: r.entry)

    # -- traversal -----------------------------------------------------------
    def _spawn_reachable(self) -> Set[str]:
        out: Set[str] = set()
        stack = [r.entry for r in self.roots]
        while stack:
            q = stack.pop()
            if q in out:
                continue
            out.add(q)
            fi = self.functions.get(q)
            if fi is None:
                continue
            for c in fi.calls:
                if c.callee not in out:
                    stack.append(c.callee)
        return out

    def traverse(self) -> None:
        """Propagate (root, context, lockset) triples over the call graph,
        collecting write observations and nested-acquire edges."""
        spawn_reach = self._spawn_reachable()
        main = RootInfo(root_id=MAIN_ROOT, entry="", multi=False)
        seeds: List[Tuple[str, RootInfo, Context,
                          Tuple[Tuple[str, Tuple[str, int]], ...]]] = []
        for r in self.roots:
            fi = self.functions.get(r.entry)
            ctx = (Context("root", "", fi.cls) if fi is not None and fi.cls
                   else NO_CTX)
            seeds.append((r.entry, r, ctx, ()))
        for qual, fi in self.functions.items():
            if qual in spawn_reach:
                continue
            ctx = Context("ext", qual, fi.cls) if fi.cls else NO_CTX
            seeds.append((qual, main, ctx, ()))

        visited: Set[Tuple[str, str, Context, FrozenSet[str]]] = set()
        states_per_func: Dict[Tuple[str, str], int] = {}
        stack = list(seeds)
        touched: Set[str] = set()
        while stack:
            qual, root, ctx, held = stack.pop()
            lockset = frozenset(l for l, _site in held)
            key = (qual, root.root_id, ctx, lockset)
            if key in visited:
                continue
            cap_key = (qual, root.root_id)
            if states_per_func.get(cap_key, 0) >= MAX_STATES_PER_FUNC:
                continue
            states_per_func[cap_key] = states_per_func.get(cap_key, 0) + 1
            visited.add(key)
            touched.add(qual)
            fi = self.functions.get(qual)
            if fi is None:
                continue
            held_map = dict(held)
            # observations: every write in this function, with inherited +
            # local locks
            for w in fi.writes:
                locks = frozenset(held_map) | frozenset(
                    l for l, _s in w.locks
                )
                self.observations.setdefault(
                    (w.cls, w.attr), []
                ).append(Observation(site=w, root=root, ctx=ctx,
                                     locks=locks))
            # lock-order edges: local acquires nest under inherited locks
            # AND under locally-outer with-blocks (recorded in .outer)
            for a in fi.acquires:
                outer_map = dict(held)
                outer_map.update(dict(a.outer))
                for outer_lock, outer_site in outer_map.items():
                    if outer_lock == a.lock:
                        continue
                    self.order_edges.append(OrderEdge(
                        outer=outer_lock, inner=a.lock,
                        root=root.root_id, outer_site=outer_site,
                        inner_site=(qual, a.lineno),
                    ))
            # propagate over calls
            for c in fi.calls:
                callee = self.functions.get(c.callee)
                if callee is None:
                    continue
                new_held = dict(held)
                new_held.update(dict(c.locks))
                if not callee.cls:
                    new_ctx = NO_CTX
                elif c.kind == "self":
                    new_ctx = ctx
                elif c.kind == "attr":
                    new_ctx = Context("inst", f"{c.owner}.{c.attr}",
                                      callee.cls)
                elif c.kind == "local":
                    new_ctx = Context("local", f"{qual}:{c.lineno}",
                                      callee.cls)
                else:
                    new_ctx = Context("ext", f"{qual}:{c.lineno}",
                                      callee.cls)
                stack.append((
                    c.callee, root, new_ctx,
                    tuple(sorted(new_held.items())),
                ))
        self.functions_traversed = len(touched)

    # -- reporting helpers ---------------------------------------------------
    def stats(self) -> Dict[str, object]:
        locks: Set[str] = set()
        for cls in self.classes.values():
            locks.update(cls.lock_attrs.values())
        for idx in self.indexers.values():
            locks.update(idx.module_locks.values())
        edge_keys = {(e.outer, e.inner) for e in self.order_edges}
        return {
            "files": len(self.indexers),
            "functions": len(self.functions),
            "functions_traversed": self.functions_traversed,
            "thread_roots": [r.root_id for r in self.roots],
            "locks": len(locks),
            "lock_graph_nodes": len(
                {l for e in edge_keys for l in e}
            ),
            "lock_graph_edges": len(edge_keys),
        }

    def static_order_edges(self) -> Set[Tuple[str, str]]:
        return {(e.outer, e.inner) for e in self.order_edges}


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

_CACHE: Dict[str, Tuple[Tuple[Tuple[str, int, int], ...],
                        ConcurrencyModel]] = {}


def _package_files(root: str) -> List[str]:
    base = os.path.join(root, PACKAGE)
    out: List[str] = []
    for dirpath, _dirs, files in os.walk(base):
        out += [
            os.path.join(dirpath, f) for f in files if f.endswith(".py")
        ]
    return sorted(out)


def model_for(root: str) -> ConcurrencyModel:
    """The (cached) concurrency model of the ``rca_tpu_torch/`` package under
    ``root``.  Rebuilt whenever any package file's (mtime, size)
    changes — cheap enough that repeated ``run_lint`` calls in one
    process do not re-parse the world."""
    files = _package_files(root)
    key = tuple(
        (f, int(os.stat(f).st_mtime_ns), os.path.getsize(f))
        for f in files
    )
    cached = _CACHE.get(root)
    if cached is not None and cached[0] == key:
        return cached[1]
    from rca_tpu_torch.analysis.core import parse_file

    parsed: List[Tuple[str, ast.AST]] = []
    for f in files:
        rel = os.path.relpath(f, root).replace(os.sep, "/")
        try:
            # shared parse cache: one ast.parse per file per lint run,
            # even though graftlint's runner walks the same trees
            parsed.append((rel, parse_file(f)[1]))
        except (SyntaxError, OSError):
            continue  # the core runner reports parse errors itself
    model = ConcurrencyModel(root, parsed)
    if len(_CACHE) > 4:
        _CACHE.clear()
    _CACHE[root] = (key, model)
    return model
