"""Rule ``rng-key-reuse``: draws are never correlated by accident, in
torch's and numpy's terms.

The hazard the JAX package's rule guards — one PRNG key consumed twice,
so two samplers return identical draws — has three spellings where
generators are stateful objects.  Nothing crashes in any of them: a
training sweep or a chaos schedule silently loses entropy and every
downstream number is quietly wrong.  Scope: ``rca_tpu_torch/``.

- **every draw names its generator**: a torch draw (``torch.rand``,
  ``randn``, ``randint``, ``randperm``, ``normal``, ``bernoulli``,
  ``multinomial``, ``poisson``, their ``_like`` twins, and the in-place
  tensor draws ``.uniform_()``, ``.normal_()``, ...) passes
  ``generator=``, and a numpy draw is a method of a
  ``np.random.Generator`` — a module-level ``np.random.<draw>()`` shares
  the process's one global stream with every other caller;
- **no global seeding**: ``torch.manual_seed`` (and ``torch.cuda`` /
  ``torch.random``'s) and ``np.random.seed`` reseed a stream every
  module shares, so two seedings with one value replay each other's
  draws (``torch.Generator().manual_seed(s)`` seeds a private generator
  and stays legal);
- **one seed, one generator**: within one function, one seed expression
  feeds at most one constructor of a family (``np.random.default_rng``,
  ``np.random.RandomState``, ``random.Random``, a ``torch.Generator``'s
  ``manual_seed``) — two generators of one family seeded alike draw the
  same stream — and a constructor inside a loop uses a seed that names a
  loop variable (else every iteration replays the first).  Generators of
  different families seeded alike are different algorithms, not
  correlated streams, and stay legal.

Seeds are compared by their source expression: ``seed`` and ``seed + 0``
count as two, and a seed threaded through another name is out of reach.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from rca_tpu_torch.analysis.core import FileContext, Finding, Rule, register
from rca_tpu_torch.analysis.rules.nondet import (
    _TENSOR_DRAWS,
    _TORCH_DRAWS,
    _dotted,
)

#: module-level numpy calls that are NOT draws (constructors, seeding
#: objects); every other ``np.random.<fn>()`` draws from the global stream
_NP_NOT_DRAWS = frozenset({
    "default_rng", "Generator", "RandomState", "SeedSequence", "PCG64",
    "PCG64DXSM", "MT19937", "Philox", "SFC64", "BitGenerator", "seed",
    "get_state", "set_state",
})
_GLOBAL_SEEDS = frozenset({
    "torch.manual_seed", "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all", "torch.random.manual_seed",
    "np.random.seed", "numpy.random.seed",
})

MSG_TORCH = (
    "{call}() draws from torch's global generator — pass generator= (a "
    "seeded torch.Generator of this caller's own)"
)
MSG_NUMPY = (
    "{call}() draws from numpy's global stream — draw from a "
    "np.random.Generator (np.random.default_rng(seed))"
)
MSG_GLOBAL_SEED = (
    "{call}() reseeds a stream every module shares — seed a generator of "
    "this caller's own instead"
)
MSG_SAME_SEED = (
    "seed `{seed}` feeds a second {family} generator in {func}() (first "
    "at line {first}) — both draw the same stream; derive distinct seeds"
)
MSG_LOOP_SEED = (
    "{family} generator built in a loop from seed `{seed}`, which names "
    "no loop variable — every iteration replays the first's draws"
)


def _family(node: ast.Call) -> Optional[Tuple[str, ast.expr]]:
    """(family, seed expression) of a seeded generator constructor."""
    dotted = _dotted(node.func)
    parts = dotted.split(".")
    tail = parts[-1]
    seed = node.args[0] if node.args else next(
        (kw.value for kw in node.keywords if kw.arg == "seed"), None)
    if seed is None:
        return None
    if tail in ("default_rng", "RandomState") and "random" in parts[:-1]:
        return f"numpy {tail}", seed
    if dotted in ("random.Random", "_random.Random"):
        return "random.Random", seed
    if (tail == "manual_seed" and isinstance(node.func, ast.Attribute)
            and isinstance(node.func.value, ast.Call)
            and _dotted(node.func.value.func).split(".")[-1] == "Generator"):
        return "torch.Generator", seed
    return None


def _names(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


@register
class RngKeyReuseRule(Rule):
    name = "rng-key-reuse"
    summary = ("every draw names its generator, nothing seeds a global "
               "stream, and one seed feeds one generator of a family")
    why = ("two samplers on one stream, or two generators seeded alike, "
           "return correlated or identical values: randomized sweeps, "
           "chaos schedules and init all lose entropy with zero crashes "
           "or test failures")

    def applies_to(self, relpath: str) -> bool:
        return relpath.startswith("rca_tpu_torch/")

    def scan(self, ctx: FileContext) -> List[Finding]:
        hits: List[Finding] = []

        def check_draw(node: ast.Call, func: str) -> None:
            dotted = _dotted(node.func)
            parts = dotted.split(".")
            head, tail = parts[0], parts[-1]
            if dotted in _GLOBAL_SEEDS:
                hits.append(ctx.finding(
                    self, node.lineno, MSG_GLOBAL_SEED.format(call=dotted),
                    func=func))
                return
            named = any(kw.arg == "generator" for kw in node.keywords)
            if not named and (
                    (head == "torch" and len(parts) == 2
                     and tail in _TORCH_DRAWS)
                    or (isinstance(node.func, ast.Attribute)
                        and tail in _TENSOR_DRAWS)):
                hits.append(ctx.finding(
                    self, node.lineno, MSG_TORCH.format(call=dotted),
                    func=func))
                return
            if (head in ("np", "numpy") and len(parts) == 3
                    and parts[1] == "random" and tail not in _NP_NOT_DRAWS):
                hits.append(ctx.finding(
                    self, node.lineno, MSG_NUMPY.format(call=dotted),
                    func=func))

        def check_function(fn: ast.AST) -> None:
            seen: Dict[Tuple[str, str], int] = {}

            def visit(node: ast.AST, loop_vars: List[Set[str]]) -> None:
                if node is not fn and isinstance(
                        node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.Lambda)):
                    return  # nested defs are judged on their own
                if isinstance(node, ast.Call):
                    check_draw(node, fn.name)
                    fam = _family(node)
                    if fam is not None:
                        family, seed = fam
                        text = ast.unparse(seed)
                        key = (family, text)
                        if key in seen:
                            hits.append(ctx.finding(
                                self, node.lineno, MSG_SAME_SEED.format(
                                    seed=text, family=family, func=fn.name,
                                    first=seen[key]),
                                func=fn.name))
                        else:
                            seen[key] = node.lineno
                        if loop_vars and not (_names(seed)
                                              & set().union(*loop_vars)):
                            hits.append(ctx.finding(
                                self, node.lineno, MSG_LOOP_SEED.format(
                                    seed=text, family=family),
                                func=fn.name))
                if isinstance(node, (ast.For, ast.AsyncFor)):
                    visit(node.iter, loop_vars)
                    inner = loop_vars + [_names(node.target)]
                    for stmt in node.body + node.orelse:
                        visit(stmt, inner)
                    return
                if isinstance(node, ast.While):
                    # a while loop has no loop variable: every name the
                    # body rebinds counts as one
                    bound = {n.id for n in ast.walk(node)
                             if isinstance(n, ast.Name)
                             and isinstance(n.ctx, ast.Store)}
                    inner = loop_vars + [bound]
                    visit(node.test, loop_vars)
                    for stmt in node.body + node.orelse:
                        visit(stmt, inner)
                    return
                if isinstance(node, (ast.ListComp, ast.SetComp,
                                     ast.DictComp, ast.GeneratorExp)):
                    inner = loop_vars + [set().union(
                        *(_names(g.target) for g in node.generators))]
                    for child in ast.iter_child_nodes(node):
                        visit(child, inner)
                    return
                for child in ast.iter_child_nodes(node):
                    visit(child, loop_vars)

            visit(fn, [])

        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                check_function(node)

        # draws at module level (outside every function)
        module_draws: List[ast.Call] = []

        def top(node: ast.AST) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda)):
                    continue
                if isinstance(child, ast.Call):
                    module_draws.append(child)
                top(child)

        top(ctx.tree)
        for node in module_draws:
            check_draw(node, "<module>")
        return hits
