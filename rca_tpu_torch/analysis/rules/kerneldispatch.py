"""Rule ``kernel-dispatch``: the registry is the ONLY dispatch seam.

:mod:`rca_tpu_torch.engine.registry` is the single place a propagation
surface learns which row a padded shape engages (``kernel_plan`` asks it,
then builds the winner's layouts).  The regression this rule prevents is
a call surface re-deriving the kernel choice locally — calling a
kernel's wrapper or a row's body directly — so that a new kernel or a
changed eligibility gate lands in N-1 of N surfaces and the cross-path
bit-parity contract silently breaks.

In torch terms the port picks kernels through tables and conditional
expressions (``_FRONTS[row]``, ``up = up_seg_step_shard if kern else
...``), so a REFERENCE to a target counts as a use, not only a call
(imports do not).  Flagged inside ``rca_tpu_torch/``, outside the seam
files: the CUDA kernels' wrappers (the front, its halves, the seg steps,
the one-CTA and the grid recursions, the per-shard entries, the front
and the recursions over every shard of one card and the recursions over
distinct cards, the flagged scans), the
shared propagation body (``propagate_core``), the layout
assembly (``build_seg_layouts``), the ``quantized`` and ``doubling``
rows' bodies and layout gates, and the attribution executables.
``chip_smoke.py`` and the tests are out of scope: measurement code calls
the kernels on purpose.  A target reached through an alias bound outside
the module is out of the rule's reach.
"""

from __future__ import annotations

import ast
from typing import List

from rca_tpu_torch.analysis.core import FileContext, Finding, Rule, register

#: uses that constitute bypassing the registry seam
TARGETS = frozenset({
    # the CUDA kernels' wrappers (engine/evidence.py, engine/segscan.py)
    "noisy_or_pair",
    "evidence_front",
    "evidence_front_rows",
    "seg_contrast_step",
    "seg_contrast_step_shard",
    "evidence_front_shard",
    "up_seg_step",
    "down_seg_step",
    "up_seg_steps",
    "down_seg_steps",
    "up_seg_steps_grid",
    "down_seg_steps_grid",
    "up_seg_steps_shard",
    "down_seg_steps_shard",
    "up_seg_step_shard",
    "down_seg_step_shard",
    "up_seg_steps_peer",
    "down_seg_steps_peer",
    "segscan_sum",
    "segscan_max",
    # the shared propagation body and the layout assembly
    "propagate_core",
    "build_seg_layouts",
    # quantized row bodies (engine/quantized.py)
    "noisy_or_pair_bf16",
    "quant_up_step",
    "quant_imp_step",
    "quantized_front",
    # doubling row bodies + layout gate (engine/doubling.py)
    "doubling_up",
    "doubling_down",
    "doubling_layouts_for",
    "build_doubling",
    # causelens attribution executables (engine/attribution.py): callers
    # go through compute_attribution / EngineResult.attribution()
    "attribution_sweep",
    "attribution_saliency",
})

#: files that ARE the seam (definitions + the registry's own timing)
ALLOWED_FILES = frozenset({
    "rca_tpu_torch/engine/registry.py",
    "rca_tpu_torch/engine/propagate.py",
    "rca_tpu_torch/engine/segscan.py",
    "rca_tpu_torch/engine/evidence.py",
    "rca_tpu_torch/engine/quantized.py",
    "rca_tpu_torch/engine/doubling.py",
    # the ell edge layout's recursions (they sum their overflow edges
    # with the flagged scan): the layout row's own body
    "rca_tpu_torch/engine/ell.py",
})

MESSAGE = (
    "{name} used outside the kernel-dispatch seam — propagation surfaces "
    "must ask rca_tpu_torch/engine/registry.py (through "
    "runner.kernel_plan) which row a shape engages; using a kernel's "
    "wrapper or a row's body directly lets kernel choices drift between "
    "call surfaces"
)


@register
class KernelDispatchRule(Rule):
    name = "kernel-dispatch"
    summary = ("outside the registry seam, no surface calls or selects "
               "the CUDA kernels' wrappers or a row's body — the "
               "registry is the only dispatch seam")
    why = ("a kernel choice re-derived locally at one call surface "
           "diverges from the registry's per-shape row the moment a new "
           "kernel or eligibility gate lands, breaking the cross-path "
           "bit-parity contract the serve/streaming/resident surfaces "
           "rely on")
    # the one layout-assembly step beside the registry (kernel_plan asks
    # the registry FIRST, then builds the winner's layouts), the sharded
    # engine's bodies, per shard and over every shard of one card (they
    # run the row and the form their ShardPlan carries, as propagate_core
    # runs the dense plan's), and the causelens host
    # wrapper (it asks the registry's attribution variant, then invokes
    # the executables it owns)
    allow = {
        "rca_tpu_torch/engine/runner.py": {"kernel_plan"},
        "rca_tpu_torch/parallel/sharded.py": {"propagate_blocks",
                                              "_propagate_card"},
        "rca_tpu_torch/engine/attribution.py": {"compute_attribution"},
    }

    def applies_to(self, relpath: str) -> bool:
        return (
            relpath.startswith("rca_tpu_torch/")
            and relpath not in ALLOWED_FILES
        )

    def scan(self, ctx: FileContext) -> List[Finding]:
        hits: List[Finding] = []
        func_stack: List[str] = []

        def visit(node: ast.AST) -> None:
            is_func = isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)
            )
            if is_func:
                func_stack.append(node.name)
            name = None
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                name = node.id
            elif (isinstance(node, ast.Attribute)
                  and isinstance(node.ctx, ast.Load)):
                name = node.attr
            if name in TARGETS:
                hits.append(ctx.finding(
                    self, node.lineno, MESSAGE.format(name=name),
                    func=func_stack[-1] if func_stack else "<module>",
                ))
            for child in ast.iter_child_nodes(node):
                visit(child)
            if is_func:
                func_stack.pop()

        visit(ctx.tree)
        return hits
