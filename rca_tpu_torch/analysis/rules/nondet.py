"""Rule ``nondet-discipline``: replay-covered modules read no wall clock
and draw no unseeded randomness outside the injectable seams.

The flight recorder (``rca_tpu_torch/replay``) replays a session by
re-serving its recorded cluster responses to the real engine — which is
only sound while every OTHER input is deterministic.  A stray
``time.time()`` feeding a feature, a ``datetime.now()`` in a capture path,
or a global random draw makes recordings host-dependent and replay
divergence unexplainable.  This rule fences the replay-covered modules:

- **forbidden**: direct CALLS to ``time.time/monotonic/perf_counter``
  (and ``_ns`` twins), ``datetime.now/utcnow/today``, the ``findings``
  helper ``utcnow_iso``, module-level ``random.<fn>()`` draws, UNSEEDED
  RNG constructors (``random.Random()`` / ``np.random.default_rng()``
  with no arguments), and torch's draws from its GLOBAL generator: a
  ``torch.<draw>(...)`` (``rand``, ``randn``, ``randint``, ``randperm``,
  ``normal``, ``bernoulli``, ``multinomial``, ``poisson`` and their
  ``_like`` twins) or an in-place tensor draw (``.uniform_()``,
  ``.normal_()``, ``.random_()``, ``.bernoulli_()``, ``.exponential_()``,
  ``.geometric_()``, ``.cauchy_()``, ``.log_normal_()``) that names no
  ``generator=``;
- **seams (legal)**: passing a clock FUNCTION into an injectable
  parameter (``clock: Callable = time.monotonic`` — a reference, not a
  call; every covered module times through ``self._clock()``), SEEDED
  RNG construction (``random.Random(seed)``, ``default_rng(seed)``), and
  a torch draw from a named ``torch.Generator`` (``generator=g``) — a
  (seed, call-sequence) pair replays exactly.

The two allowlist entries ARE seams: ``MockClusterClient.get_current_time``
(wall time only behind its ``frozen_time=False`` escape hatch) and the
recorder's ``wall_now`` (header metadata — nothing replayed depends on
it).  Calls are matched by spelling, so a draw reached through an alias
(``r = torch.rand; r(3)``) is out of the rule's reach.
"""

from __future__ import annotations

import ast
from typing import List

from rca_tpu_torch.analysis.core import FileContext, Finding, Rule, register

#: replay-covered scope: everything a stream or serve recording's
#: determinism argument rests on (prefix match on repo-relative paths)
REPLAY_SCOPE = (
    "rca_tpu_torch/replay/",
    # the gateway fronts the serve plane and its canary mints recordings
    "rca_tpu_torch/gateway/",
    "rca_tpu_torch/engine/streaming.py",
    "rca_tpu_torch/engine/live.py",
    "rca_tpu_torch/parallel/streaming.py",
    "rca_tpu_torch/serve/",
    "rca_tpu_torch/cluster/watch_pump.py",
    "rca_tpu_torch/cluster/mock_client.py",
    "rca_tpu_torch/cluster/world.py",
    "rca_tpu_torch/cluster/snapshot.py",
    # coldiff frames replay the columnar row writes
    "rca_tpu_torch/cluster/columnar.py",
    # live ingest and the multi-cluster merge feed recorded sessions
    "rca_tpu_torch/cluster/live_columnar.py",
    "rca_tpu_torch/cluster/clusterset.py",
    "rca_tpu_torch/features/extract.py",
    "rca_tpu_torch/resilience/chaos.py",
    "rca_tpu_torch/resilience/policy.py",
    # spans are embedded in recordings (tick health records): the tracer
    # times through its injectable clock, never the wall
    "rca_tpu_torch/observability/",
)

#: torch functions that draw from the global generator unless they are
#: given ``generator=``
_TORCH_DRAWS = frozenset({
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial", "poisson", "rand_like", "randn_like", "randint_like",
})
#: in-place tensor draws (torch's spelling only: numpy has no trailing
#: underscore methods), global unless they are given ``generator=``
_TENSOR_DRAWS = frozenset({
    "uniform_", "normal_", "random_", "bernoulli_", "exponential_",
    "geometric_", "cauchy_", "log_normal_",
})

_TIME_FNS = frozenset({
    "time", "time_ns", "monotonic", "monotonic_ns",
    "perf_counter", "perf_counter_ns",
})
_DATETIME_FNS = frozenset({"now", "utcnow", "today"})

MSG_TIME = (
    "direct {call}() in a replay-covered module — time through the "
    "injectable clock seam (self._clock / the clock= parameter) so "
    "recordings stay host-independent"
)
MSG_RANDOM = (
    "module-level random.{fn}() in a replay-covered module — draw from a "
    "seeded random.Random(seed) instance so a (seed, call-sequence) pair "
    "replays exactly"
)
MSG_UNSEEDED = (
    "unseeded {ctor}() in a replay-covered module — pass a seed so the "
    "stream is replayable"
)
MSG_TORCH_GLOBAL = (
    "{call}() draws from torch's global generator in a replay-covered "
    "module — pass generator= (a seeded torch.Generator) so the stream "
    "is replayable"
)
MSG_WALLHELPER = (
    "utcnow_iso() in a replay-covered module — wall time must come from "
    "the client (get_current_time) or an allowlisted metadata seam"
)


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name of an attribute chain ('np.random.default_rng')."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


@register
class NondetDisciplineRule(Rule):
    name = "nondet-discipline"
    summary = ("no wall-clock reads or unseeded randomness in "
               "replay-covered modules outside the clock/RNG seams")
    why = ("the flight recorder replays recorded cluster responses "
           "through the real engine; one stray time.time() or global "
           "random draw makes the replay diverge on a different host "
           "with nothing in the log to explain why")

    allow = {
        # frozen_time=False escape hatch — the documented wall seam
        "rca_tpu_torch/cluster/mock_client.py": {"get_current_time"},
        # recording METADATA stamp (header created_at); never replayed
        "rca_tpu_torch/replay/recorder.py": {"wall_now"},
    }

    def applies_to(self, relpath: str) -> bool:
        return any(relpath.startswith(p) for p in REPLAY_SCOPE)

    def scan(self, ctx: FileContext) -> List[Finding]:
        hits: List[Finding] = []

        def check_call(node: ast.Call, func: str) -> None:
            dotted = _dotted(node.func)
            parts = dotted.split(".")
            if len(parts) < 1:
                return
            head, tail = parts[0], parts[-1]
            # time.<fn>() — only as a CALL; a bare reference passed into
            # a clock= parameter is the seam itself and stays legal
            if head == "time" and len(parts) == 2 and tail in _TIME_FNS:
                hits.append(ctx.finding(
                    self, node.lineno, MSG_TIME.format(call=dotted),
                    func=func,
                ))
                return
            # datetime.now()/utcnow()/today() (datetime.datetime.now too)
            if tail in _DATETIME_FNS and "datetime" in parts[:-1]:
                hits.append(ctx.finding(
                    self, node.lineno, MSG_TIME.format(call=dotted),
                    func=func,
                ))
                return
            if dotted == "utcnow_iso":
                hits.append(ctx.finding(
                    self, node.lineno, MSG_WALLHELPER, func=func,
                ))
                return
            # random.<fn>() module-level draws; random.Random(seed) and
            # any seeded constructor stay legal
            if head == "random" and len(parts) == 2:
                if tail == "Random":
                    if not node.args and not node.keywords:
                        hits.append(ctx.finding(
                            self, node.lineno,
                            MSG_UNSEEDED.format(ctor=dotted), func=func,
                        ))
                else:
                    hits.append(ctx.finding(
                        self, node.lineno,
                        MSG_RANDOM.format(fn=tail), func=func,
                    ))
                return
            # np.random.default_rng() / numpy.random.default_rng() unseeded
            if (tail == "default_rng" and "random" in parts[:-1]
                    and not node.args and not node.keywords):
                hits.append(ctx.finding(
                    self, node.lineno, MSG_UNSEEDED.format(ctor=dotted),
                    func=func,
                ))
                return
            # torch's global generator: torch.<draw>(...) or t.<draw>_()
            # without generator=
            named = any(kw.arg == "generator" for kw in node.keywords)
            if named:
                return
            if ((head == "torch" and len(parts) == 2
                    and tail in _TORCH_DRAWS)
                    or (isinstance(node.func, ast.Attribute)
                        and tail in _TENSOR_DRAWS)):
                hits.append(ctx.finding(
                    self, node.lineno,
                    MSG_TORCH_GLOBAL.format(call=dotted or tail),
                    func=func,
                ))

        def walk(node: ast.AST, func: str) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                func = node.name
            if isinstance(node, ast.Call):
                check_call(node, func)
            for child in ast.iter_child_nodes(node):
                walk(child, func)

        walk(ctx.tree, "<module>")
        return hits
