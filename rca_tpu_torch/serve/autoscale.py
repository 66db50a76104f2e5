"""The autoscaler's rule tables (the port's copy of the tables of
``rca_tpu.serve.autoscale``).

**Policy is a table, not code paths.**  Every scale decision comes from
the declarative ``SCALE_RULES`` table: each rule names one signal, a
threshold, a SUSTAIN window (the signal must breach continuously for
``for_s`` before the rule fires: hysteresis), and an action.  Rule order
is priority; tables are validated loudly at construction (a typo'd rule
must fail at import, not mid-surge).

**Placement is a table too.**  ``PLACEMENT_RULES`` buckets requests by
graph size and says which evidence may reorder the rendezvous ring:
``timings`` (the hello frame's kernel-registry summary, per-shape winner
milliseconds) and ``headroom`` (the worker's CUDA allocator
``bytes_in_use``).  Small graphs stay pure rendezvous (any worker serves
them well and stickiness is worth more than microseconds); big graphs
route to the worker with the winning timing at their shape tier,
headroom breaking ties.  The scoring is deterministic, so a preferred
bucket is still STICKY.  :class:`rca_tpu_torch.serve.federation.
FederationPlane` reads ``PLACEMENT_RULES`` and :func:`shape_tier_ms`.

The controller that reads ``SCALE_RULES`` (``AutoscaleController``), its
thread fleet and its two soaks (the load ramp and the scaling storm) come
in the next slice of the port, with ``serve --autoscale``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

#: the elastic fleet's fault class (what ``chaos`` observes once the
#: controller is here).  Deliberately NOT in
#: ``federation.FED_FAULT_CLASSES``: that vocabulary is the plane's
#: per-worker death taxonomy; a scaling storm is a harness-level
#: composite (decisions racing those faults).
SCALING_FAULT_CLASSES = ("scaling_storm",)

SCALE_SIGNALS = ("queue_p99_ms", "queue_depth", "occupancy", "slo_burn")
SCALE_OPS = (">", "<")
SCALE_ACTIONS = ("up", "down")
PLACEMENT_EVIDENCE = ("timings", "headroom")

# ---------------------------------------------------------------------------
# SCALE_RULES — the declarative scaling policy
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ScaleRule:
    """One scaling trigger: ``signal op threshold`` sustained for
    ``for_s`` seconds fires ``action`` by ``step`` workers."""

    name: str
    signal: str
    op: str
    threshold: float
    for_s: float
    action: str
    step: int = 1


@dataclass(frozen=True)
class ScaleRuleSet:
    """An ordered, validated scale-rule table.  Order is priority: the
    FIRST sustained-breaching rule wins a sweep.  Validation is loud and
    total at construction — the same contract as the partition rules."""

    rules: Tuple[ScaleRule, ...]

    def __post_init__(self) -> None:
        if not self.rules:
            raise ValueError("ScaleRuleSet: at least one rule required")
        seen: set = set()
        for r in self.rules:
            ctx = f"scale rule {r.name!r}"
            if not r.name or r.name in seen:
                raise ValueError(
                    f"{ctx}: names must be non-empty and unique"
                )
            seen.add(r.name)
            if r.signal not in SCALE_SIGNALS:
                raise ValueError(
                    f"{ctx}: unknown signal {r.signal!r} "
                    f"(known: {SCALE_SIGNALS})"
                )
            if r.op not in SCALE_OPS:
                raise ValueError(f"{ctx}: op must be one of {SCALE_OPS}")
            if r.action not in SCALE_ACTIONS:
                raise ValueError(
                    f"{ctx}: action must be one of {SCALE_ACTIONS}"
                )
            if r.threshold < 0:
                raise ValueError(f"{ctx}: threshold must be >= 0")
            if r.for_s < 0:
                raise ValueError(f"{ctx}: for_s must be >= 0")
            if r.step < 1:
                raise ValueError(f"{ctx}: step must be >= 1")
        if not any(r.action == "up" for r in self.rules):
            raise ValueError("ScaleRuleSet: no scale-up rule")
        if not any(r.action == "down" for r in self.rules):
            raise ValueError("ScaleRuleSet: no scale-down rule")
        # hysteresis band: a signal driving BOTH directions must leave a
        # dead zone between its down and up thresholds, or one steady
        # value could fire up and down alternately (the flap this table
        # exists to make impossible)
        for sig in SCALE_SIGNALS:
            ups = [r.threshold for r in self.rules
                   if r.signal == sig and r.action == "up" and r.op == ">"]
            downs = [r.threshold for r in self.rules
                     if r.signal == sig and r.action == "down"
                     and r.op == "<"]
            if ups and downs and max(downs) >= min(ups):
                raise ValueError(
                    f"ScaleRuleSet: signal {sig!r} has no hysteresis "
                    f"band (down threshold {max(downs)} >= up threshold "
                    f"{min(ups)})"
                )


#: the default policy: scale up on sustained queue growth or SLO burn,
#: down only on a long-idle fleet.  Sustain windows are in units of the
#: default sweep interval (RCA_FED_SCALE_INTERVAL_S=1.0); the soak and
#: the tests pass their own faster tables.
SCALE_RULES = ScaleRuleSet(rules=(
    ScaleRule("surge-queue-p99", "queue_p99_ms", ">", 500.0, 5.0, "up", 2),
    ScaleRule("surge-depth", "queue_depth", ">", 32.0, 5.0, "up", 2),
    ScaleRule("surge-slo-burn", "slo_burn", ">", 0.0, 10.0, "up", 1),
    ScaleRule("hot-occupancy", "occupancy", ">", 0.85, 5.0, "up", 1),
    ScaleRule("idle-occupancy", "occupancy", "<", 0.10, 30.0, "down", 1),
))


# ---------------------------------------------------------------------------
# PLACEMENT_RULES — shape-aware routing policy
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PlacementRule:
    """One graph-size bucket: requests with ``n_services >=
    min_services`` may use the named evidence to reorder the ring."""

    name: str
    min_services: int
    prefer: Tuple[str, ...] = field(default_factory=tuple)


@dataclass(frozen=True)
class PlacementRuleSet:
    """Validated, first-match placement table over descending
    ``min_services`` bounds; the last rule must cover 0 so every
    request matches (an unroutable bucket is a bug, not a policy)."""

    rules: Tuple[PlacementRule, ...]

    def __post_init__(self) -> None:
        if not self.rules:
            raise ValueError("PlacementRuleSet: at least one rule required")
        seen: set = set()
        prev: Optional[int] = None
        for r in self.rules:
            ctx = f"placement rule {r.name!r}"
            if not r.name or r.name in seen:
                raise ValueError(
                    f"{ctx}: names must be non-empty and unique"
                )
            seen.add(r.name)
            if r.min_services < 0:
                raise ValueError(f"{ctx}: min_services must be >= 0")
            if prev is not None and r.min_services >= prev:
                raise ValueError(
                    f"{ctx}: min_services must strictly descend "
                    f"({r.min_services} after {prev})"
                )
            prev = r.min_services
            for ev in r.prefer:
                if ev not in PLACEMENT_EVIDENCE:
                    raise ValueError(
                        f"{ctx}: unknown evidence {ev!r} "
                        f"(known: {PLACEMENT_EVIDENCE})"
                    )
        if self.rules[-1].min_services != 0:
            raise ValueError(
                "PlacementRuleSet: last rule must cover min_services=0"
            )

    def rule_for(self, n_services: int) -> PlacementRule:
        for r in self.rules:
            if int(n_services) >= r.min_services:
                return r
        raise AssertionError("unreachable: last rule covers 0")


#: big graphs chase the winning per-shape kernel timing with headroom
#: tie-breaks; mid graphs use timings alone; small graphs stay pure
#: rendezvous — stickiness is worth more than microseconds there
PLACEMENT_RULES = PlacementRuleSet(rules=(
    PlacementRule("big-graphs", 192, ("timings", "headroom")),
    PlacementRule("mid-graphs", 48, ("timings",)),
    PlacementRule("small-graphs", 0, ()),
))


def shape_tier_ms(shape_ms: Dict[int, float],
                  n_services: int) -> Optional[float]:
    """A worker's advertised winner timing at the tier serving
    ``n_services``: the smallest known ``n_pad >= n_services``, else
    the largest known (an undersized tier still says how fast the
    worker's kernels are).  None with no data — the caller falls back
    to rendezvous."""
    if not shape_ms:
        return None
    covering = [p for p in shape_ms if p >= int(n_services)]
    tier = min(covering) if covering else max(shape_ms)
    return shape_ms[tier]
