"""The elastic fleet: the autoscaler's controller, its rule tables, its
thread fleet and its two soaks (the port's copy of
``rca_tpu.serve.autoscale``).

A federation of a fixed N burns SLO through a surge until an operator
adds workers, and wastes hosts when idle.  :class:`AutoscaleController`
closes that loop on the coordinator: it watches the telemetry the plane
already exports (windowed queue-time p99, SLO burn, queue depth, fleet
occupancy) and spawns or drains workers through the plane's seams,
``FederationPlane.spawn_worker`` (``util.procs``) up and
``FederationPlane.drain_worker`` (drain-and-reroute) down.

**Policy is a table, not code paths.**  Every scale decision comes from
the declarative ``SCALE_RULES`` table: each rule names one signal, a
threshold, a SUSTAIN window (the signal must breach continuously for
``for_s`` before the rule fires: hysteresis), and an action.  One global
COOLDOWN after any action, plus min/max clamps, keeps a flapping load
signal from thrashing the ring: between the sustain requirement and the
cooldown there is at most one transition per ``cooldown_s``.  Rule order
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

**Every transition is chaos-gated.**  :func:`run_scaling_storm` is the
seeded ``scaling_storm`` fault class: scale-up racing a worker's
SIGKILL, a rejoin racing its drain, a partition during a scale-down;
:func:`run_scale_ramp_soak` walks the fleet min→max→min under continuous
traffic.  Both run in THREAD worker mode by default
(:class:`ThreadWorker`: a real ``WorkerAgent`` + ``ServeLoop`` over a real
loopback socket per fleet member, all on one engine on ``device``: the
card unless ``device="cpu"``); ``worker_mode="process"`` runs the storm
over worker processes on the plane's ``device``.

The controller counts a worker the plane has spawned but that has not
said hello yet (``scale_status()["spawning"]``) toward the fleet it
scales up, and never hands out a worker id twice, so a worker process
slower to join than the cooldown is not spawned past ``max_workers``.
Over a plane whose workers join before the next sweep its decisions are
the reference's.

Concurrency: ``AutoscaleController._lock`` guards the breach timers,
cooldown stamp and decision log, and is a LEAF, never held across a
plane call.  Timing goes through the plane's injectable clock (the
fake-clock tests drive ``run_once(now=)`` directly).
"""

from __future__ import annotations

import collections
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from rca_tpu_torch.config import (
    fed_scale_cooldown_s,
    fed_scale_interval_s,
    fed_scale_max,
    fed_scale_min,
)
from rca_tpu_torch.util.threads import make_lock, spawn

#: the elastic fleet's fault class (what ``chaos`` observes).
#: Deliberately NOT in ``federation.FED_FAULT_CLASSES``: that vocabulary
#: is the plane's per-worker death taxonomy; a scaling storm is a
#: harness-level composite (decisions racing those faults).
SCALING_FAULT_CLASSES = ("scaling_storm",)

SCALE_SIGNALS = ("queue_p99_ms", "queue_depth", "occupancy", "slo_burn")
SCALE_OPS = (">", "<")
SCALE_ACTIONS = ("up", "down")
PLACEMENT_EVIDENCE = ("timings", "headroom")

#: controller decisions retained for ``fleet`` / the soak report
_DECISION_CAP = 256

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


# ---------------------------------------------------------------------------
# The controller
# ---------------------------------------------------------------------------


class AutoscaleController:
    """Coordinator-side elastic-fleet controller over one
    :class:`rca_tpu_torch.serve.federation.FederationPlane`.

    Reads the plane through narrow, lock-consistent surfaces
    (``scale_status`` / ``pending_count`` / ``metrics
    .autoscale_signals``), decides through ``SCALE_RULES``, and acts
    through ``spawner`` (default: the plane's procs-seam
    ``spawn_worker``) and ``plane.drain_worker``.  ``run_once(now=)`` is
    the whole policy, drivable on a fake clock; ``start()`` runs it on a
    named monitor thread every ``interval_s``."""

    def __init__(
        self,
        plane,
        min_workers: Optional[int] = None,
        max_workers: Optional[int] = None,
        rules: Optional[ScaleRuleSet] = None,
        cooldown_s: Optional[float] = None,
        interval_s: Optional[float] = None,
        clock: Optional[Callable[[], float]] = None,
        spawner: Optional[Callable[[int], Any]] = None,
    ):
        self.plane = plane
        self.min_workers = (
            int(min_workers) if min_workers is not None else fed_scale_min()
        )
        self.max_workers = (
            int(max_workers) if max_workers is not None else fed_scale_max()
        )
        if not 1 <= self.min_workers <= self.max_workers:
            raise ValueError(
                f"autoscale bounds: need 1 <= min <= max, got "
                f"min={self.min_workers} max={self.max_workers}"
            )
        self.rules = rules if rules is not None else SCALE_RULES
        self.cooldown_s = (
            float(cooldown_s) if cooldown_s is not None
            else fed_scale_cooldown_s()
        )
        self.interval_s = (
            float(interval_s) if interval_s is not None
            else fed_scale_interval_s()
        )
        self.clock = clock if clock is not None else plane.clock
        self.spawner = spawner if spawner is not None else plane.spawn_worker
        self._lock = make_lock("AutoscaleController._lock")
        self._breach_since: Dict[str, float] = {}
        self._last_action_at: Optional[float] = None
        self._last_burn_total = 0
        # the next worker id this controller may hand out: a thread
        # member registers with the plane only at its hello, so the
        # plane's ``next_id`` alone could name a worker twice
        self._next_spawn_id = 0
        self.decisions: "collections.deque[Dict[str, Any]]" = (
            collections.deque(maxlen=_DECISION_CAP)
        )
        self.decision_total = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        plane.autoscaler = self

    # -- signals --------------------------------------------------------------
    def _observe(self) -> Tuple[Dict[str, float], Dict[str, Any]]:
        """One consistent reading of every rule signal and the fleet
        status it was computed against."""
        status = self.plane.scale_status()
        live = len(status["live"])
        depth = float(len(self.plane.queue))
        pending = float(self.plane.pending_count())
        sig = self.plane.metrics.autoscale_signals()
        burn_total = int(sig["slo_breach_total"])
        with self._lock:
            burn = max(0, burn_total - self._last_burn_total)
            self._last_burn_total = burn_total
        return {
            "queue_p99_ms": float(sig["queue_ms_p99_recent"] or 0.0),
            "queue_depth": depth,
            "occupancy": (
                pending / (max(1, live) * float(self.plane.window))
            ),
            "slo_burn": float(burn),
        }, status

    def signals(self) -> Dict[str, float]:
        return self._observe()[0]

    # -- policy ---------------------------------------------------------------
    def run_once(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One sweep: evaluate the table against live signals, apply at
        most one action.  ``now`` overrides the clock (fake-clock
        tests); the decision record is always returned."""
        t_in = self.clock()
        if now is None:
            now = t_in
        sig, status = self._observe()
        with self._lock:
            fired: Optional[ScaleRule] = None
            for rule in self.rules.rules:
                value = sig[rule.signal]
                breached = (
                    value > rule.threshold if rule.op == ">"
                    else value < rule.threshold
                )
                if not breached:
                    self._breach_since.pop(rule.name, None)
                    continue
                since = self._breach_since.setdefault(rule.name, now)
                if fired is None and now - since >= rule.for_s:
                    fired = rule
            cooling = (
                fired is not None
                and self._last_action_at is not None
                and now - self._last_action_at < self.cooldown_s
            )
        if fired is None:
            self.plane.metrics.scale_event("holds")
            return {"t": now, "action": "hold", "rule": None,
                    "live": len(status["live"]), "signals": sig}
        if cooling:
            self.plane.metrics.scale_event("cooldown_skips")
            decision = {"t": now, "action": "cooldown", "rule": fired.name,
                        "live": len(status["live"]), "signals": sig}
            self._record(decision)
            return decision
        return self._apply(
            fired.name, fired.action, fired.step, now, t_in, sig, status,
        )

    def force(self, action: str, step: int = 1, rule: str = "forced",
              victims: Optional[List[int]] = None) -> Dict[str, Any]:
        """Chaos seam: apply one transition NOW, bypassing sustain and
        cooldown; the min/max clamps still hold (the storm harness must
        not scale past the operator's bounds).  ``victims`` pins the
        scale-down choice (racing a drain against a SPECIFIC rejoined
        worker needs to name it)."""
        if action not in SCALE_ACTIONS:
            raise ValueError(f"force: action must be one of {SCALE_ACTIONS}")
        t_in = self.clock()
        sig, status = self._observe()
        self.plane.metrics.scale_event("forced")
        return self._apply(rule, action, int(step), t_in, t_in, sig,
                           status, victims=victims, forced=True)

    def _spawn_ids(self, status: Dict[str, Any], count: int) -> List[int]:
        """``count`` fresh worker ids, never one handed out before."""
        with self._lock:
            first = max(int(status["next_id"]), self._next_spawn_id)
            self._next_spawn_id = first + count
        return list(range(first, first + count))

    def _apply(self, rule_name: str, action: str, step: int, now: float,
               t_in: float, sig: Dict[str, float], status: Dict[str, Any],
               victims: Optional[List[int]] = None,
               forced: bool = False) -> Dict[str, Any]:
        live = list(status["live"])
        n_live = len(live)
        # spawned, not joined yet: capacity on its way, counted so a
        # slow start is not spawned again
        spawning = len(status.get("spawning", ()))
        if action == "up":
            have = n_live + spawning
            target = min(self.max_workers, have + step)
        else:
            have = n_live
            target = max(self.min_workers, n_live - step)
        decision: Dict[str, Any] = {
            "t": now, "rule": rule_name, "action": action,
            "from": n_live, "to": target, "forced": bool(forced),
            "workers": [],
            "signals": {k: round(float(v), 4) for k, v in sig.items()},
        }
        if spawning:
            decision["spawning"] = spawning
        # a scale-up never drains, whatever the fleet holds
        if target == have or (action == "up" and target < have):
            decision["action"] = "clamped"
            self.plane.metrics.scale_event("clamps")
            self._record(decision)
            return decision
        with self._lock:
            self._last_action_at = now
            # hysteresis re-arm: every sustain window restarts after an
            # action; the fleet just changed, and old breach history is
            # evidence about a topology that no longer exists
            self._breach_since.clear()
        if target > have:
            for wid in self._spawn_ids(status, target - have):
                self.spawner(wid)
                decision["workers"].append(wid)
            self.plane.metrics.scale_event("scale_ups")
            self.plane._event(
                "scale_up", None, rule=rule_name,
                added=list(decision["workers"]), target=target,
            )
        else:
            if victims is None:
                outstanding = status["outstanding"]
                # least-loaded first (cheapest drain); newest id breaks
                # ties so long-lived workers keep their hot residency
                victims = sorted(
                    live,
                    key=lambda w: (outstanding.get(w, 0), -w),
                )[: n_live - target]
            for wid in victims:
                if self.plane.drain_worker(wid):
                    decision["workers"].append(wid)
            self.plane.metrics.scale_event("scale_downs")
            self.plane._event(
                "scale_down", None, rule=rule_name,
                drained=list(decision["workers"]), target=target,
            )
        decision["decision_ms"] = round((self.clock() - t_in) * 1e3, 3)
        self._record(decision)
        return decision

    def _record(self, decision: Dict[str, Any]) -> None:
        with self._lock:
            self.decisions.append(decision)
            self.decision_total += 1

    def ensure_min(self) -> List[int]:
        """Bring a smaller-than-floor fleet up to ``min_workers`` (the
        attach-time bootstrap; also what ``serve --autoscale`` leans on
        before traffic arrives)."""
        status = self.plane.scale_status()
        have = (len(status["live"]) + len(status["draining"])
                + len(status.get("spawning", ())))
        spawned = self._spawn_ids(status, max(0, self.min_workers - have))
        for wid in spawned:
            self.spawner(wid)
        return spawned

    # -- lifecycle ------------------------------------------------------------
    def start(self, spawn_min: bool = True) -> "AutoscaleController":
        if self._thread is not None and self._thread.is_alive():
            return self
        if spawn_min:
            self.ensure_min()
        self._stop.clear()
        self._thread = spawn(
            self._run_loop, name="rca-fed-autoscale", daemon=True,
        )
        return self

    def _run_loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.run_once()
            except Exception as exc:  # noqa: BLE001 - outlive one bad sweep
                self.plane._event(
                    "autoscale_error", None,
                    error=f"{type(exc).__name__}: {exc}",
                )

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None

    def status(self) -> Dict[str, Any]:
        """The ``fleet`` / ``/healthz`` block."""
        with self._lock:
            last = self.decisions[-1] if self.decisions else None
            return {
                "min": self.min_workers,
                "max": self.max_workers,
                "cooldown_s": self.cooldown_s,
                "interval_s": self.interval_s,
                "running": (
                    self._thread is not None and self._thread.is_alive()
                ),
                "decisions": self.decision_total,
                "last_decision": dict(last) if last is not None else None,
            }


# ---------------------------------------------------------------------------
# Thread-mode fleet members (the ramp soak, the storm)
# ---------------------------------------------------------------------------


def _thread_fleet_engine(device=None):
    """The engine thread-mode fleet members SHARE, on ``device`` (the
    card unless ``device="cpu"``; raises without one).  Always the dense
    :class:`GraphEngine`, as the reference's (whose auto-sharded
    engine's collectives deadlock under several ServeLoop threads) and
    as the federation's workers pinned by ``RCA_SHARD=0``.  Sharing is
    safe: a serve dispatch reads only the engine's parameters and device
    and asks the registry (behind its own locks) for the row; every
    staging buffer, prepared graph and host copy belongs to the calling
    loop's dispatcher, and on the card every member launches on the
    device's one default stream.  Process-mode workers build their own
    engine in their own process."""
    from rca_tpu_torch.engine.runner import GraphEngine

    return GraphEngine(device=device)


class ThreadWorker:
    """One in-process fleet member: a real :class:`WorkerAgent` over a
    real loopback socket, serving through its own started
    :class:`ServeLoop`.  The full wire protocol (hello, lease,
    heartbeats, drain) with none of the process spawn cost, so a ramp
    soak can cycle 2→8→2 in seconds.  A shared ``engine`` skips
    per-member set-up (thread members measure CONTROL-plane elasticity;
    ``worker_mode="process"`` measures the procs seam); without one the
    member builds its own on ``device``."""

    def __init__(self, worker_id: int, host: str, port: int,
                 engine=None, config=None, device=None):
        from rca_tpu_torch.serve.loop import ServeLoop
        from rca_tpu_torch.serve.worker import WorkerAgent

        self.worker_id = int(worker_id)
        eng = engine if engine is not None else _thread_fleet_engine(device)
        self.loop = ServeLoop(engine=eng, config=config)
        self.loop.start()
        self.agent = WorkerAgent(
            self.worker_id, host, port, self.loop,
            engine_tag=getattr(eng, "engine_tag", type(eng).__name__),
            rejoin_seed=self.worker_id,
        )
        self.exit_code: Optional[int] = None
        self.thread = spawn(
            self._run, name=f"rca-fedw{worker_id}-agent", daemon=True,
        )

    def _run(self) -> None:
        try:
            self.exit_code = self.agent.run()
        finally:
            self.agent.close()
            self.loop.stop()

    def alive(self) -> bool:
        return self.thread.is_alive()

    def close(self, timeout_s: float = 10.0) -> None:
        self.agent.close()
        self.thread.join(timeout_s)


def thread_fleet_spawner(plane, fleet: Dict[int, ThreadWorker],
                         engine=None, config=None,
                         device=None) -> Callable[[int], Any]:
    """A controller ``spawner`` that grows a THREAD fleet against
    ``plane``'s control port, recording members in ``fleet`` so the
    harness can kill and join them."""
    def _spawn(worker_id: int) -> ThreadWorker:
        tw = ThreadWorker(
            worker_id, plane.host, plane.port, engine=engine, config=config,
            device=device,
        )
        fleet[int(worker_id)] = tw
        return tw
    return _spawn


# ---------------------------------------------------------------------------
# Load-ramp soak (2→8→2 under continuous traffic)
# ---------------------------------------------------------------------------


def run_scale_ramp_soak(
    seed: int = 0,
    min_workers: int = 2,
    max_workers: int = 8,
    services: Tuple[int, ...] = (24, 48),
    heavy_threads: int = 24,
    heavy_requests_each: int = 8,
    window: int = 4,
    p99_bound_ms: float = 30000.0,
    config=None,
    ramp_timeout_s: float = 90.0,
    cooldown_s: float = 0.35,
    interval_s: float = 0.05,
    device=None,
) -> Dict[str, Any]:
    """The elastic fleet's endurance contract: scale ``min→max→min``
    under CONTINUOUS traffic and hold every invariant through both
    transitions, the thread fleet on one engine on ``device`` (the card
    unless ``device="cpu"``).

    Heavy phase: ``heavy_threads`` closed-loop submitters over a small
    per-worker window saturate the fleet, and the surge rules walk it up
    to ``max_workers``.  Each submitter sends ``heavy_requests_each``
    requests and keeps going until the fleet has peaked (or
    ``ramp_timeout_s`` passed): a plane that answers the surge faster
    than the controller's cooldowns walk the fleet up must still face
    it.  Then the load drops to a trickle (traffic never stops) and the
    idle rule drains it back to ``min_workers``.  Gates computed IN-RUN:
    every request terminal, ZERO double completions, and the windowed
    queue p99 bounded right after the up-ramp and again at the end.
    Returns latency percentiles, scale-decision latency and the placement
    hit rate."""
    import numpy as np

    from rca_tpu_torch.cluster.generator import synthetic_cascade_arrays
    from rca_tpu_torch.serve.federation import FederationPlane
    from rca_tpu_torch.serve.request import ServeRequest
    from rca_tpu_torch.util.threads import make_thread

    # aggressive table scaled to the sweep interval: the soak must cross
    # min→max→min in seconds, not the production default's minutes.
    # occupancy drives both directions (band 0.2 .. 0.85)
    rules = ScaleRuleSet(rules=(
        ScaleRule("soak-depth", "queue_depth", ">", 4.0, 0.10, "up", 2),
        ScaleRule("soak-occupancy", "occupancy", ">", 0.85, 0.15, "up", 2),
        ScaleRule("soak-idle", "occupancy", "<", 0.20, 0.70, "down", 2),
    ))
    cases = [
        synthetic_cascade_arrays(n, n_roots=1, seed=seed + i)
        for i, n in enumerate(services)
    ]
    nprng = np.random.default_rng(seed)
    engine = _thread_fleet_engine(device)
    plane = FederationPlane(
        workers=0, config=config, heartbeat_s=0.15, window=window,
        spawn_workers=False,
    )
    fleet: Dict[int, ThreadWorker] = {}
    controller = AutoscaleController(
        plane, min_workers=min_workers, max_workers=max_workers,
        rules=rules, cooldown_s=cooldown_s, interval_s=interval_s,
        spawner=thread_fleet_spawner(plane, fleet, engine=engine,
                                     config=config),
    )
    latencies_ms: List[float] = []
    requests: List[ServeRequest] = []
    hung = 0
    req_lock = make_lock("ramp_soak.req_lock")

    def one_request(i: int) -> "ServeRequest":
        case = cases[i % len(cases)]
        feats = np.clip(
            case.features + nprng.uniform(
                0, 0.05, case.features.shape
            ).astype(np.float32),
            0, 1,
        )
        return ServeRequest(
            tenant=f"soak-{i % 3}", features=feats,
            dep_src=case.dep_src, dep_dst=case.dep_dst,
            names=case.names, k=3,
        )

    def closed_loop(idx: int, n: int) -> None:
        nonlocal hung
        j = 0
        while j < n or not surge_over.is_set():
            req = one_request(idx * 1000 + j)
            j += 1
            with req_lock:
                requests.append(req)
            t0 = plane.clock()
            plane.submit(req)
            try:
                req.result(60.0)
            except TimeoutError:
                with req_lock:
                    hung += 1
                continue
            with req_lock:
                latencies_ms.append((plane.clock() - t0) * 1e3)

    def live_count() -> int:
        return len(plane.scale_status()["live"])

    def wait_fleet(pred, timeout_s: float) -> bool:
        deadline = plane.clock() + timeout_s
        while plane.clock() < deadline:
            if pred():
                return True
            stop_trickle.wait(0.05)
        return pred()

    stop_trickle = threading.Event()
    surge_over = threading.Event()
    p99_after_up: Optional[float] = None
    with plane:
        controller.start(spawn_min=True)
        try:
            if not plane.wait_ready(min_workers, timeout_s=30.0):
                raise RuntimeError(
                    f"ramp soak: initial fleet of {min_workers} failed "
                    f"to join: {plane.worker_table()}"
                )
            t_ramp0 = plane.clock()
            heavy = [
                make_thread(closed_loop, name=f"soak-heavy-{i}",
                            daemon=True, args=(i, heavy_requests_each))
                for i in range(heavy_threads)
            ]
            for t in heavy:
                t.start()
            peaked = wait_fleet(
                lambda: live_count() >= max_workers, ramp_timeout_s,
            )
            ramp_up_s = plane.clock() - t_ramp0
            surge_over.set()
            p99_after_up = plane.metrics.autoscale_signals()[
                "queue_ms_p99_recent"
            ]
            for t in heavy:
                t.join(120.0)

            # trickle: traffic CONTINUES through the down-ramp
            def trickle() -> None:
                i = 0
                while not stop_trickle.is_set():
                    req = one_request(900000 + i)
                    with req_lock:
                        requests.append(req)
                    t0 = plane.clock()
                    plane.submit(req)
                    try:
                        req.result(30.0)
                        with req_lock:
                            latencies_ms.append(
                                (plane.clock() - t0) * 1e3
                            )
                    except TimeoutError:
                        pass
                    i += 1
                    stop_trickle.wait(0.05)

            trickler = make_thread(trickle, name="soak-trickle",
                                   daemon=True)
            t_down0 = plane.clock()
            trickler.start()
            shrunk = wait_fleet(
                lambda: live_count() <= min_workers, ramp_timeout_s,
            )
            ramp_down_s = plane.clock() - t_down0
            stop_trickle.set()
            trickler.join(60.0)
            with req_lock:
                all_reqs = list(requests)
            for req in all_reqs:
                if not req.done():
                    try:
                        req.result(60.0)
                    except TimeoutError:
                        hung += 1
            sig_end = plane.metrics.autoscale_signals()
            snap = plane.metrics.snapshot()
            double = plane.sink.double_completions
            stale = plane.stale_responses
            reroutes = plane.reroutes
            events = list(plane.events)
            decisions = list(controller.decisions)
        finally:
            surge_over.set()
            stop_trickle.set()
            controller.stop()
    for tw in fleet.values():
        tw.close(5.0)

    by_status: Dict[str, int] = {}
    for req in all_reqs:
        status = req.response.status if req.done() else "hung"
        by_status[status] = by_status.get(status, 0) + 1
    all_terminal = hung == 0 and all(r.done() for r in all_reqs)
    lat = sorted(latencies_ms)

    def pct(q: float) -> Optional[float]:
        return (
            round(lat[min(len(lat) - 1, int(len(lat) * q))], 3)
            if lat else None
        )

    decision_ms = sorted(
        d["decision_ms"] for d in decisions if "decision_ms" in d
    )
    p99_final = sig_end["queue_ms_p99_recent"]
    p99_ok = all(
        p is None or p <= p99_bound_ms
        for p in (p99_after_up, p99_final)
    )
    placement = snap["placement"]
    picks = sum(placement.values())
    scale_ups = sum(1 for e in events if e["event"] == "scale_up")
    scale_downs = sum(1 for e in events if e["event"] == "scale_down")
    ok = (
        all_terminal
        and double == 0
        and peaked
        and shrunk
        and p99_ok
        and scale_ups >= 1
        and scale_downs >= 1
    )
    return {
        "ok": bool(ok),
        "worker_mode": "thread",
        "min_workers": min_workers,
        "max_workers": max_workers,
        "requests": len(all_reqs),
        "by_status": by_status,
        "all_terminal": bool(all_terminal),
        "double_completions": double,
        "stale_responses": stale,
        "reroutes": reroutes,
        "peaked": bool(peaked),
        "shrunk": bool(shrunk),
        "ramp_up_s": round(ramp_up_s, 3),
        "ramp_down_s": round(ramp_down_s, 3),
        "scale_ups": scale_ups,
        "scale_downs": scale_downs,
        "request_ms_p50": pct(0.50),
        "request_ms_p99": pct(0.99),
        "queue_ms_p99_after_up": p99_after_up,
        "queue_ms_p99_final": p99_final,
        "p99_bound_ms": p99_bound_ms,
        "p99_ok": bool(p99_ok),
        "scale_decision_ms_p50": (
            round(decision_ms[len(decision_ms) // 2], 3)
            if decision_ms else None
        ),
        "placement": dict(placement),
        "placement_hit_rate": (
            round(placement["preferred"] / picks, 4) if picks else None
        ),
        "decisions": decisions[-12:],
    }


# ---------------------------------------------------------------------------
# scaling_storm: the chaos-gate fault class
# ---------------------------------------------------------------------------


def run_scaling_storm(
    seed: int = 7,
    workers: int = 3,
    max_workers: int = 6,
    services: int = 24,
    heartbeat_s: float = 0.12,
    timeout_s: float = 120.0,
    worker_mode: str = "thread",
    config=None,
    device=None,
) -> Dict[str, Any]:
    """The seeded ``scaling_storm`` fault class: scale decisions racing
    the federation's fault seams, under continuous wire load, on
    ``device`` (the card unless ``device="cpu"``: the thread fleet's
    engine, or the plane's worker processes in ``worker_mode="process"``).

    1. **scale-up racing SIGKILL**: a forced controller scale-up spawns
       a worker; the moment it joins it is killed: the half-born member
       must die as an ordinary ``process_kill``, never wedge the ring;
    2. **rejoin racing drain**: a worker is hung past its lease, ages
       out, wakes, rejoins, and a forced scale-down drains EXACTLY that
       worker while its rejoin is still warm (this also exercises the
       backoff'd re-hello path);
    3. **partition during scale-down**: one worker is partitioned while
       a forced scale-down drains ANOTHER: the fleet transitions with
       its capacity ambiguous, then the partitioned worker rejoins.

    Exit contract: every request terminal, ZERO double completions,
    stale drops bounded by reroutes (+ slack), every phase observed;
    only then does ``scaling_storm`` count as observed."""
    import random as _random

    import numpy as np

    from rca_tpu_torch.cluster.generator import synthetic_cascade_arrays
    from rca_tpu_torch.serve.federation import FederationPlane
    from rca_tpu_torch.serve.request import ServeRequest
    from rca_tpu_torch.util.threads import make_thread

    if worker_mode not in ("thread", "process"):
        raise ValueError(
            f"worker_mode must be 'thread' or 'process', got {worker_mode!r}"
        )
    rng = _random.Random(seed)
    case = synthetic_cascade_arrays(services, n_roots=1, seed=seed)
    nprng = np.random.default_rng(seed)
    process_mode = worker_mode == "process"
    plane = FederationPlane(
        workers=workers, config=config, heartbeat_s=heartbeat_s,
        spawn_workers=process_mode, device=device,
    )
    fleet: Dict[int, ThreadWorker] = {}
    spawner = None
    if not process_mode:
        spawner = thread_fleet_spawner(
            plane, fleet, engine=_thread_fleet_engine(device), config=config,
        )
    # wide-open rules: nothing fires organically; every transition in
    # the storm is a FORCED controller decision, deliberately timed
    # against the fault seams
    storm_rules = ScaleRuleSet(rules=(
        ScaleRule("storm-up", "queue_depth", ">", 1e9, 3600.0, "up", 1),
        ScaleRule("storm-down", "queue_p99_ms", "<", 0.0, 3600.0,
                  "down", 1),
    ))
    controller = AutoscaleController(
        plane, min_workers=1, max_workers=max_workers, rules=storm_rules,
        cooldown_s=0.05, interval_s=0.5, spawner=spawner,
    )
    ttl = plane.leases.ttl_s
    submitted: List[ServeRequest] = []
    stop_load = threading.Event()

    def load() -> None:
        i = 0
        while not stop_load.is_set():
            feats = np.clip(
                case.features + nprng.uniform(
                    0, 0.05, case.features.shape
                ).astype(np.float32),
                0, 1,
            )
            req = ServeRequest(
                tenant=f"storm-{i % 3}", features=feats,
                dep_src=case.dep_src, dep_dst=case.dep_dst,
                names=case.names, k=3,
            )
            submitted.append(req)
            plane.submit(req)
            i += 1
            stop_load.wait(0.03)

    def wait_event(pred, deadline: float) -> bool:
        while plane.clock() < deadline:
            if any(pred(e) for e in list(plane.events)):
                return True
            stop_load.wait(0.05)
        return False

    def downed(wid: int, klass: str):
        return lambda e: (
            e["event"] == "worker_down"
            and e["worker_id"] == wid and e.get("class") == klass
        )

    def rejoined(wid: int, after: float):
        return lambda e: (
            e["event"] == "rejoin" and e["worker_id"] == wid
            and e["t"] >= after
        )

    def scaled_down(wid: int):
        return lambda e: (
            e["event"] == "worker_scaled_down" and e["worker_id"] == wid
        )

    phases: List[Dict[str, Any]] = []
    with plane:
        if not process_mode:
            for i in range(workers):
                spawner(i)
        if not plane.wait_ready(workers, timeout_s=timeout_s / 2):
            raise RuntimeError(
                "scaling storm: initial fleet failed to join: "
                f"{plane.worker_table()}"
            )
        controller.start(spawn_min=False)
        loader = make_thread(load, name="storm-load", daemon=True)
        loader.start()
        try:
            # 1. scale-up racing SIGKILL
            d1 = controller.force("up", rule="storm-spawn")
            new_wid = d1["workers"][0] if d1["workers"] else -1
            joined = wait_event(
                lambda e: (e["event"] == "worker_joined"
                           and e["worker_id"] == new_wid),
                plane.clock() + timeout_s / 4,
            )
            plane.kill_worker(new_wid)
            kill_seen = wait_event(
                downed(new_wid, "process_kill"),
                plane.clock() + timeout_s / 4,
            )
            phases.append({
                "race": "scaleup_vs_kill", "worker": new_wid,
                "observed": bool(joined and kill_seen),
            })

            # 2. rejoin racing drain
            victims = [
                w for w in plane.live_workers() if w != new_wid
            ]
            hang_w = victims[rng.randrange(len(victims))]
            t_h = plane.clock()
            plane.hang_worker(hang_w, for_s=ttl * 2.5)
            hang_seen = wait_event(
                downed(hang_w, "worker_hang"),
                plane.clock() + timeout_s / 4,
            )
            rejoin_seen = wait_event(
                rejoined(hang_w, t_h), plane.clock() + timeout_s / 4,
            )
            controller.force("down", rule="storm-drain-rejoined",
                             victims=[hang_w])
            drain_seen = wait_event(
                scaled_down(hang_w), plane.clock() + timeout_s / 4,
            )
            phases.append({
                "race": "rejoin_vs_drain", "worker": hang_w,
                "observed": bool(hang_seen and rejoin_seen and drain_seen),
            })

            # 3. partition during scale-down (of a DIFFERENT worker)
            live = plane.live_workers()
            part_w = live[rng.randrange(len(live))]
            others = [w for w in live if w != part_w]
            drain_w = others[rng.randrange(len(others))]
            t_p = plane.clock()
            plane.partition(part_w, for_s=ttl * 2.5)
            controller.force("down", rule="storm-drain-partitioned",
                             victims=[drain_w])
            down_seen = wait_event(
                scaled_down(drain_w), plane.clock() + timeout_s / 4,
            )
            part_seen = wait_event(
                downed(part_w, "coordinator_partition"),
                plane.clock() + timeout_s / 4,
            )
            part_rejoin = wait_event(
                rejoined(part_w, t_p), plane.clock() + timeout_s / 4,
            )
            phases.append({
                "race": "partition_vs_scaledown",
                "partitioned": part_w, "drained": drain_w,
                "observed": bool(down_seen and part_seen and part_rejoin),
            })

            stop_load.wait(ttl)
        finally:
            stop_load.set()
            loader.join(10.0)
            controller.stop()
        responses = [r.result(timeout_s / 2) for r in submitted]
        double = plane.sink.double_completions
        stale = plane.stale_responses
        reroutes = plane.reroutes
        events = list(plane.events)
        plane_classes = plane.fault_classes_observed()
    for tw in fleet.values():
        tw.close(5.0)

    by_status: Dict[str, int] = {}
    for r in responses:
        by_status[r.status] = by_status.get(r.status, 0) + 1
    all_terminal = all(r.done() for r in submitted)
    stale_bound = reroutes + 8
    stale_bounded = stale <= stale_bound
    scale_ups = sum(1 for e in events if e["event"] == "scale_up")
    scale_downs = sum(1 for e in events if e["event"] == "scale_down")
    storm_observed = all(p["observed"] for p in phases)
    ok = (
        all_terminal
        and double == 0
        and stale_bounded
        and storm_observed
        and scale_ups >= 1
        and scale_downs >= 2
    )
    classes = sorted(
        set(plane_classes)
        | (set(SCALING_FAULT_CLASSES) if storm_observed else set())
    )
    return {
        "ok": bool(ok),
        "worker_mode": worker_mode,
        "workers": workers,
        "requests": len(submitted),
        "by_status": by_status,
        "all_terminal": bool(all_terminal),
        "double_completions": double,
        "stale_responses": stale,
        "stale_bound": stale_bound,
        "stale_bounded": bool(stale_bounded),
        "reroutes": reroutes,
        "scale_ups": scale_ups,
        "scale_downs": scale_downs,
        "fault_classes_observed": classes,
        "phases": phases,
        "lease_ttl_s": ttl,
        "rejoins": sum(1 for e in events if e["event"] == "rejoin"),
    }
