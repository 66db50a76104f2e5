"""Seeded fault injection over any cluster client, and the chaos soak.

The port's copy of ``rca_tpu.resilience.chaos``.
:class:`ChaosClusterClient` wraps a cluster client and injects, from a
seeded schedule, the fault classes the live session must absorb:

- ``api_timeout``     list/fetch calls raise :class:`InjectedTimeout`;
- ``truncated_list``  ``get_pods`` silently returns a truncated copy;
- ``nan_metrics``     ``get_pod_metrics`` returns a deep-copied payload
  with NaN/Inf ``usage_percentage`` values (poisons feature channels,
  exercising the engine's finite-mask sanitize);
- ``gone_storm``      ``watch_changes`` reports ``expired`` for several
  consecutive polls (a 410 Gone storm: repeated resyncs);
- ``pump_death``      ``watch_changes`` silently discards the pending feed
  entries, then reports one ``expired`` (a watch pump died holding
  undelivered changes).

With ``config.enabled = False`` (or every rate 0) the wrapper is a pure
delegating proxy, bit-identical to the wrapped client.  Injected faults
are listed by :meth:`ChaosClusterClient.drain_injected`; the live session
drains that surface into its per-tick health record, which is how
:func:`run_chaos_soak` (behind ``python -m rca_tpu_torch chaos``) counts
the observed fault classes and checks fault-free ticks against a
fault-free baseline.

:func:`seeded_fault_hook` is the serving scheduler's injector: ``serve
--selftest --chaos`` wires it into the batch dispatcher, where a fault it
raises takes the breaker and degraded-response path.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import random
from typing import Any, Callable, Dict, List, Optional

FAULT_CLASSES = (
    "api_timeout", "truncated_list", "nan_metrics", "gone_storm",
    "pump_death",
)


class InjectedTimeout(TimeoutError):
    """A chaos-injected timeout (distinguishable from real ones)."""


@dataclasses.dataclass
class ChaosConfig:
    """Schedule parameters.  ``rates`` are per-opportunity probabilities
    drawn from one seeded stream, so a (seed, call-sequence) pair replays
    the same fault schedule."""

    seed: int = 0
    enabled: bool = True
    rates: Dict[str, float] = dataclasses.field(default_factory=lambda: {
        "api_timeout": 0.06,
        "truncated_list": 0.10,
        "nan_metrics": 0.12,
        "gone_storm": 0.04,
        "pump_death": 0.03,
    })
    storm_len: int = 3      # consecutive expired polls per gone_storm
    nan_pods: int = 2       # pods corrupted per nan_metrics injection

    def rate(self, fault: str) -> float:
        return float(self.rates.get(fault, 0.0))


class ChaosClusterClient:
    """Fault-injecting proxy over any cluster client."""

    def __init__(self, inner: Any, config: Optional[ChaosConfig] = None):
        self.inner = inner
        self.config = config or ChaosConfig()
        self._rng = random.Random(self.config.seed)
        self._injected: List[Dict[str, str]] = []
        self._storm_left = 0
        self._nan_toggle = 0

    # -- bookkeeping --------------------------------------------------------
    def drain_injected(self, clear: bool = True) -> List[Dict[str, str]]:
        out = list(self._injected)
        if clear:
            self._injected.clear()
        return out

    def _fires(self, fault: str) -> bool:
        if not self.config.enabled:
            return False
        return self._rng.random() < self.config.rate(fault)

    def _record(self, fault: str, op: str) -> None:
        self._injected.append({"fault": fault, "op": op})

    def _maybe_timeout(self, op: str) -> None:
        if self._fires("api_timeout"):
            self._record("api_timeout", op)
            raise InjectedTimeout(f"chaos: injected timeout in {op}")

    # -- transparent delegation --------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name == "get_columnar":
            # the columnar capture would bypass exactly the surfaces this
            # wrapper injects on (get_pods truncation, metric NaNs, capture
            # timeouts), starving the seeded schedule: a chaos-wrapped
            # client does not advertise it, so soaks take the dict capture
            raise AttributeError(name)
        # anything not intercepted passes straight through: the disabled
        # wrapper is bit-identical to the wrapped client
        return getattr(self.inner, name)

    # -- intercepted surfaces ----------------------------------------------
    def get_pods(self, namespace: str) -> List[Dict[str, Any]]:
        self._maybe_timeout("get_pods")
        pods = self.inner.get_pods(namespace)
        if pods and len(pods) > 1 and self._fires("truncated_list"):
            keep = max(1, len(pods) - max(1, len(pods) // 4))
            self._record("truncated_list", "get_pods")
            return pods[:keep]
        return pods

    def get_events(self, namespace: str, field_selector=None):
        self._maybe_timeout("get_events")
        return self.inner.get_events(namespace, field_selector)

    def get_pod_metrics(self, namespace: str) -> Dict[str, Any]:
        self._maybe_timeout("get_pod_metrics")
        metrics = self.inner.get_pod_metrics(namespace)
        if not self._fires("nan_metrics"):
            return metrics
        pods = (metrics or {}).get("pods") or {}
        if not pods:
            return metrics
        corrupted = copy.deepcopy(metrics)
        names = sorted(pods)
        picks = [
            names[self._rng.randrange(len(names))]
            for _ in range(min(self.config.nan_pods, len(names)))
        ]
        # alternate NaN / +Inf so both non-finite shapes are exercised
        self._nan_toggle ^= 1
        poison = float("nan") if self._nan_toggle else float("inf")
        for name in picks:
            rec = corrupted["pods"][name]
            for ch in ("cpu", "memory"):
                if isinstance(rec.get(ch), dict):
                    rec[ch]["usage_percentage"] = poison
        self._record("nan_metrics", "get_pod_metrics")
        return corrupted

    def watch_changes(self, namespace: str, cursor):
        if cursor is not None and self.config.enabled:
            if self._storm_left > 0:
                self._storm_left -= 1
                self._record("gone_storm", "watch_changes")
                return {"supported": True, "cursor": cursor,
                        "expired": True, "changes": []}
            if self._fires("gone_storm"):
                # storm: this poll and the next storm_len-1 expire too
                self._storm_left = max(0, self.config.storm_len - 1)
                self._record("gone_storm", "watch_changes")
                return {"supported": True, "cursor": cursor,
                        "expired": True, "changes": []}
            if self._fires("pump_death"):
                # a dead pump loses whatever it was holding: consume the
                # real feed (dropping the entries) and report expiry
                self._record("pump_death", "watch_changes")
                self.inner.watch_changes(namespace, cursor)
                return {"supported": True, "cursor": cursor,
                        "expired": True, "changes": []}
        return self.inner.watch_changes(namespace, cursor)


def seeded_fault_hook(
    seed: int,
    rate: float = 0.1,
    ops: Optional[List[str]] = None,
) -> Callable[[str], None]:
    """Seeded fault injector for the serving dispatcher: called with the
    op name (``"dispatch"`` / ``"fetch"``) before the device work; raises
    :class:`InjectedTimeout` at ``rate`` per call from one seeded stream,
    so a (seed, call-sequence) pair replays the same fault schedule.
    ``ops`` restricts injection to those call sites (default: all)."""
    rng = random.Random(seed)

    def hook(op: str) -> None:
        if ops is not None and op not in ops:
            return
        if rng.random() < rate:
            raise InjectedTimeout(f"chaos: injected fault in serve {op}")

    return hook


# ---------------------------------------------------------------------------
# Chaos soak harness (`python -m rca_tpu_torch chaos`, tests)
# ---------------------------------------------------------------------------


def run_chaos_soak(
    make_world: Callable[[], Any],
    namespace: str,
    seed: int = 7,
    ticks: int = 200,
    k: int = 5,
    engine_factory: Optional[Callable[[], Any]] = None,
    config: Optional[ChaosConfig] = None,
    topology_check_every: int = 5,
    record_path: Optional[str] = None,
    pipeline_depth: Optional[int] = None,
    replay_check: bool = True,
    parity_mode: Optional[str] = None,
    device: Any = None,
) -> Dict[str, Any]:
    """Run ``ticks`` polls of a :class:`LiveStreamingSession` over a
    chaos-wrapped mock world and score the resilience contract:

    - ``uncaught_exceptions`` MUST be 0 (``poll()`` never raises);
    - every injected fault class should appear in the health records;
    - fault-free ticks (no injection this tick, no residual
      contamination, no sanitized rows, not degraded) must equal a
      fault-free baseline session over an identically built world, bit
      for bit (``parity_mode="exact"``) or by rank (``"rank"``); unset,
      ``rank`` when ``RCA_KERNEL=quantized`` forces the row whose scores
      move in the low decimals, else ``exact``.

    ``make_world`` is called twice (baseline + chaos), so the sessions
    never share mutable state.  ``engine_factory`` builds each session's
    engine (default :func:`make_engine` on ``device``, the CUDA card
    unless the caller names the CPU).

    ``record_path`` flight-records the CHAOS session: every client call
    (faults included) and every tick's ranking land in the log, and with
    ``replay_check`` the soak ends by replaying its own recording through
    a fresh engine and checking tick-for-tick parity
    (``summary["replay"]``)."""
    from rca_tpu_torch.cluster.mock_client import MockClusterClient
    from rca_tpu_torch.engine.live import LiveStreamingSession
    from rca_tpu_torch.engine.sharded_runner import make_engine
    from rca_tpu_torch.observability.kernelscope import (
        DeviceMemoryAccountant,
    )
    from rca_tpu_torch.resilience.policy import record_fault

    if parity_mode is None:
        from rca_tpu_torch.config import forced_kernel

        parity_mode = "rank" if forced_kernel() == "quantized" else "exact"
    if parity_mode not in ("exact", "rank"):
        raise ValueError(
            f"parity_mode={parity_mode!r}: expected 'exact' or 'rank'"
        )
    new_engine = engine_factory or (lambda: make_engine(device=device))

    base = LiveStreamingSession(
        MockClusterClient(make_world()), namespace, k=k,
        engine=new_engine(), topology_check_every=topology_check_every,
        pipeline_depth=pipeline_depth,
    )
    baseline_list = base.poll()["ranked"]
    baseline_ranked = json.dumps(baseline_list, sort_keys=True)

    recorder = None
    if record_path is not None:
        from rca_tpu_torch.replay import Recorder

        recorder = Recorder(
            record_path, mode="stream",
            seeds={"chaos_seed": seed},
            meta={"harness": "chaos_soak", "ticks": ticks},
        )

    cfg = config or ChaosConfig(seed=seed)
    was_enabled = cfg.enabled
    cfg.enabled = False  # the session's bootstrap capture runs fault-free
    chaos = ChaosClusterClient(MockClusterClient(make_world()), cfg)
    live = LiveStreamingSession(
        chaos, namespace, k=k, engine=new_engine(),
        topology_check_every=topology_check_every,
        pipeline_depth=pipeline_depth, recorder=recorder,
    )
    cfg.enabled = was_enabled

    counts: Dict[str, int] = {f: 0 for f in FAULT_CLASSES}
    kernel_paths: Dict[str, int] = {}
    uncaught = 0
    degraded_ticks = 0
    sanitized_total = 0
    parity_checked = 0
    parity_ok = True
    dirty = False
    # the session's own recompile monitor covers the tick path; this
    # accountant samples device memory every few ticks for the leak gate
    soak_memory = DeviceMemoryAccountant(sample_every=5)
    for _ in range(ticks):
        soak_memory.maybe_sample(live._polls)
        try:
            out = live.poll()
        except Exception as exc:  # contract violation: poll must not raise
            uncaught += 1
            record_fault("chaos.soak.uncaught", exc)
            continue
        health = out.get("health", {})
        path = str(health.get("kernel_path"))
        kernel_paths[path] = kernel_paths.get(path, 0) + 1
        injected = health.get("injected", [])
        for f in injected:
            counts[f.get("fault", "?")] = counts.get(f.get("fault", "?"), 0) + 1
        sanitized = int(health.get("sanitized_rows", 0))
        sanitized_total += sanitized
        if out.get("degraded"):
            degraded_ticks += 1
        faulted = bool(injected) or sanitized > 0 or bool(health.get("faults"))
        if faulted:
            # contaminated state can outlive the faulting tick (stale rows
            # persist across quiet polls until the next clean capture)
            dirty = True
        elif not out.get("quiet", False):
            dirty = False  # a clean full capture restored ground truth
        if not faulted and not dirty and not out.get("degraded"):
            parity_checked += 1
            if parity_mode == "rank":
                from rca_tpu_torch.engine.quantized import rank_parity

                if not rank_parity(baseline_list, out["ranked"])["ok"]:
                    parity_ok = False
            elif json.dumps(out["ranked"], sort_keys=True) != (
                    baseline_ranked):
                parity_ok = False
    replay_summary = None
    if recorder is not None:
        recorder.close()
        replay_summary = {
            "path": recorder.path,
            "ticks_recorded": recorder.ticks_recorded,
            "bytes": recorder.bytes_written,
        }
        if replay_check:
            # the record → replay leg: re-drive the real engine from the
            # log just written and demand parity tick for tick
            from rca_tpu_torch.replay import replay_stream

            report = replay_stream(record_path, engine=new_engine(),
                                   parity=parity_mode)
            replay_summary.update({
                "parity_ok": report["parity_ok"],
                "first_divergent_tick": report.get("first_divergent_tick"),
                "ticks_replayed": report["ticks_replayed"],
                "unconsumed_calls": report["unconsumed_calls"],
                "kernel_paths": report["kernel_paths"],
            })
            if report.get("attribution_ticks_compared") is not None:
                replay_summary["attribution_ticks_compared"] = (
                    report["attribution_ticks_compared"]
                )
                replay_summary["attribution_parity_ok"] = (
                    report["attribution_parity_ok"]
                )
    soak_memory.sample()  # closing sample so short soaks still gate
    scope = live.recompile_monitor.snapshot()
    kernelscope_summary = {
        "enabled": scope["enabled"],
        "compiles": scope["compiles"],
        "recompiles_post_warm": scope["recompiles_post_warm"],
        **({"recompiled": scope["recompiled"]}
           if scope["recompiled"] else {}),
        "memory_samples": soak_memory.samples_taken,
        "memory_gate": soak_memory.gate(),
    }
    return {
        "ticks": ticks,
        "seed": seed,
        "kernelscope": kernelscope_summary,
        **({"replay": replay_summary} if replay_summary else {}),
        "uncaught_exceptions": uncaught,
        "faults_injected": counts,
        "fault_classes_observed": sorted(
            f for f, n in counts.items() if n > 0
        ),
        "all_classes_observed": all(
            counts.get(f, 0) > 0 for f in FAULT_CLASSES
        ),
        "degraded_ticks": degraded_ticks,
        # the registry row each polled tick ran on (``kernels`` / ``torch``)
        "kernel_paths": kernel_paths,
        "sanitized_rows_total": sanitized_total,
        "final_degradation": getattr(live, "degradation", 0),
        "resyncs_expired": getattr(live, "resyncs_expired", 0),
        "resyncs_topology": getattr(live, "resyncs_topology", 0),
        "parity_ticks_checked": parity_checked,
        "parity_mode": parity_mode,
        "parity_ok": parity_ok,
    }
