"""In-process serving client, the EngineAPI adapter and the selftest (the
port's copy of ``rca_tpu.serve.client``).

:class:`ServeClient` is how code inside the process talks to a
:class:`rca_tpu_torch.serve.loop.ServeLoop` (or a
:class:`rca_tpu_torch.serve.pool.ServePool`): submit returns the request (a
future — ``req.result(timeout)`` parks the caller), ``analyze`` is the
blocking convenience; requests over one graph coalesce into one batch
(same graph → same bucket).

:meth:`ServeClient.as_engine` returns an :class:`rca_tpu_torch.engine.
runner.EngineAPI` facade, which is how the coordinator uses the
scheduler: ``RCACoordinator(client, serve=serve_client)`` routes its
correlation analyses through the shared serving queue instead of owning
the device, so concurrent investigations batch instead of serializing.

:func:`serve_selftest` is the end-to-end smoke behind ``python -m
rca_tpu_torch serve --selftest`` (and the tier-1 suite): mixed-tenant
requests over several shape buckets, concurrent submitters, optional
chaos, and a bit-parity check of coalesced against solo rankings.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from rca_tpu_torch.engine.runner import EngineAPI, EngineResult
from rca_tpu_torch.serve.loop import ServeLoop
from rca_tpu_torch.serve.request import (
    PRIORITY_NORMAL,
    ServeRequest,
    ServeResponse,
)
from rca_tpu_torch.util.threads import make_thread

DEFAULT_TIMEOUT_S = 60.0


class ServeClient:
    """Thin submission surface over one (started) ServeLoop or ServePool;
    with no plane given it builds and starts a ServeLoop from
    ``loop_kwargs`` and stops it on :meth:`close`."""

    def __init__(self, loop: Optional[ServeLoop] = None, **loop_kwargs):
        self._own = loop is None
        self.loop = loop if loop is not None else ServeLoop(**loop_kwargs)
        if self._own:
            self.loop.start()

    def close(self) -> None:
        if self._own:
            self.loop.stop()

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- submission ----------------------------------------------------------
    def submit(
        self,
        features: np.ndarray,
        dep_src: np.ndarray,
        dep_dst: np.ndarray,
        names: Optional[Sequence[str]] = None,
        tenant: str = "default",
        k: int = 5,
        priority: int = PRIORITY_NORMAL,
        deadline_ms: Optional[float] = None,
        trace_parent=None,
        explain: bool = False,
        investigation_id: Optional[str] = None,
    ) -> ServeRequest:
        """Queue one analyze request; returns immediately with the
        request future (``queue_full``/``shed`` outcomes are already
        completed on it).  ``trace_parent`` (an observability
        ``SpanContext``) parents the request's trace onto the caller's
        span."""
        deadline_s = (
            self.loop.clock() + deadline_ms / 1e3
            if deadline_ms is not None else None
        )
        req = ServeRequest(
            tenant=tenant, features=features, dep_src=dep_src,
            dep_dst=dep_dst, names=names, k=k, priority=priority,
            deadline_s=deadline_s, trace_parent=trace_parent,
            explain=explain, investigation_id=investigation_id,
        )
        self.loop.submit(req)
        return req

    def submit_many(
        self, features_batch: Sequence[np.ndarray], dep_src, dep_dst,
        **kwargs,
    ) -> List[ServeRequest]:
        """A hypothesis sweep as individual requests over one graph, so
        they coalesce into one shape bucket and, queue permitting, one
        device batch."""
        return [
            self.submit(f, dep_src, dep_dst, **kwargs)
            for f in features_batch
        ]

    def analyze(
        self, features, dep_src, dep_dst,
        timeout_s: float = DEFAULT_TIMEOUT_S, **kwargs,
    ) -> ServeResponse:
        """Blocking submit: one request through the shared queue."""
        return self.submit(
            features, dep_src, dep_dst, **kwargs
        ).result(timeout_s)

    # -- coordinator facade --------------------------------------------------
    def as_engine(
        self,
        tenant: str = "coordinator",
        deadline_ms: Optional[float] = None,
        timeout_s: float = DEFAULT_TIMEOUT_S,
    ) -> "ServeEngineAdapter":
        return ServeEngineAdapter(
            self, tenant=tenant, deadline_ms=deadline_ms,
            timeout_s=timeout_s,
        )


class ServeEngineAdapter(EngineAPI):
    """EngineAPI facade over the serving queue: any caller written
    against the analyze boundary (the coordinator's correlate step, the
    CLI) runs through the shared scheduler unchanged, coalescing with
    whatever else is in flight."""

    def __init__(self, client: ServeClient, tenant: str,
                 deadline_ms: Optional[float], timeout_s: float):
        self.client = client
        self.tenant = tenant
        self.deadline_ms = deadline_ms
        self.timeout_s = timeout_s

    @property
    def device(self):
        """The device the plane serves on (a pool: its first replica's)."""
        plane = self.client.loop
        engine = (plane.engine if isinstance(plane, ServeLoop)
                  else plane.replicas[0].dispatcher.engine)
        return engine.device

    def analyze_arrays(self, features, dep_src, dep_dst, names=None,
                       k=None, timed=False) -> EngineResult:
        resp = self.client.analyze(
            features, dep_src, dep_dst, names=names, k=k or 5,
            tenant=self.tenant, deadline_ms=self.deadline_ms,
            timeout_s=self.timeout_s,
        )
        if resp.result is None:
            raise RuntimeError(
                f"serve: {resp.status}"
                + (f" ({resp.detail})" if resp.detail else "")
            )
        return resp.result


# ---------------------------------------------------------------------------
# Selftest (CLI `rca serve --selftest`, tier-1 smoke)
# ---------------------------------------------------------------------------


def serve_selftest(
    n_requests: int = 32,
    seed: int = 0,
    engine=None,
    chaos: bool = False,
    chaos_rate: float = 0.15,
    deadline_ms: float = 30_000.0,
    config=None,
    submitters: int = 4,
    timeout_s: float = 300.0,
    replicas: int = 1,
    replica_mix: str = "",
    kill_replica: bool = False,
    device=None,
) -> Dict[str, object]:
    """End-to-end scheduler smoke: ``n_requests`` mixed-tenant requests
    over three shape buckets, submitted from ``submitters`` concurrent
    threads with mixed priorities, a couple of them with already-expired
    deadlines (the shed contract must fire).  Asserts — and reports —
    that every request resolved (answered or shed), and that every ``ok``
    ranking is bit-identical to a solo analysis of the same request
    (the batching-parity contract), then returns the summary the CLI
    prints.  ``chaos`` wires a seeded fault hook into the dispatcher to
    exercise the breaker + degraded path (parity is then checked on the
    ok responses only — degraded ones are stale by contract).

    ``replicas`` > 1 (or a non-empty ``replica_mix``) runs the same
    contract through the :class:`rca_tpu_torch.serve.pool.ServePool` —
    parity is then checked per replica KIND against that replica's own
    engine, the summary carries the per-replica occupancy / steal /
    breaker rows, and exactly-once is asserted via the sink's
    ``double_completions``.  ``kill_replica`` kills replica 0 mid-wave
    (the chaos seam behind ``serve --selftest --kill-replica``): the
    work-stealing rebalance must leave every request answered-or-shed
    with zero double completions.

    The plane runs on ``device`` (default: the card; ``engine``'s device
    when an engine is given); a pool's replicas carve the visible devices
    of that type."""
    import dataclasses as _dc

    from rca_tpu_torch.cluster.generator import synthetic_cascade_arrays
    from rca_tpu_torch.config import ServeConfig
    from rca_tpu_torch.engine.runner import GraphEngine
    from rca_tpu_torch.parallel.mesh import visible_devices

    engine = engine or GraphEngine(device=device)
    fault_hook = None
    if chaos:
        from rca_tpu_torch.resilience.chaos import seeded_fault_hook

        fault_hook = seeded_fault_hook(seed, rate=chaos_rate)
    cases = [
        synthetic_cascade_arrays(n, n_roots=1, seed=seed + i)
        for i, n in enumerate((48, 120, 260))
    ]
    tenants = [f"tenant-{c}" for c in "abcd"]
    rng = np.random.default_rng(seed)
    use_pool = replicas > 1 or bool(replica_mix) or kill_replica
    if use_pool:
        from rca_tpu_torch.serve.pool import ServePool

        cfg = _dc.replace(
            config or ServeConfig.from_env(),
            replicas=max(replicas, 2 if kill_replica else 1),
            replica_mix=replica_mix,
        )
        loop = ServePool(config=cfg, fault_hook=fault_hook,
                         devices=visible_devices(engine.device))
    else:
        loop = ServeLoop(
            engine=engine, config=config or ServeConfig.from_env(),
            fault_hook=fault_hook,
        )
    # parity oracles: the engine serving each replica kind (a pool's ok
    # response names its engine tag; the solo rerun must use the SAME
    # engine so dense-vs-sharded float differences cannot masquerade as
    # batching-parity failures)
    solo_by_tag = {"serve+single": engine}
    if use_pool:
        for r in loop.replicas:
            solo_by_tag.setdefault(r.dispatcher.engine_tag,
                                   r.dispatcher.engine)
    loop.queue.set_weight(tenants[0], 2.0)  # one heavy tenant
    specs = []
    for i in range(n_requests):
        case = cases[i % len(cases)]
        if i % 3 == 2:
            # sparse perturbation: a handful of dirty rows, so repeat
            # dispatches over this graph ride the dispatcher's resident
            # delta path — its bit parity is under THIS selftest's
            # coalesced-vs-solo gate
            feats = case.features.copy()
            rows = rng.integers(0, case.features.shape[0], 4)
            feats[rows] = np.clip(
                feats[rows] + rng.uniform(
                    0, 0.2, (4, case.features.shape[1])
                ).astype(np.float32),
                0, 1,
            )
        else:
            feats = np.clip(
                case.features
                + rng.uniform(0, 0.05, case.features.shape).astype(
                    np.float32),
                0, 1,
            )
        specs.append({
            "case": case,
            "features": feats,
            "tenant": tenants[i % len(tenants)],
            "priority": 0 if i % 7 == 0 else 1,
            # a few requests arrive already expired: the shed contract
            # (no device slot, `shed` response) must fire
            "deadline_ms": -1.0 if i % 11 == 10 else deadline_ms,
        })
    requests: List[Optional[ServeRequest]] = [None] * n_requests
    with loop:
        client = ServeClient(loop)

        def submitter(worker: int) -> None:
            for i in range(worker, n_requests, submitters):
                s = specs[i]
                if kill_replica and worker == 0 and i >= n_requests // 2:
                    # chaos seam: replica 0 dies mid-wave; the steal
                    # protocol must keep every request answered-or-shed
                    loop.replicas[0].kill()
                requests[i] = client.submit(
                    s["features"], s["case"].dep_src, s["case"].dep_dst,
                    names=s["case"].names, tenant=s["tenant"], k=3,
                    priority=s["priority"], deadline_ms=s["deadline_ms"],
                )

        threads = [
            make_thread(submitter, name=f"selftest-submit-{w}",
                        daemon=True, args=(w,))
            for w in range(submitters)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout_s)
        responses = [r.result(timeout_s) for r in requests]  # type: ignore

        # second wave: CLOSED-LOOP sparse repeats over the largest graph.
        # The first wave established that graph's resident base in the
        # dispatcher, and each of these arrives after the previous one
        # resolved — so they dispatch separately and must ride the delta
        # path, putting its coalesced-vs-solo bit parity under THIS
        # selftest's gate.
        delta_specs: List[dict] = []
        delta_responses: List[ServeResponse] = []
        for j in range(4):
            case = cases[-1]
            feats = case.features.copy()
            rows = rng.integers(0, feats.shape[0], 3)
            feats[rows] = np.clip(
                feats[rows] + rng.uniform(
                    0, 0.2, (3, feats.shape[1])
                ).astype(np.float32),
                0, 1,
            )
            req = client.submit(
                feats, case.dep_src, case.dep_dst, names=case.names,
                tenant=tenants[j % len(tenants)], k=3,
            )
            delta_specs.append({"case": case, "features": feats})
            delta_responses.append(req.result(timeout_s))

        # kernelscope: snapshot BEFORE the loop stops (the monitor
        # disarms with it).  Every plan election here is a fresh shape —
        # a repeated one means a registry key drifted between identical
        # calls (or two threads elected one shape), and fails the
        # selftest like a parity break would.
        scope = loop.recompile_monitor.snapshot()

    by_status: Dict[str, int] = {}
    for resp in responses:
        by_status[resp.status] = by_status.get(resp.status, 0) + 1
    # without chaos the delta wave must be served ok (under chaos a
    # degraded answer is a legitimate outcome); parity below covers it
    delta_wave_ok = all(r.ok for r in delta_responses)
    # parity: every ok ranking must equal the solo analysis bit-for-bit
    # (delta-wave responses included — the resident delta path holds the
    # same contract as full staging)
    parity_checked = 0
    parity_ok = True
    for spec, resp in zip(
        list(specs) + delta_specs, list(responses) + delta_responses
    ):
        if not resp.ok:
            continue
        solo = solo_by_tag.get(resp.result.engine, engine).analyze_arrays(
            spec["features"], spec["case"].dep_src, spec["case"].dep_dst,
            spec["case"].names, k=3,
        )
        parity_checked += 1
        if solo.ranked != resp.ranked or not np.array_equal(
            solo.score, resp.result.score
        ):
            parity_ok = False
    expected_shed = sum(1 for s in specs if s["deadline_ms"] < 0)
    all_resolved = all(r.done() for r in requests)  # type: ignore
    summary = loop.metrics.summary()
    resident_delta_requests = sum(
        t["resident_delta_requests"] for t in summary["tenants"].values()
    )
    # only a dense dispatcher has the delta path: a delta wave a pool
    # routed to its sharded replica restages, as the reference's sharded
    # serve does
    delta_wave_dense = any(
        r.ok and r.result.engine == "serve+single" for r in delta_responses
    )
    ok = (
        all_resolved
        and parity_ok
        and by_status.get("shed", 0) >= expected_shed
        # without chaos the device path must be clean: no errors, every
        # non-shed request served ok, and the closed-loop delta wave both
        # resolved ok AND, served by a dense dispatcher, rode the resident
        # delta path.  Under chaos, degraded/error are legitimate contract
        # outcomes — the assertions that matter are resolution and parity
        # of the ok responses.
        and (chaos or (
            by_status.get("error", 0) == 0
            and by_status.get("ok", 0)
            == n_requests - by_status.get("shed", 0)
            and delta_wave_ok
            and (resident_delta_requests >= 1 or not delta_wave_dense)
        ))
        # recompile watchdog: zero repeat-signature compiles across the
        # whole selftest (fresh widths/shapes are legitimate and not
        # counted — see kernelscope)
        and scope["recompiles"] == 0
    )
    out = {
        "ok": bool(ok),
        "requests": n_requests,
        "chaos": bool(chaos),
        "kernelscope": {
            "enabled": scope["enabled"],
            "compiles": scope["compiles"],
            "recompiles": scope["recompiles"],
            **({"recompiled": scope["recompiled"]}
               if scope["recompiled"] else {}),
        },
        "by_status": by_status,
        "expected_shed_min": expected_shed,
        "all_resolved": bool(all_resolved),
        "parity_checked": parity_checked,
        "parity_ok": bool(parity_ok),
        "resident_delta_requests": resident_delta_requests,
        "delta_wave_ok": bool(delta_wave_ok),
        "delta_wave_dense": bool(delta_wave_dense),
        "device_batches": loop.device_batches,
        "metrics": summary,
    }
    if use_pool:
        # pool-mode rows: exactly-once accounting + the per-replica
        # occupancy / steal / breaker table (metrics["replicas"]) the
        # CLI prints; a nonzero double_completions fails the selftest
        out["replicas"] = len(loop.replicas)
        out["replica_mix"] = [r.kind for r in loop.replicas]
        out["kill_replica"] = bool(kill_replica)
        out["steals_total"] = summary.get("steals_total", 0)
        out["double_completions"] = loop.sink.double_completions
        out["breaker_state"] = {
            str(r.replica_id): (
                r.breaker.state if r.alive() else "dead"
            )
            for r in loop.replicas
        }
        out["ok"] = bool(out["ok"] and loop.sink.double_completions == 0)
        if kill_replica:
            out["ok"] = bool(
                out["ok"] and out["steals_total"] >= 0
                and any(s == "dead"
                        for s in out["breaker_state"].values())
            )
    else:
        out["breaker_state"] = loop.breaker.state
    return out
