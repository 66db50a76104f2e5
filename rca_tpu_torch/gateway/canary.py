"""Replay-driven continuous regression canary (the port's copy of
``rca_tpu.gateway.canary``, behind ``python -m rca_tpu_torch canary``).

A canary run has two phases:

1. **Sample**: drive live investigations — streaming sessions, merged
   multi-cluster sessions, serve waves in process, or serve waves through
   a RUNNING gateway — with the flight recorder attached, at
   ``RCA_CANARY_SAMPLE_RATE`` (a seeded Bernoulli draw per round).  Each
   sampled recording is minted into a one-file corpus fixture
   (:func:`rca_tpu_torch.replay.mint_recording`) and, with a store,
   stamped into the investigation store as its ``recording_ref``.

2. **Replay against a candidate**: every minted (or supplied) recording
   re-drives through a CANDIDATE engine — a different build, a perturbed
   scoring config (``--candidate-decay`` etc.), a different engine kind —
   and the run fails on ANY ranking divergence.  For stream recordings
   :func:`rca_tpu_torch.replay.bisect_divergence` names the exact first
   divergent tick (and dumps both sides' tensors); serve recordings name
   the first divergent request index.

Every engine here runs on ``device`` (the CUDA card unless the caller
names the CPU).  A sharded candidate needs more than one device: on a
one-card host it raises :class:`rca_tpu_torch.engine.sharded_runner.
ShardConfigError` rather than build a one-shard engine.
"""

from __future__ import annotations

import dataclasses
import os
import random
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

#: report lists every recording, but caps the divergence detail it
#: inlines (the dump file carries the full tensors)
_DIVERGENCE_DETAIL_CAP = 8


def build_candidate_engine(
    kind: str = "auto",
    weights: Optional[str] = None,
    decay: Optional[float] = None,
    explain_strength: Optional[float] = None,
    impact_bonus: Optional[float] = None,
    device=None,
) -> Tuple[Optional[object], Dict[str, Any]]:
    """The candidate the corpus replays against.

    With everything defaulted the candidate IS the current build (the
    replayer picks each recording's recorded engine kind) — the CI shape:
    yesterday's recordings gate today's tree.  Any override builds an
    explicit engine on ``device``: ``kind`` forces single / sharded,
    ``weights`` loads a checkpoint, and the three scalar knobs perturb the
    scoring params (which is how a divergence is planted for the bisect
    to localize)."""
    overrides = {
        key: value for key, value in (
            ("decay", decay),
            ("explain_strength", explain_strength),
            ("impact_bonus", impact_bonus),
        ) if value is not None
    }
    info: Dict[str, Any] = {"kind": kind, "weights": weights,
                            "param_overrides": overrides}
    if kind == "auto" and weights is None and not overrides:
        info["note"] = "current build, recorded engine kind"
        return None, info
    from rca_tpu_torch.config import RCAConfig
    from rca_tpu_torch.engine.params import resolve_params
    from rca_tpu_torch.engine.runner import GraphEngine

    params = None
    if weights:
        from rca_tpu_torch.engine.train import load_params

        params = load_params(weights)
    base = resolve_params(RCAConfig(), params)
    if overrides:
        base = dataclasses.replace(base, **overrides)
    if kind == "sharded":
        from rca_tpu_torch.engine.runner import resolve_device
        from rca_tpu_torch.engine.sharded_runner import (
            ShardConfigError,
            ShardedGraphEngine,
        )
        from rca_tpu_torch.parallel.mesh import visible_devices

        n_devices = len(visible_devices(resolve_device(device)))
        if n_devices < 2:
            raise ShardConfigError(
                f"a sharded candidate needs more than one device, have "
                f"{n_devices}"
            )
        return ShardedGraphEngine(params=base, device=device), info
    return GraphEngine(params=base, device=device), info


# -- sampling ----------------------------------------------------------------

def _perturbed(case, rng) -> np.ndarray:
    """One request's features: the case's, each raised by up to 0.05."""
    return np.clip(
        case.features + rng.uniform(
            0, 0.05, case.features.shape
        ).astype(np.float32),
        0, 1,
    )


def _sample_stream(tmp: str, out_path: str, ticks: int, services: int,
                   seed: int, k: int, device=None) -> Dict[str, Any]:
    """One recorded streaming investigation, minted to ``out_path``."""
    from rca_tpu_torch.cluster.generator import synthetic_cascade_world
    from rca_tpu_torch.cluster.mock_client import MockClusterClient
    from rca_tpu_torch.engine.live import LiveStreamingSession
    from rca_tpu_torch.engine.sharded_runner import make_engine
    from rca_tpu_torch.replay import Recorder, mint_recording

    world = synthetic_cascade_world(services, n_roots=1, seed=seed)
    recorder = Recorder(os.path.join(tmp, "stream"), mode="stream")
    session = LiveStreamingSession(
        MockClusterClient(world), "synthetic", k=k,
        engine=make_engine(device=device),
        topology_check_every=10, recorder=recorder,
    )
    rng = np.random.default_rng(seed)
    for t in range(ticks):
        if t % 3 == 0:
            # journaled churn so the recording carries real deltas, not
            # an all-quiet tape
            i = int(rng.integers(0, services))
            name = f"pod-svc-{i:05d}" if services > 5 else "pod-0"
            world.touch("pod_metrics", "synthetic", name)
        session.poll()
    recorder.close()
    stats = mint_recording(recorder.path, out_path)
    return {"mode": "stream", "ticks": stats["ticks"]}


def _sample_multicluster(tmp: str, out_path: str, ticks: int,
                         services: int, seed: int, k: int,
                         clusters: int = 3, device=None) -> Dict[str, Any]:
    """One recorded streaming investigation over a MERGED multi-cluster
    world: ``clusters`` synthetic member worlds behind one
    :class:`~rca_tpu_torch.cluster.clusterset.MergedClusterClient`,
    captured through the live columnar adapter with cluster-prefixed
    names and cluster-local service edges."""
    from rca_tpu_torch.cluster.clusterset import ClusterSet
    from rca_tpu_torch.cluster.generator import synthetic_cascade_world
    from rca_tpu_torch.cluster.mock_client import MockClusterClient
    from rca_tpu_torch.engine.live import LiveStreamingSession
    from rca_tpu_torch.engine.sharded_runner import make_engine
    from rca_tpu_torch.replay import Recorder, mint_recording

    worlds = {
        f"c{j}": synthetic_cascade_world(
            services, n_roots=1, seed=seed + j
        )
        for j in range(int(clusters))
    }
    cset = ClusterSet({
        cid: MockClusterClient(w) for cid, w in worlds.items()
    })
    merged = cset.merged_client()
    recorder = Recorder(os.path.join(tmp, "multicluster"), mode="stream")
    session = LiveStreamingSession(
        merged, "synthetic", k=k, engine=make_engine(device=device),
        topology_check_every=10, recorder=recorder,
    )
    rng = np.random.default_rng(seed)
    cids = sorted(worlds)
    for t in range(ticks):
        if t % 3 == 0:
            # churn lands in a different member each time, so merged
            # frames interleave cluster-prefixed deltas
            cid = cids[t // 3 % len(cids)]
            i = int(rng.integers(0, services))
            name = f"pod-svc-{i:05d}" if services > 5 else "pod-0"
            worlds[cid].touch("pod_metrics", "synthetic", name)
        session.poll()
    recorder.close()
    merged.close()
    stats = mint_recording(recorder.path, out_path)
    return {"mode": "multicluster", "clusters": int(clusters),
            "ticks": stats["ticks"]}


def _sample_gateway(tmp: str, out_path: str, url: str, requests: int,
                    services: int, seed: int, k: int,
                    token: Optional[str] = None,
                    ca_file: Optional[str] = None) -> Dict[str, Any]:
    """One serve wave sampled THROUGH a running gateway, so the plane
    behind it is what minted the rankings.  The canary writes the serve
    frames itself: it knows the exact inputs it sent (``float32 → JSON →
    float32`` is the identity) and the rankings that came back, and a
    serve frame is self-contained, so the minted recording replays
    against a candidate like an in-process one."""
    from rca_tpu_torch.cluster.generator import synthetic_cascade_arrays
    from rca_tpu_torch.gateway.client import GatewayClient
    from rca_tpu_torch.replay import Recorder, mint_recording
    from rca_tpu_torch.serve.request import ServeRequest

    client = GatewayClient.from_url(url, token=token, ca_file=ca_file)
    case = synthetic_cascade_arrays(services, n_roots=1, seed=seed)
    rng = np.random.default_rng(seed)
    recorder = Recorder(os.path.join(tmp, "gateway"), mode="serve")
    sampled = 0
    statuses: Dict[str, int] = {}
    for i in range(requests):
        feats = _perturbed(case, rng)
        code, body, _hdrs = client.analyze(
            feats, case.dep_src, case.dep_dst, names=case.names, k=k,
            tenant=None if token else f"canary-{i % 2}", retries=2,
        )
        status = str(body.get("status", f"http_{code}"))
        statuses[status] = statuses.get(status, 0) + 1
        if code == 200 and status == "ok":
            req = ServeRequest(
                tenant=str(body.get("tenant") or "canary"),
                features=feats, dep_src=case.dep_src,
                dep_dst=case.dep_dst, names=case.names, k=k,
            )
            recorder.record_serve(req, [dict(r) for r in body["ranked"]])
            sampled += 1
    recorder.close()
    if sampled == 0:
        raise RuntimeError(
            f"gateway canary: no ok responses from {url} "
            f"({statuses}) — nothing to mint"
        )
    stats = mint_recording(recorder.path, out_path)
    return {"mode": "gateway", "url": url, "requests": stats["serve"],
            "statuses": statuses}


def _sample_serve(tmp: str, out_path: str, requests: int, services: int,
                  seed: int, k: int, device=None) -> Dict[str, Any]:
    """One recorded serve wave through an in-process loop, minted to
    ``out_path``."""
    from rca_tpu_torch.cluster.generator import synthetic_cascade_arrays
    from rca_tpu_torch.engine.runner import GraphEngine
    from rca_tpu_torch.replay import Recorder, mint_recording
    from rca_tpu_torch.serve import ServeClient, ServeLoop

    case = synthetic_cascade_arrays(services, n_roots=1, seed=seed)
    rng = np.random.default_rng(seed)
    recorder = Recorder(os.path.join(tmp, "serve"), mode="serve")
    loop = ServeLoop(engine=GraphEngine(device=device), recorder=recorder)
    with loop:
        client = ServeClient(loop)
        reqs = [
            client.submit(
                _perturbed(case, rng), case.dep_src, case.dep_dst,
                names=case.names, tenant=f"canary-{i % 2}", k=k,
            )
            for i in range(requests)
        ]
        for r in reqs:
            r.result(120.0)
    recorder.close()
    stats = mint_recording(recorder.path, out_path)
    return {"mode": "serve", "requests": stats["serve"]}


# -- replay gate -------------------------------------------------------------

def _replay_one(path: str, engine, device=None) -> Dict[str, Any]:
    """Replay one recording against the candidate; on stream divergence,
    bisect to the exact tick."""
    from rca_tpu_torch.replay import (
        bisect_divergence,
        load_recording,
        replay_serve,
        replay_stream,
    )

    rec = load_recording(path)
    entry: Dict[str, Any] = {"recording": str(path), "mode": rec.mode}
    if rec.mode == "serve":
        report = replay_serve(path, engine=engine, device=device)
        entry["requests"] = report["requests_recorded"]
        entry["parity_ok"] = bool(report["parity_ok"])
        entry["first_divergent_index"] = report["first_divergent_index"]
        return entry
    report = replay_stream(path, engine=engine, device=device)
    entry["ticks"] = report["ticks_replayed"]
    entry["parity_ok"] = bool(report["parity_ok"])
    entry["engine_replayed"] = report["engine_replayed"]
    if not report["parity_ok"]:
        # bisect names the EXACT first divergent tick (fresh-session
        # probes) and dumps both sides' tensors for diffing
        bisect = bisect_divergence(path, engine=engine, device=device)
        entry["first_divergent_tick"] = bisect["first_divergent_tick"]
        entry["probes"] = bisect["probes"]
        entry["dump"] = bisect.get("dump")
    return entry


def run_canary(
    out_dir: str,
    rounds: int = 2,
    ticks: int = 12,
    services: int = 20,
    seed: int = 0,
    sample_rate: Optional[float] = None,
    mode: str = "stream",
    k: int = 5,
    candidate=None,
    candidate_info: Optional[Dict[str, Any]] = None,
    corpus: Optional[List[str]] = None,
    store=None,
    serve_requests: int = 8,
    listen_url: Optional[str] = None,
    token: Optional[str] = None,
    ca_file: Optional[str] = None,
    device=None,
) -> Dict[str, Any]:
    """Sample → mint → replay against the candidate; ``ok`` iff every
    replayed recording holds bit parity.

    ``mode``: ``stream`` | ``serve`` | ``both`` | ``multicluster`` — what
    each sampling round records.  ``listen_url`` points sampling at a
    RUNNING gateway instead of an in-process plane (``token`` /
    ``ca_file`` for a TLS and authn gateway).  ``corpus`` adds existing
    recordings to the replay gate without re-sampling them.  ``store``
    (an :class:`rca_tpu_torch.store.InvestigationStore`) gets one
    investigation per sampled recording, its ``recording_ref`` the minted
    file.  Sampling and replay run on ``device``."""
    if mode not in ("stream", "serve", "both", "multicluster"):
        raise ValueError(
            f"mode must be stream|serve|both|multicluster, got {mode!r}"
        )
    if listen_url is not None:
        mode = "gateway"
    if sample_rate is None:
        from rca_tpu_torch.config import canary_sample_rate

        sample_rate = canary_sample_rate()
    os.makedirs(out_dir, exist_ok=True)
    sampler = random.Random(seed)
    sampled: List[Dict[str, Any]] = []
    skipped = 0
    minted: List[str] = []
    for i in range(int(rounds)):
        # the seeded Bernoulli draw is consumed every round regardless
        # of outcome, so (seed, round) always addresses the same draw
        take = sampler.random() < sample_rate
        if not take:
            skipped += 1
            continue
        legs = ("stream", "serve") if mode == "both" else (mode,)
        for leg in legs:
            out_path = os.path.join(
                out_dir, f"canary-{leg}-{seed}-{i}.rcz"
            )
            tmp = tempfile.mkdtemp(prefix="rca_canary_")
            try:
                if leg == "stream":
                    info = _sample_stream(
                        tmp, out_path, ticks=ticks, services=services,
                        seed=seed + i, k=k, device=device,
                    )
                elif leg == "multicluster":
                    info = _sample_multicluster(
                        tmp, out_path, ticks=ticks, services=services,
                        seed=seed + i, k=k, device=device,
                    )
                elif leg == "gateway":
                    info = _sample_gateway(
                        tmp, out_path, listen_url,
                        requests=serve_requests, services=services,
                        seed=seed + i, k=k, token=token, ca_file=ca_file,
                    )
                else:
                    info = _sample_serve(
                        tmp, out_path, requests=serve_requests,
                        services=services, seed=seed + i, k=k,
                        device=device,
                    )
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            info["recording"] = out_path
            if store is not None:
                inv = store.create_investigation(
                    f"canary {leg} round {i} (seed {seed + i})",
                    namespace="synthetic",
                    recording_ref=out_path,
                )
                info["investigation_id"] = inv["id"]
            sampled.append(info)
            minted.append(out_path)

    results = [
        _replay_one(path, candidate, device=device)
        for path in list(minted) + list(corpus or [])
    ]
    divergent = [r for r in results if not r["parity_ok"]]
    first: Optional[Dict[str, Any]] = None
    if divergent:
        d = divergent[0]
        first = {
            "recording": d["recording"],
            **({"tick": d["first_divergent_tick"]}
               if "first_divergent_tick" in d else {}),
            **({"index": d["first_divergent_index"]}
               if d.get("first_divergent_index") is not None else {}),
        }
    return {
        "ok": not divergent,
        "mode": mode,
        "rounds": int(rounds),
        "sample_rate": float(sample_rate),
        "sampled": len(sampled),
        "skipped": skipped,
        "candidate": candidate_info or {
            "kind": "auto", "note": "current build",
        },
        "recordings": results,
        "divergent": [
            r["recording"] for r in divergent[:_DIVERGENCE_DETAIL_CAP]
        ],
        "first_divergence": first,
    }
