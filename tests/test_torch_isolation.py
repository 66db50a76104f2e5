"""The PyTorch port stands alone: no JAX, no ``rca_tpu``, no silent CPU.

- a port analysis in a fresh interpreter loads neither ``jax`` nor any
  module of the ``rca_tpu`` package (``rca_tpu_torch`` shares its prefix,
  so names are compared exactly);
- no source file of the port, nor ``chip_smoke.py``, imports either;
- a comprehensive analysis through the port's coordinator and a run of
  ``python -m rca_tpu_torch analyze`` load neither, nor do a resident
  repeat analysis, a streaming tick, a live poll,
  ``python -m rca_tpu_torch stream``, a sharded analysis (restaged,
  resident, batched, through the coordinator and a live session), a
  columnar capture, a native scan, the live columnar feed and an analysis
  through ``K8sApiClient()`` with no cluster, a serve selftest (the
  loop and the pool, chaos and a dense + sharded mix) and a coordinator
  with ``serve=``, a flight-recorded stream, chaos soak and serve load
  with their replays, the mint and the bisect, an analysis (one-shot,
  resident, batched, streamed) under ``RCA_KERNEL=quantized`` and
  ``RCA_KERNEL=doubling``, a fit with ``train``, its gate and its JSON
  checkpoint, and ``python -m rca_tpu_torch train``, the investigation
  layer (store, LLM layer, loggers, render helpers, hypotheses) with
  ``chat``, ``suggest``, ``report`` and ``investigations``, an analysis
  under ``RCA_EDGE_LAYOUT=ell``, a gateway analysis over the wire with
  its ``/metrics``, the canary (in process, through a gateway and as
  ``canary --mode multicluster``), ``fleet``, the merged multi-cluster
  client and a ``serve --listen`` subprocess (its own modules read at
  exit), the instruments (``profile_ticks``, ``ensure_cost``,
  ``run_tracecheck``, a comprehensive analysis under
  ``RCA_TORCH_PROFILE``), and the federation's worker processes of both
  roles, ``python -m rca_tpu_torch.serve.worker --device cpu`` serving a
  request and ``--role ingest`` ticking a cluster (their own modules read
  at exit; the ingest worker never initialises CUDA), and the elastic
  fleet (a thread-mode ramp soak, a controller attached to a plane with
  its thread spawner), and the analysis plane (``lint --json`` over the
  repository and specsan on the CPU, ``lint --rsan`` and the sanitized
  cross-check's chaos soak); with ``RCA_RSAN`` unset an analysis, a
  streaming tick and a serve request import nothing of
  ``analysis.concurrency`` and get bare ``threading`` primitives from
  the seam; the native scanner
  loaded is the one built from ``rca_tpu_torch/native/``;
- without a CUDA device the engine, the coordinator, the CLI (``stream``
  and ``profile`` included), the streaming sessions, ``replay``,
  ``chaos``, the recompile gate, a federation serve worker and a thread
  fleet member (with the soak and ``serve --autoscale``) raise (or
  exit non-zero, naming the cause) unless the caller asks for the CPU,
  and ``chip_smoke.py``
  exits non-zero with no verdict line;
- on a card (tests marked ``cuda``) the engine runs through the kernels
  and agrees with its own CPU run.
"""

import ast
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "rca_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return name in ("jax", "rca_tpu") or name.startswith(("jax.", "rca_tpu."))


_PROBE = """
import json, sys
import numpy as np
from rca_tpu_torch import GraphEngine
from rca_tpu_torch.cluster.generator import synthetic_cascade_arrays
from rca_tpu_torch.cluster.generator import synthetic_cascade_world
from rca_tpu_torch.cluster.mock_client import MockClusterClient
from rca_tpu_torch.coordinator import RCACoordinator
from rca_tpu_torch.engine.registry import kernel_table
case = synthetic_cascade_arrays(200, n_roots=2, seed=1)
engine = GraphEngine(device="cpu")
res = engine.analyze_case(case)
lanes = engine.analyze_batch(np.stack([case.features] * 3), case.dep_src,
                             case.dep_dst, case.names)
rec = RCACoordinator(MockClusterClient(synthetic_cascade_world(
    50, n_roots=1, seed=7, namespace="synthetic")), backend="torch",
    device="cpu").run_analysis("comprehensive", "synthetic")
corr = rec["results"]["correlated"]
print(json.dumps({"top": res.top_components(), "status": rec["status"],
                  "backend": corr["backend"],
                  "provenance": "provenance" in corr,
                  "lanes": [r.top_components() for r in lanes],
                  "rows": len(kernel_table()),
                  "modules": sorted(sys.modules)}))
"""

_CLI_PROBE = """
import json, runpy, sys
codes = []
for argv in (["analyze", "--fixture", "5svc"],
             ["hypotheses", "--fixture", "50svc", "--seed", "7"],
             ["kernels", "--services", "50", "--json"]):
    sys.argv = ["rca_tpu_torch", *argv, "--device", "cpu", "--compact"]
    try:
        runpy.run_module("rca_tpu_torch", run_name="__main__")
    except SystemExit as exc:
        codes.append(exc.code)
print(json.dumps({"codes": codes, "modules": sorted(sys.modules)}))
"""


_STREAM_PROBE = """
import json, runpy, sys
import numpy as np
from rca_tpu_torch.cluster.generator import synthetic_cascade_arrays
from rca_tpu_torch.cluster.generator import synthetic_cascade_world
from rca_tpu_torch.cluster.mock_client import MockClusterClient
from rca_tpu_torch.engine import (GraphEngine, LiveStreamingSession,
                                  StreamingSession)
case = synthetic_cascade_arrays(200, n_roots=2, seed=1)
engine = GraphEngine(device="cpu")
first = engine.analyze_case(case)
feats = case.features.copy()
feats[3] = np.nan
again = engine.analyze_arrays(feats, case.dep_src, case.dep_dst, case.names)
stream = StreamingSession(case.names, case.dep_src, case.dep_dst,
                          num_features=13, engine=engine, k=3)
stream.set_all(case.features)
stream.update(3, feats[3])
tick = stream.fetch(stream.dispatch())
live = LiveStreamingSession(MockClusterClient(synthetic_cascade_world(
    40, n_roots=1, seed=3, namespace="iso")), "iso", k=3, engine=engine,
    pipeline_depth=2)
polls = [live.poll() for _ in range(3)]
sys.argv = ["rca_tpu_torch", "stream", "--fixture", "50svc", "--ticks", "2",
            "--interval", "0", "--device", "cpu"]
try:
    runpy.run_module("rca_tpu_torch", run_name="__main__")
except SystemExit as exc:
    code = exc.code
print(json.dumps({"stats": engine._resident_cache.stats(),
                  "sanitized": again.sanitized_rows,
                  "tick": tick["sanitized_rows"],
                  "live": [bool(p["ranked"]) for p in polls],
                  "code": code, "modules": sorted(sys.modules)}))
"""


_CAPTURE_PROBE = """
import json, sys
from rca_tpu_torch import native
from rca_tpu_torch.cluster.generator import synthetic_cascade_world
from rca_tpu_torch.cluster.k8s_client import K8sApiClient
from rca_tpu_torch.cluster.live_columnar import LiveColumnarFeed
from rca_tpu_torch.cluster.mock_client import MockClusterClient
from rca_tpu_torch.cluster.snapshot import ClusterSnapshot
from rca_tpu_torch.coordinator import RCACoordinator
from rca_tpu_torch.features.extract import extract_features
world = synthetic_cascade_world(60, n_roots=1, seed=3, namespace="cap")
snap = ClusterSnapshot.capture(MockClusterClient(world), "cap")
fs = extract_features(snap)
counts = native.scan_text_native("ERROR: connection refused; OOMKilled")
feed = LiveColumnarFeed(MockClusterClient(world), "cap")
full = feed.payload(None)
feed.close()
rec = RCACoordinator(K8sApiClient(), backend="torch",
                     device="cpu").run_analysis("comprehensive", "default")
print(json.dumps({"columnar": snap.columnar is not None,
                  "services": len(fs.service_names),
                  "counts": [int(c) for c in counts],
                  "scanner": native.load_native()._name,
                  "sanitize": native.load_sanitize().__file__,
                  "feed": [full["supported"], full["full"]],
                  "status": rec["status"],
                  "modules": sorted(sys.modules)}))
"""


def test_capture_layer_loads_no_jax_and_no_rca_tpu(tmp_path):
    import hashlib
    import sysconfig

    env = {**_probe_env(), "RCA_NATIVE_CACHE": str(tmp_path / "native"),
           "KUBECONFIG": str(tmp_path / "missing")}
    proc = subprocess.run(
        [sys.executable, "-c", _CAPTURE_PROBE], cwd=str(ROOT),
        capture_output=True, text=True, timeout=180, env=env,
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["columnar"] and out["services"] == 60
    assert out["counts"][:2] == [1, 1]          # oom_kill, connection_refused
    assert out["feed"] == [True, True]
    assert out["status"] == "completed"
    # the scanner and the sanitize extension were built from the port's
    # sources (the hash tag binds the artifact to its source and ABI) into
    # the configured cache
    abi = (sysconfig.get_config_var("SOABI") or "unknown-abi").encode()
    for key, src, prefix in (("scanner", "logscan.cpp", "liblogscan"),
                             ("sanitize", "sanitizec.c", "sanitizec")):
        so = Path(out[key])
        tag = hashlib.sha256(
            (ROOT / "rca_tpu_torch" / "native" / src).read_bytes() + abi
        ).hexdigest()[:16]
        assert so.name == f"{prefix}-{tag}.so", key
        assert so.parent == (tmp_path / "native").resolve()
    for module in ("cluster.columnar", "cluster.k8s_client", "native",
                   "cluster.live_columnar"):
        assert f"rca_tpu_torch.{module}" in out["modules"], module
    assert [m for m in out["modules"] if _forbidden(m)] == []


def test_resident_streaming_live_and_stream_load_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _STREAM_PROBE], cwd=str(ROOT),
        capture_output=True, text=True, timeout=180, env=_probe_env(),
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert [json.loads(line)["tick"] for line in lines[:2]] == [1, 2]
    out = json.loads(lines[-1])
    assert out["stats"]["delta_requests"] == 1
    assert out["sanitized"] == out["tick"] == 1
    assert out["live"] == [False, True, True]
    assert out["code"] == 0
    for module in ("engine.resident", "engine.streaming", "engine.live",
                   "observability.kernelscope", "observability.spans",
                   "resilience.policy"):
        assert f"rca_tpu_torch.{module}" in out["modules"]
    assert [m for m in out["modules"] if _forbidden(m)] == []


_SHARDED_PROBE = """
import json, sys
import numpy as np
import torch
from rca_tpu_torch.cluster.generator import synthetic_cascade_arrays
from rca_tpu_torch.cluster.generator import synthetic_cascade_world
from rca_tpu_torch.cluster.mock_client import MockClusterClient
from rca_tpu_torch.coordinator import RCACoordinator
from rca_tpu_torch.engine import LiveStreamingSession, ShardedGraphEngine
from rca_tpu_torch.parallel.mesh import make_mesh
mesh = make_mesh([("dp", 2), ("sp", 4)], [torch.device("cpu")] * 8)
engine = ShardedGraphEngine(mesh=mesh)
case = synthetic_cascade_arrays(300, n_roots=2, seed=1)
first = engine.analyze_case(case)
feats = case.features.copy()
feats[3] = np.nan
again = engine.analyze_arrays(feats, case.dep_src, case.dep_dst, case.names)
lanes = engine.analyze_batch(np.stack([case.features] * 3), case.dep_src,
                             case.dep_dst, case.names)
rec = RCACoordinator(MockClusterClient(synthetic_cascade_world(
    50, n_roots=1, seed=7, namespace="synthetic")), backend="torch",
    engine=engine).run_analysis("comprehensive", "synthetic")
live = LiveStreamingSession(MockClusterClient(synthetic_cascade_world(
    40, n_roots=1, seed=3, namespace="iso")), "iso", k=3, engine=engine)
polls = [live.poll() for _ in range(2)]
print(json.dumps({"engine": first.engine, "top": first.top_components(),
                  "sanitized": again.sanitized_rows,
                  "lanes": [r.top_components() for r in lanes],
                  "status": rec["status"],
                  "corr_engine": rec["results"]["correlated"]["engine"],
                  "session": type(live.session).__name__,
                  "live": [bool(p["ranked"]) for p in polls],
                  "modules": sorted(sys.modules)}))
"""


def test_sharded_analysis_loads_no_jax_and_no_rca_tpu():
    proc = subprocess.run(
        [sys.executable, "-c", _SHARDED_PROBE], cwd=str(ROOT),
        capture_output=True, text=True, timeout=180, env=_probe_env(),
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["engine"] == "sharded(dp=2,sp=4)"
    assert out["corr_engine"] == "sharded(dp=2,sp=4)"
    assert out["status"] == "completed"
    assert out["sanitized"] == 1
    assert out["lanes"] == [out["top"]] * 3
    assert out["session"] == "ShardedStreamingSession"
    assert out["live"] == [True, True]
    for module in ("engine.sharded_runner", "parallel.sharded",
                   "parallel.collectives", "parallel.mesh",
                   "parallel.rules", "parallel.streaming"):
        assert f"rca_tpu_torch.{module}" in out["modules"]
    assert [m for m in out["modules"] if _forbidden(m)] == []


_SERVE_PROBE = """
import json, sys
from rca_tpu_torch import GraphEngine
from rca_tpu_torch.cluster.fixtures import NS, five_service_world
from rca_tpu_torch.cluster.mock_client import MockClusterClient
from rca_tpu_torch.coordinator import RCACoordinator
from rca_tpu_torch.serve import ServeClient, serve_selftest
engine = GraphEngine(device="cpu")
runs = [serve_selftest(n_requests=16, engine=engine),
        serve_selftest(n_requests=16, seed=3, engine=engine, chaos=True),
        serve_selftest(n_requests=16, engine=engine,
                       replica_mix="dense,sharded@2", kill_replica=True)]
with ServeClient(engine=engine) as client:
    rec = RCACoordinator(MockClusterClient(five_service_world()),
                         backend="torch", serve=client).run_analysis(
        "comprehensive", NS)
print(json.dumps({"ok": [r["ok"] for r in runs],
                  "status": rec["status"],
                  "engine": rec["results"]["correlated"]["engine"],
                  "modules": sorted(sys.modules)}))
"""


def test_serve_selftest_and_coordinator_serve_load_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _SERVE_PROBE], cwd=str(ROOT),
        capture_output=True, text=True, timeout=180, env=_probe_env(),
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["ok"] == [True, True, True]
    assert (out["status"], out["engine"]) == ("completed", "serve+single")
    for module in ("serve.loop", "serve.pool", "serve.dispatcher",
                   "serve.replica", "resilience.chaos", "parallel.sharded"):
        assert f"rca_tpu_torch.{module}" in out["modules"]
    assert [m for m in out["modules"] if _forbidden(m)] == []


_REPLAY_PROBE = """
import json, os, runpy, sys, tempfile
import numpy as np
from rca_tpu_torch import GraphEngine
from rca_tpu_torch.cluster.generator import synthetic_cascade_arrays
from rca_tpu_torch.cluster.generator import synthetic_cascade_world
from rca_tpu_torch.replay import (Recorder, bisect_divergence,
                                  mint_recording, replay_serve)
from rca_tpu_torch.resilience.chaos import run_chaos_soak
from rca_tpu_torch.serve import ServeClient, ServeLoop
tmp = tempfile.mkdtemp()
codes = []
for argv in (["stream", "--fixture", "50svc", "--ticks", "6", "--interval",
              "0", "--record", os.path.join(tmp, "stream")],
             ["replay", os.path.join(tmp, "stream"), "--compact"]):
    sys.argv = ["rca_tpu_torch", *argv, "--device", "cpu"]
    try:
        runpy.run_module("rca_tpu_torch", run_name="__main__")
    except SystemExit as exc:
        codes.append(exc.code)
soak = run_chaos_soak(
    lambda: synthetic_cascade_world(20, n_roots=1, seed=0), "synthetic",
    seed=7, ticks=30, engine_factory=lambda: GraphEngine(device="cpu"),
    record_path=os.path.join(tmp, "soak"))
minted = mint_recording(os.path.join(tmp, "soak"),
                        os.path.join(tmp, "soak.rcz"))
bisect = bisect_divergence(os.path.join(tmp, "soak.rcz"), device="cpu")
rec = Recorder(os.path.join(tmp, "serve"), mode="serve")
case = synthetic_cascade_arrays(60, n_roots=1, seed=1)
with ServeLoop(engine=GraphEngine(device="cpu"), recorder=rec) as loop:
    resps = [ServeClient(loop).submit(case.features, case.dep_src,
                                      case.dep_dst).result(60)
             for _ in range(3)]
rec.close()
served = replay_serve(os.path.join(tmp, "serve"), device="cpu")
print(json.dumps({"codes": codes, "soak": soak["replay"]["parity_ok"],
                  "minted": minted["ticks"], "bisect": bisect["divergent"],
                  "served": [served["parity_ok"],
                             served["requests_recorded"]],
                  "modules": sorted(sys.modules)}))
"""


def test_record_replay_and_chaos_load_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _REPLAY_PROBE], cwd=str(ROOT),
        capture_output=True, text=True, timeout=180, env=_probe_env(),
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["codes"] == [0, 0]
    assert out["soak"] and out["minted"] == 30 and not out["bisect"]
    assert out["served"] == [True, 3]
    for module in ("replay.format", "replay.recorder", "replay.replayer",
                   "replay.source", "resilience.chaos",
                   "observability.export"):
        assert f"rca_tpu_torch.{module}" in out["modules"]
    assert [m for m in out["modules"] if _forbidden(m)] == []


_VARIANTS_PROBE = """
import json, os, runpy, sys, tempfile
import numpy as np
from rca_tpu_torch import GraphEngine
from rca_tpu_torch.cluster.generator import synthetic_cascade_arrays
from rca_tpu_torch.engine import StreamingSession
from rca_tpu_torch.engine.train import (TrainConfig, load_params,
                                        save_params, shippability_report,
                                        train)
case = synthetic_cascade_arrays(200, n_roots=2, seed=1)
rows = {}
for row in ("quantized", "doubling"):
    os.environ["RCA_KERNEL"] = row
    engine = GraphEngine(device="cpu")
    first = engine.analyze_case(case)
    again = engine.analyze_case(case)
    lanes = engine.analyze_batch(np.stack([case.features] * 2),
                                 case.dep_src, case.dep_dst, case.names)
    stream = StreamingSession(case.names, case.dep_src, case.dep_dst,
                              num_features=13, engine=engine, k=3)
    stream.set_all(case.features)
    rows[row] = [first.top_components()[0], again.top_components()[0],
                 lanes[1].top_components()[0],
                 stream.tick()["ranked"][0]["component"],
                 stream.kernel_path]
os.environ.pop("RCA_KERNEL")
params, history = train(TrainConfig(n_services=32, n_cases=4, iters=3),
                        device="cpu")
report = shippability_report(params, trials_per_setting=1, device="cpu")
path = os.path.join(tempfile.mkdtemp(), "w.json")
save_params(params, path)
sys.argv = ["rca_tpu_torch", "train", "--services", "32", "--cases", "4",
            "--iters", "2", "--device", "cpu"]
try:
    runpy.run_module("rca_tpu_torch", run_name="__main__")
except SystemExit as exc:
    code = exc.code
print(json.dumps({"rows": rows, "losses": len(history),
                  "ships": isinstance(report["ships"], bool),
                  "loaded": load_params(path) == params, "code": code,
                  "modules": sorted(sys.modules)}))
"""


def test_variants_and_training_load_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _VARIANTS_PROBE], cwd=str(ROOT),
        capture_output=True, text=True, timeout=300,
        env={**_probe_env(), "RCA_EXPLAIN": "0"},
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for row, tops in out["rows"].items():
        assert len(set(tops[:4])) == 1, (row, tops)
        assert tops[4] == row
    assert out["losses"] == 3 and out["ships"] and out["loaded"]
    assert out["code"] == 0
    for module in ("engine.quantized", "engine.doubling", "engine.train",
                   "cli"):
        assert f"rca_tpu_torch.{module}" in out["modules"]
    assert [m for m in out["modules"] if _forbidden(m)] == []
    for name in ("optax", "orbax"):
        assert not any(m == name or m.startswith(name + ".")
                       for m in out["modules"]), name


_INVESTIGATE_PROBE = """
import json, os, runpy, sys, tempfile
import rca_tpu_torch.coordinator.hypotheses
import rca_tpu_torch.llm
import rca_tpu_torch.llm.prompts
import rca_tpu_torch.obslog
import rca_tpu_torch.store
import rca_tpu_torch.ui.render
from rca_tpu_torch import GraphEngine
from rca_tpu_torch.cluster.generator import synthetic_cascade_arrays
log_dir = tempfile.mkdtemp()
codes = []
for argv in (["chat", "--fixture", "5svc", "--investigation", "new",
              "why is the database down?"],
             ["suggest", "--fixture", "5svc",
              '{"type": "run_agent", "agent_type": "comprehensive"}'],
             ["report", "--fixture", "5svc", "--llm-agents", "--out",
              os.path.join(log_dir, "r.md")],
             ["investigations"]):
    sys.argv = ["rca_tpu_torch", *argv, "--device", "cpu", "--log-dir",
                log_dir]
    if argv[0] == "investigations":
        sys.argv = sys.argv[:2] + ["--log-dir", log_dir]
    try:
        runpy.run_module("rca_tpu_torch", run_name="__main__")
    except SystemExit as exc:
        codes.append(exc.code)
os.environ["RCA_EDGE_LAYOUT"] = "ell"
case = synthetic_cascade_arrays(200, n_roots=2, seed=1)
ell = GraphEngine(device="cpu").analyze_case(case).top_components()
print(json.dumps({"codes": codes, "ell": ell,
                  "modules": sorted(sys.modules)}))
"""


def test_investigation_layer_loads_no_jax_and_no_rca_tpu():
    proc = subprocess.run(
        [sys.executable, "-c", _INVESTIGATE_PROBE], cwd=str(ROOT),
        capture_output=True, text=True, timeout=300, env=_probe_env(),
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["codes"] == [0, 0, 0, 0]
    assert out["ell"]
    for module in ("store", "store.investigations", "llm", "llm.client",
                   "llm.providers", "llm.tools", "llm.prompts", "obslog",
                   "obslog.evidence", "obslog.prompts", "ui.render",
                   "coordinator.hypotheses", "coordinator.followups",
                   "coordinator.structured", "agents.llm_agent"):
        assert f"rca_tpu_torch.{module}" in out["modules"], module
    assert [m for m in out["modules"] if _forbidden(m)] == []
    for name in ("openai", "anthropic", "streamlit"):
        assert name not in out["modules"], name


def _probe_env():
    return {**os.environ, "RCA_EXPLAIN": "1", "RCA_KERNEL_CACHE": "off"}


_GATEWAY_PROBE = """
import json, os, runpy, signal, subprocess, sys, tempfile
import rca_tpu_torch.gateway
from rca_tpu_torch import GraphEngine
from rca_tpu_torch.cluster.clusterset import ClusterSet
from rca_tpu_torch.cluster.generator import (synthetic_cascade_arrays,
                                             synthetic_cascade_world)
from rca_tpu_torch.cluster.mock_client import MockClusterClient
from rca_tpu_torch.gateway import GatewayClient, GatewayServer, run_canary
from rca_tpu_torch.serve import ServeLoop
tmp = tempfile.mkdtemp()
case = synthetic_cascade_arrays(48, n_roots=1, seed=3)
with ServeLoop(engine=GraphEngine(device="cpu")) as loop, GatewayServer(
        loop, port=0) as gw:
    cl = GatewayClient(gw.host, gw.port, timeout_s=60)
    code, body, _ = cl.analyze(case.features, case.dep_src, case.dep_dst,
                               names=case.names, k=3)
    metrics = "rca_serve_requests_total" in cl.metrics_text()
    url = f"http://{gw.host}:{gw.port}"
    canary = run_canary(os.path.join(tmp, "c"), rounds=1, ticks=4,
                        services=12, seed=1, mode="both", serve_requests=2,
                        device="cpu")["ok"]
    wire_canary = run_canary(os.path.join(tmp, "w"), rounds=1, services=12,
                             serve_requests=2, listen_url=url,
                             device="cpu")["ok"]
    codes = []
    for argv in (["canary", "--fixture", "12svc", "--rounds", "1",
                  "--ticks", "4", "--mode", "multicluster", "--out",
                  os.path.join(tmp, "m"), "--no-store", "--device", "cpu"],
                 ["fleet", url]):
        sys.argv = ["rca_tpu_torch", *argv]
        try:
            runpy.run_module("rca_tpu_torch", run_name="__main__")
        except SystemExit as exc:
            codes.append(exc.code)
merged = ClusterSet({c: MockClusterClient(synthetic_cascade_world(
    12, n_roots=1, seed=i)) for i, c in enumerate("ab")}).merged_client()
pods = len(merged.get_pods("synthetic"))
merged.get_columnar("synthetic")
merged.close()
child = (
    "import atexit, json, runpy, sys\\n"
    "atexit.register(lambda: print(json.dumps(sorted(sys.modules)),"
    " file=sys.stderr, flush=True))\\n"
    "sys.argv = ['rca_tpu_torch', 'serve', '--listen', '127.0.0.1:0',"
    " '--device', 'cpu', '--log-dir', sys.argv[1]]\\n"
    "runpy.run_module('rca_tpu_torch', run_name='__main__')\\n")
proc = subprocess.Popen([sys.executable, "-c", child, tmp],
                        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                        text=True)
try:
    info = json.loads(proc.stdout.readline())
    host, port = info["listening"].rsplit(":", 1)
    sub_code = GatewayClient(host, int(port), timeout_s=60).analyze(
        case.features, case.dep_src, case.dep_dst, k=3)[0]
    proc.send_signal(signal.SIGTERM)
    _, err = proc.communicate(timeout=60)
finally:
    if proc.poll() is None:
        proc.kill()
print(json.dumps({"code": code, "metrics": metrics, "canary": canary,
                  "wire_canary": wire_canary, "codes": codes, "pods": pods,
                  "sub": [sub_code, proc.returncode],
                  "sub_modules": json.loads(err.strip().splitlines()[-1]),
                  "modules": sorted(sys.modules)}))
"""


def test_gateway_canary_and_clusterset_load_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _GATEWAY_PROBE], cwd=str(ROOT),
        capture_output=True, text=True, timeout=300,
        env={**_probe_env(), "RCA_EXPLAIN": "0"},
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert (out["code"], out["metrics"], out["canary"],
            out["wire_canary"]) == (200, True, True, True)
    # the multicluster canary holds; a loop's gateway has no fleet
    assert out["codes"] == [0, 1]
    assert out["pods"] > 0
    assert out["sub"] == [200, 0]
    for module in ("gateway", "gateway.server", "gateway.wire",
                   "gateway.export", "gateway.client", "gateway.canary",
                   "cluster.clusterset", "util.net", "cli"):
        assert f"rca_tpu_torch.{module}" in out["modules"], module
    for module in ("gateway.server", "util.net", "serve.loop"):
        assert f"rca_tpu_torch.{module}" in out["sub_modules"], module
    assert [m for m in out["modules"] if _forbidden(m)] == []
    assert [m for m in out["sub_modules"] if _forbidden(m)] == []


_OBSERVE_PROBE = """
import json, os, sys, tempfile
from rca_tpu_torch.analysis import run_tracecheck
from rca_tpu_torch.cluster.generator import synthetic_cascade_world
from rca_tpu_torch.cluster.mock_client import MockClusterClient
from rca_tpu_torch.coordinator import RCACoordinator
from rca_tpu_torch.engine.registry import get_registry
from rca_tpu_torch.observability.profile import profile_ticks
out_dir = sys.argv[1]
summary = profile_ticks(os.path.join(out_dir, "profile"), ticks=2,
                        services=16, device="cpu")
reg = get_registry()
cost = reg.ensure_cost(reg.resolve(64, device="cpu")).cost
gate = run_tracecheck(device="cpu")
os.environ["RCA_TORCH_PROFILE"] = out_dir
rec = RCACoordinator(MockClusterClient(synthetic_cascade_world(
    50, n_roots=1, seed=7, namespace="synthetic")), backend="torch",
    device="cpu").run_analysis("comprehensive", "synthetic")
print(json.dumps({"ticks": summary["ticks"], "basis": cost["basis"],
                  "gate": gate["ok"], "status": rec["status"],
                  "traced": sorted(os.listdir(out_dir)),
                  "modules": sorted(sys.modules)}))
"""


def test_instruments_load_no_jax_and_no_rca_tpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", _OBSERVE_PROBE, str(tmp_path)], cwd=str(ROOT),
        capture_output=True, text=True, timeout=300, env=_probe_env())
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert (out["ticks"], out["basis"], out["gate"], out["status"]) == (
        2, "model", True, "completed")
    assert out["traced"] == ["correlate", "profile"]
    for module in ("analysis.tracecheck", "observability.profile",
                   "kernels.cost"):
        assert f"rca_tpu_torch.{module}" in out["modules"]
    assert [m for m in out["modules"] if _forbidden(m)] == []


def test_port_analysis_loads_no_jax_and_no_rca_tpu():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=str(ROOT), capture_output=True,
        text=True, timeout=180, env=_probe_env(),
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(out["top"]) == 5
    assert (out["status"], out["backend"]) == ("completed", "torch")
    assert out["provenance"]
    assert out["lanes"] == [out["top"]] * 3
    assert out["rows"] >= 2
    assert "rca_tpu_torch" in out["modules"]
    assert "rca_tpu_torch.coordinator.core" in out["modules"]
    for module in ("engine.attribution", "engine.registry",
                   "observability.causelens"):
        assert f"rca_tpu_torch.{module}" in out["modules"]
    assert [m for m in out["modules"] if _forbidden(m)] == []


def test_port_cli_loads_no_jax_and_no_rca_tpu():
    proc = subprocess.run(
        [sys.executable, "-c", _CLI_PROBE], cwd=str(ROOT),
        capture_output=True, text=True, timeout=180, env=_probe_env(),
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert json.loads(lines[0])["status"] == "completed"
    assert json.loads(lines[1])["hypotheses"]
    assert json.loads(lines[2])["rows"]
    out = json.loads(lines[-1])
    assert out["codes"] == [0, 0, 0]
    assert "rca_tpu_torch.cli" in out["modules"]
    assert [m for m in out["modules"] if _forbidden(m)] == []


_WORKER_CHILD = (
    "import atexit, json, runpy, sys\n"
    "def _dump():\n"
    "    import torch\n"
    "    print(json.dumps({'modules': sorted(sys.modules),"
    " 'cuda': torch.cuda.is_initialized()}), file=sys.stderr, flush=True)\n"
    "atexit.register(_dump)\n"
    "sys.argv = ['rca_tpu_torch.serve.worker', *sys.argv[1:]]\n"
    "runpy.run_module('rca_tpu_torch.serve.worker', run_name='__main__')\n")


def test_federation_workers_of_both_roles_load_no_jax():
    from rca_tpu_torch.cluster.generator import synthetic_cascade_arrays
    from rca_tpu_torch.serve import ServeRequest
    from rca_tpu_torch.serve.federation import FederationPlane
    from rca_tpu_torch.util.procs import spawn_worker

    plane = FederationPlane(workers=2, spawn_workers=False, heartbeat_s=1.0,
                            device="cpu").start()
    procs = {}
    try:
        for wid, role in ((0, "serve"), (1, "ingest")):
            procs[role] = spawn_worker(f"iso-{role}", [
                sys.executable, "-c", _WORKER_CHILD, "--connect",
                plane.address, "--worker-id", str(wid), "--role", role,
                "--device", "cpu"])
        assert plane.wait_ready(2, timeout_s=240.0), plane.worker_table()
        case = synthetic_cascade_arrays(24, n_roots=1, seed=0)
        req = ServeRequest(tenant="t", features=case.features,
                           dep_src=case.dep_src, dep_dst=case.dep_dst,
                           names=case.names, k=3)
        plane.submit(req)
        assert req.result(120.0).ok
        plane.register_clusters({"c0": {"digest": "d0", "services": 6}})
        deadline = time.monotonic() + 120.0
        while (time.monotonic() < deadline
               and plane.ingest_status()["c0"]["ticks"] < 2):
            time.sleep(0.05)
        assert plane.ingest_status()["c0"]["ticks"] >= 2
        for wid in (0, 1):
            assert plane.drain_worker(wid)
        for proc in procs.values():
            assert proc.join(120.0) == 0
    finally:
        plane.stop()
        for proc in procs.values():
            proc.kill()
    deadline = time.monotonic() + 30.0
    dumps = {}
    while time.monotonic() < deadline and len(dumps) < 2:
        for role, proc in procs.items():
            lines = [ln for ln in proc.output()[1].splitlines()
                     if ln.startswith('{"modules"')]
            if lines:
                dumps[role] = json.loads(lines[-1])
        time.sleep(0.05)
    assert sorted(dumps) == ["ingest", "serve"]
    for role, dump in dumps.items():
        assert "rca_tpu_torch.serve.fedwire" in dump["modules"], role
        assert [m for m in dump["modules"] if _forbidden(m)] == [], role
    assert "rca_tpu_torch.serve.ingest" in dumps["ingest"]["modules"]
    assert not dumps["ingest"]["cuda"]


_AUTOSCALE_PROBE = """
import json, sys
from rca_tpu_torch.serve.autoscale import (AutoscaleController,
                                           run_scale_ramp_soak,
                                           thread_fleet_spawner)
from rca_tpu_torch.serve.federation import FederationPlane
soak = run_scale_ramp_soak(seed=0, min_workers=2, max_workers=3,
                           device="cpu")
plane = FederationPlane(workers=0, spawn_workers=False, heartbeat_s=1.0,
                        device="cpu").start()
fleet = {}
ctl = AutoscaleController(plane, min_workers=1, max_workers=2,
                          interval_s=0.05,
                          spawner=thread_fleet_spawner(plane, fleet,
                                                       device="cpu"))
try:
    ctl.start()
    ready = plane.wait_ready(1, timeout_s=60.0)
    health = plane.health()["autoscale"]
finally:
    ctl.stop()
    plane.stop()
    for tw in fleet.values():
        tw.close(5.0)
print(json.dumps({"soak": soak["ok"], "ready": ready,
                  "running": health["running"],
                  "modules": sorted(sys.modules)}))
"""


def test_elastic_fleet_loads_no_jax_and_no_rca_tpu():
    proc = subprocess.run(
        [sys.executable, "-c", _AUTOSCALE_PROBE], cwd=str(ROOT),
        capture_output=True, text=True, timeout=240, env=_probe_env(),
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["soak"] and out["ready"] and out["running"]
    assert "rca_tpu_torch.serve.autoscale" in out["modules"]
    assert [m for m in out["modules"] if _forbidden(m)] == []


_GRAFTSPEC_UI_PROBE = """
import json, runpy, sys
from rca_tpu_torch.analysis import run_lint
from rca_tpu_torch.analysis.dataplane import absint
from rca_tpu_torch.cluster.fixtures import NS, five_service_world
from rca_tpu_torch.cluster.mock_client import MockClusterClient
from rca_tpu_torch.cluster.oomchain import (OOM_NS, OOM_ROOT,
                                            measure_analyze, oom_chain_world)
from rca_tpu_torch.ui import app
lint = run_lint(rules=["dtype-discipline", "shape-contract"],
                use_baseline=False)
oom = measure_analyze(MockClusterClient(oom_chain_world(200)), OOM_NS,
                      OOM_ROOT, device="cpu")

class St:
    session_state = {}
    frames = []
    def button(self, label):
        return True
    def checkbox(self, label, value=False, key=None):
        return False
    def dataframe(self, data):
        self.frames.append(data)
    def markdown(self, text):
        pass
    def caption(self, text):
        pass

st = St()
app._render_stream_tab(st, MockClusterClient(five_service_world()), NS,
                       device="cpu")
codes = []
sys.argv = ["rca_tpu_torch", "ui", "--device", "cpu"]
try:
    runpy.run_module("rca_tpu_torch", run_name="__main__")
except SystemExit as exc:
    codes.append(exc.code)
print(json.dumps({"lint": len(lint.findings), "hit1": oom["hit1"],
                  "backend": oom["backend"],
                  "top": st.frames[0][0]["component"], "codes": codes,
                  "modules": sorted(sys.modules)}))
"""


def test_graftspec_oomchain_and_ui_load_no_jax_and_no_streamlit():
    """The two graftspec rules over the repository, the OOM chain's
    measurement, the app's Stream tab and ``ui`` (exit 1: no streamlit)
    load neither ``jax`` nor ``rca_tpu``, nor ``streamlit`` or
    ``plotly``."""
    proc = subprocess.run(
        [sys.executable, "-c", _GRAFTSPEC_UI_PROBE], cwd=str(ROOT),
        capture_output=True, text=True, timeout=240, env=_probe_env(),
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["lint"] == 0
    assert (out["hit1"], out["backend"]) == (True, "torch")
    assert out["top"] == "database"
    assert out["codes"] == [1]
    for module in ("analysis.dataplane.absint", "analysis.rules.shapecontract",
                   "analysis.rules.dtypediscipline", "cluster.oomchain",
                   "ui.app", "engine.live"):
        assert f"rca_tpu_torch.{module}" in out["modules"], module
    assert [m for m in out["modules"] if _forbidden(m)] == []
    for name in ("streamlit", "plotly"):
        assert name not in out["modules"], name


def test_thread_fleet_without_device_fails_without_cuda(no_cuda):
    """A thread fleet member, the soak and ``serve --autoscale`` without
    ``--device cpu`` raise (or exit non-zero naming CUDA) on a host
    without a card: none serves from the CPU in the card's place."""
    from rca_tpu_torch.serve.autoscale import (
        ThreadWorker,
        run_scale_ramp_soak,
    )

    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            ThreadWorker(0, "127.0.0.1", 9, device=device)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_scale_ramp_soak()
    proc = subprocess.run(
        [sys.executable, "-m", "rca_tpu_torch", "serve", "--autoscale",
         "2:3"], cwd=str(ROOT), capture_output=True, text=True, timeout=180)
    assert proc.returncode != 0 and "CUDA" in proc.stderr
    assert proc.stdout == ""


def test_serve_worker_without_device_fails_without_cuda(no_cuda):
    proc = subprocess.run(
        [sys.executable, "-m", "rca_tpu_torch.serve.worker", "--connect",
         "127.0.0.1:9", "--worker-id", "0"], cwd=str(ROOT),
        capture_output=True, text=True, timeout=180,
    )
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert '"worker"' not in proc.stdout


_LINT_PROBE = """
import contextlib, io, json, sys
from rca_tpu_torch.analysis.__main__ import main
from rca_tpu_torch.analysis.dataplane.specsan import run_specsan
out = io.StringIO()
with contextlib.redirect_stdout(out):
    code = main(["--json"])
report = run_specsan(device="cpu")
print(json.dumps({"code": code, "clean": json.loads(out.getvalue())["clean"],
                  "specsan": report["ok"], "modules": sorted(sys.modules)}))
"""


def test_lint_and_specsan_load_no_jax_and_no_rca_tpu():
    proc = subprocess.run(
        [sys.executable, "-c", _LINT_PROBE], cwd=str(ROOT),
        capture_output=True, text=True, timeout=300, env=_probe_env())
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert (out["code"], out["clean"], out["specsan"]) == (0, True, True)
    for module in ("analysis.core", "analysis.rules.ticksync",
                   "analysis.dataplane.specsan", "engine.fetch"):
        assert f"rca_tpu_torch.{module}" in out["modules"]
    assert [m for m in out["modules"] if _forbidden(m)] == []


_RSAN_PROBE = """
import contextlib, io, json, sys
from rca_tpu_torch.analysis.__main__ import main
from rca_tpu_torch.analysis.concurrency import rsan
from rca_tpu_torch.analysis.concurrency.crosscheck import run_rsan_crosscheck
out = io.StringIO()
with contextlib.redirect_stdout(out):
    code = main(["--rsan", "--json"])
soak = run_rsan_crosscheck(seed=7, soak_ticks=8, device="cpu")
print(json.dumps({"code": code, "rsan": json.loads(out.getvalue())["rsan"]["ok"],
                  "soak": soak["ok"], "ticks": soak["soak"]["ticks"],
                  "enabled": rsan.enabled(), "modules": sorted(sys.modules)}))
"""


def test_lint_rsan_and_the_sanitized_soak_load_no_jax_and_no_rca_tpu():
    env = _probe_env()
    env.pop("RCA_RSAN", None)
    proc = subprocess.run(
        [sys.executable, "-c", _RSAN_PROBE], cwd=str(ROOT),
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert (out["code"], out["rsan"], out["soak"], out["ticks"]) == (
        0, True, True, 8)
    assert out["enabled"] is False
    for module in ("analysis.concurrency.rsan", "analysis.concurrency.model",
                   "analysis.concurrency.crosscheck",
                   "analysis.rules.gravelock", "resilience.chaos"):
        assert f"rca_tpu_torch.{module}" in out["modules"]
    assert [m for m in out["modules"] if _forbidden(m)] == []


_RSAN_OFF_PROBE = """
import json, sys, threading
import numpy as np
from rca_tpu_torch import GraphEngine
from rca_tpu_torch.cluster.generator import synthetic_cascade_arrays
from rca_tpu_torch.engine import StreamingSession
from rca_tpu_torch.serve import ServeClient
from rca_tpu_torch.util.threads import make_condition, make_lock, make_rlock
case = synthetic_cascade_arrays(120, n_roots=2, seed=1)
engine = GraphEngine(device="cpu")
top = engine.analyze_case(case).top_components()
stream = StreamingSession(case.names, case.dep_src, case.dep_dst,
                          num_features=13, engine=engine, k=3)
stream.set_all(case.features)
stream.update(3, case.features[3] * 0.5)
tick = stream.fetch(stream.dispatch())
with ServeClient(engine=engine) as client:
    resp = client.analyze(case.features, case.dep_src, case.dep_dst,
                          names=case.names)
print(json.dumps({
    "top": top, "served": resp.status,
    "bare": [type(make_lock("p.l")) is type(threading.Lock()),
             type(make_rlock("p.r")) is type(threading.RLock()),
             type(make_condition("p.c")) is threading.Condition],
    "modules": sorted(sys.modules)}))
"""


def test_sanitizer_off_leaves_bare_primitives_and_no_concurrency_module():
    """``RCA_RSAN`` unset: the seam returns bare ``threading`` primitives
    and an analysis, a streaming tick and a serve request import nothing
    of the analysis plane's concurrency package."""
    env = _probe_env()
    env.pop("RCA_RSAN", None)
    proc = subprocess.run(
        [sys.executable, "-c", _RSAN_OFF_PROBE], cwd=str(ROOT),
        capture_output=True, text=True, timeout=180, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["top"] and out["served"] == "ok"
    assert out["bare"] == [True, True, True]
    assert "rca_tpu_torch.serve.loop" in out["modules"]
    assert [m for m in out["modules"]
            if m.startswith("rca_tpu_torch.analysis.concurrency")] == []
    assert [m for m in out["modules"] if _forbidden(m)] == []


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_no_jax_and_no_rca_tpu(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, node.lineno)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card rule does not "
                    "apply")


def test_engine_without_device_raises_on_a_host_without_cuda(no_cuda):
    from rca_tpu_torch import GraphEngine
    from rca_tpu_torch.entry import entry

    with pytest.raises(RuntimeError, match="CUDA"):
        GraphEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        GraphEngine(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()


def test_coordinator_and_cli_without_device_raise_on_a_host_without_cuda(
        no_cuda):
    from rca_tpu_torch.agents import AnalysisContext
    from rca_tpu_torch.cluster.fixtures import NS, five_service_world
    from rca_tpu_torch.cluster.generator import synthetic_cascade_arrays
    from rca_tpu_torch.cluster.mock_client import MockClusterClient
    from rca_tpu_torch.cluster.snapshot import ClusterSnapshot
    from rca_tpu_torch.coordinator import RCACoordinator, correlate_findings
    from rca_tpu_torch.graph.analysis import betweenness_centrality

    client = MockClusterClient(five_service_world())
    for backend in ("torch", "deterministic"):
        with pytest.raises(RuntimeError, match="CUDA"):
            RCACoordinator(client, backend=backend)
    case = synthetic_cascade_arrays(1300, n_roots=1, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        betweenness_centrality(1300, case.dep_src, case.dep_dst)
    ctx = AnalysisContext(ClusterSnapshot.capture(client, NS))
    with pytest.raises(RuntimeError, match="CUDA"):
        correlate_findings({}, ctx=ctx, backend="torch")
    proc = subprocess.run(
        [sys.executable, "-m", "rca_tpu_torch", "analyze", "--fixture",
         "5svc", "--compact"], cwd=str(ROOT), capture_output=True,
        text=True, timeout=180,
    )
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert '"status"' not in proc.stdout


@pytest.mark.parametrize("argv", [
    ["chat", "--fixture", "5svc", "hello?"],
    ["suggest", "--fixture", "5svc", '{"type": "query", "query": "x"}'],
    ["report", "--fixture", "5svc"],
])
def test_investigation_commands_without_device_fail_without_cuda(
        argv, no_cuda, tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "rca_tpu_torch", *argv, "--log-dir",
         str(tmp_path)], cwd=str(ROOT), capture_output=True, text=True,
        timeout=180,
    )
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert proc.stdout == ""


def test_streaming_without_device_raises_on_a_host_without_cuda(no_cuda):
    from rca_tpu_torch.cluster.generator import synthetic_cascade_arrays
    from rca_tpu_torch.cluster.mock_client import MockClusterClient
    from rca_tpu_torch.cluster.fixtures import NS, five_service_world
    from rca_tpu_torch.engine import LiveStreamingSession, StreamingSession

    case = synthetic_cascade_arrays(50, n_roots=1, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingSession(case.names, case.dep_src, case.dep_dst, 13)
    with pytest.raises(RuntimeError, match="CUDA"):
        LiveStreamingSession(MockClusterClient(five_service_world()), NS)
    proc = subprocess.run(
        [sys.executable, "-m", "rca_tpu_torch", "stream", "--fixture",
         "50svc", "--ticks", "1", "--interval", "0"], cwd=str(ROOT),
        capture_output=True, text=True, timeout=180,
    )
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert '"tick"' not in proc.stdout


def test_replay_and_chaos_without_device_fail_on_a_host_without_cuda(
        no_cuda):
    tape = str(ROOT / "tests" / "corpus_torch" /
               "chaos-20svc-seed11.torch.rcz")
    for argv in (["replay", tape], ["chaos", "--fixture", "20svc",
                                    "--ticks", "5"]):
        proc = subprocess.run(
            [sys.executable, "-m", "rca_tpu_torch", *argv, "--compact"],
            cwd=str(ROOT), capture_output=True, text=True, timeout=180,
        )
        assert proc.returncode != 0, argv
        assert "CUDA" in proc.stderr, argv
        assert '"parity_ok"' not in proc.stdout, argv


def test_profile_and_tracecheck_without_device_fail_without_cuda(
        no_cuda, tmp_path):
    from rca_tpu_torch.analysis import run_tracecheck
    from rca_tpu_torch.observability.profile import profile_ticks

    with pytest.raises(RuntimeError, match="CUDA"):
        profile_ticks(str(tmp_path / "p"), ticks=1, services=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_tracecheck(["engine.analyze_case"])
    proc = subprocess.run(
        [sys.executable, "-m", "rca_tpu_torch", "profile", "--out",
         str(tmp_path / "cli"), "--ticks", "1", "--services", "16"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=180)
    assert proc.returncode != 0 and "CUDA" in proc.stderr
    assert '"ticks"' not in proc.stdout


def test_engine_rejects_an_unsupported_device():
    from rca_tpu_torch import GraphEngine

    with pytest.raises(ValueError):
        GraphEngine(device="meta")


def test_entry_on_cpu_matches_the_engine():
    from rca_tpu_torch import GraphEngine
    from rca_tpu_torch.cluster.generator import synthetic_cascade_arrays
    from rca_tpu_torch.entry import entry

    fn, args = entry(device="cpu")
    assert [tuple(a.shape) for a in args] == [(2048, 13), (4096,), (4096,)]
    case = synthetic_cascade_arrays(2047, n_roots=3, seed=0)
    res = GraphEngine(device="cpu").analyze_case(case)
    score = fn(*args)
    assert np.array_equal(score[:2047].numpy(), res.score)


def test_chip_smoke_fails_without_a_card(no_cuda):
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=str(ROOT),
        capture_output=True, text=True, timeout=180,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=180,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_kernel_build_needs_nvcc(monkeypatch):
    from rca_tpu_torch.kernels import build

    monkeypatch.delenv("CUDA_HOME", raising=False)
    sources = [p.name for p in build.sources()]
    assert sources == ["evidence.cu", "front.cu", "frontshard.cu",
                       "seggrid.cu", "segpeer.cu", "segscan.cu",
                       "segshard.cu", "segstep.cu", "segsteps.cu"]
    assert build.BUILD_DIR.name == "_build"
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc is present: the missing-compiler error does not "
                    "apply")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.find_nvcc()


@pytest.mark.cuda
def test_engine_on_card_runs_the_kernels_and_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: python3 chip_smoke.py runs this path "
                    "on the card")
    from rca_tpu_torch import GraphEngine
    from rca_tpu_torch.cluster.generator import synthetic_cascade_arrays
    from rca_tpu_torch.kernels import LAUNCHES, reset_launches

    case = synthetic_cascade_arrays(2047, n_roots=3, seed=0)
    engine = GraphEngine()
    # the first analysis of a shape races the registry's rows, which
    # launches the kernels; the counted one reads the resolved row
    engine.analyze_case(case)
    reset_launches()
    got = engine.analyze_case(case)
    # the plan fuses each recursion into one launch at this size
    assert LAUNCHES == {"noisy_or_pair": 0, "segscan_sum": 0,
                        "segscan_max": 0, "seg_up_step": 0,
                        "seg_down_step": 0, "evidence_front": 0,
                        "seg_contrast_step": 0, "seg_up_steps": 1,
                        "seg_down_steps": 1, "evidence_front_fused": 1,
                        "seg_up_steps_grid": 0, "seg_down_steps_grid": 0,
                        "seg_up_steps_shard": 0, "seg_down_steps_shard": 0,
                        "evidence_front_shard": 0, "seg_up_steps_peer": 0,
                        "seg_down_steps_peer": 0}
    ref = GraphEngine(device="cpu").analyze_case(case)
    assert got.top_components() == ref.top_components()
    assert np.array_equal(got.upstream, ref.upstream)
    np.testing.assert_allclose(got.score, ref.score, rtol=1e-5, atol=1e-6)
