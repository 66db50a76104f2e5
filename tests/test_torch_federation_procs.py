"""The port's federation with REAL worker processes on the CPU
(``--device cpu``): the acceptance gates, run small.

- ``federation_selftest`` over 2 workers: every request terminal, every
  ok ranking bitwise the port's solo analysis of it in this process (the
  selftest's own parity check, worker and oracle pinned to the dense
  engine by ``RCA_SHARD=0``), and that solo analysis's top-k identical to
  the reference engine's on the same numpy inputs;
- the kill-worker gate over 3 workers: one SIGKILLed mid-wave, every
  request terminal, survivors bitwise, no double completion;
- the chaos harnesses: the federation's three process-level fault classes
  with their rejoins, and the ingest owner's death (moved, reclaimed, no
  tick applied twice);
- the CLI: ``serve --federation 2`` and ``--kill-worker``, ``ingest``,
  ``serve --autoscale 2:3`` (the ramp soak) and ``chaos --ticks 100``
  with its ``scaling_storm`` leg.

The lease timings are generous (a 1 s heartbeat where the contract does
not need a fast one): these run beside other test files on a loaded
host, and a starved heartbeat must not read as a dead worker.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

from rca_tpu.cluster.generator import synthetic_cascade_arrays as ref_cascade
from rca_tpu.engine import GraphEngine as RefEngine
from rca_tpu_torch import GraphEngine
from rca_tpu_torch.cluster.generator import synthetic_cascade_arrays
from rca_tpu_torch.serve.federation import (
    FED_FAULT_CLASSES,
    INGEST_FAULT_CLASS,
    federation_selftest,
    run_federation_chaos,
    run_ingest_chaos,
)

ROOT = Path(__file__).resolve().parent.parent


def _selftest_inputs(n_requests, seed, services):
    """The selftest's request features, rebuilt from its seed as it
    builds them."""
    cases = [synthetic_cascade_arrays(n, n_roots=1, seed=seed + i)
             for i, n in enumerate(services)]
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_requests):
        case = cases[i % len(cases)]
        feats = np.clip(case.features + rng.uniform(
            0, 0.05, case.features.shape).astype(np.float32), 0, 1)
        out.append((i % len(cases), seed + i % len(cases), feats))
    return cases, out


def test_selftest_two_workers_bitwise_solo_and_the_references_topk():
    services = (24, 48)
    out = federation_selftest(
        workers=2, n_requests=12, seed=0, services=services, device="cpu",
        heartbeat_s=1.0, ready_timeout_s=240.0, timeout_s=240.0,
    )
    assert out["ok"], out
    assert out["parity_ok"] and out["parity_checked"] >= 8
    assert out["double_completions"] == 0
    assert out["by_status"].get("shed", 0) >= out["expected_shed_min"]
    assert out["by_status"].get("error", 0) == 0
    assert sorted(out["hellos"]) == ["0", "1"]
    for hello in out["hellos"].values():
        assert hello["process_count"] == 1
        assert hello["local_devices"] is None      # CUDA never touched
        assert hello["headroom"] is None
    # the oracle the workers matched, against the reference engine
    cases, inputs = _selftest_inputs(12, 0, services)
    mine, theirs = GraphEngine(device="cpu"), RefEngine()
    for ci, case_seed, feats in inputs:
        case = cases[ci]
        ref_case = ref_cascade(services[ci], n_roots=1, seed=case_seed)
        assert np.array_equal(ref_case.features, case.features)
        got = mine.analyze_arrays(feats, case.dep_src, case.dep_dst,
                                  case.names, k=3)
        want = theirs.analyze_arrays(feats, ref_case.dep_src,
                                     ref_case.dep_dst, ref_case.names, k=3)
        assert [r["component"] for r in got.ranked] == [
            r["component"] for r in want.ranked]
        np.testing.assert_allclose(
            [r["score"] for r in got.ranked],
            [r["score"] for r in want.ranked], rtol=1e-5, atol=1e-6)


def test_kill_worker_gate():
    out = federation_selftest(
        workers=3, n_requests=18, seed=1, kill_worker=True,
        services=(24, 48), submitters=4, device="cpu", heartbeat_s=1.0,
        ready_timeout_s=240.0, timeout_s=240.0,
    )
    assert out["ok"], out
    assert out["double_completions"] == 0
    assert "process_kill" in out["fault_classes_observed"]
    assert out["parity_ok"] and out["all_resolved"]
    assert out["recovery_ms"] is not None and out["recovery_ms"] >= 0
    assert out["killed_worker"] in (0, 1, 2)
    dead = [w for w in out["worker_table"] if w["state"] == "dead"]
    assert [w["worker_id"] for w in dead] == [out["killed_worker"]]


def test_federation_chaos_observes_every_process_fault_class():
    out = run_federation_chaos(seed=7, workers=3, heartbeat_s=0.5,
                               services=24, device="cpu",
                               ready_timeout_s=240.0)
    assert out["ok"], {k: v for k, v in out.items() if k != "by_status"}
    assert set(out["fault_classes_observed"]) >= set(FED_FAULT_CLASSES)
    assert out["double_completions"] == 0 and out["all_terminal"]
    assert out["rejoins"] >= 2
    assert [p["fault"] for p in out["phases"]] == [
        "worker_hang", "coordinator_partition", "process_kill"]


def test_ingest_chaos_moves_and_reclaims_exactly_once():
    out = run_ingest_chaos(seed=17, workers=3, clusters=4, heartbeat_s=0.5,
                           ready_timeout_s=240.0)
    assert out["ok"], out
    assert out["fault_classes_observed"] == [INGEST_FAULT_CLASS]
    assert out["double_applied"] == 0
    assert out["moved_to_survivor"] and out["rejoin_reclaimed"]
    assert out["victim_clusters"]
    owners = {c["owner"] for c in out["table"].values()}
    assert None not in owners


def _cli(*argv, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "rca_tpu_torch", *argv], cwd=str(ROOT),
        capture_output=True, text=True, timeout=timeout,
    )


def test_serve_federation_cli_on_the_cpu():
    proc = _cli("serve", "--federation", "2", "--requests", "8",
                "--device", "cpu", "--compact")
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["ok"] and out["workers"] == 2 and out["requests"] == 8
    assert out["parity_ok"] and out["double_completions"] == 0


def test_serve_federation_kill_worker_cli_on_the_cpu():
    proc = _cli("serve", "--federation", "3", "--kill-worker",
                "--requests", "12", "--device", "cpu", "--compact")
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["ok"] and out["kill_worker"]
    assert "process_kill" in out["fault_classes_observed"]


def test_ingest_cli_on_the_cpu():
    proc = _cli("ingest", "--workers", "2", "--clusters", "3",
                "--duration", "2", "--compact")
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["ok"] and out["double_applied"] == 0
    assert sorted(out["clusters"]) == ["c0", "c1", "c2"]
    assert all(w["role"] == "ingest" for w in out["workers"])


def test_autoscale_modes_exit_2_naming_a14(capsys):
    """The two modes that exited 2 naming A14 now run: ``serve
    --autoscale 2:3`` the ramp soak on the CPU, and ``chaos`` from 100
    ticks, without ``--no-autoscale``, its ``scaling_storm`` leg beside
    the federation and ingest legs."""
    from rca_tpu_torch.cli import main

    assert main(["serve", "--autoscale", "2:3", "--device", "cpu",
                 "--compact"]) == 0
    soak = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert soak["ok"] and (soak["min_workers"], soak["max_workers"]) == (2, 3)
    assert soak["double_completions"] == 0 and soak["shrunk"]
    assert main(["chaos", "--fixture", "12svc", "--ticks", "100",
                 "--device", "cpu", "--compact"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    storm = report["autoscale"]
    assert storm["ok"] and storm["worker_mode"] == "thread"
    assert "scaling_storm" in storm["fault_classes_observed"]
    assert storm["double_completions"] == 0
    assert report["federation"]["ok"] and report["ingest"]["ok"]
