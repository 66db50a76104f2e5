"""The port's chaos layer (``rca_tpu_torch.resilience.chaos``) against the
JAX package's.

- ``ChaosClusterClient``: over twin worlds with the same seed and the same
  call sequence, the port's and the reference's wrappers inject the same
  faults (``drain_injected`` lists equal, the same exceptions, the same
  payloads, NaN/Inf where the reference poisons); disabled, it is a pure
  proxy; it hides the columnar feed;
- ``run_chaos_soak`` over a 20-service world for 60 ticks: the same
  ``faults_injected`` counts and resilience counters as the reference's
  soak (exact), no uncaught exception, fault-free ticks bitwise the
  baseline, and with a recorder the replay leg in parity;
- ``python -m rca_tpu_torch chaos``: exit 0 when the contract holds, at
  ``--ticks`` >= 100 with the federation, ``scaling_storm`` and ingest
  legs (A14) or with ``--no-federation`` without them, and
  ``RCA_CHAOS_SEED`` parsed as the reference parses it.
"""

import json
import math

import pytest

from rca_tpu.cluster.generator import synthetic_cascade_world as ref_world
from rca_tpu.cluster.mock_client import MockClusterClient as RefClient
from rca_tpu.config import env_int as ref_env_int
from rca_tpu.engine import GraphEngine as RefEngine
from rca_tpu.resilience.chaos import ChaosClusterClient as RefChaos
from rca_tpu.resilience.chaos import ChaosConfig as RefChaosConfig
from rca_tpu.resilience.chaos import run_chaos_soak as ref_run_chaos_soak
from rca_tpu_torch.cluster.generator import synthetic_cascade_world
from rca_tpu_torch.cluster.mock_client import MockClusterClient
from rca_tpu_torch.config import chaos_seed
from rca_tpu_torch.engine import GraphEngine
from rca_tpu_torch.replay import load_recording
from rca_tpu_torch.resilience.chaos import (
    FAULT_CLASSES,
    ChaosClusterClient,
    ChaosConfig,
    InjectedTimeout,
    run_chaos_soak,
)

#: the soak summary keys both packages must agree on exactly
SOAK_KEYS = ("faults_injected", "fault_classes_observed",
             "all_classes_observed", "uncaught_exceptions", "degraded_ticks",
             "sanitized_rows_total", "final_degradation", "resyncs_expired",
             "resyncs_topology", "parity_ticks_checked", "parity_ok")


@pytest.fixture(autouse=True)
def _no_kernel_cache(monkeypatch):
    monkeypatch.setenv("RCA_KERNEL_CACHE", "off")
    monkeypatch.delenv("RCA_KERNEL", raising=False)


def _call_sequence(client, ns, rounds, drain=True):
    """A fixed call sequence over the intercepted surfaces; each answer
    (or exception) is recorded as JSON text (NaN-aware), and after each
    round the drained injections."""
    out = []
    cursor = client.watch_changes(ns, None).get("cursor")
    for _ in range(rounds):
        for name, args in (("get_pods", (ns,)), ("get_events", (ns,)),
                           ("get_pod_metrics", (ns,)),
                           ("watch_changes", (ns, cursor)),
                           ("get_services", (ns,))):
            try:
                out.append(json.dumps(getattr(client, name)(*args),
                                      sort_keys=True, default=str))
            except TimeoutError as exc:   # either package's InjectedTimeout
                out.append(f"{type(exc).__name__}: {exc}")
        if drain:
            out.append(client.drain_injected())
    return out


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_chaos_client_injects_as_the_reference(seed):
    ns = "synthetic"
    port = ChaosClusterClient(
        MockClusterClient(synthetic_cascade_world(20, n_roots=1, seed=0)),
        ChaosConfig(seed=seed))
    ref = RefChaos(RefClient(ref_world(20, n_roots=1, seed=0)),
                   RefChaosConfig(seed=seed))
    got = _call_sequence(port, ns, 80)
    want = _call_sequence(ref, ns, 80)
    assert got == want
    drained = [f["fault"] for entry in got if isinstance(entry, list)
               for f in entry]
    assert set(drained) <= set(FAULT_CLASSES) and len(set(drained)) >= 4
    poisoned = [json.loads(e) for e in got
                if isinstance(e, str) and e.startswith('{"pods"')]
    values = [rec["cpu"]["usage_percentage"] for m in poisoned
              for rec in m["pods"].values()]
    assert any(math.isnan(v) for v in values)
    assert any(math.isinf(v) for v in values)


def test_disabled_chaos_client_is_a_pure_proxy():
    inner = MockClusterClient(synthetic_cascade_world(20, n_roots=1, seed=0))
    proxy = ChaosClusterClient(
        MockClusterClient(synthetic_cascade_world(20, n_roots=1, seed=0)),
        ChaosConfig(seed=3, enabled=False))
    assert _call_sequence(proxy, "synthetic", 10, drain=False) == \
        _call_sequence(inner, "synthetic", 10, drain=False)
    assert proxy.drain_injected() == []
    assert not hasattr(proxy, "get_columnar")
    assert callable(getattr(inner, "get_columnar"))


def _soak_world(seed):
    return lambda: synthetic_cascade_world(20, n_roots=1, seed=seed)


def _ref_soak_world(seed):
    return lambda: ref_world(20, n_roots=1, seed=seed)


@pytest.mark.parametrize("seed", [7, 11])
def test_soak_matches_the_reference_and_replays(seed, tmp_path):
    path = str(tmp_path / "soak")
    got = run_chaos_soak(
        _soak_world(0), "synthetic", seed=seed, ticks=60,
        engine_factory=lambda: GraphEngine(device="cpu"),
        record_path=path)
    want = ref_run_chaos_soak(_ref_soak_world(0), "synthetic", seed=seed,
                              ticks=60, engine_factory=RefEngine,
                              replay_check=False)
    assert {k: got[k] for k in SOAK_KEYS} == {k: want[k] for k in SOAK_KEYS}
    assert got["uncaught_exceptions"] == 0 and got["parity_ok"]
    assert got["parity_ticks_checked"] > 10
    assert got["kernel_paths"] == {"torch": 60}
    assert sum(got["faults_injected"].values()) > 10
    replay = got["replay"]
    assert replay["parity_ok"] and replay["ticks_replayed"] == 60
    assert replay["unconsumed_calls"] == 0
    assert replay["kernel_paths"] == {"torch": 60}
    scope = got["kernelscope"]
    assert scope["recompiles_post_warm"] == 0 and scope["memory_gate"]["ok"]
    rec = load_recording(path)
    assert rec.header["seeds"] == {"chaos_seed": seed}
    assert rec.header["meta"] == {"harness": "chaos_soak", "ticks": 60}


def test_soak_rank_parity_mode_and_bad_mode():
    got = run_chaos_soak(
        _soak_world(1), "synthetic", seed=3, ticks=20,
        engine_factory=lambda: GraphEngine(device="cpu"),
        parity_mode="rank")
    assert got["parity_mode"] == "rank" and got["parity_ok"]
    with pytest.raises(ValueError, match="parity_mode"):
        run_chaos_soak(_soak_world(1), "synthetic", ticks=1,
                       engine_factory=lambda: GraphEngine(device="cpu"),
                       parity_mode="bits")


def test_chaos_cli_exit_codes(tmp_path, capsys):
    from rca_tpu_torch.cli import main

    rec = str(tmp_path / "rec")
    assert main(["chaos", "--fixture", "20svc", "--ticks", "30",
                 "--record", rec, "--device", "cpu", "--compact"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["seed"] == 7 and summary["replay"]["parity_ok"]
    assert main(["replay", rec, "--device", "cpu", "--compact"]) == 0
    capsys.readouterr()
    # from 100 ticks the process-level legs run, the scaling_storm leg
    # (A14) among them
    assert main(["chaos", "--fixture", "20svc", "--ticks", "100",
                 "--device", "cpu", "--compact"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["autoscale"]["ok"] and "scaling_storm" in summary[
        "autoscale"]["fault_classes_observed"]
    assert summary["federation"]["ok"] and summary["ingest"]["ok"]
    assert main(["chaos", "--fixture", "20svc", "--ticks", "100",
                 "--no-federation", "--seed", "11", "--device", "cpu",
                 "--compact"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["all_classes_observed"] and summary["seed"] == 11
    with pytest.raises(SystemExit, match="synthetic fixture"):
        main(["chaos", "--fixture", "live", "--device", "cpu"])


@pytest.mark.parametrize("raw", [None, "", "0", "11", " 42 ", "2147483647"])
def test_chaos_seed_env_parses_as_the_reference(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("RCA_CHAOS_SEED", raising=False)
    else:
        monkeypatch.setenv("RCA_CHAOS_SEED", raw)
    assert chaos_seed() == ref_env_int("RCA_CHAOS_SEED", 7, 0, 2**31 - 1)


@pytest.mark.parametrize("raw", ["x", "-1", "2147483648", "1.5"])
def test_chaos_seed_env_rejects_as_the_reference(monkeypatch, raw):
    monkeypatch.setenv("RCA_CHAOS_SEED", raw)
    with pytest.raises(ValueError, match="RCA_CHAOS_SEED"):
        chaos_seed()
    with pytest.raises(ValueError, match="RCA_CHAOS_SEED"):
        ref_env_int("RCA_CHAOS_SEED", 7, 0, 2**31 - 1)


def test_chaos_cli_reads_the_seed_from_the_env(monkeypatch, capsys):
    from rca_tpu_torch.cli import main

    monkeypatch.setenv("RCA_CHAOS_SEED", "5")
    assert main(["chaos", "--fixture", "20svc", "--ticks", "10",
                 "--device", "cpu", "--compact"]) == 0
    assert json.loads(capsys.readouterr().out)["seed"] == 5
