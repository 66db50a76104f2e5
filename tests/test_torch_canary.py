"""The port's replay canary (``rca_tpu_torch.gateway.canary``, ``python -m
rca_tpu_torch canary``) against the JAX package's.

- the current build holds parity on its own recordings, each stamped into
  the store as a replayable ``recording_ref``; sample rate 0 samples
  nothing; the merged multi-cluster leg holds parity too;
- a perturbed ``decay`` is caught at the SAME bisected tick as the
  reference's canary names on the same seed, and an independent bisect
  agrees; the CLI exits 1 on the divergence and 0 on a clean run;
- sampling through a live port gateway (token authn) mints recordings
  that replay in parity;
- recordings cross packages: a port-minted recording replays under the
  reference's replayer in rank parity (streams through its replayer,
  serve frames through its engine), and the other way round;
- candidates: ``single`` on the CPU, ``sharded`` with one device raises
  ``ShardConfigError``.
"""

import json
import os

import numpy as np
import pytest

from rca_tpu.engine import GraphEngine as RefEngine
from rca_tpu.gateway import build_candidate_engine as ref_build_candidate
from rca_tpu.gateway import run_canary as ref_run_canary
from rca_tpu.replay import load_recording as ref_load_recording
from rca_tpu.replay import replay_stream as ref_replay_stream
from rca_tpu_torch import GraphEngine
from rca_tpu_torch.engine.quantized import rank_parity
from rca_tpu_torch.engine.sharded_runner import ShardConfigError
from rca_tpu_torch.gateway import (
    GatewayServer,
    build_candidate_engine,
    run_canary,
)
from rca_tpu_torch.replay import (
    bisect_divergence,
    decode_array,
    load_recording,
    replay_stream,
)
from rca_tpu_torch.serve import ServeLoop
from rca_tpu_torch.store import InvestigationStore


@pytest.fixture(scope="module")
def engine():
    return GraphEngine(device="cpu")


@pytest.fixture(scope="module")
def minted(tmp_path_factory):
    """One ``both`` round of each package's canary on the same seed."""
    root = tmp_path_factory.mktemp("minted")
    port = run_canary(str(root / "port"), rounds=1, ticks=6, services=12,
                      seed=5, mode="both", serve_requests=4, device="cpu")
    ref = ref_run_canary(str(root / "ref"), rounds=1, ticks=6, services=12,
                         seed=5, mode="both", serve_requests=4)
    return port, ref


def test_self_parity_and_store_refs(tmp_path):
    store = InvestigationStore(root=str(tmp_path / "logs"))
    report = run_canary(
        str(tmp_path / "corpus"), rounds=1, ticks=6, services=12, seed=5,
        mode="both", store=store, serve_requests=4, device="cpu")
    assert report["ok"], report
    assert report["sampled"] == 2
    assert {r["mode"] for r in report["recordings"]} == {"stream", "serve"}
    listed = store.list_investigations()
    assert len(listed) == 2 and all(i["replayable"] for i in listed)
    for inv in listed:
        ref = store.get_recording_ref(inv["id"])
        assert ref and load_recording(ref).clean_close


def test_sample_rate_zero_samples_nothing(tmp_path):
    report = run_canary(str(tmp_path / "corpus"), rounds=3, ticks=4,
                        services=8, seed=0, sample_rate=0.0, device="cpu")
    want = ref_run_canary(str(tmp_path / "ref"), rounds=3, ticks=4,
                          services=8, seed=0, sample_rate=0.0)
    assert report["ok"] and report["sampled"] == 0
    assert report["skipped"] == want["skipped"] == 3
    # a partial rate draws the reference's rounds
    got = run_canary(str(tmp_path / "half"), rounds=4, ticks=3, services=8,
                     seed=2, sample_rate=0.5, mode="serve", serve_requests=2,
                     device="cpu")
    want = ref_run_canary(str(tmp_path / "ref-half"), rounds=4, ticks=3,
                          services=8, seed=2, sample_rate=0.5, mode="serve",
                          serve_requests=2)
    assert (got["sampled"], got["skipped"]) == (want["sampled"],
                                                want["skipped"])
    assert [os.path.basename(r["recording"]) for r in got["recordings"]] == [
        os.path.basename(r["recording"]) for r in want["recordings"]]


def test_multicluster_leg_holds_parity(tmp_path):
    report = run_canary(str(tmp_path / "corpus"), rounds=1, ticks=6,
                        services=12, seed=5, mode="multicluster",
                        device="cpu")
    assert report["ok"], report
    assert report["sampled"] == 1
    assert report["recordings"][0]["ticks"] == 6


@pytest.mark.parametrize("seed,decay", [(3, 0.5), (4, 0.45)])
def test_perturbed_decay_caught_at_the_reference_tick(tmp_path, seed, decay):
    candidate, info = build_candidate_engine(decay=decay, device="cpu")
    ref_candidate, ref_info = ref_build_candidate(decay=decay)
    assert info == ref_info == {"kind": "auto", "weights": None,
                                "param_overrides": {"decay": decay}}
    report = run_canary(str(tmp_path / "port"), rounds=1, ticks=8,
                        services=12, seed=seed, mode="stream",
                        candidate=candidate, candidate_info=info,
                        device="cpu")
    want = ref_run_canary(str(tmp_path / "ref"), rounds=1, ticks=8,
                          services=12, seed=seed, mode="stream",
                          candidate=ref_candidate, candidate_info=ref_info)
    assert not report["ok"] and not want["ok"]
    named = report["first_divergence"]["tick"]
    assert named == want["first_divergence"]["tick"]
    entry = report["recordings"][0]
    assert entry["first_divergent_tick"] == named
    assert os.path.exists(entry["dump"])
    independent = bisect_divergence(entry["recording"], engine=candidate,
                                    dump_path=str(tmp_path / "dump.json"))
    assert independent["divergent"]
    assert independent["first_divergent_tick"] == named


def test_cli_exits_nonzero_on_divergence(tmp_path, capsys):
    from rca_tpu_torch.cli import main

    rc = main(["canary", "--out", str(tmp_path / "corpus"), "--rounds", "1",
               "--ticks", "6", "--fixture", "12svc", "--seed", "4",
               "--candidate-decay", "0.45", "--log-dir",
               str(tmp_path / "logs"), "--compact", "--device", "cpu"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 1 and not report["ok"]
    assert isinstance(report["first_divergence"]["tick"], int)
    assert len(InvestigationStore(
        root=str(tmp_path / "logs")).list_investigations()) == 1
    rc = main(["canary", "--out", str(tmp_path / "corpus2"), "--rounds",
               "1", "--ticks", "6", "--fixture", "12svc", "--seed", "4",
               "--no-store", "--compact", "--device", "cpu", "--corpus",
               str(tmp_path / "corpus")])
    report = json.loads(capsys.readouterr().out)
    # the clean candidate holds parity on the new and the old recording
    assert rc == 0 and len(report["recordings"]) == 2
    with pytest.raises(SystemExit):
        main(["canary", "--fixture", "live", "--device", "cpu"])


def test_samples_through_a_live_gateway(engine, tmp_path):
    with ServeLoop(engine=engine) as loop, GatewayServer(
            loop, port=0, tokens={"can-tok": ("canary", None)}) as gw:
        report = run_canary(
            str(tmp_path / "corpus"), rounds=2, services=20, seed=0,
            serve_requests=3, k=3, listen_url=f"http://{gw.host}:{gw.port}",
            token="can-tok", device="cpu")
    assert report["ok"], report
    assert report["mode"] == "gateway" and report["sampled"] == 2
    for rec in report["recordings"]:
        assert rec["parity_ok"] and rec["mode"] == "serve"
        assert rec["requests"] == 3


def _serve_rank_parity(path, load, engine) -> bool:
    """Every serve frame of a recording re-run through ``engine``: its
    ranking in rank parity with the recorded one."""
    rec = load(path)
    assert rec.serve
    for fr in rec.serve:
        res = engine.analyze_arrays(
            decode_array(fr["features"]), decode_array(fr["dep_src"]),
            decode_array(fr["dep_dst"]), fr.get("names"), k=int(fr["k"]))
        if not rank_parity(fr["ranked"], res.ranked)["ok"]:
            return False
    return True


def test_recordings_cross_replay_in_rank_parity(minted, engine):
    port, ref = minted
    assert port["ok"] and ref["ok"]
    ref_engine = RefEngine()
    for rec in port["recordings"]:
        if rec["mode"] == "stream":
            assert ref_replay_stream(rec["recording"],
                                     parity="rank")["parity_ok"]
        else:
            assert _serve_rank_parity(rec["recording"], ref_load_recording,
                                      ref_engine)
    for rec in ref["recordings"]:
        if rec["mode"] == "stream":
            assert replay_stream(rec["recording"], parity="rank",
                                 device="cpu")["parity_ok"]
        else:
            assert _serve_rank_parity(rec["recording"], load_recording,
                                      engine)


def test_minted_recordings_carry_the_reference_inputs(minted):
    """The same seed samples the same requests in both packages: the serve
    frames' inputs are byte-equal and the stream tapes hold the same
    ticks."""
    port, ref = minted
    by_mode = {r["mode"]: r["recording"] for r in ref["recordings"]}
    for rec in port["recordings"]:
        got = load_recording(rec["recording"])
        want = ref_load_recording(by_mode[rec["mode"]])
        if rec["mode"] == "serve":
            assert len(got.serve) == len(want.serve) == 4
            for g, w in zip(got.serve, want.serve):
                for key in ("features", "dep_src", "dep_dst"):
                    assert np.array_equal(decode_array(g[key]),
                                          decode_array(w[key]))
                assert g["tenant"] == w["tenant"]
        else:
            assert sorted(got.ticks) == sorted(want.ticks)


def test_candidates(monkeypatch):
    monkeypatch.delenv("RCA_WEIGHTS", raising=False)
    assert build_candidate_engine()[0] is None
    single, info = build_candidate_engine(kind="single", impact_bonus=0.2,
                                          device="cpu")
    assert isinstance(single, GraphEngine) and str(single.device) == "cpu"
    assert single.params.impact_bonus == 0.2
    assert info["param_overrides"] == {"impact_bonus": 0.2}
    with pytest.raises(ShardConfigError, match="more than one device"):
        build_candidate_engine(kind="sharded", device="cpu")
