"""The port's trainer against the JAX package's.

- ``make_dataset`` byte-equal at the reference test's config, the raw
  values and the generator draws equal;
- at init, from the same raw values (``raw_from_jax``): ``_loss`` within
  rtol 1e-5 and every gradient within rtol 1e-4 / atol 1e-6 of
  ``jax.value_and_grad``, and the regularizer alone likewise;
- 5 Adam iterations against optax's adam: raw values within rtol 1e-4;
- the 60-iteration fit meets the reference test's bars (final loss below
  0.9 of the initial, hit@1 >= 0.9 and >= the defaults' less 0.1) and
  lands within 1e-5 of the reference's fitted weights (2.1e-6 measured),
  its loss history within rtol 1e-5 (7.6e-7 measured);
- ``shippability_report(default_params(), trials_per_setting=3)`` equal as
  a dict to the reference's, degenerate and channel-zeroing weights
  refused;
- the JSON checkpoint round-trips, ``RCA_WEIGHTS`` loads it, each
  package reads the other's file, a directory is refused;
- ``python -m rca_tpu_torch train`` against ``python -m rca_tpu train``.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import optax

from rca_tpu.engine import train as ref_train
from rca_tpu.engine.propagate import default_params as ref_default_params
from rca_tpu_torch import GraphEngine
from rca_tpu_torch.engine import train
from rca_tpu_torch.engine.params import default_params, raw_from_jax
from rca_tpu_torch.features.schema import SvcF

ROOT = Path(__file__).resolve().parent.parent
KW = dict(n_services=64, n_cases=16, iters=60, lr=0.05, seed=1,
          modes=("adversarial", "crashing_victims"))
CFG = train.TrainConfig(**KW)
REF_CFG = ref_train.TrainConfig(**KW)


@pytest.fixture(autouse=True)
def _no_cache(monkeypatch):
    monkeypatch.setenv("RCA_KERNEL_CACHE", "0")
    monkeypatch.delenv("RCA_KERNEL", raising=False)


@pytest.fixture(scope="module")
def fits():
    """Both packages' 60-iteration fits of the reference test's config."""
    return train.train(CFG, device="cpu"), ref_train.train(REF_CFG)


@pytest.fixture(scope="module")
def staged():
    data = train.make_dataset(CFG)
    return data, train.stage_dataset(*data, "cpu")


def _ref_raw():
    return ref_train.params_to_pytree(ref_default_params())


def _numpy(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def test_make_dataset_byte_equal_reference(staged):
    (feats, edges, roots), batch = staged
    want = ref_train.make_dataset(REF_CFG)
    for got, ref in zip((feats, edges, roots), want):
        assert got.dtype == np.asarray(ref).dtype
        assert got.shape == np.asarray(ref).shape
        assert got.tobytes() == np.asarray(ref).tobytes()
    B, S1 = feats.shape[:2]
    assert batch.feats.shape == (B, S1, feats.shape[2])
    # the union graph: every real edge of every case, none of the padding
    assert batch.down_seg.offsets[-1] == int((edges[:, 0] != S1 - 1).sum())


def test_raw_values_and_generator_draws_equal_reference():
    raw = train.params_to_raw(default_params())
    bridged = raw_from_jax(_numpy(_ref_raw()))
    for key in raw:
        assert raw[key].dtype == torch.float32
        assert torch.equal(raw[key], bridged[key]), key
    back = train.raw_to_params(raw)
    want = ref_train.pytree_to_params(_ref_raw())
    np.testing.assert_allclose(back.anomaly_weights, want.anomaly_weights,
                               rtol=1e-6)
    for name in ("decay", "explain_strength", "impact_bonus"):
        assert abs(getattr(back, name) - getattr(want, name)) < 1e-6, name
    assert abs(back.impact_bonus - 1.6) < 1e-3
    cfg = train.TrainConfig()
    a, b = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(50):
        assert (train.sample_generator_kwargs(cfg, a)
                == ref_train.sample_generator_kwargs(ref_train.TrainConfig(),
                                                     b))


@pytest.mark.parametrize("init", ["defaults", "perturbed"])
def test_loss_and_gradients_at_init_match_reference(init, staged):
    (feats, edges, roots), batch = staged
    tree = _ref_raw()
    if init == "perturbed":
        rng = np.random.default_rng(4)
        tree = {k: v + rng.normal(0, 0.5, np.shape(v)).astype(np.float32)
                for k, v in tree.items()}
    want, grads = jax.value_and_grad(ref_train._loss)(
        tree, feats, edges, roots, CFG.steps, CFG.reg_strength)
    raw = raw_from_jax(_numpy(tree))
    for value in raw.values():
        value.requires_grad_(True)
    got = train._loss(raw, batch, CFG.steps, CFG.reg_strength)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for key in raw:
        np.testing.assert_allclose(raw[key].grad.numpy(),
                                   np.asarray(grads[key]), rtol=1e-4,
                                   atol=1e-6, err_msg=key)


def test_regularizer_matches_reference():
    rng = np.random.default_rng(9)
    for _ in range(5):
        tree = {k: v + rng.normal(0, 1.5, np.shape(v)).astype(np.float32)
                for k, v in _ref_raw().items()}
        want, grads = jax.value_and_grad(ref_train._regularizer)(tree)
        raw = raw_from_jax(_numpy(tree))
        for value in raw.values():
            value.requires_grad_(True)
        got = train._regularizer(raw)
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-5, atol=1e-7)
        for key in raw:
            # mu and beta do not enter the prior: no gradient (JAX: zeros)
            grad = raw[key].grad
            grad = torch.zeros_like(raw[key]) if grad is None else grad
            np.testing.assert_allclose(grad.numpy(),
                                       np.asarray(grads[key]), rtol=1e-4,
                                       atol=1e-6)


def test_five_adam_iterations_match_optax(staged):
    (feats, edges, roots), _ = staged
    tree = _ref_raw()
    opt = optax.adam(CFG.lr)
    state = opt.init(tree)
    losses = []
    for _ in range(5):
        loss, grads = jax.value_and_grad(ref_train._loss)(
            tree, feats, edges, roots, CFG.steps, CFG.reg_strength)
        updates, state = opt.update(grads, state)
        tree = optax.apply_updates(tree, updates)
        losses.append(float(loss))
    raws = []
    _, history = train.train(dataclasses.replace(CFG, iters=5),
                             device="cpu", history_raw=raws)
    np.testing.assert_allclose(history, losses, rtol=1e-5)
    for key in tree:
        np.testing.assert_allclose(raws[-1][key], np.asarray(tree[key]),
                                   rtol=1e-4, err_msg=key)


def test_training_meets_reference_bars_and_tracks_reference_fit(fits):
    (params, history), (ref_params, ref_history) = fits
    assert history[-1] < history[0] * 0.9, history[:3] + history[-3:]
    assert all(0.0 < w < 1.0 for w in params.anomaly_weights)
    acc = train.hit_at_1(params, CFG, device="cpu")
    assert acc >= 0.9
    base = train.hit_at_1(default_params(CFG.steps), CFG, device="cpu")
    assert acc >= base - 0.1
    # the reference's fit of the same config
    np.testing.assert_allclose(history, ref_history, rtol=1e-5)
    np.testing.assert_allclose(params.anomaly_weights,
                               ref_params.anomaly_weights, atol=1e-5)
    np.testing.assert_allclose(params.hard_weights, ref_params.hard_weights,
                               atol=1e-5)
    for name in ("decay", "explain_strength", "impact_bonus"):
        assert abs(getattr(params, name) - getattr(ref_params, name)) \
            < 1e-5, name
    assert acc == ref_train.hit_at_1(ref_params, REF_CFG)


def test_default_shippability_report_equals_reference():
    got = train.shippability_report(default_params(), trials_per_setting=3,
                                    device="cpu")
    want = ref_train.shippability_report(ref_default_params(),
                                         trials_per_setting=3)
    assert got == want
    assert got["ships"] and got["fixtures"]["five_svc_ok"]


def test_shippability_gate_refuses_degenerate_weights():
    p = default_params()
    hw = list(p.hard_weights)
    hw[SvcF.CRASH] = 0.05
    degenerate = dataclasses.replace(p, decay=0.02, hard_weights=tuple(hw))
    bad = train.shippability_report(degenerate, trials_per_setting=2,
                                    device="cpu")
    assert not bad["ships"]
    assert not bad["sanity"]["decay_ok"]
    assert not bad["sanity"]["hard_crash_ok"]


def test_shippability_gate_refuses_channel_zeroing():
    p = default_params()
    aw, hw = list(p.anomaly_weights), list(p.hard_weights)
    for ch in (SvcF.IMAGE, SvcF.CONFIG, SvcF.PENDING, SvcF.OOM):
        aw[ch] = 0.02
        hw[ch] = 0.02
    zeroed = dataclasses.replace(p, anomaly_weights=tuple(aw),
                                 hard_weights=tuple(hw))
    report = train.shippability_report(zeroed, trials_per_setting=2,
                                       device="cpu")
    assert not report["fixtures"]["archetypes_ok"], report["fixtures"]
    assert not report["ships"]
    assert report["sanity"]["decay_ok"]
    assert report["sanity"]["hard_crash_ok"]


def test_json_checkpoint_round_trips_and_rca_weights_loads_it(
        tmp_path, fits, monkeypatch):
    (params, _), _ = fits
    path = str(tmp_path / "weights.json")
    train.save_params(params, path)
    loaded = train.load_params(path)
    np.testing.assert_allclose(loaded.anomaly_weights,
                               params.anomaly_weights, atol=1e-6)
    assert loaded.steps == params.steps
    assert abs(loaded.decay - params.decay) < 1e-6
    assert json.load(open(path))["format"] == "rca-weights-v1"
    monkeypatch.setenv("RCA_WEIGHTS", path)
    eng = GraphEngine(device="cpu")
    assert eng.params == loaded
    train.save_params_json(params, path, provenance={"note": "unit test"})
    assert json.load(open(path))["provenance"]["note"] == "unit test"


def test_each_package_reads_the_others_checkpoint(tmp_path, fits):
    (params, _), (ref_params, _) = fits
    ours, theirs = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    train.save_params_json(params, ours, provenance={"by": "port"})
    ref_train.save_params_json(ref_params, theirs, provenance={"by": "ref"})
    got = train.load_params(theirs)
    want = ref_train.load_params_json(theirs)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    back = ref_train.load_params_json(ours)
    assert dataclasses.asdict(back) == dataclasses.asdict(
        train.load_params_json(ours))
    # the same params write the same bytes in both packages
    ref_train.save_params_json(ref_params, theirs)
    train.save_params_json(ref_params, ours)
    assert open(ours).read() == open(theirs).read()


def test_load_params_refuses_a_directory(tmp_path):
    with pytest.raises(ValueError, match="rca-weights-v1"):
        train.load_params(str(tmp_path))


def _cli(module, out, tmp_path):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "RCA_KERNEL_CACHE": "0"}
    argv = [sys.executable, "-m", module, "train", "--services", "64",
            "--cases", "8", "--iters", "10", "--out", out]
    if module == "rca_tpu_torch":
        argv += ["--device", "cpu"]
    return subprocess.run(argv, cwd=str(tmp_path), capture_output=True,
                          text=True, timeout=600, env={
                              **env, "PYTHONPATH": str(ROOT)})


def test_train_cli_matches_reference_cli(tmp_path):
    port = _cli("rca_tpu_torch", str(tmp_path / "port.json"), tmp_path)
    ref = _cli("rca_tpu", str(tmp_path / "ref_ckpt"), tmp_path)
    assert port.returncode == ref.returncode, (port.stderr, ref.stderr)
    got = json.loads(port.stdout.strip().splitlines()[-1])
    want = json.loads(ref.stdout.strip().splitlines()[-1])
    assert set(got) == set(want)
    assert got["shippability"] == want["shippability"]
    assert got["holdout_hit_at_1"] == want["holdout_hit_at_1"]
    for key in ("final_loss", "initial_loss", "decay", "explain_strength",
                "impact_bonus"):
        assert abs(got[key] - want[key]) <= 2e-4, key
    assert (got["checkpoint"] is None) == (want["checkpoint"] is None)
    assert ("refusing to save" in port.stderr) == (
        "refusing to save" in ref.stderr)
