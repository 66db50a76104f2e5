"""The port's kernel registry, kernel plan and hybrid up-table against the
JAX package's.

- rows, sources and eligibility reasons of both variants on the CPU, the
  forcing knob ``RCA_KERNEL`` and the rows it keys;
- ``_pick_winner``'s 5% rule on fed timings, against the reference's with
  the rows mapped (``torch`` for ``xla``, ``kernels`` for ``pallas``);
- the timing path as a card takes it (the timings fed): a cache hit in a
  second registry, and a re-time on a stale header, a corrupt file or
  another card;
- ``build_ell_segments`` / ``build_up_ell`` arrays equal to the
  reference's, and the up-step over the table bitwise, its gradient at
  ties included;
- the ``kernels`` command on the CPU.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rca_tpu.cluster.generator import synthetic_cascade_arrays as ref_cascade
from rca_tpu.engine import ell as ref_ell
from rca_tpu.engine import registry as ref_registry
from rca_tpu.engine.runner import build_up_ell as ref_build_up_ell
from rca_tpu_torch import GraphEngine
from rca_tpu_torch.config import kernel_cache_path
from rca_tpu_torch.engine import ell as port_ell
from rca_tpu_torch.engine import registry
from rca_tpu_torch.engine.runner import kernel_plan

ROOT = Path(__file__).resolve().parent.parent
SIZES = [5, 50, 300, 2047]


@pytest.fixture
def fresh(monkeypatch, tmp_path):
    """A clean process registry, its cache under ``tmp_path`` and no
    forcing knob."""
    monkeypatch.delenv("RCA_KERNEL", raising=False)
    monkeypatch.setenv("RCA_KERNEL_CACHE", str(tmp_path / "cache.json"))
    registry.reset_registry()
    yield tmp_path
    registry.reset_registry()


def _edges(n):
    case = ref_cascade(n, n_roots=1, seed=n)
    return case.dep_src, case.dep_dst


@pytest.mark.parametrize("variant,winner,source,kernels,quantized,doubling", [
    ("dense", "torch", "cpu-default", True, True, True),
    ("attribution", "torch", "attribution", registry.ATTRIBUTION_DECLINE,
     "int8 messages are not differentiable",
     "frontier layouts have no per-row counterfactual twin"),
])
def test_cpu_rows_sources_and_eligibility(variant, winner, source, kernels,
                                          quantized, doubling, fresh):
    row = registry.get_registry().resolve(2048, 4096, variant=variant,
                                          device="cpu")
    assert (row.winner, row.source, row.backend) == (winner, source, "cpu")
    assert row.eligible == {"torch": True, "kernels": kernels,
                            "quantized": quantized, "doubling": doubling}
    assert row.timings_ms == {}
    assert "backward kernel" in registry.ATTRIBUTION_DECLINE
    table = registry.kernel_table()
    assert [r["variant"] for r in table] == [variant]
    assert table[0]["eligible"] == row.eligible


@pytest.mark.parametrize("forced", ["torch", "kernels"])
def test_forcing_knob_engages_its_row_and_spares_attribution(forced, fresh,
                                                             monkeypatch):
    monkeypatch.setenv("RCA_KERNEL", forced)
    reg = registry.get_registry()
    dense = reg.resolve(512, 1024, device="cpu")
    assert (dense.winner, dense.source) == (forced, "forced")
    attribution = reg.resolve(512, 1024, variant="attribution",
                              device="cpu")
    assert (attribution.winner, attribution.source) == ("torch",
                                                        "attribution")


def test_rows_are_keyed_by_the_env_knobs(fresh, monkeypatch):
    assert registry.engaged_kernel(512, 1024, device="cpu") == "torch"
    monkeypatch.setenv("RCA_KERNEL", "kernels")
    assert registry.engaged_kernel(512, 1024, device="cpu") == "kernels"
    monkeypatch.setenv("RCA_KERNEL", "torch")
    assert registry.engaged_kernel(512, 1024, device="cpu") == "torch"
    assert len(registry.kernel_table()) == 3
    monkeypatch.setenv("RCA_KERNEL", "segscan")
    with pytest.raises(ValueError, match="RCA_KERNEL"):
        registry.engaged_kernel(512, 1024, device="cpu")


@pytest.mark.parametrize("row", ["torch", "kernels"])
def test_plan_builds_the_layouts_of_its_row(row, fresh, monkeypatch):
    monkeypatch.setenv("RCA_KERNEL", row)
    src, dst = _edges(300)
    plan = kernel_plan(512, 1024, src, dst, "cpu")
    assert plan.kernel == row
    assert plan.down_seg.offsets.shape == (513,)
    assert plan.up_seg.offsets.shape == (513,)
    assert (plan.up_ell is None) == (row == "kernels")


@pytest.mark.parametrize("kernel,up_ell", [("torch", False),
                                           ("xla", True)])
def test_plan_row_decides_the_body(kernel, up_ell, fresh):
    """The body runs the row its plan names and no other: a ``torch``
    plan without its up-table, or a row the registry does not know,
    raises instead of running another row's ops."""
    src, dst = _edges(50)
    plan = kernel_plan(64, 128, src, dst, "cpu")._replace(kernel=kernel)
    if not up_ell:
        plan = plan._replace(up_ell=None)
    case = ref_cascade(50, n_roots=1, seed=1)
    engine = GraphEngine(device="cpu")
    f, _, d = engine._pad(case.features, case.dep_src, case.dep_dst)
    with pytest.raises(ValueError, match="up-table|unknown kernel row"):
        engine.model(torch.from_numpy(f), torch.from_numpy(
            d.astype(np.int64)), 50, plan)


@pytest.mark.parametrize("timings", [
    {"torch": 1.0, "kernels": 0.96},
    {"torch": 1.0, "kernels": 0.94},
    {"torch": 1.0, "kernels": 0.95},
    {"torch": 1.0, "kernels": 1.0},
    {"torch": 1.0, "kernels": 2.0},
    {"torch": None, "kernels": 0.1},
    {"torch": 1.0, "kernels": None},
    {"torch": 0.004, "kernels": 0.0037},
])
def test_pick_winner_matches_reference_5_percent_rule(timings):
    names = {"torch": "xla", "kernels": "pallas"}
    port = registry._pick_winner(timings)
    ref = ref_registry._pick_winner({names[k]: v for k, v in timings.items()})
    assert names[port] == ref
    beats = (timings["torch"] is not None and timings["kernels"] is not None
             and timings["kernels"] < 0.95 * timings["torch"])
    assert port == ("kernels" if beats else "torch")


@pytest.mark.parametrize("n_pad,e_pad", [(64, 64), (2048, 4096),
                                         (53248, 106496)])
def test_timing_harness_is_the_reference_ring(n_pad, e_pad):
    n, e, src, dst = registry._timing_harness(n_pad, e_pad)
    rn, re_, rsrc, rdst, _ = ref_registry._timing_harness(n_pad, e_pad, 8)
    assert (n, e) == (rn, re_)
    assert np.array_equal(src, rsrc) and np.array_equal(dst, rdst)


class _Card:
    """The timing path as a card takes it, with fed timings: the device
    is ``cuda`` by name only, and nothing launches."""

    def __init__(self, monkeypatch, timings, name="NVIDIA H100 80GB HBM3"):
        self.calls = 0
        self.timings = timings
        self.name = name

        def fake_time(n_pad, e_pad, steps, candidates, device):
            self.calls += 1
            assert list(candidates) == ["torch", "kernels"]
            assert device.type == "cuda"
            return dict(self.timings)

        monkeypatch.setattr(registry, "_time_candidates", fake_time)
        monkeypatch.setattr(registry, "_device_name", lambda dev: self.name)

    def resolve(self, reg=None):
        return (reg or registry.KernelRegistry()).resolve(
            2048, 4096, device="cuda")


def test_card_times_then_second_registry_reads_cache(fresh, monkeypatch):
    card = _Card(monkeypatch, {"torch": 1.0, "kernels": 0.2})
    row = card.resolve()
    assert (row.winner, row.source, card.calls) == ("kernels", "timed", 1)
    assert row.timings_ms == {"torch": 1.0, "kernels": 0.2}
    cache = json.loads((fresh / "cache.json").read_text())
    assert cache["device"] == card.name
    assert cache["torch"] == torch.__version__
    assert cache["kernel_set"] == registry.kernel_set_hash()
    again = card.resolve()
    assert (again.winner, again.source, card.calls) == ("kernels", "cache",
                                                        1)
    assert again.timings_ms == row.timings_ms


@pytest.mark.parametrize("damage", ["stale_kernel_set", "stale_torch",
                                    "corrupt", "other_card"])
def test_stale_or_corrupt_cache_re_times(damage, fresh, monkeypatch):
    card = _Card(monkeypatch, {"torch": 1.0, "kernels": 0.2})
    assert card.resolve().winner == "kernels"
    path = fresh / "cache.json"
    if damage == "corrupt":
        path.write_text("{not json")
    elif damage == "other_card":
        card.name = "NVIDIA H200"
    else:
        data = json.loads(path.read_text())
        data["kernel_set" if damage == "stale_kernel_set" else "torch"] = "x"
        path.write_text(json.dumps(data))
    card.timings = {"torch": 1.0, "kernels": 0.5}
    row = card.resolve()
    assert (row.winner, row.source, card.calls) == ("kernels", "timed", 2)
    assert json.loads(path.read_text())["rows"]["dense:2048:4096:8:cuda"][
        "timings_ms"] == card.timings


@pytest.mark.parametrize("timings", [{"torch": 1.0, "kernels": 0.96},
                                     {"torch": 1.0, "kernels": 2.0}])
def test_card_race_that_torch_wins_raises(timings, fresh, monkeypatch):
    """On the card the race never hands the dense path to plain ops:
    a ``torch`` verdict raises and is not cached."""
    card = _Card(monkeypatch, timings)
    with pytest.raises(RuntimeError, match="RCA_KERNEL=torch"):
        card.resolve()
    assert not (fresh / "cache.json").exists()
    monkeypatch.setenv("RCA_KERNEL", "torch")
    row = card.resolve()
    assert (row.winner, row.source, card.calls) == ("torch", "forced", 1)


def test_cached_torch_verdict_on_the_card_re_times(fresh, monkeypatch):
    """A cache file whose row names ``torch`` (written by hand or by
    another version) is not served: the shape re-times."""
    card = _Card(monkeypatch, {"torch": 1.0, "kernels": 0.2})
    card.resolve()
    path = fresh / "cache.json"
    data = json.loads(path.read_text())
    data["rows"]["dense:2048:4096:8:cuda"]["winner"] = "torch"
    path.write_text(json.dumps(data))
    row = card.resolve()
    assert (row.winner, row.source, card.calls) == ("kernels", "timed", 2)


def test_cache_off_writes_nothing(fresh, monkeypatch):
    monkeypatch.setenv("RCA_KERNEL_CACHE", "off")
    card = _Card(monkeypatch, {"torch": 1.0, "kernels": 0.2})
    assert card.resolve().source == "timed"
    assert card.resolve().source == "timed"
    assert card.calls == 2
    assert list(fresh.iterdir()) == []


def test_note_timing_keeps_the_minimum(fresh):
    reg = registry.get_registry()
    for ms in (5.0, 3.25, 4.0):
        reg.note_timing(64, 64, "attribution", ms, variant="attribution")
    row = reg.resolve(64, 64, variant="attribution")
    assert row.timings_ms == {"attribution": 3.25}


def test_default_cache_is_in_the_build_directory(monkeypatch):
    monkeypatch.delenv("RCA_KERNEL_CACHE", raising=False)
    path = Path(kernel_cache_path("cuda"))
    assert path.name == "kernel_cache.cuda.json"
    assert path.parent == ROOT / "rca_tpu_torch" / "_build"
    monkeypatch.setenv("RCA_KERNEL_CACHE", "none")
    assert kernel_cache_path("cuda") is None


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("direction", ["up", "down"])
@pytest.mark.parametrize("cap", [2, 8, 32])
def test_build_ell_segments_matches_reference(n, direction, cap):
    src, dst = _edges(n)
    seg, other = (src, dst) if direction == "up" else (dst, src)
    n_pad = 1 << max(6, int(n).bit_length())
    port = port_ell.build_ell_segments(seg, other, n_pad, width_cap=cap)
    ref = ref_ell.build_ell_segments(seg, other, n_pad, width_cap=cap)
    for field in ("idx", "mask", "ovf_seg", "ovf_other"):
        got, want = getattr(port, field), getattr(ref, field)
        assert got.dtype == want.dtype and np.array_equal(got, want), field
    assert port.n_overflow == ref.n_overflow


@pytest.mark.parametrize("n", SIZES)
def test_build_up_ell_matches_reference(n):
    src, dst = _edges(n)
    n_pad = 1 << max(6, int(n + 1).bit_length())
    port = port_ell.build_up_ell(n_pad, src, dst)
    ref = ref_build_up_ell(n_pad, src, dst)
    for got, want in zip(port, ref):
        want = np.asarray(want)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert port.idx.shape[1] == port_ell.UP_WIDTH_CAP
    with pytest.raises(ValueError, match="dummy"):
        port_ell.build_up_ell(n_pad, np.array([n_pad - 1]), np.array([0]))


def _hub_edges(n_pad):
    """A hub depended on by many and a dependent of 12 (past the width
    cap, so the overflow runs), over a ring."""
    ring = np.arange(n_pad - 1)
    src = np.concatenate([ring, np.full(12, 5), np.arange(20, 40)])
    dst = np.concatenate([(ring + 1) % (n_pad - 1), np.arange(30, 42),
                          np.full(20, 3)])
    return src.astype(np.int32), dst.astype(np.int32)


@pytest.mark.parametrize("ties", [False, True])
def test_ell_up_step_and_its_gradient_match_reference(ties):
    n_pad = 64
    src, dst = _hub_edges(n_pad)
    up = port_ell.build_up_ell(n_pad, src, dst)
    rng = np.random.default_rng(3)
    u, h = (rng.uniform(0, 1, n_pad).astype(np.float32) for _ in range(2))
    if ties:
        # healthy dependencies: h = u = 0 everywhere but a few rows, so the
        # max ties across the table's slots, padded ones included
        u[:] = 0.0
        h[:] = 0.0
        h[[3, 31]] = 0.5
    u[-1] = h[-1] = 0.0
    ref_up = tuple(jnp.asarray(a) for a in ref_build_up_ell(n_pad, src, dst))

    def ref_fn(uu, hh):
        return ref_ell.ell_up_step(uu, hh, 0.7, *ref_up)

    want = np.asarray(ref_fn(jnp.asarray(u), jnp.asarray(h)))
    ut = torch.from_numpy(u).requires_grad_(True)
    ht = torch.from_numpy(h).requires_grad_(True)
    got = port_ell.ell_up_step(ut, ht, 0.7, up.to("cpu"))
    assert np.array_equal(got.detach().numpy(), want)
    weights = rng.uniform(0.5, 1.5, n_pad).astype(np.float32)
    gu, gh = jax.grad(lambda a, b: jnp.sum(ref_fn(a, b) * weights),
                      argnums=(0, 1))(jnp.asarray(u), jnp.asarray(h))
    (got * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_allclose(ut.grad.numpy(), np.asarray(gu), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(gh), rtol=1e-6,
                               atol=1e-7)


def test_kernels_command_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "rca_tpu_torch", "kernels", "--device", "cpu",
         "--services", "50,2047", "--json", "--compact"], cwd=str(ROOT),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    rows = json.loads(proc.stdout)["rows"]
    assert {(r["variant"], r["n_pad"]) for r in rows} == {
        ("dense", 64), ("dense", 2048), ("attribution", 64),
        ("attribution", 2048)}
    for r in rows:
        assert r["winner"] == "torch" and r["backend"] == "cpu"
        assert r["source"] == ("cpu-default" if r["variant"] == "dense"
                               else "attribution")
    proc = subprocess.run(
        [sys.executable, "-m", "rca_tpu_torch", "kernels", "--device", "cpu",
         "--services", "500", "--explain"], cwd=str(ROOT),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "kernels  ineligible: no backward kernel" in proc.stdout
    assert "not raced (decision source: cpu-default)" in proc.stdout
