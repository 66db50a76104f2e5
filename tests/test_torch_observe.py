"""The port's instruments against the JAX package's: recompile windows that
close, the registry's cost capture, the ``kernels`` cost columns, the
``/metrics`` cost families, ``profile`` on ``torch.profiler`` and the
correlate stage's ``RCA_TORCH_PROFILE`` trace.

- ``RecompileMonitor.stop`` / ``with`` close the window: the snapshot is
  the reference's closed form key for key, a later ``start`` opens a
  fresh window, ``RCA_KERNELSCOPE=0`` is a no-op, and a stopped
  ``ServeLoop`` / ``ServePool`` reports the closed window;
- ``ensure_cost`` on the CPU: the model's ``flops`` / ``bytes_accessed``
  (``basis: "model"``), the counted ``output_bytes``, a
  ``memory_unavailable`` reason; the cap leaves a big row uncosted as the
  reference's does; the cost persists through the cache file; a winner
  that cannot run is reported, never replaced; ``kernels`` carries the
  columns and the JSON key; a ``/metrics`` render samples the families
  and captures nothing;
- ``kernels/cost.py`` gives PERF.md's bounds to the digits printed there;
- ``profile_ticks`` against the reference's (ticks, services, the padded
  shape, spans), its Chrome trace, profiled polls ranking bitwise as
  unprofiled ones, the ``profile`` command;
- ``RCA_TORCH_PROFILE``: a trace under ``correlate/``, findings JSON
  identical to the run without it and to the reference's.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rca_tpu.cluster.generator import synthetic_cascade_world as ref_world
from rca_tpu.cluster.mock_client import MockClusterClient as RefClient
from rca_tpu.coordinator import RCACoordinator as RefCoordinator
from rca_tpu.engine import registry as ref_registry
from rca_tpu.observability.kernelscope import (
    RecompileMonitor as RefMonitor,
)
from rca_tpu.observability.profile import profile_ticks as ref_profile_ticks
from rca_tpu.observability.spans import Tracer as RefTracer
from rca_tpu.observability.spans import profiling_active as ref_profiling
from rca_tpu_torch import GraphEngine
from rca_tpu_torch.cli import main as cli_main
from rca_tpu_torch.cluster.generator import (
    synthetic_cascade_arrays,
    synthetic_cascade_world,
)
from rca_tpu_torch.cluster.mock_client import MockClusterClient
from rca_tpu_torch.config import ServeConfig
from rca_tpu_torch.coordinator import RCACoordinator
from rca_tpu_torch.engine import registry
from rca_tpu_torch.engine.segscan import build_seg_layouts
from rca_tpu_torch.gateway.export import render_metrics_text
from rca_tpu_torch.kernels import LAUNCHES, cost
from rca_tpu_torch.observability.kernelscope import (
    RecompileMonitor,
    note_compile,
)
from rca_tpu_torch.observability.profile import profile_ticks
from rca_tpu_torch.observability.spans import Tracer, profiling_active
from rca_tpu_torch.serve import ServeClient, ServeLoop, ServePool

ROOT = Path(__file__).resolve().parent.parent
WAIT_S = 60.0
CLOSED = {"enabled": False, "compiles": 0, "recompiles": 0,
          "recompiles_post_warm": 0, "recompiled": []}


@pytest.fixture
def fresh(monkeypatch, tmp_path):
    """A clean process registry (the port's and the reference's), the
    port's cache under ``tmp_path`` and no forcing knob."""
    monkeypatch.delenv("RCA_KERNEL", raising=False)
    monkeypatch.setenv("RCA_KERNEL_CACHE", str(tmp_path / "cache.json"))
    registry.reset_registry()
    ref_registry.reset_registry()
    yield tmp_path
    registry.reset_registry()
    ref_registry.reset_registry()


# -- recompile windows ----------------------------------------------------

def test_stop_and_with_close_the_window_as_the_reference():
    ref = RefMonitor(enabled=True).start()
    ref.stop()
    assert ref.snapshot() == CLOSED
    monitor = RecompileMonitor(enabled=True).start()
    note_compile("probe", ("observe", "stop"))
    assert monitor.snapshot()["enabled"] is True
    assert monitor.snapshot()["compiles"] == 1
    monitor.stop()
    assert monitor.snapshot() == ref.snapshot()
    with RecompileMonitor(enabled=True) as scoped:
        note_compile("probe", ("observe", "with"))
        assert scoped.snapshot()["compiles"] == 1
    assert scoped.snapshot() == CLOSED
    with RefMonitor(enabled=True) as ref_scoped:
        pass
    assert ref_scoped.snapshot() == scoped.snapshot()


def test_start_after_stop_opens_a_fresh_window():
    monitor = RecompileMonitor(enabled=True).start()
    note_compile("probe", ("observe", "fresh"))
    monitor.mark_warm()
    note_compile("probe", ("observe", "fresh"))
    snap = monitor.snapshot()
    assert (snap["compiles"], snap["recompiles"],
            snap["recompiles_post_warm"]) == (2, 1, 1)
    monitor.stop()
    monitor.start()
    assert monitor.snapshot() == {**CLOSED, "enabled": True}
    # a signature compiled in the old window is no recompile in the new
    note_compile("probe", ("observe", "fresh"))
    snap = monitor.snapshot()
    assert (snap["compiles"], snap["recompiles"]) == (1, 0)
    monitor.stop()


def test_kernelscope_off_is_a_no_op(monkeypatch):
    monkeypatch.setenv("RCA_KERNELSCOPE", "0")
    monitor = RecompileMonitor()
    assert monitor.enabled is False
    with monitor as m:
        note_compile("probe", ("observe", "off"))
        assert m.snapshot() == CLOSED
    monitor.start()
    monitor.mark_warm()
    assert monitor.snapshot() == CLOSED
    monitor.stop()
    assert monitor.snapshot() == CLOSED


def _serve_one(plane, case):
    req = ServeClient(plane).submit(case.features, case.dep_src,
                                    case.dep_dst, names=case.names, k=3)
    assert req.result(WAIT_S).status == "ok"


@pytest.mark.parametrize("kind", ["loop", "pool"])
def test_stopped_serve_plane_reports_the_closed_window(kind, fresh):
    case = synthetic_cascade_arrays(40, n_roots=1, seed=3)
    if kind == "loop":
        plane = ServeLoop(engine=GraphEngine(device="cpu"))
    else:
        plane = ServePool(engines=[GraphEngine(device="cpu"),
                                   GraphEngine(device="cpu")],
                          config=ServeConfig(replicas=2))
    with plane:
        _serve_one(plane, case)
        open_scope = plane.kernelscope_summary()
    assert open_scope["enabled"] is True and open_scope["recompiles"] == 0
    assert open_scope["compiles"] >= 1          # the shape's election
    assert plane.recompile_monitor.snapshot() == CLOSED
    closed = plane.kernelscope_summary()
    assert {key: closed[key] for key in CLOSED} == CLOSED
    assert closed["device_memory"] is None


# -- the registry's cost ----------------------------------------------------

def test_ensure_cost_on_the_cpu(fresh):
    reg = registry.get_registry()
    row = reg.ensure_cost(reg.resolve(64, device="cpu"))
    c = row.cost
    assert c["basis"] == "model" and c["kernel"] == "torch"
    assert c["flops"] > 0 and c["bytes_accessed"] > 0
    assert c["output_bytes"] > 0 and c["argument_bytes"] > 0
    assert "peak_temp_bytes" not in c
    assert c["memory_unavailable"] == registry.CPU_MEMORY_UNAVAILABLE
    # k as the reference's canonical executable takes it
    assert c["k"] == min(13, 64)
    # the totals are the model's stages, read by the bounds too
    stages = cost.propagation(64, 64, *c["n_long"], k=13)
    assert c["stages"] == {k: list(v) for k, v in stages.items()}
    assert c["bytes_accessed"] == sum(b for b, _ in stages.values())
    assert c["flops"] == sum(o for _, o in stages.values())
    # outputs: the [4, n_pad] stack, the [4, k] gather, k values, k int64
    # ids and the count
    assert c["output_bytes"] == 4 * 64 * 4 + 4 * 13 * 4 + 13 * 4 + 13 * 8 + 4
    # the model does not depend on the row that does the work
    forced = registry._capture_cost(64, 64, "kernels", 8, "cpu")
    assert {k: forced[k] for k in ("flops", "bytes_accessed", "stages")} == \
        {k: c[k] for k in ("flops", "bytes_accessed", "stages")}
    assert row.to_dict()["cost"] == c


def test_cost_cap_leaves_big_rows_uncosted_as_the_reference(fresh):
    reg = registry.get_registry()
    reg.resolve(64, device="cpu")
    reg.resolve(8192, device="cpu")
    rows = {r["n_pad"]: r for r in reg.table(ensure_cost=True,
                                             cost_max_pad=128)}
    ref = ref_registry.get_registry()
    ref.resolve(64)
    ref.resolve(8192)
    ref_rows = {r["n_pad"]: r for r in ref.table(ensure_cost=True,
                                                 cost_max_pad=128)}
    assert rows[64]["cost"] is not None and rows[8192]["cost"] is None
    assert {n: r["cost"] is None for n, r in rows.items()} == \
        {n: r["cost"] is None for n, r in ref_rows.items()}
    # a scrape-side read never captures
    assert registry.kernel_table()[-1]["cost"] is None


class _Card:
    """A timed row as a card elects it, with fed timings and a fed cost:
    the device is ``cuda`` by name only, and nothing launches."""

    def __init__(self, monkeypatch):
        self.captures = 0

        def fake_time(n_pad, e_pad, steps, candidates, device):
            return {"torch": 1.0, "kernels": 0.2}

        def fake_cost(n_pad, e_pad, winner, steps, device):
            self.captures += 1
            return {"kernel": winner, "basis": "model", "flops": 1.0,
                    "bytes_accessed": 2.0, "peak_temp_bytes": 3,
                    "output_bytes": 4}

        monkeypatch.setattr(registry, "_time_candidates", fake_time)
        monkeypatch.setattr(registry, "_capture_cost", fake_cost)
        monkeypatch.setattr(registry, "_device_name",
                            lambda dev: "NVIDIA H100 80GB HBM3")


def test_cost_persists_through_the_cache_file(fresh, monkeypatch):
    card = _Card(monkeypatch)
    row = registry.KernelRegistry().resolve(2048, 4096, device="cuda")
    assert (row.source, row.cost) == ("timed", None)
    registry.get_registry().ensure_cost(row)
    assert card.captures == 1
    cached = json.loads((fresh / "cache.json").read_text())
    assert cached["rows"]["dense:2048:4096:8:cuda"]["cost"] == row.cost
    again = registry.KernelRegistry().resolve(2048, 4096, device="cuda")
    assert again.source == "cache" and again.cost == row.cost
    registry.get_registry().ensure_cost(again)
    assert card.captures == 1


def test_a_winner_that_cannot_run_is_reported_not_replaced(monkeypatch):
    from rca_tpu_torch.engine import propagate as port_propagate

    def refused(*args, **kwargs):
        raise RuntimeError("kernel launch refused")

    monkeypatch.setattr(port_propagate, "propagate", refused)
    out = registry._capture_cost(64, 64, "kernels", 8, "cpu")
    assert out == {"unavailable": "run: RuntimeError: kernel launch refused"}


def test_kernels_command_carries_the_cost(fresh, capsys):
    assert cli_main(["kernels", "--device", "cpu", "--services", "50",
                     "--json", "--compact"]) == 0
    rows = json.loads(capsys.readouterr().out)["rows"]
    assert {(r["variant"], r["n_pad"]) for r in rows} == {
        ("dense", 64), ("attribution", 64)}
    for r in rows:
        c = r["cost"]
        assert c["basis"] == "model" and c["output_bytes"] > 0
        assert c["flops"] > 0 and c["bytes_accessed"] > 0
        assert "memory_unavailable" in c
    registry.reset_registry()
    assert cli_main(["kernels", "--device", "cpu", "--services", "50",
                     "--json", "--no-cost"]) == 0
    assert all(r["cost"] is None
               for r in json.loads(capsys.readouterr().out)["rows"])
    registry.reset_registry()
    assert cli_main(["kernels", "--device", "cpu", "--services", "2047",
                     "--cost-max-pad", "1024"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split() == [
        "n_pad", "e_pad", "variant", "backend", "winner", "source",
        "layout", "t_torch_ms", "t_win_ms", "flops", "bytes", "peak_temp",
        "output"]
    # 2048 is above the cap: no cost columns filled
    assert lines[2].split()[-4:] == ["-", "-", "-", "-"]


def test_metrics_samples_the_cost_families_and_captures_nothing(fresh):
    case = synthetic_cascade_arrays(40, n_roots=1, seed=3)
    with ServeLoop(engine=GraphEngine(device="cpu")) as loop:
        _serve_one(loop, case)
        before = render_metrics_text(loop.metrics.summary(),
                                     kernelscope=loop.kernelscope_summary())
        assert registry.kernel_table()[0]["cost"] is None
        registry.kernel_table(ensure_cost=True)
        after = render_metrics_text(loop.metrics.summary(),
                                    kernelscope=loop.kernelscope_summary())
        # a CUDA row's capture carries the allocator's peak
        f, src, _ = GraphEngine(device="cpu")._pad(
            case.features, case.dep_src, case.dep_dst)
        row = registry.get_registry().resolve(f.shape[0], len(src),
                                              device="cpu")
        row.cost = {**row.cost, "peak_temp_bytes": 4096}
        card = render_metrics_text(loop.metrics.summary(),
                                   kernelscope=loop.kernelscope_summary())
    families = ("rca_kernel_cost_flops", "rca_kernel_cost_bytes_accessed",
                "rca_kernel_peak_temp_bytes")

    def samples(text):
        return {f: [line for line in text.splitlines()
                    if line.startswith(f + "{")] for f in families}

    assert all(not lines for lines in samples(before).values())
    got = samples(after)
    assert got["rca_kernel_cost_flops"] and \
        got["rca_kernel_cost_bytes_accessed"]
    assert not got["rca_kernel_peak_temp_bytes"]    # the CPU has no peak
    assert [line.split(" ")[1] for line in
            samples(card)["rca_kernel_peak_temp_bytes"]] == ["4096"]
    assert "absent until captured" in after


# -- the model gives PERF.md's bounds ----------------------------------------

#: the long segments of the tiers' layouts (up, down): at 2047 checked
#: below; at 49,999 those of ``synthetic_cascade_arrays(49999, n_roots=3,
#: seed=0)``'s layouts (``n_pad`` 53,248, ``e_pad`` 106,496), too big to
#: build in these tests
LONG_49999 = (1, 877)
TIERS = {2047: (2048, 4096), 49999: (53248, 106496)}


def test_tier_long_segments_at_2047():
    case = synthetic_cascade_arrays(2047, n_roots=3, seed=0)
    down, up = build_seg_layouts(2048, 4096, case.dep_src, case.dep_dst)
    assert (len(up.long_ids), len(down.long_ids)) == (0, 38)


def _work(name, n_pad, e_pad, long_up, long_down, lanes):
    return {
        "front": lambda: cost.front(n_pad, e_pad, lanes),
        "front_rows": lambda: cost.front_rows(n_pad, lanes),
        "contrast": lambda: cost.contrast(n_pad, e_pad, lanes),
        "noisy_or_pair": lambda: cost.noisy_or_pair(n_pad),
        "up_steps": lambda: cost.up_steps(n_pad, e_pad, long_up, lanes),
        "down_steps": lambda: cost.down_steps(n_pad, e_pad, long_down,
                                              lanes),
        "up_step": lambda: cost.up_step(n_pad, e_pad, lanes),
        "down_step": lambda: cost.down_step(n_pad, e_pad, lanes),
        "segscan": lambda: cost.segscan(e_pad),
    }[name]()


# (work, lanes, PERF.md's bound at 2047, at 49,999), as printed there
PERF_BOUNDS = [
    ("front", 1, "0.0000465", "0.001208"),
    ("front", 2, None, "0.00216"),
    ("front", 4, None, "0.00407"),
    ("front", 16, None, "0.01551"),
    ("front_rows", 1, "0.0000392", "0.001017"),
    ("front_rows", 8, "0.000313", "0.008138"),
    ("front_rows", 16, "0.000626", "0.0163"),
    ("contrast", 1, "0.0000147", "0.000381"),
    ("contrast", 8, "0.0000660", "0.001717"),
    ("contrast", 16, "0.000125", "0.00324"),
    ("noisy_or_pair", 1, "0.0000367", "0.000954"),
    ("down_steps", 1, "0.0000147", "0.000383"),
    ("up_steps", 1, "0.0000122", "0.000318"),
    ("down_step", 1, "0.0000171", "0.000445"),
    ("down_step", 8, "0.0000685", "0.001780"),
    ("down_step", 16, "0.000127", "0.00331"),
    ("up_step", 1, "0.0000147", "0.000381"),
    ("up_step", 8, "0.0000660", "0.001717"),
    ("up_step", 16, "0.000125", "0.00324"),
    ("segscan", 1, "0.0000147", "0.000381"),
]


@pytest.mark.parametrize("work,lanes,at_2047,at_49999", PERF_BOUNDS)
def test_cost_model_gives_the_perf_bounds(work, lanes, at_2047, at_49999):
    for services, printed in ((2047, at_2047), (49999, at_49999)):
        if printed is None:
            continue
        long_up, long_down = (0, 38) if services == 2047 else LONG_49999
        ms, by = cost.bound_ms(*_work(work, *TIERS[services], long_up,
                                      long_down, lanes))
        decimals = len(printed.split(".")[1])
        assert by == "bytes"
        assert round(ms, decimals) == float(printed), (work, services, ms)


# -- profile ------------------------------------------------------------------

_SUMMARY_KEYS = {"ticks", "services", "trace_dir", "wall_ms", "ms_per_tick",
                 "kernel_by_shape", "spans_recorded", "profile_files"}


def _trace(out_dir):
    files = [f for f in os.listdir(out_dir) if f.endswith(".json")]
    assert len(files) == 1
    with open(os.path.join(out_dir, files[0]), encoding="utf-8") as f:
        return json.load(f)


def test_profile_ticks_matches_reference(tmp_path, fresh):
    port = profile_ticks(str(tmp_path / "port"), ticks=2, services=16,
                         seed=7, tracer=Tracer(seed=0), device="cpu")
    ref = ref_profile_ticks(str(tmp_path / "ref"), ticks=2, services=16,
                            seed=7, tracer=RefTracer(seed=0))
    assert set(port) == set(ref) | {"device"} and set(ref) == _SUMMARY_KEYS
    for key in ("ticks", "services", "spans_recorded"):
        assert port[key] == ref[key], key
    assert list(port["kernel_by_shape"]) == list(ref["kernel_by_shape"])
    assert port["kernel_by_shape"] == {"64": "torch"}
    assert port["device"] == "cpu" and port["profile_files"] >= 1
    assert not profiling_active() and not ref_profiling()
    names = [e.get("name") for e in _trace(port["trace_dir"])["traceEvents"]
             if e.get("cat") == "user_annotation"]
    assert (names.count("rca_tick"), names.count("tick.dispatch"),
            names.count("tick.fetch")) == (2, 2, 2)


def test_profiled_polls_rank_as_unprofiled(tmp_path, fresh, monkeypatch):
    from rca_tpu_torch.engine import live

    polls = []
    poll = live.LiveStreamingSession.poll

    def recorded(self):
        out = poll(self)
        polls.append(out["ranked"])
        return out

    monkeypatch.setattr(live.LiveStreamingSession, "poll", recorded)
    profile_ticks(str(tmp_path), ticks=3, services=16, seed=7,
                  device="cpu")
    profiled, polls[:] = list(polls), []
    session = live.LiveStreamingSession(
        MockClusterClient(synthetic_cascade_world(
            16, n_roots=1, seed=7, namespace="profile")),
        "profile", k=5, engine=GraphEngine(device="cpu"))
    for _ in range(3):
        session.poll()
    assert len(profiled) == 3 and profiled[0]
    assert json.dumps(profiled) == json.dumps(polls)


#: demangled device kernel names as the profiler gives them on the card
_SYMBOLS = {
    "front_kernel<false>((anonymous namespace)::FrontArgs)":
        "evidence_front_fused",
    "front_kernel<true>((anonymous namespace)::FrontArgs)":
        "evidence_front_fused",
    "evidence_front_kernel(float const*, float const*)": "evidence_front",
    "evidence_front_persist_kernel(float*, float const*)": "evidence_front",
    "noisy_or_pair_kernel(float const*, float const*)": "noisy_or_pair",
    "seg_step_kernel<(anonymous namespace)::UpStep>(int const*)":
        "seg_up_step",
    "seg_step_kernel<(anonymous namespace)::DownStep>(int const*)":
        "seg_down_step",
    "seg_step_kernel<(anonymous namespace)::DownSumStep>(int const*)":
        "seg_down_step",
    "seg_step_kernel<(anonymous namespace)::ContrastStep>(int const*)":
        "seg_contrast_step",
    "seg_steps_kernel<(anonymous namespace)::UpSteps>(int, int const*)":
        "seg_up_steps",
    "seg_steps_kernel<(anonymous namespace)::DownSteps>(int, int const*)":
        "seg_down_steps",
    "seg_grid_kernel<(anonymous namespace)::UpGrid>((anonymous namespace)"
    "::GridArgs)": "seg_up_steps_grid",
    "seg_grid_kernel<(anonymous namespace)::DownGrid>((anonymous namespace)"
    "::GridArgs)": "seg_down_steps_grid",
    "seg_grid_kernel<(anonymous namespace)::UpShard>((anonymous namespace)"
    "::GridArgs)": "seg_up_steps_shard",
    "seg_shard_down_kernel((anonymous namespace)::ShardDown)":
        "seg_down_steps_shard",
    "tile_scan_kernel<0>(float const*, float const*)": "segscan_sum",
    "tile_scan_kernel<1>(float const*, float const*)": "segscan_max",
    "aggregate_scan_kernel<0>(float*, int*, int)": "other",
    "at::native::vectorized_elementwise_kernel<4, at::native::"
    "tanh_kernel_cuda>": "other",
}


def test_device_kernel_counts_name_the_wrappers():
    from rca_tpu_torch.observability.profile import device_kernel_counts

    events = [{"cat": "kernel", "name": f"void (anonymous namespace)::{n}"}
              for n in _SYMBOLS]
    events += [{"cat": "cpu_op", "name": "front_kernel<false>()"},
               {"cat": "user_annotation", "name": "rca_tick"}]
    counts = device_kernel_counts({"traceEvents": events})
    want = {}
    for name in _SYMBOLS.values():
        want[name] = want.get(name, 0) + 1
    assert {k: v for k, v in counts.items() if v} == want
    # every wrapper the launch counters count has its symbol
    assert set(counts) == set(LAUNCHES) | {"other"}


def test_profile_command_prints_one_json_line(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "rca_tpu_torch", "profile", "--device", "cpu",
         "--out", str(tmp_path / "p"), "--ticks", "1", "--services", "16",
         "--compact"], cwd=str(ROOT), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    summary = json.loads(lines[0])
    assert set(summary) == _SUMMARY_KEYS | {"device"}
    assert summary["ticks"] == 1 and summary["device"] == "cpu"
    assert len(_trace(str(tmp_path / "p"))["traceEvents"]) > 0


# -- RCA_TORCH_PROFILE --------------------------------------------------------

def _dumps(obj):
    return json.dumps(obj, sort_keys=True, default=str)


def _findings(results):
    """The findings JSON: every agent's, the groups and the root causes."""
    return {key: results[key] for key in results
            if key not in ("correlated", "profile", "summary")} | {
        "groups": results["correlated"]["groups"],
        "root_causes": results["correlated"]["root_causes"]}


def test_correlate_stage_trace_keeps_the_findings(tmp_path, fresh,
                                                  monkeypatch):
    for name in ("RCA_BACKEND", "RCA_EXPLAIN", "RCA_COLUMNAR"):
        monkeypatch.delenv(name, raising=False)

    def port_run():
        world = synthetic_cascade_world(50, n_roots=1, seed=7,
                                        namespace="synthetic")
        return RCACoordinator(MockClusterClient(world), backend="torch",
                              device="cpu").run_analysis("comprehensive",
                                                         "synthetic")

    monkeypatch.delenv("RCA_TORCH_PROFILE", raising=False)
    plain = port_run()
    monkeypatch.setenv("RCA_TORCH_PROFILE", str(tmp_path))
    traced = port_run()
    monkeypatch.delenv("RCA_TORCH_PROFILE")
    assert plain["status"] == traced["status"] == "completed"
    files = os.listdir(tmp_path / "correlate")
    assert len(files) == 1 and files[0].startswith("correlate.")
    with open(tmp_path / "correlate" / files[0], encoding="utf-8") as f:
        assert json.load(f)["traceEvents"]
    assert set(os.listdir(tmp_path)) == {"correlate"}
    assert _dumps(_findings(traced["results"])) == \
        _dumps(_findings(plain["results"]))
    ref = RefCoordinator(RefClient(ref_world(50, n_roots=1, seed=7,
                                             namespace="synthetic")),
                         backend="jax").run_analysis("comprehensive",
                                                     "synthetic")
    pr, rr = _findings(traced["results"]), _findings(ref["results"])
    assert sorted(pr) == sorted(rr)
    for key in pr:
        if key != "root_causes":
            assert _dumps(pr[key]) == _dumps(rr[key]), key
    assert [r["component"] for r in pr["root_causes"]] == \
        [r["component"] for r in rr["root_causes"]]
    for p, r in zip(pr["root_causes"], rr["root_causes"]):
        assert abs(p["score"] - r["score"]) <= 1e-4
        assert _dumps(p["findings"]) == _dumps(r["findings"])


def test_maybe_device_profile_is_a_no_op_unset(tmp_path, monkeypatch):
    from rca_tpu_torch.obslog.profiling import maybe_device_profile

    monkeypatch.delenv("RCA_TORCH_PROFILE", raising=False)
    with maybe_device_profile("correlate", torch.device("cpu")):
        np.zeros(3)
    monkeypatch.setenv("RCA_JAX_PROFILE", str(tmp_path))
    with maybe_device_profile("correlate", torch.device("cpu")):
        np.zeros(3)
    assert os.listdir(tmp_path) == []
