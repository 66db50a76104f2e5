"""The port's fetch budgets and specsan (``rca_tpu_torch/analysis/
dataplane``) against the JAX package's: the same roles and budgets
through the surface map, the same unification and budget arithmetic, the
domination proof and coverage, a recorder that judges every verdict, the
CPU run ok, its session leg transferring the reference's shapes, dtypes
and bytes surface by surface, and a capture that changes no result."""

from __future__ import annotations

import collections
import itertools
import os

import numpy as np
import pytest
import torch

from rca_tpu.analysis.dataplane import contracts as ref_contracts
from rca_tpu.analysis.dataplane import specsan as ref_specsan
from rca_tpu_torch.analysis.core import repo_root
from rca_tpu_torch.analysis.dataplane import contracts
from rca_tpu_torch.analysis.dataplane import specsan
from rca_tpu_torch.analysis.dataplane.specsan import (
    SHARDED_SURFACES,
    SpecsanRecorder,
    capture,
    confirm_findings,
    run_specsan,
    unify_roles,
)
from rca_tpu_torch.engine import fetch

ROOT = repo_root()


def _key(surface):
    return tuple(surface.split("::"))


# ---------------------------------------------------------------------------
# the tables against the reference's
# ---------------------------------------------------------------------------

def test_surface_map_covers_both_tables():
    assert set(contracts.REFERENCE_SURFACES) == set(contracts.FETCH_BUDGETS)
    images = {ref for refs in contracts.REFERENCE_SURFACES.values()
              for ref in refs}
    assert images == set(ref_contracts.FETCH_BUDGETS)


@pytest.mark.parametrize("surface", sorted(
    f"{p}::{f}" for p, f in contracts.FETCH_BUDGETS))
def test_budget_and_roles_are_the_references(surface):
    port = contracts.FETCH_BUDGETS[_key(surface)]
    refs = contracts.REFERENCE_SURFACES[_key(surface)]
    for i, ref_key in enumerate(refs):
        ref = ref_contracts.FETCH_BUDGETS[ref_key]
        assert port.budget == ref.budget
        assert port.bulk == ref.bulk
        ref_roles = {tuple(r) for r in ref.roles}
        port_roles = {tuple(r) for r in port.roles}
        if i == 0:
            assert port_roles == ref_roles
        else:
            # a merged surface declares at least its twin's roles
            assert port_roles >= ref_roles
    for binding in itertools.product(*(contracts.SYMBOL_GRID[s] for s in
                                       sorted(contracts.SYMBOL_GRID))):
        b = dict(zip(sorted(contracts.SYMBOL_GRID), binding))
        assert contracts.eval_budget(port.budget, b) == \
            ref_contracts.eval_budget(port.budget, b)


def test_grid_itemsizes_and_role_names_are_the_references():
    assert contracts.SYMBOL_GRID == ref_contracts.SYMBOL_GRID
    assert contracts.ITEMSIZE == ref_contracts.ITEMSIZE
    for name in ("self._stacked_dev", "handle.vals", "topi", "_idx_h"):
        leaf = name.rsplit(".", 1)[-1]
        assert contracts.role_name(leaf) == ref_contracts.role_name(leaf)
    assert contracts.dtype_name(torch.float32) == "float32"
    assert contracts.dtype_name(np.dtype("int32")) == "int32"


def test_budget_domination_proof_holds_and_coverage_is_complete():
    assert contracts.budget_violations() == []
    assert contracts.coverage() == []


def test_budget_violation_detected(monkeypatch):
    key = ("rca_tpu_torch/engine/fake.py", "fake_fetch")
    monkeypatch.setitem(contracts.FETCH_BUDGETS, key, contracts.FetchBudget(
        (contracts.Role("x", ("n_pad",), "float32"),), "n_pad"))
    out = contracts.budget_violations()
    assert [v["surface"] for v in out] == ["rca_tpu_torch/engine/fake.py::"
                                           "fake_fetch"]


def _roles(mod):
    return (mod.Role("vals", ("k",), "float32"),
            mod.Role("idx", ("k",), "int32"),
            mod.Role("n_bad", (), "int32"))


@pytest.mark.parametrize("leaves", [
    [((5,), "float32"), ((5,), "int32"), ((), "int32")],
    [((5,), "float32"), ((6,), "int32")],
    [((5,), "float64")],
    [((5,), "int32")],
    [((3,), "float32"), ((3,), "int32"), ((), "int32"), ((), "int32")],
    [],
])
def test_unify_roles_gives_the_references_answer(leaves):
    assert unify_roles(leaves, _roles(contracts)) == \
        ref_specsan.unify_roles(leaves, _roles(ref_contracts))


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def _exec_at(root, rel, src):
    """Run ``src`` as if it were the file ``rel`` of a repository at
    ``root`` (the recorder names surfaces by their code's file)."""
    namespace = {}
    exec(compile(src, os.path.join(root, rel), "exec"), namespace)
    return namespace


_SURFACES_SRC = """\
from rca_tpu_torch.engine.fetch import HostCopy, device_get


def _fetch_topk(diag, vals, idx, n_bad):
    return HostCopy(diag, vals, idx, n_bad).numpy()


def render(t):
    return device_get(t)


def other(t):
    return device_get(t)
"""


def test_recorder_judges_ok_over_budget_unmatched_and_unaudited(
        tmp_path, monkeypatch):
    rel = "rca_tpu_torch/engine/resident.py"
    ns = _exec_at(str(tmp_path), rel, _SURFACES_SRC)
    other = _exec_at(str(tmp_path), "rca_tpu_torch/engine/elsewhere.py",
                     _SURFACES_SRC)
    diag = torch.zeros(4, 13)
    vals = torch.zeros(13)
    idx = torch.zeros(13, dtype=torch.int32)
    n_bad = torch.zeros((), dtype=torch.int32)
    with capture(str(tmp_path)) as rec:
        ns["_fetch_topk"](diag, vals, idx, n_bad)               # ok
        ns["_fetch_topk"](diag, vals, idx.long(), n_bad)        # int64 idx
        ns["render"](vals)                                      # unaudited
        other["render"](vals)                                   # unscoped
        monkeypatch.setitem(contracts.FETCH_BUDGETS,
                            ("rca_tpu_torch/engine/resident.py", "other"),
                            contracts.FetchBudget(
                                (contracts.Role("vals", ("k",), "float32"),),
                                "2*k"))
        ns["other"](vals)                                       # over
    verdicts = [(e["surface"].split("::")[1], e["verdict"])
                for e in rec.events]
    assert verdicts == [("_fetch_topk", "ok"),
                        ("_fetch_topk", "unmatched_roles"),
                        ("render", "unaudited"), ("render", "unscoped"),
                        ("other", "over_budget")]
    assert rec.events[0]["nbytes"] == 16 * 13 + 4 * 13 + 4 * 13 + 4
    assert rec.events[0]["budget_bytes"] == 24 * 13 + 8
    assert sorted(v["kind"] for v in rec.violations) == [
        "over_budget", "unaudited", "unmatched_roles"]


def test_transfers_outside_the_port_are_not_recorded():
    with capture() as rec:
        fetch.device_get(torch.ones(3))   # this test module is not a surface
    assert rec.events == []


def test_capture_restores_the_tap_and_stays_apart_from_the_references():
    import jax

    assert fetch.set_tap(None) is None
    jax_device_get = jax.device_get
    with ref_specsan.capture(ROOT) as ref_rec, capture() as rec:
        specsan._session_leg(None, 0, 20, "cpu")
        ref_specsan._session_leg(ref_rec, 0)
    # each capture restored only what it patched
    assert fetch._TAP is None
    assert jax.device_get is jax_device_get
    port_surfaces = {e["surface"] for e in rec.events}
    ref_surfaces = {e["surface"] for e in ref_rec.events}
    assert port_surfaces and ref_surfaces
    assert all(s.startswith("rca_tpu_torch/") for s in port_surfaces)
    assert all(s.startswith("rca_tpu/") for s in ref_surfaces)


def test_confirm_findings_stamps_implicated_paths():
    findings = [
        {"rule": "resident-fetch", "path": "rca_tpu_torch/engine/runner.py"},
        {"rule": "resident-fetch", "path": "rca_tpu_torch/engine/other.py"},
        {"rule": "rng-key-reuse", "path": "rca_tpu_torch/engine/runner.py"},
    ]
    report = {"violations": [
        {"kind": "over_budget",
         "surface": "rca_tpu_torch/engine/runner.py::timed_fetch"},
    ]}
    assert confirm_findings(findings, report) == 1
    assert findings[0].get("dynamically_confirmed") is True
    assert "dynamically_confirmed" not in findings[1]
    assert "dynamically_confirmed" not in findings[2]


# ---------------------------------------------------------------------------
# the workload on the CPU
# ---------------------------------------------------------------------------

def test_run_specsan_on_the_cpu_is_ok():
    report = run_specsan(device="cpu")
    assert report["ok"], report["violations"]
    assert report["violations"] == []
    budgeted = {f"{p}::{f}" for p, f in contracts.FETCH_BUDGETS}
    assert set(report["surfaces_unexercised"]) == set(SHARDED_SURFACES)
    assert set(report["surfaces_confirmed"]) == budgeted - SHARDED_SURFACES
    assert set(report["legs"]) == {"session@20", "serve"}
    assert report["serve"]["ok"] and report["serve"]["parity_ok"]
    for leg in report["launches"].values():
        assert set(leg.values()) == {0}  # the plain versions on the CPU


def _signatures(events, surface_of):
    out = collections.defaultdict(list)
    for e in events:
        out[surface_of(e["surface"])].append(
            (tuple(map(tuple, e["shapes"])), tuple(e["dtypes"]),
             e["nbytes"]))
    return out


def test_session_leg_moves_the_references_transfers():
    """Surface by surface through the map: the same shapes, dtypes and
    bytes in the same order; the port's timed path warms with one more
    top-k pair fetch (it compiles nothing ahead of time, where the
    reference lowers its executable)."""
    with ref_specsan.capture(ROOT) as ref_rec:
        ref_specsan._session_leg(ref_rec, 0)
    with capture() as rec:
        specsan._session_leg(rec, 0, 20, "cpu")
    ref = _signatures(ref_rec.events, lambda s: s)
    port = _signatures(rec.events, lambda s: "::".join(
        contracts.REFERENCE_SURFACES[_key(s)][0]))
    assert set(port) == set(ref)
    timed = "rca_tpu/engine/runner.py::timed_fetch"
    for surface in ref:
        want = ref[surface]
        if surface == timed:
            want = [want[0]] + want
        assert port[surface] == want, surface
    assert ref_rec.violations == [] and rec.violations == []


def test_serve_leg_moves_the_references_lanes():
    """The dispatcher's copies per lane (the batch width follows thread
    timing) against the reference's, whose selftest serves on its dense
    engine here."""
    with ref_specsan.capture(ROOT) as ref_rec:
        ref_out = ref_specsan._serve_leg(0, 8)
    with capture() as rec:
        out = specsan._serve_leg(rec, 0, 8, "cpu")
    assert out["ok"] and ref_out["ok"]

    def lanes(events, surface):
        return {(tuple(tuple(s[1:]) if len(s) > 1 else tuple(s)
                       for s in e["shapes"]), tuple(e["dtypes"]))
                for e in events if e["surface"] == surface}

    ref_lanes = lanes(ref_rec.events, "rca_tpu/serve/dispatcher.py::fetch")
    port_lanes = lanes(rec.events, "rca_tpu_torch/serve/dispatcher.py::"
                                   "dispatch")
    assert ref_lanes and port_lanes == ref_lanes


def test_sharded_surfaces_unify_with_their_budgets():
    """The three surfaces only the sharded engine reaches, on logical
    CPU shards: every transfer ok."""
    from rca_tpu_torch.cluster.generator import synthetic_cascade_arrays
    from rca_tpu_torch.engine.sharded_runner import ShardedGraphEngine
    from rca_tpu_torch.engine.streaming import make_streaming_session
    from rca_tpu_torch.parallel.mesh import make_mesh

    cpu = torch.device("cpu")
    engine = ShardedGraphEngine(mesh=make_mesh([("dp", 1), ("sp", 4)],
                                               [cpu] * 4))
    case = synthetic_cascade_arrays(40, seed=3)
    with capture() as rec:
        res = engine.analyze_case(case, k=5, timed=True)
        res.full_diagnostics()
        engine.analyze_batch(np.stack([case.features] * 2), case.dep_src,
                             case.dep_dst, case.names, k=5)
        engine.analyze_arrays(case.features, case.dep_src, case.dep_dst,
                              case.names, k=5)
        session = make_streaming_session(case.names, case.dep_src,
                                         case.dep_dst, case.features.shape[1],
                                         engine=engine, k=5)
        session.update_rows(np.arange(2, dtype=np.int32),
                            case.features[:2])
        session.tick()
    assert rec.violations == []
    seen = {e["surface"] for e in rec.events}
    assert SHARDED_SURFACES <= seen
    assert "rca_tpu_torch/engine/resident.py::_fetch_topk" in seen
    assert all(e["verdict"] == "ok" for e in rec.events)


def test_capture_changes_no_result():
    plain = specsan.run_legs(None, seed=0, services=(20,), device="cpu")
    with capture() as rec:
        captured = specsan.run_legs(rec, seed=0, services=(20,),
                                    device="cpu")
    assert rec.events
    for n, leg in plain["sessions"].items():
        assert leg["rankings"] == captured["sessions"][n]["rankings"]
    assert plain["serve"]["by_status"] == captured["serve"]["by_status"]
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    with capture():
        got = fetch.device_get(t, t[0])
        copied = fetch.HostCopy(t).numpy()
    assert np.array_equal(got[0], t.numpy())
    assert np.array_equal(got[1], t[0].numpy())
    assert np.array_equal(copied[0], t.numpy())


def test_replayed_tape_fetches_within_budget():
    """Every transfer of a replayed port tape (the committed chaos tape)
    unifies with its budget."""
    from rca_tpu_torch.replay import replay

    tape = os.path.join(ROOT, "tests", "corpus_torch",
                        "chaos-20svc-seed11.torch.rcz")
    with capture() as rec:
        replay(tape, device="cpu")
    budgeted = {f"{p}::{f}" for p, f in contracts.FETCH_BUDGETS}
    assert rec.violations == []
    assert {e["surface"] for e in rec.events} & budgeted


@pytest.mark.cuda
def test_specsan_on_the_card_at_both_tiers():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: python3 chip_smoke.py --lint-only runs "
                    "specsan's legs on the card")
    report = run_specsan(seed=0, services=(2047, 49999), device="cuda")
    assert report["ok"], report["violations"]
    launches = report["launches"]
    assert launches["session@2047"]["evidence_front_fused"] > 0
    assert launches["session@2047"]["seg_down_steps"] > 0
    # above one CTA each recursion is one cooperative launch a front
    big = launches["session@49999"]
    assert big["seg_down_steps_grid"] == big["seg_up_steps_grid"] == \
        big["evidence_front_fused"] > 0
    assert big["seg_down_step"] == big["seg_up_step"] == 0
