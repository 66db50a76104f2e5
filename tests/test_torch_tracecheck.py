"""The port's recompile gate against the JAX package's.

- ``run_tracecheck(device="cpu")`` is ``ok`` with the reference's four
  entry points, and its summary has the reference's keys, top level and
  per entry;
- the gate gates: an entry whose registry is cleared between its two
  calls re-elects the shape on call two and is reported as a recompile
  (as ``tests/test_analysis.py`` forces one for the reference), and a
  compile noted inside the capture is collected;
- an unknown entry raises ``KeyError``, as the reference's does.
"""

import pytest

from rca_tpu.analysis import run_tracecheck as ref_run_tracecheck
from rca_tpu.analysis.tracecheck import ENTRY_POINTS as REF_ENTRY_POINTS
from rca_tpu_torch.analysis import run_tracecheck
from rca_tpu_torch.analysis import tracecheck
from rca_tpu_torch.config import RCAConfig, bucket_for
from rca_tpu_torch.engine import registry
from rca_tpu_torch.observability.kernelscope import note_compile


@pytest.fixture
def fresh(monkeypatch):
    monkeypatch.delenv("RCA_KERNEL", raising=False)
    monkeypatch.delenv("RCA_SHARD", raising=False)
    monkeypatch.setenv("RCA_KERNEL_CACHE", "off")
    registry.reset_registry()
    yield
    registry.reset_registry()


def test_tracecheck_is_ok_with_the_reference_entries(fresh):
    summary = run_tracecheck(device="cpu")
    assert summary["ok"], summary
    ref = ref_run_tracecheck()
    assert ref["ok"], ref
    assert list(tracecheck.ENTRY_POINTS) == list(REF_ENTRY_POINTS)
    assert [e["entry"] for e in summary["entries"]] == \
        [e["entry"] for e in ref["entries"]]
    assert set(summary) == set(ref)
    for port, want in zip(summary["entries"], ref["entries"]):
        assert set(port) == set(want)
        assert port["recompiles"] == 0 and port["recompiled"] == []
        assert port["wall_ms"] > 0
    # the registry was cleared: the first entry elects its shape
    assert summary["entries"][0]["warmup_compiles"] == 1
    again = run_tracecheck(["engine.analyze_case"], device="cpu")
    assert again["ok"] and again["entries"][0]["warmup_compiles"] == 0


def test_a_registry_cleared_between_the_calls_is_a_recompile(fresh,
                                                             monkeypatch):
    build = tracecheck.ENTRY_POINTS["engine.analyze_case"]

    def clearing(device):
        call = build(device)

        def cleared() -> None:
            registry.reset_registry()
            call()

        return cleared

    monkeypatch.setitem(tracecheck.ENTRY_POINTS, "engine.analyze_case",
                        clearing)
    summary = run_tracecheck(["engine.analyze_case"], device="cpu")
    n_pad = bucket_for(tracecheck.N_SERVICES + 1, RCAConfig().shape_buckets)
    entry = summary["entries"][0]
    assert not summary["ok"] and not entry["ok"]
    assert (entry["warmup_compiles"], entry["recompiles"]) == (1, 1)
    assert entry["recompiled"] == [f"plan dense:{n_pad}:64:8 on cpu"]


def test_compile_log_capture_collects_the_compiles_in_its_block():
    outside, inside = [], []
    note_compile("before", ("tracecheck", 0))
    with tracecheck.compile_log_capture(inside):
        note_compile("kernel library", ("tracecheck", 1))
        note_compile("kernel library", ("tracecheck", 1))
    with tracecheck.compile_log_capture(outside):
        pass
    assert inside == ["kernel library", "kernel library"]
    assert outside == []


def test_unknown_entry_raises_as_the_reference():
    with pytest.raises(KeyError, match="nope"):
        run_tracecheck(["nope"], device="cpu")
    with pytest.raises(KeyError, match="nope"):
        ref_run_tracecheck(["nope"])
