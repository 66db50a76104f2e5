"""graftlint for the port (``rca_tpu_torch/analysis``) against the JAX
package's own (``rca_tpu/analysis``): the rules that keep their meaning
give the same findings, lines and fingerprints on the reference's
fixtures written at the mapped paths, suppressions and the baseline count
alike, the CLIs share exit codes and JSON keys, the torch rules fire on
their hazards and not on numpy's look-alikes, and the repository is clean
with an empty baseline."""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import sys

import pytest

from rca_tpu.analysis import core as ref_core
from rca_tpu.analysis import run_lint as ref_run_lint
from rca_tpu.analysis.__main__ import main as ref_main
from rca_tpu_torch.analysis import (
    all_rules,
    default_baseline_path,
    load_baseline,
    repo_root,
    run_lint,
    write_baseline,
)
from rca_tpu_torch.analysis.__main__ import main as port_main
from rca_tpu_torch.analysis.core import discover_files, index_path

ROOT = repo_root()

#: the rules that keep the reference's meaning, with the paths mapped
KEPT = ("env-discipline", "swallowed-faults", "thread-discipline",
        "lock-discipline", "span-discipline", "nondet-discipline",
        "no-dict-scan")
TORCH_RULES = ("tick-sync", "resident-fetch", "kernel-dispatch",
               "rng-key-reuse")
#: gravelock's rules over the port's concurrency model
#: (tests/test_torch_gravelock.py holds them to the reference's)
GRAVELOCK_RULES = ("race-guard", "lock-order")
#: graftspec's static half over the port's abstract interpreter
#: (tests/test_torch_dataplane.py holds them to the reference's)
GRAFTSPEC_RULES = ("dtype-discipline", "shape-contract")


def _reference_fixtures():
    """The reference's fire fixtures, read from its test module."""
    path = os.path.join(ROOT, "tests", "test_analysis.py")
    spec = importlib.util.spec_from_file_location("_ref_analysis_tests",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.FIXTURES


REF_FIXTURES = _reference_fixtures()


def _mapped(rel: str) -> str:
    assert rel.startswith("rca_tpu/"), rel
    return "rca_tpu_torch/" + rel[len("rca_tpu/"):]


def _fake_repo(root, *entries):
    for rel, src in entries:
        full = root / rel
        full.parent.mkdir(parents=True, exist_ok=True)
        full.write_text(src)
    return str(root)


def _both(tmp_path, entries, **kwargs):
    """The same files linted by each package: at the reference's paths
    for it, at the mapped paths for the port."""
    ref_root = _fake_repo(tmp_path / "ref", *entries)
    port_root = _fake_repo(tmp_path / "port",
                           *((_mapped(rel), src) for rel, src in entries))
    return (ref_run_lint(root=ref_root, **kwargs),
            run_lint(root=port_root, **kwargs))


def _key(f):
    return (f.rule, f.line, f.snippet, f.func)


# ---------------------------------------------------------------------------
# the kept rules: the reference's fixtures, the same findings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rule", KEPT)
def test_kept_rule_matches_the_reference_on_its_fixture(tmp_path, rule):
    rel, src, expected = REF_FIXTURES[rule]
    ref, port = _both(tmp_path, [(rel, src)], rules=[rule],
                      use_baseline=False)
    assert len(ref.findings) >= expected
    assert [_key(f) for f in port.findings] == [_key(f) for f in
                                                ref.findings]
    for rf, pf in zip(ref.findings, port.findings):
        assert pf.path == _mapped(rf.path)
        mapped = ref_core.Finding(rf.rule, pf.path, rf.line, rf.message,
                                  rf.snippet, rf.func)
        blob = f"{pf.rule}|{pf.path}|{pf.snippet}".encode("utf-8")
        assert pf.fingerprint() == mapped.fingerprint() == \
            hashlib.sha1(blob).hexdigest()[:16]


#: the reference's clean twins of the kept rules' fixtures
CLEAN_TWINS = {
    "locks": ("rca_tpu/serve/good_locks.py", """\
from rca_tpu.util.threads import make_lock

class Q:
    def __init__(self):
        self._lock = make_lock("Q._lock")
        self._items = []

    def put(self, x):
        with self._lock:
            self._items.append(x)

    def legacy_put(self, x):
        self._lock.acquire()
        try:
            self._items.append(x)
        finally:
            self._lock.release()
"""),
    "socket": ("rca_tpu/gateway/good_socket.py", """\
from rca_tpu.util.net import make_server_socket

def listen(host, port):
    return make_server_socket("gateway", host, port)  # the seam itself
"""),
    "procs": ("rca_tpu/serve/good_procs.py", """\
import subprocess

from rca_tpu.util.procs import python_argv, spawn_worker

def launch(worker_id, addr):
    # long-lived children go through the seam...
    return spawn_worker(
        f"fed-worker{worker_id}",
        python_argv("rca_tpu.serve.worker", "--connect", addr),
    )

def one_shot(cmd):
    # ...one-shot subprocess.run stays legal (no life cycle to own)
    return subprocess.run(cmd, capture_output=True, timeout=30)
"""),
    "procs_seam": ("rca_tpu/util/procs.py", """\
import subprocess

def spawn_worker(name, argv, env=None):
    # legal ONLY in the procs seam
    return subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, env=env)
"""),
    "net_seam": ("rca_tpu/util/net.py", """\
import socket

def make_server_socket(name, host, port):
    sock = socket.socket()         # legal ONLY in the net seam
    sock.bind((host, port))
    sock.listen(8)
    return sock
"""),
    "columnar": ("rca_tpu/cluster/columnar.py", """\
import numpy as np


def build_view(table):
    \"\"\"[no-dict-scan] assemble the capture view, vectorized.\"\"\"
    feat = table.base.copy()
    feat[:, 0] = table.cpu
    # comprehensions over small registries are the documented allowlist
    lut = np.asarray([table.pos.get(n, -1) for n in table.registry])
    return feat, lut


def encode_row(pod):
    # unmarked row-write encoder: loops are its job (paid per mutation)
    total = 0
    for cs in pod.get("statuses", []):
        total += cs.get("restarts", 0)
    return total
"""),
    "spans": ("rca_tpu/serve/good_spans.py", """\
def handle(tracer, ctx, t0, t1):
    with tracer.span("serve.request", parent=ctx) as sp:
        sp.set_attr("tenant", "t")
    # cross-method phases use complete timestamps: cannot leak
    tracer.record("serve.queue", t0, t1, parent=ctx)
    tracer.event("serve.steal", t1, parent=ctx)
"""),
    "nondet": ("rca_tpu/serve/good_nondet.py", """\
import random
import time

import numpy as np


class Worker:
    def __init__(self, clock=time.monotonic, seed=0):
        self._clock = clock
        self._rng = random.Random(seed)
        self._np = np.random.default_rng(seed)

    def stamp(self):
        return self._clock()
"""),
}


@pytest.mark.parametrize("twin", sorted(CLEAN_TWINS))
def test_kept_rules_clean_on_the_reference_twins(tmp_path, twin):
    ref, port = _both(tmp_path, [CLEAN_TWINS[twin]], rules=list(KEPT),
                      use_baseline=False)
    assert ref.clean, ref.findings
    assert port.clean, port.findings


def test_nondet_allowlist_covers_the_ports_seams():
    paths = ["rca_tpu_torch/cluster/mock_client.py",
             "rca_tpu_torch/replay/recorder.py"]
    result = run_lint(root=ROOT, rules=["nondet-discipline"],
                      use_baseline=False, paths=paths)
    assert result.clean, result.findings
    rule = all_rules()["nondet-discipline"]
    saved = rule.allow
    try:
        rule.allow = {}
        bare = run_lint(root=ROOT, rules=["nondet-discipline"],
                        use_baseline=False, paths=paths)
        assert len(bare.findings) >= 2  # the seams exist and are fenced
    finally:
        rule.allow = saved


# ---------------------------------------------------------------------------
# suppressions and the baseline: the same counts from both packages
# ---------------------------------------------------------------------------

def _env_source(suffix=""):
    rel, src, _ = REF_FIXTURES["env-discipline"]
    line = 'return int(os.environ.get("RCA_PIPELINE_DEPTH", "1"))'
    return rel, src.replace(line, line + suffix)


@pytest.mark.parametrize("case", ["line", "file", "all"])
def test_suppressions_count_as_in_the_reference(tmp_path, case):
    if case == "line":
        entry = _env_source("  # graftlint: disable=env-discipline")
    elif case == "all":
        entry = _env_source("  # graftlint: disable=all")
    else:
        rel, src, _ = REF_FIXTURES["swallowed-faults"]
        entry = (rel, "# graftlint: disable-file=swallowed-faults\n" + src)
    ref, port = _both(tmp_path, [entry], use_baseline=False)
    assert ref.clean and port.clean
    assert ref.suppressed == port.suppressed == (0 if case == "file" else 1)


def _relint(root, rel, src, bpath):
    (root / rel).write_text(src)
    return (run_lint if rel.startswith("rca_tpu_torch/") else ref_run_lint)(
        root=str(root), baseline_path=bpath)


@pytest.mark.parametrize("case", ["round_trip", "multiset"])
def test_baseline_counts_as_in_the_reference(tmp_path, case):
    rel, src, _ = REF_FIXTURES["nondet-discipline"]
    counts = []
    for pkg, lint, path in (("ref", ref_run_lint, rel),
                            ("port", run_lint, _mapped(rel))):
        root = tmp_path / pkg
        _fake_repo(root, (path, src))
        bpath = str(tmp_path / f"{pkg}-baseline.json")
        first = lint(root=str(root), use_baseline=False)
        (ref_core.write_baseline if pkg == "ref" else write_baseline)(
            bpath, first.findings)
        second = lint(root=str(root), baseline_path=bpath)
        if case == "round_trip":
            # fixing the code turns the entries stale
            third = _relint(root, path, "import time\n", bpath)
            counts.append((len(first.findings), second.baselined,
                           second.clean, len(second.stale_baseline),
                           third.baselined, len(third.stale_baseline)))
        else:
            # a new copy of a baselined line is NOT absorbed
            dup = src + "\n\ndef stamp2():\n    return time.time()\n"
            third = _relint(root, path, dup, bpath)
            counts.append((len(first.findings), second.baselined,
                           len(third.findings), third.baselined))
    assert counts[0] == counts[1]
    assert counts[0][0] >= 4


def test_repo_is_lint_clean_with_an_empty_baseline():
    """THE gate: the port's lint exits 0 on the repository, with nothing
    baselined."""
    result = run_lint(root=ROOT)
    assert result.clean, "\n".join(
        f"{f.path}:{f.line}: [{f.rule}] {f.message}" for f in result.findings
    )
    assert result.baselined == 0
    assert load_baseline(default_baseline_path(ROOT)) == []


def test_scan_set_is_the_port_chip_smoke_and_its_tests():
    files = discover_files(ROOT)
    assert "chip_smoke.py" in files
    assert "rca_tpu_torch/engine/fetch.py" in files
    assert "tests/test_torch_lint.py" in files
    assert not [f for f in files if f.startswith("rca_tpu/")
                or (f.startswith("tests/")
                    and not f.startswith("tests/test_torch_"))]


def test_eleven_rules_registered():
    """The eleven rules of the first part, gravelock's two and graftspec's
    static two beside them: 15 of the reference's 18."""
    assert set(all_rules()) == set(KEPT) | set(TORCH_RULES) | set(
        GRAVELOCK_RULES) | set(GRAFTSPEC_RULES)
    assert len(all_rules()) == 15
    for rule in all_rules().values():
        assert rule.summary and rule.why


# ---------------------------------------------------------------------------
# the CLI: exit codes, JSON keys, forwarding
# ---------------------------------------------------------------------------

def test_cli_exit_codes_match_the_reference(tmp_path):
    rel, src, _ = REF_FIXTURES["env-discipline"]
    ref_root = _fake_repo(tmp_path / "ref", (rel, src))
    port_root = _fake_repo(tmp_path / "port", (_mapped(rel), src))
    for argv in (["--no-baseline"], ["--no-baseline", "--rules",
                                     "swallowed-faults"],
                 ["--rules", "no-such-rule"],
                 ["--changed", "somefile.py"]):
        assert ref_main(["--root", ref_root, *argv]) == port_main(
            ["--root", port_root, *argv]), argv


def test_cli_json_keys_match_the_reference(tmp_path, capsys):
    rel, src, _ = REF_FIXTURES["swallowed-faults"]
    ref_root = _fake_repo(tmp_path / "ref", (rel, src))
    port_root = _fake_repo(tmp_path / "port", (_mapped(rel), src))
    assert ref_main(["--root", ref_root, "--no-baseline", "--json"]) == 1
    ref = json.loads(capsys.readouterr().out)
    assert port_main(["--root", port_root, "--no-baseline", "--json"]) == 1
    port = json.loads(capsys.readouterr().out)
    assert set(port) == set(ref)
    assert set(port["findings"][0]) == set(ref["findings"][0])
    assert port["findings"][0]["fingerprint"] == ref_core.Finding(
        "swallowed-faults", _mapped(rel), 0, "",
        ref["findings"][0]["snippet"]).fingerprint()


def test_port_cli_lint_forwards_every_argument(tmp_path, capsys):
    from rca_tpu_torch.cli import main

    assert main(["lint", "--list-rules"]) == 0
    assert set(capsys.readouterr().out.split()) >= set(all_rules())
    rel, src, _ = REF_FIXTURES["env-discipline"]
    root = _fake_repo(tmp_path, (_mapped(rel), src))
    assert main(["lint", "--root", root, "--no-baseline", "--json"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert [f["rule"] for f in out["findings"]] == ["env-discipline"]


def test_rsan_exits_0_clean_and_1_on_a_racing_fixture(tmp_path, capsys):
    """``--rsan`` runs the cross-check beside the rules: exit 0 on a clean
    fake repo (the report's human line says ``rsan: ok``), exit 1 on one
    whose fixture races, with the sanitizer's verdict still ok."""
    clean = _fake_repo(tmp_path / "clean", ("rca_tpu_torch/ok.py",
                                            "X = 1\n"))
    assert port_main(["--root", clean, "--rsan"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2].startswith("rsan: ok [")
    assert lines[-1].startswith("graftlint: clean")
    racing = _fake_repo(tmp_path / "racing", ("rca_tpu_torch/serve/w.py", """\
import threading

class Worker:
    def __init__(self):
        self._lock = threading.Lock()
        self._done = 0

    def start(self):
        threading.Thread(target=self._run, name="w", daemon=True).start()

    def _run(self):
        self._done += 1

    def bump(self):
        with self._lock:
            self._done += 1
"""))
    assert port_main(["--root", racing, "--rsan", "--rules", "race-guard",
                      "--json"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert [f["rule"] for f in out["findings"]] == ["race-guard"]
    assert out["rsan"]["ok"] is True and out["clean"] is False


def test_all_runs_every_check_in_one_summary(tmp_path, capsys):
    """``--all`` = the rules + tracecheck + rsan + specsan: one JSON object
    with an ``rsan`` report and no ``not_run``, one human summary."""
    root = _fake_repo(tmp_path, ("rca_tpu_torch/ok.py", "X = 1\n"))
    assert port_main(["--root", root, "--all", "--device", "cpu",
                      "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert "not_run" not in out
    assert out["clean"] and out["tracecheck"]["ok"] and out["specsan"]["ok"]
    assert out["rsan"]["ok"] and out["rsan"]["contradictions"] == []
    assert out["rsan"]["races_observed"] == []
    assert port_main(["--root", root, "--all", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert any(line.startswith("rsan: ok [") for line in lines)
    assert lines[-1].startswith("graftlint: clean")
    assert "not run" not in lines[-1]


def test_changed_reads_the_ports_own_index(tmp_path, capsys):
    rel = "rca_tpu_torch/engine/a.py"
    root = _fake_repo(tmp_path, (rel, "X = 1\n"))
    assert port_main(["--root", root, "--json"]) == 0
    capsys.readouterr()
    assert os.path.exists(index_path(root))
    assert ".graftlint_torch" in index_path(root)
    assert port_main(["--root", root, "--changed", "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["changed_files"] == []
    (tmp_path / rel).write_text("import os\nX = os.environ['HOME']\n")
    assert port_main(["--root", root, "--changed", "--json"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert out["changed_files"] == [rel]
    assert [f["rule"] for f in out["findings"]] == ["env-discipline"]


# ---------------------------------------------------------------------------
# the torch rules: each fires on its hazard, never on numpy's look-alikes
# ---------------------------------------------------------------------------

TORCH_FIRE = {
    "tick-sync": ("rca_tpu_torch/engine/live.py", """\
import torch

from rca_tpu_torch.engine.fetch import HostCopy, device_get


class S:
    def poll(self, t, ev):
        a = t.cpu()                        # raw device->host copy
        b = t.item()                       # a scalar sync
        c = t.to("cpu")                    # the same copy, spelled .to
        d = t.to(device="cpu")             # and with a keyword
        torch.cuda.synchronize()           # a device-wide sync
        ev.synchronize()                   # an event's
        e = device_get(t)                  # the seam's sync, off fetch
        h = HostCopy(t)                    # copies started off dispatch
        return a, b, c, d, e, h
""", 8),
    "resident-fetch": ("rca_tpu_torch/engine/runner.py", """\
from rca_tpu_torch.engine import fetch
from rca_tpu_torch.engine.fetch import HostCopy, device_get


def analyze_arrays(run):
    stacked, diag, vals, idx, n_bad = run()
    return device_get(stacked)         # bulk fetch outside a surface


def render(handle):
    copy = fetch.HostCopy(handle.stacked)  # copies off the surfaces
    return copy, handle.stacked.cpu()   # and a raw copy
""", 3),
    "kernel-dispatch": ("rca_tpu_torch/engine/bad_dispatch.py", """\
from rca_tpu_torch.engine.doubling import doubling_layouts_for
from rca_tpu_torch.engine.evidence import evidence_front
from rca_tpu_torch.engine.segscan import up_seg_step, up_seg_step_plain


def tick(ft, aw, hw, up, kern):
    # re-deriving the kernel choice locally bypasses the registry seam
    front = evidence_front(ft, aw, hw, 0.7, up)
    step = up_seg_step if kern else up_seg_step_plain   # a selection
    return front, step, doubling_layouts_for(64, 64, up, up, 8)
""", 3),
    "rng-key-reuse": ("rca_tpu_torch/engine/bad_rng.py", """\
import random

import numpy as np
import torch


def sample(seed, x):
    a = torch.rand(3)                  # torch's global generator
    x.normal_()                        # an in-place draw, global too
    b = np.random.normal(size=3)       # numpy's global stream
    torch.manual_seed(seed)            # reseeds every module's stream
    g1 = np.random.default_rng(seed)
    g2 = np.random.default_rng(seed)   # the same stream again
    out = [random.Random(seed) for _ in range(3)]  # the same each time
    return a, b, g1, g2, out
""", 6),
}

TORCH_CLEAN = {
    "tick-sync": ("rca_tpu_torch/engine/streaming.py", """\
import numpy as np

from rca_tpu_torch.engine.fetch import HostCopy, device_get


class S:
    def dispatch(self, vals, idx):
        return HostCopy(vals, idx)          # starts the copies, no sync

    def fetch(self, handle, t):
        vals, idx = handle.numpy()          # THE sync point
        return vals, idx, device_get(t)

    def render(self, table, idx):
        ids = np.asarray(idx).tolist()      # numpy's tolist
        arr = np.zeros(3).numpy() if False else np.zeros(3)
        return ids, table.cpu, arr.item     # a cpu column, no call
"""),
    "resident-fetch": ("rca_tpu_torch/engine/runner.py", """\
import numpy as np

from rca_tpu_torch.engine.fetch import device_get


def timed_fetch(run, timed):
    stacked, diag, vals, idx, n_bad = run()
    return device_get(diag, vals, idx, n_bad)  # audited surface


def full_diagnostics(self):
    return device_get(self._stacked_dev)    # the deferred bulk seam


def render_result(diag, idx, table):
    return np.asarray(idx).tolist(), diag.numpy(), table.cpu
"""),
    "kernel-dispatch": ("rca_tpu_torch/engine/good_dispatch.py", """\
from rca_tpu_torch.engine.registry import get_registry
from rca_tpu_torch.engine.runner import kernel_plan


def tick(n_pad, e_pad, src, dst, dev):
    # the registry IS the seam: asking it is how a surface dispatches
    plan = kernel_plan(n_pad, e_pad, src, dst, dev)
    return plan.kernel, get_registry()
"""),
    "rng-key-reuse": ("rca_tpu_torch/engine/good_rng.py", """\
import random

import numpy as np
import torch


def sample(seed, n, x):
    g = torch.Generator().manual_seed(seed)
    a = torch.rand(3, generator=g)
    x.normal_(generator=g)
    rng = np.random.default_rng(seed)
    b = rng.normal(size=3)
    # one seed, different families: different streams
    py = random.Random(seed)
    lanes = [np.random.default_rng(seed + i) for i in range(n)]
    return a, b, py, lanes
"""),
}


@pytest.mark.parametrize("rule", TORCH_RULES)
def test_torch_rule_fires_on_its_hazard(tmp_path, rule):
    rel, src, expected = TORCH_FIRE[rule]
    root = _fake_repo(tmp_path, (rel, src))
    got = run_lint(root=root, rules=[rule], use_baseline=False).findings
    assert len(got) == expected, got
    for f in got:
        assert f.path == rel and f.snippet


@pytest.mark.parametrize("rule", TORCH_RULES)
def test_torch_rule_clean_on_numpy_and_the_seams(tmp_path, rule):
    root = _fake_repo(tmp_path, TORCH_CLEAN[rule])
    result = run_lint(root=root, rules=[rule], use_baseline=False)
    assert result.clean, result.findings


def test_tick_sync_allows_copies_only_where_they_start(tmp_path):
    """``HostCopy`` in a dispatch is the copy-start the design needs;
    the same call in another function of the same module is flagged."""
    src = TORCH_CLEAN["tick-sync"][1].replace("def dispatch",
                                              "def prepare")
    root = _fake_repo(tmp_path, ("rca_tpu_torch/engine/streaming.py", src))
    got = run_lint(root=root, rules=["tick-sync"],
                   use_baseline=False).findings
    assert [(f.func, "HostCopy" in f.message) for f in got] == [
        ("prepare", True)]


def test_kernel_dispatch_seam_files_and_allowlist_are_load_bearing():
    rule = all_rules()["kernel-dispatch"]
    paths = sorted(rule.allow)
    assert run_lint(root=ROOT, rules=["kernel-dispatch"], paths=paths,
                    use_baseline=False).clean
    saved = rule.allow
    try:
        rule.allow = {}
        bare = run_lint(root=ROOT, rules=["kernel-dispatch"], paths=paths,
                        use_baseline=False)
    finally:
        rule.allow = saved
    assert {f.path for f in bare.findings} == set(paths)


# ---------------------------------------------------------------------------
# the repaired seams keep their behaviour
# ---------------------------------------------------------------------------

def test_build_error_text_comes_through_the_procs_seam():
    from rca_tpu_torch.kernels import build

    ok = build._start("ok", [sys.executable, "-c", "print('fine')"])
    build._finish([("ok", ok)], verbose=False)
    bad = build._start("bad", [
        sys.executable, "-c",
        "import sys; print('out line'); print('err line', file=sys.stderr);"
        " sys.exit(3)"])
    with pytest.raises(RuntimeError) as err:
        build._finish([("bad.cu", bad)], verbose=False)
    text = str(err.value)
    assert "nvcc failed on bad.cu (3)" in text
    assert "out line" in text and "err line" in text


def test_nvcc_found_through_cuda_home(tmp_path, monkeypatch):
    from rca_tpu_torch.kernels import build

    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\n")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    assert build.find_nvcc() == str(nvcc)
