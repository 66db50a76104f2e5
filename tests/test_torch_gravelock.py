"""gravelock for the port (``rca_tpu_torch/analysis/concurrency``,
``rca_tpu_torch/analysis/rules/gravelock.py``) against the JAX package's
(``rca_tpu/analysis/concurrency``): the static rules give the reference's
findings on its fixtures written at the mapped paths, only the port's own
package is indexed and only its own imports resolve, the port's package is
statically clean with its thread families discovered as roots, the rsan
shim behind ``make_lock`` records as the reference's does and is absent
when off, and the cross-check's workloads (the 8-thread queue / metrics
barrage, a 40-tick chaos soak on the CPU, the serve metrics under eight
writers) run clean with the reference's totals."""

from __future__ import annotations

import json
import textwrap
import threading

import pytest

from rca_tpu.analysis import run_lint as ref_run_lint
from rca_tpu.analysis.__main__ import main as ref_main
from rca_tpu.analysis.concurrency import model_for as ref_model_for
from rca_tpu.analysis.concurrency import rsan as ref_rsan
from rca_tpu.analysis.concurrency.crosscheck import (
    order_contradictions as ref_order_contradictions,
)
from rca_tpu.analysis.concurrency.crosscheck import (
    queue_metrics_stress as ref_queue_metrics_stress,
)
from rca_tpu_torch.analysis import run_lint
from rca_tpu_torch.analysis.__main__ import main as port_main
from rca_tpu_torch.analysis.concurrency import model_for, rsan
from rca_tpu_torch.analysis.concurrency.crosscheck import (
    order_contradictions,
    queue_metrics_stress,
    run_rsan_crosscheck,
)
from rca_tpu_torch.analysis.concurrency.lockorder import analyze_lock_order
from rca_tpu_torch.analysis.concurrency.races import (
    analyze_class_attrs,
    analyze_races,
)
from rca_tpu_torch.analysis.core import repo_root
from rca_tpu_torch.util.threads import (
    make_condition,
    make_lock,
    make_rlock,
    make_thread,
    spawn,
)

ROOT = repo_root()


def _sanitizer(mod):
    """``mod``'s sanitizer on for the body, restored (and drained)."""
    was = mod.enabled()
    mod.enable()
    mod.RSAN.reset()
    try:
        yield mod.RSAN
    finally:
        mod.RSAN.reset()
        if not was:
            mod.disable()


@pytest.fixture
def sanitized():
    yield from _sanitizer(rsan)


@pytest.fixture
def ref_sanitized():
    yield from _sanitizer(ref_rsan)


def _fake_repo(root, *entries):
    for rel, src in entries:
        full = root / rel
        full.parent.mkdir(parents=True, exist_ok=True)
        full.write_text(textwrap.dedent(src))
    return str(root)


def _mapped(rel: str) -> str:
    assert rel.startswith("rca_tpu/"), rel
    return "rca_tpu_torch/" + rel[len("rca_tpu/"):]


def _port_source(src: str) -> str:
    """A fixture's source as the port would write it: its in-package
    imports name the port's package (lines do not move)."""
    return src.replace("rca_tpu.", "rca_tpu_torch.")


# ---------------------------------------------------------------------------
# the reference's static fixtures (tests/test_gravelock.py), both packages
# ---------------------------------------------------------------------------

WORKER = ("rca_tpu/serve/w.py", """\
import threading

class Worker:
    def __init__(self):
        self._lock = threading.Lock()
        self._done = 0
        self._thread = None

    def start(self):
        self._thread = threading.Thread(
            target=self._run, name="w", daemon=True
        )
        self._thread.start()

    def _run(self):
        self._done += 1

    def bump(self):
        with self._lock:
            self._done += 1
""")

BUDGET = ("rca_tpu/serve/b.py", """\
import threading

class Budget:
    def __init__(self):
        self.spent = 0

    def charge(self):
        self.spent += 1

class Owner:
    def __init__(self):
        self.budget = Budget()
        self.threads = [
            threading.Thread(
                target=self.work, name="worker", daemon=True
            )
            for _ in range(2)
        ]

    def work(self):
        self.budget.charge()
""")

STATS = ("rca_tpu/serve/p.py", """\
import threading

class Stats:
    def __init__(self):
        self.samples = []

    def record(self, x):
        self.samples.append(x)

class Guarded:
    def __init__(self):
        self._lock = threading.Lock()
        self.stats = Stats()
        self._thread = None

    def start(self):
        self._thread = threading.Thread(
            target=self._run, name="g", daemon=True
        )
        self._thread.start()

    def _run(self):
        with self._lock:
            self.stats.record(1)

class Unshared:
    def __init__(self):
        self.stats = Stats()

    def tick(self):
        self.stats.record(2)
""")

INVERTED = ("rca_tpu/serve/inverted.py", """\
import threading

class Pair:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()

    def forward(self):
        with self._a:
            self._inner_b()

    def _inner_b(self):
        with self._b:
            pass

    def backward(self):
        with self._b:
            with self._a:
                pass
""")

RAW = ("rca_tpu/x.py", """\
import threading
from threading import Lock

def bad(fn):
    a = threading.Lock()
    b = Lock()
    t = threading.Thread(target=fn)
    return a, b, t
""")

SEAM_USER = ("rca_tpu/y.py", """\
from rca_tpu.util.threads import make_lock, spawn

def good(fn):
    a = make_lock("y.a")
    return a, spawn(fn, name="worker")
""")

# a cycle whose two edges both cross a module boundary through an
# in-package import: it exists only where the imports resolve
GATE = ("rca_tpu/serve/gate.py", """\
import threading
from rca_tpu.serve.inner import take_inner

GATE = threading.Lock()


def forward():
    with GATE:
        take_inner()


def gate():
    with GATE:
        pass
""")

INNER = ("rca_tpu/serve/inner.py", """\
import threading
from rca_tpu.serve.gate import gate

INNER = threading.Lock()


def take_inner():
    with INNER:
        pass


def backward():
    with INNER:
        gate()
""")

#: case -> (rule, fixture files, findings each package must give)
CASES = {
    "unguarded_multiroot_write": ("race-guard", (WORKER,), 1),
    "shared_instance_across_spawned_copies": ("race-guard", (BUDGET,), 1),
    "distinct_instances_do_not_pair": ("race-guard", (STATS,), 0),
    "lock_order_cycle_with_chains": ("lock-order", (INVERTED,), 1),
    "thread_discipline": ("thread-discipline", (RAW, SEAM_USER), 3),
    "cycle_across_imported_functions": ("lock-order", (GATE, INNER), 1),
}


def _finding_key(f, port: bool):
    path = f.path
    message = f.message
    if port:
        assert path.startswith("rca_tpu_torch/"), path
        path = "rca_tpu/" + path[len("rca_tpu_torch/"):]
        message = message.replace("rca_tpu_torch/", "rca_tpu/")
    return (f.rule, path, f.line, f.func, message)


@pytest.mark.parametrize("case", sorted(CASES))
def test_static_rule_matches_the_reference_on_its_fixture(tmp_path, case):
    """The same fixture under ``rca_tpu/`` for the reference's lint and
    under ``rca_tpu_torch/`` for the port's: the same rule, path, line,
    function and message, the package's name apart."""
    rule, entries, expected = CASES[case]
    ref_root = _fake_repo(tmp_path / "ref", *entries)
    port_root = _fake_repo(tmp_path / "port", *(
        (_mapped(rel), _port_source(src)) for rel, src in entries))
    ref = ref_run_lint(root=ref_root, rules=[rule], use_baseline=False)
    port = run_lint(root=port_root, rules=[rule], use_baseline=False)
    assert len(ref.findings) == expected, ref.findings
    assert [_finding_key(f, True) for f in port.findings] == [
        _finding_key(f, False) for f in ref.findings]
    if case == "unguarded_multiroot_write":
        assert "dominant guard is `Worker._lock`" in port.findings[0].message
        assert port.findings[0].func == "_run"
    if case == "lock_order_cycle_with_chains":
        msg = port.findings[0].message
        assert "Pair._a -> Pair._b" in msg and "Pair._b -> Pair._a" in msg
        assert "Pair.forward" in msg and "Pair._inner_b" in msg
    if case == "thread_discipline":
        assert {f.path for f in port.findings} == {"rca_tpu_torch/x.py"}


def test_a_port_files_import_of_rca_tpu_resolves_to_nothing(tmp_path):
    """A root holding both packages, as this repository does: the port's
    model indexes ``rca_tpu_torch/`` alone, and a port file whose imports
    name ``rca_tpu.*`` resolves none of them — the cycle that the mapped
    imports close is not there."""
    entries = (GATE, INNER)
    root = _fake_repo(tmp_path, *entries, *(
        (_mapped(rel), src) for rel, src in entries))
    assert len(ref_run_lint(root=root, rules=["lock-order"],
                            use_baseline=False).findings) == 1
    port = run_lint(root=root, rules=["lock-order"], use_baseline=False)
    assert port.findings == []
    model = model_for(root)
    assert model.stats()["files"] == 2
    assert all(fi.relpath.startswith("rca_tpu_torch/")
               for fi in model.functions.values())
    assert model.static_order_edges() == set()

    mapped = tmp_path / "mapped"
    _fake_repo(mapped, *entries, *(
        (_mapped(rel), _port_source(src)) for rel, src in entries))
    assert model_for(str(mapped)).static_order_edges() == {
        ("serve.gate.GATE", "serve.inner.INNER"),
        ("serve.inner.INNER", "serve.gate.GATE")}


@pytest.mark.parametrize("static,observed", [
    ({("A", "B")}, [("B", "A")]),
    ({("A", "B")}, [("A", "B")]),
    (set(), [("A", "B"), ("B", "A")]),
    ({("A", "B"), ("B", "C")}, [("C", "A"), ("A", "B")]),
    ({("A", "B")}, [("C", "D")]),
])
def test_order_contradictions_agree_with_the_reference(static, observed):
    edges = {
        edge: {"count": i + 1, "threads": [f"t{i}"], "chain": list(edge)}
        for i, edge in enumerate(observed)
    }
    assert order_contradictions(static, edges) == ref_order_contradictions(
        static, edges)


# ---------------------------------------------------------------------------
# the port's own model
# ---------------------------------------------------------------------------

#: the port's thread families, by entry function (and multi-instance)
PORT_ROOTS = {
    "serve/loop.py::ServeLoop._run": False,
    "serve/replica.py::ReplicaWorker._run": False,
    "gateway/server.py::_GatewayHTTPServer._process_request_thread": False,
    "serve/federation.py::FederationPlane._route_loop": False,
    "serve/federation.py::FederationPlane._accept_loop": False,
    "serve/federation.py::FederationPlane._monitor_loop": False,
    "serve/federation.py::FederationPlane._conn_loop": True,
    "serve/autoscale.py::ThreadWorker._run": False,
    "serve/autoscale.py::AutoscaleController._run_loop": False,
    "cluster/watch_pump.py::_Pump.run": True,
    "serve/client.py::serve_selftest.submitter": True,
    "serve/federation.py::federation_selftest.submitter": True,
    "analysis/concurrency/crosscheck.py::queue_metrics_stress.submitter":
        True,
}


def test_port_thread_roots_discovered():
    roots = {r.entry: r for r in model_for(ROOT).roots}
    for entry, multi in PORT_ROOTS.items():
        root = roots.get(f"rca_tpu_torch/{entry}")
        assert root is not None, entry
        assert root.multi is multi, entry


def test_port_roots_are_the_references_at_the_mapped_paths():
    def table(model, prefix):
        return sorted((r.entry[len(prefix):], r.root_id, r.multi)
                      for r in model.roots)

    assert table(model_for(ROOT), "rca_tpu_torch/") == table(
        ref_model_for(ROOT), "rca_tpu/")


def test_port_is_statically_clean():
    """The empty-baseline criterion of the two rules over the port: no
    race, no class-attribute mutation, no lock-order cycle."""
    model = model_for(ROOT)
    assert analyze_races(model) == []
    assert analyze_class_attrs(model) == []
    assert analyze_lock_order(model) == []
    assert all(fi.relpath.startswith("rca_tpu_torch/")
               for fi in model.functions.values())
    stats = model.stats()
    assert stats["lock_graph_edges"] >= 1
    assert {"ServePool._route_lock", "RequestQueue._cond"} <= {
        lock for edge in model.static_order_edges() for lock in edge}


# ---------------------------------------------------------------------------
# the rsan shim behind make_lock
# ---------------------------------------------------------------------------

def test_constructors_return_bare_primitives_when_off():
    was = rsan.enabled()
    rsan.disable()
    try:
        assert isinstance(make_lock("t.lock"), type(threading.Lock()))
        assert isinstance(make_rlock("t.rlock"), type(threading.RLock()))
        assert type(make_condition("t.cond")) is threading.Condition
    finally:
        if was:
            rsan.enable()


def test_env_seeds_rsan(monkeypatch):
    monkeypatch.setenv("RCA_RSAN", "1")
    monkeypatch.setattr(rsan, "_ENABLED", None)
    assert rsan.enabled()
    assert isinstance(make_lock("t.env"), rsan.SanitizedLock)
    assert isinstance(make_rlock("t.env_r"), rsan.SanitizedLock)
    assert isinstance(make_condition("t.env_c"), rsan.SanitizedCondition)
    monkeypatch.setattr(rsan, "_ENABLED", False)
    assert isinstance(make_lock("t.off"), type(threading.Lock()))


def test_bounds_equal_the_references():
    for name in ("MAX_EDGES", "MAX_ACCESS_KEYS", "MAX_SAMPLES_PER_KEY"):
        assert getattr(rsan, name) == getattr(ref_rsan, name)


def test_rsan_records_order_edges_and_threads(sanitized):
    a = make_lock("T._a")
    b = make_lock("T._b")

    def nested():
        with a:
            with b:
                pass

    t = spawn(nested, name="edge-maker")
    t.join(10.0)
    nested()
    edges = sanitized.order_edges()
    assert ("T._a", "T._b") in edges
    rec = edges[("T._a", "T._b")]
    assert rec["count"] == 2
    assert set(rec["threads"]) >= {"edge-maker"}
    assert sanitized.lock_threads()["T._a"]


def test_reentrant_lock_records_no_self_edge(sanitized):
    r = make_rlock("T._r")
    with r:
        with r:
            assert rsan.held_locks() == ("T._r", "T._r")
        assert rsan.held_locks() == ("T._r",)
    assert rsan.held_locks() == ()
    assert sanitized.order_edges() == {}
    assert sanitized.acquires == 2


def test_rsan_observes_unguarded_write_pair(sanitized):
    lock = make_lock("T._lock")

    def guarded():
        with lock:
            rsan.note_access("Obj", "guarded")

    def unguarded():
        rsan.note_access("Obj", "naked")

    ts = [spawn(guarded, name=f"g{i}") for i in range(2)]
    ts += [spawn(unguarded, name=f"u{i}") for i in range(2)]
    for t in ts:
        t.join(10.0)
    keys = {(r["owner"], r["attr"]) for r in sanitized.races_observed()}
    assert ("Obj", "naked") in keys
    assert ("Obj", "guarded") not in keys


def test_sanitized_condition_wait_rebalances_held_stack(sanitized):
    cond = make_condition("T._cond")
    outcome = {}

    def waiter():
        with cond:
            cond.wait(0.05)
            outcome["held_after_wait"] = rsan.held_locks()
            outcome["woke"] = cond.wait_for(lambda: True, 0.05)
        outcome["held_after_exit"] = rsan.held_locks()

    t = spawn(waiter, name="waiter")
    t.join(10.0)
    assert outcome["held_after_wait"] == ("T._cond",)
    assert outcome["woke"] is True
    assert outcome["held_after_exit"] == ()


def test_inverted_order_caught_statically_and_dynamically(
        tmp_path, sanitized):
    """The same inversion is a static lock-order finding of the port AND
    an rsan order contradiction when executed."""
    rel, src = INVERTED
    root = _fake_repo(tmp_path, (_mapped(rel), src))
    static = run_lint(root=root, rules=["lock-order"], use_baseline=False)
    assert len(static.findings) == 1

    a = make_lock("Pair._a")
    b = make_lock("Pair._b")

    def forward():
        with a:
            with b:
                pass

    def backward():
        with b:
            with a:
                pass

    t1 = spawn(forward, name="fwd")
    t1.join(10.0)
    t2 = spawn(backward, name="bwd")
    t2.join(10.0)
    contradictions = order_contradictions(
        model_for(root).static_order_edges(), sanitized.order_edges())
    edges = {tuple(c["edge"]) for c in contradictions}
    assert ("Pair._a", "Pair._b") in edges
    assert ("Pair._b", "Pair._a") in edges


# ---------------------------------------------------------------------------
# the workloads and the cross-check
# ---------------------------------------------------------------------------

def test_queue_metrics_stress_equals_the_reference(sanitized,
                                                   ref_sanitized):
    """The seeded 8-thread barrage over the port's RequestQueue and
    ServeMetrics, every lock sanitized: the reference's exact totals for
    the same seed, and both hot locks contended across threads."""
    out = queue_metrics_stress(seed=11, threads=8)
    assert out["ok"], out
    lt = sanitized.lock_threads()
    assert len(lt["RequestQueue._cond"]) >= 2
    assert len(lt["ServeMetrics._lock"]) >= 2
    assert sanitized.races_observed() == []
    assert order_contradictions(model_for(ROOT).static_order_edges(),
                                sanitized.order_edges()) == []
    assert out == ref_queue_metrics_stress(seed=11, threads=8)
    assert len(ref_sanitized.lock_threads()["RequestQueue._cond"]) >= 2


def test_rsan_crosscheck_with_chaos_soak_on_the_cpu():
    out = run_rsan_crosscheck(seed=7, soak_ticks=40, device="cpu")
    assert out["ok"], json.dumps(
        {k: out[k] for k in ("contradictions", "races_observed",
                             "stress", "soak")}, default=str)
    assert out["soak"]["ticks"] == 40
    assert out["soak"]["uncaught_exceptions"] == 0
    assert out["soak"]["device"] == "cpu"
    assert out["contradictions"] == [] and out["races_observed"] == []
    assert len(out["multi_thread_locks"]) >= 2
    assert out["static_race_findings"] == []
    assert not rsan.enabled()


def test_soak_without_a_card_raises_and_leaves_rsan_off(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    was = rsan.enabled()
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            run_rsan_crosscheck(seed=7, soak_ticks=1, device=device)
    assert rsan.enabled() is was


def test_crosscheck_leaves_rsan_on_when_it_found_it_on(sanitized):
    out = run_rsan_crosscheck(seed=3)
    assert out["ok"] and out["soak"] is None
    assert rsan.enabled()


def test_cli_rsan_json_shape_matches_the_reference(tmp_path, capsys):
    ref_root = _fake_repo(tmp_path / "ref", ("rca_tpu/clean.py", "X = 1\n"))
    port_root = _fake_repo(tmp_path / "port",
                           ("rca_tpu_torch/clean.py", "X = 1\n"))
    assert ref_main(["--root", ref_root, "--no-baseline", "--json",
                     "--rsan"]) == 0
    ref = json.loads(capsys.readouterr().out)
    assert port_main(["--root", port_root, "--no-baseline", "--json",
                      "--rsan"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["clean"] is True and out["rsan"]["ok"] is True
    assert out["rsan"]["stress"]["ok"] is True
    assert out["rsan"]["contradictions"] == []
    assert set(out) == set(ref)
    assert set(out["rsan"]) == set(ref["rsan"])
    assert out["rsan"]["stress"] == ref["rsan"]["stress"]
    assert not rsan.enabled()


# ---------------------------------------------------------------------------
# the serve metrics under eight writers (the reference's gateway twin)
# ---------------------------------------------------------------------------

def test_metrics_snapshot_consistent_under_rsan(sanitized):
    """8 writer threads hammer every ServeMetrics surface while a reader
    snapshots concurrently: each snapshot is internally consistent, rsan
    observes no race and no order contradiction against the port's
    static graph, and the metrics lock was contended across threads."""
    from rca_tpu_torch.serve.metrics import ServeMetrics

    metrics = ServeMetrics()

    def writer(w: int) -> None:
        tenant = f"t{w % 3}"
        for i in range(300):
            metrics.submitted(tenant, i % 7)
            metrics.answered(tenant, float(i % 11))
            metrics.record_batch(1 + i % 4)
            metrics.replica_occupancy(w % 2, i % 5)
            metrics.replica_batch(w % 2, 1 + i % 4)
            if i % 50 == 0:
                metrics.stolen(w % 2, (w + 1) % 2, 1)

    threads = [make_thread(writer, name=f"metrics-writer-{w}", daemon=True,
                           args=(w,)) for w in range(8)]
    for t in threads:
        t.start()
    bad = []
    while any(t.is_alive() for t in threads):
        snap = metrics.snapshot()
        if sum(snap["occupancy"]) != snap["dispatched_requests"]:
            bad.append("occupancy-vs-dispatched")
        for tenant, counts in snap["counts"].items():
            if snap["queue_ms"].count(tenant) != counts["answered"]:
                bad.append(f"queue-samples-vs-answered:{tenant}")
        assert isinstance(metrics.summary()["tenants"], dict)
    for t in threads:
        t.join(30.0)
    assert not bad, bad
    final = metrics.snapshot()
    assert sum(final["occupancy"]) == final["dispatched_requests"]
    assert final["dispatched_requests"] == 8 * sum(
        1 + i % 4 for i in range(300))
    assert sanitized.races_observed() == []
    assert len(sanitized.lock_threads().get("ServeMetrics._lock", ())) >= 2
    assert order_contradictions(model_for(ROOT).static_order_edges(),
                                sanitized.order_edges()) == []


# ---------------------------------------------------------------------------
# the reference's race regressions, held on the port's copies
# ---------------------------------------------------------------------------

def test_retry_counter_is_thread_safe():
    """The reference's gravelock found ``Retry.retries_spent += 1``
    unguarded on an object both pump threads share; the port's copy keeps
    the fix: no lost update under a barrage."""
    from rca_tpu_torch.resilience.policy import Retry

    retry = Retry(attempts=2, sleep=lambda s: None, seed=0)
    n_threads, per_thread = 8, 400

    def worker():
        for _ in range(per_thread):
            retry.sleep_for(1)

    threads = [make_thread(worker, name=f"retry-{i}", daemon=True)
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
    assert retry.retries_spent == n_threads * per_thread


def test_watch_pump_tokens_unique_across_sets():
    """The reference's class-attribute token counter minted duplicates
    across namespaces' pump sets; the port's tokens are process-unique."""
    from rca_tpu_torch.cluster.watch_pump import WatchPumpSet

    sets = [WatchPumpSet(core_api=None, namespace=f"ns{i}")
            for i in range(4)]
    tokens: list = []
    lock = threading.Lock()

    def register_many(ps):
        got = [ps.register() for _ in range(50)]
        with lock:
            tokens.extend(got)

    threads = [make_thread(register_many, name=f"reg-{i}", daemon=True,
                           args=(ps,))
               for i, ps in enumerate(sets) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
    assert len(tokens) == len(set(tokens)) == 4 * 2 * 50
