"""The port's investigation store and its two loggers against the JAX
package's.

The store is the JAX package's file-locked JSON store, copied: every
lifecycle, cap and locking case of ``tests/test_store.py`` runs against
the port's copy; each package's store reads and writes files the other
wrote; the recorded investigation fixture loads and resumes in the port's
store with the port's coordinator; the serve plane's store notes and
explained provenance land through the port's ``ServeLoop(store=...)``, a
failing store never failing the response.
"""

import json
import multiprocessing
import os
import shutil
import threading

import numpy as np
import pytest

from rca_tpu.obslog import EvidenceLogger as RefEvidenceLogger
from rca_tpu.obslog import PromptLogger as RefPromptLogger
from rca_tpu.store import InvestigationStore as RefStore
from rca_tpu_torch.config import ServeConfig
from rca_tpu_torch.obslog import EvidenceLogger, PromptLogger
from rca_tpu_torch.serve import ServeLoop, ServeRequest
from rca_tpu_torch.store import ACCUMULATED_FINDINGS_CAP, InvestigationStore

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "recorded_investigation.json")


@pytest.fixture
def store(tmp_path):
    return InvestigationStore(root=str(tmp_path / "logs"))


def _fill(store, iid):
    store.add_message(iid, "user", "why is the db down?")
    store.add_message(iid, "assistant", {"summary": "crash loop"})
    store.set_next_actions(iid, [{"text": "check logs", "priority": "high"}])
    store.add_evidence(iid, "pod_status", {"phase": "Running"})
    store.add_agent_findings(iid, "logs", [{"issue": "oom"}])
    store.update_summary(iid, "database crash looping")
    store.save_hypothesis(iid, {"description": "bad init script"})
    store.add_accumulated_findings(iid, ["a", "b", "a"])
    store.set_recording_ref(iid, "/tapes/x.rcz")
    store.set_provenance(iid, {"schema": 1, "candidates": []})


def test_investigation_lifecycle(store):
    inv = store.create_investigation("DB down", namespace="prod")
    iid = inv["id"]
    assert inv["status"] == "active"
    assert set(inv) >= {
        "id", "title", "namespace", "context", "created_at", "updated_at",
        "summary", "status", "conversation", "evidence", "agent_findings",
        "next_actions", "accumulated_findings",
    }
    _fill(store, iid)
    got = store.get_investigation(iid)
    assert [m["role"] for m in got["conversation"]] == ["user", "assistant"]
    assert got["next_actions"][0]["priority"] == "high"
    assert got["evidence"]["pod_status"]["phase"] == "Running"
    assert got["agent_findings"]["logs"][0]["issue"] == "oom"
    assert got["summary"] == "database crash looping"
    assert got["hypotheses"][0]["description"] == "bad init script"
    assert got["accumulated_findings"] == ["a", "b"]
    assert store.get_recording_ref(iid) == "/tapes/x.rcz"
    assert store.get_provenance(iid) == {"schema": 1, "candidates": []}
    assert store.list_investigations()[0]["replayable"] is True


def test_accumulated_findings_and_title_caps_match_reference(tmp_path):
    port = InvestigationStore(root=str(tmp_path / "port"))
    ref = RefStore(root=str(tmp_path / "ref"))
    long_title = "t" * 200
    findings = [f"f{i}" for i in range(ACCUMULATED_FINDINGS_CAP + 5)]
    out = []
    for s in (port, ref):
        iid = s.create_investigation("x", investigation_id="same")["id"]
        s.add_accumulated_findings(iid, ["a", "b", "a"])
        s.add_accumulated_findings(iid, findings)
        s.set_title(iid, long_title)
        out.append(s.get_investigation(iid))
    p, r = out
    assert len(p["accumulated_findings"]) == ACCUMULATED_FINDINGS_CAP
    assert p["accumulated_findings"] == r["accumulated_findings"]
    assert p["title"] == r["title"]


def test_list_sorted_newest_first(store):
    a = store.create_investigation("first")
    store.create_investigation("second")
    store.add_message(a["id"], "user", "bump")  # a updated most recently
    lst = store.list_investigations()
    assert [r["title"] for r in lst] == ["first", "second"]
    assert lst[0]["messages"] == 1


def test_missing_investigation_returns_none(store):
    assert store.get_investigation("nope") is None
    assert store.add_message("nope", "user", "x") is None


def _writer(args):
    root, iid, start = args
    store = InvestigationStore(root=root)
    for i in range(start, start + 20):
        store.add_message(iid, "user", f"m{i}")
    return True


def test_concurrent_writers_do_not_lose_messages(store):
    """Three processes appending to one investigation lose nothing."""
    iid = store.create_investigation("race")["id"]
    with multiprocessing.get_context("spawn").Pool(3) as pool:
        pool.map(_writer, [(str(store.root), iid, k * 100) for k in range(3)])
    assert len(store.get_investigation(iid)["conversation"]) == 60


def test_lock_released_when_writer_crashes_mid_update(store):
    """A writer that raises inside the locked read-modify-write releases
    the lock: the next writer proceeds."""
    iid = store.create_investigation("crash")["id"]

    def crasher():
        def mutate(_inv):
            raise RuntimeError("worker crash mid-update")

        with pytest.raises(RuntimeError):
            store._update(iid, mutate)

    t = threading.Thread(target=crasher)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    done = []
    t2 = threading.Thread(
        target=lambda: done.append(store.add_message(iid, "user", "after")))
    t2.start()
    t2.join(timeout=10)
    assert done and done[0] is not None
    got = store.get_investigation(iid)
    assert [m["content"] for m in got["conversation"]] == ["after"]


def test_delete_and_update_status(store):
    iid = store.create_investigation("temp", namespace="x")["id"]
    store.update_status(iid, "resolved")
    assert store.get_investigation(iid)["status"] == "resolved"
    assert store.delete_investigation(iid) is True
    assert store.get_investigation(iid) is None
    assert store.delete_investigation(iid) is False


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_package_reads_the_others_files(writer, tmp_path):
    """A file written by one package's store reads, lists and takes
    further writes in the other's, byte for byte the same layout."""
    root = str(tmp_path / "logs")
    first, second = ((InvestigationStore, RefStore) if writer == "port"
                     else (RefStore, InvestigationStore))
    a = first(root=root)
    iid = a.create_investigation("cross", namespace="prod",
                                 investigation_id="inv-x")["id"]
    _fill(a, iid)
    b = second(root=root)
    assert b.get_investigation(iid) == a.get_investigation(iid)
    assert b.list_investigations() == a.list_investigations()
    b.add_message(iid, "user", "continued")
    b.add_accumulated_findings(iid, ["c"])
    got = a.get_investigation(iid)
    assert got["conversation"][-1]["content"] == "continued"
    assert got["accumulated_findings"] == ["a", "b", "c"]


def test_store_files_equal_across_packages(tmp_path, monkeypatch):
    """The same calls with frozen clocks and ids write the same bytes."""
    from rca_tpu.store import investigations as ref_mod
    from rca_tpu_torch.store import investigations as port_mod

    for mod in (ref_mod, port_mod):
        monkeypatch.setattr(mod, "_now", lambda: "2026-01-01T00:00:00+00:00")
    paths = []
    for cls, name in ((InvestigationStore, "port"), (RefStore, "ref")):
        s = cls(root=str(tmp_path / name))
        iid = s.create_investigation("same", namespace="ns",
                                     investigation_id="fixed")["id"]
        _fill(s, iid)
        s.record_chat_turn(iid, "q?", {"response_data": {"points": ["p"]},
                                       "suggestions": [{"text": "s"}],
                                       "key_findings": ["k"],
                                       "summary": "sum"})
        paths.append(tmp_path / name / "fixed.json")
    assert paths[0].read_bytes() == paths[1].read_bytes()


def test_recorded_investigation_fixture_resumes(tmp_path):
    """The committed recorded investigation loads in the port's store and
    resumes: its accumulated findings feed the port coordinator's next
    turn, which equals the reference coordinator's."""
    from rca_tpu.cluster.fixtures import five_service_world as ref_five
    from rca_tpu.cluster.mock_client import MockClusterClient as RefClient
    from rca_tpu.coordinator import RCACoordinator as RefCoordinator
    from rca_tpu_torch.cluster.fixtures import five_service_world
    from rca_tpu_torch.cluster.mock_client import MockClusterClient
    from rca_tpu_torch.coordinator import RCACoordinator

    root = tmp_path / "logs"
    root.mkdir()
    shutil.copy(FIXTURE, root / "rec-0001-fixture.json")
    store = InvestigationStore(root=str(root))
    assert [r["id"] for r in store.list_investigations()] == [
        "rec-0001-fixture"]
    inv = store.get_investigation("rec-0001-fixture")
    assert inv["title"] == "Database crash loop"
    assert inv["namespace"] == "test-microservices"
    assert len(inv["conversation"]) == 2
    assert inv["conversation"][1]["content"]["response_data"]["points"]
    assert inv["next_actions"] and inv["accumulated_findings"]
    top = inv["agent_findings"]["comprehensive"]["root_causes"][0]
    assert top["component"] == "database"

    query = "what should I fix first?"
    out = RCACoordinator(MockClusterClient(five_service_world()),
                         backend="deterministic", device="cpu"
                         ).process_user_query(
        query, inv["namespace"],
        previous_findings=inv["accumulated_findings"])
    ref = RefCoordinator(RefClient(ref_five()), backend="deterministic"
                         ).process_user_query(
        query, inv["namespace"],
        previous_findings=inv["accumulated_findings"])
    out.pop("timestamp"), ref.pop("timestamp")
    assert json.dumps(out, sort_keys=True) == json.dumps(ref, sort_keys=True)
    store.record_chat_turn("rec-0001-fixture", query, out)
    resumed = store.get_investigation("rec-0001-fixture")
    assert len(resumed["conversation"]) == 4
    # the reference's store reads the resumed file
    assert RefStore(root=str(root)).get_investigation(
        "rec-0001-fixture") == resumed


# -- the serve plane's store notes ---------------------------------------------

def _serve_stub_parts(explain_block=None):
    """Device-free serve-loop parts: a stub dispatcher whose results carry
    a ranking, an engine name and (for explained requests) a block."""

    class _Handle:
        def __init__(self, requests, at):
            self.requests, self.dispatched_at = requests, at

    class _Result:
        ranked = [{"component": "svc-0", "score": 1.0}]
        engine = "stub"

        def attribution(self):
            return explain_block

    class _Stub:
        engine = None

        def dispatch(self, batch, now=None):
            return _Handle(list(batch), now if now is not None else 0.0)

        def fetch(self, handle):
            return [_Result() for _ in handle.requests]

    feats = np.ones((8, 4), np.float32)
    src = np.arange(7, dtype=np.int32)
    dst = np.arange(1, 8, dtype=np.int32)
    return _Stub(), feats, src, dst


def test_serve_path_concurrent_appends_no_lost_updates(store):
    """Submitter threads write user messages while the serve worker
    appends one serve note per request to the same investigation: the
    store's locking loses nothing."""
    stub, feats, src, dst = _serve_stub_parts()
    iid = store.create_investigation("serve stress")["id"]
    loop = ServeLoop(config=ServeConfig(max_batch=4, max_wait_us=0,
                                        queue_cap=256),
                     dispatcher=stub, store=store).start()
    n, workers = 32, 8
    reqs = [None] * n

    def submitter(w):
        for i in range(w, n, workers):
            store.add_message(iid, "user", f"query-{i}")
            reqs[i] = ServeRequest(tenant=f"t{w}", features=feats,
                                   dep_src=src, dep_dst=dst,
                                   investigation_id=iid)
            loop.submit(reqs[i])

    threads = [threading.Thread(target=submitter, args=(w,))
               for w in range(workers)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        resps = [r.result(60.0) for r in reqs]
    finally:
        loop.stop()
    assert all(r.status == "ok" for r in resps)
    roles = [m["role"] for m in store.get_investigation(iid)["conversation"]]
    assert roles.count("user") == n
    assert roles.count("serve") == n
    note = next(m["content"] for m in store.get_investigation(iid)[
        "conversation"] if m["role"] == "serve")
    assert sorted(note) == ["engine", "request_id", "tenant", "top_component"]
    assert note["top_component"] == "svc-0" and note["engine"] == "stub"


def test_explained_request_lands_its_provenance(store, tmp_path):
    """An explained request naming an investigation stores its provenance
    block before the response completes, and a recorder's path lands as
    the recording_ref; ``why`` then renders the block."""
    from rca_tpu_torch.cli import main
    from rca_tpu_torch.replay import Recorder

    block = {"schema": 1, "k": 0, "candidates": [], "evidence_rows": []}
    stub, feats, src, dst = _serve_stub_parts(block)
    iid = store.create_investigation("explained")["id"]
    rec = Recorder(str(tmp_path / "tape"))
    loop = ServeLoop(config=ServeConfig(max_wait_us=0), dispatcher=stub,
                     store=store, recorder=rec).start()
    try:
        req = ServeRequest(tenant="t", features=feats, dep_src=src,
                           dep_dst=dst, investigation_id=iid, explain=True)
        loop.submit(req)
        resp = req.result(30.0)
    finally:
        loop.stop()
        rec.close()
    assert resp.status == "ok" and resp.provenance == block
    got = store.get_investigation(iid)
    assert got["provenance"] == block
    assert got["recording_ref"] == rec.path
    assert main(["why", iid, "--log-dir", str(store.root), "--json",
                 "--compact"]) == 0


def test_serve_store_failure_does_not_fail_response():
    """A store that raises on every write is a recorded fault, never a
    failed response."""
    block = {"schema": 1, "candidates": []}
    stub, feats, src, dst = _serve_stub_parts(block)

    class _BrokenStore:
        def add_message(self, *a, **kw):
            raise OSError("disk full")

        def set_provenance(self, *a, **kw):
            raise OSError("disk full")

    loop = ServeLoop(config=ServeConfig(max_wait_us=0), dispatcher=stub,
                     store=_BrokenStore()).start()
    try:
        reqs = [ServeRequest(tenant="t", features=feats, dep_src=src,
                             dep_dst=dst, investigation_id="whatever",
                             explain=explain) for explain in (False, True)]
        for req in reqs:
            loop.submit(req)
        resps = [req.result(30.0) for req in reqs]
    finally:
        loop.stop()
    assert [r.status for r in resps] == ["ok", "ok"]
    assert resps[1].provenance == block


def test_serve_client_submit_carries_the_investigation(store):
    from rca_tpu_torch.serve import ServeClient

    stub, feats, src, dst = _serve_stub_parts()
    iid = store.create_investigation("client")["id"]
    loop = ServeLoop(config=ServeConfig(max_wait_us=0), dispatcher=stub,
                     store=store).start()
    try:
        req = ServeClient(loop).submit(feats, src, dst, tenant="t",
                                       investigation_id=iid)
        assert req.investigation_id == iid
        assert req.result(30.0).status == "ok"
    finally:
        loop.stop()
    roles = [m["role"] for m in store.get_investigation(iid)["conversation"]]
    assert roles == ["serve"]


# -- the loggers ------------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_evidence_logger_roundtrip(pkg, tmp_path):
    cls = EvidenceLogger if pkg == "port" else RefEvidenceLogger
    ev = cls(root=str(tmp_path / "ev"))
    p1 = ev.log_hypothesis("inv1", "Pod/db",
                           {"description": "liveness probe failing"},
                           evidence={"restarts": 5})
    ev.log_investigation_step(
        "inv1", "Pod/db", {"description": "check logs"}, result="logs ok",
        verdict={"verdict": "refuted", "confidence": 0.8})
    ev.log_conclusion("inv1", "Pod/db", {"root_cause": "bad probe"})
    assert p1.name.endswith("_hypothesis.json")
    assert json.loads(p1.read_text())["investigation_id"] == "inv1"
    assert len(ev.get_evidence_for_hypothesis("liveness probe")) == 1
    assert ev.get_evidence_for_hypothesis("unrelated") == []
    # the other package's logger finds the same evidence in these files
    other = (RefEvidenceLogger if pkg == "port" else EvidenceLogger)(
        root=str(tmp_path / "ev"))
    assert (other.get_evidence_for_hypothesis("liveness probe")
            == ev.get_evidence_for_hypothesis("liveness probe"))
    assert sorted(p.name[15:] for p in (tmp_path / "ev").iterdir()) == [
        "_Pod-db_bad-probe_conclusion.json",
        "_Pod-db_check-logs_step.json",
        "_Pod-db_liveness-probe-failing_hypothesis.json"]


def test_loggers_default_to_rca_log_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("RCA_LOG_DIR", str(tmp_path / "custom"))
    assert EvidenceLogger().root == tmp_path / "custom" / "evidence"
    assert PromptLogger().root == tmp_path / "custom" / "prompts"
    assert InvestigationStore().root == tmp_path / "custom"


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_prompt_logger_jsonl_format(pkg, tmp_path):
    cls = PromptLogger if pkg == "port" else RefPromptLogger
    pl = cls(root=str(tmp_path / "prompts"))
    pl.log_interaction(
        "the prompt", "the response", investigation_id="inv9",
        user_query="why?", namespace="prod", accumulated_findings=["f1"],
        additional_context={"provider": "offline", "model": "m",
                            "temperature": 0.2})
    pl.log_system_event("provider_failover", {"from": "openai"})
    records = pl.read_all()
    assert len(records) == 2
    assert set(records[0]) == {
        "timestamp", "investigation_id", "user_query", "prompt", "response",
        "namespace", "accumulated_findings", "additional_context",
    }
    assert records[0]["additional_context"]["provider"] == "offline"
    assert (records[1]["additional_context"]["system_event"]
            == "provider_failover")


def test_prompt_logger_llm_adapter(tmp_path):
    from rca_tpu_torch.llm import LLMClient, OfflineProvider

    pl = PromptLogger(root=str(tmp_path / "prompts"))
    llm = LLMClient(provider=OfflineProvider(),
                    log_fn=pl.as_log_fn(investigation_id="inv1",
                                        namespace="ns"))
    llm.generate_completion("hello")
    records = pl.read_all()
    assert records[0]["investigation_id"] == "inv1"
    assert records[0]["additional_context"]["provider"] == "offline"
