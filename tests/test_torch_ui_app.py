"""The port's Streamlit app (``rca_tpu_torch/ui/app.py``) and ``ui``
against the JAX package's (``rca_tpu/ui/app.py``, ``python -m rca_tpu
ui``).

- the app imports without ``streamlit`` and ``plotly``;
- the Stream tab, driven by a scripted stand-in for ``st`` as the
  reference's own test drives it (``tests/test_cli_ui.py``), ranks on
  ``device="cpu"`` the rows the reference's tab ranks (components in
  order, scores at rtol 1e-5 / atol 1e-6), with its session-state keys,
  history and eviction; with no card and no device it raises;
- the chart dispatcher makes the reference's calls for every spec kind;
- ``_build_services`` honours ``RCA_FIXTURE`` and ``RCA_LOG_DIR`` and
  puts the coordinator on the device it is given; the script's
  ``--device`` reaches it;
- ``ui`` exits 1 without streamlit, with the reference's message in the
  port's terms; with a stand-in ``streamlit`` it launches ``streamlit
  run`` on the app with ``--server.port`` and ``-- --device``.
"""

from __future__ import annotations

import sys

import pytest
import torch

from rca_tpu.cli import main as ref_cli
from rca_tpu.cluster.fixtures import five_service_world as ref_five
from rca_tpu.cluster.mock_client import MockClusterClient as RefClient
from rca_tpu.ui.app import _render_chart as ref_render_chart
from rca_tpu.ui.app import _render_stream_tab as ref_render_stream_tab
from rca_tpu_torch.cli import main as port_cli
from rca_tpu_torch.cluster.fixtures import NS, five_service_world
from rca_tpu_torch.cluster.mock_client import MockClusterClient
from rca_tpu_torch.ui import app


class FakeSt:
    """The reference test's stand-in for ``st``: scripted buttons, the
    calls recorded."""

    def __init__(self, buttons):
        self.session_state = {}
        self._buttons = buttons  # label -> bool
        self.dataframes = []
        self.markdowns = []
        self.infos = []

    def button(self, label):
        return self._buttons.get(label, False)

    def checkbox(self, label, value=False, key=None):
        return False

    def dataframe(self, data):
        self.dataframes.append(data)

    def markdown(self, text):
        self.markdowns.append(text)

    def caption(self, text):
        pass

    def info(self, text):
        self.infos.append(text)

    def rerun(self):
        raise AssertionError("rerun must not fire without auto-poll")


@pytest.fixture
def clean_env(monkeypatch):
    for name in ("RCA_EXPLAIN", "RCA_COLUMNAR", "RCA_KERNEL",
                 "RCA_PIPELINE_DEPTH", "RCA_SHARD"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("RCA_KERNEL_CACHE", "off")


def test_app_imports_without_streamlit():
    assert app.__name__ == "rca_tpu_torch.ui.app"
    for name in ("streamlit", "plotly"):
        assert sys.modules.get(name) is None, name


def _drive(render, client, **device):
    """The reference test's script: no session, start + poll, a second
    poll, then a start for another namespace."""
    st = FakeSt({})
    render(st, client, NS, **device)
    assert st.infos and not st.dataframes
    st = FakeSt({"Start / reset stream": True, "Poll now": True})
    render(st, client, NS, **device)
    assert len(st.dataframes) == 2  # ranked + history
    first = st.dataframes[0]
    st2 = FakeSt({"Poll now": True})
    st2.session_state = st.session_state
    render(st2, client, NS, **device)
    second = st2.dataframes[0]
    state_key = f"live-stream-{NS}"
    history = st2.session_state[state_key]["history"]
    st3 = FakeSt({"Start / reset stream": True})
    st3.session_state = st2.session_state
    render(st3, client, "other-ns", **device)
    assert state_key not in st3.session_state
    assert "live-stream-other-ns" in st3.session_state
    return first, second, history


def _same_rows(port, ref):
    assert [r["component"] for r in port] == [r["component"] for r in ref]
    for p, r in zip(port, ref):
        assert sorted(p) == sorted(r)
        assert p["score"] == pytest.approx(r["score"], rel=1e-5, abs=1e-6)


def test_stream_tab_ranks_the_references_rows_on_the_cpu(clean_env):
    port = _drive(app._render_stream_tab,
                  MockClusterClient(five_service_world()), device="cpu")
    ref = _drive(ref_render_stream_tab, RefClient(ref_five()))
    for got, want in zip(port[:2], ref[:2]):
        _same_rows(got, want)
    assert port[0][0]["component"] == "database"
    assert [h["tick"] for h in port[2]] == [h["tick"] for h in ref[2]] \
        == [1, 2]
    for got, want in zip(port[2], ref[2]):
        assert sorted(got) == sorted(want)
        for key in ("tick", "quiet", "changed_rows", "upload_rows",
                    "resynced", "top"):
            assert got[key] == want[key], key


def test_stream_tab_history_keeps_the_last_fifty(clean_env):
    client = MockClusterClient(five_service_world())
    st = FakeSt({"Start / reset stream": True, "Poll now": True})
    app._render_stream_tab(st, client, NS, device="cpu")
    state = st.session_state[f"live-stream-{NS}"]
    state["history"] = [{"tick": -i} for i in range(60)]
    st2 = FakeSt({"Poll now": True})
    st2.session_state = st.session_state
    app._render_stream_tab(st2, client, NS, device="cpu")
    assert len(state["history"]) == 50
    assert state["history"][-1]["tick"] == 2
    assert state["live"].engine.device.type == "cpu"


def test_stream_tab_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card rule does not "
                    "apply")
    st = FakeSt({"Start / reset stream": True})
    with pytest.raises(RuntimeError, match="CUDA device"):
        app._render_stream_tab(st, MockClusterClient(five_service_world()),
                               NS)


class ChartSt:
    def __init__(self):
        self.calls = []

    def bar_chart(self, data):
        self.calls.append(("bar_chart", data))

    def dataframe(self, data, **kw):
        self.calls.append(("dataframe", data, kw))

    def caption(self, text):
        self.calls.append(("caption", text))


_CHARTS = {
    "bar_thresholds": {
        "kind": "bar", "title": "Utilization",
        "data": {"Pod/y (cpu)": 95.0},
        "thresholds": [{"value": 80, "label": "warn (80%)"},
                       {"value": 90, "label": "critical (90%)"}]},
    "bar_plain": {"kind": "bar", "title": "b", "data": {"x": 1, "y": 2}},
    "findings_table": {
        "kind": "findings_table", "title": "Findings",
        "data": [{"icon": "🔴", "severity": "critical",
                  "component": "Pod/x", "issue": "boom"}]},
    "pie": {"kind": "pie", "title": "p", "data": {"a": 2, "b": 3}},
    "sunburst": {"kind": "sunburst", "title": "s", "data": [
        {"id": "c", "parent": "", "value": 2, "color": "#fff"},
        {"id": "c/high", "parent": "c", "value": 2, "color": "#f00"}]},
    "bar_grouped": {"kind": "bar_grouped", "title": "g", "series": {
        "cpu": {"a": 1.0}, "memory": {"a": 2.0, "b": 3.0}}},
    "digraph": {"kind": "digraph", "title": "d", "data": [
        {"source": "a", "target": "b", "source_severity": "high",
         "target_severity": "low"}]},
    "table": {"kind": "table", "title": "t", "data": [{"a": 1}]},
}


@pytest.mark.parametrize("kind", sorted(_CHARTS))
def test_render_chart_makes_the_references_calls(monkeypatch, kind):
    for name in ("plotly", "plotly.graph_objects", "plotly.express"):
        monkeypatch.setitem(sys.modules, name, None)
    port, ref = ChartSt(), ChartSt()
    app._render_chart(port, _CHARTS[kind])
    ref_render_chart(ref, _CHARTS[kind])
    assert port.calls == ref.calls
    assert port.calls


def test_build_services_honours_the_fixture_and_the_device(
        monkeypatch, tmp_path):
    from rca_tpu_torch import obslog
    from rca_tpu_torch.obslog.prompts import PromptLogger

    monkeypatch.setenv("RCA_FIXTURE", "5svc")
    monkeypatch.setenv("RCA_LOG_DIR", str(tmp_path))
    monkeypatch.setattr(obslog, "get_logger",
                        lambda: PromptLogger(str(tmp_path / "prompts")))
    client, coord, store = app._build_services("cpu")
    assert isinstance(client, MockClusterClient)
    assert NS in client.get_namespaces()
    assert coord.device.type == "cpu"
    assert coord.cluster is client
    assert str(store.root) == str(tmp_path)
    assert coord.run_analysis("comprehensive", NS)["status"] == "completed"


def test_build_services_without_the_fixture_takes_the_live_client(
        monkeypatch, tmp_path):
    from rca_tpu_torch import obslog
    from rca_tpu_torch.cluster.k8s_client import K8sApiClient
    from rca_tpu_torch.obslog.prompts import PromptLogger

    monkeypatch.delenv("RCA_FIXTURE", raising=False)
    monkeypatch.setenv("RCA_LOG_DIR", str(tmp_path))
    monkeypatch.setenv("KUBECONFIG", str(tmp_path / "missing"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(obslog, "get_logger",
                        lambda: PromptLogger(str(tmp_path / "prompts")))
    client, coord, _ = app._build_services("cpu")
    assert isinstance(client, K8sApiClient)
    assert coord.device.type == "cpu"


def test_the_scripts_device_argument():
    assert app._device_arg(["--device", "cpu"]) == "cpu"
    assert app._device_arg([]) is None
    assert app._device_arg(["--server.port", "5000", "--device",
                            "cuda"]) == "cuda"


def test_ui_without_streamlit_exits_1_with_the_references_message(
        monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "streamlit", None)
    assert ref_cli(["ui"]) == 1
    ref_err = capsys.readouterr().err
    assert port_cli(["ui", "--device", "cpu"]) == 1
    port_err = capsys.readouterr().err
    assert "python -m rca_tpu_torch analyze --fixture 5svc" in port_err
    assert port_err == ref_err.replace("python -m rca_tpu analyze",
                                       "python -m rca_tpu_torch analyze")


@pytest.mark.parametrize("argv,device", [
    (["ui", "--port", "5123", "--device", "cpu"], "cpu"),
    (["ui"], "cuda"),
])
def test_ui_launches_streamlit_run_on_the_app(monkeypatch, tmp_path, argv,
                                              device):
    import subprocess

    pkg = tmp_path / "streamlit"
    pkg.mkdir()
    (pkg / "__init__.py").write_text('"""A stand-in streamlit."""\n')
    monkeypatch.syspath_prepend(str(tmp_path))
    # the stand-in leaves sys.modules with the test: no streamlit after
    monkeypatch.setitem(sys.modules, "streamlit", None)
    del sys.modules["streamlit"]
    calls = []

    def fake_call(cmd):
        calls.append(cmd)
        return 7

    monkeypatch.setattr(subprocess, "call", fake_call)
    assert port_cli(argv) == 7
    port = "5123" if "--port" in argv else "5000"
    assert calls == [[sys.executable, "-m", "streamlit", "run", app.__file__,
                      "--server.port", port, "--", "--device", device]]
    assert sys.modules["streamlit"].__file__.startswith(str(tmp_path))


def test_no_stand_in_streamlit_outlives_its_test():
    """Runs after the stand-in tests above (a file runs in order): the
    stand-in package they import is gone from ``sys.modules``."""
    assert sys.modules.get("streamlit") is None
