"""Streamlit chat UI over the port's coordinator (thin — all logic lives
below; the twin of ``rca_tpu.ui.app``).

Surface parity with the JAX package's UI: the chat loop with suggestion
buttons, the investigation list and connection status, the 4-stage
wizard, the tabbed report, the topology view and the live Stream tab.
Run via ``python -m rca_tpu_torch ui --device cuda`` or ``streamlit run
rca_tpu_torch/ui/app.py -- --device cuda``.  It imports without
``streamlit`` or ``plotly``: both are imported inside the functions that
draw.

Device rule: the coordinator and the Stream tab's live session run on the
device the script's arguments name (``--device``), the card unless
``cpu``; with no card and no ``--device cpu`` they raise, as every entry
point of the port does.
"""

from __future__ import annotations

import argparse
import sys

from rca_tpu_torch.config import env_str
from rca_tpu_torch.ui.render import (
    analysis_chart_series,
    comprehensive_chart_series,
    analysis_viz_data,
    correlated_markdown,
    diagnostic_timeline_markdown,
    finding_markdown,
    initial_suggestions,
    report_markdown,
    response_markdown,
    root_causes_markdown,
    topology_plot_data,
)


def _build_services(device=None):
    """Construct client/coordinator/store once per session: the fixture
    world when ``RCA_FIXTURE`` is set, else the live cluster; the
    coordinator on ``device``."""
    from rca_tpu_torch.coordinator import RCACoordinator
    from rca_tpu_torch.llm import LLMClient, make_provider
    from rca_tpu_torch.obslog import EvidenceLogger, get_logger
    from rca_tpu_torch.store import InvestigationStore

    fixture = env_str("RCA_FIXTURE", "")
    if fixture:
        from rca_tpu_torch.cluster.fixtures import five_service_world
        from rca_tpu_torch.cluster.mock_client import MockClusterClient

        client = MockClusterClient(five_service_world())
    else:
        from rca_tpu_torch.cluster.k8s_client import K8sApiClient

        client = K8sApiClient()
    store = InvestigationStore()
    prompt_logger = get_logger()
    llm = LLMClient(
        provider=make_provider(), log_fn=prompt_logger.as_log_fn()
    )
    coord = RCACoordinator(
        client, llm_client=llm, evidence_logger=EvidenceLogger(),
        device=device,
    )
    return client, coord, store


def _device_arg(argv=None):
    """The ``--device`` of the script's arguments (after streamlit's
    ``--``): ``cuda`` unless ``cpu`` is named."""
    p = argparse.ArgumentParser(prog="rca_tpu_torch.ui.app")
    p.add_argument("--device", default=None,
                   help="cuda | cpu (default: cuda)")
    args, _ = p.parse_known_args(sys.argv[1:] if argv is None else argv)
    return args.device


def main() -> None:  # pragma: no cover - needs streamlit runtime
    import streamlit as st

    st.set_page_config(page_title="K8s RCA (GPU)", layout="wide")

    if "services" not in st.session_state:
        st.session_state.services = _build_services(_device_arg())
    client, coord, store = st.session_state.services

    # deep link: restore the investigation named in the URL
    # (?investigation=<id>, reference: app.py:88-105)
    url_inv = st.query_params.get("investigation")
    if url_inv and st.session_state.get("investigation_id") != url_inv:
        if store.get_investigation(url_inv):
            st.session_state.investigation_id = url_inv
        else:
            # unknown id: drop it so the URL can't keep advertising an
            # investigation this store doesn't have
            st.warning(f"Investigation {url_inv!r} not found in this store.")
            del st.query_params["investigation"]

    # ---- sidebar: investigations + connection (reference: sidebar.py) ----
    with st.sidebar:
        st.title("Investigations")
        connected = client.is_connected()
        st.caption(
            ("🟢 connected: " + client.get_cluster_info().get("name", ""))
            if connected else "🔴 no cluster — mock/offline mode"
        )
        # gate on the REAL API probe, not is_connected(): the latter is
        # True whenever kubectl is merely installed, which is exactly the
        # degraded state the repair flow exists for
        api_connected = bool(
            client.get_cluster_info().get("connected", connected)
        )
        if st.session_state.pop("repair-ok", False):
            st.success("Kubeconfig updated — reconnected.")
        if not api_connected and hasattr(client, "update_server_url"):
            # endpoint repair for tunneled clusters whose public URL rotated
            # (reference: components/sidebar.py:160-189 ngrok repair flow)
            with st.expander("Connection repair"):
                new_url = st.text_input(
                    "New API server URL", key="repair-url",
                    placeholder="https://<tunnel-host>:443",
                )
                if st.button("Update kubeconfig & reconnect") and new_url:
                    if client.update_server_url(new_url):
                        # flag survives the rerun; success renders above
                        st.session_state["repair-ok"] = True
                        st.rerun()
                    else:
                        errs = client.get_cluster_info().get("errors", [])
                        st.error(
                            "Repair failed: "
                            + (errs[-1]["error"] if errs else "unknown error")
                        )
        # kube-context picker for live clients (reference: sidebar.py
        # namespace/context pickers) — only when more than one exists.
        # Switching is behind an EXPLICIT button: auto-switch-on-change
        # would fire on plain render when no current-context is set, and
        # would retry a failed (blocking) connect on every rerun
        if hasattr(client, "list_contexts"):
            ctxs = client.list_contexts()
            if len(ctxs.get("contexts", [])) > 1:
                chosen = st.selectbox(
                    "Context", ctxs["contexts"],
                    index=(
                        ctxs["contexts"].index(ctxs["current"])
                        if ctxs.get("current") in ctxs["contexts"] else 0
                    ),
                )
                if chosen != ctxs.get("current") and st.button(
                    f"Switch to {chosen}"
                ):
                    if client.switch_context(chosen):
                        st.rerun()
                    else:
                        st.error(f"Could not connect to context {chosen!r}")
        namespaces = client.get_namespaces() or ["default"]
        namespace = st.selectbox("Namespace", namespaces)
        if st.button("New investigation"):
            inv = store.create_investigation(
                "New investigation", namespace=namespace
            )
            st.session_state.investigation_id = inv["id"]
            st.query_params["investigation"] = inv["id"]
            st.session_state.pop("suggestions", None)
            st.rerun()
        for row in store.list_investigations()[:15]:
            if st.button(
                f"{row['title'][:40]} · {row['messages']} msgs",
                key=f"inv-{row['id']}",
            ):
                st.session_state.investigation_id = row["id"]
                st.query_params["investigation"] = row["id"]
                st.rerun()

    inv_id = st.session_state.get("investigation_id")
    if not inv_id:
        inv = store.create_investigation("New investigation",
                                         namespace=namespace)
        inv_id = st.session_state.investigation_id = inv["id"]
        st.query_params["investigation"] = inv_id  # URL mirrors the view
    investigation = store.get_investigation(inv_id) or {}

    st.title("Kubernetes Root Cause Analysis")
    # view navigation with ?view= deep links (reference: app.py:88-105
    # reads ?investigation=<id>&view=chat): a radio nav (not st.tabs,
    # which cannot be preselected programmatically) restores the view
    # named in the URL and writes the user's choice back to it
    views = ["Chat", "Report", "Topology", "Investigate", "Stream"]
    url_view = str(st.query_params.get("view", "")).lower()
    default_idx = next(
        (i for i, v in enumerate(views) if v.lower() == url_view), 0
    )
    view = st.radio(
        "View", views, index=default_idx, horizontal=True,
        label_visibility="collapsed",
    )
    if st.query_params.get("view") != view.lower():
        st.query_params["view"] = view.lower()

    # per-namespace session keys: results/topology/wizard state from one
    # namespace must not leak into another after a sidebar switch
    results_key = f"last_results-{namespace}"
    topology_key = f"topology-{namespace}"
    wizard_key = f"wizard-{namespace}"

    # ---- chat view (reference: chatbot_interface.py) ---------------------
    if view == "Chat":
        for msg in investigation.get("conversation", []):
            with st.chat_message(msg["role"]):
                content = msg["content"]
                if isinstance(content, dict):
                    st.markdown(
                        response_markdown(content.get("response_data", {}))
                    )
                else:
                    st.markdown(str(content))

        suggestions = (
            investigation.get("next_actions")
            or initial_suggestions(namespace)
        )
        cols = st.columns(min(len(suggestions), 5) or 1)
        clicked = None
        for i, (col, sugg) in enumerate(zip(cols, suggestions)):
            with col:
                # index-keyed: suggestion texts can repeat across turns
                if st.button(sugg["text"], key=f"sugg-{i}"):
                    clicked = sugg

        query = st.chat_input("Ask about the cluster…")
        if clicked is not None:
            store.add_message(inv_id, "user", clicked["text"])
            out = coord.process_suggestion(
                clicked.get("action", {}), namespace,
                investigation.get("accumulated_findings"),
            )
            store.add_message(
                inv_id, "assistant", {"response_data": out["response"]}
            )
            store.set_next_actions(inv_id, out["suggestions"])
            store.add_accumulated_findings(inv_id, out["key_findings"])
            st.rerun()
        elif query:
            out = coord.process_user_query(
                query, namespace, investigation.get("accumulated_findings")
            )
            store.record_chat_turn(inv_id, query, out)
            if len(investigation.get("conversation", [])) == 0:
                title = coord.generate_summary_from_query(query, out)
                store.set_title(inv_id, title)
            st.rerun()

    # ---- report view (reference: report.py:57-196 tabbed report) ---------
    elif view == "Report":
        if st.button("Run comprehensive analysis"):
            with st.spinner(f"Analyzing ({coord.device.type})…"):
                record = coord.run_analysis("comprehensive", namespace)
            if record.get("status") != "completed":
                st.error(
                    "Analysis failed: "
                    + str(record.get("error", "unknown error"))
                )
                # don't render a previous run's results under the error
                st.session_state.pop(results_key, None)
            else:
                st.session_state[results_key] = record.get("results", {})
                store.add_agent_findings(inv_id, "comprehensive", record)
        results = st.session_state.get(results_key)
        if results:
            if results.get("degraded"):
                st.warning(results["degraded"]["note"])
            agent_types = [
                a for a in ("resources", "metrics", "logs", "events",
                            "topology", "traces")
                if isinstance(results.get(a), dict)
            ]
            sub = st.tabs(["Root Causes", "Correlated"] + agent_types)
            with sub[0]:
                st.markdown(
                    root_causes_markdown(results.get("correlated", {}))
                )
                # cross-agent overview (reference: visualization.py:38-236)
                for chart in comprehensive_chart_series(results):
                    st.caption(chart["title"])
                    _render_chart(st, chart)
                with st.expander("Full report"):
                    st.markdown(report_markdown(results))
            with sub[1]:
                st.markdown(correlated_markdown(results.get("correlated", {})))
            for tab, agent in zip(sub[2:], agent_types):
                with tab:
                    res = results[agent]
                    st.markdown(res.get("summary", ""))
                    viz = analysis_viz_data(agent, res)
                    for chart in analysis_chart_series(viz):
                        st.caption(chart["title"])
                        _render_chart(st, chart)
                    if agent == "topology" and viz.get("graph"):
                        st.caption("Dependency graph")
                        st.json(topology_plot_data(viz["graph"]))
                    with st.expander("Finding details"):
                        for f in res.get("findings", [])[:12]:
                            st.markdown(finding_markdown(f))

    # ---- topology view (reference: visualization.py) ---------------------
    elif view == "Topology":
        if st.button("Build topology graph"):
            ctx = coord.capture(namespace)
            st.session_state[topology_key] = ctx.graph.to_dict()
        graph = st.session_state.get(topology_key)
        if graph:
            data = topology_plot_data(graph)
            try:
                import plotly.graph_objects as go

                fig = go.Figure()
                for e in data["edges"]:
                    fig.add_trace(
                        go.Scatter(
                            x=[e["x0"], e["x1"]], y=[e["y0"], e["y1"]],
                            mode="lines", line={"width": 1},
                            hoverinfo="none", showlegend=False,
                        )
                    )
                # one trace per node type -> colored legend (reference:
                # components/visualization.py:647-764 node-type colors)
                type_colors = {
                    "service": "#1f77b4", "workload": "#2ca02c",
                    "ingress": "#d62728", "configmap": "#9467bd",
                    "secret": "#8c564b",
                }
                by_type = {}
                for node in data["nodes"]:
                    by_type.setdefault(node["type"] or "other", []).append(node)
                for ntype, members in sorted(by_type.items()):
                    fig.add_trace(
                        go.Scatter(
                            x=[n["x"] for n in members],
                            y=[n["y"] for n in members],
                            text=[n["id"] for n in members],
                            name=ntype,
                            mode="markers+text", textposition="top center",
                            marker={"size": 10,
                                    "color": type_colors.get(ntype, "#7f7f7f")},
                        )
                    )
                st.plotly_chart(fig, use_container_width=True)
            except ImportError:
                st.json(data)

    # ---- guided 4-stage wizard (reference: interactive_session.py) -------
    elif view == "Investigate":
        from rca_tpu_torch.ui.render import wizard_stage_markdown

        wiz = st.session_state.setdefault(wizard_key, {"stage": 0})
        st.markdown(wizard_stage_markdown(wiz))

        if wiz["stage"] == 0:
            results = st.session_state.get(results_key)
            if not results:
                st.info("Run a comprehensive analysis in the Report tab "
                        "first, then pick a finding to investigate.")
            else:
                findings = [
                    f
                    for res in results.values()
                    if isinstance(res, dict)
                    for f in res.get("findings", [])
                ]
                findings.sort(
                    key=lambda f: ["info", "low", "medium", "high",
                                   "critical"].index(
                        str(f.get("severity", "info")).lower()
                    ),
                    reverse=True,
                )
                for i, f in enumerate(findings[:12]):
                    if st.button(
                        f"{f['component']}: {f['issue'][:60]}",
                        key=f"wiz-f{i}",
                    ):
                        wiz.update(
                            {"stage": 1, "finding": f,
                             "component": f["component"]}
                        )
                        st.rerun()

        elif wiz["stage"] == 1:
            if "hypotheses" not in wiz:
                with st.spinner("Generating hypotheses…"):
                    wiz["hypotheses"] = coord.generate_hypotheses(
                        wiz["component"], wiz["finding"], namespace,
                        investigation_id=inv_id,
                    )
            for i, h in enumerate(wiz["hypotheses"]):
                if st.button(
                    f"{h['description'][:70]} ({h['confidence']:.0%})",
                    key=f"wiz-h{i}",
                ):
                    wiz.update(
                        {"stage": 2, "hypothesis": h, "executed": [],
                         "plan": coord.get_investigation_plan(h, namespace)}
                    )
                    st.rerun()

        elif wiz["stage"] == 2:
            plan = wiz["plan"]
            done = len(wiz["executed"])
            for i, step in enumerate(plan["steps"]):
                mark = "✅" if i < done else "⚪"
                st.markdown(f"{mark} {step['description']}")
            if done < len(plan["steps"]):
                if st.button("Execute next step"):
                    with st.spinner("Gathering evidence…"):
                        out = coord.execute_investigation_step(
                            plan["steps"][done], wiz["hypothesis"],
                            namespace, investigation_id=inv_id,
                        )
                    wiz["executed"].append(out)
                    st.rerun()
                if wiz["executed"]:
                    st.markdown(
                        diagnostic_timeline_markdown(wiz["executed"])
                    )
            else:
                if st.button("Accept conclusion"):
                    wiz["stage"] = 3
                    st.rerun()

        elif wiz["stage"] == 3:
            # generate + persist ONCE: streamlit reruns this block on every
            # widget interaction, which would otherwise regenerate the
            # report (an LLM call on non-offline backends) and rewrite the
            # store file each time
            if "report" not in wiz:
                wiz["report"] = coord.generate_root_cause_report(
                    {
                        "component": wiz["component"],
                        "accepted_hypothesis": wiz["hypothesis"],
                        "steps": wiz["executed"],
                        "finding": wiz["finding"],
                    }
                )
                store.add_evidence(inv_id, "root_cause_report", wiz["report"])
            st.markdown(wiz["report"])
            if st.button("Start a new investigation"):
                st.session_state[wizard_key] = {"stage": 0}
                st.rerun()

    # ---- live streaming view (engine/live.py) ----------------------------
    elif view == "Stream":
        _render_stream_tab(st, client, namespace, coord.device)


def _render_chart(st, chart) -> None:
    """Draw one renderer-agnostic chart spec (ui.render.
    analysis_chart_series).  Bars with ``thresholds`` draw the 80/90%
    rule-engine lines when plotly is available (reference:
    components/visualization.py utilization charts) and degrade to a plain
    bar chart otherwise; ``findings_table`` rows carry severity icons so
    the table reads severity-colored without a pandas Styler dependency."""
    kind = chart.get("kind")
    if kind == "bar":
        thresholds = chart.get("thresholds") or []
        colors = chart.get("colors") or {}
        if thresholds or colors:
            try:
                import plotly.graph_objects as go

                data = chart["data"]
                bar = go.Bar(x=list(data.keys()), y=list(data.values()))
                if colors:
                    bar.marker = {
                        "color": [
                            colors.get(k, "#888888") for k in data.keys()
                        ]
                    }
                fig = go.Figure(bar)
                for t in thresholds:
                    fig.add_hline(
                        y=t["value"], line_dash="dash",
                        annotation_text=t.get("label", str(t["value"])),
                    )
                st.plotly_chart(fig, use_container_width=True)
                return
            except ImportError:
                if thresholds:
                    st.caption(
                        "thresholds: "
                        + ", ".join(t.get("label", "") for t in thresholds)
                    )
        st.bar_chart(chart["data"])
    elif kind == "findings_table":
        st.dataframe(
            [
                {"": row["icon"], "severity": row["severity"],
                 "component": row["component"], "issue": row["issue"]}
                for row in chart["data"]
            ],
            use_container_width=True,
        )
    elif kind == "pie":
        try:
            import plotly.express as px

            fig = px.pie(
                values=list(chart["data"].values()),
                names=list(chart["data"].keys()),
                hole=chart.get("hole", 0),
            )
            st.plotly_chart(fig, use_container_width=True)
        except ImportError:
            st.bar_chart(chart["data"])
    elif kind == "sunburst":
        try:
            import plotly.graph_objects as go

            rows = chart["data"]
            fig = go.Figure(go.Sunburst(
                ids=[r["id"] for r in rows],
                parents=[r["parent"] for r in rows],
                values=[r["value"] for r in rows],
                marker={"colors": [r["color"] for r in rows]},
                branchvalues="total",
            ))
            st.plotly_chart(fig, use_container_width=True)
        except ImportError:
            # leaf rows only: component/severity -> count
            st.dataframe([r for r in chart["data"] if r["parent"]])
    elif kind == "bar_grouped":
        series = chart.get("series", {})
        try:
            import plotly.graph_objects as go

            fig = go.Figure([
                go.Bar(name=name, x=list(vals.keys()),
                       y=list(vals.values()))
                for name, vals in series.items() if vals
            ])
            for t in chart.get("thresholds") or []:
                fig.add_hline(
                    y=t["value"], line_dash="dash",
                    annotation_text=t.get("label", str(t["value"])),
                )
            fig.update_layout(barmode="group")
            st.plotly_chart(fig, use_container_width=True)
        except ImportError:
            # wide-form rows: one column per series
            keys = sorted({k for vals in series.values() for k in vals})
            st.dataframe([
                {"component": k,
                 **{name: vals.get(k) for name, vals in series.items()}}
                for k in keys
            ])
    elif kind == "digraph":
        sev_icon = {"critical": "🔴", "high": "🟠", "medium": "🟡",
                    "low": "🔵", "info": "⚪"}
        st.dataframe([
            {"from": f"{sev_icon.get(e.get('source_severity'), '⚪')} "
                     f"{e['source']}",
             "to": f"{sev_icon.get(e.get('target_severity'), '⚪')} "
                   f"{e['target']}"}
            for e in chart["data"]
        ], use_container_width=True)
    else:
        st.dataframe(chart["data"])


def _render_stream_tab(st, client, namespace, device=None) -> None:
    """Live streaming surface over engine/live.py: each poll diffs the
    cluster against the device-resident features and re-ranks in one
    dispatch of the kernels on ``device`` (the card unless ``"cpu"``).

    Auto-poll runs as a scoped ``st.fragment(run_every=...)`` so only this
    tab's body re-executes on the timer — a top-level sleep+rerun loop
    would block every widget in the app for the poll interval and hit the
    cluster API from the sidebar on each cycle.  The checkbox that arms
    the timer lives OUTSIDE the fragment: toggling it must trigger a full
    rerun so the fragment is re-registered with the new ``run_every``
    (from inside, the toggle would only rerun the fragment body and the
    old timer would stay armed)."""
    auto = st.checkbox("Auto-poll every 2 s", value=False, key="stream-auto")
    if hasattr(st, "fragment"):
        st.fragment(run_every="2s" if auto else None)(
            lambda: _stream_tab_body(st, client, namespace, device)
        )()
    else:
        _stream_tab_body(st, client, namespace, device)


def _stream_tab_body(st, client, namespace, device=None) -> None:
    from rca_tpu_torch.engine import LiveStreamingSession, make_engine

    sess_key = f"live-stream-{namespace}"
    if st.button("Start / reset stream"):
        # one live session at a time: every stream pins a device-resident
        # feature matrix + edge arrays, so drop any other namespace's
        for key in [k for k in st.session_state
                    if str(k).startswith("live-stream-")]:
            del st.session_state[key]
        st.session_state[sess_key] = {
            "live": LiveStreamingSession(
                client, namespace, k=8, engine=make_engine(device=device)),
            "history": [],
        }
    state = st.session_state.get(sess_key)
    if not state:
        st.info("Start the stream to rank root causes continuously; each "
                "poll uploads only the services whose signals changed.")
        return
    if st.button("Poll now") or st.session_state.get("stream-auto"):
        out = state["live"].poll()
        state["history"].append({
            "tick": out["tick"],
            "latency_ms": round(out["latency_ms"], 1),
            "capture_ms": out["capture_ms"],
            "quiet": out.get("quiet", False),
            "changed_rows": out["changed_rows"],
            "upload_rows": out["upload_rows"],
            "resynced": out["resynced"],
            "top": (out["ranked"][0]["component"]
                    if out["ranked"] else "—"),
        })
        state["history"] = state["history"][-50:]
        st.markdown(
            f"**Top root causes** (tick {out['tick']}, "
            f"{out['changed_rows']} changed, "
            f"{'resynced, ' if out['resynced'] else ''}"
            f"{out['latency_ms']:.0f} ms)"
        )
        st.dataframe(out["ranked"])
    if state["history"]:
        st.caption("Tick history (newest last)")
        st.dataframe(state["history"])


if __name__ == "__main__":  # pragma: no cover
    main()
