"""The port's wire front door (``rca_tpu_torch.gateway``) against the JAX
package's, and against itself.

- the wire codec: the port's ``encode_analyze`` body equals the
  reference's, ``decode_analyze`` of it gives equal arrays and kwargs, the
  malformed bodies raise ``WireError`` with the reference's messages, and
  ``status_code_for`` agrees for every status;
- the config knobs: env round trips, defaults and rejections (messages
  included) equal the reference's;
- A/B over the wire: the same 16 concurrent requests through the
  reference's ``GatewayServer`` over its ``ServeLoop`` and through the
  port's over its own — status codes equal, ``ranked`` names and order
  identical, scores at rtol 1e-5 / atol 1e-6; within the port every wire
  answer is bitwise its in-process ``ServeClient`` answer and its solo
  analysis;
- backpressure: the same scenario gives the same 429 / 503 / 413 / 400 /
  404 in both packages; a body over the default cap gets 413 without
  touching the queue;
- the rate limiter admits the same sequence as the reference's under an
  injected clock; ``TickHub`` drops for a slow subscriber and never
  blocks; the subscription stream, ``?explain=1``, ``/v1/explain/<id>``
  and ``/v1/traces``;
- ``/metrics``: over the same served load the exposition has the
  reference's serve and gateway metric names and label sets, with equal
  counter values;
- ``/healthz`` follows the breaker and the plane's death, the
  ``Retry-After`` jitter equals the reference's for the same seed, tokens
  bind the tenant, TLS, mTLS and the rejection of plaintext work with the
  committed ``tests/fixtures/*.pem``;
- the serve surfaces the gateway reads (``submit_many``,
  ``depth_by_tenant``, a pool's ``occupancy``) against the reference's;
- ``python -m rca_tpu_torch serve --listen 127.0.0.1:0 --device cpu`` in
  a subprocess: its banner, 16 requests bitwise in process, exit 0 on
  SIGTERM.

Every blocking call takes a timeout, and every server and loop is closed
in ``finally`` or a ``with`` block.
"""

import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from rca_tpu.cluster.generator import synthetic_cascade_arrays as ref_cascade
from rca_tpu.config import ServeConfig as RefServeConfig
from rca_tpu.engine import GraphEngine as RefEngine
from rca_tpu.gateway import GatewayClient as RefGatewayClient
from rca_tpu.gateway import GatewayServer as RefGatewayServer
from rca_tpu.gateway import wire as ref_wire
from rca_tpu.gateway.server import TenantRateLimiter as RefLimiter
from rca_tpu.serve import ServeLoop as RefServeLoop
from rca_tpu.serve import ServePool as RefServePool
from rca_tpu.serve import ServeRequest as RefServeRequest
from rca_tpu.serve.queue import RequestQueue as RefRequestQueue
from rca_tpu_torch import GraphEngine
from rca_tpu_torch.cluster.generator import synthetic_cascade_arrays
from rca_tpu_torch.config import ServeConfig
from rca_tpu_torch.gateway import (
    GatewayClient,
    GatewayServer,
    TenantRateLimiter,
    TickHub,
    WireError,
    decode_analyze,
    encode_analyze,
    status_code_for,
)
from rca_tpu_torch.observability.spans import TRACE_HEADER, Tracer
from rca_tpu_torch.resilience.policy import CircuitBreaker
from rca_tpu_torch.serve import (
    RequestQueue,
    ServeClient,
    ServeLoop,
    ServePool,
    ServeRequest,
)

ROOT = Path(__file__).resolve().parent.parent
CERT = str(ROOT / "tests" / "fixtures" / "gateway_cert.pem")
KEY = str(ROOT / "tests" / "fixtures" / "gateway_key.pem")
CLIENT_CERT = str(ROOT / "tests" / "fixtures" / "client_cert.pem")
CLIENT_KEY = str(ROOT / "tests" / "fixtures" / "client_key.pem")
#: every wait in this file is bounded by this
WAIT_S = 120.0


@pytest.fixture(scope="module")
def engine():
    return GraphEngine(device="cpu")


@pytest.fixture(scope="module")
def ref_engine():
    return RefEngine()


@pytest.fixture(scope="module")
def case():
    return synthetic_cascade_arrays(48, n_roots=1, seed=3)


def _req(tenant="t", n=8, k=3, seed=0, cls=ServeRequest, **kw):
    rng = np.random.default_rng(seed)
    feats = rng.uniform(0, 1, (n, 4)).astype(np.float32)
    src = np.arange(n - 1, dtype=np.int32)
    dst = np.arange(1, n, dtype=np.int32)
    return cls(tenant=tenant, features=feats, dep_src=src, dep_dst=dst, k=k,
               **kw)


def _perturbed(case, seed: int, count: int):
    rng = np.random.default_rng(seed)
    return [np.clip(case.features + rng.uniform(
        0, 0.05, case.features.shape).astype(np.float32), 0, 1)
        for _ in range(count)]


def _raw(host, port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection(host, port, timeout=30)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read(), dict(resp.getheaders())
    finally:
        conn.close()


def _in_threads(fn, count: int) -> None:
    threads = [threading.Thread(target=fn, args=(i,), daemon=True)
               for i in range(count)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S)
    assert not any(t.is_alive() for t in threads)


def _assert_ranked_close(got, want):
    assert [r["component"] for r in got] == [r["component"] for r in want]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in g:
            if key != "component":
                np.testing.assert_allclose(g[key], w[key], rtol=1e-5,
                                           atol=1e-6)


# -- the wire codec ---------------------------------------------------------

def test_cases_equal_the_reference(case):
    ref = ref_cascade(48, n_roots=1, seed=3)
    assert np.array_equal(case.features, ref.features)
    assert np.array_equal(case.dep_src, ref.dep_src)
    assert np.array_equal(case.dep_dst, ref.dep_dst)
    assert list(case.names) == list(ref.names)


@pytest.mark.parametrize("kwargs", [
    {},
    {"names": True, "tenant": "t", "k": 3, "deadline_ms": 250.0},
    {"priority": "high", "investigation_id": "inv-1", "explain": True},
    {"priority": "batch", "k": 7, "deadline_ms": 1},
], ids=["defaults", "tagged", "explained", "batch"])
def test_encode_equals_reference_and_decode_round_trips(case, kwargs):
    kw = dict(kwargs)
    if kw.pop("names", False):
        kw["names"] = case.names
    body = encode_analyze(case.features, case.dep_src, case.dep_dst, **kw)
    assert body == ref_wire.encode_analyze(case.features, case.dep_src,
                                           case.dep_dst, **kw)
    wire = json.loads(json.dumps(body))
    got = decode_analyze(wire, header_tenant="hdr")
    want = ref_wire.decode_analyze(wire, header_tenant="hdr")
    assert got.keys() == want.keys()
    for key in ("features", "dep_src", "dep_dst"):
        assert got[key].dtype == want[key].dtype
        assert np.array_equal(got[key], want[key])
    # float32 -> JSON -> float32 is the identity
    assert np.array_equal(got["features"], case.features)
    assert {k: v for k, v in got.items()
            if k not in ("features", "dep_src", "dep_dst")} == {
        k: v for k, v in want.items()
        if k not in ("features", "dep_src", "dep_dst")}
    assert got["tenant"] == "hdr"


@pytest.mark.parametrize("mutate", [
    lambda b: b.pop("features"),
    lambda b: b.update(features=[1, 2, 3]),
    lambda b: b.update(features=[["a", "b"]]),
    lambda b: b.update(dep_src=[0, 1]),
    lambda b: b.update(priority="urgent"),
    lambda b: b.update(k=0),
    lambda b: b.update(k="5"),
    lambda b: b.update(names="not-a-list"),
    lambda b: b.update(names=[1, 2]),
    lambda b: b.update(deadline_ms="soon"),
    lambda b: b.update(tenant=5),
    lambda b: b.update(investigation_id=7),
    lambda b: b.update(explain="yes"),
], ids=["no-features", "1d-features", "text-features", "edge-lengths",
        "priority", "k-zero", "k-string", "names-string", "names-ints",
        "deadline", "tenant-number", "investigation-id", "explain"])
def test_malformed_bodies_raise_the_reference_messages(mutate):
    body = encode_analyze(np.zeros((2, 2), np.float32), [0], [1])
    mutate(body)
    with pytest.raises(WireError) as got:
        decode_analyze(body)
    with pytest.raises(ref_wire.WireError) as want:
        ref_wire.decode_analyze(body)
    assert str(got.value) == str(want.value)


def test_non_object_body_raises_the_reference_message():
    with pytest.raises(WireError) as got:
        decode_analyze([1, 2])
    with pytest.raises(ref_wire.WireError) as want:
        ref_wire.decode_analyze([1, 2])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("status", ["ok", "degraded", "queue_full", "shed",
                                    "error", "rate_limited", "mystery"])
def test_status_map_equals_reference(status):
    assert status_code_for(status) == ref_wire.status_code_for(status)


# -- config -------------------------------------------------------------------

_KNOBS = ("gateway_port", "gateway_max_body", "canary_sample_rate",
          "gateway_tls_files", "gateway_tls_client_ca", "gateway_tokens",
          "gateway_tenant_rps")
_ENV = ("RCA_GATEWAY_PORT", "RCA_GATEWAY_MAX_BODY", "RCA_CANARY_SAMPLE_RATE",
        "RCA_GATEWAY_TLS_CERT", "RCA_GATEWAY_TLS_KEY",
        "RCA_GATEWAY_TLS_CLIENT_CA", "RCA_GATEWAY_TOKENS",
        "RCA_GATEWAY_TENANT_RPS")


def _knobs(module):
    return {name: getattr(module, name)() for name in _KNOBS}


def test_config_defaults_and_round_trip_equal_reference(monkeypatch):
    import rca_tpu.config as ref_config
    import rca_tpu_torch.config as config

    for name in _ENV:
        monkeypatch.delenv(name, raising=False)
    assert _knobs(config) == _knobs(ref_config)
    assert config.gateway_port() == 8321
    assert config.gateway_max_body() == 8 * 1024 * 1024
    assert config.canary_sample_rate() == 1.0
    assert config.gateway_tenant_rps() == 0.0
    for name, value in (("RCA_GATEWAY_PORT", "9001"),
                        ("RCA_GATEWAY_MAX_BODY", "65536"),
                        ("RCA_CANARY_SAMPLE_RATE", "0.25"),
                        ("RCA_GATEWAY_TLS_CERT", CERT),
                        ("RCA_GATEWAY_TLS_KEY", KEY),
                        ("RCA_GATEWAY_TLS_CLIENT_CA", CLIENT_CERT),
                        ("RCA_GATEWAY_TOKENS", "tokA:acme,tokB:beta:1.9e9"),
                        ("RCA_GATEWAY_TENANT_RPS", "2.5")):
        monkeypatch.setenv(name, value)
    assert _knobs(config) == _knobs(ref_config)
    assert config.gateway_tokens() == {"tokA": ("acme", None),
                                       "tokB": ("beta", 1.9e9)}


@pytest.mark.parametrize("env", [
    {"RCA_GATEWAY_PORT": "70000"},
    {"RCA_GATEWAY_PORT": "abc"},
    {"RCA_GATEWAY_MAX_BODY": "10"},
    {"RCA_CANARY_SAMPLE_RATE": "1.5"},
    {"RCA_CANARY_SAMPLE_RATE": "often"},
    {"RCA_GATEWAY_TENANT_RPS": "-1"},
    {"RCA_GATEWAY_TENANT_RPS": "lots"},
    {"RCA_GATEWAY_TLS_CERT": CERT},
    {"RCA_GATEWAY_TLS_CLIENT_CA": CLIENT_CERT},
    {"RCA_GATEWAY_TOKENS": "lonetoken"},
    {"RCA_GATEWAY_TOKENS": "a:b,a:c"},
    {"RCA_GATEWAY_TOKENS": ":t"},
    {"RCA_GATEWAY_TOKENS": "tok:tenant:soon"},
], ids=lambda e: "-".join(f"{k}={v}" for k, v in e.items())[:60])
def test_config_rejections_equal_reference(monkeypatch, env):
    import rca_tpu.config as ref_config
    import rca_tpu_torch.config as config

    for name in _ENV:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    for name in _KNOBS:
        try:
            want = getattr(ref_config, name)()
        except ValueError as exc:
            with pytest.raises(ValueError) as got:
                getattr(config, name)()
            assert str(got.value) == str(exc)
        else:
            assert getattr(config, name)() == want


# -- A/B over the wire ------------------------------------------------------

def test_wire_ab_against_reference_at_concurrency_16(engine, ref_engine,
                                                     case):
    """16 concurrent requests over 4 tenants through each package's
    gateway.  ``engine`` (``serve+single`` in both) is left out of the
    cross-package compare: it names the package's own engine."""
    feats = _perturbed(case, 1, 16)
    answers = {}
    for label, loop_cls, gw_cls, cl_cls, eng in (
            ("port", ServeLoop, GatewayServer, GatewayClient, engine),
            ("ref", RefServeLoop, RefGatewayServer, RefGatewayClient,
             ref_engine)):
        wire = [None] * 16
        loop = loop_cls(engine=eng).start()
        try:
            with gw_cls(loop, port=0) as gw:
                cl = cl_cls(gw.host, gw.port, timeout_s=WAIT_S)

                def worker(i, cl=cl, wire=wire):
                    wire[i] = cl.analyze(
                        feats[i], case.dep_src, case.dep_dst,
                        names=case.names, tenant=f"t{i % 4}", k=3)

                _in_threads(worker, 16)
                if label == "port":
                    inproc = ServeClient(loop)
                    for i, f in enumerate(feats):
                        code, body, _ = wire[i]
                        assert code == 200 and body["status"] == "ok"
                        resp = inproc.analyze(
                            f, case.dep_src, case.dep_dst, names=case.names,
                            tenant="oracle", k=3, timeout_s=WAIT_S)
                        assert body["ranked"] == resp.ranked
                        solo = engine.analyze_arrays(
                            f, case.dep_src, case.dep_dst, case.names, k=3)
                        assert body["ranked"] == solo.ranked
        finally:
            loop.stop()
        answers[label] = wire
    for (pc, pb, _), (rc, rb, _) in zip(answers["port"], answers["ref"]):
        assert pc == rc == 200
        for key in ("status", "tenant", "degraded", "deadline_missed"):
            assert pb[key] == rb[key], key
        _assert_ranked_close(pb["ranked"], rb["ranked"])
        assert set(pb) == set(rb)


def _settled(gw, responses: int):
    """The gateway's metrics once ``responses`` responses are counted (the
    handler counts each after writing it)."""
    for _ in range(500):
        snap = gw.metrics.snapshot()
        if sum(snap["requests"].values()) >= responses:
            return snap
        threading.Event().wait(0.01)
    return gw.metrics.snapshot()


def _backpressure(loop_cls, gw_cls, cl_cls, cfg_cls, req_cls, eng, case):
    """429 / 503 / 413 / 400 / 404 on a never-started loop with a
    saturated queue: every outcome completes at admission."""
    loop = loop_cls(engine=eng, config=cfg_cls(queue_cap=2))
    out = []
    with gw_cls(loop, port=0, max_body=256 * 1024,
                retry_jitter_seed=5) as gw:
        cl = cl_cls(gw.host, gw.port, timeout_s=WAIT_S)
        for i in range(2):
            assert loop.submit(_req(seed=i, cls=req_cls))
        for kw in ({}, {"deadline_ms": -1.0}):
            code, body, headers = cl.analyze(
                case.features, case.dep_src, case.dep_dst, k=3, **kw)
            out.append((code, body["status"], body["detail"],
                        headers.get("Retry-After"),
                        headers.get("X-RCA-Retry-After-Ms")))
        code, body, _ = cl.analyze(np.zeros((600, 128), np.float32), [0],
                                   [1], k=3)
        out.append((code, body["status"], body["detail"]))
        for method, path, raw in (("POST", "/v1/analyze", b"{not json"),
                                  ("POST", "/v1/analyze", b'{"features": 1}'),
                                  ("GET", "/v1/nope", None),
                                  ("POST", "/v2/analyze", b"{}")):
            status, payload, _ = _raw(gw.host, gw.port, method, path, raw,
                                      {"Content-Type": "application/json"})
            body = json.loads(payload)
            out.append((status, body["status"], body["detail"]))
        # a response is counted after it is written: wait for the last one
        snap = _settled(gw, 8)
        out.append(sorted(snap["requests"].items()))
        out.append((snap["body_rejections"], len(loop.queue)))
    return out


def test_backpressure_equals_reference(engine, ref_engine, case):
    got = _backpressure(ServeLoop, GatewayServer, GatewayClient, ServeConfig,
                        ServeRequest, engine, case)
    want = _backpressure(RefServeLoop, RefGatewayServer, RefGatewayClient,
                         RefServeConfig, RefServeRequest, ref_engine, case)
    assert got == want
    assert [row[0] for row in got[:7]] == [429, 503, 413, 400, 400, 404, 404]
    assert got[-1] == (1, 2)


def test_default_cap_refuses_a_large_body_before_the_queue(engine):
    loop = ServeLoop(engine=engine)
    with GatewayServer(loop, port=0) as gw:
        conn = http.client.HTTPConnection(gw.host, gw.port, timeout=30)
        try:
            conn.putrequest("POST", "/v1/analyze")
            conn.putheader("Content-Length", str(gw.max_body + 1))
            conn.endheaders()
            resp = conn.getresponse()
            body = json.loads(resp.read())
        finally:
            conn.close()
        assert resp.status == 413 and "RCA_GATEWAY_MAX_BODY" in body["detail"]
        assert gw.max_body == 8 * 1024 * 1024
        assert len(loop.queue) == 0 and loop.device_batches == 0
        assert gw.metrics.snapshot()["body_rejections"] == 1


# -- the rate limiter and the hub ---------------------------------------------

def test_rate_limiter_admits_the_reference_sequence():
    steps = [(0.0, "a"), (0.0, "a"), (0.0, "a"), (0.0, "b"), (0.25, "a"),
             (0.25, "a"), (0.1, "b"), (0.05, "b"), (1.0, "a"), (0.0, "a"),
             (0.0, "a"), (0.0, "a"), (0.3, "c"), (0.0, "c"), (0.0, "c")]
    for rps, burst in ((2.0, None), (0.5, None), (4.0, 2.0)):
        now = [100.0]
        port = TenantRateLimiter(rps, clock=lambda: now[0], burst=burst)
        ref = RefLimiter(rps, clock=lambda: now[0], burst=burst)
        for dt, tenant in steps:
            now[0] += dt
            assert port.admit(tenant) == ref.admit(tenant)
        assert port.rejected == ref.rejected > 0
        assert port._buckets == ref._buckets
    now = [0.0]
    port = TenantRateLimiter(1.0, clock=lambda: now[0], max_tenants=4)
    ref = RefLimiter(1.0, clock=lambda: now[0], max_tenants=4)
    for i in range(10):
        now[0] += 0.3
        assert port.admit(f"t{i % 6}") == ref.admit(f"t{i % 6}")
    assert port._buckets == ref._buckets and len(port._buckets) <= 4


def test_rate_limit_refuses_the_hot_tenant_only(engine, case):
    frozen = [500.0]
    with ServeLoop(engine=engine) as loop, GatewayServer(
            loop, port=0, tenant_rps=2.0, clock=lambda: frozen[0]) as gw:
        cl = GatewayClient(gw.host, gw.port, timeout_s=WAIT_S)
        codes = [cl.analyze(case.features, case.dep_src, case.dep_dst,
                            tenant="hot", k=3)[0] for _ in range(5)]
        assert codes == [200, 200, 429, 429, 429]
        assert cl.analyze(case.features, case.dep_src, case.dep_dst,
                          tenant="quiet", k=3)[0] == 200
        assert loop.metrics.summary()["tenants"]["hot"]["submitted"] == 2
        assert "rca_gateway_rate_limited_total 3" in cl.metrics_text()


def test_tickhub_slow_subscriber_drops_never_blocks():
    hub = TickHub()
    sid, q = hub.subscribe()
    other, q_other = hub.subscribe("elsewhere")
    for i in range(hub.QUEUE_CAP + 5):
        hub.publish({"tenant": "t", "i": i})
    assert q.qsize() == hub.QUEUE_CAP and q_other.qsize() == 0
    assert hub.dropped == 5
    hub.unsubscribe(sid)
    hub.unsubscribe(other)
    assert hub.subscriber_count() == 0
    hub.publish({"tenant": "t"})


def test_subscription_receives_every_served_response(engine, case):
    with ServeLoop(engine=engine) as loop, GatewayServer(loop,
                                                         port=0) as gw:
        cl = GatewayClient(gw.host, gw.port, timeout_s=WAIT_S)
        got: list = []

        def subscriber():
            for ev in cl.subscribe(tenant="watch-me", max_events=3,
                                   idle_s=20.0, timeout_s=60.0):
                got.append(ev)

        t = threading.Thread(target=subscriber, daemon=True)
        t.start()
        for _ in range(200):
            if gw.hub.subscriber_count():
                break
            threading.Event().wait(0.05)
        served = []
        for _ in range(3):
            code, body, _ = cl.analyze(case.features, case.dep_src,
                                       case.dep_dst, k=3, tenant="watch-me")
            assert code == 200
            served.append(body)
            cl.analyze(case.features, case.dep_src, case.dep_dst, k=3,
                       tenant="other")
        t.join(60.0)
        assert not t.is_alive()
        assert got == served
        assert gw.metrics.snapshot()["stream_events"] == 3


def test_explain_query_and_explain_route(engine, case):
    tracer = Tracer(seed=3)
    with ServeLoop(engine=engine, tracer=tracer) as loop, GatewayServer(
            loop, port=0) as gw:
        assert gw.tracer is tracer
        parent = "00000000000000aa-000000bb"
        status, payload, headers = _raw(
            gw.host, gw.port, "POST", "/v1/analyze?explain=1",
            json.dumps(encode_analyze(case.features, case.dep_src,
                                      case.dep_dst, names=case.names,
                                      k=3)).encode(),
            {"Content-Type": "application/json", TRACE_HEADER: parent})
        body = json.loads(payload)
        assert status == 200 and "provenance" in body
        assert body["trace_id"] == "00000000000000aa"
        assert headers[TRACE_HEADER].startswith("00000000000000aa-")
        for key in (body["trace_id"], body["request_id"]):
            code, rec, _ = _raw(gw.host, gw.port, "GET", f"/v1/explain/{key}")
            assert code == 200
            assert json.loads(rec)["provenance"] == body["provenance"]
        assert _raw(gw.host, gw.port, "GET", "/v1/explain/nope")[0] == 404
        spans = GatewayClient(gw.host, gw.port).traces(
            trace_id=body["trace_id"])
        names = {s["name"] for s in spans}
        assert "gateway.analyze" in names and len(names) > 1
        chrome = GatewayClient(gw.host, gw.port).traces(fmt="chrome")
        assert chrome["traceEvents"]
        # a malformed header starts a fresh trace
        code, body2, hdrs = GatewayClient(gw.host, gw.port).analyze(
            case.features, case.dep_src, case.dep_dst, k=3, trace="x-y-z")
        assert code == 200 and body2["trace_id"] != body["trace_id"]
        assert hdrs[TRACE_HEADER].split("-")[0] == body2["trace_id"]


# -- /metrics ----------------------------------------------------------------

def _families(text):
    """``{family: (type, {(sample name, labels): value})}`` of an
    exposition, timestamps dropped."""
    types, samples = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ")
            types[name] = kind
        elif line and not line.startswith("#"):
            head, _, rest = line.partition(" ")
            name, _, labels = head.partition("{")
            samples[(name, labels.rstrip("}"))] = rest.split(" ")[0]
    out = {}
    for (name, labels), value in samples.items():
        family = next(f for f in sorted(types, key=len, reverse=True)
                      if name == f or name.startswith(f + "_"))
        out.setdefault(family, (types[family], {}))[1][(name, labels)] = value
    return out


#: the families compared across packages; rca_slo_breaches_total counts
#: completions over RCA_SLO_MS, a wall-clock outcome, so it is left out
_SERVED = ("rca_serve_", "rca_gateway_", "rca_request_", "rca_explain_")


def test_metrics_exposition_matches_reference(engine, ref_engine, case):
    feats = _perturbed(case, 4, 6)
    texts = {}
    for label, loop_cls, gw_cls, cl_cls, eng in (
            ("port", ServeLoop, GatewayServer, GatewayClient, engine),
            ("ref", RefServeLoop, RefGatewayServer, RefGatewayClient,
             ref_engine)):
        loop = loop_cls(engine=eng).start()
        try:
            with gw_cls(loop, port=0) as gw:
                cl = cl_cls(gw.host, gw.port, timeout_s=WAIT_S)
                for i, f in enumerate(feats):
                    code, _, _ = cl.analyze(
                        f, case.dep_src, case.dep_dst, names=case.names,
                        tenant=f"tenant-{i % 2}", k=3)
                    assert code == 200
                _raw(gw.host, gw.port, "GET", "/v1/nope")
                _raw(gw.host, gw.port, "POST", "/v1/analyze", b"{bad")
                texts[label] = cl.metrics_text()
        finally:
            loop.stop()
    port, ref = _families(texts["port"]), _families(texts["ref"])
    served = sorted(f for f in ref if f.startswith(_SERVED))
    assert served and served == sorted(f for f in port
                                       if f.startswith(_SERVED))
    for family in served:
        kind, want = ref[family]
        assert port[family][0] == kind
        assert set(port[family][1]) == set(want), family
        if kind == "counter":
            assert port[family][1] == want, family
    assert port["rca_gateway_up"][1] == ref["rca_gateway_up"][1]
    # the registry row that served the shape (on the CPU: ``torch``)
    winners = port["rca_kernel_winner_info"][1]
    assert any('n_pad="64"' in labels and 'kernel="torch"' in labels
               for _, labels in winners)
    assert 'rca_serve_requests_total{outcome="answered",tenant="tenant-0"} 3' \
        in texts["port"]


# -- health, retries, credentials --------------------------------------------

class _StubDispatcher:
    engine = None
    engine_tag = "stub"

    def __init__(self):
        self.graphs = set()

    def has_graph(self, key):
        return key in self.graphs

    def dispatch(self, batch, now=None):
        self.graphs.add(batch[0].graph_key)

        class _H:
            requests = list(batch)
            dispatched_at = now if now is not None else 0.0
            resident_delta = False

        return _H()

    def fetch(self, handle):
        class _R:
            ranked = [{"component": "svc", "score": 1.0}]
            engine = "stub"
            score = np.ones(1, np.float32)

        return [_R() for _ in handle.requests]


def test_healthz_follows_the_breaker_and_the_planes_death(engine):
    loop = ServeLoop(engine=engine, breaker=CircuitBreaker(
        failure_threshold=3, reset_after=3600.0, name="test.gateway"))
    with GatewayServer(loop, port=0) as gw:
        cl = GatewayClient(gw.host, gw.port, timeout_s=30)
        assert cl.healthz() == (200, {"ok": True, "breaker": "closed",
                                      "queue_depth": 0})
        for _ in range(5):
            loop.breaker.record_failure()
        code, health = cl.healthz()
        assert code == 503 and health["breaker"] == "open"
    loop = ServeLoop(engine=engine).start()
    with GatewayServer(loop, port=0) as gw:
        cl = GatewayClient(gw.host, gw.port, timeout_s=30)
        assert cl.healthz()[0] == 200
        loop.stop()
        code, health = cl.healthz()
        assert code == 503 and health["stopped"] is True
    pool = ServePool(dispatchers=[_StubDispatcher() for _ in range(2)],
                     config=ServeConfig(replicas=2, max_wait_us=0))
    with GatewayServer(pool, port=0) as gw:
        cl = GatewayClient(gw.host, gw.port, timeout_s=30)
        code, health = cl.healthz()
        assert code == 200 and health["occupancy"] == 0.0
        for r in pool.replicas:
            r.kill()
        code, health = cl.healthz()
        assert code == 503 and set(health["replicas"].values()) == {"dead"}
        assert health["occupancy"] == 1.0


def _jitter_hints(loop_cls, gw_cls, cl_cls, cfg_cls, req_cls, eng):
    loop = loop_cls(engine=eng, config=cfg_cls(queue_cap=2))
    for i in range(2):
        assert loop.submit(_req(seed=i, cls=req_cls))
    with gw_cls(loop, port=0, retry_jitter_seed=7) as gw:
        cl = cl_cls(gw.host, gw.port, timeout_s=30)
        out = []
        for _ in range(6):
            code, _, headers = cl.analyze(np.zeros((4, 4), np.float32),
                                          [0], [1])
            assert code == 429
            out.append((headers["Retry-After"],
                        headers["X-RCA-Retry-After-Ms"]))
        return out, [gw.jittered_retry_after(1) for _ in range(4)]


def test_retry_after_jitter_equals_reference(engine, ref_engine):
    got = _jitter_hints(ServeLoop, GatewayServer, GatewayClient, ServeConfig,
                        ServeRequest, engine)
    want = _jitter_hints(RefServeLoop, RefGatewayServer, RefGatewayClient,
                         RefServeConfig, RefServeRequest, ref_engine)
    assert got == want
    hints = [int(ms) for _, ms in got[0]]
    assert len(set(hints)) >= 5 and all(1000 <= ms < 3001 for ms in hints)
    assert all(int(s) >= int(ms) / 1000.0 for s, ms in got[0])


def test_client_retries_honour_the_jittered_hint(engine):
    loop = ServeLoop(engine=engine, config=ServeConfig(queue_cap=1))
    assert loop.submit(_req(seed=0))
    sleeps: list = []
    with GatewayServer(loop, port=0, retry_jitter_seed=3,
                       timeout_s=1.0) as gw:
        def sleeper(s):
            sleeps.append(s)
            if len(sleeps) == 1:
                loop.queue.pop()

        cl = GatewayClient(gw.host, gw.port, sleeper=sleeper, timeout_s=30)
        code, _, _ = cl.analyze(np.zeros((4, 4), np.float32), [0], [1],
                                retries=3)
        # one backoff, then admitted: the never-started loop answers 504
        assert len(sleeps) == 1 and 1.0 <= sleeps[0] <= 3.001
        assert code == 504 and len(loop.queue) == 1
    loop.queue.pop()
    assert GatewayClient.retry_delay_s(
        {"X-RCA-Retry-After-Ms": "1750", "Retry-After": "2"}) == 1.75
    assert GatewayClient.retry_delay_s({"Retry-After": "3"}) == 3.0
    assert GatewayClient.retry_delay_s({}) == 1.0
    cl = GatewayClient.from_url("https://127.0.0.1:9", token="t")
    assert (cl.host, cl.port, cl.tls, cl.token) == ("127.0.0.1", 9, True, "t")
    with pytest.raises(ValueError):
        GatewayClient.from_url("ftp://127.0.0.1:9")


def test_authn_rejects_before_the_body_and_the_queue(engine):
    loop = ServeLoop(engine=engine, config=ServeConfig(queue_cap=2))
    wall = [1000.0]
    with GatewayServer(loop, port=0, wall=lambda: wall[0], tokens={
            "tok-a": ("tenant-a", None),
            "tok-old": ("tenant-o", 999.0)}) as gw:
        feats = np.zeros((4, 4), np.float32)
        outcomes = [
            GatewayClient(gw.host, gw.port, token=token).analyze(
                feats, [0], [1], tenant=tenant)[:2]
            for token, tenant in ((None, None), ("wrong", None),
                                  ("tok-old", None), ("tok-a", "tenant-b"))]
        assert [c for c, _ in outcomes] == [401, 401, 401, 403]
        assert "expired" in outcomes[2][1]["detail"]
        assert len(loop.queue) == 0
        assert gw.metrics.snapshot()["auth_rejections"] == 4
        conn = http.client.HTTPConnection(gw.host, gw.port, timeout=10)
        try:
            conn.putrequest("POST", "/v1/analyze")
            conn.putheader("Content-Length", str(1 << 30))
            conn.endheaders()
            resp = conn.getresponse()
            assert resp.status == 401
            resp.read()
        finally:
            conn.close()
        for path in ("/metrics", "/v1/traces", "/v1/subscribe",
                     "/v1/explain/x"):
            assert _raw(gw.host, gw.port, "GET", path)[0] == 401
        assert _raw(gw.host, gw.port, "GET", "/healthz")[0] == 200


def test_token_binds_the_tenant(engine, case):
    with ServeLoop(engine=engine) as loop, GatewayServer(
            loop, port=0, tokens={"tok-a": ("tenant-a", None)}) as gw:
        cl = GatewayClient(gw.host, gw.port, token="tok-a", timeout_s=WAIT_S)
        for tenant in (None, "tenant-a"):
            code, body, _ = cl.analyze(case.features, case.dep_src,
                                       case.dep_dst, names=case.names, k=3,
                                       tenant=tenant)
            assert code == 200 and body["tenant"] == "tenant-a"


def test_tls_parity_and_plaintext_rejection(engine, case):
    with ServeLoop(engine=engine) as loop, GatewayServer(
            loop, port=0, tls=(CERT, KEY), tokens={"t": ("secure", None)}
    ) as gw:
        assert gw.tls_context is not None
        cl = GatewayClient(gw.host, gw.port, tls=True, ca_file=CERT,
                           token="t", timeout_s=WAIT_S)
        code, body, _ = cl.analyze(case.features, case.dep_src, case.dep_dst,
                                   names=case.names, k=3)
        assert code == 200 and body["tenant"] == "secure"
        solo = engine.analyze_arrays(case.features, case.dep_src,
                                     case.dep_dst, case.names, k=3)
        assert body["ranked"] == solo.ranked
        with pytest.raises((OSError, http.client.HTTPException)):
            _raw(gw.host, gw.port, "GET", "/healthz")
        assert GatewayClient(gw.host, gw.port, tls=True).healthz()[0] == 200


def test_mtls_client_certificate_enforced(engine, case):
    with ServeLoop(engine=engine) as loop, GatewayServer(
            loop, port=0, tls=(CERT, KEY), tls_client_ca=CLIENT_CERT) as gw:
        cl = GatewayClient(gw.host, gw.port, tls=True, ca_file=CERT,
                           cert_file=CLIENT_CERT, key_file=CLIENT_KEY,
                           timeout_s=WAIT_S)
        assert cl.healthz()[0] == 200
        assert cl.analyze(case.features, case.dep_src, case.dep_dst,
                          k=3)[0] == 200
        for kw in ({}, {"cert_file": CERT, "key_file": KEY}):
            with pytest.raises((OSError, http.client.HTTPException)):
                GatewayClient(gw.host, gw.port, tls=True, ca_file=CERT,
                              timeout_s=30, **kw).healthz()
        # the client reads the server's alert before the server's
        # connection thread counts its failed handshake
        deadline = time.monotonic() + WAIT_S
        while (gw.metrics.snapshot()["auth_rejections"] < 2
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert gw.metrics.snapshot()["auth_rejections"] >= 2


def test_tls_client_ca_requires_a_pair(monkeypatch, engine):
    for name in ("RCA_GATEWAY_TLS_CERT", "RCA_GATEWAY_TLS_KEY",
                 "RCA_GATEWAY_TLS_CLIENT_CA"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError):
        GatewayServer(ServeLoop(engine=engine), port=0,
                      tls_client_ca=CLIENT_CERT)


# -- the serve surfaces the gateway reads -----------------------------------

def test_serve_surfaces_equal_reference(engine, ref_engine, case):
    port_q, ref_q = RequestQueue(cap=8), RefRequestQueue(cap=8)
    for i, tenant in enumerate("aabca"):
        assert port_q.submit(_req(tenant=tenant, seed=i))
        assert ref_q.submit(_req(tenant=tenant, seed=i, cls=RefServeRequest))
    port_q.pop()
    ref_q.pop()
    assert port_q.depth_by_tenant() == ref_q.depth_by_tenant()
    feats = _perturbed(case, 2, 3)
    port_loop, ref_loop = ServeLoop(engine=engine), RefServeLoop(
        engine=ref_engine)
    from rca_tpu.serve import ServeClient as RefServeClient

    got = ServeClient(port_loop).submit_many(feats, case.dep_src,
                                             case.dep_dst, tenant="h", k=3)
    want = RefServeClient(ref_loop).submit_many(feats, case.dep_src,
                                                case.dep_dst, tenant="h",
                                                k=3)
    assert len(got) == len(want) == 3
    assert len({r.graph_key for r in got}) == 1
    assert port_loop.queue.depth_by_tenant() == \
        ref_loop.queue.depth_by_tenant() == {"h": 3}
    port_pool = ServePool(dispatchers=[_StubDispatcher() for _ in range(2)],
                          config=ServeConfig(replicas=2))
    ref_pool = RefServePool(dispatchers=[_StubDispatcher()
                                         for _ in range(2)],
                            config=RefServeConfig(replicas=2))
    assert port_pool.occupancy() == ref_pool.occupancy() == 0.0
    for pool in (port_pool, ref_pool):
        for r in pool.replicas:
            r.kill()
    assert port_pool.occupancy() == ref_pool.occupancy() == 1.0


# -- serve --listen in a subprocess -----------------------------------------

def test_serve_listen_subprocess(tmp_path, engine, case):
    proc = subprocess.Popen(
        [sys.executable, "-m", "rca_tpu_torch", "serve", "--listen",
         "127.0.0.1:0", "--max-batch", "8", "--device", "cpu",
         "--log-dir", str(tmp_path / "logs")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(ROOT))
    try:
        banner: list = []
        reader = threading.Thread(
            target=lambda: banner.append(proc.stdout.readline()),
            daemon=True)
        reader.start()
        reader.join(WAIT_S)
        assert banner and banner[0], "the gateway did not report in"
        info = json.loads(banner[0])
        assert info["endpoints"] == ["/v1/analyze", "/v1/subscribe",
                                     "/v1/traces", "/metrics", "/healthz"]
        assert (info["replicas"], info["tls"], info["authn"],
                info["max_body"]) == (1, False, False, 8 * 1024 * 1024)
        host, port = info["listening"].rsplit(":", 1)
        cl = GatewayClient(host, int(port), timeout_s=WAIT_S)
        feats = _perturbed(case, 2, 16)
        results: list = [None] * 16

        def worker(i):
            results[i] = cl.analyze(feats[i], case.dep_src, case.dep_dst,
                                    names=case.names, tenant=f"t{i % 4}",
                                    k=3)

        _in_threads(worker, 16)
        for f, (code, body, _) in zip(feats, results):
            assert code == 200, body
            solo = engine.analyze_arrays(f, case.dep_src, case.dep_dst,
                                         case.names, k=3)
            assert body["ranked"] == solo.ranked
        assert cl.healthz()[0] == 200
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    assert proc.returncode == 0
    summary = json.loads(err.strip().splitlines()[-1])
    assert summary["stopped"] and summary["gateway_requests"][
        "analyze:200"] == 16


@pytest.mark.parametrize("argv", [
    # a starting width outside the autoscaler's bounds, and --autoscale
    # in front of a loop: both refused before a socket is bound or a
    # worker spawned, with the reference's messages
    ["--listen", "127.0.0.1:0", "--federation", "2", "--autoscale", "3:4"],
    ["--listen", "127.0.0.1:0", "--autoscale", "1:2"],
])
def test_serve_federation_and_autoscale_exit_2(argv):
    proc = subprocess.run(
        [sys.executable, "-m", "rca_tpu_torch", "serve", *argv, "--device",
         "cpu"], cwd=str(ROOT), capture_output=True, text=True, timeout=120)
    want = ("--autoscale 3:4: --federation 2 is outside [3, 4]"
            if "--federation" in argv else
            "--autoscale with --listen needs --federation N (an elastic "
            "fleet is a federation property; in-process pools resize via "
            "RCA_SERVE_REPLICAS)")
    assert proc.returncode == 1
    assert proc.stderr.strip().splitlines()[-1] == want
    assert proc.stdout == ""


def test_fleet_against_a_gateway_with_no_fleet(engine, capsys):
    from rca_tpu_torch.cli import main

    with ServeLoop(engine=engine) as loop, GatewayServer(loop,
                                                         port=0) as gw:
        url = f"http://{gw.host}:{gw.port}"
        assert main(["fleet", url]) == 1
        out = json.loads(capsys.readouterr().out)
        assert out["error"].startswith("not a federation gateway")
        assert out["health"]["ok"] is True
        assert main(["fleet", url, "--json"]) == 0
        assert json.loads(capsys.readouterr().out)["breaker"] == "closed"


def test_listen_needs_a_card_unless_asked_for_the_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card rule does not "
                    "apply")
    env = {k: v for k, v in os.environ.items() if k != "RCA_SHARD"}
    proc = subprocess.run(
        [sys.executable, "-m", "rca_tpu_torch", "serve", "--listen",
         "127.0.0.1:0"], cwd=str(ROOT), capture_output=True, text=True,
        timeout=120, env=env)
    assert proc.returncode != 0 and "CUDA" in proc.stderr
    assert '"listening"' not in proc.stdout
