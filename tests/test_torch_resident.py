"""The port's device-resident analyze sessions against restaging and
against the JAX package's resident engine.

- over seeded update / delete (zero reset) / NaN / Inf sequences, the
  port's resident path (the default) is bitwise equal to
  ``GraphEngine(resident=False)``: rankings, the ``[4, n_pad]`` stack,
  ``sanitized_rows``, the attribution block;
- the same sequence holds the port to ``rca_tpu``'s resident engine under
  the engine contract (``u`` bitwise, scores rtol 1e-5 / atol 1e-6, top-k
  identical with tie order, ``sanitized_rows`` equal), and the caches'
  ``stats()`` (LRU counters, requests, upload and fetch bytes) are equal;
- an identical request uploads nothing, a delta is O(changed rows), a
  failed request drops the mirror so the next one restages, whichever
  features it carries;
- ``graph_digest`` is the reference's, and ``RCA_RESIDENT`` /
  ``RCA_RESIDENT_CACHE`` are validated as the reference validates them.
"""

import numpy as np
import pytest

from rca_tpu.cluster.generator import synthetic_cascade_arrays as ref_cascade
from rca_tpu.config import resident_cache_cap as ref_cache_cap
from rca_tpu.config import resident_enabled as ref_enabled
from rca_tpu.engine.resident import graph_digest as ref_digest
from rca_tpu.engine.runner import GraphEngine as RefEngine
from rca_tpu_torch import GraphEngine
from rca_tpu_torch.config import resident_cache_cap, resident_enabled
from rca_tpu_torch.engine import resident as port_resident
from rca_tpu_torch.engine.resident import ResidentCache, graph_digest


def _case(n=96, seed=0):
    return ref_cascade(n, n_roots=1, seed=seed)


def _sequence(case, steps=12, seed=11):
    """Feature matrices of one graph over time: sparse updates, deletes
    (rows reset to zero), NaN and Inf poisoning, then a heal with dense
    churn (a delta wider than n_pad / 2)."""
    n, C = case.features.shape
    rng = np.random.default_rng(seed)
    feats = case.features.copy()
    out = []
    for step in range(steps):
        kind = step % 4
        if kind == 0:
            rows = rng.integers(0, n, rng.integers(1, 9))
            feats[rows] = np.clip(
                feats[rows] + rng.uniform(-0.3, 0.3, (len(rows), C)), 0, 1,
            ).astype(np.float32)
        elif kind == 1:
            feats[rng.integers(0, n, 3)] = 0.0
        elif kind == 2:
            feats[int(rng.integers(0, n))] = np.nan
            feats[int(rng.integers(0, n)), 0] = np.inf
        else:
            feats = np.nan_to_num(feats, posinf=0.0)
            feats = np.clip(
                feats + rng.uniform(-0.02, 0.02, feats.shape), 0, 1,
            ).astype(np.float32)
        out.append(feats.copy())
    return out


def _assert_bitwise(a, b, ctx=""):
    assert a.ranked == b.ranked, ctx
    assert np.array_equal(a.full_diagnostics(), b.full_diagnostics()), ctx
    assert a.sanitized_rows == b.sanitized_rows, ctx
    assert a.engine == b.engine == "single", ctx


def test_resident_is_bitwise_restaging_over_update_delete_nan():
    case = _case()
    resident = GraphEngine(device="cpu")            # RCA_RESIDENT default
    fresh = GraphEngine(device="cpu", resident=False)
    assert resident._resident_cache is not None
    for step, feats in enumerate(_sequence(case)):
        a = resident.analyze_arrays(feats, case.dep_src, case.dep_dst,
                                    case.names, k=5)
        b = fresh.analyze_arrays(feats, case.dep_src, case.dep_dst,
                                 case.names, k=5)
        _assert_bitwise(a, b, f"step {step}")
    stats = resident._resident_cache.stats()
    assert stats["delta_requests"] >= 6 and stats["sessions"] == 1
    # the attribution context is the request's host features
    assert a.attribution() == b.attribution()


def test_resident_matches_reference_resident_engine():
    case = _case(120, seed=4)
    port = GraphEngine(device="cpu")
    ref = RefEngine(resident=True)
    for step, feats in enumerate(_sequence(case, steps=12, seed=5)):
        got = port.analyze_arrays(feats, case.dep_src, case.dep_dst,
                                  case.names, k=5)
        want = ref.analyze_arrays(feats, case.dep_src, case.dep_dst,
                                  case.names, k=5)
        ctx = f"step {step}"
        assert got.top_components() == want.top_components(), ctx
        assert got.sanitized_rows == want.sanitized_rows, ctx
        assert np.array_equal(got.upstream, want.upstream), ctx
        np.testing.assert_allclose(got.score, want.score, rtol=1e-5,
                                   atol=1e-6, err_msg=ctx)
    assert port._resident_cache.stats() == ref._resident_cache.stats()


def _session(engine):
    return next(iter(engine._resident_cache._sessions.values()))


def test_identical_request_uploads_nothing():
    case = _case(48, seed=3)
    eng = GraphEngine(device="cpu")
    eng.analyze_case(case, k=3)
    sess = _session(eng)
    assert sess.last_upload_rows == sess._n_pad     # first staging is bulk
    before = sess.upload_bytes
    eng.analyze_case(case, k=3)
    assert sess.last_upload_rows == 0
    assert sess.upload_bytes == before
    assert sess.delta_requests == 1


def test_upload_is_o_changed_rows():
    case = _case(200, seed=5)
    eng = GraphEngine(device="cpu")
    eng.analyze_case(case, k=5)
    sess = _session(eng)
    before = sess.upload_bytes
    for u, u_pad in ((1, 1), (3, 4), (9, 16)):
        f2 = case.features.copy()
        f2[17:17 + u] = np.clip(f2[17:17 + u] + 0.25, 0, 1)
        eng.analyze_arrays(f2, case.dep_src, case.dep_dst, case.names, k=5)
        assert sess.last_upload_rows == u_pad
        assert sess.upload_bytes - before == u_pad * (4 + 13 * 4)
        eng.analyze_case(case, k=5)      # back: the same rows again
        assert sess.last_upload_rows == u_pad
        before = sess.upload_bytes


def test_a_failed_request_leaves_the_mirror(monkeypatch):
    case = _case(64, seed=2)
    eng = GraphEngine(device="cpu")
    eng.analyze_case(case, k=3)
    f2 = case.features.copy()
    f2[5] = 0.5
    from rca_tpu_torch.engine import runner

    def broken(*args, **kwargs):
        raise RuntimeError("launch failed")

    with monkeypatch.context() as mp:
        mp.setattr(runner, "propagate_ranked", broken)
        with pytest.raises(RuntimeError):
            eng.analyze_arrays(f2, case.dep_src, case.dep_dst, case.names,
                               k=3)
    sess = _session(eng)
    assert sess._mirror is None
    got = eng.analyze_arrays(f2, case.dep_src, case.dep_dst, case.names, k=3)
    assert sess.last_upload_rows == sess._n_pad       # restaged
    want = GraphEngine(device="cpu", resident=False).analyze_arrays(
        f2, case.dep_src, case.dep_dst, case.names, k=3)
    _assert_bitwise(got, want)


def test_a_failed_delta_then_the_original_features_are_restaged(monkeypatch):
    """The failed request's rows reached the buffer before the raise: a
    later request equal to the OLD mirror must not diff as identical and
    rank from those rows."""
    case = _case(64, seed=3)
    eng = GraphEngine(device="cpu")
    eng.analyze_case(case, k=3)
    f2 = case.features.copy()
    f2[[5, 17]] = 0.5
    f2[30] = np.nan
    from rca_tpu_torch.engine import runner

    def broken(*args, **kwargs):
        raise RuntimeError("launch failed")

    with monkeypatch.context() as mp:
        mp.setattr(runner, "propagate_ranked", broken)
        with pytest.raises(RuntimeError):
            eng.analyze_arrays(f2, case.dep_src, case.dep_dst, case.names,
                               k=3)
    got = eng.analyze_arrays(case.features, case.dep_src, case.dep_dst,
                             case.names, k=3)
    assert _session(eng).last_upload_rows == _session(eng)._n_pad
    want = GraphEngine(device="cpu", resident=False).analyze_arrays(
        case.features, case.dep_src, case.dep_dst, case.names, k=3)
    _assert_bitwise(got, want)


def test_cache_lru_counters_and_stats_equal_reference():
    cases = [_case(40 + 8 * i, seed=i) for i in range(3)]
    port = GraphEngine(device="cpu")
    ref = RefEngine(resident=True)
    for eng in (port, ref):
        eng._resident_cache._cap = 2
        for c in cases:
            eng.analyze_case(c, k=3)
        eng.analyze_case(cases[-1], k=3)             # still resident
        eng.analyze_case(cases[0], k=3)              # evicted: a miss
    stats = port._resident_cache.stats()
    assert stats == ref._resident_cache.stats()
    assert (stats["misses"], stats["hits"], stats["evictions"],
            stats["sessions"]) == (4, 1, 2, 2)


def test_cache_cap_comes_from_the_env(monkeypatch):
    monkeypatch.setenv("RCA_RESIDENT_CACHE", "3")
    assert ResidentCache(GraphEngine(device="cpu"))._cap == 3


def test_graph_digest_equals_reference():
    c = _case(32, seed=1)
    for src, dst in ((c.dep_src, c.dep_dst), (c.dep_dst, c.dep_src),
                     (c.dep_src.astype(np.int64), c.dep_dst.astype(np.int64))):
        got = graph_digest(32, 13, src, dst)
        assert got == ref_digest(32, 13, src, dst)
    assert graph_digest(32, 13, c.dep_src, c.dep_dst) != \
        graph_digest(32, 13, c.dep_dst, c.dep_src)


@pytest.mark.parametrize("raw,on", [("", True), ("1", True), ("on", True),
                                    ("0", False), ("OFF", False)])
def test_rca_resident_parses_as_the_reference(monkeypatch, raw, on):
    monkeypatch.setenv("RCA_RESIDENT", raw)
    assert resident_enabled() is ref_enabled() is on
    assert (GraphEngine(device="cpu")._resident_cache is not None) is on


@pytest.mark.parametrize("name,raw", [("RCA_RESIDENT", "banana"),
                                      ("RCA_RESIDENT_CACHE", "0"),
                                      ("RCA_RESIDENT_CACHE", "2000"),
                                      ("RCA_RESIDENT_CACHE", "many")])
def test_malformed_resident_knobs_raise(monkeypatch, name, raw):
    monkeypatch.setenv(name, raw)
    for fn in ((resident_enabled, ref_enabled)
               if name == "RCA_RESIDENT" else
               (resident_cache_cap, ref_cache_cap)):
        with pytest.raises(ValueError):
            fn()


def test_timed_analysis_restages(monkeypatch):
    case = _case(64, seed=6)
    eng = GraphEngine(device="cpu")
    res = eng.analyze_case(case, timed=True)
    assert eng._resident_cache.stats()["requests"] == 0
    assert res.ranked == eng.analyze_case(case).ranked


def test_pow2_pad_matches_the_reference_rule():
    for u, want in ((0, 1), (1, 1), (2, 2), (3, 4), (64, 64), (65, 128)):
        assert port_resident.pow2_pad(u) == want


def test_resident_session_follows_a_kernel_row_flip(monkeypatch):
    """A session made on one registry row runs the row a restaged request
    would after ``RCA_KERNEL`` changes (the kernels' plain versions here),
    bitwise equal to restaging on either row."""
    monkeypatch.setenv("RCA_KERNEL_CACHE", "off")
    case = _case(80, seed=9)
    eng = GraphEngine(device="cpu")
    for kernel in ("torch", "kernels", "torch"):
        monkeypatch.setenv("RCA_KERNEL", kernel)
        got = eng.analyze_case(case, k=5)
        assert _session(eng)._plan.kernel == kernel
        want = GraphEngine(device="cpu", resident=False).analyze_case(
            case, k=5)
        _assert_bitwise(got, want, kernel)
