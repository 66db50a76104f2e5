"""The port's streaming session against the JAX package's, and against
itself.

- ``fetch(dispatch())`` equals ``tick()``, and a manual depth-2 pipeline
  (dispatch N, stage N+1, fetch N) equals the serial sequence shifted by
  one, bitwise;
- the packed delta ``(idx, rows)`` of mixed ``update`` / ``update_many`` /
  ``update_rows`` staging equals the reference's ``_pack_pending``;
- ``set_all``'s bulk upload is reported by the next tick, as in the
  reference;
- ticks rank as the reference's under the engine contract; after a NaN
  delta the persisted buffer equals the reference session's buffer
  bitwise, and in the window after a raw ``set_all`` the quiet ticks
  report the reference's ``sanitized_rows``;
- the front's persisting launch: its plain version zeroes exactly the bad
  rows in place and leaves every output as the reading launch's; on the
  card (marker ``cuda``) the kernel against it;
- ``topology_digest`` is the reference's.
"""

import json

import numpy as np
import pytest
import torch

from rca_tpu.cluster.generator import synthetic_cascade_arrays as ref_cascade
from rca_tpu.engine.runner import GraphEngine as RefEngine
from rca_tpu.engine.streaming import StreamingSession as RefStreaming
from rca_tpu.engine.streaming import topology_digest as ref_topology_digest
from rca_tpu_torch import GraphEngine
from rca_tpu_torch.engine import evidence
from rca_tpu_torch.engine.streaming import StreamingSession, topology_digest
from rca_tpu_torch.kernels import PERSIST_LAUNCHES

C = 13


def _ranked_key(out):
    return json.dumps(out["ranked"], sort_keys=True)


def _port(case, k=4, **kw):
    return StreamingSession(case.names, case.dep_src, case.dep_dst,
                            num_features=C, engine=GraphEngine(device="cpu"),
                            k=k, **kw)


def _ref(case, k=4):
    return RefStreaming(case.names, case.dep_src, case.dep_dst,
                        num_features=C, engine=RefEngine(resident=False),
                        k=k)


def _deltas(case, n_ticks, seed=3, per_tick=5):
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n_ticks):
        rows = {
            int(i): np.clip(case.features[i] + rng.uniform(
                -0.2, 0.2, C), 0, 1).astype(np.float32)
            for i in rng.integers(0, case.n, per_tick)
        }
        if t % 4 == 2:
            rows[int(rng.integers(0, case.n))] = np.full(C, np.nan,
                                                         np.float32)
        if t % 4 == 3:
            rows = {}                      # a quiet tick
        out.append(rows)
    return out


def test_dispatch_fetch_equals_tick():
    case = ref_cascade(300, n_roots=1, seed=5)
    a, b = _port(case, k=3), _port(case, k=3)
    for s in (a, b):
        s.set_all(case.features)
    for rows in _deltas(case, 6):
        a.update_many(rows)
        b.update_many(rows)
        out_a = a.tick()
        out_b = b.fetch(b.dispatch())
        assert out_a["ranked"] == out_b["ranked"]
        assert out_a["upload_rows"] == out_b["upload_rows"]
        assert out_a["sanitized_rows"] == out_b["sanitized_rows"]
        assert out_b["dispatch_ms"] >= 0 and out_b["fetch_ms"] >= 0
    assert torch.equal(a._features, b._features)


@pytest.mark.parametrize("kernel", ["torch", "kernels"])
def test_manual_depth_two_equals_serial_shifted(kernel, monkeypatch):
    """Dispatch N, stage N+1, fetch N: the fetched sequence equals the
    serial one, bitwise, on either registry row (``kernels`` runs the
    kernels' plain versions here)."""
    monkeypatch.setenv("RCA_KERNEL", kernel)
    monkeypatch.setenv("RCA_KERNEL_CACHE", "off")
    case = ref_cascade(400, n_roots=2, seed=9)
    deltas = _deltas(case, 8, seed=4)

    def session():
        s = _port(case)
        assert s.kernel_path == kernel
        s.set_all(case.features)
        s.tick()
        return s

    serial = session()
    serial_seq = []
    for rows in deltas:
        serial.update_many(rows)
        out = serial.tick()
        serial_seq.append((out["ranked"], out["upload_rows"],
                           out["sanitized_rows"]))
    piped = session()
    piped_seq = []
    prev = None
    for rows in deltas:
        piped.update_many(rows)
        handle = piped.dispatch()
        if prev is not None:
            out = piped.fetch(prev)
            piped_seq.append((out["ranked"], out["upload_rows"],
                              out["sanitized_rows"]))
        prev = handle
    out = piped.fetch(prev)
    piped_seq.append((out["ranked"], out["upload_rows"],
                      out["sanitized_rows"]))
    assert piped_seq == serial_seq
    assert torch.equal(piped._features, serial._features)


def _stage(session, rng, n):
    """Mixed staging: single updates, a dict, and overlapping blocks (the
    last write per index wins across all three)."""
    for i in rng.integers(0, n, 3):
        session.update(int(i), rng.uniform(0, 1, C).astype(np.float32))
    session.update_many({int(i): rng.uniform(0, 1, C).astype(np.float32)
                         for i in rng.integers(0, n, 4)})
    idx = rng.integers(0, n, 6)
    session.update_rows(idx, rng.uniform(0, 1, (6, C)).astype(np.float32))
    session.update(int(idx[0]), np.full(C, 0.5, np.float32))


def test_packed_delta_equals_reference():
    case = ref_cascade(200, n_roots=1, seed=2)
    port, ref = _port(case), _ref(case)
    for seed in range(5):
        for s in (port, ref):
            _stage(s, np.random.default_rng(seed), case.n)
        got = port._pack_pending(port._n_pad - 1)
        want = ref._pack_pending(ref._n_pad - 1)
        assert got[:2] == want[:2]
        assert got[2].dtype == want[2].dtype == np.int32
        assert np.array_equal(got[2], want[2])
        assert np.array_equal(got[3], want[3])
        assert len(np.unique(got[2][: got[0]])) == got[0]
        for s in (port, ref):
            s._account_upload(0)


def test_set_all_upload_accounting_equals_reference():
    case = ref_cascade(150, n_roots=1, seed=1)
    port, ref = _port(case), _ref(case)
    seq = []
    for s in (port, ref):
        s.set_all(case.features)
        s.update(3, np.zeros(C, np.float32))
        first = s.tick()["upload_rows"]
        quiet = s.tick()["upload_rows"]
        s.set_all(case.features)
        again = s.tick()["upload_rows"]
        seq.append((first, quiet, again, s.last_upload_rows))
    assert seq[0] == seq[1] == (256 + 1, 0, 256, 256)


def test_ticks_and_persisted_buffer_match_reference():
    """A NaN row in ``set_all`` (raw until the first delta tick) and NaN
    deltas later: every tick ranks as the reference's, reports its
    ``sanitized_rows`` and upload rows, and the persisted buffer equals
    the reference session's after every tick."""
    case = ref_cascade(300, n_roots=2, seed=8)
    port, ref = _port(case), _ref(case)
    start = case.features.copy()
    start[[4, 90]] = np.nan
    start[7, 2] = np.inf
    for s in (port, ref):
        s.set_all(start)
    deltas = [{}, {}] + _deltas(case, 10, seed=6)
    for t, rows in enumerate(deltas):
        for s in (port, ref):
            s.update_many(rows)
        got, want = port.tick(), ref.tick()
        assert [r["component"] for r in got["ranked"]] == \
            [r["component"] for r in want["ranked"]], t
        np.testing.assert_allclose([r["score"] for r in got["ranked"]],
                                   [r["score"] for r in want["ranked"]],
                                   rtol=1e-5, atol=1e-6)
        for key in ("sanitized_rows", "upload_rows", "tick"):
            assert got[key] == want[key], (t, key)
        assert np.array_equal(port._features.numpy(),
                              np.asarray(ref._features), equal_nan=True), t
    # the raw set_all window: both quiet ticks saw the 3 poisoned rows
    assert port.ticks == len(deltas)


def test_quiet_window_after_raw_set_all_reports_sanitized_rows():
    case = ref_cascade(120, n_roots=1, seed=3)
    port, ref = _port(case), _ref(case)
    bad = case.features.copy()
    bad[[1, 2]] = np.nan
    counts = []
    for s in (port, ref):
        s.set_all(bad)
        quiet = [s.tick()["sanitized_rows"] for _ in range(3)]
        s.update(50, case.features[50])
        flush = s.tick()["sanitized_rows"]
        after = s.tick()["sanitized_rows"]
        counts.append((quiet, flush, after))
    assert counts[0] == counts[1] == ([2, 2, 2], 2, 0)
    assert not np.isnan(port._features.numpy()).any()


def test_persisting_front_plain_zeroes_bad_rows_in_place():
    rng = np.random.default_rng(0)
    f = rng.uniform(-0.2, 1.2, (64, C)).astype(np.float32)
    f[[3, 40]] = np.nan
    f[9, 5] = -np.inf
    raw = torch.from_numpy(f.copy())
    buf = raw.clone()
    aw = torch.from_numpy(rng.uniform(0.2, 0.9, C).astype(np.float32))
    hw = torch.from_numpy(rng.uniform(0.2, 0.9, C).astype(np.float32))
    kept = evidence.evidence_front_rows(raw.clone(), aw, hw)
    before = dict(PERSIST_LAUNCHES)
    got = evidence.evidence_front_rows(buf, aw, hw, persist=True)
    assert PERSIST_LAUNCHES == before           # the plain version
    for g, w in zip(got, kept):
        assert torch.equal(g, w)
    clean, n_bad = evidence.finite_mask_rows(raw)
    assert int(n_bad) == 3
    assert torch.equal(buf, clean)
    assert torch.equal(buf[[0, 10, 63]], raw[[0, 10, 63]])
    with pytest.raises(ValueError, match="contiguous"):
        evidence.evidence_front_rows(buf.t().contiguous().t(), aw, hw,
                                     persist=True)


def test_use_torch_row_keeps_the_buffer_and_the_ranking(monkeypatch):
    monkeypatch.setenv("RCA_KERNEL", "kernels")
    monkeypatch.setenv("RCA_KERNEL_CACHE", "off")
    case = ref_cascade(200, n_roots=1, seed=4)
    a, b = _port(case), _port(case)
    for s in (a, b):
        s.set_all(case.features)
        s.update(5, np.full(C, np.nan, np.float32))
        s.tick()
    b.use_torch_row()
    assert (a.kernel_path, b.kernel_path) == ("kernels", "torch")
    assert torch.equal(a._features, b._features)
    got, want = b.tick(), a.tick()
    assert [r["component"] for r in got["ranked"]] == \
        [r["component"] for r in want["ranked"]]


def test_topology_digest_equals_reference():
    parts = [("svc-a", ["b", "c"]), {"z": 1, "a": (2, 3)}, 7, "x"]
    assert topology_digest("world", parts) == \
        ref_topology_digest("world", parts)
    assert topology_digest("world", parts) != topology_digest("other", parts)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the persisting evidence_front launch "
                    "runs only on the card (python3 chip_smoke.py runs it "
                    "there)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_persisting_front_kernel_matches_plain_on_card(cuda_device):
    from rca_tpu_torch.kernels import LAUNCHES

    rng = np.random.default_rng(1)
    persisting = PERSIST_LAUNCHES["evidence_front"]
    f = rng.uniform(-0.2, 1.2, (53248, C)).astype(np.float32)
    f[[3, 777, 53247]] = np.nan
    f[1001, 12] = np.inf
    aw = torch.from_numpy(rng.uniform(0.2, 0.9, C).astype(
        np.float32)).to(cuda_device)
    hw = torch.from_numpy(rng.uniform(0.2, 0.9, C).astype(
        np.float32)).to(cuda_device)
    buf = torch.from_numpy(f).to(cuda_device)
    plain_buf = torch.from_numpy(f.copy())
    before = LAUNCHES["evidence_front"]
    got = evidence.evidence_front_rows(buf, aw, hw, persist=True)
    want = evidence.evidence_front_rows_plain(plain_buf, aw.cpu(), hw.cpu(),
                                              persist=True)
    assert LAUNCHES["evidence_front"] == before + 1
    assert PERSIST_LAUNCHES["evidence_front"] == persisting + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert torch.equal(buf.cpu(), plain_buf)
