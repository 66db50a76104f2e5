"""The port's native host scanners against the regex scanner, the Python
sanitize and the JAX package's own native scanners.

The C++ log scanner (``rca_tpu_torch/native/logscan.cpp``) must count what
the regex scanner counts on every alternative of its spec table, on the
fixture worlds' logs and on crafted samples; the C sanitize extension
must return what the Python walk returns on fuzzed objects.  The port
builds both from its own sources into its own user-private cache, never
the reference's, and the cache's ownership checks are the reference's.
A toolchain (``g++``) is required: where there is none the tests say so
and fail rather than silently pass on the fallback.
"""

import copy
import os
import random
import shutil
from pathlib import Path

import numpy as np
import pytest

from rca_tpu.features.logscan import scan_text_python as ref_scan_python
from rca_tpu.native import SPEC_TABLE as REF_SPEC_TABLE
from rca_tpu.native import scan_text_native as ref_scan_native
from rca_tpu.native import serialize_spec as ref_serialize_spec
from rca_tpu_torch import native
from rca_tpu_torch.cluster.fixtures import NS, five_service_world
from rca_tpu_torch.cluster.generator import synthetic_cascade_world
from rca_tpu_torch.cluster.sanitize import sanitize_object, sanitize_objects
from rca_tpu_torch.features.logscan import (
    LOG_PATTERN_NAMES,
    scan_text,
    scan_text_python,
)

PORT_NATIVE = Path(native.__file__).resolve().parent

SAMPLES = [
    "",
    "INFO: all good\n" * 50,
    "ERROR: Database initialization failed\nFATAL: could not open file\n",
    "container oomkilled by kernel: out of memory\nsignal: killed\n",
    "oom-kill event; oom_killer invoked; OOMKilled\n",
    "connection refused to db:5432 (ECONNREFUSED)\n",
    "request timed out; deadline exceeded; ETIMEDOUT; timeout after 5s\n",
    "time out while waiting; timed-out again; time-out\n",
    "Back-off restarting failed container\nCrashLoopBackOff seen\n",
    "backoff restarting container now\n",
    "api server error; StatusCode=503 returned; StatusCode=5xx\n",
    "API SERVER ERROR uppercase should not match api_error\n",
    "Unable to attach or mount volumes: timed out\n",
    "MountVolume.SetUp failed for volume xyz\n",
    "ErrImagePull: failed to pull image 'x:1'\nImagePullBackOff\n",
    "could not resolve host; no such host; DNS resolution failed\n",
    "401 Unauthorized; authentication failure for user\n",
    "invalid configuration detected\nconfigmap \"app-cfg\" not found\n",
    "secret my-secret key not found in namespace\n",
    "HTTP 500 Internal Server Error\ninternal server error again\n",
    "Exception in thread main\nTraceback (most recent call last)\n",
    "errors everywhere but the word error stands alone: error!\n",
    "forbidden access; this_is_forbidden_token should not wordmatch\n",
    "panic: runtime error\npanicking is fine\n",
    "CRITICAL failure; criticality is not critical-word? critical.\n",
    "fatal: FATAL mistake; fatally wrong\n",
    "timed\t-out; time\nout; configmap x not\nfound; secret a not found b"
    " not found\n",
    (
        "2026-01-01T00:00:00Z ERROR failed to pull image registry/app:9\n"
        "2026-01-01T00:00:01Z warn connection refused: backend:8080\n"
        "2026-01-01T00:00:02Z info retrying in 5s\n"
        "2026-01-01T00:00:03Z ERROR Exception: deadline exceeded\n"
    ) * 20,
]

#: one concrete spelling per token of the spec's mini-language
_TOKENS = {native.D: "7", native.W: "SetUp_2", native.WS0: "  ",
           native.WS1: " ", native.ANY: "\"app-cfg\" key "}


def _spell(pattern: str, upper: bool) -> str:
    text = "".join(_TOKENS.get(ch, ch) for ch in pattern)
    return text.upper() if upper else text


def _alternative_texts():
    """Every alternative of every class, spelled out alone, in upper case
    (for the case-insensitive ones), inside a word (for the word-bounded
    ones) and twice on one line."""
    out = []
    for cls, alts in native.SPEC_TABLE:
        for flags, pattern in alts:
            text = _spell(pattern, upper=False)
            out.append((cls, text))
            out.append((cls, f"x {text} y {text}\n{text}"))
            if not flags & 2:
                out.append((cls, _spell(pattern, upper=True)))
            if flags & 1:
                out.append((cls, f"pre{text}post {text}_x"))
    return out


ALTERNATIVES = _alternative_texts()


@pytest.fixture(scope="module")
def scanner():
    lib = native.load_native()
    assert lib is not None, \
        "the native log scanner did not build (is g++ on the PATH?)"
    return lib


def test_spec_is_the_reference_spec_and_covers_every_class():
    assert native.SPEC_CLASS_NAMES == LOG_PATTERN_NAMES
    assert native.SPEC_TABLE == REF_SPEC_TABLE
    assert native.serialize_spec() == ref_serialize_spec()
    assert len(ALTERNATIVES) > 2 * sum(len(a) for _, a in native.SPEC_TABLE)


def test_scanner_is_built_from_the_port_sources(scanner):
    so = Path(scanner._name).resolve()
    assert so.name.startswith("liblogscan-") and so.suffix == ".so"
    assert native._SOURCE.resolve().parent == PORT_NATIVE
    assert native._SAN_SOURCE.resolve().parent == PORT_NATIVE
    # the port's cache, never the reference's
    configured = native.native_cache_dir()
    want = Path(configured).resolve() if configured else \
        native._default_cache_dir()
    assert so.parent == want.resolve()
    assert so.parent.name != "rca_tpu"


@pytest.mark.parametrize("idx", range(len(SAMPLES)))
def test_native_matches_python_regex(scanner, idx):
    text = SAMPLES[idx]
    got = native.scan_text_native(text)
    want = scan_text_python(text)
    assert got is not None and got.dtype == np.int32
    mismatches = {LOG_PATTERN_NAMES[i]: (int(got[i]), int(want[i]))
                  for i in range(len(want)) if got[i] != want[i]}
    assert not mismatches, f"native != regex on sample {idx}: {mismatches}"
    assert np.array_equal(got, ref_scan_python(text))


@pytest.mark.parametrize("cls", [name for name, _ in native.SPEC_TABLE])
def test_native_matches_regex_on_every_spec_alternative(scanner, cls):
    """Each alternative of the class alone, repeated, upper-cased and
    embedded in a word: the native counts equal the regex counts and the
    reference's native scanner's."""
    texts = [t for c, t in ALTERNATIVES if c == cls]
    assert texts
    hit = 0
    for text in texts:
        got = native.scan_text_native(text)
        want = scan_text_python(text)
        assert np.array_equal(got, want), (cls, text, got, want)
        assert np.array_equal(got, ref_scan_native(text)), (cls, text)
        hit += int(got[LOG_PATTERN_NAMES.index(cls)] > 0)
    assert hit >= len(texts) // 2      # the spellings do match their class


@pytest.mark.parametrize("world", ["5svc", "300svc"])
def test_native_matches_on_fixture_logs(scanner, world):
    w = five_service_world() if world == "5svc" else synthetic_cascade_world(
        300, n_roots=2, seed=5, mode="adversarial", fault_mix="mixed")
    checked = 0
    for ns_logs in list(w.logs.values()) + list(w.previous_logs.values()):
        for per_container in ns_logs.values():
            for text in per_container.values():
                assert np.array_equal(native.scan_text_native(text),
                                      scan_text_python(text))
                checked += 1
    assert checked > 3


def test_scan_text_dispatches_to_the_scanner_and_agrees(scanner,
                                                        monkeypatch):
    calls = []
    real = native.scan_text_native
    monkeypatch.setattr(native, "scan_text_native",
                        lambda text: calls.append(1) or real(text))
    for text in SAMPLES:
        assert np.array_equal(scan_text(text), scan_text_python(text))
    assert len(calls) == len(SAMPLES) - 1      # "" never reaches it


def test_scan_knob_off_takes_the_regex_path(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_attempted", False)
    monkeypatch.setenv("RCA_NATIVE_SCAN", "0")
    assert native.load_native() is None
    assert native.scan_text_native("error") is None
    assert np.array_equal(scan_text(SAMPLES[-1]),
                          scan_text_python(SAMPLES[-1]))


@pytest.mark.parametrize("name,values", [
    ("RCA_NATIVE_SCAN", ["", "auto", "0", "1", "on"]),
    ("RCA_NATIVE_SANITIZE", ["", "auto", "0", "1", "yes"]),
])
def test_native_knobs_parse_as_the_reference(monkeypatch, name, values):
    from rca_tpu.config import env_str as ref_env_str
    from rca_tpu_torch import config as port_cfg

    fn = {"RCA_NATIVE_SCAN": port_cfg.native_scan_mode,
          "RCA_NATIVE_SANITIZE": port_cfg.native_sanitize_mode}[name]
    for raw in values:
        monkeypatch.setenv(name, raw)
        try:
            want = ref_env_str(name, "auto", choices=("auto", "0", "1"))
        except ValueError as exc:
            with pytest.raises(ValueError) as got:
                fn()
            assert str(got.value) == str(exc)
            continue
        assert fn() == want
    monkeypatch.setenv("RCA_NATIVE_CACHE", "/somewhere/private")
    assert port_cfg.native_cache_dir() == "/somewhere/private"


def _mangle(obj, rng):
    if isinstance(obj, dict):
        for k in list(obj):
            r = rng.random()
            if r < 0.1:
                del obj[k]
            elif r < 0.18:
                obj[k] = None
            elif r < 0.2:
                obj[k] = 123  # wrong scalar type
            else:
                _mangle(obj[k], rng)
    elif isinstance(obj, list):
        for i, item in enumerate(obj):
            if rng.random() < 0.06:
                obj[i] = None
            else:
                _mangle(item, rng)


def test_native_sanitize_exact_parity_with_python():
    """The C sanitizer returns what the Python walk returns on fuzzed
    objects (deep equality), repairs wrong-typed metadata the same way and
    passes a well-formed object through unchanged."""
    from rca_tpu.cluster.sanitize import sanitize_object as ref_sanitize

    san = native.load_sanitize()
    assert san is not None, \
        "the native sanitize did not build (g++ and Python.h are needed)"
    assert Path(san.__file__).resolve().name.startswith("sanitizec-")
    world = five_service_world()
    objects = (world.pods[NS] + world.services[NS] + world.deployments[NS]
               + world.events[NS] + world.endpoints[NS] + world.hpas[NS]
               + world.ingresses[NS] + world.network_policies[NS])
    checked = 0
    for seed in range(30):
        rng = random.Random(seed)
        for obj in copy.deepcopy(objects):
            _mangle(obj, rng)
            py = sanitize_object(copy.deepcopy(obj))
            c = san.sanitize_object(copy.deepcopy(obj))
            assert c == py, f"seed {seed}: divergence on {obj!r:.300}"
            assert py == ref_sanitize(copy.deepcopy(obj))
            checked += 1
    assert checked > 500
    for bad in ("x", 123, ["y"]):
        obj = {"template": {"metadata": bad}}
        py = sanitize_object(copy.deepcopy(obj))
        assert py["template"]["metadata"] == {"name": "", "labels": {}}
        assert san.sanitize_object(copy.deepcopy(obj)) == py
    good = {"metadata": {"name": "x", "labels": {"app": "x"}},
            "spec": {"containers": [{"name": "c", "env": [
                {"name": "A", "value": "1"}]}]}}
    assert san.sanitize_object(good) is good
    # sanitize_objects takes the native walk and still fixes metadata
    assert sanitize_objects([{"metadata": None}, "x"]) == \
        [{"metadata": {"name": "", "labels": {}}}]


# -- the compile cache's trust logic (a one-function source: each cold
# compile costs milliseconds) ------------------------------------------------

TINY_SRC = "extern \"C\" int rca_cache_probe(void) { return 7; }\n"


@pytest.fixture()
def tiny_source(tmp_path):
    assert shutil.which("g++"), "the cache tests need g++"
    src = tmp_path / "probe.cpp"
    src.write_text(TINY_SRC)
    return src


def _compile(src):
    return native._compile_cached(src, "probe", ["-std=c++17"])


def test_loose_self_owned_default_dir_is_repaired(tmp_path, monkeypatch,
                                                  tiny_source):
    loose = tmp_path / "loose"
    loose.mkdir()
    os.chmod(loose, 0o777)
    monkeypatch.delenv("RCA_NATIVE_CACHE", raising=False)
    monkeypatch.setattr(native, "_default_cache_dir", lambda: loose)
    assert _compile(tiny_source) is not None
    assert (os.stat(loose).st_mode & 0o777) == 0o700


def test_loose_env_configured_dir_is_rejected_not_mutated(
        tmp_path, monkeypatch, tiny_source):
    shared = tmp_path / "shared"
    shared.mkdir()
    os.chmod(shared, 0o775)
    monkeypatch.setenv("RCA_NATIVE_CACHE", str(shared))
    with pytest.warns(RuntimeWarning, match="not exclusively owned"):
        assert _compile(tiny_source) is None
    assert (os.stat(shared).st_mode & 0o777) == 0o775  # untouched


def test_explicit_symlink_cache_is_followed(tmp_path, monkeypatch,
                                            tiny_source):
    target = tmp_path / "real-cache"
    link = tmp_path / "link-cache"
    link.symlink_to(target)
    monkeypatch.setenv("RCA_NATIVE_CACHE", str(link))
    out = _compile(tiny_source)
    assert out is not None and str(out).startswith(str(target))


def test_private_dir_and_stale_artifact_repair(tmp_path, monkeypatch,
                                               tiny_source):
    tight = tmp_path / "tight"
    monkeypatch.setenv("RCA_NATIVE_CACHE", str(tight))
    out = _compile(tiny_source)
    assert out is not None
    st = os.stat(tight)
    assert st.st_uid == os.getuid() and (st.st_mode & 0o022) == 0
    assert (os.stat(out).st_mode & 0o777) == 0o600
    os.chmod(out, 0o666)          # our own stale artifact: rebuilt
    out2 = _compile(tiny_source)
    assert out2 is not None and (os.stat(out2).st_mode & 0o777) == 0o600
    victim = tmp_path / "victim.txt"
    victim.write_text("precious")
    out2.unlink()
    out2.symlink_to(victim)       # never written through
    out3 = _compile(tiny_source)
    assert out3 is not None and not out3.is_symlink()
    assert victim.read_text() == "precious"


def test_default_fallback_never_follows_preseeded_symlink(
        tmp_path, monkeypatch, tiny_source):
    victim_dir = tmp_path / "victim-dir"
    victim_dir.mkdir()
    os.chmod(victim_dir, 0o770)
    fake_default = tmp_path / "preseeded-link"
    fake_default.symlink_to(victim_dir)
    monkeypatch.delenv("RCA_NATIVE_CACHE", raising=False)
    monkeypatch.setattr(native, "_default_cache_dir", lambda: fake_default)
    assert _compile(tiny_source) is None
    assert (os.stat(victim_dir).st_mode & 0o777) == 0o770  # untouched


def test_default_cache_dir_is_user_scoped_and_the_ports_own(monkeypatch,
                                                            tmp_path):
    from rca_tpu import native as ref_native

    d = native._default_cache_dir()
    assert d != ref_native._default_cache_dir()
    if str(os.getuid()) in d.name:  # tempdir fallback (HOME-less env)
        assert d.name.startswith("rca_tpu_torch_native-")
    else:
        assert str(d).startswith(str(Path.home()))
        assert d.name == "rca_tpu_torch"
    monkeypatch.setenv("HOME", str(tmp_path))
    assert native._default_cache_dir() == tmp_path / ".cache" / \
        "rca_tpu_torch"


def test_scanner_builds_into_a_configured_cache_only(tmp_path, monkeypatch):
    """A fresh load with ``RCA_NATIVE_CACHE`` set builds the scanner and
    the sanitize extension there, from the port's sources."""
    cache = tmp_path / "cache"
    monkeypatch.setenv("RCA_NATIVE_CACHE", str(cache))
    for attr, value in (("_lib", None), ("_load_attempted", False),
                        ("_san_mod", None), ("_san_load_attempted", False)):
        monkeypatch.setattr(native, attr, value)
    lib = native.load_native()
    assert lib is not None and Path(lib._name).parent == cache.resolve()
    assert np.array_equal(native.scan_text_native(SAMPLES[-1]),
                          scan_text_python(SAMPLES[-1]))
    san = native.load_sanitize()
    assert san is not None and Path(san.__file__).parent == cache.resolve()
    built = sorted(p.name.split("-")[0] for p in cache.iterdir())
    assert built == ["liblogscan", "sanitizec"]
