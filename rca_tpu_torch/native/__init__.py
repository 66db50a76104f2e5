"""Native host scanners: the C++ log scanner (ctypes) and the C sanitize
extension, built on first use with g++ from this directory's sources.

The port's own copy of the JAX package's ``native`` loader, with its own
user-private cache (``~/.cache/rca_tpu_torch``), so that neither package
ever loads the other's shared object.  The 13-class scan is a single-pass
C++ matcher; the Python regex scanner
(:func:`rca_tpu_torch.features.logscan.scan_text_python`) stays the
always-available fallback where no toolchain exists (``RCA_NATIVE_SCAN=0``
disables the native path, ``RCA_NATIVE_SANITIZE=0`` the C sanitize,
``RCA_NATIVE_CACHE`` moves the cache; parity is enforced by
tests/test_torch_native.py).

The alternative table below mirrors
``rca_tpu_torch.features.logscan.LOG_PATTERNS`` exactly — alternation
order included, because findall counts depend on which branch consumes
first.  Tokens: \\x01 digit, \\x02 word+, \\x03 ws*, \\x04 ws, \\x06
greedy-any-then-literal-tail.  Flags: 1 = word boundary, 2 = case
sensitive.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from rca_tpu_torch.config import (
    native_cache_dir,
    native_sanitize_mode,
    native_scan_mode,
)

D = "\x01"   # one digit
W = "\x02"   # one or more word chars
WS0 = "\x03"  # zero or more whitespace
WS1 = "\x04"  # exactly one whitespace
ANY = "\x06"  # greedy within-line any, followed by literal tail

# (flags, pattern) per alternative; order matches the regex alternation in
# rca_tpu_torch.features.logscan.LOG_PATTERNS.
SPEC_TABLE: List[Tuple[str, List[Tuple[int, str]]]] = [
    ("oom_kill", [
        (0, "out of memory"), (0, "oomkilled"),
        (0, "signal:" + WS0 + "killed"),
        (0, "oom-kill"), (0, "oom_kill"), (0, "oomkill"),
    ]),
    ("connection_refused", [(0, "connection refused"), (0, "econnrefused")]),
    ("permission_denied", [
        (0, "permission denied"), (0, "access denied"), (1, "forbidden"),
    ]),
    ("timeout", [
        # timed?\s?-?out expanded, greedy order (d, ws, dash present first)
        (0, "timed" + WS1 + "-out"), (0, "timed" + WS1 + "out"),
        (0, "timed-out"), (0, "timedout"),
        (0, "time" + WS1 + "-out"), (0, "time" + WS1 + "out"),
        (0, "time-out"), (0, "timeout"),
        (0, "etimedout"), (0, "deadline exceeded"),
    ]),
    ("crash_loop", [
        (0, "crashloopbackoff"),
        (0, "back-off restarting"), (0, "backoff restarting"),
    ]),
    ("api_error", [
        (2, "api server error"), (2, "StatusCode=5" + D + D),
    ]),
    ("volume_mount", [
        (0, "unable to attach or mount volumes"),
        (0, "unable to mount volumes"),
        (0, "mountvolume." + W + " failed"),
    ]),
    ("image_pull", [
        (0, "errimagepull"), (0, "imagepullbackoff"),
        (0, "failed to pull image"),
    ]),
    ("dns_resolution", [
        (0, "could not resolve"), (0, "dns resolution failed"),
        (0, "no such host"),
    ]),
    ("authentication", [(0, "unauthorized"), (0, "authentication fail")]),
    ("config_error", [
        (0, "invalid configuration"),
        (0, "configmap " + ANY + "not found"),
        (0, "secret " + ANY + "not found"),
    ]),
    ("internal_server_error", [
        (0, "internal server error"), (0, "internal servererror"),
        (0, "internalserver error"), (0, "internalservererror"),
        (0, "500 internal"),
    ]),
    ("exception", [
        (1, "exception"), (1, "error"), (0, "traceback"),
        (1, "fatal"), (1, "critical"), (0, "panic:"), (0, "panic"),
    ]),
]

SPEC_CLASS_NAMES = [name for name, _ in SPEC_TABLE]


def serialize_spec() -> bytes:
    classes = []
    for _, alts in SPEC_TABLE:
        classes.append(
            "\x1f".join(chr(ord("0") + flags) + pat for flags, pat in alts)
        )
    return "\x1e".join(classes).encode("latin-1")


_SOURCE = Path(__file__).with_name("logscan.cpp")
_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def _default_cache_dir() -> Path:
    """User-private cache location: ~/.cache/rca_tpu_torch when HOME
    resolves, else a uid-suffixed tempdir.  A world-shared path would let
    any local user pre-seed a .so whose hash tag is computable from the
    public source, and load_sanitize() imports that file as a full CPython
    extension — arbitrary code execution.  The dir is created 0700 and
    re-verified before any load."""
    try:
        home = Path.home()  # raises RuntimeError in HOME-less containers
        if home != Path("/") and os.access(str(home), os.W_OK):
            return home / ".cache" / "rca_tpu_torch"
    except (RuntimeError, OSError):
        pass
    return Path(tempfile.gettempdir()) / f"rca_tpu_torch_native-{os.getuid()}"


def _owned_and_private(path: Path, is_dir: bool) -> bool:
    """True when *path* is owned by us and not writable by group/other —
    the precondition for trusting a cached artifact enough to dlopen it."""
    try:
        st = os.stat(path, follow_symlinks=False)
    except OSError:
        return False
    if st.st_uid != os.getuid():
        return False
    if is_dir and not os.path.isdir(path):
        return False
    return (st.st_mode & 0o022) == 0


def _compile_cached(source: Path, out_prefix: str,
                    extra_flags: List[str]) -> Optional[Path]:
    """Shared lazy-compile pipeline: hash-tagged cache in a user-private
    0700 dir (RCA_NATIVE_CACHE overrides the location, not the ownership
    checks), unpredictable-suffix tmp + atomic rename, g++; None when the source,
    toolchain, or a trustworthy cache dir is unavailable.  Used by both
    the ctypes log scanner and the sanitize CPython extension."""
    import sysconfig

    try:
        src = source.read_bytes()
    except OSError:
        return None
    # the tag must bind the artifact to THIS interpreter's ABI: a CPython
    # extension built under another Python would be dlopen'd from the
    # shared cache and crash, not fall back (the ctypes logscan .so is
    # ABI-independent but rides the same scheme harmlessly)
    abi = sysconfig.get_config_var("SOABI") or "unknown-abi"
    tag = hashlib.sha256(src + abi.encode()).hexdigest()[:16]
    env_dir = native_cache_dir()
    if env_dir:
        # an explicitly-configured path may be the user's own symlink to a
        # private scratch dir; check the TARGET's ownership, not the
        # link's lstat-mode-0777
        cache_dir = Path(env_dir).resolve()
    else:
        cache_dir = _default_cache_dir()
        if cache_dir.is_symlink():
            # the /tmp fallback name is predictable and /tmp is
            # world-writable: a pre-seeded symlink would redirect the
            # chmod+compile into an attacker-chosen victim-owned dir
            return None
    try:
        if env_dir:
            # an explicitly-configured location may sit under deliberately
            # shared parents: those follow the site's umask so teammates
            # keep traversal rights.  The LEAF is still created 0700 (a
            # fresh leaf is ours; an existing one is ownership-checked,
            # never chmod'ed, below)
            cache_dir.parent.mkdir(parents=True, exist_ok=True)
            cache_dir.mkdir(mode=0o700, exist_ok=True)
        else:
            # default location: mkdir(parents=True) gives INTERMEDIATE
            # dirs the umask default, which under umask 002 would leave a
            # freshly-created ~/.cache group-writable and void the leaf
            # ownership check — create every missing component 0700
            for part in (*reversed(cache_dir.parents), cache_dir):
                if not part.exists():
                    part.mkdir(mode=0o700, exist_ok=True)
    except OSError:
        return None
    if not _owned_and_private(cache_dir, is_dir=True):
        # DEFAULT dir + our uid: our own artifact of a looser-umask era —
        # repair like the stale-.so branch below.  An env-configured dir
        # may be deliberately shared (mode 2775 team cache): never mutate
        # its permissions; anyone else's dir stays untrusted.  Either
        # rejection must be observable, not a silent permanent fallback
        # to the slow Python paths.
        repairable = False
        if not env_dir:
            try:
                repairable = os.stat(
                    cache_dir, follow_symlinks=False
                ).st_uid == os.getuid()
            except OSError:
                return None
        if not repairable:
            import warnings
            warnings.warn(
                f"native cache dir {cache_dir} is not exclusively owned "
                "by this user; native log scanner/sanitizer disabled "
                "(point RCA_NATIVE_CACHE at a private, user-owned path)",
                RuntimeWarning, stacklevel=2,
            )
            return None
        try:
            os.chmod(cache_dir, 0o700)
        except OSError:
            return None
        if not _owned_and_private(cache_dir, is_dir=True):
            return None
    out = cache_dir / f"{out_prefix}-{tag}.so"
    if out.exists():
        if _owned_and_private(out, is_dir=False):
            return out
        # the dir passed the ownership check, so nobody else could have
        # written this — it's our own stale artifact from a looser umask
        # era; rebuild rather than silently losing the native path forever
        try:
            # missing_ok: a concurrent process may have won the same repair
            out.unlink(missing_ok=True)
        except OSError:
            return None
    # unpredictable tmp name: a pid suffix could be pre-planted as a
    # symlink while the dir was still loose, and g++ -o writes THROUGH a
    # symlink (O_TRUNC on the victim file)
    import secrets
    tmp = out.with_suffix(f".{secrets.token_hex(8)}.tmp.so")
    cmd = (["g++", "-O2", "-shared", "-fPIC"] + extra_flags
           + [str(source), "-o", str(tmp)])
    try:
        proc = subprocess.run(cmd, capture_output=True, timeout=120)
        if proc.returncode != 0:
            return None
        # g++ output inherits the umask; under umask 0002 that leaves the
        # group-write bit set and every LATER process would reject the
        # cached artifact via _owned_and_private and silently lose the
        # native path — normalize so fresh artifacts pass their own check
        os.chmod(tmp, 0o600)
        os.replace(tmp, out)
        return out
    except (OSError, subprocess.TimeoutExpired):
        return None
    finally:
        try:
            tmp.unlink(missing_ok=True)  # no-op when os.replace moved it
        except OSError:
            pass


def _build_library() -> Optional[Path]:
    """Compile logscan.cpp into a cached .so; None when no toolchain."""
    return _compile_cached(_SOURCE, "liblogscan", ["-std=c++17"])


def load_native() -> Optional[ctypes.CDLL]:
    """The compiled scanner, or None (disabled / no compiler / failed)."""
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    _load_attempted = True
    if native_scan_mode() == "0":
        return None
    path = _build_library()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
        lib.rca_load_spec.argtypes = [ctypes.c_char_p, ctypes.c_long]
        lib.rca_load_spec.restype = ctypes.c_int
        lib.rca_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.rca_scan.restype = ctypes.c_int
        spec = serialize_spec()
        n = lib.rca_load_spec(spec, len(spec))
        if n != len(SPEC_TABLE):
            return None
        _lib = lib
    except OSError:
        return None
    return _lib


def native_available() -> bool:
    return load_native() is not None


def scan_text_native(text: str) -> Optional[np.ndarray]:
    """Counts per class via the C++ scanner; None when unavailable."""
    lib = load_native()
    if lib is None:
        return None
    data = text.encode("utf-8", errors="replace")
    counts = (ctypes.c_int32 * len(SPEC_TABLE))()
    rc = lib.rca_scan(data, len(data), counts)
    if rc != 0:
        return None
    return np.asarray(list(counts), dtype=np.int32)


# ---- native sanitizer (CPython extension; see sanitizec.c) ---------------

_SAN_SOURCE = Path(__file__).with_name("sanitizec.c")
_san_mod = None
_san_load_attempted = False


def _build_sanitize_ext() -> Optional[Path]:
    """Compile sanitizec.c into a cached extension .so; None w/o toolchain."""
    import sysconfig

    include = sysconfig.get_paths().get("include")
    if not include or not os.path.exists(os.path.join(include, "Python.h")):
        return None
    return _compile_cached(
        _SAN_SOURCE, "sanitizec", ["-x", "c", f"-I{include}"]
    )


def load_sanitize():
    """The native sanitize extension module, or None (disabled/unbuildable).

    Extension modules must be loaded through importlib's machinery (they
    export PyInit_*, not a C ABI), so this is not a ctypes load like the
    log scanner's."""
    global _san_mod, _san_load_attempted
    if _san_load_attempted:
        return _san_mod
    _san_load_attempted = True
    if native_sanitize_mode() == "0":
        return None
    path = _build_sanitize_ext()
    if path is None:
        return None
    try:
        import importlib.machinery
        import importlib.util

        # the module name MUST match the C PyInit_<name> symbol
        loader = importlib.machinery.ExtensionFileLoader(
            "sanitizec", str(path)
        )
        spec = importlib.util.spec_from_loader("sanitizec", loader)
        mod = importlib.util.module_from_spec(spec)
        loader.exec_module(mod)
        _san_mod = mod
    except Exception:
        _san_mod = None
    return _san_mod
