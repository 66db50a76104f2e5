"""Build and load the port's CUDA kernels.

All sources under ``rca_tpu_torch/csrc/`` compile with ONE ``nvcc`` call
into one shared library with a plain C interface (no PyTorch headers, so
the build takes seconds), which is loaded with ``ctypes``.  The build runs
at first use, never at import, into ``rca_tpu_torch/_build/`` (listed in
``.gitignore``); the library's file name carries a hash of the sources and
flags, so an edited kernel is rebuilt and a stale one is never loaded.

Every C entry returns the ``cudaError_t`` of its launches; :func:`check`
raises when it is not 0 (a refused launch never runs, and a later
synchronize would not report it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
#: seconds the last build took (0.0 when the library was already built)
BUILD_SECONDS = 0.0

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float   # without it ctypes passes a double
_SIGNATURES = {
    "rca_noisy_or_pair": (_P, _P, _P, _P, _P, _I, _I, _P),
    "rca_segscan": (_P, _P, _P, _P, _P, _I, _I, _P),
    "rca_segscan_block_size": (),
    "rca_seg_up_step": (_P, _P, _F, _P, _P, _P, _I, _P, _I, _P, _P),
    "rca_seg_down_step": (_P, _P, _P, _F, _P, _P, _P, _I, _P, _I, _P, _P),
}


def sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under ``CUDA_HOME`` or ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and Path(home, "bin", "nvcc").is_file():
            return str(Path(home, "bin", "nvcc"))
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the port's "
        "CUDA kernels cannot be built on this host"
    )


def _library_path() -> Path:
    h = hashlib.sha1(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librca_kernels-{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile every ``csrc/*.cu`` into the hashed library (once)."""
    global BUILD_SECONDS
    out = _library_path()
    if out.exists():
        BUILD_SECONDS = 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # build into a private name, then rename: a concurrent or cut build
    # never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp, *map(str, sources())]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        if verbose:
            print(proc.stdout + proc.stderr, end="")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_SECONDS = time.perf_counter() - t0
    return out


def library(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build(verbose=verbose)))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
