"""Build and load the port's CUDA kernels.

All sources under ``rca_tpu_torch/csrc/`` compile in parallel, one ``nvcc``
each, and link into one shared library with a plain C interface (no
PyTorch headers, so the build takes seconds), which is loaded with
``ctypes``.  The build runs
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
import tempfile
import time
from pathlib import Path
from typing import Optional

from rca_tpu_torch.config import env_raw
from rca_tpu_torch.observability.kernelscope import note_compile
from rca_tpu_torch.util.procs import WorkerProc, spawn_worker
from rca_tpu_torch.util.threads import make_lock

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_LOCK = make_lock("build._LOCK")
_LIB: Optional[ctypes.CDLL] = None
#: seconds the last build took (0.0 when the library was already built)
BUILD_SECONDS = 0.0

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float   # without it ctypes passes a double
_U = ctypes.c_uint
_Q = ctypes.c_ulonglong
_SIGNATURES = {
    "rca_noisy_or_pair": (_P, _P, _P, _P, _P, _I, _I, _P),
    "rca_segscan": (_P, _P, _P, _P, _P, _I, _I, _P),
    "rca_segscan_block_size": (),
    "rca_seg_up_step": (_P, _P, _F, _P, _P, _P, _I, _P, _I, _I, _I, _P,
                        _P),
    "rca_seg_down_step": (_P, _P, _P, _F, _P, _P, _P, _I, _P, _I, _I, _I,
                          _P, _P),
    "rca_evidence_front": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _P),
    "rca_seg_contrast_step": (_P, _P, _F, _P, _P, _P, _I, _P, _I, _I, _I,
                              _P, _P),
    "rca_evidence_front_fused": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                 _I, _F, _I, _I, _P, _P, _P, _I, _P, _I,
                                 _I, _P),
    "rca_evidence_front_fused_cap": (_I, _I, _P),
    "rca_evidence_front_shard": (_P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I,
                                 _F, _I, _P, _P, _P, _I, _I, _P),
    "rca_evidence_front_shard_cap": (_I, _P),
    "rca_seg_up_step_shard": (_P, _P, _F, _I, _I, _P, _P, _P, _I, _P, _I,
                              _I, _I, _P, _P),
    "rca_seg_down_step_shard": (_P, _P, _F, _I, _P, _P, _P, _I, _P, _I, _I,
                                _I, _P, _P),
    "rca_seg_contrast_step_shard": (_P, _P, _F, _I, _I, _P, _P, _P, _I, _P,
                                    _I, _I, _I, _P, _P),
    "rca_seg_up_steps": (_P, _F, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P),
    "rca_seg_down_steps": (_P, _P, _F, _I, _P, _P, _P, _I, _I, _I, _I, _P,
                           _P),
    "rca_seg_steps_smem": (_I, _I, _I, _P, _P),
    "rca_seg_up_steps_grid": (_P, _F, _I, _P, _P, _P, _I, _I, _I, _I, _I,
                              _P, _P, _I, _I, _P),
    "rca_seg_down_steps_grid": (_P, _P, _F, _I, _P, _P, _P, _I, _I, _I, _I,
                                _I, _P, _P, _I, _I, _P),
    "rca_seg_steps_grid_cap": (_I, _P),
    "rca_seg_up_steps_shard": (_P, _F, _I, _P, _P, _P, _I, _I, _I, _I, _P,
                               _P, _I, _I, _P),
    "rca_seg_down_steps_shard": (_P, _P, _F, _I, _P, _P, _P, _I, _I, _I, _P,
                                 _P, _I, _I, _P, _P, _I, _I, _P),
    "rca_seg_steps_shard_cap": (_P,),
    "rca_seg_up_steps_peer": (_P, _F, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _I, _P, _P, _Q, _U, _I, _Q, _P, _I, _I, _P),
    "rca_seg_down_steps_peer": (_P, _P, _F, _I, _P, _P, _P, _I, _I, _I, _I,
                                _I, _I, _I, _P, _P, _P, _Q, _U, _I, _Q, _P,
                                _P, _I, _I, _P),
    "rca_seg_steps_peer_cap": (_I, _P),
}


def sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under ``CUDA_HOME`` or ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (env_raw("CUDA_HOME"), "/usr/local/cuda"):
        if home and Path(home, "bin", "nvcc").is_file():
            return str(Path(home, "bin", "nvcc"))
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the port's "
        "CUDA kernels cannot be built on this host"
    )


def _library_path() -> Path:
    h = hashlib.sha1(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    # the sources and the headers they include
    for src in sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librca_kernels-{h.hexdigest()[:16]}.so"


def _start(what: str, cmd) -> WorkerProc:
    """One ``nvcc`` started, its output drained by the procs seam."""
    return spawn_worker(f"nvcc-{what}", cmd)


def _finish(procs, verbose: bool) -> None:
    """Wait for every ``(what, process)``, then raise on the first that
    failed."""
    done = [(what, *proc.communicate()) for what, proc in procs]
    for what, code, out, err in done:
        output = out + err
        if code != 0:
            raise RuntimeError(f"nvcc failed on {what} ({code}):\n{output}")
        if verbose:
            print(output, end="")


def build(verbose: bool = False) -> Path:
    """Compile every ``csrc/*.cu`` into the hashed library (once): one
    ``nvcc`` per source, all started together, then one link."""
    global BUILD_SECONDS
    out = _library_path()
    if out.exists():
        BUILD_SECONDS = 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = find_nvcc()
    ptxas = ["-Xptxas", "-v"] if verbose else []
    # build in a private directory, then rename: a concurrent or cut build
    # never leaves a half-written library under the final name
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = [str(Path(tmp, src.stem + ".o")) for src in sources()]
        _finish([(src.name, _start(src.stem, [
            nvcc, *ARCH_FLAGS, *NVCC_FLAGS, *ptxas, "-c", "-o", obj,
            str(src)])) for src, obj in zip(sources(), objects)], verbose)
        lib = str(Path(tmp, out.name))
        _finish([("the link", _start("link", [
            nvcc, *ARCH_FLAGS, "-shared", "-o", lib, *objects]))], verbose)
        os.replace(lib, out)
    BUILD_SECONDS = time.perf_counter() - t0
    note_compile("kernel library", out.name)
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
