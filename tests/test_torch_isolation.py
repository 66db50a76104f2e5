"""The PyTorch port stands alone: no JAX, no ``rca_tpu``, no silent CPU.

- a port analysis in a fresh interpreter loads neither ``jax`` nor any
  module of the ``rca_tpu`` package (``rca_tpu_torch`` shares its prefix,
  so names are compared exactly);
- no source file of the port, nor ``chip_smoke.py``, imports either;
- without a CUDA device the engine raises unless the caller asks for the
  CPU, and ``chip_smoke.py`` exits non-zero with no verdict line;
- on a card (tests marked ``cuda``) the engine runs through the kernels
  and agrees with its own CPU run.
"""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "rca_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return name in ("jax", "rca_tpu") or name.startswith(("jax.", "rca_tpu."))


_PROBE = """
import json, sys
from rca_tpu_torch import GraphEngine
from rca_tpu_torch.cluster.generator import synthetic_cascade_arrays
res = GraphEngine(device="cpu").analyze_case(
    synthetic_cascade_arrays(200, n_roots=2, seed=1))
print(json.dumps({"top": res.top_components(), "modules": sorted(sys.modules)}))
"""


def test_port_analysis_loads_no_jax_and_no_rca_tpu():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=str(ROOT), capture_output=True,
        text=True, timeout=180,
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(out["top"]) == 5
    assert "rca_tpu_torch" in out["modules"]
    assert [m for m in out["modules"] if _forbidden(m)] == []


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_no_jax_and_no_rca_tpu(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, node.lineno)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card rule does not "
                    "apply")


def test_engine_without_device_raises_on_a_host_without_cuda(no_cuda):
    from rca_tpu_torch import GraphEngine
    from rca_tpu_torch.entry import entry

    with pytest.raises(RuntimeError, match="CUDA"):
        GraphEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        GraphEngine(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()


def test_engine_rejects_an_unsupported_device():
    from rca_tpu_torch import GraphEngine

    with pytest.raises(ValueError):
        GraphEngine(device="meta")


def test_entry_on_cpu_matches_the_engine():
    from rca_tpu_torch import GraphEngine
    from rca_tpu_torch.cluster.generator import synthetic_cascade_arrays
    from rca_tpu_torch.entry import entry

    fn, args = entry(device="cpu")
    assert [tuple(a.shape) for a in args] == [(2048, 13), (4096,), (4096,)]
    case = synthetic_cascade_arrays(2047, n_roots=3, seed=0)
    res = GraphEngine(device="cpu").analyze_case(case)
    score = fn(*args)
    assert np.array_equal(score[:2047].numpy(), res.score)


def test_chip_smoke_fails_without_a_card(no_cuda):
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=str(ROOT),
        capture_output=True, text=True, timeout=180,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=180,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_kernel_build_needs_nvcc(monkeypatch):
    from rca_tpu_torch.kernels import build

    monkeypatch.delenv("CUDA_HOME", raising=False)
    sources = [p.name for p in build.sources()]
    assert sources == ["evidence.cu", "segscan.cu", "segstep.cu"]
    assert build.BUILD_DIR.name == "_build"
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc is present: the missing-compiler error does not "
                    "apply")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.find_nvcc()


@pytest.mark.cuda
def test_engine_on_card_runs_the_kernels_and_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: python3 chip_smoke.py runs this path "
                    "on the card")
    from rca_tpu_torch import GraphEngine
    from rca_tpu_torch.cluster.generator import synthetic_cascade_arrays
    from rca_tpu_torch.kernels import LAUNCHES, reset_launches

    case = synthetic_cascade_arrays(2047, n_roots=3, seed=0)
    reset_launches()
    got = GraphEngine().analyze_case(case)
    assert LAUNCHES == {"noisy_or_pair": 0, "segscan_sum": 0,
                        "segscan_max": 0, "seg_up_step": 8,
                        "seg_down_step": 8, "evidence_front": 1,
                        "seg_contrast_step": 1}
    ref = GraphEngine(device="cpu").analyze_case(case)
    assert got.top_components() == ref.top_components()
    assert np.array_equal(got.upstream, ref.upstream)
    np.testing.assert_allclose(got.score, ref.score, rtol=1e-5, atol=1e-6)
