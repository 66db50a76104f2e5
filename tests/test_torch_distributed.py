"""The port's multi-process bootstrap (``rca_tpu_torch.parallel.
distributed``, on ``torch.distributed``) and ``make_multislice_mesh``
against the JAX package's.

- with no coordinator the bootstrap is a strict no-op that returns the
  reference's dict and does not initialise CUDA;
- two processes bring up a gloo group on the CPU, one named through the
  arguments and one through torchrun's environment, both report
  ``process_count`` 2, an all-reduce crosses them, a second call is
  idempotent;
- the backend choice: gloo for the CPU, a CUDA rank without a card of
  its own raises naming the cause (NCCL's "Duplicate GPU detected"),
  never a silent fall back to gloo; without ``LOCAL_RANK`` a rank takes
  its card modulo the visible cards;
- ``make_multislice_mesh`` lays out the reference's grid on 8 logical
  devices, groups by ``slice_index`` when devices carry one, and refuses
  a short device list with the reference's message.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rca_tpu_torch.parallel import distributed
from rca_tpu_torch.parallel.distributed import (
    initialize_distributed,
    pick_backend,
)
from rca_tpu_torch.parallel.mesh import make_multislice_mesh

ROOT = Path(__file__).resolve().parent.parent

_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                 "LOCAL_RANK")


@pytest.fixture
def no_torchrun_env(monkeypatch):
    for name in _TORCHRUN_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(distributed, "_initialized", False)


def test_noop_returns_the_references_dict_without_cuda(no_torchrun_env):
    from rca_tpu.parallel.distributed import initialize_distributed as ref

    got = initialize_distributed()
    want = ref()
    assert set(got) == set(want)
    assert {k: got[k] for k in ("initialized", "process_index",
                                "process_count")} == {
        "initialized": False, "process_index": 0, "process_count": 1}
    assert {k: want[k] for k in ("initialized", "process_index",
                                 "process_count")} == {
        "initialized": False, "process_index": 0, "process_count": 1}
    assert not torch.cuda.is_initialized()
    assert got["local_device_count"] is None
    assert got["global_device_count"] is None
    assert initialize_distributed() == got       # idempotent


_RANK = """
import json, os, sys
import torch
import torch.distributed as dist
from rca_tpu_torch.parallel.distributed import (initialize_distributed,
                                                shutdown_distributed)
rank = int(sys.argv[1])
if rank == 0:
    info = initialize_distributed(sys.argv[2], num_processes=2,
                                  process_id=0, device="cpu")
else:
    info = initialize_distributed(device="cpu")   # torchrun's environment
again = initialize_distributed(device="cpu")
t = torch.tensor([float(rank + 1)])
dist.all_reduce(t)
backend = dist.get_backend()
shutdown_distributed()
print(json.dumps({"info": info, "again": again, "sum": float(t.item()),
                  "backend": backend, "up": dist.is_initialized(),
                  "cuda": torch.cuda.is_initialized()}))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_group_reports_process_count_2():
    port = _free_port()
    base = {k: v for k, v in os.environ.items() if k not in _TORCHRUN_ENV}
    envs = [base, {**base, "MASTER_ADDR": "127.0.0.1",
                   "MASTER_PORT": str(port), "WORLD_SIZE": "2",
                   "RANK": "1", "LOCAL_RANK": "1"}]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(rank), f"127.0.0.1:{port}"],
        cwd=str(ROOT), env=envs[rank], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in (0, 1)]
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=240)
            assert proc.returncode == 0, err[-2000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    for rank, out in enumerate(outs):
        assert out["info"] == {
            "initialized": True, "process_index": rank, "process_count": 2,
            "local_device_count": 1, "global_device_count": 2}
        assert out["again"] == out["info"]
        assert out["sum"] == 3.0
        assert out["backend"] == "gloo"
        assert not out["up"] and not out["cuda"]


def test_backend_choice_names_the_cause(monkeypatch):
    assert pick_backend("cpu") == "gloo"
    assert pick_backend(torch.device("cpu"), local_rank=5) == "gloo"
    with pytest.raises(ValueError, match="unsupported"):
        pick_backend("meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        pick_backend()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert pick_backend("cuda", local_rank=0) == "nccl"
    assert pick_backend("cuda", local_rank=None) == "nccl"
    with pytest.raises(RuntimeError, match="Duplicate GPU detected"):
        pick_backend("cuda", local_rank=1)


def test_a_cuda_rank_without_a_card_never_falls_back_to_gloo(
        monkeypatch, no_torchrun_env):
    called = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **k: called.append((a, k)))
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="two ranks on one"):
        initialize_distributed("127.0.0.1:1", num_processes=2, process_id=1)
    assert called == []


def test_without_local_rank_a_rank_takes_its_card_modulo_the_cards(
        monkeypatch, no_torchrun_env):
    """A named coordinator, rank 1, one visible card and no LOCAL_RANK
    (one rank on each of several one-card hosts): rank 1 drives card 0
    of its own host over NCCL."""
    cards, calls = [], []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", cards.append)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 4)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 1)
    info = initialize_distributed("10.0.0.1:29500", num_processes=4,
                                  process_id=1)
    assert cards == [0]
    assert [(a, k["rank"], k["world_size"], k["init_method"])
            for a, k in calls] == [
        (("nccl",), 1, 4, "tcp://10.0.0.1:29500")]
    assert info == {"initialized": True, "process_index": 1,
                    "process_count": 4, "local_device_count": 1,
                    "global_device_count": 4}


def _ids(grid):
    return np.vectorize(lambda d: d.id if hasattr(d, "id") else d.index,
                        otypes=[int])(grid)


@pytest.mark.parametrize("n_slices,axes", [
    (2, [("dp", 2), ("sp", 2)]), (4, [("sp", 2)]), (1, [("dp", 2),
                                                        ("sp", 4)]),
    (2, [("sp", 3)]),
])
def test_multislice_mesh_lays_out_the_references_grid(n_slices, axes):
    import jax

    from rca_tpu.parallel.mesh import make_multislice_mesh as ref_mesh

    jdevs = jax.devices()
    assert len(jdevs) == 8
    want = ref_mesh(n_slices, axes)
    got = make_multislice_mesh(
        n_slices, axes, [torch.device("cuda", d.id) for d in jdevs])
    assert got.axis_names == tuple(want.axis_names)
    assert got.devices.shape == want.devices.shape
    assert np.array_equal(_ids(got.devices), _ids(want.devices))


def test_multislice_mesh_refuses_too_few_devices_like_the_reference():
    import jax

    from rca_tpu.parallel.mesh import make_multislice_mesh as ref_mesh

    with pytest.raises(ValueError) as theirs:
        ref_mesh(3, [("sp", 4)], jax.devices())
    with pytest.raises(ValueError) as mine:
        make_multislice_mesh(3, [("sp", 4)],
                             [torch.device("cpu")] * 8)
    assert str(mine.value) == str(theirs.value)


class _SliceDevice:
    def __init__(self, index, slice_index):
        self.index = index
        self.slice_index = slice_index


def test_multislice_mesh_groups_by_slice_index():
    # interleaved slices: each row of the grid is one slice
    devs = [_SliceDevice(i, s) for i, s in enumerate([1, 0, 1, 0, 2, 2])]
    mesh = make_multislice_mesh(2, [("sp", 2)], devs)
    assert mesh.axis_names == ("slice", "sp")
    assert [[d.index for d in row] for row in mesh.devices] == [
        [1, 3], [0, 2]]
    plain = make_multislice_mesh(
        2, [("sp", 2)], [torch.device("cuda", i) for i in range(4)])
    assert [[d.index for d in row] for row in plain.devices] == [
        [0, 1], [2, 3]]
