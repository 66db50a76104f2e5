"""Multi-process bootstrap: one call before any cross-process collective
(the port's ``rca_tpu.parallel.distributed``, on ``torch.distributed``).

The reference brings up ``jax.distributed``; the port brings up a
``torch.distributed`` process group instead.  Every process runs the same
program and calls :func:`initialize_distributed` once; the rest of
:mod:`rca_tpu_torch.parallel` stays one-process mesh code.

Usage, one process per card (``torchrun`` sets the environment)::

    from rca_tpu_torch.parallel import initialize_distributed
    info = initialize_distributed()      # reads MASTER_ADDR/PORT, RANK...

or with the coordinator named explicitly::

    info = initialize_distributed("10.0.0.1:29500", num_processes=4,
                                  process_id=rank)

Coordinator, world size and rank come from the arguments, else from
torchrun's ``MASTER_ADDR`` + ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``
(``init_method="env://"``).  The backend is NCCL when each rank has a card
of its own and gloo for ``device="cpu"``.  A rank's card is ``LOCAL_RANK``
(torchrun sets it), else ``rank % torch.cuda.device_count()``, which fits
hosts filled with one rank a card in rank order.  A ``LOCAL_RANK`` with no
card of its own raises: NCCL refuses two ranks on one card ("Duplicate GPU
detected"), and the bootstrap never moves a CUDA run to gloo behind the
caller's back.  Without ``LOCAL_RANK`` two ranks can only meet on one card
when more ranks share a host than it has cards; NCCL then raises its own
"Duplicate GPU detected" at the first collective.  Single-process runs are
a strict no-op, which never initialises CUDA either.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from rca_tpu_torch.config import env_int_opt, env_raw

_initialized = False


def _coordinator_from_env() -> Optional[str]:
    addr, port = env_raw("MASTER_ADDR"), env_raw("MASTER_PORT")
    if addr and port:
        return f"{addr}:{port}"
    return None


def pick_backend(device=None, local_rank: Optional[int] = 0) -> str:
    """``gloo`` for ``device="cpu"``, ``nccl`` for a rank with a card of
    its own; raises, naming the cause, for a CUDA rank without one.
    ``local_rank`` None (no ``LOCAL_RANK``: the card is the rank modulo
    the visible cards) only needs a card to exist."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return "gloo"
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "initialize_distributed: NCCL needs a CUDA device and none is "
            "available; pass device='cpu' for a gloo process group"
        )
    cards = torch.cuda.device_count()
    if local_rank is not None and local_rank >= cards:
        raise RuntimeError(
            f"initialize_distributed: local rank {local_rank} has no card "
            f"of its own ({cards} visible): NCCL refuses two ranks on one "
            f"GPU (\"Duplicate GPU detected\"); run one rank per card, or "
            f"pass device='cpu' for gloo"
        )
    return "nccl"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> Dict[str, Any]:
    """Idempotently bring up the process group and report the topology.

    Returns ``{initialized, process_index, process_count,
    local_device_count, global_device_count}``: ``initialized`` is False
    when the run is single-process and no coordinator was named (nothing
    to do), True when the group is (or already was) up, whoever brought
    it up.  ``local_device_count`` is the devices this process drives
    (one card an NCCL rank, the CPU a gloo rank); ``global_device_count``
    assumes every rank drives as many."""
    global _initialized
    import torch
    import torch.distributed as dist

    named = coordinator_address is not None
    coordinator_address = coordinator_address or _coordinator_from_env()
    if num_processes is None:
        num_processes = env_int_opt("WORLD_SIZE", 1, 2**31 - 1)
    if process_id is None:
        process_id = env_int_opt("RANK", 0, 2**31 - 1)
    local_rank = env_int_opt("LOCAL_RANK", 0, 2**31 - 1)

    # a group someone else already brought up is recognised, so a second
    # bootstrap (ours or theirs) never re-initialises and raises
    _initialized = _initialized or (dist.is_available()
                                    and dist.is_initialized())

    if not _initialized and coordinator_address is not None:
        backend = pick_backend(device, local_rank)
        if backend == "nccl":
            torch.cuda.set_device(
                local_rank if local_rank is not None
                else (process_id or 0) % torch.cuda.device_count())
        dist.init_process_group(
            backend,
            init_method=(f"tcp://{coordinator_address}" if named
                         else "env://"),
            world_size=int(num_processes if num_processes is not None
                           else 1),
            rank=int(process_id or 0),
        )
        _initialized = True

    if not _initialized:
        # STRICT no-op: counting cards here must not initialise CUDA in a
        # process that never touched the card (an ingest worker, the
        # gateway); the counts are filled only when CUDA is already up
        cuda_up = torch.cuda.is_initialized()
        count = torch.cuda.device_count() if cuda_up else None
        return {
            "initialized": False,
            "process_index": 0,
            "process_count": 1,
            "local_device_count": count,
            "global_device_count": count,
        }

    world = dist.get_world_size()
    local = 1
    return {
        "initialized": True,
        "process_index": dist.get_rank(),
        "process_count": world,
        "local_device_count": local,
        "global_device_count": local * world,
    }


def shutdown_distributed() -> None:
    """Destroy the process group this module (or anyone) brought up, so a
    later bootstrap in the same process starts fresh."""
    global _initialized
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False
