"""The node-sharded engine's collectives over the ``sp`` axis, in one
process.

Counterpart of ``jax.lax.all_gather(..., tiled=True)`` and
``jax.lax.psum_scatter(..., tiled=True)`` inside the reference's
``shard_map`` (``rca_tpu/parallel/sharded.py``).  A shard's value is one
tensor on its own device; a collective takes the ``sp`` shards' tensors
(in shard order) and returns each shard's result on that shard's device:

- :func:`all_gather`: every shard gets the concatenation of the shards'
  blocks along the last axis;
- :func:`psum_scatter`: shard ``k`` gets block ``k`` of the sum of the
  shards' full-length vectors, summed in the FIXED shard order
  ``0..sp-1`` (no float sum depends on the order of atomics or of
  arrival, so two runs give the same bits).

There is one code path whether the shards' devices are distinct or
repeated: ``Tensor.to(dev)`` is a no-op on the same device.  Between two
CUDA devices it is a peer copy that PyTorch orders after the producer on
the source device's current stream and before the consumer on the
destination's, with no host sync.  Shards on one device share what they
would each compute alike: an all-gather concatenates once per device
(the shards there get the same tensor, which they only read), and a
reduce-scatter sums each run of consecutive shards on one device over
their joined span once, element by element in the same order, so the
bits do not depend on the placement.

Each call adds the bytes it moves between distinct shards to
:data:`COLLECTIVE_BYTES` (and one to :data:`COLLECTIVE_CALLS`) under its
kind.  For ``sp`` shards of ``block`` float32 entries per lane these are
the reference's comm-volume budget: an all-gather brings each shard the
other ``sp - 1`` blocks, ``(sp - 1) * block * 4`` bytes; a reduce-scatter
sends each shard's ``sp - 1`` foreign blocks to their owners, ``(sp - 1)
/ sp * n_pad * 4`` bytes through each shard.  The top-k merge's
candidate gather counts apart (``topk_gather``).  The recursions over
distinct cards exchange their blocks inside their kernels
(``engine/segscan.py::launch_peer``); what those move between the cards
counts under the same kinds (:func:`count_moved`), with no call.
"""

from __future__ import annotations

import itertools
from typing import List, Sequence

import torch

COLLECTIVE_BYTES = {"all_gather": 0, "reduce_scatter": 0, "topk_gather": 0}
COLLECTIVE_CALLS = {"all_gather": 0, "reduce_scatter": 0, "topk_gather": 0}


def reset_collectives() -> None:
    for counts in (COLLECTIVE_BYTES, COLLECTIVE_CALLS):
        for kind in counts:
            counts[kind] = 0


def _count(kind: str, n_bytes: int) -> None:
    count_moved(kind, n_bytes)
    COLLECTIVE_CALLS[kind] += 1


def count_moved(kind: str, n_bytes: int) -> None:
    """``n_bytes`` moved between shards under ``kind``, by a kernel's stores
    into peer memory (no host call)."""
    COLLECTIVE_BYTES[kind] += int(n_bytes)


def gather_to(blocks: Sequence[torch.Tensor], device: torch.device,
              dim: int = -1, kind: str = None) -> torch.Tensor:
    """The shards' blocks concatenated along ``dim`` on one ``device``;
    with ``kind``, counted as the ``sp - 1`` blocks that move to the
    first shard."""
    if kind is not None:
        _count(kind, (len(blocks) - 1) * blocks[0].numel()
               * blocks[0].element_size())
    return torch.cat([b.to(device) for b in blocks], dim=dim)


def all_gather(blocks: Sequence[torch.Tensor],
               devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Tiled all-gather over the last axis: shard ``k`` gets the ``sp``
    blocks concatenated on ``devices[k]``, one concatenation per distinct
    device."""
    sp = len(blocks)
    _count("all_gather", sp * (sp - 1) * blocks[0].numel()
           * blocks[0].element_size())
    joined = {}
    for dev in devices:
        if dev not in joined:
            joined[dev] = gather_to(blocks, dev)
    return [joined[dev] for dev in devices]


def psum_scatter(fulls: Sequence[torch.Tensor],
                 devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Tiled reduce-scatter over the last axis: shard ``k`` gets block
    ``k`` of ``fulls[0] + fulls[1] + ... + fulls[sp-1]``, added in that
    order on ``devices[k]``."""
    sp = len(fulls)
    n = fulls[0].shape[-1]
    if n % sp:
        raise ValueError(f"psum_scatter: length {n} does not split into "
                         f"{sp} blocks")
    block = n // sp
    _count("reduce_scatter", sp * (sp - 1) * (fulls[0].numel() // sp)
           * fulls[0].element_size())
    out = []
    for dev, run in itertools.groupby(range(sp), key=lambda k: devices[k]):
        run = list(run)
        lo, hi = run[0] * block, (run[-1] + 1) * block
        acc = fulls[0][..., lo:hi].to(dev, copy=True)
        for j in range(1, sp):
            acc += fulls[j][..., lo:hi].to(dev)
        out.extend(acc[..., i * block:(i + 1) * block]
                   for i in range(len(run)))
    return out
