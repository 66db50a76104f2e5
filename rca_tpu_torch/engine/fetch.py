"""The port's one device→host seam: every transfer of a result from the
device to the host on the analyze, tick and serve paths goes through
:func:`device_get` or :class:`HostCopy` (the port's counterpart of the
JAX package's ``jax.device_get`` calls).

- :func:`device_get` copies synchronously and returns numpy arrays: the
  call ends when the bytes are on the host;
- :class:`HostCopy` starts the copies without a host sync (pinned buffers,
  non-blocking, one event) and syncs once, in :meth:`HostCopy.numpy`, so a
  dispatch can start its copies and a later fetch wait for them.

One seam means one place to audit and to instrument: the ``tick-sync`` and
``resident-fetch`` rules (:mod:`rca_tpu_torch.analysis.rules`) fence where
these entries may be called, and both entries hand their tensors, before
any copy starts, to the tap (:func:`set_tap`), where specsan
(:mod:`rca_tpu_torch.analysis.dataplane.specsan`) judges each transfer
against the byte budgets of
:mod:`rca_tpu_torch.analysis.dataplane.contracts`.  The tap sits inside
the entries because their callers bind them at import, where replacing a
module attribute would not reach.  On the CPU both entries are visible
too, and copy nothing: a CPU tensor's array shares its memory.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

#: called with each transfer's tensors before its copy starts, or None
_TAP: Optional[Callable[[Sequence[torch.Tensor]], None]] = None


def set_tap(observer: Optional[Callable[[Sequence[torch.Tensor]], None]]):
    """Install ``observer`` on both entries (None removes it); returns the
    observer it replaces, for the caller to restore."""
    global _TAP
    previous, _TAP = _TAP, observer
    return previous


def device_get(*tensors: torch.Tensor):
    """Synchronous host copies of ``tensors`` as numpy arrays: the array
    for one tensor, a tuple of them for several (``jax.device_get`` of a
    leaf or of a tuple)."""
    if _TAP is not None:
        _TAP(tensors)
    out = tuple(t.cpu().numpy() for t in tensors)
    return out[0] if len(out) == 1 else out


class HostCopy:
    """Device→host copies started without a host sync: each tensor goes
    into a pinned host buffer of its own (non-blocking, on the current
    stream) and an event is recorded after them; :meth:`numpy` waits on
    that event, the one sync, and returns the arrays.  CPU tensors are
    their own host copies (``ready`` is None)."""

    def __init__(self, *tensors: torch.Tensor):
        if _TAP is not None:
            _TAP(tensors)
        self.ready = None
        if tensors[0].device.type != "cuda":
            self.tensors = tensors
            return
        with torch.cuda.device(tensors[0].device):
            self.tensors = tuple(
                torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(
                    t, non_blocking=True)
                for t in tensors)
            self.ready = torch.cuda.Event()
            self.ready.record()

    def numpy(self):
        if self.ready is not None:
            self.ready.synchronize()
        return tuple(t.numpy() for t in self.tensors)
