"""A device mesh in one process: named axes over an explicit device list.

Counterpart of the JAX package's ``parallel/mesh.py::make_mesh``.  The
reference is single-controller: one Python process drives every device of
its mesh through ``shard_map``.  The port keeps that shape: a
:class:`DeviceMesh` is a grid of ``torch.device`` s with named axes, and
the sharded engine runs each shard's work on its own device from one
process.

A device list may REPEAT a device: several logical shards then share one
card (or the CPU), each with its own partition, layouts and launches.
That is the port's counterpart of the reference's
``--xla_force_host_platform_device_count`` virtual devices, used by the
tests and ``chip_smoke.py`` through an explicit mesh; ``RCA_SHARD`` still
counts only the devices that are really there
(:mod:`rca_tpu_torch.engine.sharded_runner`).  The serve pool carves its
replicas' device groups with :func:`carve_device_groups`, which wraps
around the same way when the replica set asks for more devices than are
there.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def visible_devices(device=None) -> List[torch.device]:
    """The devices a mesh may span when the caller names none: every CUDA
    device (none without a card), or the one CPU for ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return [torch.device("cpu")]
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class DeviceMesh:
    """A grid of devices with named axes, ``sp`` innermost by convention
    (node shards of one replica sit next to each other)."""

    def __init__(self, grid: np.ndarray, axis_names: Tuple[str, ...]):
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, grid.shape))

    def row(self, index: int) -> List[torch.device]:
        """The ``sp`` devices of one ``dp`` index (one replica's shards)."""
        return list(self.devices.reshape(-1, self.shape["sp"])[index])

    @property
    def flat(self) -> List[torch.device]:
        return list(self.devices.reshape(-1))

    def sub_mesh(self) -> "DeviceMesh":
        """The ``dp = 1`` mesh over the first ``sp`` devices: where a
        single analysis runs (the reference's ``_exec_mesh``)."""
        if self.shape.get("dp", 1) == 1:
            return self
        return make_mesh([("dp", 1), ("sp", self.shape["sp"])], self.row(0))



def make_mesh(axis_sizes: Sequence[Tuple[str, int]],
              devices: Optional[Sequence] = None) -> DeviceMesh:
    """Build a mesh from (axis, size) pairs, e.g. ``[("dp", 2), ("sp",
    4)]``, over the first ``prod(sizes)`` entries of ``devices`` (default:
    the visible CUDA devices).  Axis order follows the argument order."""
    devices = [torch.device(d) for d in (
        devices if devices is not None else visible_devices())]
    names = tuple(a for a, _ in axis_sizes)
    sizes = tuple(int(s) for _, s in axis_sizes)
    total = int(np.prod(sizes))
    if total > len(devices):
        raise ValueError(
            f"mesh needs {total} devices for axes {axis_sizes}, "
            f"have {len(devices)}"
        )
    grid = np.empty(total, dtype=object)
    for i, d in enumerate(devices[:total]):
        grid[i] = d
    return DeviceMesh(grid.reshape(sizes), names)


def carve_device_groups(sizes: Sequence[int], devices: Sequence) -> list:
    """Contiguous device groups for a serve-pool replica set: ``sizes[i]``
    devices go to replica ``i``, carved in order so a sharded replica's
    group stays adjacent.  When the host has fewer devices than the
    replica set asks for, groups WRAP AROUND and share devices (replicas
    then oversubscribe the hardware, as logical shards do; the pool's
    occupancy metrics show the sharing) instead of refusing to start."""
    devices = list(devices)
    if not devices:
        raise ValueError("carve_device_groups: no devices visible")
    groups = []
    cursor = 0
    for size in sizes:
        size = max(1, int(size))
        groups.append(
            [devices[(cursor + j) % len(devices)] for j in range(size)]
        )
        cursor = (cursor + size) % len(devices)
    return groups


def make_multislice_mesh(
    n_slices: int,
    per_slice_axes: Sequence[Tuple[str, int]],
    devices: Optional[Sequence] = None,
    slice_axis: str = "slice",
) -> DeviceMesh:
    """Multi-slice mesh: an outer axis over groups of devices, each group
    laid out with ``per_slice_axes`` (the reference's cross-slice axis).
    Devices that carry a ``slice_index`` are grouped by it (the first
    ``n_slices`` slices that can fill a group); devices without one (a
    ``torch.device`` never has it) are grouped contiguously."""
    devices = list(devices if devices is not None else visible_devices())
    per_slice = int(np.prod([s for _, s in per_slice_axes]))
    need = n_slices * per_slice
    if need > len(devices):
        raise ValueError(
            f"multislice mesh needs {need} devices "
            f"({n_slices} slices x {per_slice}), have {len(devices)}"
        )
    devices = devices[:need]
    slice_ids = {getattr(d, "slice_index", None) for d in devices}
    if None not in slice_ids and len(slice_ids) >= n_slices:
        by_slice: dict = {}
        for d in devices:
            by_slice.setdefault(d.slice_index, []).append(d)
        # every slice that can fill per_slice, then the first n_slices
        # of them (an undersized early slice must not abandon the
        # slice-aware grouping when later slices qualify)
        groups = [
            group[:per_slice]
            for _, group in sorted(by_slice.items())
            if len(group) >= per_slice
        ][:n_slices]
        if len(groups) == n_slices:
            devices = [d for group in groups for d in group]
    sizes = (n_slices, *(int(s) for _, s in per_slice_axes))
    names = (slice_axis, *(a for a, _ in per_slice_axes))
    grid = np.empty(need, dtype=object)
    for i, d in enumerate(devices):
        grid[i] = (d if isinstance(d, torch.device)
                   or hasattr(d, "slice_index") else torch.device(d))
    return DeviceMesh(grid.reshape(sizes), names)
