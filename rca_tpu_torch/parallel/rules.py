"""Declarative partition rules: ONE table names how every graph tensor
shards over the mesh.

Counterpart of the JAX package's ``parallel/rules.py``.  :data:`GRAPH_RULES`
maps tensor NAMES (regex) to partition specs, tuples with one entry per
array axis: a mesh axis name (the array axis splits into that many equal
pieces), ``None`` (kept whole) or :data:`BATCH` (the caller's batch axes).
:func:`match_partition_rules` resolves a set of names against the table,
failing loudly on a name no rule matches, and :func:`make_shard_fns`
turns the specs into per-name staging functions for one
:class:`rca_tpu_torch.parallel.mesh.DeviceMesh`: a shard function puts
each device's piece of a host array on that device (a grid of tensors
shaped like the mesh).  The reference's ``make_shard_and_gather_fns``
also returns gather functions; nothing in the port joins pieces back on
the host that way, so they are not ported.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, Sequence, Tuple

import numpy as np
import torch

#: placeholder axis name: substituted with the caller's batch axes when a
#: rule is resolved
BATCH = "__batch__"


def resolve_batch_axes(spec: Tuple, batch_axes: Sequence[str] = ("dp",)):
    """A rule's spec with :data:`BATCH` replaced by the actual batch axis
    (the port's meshes batch over one axis, ``dp``)."""
    if len(batch_axes) != 1:
        raise ValueError(f"one batch axis, got {tuple(batch_axes)}")
    return tuple(batch_axes[0] if part == BATCH else part for part in spec)


@dataclasses.dataclass(frozen=True)
class PartitionRuleSet:
    """An ordered (regex, spec) table plus the mesh axes it talks about."""

    axes: Tuple[str, ...]
    rules: Tuple[Tuple[str, Tuple], ...]

    def spec_for(self, name: str, batch_axes: Sequence[str] = ("dp",)):
        """The first matching rule's spec for ``name`` (loud failure on no
        match: a silently replicated tensor is a bug no test catches)."""
        for pattern, parts in self.rules:
            if re.search(pattern, name) is not None:
                return resolve_batch_axes(parts, batch_axes)
        raise ValueError(
            f"no partition rule matches tensor {name!r} "
            f"(rule table axes {self.axes}); add it to GRAPH_RULES"
        )


#: the graph-propagation layout: hypothesis batches over the batch axis,
#: node blocks, per-shard edge partitions and seg layouts over 'sp',
#: weights and scalars replicated (the reference's table, with the port's
#: CSR fields of the shard layouts beside its ten)
GRAPH_RULES = PartitionRuleSet(
    axes=("dp", "sp"),
    rules=(
        (r"(^|\.)(features_batch|fb|f_loc)$", (BATCH, "sp", None)),
        (r"(^|\.)(src_local|src_global|dst_global|mask)$", ("sp", None)),
        (r"(^|\.)(dn|up)_(other|mask|flags|ends|has|offsets|seg_order)$",
         ("sp", None)),
        (r"(^|\.)(dn|up)_n_long$", ("sp",)),
        (r"(^|\.)(n_live|aw|hw|anomaly_w|hard_w)$", ()),
        (r"(^|\.)(delta_idx|delta_rows)$", ()),
        (r"(^|\.)stack$", (BATCH, None, "sp")),
        (r"(^|\.)scores$", (BATCH, "sp")),
        (r"(^|\.)topk_(vals|idx)$", (BATCH, None)),
    ),
)


def match_partition_rules(rules: PartitionRuleSet, names: Iterable[str],
                          batch_axes: Sequence[str] = ("dp",)) -> Dict:
    """Resolve ``names`` against the rule table: ``{name: spec}``."""
    return {name: rules.spec_for(name, batch_axes) for name in names}


def _piece(array: np.ndarray, spec: Tuple, mesh, coord: Dict[str, int]):
    """The piece of ``array`` that the device at mesh ``coord`` holds."""
    index = []
    for axis, part in enumerate(spec):
        if part is None:
            index.append(slice(None))
            continue
        count = mesh.shape[part]
        size = array.shape[axis]
        if size % count:
            raise ValueError(f"axis {axis} of length {size} does not split "
                             f"into {count} pieces over {part!r}")
        step = size // count
        index.append(slice(coord[part] * step, (coord[part] + 1) * step))
    return array[tuple(index)]


def make_shard_fns(partition_specs: Dict[str, Tuple], mesh):
    """Per-name shard functions for one mesh: ``shard_fns[name](array)``
    returns a grid shaped like the mesh (a nested list ``[dp][sp]``) of
    tensors, each device's piece of the host array on that device (a
    replicated array is the whole array on each)."""
    names = mesh.axis_names
    dims = [mesh.shape[a] for a in names]

    def coords():
        for flat in range(int(np.prod(dims))):
            yield dict(zip(names, np.unravel_index(flat, dims)))

    shard_fns = {}
    for name, spec in partition_specs.items():
        def shard_fn(array, _spec=spec):
            array = np.ascontiguousarray(array)
            grid = [[None] * mesh.shape["sp"] for _ in range(mesh.shape["dp"])]
            for c in coords():
                piece = np.ascontiguousarray(_piece(array, _spec, mesh, c))
                dev = mesh.devices[c["dp"], c["sp"]]
                t = torch.from_numpy(piece)
                grid[c["dp"]][c["sp"]] = (
                    t.pin_memory().to(dev, non_blocking=True)
                    if dev.type == "cuda" else t)
            return grid

        shard_fns[name] = shard_fn
    return shard_fns
