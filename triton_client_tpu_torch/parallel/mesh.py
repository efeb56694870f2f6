"""Named-axis process meshes on ``torch.distributed``.

Counterpart of ``triton_client_tpu/parallel/mesh.py``.  The reference lays
a ``jax.sharding.Mesh`` over devices and lets ``shard_map`` run one program
per device; here each mesh position is a process (a rank), and a
:class:`Mesh` holds what one rank needs to run its part: the axis names
and sizes, its own coordinate on each axis, one process group per axis
(the ranks that differ from it only on that axis) and its device.

Ranks are laid out row-major over the axes in order, as the reference
reshapes its device list: rank ``r`` sits at ``np.unravel_index(r,
sizes)``.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def factorize_mesh(
    n_devices: int,
    limits: Dict[str, int],
    axes: Sequence[str],
    priority: Optional[Sequence[str]] = None,
    remainder_axis: Optional[str] = None,
) -> Dict[str, int]:
    """Greedy power-of-two factorization of ``n_devices`` onto named axes
    (the reference's, copied).

    ``limits[ax]`` is the model dimension the axis shards: the axis size
    must divide it.  ``priority`` orders growth; each listed axis gets one
    factor of 2 before any axis deepens.  Any remainder (non-power-of-two
    factors included) lands on ``remainder_axis`` (default: the first axis
    not in ``priority``)."""
    if priority is None:
        priority = [a for a in axes if a in limits]
    if remainder_axis is None:
        spare = [a for a in axes if a not in priority]
        remainder_axis = spare[0] if spare else axes[0]
    sizes = {a: 1 for a in axes}
    rem = n_devices

    def can_grow(ax: str) -> bool:
        new = sizes[ax] * 2
        lim = limits.get(ax, 1)
        return rem % 2 == 0 and new <= lim and lim % new == 0

    for ax in priority:
        if can_grow(ax):
            sizes[ax] *= 2
            rem //= 2
    for ax in priority:
        while can_grow(ax):
            sizes[ax] *= 2
            rem //= 2
    sizes[remainder_axis] *= rem
    return sizes


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of a process mesh.

    ``shape`` maps each axis to its size, ``coords`` to this rank's index
    on it.  ``groups[ax]`` is the process group of the ranks that differ
    from this one only on ``ax`` (None where the axis has size 1), and
    ``ring[ax]`` their global ranks in order of their index on ``ax``.
    ``backend`` is the process group's backend (None for one process) and
    ``host_staging`` says that collectives copy CUDA tensors through host
    memory (gloo moves host tensors only)."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, Optional[object]]
    ring: Dict[str, Tuple[int, ...]]
    device: torch.device
    rank: int = 0
    backend: Optional[str] = None

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def host_staging(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    @property
    def transport(self) -> str:
        """How this mesh's collectives move data, for a run's report."""
        if self.backend is None:
            return "none (one process)"
        if self.host_staging:
            return f"{self.backend}, staged through host memory"
        return f"{self.backend}, {self.device.type} tensors"

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]


def _local_device(rank: int, device=None) -> torch.device:
    """The device a rank runs on: ``device`` when given, else the rank's
    card, ``cuda:<local index>`` (``LOCAL_RANK`` or the rank, modulo the
    cards present: several ranks on one card share it).  Raises when no
    card is present, rather than run on the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: a mesh runs on the rank's card; pass "
            "device='cpu' to run it on the CPU")
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def build_mesh(shape: Dict[str, int], axes: Sequence[str],
               device=None) -> Mesh:
    """This rank's :class:`Mesh` of ``shape[a]`` ranks per axis (axis order
    ``axes``).

    A mesh of one rank needs no process group.  A larger one needs
    ``torch.distributed`` started with exactly that many ranks
    (:func:`~.multihost.initialize_multihost`); every rank must call this
    with the same arguments, since each axis group is made with
    ``new_group`` on every rank in the same order."""
    axes = tuple(axes)
    sizes = [int(shape.get(a, 1)) for a in axes]
    n = math.prod(sizes)
    if n == 1:
        return Mesh(axes, dict(zip(axes, sizes)), {a: 0 for a in axes},
                    {a: None for a in axes}, {a: (0,) for a in axes},
                    _local_device(0, device))
    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh {dict(zip(axes, sizes))} spans {n} ranks: start "
            "torch.distributed first (initialize_multihost)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n:
        raise ValueError(
            f"mesh shape {dict(zip(axes, sizes))} needs exactly {n} ranks, "
            f"the process group has {world}")
    grid = np.arange(n).reshape(sizes)
    coords = dict(zip(axes, (int(c) for c in np.unravel_index(rank, sizes))))
    groups: Dict[str, Optional[object]] = {}
    ring: Dict[str, Tuple[int, ...]] = {}
    for i, ax in enumerate(axes):
        groups[ax] = None
        others = [range(s) for j, s in enumerate(sizes) if j != i]
        for rest in itertools.product(*others):
            idx = list(rest)
            idx.insert(i, slice(None))
            ranks = tuple(int(r) for r in grid[tuple(idx)])
            if rank in ranks:
                ring[ax] = ranks
            if sizes[i] == 1:
                continue
            group = dist.new_group(list(ranks))
            if rank in ranks:
                groups[ax] = group
    return Mesh(axes, dict(zip(axes, sizes)), coords, groups, ring,
                _local_device(rank, device), rank, dist.get_backend())
