"""Parallelism primitives of the port, on ``torch.distributed``.

- :mod:`.mesh`: :func:`factorize_mesh` and :func:`build_mesh`, one rank's
  view of a named-axis process mesh.
- :mod:`.collectives`: differentiable ``psum`` and ``ppermute`` over mesh
  axes, ring attention (one shard, or K/V round the ``sp`` ring), and the
  replicated-gradient sync.
- :mod:`.multihost`: starting the process group from a coordinator
  address.

The transformer (``models/transformer.py``) composes them into its 5-axis
(dp, pp, ep, sp, tp) training step.
"""

from .collectives import (all_gather, all_reduce, ppermute, psum,
                          replicated_axes, ring_attention,
                          sync_replicated_grads)
from .mesh import Mesh, build_mesh, factorize_mesh
from .multihost import backend_for, initialize_multihost

__all__ = [
    "Mesh",
    "all_gather",
    "all_reduce",
    "backend_for",
    "build_mesh",
    "factorize_mesh",
    "initialize_multihost",
    "ppermute",
    "psum",
    "replicated_axes",
    "ring_attention",
    "sync_replicated_grads",
]
