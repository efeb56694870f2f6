"""Starting ``torch.distributed`` for a mesh of processes.

Counterpart of ``triton_client_tpu/parallel/multihost.py``, with its
semantics: the arguments fall back to ``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID`` (the reference's names, kept
so that one launcher starts either package), nothing set means not
distributed, a second call is a no-op once a group is active, and a group
that someone else started counts as active.

The process group meets over a TCP store at the coordinator's
``host:port``.  Its backend follows a rule, never a caught failure: NCCL
where every local rank has a card of its own, gloo otherwise (on the CPU,
or several ranks sharing one card).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def backend_for(local_ranks: int) -> str:
    """NCCL where each of ``local_ranks`` processes on this host has a card
    of its own, gloo otherwise."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= local_ranks:
        return "nccl"
    return "gloo"


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Start the default process group if a coordinator is given (or set
    in the environment); True when distributed mode was or already is
    active, False when nothing asks for it.

    The local rank count, for the backend rule, is ``LOCAL_WORLD_SIZE``
    where a launcher sets it, else every process on one host."""
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None:
        return False
    if num_processes is None or process_id is None:
        raise ValueError(
            "initialize_multihost needs num_processes and process_id (or "
            "JAX_NUM_PROCESSES and JAX_PROCESS_ID) beside the coordinator "
            f"address {coordinator_address!r}")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    dist.init_process_group(
        backend_for(local), init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id))
    return True
