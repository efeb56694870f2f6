"""Process-local registry of CUDA shared-memory regions, by uuid.

Counterpart of ``triton_client_tpu/_xla_broker.py``.  There a region is a
rebindable slot holding the current immutable ``jax.Array``, because PjRt
can neither mutate a buffer nor import one from another process.  On a CUDA
card a region is one fixed device allocation: the client writes into it,
the server reads and writes the same bytes, and another process maps it
with ``cudaIpcOpenMemHandle``.

What stays process-local is the in-process path: ``cudaIpcOpenMemHandle``
refuses a handle made in the same process, so a server co-located with its
client finds the client's region here by the uuid its raw handle carries,
and shares the tensor.

Tiny and dependency-free, like the reference: both
``utils.cuda_shared_memory`` (client half) and ``server.shm`` (server half)
import it without importing each other.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional


class RegionEntry:
    """One live region of this process: its ``torch.uint8`` tensor of
    ``byte_size`` bytes on ``cuda:{device_id}`` (or on the CPU)."""

    def __init__(self, uuid: str, byte_size: int, device_id: int,
                 tensor: Any):
        self.uuid = uuid
        self.byte_size = byte_size
        self.device_id = device_id
        self.tensor = tensor


class CudaBroker:
    def __init__(self):
        self._regions: Dict[str, RegionEntry] = {}
        self._lock = threading.Lock()
        # Set by an in-process server (ServerHarness) while it serves, so a
        # client can tell that its regions are read in place by uuid.
        self.server_present = False

    def add(self, entry: RegionEntry) -> None:
        with self._lock:
            self._regions[entry.uuid] = entry

    def lookup(self, uuid: str) -> Optional[RegionEntry]:
        with self._lock:
            return self._regions.get(uuid)

    def drop(self, uuid: str) -> None:
        with self._lock:
            self._regions.pop(uuid, None)


_broker = CudaBroker()


def broker() -> CudaBroker:
    return _broker
