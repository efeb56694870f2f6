"""CUDA shared-memory regions: the device data path, client half.

Counterpart of ``triton_client_tpu/utils/xla_shared_memory`` (and its
``cuda_shared_memory`` alias), with the original Triton client's names.  The
JAX module makes a region a rebindable slot and imports it into another
process through a host-shm staging copy, because PjRt cannot map another
process's buffer.  On a CUDA card the port does what the original client
does:

* ``create_shared_memory_region``: one ``cudaMalloc`` of ``byte_size`` bytes
  outside PyTorch's caching allocator (so its IPC handle names exactly the
  region), seen as a ``torch.uint8`` tensor of that memory.
* ``get_raw_handle``: a JSON descriptor of the region's uuid (a server in
  this process finds the region by it, in the broker), its base64
  ``cudaIpcMemHandle_t`` (a server in another process maps it with
  ``cudaIpcOpenMemHandle``, once, at register), ``device_id`` and
  ``byte_size``.  A mapping is the memory itself: no staging copy and no
  generation counter.
* ``set_shared_memory_region``: host-to-device copies at ``offset`` (the
  other bytes kept), synchronized before returning.
  ``set_shared_memory_region_from_dlpack``: one device-to-device copy (or
  host-to-device, for a host producer) of each tensor.
* ``get_contents_as_numpy``: one device-to-host copy.
  ``as_shared_memory_tensor``: a zero-copy typed view.

``device="cpu"`` makes a region of host memory, for tests on machines
without a card: its descriptor holds the uuid only, so only a server in the
same process can register it.
"""

from __future__ import annotations

import base64
import json
import threading
import uuid as _uuid
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ... import _cuda_ipc
from ..._cuda_broker import RegionEntry, broker
from .. import (deserialize_bytes_tensor, serialize_byte_tensor,
                triton_to_torch_dtype, typed_view)

__all__ = [
    "CudaSharedMemoryException",
    "CudaSharedMemoryRegion",
    "create_shared_memory_region",
    "get_raw_handle",
    "set_shared_memory_region",
    "set_shared_memory_region_from_dlpack",
    "get_contents_as_numpy",
    "as_shared_memory_tensor",
    "allocated_shared_memory_regions",
    "destroy_shared_memory_region",
]


class CudaSharedMemoryException(Exception):
    """A failed CUDA shared-memory call (the original client's exception
    of the same name)."""


_allocated: Dict[str, "CudaSharedMemoryRegion"] = {}
_alloc_lock = threading.Lock()


def _check_device(device_id: int, device: torch.device) -> None:
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to make a host "
                "region")
        count, kind = torch.cuda.device_count(), "CUDA"
    elif device.type == "cpu":
        count, kind = 1, "CPU"
    else:
        raise ValueError(f"unsupported device {device}: expected cuda or cpu")
    if not 0 <= device_id < count:
        raise CudaSharedMemoryException(
            f"unable to create shared memory region on device {device_id}: "
            f"only {count} {kind} device(s) visible")


class CudaSharedMemoryRegion:
    """One region: a device allocation freed when the region is destroyed
    or collected (the original client's ``CudaSharedMemoryRegion``)."""

    def __init__(self, triton_shm_name: str, byte_size: int, device_id: int,
                 device: torch.device):
        self._triton_shm_name = triton_shm_name
        self._byte_size = byte_size
        self._device_id = device_id
        self._uuid = _uuid.uuid4().hex
        self._closed = False
        self._ptr: Optional[int] = None
        self._ipc_handle: Optional[bytes] = None
        if device.type == "cuda":
            self._ptr = _cuda_ipc.malloc(device_id, byte_size)
            try:
                self._ipc_handle = _cuda_ipc.get_handle(device_id, self._ptr)
                tensor = _cuda_ipc.as_tensor(self._ptr, byte_size, device_id)
            except BaseException:
                self._close()
                raise
        else:
            tensor = torch.zeros(byte_size, dtype=torch.uint8)
        self._entry = RegionEntry(self._uuid, byte_size, device_id, tensor)
        broker().add(self._entry)

    @property
    def triton_shm_name(self) -> str:
        return self._triton_shm_name

    @property
    def byte_size(self) -> int:
        return self._byte_size

    @property
    def device_id(self) -> int:
        return self._device_id

    @property
    def tensor(self) -> torch.Tensor:
        """The region's bytes, a ``torch.uint8`` tensor of ``byte_size``."""
        return self._entry.tensor

    def _close(self) -> None:
        if self._closed:
            return
        self._closed = True
        broker().drop(self._uuid)
        if self._ptr is not None:
            self._entry = None
            # cudaFree waits for the device's work on the region to finish
            _cuda_ipc.free(self._device_id, self._ptr)
            self._ptr = None

    def __del__(self):
        try:
            self._close()
        except Exception:
            pass


def create_shared_memory_region(triton_shm_name: str, byte_size: int,
                                device_id: int, device=None
                                ) -> CudaSharedMemoryRegion:
    """Allocate a region of ``byte_size`` bytes on ``cuda:{device_id}``, or
    in host memory where ``device="cpu"``."""
    if byte_size <= 0:
        raise CudaSharedMemoryException("byte_size must be positive")
    dev = torch.device("cuda" if device is None else device)
    _check_device(device_id, dev)
    region = CudaSharedMemoryRegion(triton_shm_name, byte_size, device_id,
                                    dev)
    with _alloc_lock:
        _allocated[region._uuid] = region
    return region


def get_raw_handle(cuda_shm_handle: CudaSharedMemoryRegion) -> bytes:
    """The region's import descriptor, as UTF-8 JSON: ``uuid``,
    ``cuda_ipc_handle`` (base64; absent for a host region), ``device_id``
    and ``byte_size``."""
    desc = {"uuid": cuda_shm_handle._uuid,
            "device_id": cuda_shm_handle._device_id,
            "byte_size": cuda_shm_handle._byte_size}
    if cuda_shm_handle._ipc_handle is not None:
        desc["cuda_ipc_handle"] = base64.b64encode(
            cuda_shm_handle._ipc_handle).decode("ascii")
    return json.dumps(desc).encode("utf-8")


def _region_tensor(handle: CudaSharedMemoryRegion) -> torch.Tensor:
    if handle._closed:
        raise CudaSharedMemoryException(
            f"shared memory region '{handle._triton_shm_name}' was destroyed")
    return handle.tensor


def _sync(region: torch.Tensor) -> None:
    if region.is_cuda:
        torch.cuda.current_stream(region.device).synchronize()


def set_shared_memory_region(cuda_shm_handle: CudaSharedMemoryRegion,
                             input_values: Sequence[np.ndarray],
                             offset: int = 0) -> None:
    """Copy the numpy arrays of ``input_values`` into the region, back to
    back from ``offset`` (BYTES serialized); the region's other bytes are
    kept.  Returns when the copy is done."""
    if not isinstance(input_values, (list, tuple)):
        raise CudaSharedMemoryException(
            "input_values must be a list of numpy arrays")
    if offset < 0:
        raise CudaSharedMemoryException(
            f"unable to set shared memory region: negative offset {offset}")
    payloads = []
    for v in input_values:
        v = np.asarray(v)
        if v.dtype == np.object_ or v.dtype.kind in ("S", "U"):
            payloads.append(serialize_byte_tensor(v))
        else:
            payloads.append(np.ascontiguousarray(v).reshape(-1).view(
                np.uint8))
    total = sum(p.nbytes for p in payloads)
    if offset + total > cuda_shm_handle._byte_size:
        raise CudaSharedMemoryException(
            "unable to set shared memory region: byte_size "
            f"{cuda_shm_handle._byte_size} is too small for {offset + total} "
            "bytes")
    region = _region_tensor(cuda_shm_handle)
    payloads = [p for p in payloads if p.nbytes]
    if not payloads:
        return
    host = np.concatenate(payloads) if len(payloads) > 1 else payloads[0]
    if not host.flags.writeable:  # torch.from_numpy wants a writable array
        host = host.copy()
    # a blocking copy: cudaMemcpyAsync on the current stream, then its
    # synchronize, as the original client does
    region[offset:offset + total].copy_(torch.from_numpy(host))


def set_shared_memory_region_from_dlpack(
        cuda_shm_handle: CudaSharedMemoryRegion, input_values) -> None:
    """Copy each DLPack producer of ``input_values`` (a torch tensor on the
    card or the host, a numpy array, ...) into the region, back to back
    from its start: one device-to-device copy for a tensor on the card.
    Returns when the copies are done."""
    if not isinstance(input_values, (list, tuple)):
        input_values = [input_values]
    tensors = []
    for v in input_values:
        if isinstance(v, torch.Tensor):
            t = v
        elif hasattr(v, "__dlpack__"):
            t = torch.from_dlpack(v)
        else:
            raise CudaSharedMemoryException(
                f"tensor of type {type(v).__name__} does not support DLPack")
        if not t.is_contiguous():
            raise CudaSharedMemoryException(
                "the tensor must be contiguous in memory")
        tensors.append(t)
    total = sum(t.numel() * t.element_size() for t in tensors)
    if total > cuda_shm_handle._byte_size:
        raise CudaSharedMemoryException(
            "unable to set shared memory region: byte_size "
            f"{cuda_shm_handle._byte_size} is too small for {total} bytes")
    region = _region_tensor(cuda_shm_handle)
    cur = 0
    for t in tensors:
        n = t.numel() * t.element_size()
        if n:
            region[cur:cur + n].copy_(t.reshape(-1).view(torch.uint8),
                                      non_blocking=True)
        cur += n
    _sync(region)


def get_contents_as_numpy(cuda_shm_handle: CudaSharedMemoryRegion,
                          datatype, shape: Sequence[int],
                          offset: int = 0) -> np.ndarray:
    """The region's bytes at ``offset`` as a host numpy array of the numpy
    ``datatype`` and ``shape`` (one device-to-host copy; BYTES
    deserialized)."""
    region = _region_tensor(cuda_shm_handle)
    dt = np.dtype(datatype)
    count = int(np.prod(shape)) if len(shape) else 1
    avail = cuda_shm_handle._byte_size - offset
    nbytes = avail if dt == np.object_ else count * dt.itemsize
    if offset < 0 or nbytes > avail:
        raise CudaSharedMemoryException(
            f"unable to read {nbytes} bytes at offset {offset} from region "
            f"'{cuda_shm_handle._triton_shm_name}'")
    host = region[offset:offset + nbytes].cpu().numpy()
    if dt == np.object_:
        try:
            flat = deserialize_bytes_tensor(host, count=count)
        except ValueError as e:
            raise CudaSharedMemoryException(
                f"region '{cuda_shm_handle._triton_shm_name}' holds no BYTES "
                f"tensor of {count} elements at offset {offset}: {e}")
        return flat.reshape(tuple(shape))
    return host.view(dt).reshape(tuple(shape))


def as_shared_memory_tensor(cuda_shm_handle: CudaSharedMemoryRegion,
                            datatype: str, shape: Sequence[int],
                            offset: int = 0) -> torch.Tensor:
    """The region's bytes at ``offset`` as a torch tensor of the Triton
    ``datatype`` and ``shape``, on the region's device: a view of the
    region (a copy only at an offset that is not a multiple of the item
    size), consumable by any framework through ``__dlpack__``."""
    dt = triton_to_torch_dtype(datatype)
    if dt is None:
        raise CudaSharedMemoryException(f"unsupported datatype {datatype}")
    try:
        return typed_view(_region_tensor(cuda_shm_handle), dt, shape, offset)
    except ValueError as e:
        raise CudaSharedMemoryException(
            f"region '{cuda_shm_handle._triton_shm_name}': {e}")


def allocated_shared_memory_regions() -> List[str]:
    """Names of this process's live regions (the leak check of the
    original client's cudashm examples)."""
    with _alloc_lock:
        return [r._triton_shm_name for r in _allocated.values()]


def destroy_shared_memory_region(
        cuda_shm_handle: CudaSharedMemoryRegion) -> None:
    """Free the region now (unregister it from every server first)."""
    with _alloc_lock:
        _allocated.pop(cuda_shm_handle._uuid, None)
    cuda_shm_handle._close()
