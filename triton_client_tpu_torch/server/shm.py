"""Server-side shared-memory region registries.

Counterpart of ``triton_client_tpu/server/shm.py``, the server half of the
v2 shared-memory extensions (``systemsharedmemory``, ``cudasharedmemory``):

* :class:`SystemShmRegistry`: regions registered by (shm key, offset,
  byte_size) and mapped from ``/dev/shm``; inputs are numpy views of the
  mapped bytes and outputs are copied into them, so tensor bytes never
  cross the wire.
* :class:`CudaShmRegistry`, the counterpart of ``XlaShmRegistry``: a region
  registered from the same process is found by the uuid of its raw handle
  in the broker and shared as it is; one from another process is mapped
  once, at register, with ``cudaIpcOpenMemHandle``.  Either way the server
  holds a ``torch.uint8`` tensor of the region's memory: an input is a typed
  view of it (zero-copy), an output is copied device-to-device into it.

Not ported: the reference's sibling-worker manifest (its ``SO_REUSEPORT``
multi-frontend mode, which the port does not have).
"""

from __future__ import annotations

import base64
import binascii
import json
import math
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import _cuda_ipc
from .._cuda_broker import broker
from ..utils import (bf16_to_bytes, deserialize_bytes_tensor,
                     serialize_byte_tensor, triton_to_np_dtype,
                     triton_to_torch_dtype, typed_view)
from ..utils import shared_memory as sysshm
from .types import InferError, ShmRef


def _check_extent(ref: ShmRef, region_size: int) -> None:
    if ref.offset < 0 or ref.byte_size < 0 \
            or ref.offset + ref.byte_size > region_size:
        raise InferError(
            "Invalid offset + byte size for shared memory region: "
            f"'{ref.region_name}'")


def _check_fits(ref: ShmRef, nbytes: int, datatype: str, shape) -> None:
    if nbytes > ref.byte_size:
        raise InferError(
            f"shared memory region '{ref.region_name}': {ref.byte_size} "
            f"bytes do not hold a {datatype} tensor of shape {list(shape)} "
            f"({nbytes} bytes)")


def _too_small(ref: ShmRef) -> InferError:
    return InferError(
        f"shared memory region '{ref.region_name}' too small for output", 400)


@dataclass
class SystemShmRegion:
    name: str
    key: str
    offset: int
    byte_size: int
    handle: sysshm.SharedMemoryRegionHandle


class SystemShmRegistry:
    def __init__(self):
        self._regions: Dict[str, SystemShmRegion] = {}
        self._lock = threading.Lock()

    def register(self, name: str, key: str, offset: int,
                 byte_size: int) -> None:
        with self._lock:
            if name in self._regions:
                raise InferError(
                    f"shared memory region '{name}' already in manager")
            try:
                handle = sysshm.attach_shared_memory_region(
                    name, key, byte_size, offset)
            except sysshm.SharedMemoryException as e:
                raise InferError(
                    f"failed to register shared memory region '{name}': {e}")
            self._regions[name] = SystemShmRegion(name, key, offset,
                                                  byte_size, handle)

    def unregister(self, name: Optional[str]) -> None:
        """Unregister one region, or every region when ``name`` is empty."""
        with self._lock:
            names = [name] if name else list(self._regions)
            regions = [self._regions.pop(n) for n in names
                       if n in self._regions]
        for region in regions:
            sysshm.destroy_shared_memory_region(region.handle)

    def status(self, name: Optional[str]) -> Dict[str, dict]:
        with self._lock:
            return {n: {"name": r.name, "key": r.key, "offset": r.offset,
                        "byte_size": r.byte_size}
                    for n, r in self._regions.items()
                    if not name or n == name}

    def has(self, name: str) -> bool:
        with self._lock:
            return name in self._regions

    def _get(self, ref: ShmRef) -> SystemShmRegion:
        with self._lock:
            region = self._regions.get(ref.region_name)
        if region is None:
            raise InferError(
                f"Unable to find shared memory region: '{ref.region_name}'")
        return region

    def read(self, ref: ShmRef, datatype: str, shape) -> np.ndarray:
        """The input at ``ref``: a numpy view of the mapped bytes (BYTES:
        the elements decoded)."""
        region = self._get(ref)
        _check_extent(ref, region.byte_size)
        # BF16: the bits as int16, viewed as a torch.bfloat16 tensor
        dt = (np.dtype(np.int16) if datatype == "BF16"
              else triton_to_np_dtype(datatype))
        if dt is None:
            raise InferError(f"unsupported datatype {datatype}")
        if dt != np.object_:
            _check_fits(ref, math.prod(shape) * dt.itemsize, datatype, shape)
        try:
            arr = sysshm.get_contents_as_numpy(
                region.handle, dt, list(shape), offset=ref.offset)
        except sysshm.SharedMemoryException as e:
            raise InferError(
                f"shared memory region '{ref.region_name}': {e}")
        if datatype == "BF16":
            return torch.from_numpy(arr).view(torch.bfloat16)
        return arr

    def write(self, ref: ShmRef, data) -> int:
        """Copy an output (a host array, or a ``torch.bfloat16`` tensor)
        into the region; returns the bytes written."""
        region = self._get(ref)
        if isinstance(data, torch.Tensor):
            payload = bf16_to_bytes(data)
        elif data.dtype == np.object_ or data.dtype.kind in ("S", "U"):
            payload = serialize_byte_tensor(data)
        else:
            payload = np.ascontiguousarray(data)
        if payload.nbytes > ref.byte_size \
                or ref.offset + payload.nbytes > region.byte_size:
            raise _too_small(ref)
        sysshm.set_shared_memory_region(region.handle, [payload],
                                        offset=ref.offset)
        return payload.nbytes


@dataclass
class CudaShmRegion:
    name: str
    device_id: int
    byte_size: int
    tensor: torch.Tensor  # uint8, byte_size bytes of the region's memory
    # the cudaIpcOpenMemHandle pointer of a region of another process
    ipc_ptr: Optional[int] = None


class CudaShmRegistry:
    def __init__(self):
        self._regions: Dict[str, CudaShmRegion] = {}
        self._lock = threading.Lock()

    def register(self, name: str, raw_handle: bytes, device_id: int,
                 byte_size: int) -> None:
        try:
            desc = json.loads(bytes(raw_handle).decode("utf-8"))
            if not isinstance(desc, dict):
                raise ValueError(desc)
        except (TypeError, ValueError):  # UnicodeDecodeError is one
            raise InferError(
                f"failed to register CUDA/XLA shared memory region '{name}': "
                "raw handle is not a valid descriptor")
        with self._lock:
            if name in self._regions:
                raise InferError(
                    f"shared memory region '{name}' already in manager")
            entry = broker().lookup(str(desc.get("uuid", "")))
            if entry is not None:
                # made in this process: share its tensor (cudaIpcOpen-
                # MemHandle refuses a handle of the calling process)
                self._check_size(name, byte_size, entry.byte_size)
                region = CudaShmRegion(name, device_id, byte_size,
                                       entry.tensor[:byte_size])
            elif desc.get("cuda_ipc_handle"):
                self._check_size(name, byte_size,
                                 int(desc.get("byte_size", byte_size)))
                region = self._import(name, desc["cuda_ipc_handle"],
                                      device_id, byte_size)
            else:
                raise InferError(
                    f"failed to register XLA shared memory region '{name}': "
                    "handle refers to neither an in-process slot nor a "
                    "staging region")
            self._regions[name] = region

    @staticmethod
    def _check_size(name: str, byte_size: int, allocated: int) -> None:
        if not 0 < byte_size <= allocated:
            raise InferError(
                f"failed to register CUDA shared memory region '{name}': "
                f"byte_size {byte_size} outside the region's {allocated} "
                "bytes")

    @staticmethod
    def _import(name: str, handle_b64: str, device_id: int,
                byte_size: int) -> CudaShmRegion:
        """Map another process's region, once."""
        try:
            handle = base64.b64decode(handle_b64, validate=True)
            ptr = _cuda_ipc.open_handle(device_id, handle)
        except (binascii.Error, ValueError, RuntimeError) as e:
            raise InferError(
                f"failed to register CUDA shared memory region '{name}': {e}")
        try:
            tensor = _cuda_ipc.as_tensor(ptr, byte_size, device_id)
        except BaseException:
            _cuda_ipc.close_handle(device_id, ptr)
            raise
        return CudaShmRegion(name, device_id, byte_size, tensor, ptr)

    def unregister(self, name: Optional[str]) -> None:
        """Unregister one region, or every region when ``name`` is empty;
        the device's queued work is finished before a mapping closes."""
        with self._lock:
            names = [name] if name else list(self._regions)
            regions = [self._regions.pop(n) for n in names
                       if n in self._regions]
        for region in regions:
            if region.ipc_ptr is not None:
                region.tensor = None
                torch.cuda.synchronize(region.device_id)
                _cuda_ipc.close_handle(region.device_id, region.ipc_ptr)

    def status(self, name: Optional[str]) -> Dict[str, dict]:
        with self._lock:
            return {n: {"name": r.name, "device_id": r.device_id,
                        "byte_size": r.byte_size}
                    for n, r in self._regions.items()
                    if not name or n == name}

    def has(self, name: str) -> bool:
        with self._lock:
            return name in self._regions

    def _get(self, ref: ShmRef) -> CudaShmRegion:
        with self._lock:
            region = self._regions.get(ref.region_name)
        if region is None:
            raise InferError(
                f"Unable to find shared memory region: '{ref.region_name}'")
        return region

    def read(self, ref: ShmRef, datatype: str, shape):
        """The input at ``ref``: a typed view of the region's memory, on
        its device (a copy only where ``ref.offset`` is not a multiple of
        the item size).  BYTES: one device-to-host copy, decoded."""
        region = self._get(ref)
        _check_extent(ref, region.byte_size)
        raw = region.tensor[ref.offset:ref.offset + ref.byte_size]
        if datatype == "BYTES":
            try:
                flat = deserialize_bytes_tensor(raw.cpu().numpy(),
                                                count=math.prod(shape))
            except ValueError as e:
                raise InferError(
                    f"shared memory region '{ref.region_name}': {e}")
            return flat.reshape(shape)
        dt = triton_to_torch_dtype(datatype)
        if dt is None:
            raise InferError(f"unsupported datatype {datatype}")
        _check_fits(ref, math.prod(shape) * dt.itemsize, datatype, shape)
        return typed_view(region.tensor, dt, shape, ref.offset)

    def write(self, ref: ShmRef, value: Any) -> Optional[torch.device]:
        """Copy an output (a tensor, or a host array) into the region,
        queued on the current stream without waiting.  Returns the
        region's device where that is the card (the caller records an
        event behind its writes there and waits on it), else None."""
        region = self._get(ref)
        if isinstance(value, np.ndarray) and (
                value.dtype == np.object_ or value.dtype.kind in ("S", "U")):
            value = serialize_byte_tensor(value)
        if isinstance(value, np.ndarray):
            value = torch.from_numpy(np.require(value, requirements="CW"))
        nbytes = value.numel() * value.element_size()
        if nbytes > ref.byte_size \
                or ref.offset + nbytes > region.byte_size:
            raise _too_small(ref)
        if nbytes:
            src = value.contiguous().reshape(-1).view(torch.uint8)
            region.tensor[ref.offset:ref.offset + nbytes].copy_(
                src, non_blocking=True)
        return region.tensor.device if region.tensor.is_cuda else None
