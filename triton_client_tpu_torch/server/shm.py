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

The sibling-worker manifest (the reference's, shm.py:37-126): with
``--frontends N`` the N workers share one port, so a client's register
lands on one worker and its infers on any.  Each registry publishes its
registrations into the directory ``TRITON_TPU_SHM_MANIFEST`` (the
supervisor sets it), one JSON file per region written atomically, and a
worker resolves a region name it does not know from there at first use.  A
system region attaches by its key.  A CUDA region's entry carries its raw
handle, whose ``cuda_ipc_handle`` a sibling opens with
``cudaIpcOpenMemHandle`` at first use (a region made in the sibling's own
process is found by its uuid in the broker instead): the counterpart of the
reference's host staging path.  Every registration made under a manifest
carries its entry, direct ones too, and is checked against the manifest at
each use (and at each status): once the entry is gone or changed (an
unregister, or a register again, through another worker) the attachment
is dropped and its handle closed, and a direct register of the name
evicts it.  An unregister removes the entry and closes the region in the
worker that served it; the others drop theirs at their next use.
"""

from __future__ import annotations

import base64
import binascii
import json
import math
import os
import threading
import urllib.parse
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
from .fleet import MANIFEST_ENV
from .types import InferError, ShmRef


# -- the sibling-worker manifest ---------------------------------------------


def _manifest_dir() -> Optional[str]:
    return os.environ.get(MANIFEST_ENV) or None


def _manifest_path(kind: str, name: str) -> Optional[str]:
    d = _manifest_dir()
    if d is None:
        return None
    return os.path.join(d, f"{kind}_{urllib.parse.quote(name, safe='')}.json")


def _manifest_write(kind: str, name: str, payload: dict) -> None:
    path = _manifest_path(kind, name)
    if path is None:
        return
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)  # a reader never sees a torn file
    except OSError:
        pass  # the manifest is best-effort; the registration stands


def _manifest_remove(kind: str, name: Optional[str]) -> None:
    d = _manifest_dir()
    if d is None:
        return
    try:
        if name:
            paths = [_manifest_path(kind, name)]
        else:
            paths = [os.path.join(d, fn) for fn in os.listdir(d)
                     if fn.startswith(f"{kind}_") and fn.endswith(".json")]
        for p in paths:
            try:
                os.unlink(p)
            except OSError:
                pass
    except OSError:
        pass


def _manifest_load(kind: str, name: str) -> Optional[dict]:
    path = _manifest_path(kind, name)
    if path is None:
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _manifest_names(kind: str) -> Dict[str, dict]:
    d = _manifest_dir()
    if d is None:
        return {}
    out: Dict[str, dict] = {}
    try:
        for fn in os.listdir(d):
            if not (fn.startswith(f"{kind}_") and fn.endswith(".json")):
                continue
            name = urllib.parse.unquote(fn[len(kind) + 1:-5])
            try:
                with open(os.path.join(d, fn)) as f:
                    out[name] = json.load(f)
            except (OSError, ValueError):
                continue
    except OSError:
        pass
    return out


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
    # the manifest entry this registration was published as or resolved
    # from (None without a manifest): a sibling's unregister or
    # re-register changes it, and the attachment is then dropped
    manifest: Optional[dict] = None


class _ManifestRegistry:
    """What both registries share: the regions by name under a lock, the
    manifest's publishing and lazy resolution."""

    KIND = ""

    def __init__(self):
        self._regions: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def _close(self, region) -> None:
        raise NotImplementedError

    def _resolve(self, name: str, entry: dict) -> None:
        """Register ``name`` from its manifest ``entry`` (not published)."""
        raise NotImplementedError

    def _evict(self, name: str, region) -> None:
        with self._lock:
            if self._regions.get(name) is not region:
                return
            self._regions.pop(name)
        self._close(region)

    def _stale(self, region) -> bool:
        """A registration made under a manifest whose entry is gone or
        changed."""
        return region.manifest is not None and \
            _manifest_load(self.KIND, region.name) != region.manifest

    def _lookup(self, name: str):
        """The region of ``name``: this worker's, else resolved from the
        manifest (a stale one dropped first); None."""
        with self._lock:
            region = self._regions.get(name)
        if region is not None and self._stale(region):
            self._evict(name, region)
            region = None
        if region is None:
            entry = _manifest_load(self.KIND, name)
            if entry is not None:
                try:
                    self._resolve(name, entry)
                except (InferError, KeyError, TypeError, ValueError):
                    pass
                with self._lock:
                    region = self._regions.get(name)
        return region

    def _get(self, ref: ShmRef):
        region = self._lookup(ref.region_name)
        if region is None:
            raise InferError(
                f"Unable to find shared memory region: '{ref.region_name}'")
        return region

    def _take_stale(self, name: str, publish: bool) -> None:
        """Make room for a register of ``name``: a direct register evicts
        a registration made under the manifest (a sibling may have
        unregistered it); any other holder refuses it."""
        stale = self._regions.get(name)
        if stale is None:
            return
        if publish and stale.manifest is not None:
            self._regions.pop(name)
            self._close(stale)
            return
        raise InferError(
            f"shared memory region '{name}' already in manager")

    def unregister(self, name: Optional[str]) -> None:
        """Unregister one region, or every region when ``name`` is empty
        (its manifest entries removed)."""
        with self._lock:
            names = [name] if name else list(self._regions)
            regions = [self._regions.pop(n) for n in names
                       if n in self._regions]
        for region in regions:
            self._close(region)
        _manifest_remove(self.KIND, name)

    def _status(self, name: Optional[str], row, entry_row) -> Dict[str, dict]:
        with self._lock:
            local = [r for n, r in self._regions.items()
                     if not name or n == name]
        out = {}
        for r in local:
            if self._stale(r):
                self._evict(r.name, r)
            else:
                out[r.name] = row(r)
        # regions registered through a sibling worker show here too
        for n, m in _manifest_names(self.KIND).items():
            if n not in out and (not name or n == name):
                out[n] = entry_row(n, m)
        return out

    def has(self, name: str) -> bool:
        return self._lookup(name) is not None


class SystemShmRegistry(_ManifestRegistry):
    KIND = "sys"

    def register(self, name: str, key: str, offset: int, byte_size: int,
                 publish: bool = True,
                 manifest: Optional[dict] = None) -> None:
        if publish and manifest is None and _manifest_dir() is not None:
            manifest = {"key": key, "offset": offset, "byte_size": byte_size}
        with self._lock:
            self._take_stale(name, publish)
            try:
                handle = sysshm.attach_shared_memory_region(
                    name, key, byte_size, offset)
            except sysshm.SharedMemoryException as e:
                raise InferError(
                    f"failed to register shared memory region '{name}': {e}")
            self._regions[name] = SystemShmRegion(
                name, key, offset, byte_size, handle, manifest=manifest)
        if publish and manifest is not None:
            _manifest_write(self.KIND, name, manifest)

    def _resolve(self, name: str, entry: dict) -> None:
        self.register(name, entry["key"], int(entry.get("offset", 0)),
                      int(entry["byte_size"]), publish=False,
                      manifest=entry)

    def _close(self, region: SystemShmRegion) -> None:
        sysshm.destroy_shared_memory_region(region.handle)

    def status(self, name: Optional[str]) -> Dict[str, dict]:
        return self._status(
            name, lambda r: {"name": r.name, "key": r.key,
                             "offset": r.offset, "byte_size": r.byte_size},
            lambda n, m: {"name": n, "key": m.get("key", ""),
                          "offset": int(m.get("offset", 0)),
                          "byte_size": int(m.get("byte_size", 0))})

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
    # as SystemShmRegion's
    manifest: Optional[dict] = None


class CudaShmRegistry(_ManifestRegistry):
    KIND = "cuda"

    def register(self, name: str, raw_handle: bytes, device_id: int,
                 byte_size: int, publish: bool = True,
                 manifest: Optional[dict] = None) -> None:
        if publish and manifest is None and _manifest_dir() is not None:
            manifest = {"raw_handle_b64":
                        base64.b64encode(bytes(raw_handle)).decode("ascii"),
                        "device_id": device_id, "byte_size": byte_size}
        try:
            desc = json.loads(bytes(raw_handle).decode("utf-8"))
            if not isinstance(desc, dict):
                raise ValueError(desc)
        except (TypeError, ValueError):  # UnicodeDecodeError is one
            raise InferError(
                f"failed to register CUDA/XLA shared memory region '{name}': "
                "raw handle is not a valid descriptor")
        with self._lock:
            self._take_stale(name, publish)
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
            region.manifest = manifest
            self._regions[name] = region
        if publish and manifest is not None:
            _manifest_write(self.KIND, name, manifest)

    def _resolve(self, name: str, entry: dict) -> None:
        self.register(name, base64.b64decode(entry["raw_handle_b64"]),
                      int(entry.get("device_id", 0)),
                      int(entry["byte_size"]), publish=False,
                      manifest=entry)

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

    def _close(self, region: CudaShmRegion) -> None:
        """Close a mapping of another process's region, once the device's
        queued work is finished."""
        if region.ipc_ptr is not None:
            region.tensor = None
            torch.cuda.synchronize(region.device_id)
            _cuda_ipc.close_handle(region.device_id, region.ipc_ptr)

    def status(self, name: Optional[str]) -> Dict[str, dict]:
        return self._status(
            name, lambda r: {"name": r.name, "device_id": r.device_id,
                             "byte_size": r.byte_size},
            lambda n, m: {"name": n, "device_id": int(m.get("device_id", 0)),
                          "byte_size": int(m.get("byte_size", 0))})

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
