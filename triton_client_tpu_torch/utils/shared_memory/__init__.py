"""System (POSIX) shared-memory regions, on the standard library.

Counterpart of ``triton_client_tpu/utils/shared_memory``: the same functions,
handle and error codes.  The reference binds ``shm_open`` + ``mmap`` through a
C shim; here ``os.open("/dev/shm/<key>")`` and :mod:`mmap` reach the same
object, so the two packages attach each other's regions by key.
``multiprocessing.shared_memory`` is not used: on Python 3.12 its resource
tracker unlinks a segment that a process merely attached, when that process
exits.

Numpy results of :func:`get_contents_as_numpy` and the tensors of
:func:`as_shared_memory_tensor` are views of the mapping, and they keep it
mapped: destroying a region unlinks its key at once but unmaps it only when
the last such view is gone.
"""

from __future__ import annotations

import contextlib
import mmap
import os
from typing import List, Optional

import numpy as np
import torch

from .. import (deserialize_bytes_tensor, serialize_byte_tensor,
                triton_to_torch_dtype, typed_view)

__all__ = [
    "SharedMemoryException",
    "SharedMemoryRegionHandle",
    "create_shared_memory_region",
    "attach_shared_memory_region",
    "set_shared_memory_region",
    "get_contents_as_numpy",
    "as_shared_memory_tensor",
    "mapped_shared_memory_regions",
    "destroy_shared_memory_region",
]

_SHM_DIR = "/dev/shm"


class SharedMemoryException(Exception):
    """A failed shared-memory call, by the reference's negative error
    code."""

    ERROR_MESSAGES = {
        -1: "unknown shared memory error",
        -2: "unable to open/create shared memory object",
        -3: "unable to set size of shared memory object",
        -4: "unable to map shared memory object",
        -5: "unable to unmap shared memory object",
        -6: "unable to unlink shared memory object",
        -7: "invalid shared memory handle",
        -8: "write exceeds shared memory region bounds",
    }

    def __init__(self, err: int):
        self.err = err
        super().__init__(self.ERROR_MESSAGES.get(err, "unknown error"))


def _shm_path(shm_key: str) -> str:
    """The file ``shm_open(shm_key)`` opens: leading slashes dropped, no
    other slash allowed."""
    name = shm_key.lstrip("/")
    if not name or "/" in name:
        raise SharedMemoryException(-2)
    return os.path.join(_SHM_DIR, name)


def _map(fd: int, offset: int, byte_size: int):
    """``byte_size`` bytes of ``fd`` from ``offset``, mapped from the page
    boundary below it: (mapping, offset of the region in the mapping)."""
    delta = offset % mmap.ALLOCATIONGRANULARITY
    try:
        mm = mmap.mmap(fd, byte_size + delta, flags=mmap.MAP_SHARED,
                       prot=mmap.PROT_READ | mmap.PROT_WRITE,
                       offset=offset - delta)
    except (OSError, ValueError):  # ValueError: past the object's end
        raise SharedMemoryException(-4)
    return mm, delta


class SharedMemoryRegionHandle:
    """A mapped region: its wire name, shm key, byte size, whether this
    process created (owns) it, and the mapping."""

    def __init__(self, triton_shm_name: str, shm_key: str, byte_size: int,
                 owner: bool, fd: int, mm: mmap.mmap, delta: int):
        self.triton_shm_name = triton_shm_name
        self.shm_key = shm_key
        self.byte_size = byte_size
        self.owner = owner
        self._fd = fd
        self._mmap: Optional[mmap.mmap] = mm
        self._delta = delta
        self._destroyed = False

    def _bytes(self, offset: int, nbytes: int) -> np.ndarray:
        """A uint8 numpy view of ``nbytes`` at ``offset`` of the region."""
        if self._mmap is None:
            raise SharedMemoryException(-7)
        return np.frombuffer(self._mmap, np.uint8, nbytes,
                             self._delta + offset)


# keys of the regions this process maps (the reference's list at :74)
_mapped_shm_regions: List[str] = []


def create_shared_memory_region(triton_shm_name: str, shm_key: str,
                                byte_size: int, create_only: bool = False
                                ) -> SharedMemoryRegionHandle:
    """Create the region ``shm_key``, or attach it where it exists and
    ``create_only`` is False (the object is resized to ``byte_size``, as
    ``ftruncate`` does in the reference)."""
    if byte_size <= 0:
        raise SharedMemoryException(-3)
    path = _shm_path(shm_key)
    flags = os.O_RDWR | os.O_CREAT | (os.O_EXCL if create_only else 0)
    try:
        fd = os.open(path, flags, 0o600)
    except OSError:
        raise SharedMemoryException(-2)
    err = 0
    try:
        os.ftruncate(fd, byte_size)
        mm, delta = _map(fd, 0, byte_size)
    except OSError:
        err = -3
    except SharedMemoryException as e:
        err = e.err
    if err:
        os.close(fd)
        with contextlib.suppress(OSError):
            os.unlink(path)  # as the reference: never leave it half made
        raise SharedMemoryException(err)
    _mapped_shm_regions.append(shm_key)
    return SharedMemoryRegionHandle(triton_shm_name, shm_key, byte_size,
                                    True, fd, mm, delta)


def attach_shared_memory_region(triton_shm_name: str, shm_key: str,
                                byte_size: int, offset: int = 0
                                ) -> SharedMemoryRegionHandle:
    """Map ``byte_size`` bytes at ``offset`` of a region another process
    created (the server's side of registration)."""
    if byte_size <= 0 or offset < 0:
        raise SharedMemoryException(-4)
    try:
        fd = os.open(_shm_path(shm_key), os.O_RDWR)
    except OSError:
        raise SharedMemoryException(-2)
    try:
        mm, delta = _map(fd, offset, byte_size)
    except SharedMemoryException:
        os.close(fd)
        raise
    _mapped_shm_regions.append(shm_key)
    return SharedMemoryRegionHandle(triton_shm_name, shm_key, byte_size,
                                    False, fd, mm, delta)


def _payload(value) -> np.ndarray:
    """A value's bytes as written to a region: BYTES serialized."""
    arr = np.asarray(value)
    if arr.dtype == np.object_ or arr.dtype.kind in ("S", "U"):
        return serialize_byte_tensor(arr)
    return np.ascontiguousarray(arr)


def set_shared_memory_region(shm_handle: SharedMemoryRegionHandle,
                             input_values, offset: int = 0) -> None:
    """Copy each array of ``input_values`` into the region, back to back
    from ``offset`` (BYTES serialized)."""
    if not isinstance(input_values, (list, tuple)):
        raise SharedMemoryException(-1)
    if offset < 0:
        raise SharedMemoryException(-8)
    cur = offset
    for value in input_values:
        data = _payload(value)
        nbytes = data.nbytes
        if cur > shm_handle.byte_size or nbytes > shm_handle.byte_size - cur:
            raise SharedMemoryException(-8)
        if nbytes:
            shm_handle._bytes(cur, nbytes)[:] = data.reshape(-1).view(
                np.uint8)
        cur += nbytes


def get_contents_as_numpy(shm_handle: SharedMemoryRegionHandle, datatype,
                          shape, offset: int = 0) -> np.ndarray:
    """The region's bytes at ``offset`` as a numpy array of ``datatype``
    and ``shape``: a view of the mapping, or for BYTES (``np.object_``) the
    ``prod(shape)`` elements decoded."""
    if offset < 0 or offset > shm_handle.byte_size:
        raise SharedMemoryException(-8)
    region_size = shm_handle.byte_size - offset
    dt = np.dtype(datatype)
    count = int(np.prod(shape)) if len(shape) else 1
    if dt == np.object_:
        raw = shm_handle._bytes(offset, region_size)
        try:
            flat = deserialize_bytes_tensor(raw, count=count)
        except ValueError:
            raise SharedMemoryException(-8)
        return flat.reshape(shape)
    if count * dt.itemsize > region_size:
        raise SharedMemoryException(-8)
    return shm_handle._bytes(offset, count * dt.itemsize).view(dt).reshape(
        shape)


def as_shared_memory_tensor(shm_handle: SharedMemoryRegionHandle,
                            datatype: str, shape, offset: int = 0
                            ) -> torch.Tensor:
    """The region's bytes at ``offset`` as a CPU torch tensor of the Triton
    ``datatype`` and ``shape``: zero-copy (a copy only at an offset that is
    not a multiple of the item size), and consumable by any framework
    through ``__dlpack__``."""
    dt = triton_to_torch_dtype(datatype)
    if dt is None:
        raise SharedMemoryException(-1)
    region = torch.from_numpy(shm_handle._bytes(0, shm_handle.byte_size))
    try:
        return typed_view(region, dt, shape, offset)
    except ValueError:
        raise SharedMemoryException(-8)


def mapped_shared_memory_regions() -> List[str]:
    """The shm keys of the regions this process maps."""
    return list(_mapped_shm_regions)


def destroy_shared_memory_region(
        shm_handle: SharedMemoryRegionHandle) -> None:
    """Unmap the region (once no view of it is left) and, if this process
    created it, unlink its key."""
    if shm_handle._destroyed:
        return
    shm_handle._destroyed = True
    mm, shm_handle._mmap = shm_handle._mmap, None
    try:
        mm.close()
    except BufferError:
        pass  # views exist: the mapping goes with the last of them
    os.close(shm_handle._fd)
    try:
        _mapped_shm_regions.remove(shm_handle.shm_key)
    except ValueError:
        pass
    if shm_handle.owner:
        try:
            os.unlink(_shm_path(shm_handle.shm_key))
        except OSError:
            raise SharedMemoryException(-6)
