"""ctypes binding of ``csrc/cuda_ipc.cu``: device allocations outside
PyTorch's caching allocator, their IPC handles, and torch views of them.

Shared by the client half (``utils.cuda_shared_memory``: allocate, export)
and the server half (``server.shm``: import, close).  The library is built
with nvcc at first use (``ops._build``).  Every failed CUDA call raises
:class:`CudaIpcError` with ``cudaGetErrorString``'s text; nothing falls back
to host memory.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .ops import _build

HANDLE_SIZE = 64  # sizeof(cudaIpcMemHandle_t)

_lock = threading.Lock()
_lib = None


class CudaIpcError(RuntimeError):
    """A CUDA call of the shared-memory path failed."""


def _cdll() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = _build.load("cuda_ipc")
            vp, pvp = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
            for name, args in (
                    ("cuda_ipc_malloc", [ctypes.c_int, ctypes.c_size_t, pvp]),
                    ("cuda_ipc_free", [ctypes.c_int, vp]),
                    ("cuda_ipc_get_handle", [ctypes.c_int, vp,
                                             ctypes.c_char_p]),
                    ("cuda_ipc_open", [ctypes.c_int, ctypes.c_char_p, pvp]),
                    ("cuda_ipc_close", [ctypes.c_int, vp])):
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            lib.cuda_ipc_handle_size.restype = ctypes.c_int
            lib.cuda_ipc_error_string.argtypes = [ctypes.c_int]
            lib.cuda_ipc_error_string.restype = ctypes.c_char_p
            if lib.cuda_ipc_handle_size() != HANDLE_SIZE:
                raise CudaIpcError(
                    f"cudaIpcMemHandle_t is {lib.cuda_ipc_handle_size()} "
                    f"bytes, expected {HANDLE_SIZE}")
            _lib = lib
        return _lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        msg = _cdll().cuda_ipc_error_string(rc).decode()
        raise CudaIpcError(f"{what} failed: {msg} (cudaError {rc})")


def malloc(device_id: int, nbytes: int) -> int:
    """``cudaMalloc(nbytes)`` on ``device_id``; the pointer as an int."""
    ptr = ctypes.c_void_p()
    _check(_cdll().cuda_ipc_malloc(device_id, nbytes, ctypes.byref(ptr)),
           f"cudaMalloc of {nbytes} bytes on device {device_id}")
    return ptr.value


def free(device_id: int, ptr: int) -> None:
    _check(_cdll().cuda_ipc_free(device_id, ptr), "cudaFree")


def get_handle(device_id: int, ptr: int) -> bytes:
    """The ``cudaIpcMemHandle_t`` of the allocation at ``ptr``."""
    out = ctypes.create_string_buffer(HANDLE_SIZE)
    _check(_cdll().cuda_ipc_get_handle(device_id, ptr, out),
           "cudaIpcGetMemHandle")
    return out.raw


def open_handle(device_id: int, handle: bytes) -> int:
    """Map another process's allocation (``cudaIpcOpenMemHandle`` with
    ``cudaIpcMemLazyEnablePeerAccess``); the pointer as an int."""
    if len(handle) != HANDLE_SIZE:
        raise CudaIpcError(
            f"a CUDA IPC handle is {HANDLE_SIZE} bytes, got {len(handle)}")
    ptr = ctypes.c_void_p()
    _check(_cdll().cuda_ipc_open(device_id, handle, ctypes.byref(ptr)),
           "cudaIpcOpenMemHandle")
    return ptr.value


def close_handle(device_id: int, ptr: int) -> None:
    _check(_cdll().cuda_ipc_close(device_id, ptr), "cudaIpcCloseMemHandle")


class _DeviceBytes:
    """``nbytes`` of device memory at ``ptr``, described by the CUDA array
    interface so that ``torch.as_tensor`` wraps it without a copy."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "version": 2}


def as_tensor(ptr: int, nbytes: int, device_id: int) -> torch.Tensor:
    """A ``torch.uint8`` tensor of the ``nbytes`` at ``ptr`` on
    ``cuda:{device_id}``: the same memory, not a copy.  The caller keeps
    the allocation alive as long as the tensor."""
    t = torch.as_tensor(_DeviceBytes(ptr, nbytes))
    if t.data_ptr() != ptr or t.device != torch.device("cuda", device_id):
        raise CudaIpcError(
            f"torch wrapped {ptr:#x} as {t.data_ptr():#x} on {t.device}, "
            f"expected the same pointer on cuda:{device_id}")
    return t
