"""Triton v2 dtype maps, the BYTES and BF16 codecs and the client's error
type (the port's own copy of the reference's
``triton_client_tpu/utils/__init__.py`` helpers).

``BF16`` maps to ``ml_dtypes.bfloat16`` where that package is installed,
else to no numpy dtype (and decodes to float32, as the original client
does).  The server holds a BF16 tensor on the host as a
``torch.bfloat16`` tensor, whatever is installed: :func:`bf16_from_bytes`
and :func:`bf16_to_bytes` move it to and from the wire by its own bits.  BYTES maps to ``object``; on the wire a BYTES tensor is the
row-major concatenation of ``<uint32 little-endian length><element
bytes>``.

``triton_to_torch_dtype`` and :func:`typed_view` serve the shared-memory
modules: a region is a ``torch.uint8`` tensor, and a tensor in it is a
typed view of its bytes (a torch tensor, so any framework takes it through
``__dlpack__``).

``torch`` is imported by the functions that use it, not with the module:
the clients and ``perf_analyzer`` import this module and never touch a
tensor unless a region or a BF16 tensor is involved, so a load generator's
process starts without paying the framework's import.
"""

from __future__ import annotations

import math
import struct
from typing import Optional

import numpy as np

try:
    import ml_dtypes

    _BF16_NP: Optional[np.dtype] = np.dtype(ml_dtypes.bfloat16)
except ImportError:  # not every install ships ml_dtypes
    _BF16_NP = None

_NP_TO_TRITON = {
    np.dtype(np.bool_): "BOOL",
    np.dtype(np.int8): "INT8",
    np.dtype(np.int16): "INT16",
    np.dtype(np.int32): "INT32",
    np.dtype(np.int64): "INT64",
    np.dtype(np.uint8): "UINT8",
    np.dtype(np.uint16): "UINT16",
    np.dtype(np.uint32): "UINT32",
    np.dtype(np.uint64): "UINT64",
    np.dtype(np.float16): "FP16",
    np.dtype(np.float32): "FP32",
    np.dtype(np.float64): "FP64",
}
if _BF16_NP is not None:
    _NP_TO_TRITON[_BF16_NP] = "BF16"

_TRITON_TO_NP = {v: k for k, v in _NP_TO_TRITON.items()}
_TRITON_TO_NP["BYTES"] = np.dtype(np.object_)


class InferenceServerException(Exception):
    """An error reported by the server or raised by the client: a message,
    an optional status (the HTTP status as a string) and optional debug
    details."""

    def __init__(self, msg, status: Optional[str] = None,
                 debug_details=None):
        self._msg = msg
        self._status = status
        self._debug_details = debug_details
        # the server's pushback in seconds, where it sent one
        self.retry_after_s: Optional[float] = None
        super().__init__(msg)

    def __str__(self):
        msg = super().__str__() if self._msg is None else self._msg
        if self._status is not None:
            msg = "[" + self._status + "] " + msg
        return msg

    def message(self):
        """The brief description of the error."""
        return self._msg

    def status(self):
        """The error's status code, if any."""
        return self._status

    def debug_details(self):
        """The detailed description of the error, if any."""
        return self._debug_details


def raise_error(msg):
    """Raise an :class:`InferenceServerException` with ``msg`` (an error
    found by the client)."""
    raise InferenceServerException(msg=msg) from None



# Triton dtype <-> torch dtype, both directions, built at the first use
_TORCH_DTYPES: dict = {}
_TRITON_OF_TORCH: dict = {}


def _torch_dtypes() -> dict:
    if not _TORCH_DTYPES:
        import torch

        _TORCH_DTYPES.update({
            "BOOL": torch.bool, "INT8": torch.int8, "INT16": torch.int16,
            "INT32": torch.int32, "INT64": torch.int64,
            "UINT8": torch.uint8, "UINT16": torch.uint16,
            "UINT32": torch.uint32, "UINT64": torch.uint64,
            "FP16": torch.float16, "BF16": torch.bfloat16,
            "FP32": torch.float32, "FP64": torch.float64,
        })
        _TRITON_OF_TORCH.update({v: k for k, v in _TORCH_DTYPES.items()})
    return _TORCH_DTYPES


def triton_to_torch_dtype(dtype: str) -> Optional[torch.dtype]:
    """Map a Triton v2 dtype string to a torch dtype (None for BYTES and
    unknown types)."""
    return _torch_dtypes().get(dtype)


def torch_to_triton_dtype(dtype: torch.dtype) -> Optional[str]:
    """Map a torch dtype to its Triton v2 dtype string (None if unknown)."""
    _torch_dtypes()
    return _TRITON_OF_TORCH.get(dtype)


def typed_view(region: torch.Tensor, dtype: torch.dtype, shape,
               offset: int = 0) -> torch.Tensor:
    """``shape`` elements of ``dtype`` at byte ``offset`` of the contiguous
    ``torch.uint8`` tensor ``region``: a view of the same memory, or a copy
    where ``offset`` is not a multiple of the item size (a view must be
    aligned).  Raises ValueError where the bytes run past the region."""
    shape = tuple(int(d) for d in shape)
    itemsize = dtype.itemsize
    nbytes = itemsize * math.prod(shape)
    if offset < 0 or offset + nbytes > region.numel():
        raise ValueError(
            f"{nbytes} bytes at offset {offset} run past the region's "
            f"{region.numel()} bytes")
    raw = region[offset:offset + nbytes]
    if offset % itemsize:
        raw = raw.clone()
    return raw.view(dtype).view(shape)


def np_to_triton_dtype(np_dtype) -> Optional[str]:
    """Map a numpy dtype to its Triton v2 dtype string."""
    dt = np.dtype(np_dtype)
    if dt in _NP_TO_TRITON:
        return _NP_TO_TRITON[dt]
    if dt.kind in ("O", "S", "U"):
        return "BYTES"
    return None


def triton_to_np_dtype(dtype: str):
    """Map a Triton v2 dtype string to a numpy dtype (None if unknown)."""
    return _TRITON_TO_NP.get(dtype, None)


def _encode_bytes_element(obj) -> bytes:
    if isinstance(obj, bytes):
        return obj
    if isinstance(obj, (bytearray, memoryview)):
        return bytes(obj)
    if isinstance(obj, str):
        return obj.encode("utf-8")
    return str(obj).encode("utf-8")


def serialize_byte_tensor_raw(input_tensor: np.ndarray) -> bytearray:
    """A BYTES tensor (object array of bytes/str, or an ``S``/``U`` array)
    as one length-prefixed wire buffer, each element copied once."""
    if input_tensor.dtype != np.dtype(np.object_) \
            and input_tensor.dtype.kind not in ("S", "U"):
        raise ValueError("cannot serialize bytes tensor: invalid datatype")
    if input_tensor.size == 0:
        return bytearray()
    encoded = [_encode_bytes_element(obj)
               for obj in input_tensor.flatten(order="C")]
    buf = bytearray(4 * len(encoded) + sum(len(b) for b in encoded))
    offset = 0
    for b in encoded:
        struct.pack_into("<I", buf, offset, len(b))
        offset += 4
        buf[offset:offset + len(b)] = b
        offset += len(b)
    return buf


def serialize_byte_tensor(input_tensor: np.ndarray) -> np.ndarray:
    """:func:`serialize_byte_tensor_raw` as a 1-D uint8 array (an empty
    object array for an empty tensor, as the reference returns)."""
    if input_tensor.size == 0:
        return np.empty([0], dtype=np.object_)
    return np.frombuffer(serialize_byte_tensor_raw(input_tensor),
                         dtype=np.uint8)


def deserialize_bytes_tensor(encoded_tensor,
                             count: Optional[int] = None) -> np.ndarray:
    """A BYTES wire buffer as a 1-D object array of ``bytes`` (the caller
    reshapes), decoded to the buffer's end, or ``count`` elements and the
    rest ignored (a shared-memory region may be larger than its tensor).
    A truncated buffer raises ValueError."""
    strs = []
    mv = memoryview(encoded_tensor)
    offset, n = 0, len(mv)
    while offset < n if count is None else len(strs) < count:
        if offset + 4 > n:
            raise ValueError("unexpected end of serialized BYTES tensor")
        (length,) = struct.unpack_from("<I", mv, offset)
        offset += 4
        if offset + length > n:
            raise ValueError(
                "unexpected end of serialized BYTES tensor element")
        strs.append(bytes(mv[offset:offset + length]))
        offset += length
    return np.array(strs, dtype=np.object_)


def serialize_bf16_tensor(input_tensor: np.ndarray) -> np.ndarray:
    """A tensor as raw little-endian bfloat16 bytes (a 1-D uint8 array).

    A ``ml_dtypes.bfloat16`` array is viewed without a copy; a float32
    array is truncated to its top two bytes, bit for bit as the original
    client serializes it."""
    if _BF16_NP is not None and input_tensor.dtype == _BF16_NP:
        return np.ascontiguousarray(input_tensor).view(np.uint8).reshape(-1)
    if input_tensor.dtype != np.dtype(np.float32):
        raise_error("cannot serialize bf16 tensor: invalid datatype")
    as_u16 = (np.ascontiguousarray(input_tensor).view(np.uint32)
              >> 16).astype(np.uint16)
    return as_u16.view(np.uint8).reshape(-1)


def deserialize_bf16_tensor(encoded_tensor) -> np.ndarray:
    """Raw bf16 bytes as a 1-D array: bfloat16 where ``ml_dtypes`` is
    installed, else widened to float32.  The caller reshapes."""
    if _BF16_NP is not None:
        return np.frombuffer(encoded_tensor, dtype=_BF16_NP)
    as_u16 = np.frombuffer(encoded_tensor, dtype=np.uint16)
    return (as_u16.astype(np.uint32) << 16).view(np.float32)


def bf16_from_bytes(encoded_tensor, shape) -> torch.Tensor:
    """Raw little-endian bf16 bytes as a ``torch.bfloat16`` CPU tensor of
    ``shape`` (one copy: the wire buffer may be read-only)."""
    import torch

    bits = np.frombuffer(encoded_tensor, dtype=np.int16).copy()
    return torch.from_numpy(bits).view(torch.bfloat16).reshape(
        tuple(shape))


def bf16_to_bytes(tensor: torch.Tensor) -> np.ndarray:
    """A ``torch.bfloat16`` tensor's raw little-endian bytes, from its own
    bits (``view(torch.int16)``, no float32 detour), as a 1-D uint8 array:
    a view where the tensor is a contiguous CPU tensor."""
    import torch

    bits = tensor.detach().contiguous().view(torch.int16).cpu()
    return bits.numpy().view(np.uint8).reshape(-1)


def as_wire_memoryview(arr: np.ndarray) -> memoryview:
    """A flat ``B``-format memoryview of ``arr``'s bytes: a view where
    ``arr`` is C-contiguous, else of one contiguous copy.  The caller must
    not change the array until the request that carries it is sent."""
    a = arr if arr.flags["C_CONTIGUOUS"] else np.ascontiguousarray(arr)
    return memoryview(a).cast("B")


def wire_length(raw) -> int:
    """Byte length of a wire payload: ``bytes``, ``bytearray`` or a
    ``B``-format memoryview."""
    if isinstance(raw, memoryview):
        return raw.nbytes
    return len(raw)


def serialized_byte_size(np_array: np.ndarray) -> int:
    """Bytes of a tensor as it travels on the wire."""
    if np_array.dtype == np.object_ or np_array.dtype.kind in ("S", "U"):
        return serialize_byte_tensor(np_array).size
    return np_array.nbytes
