"""HTTP-protocol ``InferInput`` (counterpart of
``triton_client_tpu/http/_infer_input.py``): tensor data as JSON or binary
(binary by default), BYTES as UTF-8 strings in JSON or length-prefixed in
binary, BF16 in binary only, or a shared-memory region in place of data."""

from __future__ import annotations

from typing import List

import numpy as np

from ..utils import (as_wire_memoryview, np_to_triton_dtype, raise_error,
                     serialize_bf16_tensor, serialize_byte_tensor_raw,
                     wire_length)

_SHM_PARAMETERS = ("shared_memory_region", "shared_memory_byte_size",
                   "shared_memory_offset")


class InferInput:
    """An input tensor of an inference request.

    On the binary path ``set_data_from_numpy`` keeps a view of a
    fixed-size array, not a copy: the bytes are gathered when the request
    body is.  The caller must not change the array before the request is
    sent (``async_infer`` copies it at submission)."""

    def __init__(self, name: str, shape: List[int], datatype: str):
        self._name = name
        self._shape = list(shape)
        self._datatype = datatype
        self._parameters: dict = {}
        self._data = None      # JSON path: a flat list
        # binary path: bytes, a bytearray (BYTES) or a B-format memoryview
        self._raw_data = None
        # bumped by set_shape, so a request template sees a shape change
        # with one integer compare
        self._shape_epoch = 0

    def name(self) -> str:
        return self._name

    def datatype(self) -> str:
        return self._datatype

    def shape(self) -> List[int]:
        return self._shape

    def set_shape(self, shape: List[int]) -> "InferInput":
        self._shape = list(shape)
        self._shape_epoch += 1
        return self

    def set_data_from_numpy(self, input_tensor: np.ndarray,
                            binary_data: bool = True):
        """Attach the tensor's data, binary (default) or JSON.  Its dtype
        and shape must be the input's (a float32 array may stand for BF16,
        truncated); BF16 must be binary."""
        if not isinstance(input_tensor, np.ndarray):
            raise_error("input_tensor must be a numpy array")
        dtype = np_to_triton_dtype(input_tensor.dtype)
        if self._datatype != dtype and not (self._datatype == "BF16"
                                            and dtype == "FP32"):
            raise_error(f"got unexpected datatype {dtype} from numpy array, "
                        f"expected {self._datatype}")
        if list(input_tensor.shape) != list(self._shape):
            raise_error(
                "got unexpected numpy array shape "
                f"[{str(input_tensor.shape)[1:-1]}], "
                f"expected [{str(self._shape)[1:-1]}]")

        for key in _SHM_PARAMETERS:
            self._parameters.pop(key, None)

        if not binary_data:
            if self._datatype == "BF16":
                raise_error("BF16 inputs must use binary_data=True")
            self._parameters.pop("binary_data_size", None)
            self._raw_data = None
            if self._datatype == "BYTES":
                try:
                    self._data = [
                        v.decode("utf-8") if isinstance(v, bytes) else str(v)
                        for v in (x.item() for x in np.nditer(
                            input_tensor, flags=["refs_ok"], order="C"))
                    ] if input_tensor.size > 0 else []
                except UnicodeDecodeError:
                    raise_error(
                        f'Failed to encode "{self._name}" using UTF-8. '
                        "Please use binary_data=True, if you want to pass a "
                        "byte array.")
            else:
                self._data = [v.item()
                              for v in input_tensor.flatten(order="C")]
        else:
            self._data = None
            if self._datatype == "BYTES":
                self._raw_data = serialize_byte_tensor_raw(input_tensor)
            elif self._datatype == "BF16":
                self._raw_data = as_wire_memoryview(
                    serialize_bf16_tensor(input_tensor))
            else:
                self._raw_data = as_wire_memoryview(input_tensor)
            self._parameters["binary_data_size"] = wire_length(self._raw_data)
        return self

    def set_shared_memory(self, region_name: str, byte_size: int,
                          offset: int = 0):
        """Take the tensor from a registered region; drops any data."""
        self._data = None
        self._raw_data = None
        self._parameters.pop("binary_data_size", None)
        self._parameters["shared_memory_region"] = region_name
        self._parameters["shared_memory_byte_size"] = byte_size
        if offset != 0:
            self._parameters["shared_memory_offset"] = offset
        return self

    def _get_tensor(self) -> dict:
        tensor = {"name": self._name, "shape": self._shape,
                  "datatype": self._datatype}
        if self._parameters:
            tensor["parameters"] = dict(self._parameters)
        if self._data is not None:
            tensor["data"] = self._data
        return tensor

    def _get_binary_data(self):
        """The wire payload (bytes, bytearray or B-format memoryview), or
        None on the JSON and shared-memory paths."""
        return self._raw_data

    def _freeze_raw(self) -> None:
        """Replace a view of the caller's array with a copy of its bytes
        (``async_infer`` gathers the body after it returns)."""
        if isinstance(self._raw_data, memoryview):
            self._raw_data = self._raw_data.tobytes()
