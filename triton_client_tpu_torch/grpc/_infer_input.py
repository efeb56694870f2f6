"""gRPC-protocol ``InferInput`` (counterpart of
``triton_client_tpu/grpc/_infer_input.py``): the tensor's raw bytes, which
travel in ``raw_input_contents`` in input order, or a shared-memory region
in place of data.  BYTES elements are length-prefixed; a float32 array may
stand for BF16 (truncated)."""

from __future__ import annotations

from typing import List

import numpy as np

from ..protocol import inference as pb
from ..utils import (as_wire_memoryview, np_to_triton_dtype, raise_error,
                     serialize_bf16_tensor, serialize_byte_tensor_raw)
from ._requested_output import _SHM_PARAMETERS


class InferInput:
    """An input tensor of an inference request.

    ``set_data_from_numpy`` keeps a view of a fixed-size array, not a copy:
    the bytes are gathered when the request is sent.  The caller must not
    change the array before then (``async_infer`` and the stream encode the
    request before they return)."""

    def __init__(self, name: str, shape: List[int], datatype: str):
        self._name = name
        self._shape = [int(s) for s in shape]
        self._datatype = datatype
        self._parameters: dict = {}
        self._raw = None
        # bumped by set_shape, so a request template sees a shape change
        self._shape_epoch = 0

    def name(self) -> str:
        return self._name

    def datatype(self) -> str:
        return self._datatype

    def shape(self) -> List[int]:
        return list(self._shape)

    def set_shape(self, shape: List[int]) -> "InferInput":
        self._shape = [int(s) for s in shape]
        self._shape_epoch += 1
        return self

    def set_data_from_numpy(self, input_tensor: np.ndarray) -> "InferInput":
        """Attach the tensor's data; its dtype and shape must be the
        input's."""
        if not isinstance(input_tensor, np.ndarray):
            raise_error("input_tensor must be a numpy array")
        dtype = np_to_triton_dtype(input_tensor.dtype)
        if self._datatype != dtype and not (self._datatype == "BF16"
                                            and dtype == "FP32"):
            raise_error(f"got unexpected datatype {dtype} from numpy array, "
                        f"expected {self._datatype}")
        if list(input_tensor.shape) != self._shape:
            raise_error(
                "got unexpected numpy array shape "
                f"[{str(input_tensor.shape)[1:-1]}], "
                f"expected [{str(self._shape)[1:-1]}]")
        for key in _SHM_PARAMETERS:
            self._parameters.pop(key, None)
        if self._datatype == "BYTES":
            self._raw = serialize_byte_tensor_raw(input_tensor)
        elif self._datatype == "BF16":
            self._raw = as_wire_memoryview(serialize_bf16_tensor(input_tensor))
        else:
            self._raw = as_wire_memoryview(input_tensor)
        return self

    def set_shared_memory(self, region_name: str, byte_size: int,
                          offset: int = 0) -> "InferInput":
        """Take the tensor from a registered region; drops any data."""
        self._raw = None
        self._parameters["shared_memory_region"] = pb.InferParameter(
            string_param=region_name)
        self._parameters["shared_memory_byte_size"] = pb.InferParameter(
            int64_param=byte_size)
        if offset != 0:
            self._parameters["shared_memory_offset"] = pb.InferParameter(
                int64_param=offset)
        return self

    def _get_tensor_pb(self):
        return pb.ModelInferRequest.InferInputTensor(
            name=self._name, datatype=self._datatype, shape=self._shape,
            parameters=dict(self._parameters))

    def _get_raw_data(self):
        """The payload (a byte memoryview or bytearray), or None for a
        shared-memory input."""
        return self._raw
