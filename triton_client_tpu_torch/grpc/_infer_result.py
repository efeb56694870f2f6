"""gRPC-protocol ``InferResult`` (counterpart of
``triton_client_tpu/grpc/_infer_result.py``): outputs read positionally
from ``raw_output_contents`` (views of the response, not copies); the JSON
forms are ``MessageToDict(..., preserving_proto_field_name=True)``."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..protocol._proto3 import to_dict
from ..utils import (deserialize_bf16_tensor, deserialize_bytes_tensor,
                     triton_to_np_dtype)


class InferResult:
    def __init__(self, result):
        self._result = result

    def as_numpy(self, name: str) -> Optional[np.ndarray]:
        """The named output as a numpy array (read-only where numeric: a
        view of the response), or None where the response has no such
        output or its data lies in a shared-memory region."""
        for index, output in enumerate(self._result.outputs):
            if output.name != name:
                continue
            if index >= len(self._result.raw_output_contents):
                return None
            buf = self._result.raw_output_contents[index]
            if not len(buf) and "shared_memory_region" in output.parameters:
                return None  # the data lies in the region
            shape = [int(s) for s in output.shape]
            if output.datatype == "BYTES":
                return deserialize_bytes_tensor(buf).reshape(shape)
            if output.datatype == "BF16":
                return deserialize_bf16_tensor(buf).reshape(shape)
            dt = triton_to_np_dtype(output.datatype)
            if dt is None:
                return None
            return np.frombuffer(buf, dtype=dt).reshape(shape)
        return None

    def get_output(self, name: str, as_json: bool = False):
        """The output message (or its JSON dict) by name, or None."""
        for output in self._result.outputs:
            if output.name == name:
                return to_dict(output) if as_json else output
        return None

    def get_response(self, as_json: bool = False):
        """The ``ModelInferResponse`` (or its JSON dict)."""
        return to_dict(self._result) if as_json else self._result
