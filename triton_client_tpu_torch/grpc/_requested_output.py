"""gRPC-protocol ``InferRequestedOutput`` (counterpart of
``triton_client_tpu/grpc/_requested_output.py``): a classification count or
a shared-memory region."""

from __future__ import annotations

from ..protocol import inference as pb

_SHM_PARAMETERS = ("shared_memory_region", "shared_memory_byte_size",
                   "shared_memory_offset")


class InferRequestedOutput:
    def __init__(self, name: str, class_count: int = 0):
        self._name = name
        self._parameters: dict = {}
        if class_count != 0:
            self._parameters["classification"] = pb.InferParameter(
                int64_param=class_count)

    def name(self) -> str:
        return self._name

    def set_shared_memory(self, region_name: str, byte_size: int,
                          offset: int = 0):
        """Have the output written into a registered region."""
        self._parameters["shared_memory_region"] = pb.InferParameter(
            string_param=region_name)
        self._parameters["shared_memory_byte_size"] = pb.InferParameter(
            int64_param=byte_size)
        if offset != 0:
            self._parameters["shared_memory_offset"] = pb.InferParameter(
                int64_param=offset)
        return self

    def unset_shared_memory(self):
        for key in _SHM_PARAMETERS:
            self._parameters.pop(key, None)
        return self

    def _get_tensor_pb(self):
        return pb.ModelInferRequest.InferRequestedOutputTensor(
            name=self._name, parameters=dict(self._parameters))
