"""HTTP-protocol ``InferRequestedOutput`` (counterpart of
``triton_client_tpu/http/_requested_output.py``): the binary_data flag, a
classification count, or a shared-memory region, which replaces the
binary_data flag."""

from __future__ import annotations


class InferRequestedOutput:
    def __init__(self, name: str, binary_data: bool = True,
                 class_count: int = 0):
        self._name = name
        self._parameters: dict = {}
        self._binary = binary_data
        if class_count != 0:
            self._parameters["classification"] = class_count
        self._parameters["binary_data"] = binary_data

    def name(self) -> str:
        return self._name

    def set_shared_memory(self, region_name: str, byte_size: int,
                          offset: int = 0):
        """Have the output written into a registered region (it then
        carries no binary_data flag)."""
        self._parameters.pop("binary_data", None)
        self._parameters["shared_memory_region"] = region_name
        self._parameters["shared_memory_byte_size"] = byte_size
        if offset != 0:
            self._parameters["shared_memory_offset"] = offset
        return self

    def unset_shared_memory(self):
        """Drop the region; the binary_data flag comes back."""
        self._parameters.pop("shared_memory_region", None)
        self._parameters.pop("shared_memory_byte_size", None)
        self._parameters.pop("shared_memory_offset", None)
        self._parameters["binary_data"] = self._binary
        return self

    def _get_tensor(self) -> dict:
        tensor = {"name": self._name}
        if self._parameters:
            tensor["parameters"] = dict(self._parameters)
        return tensor
