"""The messages of the v2 gRPC protocol (``package inference``), for the
port's own proto3 codec (``_proto3.py``).

The port's copy of ``triton_client_tpu/protocol/inference.proto``: every
message there -- the service messages and the ``ModelConfig`` family --
built from the one field table below (number, name, type, label, message
or enum type, oneof).  Nested messages are attributes of their parent, as
in generated code (``ModelInferRequest.InferInputTensor``).  The debug
messages of the reference's ``debug_pb2.py`` are in ``debug.py``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ._proto3 import MAP, Field, message_class, resolve

PACKAGE = "inference"

R = True  # repeated


def F(number, name, type_, repeated=False, oneof=None) -> Field:
    return Field(number, name, type_, repeated, oneof)


def _param_oneof(*members) -> List[Field]:
    return [F(n, name, t, oneof="parameter_choice") for n, name, t in members]


#: message full name (without the package) -> its fields
TABLE: Dict[str, List[Field]] = {
    "ServerLiveRequest": [],
    "ServerLiveResponse": [F(1, "live", "bool")],
    "ServerReadyRequest": [],
    "ServerReadyResponse": [F(1, "ready", "bool")],
    "ModelReadyRequest": [F(1, "name", "string"), F(2, "version", "string")],
    "ModelReadyResponse": [F(1, "ready", "bool")],
    "ServerMetadataRequest": [],
    "ServerMetadataResponse": [
        F(1, "name", "string"), F(2, "version", "string"),
        F(3, "extensions", "string", R)],
    "ModelMetadataRequest": [F(1, "name", "string"),
                             F(2, "version", "string")],
    "ModelMetadataResponse.TensorMetadata": [
        F(1, "name", "string"), F(2, "datatype", "string"),
        F(3, "shape", "int64", R)],
    "ModelMetadataResponse": [
        F(1, "name", "string"), F(2, "versions", "string", R),
        F(3, "platform", "string"),
        F(4, "inputs", "ModelMetadataResponse.TensorMetadata", R),
        F(5, "outputs", "ModelMetadataResponse.TensorMetadata", R)],
    "InferParameter": _param_oneof(
        (1, "bool_param", "bool"), (2, "int64_param", "int64"),
        (3, "string_param", "string"), (4, "double_param", "double"),
        (5, "uint64_param", "uint64")),
    "InferTensorContents": [
        F(1, "bool_contents", "bool", R), F(2, "int_contents", "int32", R),
        F(3, "int64_contents", "int64", R),
        F(4, "uint_contents", "uint32", R),
        F(5, "uint64_contents", "uint64", R),
        F(6, "fp32_contents", "float", R), F(7, "fp64_contents", "double", R),
        F(8, "bytes_contents", "bytes", R)],
    "ModelInferRequest.InferInputTensor": [
        F(1, "name", "string"), F(2, "datatype", "string"),
        F(3, "shape", "int64", R),
        F(4, "parameters", MAP("string", "InferParameter")),
        F(5, "contents", "InferTensorContents")],
    "ModelInferRequest.InferRequestedOutputTensor": [
        F(1, "name", "string"),
        F(2, "parameters", MAP("string", "InferParameter"))],
    "ModelInferRequest": [
        F(1, "model_name", "string"), F(2, "model_version", "string"),
        F(3, "id", "string"),
        F(4, "parameters", MAP("string", "InferParameter")),
        F(5, "inputs", "ModelInferRequest.InferInputTensor", R),
        F(6, "outputs", "ModelInferRequest.InferRequestedOutputTensor", R),
        F(7, "raw_input_contents", "bytes", R)],
    "ModelInferResponse.InferOutputTensor": [
        F(1, "name", "string"), F(2, "datatype", "string"),
        F(3, "shape", "int64", R),
        F(4, "parameters", MAP("string", "InferParameter")),
        F(5, "contents", "InferTensorContents")],
    "ModelInferResponse": [
        F(1, "model_name", "string"), F(2, "model_version", "string"),
        F(3, "id", "string"),
        F(4, "parameters", MAP("string", "InferParameter")),
        F(5, "outputs", "ModelInferResponse.InferOutputTensor", R),
        F(6, "raw_output_contents", "bytes", R)],
    "ModelStreamInferResponse": [
        F(1, "error_message", "string"),
        F(2, "infer_response", "ModelInferResponse")],
    "ModelConfigRequest": [F(1, "name", "string"),
                           F(2, "version", "string")],
    "ModelConfigResponse": [F(1, "config", "ModelConfig")],
    "ModelStatisticsRequest": [F(1, "name", "string"),
                               F(2, "version", "string")],
    "StatisticDuration": [F(1, "count", "uint64"), F(2, "ns", "uint64")],
    "InferStatistics": [
        F(1, "success", "StatisticDuration"), F(2, "fail", "StatisticDuration"),
        F(3, "queue", "StatisticDuration"),
        F(4, "compute_input", "StatisticDuration"),
        F(5, "compute_infer", "StatisticDuration"),
        F(6, "compute_output", "StatisticDuration")],
    "InferBatchStatistics": [
        F(1, "batch_size", "uint64"),
        F(2, "compute_input", "StatisticDuration"),
        F(3, "compute_infer", "StatisticDuration"),
        F(4, "compute_output", "StatisticDuration")],
    "ModelStatistics": [
        F(1, "name", "string"), F(2, "version", "string"),
        F(3, "last_inference", "uint64"), F(4, "inference_count", "uint64"),
        F(5, "execution_count", "uint64"),
        F(6, "inference_stats", "InferStatistics"),
        F(7, "batch_stats", "InferBatchStatistics", R)],
    "ModelStatisticsResponse": [F(1, "model_stats", "ModelStatistics", R)],
    "RepositoryIndexRequest": [F(1, "repository_name", "string"),
                               F(2, "ready", "bool")],
    "RepositoryIndexResponse.ModelIndex": [
        F(1, "name", "string"), F(2, "version", "string"),
        F(3, "state", "string"), F(4, "reason", "string")],
    "RepositoryIndexResponse": [
        F(1, "models", "RepositoryIndexResponse.ModelIndex", R)],
    "ModelRepositoryParameter": _param_oneof(
        (1, "bool_param", "bool"), (2, "int64_param", "int64"),
        (3, "string_param", "string"), (4, "bytes_param", "bytes")),
    "RepositoryModelLoadRequest": [
        F(1, "repository_name", "string"), F(2, "model_name", "string"),
        F(3, "parameters", MAP("string", "ModelRepositoryParameter"))],
    "RepositoryModelLoadResponse": [],
    "RepositoryModelUnloadRequest": [
        F(1, "repository_name", "string"), F(2, "model_name", "string"),
        F(3, "parameters", MAP("string", "ModelRepositoryParameter"))],
    "RepositoryModelUnloadResponse": [],
    "SystemSharedMemoryStatusRequest": [F(1, "name", "string")],
    "SystemSharedMemoryStatusResponse.RegionStatus": [
        F(1, "name", "string"), F(2, "key", "string"),
        F(3, "offset", "uint64"), F(4, "byte_size", "uint64")],
    "SystemSharedMemoryStatusResponse": [
        F(1, "regions", MAP("string",
                            "SystemSharedMemoryStatusResponse.RegionStatus"))],
    "SystemSharedMemoryRegisterRequest": [
        F(1, "name", "string"), F(2, "key", "string"),
        F(3, "offset", "uint64"), F(4, "byte_size", "uint64")],
    "SystemSharedMemoryRegisterResponse": [],
    "SystemSharedMemoryUnregisterRequest": [F(1, "name", "string")],
    "SystemSharedMemoryUnregisterResponse": [],
    "CudaSharedMemoryStatusRequest": [F(1, "name", "string")],
    "CudaSharedMemoryStatusResponse.RegionStatus": [
        F(1, "name", "string"), F(2, "device_id", "uint64"),
        F(3, "byte_size", "uint64")],
    "CudaSharedMemoryStatusResponse": [
        F(1, "regions", MAP("string",
                            "CudaSharedMemoryStatusResponse.RegionStatus"))],
    "CudaSharedMemoryRegisterRequest": [
        F(1, "name", "string"), F(2, "raw_handle", "bytes"),
        F(3, "device_id", "int64"), F(4, "byte_size", "uint64")],
    "CudaSharedMemoryRegisterResponse": [],
    "CudaSharedMemoryUnregisterRequest": [F(1, "name", "string")],
    "CudaSharedMemoryUnregisterResponse": [],
    "TraceSettingRequest.SettingValue": [F(1, "value", "string", R)],
    "TraceSettingRequest": [
        F(1, "settings", MAP("string", "TraceSettingRequest.SettingValue")),
        F(2, "model_name", "string")],
    "TraceSettingResponse.SettingValue": [F(1, "value", "string", R)],
    "TraceSettingResponse": [
        F(1, "settings", MAP("string", "TraceSettingResponse.SettingValue"))],
    "LogSettingsRequest.SettingValue": _param_oneof(
        (1, "bool_param", "bool"), (2, "uint32_param", "uint32"),
        (3, "string_param", "string")),
    "LogSettingsRequest": [
        F(1, "settings", MAP("string", "LogSettingsRequest.SettingValue"))],
    "LogSettingsResponse.SettingValue": _param_oneof(
        (1, "bool_param", "bool"), (2, "uint32_param", "uint32"),
        (3, "string_param", "string")),
    "LogSettingsResponse": [
        F(1, "settings", MAP("string", "LogSettingsResponse.SettingValue"))],
    # -- the model configuration --------------------------------------------
    "ModelInput": [
        F(1, "name", "string"), F(2, "data_type", "DataType"),
        F(3, "dims", "int64", R), F(4, "optional", "bool"),
        F(5, "allow_ragged_batch", "bool")],
    "ModelOutput": [
        F(1, "name", "string"), F(2, "data_type", "DataType"),
        F(3, "dims", "int64", R), F(4, "label_filename", "string")],
    "ModelVersionPolicy.Latest": [F(1, "num_versions", "uint32")],
    "ModelVersionPolicy.All": [],
    "ModelVersionPolicy.Specific": [F(1, "versions", "int64", R)],
    "ModelVersionPolicy": [
        F(1, "latest", "ModelVersionPolicy.Latest", oneof="policy_choice"),
        F(2, "all", "ModelVersionPolicy.All", oneof="policy_choice"),
        F(3, "specific", "ModelVersionPolicy.Specific",
          oneof="policy_choice")],
    "ModelInstanceGroup": [
        F(1, "name", "string"), F(2, "kind", "ModelInstanceGroup.Kind"),
        F(3, "count", "int32"), F(4, "gpus", "int32", R)],
    "ModelDynamicBatching": [
        F(1, "preferred_batch_size", "int32", R),
        F(2, "max_queue_delay_microseconds", "uint64"),
        F(3, "preserve_ordering", "bool")],
    "ModelSequenceBatching.Control": [
        F(1, "kind", "ModelSequenceBatching.Control.Kind"),
        F(2, "int32_false_true", "int32", R),
        F(3, "fp32_false_true", "float", R),
        F(4, "bool_false_true", "bool", R),
        F(5, "data_type", "DataType")],
    "ModelSequenceBatching.ControlInput": [
        F(1, "name", "string"),
        F(2, "control", "ModelSequenceBatching.Control", R)],
    "ModelSequenceBatching": [
        F(1, "max_sequence_idle_microseconds", "uint64"),
        F(2, "control_input", "ModelSequenceBatching.ControlInput", R)],
    "ModelEnsembling.Step": [
        F(1, "model_name", "string"), F(2, "model_version", "int64"),
        F(3, "input_map", MAP("string", "string")),
        F(4, "output_map", MAP("string", "string"))],
    "ModelEnsembling": [F(1, "step", "ModelEnsembling.Step", R)],
    "ModelParameter": [F(1, "string_value", "string")],
    "ModelWarmup.Input": [
        F(1, "data_type", "DataType"), F(2, "dims", "int64", R),
        F(3, "zero_data", "bool", oneof="input_data_type"),
        F(4, "random_data", "bool", oneof="input_data_type"),
        F(5, "input_data_file", "string", oneof="input_data_type")],
    "ModelWarmup": [
        F(1, "name", "string"), F(2, "batch_size", "uint32"),
        F(3, "inputs", MAP("string", "ModelWarmup.Input")),
        F(4, "count", "uint32")],
    "ModelTransactionPolicy": [F(1, "decoupled", "bool")],
    "ModelConfig": [
        F(1, "name", "string"), F(2, "platform", "string"),
        F(3, "backend", "string"), F(4, "max_batch_size", "int32"),
        F(5, "input", "ModelInput", R), F(6, "output", "ModelOutput", R),
        F(7, "version_policy", "ModelVersionPolicy"),
        F(8, "instance_group", "ModelInstanceGroup", R),
        F(9, "dynamic_batching", "ModelDynamicBatching"),
        F(10, "sequence_batching", "ModelSequenceBatching"),
        F(11, "ensemble_scheduling", "ModelEnsembling"),
        F(12, "parameters", MAP("string", "ModelParameter")),
        F(13, "model_transaction_policy", "ModelTransactionPolicy"),
        F(14, "default_model_filename", "string"),
        F(15, "response_cache", "ModelResponseCache"),
        F(16, "model_warmup", "ModelWarmup", R)],
    "ModelResponseCache": [F(1, "enable", "bool")],
}

#: enum full name -> {value name: number}
ENUMS: Dict[str, Dict[str, int]] = {
    "DataType": {name: i for i, name in enumerate((
        "TYPE_INVALID", "TYPE_BOOL", "TYPE_UINT8", "TYPE_UINT16",
        "TYPE_UINT32", "TYPE_UINT64", "TYPE_INT8", "TYPE_INT16",
        "TYPE_INT32", "TYPE_INT64", "TYPE_FP16", "TYPE_FP32", "TYPE_FP64",
        "TYPE_STRING", "TYPE_BF16"))},
    "ModelInstanceGroup.Kind": {"KIND_AUTO": 0, "KIND_GPU": 1,
                                "KIND_CPU": 2, "KIND_MODEL": 3,
                                "KIND_TPU": 4},
    "ModelSequenceBatching.Control.Kind": {
        "CONTROL_SEQUENCE_START": 0, "CONTROL_SEQUENCE_READY": 1,
        "CONTROL_SEQUENCE_END": 2, "CONTROL_SEQUENCE_CORRID": 3},
}


def _build() -> Dict[str, type]:
    classes = {name: message_class(f"{PACKAGE}.{name}", fields)
               for name, fields in TABLE.items()}
    resolve(classes, ENUMS)
    # nested classes as attributes of their parents
    for name, cls in classes.items():
        parent, _, child = name.rpartition(".")
        if parent:
            setattr(classes[parent], child, cls)
    return classes


MESSAGES: Dict[str, type] = _build()
globals().update({name: cls for name, cls in MESSAGES.items()
                  if "." not in name})


def enum_value(enum: str, name: str) -> int:
    return ENUMS[enum][name]


def field_table() -> Dict[str, List[Tuple]]:
    """Each message's fields as (number, name, type, repeated, oneof) rows,
    maps as ``("map", key type, value type)``: what the tests hold against
    the reference's descriptors."""
    return {f"{PACKAGE}.{name}": [
        (f.number, f.name,
         ("map", f.type.key, f.type.value) if isinstance(f.type, MAP)
         else f.type, f.repeated, f.oneof)
        for f in cls.FIELDS] for name, cls in MESSAGES.items()}
