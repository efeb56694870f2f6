"""The debug RPCs' messages, for the port's proto3 codec.

The port's copy of ``triton_client_tpu/protocol/debug_pb2.py`` (``package
inference``, wire-identical to what protoc makes of)::

    message FlightRecorderRequest { string model_name = 1; uint32 limit = 2; }
    message FlightRecorderResponse { string payload_json = 1; }
    message DeviceStatsRequest { string model_name = 1; }
    message DeviceStatsResponse { string payload_json = 1; }
    message CostsRequest { string model_name = 1; }
    message CostsResponse { string payload_json = 1; }

Each response carries its debug snapshot as the JSON the HTTP route
serves, as in the reference.
"""

from __future__ import annotations

from typing import Dict, List

from ._proto3 import Field, message_class, resolve
from .inference import PACKAGE

TABLE: Dict[str, List[Field]] = {
    "FlightRecorderRequest": [Field(1, "model_name", "string"),
                              Field(2, "limit", "uint32")],
    "FlightRecorderResponse": [Field(1, "payload_json", "string")],
    "DeviceStatsRequest": [Field(1, "model_name", "string")],
    "DeviceStatsResponse": [Field(1, "payload_json", "string")],
    "CostsRequest": [Field(1, "model_name", "string")],
    "CostsResponse": [Field(1, "payload_json", "string")],
}

MESSAGES: Dict[str, type] = {
    name: message_class(f"{PACKAGE}.{name}", fields)
    for name, fields in TABLE.items()}
resolve(MESSAGES, {})
globals().update(MESSAGES)
