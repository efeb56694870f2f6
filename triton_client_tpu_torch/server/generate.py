"""Triton ``generate`` HTTP extension: JSON-first inference.

The port's copy of ``triton_client_tpu/server/generate.py``.
``POST /v2/models/{model}/generate`` and ``.../generate_stream`` take a flat
JSON object (input names to scalar or list values; every other key becomes
a request parameter), run the model, and answer each response as a flat
JSON object; ``generate_stream`` as Server-Sent Events, one ``data:`` frame
per decoupled response (``http_server.py``).
"""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np

from ..utils import triton_to_np_dtype
from .model import Model
from .types import InferError, InferRequest, InputTensor, RequestedOutput

#: the SSE envelope of one frame
SSE_DATA = b"data: "
SSE_END = b"\n\n"


def sse_frame(payload) -> bytes:
    """One SSE ``data:`` frame around a serialized payload (str or bytes)."""
    if isinstance(payload, str):
        payload = payload.encode("utf-8")
    return b"%s%s%s" % (SSE_DATA, payload, SSE_END)


def _fit_shape(name: str, size: int, dims, batched: bool):
    """Fit a flat JSON value of ``size`` elements onto the model's declared
    dims (a batch of 1 prepended for batching models; the first -1
    absorbs the free extent, any other pins to 1)."""
    shape = ([1] if batched else []) + [int(d) for d in dims]
    wild = [i for i, d in enumerate(shape) if d < 0]
    for i in wild[1:]:
        shape[i] = 1
    fixed = 1
    for d in shape:
        if d > 0:
            fixed *= d
    if wild:
        if size % fixed:
            raise InferError(
                f"generate input '{name}': {size} values do not fit dims "
                f"{list(dims)}", 400)
        shape[wild[0]] = size // fixed
        return shape
    if fixed != size:
        raise InferError(
            f"generate input '{name}': expected {fixed} values for dims "
            f"{list(dims)}, got {size}", 400)
    return shape


def build_generate_request(
    model: Model, model_name: str, model_version: str, body: Dict[str, Any]
) -> InferRequest:
    """Map a flat generate JSON body onto an InferRequest: keys naming
    model inputs become tensors (a scalar gets shape [1], a list keeps its
    length; the dtype from the model config), every other key a request
    parameter."""
    if not isinstance(body, dict):
        raise InferError("generate request body must be a JSON object", 400)
    input_specs = {i.name: (i.data_type, list(i.dims))
                   for i in model.config.input}
    batched = model.config.max_batch_size > 0
    inputs = []
    parameters: Dict[str, Any] = {}
    for key, value in body.items():
        if key not in input_specs:
            if isinstance(value, (dict, list)):
                raise InferError(
                    f"generate parameter '{key}' must be a scalar", 400)
            parameters[key] = value
            continue
        dtype, dims = input_specs[key]
        items = value if isinstance(value, list) else [value]
        if dtype == "BYTES":
            arr = np.array(
                [v.encode() if isinstance(v, str) else bytes(v)
                 for v in items], dtype=object)
        else:
            arr = np.array(items, dtype=triton_to_np_dtype(dtype))
        arr = arr.reshape(_fit_shape(key, arr.size, dims, batched))
        inputs.append(InputTensor(
            name=key, datatype=dtype, shape=tuple(arr.shape), data=arr))
    missing = set(input_specs) - {i.name for i in inputs}
    if missing:
        raise InferError(
            f"generate request missing input(s): {', '.join(sorted(missing))}",
            400)
    outputs = [RequestedOutput(name=o.name, binary_data=False)
               for o in model.config.output]
    return InferRequest(
        model_name=model_name, model_version=model_version,
        inputs=inputs, outputs=outputs, parameters=parameters)


def response_to_json(model_name: str, model_version: str, response) -> str:
    """Flatten an InferResponse into the generate JSON shape."""
    out: Dict[str, Any] = {
        "model_name": model_name,
        "model_version": model_version or "1",
    }
    for t in response.outputs:
        arr = t.data
        if arr is None:
            continue
        if hasattr(arr, "float") and not isinstance(arr, np.ndarray):
            arr = arr.float().numpy()          # a BF16 output's tensor
        arr = np.asarray(arr)
        if arr.dtype == object or arr.dtype.kind in ("S", "U"):
            vals = [v.decode("utf-8", "replace") if isinstance(v, bytes)
                    else str(v) for v in arr.reshape(-1)]
        else:
            vals = arr.reshape(-1).tolist()
        out[t.name] = vals[0] if len(vals) == 1 else vals
    return json.dumps(out)


__all__ = ["build_generate_request", "response_to_json", "sse_frame"]
