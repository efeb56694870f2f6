"""HTTP client helpers (counterpart of ``triton_client_tpu/http/_utils.py``):
the error of a response, and the infer request body."""

from __future__ import annotations

import json
from typing import Optional, Tuple

from ..utils import InferenceServerException, raise_error

_RESERVED_PARAMETERS = ("sequence_id", "sequence_start", "sequence_end",
                        "priority", "binary_data_output")


def raise_if_error(status: int, body: bytes, headers=None) -> None:
    """Raise :class:`InferenceServerException` for a status outside 2xx,
    with the message of the v2 ``{"error": msg}`` body where there is one
    and the status as a string.  The server's pushback in ``headers``
    (``triton-retry-after-ms``, else ``Retry-After`` in seconds) lands on
    the exception's ``retry_after_s``, which the retry layer honours."""
    if 200 <= status < 300:
        return
    msg = None
    try:
        msg = json.loads(body).get("error")
    except (ValueError, AttributeError):
        msg = body.decode("utf-8", errors="replace") if body else None
    exc = InferenceServerException(
        msg=msg or f"[{status}] inference request failed", status=str(status))
    if headers is not None:
        # the precise horizon wins over the whole seconds beside it
        for key, scale in (("triton-retry-after-ms", 1e-3),
                           ("Retry-After", 1.0)):
            value = headers.get(key)
            if value is None:
                continue
            try:
                exc.retry_after_s = float(value) * scale
            except ValueError:
                continue  # an HTTP date: the jittered backoff covers it
            break
    raise exc


def build_infer_request_dict(inputs, request_id: str, outputs, sequence_id,
                             sequence_start: bool, sequence_end: bool,
                             priority: int, timeout: Optional[int],
                             custom_parameters: Optional[dict]) -> dict:
    """The v2 infer request's JSON header as a dict.  The body function
    below and the request template (``_template.py``) both use it, so the
    two cannot differ in key order or in the reserved parameters."""
    infer_request = {}
    parameters = {}
    if request_id:
        infer_request["id"] = request_id
    if sequence_id:
        parameters["sequence_id"] = sequence_id
        parameters["sequence_start"] = sequence_start
        parameters["sequence_end"] = sequence_end
    if priority:
        parameters["priority"] = priority
    if timeout is not None:
        parameters["timeout"] = timeout

    infer_request["inputs"] = [i._get_tensor() for i in inputs]
    if outputs:
        infer_request["outputs"] = [o._get_tensor() for o in outputs]
    else:
        # no outputs named: every output, binary
        parameters["binary_data_output"] = True

    if custom_parameters:
        for key, value in custom_parameters.items():
            if key in _RESERVED_PARAMETERS:
                raise_error(f"Parameter {key!r} is a reserved parameter and "
                            "cannot be specified.")
            parameters[key] = value
    if parameters:
        infer_request["parameters"] = parameters
    return infer_request


def assemble_body(header: bytes, raws) -> Tuple[bytes, Optional[int]]:
    """The JSON header and the raw tensor payloads gathered into the wire
    body with one copy.  Returns (body, json_size); json_size is None for a
    body of JSON alone."""
    if sum(len(raw) for raw in raws):
        # tpu-lint: disable=WIRE-COPY the single required gather into the wire body
        return b"".join([header, *raws]), len(header)
    return header, None


def get_inference_request_body(inputs, request_id: str, outputs, sequence_id,
                               sequence_start: bool, sequence_end: bool,
                               priority: int, timeout: Optional[int],
                               custom_parameters: Optional[dict]
                               ) -> Tuple[bytes, Optional[int]]:
    """The infer request body: the JSON header, then every binary input's
    raw bytes.  Returns (body, json_size)."""
    infer_request = build_infer_request_dict(
        inputs, request_id, outputs, sequence_id, sequence_start,
        sequence_end, priority, timeout, custom_parameters)
    header = json.dumps(infer_request).encode()
    raws = [raw for raw in (i._get_binary_data() for i in inputs)
            if raw is not None]
    return assemble_body(header, raws)
