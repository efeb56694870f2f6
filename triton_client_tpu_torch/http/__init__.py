"""HTTP/REST client of the v2 inference protocol (counterpart of
``triton_client_tpu.http``); its asyncio client is ``http.aio``, on the
port's own HTTP/1.1 over ``asyncio`` streams (the card's machine has no
``aiohttp``)."""

from .._auth import BasicAuth  # noqa: F401 (exported as the reference does)
from ._client import (InferAsyncRequest, InferenceServerClient,
                      PreparedRequest)
from ._infer_input import InferInput
from ._infer_result import InferResult
from ._requested_output import InferRequestedOutput

__all__ = [
    "InferenceServerClient",
    "InferAsyncRequest",
    "InferInput",
    "InferRequestedOutput",
    "InferResult",
    "PreparedRequest",
]
