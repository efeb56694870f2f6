"""HTTP basic-auth plugin (counterpart of ``triton_client_tpu/_auth.py``)."""

from __future__ import annotations

import base64

from ._plugin import InferenceServerClientPlugin
from ._request import Request


class BasicAuth(InferenceServerClientPlugin):
    """Adds ``authorization: Basic <b64(user:pass)>`` to every request."""

    def __init__(self, username: str, password: str):
        encoded = base64.b64encode(
            f"{username}:{password}".encode("utf-8")).decode("ascii")
        self._auth_header = f"Basic {encoded}"

    def __call__(self, request: Request) -> None:
        request.headers["authorization"] = self._auth_header
