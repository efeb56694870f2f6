"""The request a client plugin sees (counterpart of
``triton_client_tpu/_request.py``): only its headers, which the plugin may
change in place."""

from __future__ import annotations

from typing import Dict


class Request:
    def __init__(self, headers: Dict[str, str]):
        self.headers = headers
