"""Auth plugins of the HTTP client (reference ``tritonclient/http/auth``)."""

from ..._auth import BasicAuth

__all__ = ["BasicAuth"]
