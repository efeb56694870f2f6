"""Auth plugins of the aio HTTP client (reference
``tritonclient/http/aio/auth``)."""

from ...._auth import BasicAuth

__all__ = ["BasicAuth"]
