"""Auth plugins of the aio gRPC client (reference
``tritonclient/grpc/aio/auth``)."""

from ...._auth import BasicAuth

__all__ = ["BasicAuth"]
