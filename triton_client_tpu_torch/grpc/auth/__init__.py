"""Auth plugins of the gRPC client (reference ``tritonclient/grpc/auth``)."""

from ..._auth import BasicAuth

__all__ = ["BasicAuth"]
