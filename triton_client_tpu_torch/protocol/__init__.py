"""The v2 gRPC protocol of the port: its own proto3 codec (``_proto3``),
the messages of ``inference.proto`` (``inference``) and the service's
method table (``service``), with no ``protobuf`` or ``grpc``."""
