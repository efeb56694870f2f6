"""The port's serving harness: v2 HTTP frontend, inference core with dynamic
batching, model registry and the torch model adapter."""
