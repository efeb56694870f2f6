"""Parallelism primitives of the port (single device in this slice)."""

from .collectives import ring_attention

__all__ = ["ring_attention"]
