"""The FLOP and byte count a cost analysis holds open on this thread, and
the kernels' reports into it.

A hand kernel is a ctypes launch, outside PyTorch's dispatcher, so the
dispatch modes that count a forward (``server/costs.py``) never see it.
So each kernel reports its own work while a count is open: the wrapper's
CUDA path and the plain version each run inside :func:`kernel`, which adds
the kernel's formula (the one ``chip_smoke.py`` bounds it with) to the
count and turns the dispatch modes off for the body.  A forward then
counts the same FLOPs and bytes whichever implementation ran: the plain
flash attention computes the full masked S x S, the kernel skips the upper
triangle, and both count the triangle.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional

_ACTIVE = threading.local()


class KernelCount:
    """The kernels' reports of one counted execution: FLOPs and bytes."""

    __slots__ = ("flops", "bytes")

    def __init__(self) -> None:
        self.flops = 0.0
        self.bytes = 0.0


def active() -> Optional[KernelCount]:
    """The count open on this thread, or None."""
    return getattr(_ACTIVE, "count", None)


@contextlib.contextmanager
def counting(count: KernelCount) -> Iterator[KernelCount]:
    """Open ``count`` on this thread for the body."""
    prev = active()
    _ACTIVE.count = count
    try:
        yield count
    finally:
        _ACTIVE.count = prev


@contextlib.contextmanager
def kernel(flops: float, nbytes: float) -> Iterator[None]:
    """Run a kernel's body (its launch, or its plain version) as one
    counted kernel: where a count is open, add ``flops`` and ``nbytes`` to
    it and keep the body's own PyTorch ops out of it."""
    count = active()
    if count is None:
        yield
        return
    count.flops += flops
    count.bytes += nbytes
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        yield
