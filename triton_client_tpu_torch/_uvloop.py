"""Optional uvloop for the port's asyncio clients (counterpart of
``triton_client_tpu/_uvloop.py``).

The stdlib event loop is the default and the wire behaviour is the same
either way.  A library must not swap its importer's event-loop policy
behind its back, so activation is explicit (``install_uvloop()``) or
opted into with ``TRITON_TPU_UVLOOP=1`` when an aio client module is
imported.  Both return False where uvloop is not installed.
"""

from __future__ import annotations

import os

__all__ = ["install_uvloop", "maybe_install_uvloop", "uvloop_active"]

_active = False


def install_uvloop() -> bool:
    """Make uvloop the asyncio event-loop policy: True where it is
    installed and now active, False where it is not."""
    global _active
    try:
        import asyncio

        import uvloop
    except ImportError:
        return False
    asyncio.set_event_loop_policy(uvloop.EventLoopPolicy())
    _active = True
    return True


def maybe_install_uvloop() -> bool:
    """``install_uvloop()`` under ``TRITON_TPU_UVLOOP=1`` (or ``true``,
    ``on``); nothing without it."""
    if os.environ.get("TRITON_TPU_UVLOOP", "") not in ("1", "true", "on"):
        return False
    return install_uvloop()


def uvloop_active() -> bool:
    return _active
