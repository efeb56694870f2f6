"""In-process server harness for tests and co-located serving.

Counterpart of ``triton_client_tpu/server/testing.py``'s ``ServerHarness``:
the port's HTTP frontend on a free local port, served from a background
thread of the current process.  While it serves, the CUDA shared-memory
broker's ``server_present`` is set: a region made in this process is read
in place, by uuid.
"""

from __future__ import annotations

import socket
import threading
from typing import Optional

from .._cuda_broker import broker
from .core import InferenceCore
from .http_server import HttpServer
from .registry import ModelRegistry


# broker().server_present is process-global and a process may run several
# harnesses, so it counts them
_PRESENT_LOCK = threading.Lock()
_PRESENT_COUNT = 0


def _server_present(delta: int) -> None:
    global _PRESENT_COUNT
    with _PRESENT_LOCK:
        _PRESENT_COUNT = max(0, _PRESENT_COUNT + delta)
        broker().server_present = _PRESENT_COUNT > 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ServerHarness:
    def __init__(self, registry: Optional[ModelRegistry] = None,
                 http_port: Optional[int] = None, host: str = "127.0.0.1"):
        self.registry = registry or ModelRegistry()
        self.core = InferenceCore(self.registry)
        self.host = host
        self.http_port = http_port or free_port()
        self._server: Optional[HttpServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def http_url(self) -> str:
        return f"{self.host}:{self.http_port}"

    def start(self) -> "ServerHarness":
        self._server = HttpServer(self.core, self.host, self.http_port)
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="tc-torch-http")
        self._thread.start()
        _server_present(+1)
        return self

    def stop(self) -> None:
        if self._server is not None:
            _server_present(-1)
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        self.core.shutdown()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
