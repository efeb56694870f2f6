"""In-process server harness for tests and co-located serving.

Counterpart of ``triton_client_tpu/server/testing.py``:

* ``ServerHarness``: the port's HTTP frontend and its HTTP/2 gRPC port,
  each on a free local port, served from background threads of the
  current process, after the models' warmup samples ran.  ``grpc_url``
  names the gRPC port, as the reference's does; ``grpc_web_url`` the
  gRPC-Web bridge on the HTTP port.  While it serves, the CUDA shared-memory broker's
  ``server_present`` is set: a region made in this process is read in
  place, by uuid.
* ``ClusterHarness``: N of them, each with its own registry and core, with
  ``kill`` and ``restart`` on the same port.  Both take ``tls``.
* ``ReplicaSupervisor``: the self-healing of a ``ClusterHarness`` on the
  CLI supervisor's ``RestartPolicy`` and ``SupervisorState``.
* ``cli_http_port`` and ``cli_grpc_port``: the ports a ``--http-port 0
  --grpc-port 0`` CLI server bound, read from its start line, so a test
  never races another process for a port.
"""

from __future__ import annotations

import os
import re
import socket
import tempfile
import threading
import time
from typing import Callable, List, Optional

from .._cuda_broker import broker
from .core import InferenceCore
from .grpc_h2 import GrpcH2Server
from .http_server import HttpServer
from .memory import DEFAULT_MAX_REQUEST_BYTES
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


_SERVING_LINE = re.compile(r"serving v2 HTTPS? on \S+:(\d+) ")
_GRPC_LINE = re.compile(r"serving v2 HTTPS? on \S+ grpcs?=\S+:(\d+)")


def cli_http_port(proc, log_path: str, timeout: float = 120.0,
                  _line=_SERVING_LINE) -> int:
    """The HTTP port of ``proc``, a ``python -m triton_client_tpu_torch.server
    --http-port 0`` whose output goes to ``log_path``: read from the line it
    prints just before it serves.  Raises with the log where the process
    ends, or ``timeout`` seconds pass, first."""
    end = time.monotonic() + timeout
    while True:
        with open(log_path) as f:
            text = f.read()
        m = _line.search(text)
        if m:
            return int(m.group(1))
        if proc.poll() is not None:
            raise RuntimeError(f"server exited {proc.returncode}:\n{text}")
        if time.monotonic() >= end:
            raise TimeoutError(f"server not serving after {timeout:g}s:\n"
                               f"{text}")
        time.sleep(0.05)


def cli_grpc_port(proc, log_path: str, timeout: float = 120.0) -> int:
    """The gRPC port of a ``--grpc-port 0`` CLI server (``cli_http_port``'s
    contract)."""
    return cli_http_port(proc, log_path, timeout, _GRPC_LINE)


class ServerHarness:
    """``replica``, where given, names the server in every trace record
    and incident bundle (the CLI's ``--host:--http-port``); ``tls`` (a
    ``tls.TLSConfig``) serves HTTPS on the HTTP port and gRPC over TLS
    (ALPN ``h2``) on the gRPC port; ``max_request_bytes`` is both
    listeners' ingress cap."""

    def __init__(self, registry: Optional[ModelRegistry] = None,
                 http_port: Optional[int] = None, host: str = "127.0.0.1",
                 replica: str = "", tls=None,
                 grpc_port: Optional[int] = None,
                 max_request_bytes: int = DEFAULT_MAX_REQUEST_BYTES):
        self.registry = registry or ModelRegistry()
        self.core = InferenceCore(self.registry)
        self.core.tracer.replica = replica
        self.host = host
        self.tls = tls
        self.max_request_bytes = max_request_bytes
        self.http_port = http_port or free_port()
        self.grpc_port = grpc_port or free_port()
        self._server: Optional[HttpServer] = None
        self._grpc: Optional[GrpcH2Server] = None
        self._threads: List[threading.Thread] = []

    @property
    def http_url(self) -> str:
        return f"{self.host}:{self.http_port}"

    @property
    def grpc_url(self) -> str:
        """The gRPC port (HTTP/2), as the reference's harness names it."""
        return f"{self.host}:{self.grpc_port}"

    @property
    def grpc_web_url(self) -> str:
        """gRPC-Web: the bridge on the HTTP port."""
        return self.http_url

    def start(self) -> "ServerHarness":
        # warm before serving: a first request must not pay for what the
        # models' warmup samples build
        self.core.warmup_models()
        self._server = HttpServer(self.core, self.host, self.http_port,
                                  max_request_bytes=self.max_request_bytes,
                                  tls=self.tls)
        try:
            self._grpc = GrpcH2Server(
                self.core, self.host, self.grpc_port,
                max_request_bytes=self.max_request_bytes, tls=self.tls)
        except BaseException:
            self._server.server_close()
            self._server = None
            raise
        for srv, name in ((self._server, "tc-torch-http"),
                          (self._grpc, "tc-torch-grpc")):
            t = threading.Thread(target=srv.serve_forever, daemon=True,
                                 name=name)
            t.start()
            self._threads.append(t)
        _server_present(+1)
        return self

    def stop(self) -> None:
        if self._server is not None:
            _server_present(-1)
            for srv in (self._server, self._grpc):
                srv.shutdown()
                # as a process that ends: its open connections go too
                srv.close_connections()
                srv.server_close()
            self._server = self._grpc = None
        for t in self._threads:
            t.join(timeout=10)
        self._threads = []
        self.core.shutdown()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class ClusterHarness:
    """N in-process servers behind one fixture (the reference's).

    ``registry_factory`` is called once per server: each replica gets its
    own registry and core, as N processes would.  ``kill(i)`` stops
    replica *i* (its port then refuses connections); ``restart(i)`` brings
    it back on the same port with a fresh registry and core, both named
    ``replica-<i>``; ``chaos(i, injector)`` degrades one replica.  ``core_setup`` runs on
    every replica that starts, a restarted one included."""

    def __init__(self, registry_factory: Callable[[], ModelRegistry],
                 n: int = 3, host: str = "127.0.0.1",
                 core_setup: Optional[Callable[[ServerHarness], None]]
                 = None, tls=None):
        if n < 1:
            raise ValueError("ClusterHarness needs at least one server")
        self._registry_factory = registry_factory
        self.host = host
        self.tls = tls
        self._core_setup = core_setup
        # replicas keep their names across a kill and a restart
        self.harnesses: List[Optional[ServerHarness]] = [
            ServerHarness(registry_factory(), host=host,
                          replica=f"replica-{i}", tls=tls)
            for i in range(n)]
        # ports pinned at construction, so that restart(i) rebinds them
        self._http_ports = [h.http_port for h in self.harnesses]
        self._grpc_ports = [h.grpc_port for h in self.harnesses]

    @property
    def http_urls(self) -> List[str]:
        return [f"{self.host}:{p}" for p in self._http_ports]

    @property
    def grpc_urls(self) -> List[str]:
        """Each replica's gRPC port (HTTP/2)."""
        return [f"{self.host}:{p}" for p in self._grpc_ports]

    @property
    def grpc_web_urls(self) -> List[str]:
        """gRPC-Web on each HTTP port."""
        return self.http_urls

    def start(self) -> "ClusterHarness":
        for h in self.harnesses:
            h.start()
            if self._core_setup is not None:
                self._core_setup(h)
        return self

    def stop(self) -> None:
        for i, h in enumerate(self.harnesses):
            if h is not None:
                h.stop()
                self.harnesses[i] = None

    def kill(self, i: int) -> None:
        """Take replica ``i`` down."""
        h = self.harnesses[i]
        if h is not None:
            h.stop()
            self.harnesses[i] = None

    def restart(self, i: int) -> None:
        """Bring replica ``i`` back on its port, with a fresh registry and
        core, as a process restart would."""
        if self.harnesses[i] is not None:
            raise RuntimeError(f"server {i} is already running")
        h = ServerHarness(self._registry_factory(),
                          http_port=self._http_ports[i], host=self.host,
                          replica=f"replica-{i}", tls=self.tls,
                          grpc_port=self._grpc_ports[i])
        h.start()
        if self._core_setup is not None:
            self._core_setup(h)
        self.harnesses[i] = h

    def chaos(self, i: int, injector) -> None:
        """Install a chaos injector on replica ``i`` (None clears it)."""
        self.harnesses[i].core.chaos = injector

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class ReplicaSupervisor:
    """Self-healing for a :class:`ClusterHarness`, on the CLI supervisor's
    crash arithmetic (``fleet.RestartPolicy``) and restart accounting
    (``fleet.SupervisorState``), so that a drill runs the policy the
    ``--frontends`` supervisor runs.

    ``crash(i)`` is the kill (a chaos injector's ``worker_kill_cb``): on a
    thread of its own the replica is stopped, the policy's backoff paid,
    the replica restarted on its port and the restart written to the state
    file; with ``TRITON_TPU_FLEET_STATE`` naming it, every replica's
    ``/metrics`` shows ``nv_fleet_worker_restart_total``.  A storm leaves
    the replica down."""

    def __init__(self, cluster: ClusterHarness, policy=None,
                 state_path: Optional[str] = None):
        from .fleet import RestartPolicy, SupervisorState

        self.cluster = cluster
        self.policy_factory = policy or (
            lambda: RestartPolicy(base_delay_s=0.05, max_delay_s=1.0))
        self._policies = {}
        if state_path is None:
            fd, state_path = tempfile.mkstemp(
                prefix="tc-torch-fleet-state-", suffix=".json")
            os.close(fd)
            os.unlink(state_path)
        self.state = SupervisorState(state_path)
        self._threads: List[threading.Thread] = []
        self._lock = threading.Lock()

    def crash(self, i: int, reason: str = "chaos:worker_kill") -> None:
        """Kill replica ``i`` and heal it with backoff, on a thread of its
        own (the caller may be one of the replica's request threads)."""
        t = threading.Thread(target=self._heal, args=(i, reason),
                             daemon=True, name=f"tc-torch-heal-{i}")
        with self._lock:
            self._threads.append(t)
        t.start()

    def _heal(self, i: int, reason: str = "") -> None:
        with self._lock:
            policy = self._policies.setdefault(i, self.policy_factory())
            delay = policy.on_crash()
        self.cluster.kill(i)
        if delay is None:
            return  # a crash storm: the replica stays down
        time.sleep(delay)
        with self._lock:
            if self.cluster.harnesses[i] is not None:
                return  # brought back meanwhile
            self.cluster.restart(i)
            self.state.record_restart(str(i), reason=reason or None)

    def join(self, timeout: float = 30.0) -> None:
        """Wait for the heals in progress."""
        deadline = time.monotonic() + timeout
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
