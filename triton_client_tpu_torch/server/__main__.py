"""``python -m triton_client_tpu_torch.server``: serve the port's model zoo
over the v2 HTTP protocol, v2 gRPC over HTTP/2 on ``--grpc-port`` (default
8001, as the reference's), and v2 gRPC as gRPC-Web on the HTTP port too.

    python -m triton_client_tpu_torch.server --http-port 8000 --grpc-port 8001
        [--device cuda|cpu] [--model-repository DIR] [--zoo]
        [--ssl-certfile CERT.pem --ssl-keyfile KEY.pem]

The start line names both ports, as the reference's does (``serving v2
HTTP on HOST:8000 grpc=HOST:8001 ...``); ``--http-port 0`` and
``--grpc-port 0`` bind free ports, which ``testing.cli_http_port`` and
``cli_grpc_port`` read back from it.  A gRPC port that cannot be bound
fails the start.

With ``--ssl-certfile`` and ``--ssl-keyfile`` (the reference's flags and
errors: both or neither, each an existing file) the HTTP port serves HTTPS
and gRPC-Web over it, the gRPC port gRPC over TLS (ALPN ``h2``; the start
line says ``grpcs=``), and the metrics port HTTPS, in every
``--frontends`` worker; a pair that does not load fails the start.

With ``--model-repository DIR`` every model of the repository (Triton's
layout: ``DIR/<model>/config.pbtxt`` and ``DIR/<model>/<N>/model.py``
exposing ``get_model(config)`` that returns a model of this package) is
loaded at start; the repository API loads and unloads them later.  The
model zoo is registered with ``--zoo``, or where no repository is given.
The zoo registers the reference's 25 models, by its names and in its order:
``simple``, ``resnet50``, ``bert_large``, ``ensemble_llama`` (with its
``llama_preprocess``, ``llama_tpu`` and ``llama_postprocess`` steps),
``longctx_tpu``, ``moe_tpu``, ``llama_decode`` and ``llama_generate``
(decoupled: ``/generate_stream`` or a gRPC stream; both on
``llama_tpu``'s weights, ``TRITON_TPU_DECODE_MODE`` independent or
batched), and the fixtures ``simple_string``, ``simple_int8``,
``simple_identity``, ``custom_identity_int32``, ``identity_fp32``,
``identity_bf16``, ``simple_sequence``, ``simple_dyna_sequence``,
``repeat_int32`` and ``square_int32`` (decoupled: gRPC streams only),
``dense_tpu``, ``simple_cnn``, ``scale_by_two`` and
``ensemble_scale_sum``.

``--device cuda`` (the default) serves ``resnet50`` in bf16, the
full-size transformer presets (``longctx_tpu`` base, ``moe_tpu`` base,
``llama_tpu`` 1b) through the CUDA kernels and ``dense_tpu`` on the card,
and fails if CUDA is missing; ``--device cpu`` serves ``resnet50`` in f32,
the ``tiny`` presets with the kernels' plain versions and ``dense_tpu`` on
the host.  ``bert_large`` and ``resnet50`` have no preset: full width on
either device.  The other fixtures run on the host either way.  Each
device model draws its weights at its first request.
``TRITON_TPU_LONGCTX_PRESET``, ``TRITON_TPU_MOE_PRESET`` and
``TRITON_TPU_LLAMA_PRESET`` are read at start-up,
``TRITON_TPU_QUANT[_<MODEL>]=int8`` at a model's first request.

Admission and overload (the reference's flags, ``__main__.py:147-262``):
``--max-queue-size`` (a model's bound on pending requests; a config's
``max_queue_size`` parameter wins), ``--shed-retry-after`` (the base
pushback), ``--max-request-bytes`` (the ingress cap, default 64 MiB),
``--mem-budget-bytes`` (the memory governor's byte budget), the QoS tiers
and tenants (``--qos-tiers``, ``--qos-weights``, ``--qos-tenant-rate``,
``--qos-tenant-burst``, ``--qos-tenant-limit NAME=RATE[:BURST]``,
``--qos-best-effort-fraction``) and fault injection (``--chaos RATE``,
``--chaos-kinds`` of
``latency,error,abort,worker_kill,load_fail,mem_pressure,device_error``,
``--chaos-seed``, ``--chaos-latency-ms``, ``--chaos-model``,
``--chaos-transient``, ``--chaos-pressure-s``,
``--chaos-pressure-factor``).  SIGTERM or SIGINT drains: new requests get
503 with ``Retry-After``, in-flight ones finish, and the process exits
within ``--drain-timeout`` seconds.

The generation stack's cache and device faults (the reference's flags,
``__main__.py:210-340``, :426-430): ``--kv-cache-bytes MODEL=N | N``
(repeatable; the prefix/KV block store's budget,
``TRITON_TPU_KV_CACHE_BYTES[_<MODEL>]``), ``--device-fault-threshold``,
``--device-fault-window``, ``--device-fault-probe-backoff``,
``--device-fault-probe-backoff-max`` (the quarantine state machine) and
``--tick-stall-ms`` (the decode readback watchdog,
``TRITON_TPU_TICK_STALL_MS``).  ``TRITON_TPU_KV_QUANT=int8`` stores the
batched slot cache as int8 with per-vector scales.

Observability (the reference's flags): ``--capture-slower-than P|MS``,
``--flight-recorder-size``, ``--flight-recorder-outliers`` and
``--no-flight-recorder`` set the flight recorder; ``--slo
MODEL=P99_MS[:AVAILABILITY]`` (repeatable) and ``--slo-burn-threshold``
the SLO engine; ``--no-device-stats`` turns the device statistics off;
``--metrics-port`` (default 8002, 0 for none) serves ``/metrics`` and the
debug snapshots on a second listener (they are on the HTTP port either
way).  Tracing and logging are set at run time through
``/v2/trace/setting`` and ``/v2/logging``.

The host's view and the postmortems (the reference's flags,
``__main__.py:122-140`` and :474-535): ``--profile-hz`` sets the sampling
profiler (default ``TRITON_TPU_PROFILE_HZ``, else 19; 0 turns the sampler
off, the lag probes and the GC accounting stay); ``--incident-dir``
(default ``TRITON_TPU_INCIDENT_DIR``, else ``<tmp>/tc-tpu-incidents``)
receives the incident bundles and ``faulthandler-<pid>.log``, where a
fatal signal dumps every thread's stack; ``--incident-keep N`` keeps the
newest N bundles.  ``SIGUSR2`` writes a ``sigusr2`` bundle while the
server goes on serving: the handler only wakes the thread that writes
it.  ``--otlp-endpoint URL`` exports every trace record to an OTLP/HTTP
collector under this process's name (``TRITON_TPU_REPLICA``, else
``host:port``, with ``#w<i>`` for a ``--frontends`` worker), which every
record carries.

The fleet (the reference's flags, ``__main__.py:41-80``): ``--frontends
N`` runs a supervisor that starts N worker processes (this module with
``--frontend-worker i``), each a whole server sharing the HTTP and gRPC
ports through ``SO_REUSEPORT`` (the kernel spreads the connections) and serving
``/metrics`` on ``--metrics-port`` + i; client shared-memory registrations
reach every worker through a manifest directory.  A worker that dies is
started again after a capped, doubling backoff and counted in
``nv_fleet_worker_restart_total`` on every worker;
``--worker-restart-limit`` crashes of one worker inside
``--worker-restart-window`` seconds fail the fleet fast.  SIGTERM and
SIGINT reach every worker, each of which drains.  On the card every worker
opens the device: each holds its own CUDA context and its own copy of the
weights.  ``--autoscale MODEL=MIN..MAX`` (repeatable) bounds a model's
batches in flight for the fleet controller every process runs, evaluated
each ``--autoscale-interval`` seconds; a model's config can declare the
same through its ``autoscale.min_instances`` / ``autoscale.max_instances``
parameters.  Models with ``model_warmup`` samples are warmed before the
listeners open; one whose warmup fails is unloaded.  A ``worker_kill``
chaos draw exits the process with code 70, once its incident bundle is
written.

The response cache (the reference's flag, ``__main__.py:218-223``):
``--cache-budget-bytes N`` caps the bytes of every model's cached
responses together (a model caches where its config has
``response_cache { enable: true }``; its entries expire after its
``response_cache.ttl_s`` parameter).  ``--verbose`` / ``-v`` is accepted
and changes nothing, as in the reference.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading
import time
from typing import TYPE_CHECKING

# PyTorch, the zoo and the core are imported by the worker path of main():
# the supervisor of --frontends N loads no model, and spawns its workers
# without paying for them
from .chaos import build_injector
from .fleet import FleetController, parse_autoscale_spec
from .device_stats import parse_slo_spec
from .kvcache import cache_env_key
from .memory import DEFAULT_MAX_REQUEST_BYTES
from .qos import QosManager, parse_tenant_limit
from .tls import maybe_tls
from .types import InferError

if TYPE_CHECKING:
    from .core import InferenceCore


def _add_admission_flags(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--drain-timeout", type=float, default=10.0,
                    metavar="S",
                    help="graceful-drain budget on SIGINT/SIGTERM: stop "
                    "accepting (new requests get 503 + Retry-After, "
                    "readiness goes false), wait this long for in-flight "
                    "requests, then exit")
    ap.add_argument("--max-request-bytes", type=int,
                    default=DEFAULT_MAX_REQUEST_BYTES, metavar="N",
                    help="wire ingress cap: a request larger than N bytes "
                    "is refused before its body is read (HTTP 413 / gRPC "
                    "RESOURCE_EXHAUSTED carrying the limit); 0 = none")
    ap.add_argument("--mem-budget-bytes", type=int, default=0, metavar="N",
                    help="host byte budget for queued + in-flight "
                    "request/response payloads: over-budget arrivals are "
                    "shed tier-aware with a 429 + Retry-After (0 = track "
                    "only, never shed)")
    ap.add_argument("--max-queue-size", type=int, default=0,
                    help="default per-model admission bound: requests "
                    "beyond this many pending per model are shed with "
                    "429 / RESOURCE_EXHAUSTED + Retry-After (0 = "
                    "unbounded; a model config's max_queue_size parameter "
                    "overrides per model)")
    ap.add_argument("--shed-retry-after", type=float, default=0.25,
                    metavar="S",
                    help="base pushback (seconds) of a shed; the horizon "
                    "sent scales with the shed tier's queue depth")
    ap.add_argument("--qos-tiers", type=int, default=4,
                    help="QoS priority tiers; priority p maps to tier "
                    "min(p, tiers-1), the last tier is the preemptible "
                    "best-effort lane (default 4)")
    ap.add_argument("--qos-weights", default=None, metavar="W0,W1,...",
                    help="weighted-fair dequeue weights, one per tier; "
                    "default: strict priority")
    ap.add_argument("--qos-tenant-rate", type=float, default=0.0,
                    metavar="RPS",
                    help="default per-tenant token-bucket rate in "
                    "requests/s (0 = no tenant rate limiting)")
    ap.add_argument("--qos-tenant-burst", type=float, default=None,
                    help="token-bucket burst (default: max(1, rate))")
    ap.add_argument("--qos-tenant-limit", action="append", default=None,
                    metavar="NAME=RATE[:BURST]",
                    help="per-tenant rate override (repeatable); RATE 0 "
                    "exempts the tenant")
    ap.add_argument("--qos-best-effort-fraction", type=float, default=0.5,
                    metavar="F",
                    help="fraction of a model's max_queue_size the "
                    "best-effort tier may fill (default 0.5)")
    ap.add_argument("--chaos", type=float, default=0.0, metavar="RATE",
                    help="fault-injection rate in [0,1], drawn per request "
                    "from a seeded RNG")
    ap.add_argument("--chaos-kinds", default="error",
                    help="comma list of latency,error,abort,worker_kill,"
                    "load_fail,mem_pressure,device_error (default: "
                    "error).  worker_kill exits the process (code 70; "
                    "a --frontends supervisor restarts it).  "
                    "load_fail fails repository loads only.  "
                    "device_error fires at "
                    "the decode worker's dispatch boundaries: it wrecks "
                    "the bucket's cache and raises a CUDA-shaped failure, "
                    "driving the real rebuild / generation-recovery / "
                    "quarantine path")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="RNG seed: a fixed seed gives the same fault "
                    "sequence for the same arrivals")
    ap.add_argument("--chaos-latency-ms", type=float, default=50.0,
                    help="added delay of a latency fault")
    ap.add_argument("--chaos-model", action="append", default=None,
                    metavar="NAME",
                    help="inject into this model only (repeatable)")
    ap.add_argument("--chaos-transient", type=float, default=0.0,
                    metavar="S",
                    help="healthy window after each injected fault, so a "
                    "prompt retry lands clean (0 = independent draws)")
    ap.add_argument("--chaos-pressure-s", type=float, default=1.0,
                    metavar="S",
                    help="how long a mem_pressure draw holds the shrunken "
                    "byte budget (default 1.0)")
    ap.add_argument("--chaos-pressure-factor", type=float, default=0.5,
                    metavar="F",
                    help="the live byte budget under a mem_pressure "
                    "window, as a fraction of --mem-budget-bytes "
                    "(default 0.5)")


def _add_generation_flags(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--kv-cache-bytes", action="append", default=None,
                    metavar="MODEL=N | N",
                    help="prefix/KV-cache byte budget: 'MODEL=N' for one "
                    "decode model, a bare 'N' for every one (repeatable; "
                    "TRITON_TPU_KV_CACHE_BYTES[_MODEL]; 0/unset = cache "
                    "off).  Block size from TRITON_TPU_KV_BLOCK_TOKENS "
                    "(default 64)")
    ap.add_argument("--device-fault-threshold", type=int, default=3,
                    metavar="K",
                    help="dispatch faults inside --device-fault-window "
                    "that quarantine a model: not ready on both "
                    "protocols, typed retryable 503s with pushback until "
                    "a probe dispatch succeeds (default 3)")
    ap.add_argument("--device-fault-window", type=float, default=30.0,
                    metavar="S",
                    help="sliding window of the K-fault detector (default "
                    "30s)")
    ap.add_argument("--device-fault-probe-backoff", type=float,
                    default=1.0, metavar="S",
                    help="delay before a quarantined model's first probe; "
                    "doubles per failed probe (default 1s)")
    ap.add_argument("--device-fault-probe-backoff-max", type=float,
                    default=30.0, metavar="S",
                    help="probe backoff ceiling (default 30s)")
    ap.add_argument("--tick-stall-ms", type=float, default=None,
                    metavar="MS",
                    help="arm the decode readback watchdog: a tick or "
                    "prefill readback slower than MS reports a tick_stall "
                    "device fault and quarantines the model (a wedged "
                    "dispatch cannot be killed from the host; this "
                    "reroutes traffic while it is stuck; sets "
                    "TRITON_TPU_TICK_STALL_MS)")


def _configure_generation(ap: argparse.ArgumentParser, args,
                          core: InferenceCore) -> None:
    """The cache and device-fault flags: the decode models read theirs
    from the environment at their first request."""
    if args.tick_stall_ms is not None:
        if args.tick_stall_ms <= 0:
            ap.error("--tick-stall-ms must be positive")
        os.environ["TRITON_TPU_TICK_STALL_MS"] = str(args.tick_stall_ms)
    for spec in args.kv_cache_bytes or []:
        name, sep, val = spec.partition("=")
        raw = val if sep else name
        try:
            nbytes = int(raw)
        except ValueError:
            ap.error(f"--kv-cache-bytes {spec!r}: budget must be an "
                     "integer byte count")
        if nbytes < 0:
            ap.error(f"--kv-cache-bytes {spec!r}: budget must be >= 0")
        key = cache_env_key(name) if sep else "TRITON_TPU_KV_CACHE_BYTES"
        os.environ[key] = str(nbytes)
    if args.device_fault_threshold < 1:
        ap.error("--device-fault-threshold must be >= 1")
    if args.device_fault_window <= 0:
        ap.error("--device-fault-window must be positive")
    faults = core.device_faults
    faults.threshold = args.device_fault_threshold
    faults.window_s = args.device_fault_window
    faults.probe_backoff_s = max(0.05, args.device_fault_probe_backoff)
    faults.probe_backoff_max_s = max(faults.probe_backoff_s,
                                     args.device_fault_probe_backoff_max)


def _configure_admission(ap: argparse.ArgumentParser, args,
                         core: InferenceCore) -> None:
    """The admission flags onto ``core``; junk fails at start-up."""
    if args.max_request_bytes < 0:
        ap.error("--max-request-bytes must be >= 0 (0 = unbounded)")
    if args.mem_budget_bytes < 0:
        ap.error("--mem-budget-bytes must be >= 0 (0 = track only)")
    core.default_max_queue_size = max(0, args.max_queue_size)
    core.shed_retry_after_s = max(0.0, args.shed_retry_after)
    core.memory.budget_bytes = args.mem_budget_bytes
    try:
        weights = ([int(w) for w in args.qos_weights.split(",")]
                   if args.qos_weights else None)
        tenant_rates = {}
        for spec in args.qos_tenant_limit or []:
            name, rate, burst = parse_tenant_limit(spec)
            tenant_rates[name] = (rate, burst)
        core.qos = QosManager(
            tiers=args.qos_tiers,
            tenant_rate=max(0.0, args.qos_tenant_rate),
            tenant_burst=args.qos_tenant_burst, tenant_rates=tenant_rates,
            best_effort_fraction=args.qos_best_effort_fraction,
            weights=weights)
        if args.chaos > 0.0:
            core.chaos = build_injector(
                args.chaos, kinds_csv=args.chaos_kinds,
                seed=args.chaos_seed, latency_ms=args.chaos_latency_ms,
                models=args.chaos_model,
                transient_s=max(0.0, args.chaos_transient),
                pressure_s=max(0.0, args.chaos_pressure_s),
                pressure_factor=args.chaos_pressure_factor)
    except ValueError as e:
        ap.error(str(e))
    if args.mem_budget_bytes:
        print(f"memory governor: host budget {args.mem_budget_bytes} bytes")
    if core.chaos is not None:
        print(f"chaos injection ON: rate={args.chaos} "
              f"kinds={core.chaos.kinds} seed={args.chaos_seed}")


def _add_fleet_flags(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--frontends", type=int, default=1, metavar="N",
                    help="frontend processes sharing the HTTP port through "
                    "SO_REUSEPORT (the kernel spreads accepted "
                    "connections), so that serving scales past one "
                    "interpreter.  Worker i serves /metrics on "
                    "--metrics-port + i; client shared-memory "
                    "registrations reach every worker through a manifest "
                    "directory.  On the card each worker holds its own CUDA "
                    "context and copy of the weights.  Default 1 (one "
                    "process, no SO_REUSEPORT)")
    ap.add_argument("--frontend-worker", type=int, default=None,
                    help=argparse.SUPPRESS)  # a worker's index
    ap.add_argument("--worker-restart-limit", type=int, default=5,
                    metavar="K",
                    help="the supervisor's storm bound: a crashed worker is "
                    "restarted after a capped, doubling backoff, but K "
                    "crashes of one worker inside --worker-restart-window "
                    "fail the fleet fast; 1 fails on the first crash "
                    "(default 5)")
    ap.add_argument("--worker-restart-window", type=float, default=30.0,
                    metavar="S",
                    help="the sliding window (seconds) the storm bound "
                    "counts crashes over; crashes that age out of it also "
                    "reset the backoff (default 30)")
    ap.add_argument("--autoscale", action="append", default=None,
                    metavar="MODEL=MIN..MAX",
                    help="closed-loop autoscaling of MODEL between MIN and "
                    "MAX batches in flight (repeatable; either bound may "
                    "be left out around '..').  Out on an SLO burn at or "
                    "over --slo-burn-threshold or a deep batcher backlog, "
                    "in on a sustained idle duty cycle.  A config may "
                    "declare the same through its autoscale.min_instances "
                    "/ autoscale.max_instances parameters")
    ap.add_argument("--autoscale-interval", type=float, default=1.0,
                    metavar="S",
                    help="the fleet controller's evaluation period "
                    "(default 1.0 s)")


def _run_supervisor(ap: argparse.ArgumentParser, args, argv) -> int:
    """``--frontends N``: start N workers that run this module again with
    ``--frontend-worker i``, each binding the same HTTP port with
    SO_REUSEPORT, and watch them (the reference's ``_run_supervisor``).

    A worker that dies on its own is started again after its
    ``RestartPolicy``'s backoff, on the same port and manifest directory,
    and the restart is written to the fleet's state file.  A crash storm
    (``--worker-restart-limit`` crashes of one worker inside
    ``--worker-restart-window``) fails the fleet fast: the siblings are
    sent SIGTERM and drain.  SIGINT and SIGTERM are passed to every worker,
    each of which drains.  Returns the exit code: the largest of the
    workers' last codes (a worker killed by a signal counts 1), or the
    crashed worker's on a storm."""
    import shutil
    import socket
    import subprocess
    import tempfile

    from .fleet import (FLEET_STATE_ENV, MANIFEST_ENV, RestartPolicy,
                        SupervisorState, crash_reason_from_exit)

    if not hasattr(socket, "SO_REUSEPORT"):
        ap.error("--frontends > 1 requires SO_REUSEPORT (Linux)")
    if args.worker_restart_limit < 1:
        ap.error("--worker-restart-limit must be >= 1")
    if args.device == "cuda":
        print("frontend supervisor: every worker opens the card: each "
              "holds its own CUDA context and its own copy of the weights",
              file=sys.stderr, flush=True)
    # a register lands on one worker; the manifest lets every sibling
    # resolve it (shm.py).  The fleet's state file lives beside it
    manifest = tempfile.mkdtemp(prefix="tc-torch-shm-manifest-")
    fleet_state = SupervisorState(os.path.join(manifest, "fleet-state.json"))
    env = dict(os.environ)
    env[MANIFEST_ENV] = manifest
    env[FLEET_STATE_ENV] = fleet_state.path

    def spawn(i: int) -> subprocess.Popen:
        cmd = [sys.executable, "-m", "triton_client_tpu_torch.server",
               *argv, "--frontend-worker", str(i)]
        p = subprocess.Popen(cmd, env=env)
        print(f"frontend worker {i}: pid {p.pid}", flush=True)
        return p

    procs: list = []
    rc = 0
    try:
        procs = [spawn(i) for i in range(args.frontends)]
        policies = [RestartPolicy(storm_limit=args.worker_restart_limit,
                                  window_s=args.worker_restart_window)
                    for _ in procs]
        restart_at: list = [None] * len(procs)
        crash_reason: list = [None] * len(procs)
        print(f"frontend supervisor: {args.frontends} workers sharing "
              f"http={args.host}:{args.http_port} "
              f"grpc={args.host}:{args.grpc_port} (SO_REUSEPORT, "
              "self-healing: restart with backoff, fail-fast after "
              f"{args.worker_restart_limit} crashes/"
              f"{args.worker_restart_window:g}s)", flush=True)
        state = {"stopping": False}

        def forward(signum, _frame):
            # each worker drains itself; a pending restart is dropped
            state["stopping"] = True
            for p in procs:
                if p is not None and p.poll() is None:
                    try:
                        p.send_signal(signum)
                    except OSError:
                        pass

        for sig in (signal.SIGINT, signal.SIGTERM):
            signal.signal(sig, forward)

        def fail_fast() -> None:
            state["stopping"] = True
            for q in procs:
                if q is not None and q.poll() is None:
                    try:
                        q.send_signal(signal.SIGTERM)
                    except OSError:
                        pass

        while True:
            now = time.monotonic()
            if not state["stopping"]:
                for i, p in enumerate(procs):
                    if p is None or p.poll() is None:
                        continue
                    # a worker that exits while the fleet is not stopping
                    # crashed: a server runs until it is told to stop
                    code = p.returncode or 0
                    procs[i] = None
                    crash_reason[i] = crash_reason_from_exit(p.returncode)
                    delay = policies[i].on_crash(now)
                    if delay is None:
                        print(f"frontend worker {i}: "
                              f"{policies[i].storm_limit} crashes inside "
                              f"{policies[i].window_s:g}s — crash storm, "
                              "failing fast (draining siblings)",
                              file=sys.stderr, flush=True)
                        rc = max(rc, 1 if code <= 0 else code)
                        fail_fast()
                        restart_at = [None] * len(procs)
                        break
                    print(f"frontend worker {i} exited rc={code} "
                          f"({crash_reason[i]}); restarting in {delay:g}s",
                          file=sys.stderr, flush=True)
                    restart_at[i] = now + delay
                for i, due in enumerate(restart_at):
                    if due is not None and now >= due \
                            and not state["stopping"]:
                        restart_at[i] = None
                        procs[i] = spawn(i)
                        fleet_state.record_restart(
                            str(i), reason=crash_reason[i])
            alive = any(p is not None and p.poll() is None for p in procs)
            pending = any(due is not None for due in restart_at)
            if state["stopping"] and not alive:
                break
            if not state["stopping"] and not alive and not pending:
                break  # nothing left to watch
            time.sleep(0.2)
        # a worker killed by a signal failed; healed crashes do not count
        rc = max([rc] + [1 if (p.returncode or 0) < 0
                         else (p.returncode or 0)
                         for p in procs if p is not None])
    finally:
        for p in procs:
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(manifest, ignore_errors=True)
    return rc


def _configure_host_view(ap: argparse.ArgumentParser, args, core,
                         worker_index) -> None:
    """The profiler's rate, the incident directory and its retention, the
    faulthandler dump, the replica's name and the OTLP export."""
    import faulthandler

    if args.profile_hz is not None:
        core.profiler.hz = args.profile_hz
    core.incidents.keep = args.incident_keep
    if args.incident_dir:
        core.incidents.dir = args.incident_dir
    os.makedirs(core.incidents.dir, exist_ok=True)
    # faulthandler keeps only the descriptor: the file lives on the core
    core._faulthandler_file = open(
        os.path.join(core.incidents.dir, f"faulthandler-{os.getpid()}.log"),
        "w")
    faulthandler.enable(file=core._faulthandler_file)
    print(f"incident capture: dir={core.incidents.dir} "
          f"keep={core.incidents.keep} profiler_hz={core.profiler.hz:g} "
          "(SIGUSR2 triggers a manual bundle)")
    replica = os.environ.get("TRITON_TPU_REPLICA", "")
    if not replica:
        replica = f"{args.host}:{args.http_port}"
        if worker_index is not None:
            replica += f"#w{worker_index}"
    core.tracer.replica = replica
    if args.otlp_endpoint:
        try:
            core.enable_otlp(args.otlp_endpoint, replica=replica)
        except ValueError as e:
            ap.error(str(e))
        print(f"OTLP export: {args.otlp_endpoint} (replica={replica})")


def _arm_sigusr2(core) -> None:
    """SIGUSR2 writes a ``sigusr2`` bundle and serving goes on.  The
    handler runs on the main thread between two bytecodes, wherever that
    thread was (it starts the request threads, under threading's own
    locks), so it takes no lock: it sets an event that a thread of its
    own waits on, and that thread triggers the bundle."""
    if not hasattr(signal, "SIGUSR2"):
        return
    wake = threading.Event()

    def write_bundles() -> None:
        while True:
            wake.wait()
            wake.clear()
            core.incidents.trigger("sigusr2", reason="operator SIGUSR2")

    threading.Thread(target=write_bundles, daemon=True,
                     name="tc-torch-sigusr2").start()
    signal.signal(signal.SIGUSR2, lambda signum, frame: wake.set())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m triton_client_tpu_torch.server")
    ap.add_argument("--model-repository", default=None,
                    help="model repository directory; every model in it "
                    "is loaded at start")
    ap.add_argument("--zoo", action="store_true",
                    help="register the built-in model zoo (the default "
                    "without --model-repository)")
    ap.add_argument("--http-port", type=int, default=8000)
    ap.add_argument("--grpc-port", type=int, default=8001,
                    help="the v2 gRPC service over HTTP/2 (0: a free port; "
                    "gRPC-Web stays on the HTTP port too)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--capture-slower-than", default="p99", metavar="P|MS",
                    help="flight-recorder watchdog threshold: a live "
                    "per-model quantile (p50/p90/p95/p99/p999, default "
                    "p99) or an absolute milliseconds value; requests "
                    "beyond it (and every failure) are pinned with a full "
                    "span tree")
    ap.add_argument("--flight-recorder-size", type=int, default=1024,
                    help="ring-buffer capacity of the flight recorder")
    ap.add_argument("--flight-recorder-outliers", type=int, default=32,
                    help="pinned-outlier buffer capacity")
    ap.add_argument("--no-flight-recorder", action="store_true",
                    help="record no requests (the debug route stays up)")
    ap.add_argument("--slo", action="append", default=None,
                    metavar="MODEL=P99_MS[:AVAILABILITY]",
                    help="per-model SLO (repeatable): p99 target in ms and "
                    "an availability objective (default 0.999)")
    ap.add_argument("--slo-burn-threshold", type=float, default=None,
                    metavar="X",
                    help="multi-window breach threshold (default 14.4)")
    ap.add_argument("--no-device-stats", action="store_true",
                    help="turn the device statistics off (nv_tpu_* "
                    "metrics, batcher tick profiling)")
    ap.add_argument("--metrics-port", type=int, default=8002,
                    help="second listener for /metrics and the debug "
                    "snapshots (0: none; /metrics stays on the HTTP port)")
    ap.add_argument("--profile-hz", type=float, default=None, metavar="HZ",
                    help="rate of the host's sampling profiler (default "
                    "TRITON_TPU_PROFILE_HZ, else 19; 0: the sampler is "
                    "off, the lag probes and GC accounting stay on)")
    ap.add_argument("--incident-dir", default=None, metavar="DIR",
                    help="directory of the incident bundles and of the "
                    "faulthandler dump (default TRITON_TPU_INCIDENT_DIR, "
                    "else <tmpdir>/tc-tpu-incidents)")
    ap.add_argument("--incident-keep", type=int, default=8, metavar="N",
                    help="keep the newest N incident bundles (default 8)")
    ap.add_argument("--otlp-endpoint", default=None, metavar="URL",
                    help="OTLP/HTTP collector to export the trace records "
                    "to (host:port, or a URL; /v1/traces is added where "
                    "the URL has no path)")
    ap.add_argument("--cache-budget-bytes", type=int, default=0,
                    metavar="N",
                    help="byte budget across all response-cache entries; "
                    "an insert evicts LRU entries to fit (0: the entry "
                    "count bound only).  A model's TTL is its config's "
                    "response_cache.ttl_s parameter")
    # accepted and unused, as in the reference
    ap.add_argument("--verbose", "-v", action="store_true")
    ap.add_argument("--ssl-certfile", default=None,
                    help="serve HTTPS (and gRPC-Web over it) with this PEM "
                    "cert chain; the metrics port too")
    ap.add_argument("--ssl-keyfile", default=None,
                    help="PEM private key matching --ssl-certfile")
    _add_admission_flags(ap)
    _add_generation_flags(ap)
    _add_fleet_flags(ap)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    if args.frontends < 1:
        ap.error("--frontends must be >= 1")
    # before the supervisor's branch: a typo must fail at once, not crash
    # N workers into a storm with the message in their output
    autoscale_bounds = {}
    for spec in args.autoscale or []:
        try:
            name, bounds = parse_autoscale_spec(spec)
        except ValueError as e:
            ap.error(str(e))
        autoscale_bounds[name] = bounds
    if args.autoscale_interval <= 0:
        ap.error("--autoscale-interval must be positive")
    if args.profile_hz is not None and args.profile_hz < 0:
        ap.error("--profile-hz must be >= 0 (0 = sampler off)")
    if args.incident_keep < 1:
        ap.error("--incident-keep must be >= 1")
    try:
        tls = maybe_tls(args.ssl_certfile, args.ssl_keyfile)
    except ValueError as e:
        ap.error(str(e))
    worker_index = args.frontend_worker
    if args.frontends > 1 and worker_index is None:
        # the supervisor: it loads no model
        return _run_supervisor(ap, args, argv)

    from ..models import zoo
    from .core import InferenceCore
    from .grpc_h2 import GrpcH2Server
    from .http_server import HttpServer, MetricsServer
    from .registry import ModelRegistry

    registry = ModelRegistry(repository_path=args.model_repository)
    if args.model_repository:
        for entry in registry.index():
            try:
                registry.load(entry["name"])
                print(f"loaded model '{entry['name']}'")
            except Exception as e:  # noqa: BLE001 - reported, serving goes on
                print(f"failed to load '{entry['name']}': {e}")
    if args.zoo or not args.model_repository:
        zoo.register_all(registry, device=args.device)
        print(f"registered model zoo: "
              f"{[e['name'] for e in registry.index()]}")
    core = InferenceCore(registry)
    if args.cache_budget_bytes < 0:
        ap.error("--cache-budget-bytes must be >= 0 (0 = no byte budget)")
    core.response_cache.budget_bytes = args.cache_budget_bytes or None
    _configure_admission(ap, args, core)
    _configure_generation(ap, args, core)
    if core.chaos is not None and "worker_kill" in core.chaos.kinds:
        # a worker_kill draw looks like a real crash: no drain, no atexit;
        # the supervisor (or the operator's init system) heals it.  The
        # draw's incident bundle is written first: a bundle cut off by the
        # exit would be lost
        def kill() -> None:
            core.incidents.wait()
            os._exit(70)

        core.chaos.worker_kill_cb = kill
        print("chaos: worker_kill armed — this process hard-exits when "
              "the fault fires")
    # always attached (rolling updates and the nv_fleet_* counters need
    # it); its loop actuates only models with bounds
    core.fleet = FleetController(core, interval_s=args.autoscale_interval,
                                 bounds=autoscale_bounds)
    for name, (lo, hi) in sorted(autoscale_bounds.items()):
        print(f"autoscale: {name} instances in [{lo}, {hi}]")
    try:
        core.flight_recorder.configure(
            capacity=args.flight_recorder_size,
            outlier_capacity=args.flight_recorder_outliers,
            capture_slower_than=args.capture_slower_than,
            enabled=not args.no_flight_recorder)
    except InferError as e:  # a junk threshold fails at start-up
        ap.error(str(e))
    if args.no_device_stats:
        core.device_stats.enabled = False
    if args.slo_burn_threshold is not None:
        if args.slo_burn_threshold <= 0:
            ap.error("--slo-burn-threshold must be positive")
        core.slo.burn_threshold = args.slo_burn_threshold
    for spec in args.slo or []:
        try:
            name, objective = parse_slo_spec(spec)
        except ValueError as e:
            ap.error(str(e))
        core.slo.set_objective(name, objective)
        print(f"SLO: {name} p99<={objective.p99_ms:g}ms "
              f"availability={objective.availability:g}")
    _configure_host_view(ap, args, core, worker_index)
    warmed = core.warmup_models()
    if warmed:
        print(f"warmed up: {warmed}", flush=True)
    core.fleet.start()
    server = HttpServer(core, args.host, args.http_port,
                        max_request_bytes=args.max_request_bytes,
                        reuse_port=worker_index is not None, tls=tls)
    try:
        grpc = GrpcH2Server(core, args.host, args.grpc_port,
                            max_request_bytes=args.max_request_bytes,
                            reuse_port=worker_index is not None, tls=tls)
    except BaseException:
        server.server_close()
        raise
    servers = [server, grpc]
    threading.Thread(target=grpc.serve_forever, daemon=True,
                     name="tc-torch-grpc").start()
    # worker i serves its own metrics port: the HTTP port is shared
    metrics_port = (args.metrics_port + (worker_index or 0)
                    if args.metrics_port else 0)
    if metrics_port:
        metrics = MetricsServer(core, args.host, metrics_port, tls=tls)
        servers.append(metrics)
        threading.Thread(target=metrics.serve_forever, daemon=True,
                         name="tc-torch-metrics").start()

    def _drain_then_stop():
        # new requests get 503 while the in-flight ones finish and their
        # answers are written; then the listeners close
        print("shutting down: draining in-flight requests "
              f"(up to {args.drain_timeout:g}s)", flush=True)
        end = time.monotonic() + max(0.0, args.drain_timeout)
        core.drain(max(0.0, args.drain_timeout))
        # HTTP/2 clients are told to open no new stream here
        grpc.goaway()
        while server.active + grpc.active > 0 and time.monotonic() < end:
            time.sleep(0.01)
        for srv in servers:
            srv.shutdown()

    draining = []

    def _stop(signum, frame):
        # shutdown() waits for serve_forever to return: call it off the
        # main thread, which is the one serving
        if not draining:
            draining.append(threading.Thread(target=_drain_then_stop,
                                             daemon=True))
            draining[0].start()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    _arm_sigusr2(core)
    metrics_at = (f", metrics on {args.host}:{metrics_port}"
                  if metrics_port else "")
    worker = (f" [frontend worker {worker_index}/{args.frontends}]"
              if worker_index is not None else "")
    # the bound ports: ``--http-port 0`` / ``--grpc-port 0`` take free ones
    scheme = "HTTPS" if tls is not None else "HTTP"
    grpc_scheme = "grpcs" if tls is not None else "grpc"
    print(f"serving v2 {scheme} on {args.host}:{server.server_address[1]} "
          f"{grpc_scheme}={args.host}:{grpc.server_address[1]} "
          f"(device {args.device}){metrics_at}{worker}", flush=True)
    try:
        server.serve_forever()
    finally:
        for srv in servers:
            srv.server_close()
        core.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
