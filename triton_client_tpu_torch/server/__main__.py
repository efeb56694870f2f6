"""``python -m triton_client_tpu_torch.server``: serve the port's model zoo
over the v2 HTTP protocol, and v2 gRPC as gRPC-Web on the same port.

    python -m triton_client_tpu_torch.server --http-port 8000 [--device cuda|cpu]

Registers the reference's 25 models, by its names and in its order:
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
``--chaos-kinds`` of ``latency,error,abort,mem_pressure``,
``--chaos-seed``, ``--chaos-latency-ms``, ``--chaos-model``,
``--chaos-transient``, ``--chaos-pressure-s``,
``--chaos-pressure-factor``).  SIGTERM or SIGINT drains: new requests get
503 with ``Retry-After``, in-flight ones finish, and the process exits
within ``--drain-timeout`` seconds.

Observability (the reference's flags): ``--capture-slower-than P|MS``,
``--flight-recorder-size``, ``--flight-recorder-outliers`` and
``--no-flight-recorder`` set the flight recorder; ``--slo
MODEL=P99_MS[:AVAILABILITY]`` (repeatable) and ``--slo-burn-threshold``
the SLO engine; ``--no-device-stats`` turns the device statistics off;
``--metrics-port`` (default 8002, 0 for none) serves ``/metrics`` and the
debug snapshots on a second listener (they are on the HTTP port either
way).  Tracing and logging are set at run time through
``/v2/trace/setting`` and ``/v2/logging``.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading
import time

from ..models import zoo
from .chaos import build_injector
from .core import InferenceCore
from .device_stats import parse_slo_spec
from .http_server import HttpServer, MetricsServer
from .memory import DEFAULT_MAX_REQUEST_BYTES
from .qos import QosManager, parse_tenant_limit
from .registry import ModelRegistry
from .types import InferError


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
                    help="comma list of latency,error,abort,mem_pressure "
                    "(default: error)")
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m triton_client_tpu_torch.server")
    ap.add_argument("--http-port", type=int, default=8000)
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
    _add_admission_flags(ap)
    args = ap.parse_args(argv)

    registry = ModelRegistry()
    zoo.register_all(registry, device=args.device)
    core = InferenceCore(registry)
    _configure_admission(ap, args, core)
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
    server = HttpServer(core, args.host, args.http_port,
                        max_request_bytes=args.max_request_bytes)
    servers = [server]
    if args.metrics_port:
        metrics = MetricsServer(core, args.host, args.metrics_port)
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
        while server.active > 0 and time.monotonic() < end:
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
    metrics_at = (f", metrics on {args.host}:{args.metrics_port}"
                  if args.metrics_port else "")
    print(f"serving v2 HTTP on {args.host}:{args.http_port} "
          f"(device {args.device}){metrics_at}", flush=True)
    try:
        server.serve_forever()
    finally:
        for srv in servers:
            srv.server_close()
        core.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
