"""``python -m triton_client_tpu_torch.server``: serve the port's model zoo
over the v2 HTTP protocol, and v2 gRPC as gRPC-Web on the same port.

    python -m triton_client_tpu_torch.server --http-port 8000 [--device cuda|cpu]

Registers 23 models, by the reference's names and in its order: ``simple``,
``resnet50``, ``bert_large``, ``ensemble_llama`` (with its
``llama_preprocess``, ``llama_tpu`` and ``llama_postprocess`` steps),
``longctx_tpu``, ``moe_tpu``, and the fixtures ``simple_string``,
``simple_int8``, ``simple_identity``, ``custom_identity_int32``,
``identity_fp32``, ``identity_bf16``, ``simple_sequence``,
``simple_dyna_sequence``, ``repeat_int32`` and ``square_int32`` (decoupled:
gRPC streams only), ``dense_tpu``, ``simple_cnn``, ``scale_by_two`` and
``ensemble_scale_sum``.  The decode model and ``llama_generate`` are not
ported yet (ROADMAP A7).

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

from ..models import zoo
from .core import InferenceCore
from .device_stats import parse_slo_spec
from .http_server import HttpServer, MetricsServer
from .registry import ModelRegistry
from .types import InferError


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
    args = ap.parse_args(argv)

    registry = ModelRegistry()
    zoo.register_all(registry, device=args.device)
    core = InferenceCore(registry)
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
    server = HttpServer(core, args.host, args.http_port)
    servers = [server]
    if args.metrics_port:
        metrics = MetricsServer(core, args.host, args.metrics_port)
        servers.append(metrics)
        threading.Thread(target=metrics.serve_forever, daemon=True,
                         name="tc-torch-metrics").start()

    def _stop(signum, frame):
        # shutdown() waits for serve_forever to return: call it off the
        # main thread, which is the one serving
        for srv in servers:
            threading.Thread(target=srv.shutdown, daemon=True).start()

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
