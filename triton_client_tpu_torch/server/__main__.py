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
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

from ..models import zoo
from .core import InferenceCore
from .http_server import HttpServer
from .registry import ModelRegistry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m triton_client_tpu_torch.server")
    ap.add_argument("--http-port", type=int, default=8000)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    registry = ModelRegistry()
    zoo.register_all(registry, device=args.device)
    core = InferenceCore(registry)
    server = HttpServer(core, args.host, args.http_port)

    def _stop(signum, frame):
        # shutdown() waits for serve_forever to return: call it off the
        # main thread, which is the one serving
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    print(f"serving v2 HTTP on {args.host}:{args.http_port} "
          f"(device {args.device})", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        core.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
