"""The port's model zoo.

Counterpart of ``triton_client_tpu/models/zoo.py``: the protocol fixtures
that the reference's examples and clients are written against, and
:func:`register_all`, which serves them beside ``resnet50``
(``models/vision.py``) and the language models of ``models/language.py``.

* ``simple`` (two INT32 [1, 16] inputs, their sum and difference),
  ``simple_int8`` (the same in INT8, wrapping), ``simple_string`` (the same
  over decimal strings, BYTES);
* identities: ``simple_identity`` (BYTES), ``custom_identity_int32`` (with
  the ``execute_delay_ms`` request parameter), ``identity_fp32``,
  ``identity_bf16``;
* stateful sequences: ``simple_sequence`` (a running sum per correlation
  id) and ``simple_dyna_sequence`` (seeded from the id at the start);
* decoupled: ``repeat_int32`` (one response per value) and
  ``square_int32`` (n responses of n);
* ``dense_tpu`` (a bf16 MLP on the device, dynamic batching),
  ``simple_cnn`` (a host image classifier with labels), ``scale_by_two``
  and ``ensemble_scale_sum`` (scale_by_two, then simple).

Host fixtures stay on the host (``KIND_CPU``), as the reference's do.
``dense_tpu`` and ``simple_cnn`` draw their weights from a
``torch.Generator`` at the first request, so not the reference's numbers;
``params=`` (numpy arrays) serves the reference's.  ``llama_decode`` and
``llama_generate`` (``models/decode.py``) share one set of ``llama_tpu``'s
weights, built at the first request.
"""

from __future__ import annotations

import threading
import time as _time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import instance_kind, resolve_device
from ..server.model import (EnsembleModel, EnsembleStep, Model, PyModel,
                            TorchModel, make_config)
from ..server.registry import ModelRegistry
from ..server.types import InferError


def make_simple() -> TorchModel:
    cfg = make_config(
        "simple",
        inputs=[("INPUT0", "INT32", [1, 16]), ("INPUT1", "INT32", [1, 16])],
        outputs=[("OUTPUT0", "INT32", [1, 16]),
                 ("OUTPUT1", "INT32", [1, 16])],
        # host math: the protocol path must not pay device transfers
        instance_kind="KIND_CPU",
    )

    def fn(INPUT0, INPUT1):
        return {"OUTPUT0": INPUT0 + INPUT1, "OUTPUT1": INPUT0 - INPUT1}

    return TorchModel(cfg, fn)


def make_simple_string() -> PyModel:
    """Element-wise sum and difference of decimal-string tensors: BYTES
    in, BYTES out, arithmetic on the parsed integers."""
    cfg = make_config(
        "simple_string",
        inputs=[("INPUT0", "BYTES", [1, 16]), ("INPUT1", "BYTES", [1, 16])],
        outputs=[("OUTPUT0", "BYTES", [1, 16]),
                 ("OUTPUT1", "BYTES", [1, 16])],
    )

    def _ints(arr):
        flat = np.asarray(arr, dtype=object).reshape(-1)
        return np.array(
            [int(v.decode() if isinstance(v, bytes) else v) for v in flat])

    def fn(inputs, params):
        shape = np.asarray(inputs["INPUT0"], dtype=object).shape

        def enc(vals):
            return np.array([str(int(v)).encode() for v in vals],
                            dtype=object).reshape(shape)

        a, b = _ints(inputs["INPUT0"]), _ints(inputs["INPUT1"])
        return {"OUTPUT0": enc(a + b), "OUTPUT1": enc(a - b)}

    return PyModel(cfg, fn)


def make_simple_int8() -> TorchModel:
    """INT8 sum and difference (wrapping, as int8 arithmetic does)."""
    cfg = make_config(
        "simple_int8",
        inputs=[("INPUT0", "INT8", [1, 16]), ("INPUT1", "INT8", [1, 16])],
        outputs=[("OUTPUT0", "INT8", [1, 16]), ("OUTPUT1", "INT8", [1, 16])],
        instance_kind="KIND_CPU",
    )

    def fn(INPUT0, INPUT1):
        return {"OUTPUT0": INPUT0 + INPUT1, "OUTPUT1": INPUT0 - INPUT1}

    return TorchModel(cfg, fn)


def make_simple_identity() -> PyModel:
    cfg = make_config(
        "simple_identity",
        inputs=[("INPUT0", "BYTES", [-1])],
        outputs=[("OUTPUT0", "BYTES", [-1])],
        max_batch_size=8,
    )

    def fn(inputs, params):
        return {"OUTPUT0": inputs["INPUT0"]}

    return PyModel(cfg, fn)


def make_custom_identity_int32() -> PyModel:
    """Passthrough that first sleeps for the ``execute_delay_ms`` request
    parameter (capped at 30 s; what a client's timeout tests drive)."""
    cfg = make_config(
        "custom_identity_int32",
        inputs=[("INPUT0", "INT32", [-1])],
        outputs=[("OUTPUT0", "INT32", [-1])],
        max_batch_size=8,
    )

    def fn(inputs, params):
        try:
            delay_s = float(params.get("execute_delay_ms", 0)) / 1e3
        except (TypeError, ValueError):
            delay_s = 0.0
        if delay_s > 0:
            _time.sleep(min(delay_s, 30.0))
        return {"OUTPUT0": inputs["INPUT0"]}

    return PyModel(cfg, fn)


def _identity(name: str, datatype: str) -> TorchModel:
    cfg = make_config(
        name,
        inputs=[("INPUT0", datatype, [-1])],
        outputs=[("OUTPUT0", datatype, [-1])],
        max_batch_size=64,
        instance_kind="KIND_CPU",
    )
    return TorchModel(cfg, lambda INPUT0: {"OUTPUT0": INPUT0})


def make_identity_fp32() -> TorchModel:
    return _identity("identity_fp32", "FP32")


def make_identity_bf16() -> TorchModel:
    """BF16 passthrough: the bits come back as they went in."""
    return _identity("identity_bf16", "BF16")


class SequenceModel(Model):
    """A running sum per sequence: each request carries one INT32 [1]
    value and gets the sum so far of its correlation id (int or string,
    the ``sequence_id`` parameter); ``sequence_start`` resets it,
    ``sequence_end`` drops it, and a sequence idle longer than the config's
    ``max_sequence_idle_microseconds`` is dropped too."""

    def __init__(self, name: str = "simple_sequence"):
        cfg = make_config(
            name,
            inputs=[("INPUT", "INT32", [1])],
            outputs=[("OUTPUT", "INT32", [1])],
            sequence_batching=True,
        )
        super().__init__(cfg)
        self._state: Dict[Any, int] = {}
        self._touched: Dict[Any, float] = {}
        self._idle_s = cfg.max_sequence_idle_microseconds / 1e6
        self._lock = threading.Lock()

    def _evict_idle_locked(self, now: float) -> None:
        stale = [k for k, t in self._touched.items()
                 if now - t > self._idle_s]
        for k in stale:
            self._state.pop(k, None)
            self._touched.pop(k, None)

    def execute(self, inputs, parameters):
        seq_id = parameters.get("sequence_id", 0)
        start = bool(parameters.get("sequence_start", False))
        end = bool(parameters.get("sequence_end", False))
        if not seq_id:
            raise InferError(
                f"inference request to model '{self.name}' must specify a "
                "non-zero or non-empty correlation ID")
        value = int(np.asarray(inputs["INPUT"]).reshape(-1)[0])
        now = _time.monotonic()
        with self._lock:
            self._evict_idle_locked(now)
            if start or seq_id not in self._state:
                self._state[seq_id] = 0
            self._state[seq_id] += value
            acc = self._state[seq_id]
            if end:
                del self._state[seq_id]
                self._touched.pop(seq_id, None)
            else:
                self._touched[seq_id] = now
        return {"OUTPUT": np.array([acc], dtype=np.int32).reshape(1)}


class DynaSequenceModel(SequenceModel):
    """``simple_dyna_sequence``: at the start the sum is seeded from the
    correlation id, so interleaved sequences read apart -- an int id
    wrapped to int32, a string id ``hash(str(id)) % 1000``, as the
    reference does (Python salts string hashes per process, so that value
    holds within one process)."""

    def __init__(self):
        super().__init__("simple_dyna_sequence")

    def execute(self, inputs, parameters):
        seq_id = parameters.get("sequence_id", 0)
        if bool(parameters.get("sequence_start", False)) and seq_id:
            corr = (hash(str(seq_id)) % 1000 if isinstance(seq_id, str)
                    else int(seq_id))
            with self._lock:
                self._state[seq_id] = int(np.int64(corr).astype(np.int32))
                self._touched[seq_id] = _time.monotonic()
            parameters = dict(parameters, sequence_start=False)
        return super().execute(inputs, parameters)


def make_repeat_int32() -> PyModel:
    """Decoupled: ``IN [n]`` values, ``DELAY [n]`` (us, slept before each
    response), ``WAIT`` (us, slept after the last); one response per value
    with ``OUT`` the value and ``IDX`` its index."""
    cfg = make_config(
        "repeat_int32",
        inputs=[("IN", "INT32", [-1]), ("DELAY", "UINT32", [-1]),
                ("WAIT", "UINT32", [1])],
        outputs=[("OUT", "INT32", [1]), ("IDX", "UINT32", [1])],
        decoupled=True,
    )

    def gen(inputs, params) -> Iterator[Dict[str, np.ndarray]]:
        values = np.asarray(inputs["IN"]).reshape(-1)
        delays = np.asarray(inputs.get("DELAY", np.zeros_like(values))
                            ).reshape(-1)
        wait = int(np.asarray(inputs.get("WAIT", [0])).reshape(-1)[0])
        for i, v in enumerate(values):
            if i < len(delays):
                _time.sleep(int(delays[i]) / 1e6)
            yield {"OUT": np.array([v], dtype=np.int32),
                   "IDX": np.array([i], dtype=np.uint32)}
        if wait:
            _time.sleep(wait / 1e6)

    return PyModel(cfg, fn=None, decoupled_fn=gen)


def make_square_int32() -> PyModel:
    """Decoupled: scalar ``IN`` = n gives n responses, each ``OUT`` = n
    (none for n <= 0)."""
    cfg = make_config(
        "square_int32",
        inputs=[("IN", "INT32", [1])],
        outputs=[("OUT", "INT32", [1])],
        decoupled=True,
    )

    def gen(inputs, params):
        n = int(np.asarray(inputs["IN"]).reshape(-1)[0])
        for _ in range(max(n, 0)):
            yield {"OUT": np.array([n], dtype=np.int32)}

    return PyModel(cfg, fn=None, decoupled_fn=gen)


class _LazyParams:
    """A weight dict built once, at the first request."""

    def __init__(self, build):
        self._build = build
        self._lock = threading.Lock()
        self.params: Optional[Dict[str, torch.Tensor]] = None

    def get(self) -> Dict[str, torch.Tensor]:
        with self._lock:
            if self.params is None:
                self.params = self._build()
            return self.params


def _tensors(params: Dict[str, np.ndarray], dtype, dev):
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev, dtype)
            for k, v in params.items()}


DENSE_D = 512


def make_dense_tpu(device=None,
                   params: Optional[Dict[str, np.ndarray]] = None
                   ) -> TorchModel:
    """A batched bf16 MLP on the device (``relu(x @ w1) @ w2``, D -> 2D ->
    D, f32 out) with dynamic batching, for the device path; its weights
    ``w1``, ``w2`` are normal x 0.05 (seed 0), or ``params``."""
    D = DENSE_D
    dev = resolve_device(device)
    cfg = make_config(
        "dense_tpu",
        inputs=[("INPUT", "FP32", [D])],
        outputs=[("OUTPUT", "FP32", [D])],
        max_batch_size=64,
        preferred_batch_sizes=[8, 16, 32, 64],
        max_queue_delay_us=2000,
        instance_kind=instance_kind(dev),
        # two matmuls (D -> 2D -> D): 8 * D^2 FLOPs per row
        parameters={"flops_per_inference": str(8 * D * D)},
    )

    def build():
        if params is not None:
            return _tensors(params, torch.bfloat16, dev)
        gen = torch.Generator(dev).manual_seed(0)
        return {n: (torch.randn(shape, generator=gen, device=dev) * 0.05)
                .to(torch.bfloat16)
                for n, shape in (("w1", (D, 2 * D)), ("w2", (2 * D, D)))}

    weights = _LazyParams(build)

    def fn(INPUT):
        p = weights.get()
        h = torch.relu(INPUT.to(torch.bfloat16) @ p["w1"])
        return {"OUTPUT": (h @ p["w2"]).float()}

    model = TorchModel(cfg, fn)
    model.weights = weights
    return model


def make_simple_cnn(params: Optional[Dict[str, np.ndarray]] = None
                    ) -> TorchModel:
    """A small host image classifier with labels, for ``image_client``'s
    ``class_count`` path: FP32 CHW [3, 224, 224] -> a 4x4/4 convolution to
    8 channels, ReLU, 4x4/4 max pooling, a dense layer -> [1000].  Weights
    ``conv_w`` (OIHW, normal x 0.1) and ``dense_w`` (normal x 0.02), seed
    7, or ``params``."""
    labels = [f"class_{i}" for i in range(1000)]
    cfg = make_config(
        "simple_cnn",
        inputs=[("INPUT", "FP32", [3, 224, 224])],
        outputs=[("OUTPUT", "FP32", [1000])],
        max_batch_size=8,
        instance_kind="KIND_CPU",
        labels={"OUTPUT": labels},
    )
    dev = torch.device("cpu")

    def build():
        if params is not None:
            return _tensors(params, torch.float32, dev)
        gen = torch.Generator(dev).manual_seed(7)
        return {"conv_w": torch.randn((8, 3, 4, 4), generator=gen) * 0.1,
                "dense_w": torch.randn((8 * 14 * 14, 1000),
                                       generator=gen) * 0.02}

    weights = _LazyParams(build)

    def fn(INPUT):
        p = weights.get()
        y = F.relu(F.conv2d(INPUT, p["conv_w"], stride=4))
        y = F.max_pool2d(y, 4, 4)
        return {"OUTPUT": y.reshape(y.shape[0], -1) @ p["dense_w"]}

    return TorchModel(cfg, fn, output_labels={"OUTPUT": labels})


def make_scale_by_two() -> TorchModel:
    cfg = make_config(
        "scale_by_two",
        inputs=[("INPUT", "INT32", [1, 16])],
        outputs=[("OUTPUT", "INT32", [1, 16])],
        instance_kind="KIND_CPU",
    )
    return TorchModel(cfg, lambda INPUT: {"OUTPUT": INPUT * 2})


def make_ensemble_scale_sum() -> EnsembleModel:
    """scale_by_two(RAW0), then simple with RAW1: SUM and DIFF."""
    cfg = make_config(
        "ensemble_scale_sum",
        inputs=[("RAW0", "INT32", [1, 16]), ("RAW1", "INT32", [1, 16])],
        outputs=[("SUM", "INT32", [1, 16]), ("DIFF", "INT32", [1, 16])],
        platform="ensemble",
        backend="",
        ensemble_scheduling=[
            EnsembleStep("scale_by_two", {"INPUT": "RAW0"},
                         {"OUTPUT": "scaled0"}),
            EnsembleStep("simple", {"INPUT0": "scaled0", "INPUT1": "RAW1"},
                         {"OUTPUT0": "SUM", "OUTPUT1": "DIFF"}),
        ],
    )
    return EnsembleModel(cfg)


def make_llama_decode(device=None,
                      params: Optional[Dict[str, np.ndarray]] = None):
    """The ``DecodeModel`` behind ``llama_decode`` (its ``.model``) and
    ``llama_generate`` (``decode.make_llama_generate`` of it): the
    ``TRITON_TPU_LLAMA_PRESET`` preset for ``device`` (``1b`` on CUDA,
    ``tiny`` on the CPU), ``llama_tpu``'s seed, or ``params``."""
    from .decode import DecodeModel

    return DecodeModel(device=device, params=params)


def register_all(registry: ModelRegistry, device=None) -> None:
    """Register every ported model in the reference's order; the device
    models on ``device`` (default CUDA).  Registration is cheap: each
    device model draws its weights at its first request."""
    from . import language, vision
    from .decode import make_llama_generate

    registry.register_model(make_simple())
    registry.register_model(vision.make_resnet50(device))
    registry.register_model(language.make_bert_large(device))
    registry.register_model(language.make_llama_preprocess())
    registry.register_model(language.make_llama_tpu(device))
    registry.register_model(language.make_llama_postprocess())
    registry.register_model(language.make_ensemble_llama())
    registry.register_model(language.make_longctx_tpu(device))
    registry.register_model(language.make_moe_tpu(device))
    decode = make_llama_decode(device)
    registry.register_model(decode.model)
    registry.register_model(make_llama_generate(decode))
    registry.register_model(make_simple_string())
    registry.register_model(make_simple_int8())
    registry.register_model(make_simple_identity())
    registry.register_model(make_custom_identity_int32())
    registry.register_model(make_identity_fp32())
    registry.register_model(make_identity_bf16())
    registry.register_model(SequenceModel())
    registry.register_model(DynaSequenceModel())
    registry.register_model(make_repeat_int32())
    registry.register_model(make_square_int32())
    registry.register_model(make_dense_tpu(device))
    registry.register_model(make_simple_cnn())
    registry.register_model(make_scale_by_two())
    registry.register_model(make_ensemble_scale_sum())
