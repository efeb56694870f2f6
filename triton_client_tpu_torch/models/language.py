"""Language-model zoo entries of the port (BASELINE rows 4 and 5).

Counterpart of ``triton_client_tpu/models/language.py``, model for model:

* ``bert_large``: the BERT-large shape (24 layers, d_model 1024, 16 heads,
  d_ff 4096, bidirectional), ``INPUT_IDS INT32 [384] -> LOGITS FP32
  [384, 2]`` through a span head that projects only its 2 columns;
* ``longctx_tpu``: the long-context scorer, ``TOKENS INT32 [S] ->
  LOGPROBS FP32 [S]``;
* ``moe_tpu``: a mixture-of-experts next-token model, ``TOKENS INT32 [S]
  -> NEXT_TOKEN INT32 [1], NEXT_LOGIT FP32 [1]``;
* ``llama_preprocess`` -> ``llama_tpu`` -> ``llama_postprocess``, chained
  by ``ensemble_llama``: ``TEXT BYTES [1] -> OUT_TEXT BYTES [1]`` (and
  ``NEXT_TOKEN``), byte-level tokens over a 128-token window.

The same presets, ``TRITON_TPU_*_PRESET`` overrides, seeds and wire
contracts as the reference.  Weights are drawn with ``torch.Generator`` on
the model's device, so not the reference's numbers; pass ``params=`` (a
numpy dict in the reference's layout) to serve the reference's weights.  A
preset follows the requested device where the reference followed the JAX
platform: the full-size one on CUDA, ``tiny`` on the CPU.  ``bert_large``
has no preset.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional

import numpy as np
import torch

from ..device import instance_kind, resolve_device
from ..server.model import (EnsembleModel, EnsembleStep, PyModel,
                            TorchModel, make_config)
from . import transformer as tr

BERT_LARGE = tr.TransformerConfig(
    vocab_size=30522, d_model=1024, n_layers=24, n_heads=16,
    head_dim=64, d_ff=4096, n_experts=0, causal=False,
)

# Llama-architecture presets (RMSNorm + RoPE + SiLU FFN); "8b" is the real
# Llama-3-8B shape
_LLAMA_PRESETS = {
    "tiny": tr.TransformerConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, head_dim=16,
        d_ff=128, n_experts=0),
    "tiny-moe": tr.TransformerConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, head_dim=16,
        d_ff=128, n_experts=4, moe_top_k=2),
    "1b": tr.TransformerConfig(
        vocab_size=128256, d_model=2048, n_layers=16, n_heads=16,
        head_dim=128, d_ff=8192, n_experts=0),
    "8b": tr.LLAMA3_8B,
}

BERT_SEQ_LEN = 384   # BERT-large SQuAD serving length
BERT_HEAD_COLS = 2   # span head: start/end logits
LLAMA_SEQ_LEN = 128  # the generation ensemble's fixed window

# Each preset carries its serving window so config and S can't drift.
_LONGCTX_PRESETS = {
    "tiny": (tr.TransformerConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, head_dim=16,
        d_ff=128, n_experts=0), 512),
    "base": (tr.TransformerConfig(
        vocab_size=256, d_model=1024, n_layers=8, n_heads=16, head_dim=64,
        d_ff=4096, n_experts=0), 4096),
    "xl": (tr.TransformerConfig(
        vocab_size=256, d_model=1024, n_layers=8, n_heads=16, head_dim=64,
        d_ff=4096, n_experts=0), 8192),
}


def _env_preset(var: str, presets, device, gpu_default: str,
                cpu_default: str) -> str:
    """``var`` if set, else the default for the requested device; unknown
    names raise with the variable spelled out."""
    name = os.environ.get(var)
    if name is None:
        name = cpu_default if resolve_device(device).type == "cpu" \
            else gpu_default
    if name not in presets:
        raise ValueError(
            f"{var}={name!r} is not a valid preset; choose one of "
            f"{sorted(presets)}")
    return name


def _longctx_preset(device=None) -> str:
    return _env_preset("TRITON_TPU_LONGCTX_PRESET", _LONGCTX_PRESETS, device,
                       gpu_default="base", cpu_default="tiny")


def longctx_cfg(device=None) -> tr.TransformerConfig:
    return _LONGCTX_PRESETS[_longctx_preset(device)][0]


def longctx_seq_len(device=None) -> int:
    return _LONGCTX_PRESETS[_longctx_preset(device)][1]


_MOE_PRESETS = {
    "tiny": (tr.TransformerConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, head_dim=16,
        d_ff=128, n_experts=4, moe_top_k=2), 128),
    "base": (tr.TransformerConfig(
        vocab_size=256, d_model=512, n_layers=4, n_heads=8, head_dim=64,
        d_ff=2048, n_experts=8, moe_top_k=2), 256),
}


def _moe_preset(device=None) -> str:
    return _env_preset("TRITON_TPU_MOE_PRESET", _MOE_PRESETS, device,
                       gpu_default="base", cpu_default="tiny")


def moe_cfg(device=None) -> tr.TransformerConfig:
    return _MOE_PRESETS[_moe_preset(device)][0]


def moe_seq_len(device=None) -> int:
    return _MOE_PRESETS[_moe_preset(device)][1]


def llama_cfg(device=None) -> tr.TransformerConfig:
    return _LLAMA_PRESETS[_env_preset(
        "TRITON_TPU_LLAMA_PRESET", _LLAMA_PRESETS, device,
        gpu_default="1b", cpu_default="tiny")]


def n_params(cfg: tr.TransformerConfig) -> int:
    """Parameter count (dense FFN presets)."""
    per_layer = (
        4 * cfg.d_model * cfg.n_heads * cfg.head_dim  # wq wk wv wo
        + 2 * cfg.d_model                              # ln1 ln2
        + 2 * cfg.d_model * cfg.d_ff                   # w1 w2
    )
    embed = cfg.vocab_size * cfg.d_model
    head = cfg.d_model * cfg.vocab_size
    return cfg.n_layers * per_layer + embed + head + cfg.d_model


def forward_flops_per_token(cfg: tr.TransformerConfig, seq_len: int,
                            head_cols: Optional[int] = None) -> float:
    """About 2 * params matmul FLOPs per token plus the attention score and
    value terms (causal counted in full, an upper bound)."""
    matmul = 2.0 * (n_params(cfg) - cfg.vocab_size * cfg.d_model)
    if head_cols is not None:
        matmul += 2.0 * cfg.d_model * (head_cols - cfg.vocab_size)
    attn = 4.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim * seq_len
    return matmul + attn


class LazyTransformer:
    """Params and forward built on first call, on one device.

    ``TRITON_TPU_QUANT[_<MODEL>]=int8`` quantizes the layer weights and runs
    the int8 path.  ``params`` (a numpy dict in the reference's layout)
    replaces the seeded init."""

    def __init__(self, cfg: tr.TransformerConfig, seed: int, device,
                 model_name: Optional[str] = None,
                 head_cols: Optional[int] = None,
                 params: Optional[Dict[str, np.ndarray]] = None):
        self.cfg = cfg
        self.device = device
        self._seed = seed
        self._model_name = model_name
        self._head_cols = head_cols
        self._np_params = params
        self._lock = threading.Lock()
        self._fwd = None
        self.params: Optional[Dict[str, torch.Tensor]] = None

    def _ensure(self):
        with self._lock:
            if self._fwd is not None:
                return
            if self._np_params is not None:
                params = tr.params_from_jax(self._np_params, self.cfg,
                                            self.device)
            else:
                gen = torch.Generator(self.device).manual_seed(self._seed)
                params = tr.init_params(gen, self.cfg)
            quant = tr.resolve_quant(self._model_name)
            if quant == "int8":
                params = tr.quantize_layer_weights(params, self.cfg)
            self.params = params
            self._fwd = tr.make_forward(self.cfg, quantized=(quant == "int8"),
                                        head_cols=self._head_cols)

    def __call__(self, tokens):
        self._ensure()
        return self._fwd(self.params, tokens)


def longctx_scores(logits, tokens):
    """Per-position logprob of the next provided token; 0 at the last slot."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nxt = tokens[:, 1:].long()
    scores = torch.gather(logp[:, :-1, :], -1, nxt[..., None])[..., 0]
    return torch.nn.functional.pad(scores, (0, 1))


def make_bert_large(device=None,
                    params: Optional[Dict[str, np.ndarray]] = None
                    ) -> TorchModel:
    """BASELINE row 4: INT32 INPUT_IDS [384] -> FP32 LOGITS [384, 2]
    (start/end span logits), the BERT-large stack with dynamic batching up
    to 32 (12,288 tokens an execution).  Full width on every device; on
    CUDA its attention (S = 384, under the flash gate) is the ring's."""
    dev = resolve_device(device)
    cfg = make_config(
        "bert_large",
        inputs=[("INPUT_IDS", "INT32", [BERT_SEQ_LEN])],
        outputs=[("LOGITS", "FP32", [BERT_SEQ_LEN, 2])],
        max_batch_size=32,
        preferred_batch_sizes=[1, 2, 4, 8, 16, 32],
        max_queue_delay_us=3000,
        instance_kind=instance_kind(dev),
        parameters={"flops_per_inference": str(
            BERT_SEQ_LEN * forward_flops_per_token(
                BERT_LARGE, BERT_SEQ_LEN, head_cols=BERT_HEAD_COLS))},
    )
    run = LazyTransformer(BERT_LARGE, seed=24, device=dev,
                          model_name="bert_large", head_cols=BERT_HEAD_COLS,
                          params=params)

    def fn(INPUT_IDS):
        tokens = torch.clamp(INPUT_IDS, 0, BERT_LARGE.vocab_size - 1)
        return {"LOGITS": run(tokens)}

    model = TorchModel(cfg, fn)
    model.transformer = run
    return model


def next_token(logits):
    """Greedy head over the last position: (NEXT_TOKEN [B, 1] int32,
    NEXT_LOGIT [B, 1] f32)."""
    last = logits[:, -1, :].float()
    return (last.argmax(dim=-1).to(torch.int32)[:, None],
            last.amax(dim=-1)[:, None])


def _next_token_model(name: str, cfg_t: tr.TransformerConfig, seq_len: int,
                      seed: int, dev: torch.device,
                      params: Optional[Dict[str, np.ndarray]],
                      parameters: Optional[Dict[str, str]] = None
                      ) -> TorchModel:
    cfg = make_config(
        name,
        inputs=[("TOKENS", "INT32", [seq_len])],
        outputs=[("NEXT_TOKEN", "INT32", [1]), ("NEXT_LOGIT", "FP32", [1])],
        max_batch_size=8,
        preferred_batch_sizes=[1, 2, 4, 8],
        max_queue_delay_us=2000,
        instance_kind=instance_kind(dev),
        parameters=parameters,
    )
    run = LazyTransformer(cfg_t, seed=seed, device=dev, model_name=name,
                          params=params)

    def fn(TOKENS):
        tokens = torch.clamp(TOKENS, 0, cfg_t.vocab_size - 1)
        nxt, best = next_token(run(tokens))
        return {"NEXT_TOKEN": nxt, "NEXT_LOGIT": best}

    model = TorchModel(cfg, fn)
    model.transformer = run
    return model


def make_moe_tpu(device=None,
                 params: Optional[Dict[str, np.ndarray]] = None
                 ) -> TorchModel:
    """MoE next-token model: INT32 TOKENS [S] -> INT32 NEXT_TOKEN [1] +
    FP32 NEXT_LOGIT [1] (argmax and max over the last position), through
    the routed-expert FFN.  ``base`` preset on CUDA (8 experts, top 2,
    S = 256), ``tiny`` on the CPU; ``TRITON_TPU_MOE_PRESET`` overrides."""
    dev = resolve_device(device)
    return _next_token_model("moe_tpu", moe_cfg(dev), moe_seq_len(dev),
                             seed=17, dev=dev, params=params)


def make_llama_tpu(device=None,
                   params: Optional[Dict[str, np.ndarray]] = None
                   ) -> TorchModel:
    """Llama-architecture next-token model: INT32 TOKENS [128] -> INT32
    NEXT_TOKEN [1] + FP32 NEXT_LOGIT [1].  ``1b`` preset on CUDA, ``tiny``
    on the CPU; ``TRITON_TPU_LLAMA_PRESET`` overrides."""
    dev = resolve_device(device)
    cfg_t = llama_cfg(dev)
    return _next_token_model(
        "llama_tpu", cfg_t, LLAMA_SEQ_LEN, seed=3, dev=dev, params=params,
        parameters={"flops_per_inference": str(
            LLAMA_SEQ_LEN * forward_flops_per_token(cfg_t, LLAMA_SEQ_LEN))})


def make_llama_preprocess() -> PyModel:
    """BYTES TEXT [1] -> INT32 TOKENS [128]: byte-level tokens (the last
    128 bytes), left-padded with 0; every preset's vocab covers 0..255."""
    cfg = make_config(
        "llama_preprocess",
        inputs=[("TEXT", "BYTES", [1])],
        outputs=[("TOKENS", "INT32", [LLAMA_SEQ_LEN])],
        max_batch_size=8,
    )

    def fn(inputs, params):
        texts = np.asarray(inputs["TEXT"]).reshape(-1)
        out = np.zeros((len(texts), LLAMA_SEQ_LEN), np.int32)
        for i, t in enumerate(texts):
            raw = t if isinstance(t, (bytes, bytearray)) else str(t).encode()
            b = np.frombuffer(bytes(raw[-LLAMA_SEQ_LEN:]), np.uint8)
            out[i, LLAMA_SEQ_LEN - len(b):] = b
        return {"TOKENS": out}

    return PyModel(cfg, fn)


def make_llama_postprocess() -> PyModel:
    """INT32 NEXT_TOKEN [1] -> BYTES OUT_TEXT [1]: ``bytes([t % 256])``."""
    cfg = make_config(
        "llama_postprocess",
        inputs=[("NEXT_TOKEN", "INT32", [1])],
        outputs=[("OUT_TEXT", "BYTES", [1])],
        max_batch_size=8,
    )

    def fn(inputs, params):
        toks = np.asarray(inputs["NEXT_TOKEN"]).reshape(-1)
        texts = np.array([bytes([int(t) % 256]) for t in toks], dtype=object)
        return {"OUT_TEXT": texts.reshape(len(toks), 1)}

    return PyModel(cfg, fn)


def make_ensemble_llama() -> EnsembleModel:
    """BASELINE row 5: TEXT -> llama_preprocess -> llama_tpu ->
    llama_postprocess -> OUT_TEXT, with NEXT_TOKEN surfaced too.  The core
    runs the steps; ``llama_tpu``'s batcher coalesces concurrent requests."""
    cfg = make_config(
        "ensemble_llama",
        inputs=[("TEXT", "BYTES", [1])],
        outputs=[("OUT_TEXT", "BYTES", [1]), ("NEXT_TOKEN", "INT32", [1])],
        max_batch_size=8,
        platform="ensemble",
        backend="",
        ensemble_scheduling=[
            EnsembleStep("llama_preprocess", {"TEXT": "TEXT"},
                         {"TOKENS": "_tokens"}),
            EnsembleStep("llama_tpu", {"TOKENS": "_tokens"},
                         {"NEXT_TOKEN": "NEXT_TOKEN",
                          "NEXT_LOGIT": "_logit"}),
            EnsembleStep("llama_postprocess", {"NEXT_TOKEN": "NEXT_TOKEN"},
                         {"OUT_TEXT": "OUT_TEXT"}),
        ],
    )
    return EnsembleModel(cfg)


def make_longctx_tpu(device=None,
                     params: Optional[Dict[str, np.ndarray]] = None
                     ) -> TorchModel:
    """Long-context document scorer: INT32 TOKENS [S] -> FP32 LOGPROBS [S].

    ``device`` defaults to CUDA (``base`` preset, S = 4096, attention
    through the flash kernel); ``device="cpu"`` serves the ``tiny`` preset
    (S = 512) with the kernels' plain versions."""
    dev = resolve_device(device)
    cfg_t = longctx_cfg(dev)
    S = longctx_seq_len(dev)
    cfg = make_config(
        "longctx_tpu",
        inputs=[("TOKENS", "INT32", [S])],
        outputs=[("LOGPROBS", "FP32", [S])],
        max_batch_size=4,
        preferred_batch_sizes=[1, 2, 4],
        max_queue_delay_us=2000,
        instance_kind=instance_kind(dev),
        parameters={"flops_per_inference": str(
            S * forward_flops_per_token(cfg_t, S))},
    )
    run = LazyTransformer(cfg_t, seed=11, device=dev,
                          model_name="longctx_tpu", params=params)

    def fn(TOKENS):
        tokens = torch.clamp(TOKENS, 0, cfg_t.vocab_size - 1)
        return {"LOGPROBS": longctx_scores(run(tokens), tokens)}

    model = TorchModel(cfg, fn)
    model.transformer = run
    return model
