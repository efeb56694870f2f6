"""Language-model zoo entries of the port: the long-context scorer.

Counterpart of ``triton_client_tpu/models/language.py`` for ``longctx_tpu``:
the same presets, the same ``TRITON_TPU_LONGCTX_PRESET`` override, the same
seed-11 weights recipe (drawn with ``torch.Generator``, so not the
reference's numbers; pass ``params=`` to serve the reference's weights), and
the same wire contract ``TOKENS INT32 [S] -> LOGPROBS FP32 [S]``.  The
preset follows the requested device where the reference followed the JAX
platform: ``base`` on CUDA, ``tiny`` on the CPU.

``bert_large``, the MoE scorer and the Llama ensemble are not ported yet.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..server.model import TorchModel, make_config
from . import transformer as tr

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
                gen = torch.Generator().manual_seed(self._seed)
                params = tr.init_params(gen, self.cfg, self.device)
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
        instance_kind="KIND_CPU" if dev.type == "cpu" else "KIND_GPU",
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
