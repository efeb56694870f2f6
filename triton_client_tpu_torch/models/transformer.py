"""The flagship transformer forward, single device, in PyTorch.

Counterpart of ``triton_client_tpu/models/transformer.py`` for serving:
the same parameter dict and layouts (``wq [L, D, H, K]``, ``wo [L, H, K, D]``,
``w1 [L, D, F]``, ``w2 [L, F, D]``, int8 weights with ``*_scale`` siblings),
the same knobs (``TRITON_TPU_FLASH``, ``TRITON_TPU_FLASH_MIN_S``,
``TRITON_TPU_INT8_FUSED``, ``TRITON_TPU_QUANT[_<MODEL>]``) with the same
defaults and loud rejection, and the same math per layer.  On one device
every ``psum`` of the reference is the identity, the layer ``scan`` is a
Python loop, and attention at ``sp = 1`` is the flash kernel at or above the
gate and the single-shard ring below it.

The MoE FFN is the reference's too: an f32 router keeps the top-k experts by
threshold, every expert runs densely and the outputs are weighted by the
routing probabilities; under int8 the expert weights are weight-only
(dequantized at use), so no int8 kernel runs in it.

Not ported yet: multi-device meshes, pipeline parallelism and the training
step.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.flash_attention import flash_attention, flash_attention_reference
from ..ops.int8_matmul import int8_matmul, int8_matmul_reference, int8_scale
from ..parallel.collectives import ring_attention


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 256
    d_model: int = 64
    n_layers: int = 4
    n_heads: int = 4
    head_dim: int = 16
    d_ff: int = 128
    n_experts: int = 2        # 0 => dense FFN, >0 => MoE FFN
    moe_top_k: int = 2
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16  # activation/compute dtype
    causal: bool = True

    @property
    def moe(self) -> bool:
        return self.n_experts > 0


# Llama-3-8B-shaped config (the same code path at the real model's widths)
LLAMA3_8B = TransformerConfig(
    vocab_size=128256, d_model=4096, n_layers=32, n_heads=32,
    head_dim=128, d_ff=14336, n_experts=0,
)

_LAYER_KEYS_DENSE = ("wq", "wk", "wv", "wo", "ln1", "ln2", "w1", "w2")
_LAYER_KEYS_MOE = ("wq", "wk", "wv", "wo", "ln1", "ln2", "router", "we1",
                   "we2")


def init_params(generator: torch.Generator, cfg: TransformerConfig
                ) -> Dict[str, torch.Tensor]:
    """Float32 init with the reference's shapes and scales, drawn on the
    generator's device (with a CUDA generator, Llama 1b's 1.3 B weights are
    drawn on the card, not on the host).

    ``torch.Generator`` draws differ from ``jax.random`` for the same seed;
    tests that compare the two packages carry the reference's weights across
    with :func:`params_from_jax` instead."""
    D, H, K, Fd, L, V = (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
                         cfg.n_layers, cfg.vocab_size)
    device = generator.device

    def normal(*shape, std):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=device) * std

    p = {
        "embed": normal(V, D, std=0.02),
        "wq": normal(L, D, H, K, std=1.0 / math.sqrt(D)),
        "wk": normal(L, D, H, K, std=1.0 / math.sqrt(D)),
        "wv": normal(L, D, H, K, std=1.0 / math.sqrt(D)),
        "wo": normal(L, H, K, D, std=1.0 / math.sqrt(H * K)),
        "ln1": torch.ones(L, D, device=device),
        "ln2": torch.ones(L, D, device=device),
        "final_ln": torch.ones(D, device=device),
        "head": normal(D, V, std=0.02),
    }
    if cfg.moe:
        E = cfg.n_experts
        p["router"] = normal(L, D, E, std=0.02)
        p["we1"] = normal(L, E, D, Fd, std=1.0 / math.sqrt(D))
        p["we2"] = normal(L, E, Fd, D, std=1.0 / math.sqrt(Fd))
    else:
        p["w1"] = normal(L, D, Fd, std=1.0 / math.sqrt(D))
        p["w2"] = normal(L, Fd, D, std=1.0 / math.sqrt(Fd))
    return p


def params_from_jax(np_params: Dict[str, np.ndarray], cfg: TransformerConfig,
                    device="cpu") -> Dict[str, torch.Tensor]:
    """The reference's parameter dict, carried across as numpy arrays.

    Layouts are kept as they are (the MoE keys ``router``, ``we1``, ``we2``
    too); float arrays become f32 tensors, int8 weights stay int8,
    ``*_scale`` siblings stay f32."""
    out = {}
    for name, arr in np_params.items():
        a = np.asarray(arr)
        t = torch.from_numpy(np.array(a, dtype=np.int8 if a.dtype == np.int8
                                      else np.float32, copy=True))
        out[name] = t.to(device)
    return out


def _contraction_innermost(w, axes):
    """``w`` with the same shape and values, stored with its contraction
    ``axes`` innermost: each layer's ``[K, N]`` matrix is K-major, the
    layout the int8 kernel and cuBLASLt's int8 GEMMs read without a copy."""
    perm = [d for d in range(w.dim()) if d not in axes] + list(axes)
    return w.permute(perm).contiguous().permute(np.argsort(perm).tolist())


def quantize_layer_weights(params: Dict[str, torch.Tensor],
                           cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    """Weight-only int8, symmetric, one scale per output channel (reduced
    over each weight's contraction axes), stored as ``<name>_scale``.

    The int8 weights keep the reference's shapes and values but are stored
    K-major (contraction axes innermost), once, so no call copies them.
    The MoE experts (``we1 [L, E, D, F]``, ``we2 [L, E, F, D]``) reduce
    over their middle dim per expert; the router stays fp (it picks the
    experts)."""
    contract_axes = {"wq": (1,), "wk": (1,), "wv": (1,),
                     "wo": (1, 2), "w1": (1,), "w2": (1,),
                     "we1": (2,), "we2": (2,)}
    out = dict(params)
    for k, axes in contract_axes.items():
        if k not in params:
            continue
        w = params[k].float()
        scale = int8_scale(w.abs().amax(dim=axes, keepdim=True))
        q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
        out[k] = _contraction_innermost(q, axes)
        out[k + "_scale"] = scale
    return out


def quant_env_key(model_name: str) -> str:
    return "TRITON_TPU_QUANT_" + "".join(
        c if c.isalnum() else "_" for c in model_name.upper())


def resolve_quant(model_name: Optional[str] = None) -> str:
    """Serving quantization mode: '' (bf16) or 'int8', from
    ``TRITON_TPU_QUANT_<MODEL>`` over ``TRITON_TPU_QUANT``; anything else
    raises naming the variable that was set."""
    var = "TRITON_TPU_QUANT"
    val = os.environ.get(var, "")
    if model_name:
        key = quant_env_key(model_name)
        per_model = os.environ.get(key)
        if per_model is not None:
            var, val = key, per_model
    val = val.strip().lower()
    if val in ("", "none", "bf16"):
        return ""
    if val == "int8":
        return "int8"
    raise ValueError(f"{var}={val!r}: expected 'int8' or unset")


# ---------------------------------------------------------------------------
# Model math
# ---------------------------------------------------------------------------

def _int8_quant(h, dims):
    """Dynamic symmetric int8 quantization over the contraction ``dims``:
    (int8 codes, f32 scale with the reduced dims kept as singletons)."""
    h32 = h.float()
    s = int8_scale(h32.abs().amax(dim=dims, keepdim=True))
    q = torch.clamp(torch.round(h32 / s), -127, 127).to(torch.int8)
    return q, s


def _int_dot(a, b):
    """Exact s8 x s8 -> s32 product of 2-D tensors ``[M, K] @ [K, N]``: the
    int8 einsums the reference leaves to XLA outside its kernel.

    On CUDA ``torch._int_mm`` wants more than 16 rows, and cuBLASLt's int8
    GEMMs want both operands contiguous along K (``b`` column-major): with a
    row-major ``b`` the H100 refused some shapes at K = 64 and ran others on
    a slow fallback.  The served weights are stored K-major, so ``b`` is
    copied only when a caller passes a row-major one.  Short inputs are
    padded with zero rows to 32."""
    M = a.shape[0]
    if M < 32:
        a = torch.cat([a, a.new_zeros(32 - M, a.shape[1])])
    return torch._int_mm(a.contiguous(), b.t().contiguous().t())[:M]


def _rmsnorm(x, scale, eps):
    x32 = x.float()
    r = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * r).to(x.dtype) * scale.to(x.dtype)


def _rope(q, k, positions, theta):
    # q, k: [B, H, S, K]; positions: [S]
    Kd = q.shape[-1]
    half = Kd // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=q.device) / half))
    ang = positions[:, None].float() * freqs[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)

    def rot(x):
        x1, x2 = x[..., :half], x[..., half:]
        xr1 = x1 * cos - x2 * sin
        xr2 = x2 * cos + x1 * sin
        return torch.cat([xr1, xr2], dim=-1).to(x.dtype)

    return rot(q), rot(k)


def _flash_enabled() -> bool:
    return os.environ.get("TRITON_TPU_FLASH", "1") != "0"


def _int8_fused_mode() -> frozenset:
    """Which int8 FFN matmuls take the fused kernel: '0' (none), 'w1',
    'w2' (default), '1'/'all', or a comma list of w1/w2.  The default was
    measured on a TPU and is a placeholder until measured on the H100."""
    val = os.environ.get("TRITON_TPU_INT8_FUSED", "w2").strip().lower()
    if val in ("", "0"):
        return frozenset()
    if val in ("1", "all"):
        return frozenset(("w1", "w2"))
    mode = frozenset(v.strip() for v in val.split(",") if v.strip())
    unknown = mode - frozenset(("w1", "w2"))
    if unknown:
        raise ValueError(
            f"TRITON_TPU_INT8_FUSED={val!r}: unknown selector(s) "
            f"{sorted(unknown)}; expected '0', '1'/'all', 'w1', 'w2', "
            "or a comma list of w1/w2")
    return mode


def _flash_min_s() -> int:
    """Sequence-length gate for the flash kernel (default 1024, measured on
    a TPU; a placeholder on the H100).  Override TRITON_TPU_FLASH_MIN_S."""
    return int(os.environ.get("TRITON_TPU_FLASH_MIN_S", "1024"))


@dataclasses.dataclass(frozen=True)
class _Ops:
    """The two kernel entry points a forward calls: the CUDA wrappers, or
    their plain versions for a reference forward."""
    attention: Callable
    int8_mm: Callable


_KERNEL_OPS = _Ops(flash_attention, int8_matmul)
_PLAIN_OPS = _Ops(flash_attention_reference, int8_matmul_reference)


def _attn_apply(blk, x, cfg: TransformerConfig, ops: _Ops = _KERNEL_OPS):
    B, S, D = x.shape
    H, K = cfg.n_heads, cfg.head_dim
    h = _rmsnorm(x, blk["ln1"], cfg.norm_eps)
    if "wq_scale" in blk:
        hq, hs = _int8_quant(h, (-1,))          # [B,S,D] i8, [B,S,1] f32
        hq2 = hq.reshape(B * S, D)

        def proj(name):
            out = _int_dot(hq2, blk[name].reshape(D, H * K))
            out = out.reshape(B, S, H, K).permute(0, 2, 1, 3)
            ws = blk[name + "_scale"]           # [1,H,K]
            return (out.float() * hs[:, None, :, :]
                    * ws[:, :, None, :]).to(h.dtype)

        q, k, v = proj("wq"), proj("wk"), proj("wv")
    else:
        def proj(name):
            w = blk[name].to(h.dtype).reshape(D, H * K)
            return (h @ w).reshape(B, S, H, K).permute(0, 2, 1, 3)

        q, k, v = proj("wq"), proj("wk"), proj("wv")
    positions = torch.arange(S, device=x.device)
    q, k = _rope(q, k, positions, cfg.rope_theta)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if _flash_enabled() and S >= _flash_min_s():
        o = ops.attention(q, k, v, causal=cfg.causal)
    else:
        o = ring_attention(q, k, v, causal=cfg.causal)
    if "wo_scale" in blk:
        # contraction is (h, k): quantize per (b, s) over the heads
        oq, osc = _int8_quant(o, (1, 3))        # [B,H,S,K] i8, [B,1,S,1]
        oq2 = oq.permute(0, 2, 1, 3).reshape(B * S, H * K)
        out = _int_dot(oq2, blk["wo"].reshape(H * K, D)).reshape(B, S, D)
        out = (out.float() * osc[:, 0, :, :]
               * blk["wo_scale"]).to(o.dtype)
    else:
        o2 = o.permute(0, 2, 1, 3).reshape(B, S, H * K)
        out = o2 @ blk["wo"].to(o.dtype).reshape(H * K, D)
    return x + out


def _moe_ffn(blk, h, cfg: TransformerConfig):
    """Top-k routed experts, computed densely over all experts (``ep = 1``:
    the reference's psums are the identity).  Routing runs in f32 and keeps
    every expert whose score reaches the k-th largest, so ties keep more
    than k; int8 expert weights are dequantized at use (weight-only)."""
    gate = torch.einsum("bsd,de->bse", h.float(), blk["router"].float())
    thresh = torch.topk(gate, cfg.moe_top_k, dim=-1).values[..., -1:]
    probs = torch.softmax(
        torch.where(gate >= thresh, gate, torch.full_like(gate, -1e30)), -1)

    def weight(name):
        w = blk[name].to(h.dtype)
        s = blk.get(name + "_scale")
        return w * s.to(h.dtype) if s is not None else w

    he = F.silu(torch.einsum("bsd,edf->ebsf", h, weight("we1")))
    oe = torch.einsum("ebsf,efd->ebsd", he, weight("we2"))
    return torch.einsum("ebsd,bse->bsd", oe, probs.to(oe.dtype))


def _ffn_apply(blk, x, cfg: TransformerConfig, ops: _Ops = _KERNEL_OPS):
    h = _rmsnorm(x, blk["ln2"], cfg.norm_eps)
    B, S, D = h.shape
    if cfg.moe:
        out = _moe_ffn(blk, h, cfg)
    elif "w1_scale" in blk:
        fused = _int8_fused_mode()
        if "w1" in fused:
            he = ops.int8_mm(h, blk["w1"], blk["w1_scale"])
        else:
            hq, hs = _int8_quant(h, (-1,))
            he = _int_dot(hq.reshape(B * S, D), blk["w1"]).reshape(B, S, -1)
            he = (he.float() * hs * blk["w1_scale"]).to(h.dtype)
        he = F.silu(he)
        if "w2" in fused:
            out = ops.int8_mm(he, blk["w2"], blk["w2_scale"])
        else:
            gq, gs = _int8_quant(he, (-1,))
            out = _int_dot(gq.reshape(B * S, -1), blk["w2"]).reshape(B, S, D)
            out = (out.float() * gs * blk["w2_scale"]).to(h.dtype)
    else:
        he = F.silu(h @ blk["w1"].to(h.dtype))
        out = he @ blk["w2"].to(h.dtype)
    return x + out


def _stage_apply(params, x, cfg: TransformerConfig, ops: _Ops = _KERNEL_OPS):
    """Run the stack of layers (the reference's ``lax.scan``)."""
    keys = _LAYER_KEYS_MOE if cfg.moe else _LAYER_KEYS_DENSE
    for layer in range(cfg.n_layers):
        blk = {}
        for k in keys:
            blk[k] = params[k][layer]
            if k + "_scale" in params:
                blk[k + "_scale"] = params[k + "_scale"][layer]
        x = _attn_apply(blk, x, cfg, ops)
        x = _ffn_apply(blk, x, cfg, ops)
    return x


def make_forward(cfg: TransformerConfig, quantized: bool = False,
                 head_cols: Optional[int] = None, plain: bool = False):
    """``(params, tokens [B, S]) -> logits [B, S, V]`` in f32.

    ``quantized=True`` expects :func:`quantize_layer_weights` params and
    runs the layer matmuls on the int8 path.  ``head_cols=N`` projects only
    the first N head columns.  ``plain=True`` runs the kernels' plain
    versions in their place: the reference forward a kernel run is checked
    against."""
    ops = _PLAIN_OPS if plain else _KERNEL_OPS

    def forward(params, tokens):
        if quantized != ("wq_scale" in params):
            raise ValueError(
                f"make_forward(quantized={quantized}) got "
                f"{'int8' if 'wq_scale' in params else 'float'} params")
        x = params["embed"][tokens.long()].to(cfg.dtype)
        x = _stage_apply(params, x, cfg, ops)
        h = _rmsnorm(x, params["final_ln"], cfg.norm_eps)
        head = params["head"]
        if head_cols is not None:
            head = head[:, :head_cols]
        return h.float() @ head.float()

    return forward
