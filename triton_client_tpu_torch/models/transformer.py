"""The flagship transformer in PyTorch: the serving forward on one device,
and the 5-axis training step over a process mesh.

Counterpart of ``triton_client_tpu/models/transformer.py``: the same
parameter dict and layouts (``wq [L, D, H, K]``, ``wo [L, H, K, D]``,
``w1 [L, D, F]``, ``w2 [L, F, D]``, int8 weights with ``*_scale`` siblings),
the same knobs (``TRITON_TPU_FLASH``, ``TRITON_TPU_FLASH_MIN_S``,
``TRITON_TPU_INT8_FUSED``, ``TRITON_TPU_QUANT[_<MODEL>]``) with the same
defaults and loud rejection, and the same math per layer.  The layer
``scan`` is a Python loop, and attention at ``sp = 1`` is the flash kernel
at or above the gate and the single-shard ring below it.

The MoE FFN is the reference's too: an f32 router keeps the top-k experts by
threshold, every expert runs densely and the outputs are weighted by the
routing probabilities; under int8 the expert weights are weight-only
(dequantized at use), so no int8 kernel runs in it.

Training (:func:`make_grad_fn`, :func:`make_train_step`) runs on a
:class:`~..parallel.mesh.Mesh` over the axes ``('dp', 'pp', 'ep', 'sp',
'tp')``, one process a position, each holding its shards
(:func:`shard_params`) as the reference's ``shard_map`` holds them: dp
splits the batch, pp runs GPipe over the layer stages with ``ppermute``,
ep splits the experts (psum over ``ep``), sp runs ring attention, tp
splits heads and the FFN width (psum after ``wo``, ``w2`` and the
experts).  The gradients are the reference's: each rank differentiates
its local loss, sums each leaf over the axes it is replicated on and
divides by the global token count times ``tp * ep``.  Compute is
``cfg.dtype`` on f32 master weights; AdamW is the reference's, by hand.
On a one-process mesh every collective is the identity.

The serving forward (:func:`make_forward`) is the same code with no mesh:
no collective runs.  Sharded serving (``serve_mesh`` and the server's mesh
flags) is ROADMAP A8b.
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
from ..parallel.collectives import (Spec, all_gather, all_reduce, ppermute,
                                    psum, ring_attention,
                                    sync_replicated_grads)
from ..parallel.mesh import Mesh, build_mesh, factorize_mesh

MESH_AXES = ("dp", "pp", "ep", "sp", "tp")


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

TINY = TransformerConfig()

_LAYER_KEYS_DENSE = ("wq", "wk", "wv", "wo", "ln1", "ln2", "w1", "w2")
_LAYER_KEYS_MOE = ("wq", "wk", "wv", "wo", "ln1", "ln2", "router", "we1",
                   "we2")


def mesh_shape_for(n_devices: int, cfg: TransformerConfig) -> Dict[str, int]:
    """Greedy factorization of ``n_devices`` onto the 5 mesh axes, as the
    reference's: priority tp > sp > pp > ep, any remainder on dp."""
    return factorize_mesh(
        n_devices,
        limits={
            "tp": cfg.n_heads,
            "sp": 4,  # seq chunks; callers pick seq lengths divisible by sp
            "pp": cfg.n_layers,
            "ep": max(cfg.n_experts, 1),
        },
        axes=MESH_AXES,
        priority=("tp", "sp", "pp", "ep"),
        remainder_axis="dp",
    )


def make_mesh(n_devices: Optional[int] = None,
              cfg: TransformerConfig = TINY, device=None) -> Mesh:
    """This rank's mesh of ``n_devices`` ranks (default: the process
    group's size, or one), factorized by :func:`mesh_shape_for`.  The device
    is the rank's card unless ``device`` says otherwise."""
    if n_devices is None:
        n_devices = (torch.distributed.get_world_size()
                     if torch.distributed.is_initialized() else 1)
    return build_mesh(mesh_shape_for(n_devices, cfg), MESH_AXES, device)


#: Shardings of the int8 ``*_scale`` siblings: the reduced (contraction)
#: dims are singletons, the output-channel dims shard as the weight's.
_SCALE_SPECS = {
    "wq_scale": ("pp", None, "tp", None),
    "wk_scale": ("pp", None, "tp", None),
    "wv_scale": ("pp", None, "tp", None),
    "wo_scale": ("pp", None, None, None),
    "w1_scale": ("pp", None, "tp"),
    "w2_scale": ("pp", None, None),
    "we1_scale": ("pp", "ep", None, "tp"),
    "we2_scale": ("pp", "ep", None, None),
}


def param_specs(cfg: TransformerConfig,
                quantized: bool = False) -> Dict[str, Spec]:
    """Partition spec per parameter leaf (one entry per dim: an axis, or
    None).  Layer-stacked leaves lead with the layer dim over ``pp``."""
    specs = {
        "embed": (None, None),
        "wq": ("pp", None, "tp", None),
        "wk": ("pp", None, "tp", None),
        "wv": ("pp", None, "tp", None),
        "wo": ("pp", "tp", None, None),
        "ln1": ("pp", None),
        "ln2": ("pp", None),
        "final_ln": (None,),
        "head": (None, None),
    }
    if cfg.moe:
        specs.update({
            "router": ("pp", None, None),
            "we1": ("pp", "ep", None, "tp"),
            "we2": ("pp", "ep", "tp", None),
        })
    else:
        specs.update({
            "w1": ("pp", None, "tp"),
            "w2": ("pp", "tp", None),
        })
    if quantized:
        specs.update({k: v for k, v in _SCALE_SPECS.items()
                      if k[:-len("_scale")] in specs})
    return specs


def opt_specs(cfg: TransformerConfig):
    ps = param_specs(cfg)
    return {"mu": ps, "nu": dict(ps), "count": ()}


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


def opt_from_jax(np_opt, cfg: TransformerConfig, device="cpu"):
    """The reference's Adam state (``mu``, ``nu``, ``count``), carried
    across as numpy arrays."""
    return {"mu": params_from_jax(np_opt["mu"], cfg, device),
            "nu": params_from_jax(np_opt["nu"], cfg, device),
            "count": torch.tensor(int(np.asarray(np_opt["count"])),
                                  dtype=torch.int32, device=device)}


def _dim_split(entry, mesh: Mesh):
    """(shards, this rank's shard) of a dim with spec ``entry``: a tuple of
    axes splits it major to minor, as a ``PartitionSpec`` does."""
    axes = () if entry is None else (entry,) if isinstance(entry, str) \
        else tuple(entry)
    n, i = 1, 0
    for a in axes:
        n, i = n * mesh.shape[a], i * mesh.shape[a] + mesh.coords[a]
    return n, i


def _shard(x, spec: Spec, mesh: Mesh):
    x = torch.as_tensor(x)
    for d, entry in enumerate(spec):
        n, i = _dim_split(entry, mesh)
        if x.shape[d] % n:
            raise ValueError(
                f"dim {d} of size {x.shape[d]} does not split into {n} "
                f"shards (spec {spec})")
        if n > 1:
            size = x.shape[d] // n
            x = x.narrow(d, i * size, size)
    return x.to(mesh.device).contiguous()


def _gather(x, spec: Spec, mesh: Mesh):
    for d, entry in enumerate(spec):
        axes = () if entry is None else (entry,) \
            if isinstance(entry, str) else tuple(entry)
        for a in reversed(axes):
            x = all_gather(x, mesh, a, d)
    return x


def shard_params(params, mesh: Mesh, cfg: TransformerConfig):
    """This rank's slices of global parameters, on the mesh's device (the
    counterpart of the reference's ``place_params``)."""
    specs = param_specs(
        cfg, quantized=any(k.endswith("_scale") for k in params))
    return {k: _shard(v, specs[k], mesh) for k, v in params.items()}


def gather_params(params, mesh: Mesh, cfg: TransformerConfig):
    """The global parameters from every rank's shards (the inverse of
    :func:`shard_params`), on every rank."""
    specs = param_specs(
        cfg, quantized=any(k.endswith("_scale") for k in params))
    return {k: _gather(v, specs[k], mesh) for k, v in params.items()}


def shard_opt(opt, mesh: Mesh, cfg: TransformerConfig):
    """This rank's slices of a global Adam state (``place_opt``)."""
    return {"mu": shard_params(opt["mu"], mesh, cfg),
            "nu": shard_params(opt["nu"], mesh, cfg),
            "count": torch.as_tensor(opt["count"]).to(mesh.device)}



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


def _attn_apply(blk, x, cfg: TransformerConfig, ops: _Ops = _KERNEL_OPS,
                mesh: Optional[Mesh] = None):
    B, S, D = x.shape
    H, K = blk["wq"].shape[-2], cfg.head_dim  # this rank's heads
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
    if mesh is not None:
        positions = mesh.coords["sp"] * S + positions
    q, k = _rope(q, k, positions, cfg.rope_theta)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if (mesh is None or mesh.shape["sp"] == 1) and _flash_enabled() \
            and S >= _flash_min_s():
        o = ops.attention(q, k, v, causal=cfg.causal)
    else:
        o = ring_attention(q, k, v, causal=cfg.causal, mesh=mesh)
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
    if mesh is not None:
        out = psum(out, mesh, "tp")
    return x + out


def _moe_ffn(blk, h, cfg: TransformerConfig, mesh: Optional[Mesh] = None):
    """Top-k routed experts, computed densely over this rank's experts.
    Routing runs in f32 and keeps every expert whose score reaches the k-th
    largest, so ties keep more than k; int8 expert weights are dequantized
    at use (weight-only).  On a mesh each ``ep`` rank weights its slice of
    the experts by its slice of the probabilities, and the psums over
    ``tp`` and ``ep`` sum the partial outputs."""
    gate = torch.einsum("bsd,de->bse", h.float(), blk["router"].float())
    thresh = torch.topk(gate, cfg.moe_top_k, dim=-1).values[..., -1:]
    probs = torch.softmax(
        torch.where(gate >= thresh, gate, torch.full_like(gate, -1e30)), -1)
    if mesh is not None:
        El = blk["we1"].shape[0]
        start = mesh.coords["ep"] * El
        probs = probs[..., start:start + El]

    def weight(name):
        w = blk[name].to(h.dtype)
        s = blk.get(name + "_scale")
        return w * s.to(h.dtype) if s is not None else w

    he = F.silu(torch.einsum("bsd,edf->ebsf", h, weight("we1")))
    oe = torch.einsum("ebsf,efd->ebsd", he, weight("we2"))
    if mesh is None:
        return torch.einsum("ebsd,bse->bsd", oe, probs.to(oe.dtype))
    oe = psum(oe, mesh, "tp")
    out = torch.einsum("ebsd,bse->bsd", oe, probs.to(oe.dtype))
    return psum(out, mesh, "ep")


def _ffn_apply(blk, x, cfg: TransformerConfig, ops: _Ops = _KERNEL_OPS,
               mesh: Optional[Mesh] = None):
    h = _rmsnorm(x, blk["ln2"], cfg.norm_eps)
    B, S, D = h.shape
    if cfg.moe:
        return x + _moe_ffn(blk, h, cfg, mesh)
    if "w1_scale" in blk:
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
    if mesh is not None:
        out = psum(out, mesh, "tp")
    return x + out


def _stage_apply(params, x, cfg: TransformerConfig, ops: _Ops = _KERNEL_OPS,
                 mesh: Optional[Mesh] = None):
    """Run the stack of layers (the reference's ``lax.scan``): all of them,
    or this pipeline stage's ``n_layers / pp`` on a mesh."""
    keys = _LAYER_KEYS_MOE if cfg.moe else _LAYER_KEYS_DENSE
    n_layers = cfg.n_layers if mesh is None \
        else cfg.n_layers // mesh.shape["pp"]
    for layer in range(n_layers):
        blk = {}
        for k in keys:
            blk[k] = params[k][layer]
            if k + "_scale" in params:
                blk[k + "_scale"] = params[k + "_scale"][layer]
        x = _attn_apply(blk, x, cfg, ops, mesh)
        x = _ffn_apply(blk, x, cfg, ops, mesh)
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


# ---------------------------------------------------------------------------
# Training over a mesh
# ---------------------------------------------------------------------------

def _flag(value: bool, device) -> torch.Tensor:
    return torch.tensor(value, device=device)


def _pipeline_apply(params, x_mbs, cfg: TransformerConfig, ops: _Ops,
                    mesh: Mesh):
    """GPipe over the ``pp`` ring (the reference's ``fori_loop``).

    ``x_mbs``: ``n_micro`` embedded microbatches ``[mb, Sc, D]``, the same
    on every pp rank.  Returns the ``n_micro`` outputs, valid only on the
    last stage.  Every rank runs the same ops (selects by tensor flags,
    never a branch on its stage), so the backward's collectives line up
    across ranks; the reference's last rotation, whose result nobody
    reads, is not made."""
    pp = mesh.shape["pp"]
    stage = mesh.coords["pp"]
    n_micro = len(x_mbs)
    steps = n_micro + pp - 1
    first = _flag(stage == 0, x_mbs[0].device)
    last = _flag(stage == pp - 1, x_mbs[0].device)
    state = torch.zeros_like(x_mbs[0])
    outs = [torch.zeros_like(x_mbs[0]) for _ in range(n_micro)]
    for t in range(steps):
        state = torch.where(first, x_mbs[min(t, n_micro - 1)], state)
        state = _stage_apply(params, state, cfg, ops, mesh)
        if t >= pp - 1:
            outs[t - (pp - 1)] = torch.where(last, state,
                                             outs[t - (pp - 1)])
        if t < steps - 1:
            state = ppermute(state, mesh, "pp", 1)
    return outs


def _local_batch(x, mesh: Mesh) -> torch.Tensor:
    """This rank's ``[B / dp, S / sp]`` block of a global ``[B, S]`` array
    of token ids, on the mesh's device."""
    x = torch.as_tensor(x)
    B, S = x.shape
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    if B % dp or S % sp:
        raise ValueError(
            f"a [{B}, {S}] batch does not split over dp={dp}, sp={sp}")
    Bl, Sc = B // dp, S // sp
    i, j = mesh.coords["dp"], mesh.coords["sp"]
    return x[i * Bl:(i + 1) * Bl, j * Sc:(j + 1) * Sc].to(
        mesh.device).long()


def _embed_microbatches(params, tokens, cfg: TransformerConfig,
                        n_micro: int):
    Bl, Sc = tokens.shape
    if Bl % n_micro:
        raise ValueError(f"{Bl} local rows do not split into {n_micro} "
                         "microbatches")
    x = params["embed"][tokens].to(cfg.dtype)
    return list(x.reshape(n_micro, Bl // n_micro, Sc, cfg.d_model).unbind(0))


def _local_loss(params, tokens, labels, cfg: TransformerConfig,
                n_micro: int, ops: _Ops, mesh: Mesh):
    """This rank's summed token loss (the reference's ``_local_loss``):
    nonzero only on the last pp stage; callers sum it over (dp, sp, pp)
    and divide by the global token count."""
    x_mbs = _embed_microbatches(params, tokens, cfg, n_micro)
    outs = torch.stack(_pipeline_apply(params, x_mbs, cfg, ops, mesh))
    h = _rmsnorm(outs, params["final_ln"], cfg.norm_eps)
    logits = h.float() @ params["head"].float()
    logp = torch.log_softmax(logits, dim=-1)
    lab = labels.reshape(outs.shape[:3])
    nll = -logp.gather(-1, lab[..., None])[..., 0]
    last = mesh.coords["pp"] == mesh.shape["pp"] - 1
    return nll.sum() * (1.0 if last else 0.0)


def adam_init(params):
    """Zero AdamW moments and step count beside ``params``."""
    device = next(iter(params.values())).device
    return {"mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def _adam_update(params, grads, opt, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=0.0):
    """The reference's AdamW, elementwise on each rank's shards."""
    count = opt["count"] + 1
    t = count.float()
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t
    new_p, mu, nu = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        mu[k] = b1 * opt["mu"][k] + (1 - b1) * g
        nu[k] = b2 * opt["nu"][k] + (1 - b2) * (g * g)
        step = lr * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps)
        new_p[k] = p - step - lr * weight_decay * p
    return new_p, {"mu": mu, "nu": nu, "count": count}


def make_grad_fn(mesh: Mesh, cfg: TransformerConfig, n_micro: int = 2,
                 plain: bool = False):
    """``(params, tokens, labels) -> (grads, loss)``: this rank's synced
    mean gradients of its parameter shards, and the global mean loss (the
    same 0-dim f32 tensor on every rank).  ``tokens`` and ``labels`` are
    the global ``[B, S]`` arrays; each rank takes its (dp, sp) block.

    Exposed apart from the step so raw gradients can be checked (Adam
    hides constant per-leaf scale errors).  ``plain=True`` runs the
    kernels' plain versions, differentiated by autograd straight through.

    A tp or ep rank computes the same loss from its own parameter copies,
    and the psums' backward hands every copy the whole gradient, so the
    sum over those compute-replicated axes over-counts by their size; the
    static ``tp * ep`` divisor corrects it, as the reference's does."""
    specs = param_specs(cfg)
    ops = _PLAIN_OPS if plain else _KERNEL_OPS
    compute_scale = float(mesh.shape["tp"] * mesh.shape["ep"])

    def grad_fn(params, tokens, labels):
        tok, lab = _local_batch(tokens, mesh), _local_batch(labels, mesh)
        count = float(tok.numel() * mesh.shape["dp"] * mesh.shape["sp"])
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss_local = _local_loss(leaves, tok, lab, cfg, n_micro, ops, mesh)
        grads = torch.autograd.grad(loss_local, list(leaves.values()),
                                    allow_unused=True)
        grads = {k: g if g is not None else torch.zeros_like(leaves[k])
                 for k, g in zip(leaves, grads)}
        loss = all_reduce(loss_local.detach(), mesh, ("dp", "sp", "pp"))
        grads = sync_replicated_grads(grads, specs, mesh)
        grads = {k: g / (count * compute_scale) for k, g in grads.items()}
        return grads, loss / count

    return grad_fn


def make_train_step(mesh: Mesh, cfg: TransformerConfig, n_micro: int = 2,
                    lr: float = 1e-3):
    """``(params, opt, tokens, labels) -> (params, opt, loss)``: one AdamW
    step on this rank's shards (:func:`make_grad_fn`, then the update).
    The inputs are not changed: new tensors come back."""
    grad_fn = make_grad_fn(mesh, cfg, n_micro)

    def step(params, opt, tokens, labels):
        grads, loss = grad_fn(params, tokens, labels)
        params, opt = _adam_update(params, grads, opt, lr=lr)
        return params, opt, loss

    return step


def make_mesh_forward(mesh: Mesh, cfg: TransformerConfig, n_micro: int = 1):
    """``(params, tokens [B, S]) -> logits [B, S, V]``: the forward over
    the mesh (the reference's ``make_forward`` on a mesh), each rank
    holding its shards; the last stage's output is summed over ``pp`` and
    the global logits are gathered on every rank."""

    def forward(params, tokens):
        with torch.no_grad():
            tok = _local_batch(tokens, mesh)
            Bl, Sc = tok.shape
            x_mbs = _embed_microbatches(params, tok, cfg, n_micro)
            outs = torch.stack(_pipeline_apply(params, x_mbs, cfg,
                                               _KERNEL_OPS, mesh))
            last = _flag(mesh.coords["pp"] == mesh.shape["pp"] - 1,
                         outs.device)
            outs = torch.where(last, outs, torch.zeros_like(outs)).float()
            outs = psum(outs, mesh, "pp").to(cfg.dtype)
            h = _rmsnorm(outs, params["final_ln"], cfg.norm_eps)
            logits = (h.float() @ params["head"].float()).reshape(Bl, Sc, -1)
            return all_gather(all_gather(logits, mesh, "sp", 1), mesh,
                              "dp", 0)

    return forward
