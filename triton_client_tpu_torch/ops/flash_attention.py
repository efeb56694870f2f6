"""Flash attention: the hand-written Hopper kernel and its plain version.

Counterpart of ``triton_client_tpu/ops/flash_attention.py``.  The kernel is
``csrc/flash_attention.cu`` (bf16: persistent blocks of a TMA producer and
two or three wgmma consumer warpgroups walking query tiles, online softmax
in f32, causal early exit; see the source's header).

:func:`flash_attention` is a ``torch.autograd.Function``.  Its forward
launches the kernel for CUDA tensors and raises on anything the kernel does
not take; it uses :func:`flash_attention_reference` only for tensors that
lie on the CPU, where no kernel exists.  Its backward, on both devices, is
the reference's ``_flash_bwd``: recompute attention through the plain math
and take its vector-Jacobian product (the reference runs its jnp
``flash_attention_reference`` there, not a Pallas kernel).  The recompute
goes through ``_reference``, so it reports no work to a cost count: a
served forward counts the same, and the backward's FLOPs are not counted.

While a cost analysis counts on this thread (``_count``), the kernel and
the plain version each report :func:`flash_work` -- the FLOPs of the lower
triangle where causal, of the full S x S otherwise -- and their own PyTorch
ops stay out of the count, so a forward counts the same either way.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build, _count

_NEG_INF = -1e30

#: launches of the CUDA kernel in this process (chip_smoke.py reads it to
#: prove the serving path went through the kernel)
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = {torch.float32: (16, 32, 64), torch.bfloat16: (16, 32, 64, 128)}


def flash_work(q, k, causal: bool):
    """(FLOPs, bytes) of one attention over ``q [B, H, Sq, D]`` and ``k [B,
    H, Sk, D]``: q kᵀ and P v, 4·B·H·D·S·(S+1)/2 where causal (the lower
    triangle the kernel computes), 4·B·H·Sq·Sk·D otherwise; q, k and v read
    once and the output written once."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    flops = (4.0 * B * H * D * Sq * (Sq + 1) / 2 if causal
             else 4.0 * B * H * Sq * Sk * D)
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return flops, float(nbytes)


def flash_attention_reference(q, k, v, *, causal: bool = True, sm_scale=None):
    """Plain PyTorch attention with the kernel's semantics.

    q, k, v: ``[B, H, S, D]``; returns ``[B, H, S, D]`` in ``q.dtype``.
    Scores in f32, masked keys at -1e30, softmax in f32."""
    with _count.kernel(*flash_work(q, k, causal)):
        return _reference(q, k, v, causal, sm_scale)


def _reference(q, k, v, causal, sm_scale):
    D = q.shape[-1]
    S = q.shape[2]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        idx = torch.arange(S, device=q.device)
        mask = idx[:, None] >= idx[None, :]
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.to(q.dtype)


_fwd = None


def _lib():
    """The kernel's C entry point, built and loaded on first use."""
    global _fwd
    if _fwd is None:
        fn = _build.load("flash_attention").flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fwd = fn
    return _fwd


def flash_attention(q, k, v, *, causal: bool = True, sm_scale=None):
    """Flash attention over ``[B, H, S, D]`` tensors; differentiable.

    CUDA tensors run the Hopper kernel forward: bf16 with D in {16, 32, 64,
    128} or f32 with D in {16, 32, 64}, all three contiguous and of one
    type.  Any other CUDA input raises ``ValueError``.  CPU tensors run the
    plain version.  The backward recomputes through the plain math (the
    reference's ``_flash_bwd``)."""
    if not (q.device.type == "cpu" and k.device.type == "cpu"
            and v.device.type == "cpu"):
        _check_kernel_inputs(q, k, v)
    return _Flash.apply(q, k, v, causal, sm_scale)


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        if q.device.type == "cpu":
            return flash_attention_reference(q, k, v, causal=causal,
                                             sm_scale=sm_scale)
        with _count.kernel(*flash_work(q, k, causal)):
            return _launch(q, k, v, causal, sm_scale)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            o = _reference(*inputs, ctx.causal, ctx.sm_scale)
        grads = torch.autograd.grad(o, inputs, g)
        return (*(gr if need else None for gr, need in
                  zip(grads, ctx.needs_input_grad)), None, None)


def _check_kernel_inputs(q, k, v) -> None:
    """Raise on CUDA inputs the kernel does not take."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(
            "flash_attention: q, k, v must all be CUDA tensors or all CPU "
            f"tensors, got {q.device}, {k.device}, {v.device}")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            "flash_attention: q, k, v must share one [B, H, S, D] shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise ValueError(
            "flash_attention: the kernel takes bf16 or f32 q, k, v of one "
            f"type, got {q.dtype}, {k.dtype}, {v.dtype}")
    B, H, S, D = q.shape
    if D not in _HEAD_DIMS[q.dtype]:
        raise ValueError(
            f"flash_attention: head dim {D} is not supported for {q.dtype} "
            f"(supported: {_HEAD_DIMS[q.dtype]})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"flash_attention: {name} must be contiguous and 16-byte "
                "aligned")
    if B * H == 0 or S == 0:
        raise ValueError(
            f"flash_attention: B*H = {B * H} and S = {S} must be > 0")
    # the f32 grid takes B*H as its y dimension; the bf16 blocks walk
    # (head, query tile) work items numbered in an int
    if q.dtype == torch.float32 and B * H > 65535:
        raise ValueError(
            f"flash_attention: f32 takes B*H up to 65535, got {B * H}")
    if q.dtype == torch.bfloat16 and B * H * -(-S // 64) >= 2**30:
        raise ValueError(
            f"flash_attention: B*H = {B * H} at S = {S} is too large")


def _launch(q, k, v, causal, sm_scale):
    """The kernel on checked CUDA inputs."""
    global launches
    B, H, S, D = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    if q.dtype == torch.bfloat16 and scale <= 0:
        # the bf16 kernel takes row maxima of the unscaled scores, so it
        # wants scale > 0: a negative scale's sign moves into q (exact in
        # bf16), and a zero scale, which makes every score 0, becomes zero
        # queries at scale 1
        q, scale = (-q, -scale) if scale < 0 else (torch.zeros_like(q), 1.0)
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                B * H, S, D, float(scale), int(bool(causal)),
                _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: cudaError {rc}")
    launches += 1
    return o
