"""Fused dynamic-quantize + int8 matmul: the Hopper kernel and its plain version.

Counterpart of ``triton_client_tpu/ops/int8_matmul.py``.  The kernel is
``csrc/int8_matmul.cu``: a per-row scale pass, then a GEMM that quantizes
each activation tile in registers on its way to shared memory, so the int8
activation never reaches device memory (see the source's header).

:func:`int8_matmul` launches the kernel for CUDA tensors and raises on a
shape it does not take -- including the reference's alignment gate
(K and N multiples of 128), which the TPU version answered with a silent
fallback.  It uses :func:`int8_matmul_reference` only for CPU tensors.
The TPU schedule knobs (``TRITON_TPU_INT8_BLOCKS`` / ``_SCHED``) and the
VMEM budget are TPU-only and not ported.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: launches of the CUDA kernel in this process (read by chip_smoke.py)
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def exact_int_dot(a, b):
    """Exact s8 x s8 -> s32 product of 2-D int8 tensors ``[M, K] @ [K, N]``.

    Runs as a float64 product: every partial sum is an integer below
    127**2 * K < 2**53, so the result is exact in any summation order
    (PyTorch has no int8 matmul on CUDA besides ``torch._int_mm``)."""
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)


def int8_scale(amax):
    """``max(amax, 1e-12) / 127`` in f32 with an IEEE divide.

    The divisor is a tensor on purpose: PyTorch's CUDA division by a Python
    scalar multiplies by the scalar's reciprocal, which differs from the
    divide in the last bit for some inputs (the kernel, the CPU and the JAX
    reference run op by op all divide)."""
    return torch.clamp_min(amax, 1e-12) / torch.full_like(amax, 127.0)


def int8_matmul_reference(x, w_q, w_scale):
    """Plain PyTorch dynamic-quantized matmul.

    x: ``[..., K]`` float; w_q: ``[K, N]`` int8; w_scale: ``[N]`` or
    ``[1, N]`` f32 (per output channel).  Returns ``[..., N]`` in
    ``x.dtype``."""
    x32 = x.float()
    xs = int8_scale(x32.abs().amax(dim=-1, keepdim=True))
    q = torch.clamp(torch.round(x32 / xs), -127, 127).to(torch.int8)
    K = x.shape[-1]
    acc = exact_int_dot(q.reshape(-1, K), w_q).reshape(*x.shape[:-1], -1)
    ws = w_scale.reshape((1,) * (x.dim() - 1) + (-1,)).float()
    return (acc.float() * xs * ws).to(x.dtype)


_fwd = None


def _lib():
    """The kernel's C entry point, built and loaded on first use."""
    global _fwd
    if _fwd is None:
        fn = _build.load("int8_matmul").int8_matmul_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fwd = fn
    return _fwd


def int8_matmul(x, w_q, w_scale):
    """Dynamically quantized int8 matmul ``[..., K] @ [K, N] -> [..., N]``.

    CUDA tensors run the Hopper kernel: x bf16 or f32, w_q int8 ``[K, N]``
    contiguous, K and N multiples of 128.  Anything else on CUDA raises
    ``ValueError``.  CPU tensors run the plain version."""
    global launches
    if x.device.type == "cpu" and w_q.device.type == "cpu" \
            and w_scale.device.type == "cpu":
        return int8_matmul_reference(x, w_q, w_scale)
    if not (x.is_cuda and w_q.is_cuda and w_scale.is_cuda):
        raise ValueError(
            "int8_matmul: x, w_q, w_scale must all be CUDA tensors or all "
            f"CPU tensors, got {x.device}, {w_q.device}, {w_scale.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"int8_matmul: x must be bf16 or f32, got {x.dtype}")
    if w_q.dtype != torch.int8 or w_q.dim() != 2:
        raise ValueError(
            f"int8_matmul: w_q must be a 2-D int8 tensor, got {w_q.dtype} "
            f"{tuple(w_q.shape)}")
    K, N = w_q.shape
    if x.shape[-1] != K:
        raise ValueError(
            f"int8_matmul: x's last dim {x.shape[-1]} != w_q's K {K}")
    if K % 128 or N % 128:
        raise ValueError(
            f"int8_matmul: K={K} and N={N} must be multiples of 128 for the "
            "kernel (no fallback: pad the weights or use "
            "int8_matmul_reference explicitly)")
    if w_scale.numel() != N:
        raise ValueError(
            f"int8_matmul: w_scale has {w_scale.numel()} entries, need N={N}")
    lead = x.shape[:-1]
    x2d = x.reshape(-1, K).contiguous()
    M = x2d.shape[0]
    if M == 0:
        return x.new_empty(*lead, N)
    w = w_q.contiguous()
    ws = w_scale.reshape(N).to(torch.float32).contiguous()
    xs = torch.empty(M, dtype=torch.float32, device=x.device)
    out = torch.empty(M, N, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib()(x2d.data_ptr(), w.data_ptr(), ws.data_ptr(), xs.data_ptr(),
                out.data_ptr(), M, K, N, _DTYPE_CODES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: cudaError {rc}")
    launches += 1
    return out.reshape(*lead, N)
