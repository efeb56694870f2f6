"""Dynamic-quantize + int8 matmul: the Hopper kernels and their plain versions.

Counterpart of ``triton_client_tpu/ops/int8_matmul.py`` (``_call``, the
``pl.pallas_call`` at :102).  The kernels are ``csrc/int8_matmul.cu`` (its
header has the design): a quantize-rows pass that writes each row's f32 scale
and s8 codes once, then a persistent TMA + ``wgmma`` s8 GEMM with the
dequantizing epilogue.  The TPU kernel keeps a row block's full K in VMEM and
quantizes inside the product; a Hopper block has 227 KB of shared memory,
less than one 128-row band's codes at K = 4096 (512 KB), so the codes go
through device memory instead of being made again for every column tile.
At FFN-down (M = 16384, K = 4096, N = 1024, bf16) operations bound the
function (137.4 G int8 operations: 0.0694 ms at 1,979 TOP/s); the codes'
round trip (134.2 MB read, 67.1 MB written) sets the design's floor at
0.130 ms.

Scratch: each call allocates the codes ``[M, K]`` s8 and the scales ``[M]``
f32 with ``torch.empty`` (67 MB and 64 KB at that shape).

The weight rule: ``wgmma`` reads 8-bit operands only K-major, so the kernel
takes the weight as ``[N, K]`` in memory.  :func:`int8_matmul` keeps the
reference's ``[K, N]`` signature; a ``[K, N]`` view of K-major storage
(``stride == (1, K)``, the ``.t()`` of a contiguous ``[N, K]``, as the
served int8 weights are stored) goes straight to the kernel, and a
row-major weight is copied to K-major on every call (K*N bytes read and
written, 4 MB each way at that shape).

:func:`int8_matmul` launches the kernels for CUDA tensors and raises on a
shape they do not take -- including the reference's alignment gate (K and
N multiples of 128), which the TPU version answered with a silent
fallback.  It uses :func:`int8_matmul_reference` only for CPU tensors.
The TPU schedule knobs (``TRITON_TPU_INT8_BLOCKS`` / ``_SCHED``) and the
VMEM budget are TPU-only and not ported.

While a cost analysis counts on this thread (``_count``), the kernels and
the plain version each report :func:`int8_work` (2·M·K·N operations, and
the quantize pass's bytes with the GEMM's), and their own PyTorch ops stay
out of the count.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, _count

#: launches of the CUDA kernels by :func:`int8_matmul` in this process (read
#: by chip_smoke.py); each call runs the quantize pass and the GEMM
launches = 0
#: launches of the quantize-rows kernel, by :func:`int8_matmul` or alone by
#: :func:`int8_quantize_rows`
quantize_launches = 0

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


def int8_quantize_rows_reference(x):
    """Plain PyTorch per-row quantization of ``x [..., K]`` (float).

    Returns ``(q [..., K] int8, xs [..., 1] f32)``: the reference's
    ``_int8_quant(x, (-1,))``."""
    x32 = x.float()
    xs = int8_scale(x32.abs().amax(dim=-1, keepdim=True))
    q = torch.clamp(torch.round(x32 / xs), -127, 127).to(torch.int8)
    return q, xs


def int8_work(x, w_q):
    """(operations, bytes) of one ``int8_matmul`` of ``x [..., K]`` by
    ``w_q [K, N]``: 2·M·K·N; x, the weight and its scales read, the output
    written, and the quantize pass's codes and row scales written and read
    back."""
    K, N = w_q.shape[-2], w_q.shape[-1]
    M = x.numel() // K if K else 0
    elt = x.element_size()
    nbytes = (M * K * elt + K * N + N * 4 + M * N * elt
              + 2 * (M * K + M * 4))
    return 2.0 * M * K * N, float(nbytes)


def int8_matmul_reference(x, w_q, w_scale):
    """Plain PyTorch dynamic-quantized matmul.

    x: ``[..., K]`` float; w_q: ``[K, N]`` int8 (any strides); w_scale:
    ``[N]`` or ``[1, N]`` f32 (per output channel).  Returns ``[..., N]``
    in ``x.dtype``."""
    with _count.kernel(*int8_work(x, w_q)):
        return _reference(x, w_q, w_scale)


def _reference(x, w_q, w_scale):
    q, xs = int8_quantize_rows_reference(x)
    K = x.shape[-1]
    acc = exact_int_dot(q.reshape(-1, K), w_q).reshape(*x.shape[:-1], -1)
    ws = w_scale.reshape((1,) * (x.dim() - 1) + (-1,)).float()
    return (acc.float() * xs * ws).to(x.dtype)


_P, _I = ctypes.c_void_p, ctypes.c_int
#: C entry points of csrc/int8_matmul.cu and their argument types
_ARGTYPES = {
    # x, q, xs, M, K, dtype, stream
    "int8_quantize_rows_fwd": [_P] * 3 + [_I] * 3 + [_P],
    # x, wt, ws, q, xs, out, M, K, N, dtype, stream
    "int8_matmul_fwd": [_P] * 6 + [_I] * 4 + [_P],
}
_fns = {}


def _lib(name):
    """The kernel's C entry point ``name``, built and loaded on first use."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("int8_matmul"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _rows(x):
    """``x`` as contiguous ``[M, K]`` rows on a 16-byte boundary (the
    kernel loads 16 bytes at a time)."""
    x2d = x.reshape(-1, x.shape[-1]).contiguous()
    return x2d.clone() if x2d.data_ptr() % 16 else x2d


def _raise_on(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc}")


def int8_quantize_rows(x):
    """Per-row dynamic int8 quantization of ``x [..., K]``: ``(q [..., K]
    int8, xs [..., 1] f32)``, as :func:`int8_quantize_rows_reference`.

    CUDA tensors run the quantize-rows kernel (x bf16 or f32, K a multiple
    of 128; anything else raises ``ValueError``); CPU tensors run the plain
    version."""
    global quantize_launches
    if x.device.type == "cpu":
        return int8_quantize_rows_reference(x)
    if not x.is_cuda:
        raise ValueError(f"int8_quantize_rows: x on {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"int8_quantize_rows: x must be bf16 or f32, got {x.dtype}")
    if x.shape[-1] % 128:
        raise ValueError(
            f"int8_quantize_rows: K={x.shape[-1]} must be a multiple of 128 "
            "for the kernel (no fallback: use "
            "int8_quantize_rows_reference explicitly)")
    x2d = _rows(x)
    M, K = x2d.shape
    q = torch.empty(M, K, dtype=torch.int8, device=x.device)
    xs = torch.empty(M, dtype=torch.float32, device=x.device)
    if M:
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _raise_on(_lib("int8_quantize_rows_fwd")(
            x2d.data_ptr(), q.data_ptr(), xs.data_ptr(), M, K,
            _DTYPE_CODES[x.dtype], stream), "int8_quantize_rows")
        quantize_launches += 1
    return q.reshape(x.shape), xs.reshape(*x.shape[:-1], 1)


def int8_matmul(x, w_q, w_scale):
    """Dynamically quantized int8 matmul ``[..., K] @ [K, N] -> [..., N]``.

    CUDA tensors run the Hopper kernels: x bf16 or f32, w_q int8 ``[K, N]``
    (K-major storage is used as it is, anything else is copied to it), K
    and N multiples of 128.  Anything else on CUDA raises ``ValueError``.
    CPU tensors run the plain version."""
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
    with _count.kernel(*int8_work(x, w_q)):
        return _launch(x, w_q, w_scale)


def _launch(x, w_q, w_scale):
    """The quantize pass and the GEMM on checked CUDA inputs."""
    global launches, quantize_launches
    K, N = w_q.shape
    lead = x.shape[:-1]
    x2d = _rows(x)
    M = x2d.shape[0]
    if M == 0:
        return x.new_empty(*lead, N)
    wt = w_q.t()  # [N, K]: contiguous when w_q is K-major
    if not wt.is_contiguous():
        wt = wt.contiguous()  # a row-major weight: a K-major copy per call
    elif wt.data_ptr() % 16:  # TMA needs a 16-byte aligned base
        wt = wt.clone()
    ws = w_scale.reshape(N).to(torch.float32).contiguous()
    q = torch.empty(M, K, dtype=torch.int8, device=x.device)
    xs = torch.empty(M, dtype=torch.float32, device=x.device)
    out = torch.empty(M, N, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _raise_on(_lib("int8_matmul_fwd")(
        x2d.data_ptr(), wt.data_ptr(), ws.data_ptr(), q.data_ptr(),
        xs.data_ptr(), out.data_ptr(), M, K, N, _DTYPE_CODES[x.dtype],
        stream), "int8_matmul")
    launches += 1
    quantize_launches += 1
    return out.reshape(*lead, N)
