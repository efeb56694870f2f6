#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``triton_client_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

(``chip_smoke.py --shm-client SPEC`` is the cross-process shared-memory
client that the run starts itself.)

Phases (any failure exits non-zero and prints no result line):

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from ``triton_client_tpu_torch/csrc`` with nvcc;
3. hold each kernel against its plain PyTorch version on the card at the
   serving shapes and at ragged lengths and other head dims -- flash
   attention to atol 2e-2 + rtol 1e-2 in bf16 (compared as f32; the
   kernel feeds bf16 probabilities to the tensor cores) and atol 1e-4 in
   f32, and each query row to 5% of its RMS (``FLASH_ROW_TOL``), the int8
   matmul bit for bit -- and time kernel, plain version, one
   PyTorch library call (scaled_dot_product_attention; quantize +
   torch._int_mm + epilogue) and the least time the card could take
   (beside flash's, the floor its exponentials set on the exp unit; beside
   int8's, the floor of its quantize-then-GEMM split).  The int8 quantize
   pass and matmul are held bit for bit at M = 1 to 16384 rows of both FFN
   shapes, with the weight row-major and K-major, an all-zero row, outlier
   rows and a row of exact ties; then at the int8 shapes of ``bert_large``
   (M = 384, 4608, 12288 at K = 4096, N = 1024) and of ``llama_tpu`` 1b
   (M = 128, 1024 at K = 8192, N = 2048 and K = 2048, N = 8192), each timed
   beside its bound and the library path; and flash at ``bert_large``'s
   attention shape ([32, 16, 384, 64] bf16, not causal), timed beside
   SDPA, ``ring_attention`` (what the flash gate picks at S = 384) and its
   bound;
4. serve ``longctx_tpu`` (``base`` preset: d_model 1024, 8 layers, S = 4096)
   through the port's HTTP server, bf16: 8 requests from 4 threads, each
   response held to the port's forward with plain kernels (``SERVED_ATOL``),
   kernel launch counts checked; then on the same server one batch of 4 by
   three transports -- (a) the HTTP body, (b) system shm, (c) CUDA shm in
   this process -- each LOGPROBS held to the plain forward and to (a),
   flash once per layer, and per transport p50 / p99 of 30 requests one
   after another, infer/s from 4 clients at once and the server's split of
   a request; then one full batch timed and traced;
5. the same served int8 (``TRITON_TPU_QUANT=int8``), under the
   default ``TRITON_TPU_INT8_FUSED=w2`` (one int8 launch per layer) and
   then under ``all`` (two: FFN-up too), for its forward time beside the
   default's;
6. serve ``bert_large`` at full width (S = 384) and ``BERT_SERVE_LAYERS``
   (12) of its 24 layers: 40 requests of
   4 sequences from 8 threads, so the batcher forms batches up to 32, in
   bf16, int8 under ``w2`` and int8 under ``all``; each LOGITS held to the
   plain-kernel forward of the same tokens, and the control (that forward
   with a planted fault) beyond the bound; int8 launches exactly 0 / 1 /
   2 per layer, flash never (S = 384 is under the gate); in bf16 and
   ``w2``, then on the same server one request of 32 sequences by four
   transports -- (a), (b), (c) and (d) CUDA shm of another process (this
   script's ``--shm-client``, whose regions the server maps with
   cudaIpcOpenMemHandle) -- held, counted and timed as in phase 4, beside
   the controls; then no region may be left (in either process, in
   /dev/shm, or in the server's status); one B = 32 forward timed, traced
   and its peak memory read;
7. serve ``moe_tpu`` (``base``: 8 experts, top 2, S = 256) bf16 and int8
   (weight-only in the FFN: no int8 kernel launch), one B = 8 forward
   timed and traced;
8. serve ``ensemble_llama`` over ``llama_tpu`` 1b (bf16): 8 binary BYTES
   requests from 4 threads, OUT_TEXT equal to ``bytes([NEXT_TOKEN %
   256])`` and NEXT_TOKEN held to the plain forward of the preprocessed
   tokens; then those token rows sent to ``llama_tpu`` directly on the same
   server, its NEXT_TOKEN and NEXT_LOGIT (inside the ensemble, ``_logit``)
   held to the plain forward; one B = 8 forward timed and traced beside its
   f32 head;
   then ``llama_tpu`` served directly in int8 under ``w2`` (16 int8 launches
   per forward), one B = 8 forward timed and traced;
9. perf_analyzer: check that the flash kernel refuses inputs that require
   grad (it has no backward yet) and runs under no_grad; then serve
   ``bert_large`` int8 (``TRITON_TPU_QUANT_BERT_LARGE=int8``,
   ``TRITON_TPU_INT8_FUSED=w2``) and run ``python -m
   triton_client_tpu_torch.perf_analyzer`` in a process of its own against
   it: -b 32 at concurrency 1 and 4 by wire, system shm and CUDA shm (the
   tool's regions, which the server maps with cudaIpcOpenMemHandle); -b 1
   at concurrency 1, 8 and 15 through the dynamic batcher; open loop at
   half of concurrency 1's infer/s and at half of concurrency 8's; one run
   at concurrency 4 traced.  Then ``bert_large`` bf16 at -b 32,
   concurrency 1, and ``longctx_tpu`` base bf16 at -b 4, concurrency 1 and
   4, by wire and CUDA shm, and traced at each.  Each level prints
   infer/s, p50 / p90 / p99, errors, the model's executions in its window
   with their batch sizes and the server's split; a traced run, the card's
   busy share.  Each run must have no error, exactly 24 int8 (bert int8)
   or 8 flash (longctx) launches per execution, Little's law within
   ``LITTLE_TOL`` at each closed-loop level (a gate on the host's clock
   that misses is read once more from a new run, ``HOST_GATE_RUNS``), and
   leave no region (in either process, in /dev/shm or in the server's
   status);
10. gRPC (gRPC-Web on the server's HTTP port, the port's own proto3 codec
    and client): ``bert_large`` int8 (``w2``) at request batch 32 and
    ``longctx_tpu`` base bf16 at batch 4, each by HTTP wire, then gRPC
    unary by wire, a gRPC stream by wire and a stream with system shm, and
    ``bert_large`` also a stream with CUDA shm of another process (this
    script's ``--shm-client``): each answer held to the plain forward
    within ``SERVED_ATOL`` beside the controls and to the HTTP answer,
    launches exactly 24 int8 / 8 flash per execution in every window;
    then ``perf_analyzer -i grpc --streaming`` from a process of its own
    (BASELINE row 4): ``bert_large`` int8 -b 32 at c = 1 and 4 with CUDA
    shm and by wire (c = 4 by wire traced for the card's busy share),
    unary -b 32 at c = 1, ``longctx_tpu`` -b 4 at c = 1,
    each level printed beside this run's HTTP level and checked as the
    perf phase checks it; then BASELINE row 5: ``ensemble_llama`` over
    ``llama_tpu`` 1b bf16 generating 32 tokens on one stream (a 128-byte
    window, OUT_TEXT appended, ``sequence_id`` 1, start on the first step
    and end on the last; NEXT_TOKEN held to the plain forward of each
    window) and 4 streams of 16 at once, tokens/s and per-token p50 / p99;
    an in-band error, a non-OK status or a region left fails the run;
11. vision (BASELINE row 2): ``resnet50`` at full width (224 x 224, bf16,
    ``channels_last``) driven as image_client.py drives it -- metadata
    and config parsed, 32 seeded INCEPTION-scaled images, gRPC
    ``async_infer`` raw and with ``class_count`` 3, and a stream; OUTPUT
    held to an f32 forward of the same weights on the card
    (``VISION_OF_RMS`` of its RMS, beside controls), each classification
    string equal to ``_classify`` of the served logits; the B = 32
    forward timed, traced and counted in FLOPs; then ``perf_analyzer -m
    resnet50 -i grpc``: -b 32 at c = 1 by wire, stream and CUDA shm, -b 1
    at c = 1 and 8 through the batcher; no kernel of the port launches;
12. observability: ``longctx_tpu`` base at B = 4 under int8 ``all``
    (flash and int8 in every layer) and ``bert_large`` int8 ``w2`` at -b
    32, each served with tracing (TIMESTAMPS at rate 1), device statistics
    and the flight recorder on and driven by ``perf_analyzer
    --trace-file`` at c = 1 from a process of its own: every traced
    request a REQUEST root with QUEUE, BATCH_ASSEMBLY, COMPUTE and
    D2H_TRANSFER children, each COMPUTE within ``OBS_TOL`` of the
    CUDA-event forward; launches exactly per forward; the served answers
    equal with observability on and off (bit for bit for ``bert_large``);
    the signature's counted FLOPs equal to the plain path's within
    ``OBS_FLOPS_TOL``; live MFU in (0, 1.05] and within ``OBS_TOL`` of
    counted FLOPs / forward / the bf16 peak; ``nv_tpu_memory_used_bytes``
    at least the served parameters' bytes; ``/metrics`` parsed; a
    ``PROFILE`` window whose Chrome trace names the flash and int8
    kernels; no region left; ``bert_large`` runs off, then on, and on may
    be at most ``OBS_TOL`` slower (the spans and the cost read once more
    on a miss, ``HOST_GATE_RUNS``);
13. overload: ``bert_large`` int8 ``w2`` at -b 1 under a queue bound of
    16 and the reference's 4 tiers (3 ms batching delay): two classes
    (``--priority 0 --tenant gold``, ``--priority 3 --tenant bulk``) at
    c = 16 over HTTP (traced) and gRPC, both honouring the server's
    pushback (``--retries 3``), then a best-effort flood that ignores it
    (a process of its own) beside tier-0 requests from this process, then
    one class at c = 8: tier 0 never shed, every shed with its pushback
    and counted alike by the server (``nv_inference_rejected_total``) and
    the client, each class's infer/s, p50 / p99 and sheds printed beside
    c = 8's p99; then chaos (``error,latency,abort`` at 0.2, seed 7, a
    0.2 s healthy window after each fault) under ``perf_analyzer
    --retries 3`` at c = 4: no caller error, the retries equal the
    injected errors and aborts, answers served under chaos within
    ``SERVED_ATOL`` of the plain forward; then a ``mem_pressure`` drill
    (a byte budget of two requests, windows that halve it): sheds,
    retried, no caller error, the budget back afterwards.
    ``longctx_tpu`` base int8 ``all`` with a byte budget of 1.5 requests:
    sheds at c = 4 with pushback (``nv_mem_shed_total`` equal to them), a
    request over its tier's share a 413 sent once, requests past their
    deadline 504 (on arrival, and behind a c = 4 load), the ledger empty
    when idle, ``nv_mem_hbm_headroom_bytes`` beside
    ``torch.cuda.mem_get_info()``.  A server process of its own
    (``longctx_tpu`` base, each request held 400 ms by a latency fault)
    sent SIGTERM: the requests in flight answer, new ones get 503 with
    Retry-After, it exits 0 within ``--drain-timeout``.  Launches exactly
    24 int8 (``bert_large``), 8 flash + 16 int8 (``longctx_tpu``) per
    execution in every window: a shed, expired or injected request
    launches nothing;
14. generation (``models/decode.py``): ``llama_decode`` and
    ``llama_generate`` over llama 1b (bf16 layers, the f32 head; a
    128-token prompt in a 256-token cache, 8 slots).  The port's prefill
    and 32 greedy decode steps held to the full recompute of the same
    tokens (``reference_forward``) as ``check_next_tokens`` holds a served
    next-token model, beside the controls; the decode step at B = 1 and 8
    by CUDA events beside its bytes bound, the prefill and its f32 head;
    then each mode served (independent; batched, T = 4): ``/generate_stream``
    over HTTP (SSE) and ``llama_generate`` on gRPC-Web streams, 1 and 8
    streams of 64 tokens, every stream's tokens the independent chain's
    (or parting at a near tie of its logits), ``llama_decode`` closed loop
    over HTTP for 2 sequences held the same way; tokens/s per stream and
    together, time to the first token, per-token p50 / p99 and the card's
    idle share (torch.profiler), beside row 5's ``ensemble_llama``
    figures; no kernel of the port launches;
15. print each kernel's launches on every served path, one JSON line
    describing every kernel, then the result line
    ``{"ok": true, "device": {...}}``.

Every request goes through the port's own HTTP client
(``triton_client_tpu_torch.http``) on kept-alive connections, or its gRPC
client (``triton_client_tpu_torch.grpc``), but ``/generate_stream``, which
neither client speaks (as the reference's do not): the standard library's
``http.client`` reads its events.

Each model and precision has its own bound (``SERVED_ATOL``).  NEXT_LOGIT
is held to it; a NEXT_TOKEN that differs from the plain forward's argmax
passes only where the plain forward's logit at the served token is within
that bound of its maximum (a batch formed otherwise picks other GEMM
algorithms, which can flip a near tie).  Beside each check of
``bert_large``, ``moe_tpu`` and ``llama_tpu``, controls: the same plain
forward with the last layer's FFN-down weights off by each of
``CONTROL_SCALES``; the reading at the largest must exceed the bound.

Imports nothing of JAX and nothing of ``triton_client_tpu``.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import os
import subprocess
import sys
import threading
import time

# H100 SXM data-sheet peaks (dense), at the full 700 W power limit.  The
# bf16 peak and the memory rate are the port's own constants
# (device_stats.peak_flops(), costs.peak_bytes_per_s()), read in main(),
# so a bound here and a live MFU on the server's /metrics share one
# denominator
PEAK_BF16_FLOPS = None
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_PER_S = None
# the exp unit (MUFU ex2) of one SM retires 16 results per clock
EXP_PER_CLOCK_PER_SM = 16

# |kernel - plain| <= atol + rtol * |plain|: bf16 outputs reach ~4, where
# one bf16 ulp is 2**-5
FLASH_TOL = {"bf16": (2e-2, 1e-2), "f32": (1e-4, 0.0)}
# and, beside it, each query row's largest |kernel - plain| at most this
# share of the row's RMS in the plain output.  Late causal rows are small
# (|o| ~ 0.03 at 4096 keys), so the atol above would let through a key
# tile skipped, stale or read from the wrong ring stage, which moves such a
# row by ~sqrt(128 / keys) of its RMS (18% at 4096 keys).  A sound kernel
# differs from the plain version by the bf16 rounding of P (~0.2% of the
# RMS) and by at most one bf16 ulp of an output: under 2**-7 of the row's
# largest element, which random inputs put at ~3x the RMS (at most
# sqrt(D) x).
FLASH_ROW_TOL = 0.05
# served LOGPROBS, LOGITS and NEXT_LOGIT vs the plain-kernel forward of the
# same tokens, by (model, int8).  longctx_tpu bf16: the bound of the CPU
# parity tests.  longctx_tpu int8: a run whose bf16 activations differ from
# another's in the last bit (the flash kernel's bf16 probabilities;
# batch-size-dependent GEMM sums) flips the int8 codes that sit at a
# rounding boundary, each flip moves a product by one quantization step and
# the layers compound it: the first run on the H100 measured 6.1e-2 over 8
# longctx_tpu requests.  The other models run no flash (S is under the
# gate) and the int8 kernel is bit-exact, so only GEMM sums that depend on
# the batch differ.  Over three runs on an H100 80GB HBM3 at 700 W they
# read at most 1.1e-6 (bert_large, either precision), 3.6e-7 (moe_tpu),
# 1.32e-2 (llama_tpu 1b bf16, in batches of 1-2 rows: its bf16 GEMMs at
# M = 128-256 change algorithm with the batch) and 0 (llama_tpu int8,
# whose layer matmuls are all integer).  Each bound sits above those
# readings (~100x; ~2.3x for llama_tpu bf16) and below the control's.
SERVED_ATOL = {
    ("longctx_tpu", False): 5e-2, ("longctx_tpu", True): 1.5e-1,
    ("bert_large", False): 1e-4, ("bert_large", True): 1e-4,
    ("moe_tpu", False): 1e-4, ("moe_tpu", True): 1e-4,
    ("llama_tpu", False): 3e-2, ("llama_tpu", True): 1e-4,
}
# the controls of those checks: the served answers are also held to the
# plain forward with one planted fault, the last layer's FFN-down weights
# off by each of these factors (under int8 their scale, which the kernel's
# epilogue applies).  The reading at the last (that output doubled) must
# exceed the bound; the smallest factor whose reading does is printed, the
# least such fault the bound catches.
CONTROL_SCALES = (1.01, 1.1, 2.0)
N_REQUESTS, N_THREADS = 8, 4
#: ``bert_large``'s depth in the serving phases (6): 12 of its 24 layers,
#: at full width, so that the script stays within its time; the perf, gRPC,
#: observability and overload phases serve all 24
BERT_SERVE_LAYERS = 12
# bert_large: 40 requests of 4 sequences from 8 threads, so up to 32
# sequences wait at once and the batcher can fill its largest batch (32)
BERT_REQUESTS, BERT_ROWS, BERT_THREADS = 40, 4, 8


REPO = os.path.dirname(os.path.abspath(__file__))


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def timed_ms(fn, iters: int = 10) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` calls, after a warm-up
    call, from CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(ops: float, peak_ops: float, nbytes: float):
    t_ops = ops / peak_ops * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_flash(fa, torch, gen, sm_clock_hz: float):
    """Kernel vs plain version at the serving shapes, ragged lengths and
    the other head dims; timings at the main one ([4, 16, 4096, 64] bf16
    causal: B = 4 requests of base)."""
    import torch.nn.functional as F

    cases = [((4, 16, 4096, 64), True, torch.bfloat16),
             ((1, 16, 4096, 64), False, torch.bfloat16),
             ((1, 16, 1000, 64), True, torch.bfloat16),
             ((1, 16, 4100, 64), True, torch.bfloat16),
             ((2, 8, 1000, 128), True, torch.bfloat16),
             ((1, 16, 4096, 32), False, torch.bfloat16),
             ((1, 4, 1000, 64), True, torch.float32)]
    worst = 0.0
    for shape, causal, dtype in cases:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        got = fa.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        want = fa.flash_attention_reference(q, k, v, causal=causal)
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        atol, rtol = FLASH_TOL["bf16" if dtype == torch.bfloat16 else "f32"]
        over = (diff > atol + rtol * want.float().abs()).sum().item()
        row_err = diff.amax(-1)
        row_rms = want.float().pow(2).mean(-1).sqrt()
        rows_over = (row_err > FLASH_ROW_TOL * row_rms).sum().item()
        worst_row = (row_err / row_rms.clamp_min(1e-30)).max().item()
        print(f"flash_attention {list(shape)} causal={causal} {dtype}: "
              f"max_abs_err {err:.3e}, {over} elements beyond atol {atol} + "
              f"rtol {rtol}; worst row error {worst_row:.2%} of its RMS, "
              f"{rows_over} rows beyond {FLASH_ROW_TOL:.0%}", flush=True)
        if over or rows_over:
            fail(f"flash_attention disagrees with its plain version at "
                 f"{shape} causal={causal} {dtype}")
        worst = max(worst, err)
        del got, want
    B, H, S, D = 4, 16, 4096, 64
    q, k, v = (torch.randn((B, H, S, D), generator=gen,
                           device="cuda").to(torch.bfloat16) for _ in range(3))
    ms = timed_ms(lambda: fa.flash_attention(q, k, v, causal=True))
    plain_ms = timed_ms(
        lambda: fa.flash_attention_reference(q, k, v, causal=True), iters=3)
    lib_ms = timed_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    ops = 4.0 * B * H * D * S * (S + 1) / 2  # QK^T and PV, lower triangle
    bms, by = bound_ms(ops, PEAK_BF16_FLOPS, 4.0 * B * H * S * D * 2)
    # one exponential per score of the lower triangle, 16 per clock per SM
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    exp_ms = B * H * S * (S + 1) / 2 / (EXP_PER_CLOCK_PER_SM * sms *
                                        sm_clock_hz) * 1e3
    print(f"flash_attention [4,16,4096,64] bf16 causal: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
          f"{bms:.4f} ms ({by}), exp-unit floor {exp_ms:.4f} ms ({sms} SMs "
          f"at {sm_clock_hz / 1e6:.0f} MHz); kernel at {bms / ms:.1%} of "
          f"the bound, {ms / lib_ms:.2f}x sdpa", flush=True)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}


# int8 cases: M rows at FFN-down (K, N) = (4096, 1024) and FFN-up
# (1024, 4096) of base; M = 16384 is B = 4 requests of S = 4096
INT8_SHAPES = ((4096, 1024), (1024, 4096))
INT8_ROWS = (1, 50, 300, 4096, 16384)


def _int8_inputs(torch, gen, m, k, n, dtype):
    """x, w [K, N] row-major, ws.  From 50 rows on, x holds an all-zero row
    (scale 1e-12 / 127), two rows with one large outlier each, and a row of
    exact ties (amax 127, so the scale is 1 and all its other quotients are
    j + 0.5, rounded half to even)."""
    x = torch.randn((m, k), generator=gen, device="cuda")
    if m >= 50:
        x[1] = 0.0
        x[2, 5] = 1000.0
        x[m // 2, k - 1] = -3000.0
        x[3] = torch.arange(k, device="cuda") % 254 - 126.5
        x[3, 0] = 127.0
    w = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                      dtype=torch.int8)
    ws = (torch.rand((n,), generator=gen, device="cuda") + 0.01) * 0.02
    return x.to(dtype), w, ws


def _device_ms(torch, fn, names, iters: int = 10):
    """Mean device time per call of each kernel whose name contains one of
    ``names``, from torch.profiler over ``iters`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ms = dict.fromkeys(names, 0.0)
    for e in prof.key_averages():
        for name in names:
            if name in e.key:
                ms[name] += e.self_device_time_total / iters / 1e3
    return ms


def _int8_bit_exact(im, torch, gen, cases) -> None:
    """The quantize pass (codes, scales) and the matmul with the weight
    row-major and K-major, each bit for bit against its plain version, at
    every (M, K, N, dtype) of ``cases``."""
    for m, k, n, dtype in cases:
        x, w, ws = _int8_inputs(torch, gen, m, k, n, dtype)
        q, xs = im.int8_quantize_rows(x)
        torch.cuda.synchronize()
        want_q, want_xs = im.int8_quantize_rows_reference(x)
        bad_q = (q != want_q).sum().item()
        bad_xs = (xs != want_xs).sum().item()
        want = im.int8_matmul_reference(x, w, ws)
        w_kmajor = w.t().contiguous().t()
        for layout, wl in (("row-major", w), ("K-major", w_kmajor)):
            got = im.int8_matmul(x, wl, ws)
            torch.cuda.synchronize()
            mismatched = (got != want).sum().item()
            err = (got.float() - want.float()).abs().max().item()
            print(f"int8 M={m} K={k} N={n} {dtype} {layout} weight: "
                  f"quantize pass {bad_q} codes and {bad_xs} scales differ; "
                  f"matmul {mismatched} elements differ, max_abs_err "
                  f"{err:.3e} (exact required)", flush=True)
            if bad_q or bad_xs or mismatched:
                fail(f"int8 kernels are not bit-exact at M={m} K={k} N={n} "
                     f"{dtype}, {layout} weight")
        del x, w, ws, w_kmajor, q, xs, want_q, want_xs, want, got
    torch.cuda.empty_cache()


def _int8_timed(im, torch, gen, m, k, n):
    """Kernel (K-major weight, as served), plain version and the library
    path (quantize + torch._int_mm + epilogue) at one bf16 shape, and its
    bound.  Returns the inputs and the times."""
    x, w, ws = _int8_inputs(torch, gen, m, k, n, torch.bfloat16)
    # the K-major weight, made once: the served layout, and the one
    # cuBLASLt's int8 GEMM is several times faster with
    w_kmajor = w.t().contiguous().t()

    def library():
        x32 = x.float()
        xs = im.int8_scale(x32.abs().amax(-1, keepdim=True))
        q = torch.clamp(torch.round(x32 / xs), -127, 127).to(torch.int8)
        return (torch._int_mm(q, w_kmajor).float() * xs * ws).to(x.dtype)

    if not torch.equal(library(), im.int8_matmul_reference(x, w, ws)):
        fail("the library yardstick does not compute the same function")
    ms = timed_ms(lambda: im.int8_matmul(x, w_kmajor, ws))
    plain_ms = timed_ms(lambda: im.int8_matmul_reference(x, w, ws), iters=3)
    lib_ms = timed_ms(library)
    nbytes = m * k * 2 + k * n + n * 4 + m * n * 2
    bms, by = bound_ms(2.0 * m * k * n, PEAK_INT8_OPS, nbytes)
    return (x, w, w_kmajor, ws), {"ms": ms, "plain_ms": plain_ms,
                                  "bound_ms": bms, "bound_by": by,
                                  "library_ms": lib_ms}


def check_int8(im, torch, gen, ptxas: str):
    """The quantize pass and the GEMM, each bit for bit against its plain
    version, at M in INT8_ROWS for both shapes (bf16; f32 at M = 300) with
    the weight row-major and K-major; timings at FFN-down of B = 4 with the
    weight K-major, as the served path stores it."""
    cases = [(m, k, n, torch.bfloat16) for k, n in INT8_SHAPES
             for m in INT8_ROWS]
    cases += [(300, k, n, torch.float32) for k, n in INT8_SHAPES]
    _int8_bit_exact(im, torch, gen, cases)
    m, k, n = 16384, 4096, 1024
    (x, w, w_kmajor, ws), t = _int8_timed(im, torch, gen, m, k, n)
    ms_row = timed_ms(lambda: im.int8_matmul(x, w, ws))
    phases = _device_ms(torch, lambda: im.int8_matmul(x, w_kmajor, ws),
                        ("quantize_rows", "int8_gemm"))
    # the split's own floor: the quantize pass moves x once and the codes
    # once, then the GEMM's operations
    floor_ms = (m * k * 2 + m * k + m * 4) / PEAK_BYTES_PER_S * 1e3 + \
        2.0 * m * k * n / PEAK_INT8_OPS * 1e3
    ms, bms = t["ms"], t["bound_ms"]
    print(f"int8_matmul M={m} K={k} N={n} bf16: kernel {ms:.4f} ms with the "
          f"weight K-major ({ms_row:.4f} ms row-major, copy included); "
          f"device time: quantize pass {phases['quantize_rows']:.4f} ms, "
          f"GEMM {phases['int8_gemm']:.4f} ms (torch.profiler); plain "
          f"{t['plain_ms']:.4f} ms, quantize+_int_mm+epilogue "
          f"{t['library_ms']:.4f} ms, bound {bms:.4f} ms ({t['bound_by']}), "
          f"design floor {floor_ms:.4f} ms; kernel at {bms / ms:.1%} of the "
          f"bound, {t['library_ms'] / ms:.2f}x faster than the library "
          f"path; ptxas: {ptxas}", flush=True)
    return {"max_abs_err": 0.0, **t}


# the int8 products of this slice's models, (M, K, N): bert_large FFN-down
# at B = 1, 12 and 32 (S = 384), llama_tpu 1b FFN-down and FFN-up (under
# ``all``) at B = 1 and 8 (S = 128)
INT8_MODEL_SHAPES = (
    ("bert_large FFN-down", ((384, 4096, 1024), (4608, 4096, 1024),
                             (12288, 4096, 1024))),
    ("llama_tpu 1b FFN-down", ((128, 8192, 2048), (1024, 8192, 2048))),
    ("llama_tpu 1b FFN-up", ((128, 2048, 8192), (1024, 2048, 8192))),
)


def check_int8_model_shapes(im, torch, gen) -> None:
    """Bit-exact, then timed, at the int8 shapes of bert_large and llama
    1b."""
    cases = [(m, k, n, torch.bfloat16)
             for _, shapes in INT8_MODEL_SHAPES for m, k, n in shapes]
    _int8_bit_exact(im, torch, gen, cases)
    for label, shapes in INT8_MODEL_SHAPES:
        for m, k, n in shapes:
            inputs, t = _int8_timed(im, torch, gen, m, k, n)
            del inputs
            print(f"int8_matmul {label} M={m} K={k} N={n} bf16: kernel "
                  f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
                  f"quantize+_int_mm+epilogue {t['library_ms']:.4f} ms, "
                  f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}); kernel "
                  f"at {t['bound_ms'] / t['ms']:.1%} of the bound, "
                  f"{t['library_ms'] / t['ms']:.2f}x faster than the library "
                  "path", flush=True)
    torch.cuda.empty_cache()


def check_flash_bert(fa, torch, gen) -> None:
    """Flash at bert_large's attention shape, [32, 16, 384, 64] bf16 not
    causal: held to the plain version under FLASH_TOL / FLASH_ROW_TOL and
    timed beside SDPA, ring_attention (the flash gate's pick at S = 384)
    and the bound."""
    import torch.nn.functional as F

    from triton_client_tpu_torch.parallel.collectives import ring_attention

    B, H, S, D = 32, 16, 384, 64
    q, k, v = (torch.randn((B, H, S, D), generator=gen,
                           device="cuda").to(torch.bfloat16)
               for _ in range(3))
    got = fa.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    want = fa.flash_attention_reference(q, k, v, causal=False)
    diff = (got.float() - want.float()).abs()
    atol, rtol = FLASH_TOL["bf16"]
    over = (diff > atol + rtol * want.float().abs()).sum().item()
    row_err = diff.amax(-1)
    row_rms = want.float().pow(2).mean(-1).sqrt()
    rows_over = (row_err > FLASH_ROW_TOL * row_rms).sum().item()
    ring = ring_attention(q, k, v, causal=False)
    ring_err = (ring.float() - want.float()).abs().max().item()
    print(f"flash_attention [{B},{H},{S},{D}] causal=False bf16 "
          f"(bert_large): max_abs_err {diff.max().item():.3e}, {over} "
          f"elements beyond atol {atol} + rtol {rtol}, {rows_over} rows "
          f"beyond {FLASH_ROW_TOL:.0%} of their RMS; ring_attention vs plain "
          f"max_abs_err {ring_err:.3e}", flush=True)
    if over or rows_over:
        fail("flash_attention disagrees with its plain version at "
             "bert_large's shape")
    del got, want, ring
    ms = timed_ms(lambda: fa.flash_attention(q, k, v, causal=False))
    plain_ms = timed_ms(
        lambda: fa.flash_attention_reference(q, k, v, causal=False), iters=3)
    ring_ms = timed_ms(lambda: ring_attention(q, k, v, causal=False),
                       iters=3)
    lib_ms = timed_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    bms, by = bound_ms(4.0 * B * H * S * S * D, PEAK_BF16_FLOPS,
                       4.0 * B * H * S * D * 2)
    print(f"flash_attention [{B},{H},{S},{D}] bf16 not causal: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, ring_attention "
          f"{ring_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bms:.4f} ms "
          f"({by}); kernel at {bms / ms:.1%} of the bound, "
          f"{ring_ms / ms:.2f}x faster than ring_attention, "
          f"{ms / lib_ms:.2f}x sdpa", flush=True)
    del q, k, v
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def _client(port: int, concurrency: int = 1, protocol: str = "http"):
    """The port's v2 HTTP client of the server on ``port``, with up to
    ``concurrency`` kept-alive connections; or with ``protocol`` "grpc" its
    gRPC client (gRPC-Web on the same port)."""
    if protocol == "grpc":
        from triton_client_tpu_torch import grpc

        return grpc.InferenceServerClient(f"127.0.0.1:{port}")
    from triton_client_tpu_torch import http

    return http.InferenceServerClient(f"127.0.0.1:{port}",
                                      concurrency=concurrency,
                                      network_timeout=300)


class _Sender:
    """A prepared request sent by ``protocol`` (``"http"`` or ``"grpc"``),
    unary or, where ``stream``, on a gRPC stream of the client's own: its
    answer waited for on the stream's callback, an in-band error or a
    non-OK status of the stream a failure of the run."""

    def __init__(self, port: int, protocol: str, stream: bool):
        import queue

        self.protocol, self.stream = protocol, stream
        self.mod = importlib.import_module(
            f"triton_client_tpu_torch.{protocol}")
        self.client = _client(port, protocol=protocol)
        self._prep = None
        if stream:
            self._done = queue.Queue()
            self.client.start_stream(
                callback=lambda result, error: self._done.put(
                    (result, error)))

    def send(self, model: str, inputs, outputs):
        """The result of one request (inputs carry their data or region;
        the request is compiled at the first call)."""
        if self._prep is None:
            self._prep = self.client.prepare(model, inputs, outputs=outputs)
        if not self.stream:
            return self._prep.infer()
        self._prep.async_stream_infer()
        return self.answer()

    def answer(self, what: str = "gRPC stream"):
        """The stream's next answer; an error fails the run."""
        result, error = self._done.get(timeout=300)
        if error is not None:
            fail(f"{what}: {error}")
        return result

    def output_entry(self, result, name: str) -> dict:
        """An output's entry, as the HTTP JSON has it."""
        if self.protocol == "http":
            return result.get_output(name)
        entry = result.get_output(name, as_json=True)
        entry["parameters"] = {k: next(iter(v.values()))
                               for k, v in entry.get("parameters",
                                                     {}).items()}
        return entry

    def close(self) -> None:
        if self.stream:
            self.client.stop_stream()
        self.client.close()


def _post_infer(client, model: str, inputs, outputs):
    """One binary v2 infer request through the port's client.  ``inputs``:
    (name, datatype, array).  Returns ({output name: array}, seconds)."""
    from triton_client_tpu_torch import http

    ins = []
    for name, datatype, arr in inputs:
        x = http.InferInput(name, list(arr.shape), datatype)
        x.set_data_from_numpy(arr)
        ins.append(x)
    outs = [http.InferRequestedOutput(o) for o in outputs]
    t0 = time.perf_counter()
    res = client.infer(model, ins, outputs=outs)
    dt = time.perf_counter() - t0
    return {o: res.as_numpy(o) for o in outputs}, dt


def _reset(counters) -> None:
    for mod in counters.values():
        mod.launches = 0
    counters["int8_matmul"].quantize_launches = 0


@contextlib.contextmanager
def bert_depth(n_layers: int):
    """``bert_large`` built with ``n_layers`` layers inside the block."""
    import dataclasses

    from triton_client_tpu_torch.models import language

    full = language.BERT_LARGE
    language.BERT_LARGE = dataclasses.replace(full, n_layers=n_layers)
    try:
        yield
    finally:
        language.BERT_LARGE = full


@contextlib.contextmanager
def serving_harness(models):
    """Register ``models`` and serve them over HTTP; yields the harness."""
    from triton_client_tpu_torch.server.registry import ModelRegistry
    from triton_client_tpu_torch.server.testing import ServerHarness

    registry = ModelRegistry()
    for m in models:
        registry.register_model(m)
    with ServerHarness(registry) as harness:
        yield harness


@contextlib.contextmanager
def serving(models):
    """Register ``models`` and serve them over HTTP; yields the port."""
    with serving_harness(models) as harness:
        yield harness.http_port


def send_requests(label: str, port: int, target: str, requests, n_threads,
                  counters, outputs, batched):
    """Send each of ``requests`` (a list of input lists for
    ``_post_infer``) to ``target`` from ``n_threads`` threads at once, on
    one client with a kept-alive connection per thread, after one warm-up
    request (it builds the weights).  The launch counts
    are zeroed just before the warm-up and read just after the last
    request.  Prints the batching and latency line of the model
    ``batched``.  Returns (results, launches, executions of ``batched``
    in this window)."""
    import numpy as np

    n = len(requests)
    results = [None] * n
    latencies = [0.0] * n
    errors = []
    st = batched.stats
    runs0, rows0 = st.batch_execution_count, st.batch_size_total
    _reset(counters)
    conn = _client(port, n_threads)
    _post_infer(conn, target, requests[0], outputs)
    start = threading.Barrier(n_threads)

    def client(tid):
        try:
            start.wait(timeout=60)
            for i in range(tid, n, n_threads):
                results[i], latencies[i] = _post_infer(
                    conn, target, requests[i], outputs)
        except BaseException as e:  # reported below, then fail
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    conn.close()
    launches = {name: mod.launches for name, mod in counters.items()}
    launches["int8_quantize_rows"] = counters["int8_matmul"].quantize_launches
    if errors or any(t.is_alive() for t in threads):
        fail(f"{label}: client threads failed: {errors}")
    executions = st.batch_execution_count - runs0
    print(f"{label}: {n} requests + 1 warm-up in {executions} batched "
          f"{batched.name} executions (avg batch "
          f"{(st.batch_size_total - rows0) / max(executions, 1):.2f}); p50 "
          f"latency {1e3 * float(np.median(latencies)):.2f} ms, max "
          f"{1e3 * max(latencies):.2f} ms; {n / wall:.2f} infer/s; "
          f"launches {launches}", flush=True)
    return results, launches, executions


def check_launches(label, launches, executions, flash_per_forward,
                   int8_per_forward) -> None:
    if launches["flash_attention"] != flash_per_forward * executions:
        fail(f"{label}: flash_attention launched "
             f"{launches['flash_attention']} times, expected "
             f"{flash_per_forward} per forward x {executions} forwards")
    want = int8_per_forward * executions
    if launches["int8_matmul"] != want or \
            launches["int8_quantize_rows"] != want:
        fail(f"{label}: the int8 kernels launched {launches['int8_matmul']} "
             f"(quantize pass {launches['int8_quantize_rows']}) times, "
             f"expected {int8_per_forward} per forward x {executions} "
             "forwards")


def check_precision(label: str, run, int8: bool) -> None:
    """The served weights are the precision the phase asked for."""
    if ("wq_scale" in run.params) != int8:
        fail(f"{label}: served {'float' if int8 else 'int8'} weights, "
             f"expected {'int8' if int8 else 'float'}")


def control_params(torch, params, scale: float):
    """``params`` with a control's planted fault: the last layer's
    FFN-down weights (under int8, their scale, which the int8 kernel's
    epilogue applies) off by ``scale``."""
    key = next(k for k in ("w2_scale", "we2_scale", "w2", "we2")
               if k in params)
    w = params[key]
    return {**params, key: torch.cat([w[:-1], w[-1:] * scale])}


def check_served(label: str, what: str, atol: float, worst: float,
                 mean: float, controls, typical: float) -> None:
    """The served answers within ``atol`` of the plain-kernel forward, and
    the control at the largest of CONTROL_SCALES beyond it.  ``controls``:
    each scale's reading, in the order of CONTROL_SCALES."""
    caught = [s for s, c in zip(CONTROL_SCALES, controls) if c > atol]
    print(f"{label}: {what} vs plain-kernel forward: max_abs_err "
          f"{worst:.3e} (atol {atol}), mean_abs_err {mean:.3e}; controls "
          "(last layer's FFN-down x" + ", x".join(
              f"{s}: {c:.3e}" for s, c in zip(CONTROL_SCALES, controls))
          + f"), caught from x{caught[0] if caught else None}; mean "
          f"|{what}| {typical:.3e}", flush=True)
    if not worst <= atol:
        fail(f"{label}: served {what} disagree with the plain forward")
    if not controls[-1] > atol:
        fail(f"{label}: the control x{CONTROL_SCALES[-1]} reads "
             f"{controls[-1]:.3e}, within the bound {atol}: the bound would "
             "not catch that fault")


def profile_forward(label: str, run, torch, batch: int, seq_len: int,
                    vocab: int) -> float:
    """Time one forward of ``batch`` requests of ``seq_len`` tokens
    (``profile_run``).  Returns the forward's ms."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    tokens = torch.randint(0, vocab, (batch, seq_len), generator=gen,
                           device="cuda")
    return profile_run(label, lambda: run(tokens), torch,
                       f"forward B={batch}")


def profile_run(label: str, fn, torch, what: str) -> float:
    """Time ``fn()`` (one forward) with CUDA events, then trace one call
    with torch.profiler and print where the device time goes, the idle
    share and the peak memory.  Returns the call's ms."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        fwd_ms = timed_ms(fn, iters=5)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    # device-side entries only (kernels and copies, our ctypes launches
    # included); CPU ops carry their kernels' time too and would count twice
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    print(f"{label}: {what} {fwd_ms:.3f} ms (CUDA events); "
          f"traced device time {busy_ms:.3f} ms in {len(events)} ops, idle "
          f"{max(0.0, 1 - busy_ms / fwd_ms):.1%} of the forward; peak "
          f"memory {peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} GiB "
          "above the weights): " + "; ".join(
              f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms"
              for e in top) + f"; {CARD}", flush=True)
    ours = [e for e in events if any(
        k in e.key for k in ("flash_fwd", "quantize_rows", "int8_gemm"))]
    print(f"{label}: the port's kernels in that forward: " + "; ".join(
        f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms in "
        f"{e.count} launches" for e in ours), flush=True)
    return fwd_ms


def serve_longctx(label: str, torch, counters, int8: bool,
                  int8_per_layer: int, transports: bool = False):
    """Serve longctx_tpu base on cuda through the HTTP server; check every
    response against the plain-kernel forward and the launch counts (flash
    once per layer, the int8 kernel ``int8_per_layer`` times per layer, 0 on
    the bf16 path).  Where ``transports``, then on the same server
    ``longctx_transports``.  Returns launch counts."""
    import numpy as np

    from triton_client_tpu_torch.models import language
    from triton_client_tpu_torch.models import transformer as tr

    model = language.make_longctx_tpu("cuda")
    S = model.config.input[0].dims[0]
    rng = np.random.default_rng(1234)
    tokens = [rng.integers(0, 256, (1, S)).astype(np.int32)
              for _ in range(N_REQUESTS)]
    with serving_harness([model]) as harness:
        results, launches, executions = send_requests(
            label, harness.http_port, "longctx_tpu",
            [[("TOKENS", "INT32", t)] for t in tokens], N_THREADS, counters,
            ["LOGPROBS"], model)
        if transports:
            longctx_transports(label, torch, counters, harness, model)
    layers = model.transformer.cfg.n_layers
    check_launches(label, launches, executions, layers,
                   int8_per_layer * layers)
    # the reference: the same forward with the kernels' plain versions
    run = model.transformer
    check_precision(label, run, int8)
    fwd = tr.make_forward(run.cfg, quantized=int8, plain=True)
    worst, mean = 0.0, 0.0
    with torch.inference_mode():
        for toks, res in zip(tokens, results):
            got = res["LOGPROBS"]
            t = torch.from_numpy(toks).to("cuda")
            want = language.longctx_scores(fwd(run.params, t), t).cpu().numpy()
            if got.shape != (1, S) or not np.isfinite(got).all():
                fail(f"{label}: bad LOGPROBS shape {got.shape} or non-finite")
            worst = max(worst, float(np.abs(got - want).max()))
            mean += float(np.abs(got - want).mean()) / N_REQUESTS
    atol = SERVED_ATOL["longctx_tpu", int8]
    print(f"{label}: LOGPROBS vs plain-kernel forward: max_abs_err "
          f"{worst:.3e} (atol {atol}), mean_abs_err {mean:.3e}", flush=True)
    if not worst <= atol:
        fail(f"{label}: served LOGPROBS disagree with the plain forward")
    profile_forward(label, run, torch, 4, S, 256)
    return launches


def serve_bert(label: str, torch, counters, int8: bool, int8_per_layer: int,
               transports: bool = False):
    """Serve bert_large at full width: BERT_REQUESTS requests of BERT_ROWS
    sequences from BERT_THREADS threads, each LOGITS held to the
    plain-kernel forward of its tokens, and the control beyond the bound;
    int8 launches ``int8_per_layer`` per layer, flash none.  Where
    ``transports``, then on the same server ``bert_transports``.  Then one
    B = 32 forward timed and traced.  Returns launch counts."""
    import numpy as np

    from triton_client_tpu_torch.models import language
    from triton_client_tpu_torch.models import transformer as tr

    model = language.make_bert_large("cuda")
    S, V = language.BERT_SEQ_LEN, language.BERT_LARGE.vocab_size
    rng = np.random.default_rng(4321)
    tokens = [rng.integers(0, V, (BERT_ROWS, S)).astype(np.int32)
              for _ in range(BERT_REQUESTS)]
    with serving_harness([model]) as harness:
        results, launches, executions = send_requests(
            label, harness.http_port, "bert_large",
            [[("INPUT_IDS", "INT32", t)] for t in tokens], BERT_THREADS,
            counters, ["LOGITS"], model)
        if transports:
            bert_transports(label, torch, counters, harness, model, int8,
                            int8_per_layer)
    layers = language.BERT_LARGE.n_layers
    check_launches(label, launches, executions, 0, int8_per_layer * layers)
    run = model.transformer
    check_precision(label, run, int8)
    fwd = tr.make_forward(run.cfg, quantized=int8,
                          head_cols=language.BERT_HEAD_COLS, plain=True)
    worst, mean, typical = 0.0, 0.0, 0.0
    controls = [0.0] * len(CONTROL_SCALES)
    with torch.inference_mode():
        for toks, res in zip(tokens, results):
            got = res["LOGITS"]
            want = fwd(run.params, torch.from_numpy(toks).to("cuda"))
            want = want.cpu().numpy()
            if got.shape != (BERT_ROWS, S, 2) or not np.isfinite(got).all():
                fail(f"{label}: bad LOGITS shape {got.shape} or non-finite")
            worst = max(worst, float(np.abs(got - want).max()))
            mean += float(np.abs(got - want).mean()) / BERT_REQUESTS
            typical += float(np.abs(want).mean()) / BERT_REQUESTS
        for i, scale in enumerate(CONTROL_SCALES):
            faulty = control_params(torch, run.params, scale)
            for toks, res in zip(tokens, results):
                ctl = fwd(faulty, torch.from_numpy(toks).to("cuda"))
                controls[i] = max(controls[i], float(
                    np.abs(res["LOGITS"] - ctl.cpu().numpy()).max()))
            del faulty
    check_served(label, "LOGITS", SERVED_ATOL["bert_large", int8], worst,
                 mean, controls, typical)
    profile_forward(label, run, torch, 32, S, V)
    return launches


LONGCTX_SEED, BERT_SEED = 1357, 2468


def longctx_check(label: str, torch, model, x):
    """The check of longctx_tpu bf16 answers to ``x``: LOGPROBS within
    SERVED_ATOL of the plain-kernel forward."""
    import numpy as np

    from triton_client_tpu_torch.models import language
    from triton_client_tpu_torch.models import transformer as tr

    run = model.transformer
    fwd = tr.make_forward(run.cfg, plain=True)
    t = torch.from_numpy(x).to("cuda")
    with torch.inference_mode():
        want = language.longctx_scores(fwd(run.params, t), t).cpu().numpy()
    atol = SERVED_ATOL["longctx_tpu", False]

    def check(name, got):
        err = float(np.abs(got - want).max()) if got.shape == want.shape \
            else float("inf")
        print(f"{label} {name}: LOGPROBS vs plain-kernel forward: "
              f"max_abs_err {err:.3e} (atol {atol})", flush=True)
        if not (np.isfinite(got).all() and err <= atol):
            fail(f"{label} {name}: served LOGPROBS disagree with the plain "
                 "forward")

    return check


def longctx_transports(label: str, torch, counters, harness, model) -> None:
    """longctx_tpu base bf16 at batch 4 by wire, system shm and CUDA shm in
    this process (``serve_transports``): LOGPROBS within SERVED_ATOL of the
    plain-kernel forward, flash once per layer."""
    S, vocab = model.config.input[0].dims[0], 256
    x = model_tokens(LONGCTX_SEED, model.max_batch_size, S, vocab)
    serve_transports(label, harness, model, counters, x, LONGCTX_SEED, vocab,
                     longctx_check(label, torch, model, x),
                     SERVED_ATOL["longctx_tpu", False],
                     model.transformer.cfg.n_layers, 0, cross_process=False)


def bert_check(label: str, torch, model, int8: bool, x):
    """The check of bert_large answers to ``x``: each LOGITS within
    SERVED_ATOL of the plain-kernel forward of the same tokens, beside the
    controls."""
    import numpy as np

    from triton_client_tpu_torch.models import language
    from triton_client_tpu_torch.models import transformer as tr

    run = model.transformer
    fwd = tr.make_forward(run.cfg, quantized=int8,
                          head_cols=language.BERT_HEAD_COLS, plain=True)
    t = torch.from_numpy(x).to("cuda")
    with torch.inference_mode():
        want = fwd(run.params, t).cpu().numpy()
        controls = []
        for scale in CONTROL_SCALES:
            faulty = control_params(torch, run.params, scale)
            controls.append(fwd(faulty, t).cpu().numpy())
            del faulty
    atol = SERVED_ATOL["bert_large", int8]

    def check(name, got):
        if got.shape != want.shape or not np.isfinite(got).all():
            fail(f"{label} {name}: bad LOGITS shape {got.shape} or "
                 "non-finite")
        diff = np.abs(got - want)
        check_served(f"{label} {name}", "LOGITS", atol, float(diff.max()),
                     float(diff.mean()),
                     [float(np.abs(got - c).max()) for c in controls],
                     float(np.abs(want).mean()))

    return check


def bert_transports(label: str, torch, counters, harness, model, int8: bool,
                    int8_per_layer: int) -> None:
    """bert_large at request batch 32 (INPUT_IDS [32, 384] -> LOGITS
    [32, 384, 2]) by all four transports (``serve_transports``): each
    LOGITS within SERVED_ATOL of the plain-kernel forward of the same
    tokens, beside the controls; int8 ``int8_per_layer`` per layer."""
    from triton_client_tpu_torch.models import language

    S, V = language.BERT_SEQ_LEN, language.BERT_LARGE.vocab_size
    x = model_tokens(BERT_SEED, BERT_SHM_ROWS, S, V)
    serve_transports(label, harness, model, counters, x, BERT_SEED, V,
                     bert_check(label, torch, model, int8, x),
                     SERVED_ATOL["bert_large", int8], 0,
                     int8_per_layer * model.transformer.cfg.n_layers,
                     cross_process=True)


def check_tokens(label, toks, plain_last, atol) -> None:
    """Each NEXT_TOKEN the plain forward's argmax or a near tie (the plain
    logit at the served token within ``atol`` of the max)."""
    import numpy as np

    ties = 0
    for tok, last in zip(toks, plain_last):
        tok = int(np.asarray(tok).reshape(-1)[0])
        if tok != int(last.argmax()):
            ties += 1
            if not last[tok] >= float(last.max()) - atol:
                fail(f"{label}: NEXT_TOKEN {tok} is not the plain forward's "
                     f"argmax {int(last.argmax())} nor within {atol} of it")
    print(f"{label}: NEXT_TOKEN equal to the plain forward's argmax in "
          f"{len(toks) - ties} of {len(toks)}, near ties {ties} (atol "
          f"{atol})", flush=True)


def check_next_tokens(label, torch, run, int8, tokens, results,
                      atol) -> None:
    """Each request's NEXT_TOKEN as ``check_tokens`` says, and its
    NEXT_LOGIT within ``atol`` of the plain forward's max; the controls'
    maxima read as ``check_served`` says."""
    import numpy as np

    plain = _plain_last_logits(torch, run, int8, tokens)
    check_tokens(label, [r["NEXT_TOKEN"] for r in results], plain, atol)

    def errs(last_logits):
        return [abs(float(r["NEXT_LOGIT"].reshape(-1)[0]) - float(last.max()))
                for r, last in zip(results, last_logits)]

    err = errs(plain)
    controls = [max(errs(_plain_last_logits(
        torch, run, int8, tokens, control_params(torch, run.params, scale))))
        for scale in CONTROL_SCALES]
    check_served(label, "NEXT_LOGIT", atol, max(err), float(np.mean(err)),
                 controls, float(np.mean([abs(float(last.max()))
                                          for last in plain])))


def _plain_last_logits(torch, run, int8, tokens, params=None):
    """The plain-kernel forward's last-position logits of each token row
    (with ``params`` in place of the served weights where given)."""
    from triton_client_tpu_torch.models import transformer as tr

    fwd = tr.make_forward(run.cfg, quantized=int8, plain=True)
    params = run.params if params is None else params
    out = []
    with torch.inference_mode():
        for toks in tokens:
            t = torch.clamp(torch.from_numpy(toks).to("cuda"), 0,
                            run.cfg.vocab_size - 1)
            out.append(fwd(params, t)[0, -1].float().cpu().numpy())
    return out


def serve_next_token(label: str, torch, counters, make, name: str,
                     int8: bool, int8_per_layer: int):
    """Serve a next-token model (moe_tpu or llama_tpu) directly: N_REQUESTS
    from N_THREADS threads, held as ``check_next_tokens`` says; the int8
    kernel launches ``int8_per_layer`` times per layer.  Returns launch
    counts."""
    import numpy as np

    model = make("cuda")
    run = model.transformer
    S = model.config.input[0].dims[0]
    rng = np.random.default_rng(99)
    tokens = [rng.integers(0, 256, (1, S)).astype(np.int32)
              for _ in range(N_REQUESTS)]
    with serving([model]) as port:
        results, launches, executions = send_requests(
            label, port, name, [[("TOKENS", "INT32", t)] for t in tokens],
            N_THREADS, counters, ["NEXT_TOKEN", "NEXT_LOGIT"], model)
    check_launches(label, launches, executions, 0,
                   int8_per_layer * run.cfg.n_layers)
    check_precision(label, run, int8)
    check_next_tokens(label, torch, run, int8, tokens, results,
                      SERVED_ATOL[name, int8])
    profile_forward(label, run, torch, model.max_batch_size, S,
                    run.cfg.vocab_size)
    return launches


def serve_ensemble(label: str, torch, counters, int8: bool):
    """ensemble_llama over llama_tpu 1b: N_REQUESTS binary BYTES TEXT
    requests from N_THREADS threads; OUT_TEXT must be ``bytes([NEXT_TOKEN %
    256])`` and NEXT_TOKEN the plain forward's argmax of the preprocessed
    tokens, or a near tie.  Then, on the same server, those token rows go
    to llama_tpu directly, held as ``check_next_tokens`` says (its
    NEXT_LOGIT is the ensemble's internal ``_logit``, not on the wire).
    Returns the ensemble window's launch counts."""
    import numpy as np

    from triton_client_tpu_torch.models import language

    llama = language.make_llama_tpu("cuda")
    run = llama.transformer
    pre = language.make_llama_preprocess()
    texts = [f"request {i}: the quick brown fox jumps over {i * 7} lazy "
             "dogs".encode() + bytes([0x80 + i, 0xff])
             for i in range(N_REQUESTS)]
    tokens = [pre.execute({"TEXT": np.array([[t]], dtype=object)},
                          {})["TOKENS"] for t in texts]
    with serving([pre, llama, language.make_llama_postprocess(),
                  language.make_ensemble_llama()]) as port:
        results, launches, executions = send_requests(
            label, port, "ensemble_llama",
            [[("TEXT", "BYTES", np.array([[t]], dtype=object))]
             for t in texts],
            N_THREADS, counters, ["OUT_TEXT", "NEXT_TOKEN"], llama)
        direct = "serve llama_tpu bf16 (the ensemble's token rows)"
        direct_results, direct_launches, direct_executions = send_requests(
            direct, port, "llama_tpu",
            [[("TOKENS", "INT32", t)] for t in tokens], N_THREADS, counters,
            ["NEXT_TOKEN", "NEXT_LOGIT"], llama)
    check_launches(label, launches, executions, 0, 0)
    check_launches(direct, direct_launches, direct_executions, 0, 0)
    check_precision(label, run, int8)
    for text, res in zip(texts, results):
        out_text, tok = res["OUT_TEXT"], res["NEXT_TOKEN"]
        if out_text.shape != (1, 1) or tok.shape != (1, 1) or \
                bytes(out_text[0, 0]) != bytes([int(tok[0, 0]) % 256]):
            fail(f"{label}: OUT_TEXT {out_text!r} does not match NEXT_TOKEN "
                 f"{tok!r} for {text!r}")
    atol = SERVED_ATOL["llama_tpu", int8]
    check_tokens(label, [r["NEXT_TOKEN"] for r in results],
                 _plain_last_logits(torch, run, int8, tokens), atol)
    check_next_tokens(direct, torch, run, int8, tokens, direct_results, atol)
    fwd_ms = profile_forward(label, run, torch, 8, language.LLAMA_SEQ_LEN,
                             run.cfg.vocab_size)
    # the f32 head over the 128,256-column vocab at every position
    D, V = run.cfg.d_model, run.cfg.vocab_size
    h = torch.randn((8, language.LLAMA_SEQ_LEN, D), device="cuda")
    head = run.params["head"]
    head_ms = timed_ms(lambda: h.float() @ head.float(), iters=5)
    flops = 2.0 * 8 * language.LLAMA_SEQ_LEN * D * V
    print(f"{label}: f32 head [8,{language.LLAMA_SEQ_LEN},{D}] x [{D},{V}] "
          f"{head_ms:.3f} ms ({flops / head_ms / 1e9:.1f} TFLOP/s in f32), "
          f"{head_ms / fwd_ms:.1%} of the B=8 forward", flush=True)
    del h
    return launches


# ---------------------------------------------------------------------------
# Shared-memory transports
# ---------------------------------------------------------------------------

# per transport: requests one after another (p50, p99), then clients sending
# at once (infer/s)
SHM_SEQUENTIAL, SHM_CLIENTS, SHM_PER_CLIENT = 30, 4, 8
# bert_large's transport requests: one batch of 32 sequences
BERT_SHM_ROWS = 32
# system shm keys of this run start with this and the pid
SHM_PREFIX = "chip_smoke_"
# the card's name and power limit, printed beside every transport number
CARD = ""
#: "<phase> <transport>" -> that window's kernel launches
SHM_PATHS = {}


def _nbytes(datatype: str, shape) -> int:
    import numpy as np

    from triton_client_tpu_torch.utils import triton_to_np_dtype

    return int(np.prod(shape)) * triton_to_np_dtype(datatype).itemsize


class WireClient:
    """Tensors in the request body, binary (transport (a)), on one
    kept-alive connection, through a prepared request: HTTP, or gRPC
    unary or on a stream (``_Sender``)."""

    def __init__(self, port: int, inp, out, protocol: str = "http",
                 stream: bool = False):
        self.sender, self.out = _Sender(port, protocol, stream), out
        self._in = self.sender.mod.InferInput(inp[0], inp[2], inp[1])
        self._out = self.sender.mod.InferRequestedOutput(out[0])

    def infer(self, model: str, x):
        """(output, seconds from the request's making to the output's
        arrival)."""
        t0 = time.perf_counter()
        self._in.set_data_from_numpy(x)
        got = self.sender.send(model, [self._in], [self._out]).as_numpy(
            self.out[0])
        return got, time.perf_counter() - t0

    def close(self) -> None:
        self.sender.close()


class ShmClient:
    """One client's two regions, for a model's input ``inp`` and output
    ``out`` ((name, datatype, shape) each), registered with the server on
    ``port`` through the port's client (one kept-alive connection):
    ``kind`` "system" (POSIX shm) or "cuda" (CUDA regions of this process:
    read in place by a server in this process, mapped with
    cudaIpcOpenMemHandle by one in another)."""

    def __init__(self, port: int, kind: str, tag: str, inp, out,
                 protocol: str = "http", stream: bool = False):
        from triton_client_tpu_torch.utils import cuda_shared_memory
        from triton_client_tpu_torch.utils import shared_memory

        self.kind, self.out = kind, out
        self.sender = _Sender(port, protocol, stream)
        self.client = self.sender.client
        self.mod = shared_memory if kind == "system" else cuda_shared_memory
        self.regions = {}
        for role, (_, datatype, shape) in (("in", inp), ("out", out)):
            name, nbytes = f"{tag}_{role}", _nbytes(datatype, shape)
            if kind == "system":
                key = f"/{SHM_PREFIX}{os.getpid()}_{name}"
                h = shared_memory.create_shared_memory_region(
                    name, key, nbytes, create_only=True)
                self.regions[role] = (name, h, nbytes)
                self.client.register_system_shared_memory(name, key, nbytes)
            else:
                h = cuda_shared_memory.create_shared_memory_region(
                    name, nbytes, 0)
                self.regions[role] = (name, h, nbytes)
                self.client.register_cuda_shared_memory(
                    name, cuda_shared_memory.get_raw_handle(h), 0, nbytes)
        mod = self.sender.mod
        self._in = mod.InferInput(inp[0], inp[2], inp[1]).set_shared_memory(
            self.regions["in"][0], self.regions["in"][2])
        self._out = mod.InferRequestedOutput(out[0]).set_shared_memory(
            self.regions["out"][0], self.regions["out"][2])

    def infer(self, model: str, x):
        """Write ``x``, infer with both tensors in regions, read the output
        back: (output, seconds)."""
        import numpy as np

        from triton_client_tpu_torch.utils import triton_to_np_dtype

        t0 = time.perf_counter()
        (_, hin, _), (rout, hout, _) = (self.regions["in"],
                                        self.regions["out"])
        self.mod.set_shared_memory_region(hin, [x])
        entry = self.sender.output_entry(
            self.sender.send(model, [self._in], [self._out]), self.out[0])
        if "data" in entry or entry["parameters"].get(
                "shared_memory_region") != rout:
            fail(f"{self.kind} shm: the response carried {entry}, not the "
                 "output's region")
        got = np.array(self.mod.get_contents_as_numpy(
            hout, triton_to_np_dtype(self.out[1]), self.out[2]))
        return got, time.perf_counter() - t0

    def close(self) -> None:
        unregister = (self.client.unregister_system_shared_memory
                      if self.kind == "system"
                      else self.client.unregister_cuda_shared_memory)
        for name, h, _ in self.regions.values():
            unregister(name)
            self.mod.destroy_shared_memory_region(h)
        self.sender.close()


def _shm_status(port: int):
    """Both of the server's shared-memory status lists."""
    client = _client(port)
    try:
        return {"systemsharedmemory":
                client.get_system_shared_memory_status(),
                "cudasharedmemory": client.get_cuda_shared_memory_status()}
    finally:
        client.close()


def run_transport(make_client, model: str, x):
    """Through clients from ``make_client(tag)``: the answer to ``x`` (the
    first request, the warm-up too), SHM_SEQUENTIAL requests one after
    another, then SHM_CLIENTS clients sending SHM_PER_CLIENT each at once.
    Returns (answer, sequential latencies in s, infer/s of the concurrent
    window, requests sent)."""
    first = make_client("seq")
    try:
        answer, _ = first.infer(model, x)
        latencies = [first.infer(model, x)[1]
                     for _ in range(SHM_SEQUENTIAL)]
    finally:
        first.close()
    clients = [make_client(f"c{i}") for i in range(SHM_CLIENTS)]
    errors = []
    start = threading.Barrier(SHM_CLIENTS)

    def send(client):
        try:
            start.wait(timeout=60)
            for _ in range(SHM_PER_CLIENT):
                client.infer(model, x)
        except BaseException as e:  # reported below, then fail
            errors.append(repr(e))

    threads = [threading.Thread(target=send, args=(c,)) for c in clients]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    for c in clients:
        c.close()
    if errors or any(t.is_alive() for t in threads):
        fail(f"{model}: concurrent clients failed: {errors}")
    n = SHM_CLIENTS * SHM_PER_CLIENT
    return answer, latencies, n / wall, 1 + SHM_SEQUENTIAL + n


def run_sequential(client, model: str, x, n: int):
    """Through ``client``: the answer to ``x`` (the first request, the
    warm-up too), then ``n`` requests one after another.  Returns (answer,
    their latencies in s); the client is closed."""
    try:
        answer, _ = client.infer(model, x)
        return answer, [client.infer(model, x)[1] for _ in range(n)]
    finally:
        client.close()


def shm_client_main(spec_json: str) -> int:
    """The cross-process client (transport (d)), started by the smoke run as
    ``chip_smoke.py --shm-client SPEC``: it makes CUDA regions in its own
    process, so the server maps them with cudaIpcOpenMemHandle; it runs
    ``run_transport`` and prints one ``RESULT`` line."""
    import base64

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from triton_client_tpu_torch._cuda_broker import broker
    from triton_client_tpu_torch.utils import cuda_shared_memory

    spec = json.loads(spec_json)
    x = model_tokens(spec["seed"], spec["rows"], spec["seq_len"],
                     spec["vocab"])
    inp, out = tuple(spec["input"]), tuple(spec["output"])

    def make(tag):
        return ShmClient(spec["port"], "cuda", f"ipc_{tag}", inp, out,
                         spec.get("protocol", "http"),
                         spec.get("stream", False))

    if spec.get("sequential"):
        answer, lat = run_sequential(make("seq"), spec["model"], x,
                                     spec["sequential"])
        rate, n = 0.0, 1 + spec["sequential"]
    else:
        answer, lat, rate, n = run_transport(make, spec["model"], x)
    print("RESULT " + json.dumps({
        "answer": base64.b64encode(np.ascontiguousarray(answer).tobytes())
        .decode(), "latencies": lat, "infer_per_s": rate, "requests": n,
        "left": cuda_shared_memory.allocated_shared_memory_regions(),
        "server_present": broker().server_present}), flush=True)
    return 0


def model_tokens(seed: int, rows: int, seq_len: int, vocab: int):
    import numpy as np

    return np.random.default_rng(seed).integers(
        0, vocab, (rows, seq_len)).astype(np.int32)


def _cross_process(port: int, model: str, inp, out, seed, rows, seq_len,
                   vocab, **options):
    """Run the cross-process client; returns its RESULT.  ``options``:
    ``protocol`` and ``stream`` of its client, and ``sequential``: send
    that many requests after the first, one after another, and no more."""
    import base64

    import numpy as np

    spec = json.dumps({"port": port, "model": model, "input": inp,
                       "output": out, "seed": seed, "rows": rows,
                       "seq_len": seq_len, "vocab": vocab, **options})
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--shm-client", spec],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        stdout, stderr = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines = [ln for ln in stdout.splitlines() if ln.startswith("RESULT ")]
    if proc.returncode != 0 or not lines:
        fail(f"the cross-process client exited {proc.returncode}: "
             f"{stdout[-1500:]} {stderr[-3000:]}")
    res = json.loads(lines[-1][len("RESULT "):])
    if res["left"] or res["server_present"]:
        fail(f"the cross-process client left regions {res['left']} or saw "
             "an in-process server")
    from triton_client_tpu_torch.utils import triton_to_np_dtype

    res["answer"] = np.frombuffer(base64.b64decode(res["answer"]),
                                  triton_to_np_dtype(out[1])).reshape(out[2])
    return res


def serve_transports(label: str, harness, model, counters, x, seed: int,
                     vocab: int, check, atol: float, flash_per_forward: int,
                     int8_per_forward: int, cross_process: bool):
    """The same request ``x`` by each transport -- (a) the HTTP body,
    (b) system shm, (c) CUDA shm in this process, and where
    ``cross_process`` (d) CUDA shm of another process -- on the running
    server ``harness``: each answer held by ``check(transport, answer)`` and
    to the wire answer within ``atol``, kernel launches counted per forward, p50 / p99 of
    SHM_SEQUENTIAL requests, infer/s of SHM_CLIENTS at once and the server's
    median split of a request.  Then no region may be left: none in this
    process, no key of the run in /dev/shm, both status lists empty."""
    import numpy as np

    from triton_client_tpu_torch._cuda_broker import broker
    from triton_client_tpu_torch.utils import cuda_shared_memory

    port, core = harness.http_port, harness.core
    cfg = model.config
    inp = (cfg.input[0].name, cfg.input[0].data_type, list(x.shape))
    out = (cfg.output[0].name, cfg.output[0].data_type,
           [x.shape[0]] + list(cfg.output[0].dims))
    if not broker().server_present:
        fail(f"{label}: the in-process server did not mark the broker")
    transports = {
        "wire": lambda tag: WireClient(port, inp, out),
        "system shm": lambda tag: ShmClient(port, "system", f"sys_{tag}",
                                            inp, out),
        "cuda shm": lambda tag: ShmClient(port, "cuda", f"cuda_{tag}", inp,
                                          out),
    }
    if cross_process:
        transports["cuda shm, other process"] = None
    answers = {}
    for name, make in transports.items():
        st = model.stats
        runs0 = st.batch_execution_count
        _reset(counters)
        core.splits = []
        if make is None:
            res = _cross_process(port, model.name, inp, out, seed,
                                 x.shape[0], x.shape[1], vocab)
            answer, lat, rate, n = (res["answer"], res["latencies"],
                                    res["infer_per_s"], res["requests"])
        else:
            answer, lat, rate, n = run_transport(make, model.name, x)
        splits, core.splits = core.splits, None
        # a wire request goes through the batcher, a shm one past it
        forwards = (st.batch_execution_count - runs0) if name == "wire" \
            else n
        launches = {k: mod.launches for k, mod in counters.items()}
        launches["int8_quantize_rows"] = \
            counters["int8_matmul"].quantize_launches
        check_launches(f"{label} {name}", launches, forwards,
                       flash_per_forward, int8_per_forward)
        SHM_PATHS[f"{label} {name}"] = launches
        seq = splits[1:1 + SHM_SEQUENTIAL]
        if len(splits) != n or len(seq) != SHM_SEQUENTIAL:
            fail(f"{label} {name}: the server recorded {len(splits)} "
                 f"requests, {n} were sent")
        med = {k: float(np.median([getattr(sp, k) for sp in seq]))
               for k in ("decode", "resolve", "forward", "output", "total")}
        lat_ms = 1e3 * np.asarray(lat)
        print(f"{label} {name}: {out[0]} {list(answer.shape)}; p50 "
              f"{np.percentile(lat_ms, 50):.3f} ms, p99 "
              f"{np.percentile(lat_ms, 99):.3f} ms over {len(lat)} requests "
              f"one after another; {rate:.2f} infer/s from {SHM_CLIENTS} "
              f"clients at once; server split (median of {len(seq)}): "
              f"decode {med['decode']:.3f} ms, input resolution "
              f"{med['resolve']:.3f} ms, forward {med['forward']:.3f} ms "
              "(CUDA events), output write or readback "
              f"{med['output']:.3f} ms, total {med['total']:.3f} ms; "
              "client p50 minus server total "
              f"{np.percentile(lat_ms, 50) - med['total']:.3f} ms (kept-alive "
              f"connections); {forwards} forwards, launches {launches}; "
              f"{CARD}", flush=True)
        check(name, answer)
        answers[name] = answer
    for name, answer in answers.items():
        err = float(np.abs(answer - answers["wire"]).max())
        print(f"{label} {name} vs wire: max_abs_err {err:.3e}", flush=True)
        if not err <= atol:
            fail(f"{label} {name}: the answer differs from the wire answer "
                 f"by {err:.3e} (atol {atol})")
    left = cuda_shared_memory.allocated_shared_memory_regions()
    keys = [k for k in os.listdir("/dev/shm")
            if k.startswith(f"{SHM_PREFIX}{os.getpid()}")]
    status = _shm_status(port)
    print(f"{label}: regions left: {left} in this process, {keys} in "
          f"/dev/shm, status {status}", flush=True)
    if left or keys or any(status.values()):
        fail(f"{label}: shared-memory regions were left behind")



# ---------------------------------------------------------------------------
# perf_analyzer: the load generator against the served models
# ---------------------------------------------------------------------------

# each level: 1 s of warm-up, then a window of this many ms.  Little's
# law over a window counts, per worker, the requests that end in it: their
# latencies sum to the window give or take the request in flight at each
# edge, so the reading is off by up to (longest latency) / (window).  2 s
# where requests take up to ~0.2 s (longctx_tpu); 6 s where they take up
# to ~1 s (bert_large at -b 32 and c = 4, at -b 1 and c = 15), at most 17%
PERF_WINDOW_MS = 2000
PERF_LONG_WINDOW_MS = 6000
# Little's law at each closed-loop level: the concurrency within this share
# of infer/s x mean latency (the tool counts what it sends)
LITTLE_TOL = 0.25
# a gate read on the host's clock (Little's law, the traced COMPUTE spans,
# observability's cost) that misses is read once more, at the same bound,
# from a new run of the same load, and fails if that run misses too: the
# card's host shares its cores, and a stall of a second or more (a 2.95 s
# bert_large forward, a client idle half a window, one COMPUTE 12% long)
# is the host's, not the served path's.  Both readings are printed
HOST_GATE_RUNS = 2
#: "<path>" -> the kernel launches of that perf_analyzer run
PERF_PATHS = {}
#: "<path>" -> that perf_analyzer run's levels
PERF_LEVELS = {}


def check_flash_refuses_grad(fa, torch) -> None:
    """The flash kernel has no backward yet (ROADMAP A1): with grad mode on
    it refuses inputs that require grad and launches nothing; under
    torch.no_grad() it runs and agrees with its plain version."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn((1, 2, 128, 64), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    q.requires_grad_()
    before = fa.launches
    try:
        fa.flash_attention(q, k, v)
    except RuntimeError as e:
        refused = "ROADMAP A1" in str(e)
    else:
        refused = False
    if not refused or fa.launches != before:
        fail("flash_attention took a q that requires grad on the card")
    with torch.no_grad():
        got = fa.flash_attention(q, k, v)
        want = fa.flash_attention_reference(q, k, v)
    err = (got.float() - want.float()).abs().max().item()
    print(f"flash_attention refuses a q that requires grad (no launch); "
          f"under no_grad it runs, max_abs_err {err:.3e}", flush=True)
    if fa.launches != before + 1 or got.grad_fn is not None or \
            not err <= FLASH_TOL["bf16"][0]:
        fail("flash_attention under no_grad did not run as it should")


def _device_busy(prof):
    """(busy ms, span ms, events) of a torch.profiler trace's device work:
    the sum of the device events' durations, and the span from the first
    one's start to the last one's end."""
    events = [e for e in prof.events()
              if str(e.device_type).endswith("CUDA")
              and e.time_range.elapsed_us() > 0]
    if not events:
        return 0.0, 0.0, 0
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
    span = (max(e.time_range.end for e in events)
            - min(e.time_range.start for e in events)) / 1e3
    return busy, span, len(events)


def _perf_analyzer(label: str, harness, model, args, counters,
                   window_ms: int, trace: bool = False):
    """Run ``python -m triton_client_tpu_torch.perf_analyzer -v`` with
    ``args`` in a process of its own against the server ``harness`` of this
    process, the launch counts zeroed just before it and read just after;
    fail unless it exits 0, prints its levels and leaves no region.  Where
    ``trace``, the card is traced with torch.profiler for the whole run
    and its busy share printed.  Returns (the levels' results, launches,
    the model's executions as ``(perf_counter s, rows)``, the server's
    splits)."""
    from torch.profiler import ProfilerActivity, profile

    st, core = model.stats, harness.core
    st.executions, core.splits = [], []
    _reset(counters)
    cmd = [sys.executable, "-m", "triton_client_tpu_torch.perf_analyzer",
           "-m", model.name, "-u", harness.http_url, "-v",
           "--measurement-interval", str(window_ms), *args]
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.perf_counter()
    with (profile(activities=[ProfilerActivity.CUDA]) if trace
          else contextlib.nullcontext()) as prof:
        proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                              text=True, timeout=900)
    wall = time.perf_counter() - t0
    executions, st.executions = st.executions, None
    splits, core.splits = core.splits, None
    launches = {name: mod.launches for name, mod in counters.items()}
    launches["int8_quantize_rows"] = counters["int8_matmul"].quantize_launches
    if proc.returncode != 0:
        fail(f"{label}: perf_analyzer exited {proc.returncode}: "
             f"{proc.stdout[-2000:]} {proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    # a level with no completed request prints its latencies as null
    results = [{k: float("nan") if v is None and k.endswith(("_us", "_ms"))
                else v for k, v in json.loads(ln.split("result ", 1)[1])
                .items()}
               for ln in lines if ln.startswith("  result ")]
    left = [json.loads(ln[len("regions left "):]) for ln in lines
            if ln.startswith("regions left ")]
    if not results or left != [{"system": [], "cuda": []}]:
        fail(f"{label}: perf_analyzer printed {len(results)} levels and "
             f"left regions {left}: {proc.stdout[-2000:]}")
    print(f"{label}: perf_analyzer {' '.join(args)} in {wall:.1f} s, "
          f"{len(executions)} executions, launches {launches}", flush=True)
    if trace:
        busy, span, n = _device_busy(prof)
        print(f"{label}: traced {n} device events: busy {busy:.1f} ms of "
              f"the {span:.1f} ms from the first to the last, idle "
              f"{1 - busy / span if span else float('nan'):.1%}; "
              f"{busy / max(len(executions), 1):.3f} ms of device time per "
              f"execution; {CARD}", flush=True)
    return results, launches, executions, splits


def perf_sweep(label: str, harness, model, args, counters,
               flash_per_forward: int, int8_per_forward: int,
               window_ms: int = PERF_WINDOW_MS, trace: bool = False,
               paths=None):
    """Run ``python -m triton_client_tpu_torch.perf_analyzer`` with
    ``args`` in a process of its own against the server ``harness`` of this
    process; print each level (infer/s, p50/p90/p99, errors, the model's
    executions in the level's window and their batch sizes, and the
    server's median split of the requests whose forward ended in the
    window) and check: the tool exited 0, no errors, launches exactly per
    execution, Little's law at each closed-loop level (a miss runs the
    sweep once more, HOST_GATE_RUNS), no region left in the tool's
    process.  Where ``trace``, the card is traced with
    torch.profiler for the whole run and its busy share under that load
    printed.  The run's launches go into ``paths`` (PERF_PATHS where not
    given) and its levels into PERF_LEVELS.  Returns the levels'
    results."""
    for run in range(1, HOST_GATE_RUNS + 1):
        results, misses = _perf_sweep_once(
            label, harness, model, args, counters, flash_per_forward,
            int8_per_forward, window_ms, trace, paths)
        if not misses:
            break
        if run == HOST_GATE_RUNS:
            fail(f"{label} {misses[0]}: Little's law off by more than "
                 f"{LITTLE_TOL:.0%} in {run} runs")
        print(f"{label}: Little's law off by more than {LITTLE_TOL:.0%} at "
              f"{', '.join(misses)}; the sweep once more", flush=True)
    PERF_LEVELS[label] = results
    return results


def _perf_sweep_once(label: str, harness, model, args, counters,
                     flash_per_forward: int, int8_per_forward: int,
                     window_ms: int, trace: bool, paths):
    """One run of :func:`perf_sweep`: its levels' results and the levels
    that missed Little's law."""
    from collections import Counter

    import numpy as np

    results, launches, executions, splits = _perf_analyzer(
        label, harness, model, args, counters, window_ms, trace)
    check_launches(label, launches, len(executions), flash_per_forward,
                   int8_per_forward)
    (PERF_PATHS if paths is None else paths)[label] = launches
    batch = int(args[args.index("-b") + 1])
    misses = []
    for res in results:
        lo, hi = res["window_start_s"], res["window_end_s"]
        rows = Counter(r for t, r in executions if lo <= t <= hi)
        seen = [sp for sp in splits
                if lo <= sp.forward_done_ns / 1e9 <= hi]
        med = {k: float(np.median([getattr(sp, k) for sp in seen]))
               if seen else float("nan")
               for k in ("decode", "resolve", "forward", "output", "total")}
        closed = "concurrency" in res
        level = (f"c={res['concurrency']}" if closed
                 else f"open loop {res['request_rate']:g}/s "
                      f"({res['distribution']}), {res['unsent']} unsent, "
                      f"send lag p99 {res['send_lag_p99_ms']:.2f} ms")
        thr = res["throughput"]
        print(f"{label} {level}: {thr:.3f} infer/s ({thr * batch:.2f} "
              f"sequences/s); latency p50 {res['p50_us'] / 1e3:.3f} ms, p90 "
              f"{res['p90_us'] / 1e3:.3f} ms, p99 {res['p99_us'] / 1e3:.3f} "
              f"ms, mean {res['avg_us'] / 1e3:.3f} ms; errors "
              f"{res['errors']}; {sum(rows.values())} executions in the "
              f"window, executed batch sizes (padded to the buckets) "
              f"{dict(sorted(rows.items()))}; server split (median of "
              f"{len(seen)} requests): decode {med['decode']:.3f} ms, input "
              f"resolution {med['resolve']:.3f} ms, forward "
              f"{med['forward']:.3f} ms (CUDA events, its batch's), output "
              f"{med['output']:.3f} ms, total {med['total']:.3f} ms; {CARD}",
              flush=True)
        if res["errors"]:
            fail(f"{label} {level}: {res['errors']} errors, first "
                 f"{res['first_error']}")
        if closed:
            c = res["concurrency"]
            little = thr * res["avg_us"] * 1e-6
            print(f"{label} {level}: Little's law: infer/s x mean latency "
                  f"= {little:.3f} against concurrency {c}", flush=True)
            if not abs(little - c) <= LITTLE_TOL * c:
                misses.append(level)
    return results, misses


def _no_regions_left(label: str, harness) -> None:
    """No region in this process, none of perf_analyzer's keys in
    /dev/shm, both of the server's status lists empty."""
    from triton_client_tpu_torch.utils import cuda_shared_memory

    left = cuda_shared_memory.allocated_shared_memory_regions()
    keys = [k for k in os.listdir("/dev/shm") if k.startswith("pa_")]
    status = _shm_status(harness.http_port)
    print(f"{label}: regions left: {left} in this process, {keys} in "
          f"/dev/shm, status {status}", flush=True)
    if left or keys or any(status.values()):
        fail(f"{label}: shared-memory regions were left behind")


def _warm(harness, model, rows: int) -> None:
    """One request of ``rows`` zero rows: it builds the weights."""
    import numpy as np

    cfg = model.config.input[0]
    client = _client(harness.http_port)
    try:
        _post_infer(client, model.name, [(cfg.name, cfg.data_type, np.zeros(
            [rows] + list(cfg.dims), np.int32))], [model.config.output[0].name])
    finally:
        client.close()


def perf_phase(torch, counters, fa) -> None:
    """The load generator drives the served models at full width from a
    process of its own: ``bert_large`` int8 (``w2``: 24 int8 launches per
    forward) at -b 32, c = 1 and 4, by wire, system shm and CUDA shm (the
    tool's regions, mapped with cudaIPC); at -b 1, c = 1, 8 and 15, through
    the dynamic batcher; open loop at half of c = 1's and of c = 8's
    infer/s; c = 4 traced; ``bert_large`` bf16 at -b 32, c = 1 (to compare
    with the transport phase); ``longctx_tpu`` base bf16 (8 flash launches
    per forward) at -b 4, c = 1 and 4, by wire and CUDA shm, and traced at
    c = 1 and 4."""
    from triton_client_tpu_torch.models import language

    check_flash_refuses_grad(fa, torch)
    layers = language.BERT_LARGE.n_layers
    os.environ["TRITON_TPU_QUANT_BERT_LARGE"] = "int8"
    os.environ["TRITON_TPU_INT8_FUSED"] = "w2"
    try:
        bert = language.make_bert_large("cuda")
        with serving_harness([bert]) as harness:
            _warm(harness, bert, 32)
            check_precision("perf bert_large int8", bert.transformer, True)
            for shm in ("none", "system", "cuda"):
                perf_sweep(f"perf bert_large int8 -b 32 {shm}", harness,
                           bert, ["-b", "32", "--concurrency-range", "1:4:3",
                                  "--shared-memory", shm], counters, 0,
                           layers, window_ms=PERF_LONG_WINDOW_MS)
            levels = perf_sweep(
                "perf bert_large int8 -b 1 dynamic batching", harness, bert,
                ["-b", "1", "--concurrency-range", "1:15:7"], counters, 0,
                layers, window_ms=PERF_LONG_WINDOW_MS)
            # open loop at half of c = 1's infer/s and at half of c = 8's:
            # c = 8's runs on batches of 8 that paced arrivals, one every
            # few ms, may never form
            low, high = (round(next(r["throughput"] for r in levels
                                    if r["concurrency"] == c) / 2, 3)
                         for c in (1, 8))
            rates = (f"{low:.3f}:{high:.3f}:{high - low:.3f}" if high > low
                     else f"{low:.3f}")
            perf_sweep("perf bert_large int8 -b 1 open loop", harness, bert,
                       ["-b", "1", "--request-rate-range", rates,
                        "--max-threads", "16"], counters, 0, layers)
            # where the device's time goes at c = 4
            perf_sweep("perf bert_large int8 -b 32 none c=4 traced",
                       harness, bert, ["-b", "32", "--concurrency-range",
                                       "4"], counters, 0, layers,
                       window_ms=PERF_LONG_WINDOW_MS, trace=True)
            _no_regions_left("perf bert_large int8", harness)
    finally:
        for var in ("TRITON_TPU_QUANT_BERT_LARGE", "TRITON_TPU_INT8_FUSED"):
            os.environ.pop(var, None)
    del bert
    gc.collect()
    torch.cuda.empty_cache()
    bert = language.make_bert_large("cuda")
    longctx = language.make_longctx_tpu("cuda")
    with serving_harness([bert, longctx]) as harness:
        _warm(harness, bert, 32)
        _warm(harness, longctx, 4)
        check_precision("perf bert_large bf16", bert.transformer, False)
        check_precision("perf longctx_tpu bf16", longctx.transformer, False)
        perf_sweep("perf bert_large bf16 -b 32 none", harness, bert,
                   ["-b", "32", "--concurrency-range", "1"], counters, 0, 0)
        for shm in ("none", "cuda"):
            perf_sweep(f"perf longctx_tpu bf16 -b 4 {shm}", harness, longctx,
                       ["-b", "4", "--concurrency-range", "1:4:3",
                        "--shared-memory", shm], counters,
                       longctx.transformer.cfg.n_layers, 0)
        for c in ("1", "4"):
            perf_sweep(f"perf longctx_tpu bf16 -b 4 none c={c} traced",
                       harness, longctx, ["-b", "4", "--concurrency-range",
                                          c], counters,
                       longctx.transformer.cfg.n_layers, 0, trace=True)
        _no_regions_left("perf bert_large bf16, longctx_tpu bf16", harness)
    del bert, longctx
    gc.collect()
    torch.cuda.empty_cache()

# ---------------------------------------------------------------------------
# gRPC: gRPC-Web on the HTTP port, unary and on streams
# ---------------------------------------------------------------------------

# per gRPC transport: the first request (its answer), then this many one
# after another (p50, p99)
GRPC_SEQUENTIAL = 10
# BASELINE row 5 on one stream, then this many streams at once
ROW5_STEPS, ROW5_STREAMS, ROW5_STREAM_STEPS = 32, 4, 16
ROW5_WINDOW = 128
#: "<phase> <transport>" -> the kernel launches of that gRPC window
GRPC_PATHS = {}


def _counted(label: str, model, counters, run, flash_per_forward: int,
             int8_per_forward: int, paths=None):
    """``run()`` with the launch counts zeroed just before and read just
    after, and the model's executions recorded meanwhile: launches checked
    exactly per execution and kept in ``paths`` (GRPC_PATHS where not
    given).  Returns (``run()``'s result, executions, launches)."""
    st = model.stats
    st.executions = []
    _reset(counters)
    try:
        out = run()
    finally:
        executions, st.executions = st.executions, None
    launches = {name: mod.launches for name, mod in counters.items()}
    launches["int8_quantize_rows"] = counters["int8_matmul"].quantize_launches
    check_launches(label, launches, len(executions), flash_per_forward,
                   int8_per_forward)
    (GRPC_PATHS if paths is None else paths)[label] = launches
    return out, len(executions), launches


def grpc_transports(label: str, harness, model, counters, x, seed: int,
                    vocab: int, check, atol: float, flash_per_forward: int,
                    int8_per_forward: int, cross_process: bool) -> None:
    """The same request ``x`` by HTTP wire (the answer to compare with) and
    over gRPC: unary by wire, a stream by wire, a stream with system shm,
    and where ``cross_process`` a stream with CUDA shm of another process
    (its regions mapped with cudaIpcOpenMemHandle).  Each answer held by
    ``check`` and within ``atol`` of the HTTP answer; launches exactly per
    execution in each window; p50 / p99 of GRPC_SEQUENTIAL requests one
    after another; then no region left."""
    import numpy as np

    from triton_client_tpu_torch.utils import cuda_shared_memory

    port = harness.http_port
    cfg = model.config
    inp = (cfg.input[0].name, cfg.input[0].data_type, list(x.shape))
    out = (cfg.output[0].name, cfg.output[0].data_type,
           [x.shape[0]] + list(cfg.output[0].dims))
    transports = {
        "http wire": lambda: WireClient(port, inp, out),
        "grpc unary wire": lambda: WireClient(port, inp, out, "grpc"),
        "grpc stream wire": lambda: WireClient(port, inp, out, "grpc",
                                               stream=True),
        "grpc stream system shm": lambda: ShmClient(
            port, "system", "gsys", inp, out, "grpc", stream=True),
    }
    if cross_process:
        transports["grpc stream cuda shm, other process"] = None
    answers = {}
    for name, make in transports.items():
        def run(make=make):
            if make is None:
                res = _cross_process(port, model.name, inp, out, seed,
                                     x.shape[0], x.shape[1], vocab,
                                     protocol="grpc", stream=True,
                                     sequential=GRPC_SEQUENTIAL)
                return res["answer"], res["latencies"]
            return run_sequential(make(), model.name, x, GRPC_SEQUENTIAL)

        (answer, lat), n_exec, launches = _counted(
            f"{label} {name}", model, counters, run, flash_per_forward,
            int8_per_forward)
        if n_exec != 1 + GRPC_SEQUENTIAL:
            fail(f"{label} {name}: {n_exec} executions for "
                 f"{1 + GRPC_SEQUENTIAL} requests")
        lat_ms = 1e3 * np.asarray(lat)
        print(f"{label} {name}: {out[0]} {list(answer.shape)}; p50 "
              f"{np.percentile(lat_ms, 50):.3f} ms, p99 "
              f"{np.percentile(lat_ms, 99):.3f} ms, mean "
              f"{lat_ms.mean():.3f} ms over {len(lat)} requests one after "
              f"another; {n_exec} executions, launches {launches}; {CARD}",
              flush=True)
        check(name, answer)
        answers[name] = answer
    for name, answer in answers.items():
        if name == "http wire":
            continue
        err = float(np.abs(answer - answers["http wire"]).max())
        print(f"{label} {name} vs http wire: max_abs_err {err:.3e}",
              flush=True)
        if not err <= atol:
            fail(f"{label} {name}: the answer differs from the HTTP answer "
                 f"by {err:.3e} (atol {atol})")
    left = cuda_shared_memory.allocated_shared_memory_regions()
    keys = [k for k in os.listdir("/dev/shm")
            if k.startswith(f"{SHM_PREFIX}{os.getpid()}")]
    status = _shm_status(port)
    if left or keys or any(status.values()):
        fail(f"{label}: regions left: {left} in this process, {keys} in "
             f"/dev/shm, status {status}")


def _beside_http(label: str, http_label: str) -> None:
    """Each level of the gRPC run ``label`` beside the same concurrency of
    this run's HTTP run ``http_label``."""
    http_levels = {r["concurrency"]: r for r in PERF_LEVELS[http_label]}
    for res in PERF_LEVELS[label]:
        h = http_levels.get(res["concurrency"])
        if h is None:
            continue
        print(f"{label} c={res['concurrency']} vs {http_label}: infer/s "
              f"{res['throughput']:.3f} / {h['throughput']:.3f}, p50 "
              f"{res['p50_us'] / 1e3:.3f} / {h['p50_us'] / 1e3:.3f} ms, p99 "
              f"{res['p99_us'] / 1e3:.3f} / {h['p99_us'] / 1e3:.3f} ms, mean "
              f"{res['avg_us'] / 1e3:.3f} / {h['avg_us'] / 1e3:.3f} ms "
              f"(gRPC / HTTP); {CARD}", flush=True)


def _generate(port: int, seq_id: int, steps: int, prompt: bytes):
    """BASELINE row 5's generation loop on one gRPC stream (the reference's
    protocol, benchmarks/run_baseline.py:231-262): each step sends the last
    ROW5_WINDOW bytes of the text as ensemble_llama's TEXT, with
    ``sequence_id``, start on the first step and end on the last, and
    appends OUT_TEXT; NEXT_TOKEN is requested too.  Each step's OUT_TEXT
    must be ``bytes([NEXT_TOKEN % 256])``; an error fails the run (on a
    thread: ends it, and the caller fails).  Returns (wall seconds from the
    first request to the last answer, per-token latencies, the windows
    sent, the tokens answered)."""
    import numpy as np

    from triton_client_tpu_torch import grpc

    sender = _Sender(port, "grpc", stream=True)
    client = sender.client
    text, lats, windows, tokens = prompt, [], [], []
    outputs = [grpc.InferRequestedOutput("OUT_TEXT"),
               grpc.InferRequestedOutput("NEXT_TOKEN")]
    try:
        t_gen = time.perf_counter()
        for step in range(steps):
            window = text[-ROW5_WINDOW:]
            inp = grpc.InferInput("TEXT", [1, 1], "BYTES")
            inp.set_data_from_numpy(np.array([[window]], dtype=object))
            t0 = time.perf_counter()
            client.async_stream_infer(
                "ensemble_llama", [inp], outputs=outputs,
                sequence_id=seq_id, sequence_start=step == 0,
                sequence_end=step == steps - 1)
            result = sender.answer(f"row 5 stream {seq_id} step {step}")
            lats.append(time.perf_counter() - t0)
            out_text = result.as_numpy("OUT_TEXT")
            tok = result.as_numpy("NEXT_TOKEN")
            if out_text.shape != (1, 1) or tok.shape != (1, 1) or \
                    bytes(out_text[0, 0]) != bytes([int(tok[0, 0]) % 256]):
                fail(f"row 5 stream {seq_id} step {step}: OUT_TEXT "
                     f"{out_text!r} does not match NEXT_TOKEN {tok!r}")
            windows.append(window)
            tokens.append(tok)
            text += bytes(out_text[0, 0])
        wall = time.perf_counter() - t_gen
    finally:
        sender.close()
    return wall, lats, windows, tokens


def grpc_generate(torch, counters) -> None:
    """BASELINE row 5 over gRPC: ensemble_llama over llama_tpu 1b bf16,
    ROW5_STEPS steps on one stream (sequence 1), each NEXT_TOKEN held to
    the plain forward of the preprocessed window (``check_tokens``); then
    ROW5_STREAMS streams of ROW5_STREAM_STEPS at once with no error; the
    ensemble's llama_tpu steps batch across the streams.  Prints tokens/s
    and the per-token p50 / p99."""
    import numpy as np

    from triton_client_tpu_torch.models import language

    label = "grpc row 5 ensemble_llama (llama_tpu 1b bf16)"
    llama = language.make_llama_tpu("cuda")
    run = llama.transformer
    pre = language.make_llama_preprocess()
    with serving_harness([pre, llama, language.make_llama_postprocess(),
                          language.make_ensemble_llama()]) as harness:
        port = harness.http_port
        _generate(port, 99, 1, b"warm-up")  # builds the weights
        check_precision(label, run, False)
        (wall, lats, windows, tokens), n_exec, launches = _counted(
            f"{label} one stream", llama, counters,
            lambda: _generate(port, 1, ROW5_STEPS,
                              b"In a hole in the ground there lived"), 0, 0)
        lat_ms = 1e3 * np.asarray(lats)
        print(f"{label}: {ROW5_STEPS} tokens on one stream in {wall:.3f} s, "
              f"{ROW5_STEPS / wall:.2f} tokens/s; per-token p50 "
              f"{np.percentile(lat_ms, 50):.3f} ms, p99 "
              f"{np.percentile(lat_ms, 99):.3f} ms, mean {lat_ms.mean():.3f} "
              f"ms; {n_exec} llama_tpu executions; {CARD}", flush=True)
        rows = [pre.execute({"TEXT": np.array([[w]], dtype=object)},
                            {})["TOKENS"] for w in windows]
        check_tokens(label, tokens, _plain_last_logits(torch, run, False,
                                                       rows),
                     SERVED_ATOL["llama_tpu", False])
        errors, results = [], [None] * ROW5_STREAMS

        def stream(i):
            try:
                results[i] = _generate(port, 2000 + i, ROW5_STREAM_STEPS,
                                       f"stream {i}: in the "
                                       "beginning".encode())
            except BaseException as e:  # reported below, then fail
                errors.append(repr(e))

        def concurrent():
            threads = [threading.Thread(target=stream, args=(i,))
                       for i in range(ROW5_STREAMS)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            if any(t.is_alive() for t in threads):
                errors.append("a stream did not end")
            return time.perf_counter() - t0

        st = llama.stats
        batches0, rows0 = st.batch_execution_count, st.batch_size_total
        wall, n_exec, _ = _counted(f"{label} {ROW5_STREAMS} streams", llama,
                                   counters, concurrent, 0, 0)
        if errors:
            fail(f"{label}: concurrent streams failed: {errors}")
        n_tok = ROW5_STREAMS * ROW5_STREAM_STEPS
        lat_ms = 1e3 * np.concatenate([np.asarray(r[1]) for r in results])
        batches = st.batch_execution_count - batches0
        print(f"{label}: {ROW5_STREAMS} streams x {ROW5_STREAM_STEPS} tokens "
              f"at once in {wall:.3f} s, {n_tok / wall:.2f} tokens/s "
              f"together; per-token p50 {np.percentile(lat_ms, 50):.3f} ms, "
              f"p99 {np.percentile(lat_ms, 99):.3f} ms; {n_exec} llama_tpu "
              f"executions, avg batch "
              f"{(st.batch_size_total - rows0) / max(batches, 1):.2f}; "
              f"{CARD}", flush=True)
    del llama, run


def grpc_phase(torch, counters) -> None:
    """gRPC on the card: ``bert_large`` int8 (``w2``: 24 int8 launches per
    forward) at request batch 32 and ``longctx_tpu`` base bf16 (8 flash
    launches per forward) at batch 4 by each gRPC transport beside HTTP
    (``grpc_transports``); then ``perf_analyzer -i grpc --streaming`` from a
    process of its own (BASELINE row 4): ``bert_large`` int8 -b 32 at c = 1
    and 4 with CUDA shm and by wire (c = 4 traced once more), unary -b 32
    at c = 1, ``longctx_tpu`` -b 4 on a stream at c = 1, each level beside
    this run's HTTP level; then BASELINE row 5 (``grpc_generate``)."""
    from triton_client_tpu_torch.models import language

    os.environ["TRITON_TPU_QUANT_BERT_LARGE"] = "int8"
    os.environ["TRITON_TPU_INT8_FUSED"] = "w2"
    try:
        bert = language.make_bert_large("cuda")
        longctx = language.make_longctx_tpu("cuda")
        with serving_harness([bert, longctx]) as harness:
            _warm(harness, bert, BERT_SHM_ROWS)
            _warm(harness, longctx, longctx.max_batch_size)
            check_precision("grpc bert_large int8", bert.transformer, True)
            check_precision("grpc longctx_tpu bf16", longctx.transformer,
                            False)
            layers = bert.transformer.cfg.n_layers
            S, V = language.BERT_SEQ_LEN, language.BERT_LARGE.vocab_size
            x = model_tokens(BERT_SEED, BERT_SHM_ROWS, S, V)
            grpc_transports(
                "grpc bert_large int8", harness, bert, counters, x,
                BERT_SEED, V, bert_check("grpc bert_large int8", torch, bert,
                                         True, x),
                SERVED_ATOL["bert_large", True], 0, layers,
                cross_process=True)
            S = longctx.config.input[0].dims[0]
            x = model_tokens(LONGCTX_SEED, longctx.max_batch_size, S, 256)
            grpc_transports(
                "grpc longctx_tpu bf16", harness, longctx, counters, x,
                LONGCTX_SEED, 256, longctx_check("grpc longctx_tpu bf16",
                                                 torch, longctx, x),
                SERVED_ATOL["longctx_tpu", False],
                longctx.transformer.cfg.n_layers, 0, cross_process=False)
            for shm in ("cuda", "none"):
                label = f"perf grpc stream bert_large int8 -b 32 {shm}"
                perf_sweep(label, harness, bert,
                           ["-i", "grpc", "--streaming", "-b", "32",
                            "--concurrency-range", "1:4:3",
                            "--shared-memory", shm], counters, 0, layers,
                           window_ms=PERF_LONG_WINDOW_MS, paths=GRPC_PATHS)
                _beside_http(label, f"perf bert_large int8 -b 32 {shm}")
            # where the device's time goes under four streams, beside the
            # perf phase's traced HTTP run at c = 4
            perf_sweep("perf grpc stream bert_large int8 -b 32 none c=4 "
                       "traced", harness, bert,
                       ["-i", "grpc", "--streaming", "-b", "32",
                        "--concurrency-range", "4"], counters, 0, layers,
                       window_ms=PERF_LONG_WINDOW_MS, trace=True,
                       paths=GRPC_PATHS)
            label = "perf grpc unary bert_large int8 -b 32 none"
            perf_sweep(label, harness, bert,
                       ["-i", "grpc", "-b", "32", "--concurrency-range", "1"],
                       counters, 0, layers, window_ms=PERF_LONG_WINDOW_MS,
                       paths=GRPC_PATHS)
            _beside_http(label, "perf bert_large int8 -b 32 none")
            label = "perf grpc stream longctx_tpu bf16 -b 4 none"
            perf_sweep(label, harness, longctx,
                       ["-i", "grpc", "--streaming", "-b", "4",
                        "--concurrency-range", "1"], counters,
                       longctx.transformer.cfg.n_layers, 0, paths=GRPC_PATHS)
            _beside_http(label, "perf longctx_tpu bf16 -b 4 none")
            _no_regions_left("grpc bert_large int8, longctx_tpu bf16",
                             harness)
    finally:
        for var in ("TRITON_TPU_QUANT_BERT_LARGE", "TRITON_TPU_INT8_FUSED"):
            os.environ.pop(var, None)
    del bert, longctx
    gc.collect()
    torch.cuda.empty_cache()
    grpc_generate(torch, counters)
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Vision: resnet50 (BASELINE row 2) as image_client.py drives it, over gRPC
# ---------------------------------------------------------------------------

VISION_ROWS, VISION_CLASSES, VISION_SEED = 32, 3, 2
# resnet50 served in bf16 (channels_last) against an f32 forward of the
# same weights on the card: max |OUTPUT - f32| at most this share of the
# f32 logits' RMS.  The CPU parity test holds bf16 against the reference's
# f32 to the same share (tests/test_torch_vision.py, where it read 2.3e-2);
# the logits reach ~1e3 (random He weights, no normalisation), so the
# bound is relative.  Its controls: the f32 forward with the last block's
# c3 scale (``s3b2_s3``) off by each of CONTROL_SCALES.
VISION_OF_RMS = 6e-2
#: "<path>" -> the kernel launches of each vision window (none expected:
#: resnet50 runs cuDNN convolutions, no kernel of the port)
VISION_PATHS = {}


def parse_image_model(metadata: dict, config: dict):
    """image_client.py's ``parse_model`` on the gRPC JSON forms: (input,
    output, c, h, w, layout, datatype, max batch) of a one-input,
    one-output image model."""
    if len(metadata["inputs"]) != 1 or len(metadata["outputs"]) != 1:
        fail(f"resnet50 metadata: expected 1 input and 1 output: {metadata}")
    inp, out = metadata["inputs"][0], metadata["outputs"][0]
    config = config.get("config", config)
    max_batch = int(config.get("max_batch_size", 0))
    shape = [int(d) for d in inp["shape"]]
    if max_batch > 0:
        shape = shape[1:]
    if len(shape) != 3 or shape[0] not in (1, 3):
        fail(f"resnet50 metadata: not a CHW image input: {shape}")
    c, h, w = shape
    return inp["name"], out["name"], c, h, w, "CHW", inp["datatype"], \
        max_batch


def synthetic_images(seed: int, n: int, c: int, h: int, w: int):
    """``n`` seeded uint8 RGB images (the card's machine has no PIL),
    INCEPTION-scaled to [-1, 1] and laid out CHW, as image_client.py's
    ``preprocess`` does."""
    import numpy as np

    img = np.random.default_rng(seed).integers(0, 256, (n, h, w, c),
                                               dtype=np.uint8)
    arr = img.astype(np.float32) / 127.5 - 1.0
    return np.ascontiguousarray(arr.transpose(0, 3, 1, 2))


def _classify_requests(client, name, out_name, datatype, x):
    """image_client.py's three ways of asking for OUTPUT: raw
    (``async_infer``, a future), the top VISION_CLASSES (``async_infer``
    with a callback) and the same on a stream.  Returns (raw logits,
    async strings, stream strings)."""
    import queue

    from triton_client_tpu_torch import grpc

    inp = grpc.InferInput(name, list(x.shape), datatype)
    inp.set_data_from_numpy(x)
    raw = client.async_infer(
        "resnet50", [inp], outputs=[grpc.InferRequestedOutput(out_name)]
    ).get_result(timeout=300).as_numpy(out_name)
    classes = [grpc.InferRequestedOutput(out_name,
                                         class_count=VISION_CLASSES)]
    done = queue.Queue()

    def callback(result, error):
        done.put((result, error))

    client.async_infer("resnet50", [inp], callback=callback,
                       outputs=classes)
    answers = [done.get(timeout=300)]
    client.start_stream(callback=callback)
    try:
        client.async_stream_infer("resnet50", [inp], outputs=classes)
        answers.append(done.get(timeout=300))
    finally:
        client.stop_stream()
    strings = []
    for result, error in answers:
        if error is not None:
            fail(f"vision resnet50: {error}")
        strings.append(result.as_numpy(out_name))
    return raw, strings[0], strings[1]


def vision_phase(torch, counters) -> None:
    """BASELINE row 2: ``resnet50`` at full width (224 x 224, 25.6 M
    parameters, bf16 and channels_last on the card) through the port's
    server, driven as image_client.py drives it: metadata and config
    parsed, VISION_ROWS seeded INCEPTION-scaled images in one request,
    ``async_infer`` raw and with ``class_count`` VISION_CLASSES, and a
    stream.  The raw OUTPUT held to an f32 forward of the same weights on
    the card (VISION_OF_RMS, beside the controls), each classification
    string equal to ``_classify`` of the served logits; the B = 32 forward
    timed, traced and counted in FLOPs; then ``perf_analyzer -m resnet50 -i
    grpc`` from a process of its own: -b 32 at c = 1 by wire, stream and
    CUDA shm, -b 1 at c = 1 and 8 through the dynamic batcher."""
    import numpy as np

    from triton_client_tpu_torch import grpc
    from triton_client_tpu_torch.models import vision
    from triton_client_tpu_torch.server.core import InferenceCore

    label = "vision resnet50 bf16"
    model = vision.make_resnet50("cuda")
    with serving_harness([model]) as harness:
        client = grpc.InferenceServerClient(f"127.0.0.1:{harness.http_port}")
        try:
            md = client.get_model_metadata("resnet50", as_json=True)
            cfg = client.get_model_config("resnet50", as_json=True)
            name, out_name, c, h, w, layout, datatype, max_batch = \
                parse_image_model(md, cfg)
            print(f"{label}: parsed {name} {datatype} {layout} "
                  f"[{c}, {h}, {w}] -> {out_name}, max batch {max_batch}",
                  flush=True)
            if (c, h, w, datatype) != (3, vision.IMAGE_SIZE,
                                       vision.IMAGE_SIZE, "FP32") \
                    or max_batch < VISION_ROWS:
                fail(f"{label}: unexpected model metadata {md} / {cfg}")
            x = synthetic_images(VISION_SEED, VISION_ROWS, c, h, w)
            # the first request draws the weights
            _classify_requests(client, name, out_name, datatype, x[:1])
            if model.resnet.params["stem"].dtype != torch.bfloat16:
                fail(f"{label}: served weights are not bf16")
            (raw, cls_async, cls_stream), n_exec, launches = _counted(
                f"{label} grpc async + stream", model, counters,
                lambda: _classify_requests(client, name, out_name, datatype,
                                           x), 0, 0, paths=VISION_PATHS)
        finally:
            client.close()
        if n_exec != 3 or raw.shape != (VISION_ROWS, vision.NUM_CLASSES) \
                or not np.isfinite(raw).all():
            fail(f"{label}: {n_exec} executions for 3 requests, OUTPUT "
                 f"{raw.shape}, finite {np.isfinite(raw).all()}")
        params = {k: v.float() for k, v in model.resnet.params.items()}
        xt = torch.from_numpy(x).cuda()
        with torch.inference_mode():
            ref = vision.forward(params, xt).cpu().numpy()
            controls = [float(np.abs(vision.forward(
                {**params, "s3b2_s3": params["s3b2_s3"] * scale}, xt)
                .cpu().numpy() - ref).max()) for scale in CONTROL_SCALES]
        rms = float(np.sqrt((ref ** 2).mean()))
        bound = VISION_OF_RMS * rms
        worst = float(np.abs(raw - ref).max())
        caught = [s for s, e in zip(CONTROL_SCALES, controls) if e > bound]
        print(f"{label}: OUTPUT [{VISION_ROWS}, {vision.NUM_CLASSES}] vs "
              f"the f32 forward of the same weights: max_abs_err "
              f"{worst:.3e} ({worst / rms:.3e} of the f32 logits' RMS "
              f"{rms:.3e}; bound {VISION_OF_RMS} of it), mean_abs_err "
              f"{float(np.abs(raw - ref).mean()):.3e}; controls (last "
              "block's c3 scale x" + ", x".join(
                  f"{s}: {e:.3e}" for s, e in zip(CONTROL_SCALES, controls))
              + f"), caught from x{caught[0] if caught else None}; top-1 "
              f"equal on {int((raw.argmax(1) == ref.argmax(1)).sum())} of "
              f"{VISION_ROWS} images", flush=True)
        if not worst <= bound:
            fail(f"{label}: served OUTPUT disagrees with the f32 forward")
        if not controls[-1] > bound:
            fail(f"{label}: the control x{CONTROL_SCALES[-1]} reads "
                 f"{controls[-1]:.3e}, within the bound {bound:.3e}")
        want = InferenceCore._classify(model, out_name, raw, VISION_CLASSES)
        for how, got in (("async_infer", cls_async), ("stream", cls_stream)):
            if got.shape != want.shape or got.tolist() != want.tolist():
                fail(f"{label}: {how} classification {got[:2]} is not "
                     f"_classify of the served logits {want[:2]}")
        print(f"{label}: classification (class_count {VISION_CLASSES}) by "
              f"async_infer and on a stream equal _classify of the served "
              f"logits, {want.shape}; image 0: "
              f"{[s.decode() for s in want[0]]}", flush=True)
        fwd_ms = profile_run(label, lambda: model.resnet(xt), torch,
                             f"forward B={VISION_ROWS}")
        flops = vision.forward_flops() * VISION_ROWS
        print(f"{label}: forward B={VISION_ROWS}: {flops / 1e9:.1f} GFLOP "
              f"({vision.forward_flops() / 1e9:.2f} per image), "
              f"{flops / fwd_ms / 1e9:.1f} TFLOP/s, "
              f"{flops / fwd_ms / 1e9 / (PEAK_BF16_FLOPS / 1e12):.1%} of the "
              f"bf16 peak (bound {flops / PEAK_BF16_FLOPS * 1e3:.3f} ms, "
              f"operations); {CARD}", flush=True)
        del xt, params
        for args in (["--shared-memory", "none"], ["--streaming"],
                     ["--shared-memory", "cuda"]):
            perf_sweep(f"perf resnet50 -b 32 grpc {' '.join(args)}", harness,
                       model, ["-i", "grpc", "-b", "32",
                               "--concurrency-range", "1", *args],
                       counters, 0, 0, paths=VISION_PATHS)
        perf_sweep("perf resnet50 -b 1 grpc dynamic batching", harness,
                   model, ["-i", "grpc", "-b", "1", "--concurrency-range",
                           "1:8:7"], counters, 0, 0, paths=VISION_PATHS)
        _no_regions_left("perf resnet50", harness)
    del model
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Observability: tracing, device statistics, costs, the flight recorder and
# /metrics on the served models
# ---------------------------------------------------------------------------

#: "<path>" -> the kernel launches of that observability run
OBS_PATHS = {}
#: where the observed server writes its trace files (inside the checkout)
OBS_DIR = os.path.join(REPO, "build", "chip_smoke_obs")
# each traced COMPUTE span within this share of the CUDA-event forward;
# live MFU within it of counted FLOPs / forward time / peak; the served
# requests with observability on at most this much slower than off
OBS_TOL = 0.10
# counted FLOPs of a signature, kernel path against plain path
OBS_FLOPS_TOL = 1e-3
# the requests one PROFILE window is held open for
OBS_PROFILE_REQUESTS = 2

_PROM_SAMPLE = None


def parse_prometheus(text: str) -> dict:
    """{family: {"type", "samples": [(labels, value)]}} of a /metrics
    body; fails the run on a line that is not the text exposition
    format."""
    import re

    global _PROM_SAMPLE
    if _PROM_SAMPLE is None:
        _PROM_SAMPLE = (re.compile(
            r'([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{((?:[a-zA-Z_][a-zA-Z0-9_]*='
            r'"(?:[^"\\]|\\.)*",?)*)\})? (\S+)'),
            re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"'))
    sample, label = _PROM_SAMPLE
    families, current = {}, None
    for line in text.splitlines():
        if line.startswith("# HELP "):
            current = line[7:].partition(" ")[0]
            families[current] = {"type": None, "samples": []}
        elif line.startswith("# TYPE "):
            name, _, kind = line[7:].partition(" ")
            if name != current or kind not in ("counter", "gauge"):
                fail(f"/metrics: bad TYPE line {line!r}")
            families[name]["type"] = kind
        elif line:
            m = sample.fullmatch(line)
            if m is None or m.group(1) != current:
                fail(f"/metrics: not a sample of its family: {line!r}")
            try:
                value = float(m.group(3))
            except ValueError:
                fail(f"/metrics: not a number: {line!r}")
            families[current]["samples"].append(
                (dict(label.findall(m.group(2) or "")), value))
    return families


def _obs_set(core, on: bool) -> None:
    """Device statistics and the flight recorder on or off (tracing is
    set by perf_analyzer's --trace-file)."""
    core.device_stats.enabled = on
    core.flight_recorder.configure(enabled=on)


def _obs_request(port: int, model, rows: int, seed: int):
    """One request of ``rows`` seeded rows to ``model``: its output."""
    import numpy as np

    cfg = model.config.input[0]
    vocab = model.transformer.cfg.vocab_size
    x = np.random.default_rng(seed).integers(
        0, vocab, [rows] + list(cfg.dims)).astype(np.int32)
    client = _client(port)
    try:
        out, _ = _post_infer(client, model.name, [(cfg.name, cfg.data_type,
                                                   x)],
                             [model.config.output[0].name])
    finally:
        client.close()
    return x, out[model.config.output[0].name]


def _obs_forward_ms(torch, model, x, runs: int = 7) -> float:
    """The CUDA-event time of one served execution (``model.execute``:
    the tokens' copy to the card, the forward and the outputs) at
    ``x``'s batch, each started on an idle card as the server starts one
    at c = 1: the median of ``runs``."""
    import statistics

    inputs = {model.config.input[0].name: x}
    model.execute(inputs, {})
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        model.execute(inputs, {})
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _obs_plain_flops(torch, model, x, head_cols=None):
    """Counted FLOPs and bytes of the same function as the served one,
    with the kernels' plain versions in their place."""
    from triton_client_tpu_torch.models import language, transformer
    from triton_client_tpu_torch.server.costs import analyze_torch_callable

    run = model.transformer
    fwd = transformer.make_forward(run.cfg, quantized="wq_scale" in run.params,
                                   head_cols=head_cols, plain=True)

    def plain(tokens):
        tokens = torch.clamp(tokens, 0, run.cfg.vocab_size - 1)
        logits = fwd(run.params, tokens)
        if model.name == "longctx_tpu":
            return language.longctx_scores(logits, tokens)
        return logits

    with torch.inference_mode():
        tokens = torch.from_numpy(x).cuda()
        _, cost = analyze_torch_callable(plain, tokens, device="cuda")
    return cost


def _obs_check_traces(label: str, path: str, fwd_ms: float,
                      batched: bool):
    """Every traced request has a REQUEST root with QUEUE, COMPUTE and
    D2H_TRANSFER children (and BATCH_ASSEMBLY where batched); each COMPUTE
    within OBS_TOL of the CUDA-event forward.  Returns the COMPUTE ms, or
    None where a COMPUTE is not within it."""
    records = []
    with open(path) as f:
        for line in f:
            if line.strip():
                records.append(json.loads(line))
    if not records:
        fail(f"{label}: no traced request in {path}")
    computes = []
    for rec in records:
        names = [(s["name"], s["parent"]) for s in rec["spans"]]
        want = [("REQUEST", None)] + [(n, "REQUEST") for n in (
            "DECODE", "QUEUE", *(("BATCH_ASSEMBLY",) if batched else ()),
            "COMPUTE", "D2H_TRANSFER", "SERIALIZE", "NETWORK_WRITE")]
        if names != want:
            fail(f"{label}: a traced request's spans are {names}, "
                 f"expected {want}")
        span = next(s for s in rec["spans"] if s["name"] == "COMPUTE")
        computes.append((span["end_ns"] - span["start_ns"]) / 1e6)
    offs = [abs(c - fwd_ms) / fwd_ms for c in computes]
    worst = max(offs)
    ranked = sorted(computes)
    print(f"{label}: {len(records)} traced requests, each a REQUEST root "
          f"with {' '.join(n for n, _ in want[1:])}; COMPUTE "
          f"{ranked[0]:.3f}-{ranked[-1]:.3f} ms (median "
          f"{ranked[len(ranked) // 2]:.3f}, p90 "
          f"{ranked[int(0.9 * (len(ranked) - 1))]:.3f}) against the "
          f"CUDA-event forward {fwd_ms:.3f} ms (worst {worst:.1%}, the "
          f"{offs.index(worst) + 1}th traced request; bound {OBS_TOL:.0%});"
          f" {CARD}", flush=True)
    if not worst <= OBS_TOL:
        print(f"{label}: a traced COMPUTE is {worst:.1%} off the forward",
              flush=True)
        return None
    return computes


def _obs_traced_sweep(label: str, harness, model, counters, rows: int,
                      flash: int, int8: int, fwd_ms: float):
    """One traced :func:`_obs_sweep` whose spans :func:`_obs_check_traces`
    holds, run once more where a COMPUTE misses (HOST_GATE_RUNS): the
    sweep's result."""
    for run in range(1, HOST_GATE_RUNS + 1):
        res, path = _obs_sweep(label, harness, model, counters, rows, flash,
                               int8, True, PERF_WINDOW_MS)
        if _obs_check_traces(label, path, fwd_ms, batched=True) is not None:
            return res
    fail(f"{label}: a traced COMPUTE is more than {OBS_TOL:.0%} off the "
         f"forward in {HOST_GATE_RUNS} runs")


def _obs_device_numbers(label: str, harness, model, counted,
                        plain, fwd_ms: float) -> None:
    """The server's own numbers for ``model``: live MFU (in (0, 1.05] and
    within OBS_TOL of counted FLOPs / forward / peak), duty cycle, device
    memory in use (at least the served parameters' bytes), the roofline
    verdict of each signature, /metrics parsed; the kernel path's counted
    FLOPs equal to the plain path's within OBS_FLOPS_TOL."""
    import urllib.request

    from triton_client_tpu_torch.server.costs import classify_roofline

    client = _client(harness.http_port)
    try:
        snap = client.get_device_stats(model.name)
        costs = client.get_costs(model.name)
    finally:
        client.close()
    text = urllib.request.urlopen(
        f"http://{harness.http_url}/metrics", timeout=60).read().decode()
    families = parse_prometheus(text)
    entry = snap["models"][model.name]
    mfu = next((v for lab, v in families["nv_tpu_live_mfu"]["samples"]
                if lab.get("model") == model.name), None)
    used = [v for _, v in families.get(
        "nv_tpu_memory_used_bytes", {"samples": []})["samples"]]
    params_bytes = sum(t.numel() * t.element_size()
                       for t in model.transformer.params.values())
    rel = abs(counted.flops - plain.flops) / plain.flops
    print(f"{label}: counted FLOPs of the served signature "
          f"{counted.flops:.6e} (bytes accessed {counted.bytes_accessed:.4e},"
          f" temp {counted.temp_bytes / 1e9:.3f} GB), plain path "
          f"{plain.flops:.6e}: off by {rel:.2e} (bound {OBS_FLOPS_TOL})",
          flush=True)
    if not rel <= OBS_FLOPS_TOL:
        fail(f"{label}: the kernel path counts other FLOPs than the plain "
             "path")
    want_mfu = counted.flops / (fwd_ms / 1e3) / PEAK_BF16_FLOPS
    print(f"{label}: live MFU {mfu} (counted FLOPs / CUDA-event forward / "
          f"bf16 peak: {want_mfu:.4f}), duty cycle {entry['duty_cycle']}, "
          f"device memory in use {used} bytes (served parameters "
          f"{params_bytes} bytes), limit "
          f"{snap['hbm'].get('cuda:0', {}).get('bytes_limit')}; {CARD}",
          flush=True)
    if mfu is None or not 0 < mfu <= 1.05 or \
            not abs(mfu - want_mfu) <= OBS_TOL * want_mfu:
        fail(f"{label}: live MFU {mfu} is not in (0, 1.05] within "
             f"{OBS_TOL:.0%} of {want_mfu:.4f}")
    if not used or min(used) < params_bytes:
        fail(f"{label}: nv_tpu_memory_used_bytes {used} under the served "
             f"parameters' {params_bytes} bytes")
    for event in entry["compile"]["recent"]:
        roof = classify_roofline(event.get("flops", 0.0),
                                 event.get("bytes_accessed", 0.0))
        print(f"{label}: signature {event['signature']}: counted in "
              f"{event['wall_ms']} ms, {event.get('flops', 0.0):.4e} FLOPs, "
              f"{event.get('bytes_accessed', 0.0):.4e} bytes, roofline "
              f"{roof}; {CARD}", flush=True)
    for bucket, tick in snap["ticks"].get(model.name, {}).items():
        print(f"{label}: bucket {bucket}: {tick['ticks']} ticks, pad waste "
              f"{tick['pad_waste']}, roofline {tick['roofline']}; {CARD}",
              flush=True)
    print(f"{label}: cost ledger {costs['models'].get(model.name)}; "
          f"/metrics: {len(families)} families parsed", flush=True)


def _obs_profile(label: str, harness, torch, model, rows: int) -> None:
    """A PROFILE window over OBS_PROFILE_REQUESTS requests: its exported
    Chrome trace must name the flash and int8 kernels' __global__
    functions."""
    import glob

    base = os.path.join(OBS_DIR, "profile.json")
    client = _client(harness.http_port)
    try:
        client.update_trace_settings(settings={
            "trace_file": [base], "trace_level": ["PROFILE"]})
        try:
            for i in range(OBS_PROFILE_REQUESTS):
                _obs_request(harness.http_port, model, rows, 40 + i)
        finally:
            client.update_trace_settings(settings={"trace_level": ["OFF"]})
    finally:
        client.close()
    names = set()
    for path in glob.glob(os.path.join(base + ".profile", "*.json")):
        with open(path) as f:
            for ev in json.load(f).get("traceEvents", []):
                if ev.get("cat") == "kernel":
                    names.add(ev.get("name", ""))
    found = {k: sorted(n for n in names if k in n)
             for k in ("flash_fwd", "quantize_rows", "int8_gemm")}
    print(f"{label}: PROFILE window: {len(names)} kernel names; "
          + "; ".join(f"{k}: {v}" for k, v in found.items()), flush=True)
    if not all(found.values()):
        fail(f"{label}: the PROFILE trace does not name every kernel: "
             f"{found}")


def _obs_served_equal(label: str, harness, model, rows: int, atol):
    """The same tokens served with observability off, then on: equal (bit
    for bit where ``atol`` is 0).  Leaves observability on."""
    import numpy as np

    core = harness.core
    _obs_set(core, False)
    x, off = _obs_request(harness.http_port, model, rows, 31)
    _obs_set(core, True)
    _, on = _obs_request(harness.http_port, model, rows, 31)
    err = float(np.abs(on.astype(np.float64) - off).max())
    print(f"{label}: served answer with observability on against off: "
          f"max_abs_err {err:.3e} (bound {atol})", flush=True)
    if not err <= atol:
        fail(f"{label}: observability changed the served answer")
    return x


def _obs_sweep(label: str, harness, model, counters, rows: int, flash: int,
               int8: int, on: bool, window_ms: int):
    """One perf_analyzer run at c = 1 with observability ``on`` (device
    statistics, the flight recorder, and --trace-file at rate 1) or off."""
    core = harness.core
    _obs_set(core, on)
    args = ["-b", str(rows), "--concurrency-range", "1"]
    path = None
    if on:
        path = os.path.join(OBS_DIR, f"{model.name}-{len(OBS_PATHS)}.json")
        args += ["--trace-file", path, "--trace-rate", "1"]
    (res,) = perf_sweep(f"{label} observability {'on' if on else 'off'} "
                        f"(run {len(OBS_PATHS) + 1})", harness, model, args,
                        counters, flash, int8, window_ms=window_ms,
                        paths=OBS_PATHS)
    return res, path


def observability_phase(torch, counters) -> None:
    """Tracing, device statistics, costs, the flight recorder and /metrics
    on the card: ``longctx_tpu`` base at B = 4 under int8 ``all`` (8 flash
    and 16 int8 launches per forward) and ``bert_large`` int8 ``w2`` at
    -b 32 (24 int8 launches), each served with observability on and
    driven by ``perf_analyzer --trace-file`` at c = 1 from a process of
    its own.  Every traced request's span tree and COMPUTE length, the
    kernels' launches per forward (as with observability off), the served
    answers (equal with it on and off), the counted FLOPs (kernel path
    against plain path), live MFU, device memory in use and /metrics are
    checked; a PROFILE window must name the kernels; no region is left.
    ``bert_large`` -b 32 runs off, then on: on may be at most OBS_TOL
    slower."""
    from triton_client_tpu_torch.models import language

    os.makedirs(OBS_DIR, exist_ok=True)
    layers = language.longctx_cfg("cuda").n_layers
    # the earlier phases' long-lived objects out of the collector's scans:
    # a full collection in the middle of a served forward stalls the
    # launches and shows as a longer COMPUTE
    gc.collect()
    gc.freeze()
    for var, val in (("TRITON_TPU_QUANT_LONGCTX_TPU", "int8"),
                     ("TRITON_TPU_QUANT_BERT_LARGE", "int8"),
                     ("TRITON_TPU_INT8_FUSED", "all")):
        os.environ[var] = val
    try:
        label = "obs longctx_tpu int8 all"
        model = language.make_longctx_tpu("cuda")
        with serving_harness([model]) as harness:
            _warm(harness, model, 4)  # the signature's counted execution
            check_precision(label, model.transformer, True)
            x = _obs_served_equal(label, harness, model, 4,
                                  SERVED_ATOL[("longctx_tpu", True)])
            fwd_ms = _obs_forward_ms(torch, model, x)
            _obs_traced_sweep(label, harness, model, counters, 4, layers,
                              2 * layers, fwd_ms)
            counted = harness.core.device_stats.signature_cost(
                model.name, _signature_of(harness, model, x))
            _obs_device_numbers(label, harness, model, counted,
                                _obs_plain_flops(torch, model, x), fwd_ms)
            _obs_profile(label, harness, torch, model, 4)
            _no_regions_left(label, harness)
        del model
        gc.collect()
        torch.cuda.empty_cache()

        os.environ["TRITON_TPU_INT8_FUSED"] = "w2"
        label = "obs bert_large int8 w2 -b 32"
        layers = language.BERT_LARGE.n_layers
        model = language.make_bert_large("cuda")
        with serving_harness([model]) as harness:
            _warm(harness, model, 32)
            check_precision(label, model.transformer, True)
            x = _obs_served_equal(label, harness, model, 32, 0.0)
            fwd_ms = _obs_forward_ms(torch, model, x)
            for run in range(1, HOST_GATE_RUNS + 1):
                off, _ = _obs_sweep(label, harness, model, counters, 32, 0,
                                    layers, False, PERF_WINDOW_MS)
                on = _obs_traced_sweep(label, harness, model, counters, 32,
                                       0, layers, fwd_ms)
                slower = on["avg_us"] / off["avg_us"] - 1
                print(f"{label}: observability off: "
                      f"{off['throughput']:.3f} infer/s, mean "
                      f"{off['avg_us'] / 1e3:.3f} ms; on: "
                      f"{on['throughput']:.3f} infer/s, mean "
                      f"{on['avg_us'] / 1e3:.3f} ms ({slower:+.1%}, bound "
                      f"+{OBS_TOL:.0%}); {CARD}", flush=True)
                if slower <= OBS_TOL:
                    break
                if run == HOST_GATE_RUNS:
                    fail(f"{label}: observability on is {slower:.1%} slower "
                         f"in {run} runs")
            counted = harness.core.device_stats.signature_cost(
                model.name, _signature_of(harness, model, x))
            _obs_device_numbers(
                label, harness, model, counted,
                _obs_plain_flops(torch, model, x,
                                 head_cols=language.BERT_HEAD_COLS), fwd_ms)
            _no_regions_left(label, harness)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        gc.unfreeze()
        for var in ("TRITON_TPU_QUANT_LONGCTX_TPU",
                    "TRITON_TPU_QUANT_BERT_LARGE", "TRITON_TPU_INT8_FUSED"):
            os.environ.pop(var, None)


# ---------------------------------------------------------------------------
# Overload: QoS tiers, the memory governor, deadlines, chaos and drain
# ---------------------------------------------------------------------------

#: "<path>" -> the kernel launches of that overload run
OVERLOAD_PATHS = {}
OVERLOAD_WINDOW_MS = 6000
OVERLOAD_SHORT_MS = 2000
# the tiers' run: a model's bound on pending requests, and its classes
OVERLOAD_QUEUE = 16
OVERLOAD_CLASSES = ["--priority", "0", "--tenant", "gold",
                    "--priority", "3", "--tenant", "bulk"]
# the memory budget, in one -b 4 longctx_tpu request's wire and response
# bytes, and the mem_pressure drill's, in one -b 1 bert_large request's
OVERLOAD_BUDGET_X = 1.5
PRESSURE_BUDGET_X = 2.0
# chaos of the retries run: every retry lands inside the injector's
# healthy window (the first backoff is at most 50 ms), so with 3 attempts
# no caller sees an injected fault
CHAOS_ARGS = dict(rate=0.2, kinds_csv="error,latency,abort", seed=7,
                  transient_s=0.2)
# the mem_pressure drill: windows of 0.3 s that halve the budget, at most
# one every 1.5 s, so a shed request's third attempt (two pushbacks of at
# least 0.25 s later) lands after its window
PRESSURE_ARGS = dict(rate=0.3, kinds_csv="mem_pressure", seed=7,
                     transient_s=1.5, pressure_s=0.3, pressure_factor=0.5)
DRAIN_TIMEOUT_S = 20.0
DRAIN_LATENCY_MS = 400


def _metrics(port: int) -> dict:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=60) as r:
        return parse_prometheus(r.read().decode())


def _metric_sum(families: dict, name: str, **labels) -> float:
    """The sum of a family's samples whose labels include ``labels``."""
    return sum(v for lab, v in families.get(name, {}).get("samples", [])
               if all(lab.get(k) == str(x) for k, x in labels.items()))


def _overload_run(label, harness, model, args, counters, flash, int8,
                  window_ms, trace=False, sheds=True, retried_sheds=False):
    """One perf_analyzer run of the overload phase: its one level's result
    and the server's counters around it.  Holds: the tool exited 0; every
    error is a shed (none where not ``sheds``); every shed carried its
    pushback; the server's nv_inference_rejected_total moved by the sheds
    the tool counted (where ``retried_sheds``, every retry was a shed's:
    by those plus its retries); launches exactly per execution."""
    port = harness.http_port
    before = _metrics(port)
    results, launches, executions, _ = _perf_analyzer(
        label, harness, model, args, counters, window_ms, trace)
    after = _metrics(port)
    res = results[0]
    check_launches(label, launches, len(executions), flash, int8)
    OVERLOAD_PATHS[label] = launches
    server = (_metric_sum(after, "nv_inference_rejected_total",
                          model=model.name)
              - _metric_sum(before, "nv_inference_rejected_total",
                            model=model.name))
    print(f"{label}: {res['throughput']:.3f} infer/s, p50 "
          f"{res['p50_us'] / 1e3:.3f} ms, p99 {res['p99_us'] / 1e3:.3f} ms; "
          f"{len(executions)} executions; sheds {res['rejected_run']} "
          f"({res['pushback_run']} with pushback), server "
          f"nv_inference_rejected_total +{server:g}; retries "
          f"{res['retries_run']}; errors in the window {res['errors']}; "
          f"{CARD}", flush=True)
    for cls in res.get("classes", []):
        print(f"{label} priority {cls['priority']} tenant {cls['tenant']} "
              f"({cls['workers']} workers): {cls['throughput']:.3f} infer/s, "
              f"p50 {cls['p50_us'] / 1e3:.3f} ms, p99 "
              f"{cls['p99_us'] / 1e3:.3f} ms, sheds {cls['rejected_run']} "
              f"({cls['pushback_run']} with pushback); {CARD}", flush=True)
    if res["errors"] != res["rejected"] or (res["errors"] and not sheds):
        fail(f"{label}: {res['errors']} errors, {res['rejected']} of them "
             f"sheds; first {res['first_error']}")
    if res["pushback_run"] != res["rejected_run"]:
        fail(f"{label}: {res['rejected_run'] - res['pushback_run']} sheds "
             "came without pushback")
    client_sheds = res["rejected_run"] + (res["retries_run"]
                                          if retried_sheds else 0)
    if server != client_sheds:
        fail(f"{label}: the server counted {server:g} sheds, the client "
             f"{client_sheds}")
    return res


# a best-effort flood that ignores the server's pushback: this many
# threads of a process of their own, each sending its next request as soon
# as the last was refused, for this long (8 of them fill the best-effort
# tier's bound of 8; the others are shed, again and again)
FLOOD_THREADS, FLOOD_S = 24, 3.0
_FLOOD = """
import json, sys, threading, time
import numpy as np
from triton_client_tpu_torch import http
from triton_client_tpu_torch.utils import InferenceServerException
url, n, secs = sys.argv[1], int(sys.argv[2]), float(sys.argv[3])
counts = {"ok": 0, "shed": 0, "pushback": 0, "other": []}
lock = threading.Lock()
end = time.monotonic() + secs
def run():
    c = http.InferenceServerClient(url)
    x = http.InferInput("INPUT_IDS", [1, 384], "INT32")
    x.set_data_from_numpy(np.zeros((1, 384), np.int32))
    while time.monotonic() < end:
        try:
            c.infer("bert_large", [x], priority=3, tenant="flood")
            key, pb = "ok", False
        except InferenceServerException as e:
            key = "shed" if e.status() == "429" else None
            pb = e.retry_after_s is not None
            if key is None:
                with lock:
                    counts["other"].append(str(e))
                continue
        with lock:
            counts[key] += 1
            counts["pushback"] += pb
    c.close()
threads = [threading.Thread(target=run) for _ in range(n)]
for t in threads:
    t.start()
for t in threads:
    t.join()
print(json.dumps(counts))
"""


def _impolite_flood(label, harness, model) -> None:
    """Tier 0 from this process, one request after another, while a
    process of its own floods the best-effort lane and ignores the
    pushback: what the sheds' host work leaves the forwards."""
    import numpy as np

    from triton_client_tpu_torch import http

    env = dict(os.environ, PYTHONPATH=REPO)
    qos = harness.core.qos
    shed0 = sum(qos.rejected_counts().values())
    flood = subprocess.Popen(
        [sys.executable, "-c", _FLOOD, harness.http_url,
         str(FLOOD_THREADS), str(FLOOD_S)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    # tier 0 is timed once the flood is shedding, for half its length
    end = time.monotonic() + 120
    while sum(qos.rejected_counts().values()) == shed0:
        if flood.poll() is not None or time.monotonic() > end:
            fail(f"{label}: the flood never reached the server")
        time.sleep(0.01)
    client = _client(harness.http_port)
    x = http.InferInput("INPUT_IDS", [1, model.config.input[0].dims[0]],
                        "INT32")
    x.set_data_from_numpy(np.zeros(x.shape(), np.int32))
    latencies = []
    t_end = time.monotonic() + FLOOD_S / 2
    try:
        while time.monotonic() < t_end or not latencies:
            t0 = time.perf_counter()
            client.infer("bert_large", [x], priority=0, tenant="gold")
            latencies.append(time.perf_counter() - t0)
    finally:
        client.close()
    out, err = flood.communicate(timeout=300)
    if flood.returncode != 0:
        fail(f"{label}: the flood failed: {err[-2000:]}")
    counts = json.loads(out.strip().splitlines()[-1])
    print(f"{label}: a best-effort flood that ignores the pushback "
          f"({FLOOD_THREADS} threads, {FLOOD_S:g} s): {counts['shed']} sheds "
          f"({counts['shed'] / FLOOD_S:.0f}/s, {counts['pushback']} with "
          f"pushback), {counts['ok']} admitted; tier 0 meanwhile, one "
          f"after another: {len(latencies)} requests, latencies "
          f"{[round(v * 1e3, 1) for v in latencies]} ms; {CARD}",
          flush=True)
    if counts["other"] or counts["pushback"] != counts["shed"]:
        fail(f"{label}: the flood saw {counts['other'][:3]} or sheds "
             "without pushback")


def _overload_tiers(label, harness, model, counters) -> None:
    """Two classes at c = 16 against a queue bound of 16, over HTTP
    (traced) and gRPC, each client honouring the server's pushback
    (``--retries 3``); then a flood that ignores it; then one class at
    c = 8.  Tier 0 is never shed (its 8 workers always find a free slot
    or queued best-effort work to take), every shed has its pushback and
    is counted alike on both sides."""
    layers = model.transformer.cfg.n_layers
    core = harness.core
    core.default_max_queue_size = OVERLOAD_QUEUE
    gold_p99 = {}
    for proto in ("http", "grpc"):
        before = _metrics(harness.http_port)
        res = _overload_run(
            f"{label} c=16 two classes {proto}", harness, model,
            ["-b", "1", "--concurrency-range", "16", "-i", proto,
             "--retries", "3", *OVERLOAD_CLASSES], counters, 0, layers,
            OVERLOAD_WINDOW_MS, trace=proto == "http", retried_sheds=True)
        after = _metrics(harness.http_port)
        gold, bulk = res["classes"]
        tier0 = (_metric_sum(after, "nv_inference_rejected_total", tier=0)
                 - _metric_sum(before, "nv_inference_rejected_total",
                               tier=0))
        best_effort = (
            _metric_sum(after, "nv_inference_rejected_total", tier=3)
            - _metric_sum(before, "nv_inference_rejected_total", tier=3))
        print(f"{label} {proto}: the server shed tier 0 {tier0:g} times, "
              f"the best-effort tier {best_effort:g} times", flush=True)
        if tier0 or gold["rejected_run"]:
            fail(f"{label} {proto}: tier 0 was shed")
        if not best_effort:
            fail(f"{label} {proto}: the best-effort class was never shed")
        gold_p99[proto] = gold["p99_us"] / 1e3
    _impolite_flood(f"{label} flood", harness, model)
    res = _overload_run(
        f"{label} c=8 one class", harness, model,
        ["-b", "1", "--concurrency-range", "8", "--priority", "0",
         "--tenant", "gold"], counters, 0, layers, OVERLOAD_SHORT_MS,
        sheds=False)
    print(f"{label}: tier 0's p99 beside the best-effort class "
          f"{gold_p99['http']:.3f} ms (HTTP), {gold_p99['grpc']:.3f} ms "
          f"(gRPC), against {res['p99_us'] / 1e3:.3f} ms alone at c = 8; "
          f"{CARD}", flush=True)
    core.default_max_queue_size = 0


def _overload_chaos(label, torch, harness, model, counters) -> None:
    """perf_analyzer --retries 3 at c = 4 under injected errors, latency
    and aborts: no caller error, the retries equal the injected errors and
    aborts; then answers served under chaos held to the plain forward;
    then the mem_pressure drill."""
    import numpy as np

    from triton_client_tpu_torch._resilience import RetryPolicy
    from triton_client_tpu_torch.models import language
    from triton_client_tpu_torch.server.chaos import build_injector
    from triton_client_tpu_torch.server.memory import MemoryGovernor

    layers = model.transformer.cfg.n_layers
    core = harness.core
    core.chaos = build_injector(**CHAOS_ARGS)
    res = _overload_run(f"{label} chaos --retries 3", harness, model,
                        ["-b", "1", "--concurrency-range", "4",
                         "--retries", "3"], counters, 0, layers,
                        OVERLOAD_SHORT_MS, sheds=False)
    kinds = core.chaos.kind_counters()
    injected = {k: kinds.get((model.name, k), 0)
                for k in ("error", "latency", "abort")}
    total = _metric_sum(_metrics(harness.http_port),
                        "nv_chaos_injected_total", model=model.name)
    print(f"{label}: injected {injected} (nv_chaos_injected_total "
          f"{total:g}); the client retried {res['retries_run']} times, "
          f"errors {res['errors']}; {CARD}", flush=True)
    if total != sum(injected.values()) or \
            res["retries_run"] != injected["error"] + injected["abort"]:
        fail(f"{label}: {res['retries_run']} retries against "
             f"{injected['error'] + injected['abort']} retryable injections")
    # the answers under chaos, through the retry layer
    S, V = language.BERT_SEQ_LEN, language.BERT_LARGE.vocab_size
    x = model_tokens(BERT_SEED, 8, S, V)
    check = bert_check(f"{label} chaos", torch, model, True, x)
    client = _client(harness.http_port)
    from triton_client_tpu_torch import http

    got = []
    try:
        for row in x:
            inp = http.InferInput("INPUT_IDS", [1, S], "INT32")
            inp.set_data_from_numpy(row[None])
            got.append(client.infer(
                "bert_large", [inp], retry_policy=RetryPolicy(
                    max_attempts=3, retry_infer=True)).as_numpy("LOGITS"))
    finally:
        client.close()
    check("8 requests under chaos", np.concatenate(got))
    # the mem_pressure drill: the budget fits c = 4 with room; a window
    # halves it and arrivals shed until it lifts
    core.chaos = None
    core.memory = MemoryGovernor()
    _warm(harness, model, 1)
    one = core.memory.peak_inflight_bytes
    budget = int(PRESSURE_BUDGET_X * one)
    core.memory.budget_bytes = budget
    core.chaos = build_injector(**PRESSURE_ARGS)
    res = _overload_run(f"{label} mem_pressure --retries 3", harness, model,
                        ["-b", "1", "--concurrency-range", "4",
                         "--retries", "3"], counters, 0, layers,
                        OVERLOAD_SHORT_MS, sheds=False, retried_sheds=True)
    mem = core.memory
    time.sleep(PRESSURE_ARGS["pressure_s"])
    snap = mem.snapshot()
    print(f"{label} mem_pressure: one request holds {one} bytes, budget "
          f"{budget}; {snap['pressure_events']} pressure windows, "
          f"{snap['shed_total']} memory sheds, {res['retries_run']} "
          f"retries, errors {res['errors']}; afterwards budget "
          f"{snap['effective_budget_bytes']}, pressure active "
          f"{snap['pressure_active']}, in flight {snap['inflight_bytes']} "
          f"bytes; {CARD}", flush=True)
    if not snap["pressure_events"] or not snap["shed_total"]:
        fail(f"{label} mem_pressure: no pressure window shed anything")
    if snap["effective_budget_bytes"] != budget or snap["pressure_active"] \
            or snap["inflight_bytes"]:
        fail(f"{label} mem_pressure: the governor did not recover")
    core.chaos = None
    core.memory = MemoryGovernor()


def _overload_bytes(label, torch, counters) -> None:
    """longctx_tpu base int8 ``all`` (8 flash and 16 int8 launches per
    forward) with a byte budget of OVERLOAD_BUDGET_X requests: arrivals
    beyond it at c = 4 shed with pushback; a request larger than its
    tier's share gets 413 once, not retried; expired requests get 504 and
    launch nothing, alone and under load; the ledger empties."""
    import numpy as np

    from triton_client_tpu_torch import http
    from triton_client_tpu_torch._resilience import RetryPolicy
    from triton_client_tpu_torch._telemetry import telemetry
    from triton_client_tpu_torch.models import language
    from triton_client_tpu_torch.utils import InferenceServerException

    model = language.make_longctx_tpu("cuda")
    layers = model.transformer.cfg.n_layers
    S = model.config.input[0].dims[0]
    with serving_harness([model]) as harness:
        core, port = harness.core, harness.http_port
        _warm(harness, model, 4)
        check_precision(label, model.transformer, True)
        one = core.memory.peak_inflight_bytes
        budget = int(OVERLOAD_BUDGET_X * one)
        core.memory.budget_bytes = budget
        print(f"{label}: one -b 4 request holds {one} bytes (wire and "
              f"response), budget {budget}", flush=True)
        mem0 = _metric_sum(_metrics(port), "nv_mem_shed_total")
        res = _overload_run(f"{label} c=4 budget", harness, model,
                            ["-b", "4", "--concurrency-range", "4"],
                            counters, layers, 2 * layers, OVERLOAD_SHORT_MS)
        mem = _metric_sum(_metrics(port), "nv_mem_shed_total") - mem0
        if not res["rejected_run"] or mem != res["rejected_run"]:
            fail(f"{label}: {res['rejected_run']} sheds at c = 4, "
                 f"nv_mem_shed_total +{mem:g}")
        # larger than tier 0's whole share: 413, never retried
        client = _client(port)
        big = np.zeros((4 * 4, S), np.int32)
        inp = http.InferInput("TOKENS", list(big.shape), "INT32")
        inp.set_data_from_numpy(big)
        retries0 = sum(r["retries"]
                       for r in telemetry().snapshot()["requests"])
        _reset(counters)
        try:
            client.infer(model.name, [inp], retry_policy=RetryPolicy(
                max_attempts=3, retry_infer=True))
        except InferenceServerException as e:
            status, msg = e.status(), e.message()
        else:
            status, msg = "200", ""
        retries = sum(r["retries"]
                      for r in telemetry().snapshot()["requests"]) - retries0
        print(f"{label}: a request of {big.nbytes} tensor bytes: {status} "
              f"{msg!r}, {retries} retries", flush=True)
        if status != "413" or retries or counters["flash_attention"] \
                .launches:
            fail(f"{label}: the oversize request was not a 413 once")
        # deadlines: expired on arrival, then behind a queue at c = 4
        core.memory.budget_bytes = 0
        x = model_tokens(LONGCTX_SEED, 4, S, 256)
        inp.set_shape(list(x.shape))
        inp.set_data_from_numpy(x)
        d0 = _metric_sum(_metrics(port),
                         "nv_inference_deadline_exceeded_total")
        st = model.stats
        st.executions = []
        _reset(counters)
        expired = 0
        for _ in range(4):
            try:
                client.infer(model.name, [inp], timeout=1)
            except InferenceServerException as e:
                expired += e.status() == "504"
        env = dict(os.environ, PYTHONPATH=REPO)
        load = subprocess.Popen(
            [sys.executable, "-m", "triton_client_tpu_torch.perf_analyzer",
             "-m", model.name, "-u", harness.http_url, "-b", "4",
             "--concurrency-range", "4", "--measurement-interval",
             str(OVERLOAD_SHORT_MS)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        # the probes wait behind the load's four requests
        end = time.monotonic() + 120
        while st.pending_count < 4:
            if load.poll() is not None or time.monotonic() > end:
                fail(f"{label}: the load beside the deadlines never ran")
            time.sleep(0.005)
        statuses = []
        for _ in range(8):
            try:
                client.infer(model.name, [inp], timeout=5000)
                statuses.append("200")
            except InferenceServerException as e:
                statuses.append(e.status())
        out, _ = load.communicate(timeout=300)
        executions, st.executions = st.executions, None
        launches = {name: m.launches for name, m in counters.items()}
        launches["int8_quantize_rows"] = \
            counters["int8_matmul"].quantize_launches
        client.close()
        deadline = _metric_sum(_metrics(port),
                               "nv_inference_deadline_exceeded_total") - d0
        n504 = expired + statuses.count("504")
        print(f"{label}: 4 requests with timeout 1 us: {expired} got 504; "
              f"8 with timeout 5 ms behind c = 4: {statuses}; server "
              f"nv_inference_deadline_exceeded_total +{deadline:g}; "
              f"{len(executions)} executions, launches {launches}",
              flush=True)
        if load.returncode != 0 or " errors)" in out:
            fail(f"{label}: the load beside the deadlines failed: "
                 f"{out[-2000:]}")
        if expired != 4 or "504" not in statuses or \
                set(statuses) - {"200", "504"} or deadline != n504:
            fail(f"{label}: deadlines were not refused with 504")
        check_launches(f"{label} deadlines", launches, len(executions),
                       layers, 2 * layers)
        OVERLOAD_PATHS[f"{label} deadlines"] = launches
        # the ledger empties; the device headroom beside mem_get_info's
        fams = _metrics(port)
        inflight = _metric_sum(fams, "nv_mem_inflight_bytes")
        headroom = _metric_sum(fams, "nv_mem_hbm_headroom_bytes",
                               device="cuda:0")
        free, total = torch.cuda.mem_get_info()
        spare = torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
        print(f"{label}: idle: nv_mem_inflight_bytes {inflight:g} (ledger "
              f"{core.memory.inflight_bytes}); nv_mem_hbm_headroom_bytes "
              f"{headroom:g} against torch.cuda.mem_get_info() free {free} "
              f"of {total} and {spare} reserved-but-unallocated; {CARD}",
              flush=True)
        if inflight or core.memory.inflight_bytes:
            fail(f"{label}: {core.memory.inflight_bytes} bytes left in the "
                 "memory ledger")
        if not 0 < headroom <= total:
            fail(f"{label}: nv_mem_hbm_headroom_bytes {headroom:g} out of "
                 f"(0, {total}]")
        _no_regions_left(label, harness)
    del model


def _overload_drain() -> None:
    """A server process of its own (``python -m
    triton_client_tpu_torch.server``, ``longctx_tpu`` base, every request
    held DRAIN_LATENCY_MS in flight by a chaos latency fault) under four
    clients, sent SIGTERM: the requests in flight answer, new ones get 503
    with Retry-After, and it exits 0 within --drain-timeout."""
    import signal
    import urllib.error
    import urllib.request

    import numpy as np

    from triton_client_tpu_torch.server.testing import free_port

    label = "overload drain"
    port = free_port()
    log_path = os.path.join(REPO, "build", "chip_smoke_drain.log")
    os.makedirs(os.path.dirname(log_path), exist_ok=True)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TRITON_TPU_")}
    env["PYTHONPATH"] = REPO
    log = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "triton_client_tpu_torch.server",
         "--http-port", str(port), "--metrics-port", "0",
         "--drain-timeout", str(DRAIN_TIMEOUT_S), "--chaos", "1.0",
         "--chaos-kinds", "latency", "--chaos-latency-ms",
         str(DRAIN_LATENCY_MS), "--chaos-model", "longctx_tpu"],
        cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
    url = f"http://127.0.0.1:{port}"
    body = b""

    def post():
        req = urllib.request.Request(
            f"{url}/v2/models/longctx_tpu/infer", data=body,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, None
        except urllib.error.HTTPError as e:
            return e.code, e.headers.get("Retry-After")

    try:
        end = time.monotonic() + 180
        while True:
            try:
                with urllib.request.urlopen(f"{url}/v2/health/ready",
                                            timeout=5):
                    break
            except OSError:
                if proc.poll() is not None or time.monotonic() > end:
                    fail(f"{label}: the server did not start")
                time.sleep(0.2)
        with urllib.request.urlopen(f"{url}/v2/models/longctx_tpu/config",
                                    timeout=60) as r:
            S = int(json.load(r)["input"][0]["dims"][0])
        body = json.dumps({"inputs": [{
            "name": "TOKENS", "datatype": "INT32", "shape": [1, S],
            "data": np.zeros(S, np.int32).tolist()}]}).encode()
        if post()[0] != 200:  # builds the weights
            fail(f"{label}: the first request failed")
        records, stop = [], threading.Event()

        def client():
            while not stop.is_set():
                t0 = time.perf_counter()
                try:
                    status, retry_after = post()
                except OSError:
                    return  # the listener closed
                records.append((t0, time.perf_counter(), status,
                                retry_after))
                if status != 200:
                    time.sleep(0.02)

        threads = [threading.Thread(target=client, daemon=True)
                   for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(1.0)
        t_sig = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        try:
            code = proc.wait(timeout=DRAIN_TIMEOUT_S + 30)
        except subprocess.TimeoutExpired:
            fail(f"{label}: the server did not exit after SIGTERM")
        took = time.perf_counter() - t_sig
        stop.set()
        for t in threads:
            t.join(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    in_flight = [r for r in records if r[0] < t_sig < r[1]]
    refused = [r for r in records if r[2] == 503]
    late = [r for r in records if r[0] > t_sig + 0.1]
    print(f"{label}: SIGTERM with {len(in_flight)} requests in flight "
          f"(statuses {sorted({r[2] for r in in_flight})}); {len(refused)} "
          f"refused with 503 (Retry-After "
          f"{sorted({r[3] for r in refused}, key=str)}); the process exited "
          f"{code} {took:.2f} s after the signal (--drain-timeout "
          f"{DRAIN_TIMEOUT_S:g})", flush=True)
    with open(log_path) as f:
        tail = f.read()[-2000:]
    if not in_flight or any(r[2] != 200 for r in in_flight):
        fail(f"{label}: the requests in flight did not all answer: {tail}")
    if not refused or any(not r[3] for r in refused) or \
            any(r[2] != 503 for r in late):
        fail(f"{label}: new requests were not refused with 503 and "
             f"Retry-After: {tail}")
    if code != 0 or took > DRAIN_TIMEOUT_S:
        fail(f"{label}: the server exited {code} after {took:.1f} s: {tail}")


def overload_phase(torch, counters) -> None:
    """Admission and overload on the card: QoS tiers and the retry layer
    under chaos on ``bert_large`` int8 ``w2`` (24 int8 launches per
    forward) at -b 1; the memory governor and deadlines on
    ``longctx_tpu`` base int8 ``all`` (8 flash and 16 int8 launches); a
    graceful drain of a server process of its own.  Every load from
    perf_analyzer in a process of its own; sheds, expired and injected
    requests launch nothing (launches exactly per execution)."""
    from triton_client_tpu_torch.models import language

    for var, val in (("TRITON_TPU_QUANT_LONGCTX_TPU", "int8"),
                     ("TRITON_TPU_QUANT_BERT_LARGE", "int8"),
                     ("TRITON_TPU_INT8_FUSED", "w2")):
        os.environ[var] = val
    try:
        label = "overload bert_large int8 w2"
        model = language.make_bert_large("cuda")
        with serving_harness([model]) as harness:
            # the buckets' first (counted) executions before any window
            for rows in (1, 2, 4, 8, 16):
                _warm(harness, model, rows)
            check_precision(label, model.transformer, True)
            t0 = time.perf_counter()
            _overload_tiers(label, harness, model, counters)
            t1 = time.perf_counter()
            _overload_chaos(label, torch, harness, model, counters)
            print(f"{label}: tiers {t1 - t0:.1f} s, chaos "
                  f"{time.perf_counter() - t1:.1f} s", flush=True)
            _no_regions_left(label, harness)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        os.environ["TRITON_TPU_INT8_FUSED"] = "all"
        t0 = time.perf_counter()
        _overload_bytes("overload longctx_tpu int8 all", torch, counters)
        print(f"overload longctx_tpu: {time.perf_counter() - t0:.1f} s",
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        for var in ("TRITON_TPU_QUANT_LONGCTX_TPU",
                    "TRITON_TPU_QUANT_BERT_LARGE", "TRITON_TPU_INT8_FUSED"):
            os.environ.pop(var, None)
    t0 = time.perf_counter()
    _overload_drain()
    print(f"overload drain: {time.perf_counter() - t0:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# Generation: llama_decode and llama_generate (models/decode.py)
# ---------------------------------------------------------------------------

#: llama 1b, bf16 layers and the f32 head: a 128-token prompt in a 256-token
#: cache, 8 slots; parity over 32 decode steps, served streams of 64 tokens
GEN_SLOTS, GEN_S_MAX = 8, 256
GEN_PARITY_STEPS, GEN_TOKENS, GEN_STREAMS = 32, 64, 8
#: "generation <mode> <surface> <streams>" -> that window's kernel launches
GEN_PATHS = {}
#: where the phase runs ("cpu" only in a rehearsal of it off the card)
GEN_DEVICE = "cuda"


def _gen_prompts(n: int):
    """``n`` seeded 128-byte printable ASCII prompts (each fills the
    window; ASCII, so the JSON string's UTF-8 bytes are the prompt's)."""
    import numpy as np

    rng = np.random.default_rng(2024)
    return [bytes(rng.integers(32, 127, 128).astype(np.uint8))
            for _ in range(n)]


def _gen_window(torch, prompt: bytes):
    import numpy as np

    return torch.from_numpy(
        np.frombuffer(prompt, np.uint8).astype(np.int32)[None, :]).to(
            GEN_DEVICE)


def _gen_chain(torch, dec, prompt: bytes, n: int):
    """The independent chain (``make_prefill`` + greedy ``make_decode_step``
    on the card): the first ``n`` greedy tokens of ``prompt``, with each
    position's logits."""
    from triton_client_tpu_torch.models import decode

    params, cfg = dec._ensure_params()
    prefill = decode.make_prefill(cfg, GEN_S_MAX)
    step = decode.make_decode_step(cfg)
    toks, logits_all = [], []
    logits, cache = prefill(params, _gen_window(torch, prompt))
    for i in range(n):
        logits_all.append(logits[0].float())
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(nxt)
        if i < n - 1:
            logits, cache = step(params, cache, nxt[:, None])
    return ([int(t) for t in torch.cat(toks).cpu()],
            torch.stack(logits_all))


def _gen_recompute(torch, params, cfg, prompt: bytes, toks):
    """The plain recompute: ``reference_forward`` over the prompt and the
    generated tokens at once; row i holds the logits that chose token i."""
    from triton_client_tpu_torch.models import decode

    seq = torch.cat([_gen_window(torch, prompt), torch.tensor(
        [toks[:-1]], dtype=torch.int32, device=GEN_DEVICE)], dim=1)
    return decode.reference_forward(params, seq, cfg)[0, 127:].float()


def _gen_parity(label, torch, dec) -> None:
    """The port's prefill and GEN_PARITY_STEPS greedy decode steps on the
    card against the full recompute of the same tokens, held as
    ``check_next_tokens`` holds a served next-token model: each step's
    NEXT_LOGIT (its max logit) within SERVED_ATOL["llama_tpu", False] of
    the recompute's, tokens the recompute's argmax or a near tie; beside
    them the controls.  The largest difference over the whole 128,256-entry
    logits rows is printed too: a bf16 GEMM of another shape rounds each
    entry otherwise, and the maximum over that many entries reads several
    times the error of one."""
    import numpy as np

    params, cfg = dec._ensure_params()
    prompt = _gen_prompts(1)[0]
    n = GEN_PARITY_STEPS + 1
    with torch.inference_mode():
        toks, got = _gen_chain(torch, dec, prompt, n)
        full = _gen_recompute(torch, params, cfg, prompt, toks)
        best = got.amax(dim=-1)
        err = (best - full.amax(dim=-1)).abs().cpu().numpy()
        rows = float((got - full).abs().amax())
        controls = []
        for scale in CONTROL_SCALES:
            ctl = _gen_recompute(torch, control_params(torch, params, scale),
                                 cfg, prompt, toks)
            controls.append(float((best - ctl.amax(dim=-1)).abs().amax()))
        plain = list(full.cpu().numpy())
        typical = float(best.abs().mean())
    atol = SERVED_ATOL["llama_tpu", False]
    print(f"{label}: whole logits rows of prefill + {GEN_PARITY_STEPS} "
          f"steps vs the recompute: max_abs_err {rows:.3e}", flush=True)
    check_served(label, f"NEXT_LOGIT of prefill + {GEN_PARITY_STEPS} steps",
                 atol, float(err.max()), float(np.mean(err)), controls,
                 typical)
    check_tokens(label, toks, plain, atol)


def _gen_near_ties(label, torch, dec, chains, prompt, toks) -> bool:
    """A served stream equals the independent chain's tokens, or parts from
    it where the chain's logits had a near tie (both tokens within the
    bound of the maximum; a batch of another size rounds its bf16 GEMMs
    otherwise).  Returns whether it equals the chain."""
    want, logits = chains[prompt]
    if toks == want:
        return True
    if len(toks) != len(want):
        fail(f"{label}: {len(toks)} tokens, expected {len(want)}")
    j = next(i for i, (a, b) in enumerate(zip(toks, want)) if a != b)
    row = logits[j]
    top = float(row.max())
    atol = SERVED_ATOL["llama_tpu", False]
    if not (float(row[toks[j]]) >= top - atol
            and float(row[want[j]]) >= top - atol):
        fail(f"{label}: token {j} is {toks[j]}, the chain's is {want[j]}, "
             f"and the chain's logits {float(row[toks[j]]):.4f} / "
             f"{float(row[want[j]]):.4f} (max {top:.4f}) are no near tie")
    return False


def _sse_stream(port: int, prompt: bytes, n: int):
    """One ``/generate_stream`` over HTTP/1.1 (the standard library's
    client: the v2 clients have no generate API, as the reference's have
    none): (token ids, seconds from the request to each frame)."""
    import http.client

    raw = json.dumps({"text_input": prompt.decode("ascii"),
                      "max_tokens": n}).encode()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    toks, times = [], []
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/v2/models/llama_generate/generate_stream",
                     body=raw, headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            fail(f"generate_stream answered {resp.status}: {resp.read()!r}")
        while True:
            line = resp.readline()
            if not line:
                break
            if line.startswith(b"data: "):
                frame = json.loads(line[6:])
                if "error" in frame:
                    fail(f"generate_stream: in-band error {frame['error']}")
                times.append(time.perf_counter() - t0)
                toks.append(int(frame["token_id"]))
    finally:
        conn.close()
    return toks, times


def _grpc_gen_stream(port: int, prompt: bytes, n: int):
    """``llama_generate`` on one gRPC-Web stream of the port's client:
    (token ids, seconds from the request to each response)."""
    import queue

    import numpy as np

    from triton_client_tpu_torch import grpc

    got = queue.Queue()
    client = grpc.InferenceServerClient(f"127.0.0.1:{port}")
    client.start_stream(callback=lambda result, error: got.put(
        (result, error, time.perf_counter())))
    toks, times = [], []
    try:
        inp = grpc.InferInput("text_input", [1], "BYTES")
        inp.set_data_from_numpy(np.array([prompt], dtype=object))
        t0 = time.perf_counter()
        client.async_stream_infer("llama_generate", [inp],
                                  parameters={"max_tokens": n},
                                  enable_empty_final_response=True)
        while True:
            result, error, t = got.get(timeout=300)
            if error is not None:
                fail(f"llama_generate gRPC stream: {error}")
            if result.get_response().parameters[
                    "triton_final_response"].bool_param:
                break
            times.append(t - t0)
            toks.append(int(result.as_numpy("token_id")[0]))
    finally:
        client.stop_stream()
        client.close()
    return toks, times


def _gen_streams(label, torch, dec, counters, chains, fn, port, prompts):
    """``fn(port, prompt, GEN_TOKENS)`` for each prompt at once (one thread
    each), launches counted; each stream held to its chain.  Prints
    tokens/s per stream and together, time to the first token and the
    per-token p50 / p99 (the gaps between a stream's tokens)."""
    import numpy as np

    results, errors = [None] * len(prompts), []

    def run(i):
        try:
            results[i] = fn(port, prompts[i], GEN_TOKENS)
        except BaseException as e:  # reported below, then fail
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    _reset(counters)
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in counters.items()}
    launches["int8_quantize_rows"] = counters["int8_matmul"].quantize_launches
    GEN_PATHS[label] = launches
    if errors or any(t.is_alive() for t in threads):
        fail(f"{label}: streams failed: {errors}")
    if any(launches.values()):
        fail(f"{label}: the port's kernels launched {launches}; generation "
             "runs none")
    equal = sum(_gen_near_ties(label, torch, dec, chains, p, r[0])
                for p, r in zip(prompts, results))
    ttft = 1e3 * np.array([r[1][0] for r in results])
    gaps = 1e3 * np.concatenate([np.diff(r[1]) for r in results])
    per_stream = [GEN_TOKENS / r[1][-1] for r in results]
    print(f"{label}: {len(prompts)} x {GEN_TOKENS} tokens in {wall:.3f} s, "
          f"{len(prompts) * GEN_TOKENS / wall:.2f} tokens/s together, "
          f"{np.mean(per_stream):.2f} tokens/s per stream (min "
          f"{min(per_stream):.2f}); time to first token p50 "
          f"{np.percentile(ttft, 50):.3f} ms, max {ttft.max():.3f} ms; "
          f"per-token p50 {np.percentile(gaps, 50):.3f} ms, p99 "
          f"{np.percentile(gaps, 99):.3f} ms; {equal} of {len(prompts)} "
          f"streams equal to the independent chain (the rest part at a "
          f"near tie); launches {launches}; {CARD}", flush=True)
    return wall


def _gen_closed_loop(label, torch, dec, chains, port, prompts) -> None:
    """``llama_decode`` driven closed loop over HTTP (the port's client):
    each prompt's sequence of GEN_TOKENS tokens held to the chain."""
    import numpy as np

    from triton_client_tpu_torch import http

    with http.InferenceServerClient(f"127.0.0.1:{port}",
                                    network_timeout=300) as client:
        for sid, prompt in enumerate(prompts, start=1):
            x = np.frombuffer(prompt, np.uint8).astype(np.int32)
            toks = []
            t0 = time.perf_counter()
            for i in range(GEN_TOKENS):
                inp = http.InferInput("TOKENS", [len(x)], "INT32")
                inp.set_data_from_numpy(x)
                res = client.infer("llama_decode", [inp], sequence_id=sid,
                                   sequence_start=i == 0,
                                   sequence_end=i == GEN_TOKENS - 1)
                x = res.as_numpy("NEXT_TOKEN").astype(np.int32).reshape(1)
                toks.append(int(x[0]))
            wall = time.perf_counter() - t0
            same = _gen_near_ties(label, torch, dec, chains, prompt, toks)
            print(f"{label}: sequence {sid}, {GEN_TOKENS} tokens in "
                  f"{wall:.3f} s, {GEN_TOKENS / wall:.2f} tokens/s, equal "
                  f"to llama_generate's chain: {same}; {CARD}", flush=True)


def _gen_idle_share(label, torch, fn, port, prompts) -> None:
    """The card's idle share while ``len(prompts)`` streams run at once,
    from torch.profiler (device activity only)."""
    from torch.profiler import ProfilerActivity, profile

    threads = [threading.Thread(target=fn, args=(port, p, GEN_TOKENS))
               for p in prompts]
    with profile(activities=[ProfilerActivity.CUDA if GEN_DEVICE == "cuda"
                             else ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if GEN_DEVICE == "cuda":
            torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    busy, span, n = _device_busy(prof)
    print(f"{label}: traced {len(prompts)} streams: device busy "
          f"{busy:.3f} ms in {n} device events over {wall_ms:.3f} ms, idle "
          f"{max(0.0, 1 - busy / wall_ms):.1%}; {CARD}", flush=True)


def _gen_step_times(label, torch, dec) -> None:
    """The decode step at B = 1 (``make_decode_step``) and B = 8
    (``make_slot_step``, every slot active) by CUDA events at position 140
    of the 256-token cache, beside the bytes bound; the prefill (its f32
    head over all 128 positions) beside it."""
    from triton_client_tpu_torch.models import decode

    params, cfg = dec._ensure_params()
    keys = [k for k in params if k not in ("embed", "head", "final_ln")]
    layer_bytes = sum(params[k].numel() * params[k].element_size()
                      for k in keys)
    head_bytes = params["head"].numel() * params["head"].element_size()
    pos = 140
    L, H, K, D, V = (cfg.n_layers, cfg.n_heads, cfg.head_dim, cfg.d_model,
                     cfg.vocab_size)
    dev = GEN_DEVICE
    gen = torch.Generator(device=dev).manual_seed(11)
    with torch.inference_mode():
        prompt = torch.randint(0, 256, (1, 128), generator=gen,
                               device=dev, dtype=torch.int32)
        prefill = decode.make_prefill(cfg, GEN_S_MAX)
        pre_ms = timed_ms(lambda: prefill(params, prompt), iters=5)
        x = torch.randn((1, 128, D), generator=gen, device=dev).to(
            cfg.dtype)
        head_ms = timed_ms(lambda: decode._head(params, x, cfg), iters=5)
        _, cache = prefill(params, prompt)
        cache = dict(cache, pos=pos)
        step = decode.make_decode_step(cfg)
        tok = torch.ones((1, 1), dtype=torch.int32, device=dev)
        for B, fn in ((1, lambda: step(params, cache, tok)),
                      (GEN_SLOTS, None)):
            if fn is None:
                shape = (L, B, H, GEN_S_MAX, K)
                kc = torch.randn(shape, generator=gen, device=dev).to(
                    cfg.dtype)
                vc = torch.randn(shape, generator=gen, device=dev).to(
                    cfg.dtype)
                sstep = decode.make_slot_step(cfg)
                toks = torch.ones(B, dtype=torch.int32, device=dev)
                posv = torch.full((B,), pos, dtype=torch.int32, device=dev)
                act = torch.ones(B, dtype=torch.bool, device=dev)
                auto = torch.zeros(B, dtype=torch.bool, device=dev)

                def fn():
                    return sstep(params, kc, vc, toks, toks, posv, act, auto)
            ms = timed_ms(fn, iters=20)
            # each weight read once, the K/V up to the position read and one
            # position written per layer, the embedding rows, the logits out
            kv = 2 * L * B * H * (pos + 1) * K * 2
            nbytes = layer_bytes + head_bytes + kv + B * D * 2 + B * V * 4
            flops = 2.0 * B * (layer_bytes / 2 + head_bytes / 4) \
                + 4.0 * L * B * H * K * (pos + 1)
            bound, by = bound_ms(flops, PEAK_BF16_FLOPS, nbytes)
            print(f"{label}: decode step B={B} {ms:.4f} ms (CUDA events); "
                  f"bound {bound:.4f} ms by {by} ({nbytes / 1e9:.3f} GB: "
                  f"bf16 layers {layer_bytes / 1e9:.3f} GB, f32 head "
                  f"{head_bytes / 1e9:.3f} GB, K/V {kv / 1e6:.1f} MB), "
                  f"{bound / ms:.1%} of it; {1e3 * B / ms:.1f} tokens/s at "
                  f"that step; {CARD}", flush=True)
    print(f"{label}: prefill [1, 128] {pre_ms:.3f} ms (CUDA events), of "
          f"which the f32 head over all 128 positions {head_ms:.3f} ms "
          f"({2.0 * 128 * D * V / head_ms / 1e9:.1f} TFLOP/s in f32); "
          f"{CARD}", flush=True)


def generation_phase(torch, counters) -> None:
    """llama_decode and llama_generate over llama 1b on the card: parity of
    prefill + decode steps with the full recompute (beside the controls),
    the decode step's time at B = 1 and 8 against its bytes bound, then
    each mode (independent; batched with 8 slots at the default
    TRITON_TPU_DECODE_STEPS of 4) served: /generate_stream over HTTP and a
    gRPC-Web stream at 1 and 8 streams of 64 tokens, llama_decode closed
    loop for 2 sequences, every stream's tokens held to the independent
    chain, no kernel of the port launched; the card's idle share with 8
    streams traced.  Beside row 5's ensemble_llama figures (PERF.md)."""
    from triton_client_tpu_torch.models import decode

    for var in ("TRITON_TPU_DECODE_STEPS", "TRITON_TPU_DECODE_BUCKETS",
                "TRITON_TPU_PREFILL_CHUNK", "TRITON_TPU_KV_QUANT"):
        os.environ.pop(var, None)
    os.environ["TRITON_TPU_DECODE_SLOTS"] = str(GEN_SLOTS)
    prompts = _gen_prompts(GEN_STREAMS)
    params = None
    try:
        for mode in ("independent", "batched"):
            os.environ["TRITON_TPU_DECODE_MODE"] = mode
            label = f"generation {mode}"
            dec = decode.DecodeModel(device=GEN_DEVICE)
            if params is None:
                t0 = time.perf_counter()
                params = dec._ensure_params()
                print(f"generation: llama 1b weights built in "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
                if params[0]["head"].dtype != torch.float32 or \
                        params[0]["wq"].dtype != torch.bfloat16:
                    fail("generation: expected bf16 layers and an f32 head")
                _gen_parity("generation parity", torch, dec)
                _gen_step_times("generation", torch, dec)
                with torch.inference_mode():
                    chains = {p: _gen_chain(torch, dec, p, GEN_TOKENS)
                              for p in prompts}
            else:
                dec._params = params   # the same weights, not built again
            gen_model = decode.make_llama_generate(dec)
            with serving_harness([dec.model, gen_model]) as harness:
                port = harness.http_port
                _sse_stream(port, b"warm-up", 2)
                for surface, fn in (("http sse", _sse_stream),
                                    ("grpc-web", _grpc_gen_stream)):
                    for n in (1, GEN_STREAMS):
                        _gen_streams(f"{label} {surface} {n} stream(s)",
                                     torch, dec, counters, chains, fn, port,
                                     prompts[:n])
                _gen_closed_loop(f"{label} llama_decode http", torch, dec,
                                 chains, port, prompts[:2])
                # one stream where each is served alone, the batch of 8
                # where they share the tick
                _gen_idle_share(f"{label} http sse", torch, _sse_stream,
                                port, prompts[:1 if mode == "independent"
                                              else GEN_STREAMS])
            del dec, gen_model
            gc.collect()
        print("generation: BASELINE row 5 through ensemble_llama read "
              "30.35 / 30.51 tokens/s on one stream in earlier runs "
              "(PERF.md); this run's reading is in its gRPC phase",
              flush=True)
    finally:
        for var in ("TRITON_TPU_DECODE_MODE", "TRITON_TPU_DECODE_SLOTS"):
            os.environ.pop(var, None)
    del params
    gc.collect()
    if GEN_DEVICE == "cuda":
        torch.cuda.empty_cache()


def _signature_of(harness, model, x):
    """The input signature the server records for a batch like ``x``."""
    from triton_client_tpu_torch.server.core import _signature

    return _signature({model.config.input[0].name: x})



def main() -> int:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    if not os.path.isdir(os.path.join(REPO, "triton_client_tpu_torch")):
        fail("triton_client_tpu_torch is not beside chip_smoke.py")
    sys.path.insert(0, REPO)
    global PEAK_BF16_FLOPS, PEAK_BYTES_PER_S
    from triton_client_tpu_torch.server.costs import peak_bytes_per_s
    from triton_client_tpu_torch.server.device_stats import peak_flops
    PEAK_BF16_FLOPS, PEAK_BYTES_PER_S = peak_flops(), peak_bytes_per_s()
    # plain versions in full f32 (no TF32 shortcuts)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    global CARD
    CARD = card
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    try:
        sm_clock_hz = float(clock.stdout.strip().splitlines()[0]) * 1e6
    except (IndexError, ValueError):
        fail(f"nvidia-smi gave no SM clock: {clock.stdout!r} "
             f"{clock.stderr.strip()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}",
          flush=True)

    from triton_client_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build()
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    ptxas = {name: " | ".join(ln.strip() for ln in log.splitlines()
                              if "registers" in ln or "spill" in ln)
             for name, log in _build.build_log.items()}
    for name in sorted(ptxas):
        print(f"{name}: {ptxas[name]}", flush=True)

    fa = importlib.import_module("triton_client_tpu_torch.ops.flash_attention")
    im = importlib.import_module("triton_client_tpu_torch.ops.int8_matmul")
    gen = torch.Generator(device="cuda").manual_seed(0)
    flash = check_flash(fa, torch, gen, sm_clock_hz)
    int8 = check_int8(im, torch, gen, ptxas.get("int8_matmul", ""))
    torch.cuda.empty_cache()

    check_int8_model_shapes(im, torch, gen)
    check_flash_bert(fa, torch, gen)

    from triton_client_tpu_torch.models import language

    counters = {"flash_attention": fa, "int8_matmul": im}
    for var in [v for v in os.environ if v.startswith("TRITON_TPU_QUANT")]:
        os.environ.pop(var)
    for var in ("TRITON_TPU_INT8_FUSED", "TRITON_TPU_FLASH",
                "TRITON_TPU_FLASH_MIN_S", "TRITON_TPU_LONGCTX_PRESET",
                "TRITON_TPU_MOE_PRESET", "TRITON_TPU_LLAMA_PRESET"):
        os.environ.pop(var, None)

    def phase(label, fn, *args, int8=False, fused=None, **kw):
        """One served path, under TRITON_TPU_QUANT=int8 where ``int8``
        (else unset) and TRITON_TPU_INT8_FUSED=``fused`` (unset when
        None)."""
        for var, val in (("TRITON_TPU_QUANT", "int8" if int8 else None),
                         ("TRITON_TPU_INT8_FUSED", fused)):
            if val is None:
                os.environ.pop(var, None)
            else:
                os.environ[var] = val
        t0 = time.perf_counter()
        launches = fn(label, torch, counters, *args, int8=int8, **kw)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"{label}: phase took {time.perf_counter() - t0:.1f} s",
              flush=True)
        return launches

    # the main path: every served model, bf16 and int8 under the default
    # w2; beside it, FFN-up fused too (``all``) for its forward time and
    # error, not in the kernels line
    paths = {
        "longctx_tpu bf16": phase("serve bf16", serve_longctx,
                                  int8_per_layer=0, transports=True),
        "longctx_tpu int8": phase("serve int8", serve_longctx,
                                  int8_per_layer=1, int8=True),
    }
    phase("serve int8 fused=all", serve_longctx, int8_per_layer=2,
          int8=True, fused="all")
    with bert_depth(BERT_SERVE_LAYERS):
        paths["bert_large bf16"] = phase(
            "serve bert_large bf16", serve_bert, int8_per_layer=0,
            transports=True)
        paths["bert_large int8"] = phase(
            "serve bert_large int8", serve_bert, int8_per_layer=1, int8=True,
            transports=True)
        phase("serve bert_large int8 fused=all", serve_bert,
              int8_per_layer=2, int8=True, fused="all")
    paths["moe_tpu bf16"] = phase(
        "serve moe_tpu bf16", serve_next_token, language.make_moe_tpu,
        "moe_tpu", int8_per_layer=0)
    paths["moe_tpu int8"] = phase(
        "serve moe_tpu int8", serve_next_token, language.make_moe_tpu,
        "moe_tpu", int8_per_layer=0, int8=True)
    paths["ensemble_llama bf16"] = phase(
        "serve ensemble_llama (llama_tpu 1b bf16)", serve_ensemble)
    paths["llama_tpu int8"] = phase(
        "serve llama_tpu int8", serve_next_token, language.make_llama_tpu,
        "llama_tpu", int8_per_layer=1, int8=True)
    for var in ("TRITON_TPU_QUANT", "TRITON_TPU_INT8_FUSED"):
        os.environ.pop(var, None)
    for name, fn, args in (("perf", perf_phase, (torch, counters, fa)),
                           ("grpc", grpc_phase, (torch, counters)),
                           ("vision", vision_phase, (torch, counters)),
                           ("observability", observability_phase,
                            (torch, counters)),
                           ("overload", overload_phase, (torch, counters)),
                           ("generation", generation_phase,
                            (torch, counters))):
        t0 = time.perf_counter()
        fn(*args)
        print(f"{name} phase took {time.perf_counter() - t0:.1f} s",
              flush=True)
    # and every transport's window of the shared-memory phases, every
    # perf_analyzer run, every gRPC window, every vision window, every
    # observability run, every overload run and every generation window
    paths.update(SHM_PATHS)
    paths.update(PERF_PATHS)
    paths.update(GRPC_PATHS)
    paths.update(VISION_PATHS)
    paths.update(OBS_PATHS)
    paths.update(OVERLOAD_PATHS)
    paths.update(GEN_PATHS)
    for path, launches in paths.items():
        print(f"launches on {path}: flash_attention "
              f"{launches['flash_attention']}, int8_matmul "
              f"{launches['int8_matmul']}", flush=True)

    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "triton_client_tpu_torch/csrc/flash_attention.cu",
         "replaces": "triton_client_tpu/ops/flash_attention.py:140",
         "launches": sum(p["flash_attention"] for p in paths.values()),
         **flash},
        {"name": "int8_matmul", "route": "cuda",
         "source": "triton_client_tpu_torch/csrc/int8_matmul.cu",
         "replaces": "triton_client_tpu/ops/int8_matmul.py:102",
         "launches": sum(p["int8_matmul"] for p in paths.values()),
         **int8},
    ]
    for k in kernels:
        if k["launches"] == 0:
            fail(f"{k['name']} never launched on the main path")
    print(f"the script took {time.perf_counter() - t_start:.1f} s; {CARD}",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--shm-client"]:
        sys.exit(shm_client_main(sys.argv[2]))
    sys.exit(main())
