#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``triton_client_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

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
   rows and a row of exact ties;
4. serve ``longctx_tpu`` (``base`` preset: d_model 1024, 8 layers, S = 4096)
   through the port's HTTP server, bf16: 8 requests from 4 threads, each
   response held to the port's forward with plain kernels (LOGPROBS atol
   5e-2, the bound of the CPU parity tests), kernel launch counts checked,
   then one full batch timed and traced;
5. the same served int8 (``TRITON_TPU_QUANT_LONGCTX_TPU=int8``; LOGPROBS
   atol 1.5e-1, see ``LOGPROBS_ATOL``), under the default
   ``TRITON_TPU_INT8_FUSED=w2`` (one int8 launch per layer) and then under
   ``all`` (two: FFN-up too), for its forward time beside the default's;
6. print one JSON line describing every kernel, then the result line
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX and nothing of ``triton_client_tpu``.
"""

from __future__ import annotations

import http.client
import importlib
import json
import os
import subprocess
import sys
import threading
import time

# H100 SXM data-sheet peaks (dense), at the full 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_PER_S = 3.35e12
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
# served LOGPROBS vs the plain-kernel forward.  bf16: the bound of the CPU
# parity tests.  int8: a run whose bf16 activations differ from another's in
# the last bit (the flash kernel's bf16 probabilities; batch-size-dependent
# GEMM sums) flips the int8 codes that sit at a rounding boundary, each flip
# moves a product by one quantization step and 8 layers compound it: the
# first run on the H100 measured 6.1e-2 over 8 requests.
LOGPROBS_ATOL = {False: 5e-2, True: 1.5e-1}
N_REQUESTS, N_THREADS = 8, 4


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


def check_int8(im, torch, gen, ptxas: str):
    """The quantize pass and the GEMM, each bit for bit against its plain
    version, at M in INT8_ROWS for both shapes (bf16; f32 at M = 300) with
    the weight row-major and K-major; timings at FFN-down of B = 4 with the
    weight K-major, as the served path stores it."""
    cases = [(m, k, n, torch.bfloat16) for k, n in INT8_SHAPES
             for m in INT8_ROWS]
    cases += [(300, k, n, torch.float32) for k, n in INT8_SHAPES]
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
    m, k, n = 16384, 4096, 1024
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
    ms_row = timed_ms(lambda: im.int8_matmul(x, w, ws))
    plain_ms = timed_ms(lambda: im.int8_matmul_reference(x, w, ws), iters=3)
    lib_ms = timed_ms(library)
    phases = _device_ms(torch, lambda: im.int8_matmul(x, w_kmajor, ws),
                        ("quantize_rows", "int8_gemm"))
    nbytes = m * k * 2 + k * n + n * 4 + m * n * 2
    bms, by = bound_ms(2.0 * m * k * n, PEAK_INT8_OPS, nbytes)
    # the split's own floor: the quantize pass moves x once and the codes
    # once, then the GEMM's operations
    floor_ms = (m * k * 2 + m * k + m * 4) / PEAK_BYTES_PER_S * 1e3 + \
        2.0 * m * k * n / PEAK_INT8_OPS * 1e3
    print(f"int8_matmul M={m} K={k} N={n} bf16: kernel {ms:.4f} ms with the "
          f"weight K-major ({ms_row:.4f} ms row-major, copy included); "
          f"device time: quantize pass {phases['quantize_rows']:.4f} ms, "
          f"GEMM {phases['int8_gemm']:.4f} ms (torch.profiler); plain "
          f"{plain_ms:.4f} ms, quantize+_int_mm+epilogue {lib_ms:.4f} ms, "
          f"bound {bms:.4f} ms ({by}), design floor {floor_ms:.4f} ms; "
          f"kernel at {bms / ms:.1%} of the bound, {lib_ms / ms:.2f}x "
          f"faster than the library path; ptxas: {ptxas}", flush=True)
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}


def _post_infer(port: int, tokens):
    """One binary-extension v2 infer request; returns (LOGPROBS, seconds)."""
    import numpy as np

    raw = tokens.astype(np.int32).tobytes()
    header = json.dumps({
        "inputs": [{"name": "TOKENS", "datatype": "INT32",
                    "shape": list(tokens.shape),
                    "parameters": {"binary_data_size": len(raw)}}],
        "outputs": [{"name": "LOGPROBS",
                     "parameters": {"binary_data": True}}],
    }).encode()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    t0 = time.perf_counter()
    try:
        conn.request("POST", "/v2/models/longctx_tpu/infer", header + raw,
                     {"Inference-Header-Content-Length": str(len(header)),
                      "Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        body = resp.read()
    finally:
        conn.close()
    dt = time.perf_counter() - t0
    if resp.status != 200:
        fail(f"infer returned HTTP {resp.status}: {body[:500]!r}")
    hlen = int(resp.getheader("Inference-Header-Content-Length"))
    out = json.loads(body[:hlen])["outputs"][0]
    arr = np.frombuffer(body[hlen:], dtype=np.float32).reshape(out["shape"])
    return arr, dt


def profile_forward(label: str, run, torch, seq_len: int) -> None:
    """Time one forward of a full batch (B = 4) with CUDA events, then trace
    one with torch.profiler and print where the device time goes."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(7)
    tokens = torch.randint(0, 256, (4, seq_len), generator=gen, device="cuda")
    with torch.inference_mode():
        fwd_ms = timed_ms(lambda: run(tokens), iters=5)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(tokens)
            torch.cuda.synchronize()
    # device-side entries only (kernels and copies, our ctypes launches
    # included); CPU ops carry their kernels' time too and would count twice
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    print(f"{label}: forward B=4 {fwd_ms:.3f} ms (CUDA events); traced "
          f"device time {busy_ms:.3f} ms in {len(events)} ops: " + "; ".join(
              f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms"
              for e in top), flush=True)
    ours = [e for e in events if any(
        k in e.key for k in ("flash_fwd", "quantize_rows", "int8_gemm"))]
    print(f"{label}: the port's kernels in that forward: " + "; ".join(
        f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms in "
        f"{e.count} launches" for e in ours), flush=True)


def serve_phase(label: str, torch, counters, int8_per_layer: int):
    """Serve longctx_tpu base on cuda through the HTTP server; check every
    response against the plain-kernel forward and the launch counts (flash
    once per layer, the int8 kernel ``int8_per_layer`` times per layer, 0 on
    the bf16 path).  Returns launch counts."""
    expect_int8 = int8_per_layer > 0
    import numpy as np

    from triton_client_tpu_torch.models import language
    from triton_client_tpu_torch.models import transformer as tr
    from triton_client_tpu_torch.server.registry import ModelRegistry
    from triton_client_tpu_torch.server.testing import ServerHarness

    model = language.make_longctx_tpu("cuda")
    S = model.config.input[0].dims[0]
    rng = np.random.default_rng(1234)
    requests = [rng.integers(0, 256, (1, S)).astype(np.int32)
                for _ in range(N_REQUESTS)]
    registry = ModelRegistry()
    registry.register_model(model)
    results = [None] * N_REQUESTS
    latencies = [0.0] * N_REQUESTS
    errors = []
    with ServerHarness(registry) as harness:
        for mod in counters.values():
            mod.launches = 0
        counters["int8_matmul"].quantize_launches = 0
        _post_infer(harness.http_port, requests[0])  # warm-up: init weights
        start = threading.Barrier(N_THREADS)

        def client(tid):
            try:
                start.wait(timeout=60)
                for i in range(tid, N_REQUESTS, N_THREADS):
                    results[i], latencies[i] = _post_infer(
                        harness.http_port, requests[i])
            except BaseException as e:  # reported below, then fail
                errors.append(repr(e))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(N_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = {name: mod.launches for name, mod in counters.items()}
        quantize_launches = counters["int8_matmul"].quantize_launches
        stats = model.stats
    if errors or any(t.is_alive() for t in threads):
        fail(f"{label}: client threads failed: {errors}")
    executions = stats.batch_execution_count
    print(f"{label}: {N_REQUESTS} requests + 1 warm-up in {executions} "
          f"batched executions (avg batch "
          f"{stats.batch_size_total / max(executions, 1):.2f}); p50 latency "
          f"{1e3 * float(np.median(latencies)):.2f} ms, max "
          f"{1e3 * max(latencies):.2f} ms; {N_REQUESTS / wall:.2f} infer/s; "
          f"launches {launches}", flush=True)
    per_forward = model.transformer.cfg.n_layers
    if launches["flash_attention"] != per_forward * executions:
        fail(f"{label}: flash_attention launched "
             f"{launches['flash_attention']} times, expected "
             f"{per_forward} per forward x {executions} forwards")
    want_int8 = int8_per_layer * per_forward * executions
    if launches["int8_matmul"] != want_int8 or quantize_launches != want_int8:
        fail(f"{label}: the int8 kernels launched {launches['int8_matmul']} "
             f"(quantize pass {quantize_launches}) times, expected "
             f"{int8_per_layer * per_forward} per forward x {executions} "
             "forwards")
    # the reference: the same forward with the kernels' plain versions
    run = model.transformer
    fwd = tr.make_forward(run.cfg, quantized=expect_int8, plain=True)
    worst, mean = 0.0, 0.0
    with torch.inference_mode():
        for tokens, got in zip(requests, results):
            t = torch.from_numpy(tokens).to("cuda")
            want = language.longctx_scores(fwd(run.params, t), t).cpu().numpy()
            if got.shape != (1, S) or not np.isfinite(got).all():
                fail(f"{label}: bad LOGPROBS shape {got.shape} or non-finite")
            worst = max(worst, float(np.abs(got - want).max()))
            mean += float(np.abs(got - want).mean()) / N_REQUESTS
    atol = LOGPROBS_ATOL[expect_int8]
    print(f"{label}: LOGPROBS vs plain-kernel forward: max_abs_err "
          f"{worst:.3e} (atol {atol}), mean_abs_err {mean:.3e}", flush=True)
    if not worst <= atol:
        fail(f"{label}: served LOGPROBS disagree with the plain forward")
    profile_forward(label, run, torch, S)
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "triton_client_tpu_torch")):
        fail("triton_client_tpu_torch is not beside chip_smoke.py")
    sys.path.insert(0, repo)
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

    counters = {"flash_attention": fa, "int8_matmul": im}
    for var in ("TRITON_TPU_QUANT_LONGCTX_TPU", "TRITON_TPU_QUANT",
                "TRITON_TPU_INT8_FUSED"):
        os.environ.pop(var, None)
    bf16 = serve_phase("serve bf16", torch, counters, int8_per_layer=0)
    torch.cuda.empty_cache()
    os.environ["TRITON_TPU_QUANT_LONGCTX_TPU"] = "int8"
    q8 = serve_phase("serve int8", torch, counters, int8_per_layer=1)
    torch.cuda.empty_cache()
    # beside the default (FFN-down fused), FFN-up fused too: its forward
    # time and LOGPROBS error; not the main path, so its launches are not
    # in the kernels line
    os.environ["TRITON_TPU_INT8_FUSED"] = "all"
    serve_phase("serve int8 fused=all", torch, counters, int8_per_layer=2)
    os.environ.pop("TRITON_TPU_INT8_FUSED")
    os.environ.pop("TRITON_TPU_QUANT_LONGCTX_TPU")

    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "triton_client_tpu_torch/csrc/flash_attention.cu",
         "replaces": "triton_client_tpu/ops/flash_attention.py:140",
         "launches": bf16["flash_attention"] + q8["flash_attention"],
         **flash},
        {"name": "int8_matmul", "route": "cuda",
         "source": "triton_client_tpu_torch/csrc/int8_matmul.cu",
         "replaces": "triton_client_tpu/ops/int8_matmul.py:102",
         "launches": bf16["int8_matmul"] + q8["int8_matmul"],
         **int8},
    ]
    for k in kernels:
        if k["launches"] == 0:
            fail(f"{k['name']} never launched on the main path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
