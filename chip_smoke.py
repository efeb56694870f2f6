#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``triton_client_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

(``chip_smoke.py --shm-client SPEC`` is the cross-process shared-memory
client that the run starts itself.  ``chip_smoke.py --obs-spread N`` runs
the observability phase's traced ``longctx_tpu`` sweep N times alone and
prints, for each execution far from the forward on an idle card, the
host's and the card's times at each layer's end.)

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
   flash once per layer, and per transport p50 / p99 of
   ``SHM_SEQUENTIAL`` requests one after another, infer/s from
   ``SHM_CLIENTS`` clients at once and the server's split of a request;
   then one full batch timed and traced;
5. the same served int8 (``TRITON_TPU_QUANT=int8``), under the
   default ``TRITON_TPU_INT8_FUSED=w2`` (one int8 launch per layer) and
   then under ``all`` (two: FFN-up too), for its forward time beside the
   default's;
6. serve ``bert_large`` at full width (S = 384) and ``BERT_SERVE_LAYERS``
   (12) of its 24 layers: 12 requests (8 under ``all``) of
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
   it: -b 32 at concurrency 1 by wire and by system shm (the tool's POSIX
   regions), at 1 and 4 by CUDA shm (the tool's regions, which the server
   maps with cudaIpcOpenMemHandle), at 4 by wire, traced; -b 1
   at concurrency 1 and 8 through the dynamic batcher; open loop at
   half of concurrency 1's infer/s and at half of concurrency 8's.  Then
   ``bert_large`` bf16 at -b 32,
   concurrency 1, and ``longctx_tpu`` base bf16 at -b 4, concurrency 1 and
   4, by CUDA shm, and by wire traced at each.  Each level prints
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
    D2H_TRANSFER children, each COMPUTE within ``OBS_TOL`` of its own
    execution's CUDA events (timed from outside the core) and their
    median within it of the CUDA-event forward; launches exactly per
    forward; the served answers equal with observability on and off (bit
    for bit for ``bert_large``);
    the signature's counted FLOPs equal to the plain path's within
    ``OBS_FLOPS_TOL``; live MFU in (0, 1.05] and within ``OBS_TOL`` of
    counted FLOPs / forward / the bf16 peak; ``nv_tpu_memory_used_bytes``
    at least the served parameters' bytes; ``/metrics`` parsed; a
    ``PROFILE`` window whose Chrome trace names the flash and int8
    kernels; no region left; ``bert_large`` runs off, then on, and on may
    be at most ``OBS_TOL`` slower (the spans and the cost read once more
    on a miss, ``HOST_GATE_RUNS``);
13. the host's view: ``longctx_tpu`` base bf16 and ``bert_large`` int8
    ``w2`` (``BERT_SERVE_LAYERS``) served together; ``perf_analyzer``
    -b 4 at c = 4, untraced, while the sampling profiler is turned off
    (``set_hz(0)``) and on at its default 19 Hz every
    ``HOST_COST_SLOT_S``: infer/s and each arm's server times printed,
    the on arm's mean at most ``HOST_COST_TOL`` above the
    off arm's (the run read once more on a miss, ``HOST_GATE_RUNS``),
    flash exactly 8 a forward; then ``/v2/debug/profile``: the forward's
    frames (``transformer.py``) under the batcher or frontend role, every
    request thread's stack under ``frontend``, each role's samples grown, the
    frontend's lag probe and the GC pauses on ``/metrics``, the top five
    stacks per role printed; a ``POST /v2/debug/incident`` inside a c = 4
    window: every file of the bundle there and none failed, its profile,
    device statistics and costs naming ``longctx_tpu`` with its
    executions, ``incident_report --latest`` rendering it, its write time
    and that sweep's p99 printed beside the run without it; a
    ``bert_large`` sweep (12 int8 launches a forward); then OTLP: the
    server's and the client's exporters to a stub collector in this
    process, 16 traced requests: every server root joined to its client
    REQUEST span on one trace id, ``nv_otlp_export_total{ok}`` the
    server's posts, nothing dropped;
14. overload: ``bert_large`` int8 ``w2`` at -b 1 under a queue bound of
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
    retried, no caller error, the budget back afterwards, and the first
    draw's ``chaos`` incident bundle complete and counted.
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
15. generation (``models/decode.py``): ``llama_decode`` and
    ``llama_generate`` over llama 1b (bf16 layers, the f32 head; a
    128-token prompt in a 256-token cache, 8 slots).  The port's prefill
    and 32 greedy decode steps held to the full recompute of the same
    tokens (``reference_forward``) as ``check_next_tokens`` holds a served
    next-token model, beside the controls; the decode step at B = 1 and 8
    by CUDA events beside its bytes bound, the prefill and its f32 head;
    then each mode served (independent; batched, T = 4): ``/generate_stream``
    over HTTP (SSE) and ``llama_generate`` on gRPC-Web streams, 1 and 8
    streams of 64 tokens (independent mode's gRPC-Web stream at 1), every
    stream's tokens the independent chain's
    (or parting at a near tie of its logits), ``llama_decode`` closed loop
    over HTTP for 2 sequences held the same way; tokens/s per stream and
    together, time to the first token, per-token p50 / p99 and the card's
    idle share (torch.profiler), beside row 5's ``ensemble_llama``
    figures; no kernel of the port launches; the always-on profiler's
    top stacks of the decode worker and the request threads printed;
16. the cache and faults: the prefix/KV cache on 1,024-token prompts,
    int8 KV and the device-fault drills on llama 1b (``cache_faults_phase``;
    the persistent fault's quarantine writes a complete, counted
    ``device_fault`` incident bundle);
17. OpenAI, genai_perf and the repository: ``llama_generate`` over llama
    1b, batched with 8 slots and the prefix cache, through ``/v1``:
    greedy completions of 64 tokens, streamed and not, and ``n = 8``
    greedy streams held token by token (their characters ``chr(token %
    256)`` and chosen-token logprobs) to a warm ``/generate_stream``'s
    tokens, parting only at a near tie of the recomputed logits, a cold
    ``/generate_stream`` held to the independent chain, the first chunk
    streamed beside ``generate_stream``'s, a chat stream's
    ``include_usage`` counts and tokens against the chain, a stop that
    ends a stream and frees its slot, ``n = 16`` on the 8 slots refused
    with 429 and every slot free after, ``n = 8`` seeded streams
    reproduced, ``best_of = 4``, and ``cached_tokens`` 960 on a warm
    1,024-token prompt; ``genai_perf`` in processes of its own (SSE at
    concurrency 1 and 8, the ``llama_decode`` closed loop on gRPC-Web at 1
    and 4, 64 tokens): no error, every request complete, its report
    consistent, and ``itl_steady`` within 35% of an independent reading of
    the same token gaps just before, from a process of its own (both read
    once more on a miss); then a temporary model repository with a
    ``longctx_tpu``-base model (versions 1 and 2 from their seeds): version
    1 loaded, served and unloaded, both under a JSON override with
    ``version_policy`` all, a ``load_fail`` draw and a ``files`` load,
    each version's LOGPROBS within ``SERVED_ATOL`` of its own seed's
    plain-kernel forward beside the controls and the other seed, flash 8
    a forward, and ``torch.cuda.memory_allocated()`` back within 2 MiB of
    its value before the load after each of the three unloads;
18. the fleet: ``python -m triton_client_tpu_torch.server --frontends 2``
    and ``--frontends 1`` (the zoo on the card) start in processes of
    their own while ``bert_large`` int8 ``w2`` at ``BERT_SERVE_LAYERS``
    runs here under a fleet controller (bounds 1..8, held at 1 for the
    first cooldown of the window); the pair is started with its bundles in
    an incident directory and a ``worker_kill`` chaos draw on ``simple``
    only: one ``simple`` request kills the worker that takes it, whose
    ``chaos`` bundle and its sibling's ``worker_crash`` bundle must be
    complete, then SIGUSR2 to the sibling writes a ``sigusr2`` bundle
    (both counted on the sibling's ``/metrics``), and the worker comes
    back before the comparison; ``perf_analyzer`` c = 16 -b 32 scales it
    out one instance a cooldown and an idle second scales it back in,
    infer/s and the card's idle share (``nvidia-smi`` utilization.gpu,
    100 ms samples) printed at each in-flight count (readings taken during
    the scale-out, each about one cooldown long, beside the fleets'
    start), the answer before the load held to the plain forward beside
    the controls, int8 once per layer of every forward.  Then
    ``longctx_tpu`` base through both fleets (every worker's first answer
    held to the plain forward beside the controls), ``perf_analyzer`` c =
    4 -b 4 against each from a process of its own (infer/s, p50 / p99, the
    idle share, each worker's executions), CUDA regions of this process
    registered through one worker and used until both workers served them
    (the sibling opens the cudaIPC handle from the manifest; each answer
    the wire's), the regions gone from every worker's status, each
    worker's ``/metrics`` on its own port.  Worker 0 is SIGKILLed a
    quarter into a c = 4 ``--retries 3`` window, once it has executed in
    that window: zero errors, each worker's executions printed, and at
    least one request cut off and sent again (the client's resends on a
    new connection and its retries).  While it restarts, an in-process
    ``longctx_tpu`` model (``FLEET_SEEDS``) under a c = 4 closed loop is
    rolled from version 1 to 2 (warmed, promoted, baked): zero caller
    errors, each answer one version's (v1 before the flip, v2 for a
    request sent after ``promote`` returned), flash 8 a forward (the
    warmup's included), v1's batcher drained and v1 addressable; then an
    update to a version that fails every request rolls back to v2 and
    ``torch.cuda.memory_allocated()`` comes back within 2 MiB of its value
    before it was staged.  Then the respawned worker: its metrics port
    back with ``nv_fleet_worker_restart_total`` 2 (the draw's restart and
    the kill's, 2 on both), its answers held, and SIGTERM drains the fleet
    to exit 0.  Every child process is
    stopped on every exit path;
19. the cluster client and the response cache: three CLI replicas of
    ``longctx_tpu`` base bf16 start (the third behind a chaos latency of
    ``CC_STRAGGLE_MS`` on every request) while, in this process, two
    replicas of it (a ``ClusterHarness``) take ``perf_analyzer -u A,B -b
    4`` at c = 4, once ``--balancing round_robin`` and once
    ``least_outstanding``: both replicas execute, the client's requests by
    endpoint equal each replica's own count, flash exactly 8 a forward;
    then ``bert_large`` int8 ``w2`` at full depth (24 layers), B = 32, by
    wire with its response cache on (TTL ``CC_TTL_S``, a byte budget under
    two entries): a hit answers the miss's bytes with no launch, each miss
    launches int8 exactly 24 times, ``nv_cache_num_*_per_model`` count
    what was sent, the budget and the TTL evict, a hit's p50 beside a
    miss's; then the first two CLI replicas (each first answer held to the
    plain forward beside the controls) under ``perf_analyzer -u A,B
    --retries 3`` at c = 4, one SIGKILLed a quarter into the window among
    those that executed in it: zero caller errors, the requests sent
    again, the breakers' transitions; then the survivor beside the
    straggler, the same c = 4 window without and with ``--hedge-ms``
    (``CC_HEDGE_MS``): p99 both ways, hedges won, and ``CC_HEDGED`` hedged
    requests from this process's ``ClusterClient``, each answer within
    ``SERVED_ATOL`` of the plain forward.  Every child process is stopped
    on every exit path;
20. the operators' tools and the wire templates: ``longctx_tpu`` base
    bf16 and ``bert_large`` int8 ``w2`` at 24 layers served here with
    server tracing and the port's client telemetry tracing on, each by
    HTTP and gRPC-Web (answers within ``SERVED_ATOL``, flash 8 and int8 24
    a forward exactly), one template per (model, output set) in each of
    the server's caches; then a served response of each stamped byte for
    byte as the slow path encodes it, both encoders timed over
    ``TW_ENCODE_CALLS`` calls on it, and ``bert_large``'s response-cache
    hits timed by wire; then ``python -m
    triton_client_tpu_torch.tools.trace_summary`` on the traces (every
    request counted, every journey joined, COMPUTE's median within the
    executions' CUDA-event range, a Chrome export with a lane per journey)
    and ``tools.top --once --json`` (each model's successes as its
    statistics count them).  The fleet phase also reads the SIGKILL's
    restart through ``tools.top`` over the fleet's frontend;
21. print each kernel's launches on every served path, one JSON line
    describing every kernel, then the result line
    ``{"ok": true, "device": {...}}``.

Every request goes through the port's own HTTP client
(``triton_client_tpu_torch.http``) on kept-alive connections, its gRPC
client (``triton_client_tpu_torch.grpc``) or its cluster client over
them (``triton_client_tpu_torch.cluster``), but ``/generate_stream`` and
the ``/v1`` routes, which neither client speaks (as the reference's do
not): the standard library's ``http.client`` reads their events.

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
import urllib.error
import urllib.request

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
# bert_large: 12 requests (40, then 24, before the cuts that made room for
# the cluster and cache and the tools and wire phases, PERF.md) of 4
# sequences from 8 threads, so up to 32 sequences wait at once and the
# batcher can fill its largest batch (32)
BERT_REQUESTS, BERT_ROWS, BERT_THREADS = 12, 4, 8


REPO = os.path.dirname(os.path.abspath(__file__))


def fail(msg: str) -> None:
    """Print the failed check on both streams (a caller that keeps only
    the end of standard error still sees it) and exit 1."""
    print(f"FAIL: {msg}", flush=True)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
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
    """Register ``models`` and serve them over HTTP; yields the harness.
    On a clean exit, no response fell back to the slow path because a
    wire template raised (``ResponseTemplateCache.stats["errors"]``)."""
    from triton_client_tpu_torch.server.registry import ModelRegistry
    from triton_client_tpu_torch.server.testing import ServerHarness

    registry = ModelRegistry()
    for m in models:
        registry.register_model(m)
    with ServerHarness(registry) as harness:
        yield harness
        for proto, cache in (("HTTP", harness.core.http_wire_templates),
                             ("gRPC", harness.core.grpc_wire_templates)):
            if cache.stats["errors"]:
                fail(f"serving {[m.name for m in models]}: the {proto} wire "
                     f"templates raised {cache.stats['errors']} times "
                     f"({cache.stats})")


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
               transports: bool = False, n_requests: int = BERT_REQUESTS):
    """Serve bert_large at full width: ``n_requests`` requests of BERT_ROWS
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
              for _ in range(n_requests)]
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
            mean += float(np.abs(got - want).mean()) / n_requests
            typical += float(np.abs(want).mean()) / n_requests
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
#: (30 one after another and 8 a client before the cut that made room for
#: the fleet phase, PERF.md)
SHM_SEQUENTIAL, SHM_CLIENTS, SHM_PER_CLIENT = 15, 4, 4
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
# where requests take up to ~0.2 s (longctx_tpu, bert_large -b 32 at
# c = 1); 6 s where they take up to ~1 s (bert_large at -b 32 and c = 4,
# at -b 1 and c = 8), at most 17%
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
    forward) at -b 32, c = 1 by wire and by system shm (the tool's POSIX
    regions), c = 1 and 4 by CUDA shm (the tool's regions, mapped with
    cudaIPC), c = 4 by wire traced; at -b 1, c = 1 and 8, through
    the dynamic batcher; open loop at half of c = 1's and of c = 8's
    infer/s; ``bert_large`` bf16 at -b 32, c = 1 (to compare
    with the transport phase); ``longctx_tpu`` base bf16 (8 flash launches
    per forward) at -b 4, c = 1 and 4, by CUDA shm, and by wire traced at
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
            # c = 1 by wire and by the tool's system regions, in the short
            # window; c = 1 and 4 by its CUDA regions, in the long one; c =
            # 4 by wire is the traced run below (c = 4 untraced cut to make
            # room, PERF.md)
            for shm, levels, window in (
                    ("none", "1", PERF_WINDOW_MS),
                    ("system", "1", PERF_WINDOW_MS),
                    ("cuda", "1:4:3", PERF_LONG_WINDOW_MS)):
                perf_sweep(f"perf bert_large int8 -b 32 {shm}", harness,
                           bert, ["-b", "32", "--concurrency-range", levels,
                                  "--shared-memory", shm], counters, 0,
                           layers, window_ms=window)
            levels = perf_sweep(
                "perf bert_large int8 -b 1 dynamic batching", harness, bert,
                ["-b", "1", "--concurrency-range", "1:8:7"], counters, 0,
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
        # by wire the traced runs below are the levels (the untraced sweep
        # cut to make room, PERF.md)
        perf_sweep("perf longctx_tpu bf16 -b 4 cuda", harness, longctx,
                   ["-b", "4", "--concurrency-range", "1:4:3",
                    "--shared-memory", "cuda"], counters,
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


def _beside_http(label: str, *http_labels: str) -> None:
    """Each level of the gRPC run ``label`` beside the same concurrency of
    this run's HTTP runs ``http_labels`` (the first that has it)."""
    http_levels = {}
    for http_label in reversed(http_labels):
        http_levels.update({r["concurrency"]: (http_label, r)
                            for r in PERF_LEVELS[http_label]})
    for res in PERF_LEVELS[label]:
        if res["concurrency"] not in http_levels:
            continue
        http_label, h = http_levels[res["concurrency"]]
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
    and 4 with CUDA shm and by wire, unary -b 32
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
                _beside_http(label, f"perf bert_large int8 -b 32 {shm}",
                             "perf bert_large int8 -b 32 none c=4 traced")
            label = "perf grpc unary bert_large int8 -b 32 none"
            perf_sweep(label, harness, bert,
                       ["-i", "grpc", "-b", "32", "--concurrency-range", "1"],
                       counters, 0, layers, window_ms=PERF_WINDOW_MS,
                       paths=GRPC_PATHS)
            _beside_http(label, "perf bert_large int8 -b 32 none")
            label = "perf grpc stream longctx_tpu bf16 -b 4 none"
            perf_sweep(label, harness, longctx,
                       ["-i", "grpc", "--streaming", "-b", "4",
                        "--concurrency-range", "1"], counters,
                       longctx.transformer.cfg.n_layers, 0, paths=GRPC_PATHS)
            _beside_http(label, "perf longctx_tpu bf16 -b 4 none c=1 traced")
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
# each traced COMPUTE span within this share of its own execution's
# CUDA-event time, and their median within it of the CUDA-event forward on
# an idle card; live MFU within it of counted FLOPs / forward time / peak;
# the served requests with observability on at most this much slower than
# off
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


def _obs_fresh_dir() -> None:
    """An empty OBS_DIR: the trace files are appended to and the PROFILE
    window's directory is globbed, so an earlier run's files left in the
    checkout would be read as this run's."""
    import shutil

    shutil.rmtree(OBS_DIR, ignore_errors=True)
    os.makedirs(OBS_DIR)


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


@contextlib.contextmanager
def _obs_executions(model):
    """``model``'s executions timed from outside the core while the block
    runs: ``model.execute`` wrapped in two CUDA events of its own.  Yields
    a list that gets each execution's host start (``time.monotonic_ns``,
    the trace spans' clock) and its two events."""
    import torch

    runs = []
    execute = model.execute

    def timed(inputs, params):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.monotonic_ns()
        start.record()
        out = execute(inputs, params)
        end.record()
        runs.append((t0, start, end))
        return out

    model.execute = timed
    try:
        yield runs
    finally:
        del model.execute


def _obs_check_traces(label: str, path: str, fwd_ms: float, runs,
                      batched: bool):
    """Every traced request has a REQUEST root with QUEUE, COMPUTE and
    D2H_TRANSFER children (and BATCH_ASSEMBLY where batched); each COMPUTE
    span holds the start of one execution of ``runs`` (see
    :func:`_obs_executions`) and is within OBS_TOL of that execution's own
    CUDA-event time; the median COMPUTE is within OBS_TOL of the
    CUDA-event forward on an idle card.  Returns the COMPUTE ms, or None
    where a COMPUTE or the median is not within it."""
    records = []
    with open(path) as f:
        for line in f:
            if line.strip():
                records.append(json.loads(line))
    if not records:
        fail(f"{label}: no traced request in {path}")
    runs = sorted((t0, start.elapsed_time(end)) for t0, start, end in runs)
    computes, own = [], []
    for rec in records:
        names = [(s["name"], s["parent"]) for s in rec["spans"]]
        want = [("REQUEST", None)] + [(n, "REQUEST") for n in (
            "DECODE", "QUEUE", *(("BATCH_ASSEMBLY",) if batched else ()),
            "COMPUTE", "D2H_TRANSFER", "SERIALIZE", "NETWORK_WRITE")]
        if names != want:
            fail(f"{label}: a traced request's spans are {names}, "
                 f"expected {want}")
        span = next(s for s in rec["spans"] if s["name"] == "COMPUTE")
        ms = next((ms for t0, ms in runs
                   if span["start_ns"] <= t0 <= span["end_ns"]), None)
        if ms is None:
            fail(f"{label}: traced request {rec['id']}'s COMPUTE span "
                 f"[{span['start_ns']}, {span['end_ns']}] holds the start "
                 "of no execution of the model")
        computes.append((span["end_ns"] - span["start_ns"]) / 1e6)
        own.append(ms)
    offs = [abs(c - m) / m for c, m in zip(computes, own)]
    worst = max(offs)
    ranked = sorted(computes)
    median = ranked[len(ranked) // 2]
    med_off = abs(median - fwd_ms) / fwd_ms
    spread = max(abs(c - fwd_ms) / fwd_ms for c in computes)
    print(f"{label}: {len(records)} traced requests, each a REQUEST root "
          f"with {' '.join(n for n, _ in want[1:])}; COMPUTE "
          f"{ranked[0]:.3f}-{ranked[-1]:.3f} ms (median {median:.3f}, p90 "
          f"{ranked[int(0.9 * (len(ranked) - 1))]:.3f}); each against its "
          f"own execution's CUDA events: worst {worst:.2%} (the "
          f"{offs.index(worst) + 1}th traced request); the median against "
          f"the CUDA-event forward on an idle card {fwd_ms:.3f} ms: "
          f"{med_off:.1%} (bounds {OBS_TOL:.0%}); the farthest execution "
          f"from that forward {spread:.1%}; {CARD}", flush=True)
    if not (worst <= OBS_TOL and med_off <= OBS_TOL):
        print(f"{label}: a traced COMPUTE is {worst:.1%} off its execution, "
              f"the median {med_off:.1%} off the forward", flush=True)
        return None
    return computes


def _obs_traced_sweep(label: str, harness, model, counters, rows: int,
                      flash: int, int8: int, fwd_ms: float):
    """One traced :func:`_obs_sweep`, its executions timed from outside
    the core, whose spans :func:`_obs_check_traces` holds, run once more
    on a miss (HOST_GATE_RUNS): the sweep's result."""
    for run in range(1, HOST_GATE_RUNS + 1):
        with _obs_executions(model) as runs:
            res, path = _obs_sweep(label, harness, model, counters, rows,
                                   flash, int8, True, PERF_WINDOW_MS)
        if _obs_check_traces(label, path, fwd_ms, runs,
                             batched=True) is not None:
            return res
    fail(f"{label}: a traced COMPUTE is more than {OBS_TOL:.0%} off its "
         f"execution, or their median off the forward, in {HOST_GATE_RUNS} "
         "runs")


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

    _obs_fresh_dir()
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


def obs_spread_main(sweeps: int) -> int:
    """``chip_smoke.py --obs-spread N``: the observability phase's traced
    ``longctx_tpu`` sweep N times, each held by :func:`_obs_check_traces`
    and, beside it, by the rule the phase held before (every execution
    within OBS_TOL of the CUDA-event forward on an idle card).  Each
    layer's end is marked on both clocks; for an execution beyond that
    rule, the host's and the card's times at each layer's end are printed
    beside their medians: a host that issued late shows as card times that
    follow the host's, a slow card as a host that stays ahead."""
    import statistics

    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    sys.path.insert(0, REPO)
    global CARD, PEAK_BF16_FLOPS, PEAK_BYTES_PER_S
    from triton_client_tpu_torch.models import language
    from triton_client_tpu_torch.models import transformer as tr
    from triton_client_tpu_torch.ops import _build
    from triton_client_tpu_torch.server.costs import peak_bytes_per_s
    from triton_client_tpu_torch.server.device_stats import peak_flops

    PEAK_BF16_FLOPS, PEAK_BYTES_PER_S = peak_flops(), peak_bytes_per_s()
    CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    _build.build()
    counters = {n: importlib.import_module(f"triton_client_tpu_torch.ops.{n}")
                for n in ("flash_attention", "int8_matmul")}
    marks = []
    ffn = tr._ffn_apply

    def marked(*args, **kw):
        out = ffn(*args, **kw)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        marks.append((time.monotonic_ns(), end))
        return out

    _obs_fresh_dir()
    layers = language.longctx_cfg("cuda").n_layers
    os.environ.update(TRITON_TPU_QUANT_LONGCTX_TPU="int8",
                      TRITON_TPU_INT8_FUSED="all")
    label = "obs spread longctx_tpu int8 all"
    model = language.make_longctx_tpu("cuda")
    old_misses = new_misses = 0
    gc.collect()
    gc.freeze()
    tr._ffn_apply = marked
    try:
        with serving_harness([model]) as harness:
            _warm(harness, model, 4)
            x = _obs_served_equal(label, harness, model, 4,
                                  SERVED_ATOL[("longctx_tpu", True)])
            fwd_ms = _obs_forward_ms(torch, model, x)
            for sweep in range(1, sweeps + 1):
                marks.clear()
                with _obs_executions(model) as runs:
                    _, path = _obs_sweep(label, harness, model, counters, 4,
                                         layers, 2 * layers, True,
                                         PERF_WINDOW_MS)
                new_misses += _obs_check_traces(label, path, fwd_ms, runs,
                                                batched=True) is None
                layer_times = []
                for i, (t0, start, end) in enumerate(runs):
                    t1 = runs[i + 1][0] if i + 1 < len(runs) else None
                    layer_times.append((start.elapsed_time(end), [
                        ((ns - t0) / 1e6, start.elapsed_time(ev))
                        for ns, ev in marks
                        if t0 <= ns and (t1 is None or ns < t1)]))
                far = [(ms, at) for ms, at in layer_times
                       if abs(ms - fwd_ms) > OBS_TOL * fwd_ms]
                old_misses += bool(far)
                full = [at for _, at in layer_times if len(at) == layers]
                median = [tuple(statistics.median(at[j][k] for at in full)
                                for k in (0, 1))
                          for j in range(layers if full else 0)]
                print(f"{label} sweep {sweep}: {len(runs)} executions, "
                      f"{len(far)} beyond {OBS_TOL:.0%} of the forward on "
                      f"an idle card {fwd_ms:.3f} ms; host / card ms at "
                      "each layer's end, the median: " + "; ".join(
                          f"{h:.2f}/{c:.2f}" for h, c in median), flush=True)
                for ms, at in far:
                    print(f"  an execution of {ms:.3f} ms "
                          f"({ms / fwd_ms - 1:+.1%}): " + "; ".join(
                              f"{h:.2f}/{c:.2f}" for h, c in at), flush=True)
    finally:
        tr._ffn_apply = ffn
        gc.unfreeze()
        for var in ("TRITON_TPU_QUANT_LONGCTX_TPU", "TRITON_TPU_INT8_FUSED"):
            os.environ.pop(var, None)
    print(f"{label}: {sweeps} sweeps; the rule held before missed "
          f"{old_misses}, the phase's gate {new_misses}; {CARD}", flush=True)
    return 0


# ---------------------------------------------------------------------------
# The host's view: the sampling profiler, the incident bundles and OTLP
# export (server/profiler.py, server/incident.py, otlp.py)
# ---------------------------------------------------------------------------

#: "<path>" -> the kernel launches of that host-view run
HOST_PATHS = {}
HOST_DIR = os.path.join(REPO, "build", "chip_smoke_host")
#: the sampler at its default rate may cost the c = 4 sweep at most this
#: share of mean latency against hz = 0 (observability's cost bound)
HOST_COST_TOL = 0.10
HOST_WINDOW_MS = 3000
#: the cost gate: one c = 4 run this long, the sampler turned off and on
#: every slot, and the requests each arm must hold at the least
HOST_COST_WINDOW_MS = 16000
HOST_COST_SLOT_S = 1.0
HOST_COST_MIN_REQUESTS = 20
#: requests sent with the OTLP exporters on (the server's and the client's)
HOST_OTLP_REQUESTS = 16
#: every file of a complete incident bundle
BUNDLE_FILES = (
    "manifest.json", "profile.folded", "threads.txt", "profiler.json",
    "flight_recorder.json", "device_stats.json", "costs.json",
    "memory.json", "metrics.txt", "trace_tail.jsonl", "config.json",
    "incident.json")


def _incident_dir(name: str) -> str:
    """An empty directory for one server's incident bundles."""
    import shutil

    path = os.path.join(HOST_DIR, name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def _bundles(path: str, trigger: str = "") -> list:
    """The bundles of ``trigger`` (of every trigger where empty) in
    ``path``, oldest first."""
    try:
        return sorted(os.path.join(path, e) for e in os.listdir(path)
                      if e.startswith("incident-")
                      and e.endswith(f"-{trigger}" if trigger else ""))
    except OSError:
        return []


def _bundle_kinds(path: str) -> list:
    """Each bundle's trigger in ``path``, oldest first."""
    return [os.path.basename(b).split("-", 4)[4] for b in _bundles(path)]


def _wait_bundle(label: str, path: str, trigger: str,
                 timeout_s: float = 60.0) -> str:
    """The first bundle of ``trigger`` to appear in ``path``."""
    end = time.monotonic() + timeout_s
    while not _bundles(path, trigger):
        if time.monotonic() > end:
            fail(f"{label}: no {trigger} bundle in {path} after "
                 f"{timeout_s:g} s")
        time.sleep(0.1)
    return _bundles(path, trigger)[0]


def _check_bundle(label: str, bundle: str, trigger: str,
                  reason: str) -> dict:
    """A complete bundle of ``trigger`` whose reason holds ``reason``:
    every file there, none failed in the manifest, a profile captured.
    Returns its manifest."""
    with open(os.path.join(bundle, "manifest.json")) as f:
        manifest = json.load(f)
    missing = [n for n in BUNDLE_FILES
               if not os.path.isfile(os.path.join(bundle, n))]
    failed = [f for f in manifest["files"] if "error" in f]
    with open(os.path.join(bundle, "profile.folded")) as f:
        folded = f.read()
    if missing or failed or manifest["trigger"] != trigger or \
            reason not in manifest["reason"] or not folded.strip():
        fail(f"{label}: bundle {bundle}: missing {missing}, failed "
             f"{failed}, trigger {manifest['trigger']!r}, reason "
             f"{manifest['reason']!r}, profile {len(folded)} bytes")
    print(f"{label}: {trigger} bundle {os.path.basename(bundle)} complete "
          f"({len(manifest['files'])} files, none failed, "
          f"{len(folded.splitlines())} folded stacks); reason "
          f"{manifest['reason']!r}", flush=True)
    return manifest


def _incidents_written(families: dict, trigger: str) -> float:
    return _metric_sum(families, "nv_host_incident_total", trigger=trigger,
                       outcome="written")


def _check_counted(label: str, families: dict, trigger: str,
                   want: int = 1) -> None:
    got = _incidents_written(families, trigger)
    if got != want:
        fail(f"{label}: nv_host_incident_total{{trigger={trigger!r},"
             f"outcome=\"written\"}} reads {got:g}, expected {want}")


def _report(label: str, incident_dir: str, trigger: str) -> None:
    """``python -m triton_client_tpu_torch.tools.incident_report --latest``
    renders the newest bundle and names its trigger."""
    proc = subprocess.run(
        [sys.executable, "-m", "triton_client_tpu_torch.tools."
         "incident_report", "--latest", incident_dir], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=120)
    if proc.returncode != 0 or f"trigger:  {trigger}" not in proc.stdout:
        fail(f"{label}: incident_report exited {proc.returncode}: "
             f"{proc.stdout[-1500:]} {proc.stderr[-1500:]}")
    print(f"{label}: incident_report --latest renders it "
          f"({len(proc.stdout.splitlines())} lines, trigger {trigger})",
          flush=True)


def _top_stacks(label: str, profiler, roles, n: int = 5) -> None:
    """The profiler's ``n`` hottest stacks of each role, their last four
    frames."""
    for role in roles:
        for r, stack, count in profiler.top_stacks(n, role=role):
            frames = stack.split(";")
            tail = ";".join(frames[-4:])
            print(f"{label}: [{r}] {count:>5}  "
                  f"{'...;' if len(frames) > 4 else ''}{tail}", flush=True)


def _host_profile_checks(label: str, harness, before: dict) -> None:
    """/v2/debug/profile after the sweep: the forward's frames under the
    batcher or the frontend, every request thread under frontend, samples
    grown per role, the frontend's lag probe and the GC pauses on
    /metrics; the top five stacks per role and the lag printed."""
    port = harness.http_port
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/v2/debug/profile", timeout=60) as r:
        text = r.read().decode()
    stacks = []
    for line in text.splitlines():
        stack, _, count = line.rpartition(" ")
        role, _, frames = stack.partition(";")
        stacks.append((role, frames, int(count)))
    forward = [s for s in stacks if s[0] in ("batcher", "frontend")
               and "transformer.py:" in s[1]]
    requests = [s for s in stacks
                if "socketserver.py:process_request_thread" in s[1]]
    misread = [s for s in requests if s[0] != "frontend"]
    gc.collect()  # at least one collection with the callback in place
    after = _metrics(port)
    grown = {role: _metric_sum(after, "nv_host_profile_samples_total",
                               role=role)
             - _metric_sum(before, "nv_host_profile_samples_total",
                           role=role)
             for role in ("frontend", "batcher")}
    lag = [v for lab, v in after.get("nv_host_loop_lag_us", {})
           .get("samples", []) if lab.get("loop") == "frontend"]
    pauses = after.get("nv_host_gc_pause_us_total", {}).get("samples", [])
    print(f"{label}: /v2/debug/profile {len(stacks)} stacks, "
          f"{sum(s[2] for s in forward)} samples in the forward "
          f"(transformer.py) under batcher/frontend, {len(requests)} "
          f"request-thread stacks ({len(misread)} not frontend); samples "
          f"grown {grown}; frontend lag max "
          f"{lag[0] if lag else float('nan'):.0f} us; GC pauses "
          f"{[(lab['generation'], round(v)) for lab, v in pauses]} us; "
          f"{CARD}", flush=True)
    if not forward or not requests or misread:
        fail(f"{label}: forward stacks {len(forward)}, request threads "
             f"{len(requests)}, misread {misread[:3]}")
    if min(grown.values()) <= 0 or not lag or not pauses:
        fail(f"{label}: samples grown {grown}, lag {lag}, pauses {pauses}")
    _top_stacks(label, harness.core.profiler,
                ("frontend", "batcher", "other"))


def _host_arms(splits, flips, stop_ns):
    """The server's requests split by the sampler's state: ``flips`` is
    [(perf_counter_ns, on)] in order, each state holding until the next
    flip (the last until ``stop_ns``).  A request counts in its slot's arm
    where it began and ended inside that slot; one that spans a flip
    counts in neither.  Returns {"on": [...], "off": [...]} of the
    requests' server times in ms, and each arm's seconds."""
    import bisect

    starts = [t for t, _ in flips]
    ends = starts[1:] + [stop_ns]
    arms = {"on": [], "off": []}
    seconds = {"on": 0.0, "off": 0.0}
    for (t0, on), t1 in zip(flips, ends):
        seconds["on" if on else "off"] += (t1 - t0) / 1e9
    for sp in splits:
        if not sp.forward_done_ns:
            continue
        done = sp.forward_done_ns + sp.output * 1e6
        began = done - sp.total * 1e6
        i = bisect.bisect_right(starts, began) - 1
        if i >= 0 and done < ends[i]:
            arms["on" if flips[i][1] else "off"].append(sp.total)
    return arms, seconds


def _host_cost(label: str, harness, model, counters, layers: int):
    """The sampler's cost: one perf_analyzer -b 4 c = 4 run, untraced (a
    trace's callbacks on every launch are host work no served request
    does), while this process turns the sampler off and on at its default
    rate every HOST_COST_SLOT_S seconds (``set_hz``); each request the
    server began and answered inside one slot counts in that slot's arm,
    so a host that slows down or stalls for a while weighs on both arms
    alike.  The on arm's mean server time at most HOST_COST_TOL above the
    off arm's (the run read once more on a miss, HOST_GATE_RUNS).
    Returns the run's result."""
    import numpy as np

    profiler = harness.core.profiler
    hz = profiler.hz
    args = ["-b", "4", "--concurrency-range", "4"]
    before = _metrics(harness.http_port)
    for run in range(1, HOST_GATE_RUNS + 1):
        flips, stop = [], threading.Event()

        def flip():
            on = False
            while True:
                profiler.set_hz(hz if on else 0)
                flips.append((time.perf_counter_ns(), on))
                if stop.wait(HOST_COST_SLOT_S):
                    return
                on = not on

        flipper = threading.Thread(target=flip, name="host-cost-flips")
        flipper.start()
        try:
            run_label = f"{label} profiler off and {hz:g} Hz (run {run})"
            (res,), launches, executions, splits = _perf_analyzer(
                run_label, harness, model, args, counters,
                HOST_COST_WINDOW_MS, False)
        finally:
            stop.set()
            flipper.join(timeout=60)
            stop_ns = time.perf_counter_ns()
            profiler.set_hz(hz)
        check_launches(run_label, launches, len(executions), layers, 0)
        HOST_PATHS[run_label] = launches
        if res["errors"]:
            fail(f"{run_label}: {res['errors']} errors, first "
                 f"{res['first_error']}")
        arms, seconds = _host_arms(splits, flips, stop_ns)
        if min(len(v) for v in arms.values()) < HOST_COST_MIN_REQUESTS:
            fail(f"{run_label}: {len(arms['off'])} requests inside off "
                 f"slots and {len(arms['on'])} inside on slots (at least "
                 f"{HOST_COST_MIN_REQUESTS} each)")

        def arm(name):
            v = np.asarray(arms[name])
            return (f"{len(v)} requests in {seconds[name]:.1f} s, mean "
                    f"{v.mean():.3f} ms, p50 {np.percentile(v, 50):.3f} ms, "
                    f"p99 {np.percentile(v, 99):.3f} ms")

        slower = (float(np.mean(arms["on"])) / float(np.mean(arms["off"]))
                  - 1)
        print(f"{run_label}: {res['throughput']:.3f} infer/s, client p50 "
              f"{res['p50_us'] / 1e3:.3f} ms, p99 "
              f"{res['p99_us'] / 1e3:.3f} ms over the window; "
              f"{len(flips)} slots of {HOST_COST_SLOT_S:g} s; server time "
              f"(decode to response built) with the sampler off: "
              f"{arm('off')}; at {hz:g} Hz: {arm('on')}; "
              f"{len(splits) - len(arms['on']) - len(arms['off'])} "
              f"requests spanned a flip; the on arm's mean {slower:+.1%} "
              f"against the off arm's (bound +{HOST_COST_TOL:.0%}); {CARD}",
              flush=True)
        if slower <= HOST_COST_TOL:
            break
        if run == HOST_GATE_RUNS:
            fail(f"{label}: the sampler at {hz:g} Hz is {slower:.1%} "
                 f"slower in {run} runs")
        print(f"{label}: the sampler's cost above the bound: once more",
              flush=True)
    _host_profile_checks(label, harness, before)
    return res


def _host_bundle(label: str, harness, model, counters, layers: int,
                 plain) -> None:
    """POST /v2/debug/incident inside the window of a c = 4 sweep: the
    bundle complete, its profile, device statistics and costs naming the
    model with its executions, incident_report rendering it; its write
    time printed, and the sweep's p99 beside the run without a bundle."""
    port, core = harness.http_port, harness.core
    out = {}

    def poke():
        st = model.stats
        n0 = st.execution_count
        end = time.monotonic() + 120
        while st.execution_count < n0 + 8 and time.monotonic() < end:
            time.sleep(0.02)
        time.sleep(1.0)  # inside the window, past the tool's warm-up
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v2/debug/incident",
            data=json.dumps({"reason": "chip smoke c = 4 sweep"}).encode(),
            method="POST")
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                out["answer"] = (r.status, json.loads(r.read()))
        except OSError as e:
            out["answer"] = (None, repr(e))
        out["write_s"] = time.perf_counter() - t0
        out["at"] = t0

    th = threading.Thread(target=poke, daemon=True)
    th.start()
    (res,), _ = _perf_sweep_once(
        f"{label} profiler on, a bundle in the window", harness, model,
        ["-b", "4", "--concurrency-range", "4"], counters, layers, 0,
        HOST_WINDOW_MS, False, HOST_PATHS)
    th.join(timeout=180)
    status, answer = out.get("answer", (None, "no answer"))
    if status != 200 or answer.get("status") != "written":
        fail(f"{label}: POST /v2/debug/incident answered {status} {answer}")
    if not res["window_start_s"] <= out["at"] <= res["window_end_s"]:
        print(f"{label}: the bundle's request fell outside the window",
              flush=True)
    bundle = answer["bundle"]
    _check_bundle(label, bundle, "manual", "chip smoke")
    with open(os.path.join(bundle, "device_stats.json")) as f:
        execs = json.load(f)["models"].get(model.name, {}).get(
            "executions", 0)
    with open(os.path.join(bundle, "costs.json")) as f:
        costs = json.load(f)["models"].get(model.name, {})
    if not execs or not costs:
        fail(f"{label}: the bundle's device_stats name {model.name} with "
             f"{execs} executions, its costs {costs}")
    _report(label, core.incidents.dir, "manual")
    print(f"{label}: the bundle took {out['write_s']:.3f} s to write (a "
          f"{core.incidents.profile_window_s:g} s capture at "
          f"{core.incidents.profile_hz:g} Hz, then the snapshots); "
          f"device_stats names {model.name} with {execs} executions; the "
          f"sweep's p99 {res['p99_us'] / 1e3:.3f} ms with the bundle, "
          f"{plain['p99_us'] / 1e3:.3f} ms without; infer/s "
          f"{res['throughput']:.3f} against {plain['throughput']:.3f}; "
          f"{CARD}", flush=True)
    _check_counted(label, _metrics(port), "manual")


class _Collector:
    """A stub OTLP/HTTP collector: an ``http.server`` thread that keeps
    every POST's JSON body."""

    def __init__(self):
        import http.server

        bodies = self.bodies = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                bodies.append(json.loads(self.rfile.read(n)))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *args):
                pass

        self.srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"127.0.0.1:{self.srv.server_address[1]}"
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()

    def posts(self, service: str) -> list:
        return [b for b in self.bodies
                if b["resourceSpans"][0]["resource"]["attributes"][0]
                ["value"]["stringValue"] == service]

    def close(self) -> None:
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=10)


def _host_otlp(label: str, harness, model, counters, layers: int) -> None:
    """The server with ``enable_otlp``, the client with
    ``telemetry().enable_otlp``, HOST_OTLP_REQUESTS traced requests: the
    collector holds each one's server spans, whose root is the child of the
    client's REQUEST span on one trace id; nv_otlp_export_total{ok}
    equals the server's posts that arrived, nv_otlp_dropped_total 0."""
    import numpy as np

    from triton_client_tpu_torch import http
    from triton_client_tpu_torch._telemetry import telemetry

    port, core = harness.http_port, harness.core
    collector = _Collector()
    tel = telemetry()
    core.enable_otlp(collector.url, replica="chip-smoke")
    exporter = tel.enable_otlp(collector.url)
    client = _client(port)
    cfg = model.config.input[0]
    x = np.zeros([1] + list(cfg.dims), np.int32)
    st = model.stats
    try:
        client.update_trace_settings(settings={
            "trace_file": [os.path.join(HOST_DIR, "otlp-trace.jsonl")],
            "trace_level": ["TIMESTAMPS"], "trace_rate": ["1"]})
        _reset(counters)
        execs0 = st.execution_count
        for i in range(HOST_OTLP_REQUESTS):
            inp = http.InferInput(cfg.name, list(x.shape), cfg.data_type)
            inp.set_data_from_numpy(x)
            client.infer(model.name, [inp], request_id=f"otlp-{i}")
        execs = st.execution_count - execs0
        launches = {name: mod.launches for name, mod in counters.items()}
        launches["int8_quantize_rows"] = \
            counters["int8_matmul"].quantize_launches
        client.update_trace_settings(settings={"trace_level": ["OFF"]})
        if not (exporter.flush(30) and core.tracer.otlp.flush(30)):
            fail(f"{label}: an OTLP exporter did not drain")
        fams = _metrics(port)
        counts = core.tracer.otlp.counters()
    finally:
        client.close()
        tel.disable_otlp()
        otlp, core.tracer.otlp = core.tracer.otlp, None
        if otlp is not None:
            otlp.shutdown()
        collector.close()
    check_launches(f"{label} otlp", launches, execs, layers, 0)
    HOST_PATHS[f"{label} otlp"] = launches
    spans = [s for body in collector.bodies
             for rs in body["resourceSpans"] for ss in rs["scopeSpans"]
             for s in ss["spans"]]
    clients = {s["spanId"]: s for s in spans if s["kind"] == 3}
    roots = [s for s in spans if s["kind"] == 2 and any(
        a["key"] == "triton.request_id"
        and a["value"]["stringValue"].startswith("otlp-")
        for a in s.get("attributes", []))]
    joined = [r for r in roots if r.get("parentSpanId") in clients
              and clients[r["parentSpanId"]]["traceId"] == r["traceId"]]
    server_posts = len(collector.posts("triton-tpu-server"))
    ok = _metric_sum(fams, "nv_otlp_export_total", outcome="ok")
    dropped = _metric_sum(fams, "nv_otlp_dropped_total")
    print(f"{label}: OTLP: {HOST_OTLP_REQUESTS} requests, {len(roots)} "
          f"server roots at the collector, {len(joined)} joined to their "
          f"client REQUEST span on one trace id; {len(spans)} spans in "
          f"{len(collector.bodies)} posts ({server_posts} the server's); "
          f"nv_otlp_export_total{{ok}} {ok:g}, dropped {dropped:g}, "
          f"errors {counts['error']}; {CARD}", flush=True)
    if len(roots) != HOST_OTLP_REQUESTS or len(joined) != len(roots):
        fail(f"{label}: OTLP: {len(roots)} server roots, {len(joined)} "
             f"joined, of {HOST_OTLP_REQUESTS} requests")
    if ok != server_posts or dropped or counts["error"] or \
            counts["ok"] != server_posts:
        fail(f"{label}: OTLP: ok {ok:g} against {server_posts} posts, "
             f"dropped {dropped:g}, {counts}")


def host_view_phase(torch, counters) -> None:
    """The host's view on the card: ``longctx_tpu`` base bf16 (8 flash
    launches a forward) and ``bert_large`` int8 ``w2`` at
    ``BERT_SERVE_LAYERS`` (one int8 launch a layer) served together;
    perf_analyzer -b 4 c = 4 with the sampler off and at its default rate
    (the cost gate), /v2/debug/profile, a manual bundle inside a sweep's
    window, a bert_large sweep, and OTLP export of traced requests to a
    stub collector in this process."""
    import shutil

    from triton_client_tpu_torch.models import language

    shutil.rmtree(HOST_DIR, ignore_errors=True)
    os.makedirs(HOST_DIR)
    for var, val in (("TRITON_TPU_QUANT_BERT_LARGE", "int8"),
                     ("TRITON_TPU_INT8_FUSED", "w2")):
        os.environ[var] = val
    try:
        with bert_depth(BERT_SERVE_LAYERS):
            longctx = language.make_longctx_tpu("cuda")
            bert = language.make_bert_large("cuda")
            label = "host longctx_tpu bf16"
            with serving_harness([longctx, bert]) as harness:
                core = harness.core
                core.incidents.dir = _incident_dir("host")
                _warm(harness, longctx, 4)
                _warm(harness, bert, 8)
                check_precision(label, longctx.transformer, False)
                check_precision("host bert_large int8", bert.transformer,
                                True)
                layers = longctx.transformer.cfg.n_layers
                t0 = time.perf_counter()
                on = _host_cost(label, harness, longctx, counters, layers)
                t1 = time.perf_counter()
                _host_bundle(label, harness, longctx, counters, layers, on)
                t2 = time.perf_counter()
                blabel = "host bert_large int8 w2"
                _perf_sweep_once(
                    f"{blabel} -b 8 c = 2", harness, bert,
                    ["-b", "8", "--concurrency-range", "2"], counters, 0,
                    bert.transformer.cfg.n_layers, PERF_WINDOW_MS, False,
                    HOST_PATHS)
                t3 = time.perf_counter()
                _host_otlp(label, harness, longctx, counters, layers)
                print(f"host: the cost gate {t1 - t0:.1f} s, the bundle "
                      f"{t2 - t1:.1f} s, bert_large {t3 - t2:.1f} s, OTLP "
                      f"{time.perf_counter() - t3:.1f} s", flush=True)
                _no_regions_left(label, harness)
            del longctx, bert
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        for var in ("TRITON_TPU_QUANT_BERT_LARGE", "TRITON_TPU_INT8_FUSED"):
            os.environ.pop(var, None)


# ---------------------------------------------------------------------------
# Overload: QoS tiers, the memory governor, deadlines, chaos and drain
# ---------------------------------------------------------------------------

#: "<path>" -> the kernel launches of that overload run
OVERLOAD_PATHS = {}
# the two classes' c = 16 windows (6 s before the cut that made room for
# the cluster and cache phase, PERF.md)
OVERLOAD_WINDOW_MS = 4000
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
    core.incidents.dir = _incident_dir("overload")
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
    # the first draw's bundle (the class's later draws are rate-limited)
    core.incidents.wait()
    bundle = _wait_bundle(f"{label} mem_pressure", core.incidents.dir,
                          "chaos")
    _check_bundle(f"{label} mem_pressure", bundle, "chaos",
                  f"mem_pressure on {model.name}")
    fams = _metrics(harness.http_port)
    _check_counted(f"{label} mem_pressure", fams, "chaos")
    held = _metric_sum(fams, "nv_host_incident_total", trigger="chaos",
                       outcome="suppressed")
    print(f"{label}: the server's bundles {_bundle_kinds(core.incidents.dir)}"
          f"; later chaos draws rate-limited {held:g}", flush=True)
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
        records, stop, hold = [], threading.Event(), threading.Event()
        lock, open_ = threading.Lock(), [0]

        def client():
            while not stop.is_set():
                if hold.is_set():
                    time.sleep(0.005)
                    continue
                with lock:
                    open_[0] += 1
                t0 = time.perf_counter()
                try:
                    status, retry_after = post()
                except OSError:
                    return  # the listener closed
                finally:
                    with lock:
                        open_[0] -= 1
                records.append((t0, time.perf_counter(), status,
                                retry_after))
                if status != 200:
                    time.sleep(0.02)

        threads = [threading.Thread(target=client, daemon=True)
                   for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(1.0)
        # the signal comes once every request the clients have open is
        # admitted: no new one is sent while the server's pending count
        # (admitted, not yet answered) is read against the open ones, so a
        # request sent just before the signal cannot reach admission after
        # it and be counted in flight
        hold.set()
        end = time.monotonic() + 30
        while True:
            with lock:
                n_open = open_[0]
            pending = sum(_cf_metrics(
                port, ["nv_inference_pending_request_count"],
                "longctx_tpu").values())
            with lock:
                # none answered while the count was read
                settled = open_[0] == n_open
            if n_open and settled and pending >= n_open:
                break
            if time.monotonic() > end:
                fail(f"{label}: {n_open} requests open, {pending:g} "
                     "admitted on the server")
            if not n_open:  # all answered meanwhile: let them send again
                hold.clear()
                time.sleep(0.1)
                hold.set()
            time.sleep(0.005)
        t_sig = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        hold.clear()
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
#: the generation phase's weights, chains and prompts, for the next phase
GEN_SHARED = {}
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


def _gen_chain(torch, dec, prompt: bytes, n: int, s_max: int = GEN_S_MAX,
               params=None):
    """The independent chain (``make_prefill`` + greedy ``make_decode_step``
    on the card): the first ``n`` greedy tokens of ``prompt``, with each
    position's logits (``params`` in place of the model's where given)."""
    from triton_client_tpu_torch.models import decode

    own, cfg = dec._ensure_params()
    params = own if params is None else params
    prefill = decode.make_prefill(cfg, s_max)
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
    return decode.reference_forward(params, seq, cfg)[
        0, len(prompt) - 1:].float()


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


def _gen_near_ties(label, torch, dec, chains, prompt, toks,
                   atol=None) -> bool:
    """A served stream equals the independent chain's tokens, or parts from
    it where the chain's logits had a near tie (both tokens within the
    bound of the maximum, SERVED_ATOL's unless ``atol`` is given; a batch
    of another size rounds its bf16 GEMMs otherwise).  Returns whether it
    equals the chain."""
    want, logits = chains[prompt]
    want = want[:len(toks)]
    if toks == want:
        return True
    if len(toks) != len(want):
        fail(f"{label}: {len(toks)} tokens, expected {len(want)}")
    j = next(i for i, (a, b) in enumerate(zip(toks, want)) if a != b)
    row = logits[j]
    top = float(row.max())
    atol = SERVED_ATOL["llama_tpu", False] if atol is None else atol
    if not (float(row[toks[j]]) >= top - atol
            and float(row[want[j]]) >= top - atol):
        fail(f"{label}: token {j} is {toks[j]}, the chain's is {want[j]}, "
             f"and the chain's logits {float(row[toks[j]]):.4f} / "
             f"{float(row[want[j]]):.4f} (max {top:.4f}) are no near tie")
    return False


def _sse_stream(port: int, prompt: bytes, n: int,
                model: str = "llama_generate"):
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
        conn.request("POST", f"/v2/models/{model}/generate_stream",
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


def _grpc_gen_stream(port: int, prompt: bytes, n: int, final=None):
    """``llama_generate`` on one gRPC-Web stream of the port's client:
    (token ids, seconds from the request to each response); the final
    response's parameters into ``final`` where given."""
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
            params = result.get_response().parameters
            if params["triton_final_response"].bool_param:
                if final is not None:
                    final.update({k: v for k, v in params.items()})
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
    gRPC-Web stream at 1 and 8 streams of 64 tokens (independent mode's
    gRPC-Web stream at 1), llama_decode closed
    loop for 1 sequence, every stream's tokens held to the independent
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
                    # independent mode serves 8 streams one request's work
                    # at a time; its 8-stream window is read over SSE only
                    # (cut to make room for the last phase, PERF.md)
                    for n in ((1,) if (mode, surface) == ("independent",
                                                          "grpc-web")
                              else (1, GEN_STREAMS)):
                        _gen_streams(f"{label} {surface} {n} stream(s)",
                                     torch, dec, counters, chains, fn, port,
                                     prompts[:n])
                _gen_closed_loop(f"{label} llama_decode http", torch, dec,
                                 chains, port, prompts[:1])
                # one stream where each is served alone, the batch of 8
                # where they share the tick
                _gen_idle_share(f"{label} http sse", torch, _sse_stream,
                                port, prompts[:1 if mode == "independent"
                                              else GEN_STREAMS])
                # where the decode step's host time went: the always-on
                # profiler's hottest stacks of the decode worker (batched)
                # and of the request threads (independent mode decodes on
                # them), a reading
                _top_stacks(f"{label} host profile",
                            harness.core.profiler, ("decode", "frontend"))
            del dec, gen_model
            gc.collect()
        print("generation: BASELINE row 5 through ensemble_llama read "
              "30.35 / 30.51 tokens/s on one stream in earlier runs "
              "(PERF.md); this run's reading is in its gRPC phase",
              flush=True)
    finally:
        for var in ("TRITON_TPU_DECODE_MODE", "TRITON_TPU_DECODE_SLOTS"):
            os.environ.pop(var, None)
    # the weights, chains and prompts go on to the cache and faults phase
    GEN_SHARED.update(params=params, chains=chains, prompts=prompts)
    gc.collect()
    if GEN_DEVICE == "cuda":
        torch.cuda.empty_cache()

# ---------------------------------------------------------------------------
# The cache and faults phase: the prefix/KV cache, int8 KV and device-fault
# containment on llama 1b (llama_decode / llama_generate)
# ---------------------------------------------------------------------------

#: a 1,024-token prompt in 64-token blocks: the store holds 15 of its 16
#: (120 MiB in bf16); the budget holds the four prompts' chains
CF_PROMPT_LEN, CF_TOKENS = 1024, 8
CF_CACHE_BYTES = 512 << 20
#: int8 KV against bf16 KV, NEXT_LOGIT on the card (stated in PERF.md
#: before the first chip run), its teacher-forced steps and controls (the
#: post-prefill int8 scales of k and v off by each of CONTROL_SCALES)
CF_KV8_ATOL = 1e-1
CF_KV8_STEPS = 32
CF_KV8_TOKENS = 32
#: the transient drill's live streams and their length
CF_DRILL_STREAMS, CF_DRILL_TOKENS = 6, 64
#: the real stall: --tick-stall-ms, and how long the card sleeps
CF_STALL_MS, CF_STALL_S = 250, 1.5
#: the persistent drill's first probe (the checks run before it)
CF_PROBE_BACKOFF_S = 2.0
CF_PATHS = {}
#: the SM clock (nvidia-smi), to turn the stall's seconds into cycles
SM_CLOCK_HZ = 0.0


def _cf_prompts(seed: int, n: int, length: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [bytes(rng.integers(32, 127, length).astype(np.uint8))
            for _ in range(n)]


@contextlib.contextmanager
def _cf_env(**env):
    """The decode models' environment for one step, removed after."""
    for k, v in env.items():
        os.environ[k] = str(v)
    try:
        yield
    finally:
        for k in env:
            os.environ.pop(k, None)


def _cf_launches(label, counters, paths=None) -> None:
    """The launches since the counters were zeroed, kept in ``paths``
    (CF_PATHS by default); generation launches no kernel of the port."""
    launches = {name: mod.launches for name, mod in counters.items()}
    launches["int8_quantize_rows"] = counters["int8_matmul"].quantize_launches
    (CF_PATHS if paths is None else paths)[label] = launches
    if any(launches.values()):
        fail(f"{label}: the port's kernels launched {launches}; generation "
             "runs none")


#: the prefix/KV cache's and device faults' /metrics families
CF_CACHE_FAMILIES = ("nv_cache_hit_total", "nv_cache_miss_total",
                     "nv_cache_evict_total", "nv_cache_hit_tokens_total",
                     "nv_cache_pinned_bytes")
CF_FAULT_FAMILIES = ("nv_device_fault_total",
                     "nv_device_recovered_sequences_total",
                     "nv_device_aborted_sequences_total",
                     "nv_device_quarantine")


def _cf_metrics(port: int, names, model: str) -> dict:
    """``/metrics`` samples of the families ``names`` for ``model``, by
    family and label set."""
    fams = _metrics(port)
    out = {}
    for name in names:
        if name not in fams:
            fail(f"/metrics lacks the family {name}")
        for labels, value in fams[name]["samples"]:
            if labels.get("model") == model:
                key = name + "".join(f",{k}={v}" for k, v in sorted(
                    labels.items()) if k != "model")
                out[key] = value
    return out


def _cf_block_lane_equal(torch, dec, kvc, window) -> list:
    """The slots whose lane holds the stored chain of ``window`` byte for
    byte (k and v, positions 0 .. hit)."""
    digs = kvc.chain_digests(window)
    with kvc._lock:
        blocks = [kvc._blocks.get(d) for d in digs]
    if any(b is None for b in blocks):
        fail(f"the store lacks the chain of a committed prompt "
             f"({sum(b is None for b in blocks)} of {len(blocks)} blocks)")
    kb = torch.cat([b.k for b in blocks], dim=3)
    vb = torch.cat([b.v for b in blocks], dim=3)
    n = kb.shape[3]
    return [s for s in range(dec._buckets[0][0])
            if torch.equal(dec._k[0][:, s:s + 1, :, :n], kb)
            and torch.equal(dec._v[0][:, s:s + 1, :, :n], vb)]


def _cf_forced_rows(torch, params, cfg, prompt: bytes, toks, s_max: int):
    """The logits rows of the independent chain fed ``toks`` (teacher
    forcing): row i chose token i."""
    from triton_client_tpu_torch.models import decode

    prefill = decode.make_prefill(cfg, s_max)
    step = decode.make_decode_step(cfg)
    logits, cache = prefill(params, _gen_window(torch, prompt))
    rows = [logits[0].float()]
    for tok in toks[:-1]:
        logits, cache = step(params, cache, torch.tensor(
            [[tok]], dtype=torch.int32, device=GEN_DEVICE))
        rows.append(logits[0].float())
    return torch.stack(rows).cpu().numpy()


def _cf_prefix(torch, params, counters) -> None:
    """Cold then warm on shared 1,024-token prompts: over HTTP SSE and
    gRPC-Web, and a llama_decode sequence (NEXT_LOGIT).  The stored blocks
    equal the lane the cold prefill wrote; the lanes are wrecked (NaN)
    before the warm stream, whose lane must then hold the blocks again,
    byte for byte.  Tokens equal the independent chain or part at a near
    tie; the warm NEXT_LOGIT within SERVED_ATOL of the plain recompute,
    beside the controls.  Time to the first token cold and warm, the hit
    tokens, ``nv_cache_*`` and ``kv_cache``."""
    import numpy as np

    from triton_client_tpu_torch import http
    from triton_client_tpu_torch.models import decode
    from triton_client_tpu_torch.server import kvcache

    label = "cache prefix"
    with _cf_env(TRITON_TPU_DECODE_MODE="batched",
                 TRITON_TPU_DECODE_SLOTS=GEN_SLOTS,
                 **{kvcache.cache_env_key("llama_decode"): CF_CACHE_BYTES}):
        dec = decode.DecodeModel(device=GEN_DEVICE, prompt_len=CF_PROMPT_LEN)
        dec._params = params
        gen_model = decode.make_llama_generate(dec)
        p_warm, p_sse, p_grpc, p_dec = _cf_prompts(12, 4, CF_PROMPT_LEN)
        with torch.inference_mode():
            chains = {p: _gen_chain(torch, dec, p, CF_TOKENS, dec._s_max)
                      for p in (p_sse, p_grpc, p_dec)}
        try:
            with serving_harness([dec.model, gen_model]) as harness:
                port = harness.http_port
                # a throwaway prompt cold and warm: the first use of each
                # path's shapes (cuBLAS heuristics, lazily loaded kernels)
                # stays out of the timed ones
                for _ in range(2):
                    _sse_stream(port, p_warm, 2)
                _reset(counters)
                kvc = dec._kv_cache
                if kvc is None or kvc.block_tokens != 64:
                    fail(f"{label}: no 64-token block store on the model")
                ttft = {}
                for surface, prompt in (("http sse", p_sse),
                                        ("grpc-web", p_grpc)):
                    win = np.frombuffer(prompt, np.uint8).astype(np.int32)
                    finals = []
                    for temp in ("cold", "warm"):
                        if temp == "warm":
                            # every lane's prompt positions wrecked: the
                            # warm stream must restore them itself
                            dec._k[0][:, :, :, :CF_PROMPT_LEN] = float("nan")
                            dec._v[0][:, :, :, :CF_PROMPT_LEN] = float("nan")
                        final = {}
                        if surface == "http sse":
                            toks, times = _sse_stream(port, prompt,
                                                      CF_TOKENS)
                        else:
                            toks, times = _grpc_gen_stream(
                                port, prompt, CF_TOKENS, final=final)
                        finals.append(final.get("cache_hit_tokens"))
                        ttft[surface, temp] = 1e3 * times[0]
                        same = _gen_near_ties(f"{label} {surface} {temp}",
                                              torch, dec, chains, prompt,
                                              toks)
                        lanes = _cf_block_lane_equal(torch, dec, kvc, win)
                        if not lanes:
                            fail(f"{label} {surface} {temp}: no lane holds "
                                 "the stored blocks byte for byte")
                        print(f"{label} {surface} {temp}: {CF_TOKENS} "
                              f"tokens, first after {ttft[surface, temp]:.3f}"
                              f" ms; equal to the chain: {same}; stored "
                              f"blocks byte-equal (torch.equal) to lane(s) "
                              f"{lanes}; {CARD}", flush=True)
                    if surface == "grpc-web":
                        hit = finals[1].int64_param if finals[1] else None
                        if finals[0] is not None or hit != 960:
                            fail(f"{label}: cache_hit_tokens cold "
                                 f"{finals[0]}, warm {hit}; expected none "
                                 "and 960")
                # llama_decode, cold then warm: a sequence fed the chain's
                # tokens, so each step's NEXT_LOGIT meets the chain's row
                want_toks, want_logits = chains[p_dec]
                got = []
                with http.InferenceServerClient(
                        f"127.0.0.1:{port}", network_timeout=300) as client:
                    for sid in (1, 2):
                        x = np.frombuffer(p_dec, np.uint8).astype(np.int32)
                        for i in range(CF_TOKENS):
                            inp = http.InferInput("TOKENS", [len(x)],
                                                  "INT32")
                            inp.set_data_from_numpy(x)
                            res = client.infer(
                                "llama_decode", [inp], sequence_id=sid,
                                sequence_start=i == 0,
                                sequence_end=i == CF_TOKENS - 1)
                            got.append((i, res))
                            x = np.array([want_toks[i]], np.int32)
                rows_np = [r.cpu().numpy() for r in want_logits]
                errs = [abs(float(r.as_numpy("NEXT_LOGIT")[0])
                            - float(rows_np[i].max())) for i, r in got]
                check_tokens(f"{label} llama_decode cold, warm",
                             [r.as_numpy("NEXT_TOKEN") for _i, r in got],
                             [rows_np[i] for i, _r in got],
                             SERVED_ATOL["llama_tpu", False])
                with torch.inference_mode():
                    controls = []
                    for sc in CONTROL_SCALES:
                        ctl = _cf_forced_rows(
                            torch, control_params(torch, params[0], sc),
                            params[1], p_dec, want_toks, dec._s_max)
                        controls.append(max(
                            abs(float(r.as_numpy("NEXT_LOGIT")[0])
                                - float(ctl[i].max())) for i, r in got))
                check_served(f"{label} llama_decode",
                             f"NEXT_LOGIT of 2 x {CF_TOKENS} steps (cold, "
                             "warm)", SERVED_ATOL["llama_tpu", False],
                             max(errs), float(np.mean(errs)), controls,
                             float(np.mean([abs(float(r.max()))
                                            for r in rows_np])))
                _cf_launches(label, counters)
                rows = _cf_metrics(port, CF_CACHE_FAMILIES, "llama_decode")
                snap = json.loads(urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/v2/debug/device_stats",
                    timeout=60).read())["kv_cache"]["llama_decode"]
                want_hits = 4     # the throwaway's, two streams', a sequence's
                if (rows.get("nv_cache_hit_total") != want_hits
                        or rows.get("nv_cache_hit_tokens_total")
                        != 960 * want_hits
                        or snap["hits"] != want_hits
                        or snap["pinned_bytes"] != rows.get(
                            "nv_cache_pinned_bytes")):
                    fail(f"{label}: /metrics {rows}, kv_cache {snap}; "
                         f"expected {want_hits} hits of 960 tokens")
                per_tok = dec._kv_bytes_per_token()
                print(f"{label}: time to the first token cold / warm: "
                      + "; ".join(
                          f"{s} {ttft[s, 'cold']:.3f} / {ttft[s, 'warm']:.3f}"
                          f" ms ({ttft[s, 'cold'] / ttft[s, 'warm']:.2f}x)"
                          for s in ("http sse", "grpc-web"))
                      + f"; hit 960 of {CF_PROMPT_LEN} tokens; /metrics "
                      f"{rows}; kv_cache {snap}; {per_tok} bytes a token "
                      f"projected; {CARD}", flush=True)
        finally:
            dec._shutdown()


def _cf_kv8_steps(torch, decode, params, cfg, win, k, v, toks):
    """Teacher-forced slot steps on one slot's cache ``k`` / ``v`` (bf16
    or an int8 pair), fed ``toks``: each step's logits row."""
    blocks = decode._layer_blocks(params, cfg)
    dev = win.device
    rows = []
    for i, tok in enumerate(toks):
        pos = torch.tensor([win.shape[1] + i], dtype=torch.int32, device=dev)
        act = torch.ones(1, dtype=torch.bool, device=dev)
        t = torch.tensor([tok], dtype=torch.int32, device=dev)
        k, v, logits = decode._slot_forward(params, blocks, k, v, t, pos,
                                            act, cfg)
        rows.append(logits[0].float())
    return torch.stack(rows)


def _cf_int8(torch, params, chains, prompts, counters) -> None:
    """TRITON_TPU_KV_QUANT=int8, batched, 8 slots: the slab's bytes by
    ``torch.cuda.memory_allocated`` against ``_kv_bytes_per_token``'s
    projection; CF_KV8_STEPS teacher-forced steps over an int8 cache
    against a bf16 one (NEXT_LOGIT within CF_KV8_ATOL, tokens equal or a
    near tie), beside the controls; 8 served streams at once, each held
    to the bf16 chain at that bound."""
    import numpy as np

    from triton_client_tpu_torch.models import decode

    label = "cache int8 kv"
    p, cfg = params
    with _cf_env(TRITON_TPU_DECODE_MODE="batched",
                 TRITON_TPU_DECODE_SLOTS=GEN_SLOTS,
                 TRITON_TPU_KV_QUANT="int8"):
        dec = decode.DecodeModel(device=GEN_DEVICE)
        dec._params = params
        gen_model = decode.make_llama_generate(dec)
        try:
            if GEN_DEVICE == "cuda":
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
            dec._ensure_fns()
            if GEN_DEVICE == "cuda":
                torch.cuda.synchronize()
                grown = torch.cuda.memory_allocated() - before
            else:
                grown = float("nan")
            exact = sum(t.numel() * t.element_size()
                        for c in dec._k + dec._v for t in c.values())
            tokens = sum(cnt * cap for cnt, cap in dec._buckets)
            per_tok = dec._kv_bytes_per_token()
            if dec._k[0]["q"].dtype != torch.int8:
                fail(f"{label}: the slab is not int8")
            print(f"{label}: slab of {tokens} token positions: "
                  f"torch.cuda.memory_allocated grew {grown} bytes "
                  f"({grown / tokens:.1f} a token); the pairs hold {exact} "
                  f"({exact // tokens} a token); _kv_bytes_per_token "
                  f"projects {per_tok} a token ({tokens * per_tok} bytes), "
                  f"{exact / (tokens * per_tok):.5f}x of it; bf16 would be "
                  f"{2 * per_tok}; {CARD}", flush=True)
            prompt = prompts[0]
            with torch.inference_mode():
                win = _gen_window(torch, prompt)
                want, _logits = chains[prompt]
                feed = want[:CF_KV8_STEPS]
                kb, vb = (torch.zeros((cfg.n_layers, 1, cfg.n_heads,
                                       GEN_S_MAX, cfg.head_dim),
                                      dtype=cfg.dtype, device=GEN_DEVICE)
                          for _ in range(2))
                k8, v8 = dec._new_cache_arrays(1, GEN_S_MAX, cfg)
                pre = decode.make_slot_prefill(cfg)
                _, bb, _, kb, vb = pre(p, kb, vb, win, 0)
                _, b8, _, k8, v8 = pre(p, k8, v8, win, 0)
                k8c = {n: t.clone() for n, t in k8.items()}
                v8c = {n: t.clone() for n, t in v8.items()}
                ref = _cf_kv8_steps(torch, decode, p, cfg, win, kb, vb, feed)
                got = _cf_kv8_steps(torch, decode, p, cfg, win, k8, v8, feed)
                err = (got.amax(-1) - ref.amax(-1)).abs().cpu().numpy()
                controls = []
                for sc in CONTROL_SCALES:
                    kc = {"q": k8c["q"].clone(), "s": k8c["s"] * sc}
                    vc = {"q": v8c["q"].clone(), "s": v8c["s"] * sc}
                    ctl = _cf_kv8_steps(torch, decode, p, cfg, win, kc, vc,
                                        feed)
                    controls.append(float(
                        (ctl.amax(-1) - ref.amax(-1)).abs().max()))
                plain = list(ref.cpu().numpy())
            caught = [s for s, c in zip(CONTROL_SCALES, controls)
                      if c > CF_KV8_ATOL]
            print(f"{label}: NEXT_LOGIT of prefill ({abs(float(b8 - bb)):.3e})"
                  f" + {CF_KV8_STEPS} steps, int8 KV vs bf16 KV: max_abs_err "
                  f"{float(err.max()):.3e} (atol {CF_KV8_ATOL}), mean "
                  f"{float(err.mean()):.3e}; controls (k and v scales x"
                  + ", x".join(f"{s}: {c:.3e}"
                               for s, c in zip(CONTROL_SCALES, controls))
                  + f"), caught from x{caught[0] if caught else None}; "
                  f"{CARD}", flush=True)
            if not err.max() <= CF_KV8_ATOL:
                fail(f"{label}: int8 KV's NEXT_LOGIT beyond {CF_KV8_ATOL}")
            if not controls[-1] > CF_KV8_ATOL:
                fail(f"{label}: the control x{CONTROL_SCALES[-1]} reads "
                     f"{controls[-1]:.3e}, within the bound")
            check_tokens(f"{label} steps", [int(r.argmax()) for r in
                                            got.cpu().numpy()], plain,
                         CF_KV8_ATOL)
            with serving_harness([dec.model, gen_model]) as harness:
                port = harness.http_port
                _sse_stream(port, b"warm-up", 2)
                _reset(counters)
                results = [None] * GEN_STREAMS
                errors = []

                def run(i):
                    try:
                        results[i] = _sse_stream(port, prompts[i],
                                                 CF_KV8_TOKENS)
                    except BaseException as e:  # reported below
                        errors.append(repr(e))

                threads = [threading.Thread(target=run, args=(i,))
                           for i in range(GEN_STREAMS)]
                t0 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=600)
                wall = time.perf_counter() - t0
                if errors or any(r is None for r in results):
                    fail(f"{label}: streams failed: {errors}")
                equal = sum(_gen_near_ties(f"{label} served", torch, dec,
                                           chains, prompts[i], r[0],
                                           atol=CF_KV8_ATOL)
                            for i, r in enumerate(results))
                _cf_launches(label, counters)
                print(f"{label}: {GEN_STREAMS} x {CF_KV8_TOKENS} tokens in "
                      f"{wall:.3f} s, {GEN_STREAMS * CF_KV8_TOKENS / wall:.2f}"
                      f" tokens/s together; {equal} of {GEN_STREAMS} equal "
                      f"to the bf16 chain (the rest part at a near tie "
                      f"within {CF_KV8_ATOL}); {CARD}", flush=True)
        finally:
            dec._shutdown()


def _cf_device_stall(torch, seconds: float) -> None:
    """Queue a kernel that spins ``seconds`` of SM clocks on the current
    stream (the decode worker's too): a real wedge of the card."""
    torch.cuda._sleep(int(seconds * SM_CLOCK_HZ))


def _cf_ready(port: int, model: str):
    """Model readiness over HTTP and over gRPC-Web."""
    from triton_client_tpu_torch import grpc

    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/v2/models/{model}/ready",
                timeout=60) as r:
            http_ready = r.status == 200
    except urllib.error.HTTPError:
        http_ready = False
    with grpc.InferenceServerClient(f"127.0.0.1:{port}") as c:
        return http_ready, c.is_model_ready(model)


def _cf_refusals(label, port: int, prompt: bytes) -> str:
    """A quarantined model's refusals: llama_decode over HTTP (503,
    Retry-After, the marker the retry layer reads) and over gRPC-Web
    (UNAVAILABLE), and a generate_stream (503)."""
    import numpy as np

    from triton_client_tpu_torch import grpc, http
    from triton_client_tpu_torch._resilience import is_quarantine_error

    x = np.frombuffer(prompt, np.uint8).astype(np.int32)
    raw = json.dumps({"inputs": [{"name": "TOKENS", "shape": [len(x)],
                                  "datatype": "INT32",
                                  "data": x.tolist()}],
                      "parameters": {"sequence_id": 77,
                                     "sequence_start": True,
                                     "sequence_end": True}}).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v2/models/llama_decode/infer", data=raw,
        headers={"Content-Type": "application/json"})
    try:
        urllib.request.urlopen(req, timeout=60)
        fail(f"{label}: a quarantined llama_decode answered 200")
    except urllib.error.HTTPError as e:
        status, retry_after, body = e.code, e.headers.get("Retry-After"), \
            e.read().decode()
    if status != 503 or retry_after is None or "quarantined" not in body:
        fail(f"{label}: HTTP refusal {status}, Retry-After {retry_after}, "
             f"{body}")
    with http.InferenceServerClient(f"127.0.0.1:{port}") as c:
        inp = http.InferInput("TOKENS", [len(x)], "INT32")
        inp.set_data_from_numpy(x)
        try:
            c.infer("llama_decode", [inp], sequence_id=78,
                    sequence_start=True, sequence_end=True)
            fail(f"{label}: a quarantined llama_decode answered")
        except Exception as e:  # noqa: BLE001 - classified below
            if not is_quarantine_error(e):
                fail(f"{label}: the port's HTTP client read {e!r}, not a "
                     "quarantine refusal")
    with grpc.InferenceServerClient(f"127.0.0.1:{port}") as c:
        inp = grpc.InferInput("TOKENS", [len(x)], "INT32")
        inp.set_data_from_numpy(x)
        try:
            c.infer("llama_decode", [inp], sequence_id=79,
                    sequence_start=True, sequence_end=True)
            fail(f"{label}: a quarantined llama_decode answered on gRPC")
        except Exception as e:  # noqa: BLE001 - classified below
            if not is_quarantine_error(e) or \
                    e.status() != "StatusCode.UNAVAILABLE":
                fail(f"{label}: gRPC-Web refusal {e!r}")
    sse = urllib.request.Request(
        f"http://127.0.0.1:{port}/v2/models/llama_generate/generate_stream",
        data=json.dumps({"text_input": "x", "max_tokens": 2}).encode(),
        headers={"Content-Type": "application/json"})
    try:
        urllib.request.urlopen(sse, timeout=60)
        fail(f"{label}: a quarantined llama_generate streamed")
    except urllib.error.HTTPError as e:
        if e.code != 503:
            fail(f"{label}: generate_stream refusal {e.code}")
    return f"HTTP 503 Retry-After {retry_after} s, gRPC-Web UNAVAILABLE"


def _cf_wait(pred, timeout_s: float, what: str) -> float:
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout_s:
            fail(f"timed out after {timeout_s} s waiting for {what}")
        time.sleep(0.005)
    return time.perf_counter()


def _cf_faults(torch, params, chains, prompts, counters) -> None:
    """Device faults on llama 1b, batched, 8 slots, over one server: a
    persistent device_error at threshold 3 (quarantine: 503 with pushback
    and the marker, not ready on both frontends; then the core's probe
    releases it), a seeded transient device_error against live streams
    (zero caller errors, every stream recovered, no quarantine), and a
    real stall of the card under --tick-stall-ms (quarantined while stuck,
    released once it drains)."""
    import numpy as np

    from triton_client_tpu_torch.models import decode
    from triton_client_tpu_torch.server.chaos import ChaosInjector

    label = "faults"
    with _cf_env(TRITON_TPU_DECODE_MODE="batched",
                 TRITON_TPU_DECODE_SLOTS=GEN_SLOTS):
        dec = decode.DecodeModel(device=GEN_DEVICE)
        dec._params = params
        gen_model = decode.make_llama_generate(dec)
        stall = decode.DecodeModel(name="llama_decode_stall",
                                   device=GEN_DEVICE)
        stall._params = params
        stall_gen = decode.GenerateModel(stall, name="llama_generate_stall")
    try:
        with serving_harness([dec.model, gen_model, stall.model,
                              stall_gen.model]) as harness:
            port, core = harness.http_port, harness.core
            core.incidents.dir = _incident_dir("faults")
            faults = core.device_faults
            faults.threshold, faults.window_s = 3, 30.0
            faults.probe_backoff_s = CF_PROBE_BACKOFF_S
            _sse_stream(port, b"warm-up", 2)
            with _cf_env(TRITON_TPU_TICK_STALL_MS=CF_STALL_MS):
                _sse_stream(port, b"warm-up", 2,
                            model="llama_generate_stall")
            _reset(counters)

            # -- persistent: three faults in the window ------------------
            core.chaos = ChaosInjector(rate=1.0, kinds=["device_error"],
                                       seed=7, max_faults=3,
                                       models=["llama_decode"])
            t0 = time.perf_counter()
            toks, _times = _sse_stream(port, prompts[0], 16)
            _gen_near_ties(f"{label} persistent", torch, dec, chains,
                           prompts[0], toks)
            if not (faults.is_quarantined("llama_decode")
                    and faults.is_quarantined("llama_generate")):
                fail(f"{label}: three faults did not quarantine "
                     f"{faults.snapshot()}")
            ready = [_cf_ready(port, m) for m in ("llama_decode",
                                                  "llama_generate")]
            if any(any(r) for r in ready):
                fail(f"{label}: quarantined but ready {ready}")
            refused = _cf_refusals(label, port, prompts[1])
            snap = faults.snapshot()
            t_rel = _cf_wait(lambda: not any(
                faults.is_quarantined(m) for m in ("llama_decode",
                                                   "llama_generate")),
                30.0, "the probe's release")
            ready_after = [_cf_ready(port, m) for m in ("llama_decode",
                                                        "llama_generate")]
            if not all(all(r) for r in ready_after):
                fail(f"{label}: released but not ready {ready_after}")
            print(f"{label} persistent: {snap['faults']}; quarantined "
                  f"(reason {snap['quarantined']['llama_decode']['reason']!r}"
                  f"); stream of 16 tokens recovered, zero errors; ready "
                  f"false on HTTP and gRPC-Web; refused: {refused}; the "
                  f"probe released both names {t_rel - t0:.3f} s after the "
                  f"stream began (first probe {CF_PROBE_BACKOFF_S} s after "
                  f"the quarantine); ready again on both; {CARD}",
                  flush=True)
            # the first quarantine's bundle (the second name's, inside the
            # class's interval, is rate-limited)
            core.incidents.wait()
            bundle = _wait_bundle(f"{label} persistent", core.incidents.dir,
                                  "device_fault")
            _check_bundle(f"{label} persistent", bundle, "device_fault",
                          "quarantined")
            _check_counted(f"{label} persistent", _metrics(port),
                           "device_fault")

            # -- transient: one fault against live streams ---------------
            core.chaos = None
            dec.attach_chaos(None)
            results = [None] * CF_DRILL_STREAMS
            errors = []

            def run(i):
                try:
                    results[i] = _sse_stream(port, prompts[i],
                                             CF_DRILL_TOKENS)
                except BaseException as e:  # reported below
                    errors.append(repr(e))

            threads = [threading.Thread(target=run, args=(i,))
                       for i in range(CF_DRILL_STREAMS)]
            recovered0 = faults.snapshot()["recovered"].get("llama_decode", 0)
            for t in threads:
                t.start()
            _cf_wait(lambda: len(dec._auto_slots) == CF_DRILL_STREAMS
                     and all(len(i["sink"].emitted) >= 2
                             for i in list(dec._auto_slots.values())),
                     60.0, "every stream live")
            inj = ChaosInjector(rate=1.0, kinds=["device_error"], seed=11,
                                max_faults=1, models=["llama_decode"])
            core.chaos = inj
            dec.attach_chaos(inj)
            for t in threads:
                t.join(timeout=600)
            if errors or any(r is None for r in results):
                fail(f"{label} transient: caller errors {errors}")
            snap = faults.snapshot()
            recovered = snap["recovered"].get("llama_decode", 0) - recovered0
            if inj.injected_total != 1 or recovered < 1 or \
                    faults.is_quarantined("llama_decode"):
                fail(f"{label} transient: injected {inj.injected_total}, "
                     f"recovered {recovered}, {snap}")
            equal = sum(_gen_near_ties(f"{label} transient", torch, dec,
                                       chains, prompts[i], r[0])
                        for i, r in enumerate(results))
            gaps = [np.diff(r[1]) for r in results]
            worst = [1e3 * float(g.max()) for g in gaps]
            typical = 1e3 * float(np.median(np.concatenate(gaps)))
            rows = _cf_metrics(port, CF_FAULT_FAMILIES, "llama_decode")
            print(f"{label} transient: {CF_DRILL_STREAMS} live streams x "
                  f"{CF_DRILL_TOKENS} tokens, one device_error: zero caller "
                  f"errors, {recovered} recovered, not quarantined; {equal} "
                  f"of {CF_DRILL_STREAMS} equal to the chain (the rest part "
                  f"at a near tie); the longest gap between two tokens per "
                  f"stream {', '.join(f'{w:.1f}' for w in worst)} ms "
                  f"against a median gap of {typical:.2f} ms; /metrics "
                  f"{rows}; {CARD}", flush=True)
            core.chaos = None
            dec.attach_chaos(None)

            # -- a real stall of the card --------------------------------
            faults.probe_backoff_s = 0.05
            out = {}

            def stalled():
                try:
                    out["stream"] = _sse_stream(
                        port, prompts[2], CF_TOKENS,
                        model="llama_generate_stall")
                except BaseException as e:  # reported below
                    out["error"] = repr(e)

            t0 = time.perf_counter()
            _cf_device_stall(torch, CF_STALL_S)
            th = threading.Thread(target=stalled)
            th.start()
            t_q = _cf_wait(lambda: faults.is_quarantined(
                "llama_decode_stall"), 30.0, "the watchdog's quarantine")
            stuck = th.is_alive()
            ready = [_cf_ready(port, m) for m in ("llama_decode_stall",
                                                  "llama_generate_stall")]
            reason = faults.snapshot()["quarantined"].get(
                "llama_decode_stall", {}).get("reason", "")
            t_r = _cf_wait(lambda: not any(
                faults.is_quarantined(m) for m in ("llama_decode_stall",
                                                   "llama_generate_stall")),
                30.0, "the release after the stall")
            th.join(timeout=120)
            if "error" in out or "stream" not in out:
                fail(f"{label} stall: the stalled stream failed: {out}")
            _gen_near_ties(f"{label} stall", torch, stall, chains,
                           prompts[2], out["stream"][0])
            if not stuck or any(any(r) for r in ready) or \
                    "cannot be killed" not in reason:
                fail(f"{label} stall: stuck {stuck}, ready {ready}, "
                     f"reason {reason!r}")
            if t_r - t0 < 0.8 * CF_STALL_S:
                fail(f"{label} stall: released {t_r - t0:.3f} s in, before "
                     f"the {CF_STALL_S} s stall drained")
            if faults.is_quarantined("llama_decode"):
                fail(f"{label} stall: the other model was quarantined")
            _cf_launches(label, counters)
            print(f"{label} stall: the card slept {CF_STALL_S} s "
                  f"(torch.cuda._sleep) ahead of a stream's prefill; "
                  f"quarantined {t_q - t0:.3f} s in (--tick-stall-ms "
                  f"{CF_STALL_MS}) while stuck, not ready on both frontends; "
                  f"released by the probe {t_r - t0:.3f} s in, once the "
                  f"card drained; the stream finished with its tokens; "
                  f"{CARD}", flush=True)
    finally:
        dec._shutdown()
        stall._shutdown()


def cache_faults_phase(torch, counters) -> None:
    """The prefix/KV cache, int8 KV and device-fault containment on llama
    1b (the generation phase's weights, chains and prompts): cold and warm
    1,024-token prompts, an int8-KV cohort of 8 slots, and the three fault
    drills.  No kernel of the port runs here."""
    # the weights stay for the OpenAI phase
    params = GEN_SHARED["params"]
    chains = GEN_SHARED.pop("chains")
    prompts = GEN_SHARED.pop("prompts")
    try:
        for step, fn, args in (
                ("prefix cache", _cf_prefix, (torch, params, counters)),
                ("int8 kv", _cf_int8, (torch, params, chains, prompts,
                                       counters)),
                ("device faults", _cf_faults, (torch, params, chains,
                                               prompts, counters))):
            t0 = time.perf_counter()
            fn(*args)
            gc.collect()
            print(f"cache and faults: {step} took "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        del params
        gc.collect()
        if GEN_DEVICE == "cuda":
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The OpenAI, genai_perf and repository phase: the /v1 routes and genai_perf
# on llama 1b (llama_generate / llama_decode, batched, 8 slots), and a
# longctx_tpu-base model loaded from a model repository
# ---------------------------------------------------------------------------

#: "openai <path>" / "genai_perf <path>" / "repository <path>" -> launches
OAI_PATHS = {}
#: greedy /v1 answers and the stop case, tokens; the n = 8 cohorts (the
#: seeded ones at OAI_N_TOKENS, cut from 16 to make room)
OAI_TOKENS, OAI_N, OAI_N_TOKENS, OAI_BEST_OF = 64, 8, 8, 4
#: the second reading of the first chunk streams this many tokens
OAI_TTFT_TOKENS = 8
#: a warm 1,024-token prompt: 15 of its 16 64-token blocks come from the
#: prefix cache
OAI_CACHED_TOKENS = 960
#: genai_perf: (endpoint, model, concurrency, requests) at GENAI_TOKENS
GENAI_TOKENS = 64
#: (one request at c = 1: cut from 2 to make room)
GENAI_RUNS = (("generate", "llama_generate", 1, 1),
              ("generate", "llama_generate", 8, 8),
              ("stream", "llama_decode", 1, 1),
              ("stream", "llama_decode", 4, 4))
#: genai_perf's itl_steady against an independent reading of it
#: (``_genai_own``) and against (request latency - TTFT) / (tokens - 1) of
#: its own report: the reference test's 35%
GENAI_ITL_TOL = 0.35
#: the repository's longctx_tpu-base model: each version's seed
REPO_SEEDS = {1: 101, 2: 202}
REPO_MODEL = "longctx_repo"
#: device memory after an unload against before the load
REPO_MEM_TOL = 2 << 20
REPO_DIR = os.path.join(REPO, "build", "chip_smoke_repo")

_REPO_MODEL_PY = '''
import torch

from triton_client_tpu_torch.models import language
from triton_client_tpu_torch.server.model import (TorchModel,
                                                  resolve_instance_device)

SEED = {seed}


def get_model(config):
    dev = resolve_instance_device(config)
    cfg = language.longctx_cfg(dev)
    run = language.LazyTransformer(cfg, seed=SEED, device=dev,
                                   model_name=config.name)

    def fn(TOKENS):
        tokens = torch.clamp(TOKENS, 0, cfg.vocab_size - 1)
        return {{"LOGPROBS": language.longctx_scores(run(tokens), tokens)}}

    model = TorchModel(config, fn)
    model.transformer = run
    return model
'''


def _oai_request(port: int, path: str, body: dict, stream: bool = False,
                 status: int = 200):
    """One OpenAI request over HTTP/1.1 (the standard library's client: the
    v2 clients have no OpenAI API): the JSON body and its seconds, or where
    ``stream`` the SSE frames and each one's seconds from the request.  An
    answer of another status than ``status`` fails the run."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        t0 = time.perf_counter()
        conn.request("POST", path, body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != status:
            fail(f"{path} answered {resp.status}, expected {status}: "
                 f"{resp.read()!r}")
        if not stream:
            out = json.loads(resp.read())
            return out, time.perf_counter() - t0
        frames, times, done = [], [], False
        while True:
            line = resp.readline()
            if not line:
                break
            if not line.startswith(b"data: "):
                continue
            payload = line[6:].strip()
            if payload == b"[DONE]":
                done = True
                continue
            frame = json.loads(payload)
            if "error" in frame:
                fail(f"{path}: in-band error {frame['error']}")
            frames.append(frame)
            times.append(time.perf_counter() - t0)
        if not done:
            fail(f"{path}: the stream ended without [DONE]")
        return frames, times
    finally:
        conn.close()


def _oai_text(frames, index: int = 0, chat: bool = False) -> str:
    """Choice ``index``'s text of a stream's frames."""
    return "".join(
        (f["choices"][0]["delta"].get("content") or "") if chat
        else (f["choices"][0].get("text") or "")
        for f in frames if f["choices"] and f["choices"][0]["index"] == index)


def _oai_logprobs(frames_or_choice, index: int = 0,
                  chat: bool = False):
    """The chosen-token logprobs of a /v1 answer: a choice of a full body,
    or choice ``index`` of a stream's frames."""
    if isinstance(frames_or_choice, dict):
        parts = [frames_or_choice["logprobs"]]
    else:
        parts = [f["choices"][0]["logprobs"] for f in frames_or_choice
                 if f["choices"] and f["choices"][0]["index"] == index
                 and f["choices"][0].get("logprobs")]
    if chat:
        return [e["logprob"] for p in parts for e in p["content"]]
    return [lp for p in parts for lp in p["token_logprobs"]]


def _oai_hold(label, torch, text: str, lps, toks, rows):
    """A greedy /v1 answer held token by token to ``toks``, what another
    route chose on the same prompt from the same prefix-cache state, and
    ``rows``, the logits that chose them.  While the two agree, each
    character is ``chr(toks[i] % 256)`` (the byte detokenizer's) and each
    logprob is ``toks[i]``'s in its row within SERVED_ATOL, so /v1 chose
    those very tokens.  At the first position where they do not, /v1's
    token is the one of the character's ~500 tokens whose logprob the
    answer reports (within SERVED_ATOL), and it and ``toks[j]`` must both
    lie within SERVED_ATOL of the row's maximum: a near tie.  Past a
    parting the contexts differ and nothing more is compared.  Returns the
    position of the parting, or None where the answer is ``toks``."""
    atol = SERVED_ATOL["llama_tpu", False]
    if not (len(text) == len(lps) == len(toks)):
        fail(f"{label}: {len(text)} characters and {len(lps)} logprobs "
             f"against {len(toks)} tokens")
    for j, (ch, lp, tok) in enumerate(zip(text, lps, toks)):
        row = rows[j].float()
        ls = torch.log_softmax(row, dim=-1)
        if ch == chr(tok % 256) and abs(float(ls[tok]) - lp) <= atol:
            continue
        cand = torch.arange(ord(ch), row.numel(), 256, device=row.device)
        mine = int(cand[int(torch.argmin((ls[cand] - lp).abs()))])
        top = float(row.max())
        if abs(float(ls[mine]) - lp) > atol or not (
                float(row[mine]) >= top - atol
                and float(row[tok]) >= top - atol):
            fail(f"{label}: token {j} is {mine} ({ch!r}, logprob {lp:.4f} "
                 f"served, {float(ls[mine]):.4f} recomputed), the other "
                 f"route's {tok} ({chr(tok % 256)!r}, "
                 f"{float(ls[tok]):.4f}); logits {float(row[mine]):.4f} / "
                 f"{float(row[tok]):.4f} (max {top:.4f}) are no near tie")
        return j
    return None


def _oai_slots_free(label, dec) -> None:
    _cf_wait(lambda: len(dec._free) == GEN_SLOTS, 10,
             f"{label}: every decode slot free")


def _oai_routes(torch, dec, port, counters) -> None:
    """The OpenAI routes on llama_generate (batched, 8 slots, the prefix
    cache on): greedy completions, streamed and not, and n = 8 greedy
    choices held token by token to a warm /generate_stream's tokens (a
    cold one held to the independent chain first), the first chunk against
    generate_stream's, a chat stream's usage and tokens against the chain,
    a stop that ends a stream, n = 16 refused on 8 slots, n = 8 seeded
    (twice), best_of, and cached_tokens on a warm 1,024-token prompt."""
    params, cfg = dec._ensure_params()
    p0, p_chat, p_n, p_cache = _cf_prompts(13, 4, CF_PROMPT_LEN)
    head, tail = "user: ", "\nassistant:"
    chat_content = p_chat[:CF_PROMPT_LEN - len(head) - len(tail)].decode()
    p_chat = (head + chat_content + tail).encode()
    with torch.inference_mode():
        chains = {p: _gen_chain(torch, dec, p, OAI_TOKENS, dec._s_max)
                  for p in (p0, p_chat)}
    label = "openai"
    _reset(counters)
    # generate_stream, cold: the chain's tokens or a near tie; it fills the
    # prefix cache, so every greedy answer below starts warm
    toks, _ = _sse_stream(port, p0, OAI_TOKENS)
    cold_same = _gen_near_ties(f"{label} generate_stream cold", torch, dec,
                               chains, p0, toks)
    # greedy, not streamed
    out, wall1 = _oai_request(port, "/v1/completions", {
        "model": "llama_generate", "prompt": p0.decode(),
        "max_tokens": OAI_TOKENS, "logprobs": True})
    text = out["choices"][0]["text"]
    greedy_lps = _oai_logprobs(out["choices"][0])
    usage = out["usage"]
    if usage["completion_tokens"] != OAI_TOKENS or \
            usage["prompt_tokens"] != CF_PROMPT_LEN or \
            out["choices"][0]["finish_reason"] != "length":
        fail(f"{label}: greedy completion's usage / finish {usage} "
             f"{out['choices'][0]['finish_reason']}")
    if not usage.get("device_time_us", 0) > 0:
        fail(f"{label}: usage carries no device time: {usage}")
    # the first chunk: /v1 streamed against generate_stream, both warm;
    # the warm generate_stream's tokens are what every greedy /v1 answer on
    # this prompt is held to, token by token
    ttft = {"v1": [], "generate_stream": []}
    held = {}
    for n_tok in (OAI_TOKENS, OAI_TTFT_TOKENS):
        frames, times = _oai_request(port, "/v1/completions", {
            "model": "llama_generate", "prompt": p0.decode(),
            "max_tokens": n_tok, "stream": True, "logprobs": True},
            stream=True)
        ttft["v1"].append(1e3 * times[0])
        sse_toks, sse_times = _sse_stream(port, p0, n_tok)
        ttft["generate_stream"].append(1e3 * sse_times[0])
        if n_tok == OAI_TOKENS:
            streamed_s = times[-1]
            warm = sse_toks
            with torch.inference_mode():
                rows = _gen_recompute(torch, params, cfg, p0, warm)
            held["completions"] = _oai_hold(
                f"{label} completions", torch, text, greedy_lps, warm, rows)
        held[f"completions streamed {n_tok}"] = _oai_hold(
            f"{label} completions streamed {n_tok}", torch,
            _oai_text(frames), _oai_logprobs(frames), warm[:n_tok],
            rows[:n_tok])
    warm_same = _gen_near_ties(f"{label} generate_stream warm", torch, dec,
                               chains, p0, warm)
    print(f"{label}: greedy /v1/completions {OAI_TOKENS} tokens in "
          f"{wall1:.3f} s ({OAI_TOKENS / wall1:.2f} tokens/s at n = 1); "
          f"device_time_us {usage['device_time_us']}; {CARD}", flush=True)
    print(f"{label}: time to the first chunk on the warm prompt, /v1 "
          f"streamed {', '.join(f'{t:.2f}' for t in ttft['v1'])} ms, "
          f"generate_stream {', '.join(f'{t:.2f}' for t in ttft['generate_stream'])} ms; "
          f"{OAI_TOKENS} tokens streamed in {streamed_s:.3f} s "
          f"({OAI_TOKENS / streamed_s:.2f} tokens/s); {CARD}", flush=True)
    # a chat stream with include_usage, cold: held to the chain
    frames, times = _oai_request(port, "/v1/chat/completions", {
        "model": "llama_generate",
        "messages": [{"role": "user", "content": chat_content}],
        "max_tokens": OAI_TOKENS, "stream": True, "logprobs": True,
        "stream_options": {"include_usage": True}}, stream=True)
    chat_text = _oai_text(frames, chat=True)
    final = frames[-1]
    if final["choices"] or final["usage"]["completion_tokens"] != \
            len(chat_text) or len(chat_text) != OAI_TOKENS or \
            final["usage"]["prompt_tokens"] != CF_PROMPT_LEN or \
            any(f["usage"] is not None for f in frames[:-1]):
        fail(f"{label}: chat usage {final} against {len(chat_text)} "
             "characters streamed")
    chat_chain, chat_rows = chains[p_chat]
    held["chat against the chain"] = _oai_hold(
        f"{label} chat", torch, chat_text,
        _oai_logprobs(frames, chat=True), chat_chain, chat_rows)
    # a stop sequence that ends a stream early frees its slot
    stop = text[8:10]
    frames, _ = _oai_request(port, "/v1/completions", {
        "model": "llama_generate", "prompt": p0.decode(),
        "max_tokens": OAI_TOKENS, "stop": stop, "stream": True,
        "stream_options": {"include_usage": True}}, stream=True)
    stopped = _oai_text(frames)
    fin = [f["choices"][0]["finish_reason"] for f in frames
           if f["choices"] and f["choices"][0]["finish_reason"]]
    used = frames[-1]["usage"]["completion_tokens"]
    if fin != ["stop"] or stop in stopped or not used < OAI_TOKENS:
        fail(f"{label}: the stop {stop!r} gave finish {fin}, "
             f"{used} tokens, text {stopped!r}")
    _oai_slots_free(f"{label} stop", dec)
    print(f"{label}: stop {stop!r} ended the stream after {used} of "
          f"{OAI_TOKENS} tokens; every slot free", flush=True)
    # n = 16 greedy on 8 slots: the choices beyond them are refused (429),
    # the first refusal cancels the rest, and every slot is free after
    out, _ = _oai_request(port, "/v1/completions", {
        "model": "llama_generate", "prompt": p0.decode(),
        "max_tokens": OAI_TOKENS, "n": 2 * OAI_N}, status=429)
    _oai_slots_free(f"{label} n = {2 * OAI_N}", dec)
    print(f"{label}: n = {2 * OAI_N} on {GEN_SLOTS} slots answered 429 "
          f"({out['error']['message']}); every slot free after", flush=True)
    # n = 8 greedy, streamed, warm: every choice held to the warm
    # generate_stream's tokens
    frames, times = _oai_request(port, "/v1/completions", {
        "model": "llama_generate", "prompt": p0.decode(),
        "max_tokens": OAI_TOKENS, "n": OAI_N, "stream": True,
        "logprobs": True}, stream=True)
    for i in range(OAI_N):
        held[f"n = {OAI_N} choice {i}"] = _oai_hold(
            f"{label} n = {OAI_N} greedy choice {i}", torch,
            _oai_text(frames, i), _oai_logprobs(frames, i), warm, rows)
    print(f"{label}: n = {OAI_N} greedy streams of {OAI_TOKENS} tokens, "
          f"{OAI_N * OAI_TOKENS / times[-1]:.2f} tokens/s together; "
          f"{CARD}", flush=True)
    parted = {k: v for k, v in held.items() if v is not None}
    print(f"{label}: greedy answers held token by token, equal: "
          f"{len(held) - len(parted)} of {len(held)} (the chat to the "
          "independent chain, the rest to the warm generate_stream's "
          f"tokens); parted at a near tie (token index): "
          f"{parted or 'none'}; generate_stream "
          f"equal to the independent chain: cold {cold_same}, warm "
          f"{warm_same}; {CARD}", flush=True)
    _oai_slots_free(f"{label} n = {OAI_N} greedy", dec)
    # n = 8 seeded, streamed, twice: reproducible, every slot free after
    runs = []
    for _ in range(2):
        frames, times = _oai_request(port, "/v1/completions", {
            "model": "llama_generate", "prompt": p_n.decode(),
            "max_tokens": OAI_N_TOKENS, "n": OAI_N, "temperature": 1.0,
            "seed": 5, "stream": True}, stream=True)
        texts = [_oai_text(frames, i) for i in range(OAI_N)]
        if any(len(t) != OAI_N_TOKENS for t in texts):
            fail(f"{label}: n = {OAI_N} choices of "
                 f"{[len(t) for t in texts]} characters")
        runs.append((texts, times[-1]))
        _oai_slots_free(f"{label} n = {OAI_N}", dec)
    if runs[0][0] != runs[1][0]:
        fail(f"{label}: n = {OAI_N} seeded streams differ between runs")
    if len(set(runs[0][0])) < 2:
        fail(f"{label}: n = {OAI_N} seeded choices are all alike")
    print(f"{label}: n = {OAI_N} seeded streams of {OAI_N_TOKENS} tokens "
          f"reproduce; {', '.join(f'{OAI_N * OAI_N_TOKENS / w:.2f}' for _t, w in runs)} "
          f"tokens/s together; every slot free after; {CARD}", flush=True)
    # best_of = 4, n = 1
    out, _ = _oai_request(port, "/v1/completions", {
        "model": "llama_generate", "prompt": p_n.decode(),
        "max_tokens": 16, "n": 1, "best_of": OAI_BEST_OF,
        "temperature": 1.0, "seed": 9})
    if len(out["choices"]) != 1 or \
            out["usage"]["completion_tokens"] != OAI_BEST_OF * 16:
        fail(f"{label}: best_of {OAI_BEST_OF} answered {out}")
    _oai_slots_free(f"{label} best_of", dec)
    # a repeated 1,024-token prompt: the warm one reports cached_tokens
    cold, _ = _oai_request(port, "/v1/completions", {
        "model": "llama_generate", "prompt": p_cache.decode(),
        "max_tokens": 4})
    warm, _ = _oai_request(port, "/v1/completions", {
        "model": "llama_generate", "prompt": p_cache.decode(),
        "max_tokens": 4})
    hit = warm["usage"].get("prompt_tokens_details", {}).get(
        "cached_tokens")
    if "prompt_tokens_details" in cold["usage"] or hit != OAI_CACHED_TOKENS:
        fail(f"{label}: cached_tokens cold {cold['usage']}, warm "
             f"{warm['usage']}; expected {OAI_CACHED_TOKENS} warm")
    print(f"{label}: best_of {OAI_BEST_OF} ranked 1 of "
          f"{out['usage']['completion_tokens']} tokens; the warm "
          f"{CF_PROMPT_LEN}-token prompt reports cached_tokens {hit}",
          flush=True)
    _cf_launches(label, counters, OAI_PATHS)


def _genai_once(label, port, endpoint, model, concurrency, requests):
    """One genai_perf run, a process of its own: its report."""
    out_dir = os.path.join(REPO, "build", "chip_smoke_genai")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"{endpoint}_{model}_c{concurrency}.json")
    cmd = [sys.executable, "-m", "triton_client_tpu_torch.genai_perf",
           "-m", model, "-u", f"127.0.0.1:{port}", "--endpoint", endpoint,
           "--concurrency", str(concurrency), "--output-tokens",
           str(GENAI_TOKENS), "--num-requests", str(requests),
           "--stream-timeout", "120", "--profile-export-file", out]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          cwd=REPO)
    if proc.returncode != 0:
        fail(f"{label}: genai_perf exited {proc.returncode}: "
             f"{proc.stderr.strip()[-2000:]}")
    with open(out) as f:
        return json.load(f)


def _genai_own(label, port, endpoint, concurrency) -> float:
    """An independent reading of what genai_perf's ``itl_steady`` reads,
    on the same server just before it, through other code in a process of
    its own as genai_perf runs in one (a client in the server's process
    would share its interpreter lock): ``chip_smoke.py --genai-own``."""
    spec = json.dumps({"port": port, "endpoint": endpoint,
                       "concurrency": concurrency})
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--genai-own", spec], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    res = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    if proc.returncode != 0 or not res:
        fail(f"{label}: the independent reading exited {proc.returncode}: "
             f"{proc.stdout.strip()[-1000:]} {proc.stderr.strip()[-1000:]}")
    return json.loads(res[-1][7:])["ms"]


def genai_own_main(spec_json: str) -> int:
    """``chip_smoke.py --genai-own SPEC``: ``_genai_own_reading`` of the
    SPEC's port, endpoint and concurrency; prints one ``RESULT`` line."""
    spec = json.loads(spec_json)
    sys.path.insert(0, REPO)
    ms = _genai_own_reading(spec["port"], spec["endpoint"],
                            spec["concurrency"])
    print("RESULT " + json.dumps({"ms": ms}), flush=True)
    return 0


def _genai_own_reading(port, endpoint, concurrency) -> float:
    """At ``concurrency`` at once, one request of GENAI_TOKENS each: its
    time from the first token to the last over the tokens between (ms, the
    mean over requests).  ``generate``: /generate_stream on genai_perf's prompt
    through the standard library's client; ``stream``: the llama_decode
    closed loop on a gRPC-Web stream of the port's client, as genai_perf's
    transport, on a window laid out as genai_perf's (the prompt
    right-aligned in zeros)."""
    import queue

    import numpy as np

    from triton_client_tpu_torch import grpc

    gaps = [None] * concurrency

    def generate(k):
        _toks, times = _sse_stream(port, b"In a hole in the ground",
                                   GENAI_TOKENS)
        gaps[k] = (times[-1] - times[0]) / (len(times) - 1)

    def decode(k):
        window = np.zeros(CF_PROMPT_LEN, np.int32)
        window[CF_PROMPT_LEN // 2:] = np.random.default_rng(900 + k) \
            .integers(32, 127, CF_PROMPT_LEN // 2)
        x, times, got = window, [], queue.Queue()
        client = grpc.InferenceServerClient(f"127.0.0.1:{port}")
        client.start_stream(callback=lambda result, error: got.put(
            (result, error, time.perf_counter())))
        try:
            for i in range(GENAI_TOKENS + 1):
                inp = grpc.InferInput("TOKENS", [len(x)], "INT32")
                inp.set_data_from_numpy(x)
                client.async_stream_infer("llama_decode", [inp],
                                          sequence_id=7_000 + k,
                                          sequence_start=i == 0,
                                          sequence_end=i == GENAI_TOKENS)
                result, error, t = got.get(timeout=300)
                if error is not None:
                    return
                times.append(t)
                x = result.as_numpy("NEXT_TOKEN").astype(np.int32) \
                    .reshape(1)
        finally:
            client.stop_stream()
            client.close()
        gaps[k] = (times[-1] - times[0]) / (len(times) - 1)

    fn = generate if endpoint == "generate" else decode
    threads = [threading.Thread(target=fn, args=(k,))
               for k in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if any(g is None for g in gaps):
        fail(f"genai_perf {endpoint}: the independent reading failed")
    return 1e3 * sum(gaps) / len(gaps)


def _genai(port, counters) -> None:
    """genai_perf from processes of its own against this server: SSE on
    llama_generate at concurrency 1 and 8, the llama_decode closed loop on
    gRPC-Web streams at 1 and 4, GENAI_TOKENS tokens a request.  No error,
    every request complete, and its report consistent: ``itl_steady``
    (each request's (last - first) / (n - 1)) within GENAI_ITL_TOL of
    (latency - TTFT) / (n - 1) of the means.  Its ITL is held to an
    independent reading of the same quantity just before it
    (``_genai_own``), within GENAI_ITL_TOL: a gate on the host's clock,
    both read once more on a miss (HOST_GATE_RUNS)."""
    for endpoint, model, conc, requests in GENAI_RUNS:
        label = f"genai_perf {endpoint} {model} c={conc}"
        tokens = GENAI_TOKENS + (1 if endpoint == "stream" else 0)
        for attempt in range(1, HOST_GATE_RUNS + 1):
            own = _genai_own(label, port, endpoint, conc)
            _reset(counters)
            rep = _genai_once(label, port, endpoint, model, conc, requests)
            _cf_launches(label, counters, OAI_PATHS)
            if rep["errors"] or rep["requests_completed"] != requests or \
                    rep["output_tokens_per_request"] != tokens:
                fail(f"{label}: {rep['errors']} errors "
                     f"({rep.get('first_error')}), "
                     f"{rep['requests_completed']} of {requests} requests, "
                     f"{rep['output_tokens_per_request']} tokens each")
            steady = rep["itl_steady_ms"]["avg"]
            want = (rep["request_latency_ms"]["avg"]
                    - rep["time_to_first_token_ms"]["avg"]) / (tokens - 1)
            if abs(steady - want) > GENAI_ITL_TOL * want:
                fail(f"{label}: itl_steady {steady:.3f} ms against "
                     f"(latency - TTFT) / (n - 1) {want:.3f} ms of its "
                     "own report")
            off = abs(steady - own) / own
            ttft, itl = (rep["time_to_first_token_ms"],
                         rep["inter_token_latency_ms"])
            print(f"{label}: TTFT p50 {ttft['p50']:.2f} ms (max "
                  f"{ttft['max']:.2f}), ITL p50 {itl['p50']:.2f} ms, p99 "
                  f"{itl['p99']:.2f} ms, itl_steady avg {steady:.3f} ms "
                  f"((latency - TTFT) / (n - 1) {want:.3f} ms), the "
                  f"independent reading {own:.3f} ms ({100 * off:.1f}% "
                  f"off), {rep['output_token_throughput_per_sec']} "
                  f"tokens/s, {rep['request_throughput_per_sec']} "
                  f"requests/s; {CARD}", flush=True)
            if off <= GENAI_ITL_TOL:
                break
            if attempt == HOST_GATE_RUNS:
                fail(f"{label}: itl_steady {steady:.3f} ms is "
                     f"{100 * off:.1f}% off the independent reading "
                     f"{own:.3f} ms")
            print(f"{label}: itl_steady off by more than "
                  f"{100 * GENAI_ITL_TOL:.0f}%: once more", flush=True)


def _repo_kind() -> str:
    """The repository model's instance kind: where generation runs."""
    return "KIND_GPU" if GEN_DEVICE == "cuda" else "KIND_CPU"


def _repo_write(versions, policy: str = "") -> None:
    """The repository: REPO_MODEL at longctx_tpu's width, ``versions``
    (each built from its REPO_SEEDS seed)."""
    import shutil

    from triton_client_tpu_torch.models import language
    from triton_client_tpu_torch.server.model import resolve_instance_device
    from triton_client_tpu_torch.server.model import ModelConfig

    dev = resolve_instance_device(ModelConfig(REPO_MODEL,
                                              instance_kind=_repo_kind()))
    s = language.longctx_seq_len(dev)
    shutil.rmtree(REPO_DIR, ignore_errors=True)
    mdir = os.path.join(REPO_DIR, REPO_MODEL)
    for v in versions:
        os.makedirs(os.path.join(mdir, str(v)))
        with open(os.path.join(mdir, str(v), "model.py"), "w") as f:
            f.write(_REPO_MODEL_PY.format(seed=REPO_SEEDS[v]))
    with open(os.path.join(mdir, "config.pbtxt"), "w") as f:
        f.write(_repo_config(s) + policy)


def _repo_config(s: int) -> str:
    return (f'name: "{REPO_MODEL}"\nbackend: "pytorch"\n'
            "max_batch_size: 4\n"
            f'input [{{ name: "TOKENS" data_type: TYPE_INT32 dims: [ {s} ] '
            "}]\n"
            f'output [{{ name: "LOGPROBS" data_type: TYPE_FP32 dims: [ {s} ] '
            "}]\n"
            "dynamic_batching { preferred_batch_size: [ 1, 2, 4 ] "
            "max_queue_delay_microseconds: 2000 }\n"
            f"instance_group [{{ kind: {_repo_kind()} }}]\n")


def _repo_memory(torch) -> int:
    gc.collect()
    if GEN_DEVICE != "cuda":
        return 0
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def _repo_serve(label, torch, harness, counters, version: str,
                x, expect_seed: int, other_seed: int) -> None:
    """Serve ``x`` (rows of tokens) to ``version`` of REPO_MODEL: LOGPROBS
    within SERVED_ATOL bf16 of the plain-kernel forward of the weights of
    ``expect_seed``, the controls (those weights with the planted fault)
    and the other version's weights beyond it; flash once per layer of
    each forward."""
    import numpy as np

    from triton_client_tpu_torch import http
    from triton_client_tpu_torch.models import language
    from triton_client_tpu_torch.models import transformer as tr

    model = harness.registry.get(REPO_MODEL, version)
    run = model.transformer
    st = model.stats
    runs0 = st.execution_count
    _reset(counters)
    with http.InferenceServerClient(f"127.0.0.1:{harness.http_port}",
                                    network_timeout=300) as client:
        got = []
        for row in x:
            inp = http.InferInput("TOKENS", [1, row.shape[0]], "INT32")
            inp.set_data_from_numpy(row[None])
            got.append(client.infer(REPO_MODEL, [inp],
                                    model_version=version)
                       .as_numpy("LOGPROBS"))
    executions = st.execution_count - runs0
    launches = {name: mod.launches for name, mod in counters.items()}
    launches["int8_quantize_rows"] = counters["int8_matmul"].quantize_launches
    OAI_PATHS[f"{label} v{version}"] = launches
    layers = run.cfg.n_layers
    if GEN_DEVICE == "cuda":
        check_launches(f"{label} v{version}", launches, executions, layers, 0)
    got = np.concatenate(got)
    dev = run.device
    fwd = tr.make_forward(run.cfg, plain=True)
    t = torch.from_numpy(x).to(dev)

    def scores(params):
        return language.longctx_scores(fwd(params, t), t).float().cpu() \
            .numpy()

    with torch.inference_mode():
        own = tr.init_params(torch.Generator(dev).manual_seed(expect_seed),
                             run.cfg)
        want = scores(own)
        controls = [float(np.abs(got - scores(control_params(
            torch, own, s))).max()) for s in CONTROL_SCALES]
        del own
        other = tr.init_params(torch.Generator(dev).manual_seed(other_seed),
                               run.cfg)
        cross = float(np.abs(got - scores(other)).max())
        del other
    atol = SERVED_ATOL["longctx_tpu", False]
    check_served(f"{label} v{version}", "LOGPROBS", atol,
                 float(np.abs(got - want).max()),
                 float(np.abs(got - want).mean()), controls,
                 float(np.abs(want).mean()))
    print(f"{label} v{version}: {executions} forwards, launches "
          f"{launches}; against the other version's seed {cross:.3e}",
          flush=True)
    if not cross > atol:
        fail(f"{label} v{version}: the answers are as close to the other "
             "version's weights as the bound")


def _repo_unload(label, torch, client, harness, base: int, readings):
    """Unload REPO_MODEL: its seconds, its batchers' threads stopped when
    the unload answers, and device memory back within REPO_MEM_TOL of
    ``base`` (before the load)."""
    threads = [b._thread for k, b in harness.core._batchers.items()
               if k.startswith(f"{REPO_MODEL}@")]
    before = _repo_memory(torch)
    t0 = time.perf_counter()
    client.unload_model(REPO_MODEL)
    unload_s = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        fail(f"{label}: a retired batcher still runs after the unload")
    after = _repo_memory(torch)
    readings.append(after)
    print(f"{label}: unloaded in {unload_s:.3f} s; device memory "
          f"{before} -> {after} bytes ({before - after} freed), "
          f"{after - base:+d} against before the load; {CARD}", flush=True)
    if abs(after - base) > REPO_MEM_TOL:
        fail(f"{label}: device memory {after} after the unload, {base} "
             f"before the load ({after - base:+d} bytes)")


def _repository(torch, counters) -> None:
    """A temporary model repository with REPO_MODEL (longctx_tpu base,
    versions 1 and 2 from their seeds): version 1 loaded, served and
    unloaded; both versions under a JSON config override (version_policy
    all) served as their own seeds; a files load; a load_fail draw; three
    load/unload cycles, device memory back to where it was before each
    load."""
    from triton_client_tpu_torch import http
    from triton_client_tpu_torch.models import language
    from triton_client_tpu_torch.server import chaos
    from triton_client_tpu_torch.server.model import resolve_instance_device
    from triton_client_tpu_torch.server.model import ModelConfig
    from triton_client_tpu_torch.server.registry import ModelRegistry
    from triton_client_tpu_torch.server.testing import ServerHarness

    _repo_write((1, 2), "version_policy { specific { versions: [ 1 ] } }\n")
    dev = resolve_instance_device(ModelConfig(REPO_MODEL,
                                              instance_kind=_repo_kind()))
    s = language.longctx_seq_len(dev)
    x = model_tokens(LONGCTX_SEED, 2, s, 256)
    label = "repository"
    readings = []
    with ServerHarness(ModelRegistry(repository_path=REPO_DIR)) as harness, \
            http.InferenceServerClient(f"127.0.0.1:{harness.http_port}",
                                       network_timeout=300) as client:
        index = client.get_model_repository_index()
        if index != [{"name": REPO_MODEL, "version": "1",
                      "state": "UNAVAILABLE", "reason": "unloaded"}]:
            fail(f"{label}: index before a load {index}")
        base = _repo_memory(torch)
        # 1: version 1 alone (the config's policy)
        t0 = time.perf_counter()
        client.load_model(REPO_MODEL)
        load_s = time.perf_counter() - t0
        md = client.get_model_metadata(REPO_MODEL)
        if md["versions"] != ["1"]:
            fail(f"{label}: versions {md['versions']}, expected ['1']")
        print(f"{label}: loaded version 1 in {load_s:.3f} s", flush=True)
        _repo_serve(f"{label} cycle 1", torch, harness, counters, "1", x,
                    REPO_SEEDS[1], REPO_SEEDS[2])
        print(f"{label} cycle 1: device memory {_repo_memory(torch) - base} "
              "bytes above before the load while served", flush=True)
        _repo_unload(f"{label} cycle 1", torch, client, harness, base,
                     readings)
        # 2: a JSON config override with version_policy all
        override = json.dumps({
            "name": REPO_MODEL, "backend": "pytorch", "max_batch_size": 4,
            "input": [{"name": "TOKENS", "data_type": "TYPE_INT32",
                       "dims": [s]}],
            "output": [{"name": "LOGPROBS", "data_type": "TYPE_FP32",
                        "dims": [s]}],
            "dynamic_batching": {"preferred_batch_size": [1, 2, 4],
                                 "max_queue_delay_microseconds": 2000},
            "instance_group": [{"kind": _repo_kind()}],
            "version_policy": {"all": {}}})
        t0 = time.perf_counter()
        client.load_model(REPO_MODEL, config=override)
        load_s = time.perf_counter() - t0
        md = client.get_model_metadata(REPO_MODEL)
        rows = [(m["version"], m["state"])
                for m in client.get_model_repository_index()]
        if md["versions"] != ["1", "2"] or rows != [("1", "READY"),
                                                    ("2", "READY")]:
            fail(f"{label}: under version_policy all: {md['versions']}, "
                 f"index {rows}")
        print(f"{label}: loaded versions 1 and 2 (JSON override, "
              f"version_policy all) in {load_s:.3f} s", flush=True)
        for v in ("1", "2"):
            _repo_serve(f"{label} cycle 2", torch, harness, counters, v, x,
                        REPO_SEEDS[int(v)], REPO_SEEDS[3 - int(v)])
        # unversioned: the latest
        if harness.registry.get(REPO_MODEL).served_version != "2":
            fail(f"{label}: the default version is not the latest")
        _repo_unload(f"{label} cycle 2", torch, client, harness, base,
                     readings)
        # 3: a load_fail draw, then a files load of version 2's source
        harness.core.chaos = chaos.ChaosInjector(
            rate=1.0, kinds=("load_fail",), seed=0, max_faults=1)
        try:
            refusal = None
            try:
                client.load_model(REPO_MODEL)
            except Exception as e:  # noqa: BLE001 - the injected failure
                refusal = str(e)
            if refusal is None or "injected load failure" not in refusal:
                fail(f"{label}: the load_fail draw did not fail the load: "
                     f"{refusal}")
            print(f"{label}: load_fail: {refusal}", flush=True)
            if abs(_repo_memory(torch) - base) > REPO_MEM_TOL:
                fail(f"{label}: a failed load left device memory behind")
            with open(os.path.join(REPO_DIR, REPO_MODEL, "2",
                                   "model.py"), "rb") as f:
                source = f.read()
            t0 = time.perf_counter()
            client.load_model(REPO_MODEL, config=override, files={
                "file:2/model.py": source})
            load_s = time.perf_counter() - t0
        finally:
            harness.core.chaos = None
        if client.get_model_metadata(REPO_MODEL)["versions"] != ["2"]:
            fail(f"{label}: the files load serves another version set")
        print(f"{label}: files load (version 2's model.py in the request) "
              f"in {load_s:.3f} s", flush=True)
        _repo_serve(f"{label} cycle 3", torch, harness, counters, "2", x,
                    REPO_SEEDS[2], REPO_SEEDS[1])
        _repo_unload(f"{label} cycle 3", torch, client, harness, base,
                     readings)
    growth = max(readings) - min(readings)
    print(f"{label}: device memory after each of the 3 unloads "
          f"{readings} (spread {growth} bytes); {CARD}", flush=True)
    if growth > REPO_MEM_TOL:
        fail(f"{label}: device memory grew {growth} bytes over 3 cycles")


def openai_repository_phase(torch, counters) -> None:
    """The OpenAI routes and genai_perf on llama 1b (the generation
    phase's weights) served batched with 8 slots and the prefix cache,
    then the repository's longctx_tpu-base model."""
    from triton_client_tpu_torch.models import decode
    from triton_client_tpu_torch.server import kvcache

    params = GEN_SHARED.pop("params")
    t0 = time.perf_counter()
    try:
        with _cf_env(TRITON_TPU_DECODE_MODE="batched",
                     TRITON_TPU_DECODE_SLOTS=GEN_SLOTS,
                     **{kvcache.cache_env_key("llama_decode"):
                        CF_CACHE_BYTES}):
            dec = decode.DecodeModel(device=GEN_DEVICE,
                                     prompt_len=CF_PROMPT_LEN)
            dec._params = params
            gen_model = decode.make_llama_generate(dec)
            with serving_harness([dec.model, gen_model]) as harness:
                port = harness.http_port
                _sse_stream(port, b"warm-up", 2)
                _oai_routes(torch, dec, port, counters)
                print(f"openai: took {time.perf_counter() - t0:.1f} s",
                      flush=True)
                t1 = time.perf_counter()
                _genai(port, counters)
                print(f"genai_perf: took {time.perf_counter() - t1:.1f} s",
                      flush=True)
            del dec, gen_model
    finally:
        del params
        gc.collect()
        if GEN_DEVICE == "cuda":
            torch.cuda.empty_cache()
    t1 = time.perf_counter()
    _repository(torch, counters)
    print(f"repository: took {time.perf_counter() - t1:.1f} s", flush=True)


# -- the fleet (phase 17) ------------------------------------------------------

#: "<window>" -> that window's kernel launches (the in-process paths)
FLEET_PATHS = {}
#: each perf_analyzer window of the frontend comparison, and of the SIGKILL
#: run (which spans the kill and the sibling serving alone)
FLEET_WINDOW_MS, FLEET_KILL_WINDOW_MS = 2000, 3000
#: the in-process rolling update's longctx_tpu-base versions, by seed
FLEET_SEEDS = {1: 101, 2: 202, 3: 303}
FLEET_MODEL = "longctx_fleet"
#: the autoscaler's load (perf_analyzer c = 16, -b 32) and its cooldown out
FLEET_SCALE_WINDOW_MS, FLEET_SCALE_COOLDOWN_S = 10500, 1.2
FLEET_DIR = os.path.join(REPO, "build", "chip_smoke_fleet")


class _UtilSampler:
    """``nvidia-smi --query-gpu=utilization.gpu`` every 100 ms, each reading
    stamped with ``time.perf_counter``: the share of each sample period in
    which a kernel of any process ran."""

    def __init__(self):
        self.samples = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", "-i", "0", "--query-gpu=utilization.gpu",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self._thread = threading.Thread(target=self._read, daemon=True)
        self._thread.start()

    def _read(self):
        for line in self.proc.stdout:
            try:
                self.samples.append((time.perf_counter(),
                                     float(line.strip())))
            except ValueError:
                continue

    def idle(self, t0: float, t1: float):
        """The idle share over [t0, t1] (None without a sample)."""
        vals = [v for t, v in self.samples if t0 <= t <= t1]
        return 1.0 - sum(vals) / len(vals) / 100.0 if vals else None

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self._thread.join(timeout=10)


def _share(x) -> str:
    return "not measured" if x is None else f"{x:.1%}"


def _adjacent_ports(n: int) -> int:
    """A port P with P .. P + n - 1 free (worker i serves /metrics on
    P + i)."""
    import socket

    from triton_client_tpu_torch.server.testing import free_port

    for _ in range(100):
        p = free_port()
        try:
            for i in range(1, n):
                with socket.socket() as s:
                    s.bind(("127.0.0.1", p + i))
            return p
        except OSError:
            continue
    fail("fleet: no free run of metrics ports")


class _FleetServer:
    """``python -m triton_client_tpu_torch.server --frontends N`` (the
    zoo on the card) in a process of its own, its output in a log under
    FLEET_DIR; ``close`` sends SIGTERM and waits, and kills what is left
    on every exit path."""

    def __init__(self, frontends: int, *extra: str, name: str = ""):
        from triton_client_tpu_torch.server.testing import free_port

        self.n = frontends
        #: nv_fleet_worker_restart_total before the SIGKILL drill
        self.restarts = 0.0
        self.port = free_port()
        self.mport = _adjacent_ports(frontends)
        os.makedirs(FLEET_DIR, exist_ok=True)
        self.log_path = os.path.join(
            FLEET_DIR, f"{name or f'frontends_{frontends}'}.log")
        self._log = open(self.log_path, "w")
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("TRITON_TPU_")}
        env["PYTHONPATH"] = REPO
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "triton_client_tpu_torch.server",
             "--http-port", str(self.port), "--metrics-port",
             str(self.mport), "--frontends", str(frontends),
             "--drain-timeout", "20", "--worker-restart-window", "60",
             *extra],
            cwd=REPO, env=env, stdout=self._log, stderr=subprocess.STDOUT)
        self.url = f"127.0.0.1:{self.port}"

    def tail(self) -> str:
        with open(self.log_path) as f:
            return f.read()[-3000:]

    def metrics(self, i: int):
        """Worker i's /metrics families, None while its port is down."""
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{self.mport + i}/metrics",
                    timeout=10) as r:
                return parse_prometheus(r.read().decode())
        except OSError:
            return None

    def execs(self, model: str = "longctx_tpu"):
        """Each worker's executions of ``model`` (None: its port down)."""
        out = []
        for i in range(self.n):
            fams = self.metrics(i)
            out.append(None if fams is None else _metric_sum(
                fams, "nv_inference_exec_count", model=model))
        return out

    def pids(self) -> dict:
        """Worker index -> its latest pid (the supervisor's lines)."""
        out = {}
        with open(self.log_path) as f:
            for line in f:
                if line.startswith("frontend worker ") and ": pid " in line:
                    parts = line.split()
                    out[int(parts[2].rstrip(":"))] = int(parts[-1])
        return out

    def wait_up(self, label: str, timeout: float = 240.0) -> float:
        """Until every worker's metrics port answers; its seconds."""
        t0 = time.perf_counter()
        while any(self.metrics(i) is None for i in range(self.n)):
            if self.proc.poll() is not None or \
                    time.perf_counter() - t0 > timeout:
                fail(f"{label}: the fleet did not come up: {self.tail()}")
            time.sleep(0.2)
        return time.perf_counter() - t0

    def close(self) -> int:
        """SIGTERM, then its exit code (every worker drains); what has not
        exited within the drain's time is killed, its workers too."""
        import signal

        try:
            if self.proc.poll() is None:
                self.proc.send_signal(signal.SIGTERM)
                try:
                    self.proc.wait(timeout=90)
                except subprocess.TimeoutExpired:
                    self.proc.kill()
                    self.proc.wait()
        finally:
            if self.proc.returncode != 0:
                # a supervisor that failed or was killed may leave workers
                for pid in self.pids().values():
                    try:
                        os.kill(pid, signal.SIGKILL)
                    except OSError:
                        pass
            self._log.close()
        return self.proc.returncode


def _longctx_holder(label: str, torch, run, x):
    """The check of longctx_tpu bf16 LOGPROBS answers to ``x`` (rows of
    tokens) served from ``run``'s weights: within SERVED_ATOL of the
    plain-kernel forward, the controls beyond it (``check_served``)."""
    import numpy as np

    from triton_client_tpu_torch.models import language
    from triton_client_tpu_torch.models import transformer as tr

    fwd = tr.make_forward(run.cfg, plain=True)
    t = torch.from_numpy(x).to("cuda")
    with torch.inference_mode():
        want = language.longctx_scores(fwd(run.params, t), t).cpu().numpy()
        controls = []
        for scale in CONTROL_SCALES:
            faulty = control_params(torch, run.params, scale)
            controls.append(language.longctx_scores(
                fwd(faulty, t), t).cpu().numpy())
            del faulty
    atol = SERVED_ATOL["longctx_tpu", False]

    def check(name, got):
        if got.shape != want.shape or not np.isfinite(got).all():
            fail(f"{label} {name}: bad LOGPROBS shape {got.shape} or "
                 "non-finite")
        diff = np.abs(got - want)
        check_served(f"{label} {name}", "LOGPROBS", atol, float(diff.max()),
                     float(diff.mean()),
                     [float(np.abs(got - c).max()) for c in controls],
                     float(np.abs(want).mean()))

    return check


def _fleet_wire(srv, x):
    """One LOGPROBS request of ``x`` on a connection of its own (the kernel
    picks the worker); (answer, the worker that executed it)."""
    before = srv.execs()
    client = _client(srv.port)
    try:
        got, _ = _post_infer(client, "longctx_tpu",
                             [("TOKENS", "INT32", x)], ["LOGPROBS"])
    finally:
        client.close()
    return got["LOGPROBS"], _fleet_who(srv, before)


def _fleet_who(srv, before) -> int:
    """The worker whose longctx_tpu executions rose since ``before``."""
    end = time.monotonic() + 10
    while True:
        after = srv.execs()
        rose = [i for i, (a, b) in enumerate(zip(after, before))
                if a is not None and a > (b or 0)]
        if len(rose) == 1:
            return rose[0]
        if time.monotonic() > end:
            fail(f"fleet: cannot tell which worker served ({before} -> "
                 f"{after})")
        time.sleep(0.02)


def _fleet_every_worker(label, srv, send, check, tries: int = 40) -> list:
    """``send()`` (one request on a fresh connection: (answer, worker))
    until every worker served one; each answer held by ``check``.  Returns
    the workers in order."""
    served = []
    while len(set(served)) < srv.n:
        if len(served) >= tries:
            fail(f"{label}: {tries} connections reached workers {served} "
                 f"of {srv.n}")
        got, who = send()
        check(f"worker {who}", got)
        served.append(who)
    return served


def _fleet_perf(label, srv, args, window_ms: int, sampler):
    """``perf_analyzer -v`` with ``args`` in a process of its own against
    ``srv``: its one level's result (zero errors, or the run fails), the
    idle share over its window and each worker's executions in it."""
    before = srv.execs()
    cmd = [sys.executable, "-m", "triton_client_tpu_torch.perf_analyzer",
           "-m", "longctx_tpu", "-u", srv.url, "-v",
           "--measurement-interval", str(window_ms), *args]
    proc = subprocess.run(cmd, cwd=REPO, env=dict(os.environ,
                                                  PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=600)
    after = srv.execs()
    res = _fleet_result(label, proc)
    split = [(a or 0) - (b or 0) for a, b in zip(after, before)]
    idle = sampler.idle(res["window_start_s"], res["window_end_s"])
    print(f"{label}: {res['throughput']:.3f} infer/s, p50 "
          f"{res['p50_us'] / 1e3:.3f} ms, p99 {res['p99_us'] / 1e3:.3f} ms, "
          f"errors {res['errors']}, retries {res['retries_run']}; card idle "
          f"{_share(idle)} (nvidia-smi utilization.gpu, 100 ms samples); "
          f"executions by worker {split}; {CARD}", flush=True)
    return res, idle, split


def _fleet_result(label, proc) -> dict:
    if proc.returncode != 0:
        fail(f"{label}: perf_analyzer exited {proc.returncode}: "
             f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    results = [json.loads(ln.split("result ", 1)[1])
               for ln in proc.stdout.splitlines()
               if ln.startswith("  result ")]
    if len(results) != 1:
        fail(f"{label}: perf_analyzer printed {len(results)} levels: "
             f"{proc.stdout[-2000:]}")
    res = results[0]
    if res["errors"] or res["first_error"] or not res["throughput"]:
        fail(f"{label}: {res['errors']} errors ({res['first_error']}), "
             f"{res['throughput']} infer/s")
    return res


def _fleet_region(label, torch, srv, x, check, wire) -> None:
    """CUDA regions of this process for TOKENS and LOGPROBS, registered
    through one worker, then used by requests on fresh connections until
    both workers served one: the sibling opens the cudaIPC handle from the
    manifest.  Each answer held by ``check`` and to the wire's; the
    regions leave every worker's status after the unregister."""
    import numpy as np

    from triton_client_tpu_torch import http
    from triton_client_tpu_torch.utils import cuda_shared_memory as cudashm

    S = x.shape[1]
    regions = {}
    client = _client(srv.port)
    try:
        for role, nbytes in (("in", x.nbytes), ("out", x.shape[0] * S * 4)):
            name = f"fleet_{os.getpid()}_{role}"
            h = cudashm.create_shared_memory_region(name, nbytes, 0)
            regions[role] = (name, h, nbytes)
        cudashm.set_shared_memory_region(regions["in"][1], [x])
        for name, h, nbytes in regions.values():
            client.register_cuda_shared_memory(
                name, cudashm.get_raw_handle(h), 0, nbytes)
        listed = sorted(r["name"] for r in
                        client.get_cuda_shared_memory_status())
        if listed != sorted(name for name, _, _ in regions.values()):
            fail(f"{label}: the status after the register lists {listed}")

        def send():
            before = srv.execs()
            c = _client(srv.port)
            try:
                inp = http.InferInput("TOKENS", list(x.shape), "INT32")
                inp.set_shared_memory(regions["in"][0], regions["in"][2])
                out = http.InferRequestedOutput("LOGPROBS")
                out.set_shared_memory(regions["out"][0], regions["out"][2])
                res = c.infer("longctx_tpu", [inp], outputs=[out])
                if res.get_output("LOGPROBS").get("parameters", {}).get(
                        "shared_memory_region") != regions["out"][0]:
                    fail(f"{label}: the answer did not name the region")
            finally:
                c.close()
            who = _fleet_who(srv, before)
            got = np.array(cudashm.get_contents_as_numpy(
                regions["out"][1], np.float32, [x.shape[0], S]))
            return got, who

        def held(name, got):
            check(name, got)
            diff = float(np.abs(got - wire).max())
            print(f"{label} {name}: against the wire's answer {diff:.3e}",
                  flush=True)
            if diff > SERVED_ATOL["longctx_tpu", False]:
                fail(f"{label} {name}: the region's answer is not the "
                     "wire's")

        served = _fleet_every_worker(label, srv, send, held)
        print(f"{label}: registered through one worker (its status lists "
              f"{listed}), served by workers {served} (the sibling mapped "
              "the region from the manifest)", flush=True)
    finally:
        for name, h, _ in regions.values():
            client.unregister_cuda_shared_memory(name)
        for _, h, _ in regions.values():
            cudashm.destroy_shared_memory_region(h)
        client.close()
    # every worker's status (each read on a fresh connection) is empty
    for _ in range(8):
        if _shm_status(srv.port)["cudasharedmemory"]:
            fail(f"{label}: a region is left in a worker's status")


def _fleet_frontends(torch, srv2, srv1, sampler):
    """Part 1: ``--frontends 2`` against ``--frontends 1`` under
    perf_analyzer c = 4 -b 4 (every answer this script reads held to the
    plain forward), a CUDA region across the siblings, each worker's
    metrics port.  Returns the check of ``x`` and ``x``."""
    from triton_client_tpu_torch.models import language

    label = "fleet frontends"
    ref = language.make_longctx_tpu("cuda")
    run = ref.transformer
    run._ensure()
    S = ref.config.input[0].dims[0]
    x = model_tokens(LONGCTX_SEED, ref.max_batch_size, S, 256)
    check = _longctx_holder(label, torch, run, x)
    up = [srv.wait_up(label) for srv in (srv2, srv1)]
    print(f"{label}: both fleets up ({up[0]:.1f} / {up[1]:.1f} s after "
          "this wait began)", flush=True)
    # every worker builds its weights at its first request: six requests
    # to the pair and one to the single worker at once, each on its own
    # connection
    t0 = time.perf_counter()
    answers, errors = [], []

    def warm(srv):
        try:
            client = _client(srv.port)
            try:
                got, _ = _post_infer(client, "longctx_tpu",
                                     [("TOKENS", "INT32", x)], ["LOGPROBS"])
            finally:
                client.close()
            answers.append((srv.n, got["LOGPROBS"]))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=warm, args=(srv,), daemon=True)
               for srv in [srv2] * 6 + [srv1]]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    if errors or len(answers) != len(threads):
        fail(f"{label}: the warm-up failed: {errors}")
    for n, got in answers:
        check(f"warm-up, --frontends {n}", got)
    wire = {"x": answers[0][1]}
    if not all(srv2.execs()):
        # the kernel gave a worker no connection: one by one until it has
        _fleet_every_worker(f"{label} warm-up", srv2,
                            lambda: _fleet_wire(srv2, x), check)
    print(f"{label}: every worker built its weights in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    pair = _fleet_perf(
        f"{label} --frontends 2 c=4 -b 4", srv2,
        ["-b", "4", "--concurrency-range", "4:4"], FLEET_WINDOW_MS, sampler)
    _fleet_single(srv1, sampler, pair)
    _fleet_region(f"{label} cuda region", torch, srv2, x, check, wire["x"])
    for i in range(srv2.n):
        fams = srv2.metrics(i)
        if fams is None or "nv_fleet_worker_restart_total" not in fams:
            fail(f"{label}: worker {i}'s metrics port lacks the fleet "
                 "families")
    print(f"{label}: each worker answers /metrics on its own port "
          f"({srv2.mport}, {srv2.mport + 1})", flush=True)
    return check, x


def _fleet_single(srv1, sampler, pair) -> None:
    """The same perf_analyzer run against ``--frontends 1``, printed beside
    the pair's reading ``pair``, then its drained exit."""
    label = "fleet frontends"
    single = _fleet_perf(
        f"{label} --frontends 1 c=4 -b 4", srv1,
        ["-b", "4", "--concurrency-range", "4:4"], FLEET_WINDOW_MS, sampler)
    print(f"{label}: --frontends 2 / 1: {pair[0]['throughput']:.3f} / "
          f"{single[0]['throughput']:.3f} infer/s, p99 "
          f"{pair[0]['p99_us'] / 1e3:.3f} / {single[0]['p99_us'] / 1e3:.3f} "
          f"ms, idle {_share(pair[1])} / {_share(single[1])}; {CARD}",
          flush=True)
    code = srv1.close()
    if code != 0:
        fail(f"{label}: --frontends 1 exited {code} after SIGTERM: "
             f"{srv1.tail()}")


def _fleet_kill(srv2):
    """Part 2, first half: a worker SIGKILLed a quarter into a c = 4
    perf_analyzer window with --retries 3, once it has executed requests
    in that window: zero errors, and at least one request cut off and sent
    again (the client's resends and retries).  The kernel hands each of
    the tool's four connections to a worker by a hash of its ports, so all
    four land on one worker one run in eight: the victim is worker 0 where
    it executed in the window, else the worker that did.  Returns (the
    victim's index, its pid, the kill's time, a dict where a thread of its
    own puts the time the victim's metrics port answers again with its
    restart counted: "back")."""
    import signal

    label = "fleet self-healing"
    pids = srv2.pids()
    srv2.restarts = _metric_sum(srv2.metrics(1) or {},
                                "nv_fleet_worker_restart_total")
    cmd = [sys.executable, "-m", "triton_client_tpu_torch.perf_analyzer",
           "-m", "longctx_tpu", "-u", srv2.url, "-v", "-b", "4",
           "--concurrency-range", "4:4", "--retries", "3",
           "--measurement-interval", str(FLEET_KILL_WINDOW_MS)]
    proc = subprocess.Popen(cmd, cwd=REPO, env=dict(os.environ,
                                                    PYTHONPATH=REPO),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    respawn = {}

    def watch_respawn():
        end = time.monotonic() + 240
        while time.monotonic() < end and srv2.proc.poll() is None:
            fams = srv2.metrics(idx)
            if fams is not None and _metric_sum(
                    fams, "nv_fleet_worker_restart_total") \
                    == srv2.restarts + 1:
                respawn["back"] = time.perf_counter()
                return
            time.sleep(0.05)

    try:
        # the tool's first request starts its 1 s warm-up; the kill comes a
        # quarter into its window, once the victim has executed in it
        begun = sum(n or 0 for n in srv2.execs())
        end = time.monotonic() + 120
        while sum(n or 0 for n in srv2.execs()) == begun:
            if proc.poll() is not None or time.monotonic() > end:
                fail(f"{label}: perf_analyzer sent nothing")
            time.sleep(0.02)
        time.sleep(1.0)
        at_window = srv2.execs()
        time.sleep(FLEET_KILL_WINDOW_MS / 4e3)
        end = time.monotonic() + FLEET_KILL_WINDOW_MS / 2e3
        while True:
            pre = srv2.execs()
            busy = [i for i in range(srv2.n)
                    if (pre[i] or 0) > (at_window[i] or 0)]
            if busy:
                idx = busy[0]
                break
            if time.monotonic() > end:
                fail(f"{label}: no worker executed in the window before the "
                     f"kill (executions {at_window} -> {pre})")
            time.sleep(0.02)
        victim = pids[idx]
        t_kill = time.perf_counter()
        os.kill(victim, signal.SIGKILL)
        respawn["thread"] = threading.Thread(target=watch_respawn,
                                             daemon=True)
        respawn["thread"].start()
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    after = srv2.execs()
    res = _fleet_result(label, subprocess.CompletedProcess(
        cmd, proc.returncode, out, err))
    if not res["window_start_s"] <= t_kill <= res["window_end_s"]:
        fail(f"{label}: the kill at {t_kill:.3f} fell outside the window "
             f"[{res['window_start_s']:.3f}, {res['window_end_s']:.3f}]")
    # the victim's executions from about the window's start to the kill,
    # its sibling's to the run's end
    split = [((pre if i == idx else after)[i] or 0) - (at_window[i] or 0)
             for i in range(srv2.n)]
    cut = res["resends_run"] + res["retries_run"]
    print(f"{label}: worker {idx} (pid {victim}) SIGKILLed inside the "
          f"window: {res['throughput']:.3f} infer/s, p99 "
          f"{res['p99_us'] / 1e3:.3f} ms, errors {res['errors']}; executions "
          f"by worker {split} (worker {idx} to the kill); requests cut off "
          f"and sent again: "
          f"{res['resends_run']} on a new connection, {res['retries_run']} "
          "by the retry policy", flush=True)
    if cut < 1:
        fail(f"{label}: no request was cut off by the kill")
    return idx, victim, t_kill, respawn


def _fleet_incidents(srv2) -> None:
    """A ``worker_kill`` draw on ``--frontends 2`` (chaos on ``simple``
    only): the drawing worker's ``chaos`` bundle written before it exits,
    its sibling's ``worker_crash`` bundle naming it and the reason, the
    worker restarted; then SIGUSR2 to the sibling: a ``sigusr2`` bundle.
    Every bundle complete in the fleet's --incident-dir, and counted on
    the sibling's /metrics (the exited worker's counts went with it)."""
    import signal

    label = "fleet incidents"
    srv2.wait_up(label)
    dirname = srv2.incident_dir
    t0 = time.perf_counter()
    req = urllib.request.Request(
        f"http://{srv2.url}/v2/models/simple/infer",
        data=json.dumps({"inputs": [
            {"name": n, "shape": [1, 16], "datatype": "INT32",
             "data": [0] * 16} for n in ("INPUT0", "INPUT1")]}).encode(),
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            fail(f"{label}: the worker_kill draw answered {r.status}")
    except (OSError, urllib.error.HTTPError) as e:
        cut = repr(e)
    bundle = _wait_bundle(label, dirname, "chaos")
    m = _check_bundle(label, bundle, "chaos", "worker_kill on simple")
    victim = int(m["replica"].rsplit("#w", 1)[1])
    sibling = 1 - victim
    crash = _wait_bundle(label, dirname, "worker_crash")
    mc = _check_bundle(label, crash, "worker_crash",
                       f"worker {victim}: chaos:worker_kill")
    if not mc["replica"].endswith(f"#w{sibling}"):
        fail(f"{label}: the worker_crash bundle came from "
             f"{mc['replica']}, not worker {sibling}")
    t_crash = time.perf_counter() - t0
    pid = srv2.pids()[sibling]
    os.kill(pid, signal.SIGUSR2)
    sig = _wait_bundle(label, dirname, "sigusr2")
    ms = _check_bundle(label, sig, "sigusr2", "operator SIGUSR2")
    if ms["pid"] != pid:
        fail(f"{label}: the sigusr2 bundle came from pid {ms['pid']}, not "
             f"{pid}")
    end = time.monotonic() + 240
    while True:
        fams = [srv2.metrics(i) for i in range(srv2.n)]
        if all(f is not None and _metric_sum(
                f, "nv_fleet_worker_restart_total") == 1.0 for f in fams):
            break
        if srv2.proc.poll() is not None or time.monotonic() > end:
            fail(f"{label}: worker {victim} did not come back: "
                 f"{srv2.tail()}")
        time.sleep(0.1)
    for trigger in ("worker_crash", "sigusr2"):
        _check_counted(label, fams[sibling], trigger)
    _report(label, dirname, "sigusr2")
    print(f"{label}: a simple request drew worker_kill on worker {victim} "
          f"(the client saw {cut[:60]}...); its chaos bundle, then worker "
          f"{sibling}'s worker_crash bundle {t_crash:.1f} s after the "
          f"request; SIGUSR2 to worker {sibling} (pid {pid}) wrote a "
          f"sigusr2 bundle; worker {victim} back "
          f"{time.perf_counter() - t0:.1f} s after the request; {CARD}",
          flush=True)


def _fleet_healed(srv2, idx, victim, t_kill, respawn, check, x) -> None:
    """Part 2, second half: the supervisor respawned worker ``idx``,
    nv_fleet_worker_restart_total reads 1 on both workers' ports and in
    ``tools.top --once --json`` over the fleet's frontend, the respawned
    worker's answers hold, and SIGTERM drains the fleet to exit 0."""
    label = "fleet self-healing"
    respawn["thread"].join(timeout=240)
    end = time.monotonic() + 60
    while True:
        counts = []
        for i in range(srv2.n):
            fams = srv2.metrics(i)
            counts.append(None if fams is None else _metric_sum(
                fams, "nv_fleet_worker_restart_total"))
        if counts == [srv2.restarts + 1] * srv2.n:
            break
        if srv2.proc.poll() is not None or time.monotonic() > end:
            fail(f"{label}: restart counters {counts}: {srv2.tail()}")
        time.sleep(0.1)
    if "back" not in respawn:
        fail(f"{label}: worker {idx}'s metrics port never answered with its "
             f"restart counted: {srv2.tail()}")
    respawn_s = respawn["back"] - t_kill
    new_pid = srv2.pids()[idx]
    if new_pid == victim:
        fail(f"{label}: worker {idx} was not respawned")
    t0 = time.perf_counter()
    while True:
        got, who = _fleet_wire(srv2, x)
        check(f"worker {who}", got)
        if who == idx:
            break
        if time.perf_counter() - t0 > 60:
            fail(f"{label}: the respawned worker served nothing")
    total = srv2.restarts + 1
    # the operator's console over the fleet's frontend reads the restart
    snap = json.loads(_tw_tool(label, "top", "--url", srv2.url, "--once",
                               "--json"))
    print(f"{label}: tools.top --once --json over the fleet's frontend "
          f"{srv2.url}: worker_restarts {snap['worker_restarts']}",
          flush=True)
    if snap["worker_restarts"] < 1:
        fail(f"{label}: tools.top read worker_restarts "
             f"{snap['worker_restarts']} after the SIGKILL")
    print(f"{label}: respawned as pid {new_pid}; its metrics port answered "
          f"with nv_fleet_worker_restart_total {total:g} {respawn_s:.1f} s "
          f"after the kill ({total:g} on both workers' ports, the "
          f"worker_kill drill's restart included); its first answer took "
          f"{time.perf_counter() - t0:.1f} s (weights built); {CARD}",
          flush=True)
    # the SIGKILL's worker_crash bundle from the sibling (rate-limited
    # where it wrote the worker_kill drill's inside the class's interval)
    sibling = 1 - idx
    fams = srv2.metrics(sibling) or {}
    print(f"{label}: worker {sibling}'s worker_crash bundles: written "
          f"{_incidents_written(fams, 'worker_crash'):g}, rate-limited "
          f"{_metric_sum(fams, 'nv_host_incident_total', trigger='worker_crash', outcome='suppressed'):g}; "
          f"the fleet's bundles {_bundle_kinds(srv2.incident_dir)}",
          flush=True)
    t0 = time.perf_counter()
    code = srv2.close()
    if code != 0:
        fail(f"{label}: the fleet exited {code} after SIGTERM: "
             f"{srv2.tail()}")
    print(f"{label}: SIGTERM drained the fleet: exit 0 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def _fleet_version(torch, seed: int, warmup: bool = True,
                   fail_requests: bool = False):
    """A ``longctx_tpu``-base model named FLEET_MODEL on the card from
    ``seed`` (bf16, flash in every layer), one warmup sample of batch 4
    where ``warmup``; ``fail_requests``: it runs the forward, then fails."""
    from triton_client_tpu_torch.models import language
    from triton_client_tpu_torch.server.model import TorchModel, make_config

    cfg_t = language.longctx_cfg("cuda")
    s = language.longctx_seq_len("cuda")
    config = make_config(
        FLEET_MODEL, inputs=[("TOKENS", "INT32", [s])],
        outputs=[("LOGPROBS", "FP32", [s])], max_batch_size=4,
        preferred_batch_sizes=[1, 2, 4], max_queue_delay_us=2000,
        instance_kind="KIND_GPU",
        warmup=[{"name": "w", "batch_size": 4,
                 "inputs": {"TOKENS": ("INT32", [s], "random")}}]
        if warmup else None)
    run = language.LazyTransformer(cfg_t, seed=seed, device="cuda",
                                   model_name=FLEET_MODEL)

    def fn(TOKENS):
        tokens = torch.clamp(TOKENS, 0, cfg_t.vocab_size - 1)
        out = language.longctx_scores(run(tokens), tokens)
        if fail_requests:
            raise RuntimeError("bad version")
        return {"LOGPROBS": out}

    model = TorchModel(config, fn)
    model.transformer = run
    model.stats.executions = []
    return model


def _fleet_rolling(torch, counters) -> None:
    """Part 3: FLEET_MODEL v1 under a c = 4 closed loop, rolled to v2
    (warmed, promoted, baked); each answer one version's; then an update to
    a version that fails every request rolls back and gives its memory
    back."""
    import numpy as np

    from triton_client_tpu_torch import http
    from triton_client_tpu_torch.models import language
    from triton_client_tpu_torch.models import transformer as tr
    from triton_client_tpu_torch.server.fleet import FleetController

    label = "fleet rolling update"
    atol = SERVED_ATOL["longctx_tpu", False]
    v1 = _fleet_version(torch, FLEET_SEEDS[1])
    cfg_t, S = v1.transformer.cfg, v1.config.input[0].dims[0]
    x = model_tokens(LONGCTX_SEED, 4, S, 256)
    fwd = tr.make_forward(cfg_t, plain=True)
    t = torch.from_numpy(x).to("cuda")
    want = {}
    with torch.inference_mode():
        for v in (1, 2):
            params = tr.init_params(
                torch.Generator("cuda").manual_seed(FLEET_SEEDS[v]), cfg_t)
            want[v] = language.longctx_scores(fwd(params, t), t).cpu() \
                .numpy()
            del params
    with serving_harness([v1]) as harness:
        core = harness.core
        # no counted first executions: each batch size would run one
        core.device_stats.enabled = False
        ctl = FleetController(core, bake_s=1.0, bake_min_samples=4)
        core.fleet = ctl
        registry = core.registry
        flip = {}
        promote = registry.promote

        def timed_promote(name, version):
            flip.setdefault("start", time.perf_counter())
            staged = registry.staged_version(name, version)
            flip["warm_executions"] = len(staged.stats.executions)
            out = promote(name, version)
            flip.setdefault("end", time.perf_counter())
            return out

        registry.promote = timed_promote
        records, errors, stop = [], [], threading.Event()

        def loop(row):
            c = _client(harness.http_port)
            inp = http.InferInput("TOKENS", [1, S], "INT32")
            inp.set_data_from_numpy(x[row:row + 1])
            try:
                while not stop.is_set():
                    t0 = time.perf_counter()
                    got = c.infer(FLEET_MODEL, [inp]).as_numpy("LOGPROBS")
                    records.append((t0, time.perf_counter(), row, got[0]))
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(repr(e))
            finally:
                c.close()

        with _client(harness.http_port) as c:
            _post_infer(c, FLEET_MODEL, [("TOKENS", "INT32", x[:1])],
                        ["LOGPROBS"])
        # counted from here to the last answer: every forward whole
        v1.stats.executions = []
        _reset(counters)
        threads = [threading.Thread(target=loop, args=(r,), daemon=True)
                   for r in range(4)]
        for th in threads:
            th.start()
        time.sleep(1.0)
        v2 = _fleet_version(torch, FLEET_SEEDS[2])
        t0 = time.perf_counter()
        outcome = ctl.rolling_update(FLEET_MODEL, v2)
        update_s = time.perf_counter() - t0
        time.sleep(0.5)
        stop.set()
        for th in threads:
            th.join(timeout=120)
        launches = {name: mod.launches for name, mod in counters.items()}
        launches["int8_quantize_rows"] = \
            counters["int8_matmul"].quantize_launches
        if errors or outcome != "completed":
            fail(f"{label}: outcome {outcome}, caller errors {errors}")
        if f"{FLEET_MODEL}@1" in core._batchers:
            fail(f"{label}: v1's batcher was not drained")
        executions = len(v1.stats.executions) + len(v2.stats.executions)
        check_launches(label, launches, executions, cfg_t.n_layers, 0)
        if flip.get("warm_executions") != 1:
            fail(f"{label}: v2 executed {flip.get('warm_executions')} times "
                 "before the flip, not its one warmup sample")
        FLEET_PATHS[label] = launches
        counts = {1: 0, 2: 0}
        first_v2 = None
        for t_send, t_recv, row, got in records:
            errs = {v: float(np.abs(got - want[v][row]).max())
                    for v in (1, 2)}
            which = [v for v in (1, 2) if errs[v] <= atol]
            if len(which) != 1:
                fail(f"{label}: an answer is neither version's: {errs}")
            v = which[0]
            counts[v] += 1
            if t_recv < flip["start"] and v != 1:
                fail(f"{label}: v2 answered before the flip")
            if t_send > flip["end"] and v != 2:
                fail(f"{label}: v1 answered a request sent after promote "
                     "returned")
            if v == 2 and t_recv > flip["end"]:
                first_v2 = t_recv if first_v2 is None else min(first_v2,
                                                               t_recv)
        # v1 stays addressable
        with _client(harness.http_port) as c:
            inp = http.InferInput("TOKENS", [1, S], "INT32")
            inp.set_data_from_numpy(x[:1])
            old = c.infer(FLEET_MODEL, [inp], model_version="1") \
                .as_numpy("LOGPROBS")
        if float(np.abs(old[0] - want[1][0]).max()) > atol:
            fail(f"{label}: version 1 is not addressable after the update")
        print(f"{label}: {outcome} in {update_s:.2f} s under c = 4, zero "
              f"caller errors; answers v1 {counts[1]}, v2 {counts[2]}; v2 "
              f"warmed by 1 sample ({cfg_t.n_layers} flash launches), "
              f"{executions} forwards in the window, launches {launches}; "
              f"flip to the first v2 answer "
              f"{1e3 * (first_v2 - flip['end']):.1f} ms; v1's batcher "
              f"drained, v1 addressable; {CARD}", flush=True)

        # a version that fails every request: rolled back, memory returned
        label = "fleet rollback"
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        v3 = _fleet_version(torch, FLEET_SEEDS[3], warmup=False,
                            fail_requests=True)
        box = {}
        th = threading.Thread(target=lambda: box.setdefault(
            "outcome", ctl.rolling_update(FLEET_MODEL, v3, bake_s=30.0)),
            daemon=True)
        th.start()
        failed = 0
        c = _client(harness.http_port)
        try:
            inp = http.InferInput("TOKENS", [1, S], "INT32")
            inp.set_data_from_numpy(x[:1])
            end = time.monotonic() + 60
            while th.is_alive():
                if time.monotonic() > end:
                    fail(f"{label}: no rollback within 60 s")
                try:
                    c.infer(FLEET_MODEL, [inp])
                except Exception:  # noqa: BLE001 - v3 fails each request
                    failed += 1
            th.join()
            if box.get("outcome") != "rolled_back":
                fail(f"{label}: outcome {box}")
            after = c.infer(FLEET_MODEL, [inp]).as_numpy("LOGPROBS")
        finally:
            c.close()
        if float(np.abs(after[0] - want[2][0]).max()) > atol:
            fail(f"{label}: the default is not v2 after the rollback")
        del v3
        gc.collect()
        torch.cuda.synchronize()
        mem = torch.cuda.memory_allocated()
        print(f"{label}: rolled back to v2 after {failed} failed requests; "
              f"device memory {base} before v3 was staged, {mem} after "
              f"({mem - base:+d} bytes); update events "
              f"{dict(ctl.update_events)}; {CARD}", flush=True)
        if abs(mem - base) > REPO_MEM_TOL:
            fail(f"{label}: device memory {mem - base:+d} bytes against "
                 "before the staging")
        del v1, v2


def _fleet_autoscale(torch, counters, sampler) -> None:
    """Part 4: bert_large int8 ``w2`` at BERT_SERVE_LAYERS under the fleet
    controller (bounds 1..8, pinned at 1): a c = 16 -b 32 backlog from
    perf_analyzer scales it out one instance a cooldown; an idle window
    scales it back in.  infer/s and the idle share at each in-flight count
    it passes through; int8 once per layer of every forward."""
    from triton_client_tpu_torch.models import language
    from triton_client_tpu_torch.server.fleet import FleetController

    label = "fleet autoscale"
    S, V = language.BERT_SEQ_LEN, language.BERT_LARGE.vocab_size
    os.environ.update(TRITON_TPU_QUANT="int8", TRITON_TPU_INT8_FUSED="w2")
    try:
        with bert_depth(BERT_SERVE_LAYERS):
            model = language.make_bert_large("cuda")
            layers = language.BERT_LARGE.n_layers
            with serving_harness([model]) as harness:
                core = harness.core
                # the duty cycle's window: scale-in reads idleness within
                # 2 s of the load's end, not the default minute
                core.device_stats.window_s = 1.0
                # held at 1 until perf_analyzer's window opens (below)
                ctl = FleetController(
                    core, interval_s=0.1, bounds={"bert_large": (1, 1)},
                    queue_high=1.0,
                    scale_out_cooldown_s=FLEET_SCALE_COOLDOWN_S,
                    scale_in_cooldown_s=0.2, idle_cycles=3)
                core.fleet = ctl
                ctl.scale_to("bert_large", 1)
                x = model_tokens(BERT_SEED, 32, S, V)
                with _client(harness.http_port) as c:
                    got, _ = _post_infer(c, "bert_large",
                                         [("INPUT_IDS", "INT32", x)],
                                         ["LOGITS"])
                check_precision(label, model.transformer, True)
                bert_check(label, torch, model, True, x)(
                    "before the load", got["LOGITS"])
                batcher = core._batchers["bert_large@1"]
                timeline, stop = [(time.perf_counter(), 1)], threading.Event()

                def watch():
                    while not stop.is_set():
                        n = batcher.instances
                        if n != timeline[-1][1]:
                            timeline.append((time.perf_counter(), n))
                        time.sleep(0.005)

                def open_bounds():
                    # the tool's first request starts its 1 s warm-up; one
                    # cooldown of the window at 1 in flight, then the
                    # ladder up, one instance a cooldown
                    end = time.monotonic() + 120
                    while not model.stats.executions:
                        if stop.is_set() or time.monotonic() > end:
                            return
                        time.sleep(0.005)
                    time.sleep(1.0 + FLEET_SCALE_COOLDOWN_S)
                    ctl.bounds["bert_large"] = (1, 8)

                watcher = threading.Thread(target=watch, daemon=True)
                watcher.start()
                opener = threading.Thread(target=open_bounds, daemon=True)
                opener.start()
                ctl.start()
                try:
                    results, launches, executions, _ = _perf_analyzer(
                        label, harness, model,
                        ["-b", "32", "--concurrency-range", "16:16"],
                        counters, FLEET_SCALE_WINDOW_MS)
                    res = results[0]
                    if res["errors"]:
                        fail(f"{label}: {res['errors']} errors")
                    check_launches(label, launches, len(executions), 0,
                                   layers)
                    FLEET_PATHS[label] = launches
                    peak = max(n for _, n in timeline)
                    t_idle = time.perf_counter()
                    end = time.monotonic() + 60
                    while batcher.instances != 1:
                        if time.monotonic() > end:
                            fail(f"{label}: no scale-in within 60 s "
                                 f"({batcher.instances} instances)")
                        time.sleep(0.05)
                    in_s = time.perf_counter() - t_idle
                finally:
                    ctl.stop()
                    stop.set()
                    watcher.join(timeout=10)
                    opener.join(timeout=10)
                w0, w1 = res["window_start_s"], res["window_end_s"]
                print(f"{label}: c=16 -b 32 {res['throughput']:.3f} infer/s "
                      f"over the window, scaled out to {peak} instances "
                      f"(events {dict(ctl.scale_events)}), back to 1 in "
                      f"{in_s:.1f} s idle; launches {launches} over "
                      f"{len(executions)} forwards", flush=True)
                if peak < 4 or ctl.scale_events.get(
                        ("bert_large", "in"), 0) < 1:
                    fail(f"{label}: scaled out to {peak}, in "
                         f"{ctl.scale_events}")
                spans = timeline + [(w1, None)]
                for (a, n), (b, _) in zip(spans, spans[1:]):
                    lo, hi = max(a, w0), min(b, w1)
                    if hi - lo < 0.3:
                        continue
                    done = sum(1 for t_end, _ in executions
                               if lo <= t_end < hi)
                    print(f"{label}: {n} in flight for {hi - lo:.2f} s: "
                          f"{done / (hi - lo):.3f} infer/s, card idle "
                          f"{_share(sampler.idle(lo, hi))}; {CARD}",
                          flush=True)
    finally:
        for var in ("TRITON_TPU_QUANT", "TRITON_TPU_INT8_FUSED"):
            os.environ.pop(var, None)


def fleet_phase(torch, counters) -> None:
    """The fleet: two CLI servers (``--frontends 2`` and ``1``) start in
    processes of their own while the autoscaler runs in this process, then
    the frontend comparison, the CUDA region across siblings and the
    SIGKILL drill; the rolling update runs in this process while the
    killed worker restarts, then the healed worker's answers and the
    drained exit.  Every child process is stopped on every exit path."""
    sampler = _UtilSampler()
    servers = []

    def step(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"fleet: {name} took {time.perf_counter() - t0:.1f} s",
              flush=True)
        return out

    try:
        # the pair's workers write their bundles under FLEET incidents;
        # a worker_kill draw fires on ``simple`` only (no other drill
        # sends it)
        fleet_dir = _incident_dir("fleet")
        servers = [_FleetServer(2, "--incident-dir", fleet_dir, "--chaos",
                                "1.0", "--chaos-kinds", "worker_kill",
                                "--chaos-model", "simple"),
                   _FleetServer(1, "--incident-dir",
                                _incident_dir("fleet-single"))]
        servers[0].incident_dir = fleet_dir
        # the fleets start while the autoscaler runs in this process: its
        # readings share the host with their start
        step("autoscaler", _fleet_autoscale, torch, counters, sampler)
        step("worker_kill and SIGUSR2", _fleet_incidents, servers[0])
        check, x = step("frontends", _fleet_frontends, torch, *servers,
                        sampler)
        idx, victim, t_kill, respawn = step("kill", _fleet_kill,
                                            servers[0])
        # the rolling update runs while the killed worker restarts; its one
        # timing, the flip to the first v2 answer, shares the host with
        # that start
        step("rolling update", _fleet_rolling, torch, counters)
        step("healing", _fleet_healed, servers[0], idx, victim, t_kill,
             respawn, check, x)
    finally:
        for srv in servers:
            srv.close()
        sampler.close()


# ---------------------------------------------------------------------------
# the cluster client and the response cache
# ---------------------------------------------------------------------------

CC_PATHS = {}
#: each balancing and hedging window, and the SIGKILL window
CC_WINDOW_MS, CC_KILL_WINDOW_MS = 2000, 3000
#: the straggler's injected latency, and the hedge's fixed delay: a
#: backup sent after CC_HEDGE_MS has CC_STRAGGLE_MS - CC_HEDGE_MS to win
#: on the other replica, which then takes every request's load
CC_STRAGGLE_MS, CC_HEDGE_MS = 1000, 100
#: hedged requests the script sends itself, each answer held
CC_HEDGED = 8
#: bert_large's cached entries: their TTL and the byte budget (one
#: LOGITS entry of B = 32 is 98,304 bytes: two do not fit)
CC_TTL_S, CC_BUDGET = 3.0, 150_000
#: timed hits and misses (each miss a token set of its own)
CC_TIMED = 8
#: bert_large's depth in the cache drill: all of it
CC_BERT_LAYERS = 24
#: rows of every longctx_tpu request of the phase (-b 4): a server's
#: success count is in rows
CC_ROWS = 4


def _cc_stats(url: str, model: str = "longctx_tpu"):
    """A server's (requests answered, executions) of ``model``, from its
    ``/v2/models/<model>/stats`` (its success count is in rows, CC_ROWS a
    request); None where it does not answer."""
    try:
        with urllib.request.urlopen(
                f"http://{url}/v2/models/{model}/stats", timeout=10) as r:
            s = json.loads(r.read())["model_stats"][0]
    except OSError:
        return None
    return (int(s["inference_stats"]["success"]["count"]) // CC_ROWS,
            int(s["execution_count"]))


def _cc_one(srv, x):
    """One longctx_tpu request of ``x`` to the CLI replica ``srv`` on a
    connection of its own: its LOGPROBS."""
    client = _client(srv.port)
    try:
        got, _ = _post_infer(client, "longctx_tpu",
                             [("TOKENS", "INT32", x)], ["LOGPROBS"])
    finally:
        client.close()
    return got["LOGPROBS"]


def _cc_perf(label, urls, args, window_ms: int):
    """``perf_analyzer -v`` over the cluster ``urls`` in a process of its
    own: its one level's result (zero errors, or the run fails)."""
    cmd = [sys.executable, "-m", "triton_client_tpu_torch.perf_analyzer",
           "-m", "longctx_tpu", "-u", ",".join(urls), "-v",
           "--measurement-interval", str(window_ms), *args]
    proc = subprocess.run(cmd, cwd=REPO, env=dict(os.environ,
                                                  PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=600)
    return _fleet_result(label, proc)


def _cc_by(res, key: str, urls) -> list:
    """A cluster result's per-endpoint counts in the order of ``urls``."""
    return [res[key].get(u, 0) for u in urls]


def _cc_line(label, res, urls, split) -> None:
    print(f"{label}: {res['throughput']:.3f} infer/s, p50 "
          f"{res['p50_us'] / 1e3:.3f} ms, p99 {res['p99_us'] / 1e3:.3f} ms, "
          f"errors {res['errors']}; the client's requests by endpoint "
          f"{_cc_by(res, 'endpoints_run', urls)} (in the window "
          f"{_cc_by(res, 'endpoints', urls)}); each replica's own "
          f"(requests, executions) {split}; hedges {res['hedges']} (won "
          f"{res['hedge_wins']}); {CARD}", flush=True)


def _cc_balancing(torch, counters) -> None:
    """Two in-process replicas of longctx_tpu base bf16 (a ``ClusterHarness``
    in this process) under ``perf_analyzer -u A,B -b 4`` at c = 4, once per
    policy: both replicas execute, the client's requests by endpoint equal
    each replica's count, and flash launches exactly 8 per execution."""
    from triton_client_tpu_torch.models import language
    from triton_client_tpu_torch.server.registry import ModelRegistry
    from triton_client_tpu_torch.server.testing import ClusterHarness

    models = []

    def factory():
        r = ModelRegistry()
        models.append(language.make_longctx_tpu("cuda"))
        r.register_model(models[-1])
        return r

    with ClusterHarness(factory, n=2) as ch:
        for h, m in zip(ch.harnesses, models):
            _warm(h, m, m.max_batch_size)
            check_precision("cluster balancing", m.transformer, False)
        flash = models[0].transformer.cfg.n_layers
        for policy in ("round_robin", "least_outstanding"):
            label = f"cluster {policy} -u A,B c=4 -b 4"
            before = [(m.stats.success_count // CC_ROWS,
                       m.stats.execution_count) for m in models]
            _reset(counters)
            res = _cc_perf(label, ch.http_urls,
                           ["-b", str(CC_ROWS), "--concurrency-range", "4:4",
                            "--balancing", policy], CC_WINDOW_MS)
            launches = {n: mod.launches for n, mod in counters.items()}
            launches["int8_quantize_rows"] = \
                counters["int8_matmul"].quantize_launches
            split = [(m.stats.success_count // CC_ROWS - b[0],
                      m.stats.execution_count - b[1])
                     for m, b in zip(models, before)]
            _cc_line(label, res, ch.http_urls, split)
            if any(n == 0 for n, _ in split):
                fail(f"{label}: a replica executed nothing: {split}")
            if _cc_by(res, "endpoints_run", ch.http_urls) \
                    != [n for n, _ in split]:
                fail(f"{label}: the client's requests by endpoint "
                     f"{res['endpoints_run']} are not the replicas' "
                     f"{split}")
            check_launches(label, launches, sum(e for _, e in split),
                           flash, 0)
            CC_PATHS[label] = launches


def _cc_wait_executed(label, urls, at_window, end_s: float) -> list:
    """The replicas that executed since ``at_window`` (polled until one
    has, or ``end_s`` on the monotonic clock)."""
    while True:
        now = [_cc_stats(u) for u in urls]
        busy = [i for i, (a, b) in enumerate(zip(now, at_window))
                if a is not None and b is not None and a[1] > b[1]]
        if busy:
            return busy
        if time.monotonic() > end_s:
            fail(f"{label}: no replica executed in the window before the "
                 f"kill ({at_window} -> {now})")
        time.sleep(0.02)


def _cc_failover(pair):
    """One CLI replica SIGKILLed a quarter into a c = 4 ``--retries 3``
    window, among those that executed in it: zero caller errors; the
    requests sent again, the breakers' transitions and the split after the
    kill printed.  Returns the survivor."""
    import signal

    label = "cluster failover"
    urls = [srv.url for srv in pair]
    cmd = [sys.executable, "-m", "triton_client_tpu_torch.perf_analyzer",
           "-m", "longctx_tpu", "-u", ",".join(urls), "-v", "-b",
           str(CC_ROWS), "--concurrency-range", "4:4", "--retries", "3",
           "--measurement-interval", str(CC_KILL_WINDOW_MS)]
    start = [_cc_stats(u) for u in urls]
    proc = subprocess.Popen(cmd, cwd=REPO, env=dict(os.environ,
                                                    PYTHONPATH=REPO),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        end = time.monotonic() + 120
        while [_cc_stats(u) for u in urls] == start:
            if proc.poll() is not None or time.monotonic() > end:
                fail(f"{label}: perf_analyzer sent nothing")
            time.sleep(0.02)
        time.sleep(1.0)  # the tool's warm-up
        at_window = [_cc_stats(u) for u in urls]
        time.sleep(CC_KILL_WINDOW_MS / 4e3)
        idx = _cc_wait_executed(label, urls, at_window,
                                time.monotonic() + CC_KILL_WINDOW_MS / 2e3)[0]
        pre = _cc_stats(urls[idx])
        t_kill = time.perf_counter()
        os.kill(pair[idx].proc.pid, signal.SIGKILL)
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    res = _fleet_result(label, subprocess.CompletedProcess(
        cmd, proc.returncode, out, err))
    if not res["window_start_s"] <= t_kill <= res["window_end_s"]:
        fail(f"{label}: the kill at {t_kill:.3f} fell outside the window "
             f"[{res['window_start_s']:.3f}, {res['window_end_s']:.3f}]")
    survivor = 1 - idx
    after = _cc_stats(urls[survivor])
    split = [((pre if i == idx else after)[0] - start[i][0])
             for i in range(2)]
    print(f"{label}: replica {idx} ({urls[idx]}, pid {pair[idx].proc.pid}) "
          f"SIGKILLed inside the window after {pre[0] - at_window[idx][0]} "
          f"requests in it: {res['throughput']:.3f} infer/s, p99 "
          f"{res['p99_us'] / 1e3:.3f} ms, errors {res['errors']}; requests "
          f"sent again: {res['retries_run']} by the retry policy, "
          f"{res['resends_run']} on a new connection; breakers "
          f"{res['breakers']}; the client's requests by endpoint "
          f"{_cc_by(res, 'endpoints_run', urls)}, each replica's own "
          f"{split} (the victim's to the kill); the survivor's after the "
          f"kill {after[0] - at_window[survivor][0]} from the window's "
          f"start; {CARD}", flush=True)
    if res["retries_run"] + res["resends_run"] < 1:
        fail(f"{label}: no request was sent again across the kill")
    if "open" not in res["breakers"][urls[idx]]:
        fail(f"{label}: the victim's breaker never opened: "
             f"{res['breakers']}")
    return pair[survivor]


def _cc_hedging(torch, survivor, straggler, check, x) -> None:
    """The survivor and a replica behind chaos latency (every longctx_tpu
    request CC_STRAGGLE_MS late): the same c = 4 round-robin window
    without and with ``--hedge-ms``, p99 both ways; hedge wins; then
    CC_HEDGED hedged requests from this process, each answer held to the
    plain forward.  Round robin: under least outstanding the straggler's
    queue of backups keeps the primaries off it, and a backup sent to the
    straggler never wins."""
    from triton_client_tpu_torch import http
    from triton_client_tpu_torch._telemetry import telemetry
    from triton_client_tpu_torch.cluster import ClusterClient, HedgePolicy

    label = "cluster hedging"
    urls = [survivor.url, straggler.url]
    check("the straggler's warm-up", _cc_one(straggler, x))
    runs = {}
    for hedge in (False, True):
        name = f"{label} c=4 -b 4" + (f" --hedge-ms {CC_HEDGE_MS}" if hedge
                                      else "")
        before = [_cc_stats(u) for u in urls]
        res = _cc_perf(name, urls, ["-b", str(CC_ROWS),
                                    "--concurrency-range", "4:4",
                                    "--balancing", "round_robin"]
                       + (["--hedge-ms", str(CC_HEDGE_MS)] if hedge else []),
                       CC_WINDOW_MS)
        split = [(a[0] - b[0], a[1] - b[1]) for a, b in
                 zip([_cc_stats(u) for u in urls], before)]
        _cc_line(name, res, urls, split)
        runs[hedge] = res
    print(f"{label}: p99 without / with --hedge-ms {CC_HEDGE_MS}: "
          f"{runs[False]['p99_us'] / 1e3:.3f} / "
          f"{runs[True]['p99_us'] / 1e3:.3f} ms (the straggler "
          f"+{CC_STRAGGLE_MS} ms); hedges {runs[True]['hedges']}, won "
          f"{runs[True]['hedge_wins']}; {CARD}", flush=True)
    if not runs[True]["hedge_wins"] > 0:
        fail(f"{label}: no hedge won ({runs[True]['hedges']} issued)")
    snap = telemetry().snapshot()["hedges"]
    h0 = sum(h["hedges"] for h in snap), sum(h["wins"] for h in snap)
    hedge = HedgePolicy(default_delay_s=CC_HEDGE_MS / 1e3,
                        min_samples=1 << 30)
    with ClusterClient(urls, protocol="http", policy="round_robin",
                       hedge=hedge,
                       client_kwargs={"network_timeout": 300}) as c:
        for k in range(CC_HEDGED):
            inp = http.InferInput("TOKENS", list(x.shape), "INT32")
            inp.set_data_from_numpy(x)
            r = c.infer("longctx_tpu", [inp], hedge=True,
                        outputs=[http.InferRequestedOutput("LOGPROBS")])
            check(f"hedged request {k}", r.as_numpy("LOGPROBS"))
    snap = telemetry().snapshot()["hedges"]
    hedges = sum(h["hedges"] for h in snap) - h0[0]
    wins = sum(h["wins"] for h in snap) - h0[1]
    print(f"{label}: {CC_HEDGED} hedged requests from this process: "
          f"{hedges} hedges, {wins} won, every answer within SERVED_ATOL",
          flush=True)
    if not wins > 0:
        fail(f"{label}: none of this process's hedges won")


def _cc_cache(torch, counters) -> None:
    """bert_large int8 ``w2`` at full depth (24 layers), B = 32, by wire,
    with its response cache on (TTL CC_TTL_S, byte budget CC_BUDGET): a
    hit answers the miss's bytes with no launch, a miss launches int8
    exactly 24 times, the server's hit and miss counters equal what was
    sent, a budget under two entries evicts, and after the TTL a repeat
    misses again; a hit's p50 against a miss's."""
    import numpy as np

    from triton_client_tpu_torch.models import language

    label = "response cache bert_large int8 w2"
    os.environ["TRITON_TPU_QUANT_BERT_LARGE"] = "int8"
    os.environ["TRITON_TPU_INT8_FUSED"] = "w2"
    try:
        with bert_depth(CC_BERT_LAYERS):
            bert = language.make_bert_large("cuda")
            layers = language.BERT_LARGE.n_layers
        bert.config.response_cache = True
        bert.config.parameters["response_cache.ttl_s"] = str(CC_TTL_S)
        S, V = language.BERT_SEQ_LEN, language.BERT_LARGE.vocab_size
        xs = [model_tokens(BERT_SEED + 100 + k, 32, S, V)
              for k in range(4 + CC_TIMED)]
        with serving_harness([bert]) as harness:
            cache = harness.core.response_cache
            cache.budget_bytes = CC_BUDGET
            _warm(harness, bert, 32)  # the weights, and a first entry
            check_precision(label, bert.transformer, True)
            check = bert_check(label, torch, bert, True, xs[0])
            client = _client(harness.http_port)
            tally = {"hits": 0, "misses": 0, "evictions": 0}
            c0 = (cache.hits_by_model.get("bert_large", 0),
                  cache.misses_by_model.get("bert_large", 0),
                  cache.evictions_by_model.get("bert_large", 0))
            times = {"hit": [], "miss": []}

            def send(x, hit: bool, evicts: int = 0):
                _reset(counters)
                got, dt = _post_infer(client, "bert_large",
                                      [("INPUT_IDS", "INT32", x)],
                                      ["LOGITS"])
                launches = {n: mod.launches for n, mod in counters.items()}
                launches["int8_quantize_rows"] = \
                    counters["int8_matmul"].quantize_launches
                check_launches(f"{label} {'hit' if hit else 'miss'}",
                               launches, 0 if hit else 1, 0, layers)
                tally["hits" if hit else "misses"] += 1
                tally["evictions"] += evicts
                times["hit" if hit else "miss"].append(dt)
                return got["LOGITS"]

            miss = send(xs[0], False, evicts=1)  # the warm-up's entry goes
            check("the first miss", miss)
            hit = send(xs[0], True)
            if hit.tobytes() != miss.tobytes():
                fail(f"{label}: the hit's bytes differ from the miss's")
            for _ in range(CC_TIMED):
                send(xs[0], True)
            send(xs[1], False, evicts=1)           # the budget: xs[0] goes
            again = send(xs[0], False, evicts=1)   # ... so it misses
            if again.tobytes() != miss.tobytes():
                fail(f"{label}: a repeat's miss answers other bytes")
            t_put = time.monotonic()
            send(xs[0], True)
            time.sleep(max(0.0, t_put + CC_TTL_S + 0.2 - time.monotonic()))
            send(xs[0], False, evicts=1)           # expired: a miss again
            for k in range(CC_TIMED):
                send(xs[2 + k], False, evicts=1)
            client.close()
            fams = _metrics(harness.http_port)
        got = {k: _metric_sum(fams, name, model="bert_large") - c
               for (k, name), c in zip((
                   ("hits", "nv_cache_num_hits_per_model"),
                   ("misses", "nv_cache_num_misses_per_model"),
                   ("evictions", "nv_cache_num_evictions_per_model")), c0)}
        if got != tally:
            fail(f"{label}: /metrics counted {got}, the script sent "
                 f"{tally}")
        p50 = {k: 1e3 * float(np.median(v)) for k, v in times.items()}
        print(f"{label}: {tally['hits']} hits, {tally['misses']} misses, "
              f"{tally['evictions']} evictions (budget {CC_BUDGET} bytes, "
              f"TTL {CC_TTL_S:g} s), as /metrics counts them; int8 "
              f"launches {layers} a miss, 0 a hit; the hit's bytes the "
              f"miss's; p50 hit {p50['hit']:.3f} ms against miss "
              f"{p50['miss']:.3f} ms (by wire, B = 32); {CARD}", flush=True)
        CC_PATHS[label] = {"flash_attention": 0,
                           "int8_matmul": layers * tally["misses"]}
    finally:
        for var in ("TRITON_TPU_QUANT_BERT_LARGE", "TRITON_TPU_INT8_FUSED"):
            os.environ.pop(var, None)


def cluster_cache_phase(torch, counters) -> None:
    """The cluster client and the response cache: three CLI replicas of
    longctx_tpu base bf16 start (one behind chaos latency) while two
    in-process replicas serve the balancing runs and bert_large serves the
    cache drill here; then the SIGKILL failover over two CLI replicas,
    then hedging over the survivor and the straggler.  Every child process
    is stopped on every exit path."""
    from triton_client_tpu_torch.models import language

    servers = []

    def step(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"cluster and cache: {name} took "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        return out

    try:
        servers = [_FleetServer(1, name=f"cluster_{i}") for i in range(2)]
        servers.append(_FleetServer(
            1, "--chaos", "1.0", "--chaos-kinds", "latency",
            "--chaos-latency-ms", str(CC_STRAGGLE_MS), "--chaos-model",
            "longctx_tpu", name="cluster_straggler"))
        step("balancing", _cc_balancing, torch, counters)
        step("response cache", _cc_cache, torch, counters)
        ref = language.make_longctx_tpu("cuda")
        run = ref.transformer
        run._ensure()
        x = model_tokens(LONGCTX_SEED, ref.max_batch_size,
                         ref.config.input[0].dims[0], 256)
        check = _longctx_holder("cluster", torch, run, x)
        del ref, run
        for srv in servers:
            srv.wait_up("cluster")
        for srv in servers[:2]:
            check(f"replica {srv.url}'s warm-up", _cc_one(srv, x))
        survivor = step("failover", _cc_failover, servers[:2])
        step("hedging", _cc_hedging, torch, survivor, servers[2], check, x)
    finally:
        for srv in servers:
            srv.close()


# ---------------------------------------------------------------------------
# the operators' tools and the wire templates
# ---------------------------------------------------------------------------

TW_PATHS = {}
#: the phase's trace files and the Chrome export (inside the checkout)
TW_DIR = os.path.join(REPO, "build", "chip_smoke_tools")
#: requests of each model by each protocol while traced: one first, then
#: this many one after another
TW_SEQUENTIAL = 3
#: the calls each encoder is timed over, on the same responses
TW_ENCODE_CALLS = 200
#: bert_large response-cache hits timed by wire
TW_HITS = 16
#: bert_large's depth in this phase: all of it
TW_BERT_LAYERS = 24


def _tw_tool(label: str, module: str, *args: str) -> str:
    """``python -m triton_client_tpu_torch.tools.<module> ARGS`` in a
    process of its own: its standard output (a non-zero exit fails)."""
    proc = subprocess.run(
        [sys.executable, "-m", f"triton_client_tpu_torch.tools.{module}",
         *args], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"{label}: tools.{module} exited {proc.returncode}: "
             f"{proc.stderr.strip()[-400:]}")
    return proc.stdout


def _tw_set_trace(port: int, level: str, path: str = "") -> None:
    """The server's tracing on (TIMESTAMPS into ``path``, every request)
    or off, through the port's client."""
    client = _client(port)
    try:
        settings = {"trace_level": [level]}
        if path:
            settings.update(trace_file=[path], trace_rate=["1"],
                            trace_count=["-1"], log_frequency=["0"])
        client.update_trace_settings(settings=settings)
    finally:
        client.close()


def _tw_median_us(fn, calls: int) -> float:
    """The median of ``calls`` calls of ``fn``, in microseconds."""
    import statistics

    times = []
    for _ in range(calls):
        t0 = time.perf_counter_ns()
        fn()
        times.append(time.perf_counter_ns() - t0)
    return statistics.median(times) / 1e3


def _tw_templates(label, harness, model, counters, x, rows: int):
    """One served response of ``x`` from the core (its host outputs, as
    the frontends get them): the HTTP header and segments stamped from a
    template and the gRPC message stamped from one are byte for byte the
    slow path's; then each encoder timed over TW_ENCODE_CALLS calls on
    that response.  Returns {what: median us}."""
    from triton_client_tpu_torch.server import wire
    from triton_client_tpu_torch.server.types import (InferRequest,
                                                      InputTensor,
                                                      RequestedOutput)

    cfg = model.config
    name = cfg.output[0].name
    req = InferRequest(model.name, inputs=[InputTensor(
        cfg.input[0].name, cfg.input[0].data_type, tuple(x.shape), data=x)],
        outputs=[RequestedOutput(name)], id="tw-1")
    resp, _, _ = _counted(f"{label} core", model, counters,
                          lambda: harness.core.infer(req),
                          *((model.transformer.cfg.n_layers, 0)
                            if model.name == "longctx_tpu"
                            else (0, model.transformer.cfg.n_layers)),
                          paths=TW_PATHS)
    requested = {name: req.outputs[0]}
    http_cache, grpc_cache = (wire.ResponseTemplateCache(),
                              wire.ResponseTemplateCache())

    def slow_http():
        return wire.encode_http_response(resp, requested, True)

    def stamp_http():
        return wire.encode_http_response(resp, requested, True, http_cache,
                                         1)

    def slow_grpc():
        return wire.build_pb_response(resp).encode_parts()

    def stamp_grpc():
        return wire.encode_pb_response(resp, grpc_cache, 1).encode_parts()

    for _ in range(2):  # the compile, then a stamp
        (sh, ss), (th, ts) = slow_http(), stamp_http()
        if sh != th or [bytes(s) for s in ss] != [bytes(s) for s in ts]:
            fail(f"{label}: the stamped HTTP response differs from the "
                 "slow path's")
        slow_pb = wire.build_pb_response(resp).SerializeToString()
        if wire.encode_pb_response(resp, grpc_cache,
                                   1).SerializeToString() != slow_pb:
            fail(f"{label}: the stamped gRPC message differs from the "
                 "slow path's")
    if (http_cache.stats["hits"], grpc_cache.stats["hits"]) != (1, 1):
        fail(f"{label}: the templates did not stamp: {http_cache.stats}, "
             f"{grpc_cache.stats}")
    times = {}
    for what, fn in (("http slow", slow_http), ("http stamp", stamp_http),
                     ("grpc slow", slow_grpc), ("grpc stamp", stamp_grpc)):
        fn()
        times[what] = _tw_median_us(fn, TW_ENCODE_CALLS)
    print(f"{label}: B = {rows}, {name} {list(resp.outputs[0].shape)} "
          f"({ss[0].nbytes} bytes); stamped HTTP header and segments and "
          f"gRPC message byte for byte the slow path's; median of "
          f"{TW_ENCODE_CALLS} calls each: HTTP slow "
          f"{times['http slow']:.1f} us, stamp {times['http stamp']:.1f} us "
          f"({times['http slow'] / times['http stamp']:.2f}x); gRPC slow "
          f"{times['grpc slow']:.1f} us, stamp {times['grpc stamp']:.1f} us "
          f"({times['grpc slow'] / times['grpc stamp']:.2f}x); {CARD}",
          flush=True)
    return times


def tools_wire_phase(torch, counters) -> None:
    """The operators' tools and the wire templates: ``longctx_tpu`` base
    bf16 (flash 8 a forward) and ``bert_large`` int8 ``w2`` at 24 layers
    (int8 24 a forward) served here with server tracing (TIMESTAMPS) and
    the port's client telemetry tracing on; each model by HTTP and by
    gRPC-Web (1 + TW_SEQUENTIAL requests each), each answer within
    SERVED_ATOL of the plain-kernel forward, launches exactly per
    execution.  The servers' template caches hold one template per (model,
    output set) and protocol.  Then, tracing off, a served response of
    each model stamped byte for byte as the slow path encodes it, both
    encoders timed on it; ``bert_large``'s response-cache hits at B = 32
    timed by wire.  Then ``tools.trace_summary`` on the traces (every
    request counted, every journey joined, each model's COMPUTE median
    within its executions' CUDA-event range, a Chrome export with journey
    lanes) and ``tools.top --once --json`` (each model's successes as its
    statistics count them), each in a process of its own."""
    import shutil
    import statistics

    import numpy as np

    from triton_client_tpu_torch._telemetry import telemetry
    from triton_client_tpu_torch.models import language

    label = "tools and wire"
    shutil.rmtree(TW_DIR, ignore_errors=True)
    os.makedirs(TW_DIR)
    spath = os.path.join(TW_DIR, "server.json")
    cpath = os.path.join(TW_DIR, "client.json")
    os.environ["TRITON_TPU_QUANT_BERT_LARGE"] = "int8"
    os.environ["TRITON_TPU_INT8_FUSED"] = "w2"
    try:
        longctx = language.make_longctx_tpu("cuda")
        with bert_depth(TW_BERT_LAYERS):
            bert = language.make_bert_large("cuda")
        S, V = language.BERT_SEQ_LEN, language.BERT_LARGE.vocab_size
        rows = {"longctx_tpu": longctx.max_batch_size, "bert_large": 32}
        xs = {"longctx_tpu": model_tokens(LONGCTX_SEED + 17, rows[
            "longctx_tpu"], longctx.config.input[0].dims[0], 256),
              "bert_large": model_tokens(BERT_SEED + 17, 32, S, V)}
        models = {"longctx_tpu": longctx, "bert_large": bert}
        with serving_harness([longctx, bert]) as harness:
            port = harness.http_port
            for m in models.values():
                _warm(harness, m, rows[m.name])
            check_precision(label, longctx.transformer, False)
            check_precision(label, bert.transformer, True)
            checks = {
                "longctx_tpu": longctx_check(label, torch, longctx,
                                             xs["longctx_tpu"]),
                "bert_large": bert_check(label, torch, bert, True,
                                         xs["bert_large"])}
            per_forward = {
                "longctx_tpu": (longctx.transformer.cfg.n_layers, 0),
                "bert_large": (0, bert.transformer.cfg.n_layers)}
            _tw_set_trace(port, "TIMESTAMPS", spath)
            telemetry().enable_tracing(cpath)
            sent = {m: 0 for m in models}
            try:
                with _obs_executions(longctx) as l_runs, \
                        _obs_executions(bert) as b_runs:
                    for name, m in models.items():
                        cfg = m.config
                        inp = (cfg.input[0].name, cfg.input[0].data_type,
                               list(xs[name].shape))
                        out = (cfg.output[0].name, cfg.output[0].data_type,
                               [rows[name]] + list(cfg.output[0].dims))
                        for protocol in ("http", "grpc"):
                            (answer, _), n_exec, _ = _counted(
                                f"{label} {name} {protocol}", m, counters,
                                lambda: run_sequential(
                                    WireClient(port, inp, out, protocol),
                                    name, xs[name], TW_SEQUENTIAL),
                                *per_forward[name], paths=TW_PATHS)
                            if n_exec != 1 + TW_SEQUENTIAL:
                                fail(f"{label} {name} {protocol}: {n_exec} "
                                     f"executions for {1 + TW_SEQUENTIAL} "
                                     "requests")
                            checks[name](f"{protocol} wire", answer)
                            sent[name] += 1 + TW_SEQUENTIAL
            finally:
                telemetry().disable_tracing()
                _tw_set_trace(port, "OFF")
            exec_ms = {"longctx_tpu": sorted(
                s.elapsed_time(e) for _, s, e in l_runs), "bert_large":
                sorted(s.elapsed_time(e) for _, s, e in b_runs)}
            core = harness.core
            for cache, proto in ((core.http_wire_templates, "HTTP"),
                                 (core.grpc_wire_templates, "gRPC")):
                held = {m: cache.templates(m) for m in models}
                if held != {m: 1 for m in models} or cache.stats["errors"]:
                    fail(f"{label}: the {proto} template cache holds "
                         f"{held}, stats {cache.stats}")
                print(f"{label}: the server's {proto} templates: one per "
                      f"model; {cache.stats}", flush=True)
            times = {name: _tw_templates(f"{label} {name}", harness, m,
                                         counters, xs[name], rows[name])
                     for name, m in models.items()}
            # bert_large's response cache: one miss, then hits by wire
            bert.config.response_cache = True
            client = _client(port)
            hits = []

            def cached():
                _post_infer(client, "bert_large",
                            [("INPUT_IDS", "INT32", xs["bert_large"])],
                            ["LOGITS"])
                for _ in range(TW_HITS):
                    got, dt = _post_infer(
                        client, "bert_large",
                        [("INPUT_IDS", "INT32", xs["bert_large"])],
                        ["LOGITS"])
                    hits.append(dt)
                return got["LOGITS"]

            try:
                hit, n_exec, _ = _counted(
                    f"{label} bert_large response cache", bert, counters,
                    cached, *per_forward["bert_large"], paths=TW_PATHS)
            finally:
                client.close()
                bert.config.response_cache = False
            if n_exec != 1:
                fail(f"{label}: {n_exec} executions for one miss and "
                     f"{TW_HITS} hits")
            checks["bert_large"]("a response-cache hit", hit)
            hit_ms = 1e3 * statistics.median(hits)
            print(f"{label}: bert_large int8 w2 response-cache hit p50 "
                  f"{hit_ms:.3f} ms by wire, B = 32, over {TW_HITS} hits "
                  f"(the cluster and cache phase's hits: PERF.md); {CARD}",
                  flush=True)

            # the tools, each in a process of its own
            summary = json.loads(_tw_tool(
                label, "trace_summary", spath, "--client", cpath,
                "--format", "json"))
            n = sum(sent.values())
            jo = summary.get("journeys") or {}
            got = {m: e["count"] for m, e in summary["models"].items()}
            if summary["requests"] != n or got != sent \
                    or summary["join"]["joined"] != n \
                    or (jo.get("count"), jo.get("complete"),
                        jo.get("orphan_server_traces")) != (n, n, 0):
                fail(f"{label}: trace_summary read {summary['requests']} "
                     f"requests {got}, joined {summary['join']['joined']}, "
                     f"journeys {jo.get('count')} ({jo.get('complete')} "
                     f"complete, {jo.get('orphan_server_traces')} orphans); "
                     f"sent {sent}")
            serialize = {}
            for name in models:
                stages = summary["models"][name]["stages"]
                if "H2D_TRANSFER" in stages:
                    fail(f"{label}: {name}'s summary has an H2D_TRANSFER "
                         "row")
                compute = stages["COMPUTE"]["p50_us"] / 1e3
                lo, hi = exec_ms[name][0], exec_ms[name][-1]
                serialize[name] = stages["SERIALIZE"]["p50_us"]
                print(f"{label}: trace_summary {name}: "
                      f"{got[name]} requests, COMPUTE p50 {compute:.3f} ms "
                      f"against its executions' CUDA events {lo:.3f}-"
                      f"{hi:.3f} ms (bound {OBS_TOL:.0%}); SERIALIZE p50 "
                      f"{serialize[name]:.1f} us, NETWORK_WRITE p50 "
                      f"{stages['NETWORK_WRITE']['p50_us']:.1f} us; "
                      f"{CARD}", flush=True)
                if not lo * (1 - OBS_TOL) <= compute <= hi * (1 + OBS_TOL):
                    fail(f"{label}: {name}'s traced COMPUTE p50 "
                         f"{compute:.3f} ms is outside its executions' "
                         f"{lo:.3f}-{hi:.3f} ms")
            chrome_path = os.path.join(TW_DIR, "trace.chrome.json")
            _tw_tool(label, "trace_summary", spath, "--client", cpath,
                     "--format", "chrome", "-o", chrome_path, "-q")
            with open(chrome_path) as f:
                events = json.load(f)["traceEvents"]
            lanes = {e["pid"] for e in events if e["pid"] > 100}
            if len(lanes) != n:
                fail(f"{label}: the Chrome export has {len(lanes)} journey "
                     f"lanes for {n} journeys")
            snap = json.loads(_tw_tool(
                label, "top", "--url", f"127.0.0.1:{port}", "--once",
                "--json"))
            for name, m in models.items():
                stats = m.stats
                count = snap["recorder"]["models"][name]["count"]
                if count * rows[name] != stats.success_count \
                        or snap["models"][name]["error_pct"] != 0.0:
                    fail(f"{label}: top read {count} successes of "
                         f"{rows[name]} rows, the statistics "
                         f"{stats.success_count} rows; row "
                         f"{snap['models'][name]}")
            print(f"{label}: trace_summary counted {n} requests, joined "
                  f"{n} journeys, {len(lanes)} journey lanes in the Chrome "
                  "export; top --once --json: "
                  + ", ".join(f"{name} {snap['recorder']['models'][name]['count']} "
                              f"successes" for name in models)
                  + f", as the statistics count them; {CARD}", flush=True)
        print(f"{label}: the wire: " + "; ".join(
            f"{name} SERIALIZE p50 {serialize[name]:.1f} us traced, HTTP "
            f"stamp {times[name]['http stamp']:.1f} us against slow "
            f"{times[name]['http slow']:.1f} us, gRPC stamp "
            f"{times[name]['grpc stamp']:.1f} us against slow "
            f"{times[name]['grpc slow']:.1f} us" for name in models)
            + f"; response-cache hit p50 {hit_ms:.3f} ms; {CARD}",
            flush=True)
    finally:
        for var in ("TRITON_TPU_QUANT_BERT_LARGE", "TRITON_TPU_INT8_FUSED"):
            os.environ.pop(var, None)


def _signature_of(harness, model, x):
    """The input signature the server records for a batch like ``x``."""
    from triton_client_tpu_torch.server.core import _signature

    return _signature({model.config.input[0].name: x})



#: the bytecode of every module that this script and its child processes
#: import: the card's machine keeps none for most of the installed
#: packages, so each process (a server worker, perf_analyzer) would compile
#: PyTorch's sources again as it starts
PYCACHE = os.path.join(REPO, "build", "pycache")


def share_bytecode() -> None:
    """Write and read bytecode under PYCACHE, here and in every child."""
    os.makedirs(PYCACHE, exist_ok=True)
    os.environ["PYTHONPYCACHEPREFIX"] = PYCACHE
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.pycache_prefix = PYCACHE
    sys.dont_write_bytecode = False


def main() -> int:
    t_start = time.perf_counter()
    if not os.path.isdir(os.path.join(REPO, "triton_client_tpu_torch")):
        fail("triton_client_tpu_torch is not beside chip_smoke.py")
    share_bytecode()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available")
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
    global SM_CLOCK_HZ
    SM_CLOCK_HZ = sm_clock_hz
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
        # for its forward time and error: 8 requests (40, then 16, before
        # the cuts that made room for the fleet and the tools and wire
        # phases, PERF.md)
        phase("serve bert_large int8 fused=all", serve_bert,
              int8_per_layer=2, int8=True, fused="all", n_requests=8)
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
                           ("host view", host_view_phase, (torch, counters)),
                           ("overload", overload_phase, (torch, counters)),
                           ("generation", generation_phase,
                            (torch, counters)),
                           ("cache and faults", cache_faults_phase,
                            (torch, counters)),
                           ("openai, genai_perf and repository",
                            openai_repository_phase, (torch, counters)),
                           ("fleet", fleet_phase, (torch, counters)),
                           ("cluster and cache", cluster_cache_phase,
                            (torch, counters)),
                           ("tools and wire", tools_wire_phase,
                            (torch, counters))):
        t0 = time.perf_counter()
        fn(*args)
        print(f"{name} phase took {time.perf_counter() - t0:.1f} s",
              flush=True)
    # and every transport's window of the shared-memory phases, every
    # perf_analyzer run, every gRPC window, every vision window, every
    # observability run, every overload run, every generation window and
    # the cluster's balancing runs and the response cache's requests, and
    # the tools and wire phase's traced, encoded and cached requests
    paths.update(SHM_PATHS)
    paths.update(PERF_PATHS)
    paths.update(GRPC_PATHS)
    paths.update(VISION_PATHS)
    paths.update(OBS_PATHS)
    paths.update(HOST_PATHS)
    paths.update(OVERLOAD_PATHS)
    paths.update(GEN_PATHS)
    paths.update(CF_PATHS)
    paths.update(OAI_PATHS)
    paths.update(FLEET_PATHS)
    paths.update(CC_PATHS)
    paths.update(TW_PATHS)
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
    if sys.argv[1:2] == ["--genai-own"]:
        sys.exit(genai_own_main(sys.argv[2]))
    if sys.argv[1:2] == ["--obs-spread"]:
        sys.exit(obs_spread_main(int(sys.argv[2])))
    sys.exit(main())
