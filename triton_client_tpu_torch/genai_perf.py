"""genai-perf: a profiler of LLM generation on the port's server.

The port's copy of ``triton_client_tpu/genai_perf.py``: profile a
generation model at a fixed concurrency and report the LLM-serving metrics:

- **TTFT** (time to first token): the request sent, to its first token;
- **ITL** (inter-token latency): the gap between two tokens of a request;
- **ITL steady**: per request, (last token - first token) / (tokens - 1),
  which tokens arriving in bursts cannot skew;
- **request latency**: the request sent, to its last token;
- **output token throughput** and **request throughput** over the run.

Two endpoints:

- ``--endpoint stream`` (the default): ``llama_decode``'s decode contract
  driven closed loop on a gRPC stream (the port's gRPC client: HTTP/2 on
  the gRPC port, gRPC-Web on an HTTP port): the
  prompt window with ``sequence_start``, then one fed-back token per step,
  and the ``sequence_end`` step's token;
- ``--endpoint generate``: Server-Sent Events from
  ``POST /v2/models/{m}/generate_stream``, whose decode loop runs on the
  server.

``-u`` defaults to the gRPC port, ``localhost:8001``, for ``--endpoint
stream`` (as the reference's) and to ``localhost:8000`` for ``--endpoint
generate``.  Usage:

    python -m triton_client_tpu_torch.genai_perf -m llama_decode \
        -u localhost:8001 --concurrency 4 --output-tokens 32 \
        --num-requests 16 --profile-export-file profile.json
"""

from __future__ import annotations

import argparse
import json
import queue
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class _GenStats:
    """Per-request generation timings (all seconds)."""

    ttft: List[float] = field(default_factory=list)
    itl: List[float] = field(default_factory=list)
    #: per-request STEADY inter-token latency: (last - first token arrival)
    #: / (tokens - 1).  The server enqueues the decode chain with
    #: prefetched readbacks, so individual client-side gaps arrive in
    #: bursts (several frames land together behind a device drain) and the
    #: raw-gap p50 under-reads the true cadence; the window endpoints are
    #: burst-insensitive, making this the honest per-token rate.
    itl_steady: List[float] = field(default_factory=list)
    request_latency: List[float] = field(default_factory=list)
    tokens_out: int = 0
    requests: int = 0
    errors: int = 0
    first_error: Optional[str] = None

    def merge(self, other: "_GenStats") -> None:
        self.ttft.extend(other.ttft)
        self.itl.extend(other.itl)
        self.itl_steady.extend(other.itl_steady)
        self.request_latency.extend(other.request_latency)
        self.tokens_out += other.tokens_out
        self.requests += other.requests
        self.errors += other.errors
        if self.first_error is None:
            self.first_error = other.first_error


def _percentiles(values: List[float]) -> Dict[str, float]:
    if not values:
        return {}
    arr = np.asarray(values) * 1e3  # → ms
    return {
        "avg": float(arr.mean()),
        "min": float(arr.min()),
        "max": float(arr.max()),
        "p50": float(np.percentile(arr, 50)),
        "p90": float(np.percentile(arr, 90)),
        "p99": float(np.percentile(arr, 99)),
    }


def _prompt_window(prompt_len: int, rng: np.random.Generator) -> np.ndarray:
    # printable-byte tokens, right-aligned in the window like the
    # llama_preprocess tokenizer
    window = np.zeros(prompt_len, np.int32)
    n = max(1, prompt_len // 2)
    window[prompt_len - n:] = rng.integers(32, 127, n, dtype=np.int32)
    return window


def _resolve_decode_contract(client, model_name: str, model_version: str,
                             prompt_tokens: Optional[int] = None):
    md = client.get_model_metadata(model_name, model_version, as_json=True)
    cfg = client.get_model_config(model_name, model_version, as_json=True)
    if "config" in cfg:
        cfg = cfg["config"]
    inp = md["inputs"][0]
    token_output = None
    for o in md["outputs"]:
        if o["datatype"] == "INT32":
            token_output = o["name"]
            break
    if token_output is None:
        raise RuntimeError(
            f"model '{model_name}' has no INT32 output to feed back as the "
            "next token — not a decode-contract model")
    # Window size: explicit flag > advertised config parameter > fixed
    # metadata dims (dynamic -1 dims excluded).
    if prompt_tokens is None:
        advertised = (cfg.get("parameters") or {}).get("prompt_tokens", {})
        if advertised.get("string_value"):
            prompt_tokens = int(advertised["string_value"])
    if prompt_tokens is None:
        fixed = [int(s) for s in inp["shape"] if int(s) > 0]
        if not fixed:
            raise RuntimeError(
                f"model '{model_name}' has a fully dynamic prompt input and "
                "advertises no 'prompt_tokens' parameter — pass "
                "--prompt-tokens")
        prompt_tokens = int(np.prod(fixed))
    return inp["name"], inp["datatype"], prompt_tokens, token_output


def _worker(url, model_name, input_name, prompt_len, token_output,
            output_tokens, n_requests, worker_id, stats: _GenStats,
            barrier: threading.Barrier, stream_timeout: float) -> None:
    from . import grpc as grpcclient

    rng = np.random.default_rng(worker_id)
    local = _GenStats()
    try:
        with grpcclient.InferenceServerClient(url) as client:
            results: "queue.Queue" = queue.Queue()
            client.start_stream(
                callback=lambda result, error: results.put((result, error)))
            barrier.wait(timeout=60)
            # wire fast path (reuse-infer-objects): ONE prompt input and
            # ONE feedback-token input per worker, re-stamped with
            # set_data_from_numpy each use — the per-step InferInput
            # construction was pure decode-loop overhead
            inp = grpcclient.InferInput(input_name, [prompt_len], "INT32")
            nxt = grpcclient.InferInput(input_name, [1], "INT32")
            for req in range(n_requests):
                seq_id = worker_id * 1_000_000 + req + 1
                window = _prompt_window(prompt_len, rng)
                inp.set_data_from_numpy(window)
                t_start = time.perf_counter()
                client.async_stream_infer(
                    model_name, [inp], sequence_id=seq_id,
                    sequence_start=True)
                t_prev = None
                ok = True
                for step in range(output_tokens):
                    res, err = results.get(timeout=stream_timeout)
                    t_now = time.perf_counter()
                    if err is not None:
                        local.errors += 1
                        if local.first_error is None:
                            local.first_error = str(err)
                        ok = False
                        break
                    if step == 0:
                        local.ttft.append(t_now - t_start)
                    else:
                        local.itl.append(t_now - t_prev)
                    t_prev = t_now
                    local.tokens_out += 1
                    tok = np.asarray(res.as_numpy(token_output)).astype(
                        np.int32).reshape(1)
                    nxt.set_data_from_numpy(tok)
                    client.async_stream_infer(
                        model_name, [nxt], sequence_id=seq_id,
                        sequence_end=(step == output_tokens - 1))
                if ok:
                    # the sequence_end step still returns one final token
                    res, err = results.get(timeout=stream_timeout)
                    t_now = time.perf_counter()
                    if err is None:
                        local.itl.append(t_now - t_prev)
                        local.tokens_out += 1
                        local.request_latency.append(t_now - t_start)
                        local.requests += 1
                        n_tok = output_tokens + 1
                        t_first = t_start + local.ttft[-1]
                        if n_tok > 1:
                            local.itl_steady.append(
                                (t_now - t_first) / (n_tok - 1))
                    else:
                        local.errors += 1
                        if local.first_error is None:
                            local.first_error = str(err)
            client.stop_stream()
    except Exception as e:  # noqa: BLE001 — worker reports, run continues
        local.errors += 1
        if local.first_error is None:
            local.first_error = str(e)
    with _MERGE_LOCK:
        stats.merge(local)


_MERGE_LOCK = threading.Lock()


def _generate_worker(http_url, model_name, prompt_text, output_tokens,
                     n_requests, worker_id, stats: _GenStats,
                     barrier: threading.Barrier,
                     stream_timeout: float) -> None:
    """SSE worker over POST /v2/models/{m}/generate_stream — the server runs
    the whole decode loop, so ITL is on-device step time, not a client
    round trip per token."""
    import json as _json
    import urllib.request

    local = _GenStats()
    try:
        barrier.wait(timeout=60)
    except threading.BrokenBarrierError:
        pass
    from ._telemetry import new_trace_context

    for req_i in range(n_requests):
        # per-request isolation: a transient failure counts one error and
        # the worker moves on to its remaining requests
        try:
            body = _json.dumps({
                "text_input": f"{prompt_text} [w{worker_id} r{req_i}]",
                "max_tokens": output_tokens,
            }).encode()
            # trace propagation, same as unary infer: the server records
            # the id/traceparent into the stream's trace record, so a
            # traced load run joins per-request client and server views
            headers = {"Content-Type": "application/json"}
            headers.update(new_trace_context())
            req = urllib.request.Request(
                f"http://{http_url}/v2/models/{model_name}/generate_stream",
                data=body, headers=headers)
            t_start = time.perf_counter()
            t_prev = None
            t_first = None
            n_frames = 0
            with urllib.request.urlopen(req, timeout=stream_timeout) as resp:
                for line in resp:
                    if not line.startswith(b"data: "):
                        continue
                    frame = _json.loads(line[len(b"data: "):])
                    t_now = time.perf_counter()
                    if "error" in frame:
                        raise RuntimeError(frame["error"])
                    if n_frames == 0:
                        local.ttft.append(t_now - t_start)
                        t_first = t_now
                    else:
                        local.itl.append(t_now - t_prev)
                    t_prev = t_now
                    n_frames += 1
                    local.tokens_out += 1
            local.request_latency.append(time.perf_counter() - t_start)
            local.requests += 1
            if n_frames > 1:
                local.itl_steady.append((t_prev - t_first) / (n_frames - 1))
        except Exception as e:  # noqa: BLE001 — worker reports, run continues
            local.errors += 1
            if local.first_error is None:
                local.first_error = str(e)
    with _MERGE_LOCK:
        stats.merge(local)


def profile_generate(http_url: str, model_name: str, concurrency: int = 1,
                     output_tokens: int = 16, num_requests: int = 8,
                     prompt_text: str = "In a hole in the ground",
                     stream_timeout: float = 600.0) -> dict:
    """Profile the generate_stream (SSE) endpoint; same metric set as
    ``profile``."""
    per_worker = max(1, num_requests // concurrency)
    stats = _GenStats()
    barrier = threading.Barrier(concurrency)
    threads = []
    t0 = time.perf_counter()
    for w in range(concurrency):
        t = threading.Thread(
            target=_generate_worker,
            args=(http_url, model_name, prompt_text, output_tokens,
                  per_worker, w + 1, stats, barrier, stream_timeout),
            daemon=True)
        t.start()
        threads.append(t)
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    report = {
        "model": model_name,
        "endpoint": "generate_stream",
        "concurrency": concurrency,
        "output_tokens_per_request": output_tokens,
        "requests_completed": stats.requests,
        "errors": stats.errors,
        "wall_s": round(wall, 3),
        "time_to_first_token_ms": _percentiles(stats.ttft),
        "inter_token_latency_ms": _percentiles(stats.itl),
        # burst-corrected cadence (see _GenStats.itl_steady): prefetched
        # readbacks land in client-side bursts, so the raw-gap p50
        # under-reads — steady = per-request (last-first)/(n-1), which is
        # ~1/per-stream-tokens-per-sec by construction and self-consistent
        # with the throughput row
        "itl_steady_ms": _percentiles(stats.itl_steady),
        "request_latency_ms": _percentiles(stats.request_latency),
        "output_token_throughput_per_sec":
            round(stats.tokens_out / wall, 2) if wall > 0 else 0.0,
        "request_throughput_per_sec":
            round(stats.requests / wall, 2) if wall > 0 else 0.0,
    }
    if stats.first_error:
        report["first_error"] = stats.first_error
    return report


def profile(url: str, model_name: str, model_version: str = "",
            concurrency: int = 1, output_tokens: int = 16,
            num_requests: int = 8, stream_timeout: float = 600.0,
            prompt_tokens: Optional[int] = None) -> dict:
    """Run one profiling pass; returns the genai-perf-style metrics dict."""
    from . import grpc as grpcclient

    with grpcclient.InferenceServerClient(url) as client:
        input_name, dtype, prompt_len, token_output = \
            _resolve_decode_contract(client, model_name, model_version,
                                     prompt_tokens)
        if dtype != "INT32":
            raise RuntimeError(
                f"decode contract requires an INT32 token input, got {dtype}")

    per_worker = max(1, num_requests // concurrency)
    stats = _GenStats()
    barrier = threading.Barrier(concurrency)
    threads = []
    t0 = time.perf_counter()
    for w in range(concurrency):
        t = threading.Thread(
            target=_worker,
            args=(url, model_name, input_name, prompt_len, token_output,
                  output_tokens, per_worker, w + 1, stats, barrier,
                  stream_timeout),
            daemon=True)
        t.start()
        threads.append(t)
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0

    report = {
        "model": model_name,
        "concurrency": concurrency,
        "output_tokens_per_request": output_tokens + 1,
        "requests_completed": stats.requests,
        "errors": stats.errors,
        "wall_s": round(wall, 3),
        "time_to_first_token_ms": _percentiles(stats.ttft),
        "inter_token_latency_ms": _percentiles(stats.itl),
        # burst-corrected cadence — see profile_generate's field note
        "itl_steady_ms": _percentiles(stats.itl_steady),
        "request_latency_ms": _percentiles(stats.request_latency),
        "output_token_throughput_per_sec":
            round(stats.tokens_out / wall, 2) if wall > 0 else 0.0,
        "request_throughput_per_sec":
            round(stats.requests / wall, 2) if wall > 0 else 0.0,
    }
    if stats.first_error:
        report["first_error"] = stats.first_error
    return report


def _print_table(report: dict) -> None:
    print(f"\nModel: {report['model']}  concurrency={report['concurrency']}  "
          f"requests={report['requests_completed']}  "
          f"errors={report['errors']}")
    rows = [
        ("Time to first token (ms)", report["time_to_first_token_ms"]),
        ("Inter token latency (ms)", report["inter_token_latency_ms"]),
        ("ITL steady, de-burst (ms)", report.get("itl_steady_ms", {})),
        ("Request latency (ms)", report["request_latency_ms"]),
    ]
    hdr = f"{'Metric':<28}{'avg':>9}{'min':>9}{'max':>9}{'p50':>9}{'p90':>9}{'p99':>9}"
    print(hdr)
    print("-" * len(hdr))
    for name, p in rows:
        if not p:
            continue
        print(f"{name:<28}" + "".join(
            f"{p[k]:>9.2f}" for k in ("avg", "min", "max", "p50", "p90", "p99")))
    print(f"Output token throughput (per sec): "
          f"{report['output_token_throughput_per_sec']}")
    print(f"Request throughput (per sec): "
          f"{report['request_throughput_per_sec']}")


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m triton_client_tpu_torch.genai_perf",
        description="LLM generation profiler (genai-perf CLI contract)")
    parser.add_argument("-m", "--model", required=True)
    parser.add_argument("-u", "--url", default=None,
                        help="gRPC url for --endpoint stream (default "
                        "localhost:8001); HTTP url for --endpoint generate "
                        "(default localhost:8000)")
    parser.add_argument("--endpoint", choices=("stream", "generate"),
                        default="stream",
                        help="'stream': client closed loop over the gRPC "
                        "decode stream; 'generate': server-side loop via "
                        "POST .../generate_stream (SSE)")
    parser.add_argument("--model-version", default="")
    parser.add_argument("--concurrency", type=int, default=1)
    parser.add_argument("--output-tokens", type=int, default=16,
                        help="decode steps per request (one extra final "
                        "token arrives on sequence_end)")
    parser.add_argument("--num-requests", type=int, default=8,
                        help="total generations across all workers")
    parser.add_argument("--prompt-tokens", type=int, default=None,
                        help="prefill window size (default: the model's "
                        "advertised 'prompt_tokens' config parameter)")
    parser.add_argument("--stream-timeout", type=float, default=600.0)
    parser.add_argument("--profile-export-file", default=None,
                        help="write the full metrics dict as JSON")
    args = parser.parse_args(argv)
    if args.url is None:
        args.url = ("localhost:8000" if args.endpoint == "generate"
                    else "localhost:8001")

    try:
        if args.endpoint == "generate":
            report = profile_generate(
                args.url, args.model, concurrency=args.concurrency,
                output_tokens=args.output_tokens,
                num_requests=args.num_requests,
                stream_timeout=args.stream_timeout)
        else:
            report = profile(
                args.url, args.model, args.model_version,
                concurrency=args.concurrency,
                output_tokens=args.output_tokens,
                num_requests=args.num_requests,
                stream_timeout=args.stream_timeout,
                prompt_tokens=args.prompt_tokens)
    except Exception as e:  # noqa: BLE001 — CLI surface
        print(f"genai-perf failed: {e}", file=sys.stderr)
        return 1

    _print_table(report)
    if args.profile_export_file:
        with open(args.profile_export_file, "w") as f:
            json.dump(report, f, indent=2)
        print(f"exported: {args.profile_export_file}")
    if report["errors"] and not report["requests_completed"]:
        print(f"all requests failed: {report.get('first_error')}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
