"""perf_analyzer-equivalent load generator of the port (counterpart of
``triton_client_tpu/perf_analyzer.py``).

Closed-loop concurrency sweeps and open-loop request-rate sweeps
(``--request-rate-range``, constant or Poisson arrivals), reporting infer/s
and latency percentiles over the v2 HTTP protocol or gRPC (``-i grpc``:
HTTP/2 on the server's gRPC port, or gRPC-Web where the URL is an HTTP
port; the default URL is ``localhost:8001`` for gRPC and
``localhost:8000`` for HTTP, as the reference's), with the tensors in the
body or in shared memory (``--shared-memory none|system|cuda``).  Every
worker sends through a compiled request template (``client.prepare``) on
its own kept-alive connection; with ``--streaming`` (gRPC only, as in the
reference) each worker sends on a stream of its own and a request is
complete when its answer reaches the stream's callback.

Open-loop latency is measured from each request's *scheduled* send time, so
a queue that builds up in the server counts against the percentiles instead
of slowing the generator down; closed-loop numbers only send as fast as the
server answers (coordinated omission).

Usage:
    python -m triton_client_tpu_torch.perf_analyzer -m bert_large \\
        -u localhost:8000 -b 32 --concurrency-range 1:4:3 \\
        --shared-memory cuda
    python -m triton_client_tpu_torch.perf_analyzer -m simple \\
        -u localhost:8000 --request-rate-range 100:400:100 \\
        --request-distribution poisson
    python -m triton_client_tpu_torch.perf_analyzer -m bert_large \\
        -i grpc --streaming -b 32 --concurrency-range 1:4:3

With ``-v`` each level also prints its whole result as one JSON line
(``result {...}``; its measurement window in ``time.perf_counter`` seconds,
which on Linux is the system's monotonic clock, shared by processes), and
the run ends with the shared-memory regions it left (``regions left
{...}``).

``--trace-file PATH`` turns the server's tracing on for the sweep
(``trace_level`` TIMESTAMPS into PATH, every ``--trace-rate``-th request,
default 100), off again after it whatever happened, and prints the
per-stage breakdown of the file (``tools.trace_summary``); PATH is a path
the server writes.

QoS classes and retries (the reference's flags): ``--priority N`` and
``--tenant NAME``, each repeatable, are zipped into classes (a shorter list
repeats its last value); worker ``w`` sends as class ``w % n``, and a level
of several classes reports each one's infer/s, latency percentiles and
sheds (``classes`` in the ``result`` line, and a line per class).
``--retries N`` sends every request under a retry policy of N attempts
that may retry ``infer``, and each level counts the retries (``retries``,
in its window).  ``--retries`` and ``--tenant`` are refused with
``--streaming``, as in the reference.  Beside the reference's keys, a
``result`` line holds ``rejected_run``, ``pushback_run`` and
``retries_run``: the sheds, the sheds that carried the server's pushback
and the retries of the level's whole run, its warm-up and its last
requests included, to compare with the server's counters; and
``resends_run``: the HTTP requests of that run sent again on a new
connection because a kept-alive one failed before any response byte
(the client does this below its retry policy, so a server process lost
under load shows here, not in ``retries``).

``--export-metrics PATH`` writes the sweep's results and the client
registry's snapshot (``_telemetry.telemetry().snapshot()``: each (model,
protocol, method)'s counts, bytes and latency quantiles) as strict JSON
(NaN written as null), as the reference does.

Two or more ``-u`` endpoints (repeated or comma-separated) put every
worker of a level on one shared ``cluster.ClusterClient``, as the
reference does (its perf_analyzer.py:84-121): shared, because the
least-outstanding policy and the breakers route on the pool's state, and
a pool per worker would see one request in flight and choose at random.
``--balancing round_robin|least_outstanding`` (default
``least_outstanding``) picks the policy, ``--hedge-ms MS`` hedges each
request after a fixed MS (``HedgePolicy`` with ``min_samples`` pinned
high, so the delay never turns into the observed p95).  Such a level
reports ``endpoints`` (requests routed to each endpoint from its window's
start to the level's end, the reference's), ``endpoints_run`` (over the
whole run, to compare with each server's statistics), ``hedges`` and
``hedge_wins`` (from the window's start, the reference's: a hedge sent
before the window that wins in it counts as a win alone),
``hedges_run`` and ``hedge_wins_run`` (over the whole run, so every win
counts beside its hedge) and ``breakers`` (each endpoint's breaker
transitions).  A
cluster sweep refuses ``--streaming``, ``--shared-memory`` and
``--trace-file`` (each belongs to one server), as the reference does;
metadata comes from the first endpoint that answers.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import queue
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import numpy as np

from ._resilience import normalized_status
from ._telemetry import LatencyHistogram, telemetry
from .utils import serialized_byte_size, triton_to_np_dtype

_SHM_MODES = ("none", "system", "cuda")


@dataclass
class _Stats:
    latency: LatencyHistogram = field(default_factory=LatencyHistogram)
    count: int = 0
    errors: int = 0
    # requests the server shed (HTTP 429 / RESOURCE_EXHAUSTED), a subset
    # of errors
    rejected: int = 0
    first_error: Optional[str] = None
    # over the level's whole run: sheds, and sheds with pushback
    rejected_run: int = 0
    pushback_run: int = 0


def _is_rejected(err: Exception) -> bool:
    return normalized_status(err) in ("429", "RESOURCE_EXHAUSTED")


def _resends_recorded() -> int:
    """The HTTP client's resends so far (process-wide)."""
    from .http._client import connection_resends

    return connection_resends()


def _cluster_recorded():
    """The client registry's requests per endpoint, hedges and hedge wins
    so far (process-wide)."""
    snap = telemetry().snapshot()
    dist = {e["endpoint"]: e["success"] + e["failure"]
            for e in snap["endpoints"]}
    return (dist, sum(h["hedges"] for h in snap["hedges"]),
            sum(h["wins"] for h in snap["hedges"]))


def _delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {e: after.get(e, 0) - before.get(e, 0)
            for e in sorted(set(before) | set(after))}


def _shared_cluster(urls, protocol: str, concurrency: int,
                    balancing: str, hedge_ms: float):
    """The level's one ``ClusterClient`` over ``urls``; None for a single
    endpoint."""
    if isinstance(urls, str) or len(urls) < 2:
        return None
    from .cluster import ClusterClient, HedgePolicy

    # --hedge-ms is a fixed delay: min_samples out of reach, or the policy
    # would switch to the observed p95 within the warm-up
    hedge = (HedgePolicy(default_delay_s=hedge_ms / 1e3,
                         min_samples=1 << 30) if hedge_ms > 0 else None)
    return ClusterClient(
        list(urls), protocol=protocol, policy=balancing, hedge=hedge,
        client_kwargs={} if protocol == "grpc"
        else {"concurrency": concurrency},
        # every primary and its backup may be in flight at once
        hedge_workers=max(32, 2 * concurrency))


def _retries_recorded(model_name: str) -> int:
    """The client retries so far for ``model_name`` (process-wide)."""
    return sum(r["retries"] for r in telemetry().snapshot()["requests"]
               if r["model"] == model_name)


def _parse_classes(priorities, tenants):
    """The (priority, tenant) classes of repeated ``--priority`` and
    ``--tenant`` flags, zipped, a shorter list repeating its last value;
    None without either."""
    priorities = priorities or []
    tenants = tenants or []
    if not priorities and not tenants:
        return None
    n = max(len(priorities), len(tenants))
    return [(priorities[min(i, len(priorities) - 1)] if priorities else 0,
             tenants[min(i, len(tenants) - 1)] if tenants else None)
            for i in range(n)]


def _protocol_module(protocol: str):
    """The client package of ``protocol``: ``http`` or ``grpc``."""
    if protocol == "grpc":
        from . import grpc

        return grpc
    from . import http

    return http


def _make_client(url: str, protocol: str = "http"):
    return _protocol_module(protocol).InferenceServerClient(url)


def _set_server_tracing(url: str, protocol: str, settings: dict) -> None:
    client = _make_client(url, protocol)
    try:
        client.update_trace_settings(settings=settings)
    finally:
        client.close()


def _parse_concurrency_range(spec: str):
    parts = [int(p) for p in spec.split(":")]
    start = parts[0]
    end = parts[1] if len(parts) > 1 else start
    step = parts[2] if len(parts) > 2 else 1
    return list(range(start, end + 1, max(step, 1)))


def _parse_shapes(shape_args: List[str]) -> Dict[str, List[int]]:
    shapes = {}
    for s in shape_args or []:
        name, sep, dims = s.rpartition(":")
        if not sep or not name or not dims:
            raise ValueError(
                f"invalid --shape '{s}': expected <input name>:<d1>[,<d2>...]")
        shapes[name] = [int(d) for d in dims.split(",")]
    return shapes


def _resolve_model(client, model_name: str, model_version: str,
                   protocol: str = "http"):
    if protocol == "grpc":
        md = client.get_model_metadata(model_name, model_version,
                                       as_json=True)
        cfg = client.get_model_config(model_name, model_version,
                                      as_json=True)["config"]
    else:
        md = client.get_model_metadata(model_name, model_version)
        cfg = client.get_model_config(model_name, model_version)
    max_batch = int(cfg.get("max_batch_size", 0))
    inputs, outputs = ([{"name": t["name"], "datatype": t["datatype"],
                         "shape": [int(s) for s in t["shape"]]} for t in io]
                       for io in (md["inputs"], md["outputs"]))
    return inputs, outputs, max_batch


def _output_region_size(outputs, batch: int, max_batch: int,
                        floor: int) -> int:
    """Bytes of each output's region: the largest output of fixed shape at
    ``batch`` rows, and at least ``floor`` (``--output-shared-memory-size``,
    which sizes outputs of dynamic shape and BYTES ones).  perf_analyzer
    sizes a fixed-shape output's region from the model's metadata."""
    size = floor
    for o in outputs:
        dims = o["shape"][1:] if max_batch > 0 else o["shape"]
        dt = triton_to_np_dtype(o["datatype"])
        itemsize = 2 if o["datatype"] == "BF16" else (
            dt.itemsize if dt is not None and dt != np.object_ else 0)
        if itemsize and all(d >= 0 for d in dims):
            rows = batch if max_batch > 0 else 1
            size = max(size, rows * int(np.prod(dims)) * itemsize)
    return size


def _make_data(inputs, shapes, batch: int, max_batch: int, rng,
               string_length=16):
    """One array per input, from ``rng`` in input order: the reference
    tool's arrays for the same seed."""
    arrays = {}
    for spec in inputs:
        dims = list(shapes.get(spec["name"], []))
        if not dims:
            dims = list(spec["shape"])
            if max_batch > 0:
                dims = dims[1:]  # the batch dim, added back below
            dims = [d if d > 0 else 1 for d in dims]
        if max_batch > 0:
            dims = [batch] + dims
        dt = triton_to_np_dtype(spec["datatype"])
        if spec["datatype"] == "BYTES":
            arr = np.array([b"x" * string_length
                            for _ in range(int(np.prod(dims)))],
                           dtype=np.object_).reshape(dims)
        elif np.issubdtype(dt, np.floating):
            arr = rng.random(dims).astype(dt)
        elif dt == np.bool_:
            arr = rng.integers(0, 2, dims).astype(np.bool_)
        else:
            arr = rng.integers(0, 127, dims).astype(dt)
        arrays[spec["name"]] = arr
    return arrays


class _ShmSetup:
    """One worker's shared-memory regions, an input region per input and
    an output region per output, registered with the server under names of
    this process (``pa_<pid>_in_<worker>_<tensor>``), and in system shm
    under keys of the same name.  ``cuda_device``: where CUDA regions
    live, ``"cuda"`` or ``"cpu"`` (host memory that only a server in this
    process can map)."""

    def __init__(self, mode, client, arrays, outputs, worker_id,
                 output_byte_size, cuda_device="cuda"):
        self.mode = mode
        self.client = client
        #: (in|out, tensor name) -> (region name, byte size)
        self.handles = {}
        self._made = []  # (region name, handle), to unregister and destroy
        self.output_byte_size = output_byte_size
        self._cuda_device = cuda_device
        if mode == "none":
            return
        if mode == "system":
            from .utils import shared_memory as shm
        else:
            from .utils import cuda_shared_memory as shm
        self._shm = shm
        try:
            self._create_regions(arrays, outputs, worker_id)
        except Exception:
            self.cleanup()  # release what was made before the failure
            raise

    def _create(self, region: str, nbytes: int, value=None):
        if self.mode == "system":
            h = self._shm.create_shared_memory_region(
                region, f"/{region}", nbytes)
        else:
            h = self._shm.create_shared_memory_region(
                region, nbytes, 0, device=self._cuda_device)
        self._made.append((region, h))
        if value is not None:
            self._shm.set_shared_memory_region(h, [value])
        if self.mode == "system":
            self.client.register_system_shared_memory(
                region, f"/{region}", nbytes)
        else:
            self.client.register_cuda_shared_memory(
                region, self._shm.get_raw_handle(h), 0, nbytes)
        return region, nbytes

    def _create_regions(self, arrays, outputs, worker_id):
        prefix = f"pa_{os.getpid()}"
        for name, arr in arrays.items():
            # both region kinds serialize a BYTES array themselves
            self.handles[("in", name)] = self._create(
                f"{prefix}_in_{worker_id}_{name}", serialized_byte_size(arr),
                arr)
        for name in outputs:
            self.handles[("out", name)] = self._create(
                f"{prefix}_out_{worker_id}_{name}", self.output_byte_size)

    def attach(self, infer_inputs, requested_outputs):
        if self.mode == "none":
            return
        for inp in infer_inputs:
            inp.set_shared_memory(*self.handles[("in", inp.name())])
        for out in requested_outputs:
            out.set_shared_memory(*self.handles[("out", out.name())])

    def cleanup(self):
        if self.mode == "none":
            return
        unregister = (self.client.unregister_system_shared_memory
                      if self.mode == "system"
                      else self.client.unregister_cuda_shared_memory)
        for region, h in self._made:
            try:
                unregister(region)
            except Exception:  # noqa: BLE001 - destroy it all the same
                pass
            try:
                self._shm.destroy_shared_memory_region(h)
            except Exception:  # noqa: BLE001 - best effort at teardown
                pass
        self._made = []


def _build_inputs(mod, arrays, shm_mode):
    from .utils import np_to_triton_dtype

    infer_inputs = []
    for name, arr in arrays.items():
        dt = ("BYTES" if arr.dtype == np.object_
              else np_to_triton_dtype(arr.dtype))
        inp = mod.InferInput(name, list(arr.shape), dt)
        if shm_mode == "none":
            inp.set_data_from_numpy(arr)
        infer_inputs.append(inp)
    return infer_inputs


class _InferSession:
    """One worker's client, inputs, shared-memory regions and infer
    callable, shared by the closed-loop and open-loop sweeps.  Each call
    goes through a request template compiled once per session; with
    ``streaming`` (gRPC), on the session's stream, complete when its answer
    reaches the stream's callback (reference perf_analyzer.py:326-420)."""

    def __init__(self, url, model_name, model_version, arrays, outputs,
                 shm_mode, output_byte_size, worker_id, cuda_device="cuda",
                 protocol="http", streaming=False, qos_class=None,
                 retry_policy=None, shared=None):
        mod = _protocol_module(protocol)
        # a level's shared cluster client is the level's to close
        self._owns_client = shared is None
        self._client = _make_client(url, protocol) if shared is None \
            else shared
        self._shm_setup = None
        self._stream_open = False
        priority, tenant = qos_class if qos_class else (0, None)
        try:
            infer_inputs = _build_inputs(mod, arrays, shm_mode)
            requested = [mod.InferRequestedOutput(o) for o in outputs]
            self._shm_setup = _ShmSetup(shm_mode, self._client, arrays,
                                        outputs, worker_id, output_byte_size,
                                        cuda_device)
            self._shm_setup.attach(infer_inputs, requested)
            if shared is not None:
                # the cluster client routes each request: no template
                client = self._client
                self.infer = lambda: client.infer(
                    model_name, infer_inputs, model_version=model_version,
                    outputs=requested, priority=priority,
                    retry_policy=retry_policy, tenant=tenant)
                return
            prep = self._client.prepare(
                model_name, infer_inputs, model_version=model_version,
                outputs=requested, priority=priority)
            if streaming:
                self.infer = self._stream_infer(prep)
            else:
                self.infer = lambda: prep.infer(retry_policy=retry_policy,
                                                tenant=tenant)
        except Exception:
            self.close()
            raise

    def _stream_infer(self, prep):
        """The infer callable of a stream: send, then wait for this
        request's completion on the callback."""
        done: "queue.Queue" = queue.Queue()
        self._client.start_stream(
            callback=lambda result, error: done.put(error))
        self._stream_open = True
        # completions owed to requests that timed out: dropped when they
        # land, or each later request would take its predecessor's
        stale = [0]

        def one_infer():
            prep.async_stream_infer()
            try:
                while True:
                    err = done.get(timeout=120)
                    if stale[0] > 0:
                        stale[0] -= 1
                        continue
                    if err is not None:
                        raise err
                    return
            except queue.Empty:
                stale[0] += 1
                raise TimeoutError("stream completion timed out")
        return one_infer

    def close(self):
        if self._stream_open:
            self._client.stop_stream()
        if self._shm_setup is not None:
            self._shm_setup.cleanup()
        if self._owns_client:
            self._client.close()


def _worker(url, model_name, model_version, arrays, outputs, shm_mode,
            output_byte_size, worker_id, stop, measuring, stats: _Stats, lock,
            cuda_device="cuda", protocol="http", streaming=False,
            qos_class=None, retry_policy=None, shared=None):
    try:
        session = _InferSession(url, model_name, model_version,
                                arrays, outputs, shm_mode, output_byte_size,
                                worker_id, cuda_device, protocol, streaming,
                                qos_class, retry_policy, shared)
    except Exception as e:  # noqa: BLE001 - reported, not a dead thread
        with lock:
            stats.errors += 1
            if stats.first_error is None:
                stats.first_error = f"worker setup: {type(e).__name__}: {e}"
        return
    try:
        n = errs = rejected = rejected_run = pushback_run = 0
        first_error = None
        while not stop.is_set():
            t0 = time.perf_counter()
            err = None
            try:
                session.infer()
            except Exception as e:  # noqa: BLE001 - counted per request
                err = e
            dt_s = time.perf_counter() - t0
            shed = err is not None and _is_rejected(err)
            if shed:
                rejected_run += 1
                pushback_run += getattr(err, "retry_after_s", None) \
                    is not None
            # completions after the window closed are not counted
            if measuring.is_set():
                if err is None:
                    stats.latency.observe(dt_s)
                    n += 1
                else:
                    errs += 1
                    rejected += shed
                    if first_error is None:
                        first_error = f"{type(err).__name__}: {err}"
        with lock:
            stats.count += n
            stats.errors += errs
            stats.rejected += rejected
            stats.rejected_run += rejected_run
            stats.pushback_run += pushback_run
            if stats.first_error is None:
                stats.first_error = first_error
    finally:
        session.close()


def run_level(url, model_name, model_version, concurrency, arrays, outputs,
              shm_mode, output_byte_size, measure_s, warmup_s=1.0,
              extra_percentile=None, cuda_device="cuda", protocol="http",
              streaming=False, qos_classes=None, retry_policy=None,
              balancing="least_outstanding", hedge_ms=0.0):
    """One closed-loop level: ``concurrency`` workers, each sending its
    next request as soon as the last one is answered.  With
    ``qos_classes`` (``(priority, tenant)`` pairs) worker ``w`` sends as
    class ``w % len(classes)`` and the result gains a per-class
    ``classes`` breakdown.  ``url``: one endpoint, or a list of them for a
    cluster level (``balancing``, ``hedge_ms``)."""
    shared = _shared_cluster(url, protocol, concurrency, balancing,
                             hedge_ms)
    classes = list(qos_classes) if qos_classes else [(0, None)]
    class_stats = [_Stats() for _ in classes]
    lock = threading.Lock()
    stop = threading.Event()
    measuring = threading.Event()
    threads = [
        threading.Thread(
            target=_worker,
            args=(url, model_name, model_version, arrays, outputs,
                  shm_mode, output_byte_size, w, stop, measuring,
                  class_stats[w % len(classes)], lock, cuda_device,
                  protocol, streaming, classes[w % len(classes)],
                  retry_policy, shared),
            daemon=True)
        for w in range(concurrency)]
    retries_start = _retries_recorded(model_name)
    resends_start = _resends_recorded()
    cluster_start = _cluster_recorded()
    for t in threads:
        t.start()
    time.sleep(warmup_s)
    # the window's retries, as its counts
    retries_before = _retries_recorded(model_name)
    cluster_before = _cluster_recorded()
    measuring.set()
    t0 = time.perf_counter()
    time.sleep(measure_s)
    measuring.clear()
    t1 = time.perf_counter()
    retries_window = _retries_recorded(model_name) - retries_before
    stop.set()
    for t in threads:
        t.join(timeout=60)
    stats = _Stats()
    for cs in class_stats:
        stats.latency.merge(cs.latency)
        stats.count += cs.count
        stats.errors += cs.errors
        stats.rejected += cs.rejected
        stats.rejected_run += cs.rejected_run
        stats.pushback_run += cs.pushback_run
        if stats.first_error is None:
            stats.first_error = cs.first_error
    elapsed = t1 - t0
    res = {
        "concurrency": concurrency,
        "throughput": stats.count / elapsed,
        "errors": stats.errors,
        "rejected": stats.rejected,
        "rejected_per_sec": stats.rejected / elapsed,
        "retries": retries_window,
        "first_error": stats.first_error,
        "window_start_s": t0,
        "window_end_s": t1,
        "rejected_run": stats.rejected_run,
        "pushback_run": stats.pushback_run,
        "retries_run": _retries_recorded(model_name) - retries_start,
        "resends_run": _resends_recorded() - resends_start,
    }
    if len(classes) > 1:
        res["classes"] = [
            dict(priority=cls[0], tenant=cls[1] or "",
                 workers=sum(1 for w in range(concurrency)
                             if w % len(classes) == i),
                 throughput=cs.count / elapsed,
                 rejected=cs.rejected,
                 rejected_per_sec=cs.rejected / elapsed,
                 rejected_run=cs.rejected_run,
                 pushback_run=cs.pushback_run,
                 **_latency_stats(cs.latency, extra_percentile))
            for i, (cls, cs) in enumerate(zip(classes, class_stats))]
    if shared is not None:
        _cluster_result(res, shared, cluster_start, cluster_before)
    res.update(_latency_stats(stats.latency, extra_percentile))
    return res


def _cluster_result(res: dict, shared, start, before) -> None:
    """A cluster level's client closed (a hedge's loser still running ends
    first), then its routing: ``endpoints`` from its window's start,
    ``endpoints_run`` over the run, ``hedges`` and ``hedge_wins`` from the
    window's start, ``hedges_run`` and ``hedge_wins_run`` over the run (all
    to the level's end), and ``breakers``: each endpoint's breaker
    transitions in the run."""
    shared.close()
    dist, hedges, wins = _cluster_recorded()
    res["endpoints"] = _delta(dist, before[0])
    res["endpoints_run"] = _delta(dist, start[0])
    res["hedges"] = hedges - before[1]
    res["hedge_wins"] = wins - before[2]
    res["hedges_run"] = hedges - start[1]
    res["hedge_wins_run"] = wins - start[2]
    res["breakers"] = {e.url: list(e.breaker.history)
                       for e in shared.pool.endpoints}


def _latency_stats(latencies: Union[LatencyHistogram, list],
                   extra_percentile=None) -> dict:
    """avg/p50/p90/p95/p99 (and an optional extra percentile) in usec, NaN
    without samples; from a ``LatencyHistogram`` or a list of seconds."""
    if not isinstance(latencies, LatencyHistogram):
        h = LatencyHistogram()
        for v in latencies:
            h.observe(float(v))
        latencies = h
    out = {"avg_us": latencies.mean() * 1e6 if latencies.count
           else float("nan")}
    pcts = [50, 90, 95, 99]
    if extra_percentile is not None and extra_percentile not in pcts:
        pcts.append(extra_percentile)
    for p in pcts:
        out[f"p{p}_us"] = (latencies.percentile(p) * 1e6
                           if latencies.count else float("nan"))
    return out


def _parse_rate_range(spec: str) -> List[float]:
    parts = [float(p) for p in spec.split(":")]
    start = parts[0]
    end = parts[1] if len(parts) > 1 else start
    step = parts[2] if len(parts) > 2 else 1.0
    if start <= 0 or step <= 0:
        raise ValueError(
            f"invalid --request-rate-range '{spec}': rates and step must "
            "be positive")
    out, r = [], start
    while r <= end + 1e-9:
        out.append(r)
        r += step
    return out


def run_rate_level(url, model_name, model_version, rate, arrays, outputs,
                   shm_mode, output_byte_size, measure_s, warmup_s=1.0,
                   distribution="constant", max_threads=64,
                   extra_percentile=None, cuda_device="cuda",
                   protocol="http", streaming=False, qos_classes=None,
                   retry_policy=None, balancing="least_outstanding",
                   hedge_ms=0.0):
    """One open-loop level at ``rate`` requests/s: the send times are
    scheduled up front (constant or Poisson gaps, from a fixed seed) and
    latency counts from the scheduled time.  A server that cannot keep up
    shows as ``send_lag_*`` (how late sends left) and ``unsent`` (slots of
    the window never sent).  ``qos_classes`` as in :func:`run_level`:
    sender ``w`` sends as class ``w % len(classes)``."""
    classes = list(qos_classes) if qos_classes else [(0, None)]
    if rate <= 0:
        raise ValueError(f"request rate must be positive, got {rate}")
    shared = _shared_cluster(url, protocol, max_threads, balancing,
                             hedge_ms)
    # the schedule covers warm-up, window and 1 s more
    horizon = warmup_s + measure_s + 1.0
    n_slots = int(rate * horizon) + 1
    srng = np.random.default_rng(1234)
    if distribution == "poisson":
        gaps = srng.exponential(1.0 / rate, n_slots)
    else:
        gaps = np.full(n_slots, 1.0 / rate)
    sched = np.cumsum(gaps)

    lock = threading.Lock()
    stop = threading.Event()
    next_slot = [0]
    sent = []   # (scheduled, send lag)
    # (scheduled, latency from scheduled, error, rejected, class, pushback)
    done = []
    setup_errors = []
    t0_box = [0.0]
    ready = [0]
    go = threading.Event()

    def worker(worker_id):
        ci = worker_id % len(classes)
        try:
            session = _InferSession(url, model_name, model_version, arrays,
                                    outputs, shm_mode, output_byte_size,
                                    worker_id, cuda_device, protocol,
                                    streaming, classes[ci], retry_policy,
                                    shared)
        except Exception as e:  # noqa: BLE001 - reported below
            with lock:
                ready[0] += 1
                setup_errors.append(f"worker setup: {type(e).__name__}: {e}")
            return
        # the schedule starts once every sender is set up
        with lock:
            ready[0] += 1
        go.wait(timeout=120)
        try:
            while not stop.is_set():
                with lock:
                    k = next_slot[0]
                    if k >= n_slots:
                        return
                    next_slot[0] += 1
                target = t0_box[0] + sched[k]
                # sleep in slices, so that stop ends a long gap
                while True:
                    now = time.perf_counter()
                    if now >= target or stop.is_set():
                        break
                    time.sleep(min(target - now, 0.05))
                if stop.is_set():
                    return  # a claimed slot never sent: counted unsent
                lag = time.perf_counter() - target
                err, rejected, pushback = None, False, False
                try:
                    session.infer()
                except Exception as e:  # noqa: BLE001 - recorded per slot
                    err = f"{type(e).__name__}: {e}"
                    rejected = _is_rejected(e)
                    pushback = rejected and getattr(
                        e, "retry_after_s", None) is not None
                lat = time.perf_counter() - target
                with lock:
                    sent.append((sched[k], lag))
                    done.append((sched[k], lat, err, rejected, ci,
                                 pushback))
        finally:
            session.close()

    threads = [threading.Thread(target=worker, args=(w,), daemon=True)
               for w in range(max_threads)]
    retries_start = _retries_recorded(model_name)
    resends_start = _resends_recorded()
    cluster_start = _cluster_recorded()
    for t in threads:
        t.start()
    deadline = time.monotonic() + 30.0
    while ready[0] < max_threads and time.monotonic() < deadline:
        time.sleep(0.005)
    t0_box[0] = time.perf_counter()
    go.set()
    # the window owns every slot scheduled in it, sent or not
    time.sleep(warmup_s)
    retries_before = _retries_recorded(model_name)
    cluster_before = _cluster_recorded()
    time.sleep(measure_s)
    retries_window = _retries_recorded(model_name) - retries_before
    stop.set()
    for t in threads:
        t.join(timeout=60)
    win_lo, win_hi = warmup_s, warmup_s + measure_s
    owed = int(np.sum((sched >= win_lo) & (sched < win_hi)))
    in_win = [row for row in done if win_lo <= row[0] < win_hi]
    ok = [row[1] for row in in_win if row[2] is None]
    errs = [row[2] for row in in_win if row[2] is not None]
    n_rejected = sum(1 for row in in_win if row[3])
    lags = np.asarray([lag for s, lag in sent if win_lo <= s < win_hi])
    res = {
        "request_rate": rate,
        "distribution": distribution,
        "throughput": len(ok) / measure_s,
        "owed": owed,
        "unsent": max(owed - len(in_win), 0),
        # set-up failures come before any slot: always reported
        "errors": len(errs) + len(setup_errors),
        "rejected": n_rejected,
        "rejected_per_sec": n_rejected / measure_s,
        "retries": retries_window,
        "first_error": (setup_errors[0] if setup_errors
                        else errs[0] if errs else None),
        "send_lag_p50_ms": (float(np.percentile(lags, 50) * 1e3)
                            if lags.size else float("nan")),
        "send_lag_p99_ms": (float(np.percentile(lags, 99) * 1e3)
                            if lags.size else float("nan")),
        "window_start_s": t0_box[0] + win_lo,
        "window_end_s": t0_box[0] + win_hi,
        "rejected_run": sum(1 for row in done if row[3]),
        "pushback_run": sum(1 for row in done if row[5]),
        "retries_run": _retries_recorded(model_name) - retries_start,
        "resends_run": _resends_recorded() - resends_start,
    }
    if len(classes) > 1:
        res["classes"] = []
        for i, cls in enumerate(classes):
            c_ok = [row[1] for row in in_win
                    if row[4] == i and row[2] is None]
            c_rej = sum(1 for row in in_win if row[4] == i and row[3])
            res["classes"].append(dict(
                priority=cls[0], tenant=cls[1] or "",
                workers=sum(1 for w in range(max_threads)
                            if w % len(classes) == i),
                throughput=len(c_ok) / measure_s,
                rejected=c_rej, rejected_per_sec=c_rej / measure_s,
                rejected_run=sum(1 for row in done
                                 if row[4] == i and row[3]),
                pushback_run=sum(1 for row in done
                                 if row[4] == i and row[5]),
                **_latency_stats(c_ok, extra_percentile)))
    if shared is not None:
        _cluster_result(res, shared, cluster_start, cluster_before)
    res.update(_latency_stats(ok, extra_percentile))
    return res


def _json_sanitize(v):
    """NaN and inf as None, so a result line stays strict JSON."""
    if isinstance(v, float) and not np.isfinite(v):
        return None
    if isinstance(v, dict):
        return {k: _json_sanitize(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_json_sanitize(x) for x in v]
    return v


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="perf_analyzer",
        description="Concurrency-sweep load generator (perf_analyzer CLI "
                    "contract) of the PyTorch port")
    parser.add_argument("-m", "--model-name", required=True)
    parser.add_argument("-x", "--model-version", default="")
    parser.add_argument("-u", "--url", action="append", default=None,
                        help="server endpoint; repeat (or comma-separate) "
                             "for a fleet: two or more drive one shared "
                             "ClusterClient and report each endpoint's "
                             "requests and the hedges")
    parser.add_argument("-i", "--protocol", default="http", type=str.lower,
                        choices=["http", "grpc"],
                        help="http, or grpc (gRPC-Web on the server's "
                             "HTTP port)")
    parser.add_argument("--streaming", action="store_true",
                        help="send on one gRPC stream per worker (needs "
                             "-i grpc)")
    parser.add_argument("--balancing", default="least_outstanding",
                        type=str.lower,
                        choices=["round_robin", "least_outstanding"],
                        help="balancing policy over several -u endpoints "
                             "(default least_outstanding)")
    parser.add_argument("--hedge-ms", type=float, default=0.0,
                        help="hedged requests: a backup to a second "
                             "endpoint after this many ms (0 = off; needs "
                             "several -u endpoints)")
    parser.add_argument("-b", "--batch-size", type=int, default=1)
    parser.add_argument("--concurrency-range", default=None,
                        help="start:end:step closed-loop concurrency sweep")
    parser.add_argument("--request-rate-range", default=None,
                        help="start:end:step OPEN-loop request rates "
                             "(req/s); latency measured from the scheduled "
                             "send time (coordinated-omission-free)")
    parser.add_argument("--request-distribution", default="constant",
                        type=str.lower, choices=["constant", "poisson"],
                        help="inter-arrival schedule for --request-rate-range")
    parser.add_argument("--max-threads", type=int, default=64,
                        help="sender pool bound for the open-loop mode")
    parser.add_argument("--measurement-interval", type=int, default=5000,
                        help="measurement window per level (ms)")
    parser.add_argument("--shared-memory", default="none", choices=_SHM_MODES,
                        help="where the tensors travel: none (the HTTP "
                             "body), system (POSIX shm) or cuda (CUDA "
                             "regions, mapped by the server with cudaIPC); "
                             "the reference's xla mode has no meaning on a "
                             "GPU and is dropped")
    parser.add_argument("--cuda-shared-memory-device", default="cuda",
                        choices=["cuda", "cpu"],
                        help="where --shared-memory cuda makes its regions: "
                             "on the card (default), or in host memory, "
                             "which only a server in this process can map")
    parser.add_argument("--output-shared-memory-size", type=int,
                        default=102400,
                        help="bytes of each output's region where the "
                             "output's shape is not fixed, or it is BYTES; "
                             "a fixed-shape output's region holds it at "
                             "the batch size")
    parser.add_argument("--shape", action="append", default=[],
                        help="name:d1,d2,... override for dynamic dims")
    parser.add_argument("--string-length", type=int, default=16)
    parser.add_argument("--priority", action="append", type=int,
                        default=None, metavar="N",
                        help="v2 request priority (0 = highest); repeat "
                             "together with --tenant for mixed-tier "
                             "sweeps: workers round-robin over the "
                             "(priority, tenant) classes and the report "
                             "gives each one's infer/s, p99 and sheds")
    parser.add_argument("--tenant", action="append", default=None,
                        metavar="NAME",
                        help="QoS tenant stamped on every request "
                             "(triton-tenant); repeatable, zipped with "
                             "--priority into classes")
    parser.add_argument("--retries", type=int, default=0,
                        help="send each request under a retry policy of "
                             "this many attempts (0 = off); each level "
                             "reports its retries")
    parser.add_argument("--percentile", type=int, default=None,
                        help="report this percentile as the headline latency")
    parser.add_argument("--trace-file", default=None, metavar="PATH",
                        help="turn server-side tracing on for the sweep "
                             "(trace_level=TIMESTAMPS into PATH, sampled at "
                             "--trace-rate) and report the per-stage "
                             "breakdown after; PATH must be a path the "
                             "SERVER can write")
    parser.add_argument("--trace-rate", type=int, default=100,
                        help="server sampling rate while --trace-file is on "
                             "(trace every Nth request; default 100)")
    parser.add_argument("--export-metrics", default=None, metavar="PATH",
                        help="write the sweep's results and the client "
                             "telemetry snapshot (per model, protocol and "
                             "method: counts, bytes, latency quantiles) to "
                             "PATH as strict JSON")
    parser.add_argument("-f", "--latency-report-file", default=None)
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)
    if args.streaming and args.protocol != "grpc":
        parser.error("--streaming requires -i grpc")
    if args.streaming and args.retries:
        # a stream's completion arrives on its callback: a per-request
        # retry cannot apply
        parser.error("--retries is not supported with --streaming")
    if args.streaming and args.tenant:
        # a stream's metadata is fixed when it opens
        parser.error("--tenant is not supported with --streaming")
    qos_classes = _parse_classes(args.priority, args.tenant)
    if args.concurrency_range and args.request_rate_range:
        parser.error("--concurrency-range and --request-rate-range are "
                     "mutually exclusive (closed- vs open-loop)")
    if args.concurrency_range is None and args.request_rate_range is None:
        args.concurrency_range = "1"
    urls: List[str] = []
    for u in (args.url or []):
        urls.extend(p.strip() for p in u.split(",") if p.strip())
    urls = urls or ["localhost:8001" if args.protocol == "grpc"
                    else "localhost:8000"]
    if len(set(urls)) != len(urls):
        parser.error(f"duplicate -u endpoints: {urls}")
    cluster = len(urls) > 1
    if cluster and args.streaming:
        parser.error("--streaming drives one stream per worker and is not "
                     "supported with multiple -u endpoints")
    if cluster and args.shared_memory != "none":
        # a region registered on one replica is unknown to the others
        parser.error("--shared-memory requires a single -u endpoint")
    if args.hedge_ms < 0:
        parser.error("--hedge-ms must be >= 0")
    if args.hedge_ms and not cluster:
        parser.error("--hedge-ms needs at least two -u endpoints to hedge "
                     "across")
    if cluster and args.trace_file:
        # the trace settings reach one server: its breakdown would cover a
        # share of the sweep
        parser.error("--trace-file requires a single -u endpoint (server "
                     "tracing is per-server; trace each replica directly)")
    retry_policy = None
    if args.retries > 0 or args.hedge_ms > 0:
        from ._resilience import RetryPolicy

        # a hedge runs a request twice, as a retry does: a policy that may
        # retry infer arms it, of one attempt where --retries is not given
        retry_policy = RetryPolicy(max_attempts=max(1, args.retries),
                                   retry_infer=True)

    if args.shared_memory != "none":
        # the region modules import torch: here, not inside a level's
        # window, where a worker's first request would wait for it
        importlib.import_module(
            f"{__package__}.utils."
            + ("shared_memory" if args.shared_memory == "system"
               else "cuda_shared_memory"))
    # the metadata from the first endpoint that answers: a dead first -u
    # must not fail a sweep the cluster client would route around
    for url in urls:
        meta_client = _make_client(url, args.protocol)
        try:
            inputs, output_specs, max_batch = _resolve_model(
                meta_client, args.model_name, args.model_version,
                args.protocol)
            break
        except Exception as e:  # noqa: BLE001 - the next may answer
            if url == urls[-1]:
                raise
            print(f"warning: {url} unreachable for metadata "
                  f"({type(e).__name__}); trying the next endpoint",
                  file=sys.stderr)
        finally:
            meta_client.close()
    target = urls if cluster else url
    outputs = [o["name"] for o in output_specs]
    if args.batch_size > 1 and max_batch == 0:
        print(f"error: model {args.model_name} does not support batching",
              file=sys.stderr)
        return 1

    rng = np.random.default_rng(0)
    try:
        shapes = _parse_shapes(args.shape)
    except ValueError as e:
        parser.error(str(e))
    arrays = _make_data(inputs, shapes, args.batch_size, max_batch, rng,
                        args.string_length)
    output_size = _output_region_size(output_specs, args.batch_size,
                                      max_batch,
                                      args.output_shared_memory_size)

    measure_s = args.measurement_interval / 1000.0
    open_loop = args.request_rate_range is not None
    results = []
    print(f"*** Measurement Settings ***\n"
          f"  Batch size: {args.batch_size}\n"
          f"  Measurement window: {args.measurement_interval} msec\n"
          f"  Shared memory: {args.shared_memory}\n"
          f"  Load mode: "
          + (f"open-loop ({args.request_distribution} arrivals)"
             if open_loop else "closed-loop (concurrency)") + "\n"
          f"  Protocol: {args.protocol}"
          + (" (streaming)" if args.streaming else "")
          + f" @ {', '.join(urls)}"
          + (f" [{args.balancing}"
             + (f", hedge {args.hedge_ms:g}ms" if args.hedge_ms else "")
             + "]" if cluster else "") + "\n")

    def report(res, lead):
        results.append(res)
        headline = (res[f"p{args.percentile}_us"]
                    if args.percentile is not None else res["avg_us"])
        tail = ""
        if res.get("unsent"):
            tail += f", {res['unsent']} unsent"
        if res.get("retries"):
            tail += f", {res['retries']} retries"
        if res.get("rejected"):
            tail += f", rejected {res['rejected_per_sec']:.1f}/s"
        if res.get("hedges"):
            tail += (f", {res['hedges']} hedges"
                     f" ({res.get('hedge_wins', 0)} won)")
        if res["errors"]:
            tail += f" ({res['errors']} errors)"
        print(f"{lead}{res['throughput']:.2f} infer/sec, "
              f"latency {headline:.0f} usec" + tail)
        if res["errors"] and res.get("first_error"):
            print(f"  first error: {res['first_error']}")
        if "endpoints" in res:
            total = sum(res["endpoints"].values()) or 1
            print("  endpoint distribution: " + ", ".join(
                f"{e}: {n} ({100.0 * n / total:.0f}%)"
                for e, n in res["endpoints"].items()))
        if args.verbose:
            line = (f"  p50: {res['p50_us']:.0f} us, "
                    f"p90: {res['p90_us']:.0f} us, "
                    f"p95: {res['p95_us']:.0f} us, "
                    f"p99: {res['p99_us']:.0f} us")
            if "send_lag_p99_ms" in res:
                line += f", send lag p99 {res['send_lag_p99_ms']:.1f} ms"
            print(line)
        for cls in res.get("classes", []):
            label = f"p={cls['priority']}"
            if cls["tenant"]:
                label += f" tenant={cls['tenant']}"
            p50, p99 = cls["p50_us"], cls["p99_us"]
            p50_s = f"{p50:.0f}" if np.isfinite(p50) else "-"
            p99_s = f"{p99:.0f}" if np.isfinite(p99) else "-"
            print(f"    tier {label}: {cls['throughput']:.2f} infer/sec, "
                  f"p50 {p50_s} usec, p99 {p99_s} usec, shed "
                  f"{cls['rejected_per_sec']:.1f}/s "
                  f"({cls['rejected']} total)")
        if args.verbose:
            print("  result " + json.dumps(_json_sanitize(res)))
        sys.stdout.flush()

    if args.trace_file:
        # server-wide tracing for the sweep, turned on after every argument
        # check above, so the finally below always turns it off again
        _set_server_tracing(url, args.protocol, {
            "trace_file": [args.trace_file],
            "trace_level": ["TIMESTAMPS"],
            "trace_rate": [str(max(1, args.trace_rate))],
        })
    try:
        if open_loop:
            try:
                rates = _parse_rate_range(args.request_rate_range)
            except ValueError as e:
                parser.error(str(e))
            for rate in rates:
                res = run_rate_level(
                    target, args.model_name, args.model_version, rate, arrays,
                    outputs, args.shared_memory, output_size,
                    measure_s, distribution=args.request_distribution,
                    max_threads=args.max_threads,
                    extra_percentile=args.percentile,
                    cuda_device=args.cuda_shared_memory_device,
                    protocol=args.protocol, streaming=args.streaming,
                    qos_classes=qos_classes, retry_policy=retry_policy,
                    balancing=args.balancing, hedge_ms=args.hedge_ms)
                report(res, f"Request rate: {rate:g}/s, completed "
                            "(latency from scheduled send): ")
        else:
            for level in _parse_concurrency_range(args.concurrency_range):
                res = run_level(
                    target, args.model_name, args.model_version, level, arrays,
                    outputs, args.shared_memory, output_size,
                    measure_s, extra_percentile=args.percentile,
                    cuda_device=args.cuda_shared_memory_device,
                    protocol=args.protocol, streaming=args.streaming,
                    qos_classes=qos_classes, retry_policy=retry_policy,
                    balancing=args.balancing, hedge_ms=args.hedge_ms)
                report(res, f"Concurrency: {level}, throughput: ")
    finally:
        if args.trace_file:
            try:
                _set_server_tracing(url, args.protocol,
                                    {"trace_level": ["OFF"]})
            except Exception as e:  # noqa: BLE001 - best effort on teardown
                print(f"warning: could not disable server tracing: {e}",
                      file=sys.stderr)

    summary = None
    if args.trace_file:
        from .tools.trace_summary import (format_text, load_trace_file,
                                          summarize)

        try:
            summary = summarize(load_trace_file(args.trace_file))
            print("\n*** Server trace breakdown "
                  f"({args.trace_file}, every {max(1, args.trace_rate)}th "
                  "request) ***")
            print(format_text(summary), end="")
        except (OSError, ValueError) as e:
            # a file the server could not write (or this process cannot
            # read) does not fail a sweep that printed its numbers
            print(f"warning: could not summarize {args.trace_file}: {e}",
                  file=sys.stderr)

    if args.verbose:
        # a region module this run never imported holds no region (and
        # importing one would import torch into a run that needed none)
        shm = sys.modules.get(f"{__package__}.utils.shared_memory")
        cuda_shm = sys.modules.get(f"{__package__}.utils.cuda_shared_memory")
        print("regions left " + json.dumps({
            "system": (shm.mapped_shared_memory_regions()
                       if shm is not None else []),
            "cuda": (cuda_shm.allocated_shared_memory_regions()
                     if cuda_shm is not None else [])}))

    if args.export_metrics:
        exported = {
            "model": args.model_name,
            "protocol": args.protocol,
            "urls": urls,
            "shared_memory": args.shared_memory,
            "load_mode": "open_loop" if open_loop else "closed_loop",
            "results": results,
            "client_telemetry": telemetry().snapshot(),
        }
        if summary is not None:
            exported["server_trace_summary"] = summary
        with open(args.export_metrics, "w") as f:
            json.dump(_json_sanitize(exported), f, indent=2,
                      allow_nan=False)

    if args.latency_report_file:
        with open(args.latency_report_file, "w") as f:
            if open_loop:
                f.write("Request Rate,Inferences/Second,Avg latency,"
                        "p50 latency,p90 latency,p95 latency,p99 latency,"
                        "Unsent\n")
                for r in results:
                    f.write(f"{r['request_rate']:g},{r['throughput']:.2f},"
                            f"{r['avg_us']:.0f},{r['p50_us']:.0f},"
                            f"{r['p90_us']:.0f},{r['p95_us']:.0f},"
                            f"{r['p99_us']:.0f},{r['unsent']}\n")
            else:
                f.write("Concurrency,Inferences/Second,Avg latency,"
                        "p50 latency,p90 latency,p95 latency,p99 latency\n")
                for r in results:
                    f.write(f"{r['concurrency']},{r['throughput']:.2f},"
                            f"{r['avg_us']:.0f},{r['p50_us']:.0f},"
                            f"{r['p90_us']:.0f},{r['p95_us']:.0f},"
                            f"{r['p99_us']:.0f}\n")
    return 1 if all(r["throughput"] == 0 for r in results) else 0


if __name__ == "__main__":
    sys.exit(main())
