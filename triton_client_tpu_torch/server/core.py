"""Inference core of the port: validation, dynamic batching, readback.

Counterpart of the request path of ``triton_client_tpu/server/core.py``:
``InferenceCore.infer``, the ``_DynamicBatcher`` contract, input resolution
and shape checks, and response building.  The reference is asyncio-native
behind aiohttp; the port's frontend is ``http.server``'s thread-per-request
server, so the core is threaded: a request thread blocks on a future while
the model's batcher thread forms batches and a small pool executes them.

Device outputs are read back on the executing worker, never on the request
thread: each CUDA output is copied without blocking into pinned host memory,
one CUDA event is recorded behind the copies, and the worker waits on that
event (the counterpart of the reference's ``copy_to_host_async`` then
``np.asarray`` on the executor, core.py:2111-2116).

Ensembles run here too (the reference's ``_run_ensemble``,
core.py:2170-2262): a step runs once every tensor it reads is in the pool,
a member with dynamic batching runs through its own batcher so concurrent
ensemble requests coalesce on it, and the ensemble's outputs go through
:func:`readback`.  Ready steps run one after another on the request thread
(the reference gathers them on its event loop), and every step's outputs
come back to the host (the reference keeps an unbatched member's outputs on
the device).

Shared memory (the reference's ``system_shm`` / ``xla_shm`` registries,
core.py:2290-2294 and 2356-2380): an input that names a region is resolved
through the CUDA registry, else the system one, to a view of the region's
memory.  A request with any shared-memory input or output, or with a
``sequence_id``, bypasses the dynamic batcher and runs on its request
thread, as in the reference (``_use_batcher``, core.py:1715-1721).  An
output bound to a CUDA region is not read back: it is copied
device-to-device into the region, and one CUDA event recorded behind the
last such copy is waited on before the response goes out, so a client that
reads the region after the response sees the output.  An output bound to
a system region is read back, then copied into the mapping.

Sequence requests (``sequence_id``, ``sequence_start``, ``sequence_end``
request parameters, on either protocol) are routed as the reference routes
them: past the batcher, as is every request to a sequence model (its
state lives in the model, between requests); inside an ensemble the three
keys are stripped from a batched member's parameters, so concurrent
streams coalesce on it (core.py:2245-2251).

:meth:`InferenceCore.infer_stream` is the stream entry (the reference's,
core.py:1484-1695): one response per request, or for a decoupled model
0..N responses flagged ``triton_final_response`` false, then one empty
response flagged true.  A unary :meth:`InferenceCore.infer` refuses a
decoupled model, as the reference does.

Outputs requested with a ``classification`` count come back as the
reference's top-k ``"score:index[:label]"`` strings (``_classify``).  A
bf16 output is read back as a ``torch.bfloat16`` host tensor, not through
numpy: the frontends and the system-shm registry send its own bits.

Statistics (the reference's ``ModelStats.record`` calls and
``InferenceCore.statistics``): each execution's rows, queue and compute
ns, per model, in the same places as the reference records them.

Where ``InferenceCore.splits`` is a list, each request appends its
:class:`RequestSplit` to it: the server's time by phase.

Observability (the reference's ``InferenceCore.__init__``, core.py:851-884,
and its execute path, :2040-2130): the request tracer and the server log,
the flight recorder with its SLO engine, the device statistics and the
cost ledger.  A traced request (or one armed for the flight recorder) gets
a REQUEST root with DECODE (from the frontend), QUEUE, BATCH_ASSEMBLY
(batched), COMPUTE and D2H_TRANSFER children, each added to every traced
member of a batch; its context travels in the batcher's queue item and is
the executing thread's :func:`trace.current_trace`.  Each execution's
COMPUTE window is timed with two CUDA events on the card (host clock on
the CPU), read after the readback has waited on its own event; the span's
timestamps stay on ``time.monotonic_ns`` and its length is the events'
time.  The first execution of each input signature of a
:class:`TorchModel` runs counted (``costs.py``); the device statistics get
each execution window, the batcher's ticks (bucket, padded rows, queue
depth) and the readback transfers; the ledger charges each request its
slot share of the window, to the request's tenant (a batch's window
splits between its members by rows).

Admission (the reference's ``_admit``, core.py:1022-1145): every v2 infer
request passes, in order, the drain gate (503), its tenant's token bucket
(429), the memory governor's byte budget (429, or 413 for a request that
could never fit) and its QoS tier's share of the model's queue bound
(429, after trying to preempt queued lower-tier work), each refusal with
its pushback (``retry_after_s``).  The check and the pending count's
increment are one step under the core's admission lock, so concurrent
request threads see the bound as the reference's event loop does.  The
batcher's queue is QoS's :class:`TieredQueue`; each item carries its
deadline and ``(tenant, tier)``.  A request whose deadline passed fails
with 504 before any compute: at dequeue, at its batch's assembly and at
the last gate before the batch executes.  Chaos (``chaos.py``) draws once
per request inside the traced envelope.  :meth:`InferenceCore.drain` stops
admission (503) and waits for in-flight requests.

Device-loop models (``llama_decode`` and ``llama_generate``, whose worker
ticks on its own) get the device statistics, the cost ledger, the memory
governor, the device-fault manager and the chaos injector through their
``attach_*`` hooks before they execute, and the request's tenant as the
``_cost_tenant`` parameter; the stream's device time and prefix-cache
hit come back as the ``_cost_device_us`` and ``_cache_hit_tokens``
parameters and ride the final response as ``device_time_us`` and
``cache_hit_tokens`` (the reference's, core.py:1400-1406, :1585-1616,
:1695-1703).

Device-fault containment (the reference's ``DeviceFaultManager``,
core.py:543-808): the decode worker reports each failed dispatch; K
faults inside a sliding window, or one forced fault, quarantine the model:
not ready on both protocols and refused at admission with a typed 503,
the probe's pushback and the ``quarantined`` marker the clients' retry
layer reads.  Probes run on a doubling backoff, driven by the fleet
controller's loop where one runs (``core.fleet``, ``fleet.py``), else by
the core's own prober thread while a model is quarantined.  Each
quarantine writes a ``device_fault`` incident bundle.

The repository (the reference's ``load_model`` and
``retire_name_caches``, core.py:1780-1853): :meth:`InferenceCore.load_model`
draws the chaos ``load_fail`` first, then loads through the registry;
a load or an unload retires what the core keeps for the name's old
instances: each dynamic batcher is keyed ``name@version`` and runs one
instance in one config, so a swapped instance (or config) gets a new one
and the stale one's thread stops before the call answers; a request that
resolved a swapped-out instance before the swap is refused with 503
rather than given a batcher of it.  The SLO objective and the device
statistics' signatures go, and once the name is unloaded its prefix/KV
store, its quarantine state and its governor pins.  Server readiness is
false while a model is LOADING, which a load holds while it runs the
model's warmup samples (``warmup.py``; :meth:`InferenceCore.warmup_models`
runs them at server start).

The fleet (the reference's, core.py:263-296 and :1947-1972): a batcher
executes up to ``instances`` batches at once, resized live by the fleet
controller (``_DynamicBatcher.set_instances``), and a rolling update drains
the old version's batcher (:meth:`InferenceCore.drain_batcher`).  The
chaos ``worker_kill`` kind calls ``chaos.worker_kill_cb`` and fails its
request as a severed connection.

The response cache (the reference's ``_ResponseCache``, core.py:88-223,
and its use at :1336-1357 and :1435-1437): a model whose config enables
``response_cache`` answers a repeated request from :class:`_ResponseCache`
without a forward.  The key is (model, the registry's generation, the
resolved instance's ``served_version``, SHA-256 of the inputs, the
parameters and the requested outputs); sequence, shared-memory, decoupled
and ensemble requests bypass it, and so do inputs over ``MAX_KEY_BYTES``.
A hit counts in the model's statistics (no execution), stamps
``CACHE_HIT`` and the QUEUE span.  The lookup runs once the inputs are
resolved, the insert once the outputs are read back: by then every output
is a host numpy array or, for BF16, a CPU ``torch.bfloat16`` tensor, and
both are cached (a device tensor is never there: a CUDA-region output is
shared memory, which bypasses the cache).  Entries are frozen private
copies, evicted by LRU, the byte budget (``--cache-budget-bytes``) and the
model's ``response_cache.ttl_s``, counted per model.

The host's own view (the reference's, core.py:915-929 and :1776-1777):
``core.profiler`` (``profiler.py``: the sampler, the lag probes, the GC
pauses) and ``core.incidents`` (``incident.py``), which the flight
recorder feeds (``slo_burn``, ``watchdog_storm``).  Both start when
:meth:`InferenceCore.warmup_models` has run and stop at
:meth:`InferenceCore.shutdown`.  A chaos ``mem_pressure`` draw writes a
``chaos`` bundle on a thread of its own, and so does a ``worker_kill``
draw, started before the callback (the CLI worker's callback waits for
the bundle, then ends the process).
:meth:`InferenceCore.enable_otlp` exports every trace record to an OTLP
collector (``otlp.py``).
"""

from __future__ import annotations

import concurrent.futures
import queue
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import (Any, Collection, Dict, Iterator, List, Optional, Set,
                    Tuple)

import numpy as np
import torch

from ..utils import np_to_triton_dtype, torch_to_triton_dtype
from . import costs
from .chaos import ChaosAbort
from .costs import CostLedger, classify_roofline
from .device_stats import DeviceStatsCollector, SloEngine, SloObjective
from .flight_recorder import FlightRecorder
from .incident import IncidentRecorder
from .log import LOG_DEFAULTS, ServerLog
from .memory import MemoryGovernor
from .model import EnsembleModel, Model, TorchModel
from .profiler import HostProfiler
from .qos import DEFAULT_TENANT, QosManager, TieredQueue
from .registry import ModelRegistry
from .shm import CudaShmRegistry, SystemShmRegistry
from .trace import (TRACE_DEFAULTS, RequestTracer, reset_current_trace,
                    set_current_trace)
from .types import (InferError, InferRequest, InferResponse, InputTensor,
                    OutputTensor)
from .wire import ResponseTemplateCache


def _batch_count(inputs: Dict[str, Any]) -> int:
    for v in inputs.values():
        return int(v.shape[0]) if getattr(v, "ndim", 0) > 0 else 1
    return 1


#: the sequence-control request parameters
SEQUENCE_KEYS = ("sequence_id", "sequence_start", "sequence_end")


@dataclass
class RequestSplit:
    """One request's time in the server, in ms, by phase: ``decode`` of the
    wire request (host clock), ``resolve`` of its inputs, shared-memory
    regions included (host clock), ``forward`` (CUDA events around the
    model's execution where it runs on the card, else host clock; the copy
    of host inputs to the card is part of it), ``output``: from the forward's
    end to every output read back or written into its region (host clock),
    and ``total`` from the start of decode to the response built.  On a
    batched request, ``forward`` and ``output`` are its batch's."""

    decode: float = 0.0
    resolve: float = 0.0
    forward: float = 0.0
    output: float = 0.0
    total: float = 0.0
    # host clock when the forward was done (perf_counter_ns)
    forward_done_ns: int = 0


class _ComputeWindow:
    """One execution's COMPUTE window: two CUDA events around it on the
    card, the host clock on the CPU.  ``t0`` is the host's
    ``time.monotonic_ns`` at its start (the span's start); its length is
    read once the outputs' readback has waited on its own event, so on the
    card :meth:`elapsed_ns` waits for nothing more (an execution whose
    outputs all stay on the card waits for its end here)."""

    __slots__ = ("t0", "t1", "_events")

    def __init__(self, device) -> None:
        self._events = None
        if device is not None and device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            self._events = (start, end)
        self.t0 = time.monotonic_ns()
        self.t1 = self.t0
        if self._events is not None:
            self._events[0].record()

    def close(self) -> None:
        """The execution was issued."""
        if self._events is not None:
            self._events[1].record()
        self.t1 = time.monotonic_ns()

    def elapsed_ns(self) -> int:
        if self._events is None:
            return self.t1 - self.t0
        start, end = self._events
        end.synchronize()
        return int(start.elapsed_time(end) * 1e6)


def _signature(inputs: Dict[str, Any]) -> tuple:
    """An execution's input signature: each input's name, shape and
    dtype."""
    return tuple(sorted(
        (n, tuple(getattr(v, "shape", ())), str(getattr(v, "dtype", None)))
        for n, v in inputs.items()))


def readback(outputs: Dict[str, Any]) -> Dict[str, Any]:
    """Every output as a host numpy array, a bf16 one as a CPU
    ``torch.bfloat16`` tensor (numpy has no bf16).

    CUDA tensors are copied without blocking into pinned memory and the
    caller waits on one event recorded behind all the copies; CPU tensors
    convert without a copy."""
    staged: Dict[str, Any] = {}
    event = None
    for name, v in outputs.items():
        if isinstance(v, torch.Tensor) and v.is_cuda:
            host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            host.copy_(v, non_blocking=True)
            staged[name] = host
            if event is None:
                event = torch.cuda.Event()
        else:
            staged[name] = v
    if event is not None:
        event.record()
        event.synchronize()
    out = {}
    for name, v in staged.items():
        if isinstance(v, torch.Tensor):
            if v.dtype == torch.bfloat16:
                out[name] = v
                continue
            v = v.numpy()
        out[name] = np.asarray(v)
    return out


def _host_array(value) -> np.ndarray:
    """An output as a numpy array on the host (bf16 widened to f32, exact)."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        return (value.float() if value.dtype == torch.bfloat16
                else value).numpy()
    return np.asarray(value)


_STOP = object()


def _cacheable(v) -> Optional[np.ndarray]:
    """A host value as a numpy array to hash or to cache (a CPU BF16
    tensor as its int16 bit pattern); None for anything else, such as a
    tensor on the card."""
    if isinstance(v, np.ndarray):
        return v
    if isinstance(v, torch.Tensor) and v.device.type == "cpu":
        if v.dtype == torch.bfloat16:
            return v.contiguous().view(torch.int16).numpy()
        return v.numpy()
    return None


class _ResponseCache:
    """The TTL and byte-budget LRU of identical requests' responses
    (Triton's ``response_cache.enable``).

    At most ``MAX_ENTRIES`` entries of at most ``MAX_ITEM_BYTES`` each;
    an entry older than its model's TTL answers as a miss and is evicted;
    ``budget_bytes`` (None or 0: none) caps the entries' bytes together,
    an insert evicting LRU entries to fit.  Hits and misses count per
    model at lookup, evictions (LRU, budget, TTL) at eviction:
    ``nv_cache_num_{hits,misses,evictions}_per_model``."""

    MAX_ENTRIES = 64
    MAX_ITEM_BYTES = 8 << 20
    # larger inputs are not hashed on the request's path: they bypass
    MAX_KEY_BYTES = 1 << 20

    def __init__(self, budget_bytes: Optional[int] = None) -> None:
        # key -> (frozen outputs, expiry on the monotonic clock or None,
        # bytes)
        self._entries: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._total_bytes = 0
        self.budget_bytes = budget_bytes
        self.hits = 0
        self.misses = 0
        self.hits_by_model: Dict[str, int] = {}
        self.misses_by_model: Dict[str, int] = {}
        self.evictions_by_model: Dict[str, int] = {}
        # request threads look up and insert at once
        self._lock = threading.Lock()

    @staticmethod
    def _nbytes(v: np.ndarray) -> int:
        if v.dtype != object:
            return v.nbytes
        return sum(len(x) if isinstance(x, (bytes, str)) else 64
                   for x in v.reshape(-1))

    @staticmethod
    def key(model: Model, generation: int, request: InferRequest,
            inputs: Dict[str, Any]) -> Optional[tuple]:
        """The request's key; None where an input is not on the host or
        the inputs are over ``MAX_KEY_BYTES``."""
        import hashlib

        arrays = {}
        for name, v in inputs.items():
            arr = _cacheable(v)
            if arr is None:
                return None
            arrays[name] = arr
        if sum(map(_ResponseCache._nbytes, arrays.values())) \
                > _ResponseCache.MAX_KEY_BYTES:
            return None
        h = hashlib.sha256()
        for name in sorted(arrays):
            v = arrays[name]
            # the type names the tensor, so that BF16 bits never equal an
            # INT16 input's
            h.update(name.encode())
            h.update(str(inputs[name].dtype).encode())
            h.update(str(v.shape).encode())
            h.update(v.tobytes() if v.dtype != object
                     else repr(v.tolist()).encode())
        h.update(repr(sorted(request.parameters.items())).encode())
        h.update(repr(sorted(
            (o.name, o.class_count) for o in request.outputs)).encode())
        # the resolved instance's version: after a rolling update flips an
        # unversioned request to the new version, the old entry misses
        return (model.name, generation, model.served_version, h.hexdigest())

    def _count_eviction(self, model: str) -> None:
        self.evictions_by_model[model] = \
            self.evictions_by_model.get(model, 0) + 1

    def get(self, key: tuple) -> Optional[Dict[str, Any]]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and entry[1] is not None \
                    and time.monotonic() >= entry[1]:
                # past its TTL: evicted at lookup, a miss
                del self._entries[key]
                self._total_bytes -= entry[2]
                self._count_eviction(key[0])
                entry = None
            if entry is None:
                self.misses += 1
                self.misses_by_model[key[0]] = \
                    self.misses_by_model.get(key[0], 0) + 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            self.hits_by_model[key[0]] = \
                self.hits_by_model.get(key[0], 0) + 1
        return {n: (torch.from_numpy(v.copy()).view(torch.bfloat16)
                    if bf16 else v) for n, (v, bf16) in entry[0].items()}

    def put(self, key: tuple, outputs: Dict[str, Any],
            ttl_s: Optional[float] = None) -> None:
        """Cache ``outputs`` under ``key``: frozen copies (the model may
        reuse its buffers; writing to a hit raises).  Skipped where an
        output is not on the host or the entry is over ``MAX_ITEM_BYTES``
        or the whole budget."""
        frozen = {}
        total = 0
        for name, v in outputs.items():
            arr = _cacheable(v)
            if arr is None:
                return
            arr = arr.copy()
            arr.flags.writeable = False
            frozen[name] = (arr, isinstance(v, torch.Tensor)
                            and v.dtype == torch.bfloat16)
            total += self._nbytes(arr)
        if total > self.MAX_ITEM_BYTES:
            return
        if self.budget_bytes and total > self.budget_bytes:
            return  # larger than the whole budget: it would only churn
        expires = (time.monotonic() + ttl_s
                   if ttl_s is not None and ttl_s > 0 else None)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._total_bytes -= old[2]  # a replacement, no eviction
            self._entries[key] = (frozen, expires, total)
            self._total_bytes += total
            while len(self._entries) > self.MAX_ENTRIES or (
                    self.budget_bytes
                    and self._total_bytes > self.budget_bytes):
                k, evicted = self._entries.popitem(last=False)
                self._total_bytes -= evicted[2]
                self._count_eviction(k[0])

    @property
    def total_bytes(self) -> int:
        return self._total_bytes


def _model_cache_ttl(model: Model) -> Optional[float]:
    """A model's response-cache TTL, its config's ``response_cache.ttl_s``
    parameter (None: entries never expire)."""
    try:
        ttl = float(model.config.parameters["response_cache.ttl_s"])
    except (KeyError, ValueError):
        return None
    return ttl if ttl > 0 else None


def _batcher_key(model: Model) -> str:
    """A batcher per served version: ``name@version``."""
    return f"{model.name}@{model.served_version}"


def _fail(fut: concurrent.futures.Future, err: Exception) -> None:
    """Fail a queued request's future once (a no-op where it is done)."""
    try:
        fut.set_exception(err)
    except concurrent.futures.InvalidStateError:
        pass


class _BatcherStopped(Exception):
    """Raised by :meth:`_DynamicBatcher.submit` on a batcher that is
    stopping: the request was not queued (the core resolves a batcher
    again)."""


class _DynamicBatcher:
    """Queue + pad-to-bucket batcher for one model.

    Groups concurrent requests for up to ``max_queue_delay_microseconds``
    (or until the largest preferred batch size is reached), concatenates
    them along the batch axis, pads the batch to the smallest preferred
    size that holds it, executes once and splits the results.  A request
    that would overflow ``max_batch_size`` seeds the next batch.

    Up to ``instances`` batches execute at once (``MAX_INFLIGHT`` unless the
    fleet controller set a target for the model): a permit count under a
    condition variable, resized live by :meth:`set_instances`, and a pool
    of batch threads that grows with it.

    The queue is QoS's :class:`TieredQueue`: strict-priority (or
    weighted-fair) across tiers, FIFO within one; the core's admission may
    preempt its lower lanes.  An item whose deadline passed is failed with
    504 at dequeue and again before its batch executes."""

    MAX_INFLIGHT = 4

    def __init__(self, core: "InferenceCore", model: Model,
                 instances: Optional[int] = None):
        self._core = core
        self._model = model
        cfg = self._config = model.config
        self._max_delay_s = cfg.max_queue_delay_microseconds / 1e6
        self._buckets = sorted(cfg.preferred_batch_size)
        self._max_bs = cfg.max_batch_size
        self._queue = TieredQueue(core.qos.tiers, weights=core.qos.weights)
        #: the batches executing at once: the fleet controller's actuation
        #: target (a batcher born while the model is scaled starts there)
        self.instances = max(1, int(instances or self.MAX_INFLIGHT))
        # the permits free, the batches running, and the permits a shrink
        # still owes: completions absorb the debt instead of freeing their
        # permit, so a shrink never interrupts a batch nor touches the queue
        self._cv = threading.Condition()
        self._permits = self.instances
        self._running = 0
        self._shrink_debt = 0
        self._workers = self.instances
        self._pool = concurrent.futures.ThreadPoolExecutor(
            self._workers, thread_name_prefix=f"batch-{model.name}")
        self._stopping = False
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"batcher-{model.name}")
        self._thread.start()

    def set_instances(self, n: int) -> None:
        """Resize the batches in flight.  Growth frees permits at once (and
        grows the pool); a shrink takes the free permits, and what it still
        owes is a debt that completions absorb (the reference's shrink
        debt)."""
        n = max(1, int(n))
        with self._cv:
            delta = n - self.instances
            self.instances = n
            if delta > 0:
                settle = min(delta, self._shrink_debt)
                self._shrink_debt -= settle
                self._permits += delta - settle
                if n > self._workers:
                    # the old pool's threads finish their batches, then go
                    old, self._workers = self._pool, n
                    self._pool = concurrent.futures.ThreadPoolExecutor(
                        n, thread_name_prefix=f"batch-{self._model.name}")
                    old.shutdown(wait=False)
                self._cv.notify_all()
            elif delta < 0:
                # the free permits go at once; what is executing owes
                # the rest
                take = min(-delta, self._permits)
                self._permits -= take
                self._shrink_debt += -delta - take

    def idle(self) -> bool:
        """Nothing queued and no batch executing."""
        with self._cv:
            return not self._queue.qsize() and not self._running

    def submit(self, inputs: Dict[str, np.ndarray],
               parameters: Dict[str, Any],
               split: Optional[RequestSplit] = None, trace=None,
               deadline_ns: int = 0, tenant: str = "",
               tier: int = 0) -> Dict[str, np.ndarray]:
        """Queue one request in its tier's lane and wait for its rows of
        the batch's outputs.  A queue item is ``(inputs, parameters,
        future, split, enqueue_ns, trace, deadline_ns, (tenant, tier))``:
        the trace context travels with it to the thread that executes the
        batch.  Raises :class:`_BatcherStopped` on a stopping batcher."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._cv:
            if self._stopping:
                raise _BatcherStopped()
            self._queue.put_nowait((inputs, parameters, fut, split,
                                    time.monotonic_ns(), trace, deadline_ns,
                                    (tenant, tier)), tier)
        return fut.result()

    def serves(self, model: Model) -> bool:
        """Whether this batcher runs ``model`` in its present config (a
        load's override swaps the config of a registered instance)."""
        return self._model is model and self._config is model.config

    def stop(self, reason: str = "server is shutting down") -> None:
        """Stop the batcher thread after the batch it is forming, and wait
        for the batches executing; whatever is still queued then fails
        with 503 and ``reason``."""
        with self._cv:
            self._stopping = True
            self._queue.put_nowait(_STOP, 0)
            self._cv.notify_all()
        self._thread.join(timeout=30)
        with self._cv:
            self._cv.wait_for(lambda: not self._running, timeout=30)
            pool = self._pool
        pool.shutdown(wait=True)
        for item in self._queue.drain():
            if item is not _STOP:
                _fail(item[2], InferError(reason, 503))

    def _acquire(self) -> None:
        with self._cv:
            self._cv.wait_for(lambda: self._permits > 0)
            self._permits -= 1
            self._running += 1

    def _release(self, _task=None) -> None:
        with self._cv:
            self._running -= 1
            if self._shrink_debt > 0:
                self._shrink_debt -= 1
            else:
                self._permits += 1
            self._cv.notify_all()

    def _drop_if_expired(self, item) -> bool:
        """Fail an item whose deadline passed while it queued (504, before
        any concatenation, padding or compute)."""
        deadline_ns = item[6]
        if not deadline_ns or time.monotonic_ns() < deadline_ns:
            return False
        self._core.count_deadline_exceeded(self._model.name)
        _fail(item[2], InferError(
            f"request to model '{self._model.name}' exceeded its "
            "deadline while queued", http_status=504))
        return True

    def _run(self) -> None:
        carry = None
        while True:
            first = carry if carry is not None else self._queue.get()
            carry = None
            if first is _STOP:
                return
            if self._drop_if_expired(first):
                continue  # expired at dequeue: zero compute
            pending = [first]
            total = _batch_count(first[0])
            deadline = time.monotonic() + self._max_delay_s
            stop = False
            while total < self._max_bs:
                if self._buckets and total >= self._buckets[-1]:
                    break
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    item = self._queue.get(timeout=timeout)
                except queue.Empty:
                    break
                if item is _STOP:
                    stop = True
                    break
                if self._drop_if_expired(item):
                    continue
                count = _batch_count(item[0])
                if total + count > self._max_bs:
                    carry = item
                    break
                pending.append(item)
                total += count
            self._acquire()
            # under the lock: set_instances may replace (and shut) the pool
            with self._cv:
                task = self._pool.submit(self._execute_batch, pending)
            task.add_done_callback(self._release)
            if stop:
                return

    def _execute_batch(self, pending) -> None:
        # requests with different parameters must not share an execution
        groups: Dict[tuple, list] = {}
        for item in pending:
            key = tuple(sorted((k, repr(v)) for k, v in item[1].items()))
            groups.setdefault(key, []).append(item)
        for group in groups.values():
            self._execute_group(group)

    def _execute_group(self, pending) -> None:
        # the last deadline gate: a member that expired after dequeue must
        # not ride the execution
        pending = [p for p in pending if not self._drop_if_expired(p)]
        if not pending:
            return
        counts = [_batch_count(p[0]) for p in pending]
        total = sum(counts)
        padded = total
        for b in self._buckets:
            if total <= b:
                padded = b
                break
        traces = [p[5] for p in pending if p[5] is not None]
        t_asm0 = time.monotonic_ns()
        # requests left waiting while this batch forms
        queue_depth = self._queue.qsize()
        for item in pending:
            if item[5] is not None:
                item[5].add_span("QUEUE", item[4], t_asm0)
        core = self._core
        try:
            merged = {}
            for n in pending[0][0]:
                parts = [p[0][n] for p in pending]
                arr = np.concatenate(parts, axis=0) if len(parts) > 1 \
                    else parts[0]
                if padded > total:
                    arr = np.pad(arr, [(0, padded - total)]
                                 + [(0, 0)] * (arr.ndim - 1))
                merged[n] = arr
            split = RequestSplit() if any(p[3] is not None
                                          for p in pending) else None
            t0 = time.monotonic_ns()
            for trace in traces:
                trace.add_span("BATCH_ASSEMBLY", t_asm0, t0)
            queue_ns = t0 - pending[0][4]
            exec_stats: Dict[str, Any] = {}
            outputs = core.run_model(self._model, merged, pending[0][1],
                                     split, traces=traces,
                                     exec_stats=exec_stats, real_batch=total)
            compute_ns = time.monotonic_ns() - t0
            self._model.stats.record(total, queue_ns, compute_ns, ok=True)
            self._model.stats.record_batch(total)
            exec_stats.setdefault("compute_ns", compute_ns)
            if core.device_stats.enabled:
                self._record_tick(pending, total, padded, queue_depth,
                                  t0 - t_asm0, exec_stats)
            self._charge(pending, counts, total, exec_stats)
            offset = 0
            for item, count in zip(pending, counts):
                if item[3] is not None:
                    item[3].forward = split.forward
                    item[3].forward_done_ns = split.forward_done_ns
                item[2].set_result({n: v[offset:offset + count]
                                    for n, v in outputs.items()})
                offset += count
        except Exception as e:  # every member of the batch gets the error
            self._model.stats.record(total, 0, 0, ok=False)
            for item in pending:
                if not item[2].done():
                    item[2].set_exception(e)

    def _record_tick(self, pending, total: int, padded: int,
                     queue_depth: int, assembly_ns: int,
                     exec_stats: Dict[str, Any]) -> None:
        """One tick record per batched execution; its shape rides each
        traced member's trace and flight record."""
        self._core.device_stats.record_tick(
            self._model.name, bucket=padded, batch=total, padded=padded,
            queue_depth=queue_depth, assembly_ns=assembly_ns,
            compute_ns=exec_stats["compute_ns"],
            requests=len(pending), syncs=exec_stats.get("d2h_syncs", 0),
            flops=exec_stats.get("flops", 0.0),
            bytes_accessed=exec_stats.get("bytes_accessed", 0.0))
        tick = {
            "bucket": padded, "batch": total,
            "pad_fraction": (round((padded - total) / padded, 4)
                             if padded else 0.0),
            "queue_depth": queue_depth,
            "assembly_us": round(assembly_ns / 1e3, 1),
            "requests": len(pending),
        }
        for item in pending:
            tr = item[5]
            if tr is not None:
                tr.tick = tick
                if tr.flight is not None:
                    tr.flight.tick = tick

    def _charge(self, pending, counts, total: int,
                exec_stats: Dict[str, Any]) -> None:
        """Each member's slot share (its rows over the batch's) of the
        compute window and of the signature's FLOPs: the shares sum to the
        window the tick recorded."""
        ledger = self._core.cost_ledger
        if not (ledger.enabled and total > 0):
            return
        exec_ns = exec_stats["compute_ns"]
        exec_flops = exec_stats.get("flops", 0.0)
        roofline = classify_roofline(exec_flops,
                                     exec_stats.get("bytes_accessed", 0.0))
        verdict = roofline["verdict"] if roofline is not None else None
        for item, count in zip(pending, counts):
            tenant = item[7][0]
            share = count / total
            dev_us = exec_ns * share / 1e3
            flops_share = exec_flops * share
            ledger.charge(self._model.name, tenant, device_us=dev_us,
                          flops=flops_share)
            tr = item[5]
            if tr is not None:
                cost = {"tenant": tenant, "device_us": round(dev_us, 1)}
                if flops_share:
                    cost["flops"] = flops_share
                if verdict is not None:
                    cost["roofline"] = verdict
                tr.cost = cost
                if tr.flight is not None:
                    tr.flight.cost = cost


class DeviceFaultManager:
    """Device-fault accounting and the per-model quarantine state machine
    (the reference's, with its thresholds, texts and export rows).

    The decode worker and its stall watchdog report each failed dispatch
    (``record_fault``); ``threshold`` faults inside the sliding
    ``window_s``, or a forced fault, quarantine the model: not ready on
    both protocols (``InferenceCore.model_ready``) and refused at admission
    with a typed retryable 503 (``refusal_reason="quarantine"``).  Due
    probes (``maybe_probe``) run on a doubling backoff: a registered probe
    that succeeds releases the model, and ``escalate_after`` failures in a
    row call ``escalation_cb`` once.  A model with no probe is released
    when its backoff expires; a persistent fault trips the detector again.
    Thread-safe: faults arrive from the decode worker and the watchdog,
    probes run on threads of their own, admission reads from request
    threads."""

    #: how often the core's prober thread looks for due probes
    PROBE_POLL_S = 0.05

    def __init__(self, core=None, threshold: int = 3, window_s: float = 30.0,
                 probe_backoff_s: float = 1.0,
                 probe_backoff_max_s: float = 30.0,
                 escalate_after: int = 3):
        self.core = core
        self.threshold = max(1, int(threshold))
        self.window_s = float(window_s)
        self.probe_backoff_s = float(probe_backoff_s)
        self.probe_backoff_max_s = float(probe_backoff_max_s)
        self.escalate_after = max(1, int(escalate_after))
        #: called once per quarantine as ``cb(model, state)`` when
        #: ``escalate_after`` probes in a row failed
        self.escalation_cb = None
        self._lock = threading.Lock()
        # nv_device_fault_total{model,kind} and the sequence counters
        self._faults: Dict[Tuple[str, str], int] = {}
        self._recovered: Dict[str, int] = {}
        self._aborted: Dict[str, int] = {}
        # the sliding K-in-window detector, per model
        self._recent: Dict[str, List[float]] = {}
        # model -> {"since", "reason", "backoff_s", "probe_at",
        #           "probes_failed", "escalated"}
        self._quarantined: Dict[str, Dict[str, Any]] = {}
        self._probes: Dict[str, Any] = {}
        self._probing: Set[str] = set()
        # every model that ever faulted keeps a 0/1 gauge row
        self._ever: Set[str] = set()
        self._prober: Optional[threading.Thread] = None

    # -- fault intake ------------------------------------------------------
    def record_fault(self, model: str, kind: str, reason: str = "",
                     force_quarantine: bool = False) -> bool:
        """One device fault (``kind``: prefill / step / readback / rebuild
        / tick_stall).  True when it tripped (or kept) the quarantine."""
        now = time.monotonic()
        with self._lock:
            self._ever.add(model)
            key = (model, kind)
            self._faults[key] = self._faults.get(key, 0) + 1
            recent = self._recent.setdefault(model, [])
            recent.append(now)
            cutoff = now - self.window_s
            while recent and recent[0] < cutoff:
                recent.pop(0)
            trip = force_quarantine or len(recent) >= self.threshold
        if trip:
            self.quarantine(model, reason or f"{kind} fault")
        return trip

    def record_recovered(self, model: str, n: int = 1) -> None:
        """``n`` generations re-admitted after a device fault."""
        with self._lock:
            self._ever.add(model)
            self._recovered[model] = self._recovered.get(model, 0) + int(n)

    def record_aborted(self, model: str, n: int = 1) -> None:
        """``n`` generations that got the typed 500 instead."""
        with self._lock:
            self._ever.add(model)
            self._aborted[model] = self._aborted.get(model, 0) + int(n)

    # -- the state machine -------------------------------------------------
    def quarantine(self, model: str, reason: str = "") -> None:
        """Quarantine ``model`` (a fault while quarantined only refreshes
        the reason)."""
        now = time.monotonic()
        with self._lock:
            self._ever.add(model)
            state = self._quarantined.get(model)
            if state is not None:
                state["reason"] = reason or state["reason"]
                return
            self._quarantined[model] = {
                "since": now,
                "reason": reason,
                "backoff_s": self.probe_backoff_s,
                "probe_at": now + self.probe_backoff_s,
                "probes_failed": 0,
                "escalated": False,
            }
        core = self.core
        if core is not None:
            core.log.error(f"model '{model}' quarantined: {reason}")
            # the postmortem of the moment the device went bad
            core.incidents.trigger(
                "device_fault",
                reason=f"model '{model}' quarantined: {reason}",
                context={"model": model, "reason": reason})
            self._start_prober()

    def unquarantine(self, model: str) -> None:
        with self._lock:
            if self._quarantined.pop(model, None) is None:
                return
            # a fault after the release starts a fresh window
            self._recent.pop(model, None)
        core = self.core
        if core is not None:
            core.log.warning(f"model '{model}' un-quarantined")

    def forget(self, model: str) -> None:
        """An unloaded model's quarantine, fault window and probe (which
        holds the retired instance) go; its counters stay."""
        with self._lock:
            self._quarantined.pop(model, None)
            self._recent.pop(model, None)
            self._probes.pop(model, None)

    def is_quarantined(self, model: str) -> bool:
        with self._lock:
            return model in self._quarantined

    def retry_in(self, model: str) -> float:
        """A refusal's pushback: the time until the next probe could
        release the model, at least 50 ms."""
        now = time.monotonic()
        with self._lock:
            state = self._quarantined.get(model)
            if state is None:
                return 0.05
            return max(0.05, state["probe_at"] - now)

    # -- probing -----------------------------------------------------------
    def register_probe(self, model: str, cb) -> None:
        """``cb() -> bool`` runs one real probe dispatch; True releases."""
        with self._lock:
            self._probes[model] = cb

    def maybe_probe(self, now: Optional[float] = None) -> None:
        """Start the due probes, each on a thread of its own (a probe is a
        device dispatch); a model with no probe is released."""
        now = time.monotonic() if now is None else now
        due: List[Tuple[str, Any]] = []
        with self._lock:
            for model, state in self._quarantined.items():
                if now < state["probe_at"] or model in self._probing:
                    continue
                cb = self._probes.get(model)
                if cb is not None:
                    self._probing.add(model)
                due.append((model, cb))
        for model, cb in due:
            if cb is None:
                self.unquarantine(model)
                continue
            threading.Thread(
                target=self._run_probe, args=(model, cb), daemon=True,
                name=f"tc-torch-fault-probe-{model}").start()

    def _run_probe(self, model: str, cb) -> None:
        try:
            ok = bool(cb())
        except Exception:  # noqa: BLE001 - a raising probe failed
            ok = False
        finally:
            with self._lock:
                self._probing.discard(model)
        self.note_probe_result(model, ok)

    def note_probe_result(self, model: str, ok: bool) -> None:
        if ok:
            self.unquarantine(model)
            return
        escalate = None
        with self._lock:
            state = self._quarantined.get(model)
            if state is None:
                return
            state["probes_failed"] += 1
            state["backoff_s"] = min(self.probe_backoff_max_s,
                                     state["backoff_s"] * 2.0)
            state["probe_at"] = time.monotonic() + state["backoff_s"]
            if (state["probes_failed"] >= self.escalate_after
                    and not state["escalated"]):
                state["escalated"] = True
                escalate = dict(state)
        if escalate is None:
            return
        core = self.core
        if core is not None:
            core.log.error(
                f"model '{model}' still quarantined after "
                f"{escalate['probes_failed']} failed probes; escalating to "
                "supervisor")
        cb = self.escalation_cb
        if cb is not None:
            try:
                cb(model, escalate)
            except Exception:  # noqa: BLE001 - probing goes on
                pass

    def _start_prober(self) -> None:
        """The core's own probe loop, for where no fleet loop runs (the
        reference runs due probes from its fleet loop only): one daemon
        thread while any model is quarantined."""
        with self._lock:
            if self._prober is not None:
                return
            self._prober = threading.Thread(
                target=self._prober_loop, daemon=True,
                name="tc-torch-fault-prober")
            self._prober.start()

    def _prober_loop(self) -> None:
        while True:
            time.sleep(self.PROBE_POLL_S)
            with self._lock:
                if not self._quarantined:
                    self._prober = None
                    return
            fleet = getattr(self.core, "fleet", None)
            if fleet is not None and fleet.running:
                continue  # the fleet's loop drives the probes
            self.maybe_probe()

    # -- surfaces ----------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        now = time.monotonic()
        with self._lock:
            return {
                "faults": {f"{m}/{k}": v
                           for (m, k), v in sorted(self._faults.items())},
                "recovered": dict(self._recovered),
                "aborted": dict(self._aborted),
                "quarantined": {
                    m: {"since_s": round(now - s["since"], 3),
                        "reason": s["reason"],
                        "backoff_s": s["backoff_s"],
                        "probes_failed": s["probes_failed"],
                        "escalated": s["escalated"]}
                    for m, s in sorted(self._quarantined.items())},
            }

    def metric_rows(self) -> Dict[str, List[Tuple[Dict[str, str], float]]]:
        """The ``nv_device_*`` rows (``metrics.collect_families``)."""
        with self._lock:
            fault = [({"model": m, "kind": k}, float(v))
                     for (m, k), v in sorted(self._faults.items())]
            recovered = [({"model": m}, float(v))
                         for m, v in sorted(self._recovered.items())]
            aborted = [({"model": m}, float(v))
                       for m, v in sorted(self._aborted.items())]
            quarantine = [({"model": m},
                           1.0 if m in self._quarantined else 0.0)
                          for m in sorted(self._ever)]
        return {"device_fault": fault, "device_recovered": recovered,
                "device_aborted": aborted, "device_quarantine": quarantine}


class InferenceCore:
    SERVER_NAME = "triton_client_tpu_torch_harness"
    SERVER_VERSION = "2.0.0-cuda"
    # the reference's list in its order, less xla_shared_memory (the
    # port's device regions are cuda_shared_memory)
    EXTENSIONS = ["classification", "sequence", "model_repository",
                  "model_repository(unload_dependents)", "schedule_policy",
                  "model_configuration", "system_shared_memory",
                  "cuda_shared_memory", "binary_tensor_data", "statistics",
                  "trace", "logging"]

    def __init__(self, registry: ModelRegistry):
        self.registry = registry
        self.system_shm = SystemShmRegistry()
        self.cuda_shm = CudaShmRegistry()
        self._batchers: Dict[str, _DynamicBatcher] = {}
        self._lock = threading.Lock()
        # set by shutdown(): no batcher is made after it
        self._closed = False
        self.live = True
        #: the fleet controller (``fleet.py``), or None: it sets the
        #: batchers' instances, rolls versions and, while its loop runs,
        #: drives the quarantine probes
        self.fleet = None
        #: a list to collect each request's RequestSplit in, or None
        self.splits: Optional[List[RequestSplit]] = None
        self.trace_settings: Dict[str, List[str]] = {
            k: list(v) for k, v in TRACE_DEFAULTS.items()}
        self.log_settings: Dict[str, Any] = dict(LOG_DEFAULTS)
        self.tracer = RequestTracer(self.trace_settings)
        self.log = ServerLog(self.log_settings)
        # every request's summary, and the tail-latency watchdog; the
        # tracer hands it each armed context at the end
        self.flight_recorder = FlightRecorder()
        self.tracer.flight_recorder = self.flight_recorder
        # the host's own view and the postmortems; both start with
        # warmup_models, so a bare core starts no thread
        self.profiler = HostProfiler()
        self.incidents = IncidentRecorder(self)
        self.flight_recorder.incidents = self.incidents
        # compute windows (duty cycle, live MFU), signature events,
        # transfers and batcher ticks: the nv_tpu_* family
        self.device_stats = DeviceStatsCollector()
        # SLO burn rates: objectives from --slo or the model config's
        # slo.p99_ms / slo.availability parameters
        self.slo = SloEngine()
        self.slo.resolver = self._slo_from_config
        self.flight_recorder.slo_engine = self.slo
        # per-(model, tenant) device time and FLOPs: nv_cost_*
        self.cost_ledger = CostLedger()
        # -- admission -----------------------------------------------------
        # False once a drain began: new requests get 503 while in-flight
        # ones finish
        self.accepting = True
        # a model's bound on pending requests (0 = unbounded): the runtime
        # override in queue_limits, the config's max_queue_size parameter,
        # then this default
        self.default_max_queue_size = 0
        self.queue_limits: Dict[str, int] = {}
        # base pushback of a shed (Retry-After / retry-after-ms), scaled by
        # the shed tier's depth
        self.shed_retry_after_s = 0.25
        # priority tiers, tenant buckets, the best-effort lane (qos.py)
        self.qos = QosManager()
        # request and response bytes against --mem-budget-bytes (memory.py)
        self.memory = MemoryGovernor()
        # the fault injector (chaos.py, --chaos*), or None
        self.chaos = None
        # the quarantine state machine: the decode worker reports its
        # dispatch faults, admission and readiness consult it
        self.device_faults = DeviceFaultManager(self)
        # the check of a request's bound and its pending increment are one
        # step: request threads admit one at a time
        self._admit_lock = threading.Lock()
        # nv_inference_rejected_total / nv_inference_deadline_exceeded_total
        self._counts_lock = threading.Lock()
        self.rejected_by_model: Dict[str, int] = {}
        self.deadline_exceeded_by_model: Dict[str, int] = {}
        # identical requests answered without a forward (a model's config
        # enables it; --cache-budget-bytes sets budget_bytes)
        self.response_cache = _ResponseCache()
        # the wire templates (wire.py): per-(model, output set) compiled
        # responses, one cache per frontend protocol, keyed by the
        # registry's generation; retire_name_caches drops a name's entries;
        # a template that raises is logged once per (model, exception type)
        self.http_wire_templates = ResponseTemplateCache(
            warn=self.log.warning)
        self.grpc_wire_templates = ResponseTemplateCache(
            warn=self.log.warning)
        costs.warm_up()

    def _slo_from_config(self, name: str) -> Optional[SloObjective]:
        """A model's SLO from its config parameters (``slo.p99_ms``, and
        ``slo.availability``, default 0.999); None on absence or junk."""
        try:
            model = self.registry.get(name)
        except InferError:
            return None
        params = model.config.parameters
        try:
            p99_ms = float(params["slo.p99_ms"])
        except (KeyError, ValueError):
            return None
        if p99_ms <= 0:
            return None
        availability = 0.999
        try:
            a = float(params.get("slo.availability", ""))
            if 0.0 < a < 1.0:
                availability = a
        except ValueError:
            pass
        return SloObjective(p99_ms=p99_ms, availability=availability)

    # -- health / metadata -------------------------------------------------
    def ready(self) -> bool:
        """Up, accepting, and no model LOADING (the reference's)."""
        return (self.live and self.accepting
                and not self.registry.any_loading())

    def model_ready(self, name: str, version: str = "") -> bool:
        """Registry-ready and not quarantined, on both protocols (the
        server's own readiness stays up)."""
        return (self.registry.is_ready(name, version)
                and not self.device_faults.is_quarantined(name))

    def server_metadata(self) -> dict:
        return {"name": self.SERVER_NAME, "version": self.SERVER_VERSION,
                "extensions": list(self.EXTENSIONS)}

    # -- admission ---------------------------------------------------------
    def count_deadline_exceeded(self, model_name: str) -> None:
        with self._counts_lock:
            self.deadline_exceeded_by_model[model_name] = \
                self.deadline_exceeded_by_model.get(model_name, 0) + 1

    def max_queue_size(self, model: Model) -> int:
        """The model's admission bound (0 = unbounded)."""
        limit = self.queue_limits.get(model.name)
        if limit is not None:
            return int(limit)
        if "max_queue_size" in model.config.parameters:
            try:
                return int(model.config.parameters["max_queue_size"])
            except ValueError:
                pass
        return self.default_max_queue_size

    def _count_shed(self, model: Model, tenant: str, tier: int) -> None:
        with self._counts_lock:
            self.rejected_by_model[model.name] = \
                self.rejected_by_model.get(model.name, 0) + 1
        self.qos.count_rejected(model.name, tenant, tier)

    def _tier_depth(self, model: Model, tier: int) -> int:
        """The shed tier's backlog, for the pushback: its batcher lane's
        depth where the model batches, else the model's pending count."""
        b = self._batchers.get(_batcher_key(model))
        if b is not None and b._queue.qsize():
            return b._queue.depth(tier)
        return model.stats.pending_count

    def _admit(self, model: Model, request: InferRequest) -> None:
        """Admission at request entry, in the reference's order: drain,
        the tenant's bucket, the byte budget, the tier's queue bound (with
        preemption of queued lower-tier work).  Resolves the request's tier
        and default tenant.  Admitted, the request is counted pending (the
        caller decrements); the bytes the governor reserved are released by
        every refusal after the reservation."""
        if not self.accepting:
            err = InferError("server is shutting down", http_status=503,
                             retry_after_s=self.shed_retry_after_s)
            err.refusal_reason = "drain"
            raise err
        if self.device_faults.is_quarantined(model.name):
            # the 'quarantined' marker is what the clients' retry layer
            # reads to go to another replica
            err = InferError(
                f"model '{model.name}' is quarantined after repeated "
                "device faults; retry on another replica",
                http_status=503,
                retry_after_s=self.device_faults.retry_in(model.name))
            err.refusal_reason = "quarantine"
            raise err
        qos = self.qos
        request.tier = qos.tier_of(request.priority)
        if not request.tenant:
            request.tenant = DEFAULT_TENANT
        qos.count_request(request.tenant, request.tier)
        retry_in = qos.admit_tenant(request.tenant)
        if retry_in is not None:
            self._count_shed(model, request.tenant, request.tier)
            # the bucket's own horizon is the pushback: when a token frees
            err = InferError(
                f"tenant '{request.tenant}' is over its rate limit for "
                f"model '{model.name}'; retry later",
                http_status=429, retry_after_s=retry_in)
            err.refusal_reason = "rate_limit"
            raise err
        verdict = self.memory.try_admit(
            model.name, request.tenant, request.tier, request.wire_bytes,
            qos=qos, base_pushback_s=self.shed_retry_after_s)
        if verdict is not None:
            retry_in, permanent = verdict
            self._count_shed(model, request.tenant, request.tier)
            if permanent:
                # no wait admits it: the client's non-retryable class
                err = InferError(
                    f"request of {request.wire_bytes} bytes to model "
                    f"'{model.name}' exceeds the tier-{request.tier} "
                    "share of the server's memory budget "
                    "(--mem-budget-bytes) and can never be admitted; "
                    "reduce the payload or use shared memory",
                    http_status=413)
            else:
                err = InferError(
                    f"request of {request.wire_bytes} bytes to model "
                    f"'{model.name}' exceeds the server's memory budget "
                    f"for tier {request.tier}; retry later",
                    http_status=429, retry_after_s=retry_in)
            err.shed_reason = "memory"
            raise err
        limit = self.max_queue_size(model)
        with self._admit_lock:
            pending = model.stats.pending_count
            if limit <= 0 or pending < qos.tier_limit(request.tier, limit):
                model.stats.inc_pending()
                return
            # over the tier's bound.  A non-best-effort arrival at a full
            # queue takes the slot of the newest queued item of the lowest
            # lane below it; the victim gets the 429 a shed gets.
            if request.tier < qos.best_effort_tier and pending >= limit:
                b = self._batchers.get(_batcher_key(model))
                victim = (b._queue.preempt_lower(request.tier)
                          if b is not None else None)
                if victim is not None:
                    v_tenant, v_tier = victim[7]
                    self._count_shed(model, v_tenant or DEFAULT_TENANT,
                                     v_tier)
                    _fail(victim[2], InferError(
                        f"request to model '{model.name}' preempted by "
                        f"higher-priority traffic (tier {v_tier}); retry "
                        "later", http_status=429,
                        retry_after_s=qos.pushback_s(
                            self.shed_retry_after_s,
                            self._tier_depth(model, v_tier), limit)))
                    model.stats.inc_pending()
                    return
        # refused on the queue bound after the byte reservation above
        self.memory.release(model.name, request.tenant, request.wire_bytes)
        self._count_shed(model, request.tenant, request.tier)
        err = InferError(
            f"request queue for model '{model.name}' is full for tier "
            f"{request.tier} ({pending} pending, tier "
            f"limit {qos.tier_limit(request.tier, limit)}); retry later",
            http_status=429,
            retry_after_s=qos.pushback_s(
                self.shed_retry_after_s,
                self._tier_depth(model, request.tier), limit))
        err.refusal_reason = "queue_full"
        raise err

    def _admit_traced(self, model: Model, request: InferRequest) -> None:
        """Admission whose refusal leaves a trace record (with the refusal
        reason and the propagated trace context) where tracing is on."""
        try:
            self._admit(model, request)
        except InferError as e:
            self.tracer.record_refusal(
                model.name,
                shed_reason=(getattr(e, "refusal_reason", "")
                             or e.shed_reason or ""),
                status=e.http_status, tenant=request.tenant,
                protocol=request.protocol,
                client_request_id=request.client_request_id,
                traceparent=request.traceparent)
            raise

    def _check_deadline(self, model: Model, request: InferRequest) -> None:
        """Refuse an expired request before any compute (504; its span
        tree has no COMPUTE child)."""
        if request.expired():
            self.count_deadline_exceeded(model.name)
            raise InferError(
                f"request to model '{model.name}' exceeded its deadline "
                "before execution", http_status=504)

    def _apply_chaos(self, model: Model, trace) -> None:
        """The fault injector's verdict for this request, stamped on its
        flight record."""
        fault = self.chaos.decide(model.name)
        if fault is None:
            return
        if trace is not None and trace.flight is not None:
            trace.flight.chaos = fault.kind
        if fault.kind == "latency":
            time.sleep(fault.latency_s)
            return
        if fault.kind == "mem_pressure":
            # the drawing request goes on; the live budget shrinks, and
            # the governor's state is bundled while it does
            self.memory.inject_pressure(fault.pressure_factor,
                                        fault.latency_s)
            self.incidents.trigger(
                "chaos", reason=f"mem_pressure on {model.name} "
                f"(factor={fault.pressure_factor}, "
                f"window={fault.latency_s}s)")
            return
        if fault.kind == "abort":
            raise ChaosAbort()
        if fault.kind == "worker_kill":
            # the registered callback takes the worker down (a CLI worker
            # exits at once; a drill kills its replica through the replica
            # supervisor).  Where it returns, or none is set, the request
            # fails as a severed connection, what a crashing worker shows
            # on the wire.  The bundle starts first (a CLI worker's
            # callback waits for it, then ends the process)
            self.log.error(f"chaos: worker_kill on {model.name}")
            self.incidents.trigger(
                "chaos", reason=f"worker_kill on {model.name}")
            cb = self.chaos.worker_kill_cb
            if cb is not None:
                cb()
            raise ChaosAbort("chaos: injected worker kill")
        raise InferError(f"chaos: injected {fault.status} error",
                         http_status=fault.status)

    def drain(self, timeout_s: float) -> bool:
        """Stop admitting (new requests get 503 with pushback) and wait up
        to ``timeout_s`` for the pending requests to finish; True when none
        is left."""
        self.accepting = False
        end = time.monotonic() + max(0.0, timeout_s)
        while True:
            if not any(m.stats.pending_count
                       for m in self.registry.all_version_models()):
                return True
            if time.monotonic() >= end:
                return False
            time.sleep(0.02)

    def qos_queue_depths(self) -> Dict[tuple, int]:
        """The batchers' lane depths by ``(model, tier)``
        (``nv_qos_queue_depth``)."""
        out: Dict[tuple, int] = {}
        with self._lock:
            batchers = list(self._batchers.items())
        for key, b in batchers:
            name = key.rsplit("@", 1)[0]
            for tier, depth in enumerate(b._queue.depths()):
                out[(name, tier)] = out.get((name, tier), 0) + depth
        return out

    # -- inference ---------------------------------------------------------
    def infer(self, request: InferRequest) -> InferResponse:
        """Single request/response inference (HTTP infer, gRPC
        ModelInfer)."""
        model = self.registry.get(request.model_name, request.model_version)
        if model.decoupled:
            raise InferError(
                "doesn't support models with decoupled transaction policy")
        self._admit_traced(model, request)
        return self._infer_on(model, request)

    def _infer_on(self, model: Model, request: InferRequest
                  ) -> InferResponse:
        """An admitted request (counted pending by ``_admit``): its
        envelope, then its pending count and its bytes in the memory
        ledger (wire bytes, and the response's once built) released."""
        held = request.wire_bytes
        try:
            resp = self._infer_traced_entry(model, request)
            out_bytes = sum(int(getattr(o.data, "nbytes", 0))
                            for o in resp.outputs if o.data is not None)
            if out_bytes:
                self.memory.add(model.name, request.tenant, out_bytes)
                held += out_bytes
        finally:
            model.stats.dec_pending()
            self.memory.release(model.name, request.tenant, held)
        return resp

    def _infer_traced_entry(self, model: Model, request: InferRequest
                            ) -> InferResponse:
        """The request's trace envelope: the REQUEST root from the
        frontend's first byte, its DECODE child, and the context as this
        thread's current trace; emitted here, or by a frontend that takes
        it over (``trace_handoff``) after its SERIALIZE and NETWORK_WRITE
        spans."""
        trace = self._arm_trace(model, request, request.client_request_id,
                                self.tracer.maybe_start,
                                self.tracer.start_shadow,
                                batched=model.max_batch_size > 0)
        if trace is None:
            return self._infer_traced(model, request, None)
        trace.ts("REQUEST_START", request.arrival_ns)
        trace.ts("QUEUE_START", request.arrival_ns)
        root_start = request.arrival_ns
        if request.decode_start_ns:
            root_start = min(root_start, request.decode_start_ns)
        trace.begin_root(root_start)
        # a stream's requests are stamped for their split, but get no
        # DECODE span, as the reference's stream records have none
        if request.decode_end_ns and request.trace_handoff:
            trace.add_span("DECODE", request.decode_start_ns,
                           request.decode_end_ns)
        token = set_current_trace(trace)
        try:
            resp = self._infer_traced(model, request, trace)
        except BaseException as e:
            reason = getattr(e, "shed_reason", None)
            if reason and trace.flight is not None:
                # a memory shed inside the envelope, tellable from a queue
                # shed
                trace.flight.shed_reason = reason
            trace.mark_failed(e)
            trace.emit()
            raise
        finally:
            reset_current_trace(token)
        if trace.flight is not None:
            trace.flight.bytes_out = sum(
                int(getattr(o.data, "nbytes", 0)) for o in resp.outputs
                if o.data is not None)
        if request.trace_handoff:
            resp.trace = trace
        else:
            trace.emit()
        return resp

    def _arm_trace(self, model: Model, request: InferRequest, rid: str,
                   start, shadow, batched: bool):
        """A sampled context from ``start``; else a shadow one from
        ``shadow`` where the flight recorder or an SLO objective wants the
        span tree; else None."""
        trace = start(model.name, request.model_version or "1",
                      client_request_id=rid, traceparent=request.traceparent)
        recorder = self.flight_recorder
        slo_watch = (recorder.slo_engine is not None
                     and recorder.slo_engine.objective_for(model.name)
                     is not None)
        if trace is None:
            if not (recorder.enabled or slo_watch):
                return None
            trace = shadow(model.name, request.model_version or "1",
                           client_request_id=rid,
                           traceparent=request.traceparent)
        if recorder.enabled or slo_watch:
            trace.flight = recorder.start(
                model.name, model.served_version, request, batched=batched)
        return trace

    def _infer_traced(self, model: Model, request: InferRequest, trace
                      ) -> InferResponse:
        # the deadline gate before any compute; chaos inside the traced
        # envelope, so an injected fault lands in the flight record, then
        # the gate again (a latency fault may outlive the deadline)
        self._check_deadline(model, request)
        if self.chaos is not None:
            self._apply_chaos(model, trace)
            self._check_deadline(model, request)
        split = RequestSplit() if self.splits is not None else None
        t0 = time.monotonic_ns()
        inputs = self._resolve_inputs(model, request)
        if split is not None:
            split.resolve = (time.monotonic_ns() - t0) / 1e6
        params = dict(request.parameters)
        cache_key = self._cache_key(model, request, inputs)
        if cache_key is not None:
            cached = self.response_cache.get(cache_key)
            if cached is not None:
                # a hit counts in the statistics: its queue time, no
                # compute, no execution
                now = time.monotonic_ns()
                model.stats.record(_batch_count(cached) or 1,
                                   now - request.arrival_ns, 0, ok=True)
                if trace is not None:
                    trace.ts("CACHE_HIT", now)
                    trace.add_span("QUEUE", request.arrival_ns, now)
                return self._build_response(model, request, cached)
        self._attach_device_loop(model, request, params)
        try:
            if self._use_batcher(model, request):
                # the batcher records the batch's statistics, and this
                # request's QUEUE, BATCH_ASSEMBLY and COMPUTE spans
                outputs = self._submit(
                    model, inputs, params, split, trace=trace,
                    deadline_ns=request.deadline_ns, tenant=request.tenant,
                    tier=request.tier)
            else:
                outputs = self._run_unbatched(model, request, inputs, params,
                                              split, trace)
        except InferError:
            raise
        except Exception as e:
            raise InferError(f"inference failed: {e}", http_status=500)
        if cache_key is not None:
            self.response_cache.put(cache_key, outputs,
                                    ttl_s=_model_cache_ttl(model))
        resp = self._build_response(model, request, outputs)
        if split is not None:
            now = time.monotonic_ns()
            start = request.decode_start_ns or t0
            split.decode = (request.decode_end_ns - request.decode_start_ns
                            ) / 1e6
            if split.forward_done_ns:
                split.output = (time.perf_counter_ns()
                                - split.forward_done_ns) / 1e6
            split.total = (now - start) / 1e6
            self.splits.append(split)
        return resp

    def _cache_key(self, model: Model, request: InferRequest,
                   inputs: Dict[str, Any]) -> Optional[tuple]:
        """The request's response-cache key, or None where it bypasses the
        cache (not enabled for the model; an ensemble, decoupled, sequence
        or shared-memory request; inputs not keyed)."""
        if not model.config.response_cache \
                or isinstance(model, EnsembleModel) or model.decoupled \
                or request.sequence_id \
                or any(i.shm is not None for i in request.inputs) \
                or any(o.shm is not None for o in request.outputs):
            return None
        return _ResponseCache.key(model, self.registry.generation(model.name),
                                  request, inputs)

    def _run_unbatched(self, model: Model, request: InferRequest,
                       inputs: Dict[str, Any], params: Dict[str, Any],
                       split: Optional[RequestSplit], trace=None
                       ) -> Dict[str, Any]:
        """An ensemble, or one execution on the request thread, recorded in
        the model's statistics.  Outputs bound to CUDA regions stay where
        the model left them."""
        rows = _batch_count(inputs) or 1
        t0 = time.monotonic_ns()
        queue_ns = t0 - request.arrival_ns
        if trace is not None:
            trace.ts("COMPUTE_START", t0)
            trace.add_span("QUEUE", request.arrival_ns, t0)
        exec_stats: Dict[str, Any] = {}
        try:
            if isinstance(model, EnsembleModel):
                outputs = self._run_ensemble(model, inputs, params,
                                             request.tenant, request.tier)
            else:
                keep = {o.name for o in request.outputs if o.shm is not None
                        and self.cuda_shm.has(o.shm.region_name)}
                outputs = self.run_model(
                    model, inputs, params, split, keep,
                    traces=(trace,) if trace is not None else (),
                    exec_stats=exec_stats, cost_tenant=request.tenant)
        except Exception:
            model.stats.record(rows, queue_ns, 0, ok=False)
            raise
        compute_ns = time.monotonic_ns() - t0
        if trace is not None:
            trace.ts("COMPUTE_END", t0 + compute_ns)
            if isinstance(model, EnsembleModel):
                trace.add_span("COMPUTE", t0, t0 + compute_ns)
            elif self.cost_ledger.enabled and self.device_stats.enabled:
                # the ledger's charge in run_model, as a stamp on the
                # request's records (its slot share is the whole window)
                cost = {"tenant": request.tenant, "device_us": round(
                    exec_stats.get("compute_ns", compute_ns) / 1e3, 1)}
                if exec_stats.get("flops"):
                    cost["flops"] = exec_stats["flops"]
                trace.cost = cost
                if trace.flight is not None:
                    trace.flight.cost = cost
        model.stats.record(rows, queue_ns, compute_ns, ok=True)
        return outputs

    def infer_stream(self, request: InferRequest) -> Iterator[InferResponse]:
        """The stream entry: a request's responses, one by one.  A model
        that is not decoupled yields exactly one (traced as a unary
        request); a decoupled one yields each of its responses flagged
        ``triton_final_response`` false, then an empty one flagged true,
        under one stream trace emitted when the stream closes.  The model's
        generator runs on the calling thread and is closed when the caller
        stops early."""
        model = self.registry.get(request.model_name, request.model_version)
        # admission gates every stream entry, decoupled or not
        self._admit_traced(model, request)
        if not model.decoupled:
            yield self._infer_on(model, request)
            return
        try:
            trace = self._arm_trace(
                model, request, request.client_request_id or request.id,
                self.tracer.maybe_start_stream,
                self.tracer.start_stream_shadow, batched=False)
        except BaseException:
            model.stats.dec_pending()
            self.memory.release(model.name, request.tenant,
                                request.wire_bytes)
            raise
        if trace is not None:
            trace.ts("REQUEST_START", request.arrival_ns)
            trace.ts("QUEUE_START", request.arrival_ns)
            trace.begin_root(request.arrival_ns)
        token = set_current_trace(trace) if trace is not None else None
        try:
            self._check_deadline(model, request)
            if self.chaos is not None:
                self._apply_chaos(model, trace)
                self._check_deadline(model, request)
            yield from self._stream_decoupled(model, request, trace)
        except BaseException as e:
            if trace is not None:
                if isinstance(e, GeneratorExit):
                    trace.mark_cancelled()
                else:
                    reason = getattr(e, "shed_reason", None)
                    if reason and trace.flight is not None:
                        trace.flight.shed_reason = reason
                    trace.mark_failed(e)
            raise
        finally:
            if token is not None:
                reset_current_trace(token)
            model.stats.dec_pending()
            # a stream holds its wire bytes for its whole life
            self.memory.release(model.name, request.tenant,
                                request.wire_bytes)
            if trace is not None:
                trace.emit()

    def _attach_device_loop(self, model: Model, request: InferRequest,
                            params: Dict[str, Any]) -> None:
        """A device-loop model (its own worker ticks the card) gets the
        collector, the ledger, the memory governor, the fault manager and
        the chaos injector, and the tenant in ``params``."""
        attach = getattr(model, "attach_device_stats", None)
        if attach is None:
            return
        attach(self.device_stats)
        for hook, value in (("attach_cost_ledger", self.cost_ledger),
                            ("attach_memory_governor", self.memory),
                            ("attach_device_faults", self.device_faults),
                            ("attach_chaos", self.chaos)):
            fn = getattr(model, hook, None)
            if fn is not None and value is not None:
                fn(value)
        if request.tenant:
            params["_cost_tenant"] = request.tenant

    def _stream_decoupled(self, model: Model, request: InferRequest,
                          trace) -> Iterator[InferResponse]:
        inputs = self._resolve_inputs(model, request)
        params = dict(request.parameters)
        self._attach_device_loop(model, request, params)
        t0 = time.monotonic_ns()
        if trace is not None:
            trace.add_span("QUEUE", request.arrival_ns, t0)
        gen = model.execute_decoupled(inputs, params)
        try:
            for out in gen:
                resp = self._build_response(model, request, readback(out))
                resp.parameters["triton_final_response"] = False
                if trace is not None:
                    trace.record_chunk()
                    resp.trace = trace
                yield resp
        except GeneratorExit:
            # the consumer went away: the request was served
            model.stats.record(1, 0, time.monotonic_ns() - t0, ok=True)
            raise
        except InferError:
            model.stats.record(1, 0, time.monotonic_ns() - t0, ok=False)
            raise
        except Exception as e:
            model.stats.record(1, 0, time.monotonic_ns() - t0, ok=False)
            raise InferError(str(e), 500)
        finally:
            gen.close()
        model.stats.record(1, 0, time.monotonic_ns() - t0, ok=True)
        final = InferResponse(model_name=model.name,
                              model_version=model.served_version,
                              id=request.id)
        final.parameters["triton_final_response"] = True
        # the stream's device time, written back by the model
        device_us = params.get("_cost_device_us")
        if device_us is not None:
            final.parameters["device_time_us"] = device_us
        # and the prompt tokens restored from the prefix cache
        cache_hit = params.get("_cache_hit_tokens")
        if cache_hit is not None:
            final.parameters["cache_hit_tokens"] = cache_hit
        yield final

    def device_stats_snapshot(self, model: Optional[str] = None) -> dict:
        """The ``/v2/debug/device_stats`` JSON: the collector's snapshot
        with the SLO engine's under ``"slo"``, the memory governor's under
        ``"memory"`` and the prefix/KV block stores' under ``"kv_cache"``
        (both frontends)."""
        from . import kvcache

        out = self.device_stats.snapshot(model=model)
        out["slo"] = self.slo.snapshot(model=model)
        out["memory"] = self.memory.snapshot()
        out["kv_cache"] = kvcache.snapshot()
        return out

    def statistics(self, name: Optional[str],
                   version: str = "") -> List[dict]:
        """The v2 statistics of one model, or of every model (the
        reference's ``InferenceCore.statistics``); an unknown model is a
        400."""
        if name and version:
            models = [self.registry.get(name, version)]
        elif name:
            # unversioned: every served version of the name
            self.registry.get(name)  # an unknown name is a 400
            models = self.registry.version_models(name)
        else:
            models = self.registry.all_version_models()
        return [m.stats.snapshot(m.name, m.served_version) for m in models]

    def run_model(self, model: Model, inputs: Dict[str, Any],
                  params: Dict[str, Any],
                  split: Optional[RequestSplit] = None,
                  keep: Collection[str] = (), traces=(),
                  exec_stats: Optional[Dict[str, Any]] = None,
                  real_batch: Optional[int] = None,
                  cost_tenant: Optional[str] = None) -> Dict[str, Any]:
        """Execute and read every output back to the host, except those
        named in ``keep``, which stay as the model returned them (on the
        calling thread: a batch worker, or the request thread when
        unbatched).

        ``traces`` (every traced member of a batch, or the one request)
        each get the COMPUTE and D2H_TRANSFER spans.  With device
        statistics on: the window goes to ``record_execute`` (a
        :class:`TorchModel`'s input signature with it; the first execution
        of a signature runs counted, ``costs.py``), the readback to
        ``record_transfer``, and ``exec_stats`` gets ``compute_ns``,
        ``d2h_syncs``, ``flops`` and ``bytes_accessed``.  ``real_batch``:
        the rows before padding to a bucket.  ``cost_tenant``: the ledger
        charges it the whole window (the batcher splits a batch's window
        itself)."""
        ds = self.device_stats
        want_ds = ds.enabled
        device = getattr(model, "device", None)
        sig = None
        if want_ds:
            ds.declare_model(model.name, model.flops_per_element())
            if isinstance(model, TorchModel):
                sig = _signature(inputs)
        counted = sig is not None and not ds.signature_known(model.name, sig)
        token = set_current_trace(traces[0]) if traces else None
        try:
            window = _ComputeWindow(device)
            cost = None
            if counted:
                outputs, cost = model.analyze_cost(inputs, params,
                                                   peak_sink=ds.note_peak)
            else:
                outputs = model.execute(inputs, params)
            window.close()
        finally:
            if token is not None:
                reset_current_trace(token)
        if split is not None:
            # the request's split: the forward waited on, so that its
            # output phase starts at the forward's end
            split.forward = window.elapsed_ns() / 1e6
            split.forward_done_ns = time.perf_counter_ns()
        model.stats.record_execution(_batch_count(inputs))
        drained = [v for n, v in outputs.items() if n not in keep
                   and isinstance(v, torch.Tensor) and v.is_cuda]
        host = readback({n: v for n, v in outputs.items() if n not in keep})
        host.update({n: v for n, v in outputs.items() if n in keep})
        t_d1 = time.monotonic_ns()
        compute_ns = window.elapsed_ns()
        t_c1 = window.t0 + compute_ns
        for t in traces:
            t.add_span("COMPUTE", window.t0, t_c1)
            t.add_span("D2H_TRANSFER", t_c1, max(t_c1, t_d1))
        if want_ds:
            padded_n = _batch_count(inputs) or 1
            ds.record_execute(model.name, real_batch or padded_n, compute_ns,
                              signature=sig, cost=cost,
                              padded_batch=padded_n)
            if cost is None and sig is not None:
                cost = ds.signature_cost(model.name, sig)
            if drained:
                ds.record_transfer(
                    "d2h", sum(v.numel() * v.element_size() for v in drained),
                    count=len(drained))
            if exec_stats is not None:
                exec_stats["compute_ns"] = compute_ns
                exec_stats["d2h_syncs"] = len(drained)
                if cost is not None:
                    exec_stats["flops"] = cost.flops
                    exec_stats["bytes_accessed"] = cost.bytes_accessed
            if cost_tenant is not None and self.cost_ledger.enabled:
                self.cost_ledger.charge(
                    model.name, cost_tenant, device_us=compute_ns / 1e3,
                    flops=cost.flops if cost is not None else 0.0)
        return host

    def _run_ensemble(self, model: EnsembleModel, inputs: Dict[str, Any],
                      params: Dict[str, Any], tenant: str = "",
                      tier: int = 0) -> Dict[str, np.ndarray]:
        """Run the ensemble's steps in data-dependency order; tensors flow
        between them through ``input_map``/``output_map``."""
        pool: Dict[str, Any] = dict(inputs)
        remaining = list(model.config.ensemble_scheduling)
        while remaining:
            ready = [s for s in remaining
                     if all(p in pool for p in s.input_map.values())]
            if not ready:
                missing = sorted(
                    {p for s in remaining for p in s.input_map.values()}
                    - set(pool))
                raise InferError(
                    f"ensemble '{model.name}': tensor(s) "
                    f"{', '.join(missing)} are never produced")
            for step in ready:
                outs = self._run_ensemble_step(step, pool, params, tenant,
                                               tier)
                for member_output, pool_name in step.output_map.items():
                    if member_output not in outs:
                        raise InferError(
                            f"ensemble '{model.name}': step "
                            f"'{step.model_name}' did not produce "
                            f"'{member_output}'")
                    pool[pool_name] = outs[member_output]
            done = {id(s) for s in ready}
            remaining = [s for s in remaining if id(s) not in done]
        return readback({o.name: pool[o.name] for o in model.config.output
                         if o.name in pool})

    def _run_ensemble_step(self, step, pool: Dict[str, Any],
                           params: Dict[str, Any], tenant: str = "",
                           tier: int = 0) -> Dict[str, Any]:
        member = self.registry.get(step.model_name)
        step_inputs = {member_input: pool[pool_name]
                       for member_input, pool_name in step.input_map.items()}
        # every pool tensor is a host array (the request's, or a step's
        # output read back), so a batched member always coalesces
        if self._model_batchable(member):
            # the sequence keys correlate the ensemble request on its
            # stream; left in, each sequence would be a parameter group of
            # its own and concurrent streams would not coalesce
            member_params = {k: v for k, v in params.items()
                             if k not in SEQUENCE_KEYS}
            return self._submit(member, step_inputs, member_params,
                                tenant=tenant, tier=tier)
        rows = _batch_count(step_inputs) or 1
        t0 = time.monotonic_ns()
        try:
            outs = self.run_model(member, step_inputs, params,
                                  cost_tenant=tenant)
        except Exception:
            member.stats.record(rows, 0, time.monotonic_ns() - t0, ok=False)
            raise
        member.stats.record(rows, 0, time.monotonic_ns() - t0, ok=True)
        return outs

    @staticmethod
    def _model_batchable(model: Model) -> bool:
        return (model.max_batch_size > 0 and model.config.dynamic_batching
                and not model.is_sequence)

    def _use_batcher(self, model: Model, request: InferRequest) -> bool:
        """Through the dynamic batcher: a batchable model that is not an
        ensemble (the core runs those), and a request with no sequence id
        and no tensor in a shared-memory region."""
        return (not isinstance(model, EnsembleModel)
                and self._model_batchable(model)
                and not request.sequence_id
                and not any(t.shm is not None for t in request.inputs)
                and not any(o.shm is not None for o in request.outputs))

    def _submit(self, model: Model, inputs: Dict[str, Any],
                params: Dict[str, Any], split: Optional[RequestSplit] = None,
                **kw) -> Dict[str, Any]:
        """One request through its instance's batcher.  A batcher that
        began to stop (drained or retired) between its lookup and the
        queueing took nothing: the request resolves its batcher again, and
        runs on the instance it resolved while the registry serves it."""
        while True:
            try:
                return self._batcher(model).submit(inputs, params, split,
                                                   **kw)
            except _BatcherStopped:
                continue

    def _batcher(self, model: Model) -> _DynamicBatcher:
        """The batcher of this instance, keyed ``name@version``.  A request
        that resolved its instance before a load or an unload swapped it
        out is refused with 503 rather than given a batcher of the retired
        instance; a batcher left from a swapped instance whose retirement
        has not run yet is retired first, as a load retires it.  A new
        batcher starts at the fleet controller's target for the model."""
        key = _batcher_key(model)
        fleet = self.fleet
        while True:
            with self._lock:
                b = self._batchers.get(key)
            if b is not None and b.serves(model):
                return b
            # read outside the core's lock: the controller's counter lock
            # nests with no other
            instances = (fleet.desired_instances(model.name)
                         if fleet is not None else None)
            with self._lock:
                if self._closed:
                    raise InferError("server is shutting down", 503)
                b = self._batchers.get(key)
                if b is None or not b.serves(model):
                    if not self._is_served(model):
                        raise InferError(
                            f"model '{model.name}' was reloaded or unloaded "
                            "while the request waited", http_status=503)
                    if b is None:
                        b = self._batchers[key] = _DynamicBatcher(
                            self, model, instances)
                if b.serves(model):
                    return b
            self._retire_batchers(model.name)

    def _is_served(self, model: Model) -> bool:
        """Whether the registry serves this very instance."""
        return any(m is model for m in self.registry.version_models(
            model.name))

    def _retire_batchers(self, name: str) -> None:
        """Stop ``name``'s batchers whose instance the registry no longer
        serves, or serves in another config, on the calling thread: their
        batches in flight finish, what is queued fails with 503."""
        prefix = f"{name}@"
        with self._lock:
            stale = [self._batchers.pop(k) for k, b in
                     list(self._batchers.items()) if k.startswith(prefix)
                     and not (b.serves(b._model)
                              and self._is_served(b._model))]
        for b in stale:
            b.stop("model was reloaded while queued")

    def drain_batcher(self, name: str, version: str,
                      timeout_s: float = 30.0) -> bool:
        """Drain one version's batcher gracefully (the reference's): it
        leaves the core's map at once (a request that resolves the version
        later gets a batcher of its own), its queued work runs on its
        instance, and once nothing is queued or executing it stops.  Only
        past ``timeout_s`` does what is still queued fail with 503.  True
        when the drain was clean."""
        key = f"{name}@{version}"
        with self._lock:
            b = self._batchers.pop(key, None)
        if b is None:
            return True
        end = time.monotonic() + max(0.0, timeout_s)
        clean = True
        while not b.idle():
            if time.monotonic() >= end:
                clean = False
                break
            time.sleep(0.02)
        b.stop(f"model '{name}' version {version} was drained")
        return clean

    # -- warmup ------------------------------------------------------------
    def _warmup_one(self, model: Model) -> int:
        """Run one model's configured warmup samples through the real
        execute path (``run_model``; the reference's ``_warmup_one``).
        They stay out of the inference statistics; they build the weights
        and earn the input signatures their counted first execution.
        Returns the executions run."""
        from .warmup import warmup_samples

        if isinstance(model, EnsembleModel):
            return 0  # the core runs ensembles; their members warm alone
        n = 0
        for _name, count, inputs in warmup_samples(model):
            for _ in range(count):
                self.run_model(model, dict(inputs), {})
                n += 1
        return n

    def warmup_models(self) -> Dict[str, Any]:
        """Warm every served model that declares ``model_warmup`` samples
        (the reference's, at server start).  A model whose warmup fails is
        unloaded and reported under ``"<name>:error"``; the others serve."""
        ran: Dict[str, Any] = {}
        for model in self.registry.all_version_models():
            if not model.config.model_warmup:
                continue
            if not self.registry.is_ready(model.name, model.served_version):
                continue  # a sibling version's failure unloaded the name
            key = (model.name if model.versions == ["1"]
                   else f"{model.name}/{model.served_version}")
            try:
                ran[key] = self._warmup_one(model)
            except Exception as e:  # noqa: BLE001 - one model at a time
                ran[f"{key}:error"] = str(e)
                self.log.error(
                    f"model '{model.name}' unloaded: warmup failed: {e}")
                try:
                    self.registry.unload(model.name)
                except InferError:
                    pass
                self.retire_name_caches(model.name)
        # the host's view starts with serving, not with the core
        self.profiler.start()
        self.incidents.start()
        return ran

    # -- the repository API ------------------------------------------------
    def load_model(self, name: str, config_override: Optional[str] = None,
                   files: Optional[Dict[str, str]] = None) -> None:
        """The repository's load (the reference's ``load_model``): the
        chaos ``load_fail`` draw first, then the registry's load, the
        name's stale caches retired, then every loaded version's warmup
        samples.  The name (and the server's readiness) reads LOADING for
        the whole warmup, and no exit path leaves it LOADING; a failed
        warmup unloads the name and fails the load with 400."""
        if self.chaos is not None:
            self.chaos.maybe_fail_load(name)
        self.registry.load(name, config_override=config_override,
                           files=files)
        self.retire_name_caches(name)
        warm = [m for m in self.registry.version_models(name)
                if m.config.model_warmup]
        if warm:
            self.registry.set_state(name, "LOADING", "warming up")
            try:
                for model in warm:
                    self._warmup_one(model)
            except Exception as e:  # noqa: BLE001 - a failed load
                try:
                    self.registry.unload(name)
                except InferError:
                    pass
                self.retire_name_caches(name)
                self.log.error(
                    f"failed to load model '{name}': warmup failed: {e}")
                raise InferError(
                    f"failed to load '{name}': warmup failed: {e}",
                    http_status=400)
            finally:
                # the failure's unload moved the state off LOADING; what
                # is still LOADING here is a loaded instance that serves
                if self.registry.get_state(name)[0] == "LOADING":
                    self.registry.set_state(name, "READY", "")
        self.log.info(f"successfully loaded model '{name}'")

    def unload_model(self, name: str,
                     unload_dependents: bool = False) -> None:
        """The repository's unload; the name's caches, and its dependents'
        where they were unloaded too, are retired."""
        model = self.registry.get(name) if self.registry.is_ready(name) \
            else None
        self.registry.unload(name, unload_dependents=unload_dependents)
        names = [name]
        if unload_dependents and model is not None:
            names += [s.model_name for s in model.config.ensemble_scheduling
                      if not self.registry.is_ready(s.model_name)]
        for n in names:
            self.retire_name_caches(n)
        self.log.info(f"successfully unloaded model '{name}'")

    def retire_name_caches(self, name: str) -> None:
        """Drop what the core keeps for ``name``'s retired instances: the
        batchers of a swapped instance or config (stopped before this
        returns, so no batcher thread holds a retired instance once a load
        or an unload answers), the SLO objective resolved from the old
        config, the device statistics' signatures and FLOPs (cumulative
        counters stay) and the wire templates.  Once the name is unloaded,
        its prefix/KV store, its quarantine state (whose probe holds the
        old instance) and its governor pins go too."""
        from . import kvcache

        self._retire_batchers(name)
        self.slo.invalidate(name)
        self.device_stats.forget_model(name)
        self.retire_wire_templates(name)
        if self.registry.get_state(name)[0] != "READY":
            kvcache.drop(name)
            self.device_faults.forget(name)
            self.memory.forget_model(name)

    def retire_wire_templates(self, name: str) -> None:
        """Drop ``name``'s compiled response templates of both protocols
        (they froze the old instance's output specs; the generation in
        their key already bars a stale stamp)."""
        self.http_wire_templates.retire(name)
        self.grpc_wire_templates.retire(name)

    def shutdown(self) -> None:
        self.accepting = False
        if self.fleet is not None:
            # the control loop first: an actuation or a bake mid-teardown
            # would race the batchers' stop below
            self.fleet.stop()
        with self._lock:
            self._closed = True
            batchers = list(self._batchers.values())
            self._batchers.clear()
        for b in batchers:
            b.stop()
        for m in self.registry.all_version_models():
            m.unload()  # a model's own worker threads stop
        self.tracer.shutdown()
        self.log.shutdown()
        # the sampler, the probes, the GC callback and any bundle still
        # being written
        self.profiler.stop()
        self.incidents.stop()

    def enable_otlp(self, endpoint: str, replica: str = "") -> None:
        """Export every trace record the tracer emits (refusals too) to an
        OTLP/HTTP collector at ``endpoint``, from a thread that never
        blocks a request; ``replica`` names this process in the records.
        The exporter stops with the tracer."""
        from ..otlp import OtlpExporter, encode_server_record

        if replica:
            self.tracer.replica = replica
        old, self.tracer.otlp = self.tracer.otlp, OtlpExporter(
            endpoint, "triton-tpu-server", encode_server_record,
            resource_attributes={"replica": replica} if replica else None)
        if old is not None:
            old.shutdown()

    # -- validation / response ---------------------------------------------
    def _resolve_inputs(self, model: Model,
                        request: InferRequest) -> Dict[str, Any]:
        cfg_inputs = {i.name: i for i in model.config.input}
        batched = model.max_batch_size > 0
        resolved: Dict[str, Any] = {}
        for t in request.inputs:
            cfg = cfg_inputs.get(t.name)
            if cfg is None:
                raise InferError(
                    f"unexpected inference input '{t.name}' for model "
                    f"'{model.name}'")
            if t.datatype != cfg.data_type:
                raise InferError(
                    f"inference input '{t.name}' data-type is "
                    f"'{t.datatype}', but model '{model.name}' expects "
                    f"'{cfg.data_type}'")
            self._check_shape(model, t, cfg, batched)
            if t.shm is None:
                resolved[t.name] = t.data
            elif self.cuda_shm.has(t.shm.region_name):
                resolved[t.name] = self.cuda_shm.read(t.shm, t.datatype,
                                                      t.shape)
            else:
                resolved[t.name] = self.system_shm.read(t.shm, t.datatype,
                                                        t.shape)
        missing = [n for n, cfg in cfg_inputs.items()
                   if n not in resolved and not cfg.optional]
        if missing:
            raise InferError(
                f"expected {len(cfg_inputs)} inputs but got {len(resolved)} "
                f"inputs for model '{model.name}' (missing: "
                f"{', '.join(missing)})")
        cfg_outputs = {o.name for o in model.config.output}
        for o in request.outputs:
            if o.name not in cfg_outputs:
                raise InferError(
                    f"unexpected inference output '{o.name}' for model "
                    f"'{model.name}'")
            if o.shm is not None and not (
                    self.cuda_shm.has(o.shm.region_name)
                    or self.system_shm.has(o.shm.region_name)):
                raise InferError("Unable to find shared memory region: "
                                 f"'{o.shm.region_name}'")
        return resolved

    def _check_shape(self, model: Model, t: InputTensor, cfg,
                     batched: bool) -> None:
        dims = list(cfg.dims)
        shape = list(t.shape)
        check = shape[1:] if batched else shape
        if len(check) != len(dims):
            raise InferError(
                f"unexpected shape for input '{t.name}' for model "
                f"'{model.name}': expected rank "
                f"{len(dims) + (1 if batched else 0)}, got {len(shape)}")
        for got, want in zip(check, dims):
            if want != -1 and got != want:
                raise InferError(
                    f"unexpected shape for input '{t.name}' for model "
                    f"'{model.name}': expected {dims}, got {check}")
        if batched and shape and shape[0] > model.max_batch_size:
            raise InferError(
                f"inference request batch-size must be <= "
                f"{model.max_batch_size} for '{model.name}'")

    def _build_response(self, model: Model, request: InferRequest,
                        outputs: Dict[str, Any]) -> InferResponse:
        """The response; outputs bound to regions are written there (a
        CUDA region's copy queued on the card, then waited on)."""
        resp = InferResponse(model_name=model.name,
                             model_version=model.served_version,
                             id=request.id)
        requested = {o.name: o for o in request.outputs}
        names = list(requested) or [o.name for o in model.config.output]
        card = None
        for name in names:
            if name not in outputs:
                raise InferError(
                    f"model '{model.name}' did not produce output '{name}'")
            value = outputs[name]
            spec = requested.get(name)
            if spec is not None and spec.class_count > 0:
                value = self._classify(model, name, _host_array(value),
                                       spec.class_count)
            ref = spec.shm if spec is not None else None
            if ref is not None and self.cuda_shm.has(ref.region_name):
                card = self.cuda_shm.write(ref, value) or card
                datatype = (torch_to_triton_dtype(value.dtype)
                            if isinstance(value, torch.Tensor)
                            else np_to_triton_dtype(value.dtype))
                resp.outputs.append(OutputTensor(
                    name=name, datatype=datatype, shape=tuple(value.shape),
                    data=None, shm=ref))
                continue
            if isinstance(value, torch.Tensor) \
                    and value.dtype == torch.bfloat16:
                host, datatype = value.cpu(), "BF16"
            else:
                host = np.asarray(value)
                datatype = np_to_triton_dtype(host.dtype)
            if ref is not None:
                self.system_shm.write(ref, host)
            resp.outputs.append(OutputTensor(
                name=name, datatype=datatype,
                shape=tuple(host.shape), data=None if ref else host,
                shm=ref))
        if card is not None:
            # one event behind the last region write: the client may read
            # the region as soon as it has the response
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(card))
            done.synchronize()
        return resp

    @staticmethod
    def _classify(model: Model, name: str, arr: np.ndarray,
                  k: int) -> np.ndarray:
        """Top-k classification strings ``"score:index[:label]"`` of each
        row (the reference's ``_classify``, core.py:2391-2407: the same
        unstable ``argsort`` of the f32 row, so ties order alike, and the
        same formatting); shape ``[rows, k]``, or ``[k]`` unbatched."""
        labels = model.labels(name)
        batched = arr.ndim > 1
        rows = arr if batched else arr[None, :]
        k = min(k, rows.shape[-1])
        out = []
        for row in rows.astype(np.float32):
            idx = np.argsort(-row)[:k]
            for i in idx:
                s = f"{row[i]:f}:{i}"
                if labels and i < len(labels):
                    s += f":{labels[i]}"
                out.append(s.encode("utf-8"))
        shape = (rows.shape[0], k) if batched else (k,)
        return np.array(out, dtype=np.object_).reshape(shape)
