"""Model abstraction for the port's serving harness.

Counterpart of ``triton_client_tpu/server/model.py``.  The reference builds
its model configs as protobuf messages; the port's serving path runs on the
standard library, torch and numpy alone, so :func:`make_config` returns a
:class:`ModelConfig` dataclass with the fields the port uses; it renders
itself as the port's own proto ``ModelConfig`` message (gRPC) and that
message's proto3 JSON (the HTTP ``/config`` body), as the reference's does.

* :class:`TorchModel` is the counterpart of ``JaxModel``: a function over
  tensors, run under ``torch.inference_mode()`` on the device its config's
  ``instance_group`` names.  Outputs may stay on the device; the core reads
  them back off the request thread.  Its executions earn input signatures
  in the device statistics, and :meth:`TorchModel.analyze_cost` counts one
  (``costs.py``).
* :class:`PyModel` runs arbitrary Python over numpy arrays; a decoupled
  one yields 0..N response dicts from ``execute_decoupled``.
* :class:`EnsembleModel` names a DAG of member models (its config's
  ``ensemble_scheduling``); the core runs it.

:func:`config_from_pb` reads a ``ModelConfig`` message (a repository's
``config.pbtxt`` or a load's JSON override, ``protocol/text_format.py``)
into the dataclass; a field the port does not serve is a load error naming
the ROADMAP item that brings it, never dropped.  Five fields that the
reference's server takes and does nothing with are loaded and echoed by
``get_model_config`` alike: ``default_model_filename``,
``input.allow_ragged_batch``, ``dynamic_batching.preserve_ordering``,
``sequence_batching.control_input`` and an ensemble step's
``model_version``.  ``instance_group`` is read
as the reference reads it: any number of groups of any count, the first
group's kind placing the model.
"""

from __future__ import annotations

import abc
import threading
import time
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from ..device import resolve_device
from .types import InferError


@dataclass
class TensorConfig:
    name: str
    data_type: str            # Triton dtype string ("INT32", "FP32", ...)
    dims: List[int]
    optional: bool = False
    label_filename: str = ""  # outputs with classification labels
    # input.allow_ragged_batch: loaded and echoed, nothing done with it
    allow_ragged_batch: bool = False


@dataclass
class EnsembleStep:
    """One step of ``ensemble_scheduling``: member ``model_name`` reads
    ``input_map`` (member input -> ensemble tensor) and writes
    ``output_map`` (member output -> ensemble tensor)."""

    model_name: str
    input_map: Dict[str, str]
    output_map: Dict[str, str]
    # the step's model_version: loaded and echoed; the core runs the
    # member's default version, as the reference's does
    model_version: int = 0


@dataclass
class ModelConfig:
    """The fields of Triton's ModelConfig that the port uses."""

    name: str
    platform: str = "pytorch"
    backend: str = "pytorch"
    max_batch_size: int = 0
    input: List[TensorConfig] = field(default_factory=list)
    output: List[TensorConfig] = field(default_factory=list)
    preferred_batch_size: List[int] = field(default_factory=list)
    max_queue_delay_microseconds: int = 0
    dynamic_batching: bool = False
    instance_kind: Optional[str] = None
    parameters: Dict[str, str] = field(default_factory=dict)
    ensemble_scheduling: List[EnsembleStep] = field(default_factory=list)
    # model_transaction_policy.decoupled
    decoupled: bool = False
    # sequence_batching.max_sequence_idle_microseconds; None: no sequence
    # batching
    max_sequence_idle_microseconds: Optional[int] = None
    # the repository's ModelVersionPolicy message (protocol/inference.py),
    # or None: the latest version
    version_policy: Any = None
    # instance_group's name (None: the model's) and count
    instance_name: Optional[str] = None
    instance_count: int = 1
    # every instance_group message as read (config_from_pb), rendered as
    # is; empty: the one group of instance_kind.  Only the first group's
    # kind places the model, as in the reference
    instance_groups: List[Any] = field(default_factory=list)
    # the ModelWarmup messages (protocol/inference.py), run through the
    # execute path before the model serves (warmup.py)
    model_warmup: List[Any] = field(default_factory=list)
    # response_cache.enable; None: no response_cache message
    response_cache: Optional[bool] = None
    # loaded and echoed, and nothing done with them, as in the reference:
    # default_model_filename, dynamic_batching.preserve_ordering and
    # sequence_batching.control_input (its messages as read)
    default_model_filename: str = ""
    preserve_ordering: bool = False
    sequence_control_inputs: List[Any] = field(default_factory=list)

    def to_pb(self):
        """The config as the v2 protocol's ``ModelConfig`` message (what
        gRPC ``ModelConfig`` returns)."""
        from ..protocol import inference as pb

        def dtype(t):
            return pb.enum_value("DataType", "TYPE_" + (
                "STRING" if t.data_type == "BYTES" else t.data_type))

        out = pb.ModelConfig(
            name=self.name, platform=self.platform, backend=self.backend,
            max_batch_size=self.max_batch_size,
            input=[pb.ModelInput(name=t.name, data_type=dtype(t),
                                 dims=list(t.dims), optional=t.optional,
                                 allow_ragged_batch=t.allow_ragged_batch)
                   for t in self.input],
            output=[pb.ModelOutput(name=t.name, data_type=dtype(t),
                                   dims=list(t.dims),
                                   label_filename=t.label_filename)
                    for t in self.output],
            default_model_filename=self.default_model_filename)
        if self.decoupled:
            out.model_transaction_policy = pb.ModelTransactionPolicy(
                decoupled=True)
        if self.dynamic_batching:
            out.dynamic_batching = pb.ModelDynamicBatching(
                preferred_batch_size=list(self.preferred_batch_size),
                max_queue_delay_microseconds=self
                .max_queue_delay_microseconds,
                preserve_ordering=self.preserve_ordering)
        if self.max_sequence_idle_microseconds is not None:
            out.sequence_batching = pb.ModelSequenceBatching(
                max_sequence_idle_microseconds=self
                .max_sequence_idle_microseconds,
                control_input=list(self.sequence_control_inputs))
        if self.version_policy is not None:
            out.version_policy = self.version_policy
        if self.instance_groups:
            out.instance_group = list(self.instance_groups)
        elif self.instance_kind:
            out.instance_group.append(pb.ModelInstanceGroup(
                name=self.name if self.instance_name is None
                else self.instance_name, count=self.instance_count,
                kind=pb.enum_value("ModelInstanceGroup.Kind",
                                   self.instance_kind)))
        for k, v in self.parameters.items():
            out.parameters[k] = pb.ModelParameter(string_value=v)
        if self.ensemble_scheduling:
            out.ensemble_scheduling = pb.ModelEnsembling(step=[
                pb.ModelEnsembling.Step(model_name=s.model_name,
                                        model_version=s.model_version,
                                        input_map=dict(s.input_map),
                                        output_map=dict(s.output_map))
                for s in self.ensemble_scheduling])
        out.model_warmup = list(self.model_warmup)
        if self.response_cache is not None:
            out.response_cache = pb.ModelResponseCache(
                enable=self.response_cache)
        return out

    def to_json(self) -> dict:
        """The v2 ``/v2/models/{m}/config`` body: the proto3 JSON of
        :meth:`to_pb`, as the reference renders its config message."""
        from ..protocol._proto3 import to_dict

        return to_dict(self.to_pb())


_INSTANCE_KINDS = ("KIND_AUTO", "KIND_GPU", "KIND_CPU", "KIND_MODEL")


def _refused(name: str, field_name: str, item: str) -> InferError:
    return InferError(
        f"failed to load '{name}': config field '{field_name}' is not "
        f"served by triton_client_tpu_torch yet (ROADMAP {item})")


def config_from_pb(msg, name: str) -> "ModelConfig":
    """The dataclass of a ``ModelConfig`` message (its name defaults to
    ``name``).  A field the port does not serve is refused
    (:class:`InferError` naming its ROADMAP item)."""
    from ..protocol import inference as pb

    name = msg.name or name
    if any(g.gpus for g in msg.instance_group):
        raise _refused(name, "instance_group.gpus", "A8b")
    kinds = {v: k for k, v in pb.ENUMS["ModelInstanceGroup.Kind"].items()}
    dtypes = {v: k for k, v in pb.ENUMS["DataType"].items()}

    def dtype(number: int) -> str:
        label = dtypes.get(number, "TYPE_INVALID")
        if label == "TYPE_INVALID":
            raise InferError(f"failed to load '{name}': tensor data_type "
                             f"{label} is not a Triton datatype")
        return "BYTES" if label == "TYPE_STRING" else label[len("TYPE_"):]

    group = msg.instance_group[0] if msg.instance_group else None
    kind = kinds.get(group.kind) if group is not None else None
    if kind == "KIND_TPU":
        raise _refused(name, "instance_group.kind KIND_TPU", "A9")
    db, sb, ens = (msg.dynamic_batching, msg.sequence_batching,
                   msg.ensemble_scheduling)
    return ModelConfig(
        name=name, platform=msg.platform, backend=msg.backend,
        max_batch_size=msg.max_batch_size,
        input=[TensorConfig(t.name, dtype(t.data_type), list(t.dims),
                            optional=t.optional,
                            allow_ragged_batch=t.allow_ragged_batch)
               for t in msg.input],
        output=[TensorConfig(t.name, dtype(t.data_type), list(t.dims),
                             label_filename=t.label_filename)
                for t in msg.output],
        preferred_batch_size=list(db.preferred_batch_size) if db else [],
        max_queue_delay_microseconds=(db.max_queue_delay_microseconds
                                      if db else 0),
        dynamic_batching=db is not None,
        instance_kind=kind,
        instance_name=group.name if group is not None else None,
        instance_count=group.count if group is not None else 1,
        instance_groups=list(msg.instance_group),
        parameters={k: v.string_value for k, v in msg.parameters.items()},
        ensemble_scheduling=[
            EnsembleStep(s.model_name, dict(s.input_map), dict(s.output_map),
                         model_version=s.model_version)
            for s in (ens.step if ens is not None else [])],
        decoupled=bool(msg.model_transaction_policy is not None
                       and msg.model_transaction_policy.decoupled),
        max_sequence_idle_microseconds=(
            sb.max_sequence_idle_microseconds if sb is not None else None),
        version_policy=msg.version_policy,
        model_warmup=list(msg.model_warmup),
        response_cache=(msg.response_cache.enable
                        if msg.response_cache is not None else None),
        default_model_filename=msg.default_model_filename,
        preserve_ordering=bool(db is not None and db.preserve_ordering),
        sequence_control_inputs=list(sb.control_input) if sb is not None
        else [],
    )


def make_config(
    name: str,
    inputs: Sequence[Tuple[str, str, Sequence[int]]],
    outputs: Sequence[Tuple[str, str, Sequence[int]]],
    max_batch_size: int = 0,
    platform: str = "pytorch",
    backend: str = "pytorch",
    preferred_batch_sizes: Optional[Sequence[int]] = None,
    max_queue_delay_us: int = 0,
    instance_kind: Optional[str] = None,
    parameters: Optional[Dict[str, str]] = None,
    ensemble_scheduling: Optional[Sequence[EnsembleStep]] = None,
    decoupled: bool = False,
    sequence_batching: bool = False,
    labels: Optional[Dict[str, List[str]]] = None,
    warmup: Optional[Sequence[dict]] = None,
    response_cache: bool = False,
) -> ModelConfig:
    """Config builder with the reference's signature, for the fields the
    port uses.  ``response_cache`` enables the core's response cache for
    the model (its TTL: the ``response_cache.ttl_s`` parameter).
    ``warmup``: the reference's
    samples, ``[{"name", "batch_size", "count", "inputs": {tensor: (dtype,
    dims, "zero" | "random")}}]``.
    ``inputs``/``outputs``: (name, Triton dtype, dims), dims excluding the
    batch dimension when ``max_batch_size > 0``.  An output named in
    ``labels`` gets the reference's ``label_filename``
    (``<output>_labels.txt``); ``sequence_batching`` sets the reference's
    60 s ``max_sequence_idle_microseconds``.  The reference adds ensemble
    steps to the config message after building it; here they are
    ``ensemble_scheduling``."""
    if instance_kind is not None and instance_kind not in _INSTANCE_KINDS:
        raise ValueError(f"unknown instance kind {instance_kind!r}; "
                         f"expected one of {_INSTANCE_KINDS}")
    labels = labels or {}
    return ModelConfig(
        name=name, platform=platform, backend=backend,
        max_batch_size=max_batch_size,
        input=[TensorConfig(n, dt, list(d)) for n, dt, d in inputs],
        output=[TensorConfig(n, dt, list(d),
                             label_filename=f"{n}_labels.txt"
                             if n in labels else "")
                for n, dt, d in outputs],
        preferred_batch_size=sorted(preferred_batch_sizes or []),
        max_queue_delay_microseconds=max_queue_delay_us,
        dynamic_batching=bool(preferred_batch_sizes or max_queue_delay_us),
        instance_kind=instance_kind,
        parameters={k: str(v) for k, v in (parameters or {}).items()},
        ensemble_scheduling=list(ensemble_scheduling or []),
        decoupled=decoupled,
        max_sequence_idle_microseconds=60_000_000 if sequence_batching
        else None,
        model_warmup=[_warmup_sample(w) for w in warmup or []],
        response_cache=True if response_cache else None,
    )


def _warmup_sample(w: dict):
    """One ``ModelWarmup`` message of a ``make_config`` warmup entry."""
    from ..protocol import inference as pb

    inputs = {}
    for tensor, (dt, dims, mode) in w["inputs"].items():
        data = ({"random_data": True} if mode == "random"
                else {"zero_data": True})
        inputs[tensor] = pb.ModelWarmup.Input(
            data_type=pb.enum_value("DataType", "TYPE_" + (
                "STRING" if dt == "BYTES" else dt)),
            dims=list(dims), **data)
    return pb.ModelWarmup(name=w.get("name", "sample"),
                          batch_size=w.get("batch_size", 0),
                          count=w.get("count", 1), inputs=inputs)


def resolve_instance_device(config: ModelConfig) -> torch.device:
    """Placement from ``instance_group``: ``KIND_CPU`` pins the host; any
    other kind is ``cuda:0``, which raises where CUDA is missing."""
    if config.instance_kind == "KIND_CPU":
        return torch.device("cpu")
    return resolve_device("cuda:0")


@dataclass
class ModelStats:
    """Per-model counters (the reference's ``ModelStats``), backing the
    statistics API (HTTP ``/v2/models/{m}/stats``, gRPC
    ``ModelStatistics``): inferences (requests' rows) and executions, the
    success / fail / queue / compute durations in ns, and the last
    inference's wall-clock ms.  Dynamic batching besides: batched
    executions and the requests they carried (average formed batch =
    batch_size_total / batch_execution_count).  Every execution, batched or
    not: where ``executions`` is a list, each one's
    (``time.perf_counter()`` at its end, rows executed: the batch padded to
    its bucket) is appended to it."""

    inference_count: int = 0
    execution_count: int = 0
    last_inference_ms: int = 0
    success_count: int = 0
    success_ns: int = 0
    fail_count: int = 0
    fail_ns: int = 0
    queue_count: int = 0
    queue_ns: int = 0
    infer_count: int = 0
    infer_ns: int = 0
    batch_size_total: int = 0
    batch_execution_count: int = 0
    # requests executing or waiting (nv_inference_pending_request_count)
    pending_count: int = 0
    executions: Optional[List[Tuple[float, int]]] = None
    lock: threading.Lock = field(default_factory=threading.Lock)

    def record(self, batch: int, queue_ns: int, compute_ns: int,
               ok: bool) -> None:
        """One execution of ``batch`` rows (the reference's
        ``ModelStats.record``)."""
        with self.lock:
            if ok:
                self.inference_count += batch
                self.execution_count += 1
                self.last_inference_ms = int(time.time() * 1000)
                self.success_count += batch
                self.success_ns += (queue_ns + compute_ns) * batch
                self.queue_count += batch
                self.queue_ns += queue_ns * batch
                self.infer_count += batch
                self.infer_ns += compute_ns * batch
            else:
                self.fail_count += batch
                self.fail_ns += (queue_ns + compute_ns) * batch

    def inc_pending(self) -> None:
        with self.lock:
            self.pending_count += 1

    def dec_pending(self) -> None:
        with self.lock:
            self.pending_count -= 1

    def record_batch(self, batch: int) -> None:
        with self.lock:
            self.batch_size_total += batch
            self.batch_execution_count += 1

    def record_execution(self, rows: int) -> None:
        if self.executions is not None:
            with self.lock:
                self.executions.append((time.perf_counter(), rows))

    def snapshot(self, name: str, version: str) -> dict:
        """The v2 statistics entry of this model (the reference's
        ``InferenceCore.statistics`` row)."""
        with self.lock:
            return {
                "name": name, "version": version,
                "last_inference": self.last_inference_ms,
                "inference_count": self.inference_count,
                "execution_count": self.execution_count,
                "inference_stats": {
                    "success": {"count": self.success_count,
                                "ns": self.success_ns},
                    "fail": {"count": self.fail_count, "ns": self.fail_ns},
                    "queue": {"count": self.queue_count,
                              "ns": self.queue_ns},
                    "compute_input": {"count": self.infer_count, "ns": 0},
                    "compute_infer": {"count": self.infer_count,
                                      "ns": self.infer_ns},
                    "compute_output": {"count": self.infer_count, "ns": 0},
                },
                "batch_stats": [],
            }


class Model(abc.ABC):
    """Base model: subclasses implement ``execute`` over a dict of input
    arrays and return a dict of output arrays or tensors."""

    #: version number this instance serves (the registry stamps it)
    served_version: str = "1"
    #: the directory a repository model was loaded from, else None
    model_dir: Optional[str] = None

    def __init__(self, config: ModelConfig):
        self.config = config
        self.stats = ModelStats()

    @property
    def name(self) -> str:
        return self.config.name

    @property
    def versions(self) -> List[str]:
        """Every version served under this model's name (the registry
        stamps the list on each loaded instance)."""
        return list(getattr(self, "_version_list", ("1",)))

    @property
    def max_batch_size(self) -> int:
        return self.config.max_batch_size

    @property
    def decoupled(self) -> bool:
        return self.config.decoupled

    @property
    def is_sequence(self) -> bool:
        return self.config.max_sequence_idle_microseconds is not None

    def metadata(self) -> dict:
        """v2 model-metadata JSON."""
        batched = self.config.max_batch_size > 0

        def tensor_md(io):
            dims = list(io.dims)
            return {"name": io.name, "datatype": io.data_type,
                    "shape": [-1] + dims if batched else dims}

        return {
            "name": self.name,
            "versions": self.versions,
            "platform": self.config.platform,
            "inputs": [tensor_md(i) for i in self.config.input],
            "outputs": [tensor_md(o) for o in self.config.output],
        }

    @abc.abstractmethod
    def execute(self, inputs: Dict[str, Any],
                parameters: Dict[str, Any]) -> Dict[str, Any]:
        ...

    def execute_decoupled(self, inputs: Dict[str, Any],
                          parameters: Dict[str, Any]
                          ) -> Iterator[Dict[str, Any]]:
        """A decoupled model's 0..N response dicts."""
        raise InferError(f"model '{self.name}' is not decoupled")

    def labels(self, output_name: str) -> Optional[List[str]]:
        """Classification labels of an output, where it has them."""
        return None

    def unload(self) -> None:
        """Release what the model holds when the registry unloads it."""

    def flops_per_element(self) -> Optional[float]:
        """Analytic forward FLOPs per batch element, the live-MFU numerator
        until a counted execution gives the measured one: the config's
        ``flops_per_inference`` parameter, else None (no MFU series)."""
        cached = getattr(self, "_flops_pe_cache", False)
        if cached is not False:
            return cached
        value: Optional[float] = None
        raw = self.config.parameters.get("flops_per_inference")
        if raw is not None:
            try:
                parsed = float(raw)
                if parsed > 0:
                    value = parsed
            except ValueError:
                pass
        self._flops_pe_cache = value
        return value


class PyModel(Model):
    """Host-side model: arbitrary Python over numpy arrays.  A decoupled
    one takes ``decoupled_fn(inputs, parameters)``, a generator of
    response dicts."""

    def __init__(self, config: ModelConfig, fn: Optional[Callable],
                 decoupled_fn: Optional[Callable] = None):
        super().__init__(config)
        self._fn = fn
        self._decoupled_fn = decoupled_fn

    def execute(self, inputs, parameters):
        return self._fn(inputs, parameters)

    def execute_decoupled(self, inputs, parameters):
        if self._decoupled_fn is None:
            return super().execute_decoupled(inputs, parameters)
        return self._decoupled_fn(inputs, parameters)


class EnsembleModel(Model):
    """A DAG of steps mapping tensors between member models (the config's
    ``ensemble_scheduling``).  The core runs it and resolves the members
    at infer time."""

    def __init__(self, config: ModelConfig):
        super().__init__(config)
        if not config.ensemble_scheduling:
            raise InferError(
                f"ensemble model '{config.name}' has no ensemble_scheduling")

    def execute(self, inputs, parameters):
        raise InferError("ensemble models are executed by the core")


class TorchModel(Model):
    """A model whose compute is a function over tensors on one device.

    ``fn(**inputs) -> dict[str, Tensor]`` receives every numeric input as a
    tensor on the model's device (object/BYTES arrays stay numpy) and runs
    under ``torch.inference_mode()``.  ``host_pre(inputs, params)`` and
    ``host_post(outputs, params)`` run on the host before and after it.
    ``output_labels``: classification labels by output name."""

    def __init__(self, config: ModelConfig, fn: Callable[..., Dict[str, Any]],
                 host_pre: Optional[Callable] = None,
                 host_post: Optional[Callable] = None,
                 output_labels: Optional[Dict[str, List[str]]] = None):
        super().__init__(config)
        self._fn = fn
        self._host_pre = host_pre
        self._host_post = host_post
        self._output_labels = output_labels or {}
        # resolved here, not on first request: a model placed on a missing
        # device fails at registration, loudly
        self.device = resolve_instance_device(config)

    def _to_device(self, v):
        """A tensor on the model's device: the same tensor where it lies
        there already (a view of a CUDA shared-memory region is consumed in
        place).  A copy to the host blocks: a host model reads it at once."""
        if isinstance(v, torch.Tensor):
            return v.to(self.device, non_blocking=self.device.type == "cuda")
        if isinstance(v, np.ndarray) and v.dtype != np.object_:
            if not (v.flags.writeable and v.flags.c_contiguous
                    and v.flags.aligned):
                v = np.array(v)  # wire buffers are read-only views
            return torch.from_numpy(v).to(
                self.device, non_blocking=True)
        return v

    def execute(self, inputs: Dict[str, Any],
                parameters: Dict[str, Any]) -> Dict[str, Any]:
        if self._host_pre is not None:
            inputs = self._host_pre(inputs, parameters)
        with torch.inference_mode():
            tensors = {n: self._to_device(v) for n, v in inputs.items()}
            outputs = self._fn(**tensors)
        if self._host_post is not None:
            outputs = self._host_post(outputs, parameters)
        return outputs

    def labels(self, output_name: str) -> Optional[List[str]]:
        return self._output_labels.get(output_name)

    def analyze_cost(self, inputs: Dict[str, Any],
                     parameters: Optional[Dict[str, Any]] = None,
                     peak_sink: Optional[Callable[[str, int], None]] = None):
        """Execute once, counted (``costs.analyze_torch_callable``):
        ``(outputs, SignatureCost or None)``.  The reference lowers its
        function ahead of time and runs nothing; the port can count only by
        running, so the core calls this in place of ``execute`` for the
        first execution of each input signature, and no extra forward
        runs."""
        from .costs import analyze_torch_callable

        return analyze_torch_callable(
            self.execute, inputs, parameters if parameters is not None
            else {}, device=self.device, peak_sink=peak_sink)


__all__ = ["EnsembleModel", "EnsembleStep", "Model", "ModelConfig",
           "ModelStats", "PyModel", "TensorConfig", "TorchModel",
           "config_from_pb", "make_config",
           "resolve_instance_device"]
