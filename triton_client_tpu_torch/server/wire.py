"""The server's wire templates: responses compiled once per (model, output
set), then stamped.

The port's counterpart of ``triton_client_tpu/server/wire.py``.  The slow
path rebuilds the whole v2 response envelope per request: the HTTP
frontend dumps the JSON header (model name and version, output specs,
parameter blocks) through ``json.dumps``, the gRPC frontend builds a
``ModelInferResponse`` tree and encodes it.  For steady serving (one
model, one output set, thousands of responses) everything but the
response id, ``triton_request_id``, the leading (batch) dim of each
output and the tensor bytes is the same each time, so this module
compiles the envelope once and stamps only those:

* :class:`HttpResponseTemplate` runs the one header builder
  (:func:`build_http_response_header`, which the slow path runs too, so
  the two cannot drift) with sentinel values and cuts the dumped JSON into
  a printf-style ``bytes`` template: ``%d`` per leading dim and per
  ``binary_data_size``, ``%s`` per id slot.  A stamp is one ``%`` format;
  the tensors stay separate segments, views of the output arrays, as the
  slow path sends them.
* :class:`GrpcResponseTemplate` keeps pre-encoded byte parts rather than a
  message to copy: the port's proto3 codec (``protocol/_proto3.py``) is
  pure Python, so copying a message tree would cost what encoding it
  does.  The parts are the codec's own encodings of the invariant fields
  (model name and version, each frozen parameter, each output's
  submessage per leading dim); a stamp adds the id, the
  ``triton_request_id`` entry and each ``raw_output_contents`` entry (tag,
  length, then the payload, not copied).  Protobuf writes fields in number
  order, so the parts joined are byte for byte the slow path's message.
* :func:`wire_segment`: an output's wire bytes as a memoryview of its host
  array (BF16: the tensor's own bits; BYTES: the one serialization
  buffer), so the only payload copy left is the socket write.

Templates live in a per-core, per-protocol :class:`ResponseTemplateCache`
keyed by (model, registry generation).  A load bumps the generation, so a
stale template never stamps a reloaded model's responses;
``InferenceCore.retire_name_caches`` (a load, an unload, a failed warmup)
and a rolling update's flip and rollback drop a name's entries at once.
A response whose shape is not template-friendly (an output in JSON
``data``, whose values vary per response) takes the slow path: the same
bytes, not amortized.  No switch turns the templates off.

Ownership: the segments and payloads alias the response's host arrays,
which nothing in the serving path writes to after the core reads them
back; a stamped gRPC message is encoded from its parts, so it is not to
be changed after the stamp.
"""

from __future__ import annotations

import json
import threading
import warnings
from json.encoder import encode_basestring_ascii as _json_str
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..protocol import inference as pb
from ..protocol._proto3 import encode_varint
from ..utils import bf16_to_bytes, serialize_byte_tensor_raw
from .types import InferResponse, OutputTensor

__all__ = [
    "GrpcResponseTemplate",
    "HttpResponseTemplate",
    "ResponseTemplateCache",
    "StampedInferResponse",
    "build_http_response_header",
    "build_pb_response",
    "encode_http_response",
    "encode_pb_response",
    "py_to_param",
    "wire_segment",
]

#: Improbable literals the template compiler plants, then locates, in the
#: dumped header.  The int base is moved on a collision (a shm byte size or
#: a frozen dim could in principle equal one); the strings never appear
#: otherwise.
_SENTINEL_ID = "tmpl-resp-id-9f3a71c5e2d04b88"
_SENTINEL_RID = "tmpl-resp-rid-5c1e88f0a73d42b9"
_SENTINEL_INT_BASE = 9_090_909_090_001


# -- the wire bytes of an output --------------------------------------------


def wire_segment(data, datatype: str) -> memoryview:
    """An output's wire bytes (HTTP binary data, gRPC
    ``raw_output_contents``): a view of the array where it is numeric and
    contiguous, BYTES serialized once, BF16 the tensor's own bits.  The
    caller must not change the array until the bytes are written."""
    if datatype == "BYTES":
        return memoryview(serialize_byte_tensor_raw(np.asarray(data)))
    if datatype == "BF16":
        return memoryview(bf16_to_bytes(data))
    return memoryview(np.ascontiguousarray(data).reshape(-1)).cast("B")


# -- HTTP: the one header builder (slow path and template compile) ---------


def _array_to_json(data, datatype: str) -> list:
    """An output's values in JSON ``data``: BYTES as UTF-8 strings (one
    that is not UTF-8 fails, as in the reference), BF16 through f32."""
    if datatype == "BYTES":
        return [x.decode("utf-8") if isinstance(x, (bytes, bytearray))
                else str(x) for x in np.asarray(data).flatten(order="C")]
    if datatype == "BF16":
        return data.float().reshape(-1).tolist()
    return np.asarray(data).reshape(-1).tolist()


def build_http_response_header(
    resp: InferResponse,
    requested: Dict[str, Any],
    default_binary: bool,
    segments: List[memoryview],
    sizes: Optional[List[int]] = None,
) -> Dict[str, Any]:
    """The v2 HTTP response header as a dict.

    The one header builder: the slow path dumps what it returns, and the
    template compiler runs it with sentinel values.  ``segments`` collects
    each binary output's wire bytes in output order; ``sizes``, given by
    the compiler only, supplies the ``binary_data_size`` values instead.
    An output written to a shared-memory region carries only the region's
    parameters."""
    out_json: List[Dict[str, Any]] = []
    bslot = 0
    for out in resp.outputs:
        entry: Dict[str, Any] = {"name": out.name, "datatype": out.datatype,
                                 "shape": list(out.shape)}
        if out.shm is not None:
            entry["parameters"] = {
                "shared_memory_region": out.shm.region_name,
                "shared_memory_byte_size": out.shm.byte_size}
            if out.shm.offset:
                entry["parameters"]["shared_memory_offset"] = out.shm.offset
        else:
            spec = requested.get(out.name)
            if spec.binary_data if spec is not None else default_binary:
                if sizes is not None:
                    n = sizes[bslot]
                    bslot += 1
                else:
                    seg = wire_segment(out.data, out.datatype)
                    n = seg.nbytes
                    segments.append(seg)
                entry["parameters"] = {"binary_data_size": n}
            else:
                entry["data"] = _array_to_json(out.data, out.datatype)
        out_json.append(entry)
    header: Dict[str, Any] = {"model_name": resp.model_name,
                              "model_version": resp.model_version or "1",
                              "outputs": out_json}
    if resp.id:
        header["id"] = resp.id
    if resp.parameters:
        header["parameters"] = resp.parameters
    return header


# -- what a template freezes -----------------------------------------------


class _TemplateBase:
    """The frozen spec and the per-request ``matches`` check both
    templates share.

    A template freezes everything invariant about its response shape: the
    model version, whether there is an id and a ``triton_request_id``,
    every other response parameter (key, class and value: ``1``, ``True``
    and ``1.0`` compare equal but serialize differently) in order, and per
    output its name, datatype, rank, trailing dims and shared-memory
    region.  ``matches`` runs on every request, so it exits early and
    builds no signature."""

    def _freeze(self, resp: InferResponse) -> None:
        self._version = resp.model_version or "1"
        self._has_id = bool(resp.id)
        params = resp.parameters
        self._has_rid = "triton_request_id" in params
        self._frozen_items = [(k, v.__class__, v) for k, v in params.items()]
        self._out_frozen = []
        for o in resp.outputs:
            shm = o.shm
            self._out_frozen.append((
                o.name, o.datatype, len(o.shape), tuple(o.shape[1:]),
                None if shm is None
                else (shm.region_name, shm.byte_size, shm.offset)))

    def _matches_base(self, resp: InferResponse) -> bool:
        if (resp.model_version or "1") != self._version \
                or bool(resp.id) != self._has_id:
            return False
        params = resp.parameters
        fi = self._frozen_items
        if len(params) != len(fi):
            return False
        for (k, v), (fk, fcls, fv) in zip(params.items(), fi):
            if k != fk or v.__class__ is not fcls:
                return False
            # the rid's value is a stamp slot; every other value froze
            if k != "triton_request_id" and v != fv:
                return False
        outs = resp.outputs
        fo = self._out_frozen
        if len(outs) != len(fo):
            return False
        for o, (name, dt, ndim, tail, shm_key) in zip(outs, fo):
            if o.name != name or o.datatype != dt:
                return False
            shp = o.shape
            if len(shp) != ndim or tuple(shp[1:]) != tail:
                return False
            s = o.shm
            if shm_key is None:
                if s is not None:
                    return False
            elif s is None or s.region_name != shm_key[0] \
                    or s.byte_size != shm_key[1] or s.offset != shm_key[2]:
                return False
        return True


def _http_templatable(resp: InferResponse, requested: Dict[str, Any],
                      default_binary: bool) -> bool:
    """An output in JSON ``data`` varies per response: nothing to
    amortize."""
    for o in resp.outputs:
        if o.shm is None:
            spec = requested.get(o.name)
            if not (spec.binary_data if spec is not None
                    else default_binary):
                return False
    return True


# -- HTTP response template ------------------------------------------------


class HttpResponseTemplate(_TemplateBase):
    """The compiled header of one (model, output set) HTTP response shape:
    a ``bytes`` format with ``%d`` per leading dim and per
    ``binary_data_size`` and ``%s`` per id slot, so the header is one
    C-level format call.  ``stamp()`` only reads, so one template serves
    every request thread of its shape at once."""

    def __init__(self, resp: InferResponse, requested: Dict[str, Any],
                 default_binary: bool):
        self._freeze(resp)
        # the outputs with a leading (batch) dim, and the binary ones, in
        # output order
        self._dim_idx = [i for i, o in enumerate(resp.outputs) if o.shape]
        self._bin_idx = [i for i, o in enumerate(resp.outputs)
                         if o.shm is None]
        self._fmt, self._argspec = self._compile(resp, requested,
                                                 default_binary)

    def matches(self, resp: InferResponse, requested: Dict[str, Any],
                default_binary: bool) -> bool:
        if not self._matches_base(resp):
            return False
        # every output not in a region must still resolve to binary (the
        # requested outputs and the default may differ per request)
        outs = resp.outputs
        for i in self._bin_idx:
            spec = requested.get(outs[i].name)
            if not (spec.binary_data if spec is not None
                    else default_binary):
                return False
        return True

    def _compile(self, resp, requested, default_binary):
        """Run the header builder with sentinel values and compile its dump
        into a ``%`` format plus the argument spec (``("id", None)``,
        ``("rid", None)``, ``("dim", output index)``, ``("bsize",
        slot)``, in header order)."""
        base = _SENTINEL_INT_BASE
        for _attempt in range(16):
            dim_sent = {i: base + 7 * i for i in self._dim_idx}
            size_sent = [base + 500_009 + 11 * s
                         for s in range(len(self._bin_idx))]
            sent_outputs = []
            for i, o in enumerate(resp.outputs):
                shape = ((dim_sent[i],) + tuple(o.shape[1:]) if o.shape
                         else ())
                sent_outputs.append(OutputTensor(
                    name=o.name, datatype=o.datatype, shape=shape,
                    data=o.data, shm=o.shm))
            params = dict(resp.parameters)
            if self._has_rid:
                params["triton_request_id"] = _SENTINEL_RID
            sent = InferResponse(
                model_name=resp.model_name,
                model_version=resp.model_version,
                id=_SENTINEL_ID if self._has_id else "",
                outputs=sent_outputs, parameters=params)
            header = json.dumps(build_http_response_header(
                sent, requested, default_binary, [], sizes=size_sent))
            marks: List[Tuple[str, str, Optional[int]]] = []
            if self._has_id:
                marks.append((json.dumps(_SENTINEL_ID), "id", None))
            if self._has_rid:
                marks.append((json.dumps(_SENTINEL_RID), "rid", None))
            marks += [(str(v), "dim", i) for i, v in dim_sent.items()]
            marks += [(str(v), "bsize", s) for s, v in enumerate(size_sent)]
            if all(header.count(m) == 1 for m, _k, _s in marks):
                return self._fuse(
                    header.encode("utf-8"),
                    [(m.encode("utf-8"), k, s) for m, k, s in marks])
            base += 1_010_101  # a real value collided: move and plant again
        raise ValueError("could not compile a response template "
                         "(sentinel collision)")

    @staticmethod
    def _fuse(header: bytes, marks):
        """Cut the sentinels out of the dumped header and join the literals
        into one ``%`` format (a literal ``%`` escaped), with its argument
        spec in header order."""
        placed = sorted((header.index(m), m, kind, slot)
                        for m, kind, slot in marks)
        fmt_parts: List[bytes] = []
        argspec: List[Tuple[str, Any]] = []
        pos = 0
        for at, m, kind, slot in placed:
            fmt_parts.append(header[pos:at].replace(b"%", b"%%"))
            fmt_parts.append(b"%s" if kind in ("id", "rid") else b"%d")
            argspec.append((kind, slot))
            pos = at + len(m)
        fmt_parts.append(header[pos:].replace(b"%", b"%%"))
        return b"".join(fmt_parts), argspec

    def stamp(self, resp: InferResponse) -> Tuple[bytes, List[memoryview]]:
        """The header with this response's fields, and its binary
        segments: byte for byte the slow path's for any response this
        template ``matches``."""
        outs = resp.outputs
        segments = [wire_segment(outs[i].data, outs[i].datatype)
                    for i in self._bin_idx]
        args = []
        for kind, val in self._argspec:
            if kind == "dim":
                args.append(outs[val].shape[0])
            elif kind == "bsize":
                args.append(segments[val].nbytes)
            elif kind == "id":
                # the C escaper json.dumps itself uses
                args.append(_json_str(resp.id).encode("utf-8"))
            else:  # rid
                args.append(_json_str(
                    resp.parameters["triton_request_id"]).encode("utf-8"))
        return self._fmt % tuple(args), segments


# -- gRPC: the one message builder and its template -------------------------


def py_to_param(value) -> "pb.InferParameter":
    if isinstance(value, bool):
        return pb.InferParameter(bool_param=value)
    if isinstance(value, int):
        return pb.InferParameter(int64_param=value)
    if isinstance(value, float):
        return pb.InferParameter(double_param=value)
    return pb.InferParameter(string_param=str(value))


def _output_tensor(t: OutputTensor):
    tensor = pb.ModelInferResponse.InferOutputTensor(
        name=t.name, datatype=t.datatype, shape=[int(s) for s in t.shape])
    if t.shm is not None:
        tensor.parameters["shared_memory_region"] = pb.InferParameter(
            string_param=t.shm.region_name)
        tensor.parameters["shared_memory_byte_size"] = pb.InferParameter(
            int64_param=t.shm.byte_size)
        if t.shm.offset:
            tensor.parameters["shared_memory_offset"] = pb.InferParameter(
                int64_param=t.shm.offset)
    return tensor


def build_pb_response(resp: InferResponse) -> "pb.ModelInferResponse":
    """The slow path's ``ModelInferResponse`` (and the gRPC template's
    source of truth): an output in a region has an empty
    ``raw_output_contents`` entry, every other its wire segment."""
    out = pb.ModelInferResponse(model_name=resp.model_name,
                                model_version=resp.model_version or "1",
                                id=resp.id)
    for k, v in resp.parameters.items():
        out.parameters[k] = py_to_param(v)
    for t in resp.outputs:
        out.outputs.append(_output_tensor(t))
        out.raw_output_contents.append(
            b"" if t.shm is not None else wire_segment(t.data, t.datatype))
    return out


_TAG_ID = encode_varint(3 << 3 | 2)
_TAG_PARAM = encode_varint(4 << 3 | 2)
_TAG_RAW = encode_varint(6 << 3 | 2)
_EMPTY_RAW = _TAG_RAW + encode_varint(0)


def _param_entry(key: str, value) -> bytes:
    """One ``parameters`` map entry of a ``ModelInferResponse``, as the
    codec writes it (a string value spelled out, the hot case)."""
    if value.__class__ is not str:
        return pb.ModelInferResponse(
            parameters={key: py_to_param(value)}).SerializeToString()
    kb, vb = key.encode("utf-8"), value.encode("utf-8")
    # InferParameter.string_param is field 3
    param = b"\x1a" + encode_varint(len(vb)) + vb
    entry = (b"\x0a" + encode_varint(len(kb)) + kb
             + b"\x12" + encode_varint(len(param)) + param)
    return _TAG_PARAM + encode_varint(len(entry)) + entry


def _enc_stamped(msg, out: List[Any]) -> int:
    out.extend(msg._parts)
    return msg._size


class StampedInferResponse(pb.ModelInferResponse):
    """A ``ModelInferResponse`` stamped from a :class:`GrpcResponseTemplate`:
    its fields read as the slow path's message would, and it encodes
    (alone or inside a ``ModelStreamInferResponse``) from the template's
    parts.  Not to be changed after the stamp."""

    __slots__ = ("_parts", "_size")
    _ENCODERS = (_enc_stamped,)


class GrpcResponseTemplate(_TemplateBase):
    """The pre-encoded parts of one (model, output set)
    ``ModelInferResponse`` shape.  Each output's submessage is kept per
    leading dim met so far (at most ``DIMS_KEPT``; steady traffic repeats
    one batch size), as its encoded bytes and its message."""

    DIMS_KEPT = 64

    def __init__(self, resp: InferResponse):
        self._freeze(resp)
        skeleton = build_pb_response(resp)
        self._model_name = skeleton.model_name
        self._model_version = skeleton.model_version
        self._head = pb.ModelInferResponse(
            model_name=skeleton.model_name,
            model_version=skeleton.model_version).SerializeToString()
        # the parameters in order: (key, frozen entry bytes or None for the
        # rid, frozen InferParameter)
        self._params = [
            (k, None if k == "triton_request_id" else _param_entry(k, v),
             skeleton.parameters[k])
            for k, v in resp.parameters.items()]
        self._shm = [t.shm is not None for t in resp.outputs]
        self._tensors = skeleton.outputs
        # per output: {leading dim: (submessage bytes, submessage)}
        self._by_dim: List[Dict[Optional[int], Tuple[bytes, Any]]] = [
            {} for _ in resp.outputs]
        for i, tensor in enumerate(skeleton.outputs):
            self._dim_entry(i, tensor.shape[0] if tensor.shape else None)

    def _dim_entry(self, i: int, dim: Optional[int]) -> Tuple[bytes, Any]:
        kept = self._by_dim[i]
        entry = kept.get(dim)
        if entry is None:
            base = self._tensors[i]
            tensor = pb.ModelInferResponse.InferOutputTensor(
                name=base.name, datatype=base.datatype,
                shape=([dim] + list(base.shape[1:])) if base.shape else [],
                parameters=base.parameters)
            entry = (pb.ModelInferResponse(outputs=[tensor])
                     .SerializeToString(), tensor)
            if len(kept) < self.DIMS_KEPT:
                kept[dim] = entry
        return entry

    def matches(self, resp: InferResponse) -> bool:
        return self._matches_base(resp)

    def stamp(self, resp: InferResponse) -> StampedInferResponse:
        """This response's message: its ``SerializeToString()`` is byte for
        byte the slow path's for any response this template ``matches``."""
        parts: List[Any] = [self._head]
        if resp.id:
            idb = resp.id.encode("utf-8")
            parts.append(_TAG_ID + encode_varint(len(idb)) + idb)
        params = {}
        for k, entry, param in self._params:
            if entry is None:
                v = resp.parameters[k]
                entry, param = _param_entry(k, v), py_to_param(v)
            parts.append(entry)
            params[k] = param
        outs = resp.outputs
        tensors = []
        for i, o in enumerate(outs):
            body, tensor = self._dim_entry(i, o.shape[0] if o.shape
                                           else None)
            parts.append(body)
            tensors.append(tensor)
        raws = []
        for o, shm in zip(outs, self._shm):
            if shm:
                parts.append(_EMPTY_RAW)
                raws.append(b"")
            else:
                seg = wire_segment(o.data, o.datatype)
                parts.append(_TAG_RAW + encode_varint(seg.nbytes))
                parts.append(seg)
                raws.append(seg)
        msg = StampedInferResponse.__new__(StampedInferResponse)
        for name, value in (("model_name", self._model_name),
                            ("model_version", self._model_version),
                            ("id", resp.id), ("parameters", params),
                            ("outputs", tensors),
                            ("raw_output_contents", raws),
                            ("_parts", parts),
                            ("_size", sum(len(p) if p.__class__ is bytes
                                          else p.nbytes for p in parts))):
            object.__setattr__(msg, name, value)
        return msg


# -- the template cache ----------------------------------------------------


class ResponseTemplateCache:
    """Bounded cache of compiled response templates, one per protocol and
    core.  Keyed ``(model name, registry generation)``: a load bumps the
    generation, so a stale template never stamps a reloaded model's
    responses.  Each key holds a short list of templates (usually one;
    a model answers in few shapes); the caps bound a pathological churn
    (a per-request response parameter never matches a template).  Request
    threads look up, add and retire at once: changes hold a lock, a
    lookup reads a list that is only ever replaced.  A template that fails
    to compile or stamp counts in ``stats["errors"]`` and is reported
    through ``warn`` once per (model, exception type); the slow path
    answers that request."""

    PER_KEY = 8

    def __init__(self, capacity: int = 256,
                 warn: Callable[[str], Any] = warnings.warn):
        self.capacity = capacity
        self._map: Dict[Tuple[str, int], List[Any]] = {}
        self._lock = threading.Lock()
        self._warn = warn
        self._reported: set = set()
        self.stats = {"hits": 0, "misses": 0, "bypass": 0, "errors": 0}

    def lookup(self, model_name: str, generation: int) -> List[Any]:
        return self._map.get((model_name, generation), _EMPTY)

    def add(self, model_name: str, generation: int, tpl) -> None:
        key = (model_name, generation)
        with self._lock:
            tpls = self._map.get(key)
            if tpls is None:
                if len(self._map) >= self.capacity:
                    self._map.pop(next(iter(self._map)))
                tpls = []
            self._map[key] = (tpls + [tpl])[-self.PER_KEY:]

    def count(self, what: str) -> None:
        with self._lock:
            self.stats[what] += 1

    def failed(self, model_name: str, exc: Exception) -> None:
        """A template of ``model_name`` raised ``exc``: count it, and
        report it the first time this (model, exception type) is met."""
        key = (model_name, type(exc).__name__)
        with self._lock:
            self.stats["errors"] += 1
            first = key not in self._reported
            self._reported.add(key)
        if first:
            self._warn(f"wire templates: model '{model_name}': {key[1]}: "
                       f"{exc}; the slow path encodes its responses")

    def retire(self, model_name: str) -> None:
        """Drop a (re)loaded or unloaded model's entries now (the
        generation in the key already bars stale stamps; this frees them
        without waiting for the cap)."""
        with self._lock:
            for k in [k for k in self._map if k[0] == model_name]:
                del self._map[k]

    def templates(self, model_name: str) -> int:
        """How many templates the cache holds for ``model_name``."""
        with self._lock:
            return sum(len(v) for k, v in self._map.items()
                       if k[0] == model_name)


_EMPTY: List[Any] = []


def encode_http_response(
    resp: InferResponse,
    requested: Dict[str, Any],
    default_binary: bool,
    cache: Optional[ResponseTemplateCache] = None,
    generation: int = 0,
) -> Tuple[bytes, List[memoryview]]:
    """An HTTP response's JSON header and binary segments: stamped from a
    template where a cache is given and the response is template-friendly,
    else the slow path (the header through ``json.dumps``).  Both give the
    same bytes."""
    if cache is not None:
        try:
            for tpl in cache.lookup(resp.model_name, generation):
                if tpl.matches(resp, requested, default_binary):
                    cache.count("hits")
                    return tpl.stamp(resp)
            if _http_templatable(resp, requested, default_binary):
                tpl = HttpResponseTemplate(resp, requested, default_binary)
                cache.add(resp.model_name, generation, tpl)
                cache.count("misses")
                return tpl.stamp(resp)
            cache.count("bypass")
        except Exception as e:  # noqa: BLE001 - the slow path serves it
            # a compile or stamp surprise must fall back to the slow path,
            # never fail a request the slow path can answer
            cache.failed(resp.model_name, e)
    segments: List[memoryview] = []
    header = build_http_response_header(resp, requested, default_binary,
                                        segments)
    return json.dumps(header).encode("utf-8"), segments


def encode_pb_response(
    resp: InferResponse,
    cache: Optional[ResponseTemplateCache] = None,
    generation: int = 0,
) -> "pb.ModelInferResponse":
    """A gRPC response message: stamped from a template where a cache is
    given, else the slow builder.  Both encode to the same bytes."""
    if cache is not None:
        try:
            for tpl in cache.lookup(resp.model_name, generation):
                if tpl.matches(resp):
                    cache.count("hits")
                    return tpl.stamp(resp)
            tpl = GrpcResponseTemplate(resp)
            cache.add(resp.model_name, generation, tpl)
            cache.count("misses")
            return tpl.stamp(resp)
        except Exception as e:  # noqa: BLE001 - the slow path serves it
            cache.failed(resp.model_name, e)
    return build_pb_response(resp)
