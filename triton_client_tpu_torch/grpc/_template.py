"""Compiled gRPC request templates: the client's wire fast path
(counterpart of ``triton_client_tpu/grpc/_template.py``).

A load generator sends one model the same request spec thousands of times.
:class:`RequestTemplate` builds the ``ModelInferRequest`` once with the
slow path's own builder (``get_inference_request``), encodes the parts
that do not change, and on each ``stamp()`` encodes only the request
``id``, the v2 parameters where a ``timeout`` is stamped, and the
``raw_input_contents`` entries (tag, length, then the payload itself, not
copied).  Protobuf writes fields in number order (1-2 model, 3 id, 4
parameters, 5-6 tensors, 7 raw contents), so the stamped parts joined are
byte for byte the slow path's message.

A template goes stale when an input's shape, datatype or representation
(data or shared memory) changes, or a requested output's parameters do:
``stamp()`` checks them on each call and raises rather than send a wrong
request.  ``stamp()`` changes nothing in the template, so threads may share
one.
"""

from __future__ import annotations

from typing import List, Optional

from ..protocol import inference as pb
from ..protocol._proto3 import encode_varint
from ..protocol.grpc_web import frame_header
from ..utils import raise_error, wire_length
from ._utils import get_inference_request

__all__ = ["RequestTemplate"]

_ID_TAG = encode_varint(3 << 3 | 2)
_RAW_TAG = encode_varint(7 << 3 | 2)


class RequestTemplate:
    """The compiled fixed part of one (model, inputs, outputs, parameters)
    request.  Made by ``client.prepare(...)``."""

    def __init__(self, model_name: str, inputs, outputs=None,
                 model_version: str = "", priority: int = 0,
                 timeout: Optional[int] = None, parameters=None):
        self.model_name = model_name
        self.model_version = model_version
        self._inputs = list(inputs)
        self._outputs = list(outputs) if outputs else []
        request = get_inference_request(
            model_name, self._inputs, model_version, "", self._outputs, 0,
            False, False, priority, timeout, parameters)
        self._params = dict(request.parameters)
        self._prefix = pb.ModelInferRequest(
            model_name=model_name,
            model_version=model_version).SerializeToString()
        self._tensors = pb.ModelInferRequest(
            inputs=request.inputs, outputs=request.outputs
        ).SerializeToString()
        self._params_bytes = self._encode_params(self._params)
        # the inputs that carry data, and each one's frozen size (None: a
        # BYTES input, whose size varies)
        self._raw_idx: List[int] = []
        self._frozen_sizes: List[Optional[int]] = []
        # the other inputs (shared memory) are compiled in whole
        self._static_inputs = []
        self._frozen_shapes = [list(i.shape()) for i in self._inputs]
        self._frozen_epochs = [i._shape_epoch for i in self._inputs]
        for i, inp in enumerate(self._inputs):
            raw = inp._get_raw_data()
            if raw is None:
                self._static_inputs.append(
                    (i, inp._get_tensor_pb().SerializeToString()))
                continue
            self._raw_idx.append(i)
            self._frozen_sizes.append(
                None if inp.datatype() == "BYTES" else wire_length(raw))
        self._frozen_outputs = [o._get_tensor_pb().SerializeToString()
                                for o in self._outputs]

    @staticmethod
    def _encode_params(params) -> bytes:
        return pb.ModelInferRequest(parameters=params).SerializeToString()

    def _check(self) -> List:
        """The payloads of the bound inputs, after checking that nothing
        compiled in changed."""
        for i, frozen in self._static_inputs:
            inp = self._inputs[i]
            if inp._get_raw_data() is not None \
                    or inp._get_tensor_pb().SerializeToString() != frozen:
                raise_error(
                    f"template invalidated: input {inp.name()!r} changed "
                    "representation or shm parameters after prepare (its "
                    "submessage is compiled in -- re-prepare)")
        for o, frozen in zip(self._outputs, self._frozen_outputs):
            if o._get_tensor_pb().SerializeToString() != frozen:
                raise_error(
                    f"template invalidated: output {o.name()!r} parameters "
                    "changed after prepare (its submessage is compiled in "
                    "-- re-prepare)")
        for i, inp in enumerate(self._inputs):
            if inp._shape_epoch != self._frozen_epochs[i]:
                if inp.shape() != self._frozen_shapes[i]:
                    raise_error(
                        f"template invalidated: input {inp.name()!r} shape "
                        f"changed to {inp.shape()} after prepare froze "
                        f"{self._frozen_shapes[i]} (re-prepare)")
                self._frozen_epochs[i] = inp._shape_epoch
        raws = []
        for slot, i in enumerate(self._raw_idx):
            raw = self._inputs[i]._get_raw_data()
            if raw is None:
                raise_error(
                    "template invalidated: input "
                    f"{self._inputs[i].name()!r} no longer carries raw data "
                    "(representation changed after prepare -- re-prepare)")
            frozen = self._frozen_sizes[slot]
            if frozen is not None and wire_length(raw) != frozen:
                raise_error(
                    "template invalidated: input "
                    f"{self._inputs[i].name()!r} payload is "
                    f"{wire_length(raw)} bytes, template froze {frozen} "
                    "(re-prepare after a shape change)")
            raws.append(raw)
        return raws

    def raws_for(self, inputs) -> List:
        """Another request's tensor payloads in this template's order
        (``infer_many``), each input checked against the template's: the
        same name, datatype and shape, a compiled-in (shared-memory) input
        with the same submessage, and a payload of the frozen size."""
        if len(inputs) != len(self._inputs):
            raise_error("infer_many item does not match the template's "
                        f"input count ({len(inputs)} != "
                        f"{len(self._inputs)})")
        for ours, theirs in zip(self._inputs, inputs):
            if (theirs.name() != ours.name()
                    or theirs.datatype() != ours.datatype()
                    or list(theirs.shape()) != list(ours.shape())):
                raise_error(
                    f"infer_many item input {theirs.name()!r} does not "
                    "match the template spec (name/dtype/shape must be "
                    "identical; re-prepare for a new shape)")
        for i, frozen in self._static_inputs:
            inp = inputs[i]
            if inp._get_raw_data() is not None \
                    or inp._get_tensor_pb().SerializeToString() != frozen:
                raise_error(f"infer_many item input {inp.name()!r} does not "
                            "match the template's shared-memory input")
        raws = []
        for slot, i in enumerate(self._raw_idx):
            raw = inputs[i]._get_raw_data()
            if raw is None:
                raise_error(f"infer_many item input {inputs[i].name()!r} "
                            "has no binary data attached")
            frozen = self._frozen_sizes[slot]
            if frozen is not None and wire_length(raw) != frozen:
                raise_error(f"infer_many item input {inputs[i].name()!r} "
                            f"payload is {wire_length(raw)} bytes, the "
                            f"template's {frozen}")
            raws.append(raw)
        return raws

    def stamp(self, request_id: str = "",
              timeout_us: Optional[int] = None, raws=None) -> bytes:
        """The gRPC-Web frame of the request for the bound inputs' current
        data, or for the payloads ``raws`` (:meth:`raws_for`): byte for
        byte the slow path's message with this ``request_id`` (and
        ``timeout`` parameter, where given)."""
        if raws is None:
            raws = self._check()
        parts = [self._prefix]
        if request_id:
            rid = request_id.encode("utf-8")
            parts += [_ID_TAG, encode_varint(len(rid)), rid]
        if timeout_us is None:
            parts.append(self._params_bytes)
        else:
            params = dict(self._params)
            params["timeout"] = pb.InferParameter(int64_param=timeout_us)
            parts.append(self._encode_params(params))
        parts.append(self._tensors)
        for raw in raws:
            parts += [_RAW_TAG, encode_varint(wire_length(raw)), raw]
        n = sum(wire_length(p) for p in parts)
        # tpu-lint: disable=WIRE-COPY the one gather of the request frame
        return b"".join([frame_header(n), *parts])
