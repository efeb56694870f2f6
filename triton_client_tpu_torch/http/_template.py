"""Compiled HTTP request templates: the client's wire fast path
(counterpart of ``triton_client_tpu/http/_template.py``).

The slow path builds the whole v2 JSON header on every ``infer()``.  For a
load generator (one model, one tensor spec, thousands of calls) everything
but the request id and the raw tensor bytes stays the same, so
:class:`RequestTemplate` serializes the header once and splits it into
literal byte segments around the parts that vary:

* the optional ``"id": "...", `` chunk (left out without a request id, as
  the slow path leaves it out),
* one ``binary_data_size`` integer per BYTES input (its length varies from
  call to call; a fixed-size input's size is frozen and checked on each
  stamp).

Compiling runs the slow path's own code (``build_infer_request_dict``
and ``json.dumps``) with sentinel values and splits its output, so a
stamped request is byte for byte what the slow path would send.

A template goes stale when an input's shape, dtype or representation
(binary, JSON, shared memory) changes, or the requested outputs change:
``stamp()`` checks the frozen parts on each call and raises rather than
send a wrong body; the caller then prepares again.

A template does not change after compiling, and ``stamp()`` builds a new
list of parts on each call, so threads may share one.
"""

from __future__ import annotations

import json
from typing import List, Optional, Tuple

from ..utils import raise_error, wire_length
from ._utils import build_infer_request_dict

__all__ = ["RequestTemplate"]

#: literals the compiler plants in the header, then finds again.  The
#: integer base moves on a collision (a shape dim could equal it); the id
#: string never appears otherwise.
_SENTINEL_ID = "tmpl-rid-9f3a71c5e2d04b88"
_SENTINEL_INT_BASE = 9_090_909_090_001


class RequestTemplate:
    """The compiled fixed part of one (model, inputs, outputs, parameters)
    request.  Made by ``client.prepare(...)``."""

    def __init__(self, model_name: str, inputs, outputs=None,
                 model_version: str = "", priority: int = 0,
                 timeout: Optional[int] = None, parameters=None):
        self.model_name = model_name
        self.model_version = model_version
        self._inputs = list(inputs)
        self._outputs = list(outputs) if outputs else None
        self._priority = priority
        self._timeout = timeout
        self._parameters = dict(parameters) if parameters else None
        # binary inputs in input order, and each one's frozen size (None:
        # a BYTES input, whose size is stamped)
        self._binary_idx: List[int] = []
        self._frozen_sizes: List[Optional[int]] = []
        # inputs without binary data (shared-memory ones) are header only:
        # their parameters are compiled in, so they are kept here and
        # checked on each stamp
        self._static_inputs: List[Tuple[int, dict]] = []
        # the requested outputs are header only too
        self._frozen_outputs: List[dict] = [
            dict(o._parameters) for o in (self._outputs or [])]
        # the header holds every input's shape; a reshape that keeps the
        # byte count is caught by the shape epoch
        self._frozen_shapes: List[List[int]] = []
        self._frozen_epochs: List[int] = []
        for i, inp in enumerate(self._inputs):
            self._frozen_epochs.append(inp._shape_epoch)
            if inp._data is not None:
                raise_error("RequestTemplate requires binary inputs; input "
                            f"{inp.name()!r} carries JSON data")
            self._frozen_shapes.append(list(inp.shape()))
            raw = inp._get_binary_data()
            if raw is None:
                self._static_inputs.append((i, dict(inp._parameters)))
                continue
            self._binary_idx.append(i)
            self._frozen_sizes.append(
                None if inp.datatype() == "BYTES" else wire_length(raw))
        self._segments = self._compile()

    # -- compile -----------------------------------------------------------
    def _compile(self) -> List[Tuple[str, object]]:
        """Dump the header with sentinel values and split it into
        ``("lit", bytes)``, ``("id", None)`` and ``("bsize", slot)``."""
        bytes_slots = [s for s, size in enumerate(self._frozen_sizes)
                       if size is None]
        base = _SENTINEL_INT_BASE
        for _attempt in range(16):
            sentinels = {s: base + 7 * s for s in bytes_slots}
            saved = {}
            for s, val in sentinels.items():
                inp = self._inputs[self._binary_idx[s]]
                saved[s] = inp._parameters.get("binary_data_size")
                inp._parameters["binary_data_size"] = val
            try:
                header = json.dumps(build_infer_request_dict(
                    self._inputs, _SENTINEL_ID, self._outputs, 0, False,
                    False, self._priority, self._timeout, self._parameters))
            finally:
                for s, old in saved.items():
                    inp = self._inputs[self._binary_idx[s]]
                    if old is None:
                        inp._parameters.pop("binary_data_size", None)
                    else:
                        inp._parameters["binary_data_size"] = old
            marks = [(f'"id": "{_SENTINEL_ID}", ', "id", None)]
            marks += [(str(val), "bsize", s) for s, val in sentinels.items()]
            if all(header.count(m) == 1 for m, _k, _s in marks):
                return self._split(header.encode(),
                                   [(m.encode(), k, s) for m, k, s in marks])
            base += 1_010_101  # a real value collided: move and plant again
        raise_error("could not compile request template "
                    "(sentinel collision)")  # pragma: no cover

    @staticmethod
    def _split(header: bytes, marks) -> List[Tuple[str, object]]:
        placed = sorted((header.index(m), m, kind, slot)
                        for m, kind, slot in marks)
        ops: List[Tuple[str, object]] = []
        pos = 0
        for at, m, kind, slot in placed:
            if at > pos:
                ops.append(("lit", header[pos:at]))
            ops.append((kind, slot))
            pos = at + len(m)
        if pos < len(header):
            ops.append(("lit", header[pos:]))
        return ops

    # -- stamp -------------------------------------------------------------
    def stamp(self, request_id: str = "") -> Tuple[bytes, Optional[int]]:
        """The body for the bound inputs' current data and ``request_id``:
        (body, json_size), byte for byte the slow path's."""
        self._check_static()
        self._check_shapes()
        raws = []
        for i in self._binary_idx:
            raw = self._inputs[i]._get_binary_data()
            if raw is None:
                raise_error(
                    "template invalidated: input "
                    f"{self._inputs[i].name()!r} no longer carries binary "
                    "data (representation changed after prepare -- "
                    "re-prepare)")
            raws.append(raw)
        sizes = [len(r) for r in raws]
        for slot, frozen in enumerate(self._frozen_sizes):
            if frozen is not None and sizes[slot] != frozen:
                raise_error(
                    "template invalidated: input "
                    f"{self._inputs[self._binary_idx[slot]].name()!r} "
                    f"payload is {sizes[slot]} bytes, template froze "
                    f"{frozen} (re-prepare after a shape change)")
        parts: List[bytes] = []
        for kind, val in self._segments:
            if kind == "lit":
                parts.append(val)
            elif kind == "id":
                if request_id:
                    parts.append(b'"id": ' + json.dumps(request_id).encode()
                                 + b", ")
            else:  # bsize
                parts.append(str(sizes[val]).encode())
        json_size = sum(len(p) for p in parts)
        if sum(sizes):
            parts.extend(raws)
            # tpu-lint: disable=WIRE-COPY the single required gather into the wire body
            return b"".join(parts), json_size
        # tpu-lint: disable=WIRE-COPY header-only join, no tensor payload
        return b"".join(parts), None

    def _check_shapes(self) -> None:
        """A ``set_shape`` after prepare raises, even one that keeps the
        byte count: one integer compare per input, the full compare only
        where an epoch moved."""
        for i, epoch in enumerate(self._frozen_epochs):
            inp = self._inputs[i]
            if inp._shape_epoch != epoch:
                if inp._shape != self._frozen_shapes[i]:
                    raise_error(
                        f"template invalidated: input {inp.name()!r} shape "
                        f"changed to {list(inp.shape())} after prepare froze "
                        f"{self._frozen_shapes[i]} (re-prepare)")
                self._frozen_epochs[i] = inp._shape_epoch

    def _check_static(self) -> None:
        """The header-only inputs and the requested outputs are as they
        were compiled."""
        for i, frozen in self._static_inputs:
            inp = self._inputs[i]
            if inp._get_binary_data() is not None or inp._data is not None \
                    or inp._parameters != frozen:
                raise_error(
                    f"template invalidated: input {inp.name()!r} changed "
                    "representation or shm parameters after prepare (its "
                    "header fields are compiled in -- re-prepare)")
        for o, frozen in zip(self._outputs or [], self._frozen_outputs):
            if o._parameters != frozen:
                raise_error(
                    f"template invalidated: output {o.name()!r} parameters "
                    "changed after prepare (its header fields are compiled "
                    "in -- re-prepare)")
