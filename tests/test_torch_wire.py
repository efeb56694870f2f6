"""The port's wire templates (``server/wire.py``) against its slow path and
against the reference's, on the CPU.

The counterpart of ``tests/test_server_wire_fastpath.py``'s template
classes:

* Byte equality with the slow path over the matrix of datatypes (BF16, a
  CPU ``torch.bfloat16`` tensor in the port, and BYTES included), ids,
  ``triton_request_id``, shared-memory outputs, shared-memory and binary
  outputs mixed, JSON ``data`` outputs (which bypass the template), the
  default binary flag and several outputs with their own batch dims: a
  stamped HTTP header and its segments equal the slow path's
  (``build_http_response_header`` through ``json.dumps``) byte for byte,
  and a stamped gRPC message's ``SerializeToString()`` equals the slow
  builder's, alone and inside a ``ModelStreamInferResponse``.
* Across packages, one response built from the same numpy arrays: the
  port's header bytes equal the reference's ``encode_http_response``
  header (and parse to the same JSON), with equal tensor bytes; the port's
  gRPC bytes parse to the reference's ``build_pb_response``.
* Lifecycle: a generation bump compiles a fresh template, ``retire`` drops
  a name's entries, the cache is bounded, and a load, an unload and a
  rolling update's flip through the port's core retire the templates.
* Zero copy: ``wire_segment`` is a view of the output array.
* Served: repeated ``bert_large``-shaped requests (INPUT_IDS [B, 384] to
  LOGITS [B, 384, 2], B up to 32) over HTTP and gRPC-Web answer the slow
  path's bytes, and each cache holds one template per (model, output set).
"""

import http.client
import json
import urllib.request

import ml_dtypes
import numpy as np
import pytest
import torch

from triton_client_tpu.protocol import inference_pb2 as jpb
from triton_client_tpu.server import types as jtypes
from triton_client_tpu.server import wire as jwire
from triton_client_tpu_torch.protocol import _proto3
from triton_client_tpu_torch.protocol import inference as pb
from triton_client_tpu_torch.protocol.grpc_web import (CONTENT_TYPE,
                                                       TRAILER_FLAG,
                                                       encode_frame,
                                                       iter_frames)
from triton_client_tpu_torch.server import types as ttypes
from triton_client_tpu_torch.server import wire
from triton_client_tpu_torch.server.core import InferenceCore
from triton_client_tpu_torch.server.model import PyModel, make_config
from triton_client_tpu_torch.server.registry import ModelRegistry
from triton_client_tpu_torch.server.testing import ServerHarness
from triton_client_tpu_torch.utils import serialize_byte_tensor

# (datatype, values as numpy; BF16's are f32 values exact in bf16)
DTYPE_CASES = [
    ("BOOL", np.array([[True, False, True]])),
    ("INT8", np.arange(-4, 4, dtype=np.int8).reshape(2, 4)),
    ("INT16", np.arange(8, dtype=np.int16).reshape(1, 8)),
    ("INT32", np.arange(16, dtype=np.int32).reshape(1, 16)),
    ("INT64", np.arange(4, dtype=np.int64).reshape(2, 2)),
    ("UINT8", np.arange(6, dtype=np.uint8).reshape(1, 6)),
    ("UINT16", np.arange(6, dtype=np.uint16).reshape(3, 2)),
    ("UINT32", np.arange(5, dtype=np.uint32).reshape(1, 5)),
    ("UINT64", np.arange(3, dtype=np.uint64).reshape(1, 3)),
    ("FP16", np.linspace(0, 1, 6, dtype=np.float16).reshape(1, 6)),
    ("FP32", np.linspace(-1, 1, 8, dtype=np.float32).reshape(2, 4)),
    ("FP64", np.linspace(0, 2, 4, dtype=np.float64).reshape(1, 4)),
    ("BF16", np.array([[1.5, -2.0, 0.25], [3.0, 0.0, -0.5]],
                      dtype=np.float32)),
    ("BYTES", np.array([b"abc", "d\xc3\xa9f".encode(), b""],
                       dtype=np.object_).reshape(1, 3)),
]
_IDS = [c[0] for c in DTYPE_CASES]


def _data(pkg, dt, values):
    """The output array as each package's server holds it: BF16 a CPU
    ``torch.bfloat16`` tensor in the port, an ``ml_dtypes`` array in the
    reference."""
    if dt != "BF16":
        return values
    if pkg == "port":
        return torch.from_numpy(values).to(torch.bfloat16)
    return values.astype(ml_dtypes.bfloat16)


def _resp(dt, values, *, rid=None, req_id="", shm=None, pkg="port",
          params=None):
    types = ttypes if pkg == "port" else jtypes
    out = types.OutputTensor(
        "OUT0", dt, tuple(values.shape),
        None if shm else _data(pkg, dt, values),
        shm=None if shm is None else types.ShmRef(*shm))
    resp = types.InferResponse("m", "2", id=req_id, outputs=[out])
    resp.parameters.update(params or {})
    if rid is not None:
        resp.parameters["triton_request_id"] = rid
    return resp


def _requested(names=("OUT0",), binary=True, pkg="port"):
    types = ttypes if pkg == "port" else jtypes
    return {n: types.RequestedOutput(n, binary_data=binary) for n in names}


def _flat(encoded):
    """An HTTP encoding as (header bytes, the segments' bytes)."""
    header, segments = encoded
    return header, [bytes(s) for s in segments]


def slow_http(resp, requested, default_binary):
    return _flat(wire.encode_http_response(resp, requested, default_binary))


def slow_pb(resp) -> bytes:
    return wire.build_pb_response(resp).SerializeToString()


def _twice(values, dt):
    return (values if dt == "BYTES"
            else np.concatenate([values, values], axis=0))


class TestHttpTemplateEquality:
    @pytest.mark.parametrize("dt,values", DTYPE_CASES, ids=_IDS)
    @pytest.mark.parametrize("req_id", ["", "req-id-€/esc\"x"])
    @pytest.mark.parametrize("rid", [None, "rid-123"])
    def test_matrix(self, dt, values, req_id, rid):
        cache = wire.ResponseTemplateCache()
        requested = _requested()
        resp = _resp(dt, values, rid=rid, req_id=req_id)
        got = _flat(wire.encode_http_response(resp, requested, True,
                                              cache=cache, generation=1))
        assert got == slow_http(resp, requested, True)
        # through the cached template: another id, rid and batch dim, each
        # its own slow path's bytes (nothing of the first one leaks)
        resp2 = _resp(dt, _twice(values, dt),
                      rid=("other-rid" if rid else None),
                      req_id=("other-id" if req_id else ""))
        got2 = _flat(wire.encode_http_response(resp2, requested, True,
                                               cache=cache, generation=1))
        assert got2 == slow_http(resp2, requested, True)
        assert cache.stats == {"hits": 1, "misses": 1, "bypass": 0,
                               "errors": 0}

    def test_shm_output(self):
        cache = wire.ResponseTemplateCache()
        resp = _resp("FP32", np.zeros((4, 2), np.float32),
                     shm=("region0", 128, 16))
        requested = _requested()
        want = slow_http(resp, requested, True)
        for _ in range(2):
            assert _flat(wire.encode_http_response(
                resp, requested, True, cache=cache, generation=1)) == want
        assert want[1] == [] and cache.stats["hits"] == 1

    def test_mixed_shm_and_binary_outputs(self):
        cache = wire.ResponseTemplateCache()
        resp = ttypes.InferResponse("m", "1", id="x", outputs=[
            ttypes.OutputTensor("A", "INT32", (2, 3),
                                np.arange(6, dtype=np.int32).reshape(2, 3)),
            ttypes.OutputTensor("B", "FP32", (2, 2), None,
                                shm=ttypes.ShmRef("r1", 64)),
        ])
        requested = _requested(("A", "B"))
        for _ in range(2):
            assert _flat(wire.encode_http_response(
                resp, requested, True, cache=cache, generation=1)) == \
                slow_http(resp, requested, True)
        assert cache.stats["hits"] == 1

    @pytest.mark.parametrize("dt,values", DTYPE_CASES, ids=_IDS)
    def test_json_data_output_bypasses_template(self, dt, values):
        if dt == "BYTES":
            values = np.array([[b"ab", b"c"]], dtype=np.object_)
        cache = wire.ResponseTemplateCache()
        resp = _resp(dt, values)
        requested = _requested(binary=False)
        got = _flat(wire.encode_http_response(resp, requested, False,
                                              cache=cache, generation=1))
        assert got == slow_http(resp, requested, False)
        assert got[1] == []
        assert cache.stats["bypass"] == 1 and cache.stats["misses"] == 0

    def test_default_binary_without_requested_outputs(self):
        cache = wire.ResponseTemplateCache()
        resp = _resp("INT32", np.arange(4, dtype=np.int32).reshape(1, 4))
        for default_binary in (True, False, True):
            assert _flat(wire.encode_http_response(
                resp, {}, default_binary, cache=cache, generation=1)) == \
                slow_http(resp, {}, default_binary)
        assert cache.stats == {"hits": 1, "misses": 1, "bypass": 1,
                               "errors": 0}

    def test_outputs_with_their_own_batch_dims(self):
        cache = wire.ResponseTemplateCache()
        requested = _requested(("A", "B"))
        for ba, bb in ((1, 1), (3, 3), (2, 5)):
            resp = ttypes.InferResponse("m", "1", outputs=[
                ttypes.OutputTensor("A", "INT32", (ba, 2),
                                    np.zeros((ba, 2), np.int32)),
                ttypes.OutputTensor("B", "FP32", (bb, 4),
                                    np.ones((bb, 4), np.float32)),
            ])
            assert _flat(wire.encode_http_response(
                resp, requested, True, cache=cache, generation=1)) == \
                slow_http(resp, requested, True)
        assert cache.stats["hits"] == 2  # one compile served all three

    def test_frozen_parameters_and_a_changed_value(self):
        """Parameters before and after the rid keep their order; a frozen
        value that changes compiles a template of its own."""
        cache = wire.ResponseTemplateCache()
        requested = _requested()
        values = np.arange(4, dtype=np.int32).reshape(1, 4)
        for n, rid in ((7, "a"), (7, "b"), (8, "c"), (8, "d")):
            resp = _resp("INT32", values, params={"flag": True, "n": n},
                         rid=rid)
            resp.parameters["tail"] = 1.5
            assert _flat(wire.encode_http_response(
                resp, requested, True, cache=cache, generation=1)) == \
                slow_http(resp, requested, True)
        assert cache.stats["misses"] == 2 and cache.stats["hits"] == 2
        assert cache.templates("m") == 2

    def test_a_sentinel_collision_moves_the_sentinels(self):
        """A region's byte size equal to a planted sentinel makes the
        compiler plant again elsewhere: the bytes stay the slow path's."""
        cache = wire.ResponseTemplateCache()
        resp = ttypes.InferResponse("m", "1", outputs=[
            ttypes.OutputTensor("A", "INT32", (2, 2),
                                np.zeros((2, 2), np.int32)),
            ttypes.OutputTensor("B", "FP32", (1,), None, shm=ttypes.ShmRef(
                "r", wire._SENTINEL_INT_BASE)),
        ])
        requested = _requested(("A", "B"))
        for _ in range(2):
            assert _flat(wire.encode_http_response(
                resp, requested, True, cache=cache, generation=1)) == \
                slow_http(resp, requested, True)
        assert cache.stats["errors"] == 0 and cache.stats["hits"] == 1

    def test_a_flipped_output_mode_misses(self):
        """A response whose output now resolves to JSON does not stamp
        through its binary template."""
        cache = wire.ResponseTemplateCache()
        resp = _resp("INT32", np.arange(4, dtype=np.int32).reshape(1, 4))
        for binary in (True, False):
            requested = _requested(binary=binary)
            assert _flat(wire.encode_http_response(
                resp, requested, True, cache=cache, generation=1)) == \
                slow_http(resp, requested, True)
        assert cache.stats["bypass"] == 1 and cache.stats["hits"] == 0


class TestGrpcTemplateEquality:
    @pytest.mark.parametrize("dt,values", DTYPE_CASES, ids=_IDS)
    @pytest.mark.parametrize("req_id", ["", "abc"])
    @pytest.mark.parametrize("rid", [None, "rid-9"])
    def test_matrix(self, dt, values, req_id, rid):
        cache = wire.ResponseTemplateCache()
        resp = _resp(dt, values, rid=rid, req_id=req_id)
        got = wire.encode_pb_response(resp, cache=cache, generation=1)
        assert got.SerializeToString() == slow_pb(resp)
        resp2 = _resp(dt, _twice(values, dt), rid=("r2" if rid else None),
                      req_id=("id2" if req_id else ""))
        got2 = wire.encode_pb_response(resp2, cache=cache, generation=1)
        assert got2.SerializeToString() == slow_pb(resp2)
        # the stamped message reads as the slow one, field for field
        assert _proto3.to_dict(got2) == \
            _proto3.to_dict(wire.build_pb_response(resp2))
        assert cache.stats == {"hits": 1, "misses": 1, "bypass": 0,
                               "errors": 0}

    def test_shm_output_has_an_empty_raw_entry(self):
        cache = wire.ResponseTemplateCache()
        resp = ttypes.InferResponse("m", "1", outputs=[
            ttypes.OutputTensor("A", "INT32", (1, 2),
                                np.zeros((1, 2), np.int32)),
            ttypes.OutputTensor("B", "FP32", (1, 4), None,
                                shm=ttypes.ShmRef("xr", 256, 4)),
        ])
        for _ in range(2):
            msg = wire.encode_pb_response(resp, cache=cache, generation=1)
            assert bytes(msg.raw_output_contents[1]) == b""
            assert msg.SerializeToString() == slow_pb(resp)

    def test_inside_a_stream_response(self):
        cache = wire.ResponseTemplateCache()
        for b in (2, 2, 5):
            resp = _resp("FP32", np.ones((b, 3), np.float32), rid=f"r{b}",
                         req_id="s", params={"triton_final_response": True})
            stamped = wire.encode_pb_response(resp, cache=cache,
                                              generation=1)
            want = pb.ModelStreamInferResponse(
                infer_response=wire.build_pb_response(resp))
            got = pb.ModelStreamInferResponse(infer_response=stamped)
            assert got.SerializeToString() == want.SerializeToString()
            parts, n = got.encode_parts()
            assert n == len(want.SerializeToString())
        assert cache.stats["hits"] == 2

    def test_non_string_rid_and_several_dims(self):
        cache = wire.ResponseTemplateCache()
        for b, rid in ((1, 5), (4, 6), (1, 7), (9, 8)):
            resp = ttypes.InferResponse(
                "m", "1", parameters={"triton_request_id": rid, "x": "y"},
                outputs=[ttypes.OutputTensor(
                    "A", "INT64", (b, 2), np.full((b, 2), rid, np.int64))])
            got = wire.encode_pb_response(resp, cache=cache, generation=1)
            assert got.SerializeToString() == slow_pb(resp)
        assert cache.stats["hits"] == 3

    def test_stamped_messages_are_independent(self):
        cache = wire.ResponseTemplateCache()
        r1 = _resp("INT32", np.array([[1, 2]], np.int32), req_id="a")
        r2 = _resp("INT32", np.array([[3, 4]], np.int32), req_id="b")
        m1 = wire.encode_pb_response(r1, cache=cache, generation=1)
        m2 = wire.encode_pb_response(r2, cache=cache, generation=1)
        assert m1 is not m2
        assert (m1.id, m2.id) == ("a", "b")
        assert bytes(m1.raw_output_contents[0]) == \
            np.array([[1, 2]], np.int32).tobytes()
        assert m1.SerializeToString() == slow_pb(r1)


class TestAcrossPackages:
    """One response from the same numpy arrays through both packages."""

    @pytest.mark.parametrize("binary", [True, False],
                             ids=["binary", "json"])
    @pytest.mark.parametrize("dt,values", DTYPE_CASES, ids=_IDS)
    def test_http_header_and_tensor_bytes(self, dt, values, binary):
        if dt == "BYTES" and not binary:
            values = np.array([[b"ab", b"c"]], dtype=np.object_)
        kw = dict(rid="rid-1", req_id="id-€")
        port = _resp(dt, values, **kw)
        ref = _resp(dt, values, pkg="ref", **kw)
        cache = wire.ResponseTemplateCache()
        for _ in range(2):  # the compile, then a stamp
            header, segs = _flat(wire.encode_http_response(
                port, _requested(binary=binary), binary, cache=cache,
                generation=1))
            body, json_size = jwire.encode_http_response(
                ref, _requested(binary=binary, pkg="ref"), binary)
            assert json.loads(header) == json.loads(body[:json_size])
            assert header == body[:json_size]
            assert b"".join(segs) == body[json_size:]

    @pytest.mark.parametrize("dt,values", DTYPE_CASES, ids=_IDS)
    def test_grpc_message(self, dt, values):
        kw = dict(rid="rid-1", req_id="id-2", params={"flag": True, "n": 3})
        cache = wire.ResponseTemplateCache()
        ref = jwire.build_pb_response(_resp(dt, values, pkg="ref", **kw))
        for _ in range(2):
            got = wire.encode_pb_response(_resp(dt, values, **kw),
                                          cache=cache, generation=1)
            assert jpb.ModelInferResponse.FromString(
                got.SerializeToString()) == ref


class TestTemplateCacheLifecycle:
    def test_generation_bump_compiles_a_fresh_template(self):
        cache = wire.ResponseTemplateCache()
        resp = _resp("INT32", np.arange(4, dtype=np.int32).reshape(1, 4))
        for gen in (1, 2):
            wire.encode_http_response(resp, _requested(), True, cache=cache,
                                      generation=gen)
        assert cache.stats["misses"] == 2 and cache.stats["hits"] == 0

    def test_retire_drops_a_names_entries(self):
        cache = wire.ResponseTemplateCache()
        for name in ("m", "other"):
            resp = ttypes.InferResponse(name, "1", outputs=[
                ttypes.OutputTensor("O", "INT32", (1, 2),
                                    np.zeros((1, 2), np.int32))])
            wire.encode_pb_response(resp, cache=cache, generation=1)
        cache.retire("m")
        assert (cache.templates("m"), cache.templates("other")) == (0, 1)

    def test_capacity_and_per_key_bounds(self):
        cache = wire.ResponseTemplateCache(capacity=4)
        for i in range(10):
            resp = ttypes.InferResponse(f"m{i}", "1", outputs=[
                ttypes.OutputTensor("O", "INT32", (1, 2),
                                    np.zeros((1, 2), np.int32))])
            wire.encode_pb_response(resp, cache=cache, generation=1)
        assert sum(cache.templates(f"m{i}") for i in range(10)) == 4
        assert cache.templates("m9") == 1
        for i in range(12):  # a frozen parameter that changes every time
            resp = _resp("INT32", np.zeros((1, 2), np.int32),
                         params={"n": i})
            wire.encode_pb_response(resp, cache=cache, generation=1)
        assert cache.templates("m") == wire.ResponseTemplateCache.PER_KEY

    def test_core_load_unload_and_rolling_update_retire(self):
        from triton_client_tpu_torch.server.fleet import FleetController

        def model():
            cfg = make_config("tm", inputs=[("X", "INT32", [2])],
                              outputs=[("Y", "INT32", [2])],
                              max_batch_size=4, instance_kind="KIND_CPU")
            return PyModel(cfg, lambda inputs, params: {"Y": inputs["X"]})

        registry = ModelRegistry()
        registry.register_model(model())
        core = InferenceCore(registry)
        resp = ttypes.InferResponse("tm", "1", outputs=[ttypes.OutputTensor(
            "Y", "INT32", (1, 2), np.zeros((1, 2), np.int32))])

        def fill():
            gen = registry.generation("tm")
            wire.encode_http_response(resp, {}, True,
                                      cache=core.http_wire_templates,
                                      generation=gen)
            wire.encode_pb_response(resp, cache=core.grpc_wire_templates,
                                    generation=gen)
            assert core.http_wire_templates.templates("tm") == 1
            assert core.grpc_wire_templates.templates("tm") == 1

        def retired():
            return (core.http_wire_templates.templates("tm"),
                    core.grpc_wire_templates.templates("tm")) == (0, 0)

        try:
            fill()
            core.load_model("tm")
            assert retired()
            fill()
            core.fleet = FleetController(core)
            assert core.fleet.rolling_update("tm", model(),
                                             bake_s=0) == "completed"
            assert retired()
            fill()
            core.unload_model("tm")
            assert retired()
        finally:
            core.shutdown()

    @pytest.mark.parametrize("protocol", ["http", "grpc"])
    def test_a_failing_template_is_reported_once_and_the_slow_path_answers(
            self, protocol, monkeypatch):
        cls = (wire.HttpResponseTemplate if protocol == "http"
               else wire.GrpcResponseTemplate)

        def broken(self, resp):
            raise ValueError("planted")

        monkeypatch.setattr(cls, "stamp", broken)
        warned = []
        cache = wire.ResponseTemplateCache(warn=warned.append)
        values = np.arange(4, dtype=np.int32).reshape(1, 4)
        for name in ("m", "m", "m", "other"):
            resp = _resp("INT32", values)
            resp.model_name = name
            if protocol == "http":
                got = _flat(wire.encode_http_response(
                    resp, _requested(), True, cache=cache, generation=1))
                assert got == slow_http(resp, _requested(), True)
            else:
                got = wire.encode_pb_response(resp, cache=cache,
                                              generation=1)
                assert got.SerializeToString() == slow_pb(resp)
        assert cache.stats["errors"] == 4
        assert [w.split(":")[1] for w in warned] == [" model 'm'",
                                                     " model 'other'"]
        assert all("ValueError: planted" in w for w in warned)


class TestSharedCache:
    def test_request_threads_share_one_cache(self):
        """More threads than cores stamp through one cache per protocol
        (as the core keeps them) with a short switch interval: every answer
        is its slow path's bytes, and no count is lost."""
        import os
        import sys
        import threading

        caches = {"http": wire.ResponseTemplateCache(),
                  "grpc": wire.ResponseTemplateCache()}
        n_threads, calls = 2 * (os.cpu_count() or 2) + 2, 60
        errors = []

        def work(k):
            try:
                for i in range(calls):
                    resp = _resp("FP32", np.full((1 + i % 3, 4), k,
                                                 np.float32),
                                 rid=f"{k}-{i}", req_id=f"id{i}")
                    if i % 2:
                        got = wire.encode_pb_response(
                            resp, cache=caches["grpc"], generation=1)
                        ok = got.SerializeToString() == slow_pb(resp)
                    else:
                        got = _flat(wire.encode_http_response(
                            resp, _requested(), True, cache=caches["http"],
                            generation=1))
                        ok = got == slow_http(resp, _requested(), True)
                    if not ok:
                        errors.append((k, i))
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(repr(e))

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads)
        assert errors == []
        for cache in caches.values():
            stats = cache.stats
            assert stats["hits"] + stats["misses"] == n_threads * calls // 2
            assert stats["errors"] == stats["bypass"] == 0
            assert 1 <= cache.templates("m") <= cache.PER_KEY


class TestZeroCopy:
    def test_a_numeric_segment_is_a_view(self):
        arr = np.arange(32, dtype=np.float32).reshape(4, 8)
        seg = wire.wire_segment(arr, "FP32")
        assert isinstance(seg, memoryview) and seg.nbytes == arr.nbytes
        assert np.shares_memory(np.frombuffer(seg, np.float32), arr)

    def test_a_bf16_segment_is_a_view_of_the_tensors_bits(self):
        t = torch.ones((2, 4), dtype=torch.bfloat16)
        seg = wire.wire_segment(t, "BF16")
        assert np.shares_memory(np.frombuffer(seg, np.uint8),
                                t.view(torch.int16).numpy())
        assert bytes(seg) == jwire.wire_segment(
            np.ones((2, 4), ml_dtypes.bfloat16), "BF16").tobytes()

    def test_a_bytes_segment_is_one_packed_buffer(self):
        arr = np.array([b"ab", b"c"], dtype=np.object_)
        seg = wire.wire_segment(arr, "BYTES")
        assert bytes(seg) == serialize_byte_tensor(arr).tobytes()


# -- served ---------------------------------------------------------------

_SEQ = 384


@pytest.fixture(scope="module")
def served():
    """A port server with ``bert_like``: bert_large's I/O (INPUT_IDS INT32
    [384] to LOGITS FP32 [384, 2], max batch 32) on a host function."""
    def fn(inputs, params):
        x = inputs["INPUT_IDS"].astype(np.float32)
        return {"LOGITS": np.stack([x * 0.5, x * -0.25], axis=-1)}

    cfg = make_config("bert_like", inputs=[("INPUT_IDS", "INT32", [_SEQ])],
                      outputs=[("LOGITS", "FP32", [_SEQ, 2])],
                      max_batch_size=32, instance_kind="KIND_CPU")
    registry = ModelRegistry()
    registry.register_model(PyModel(cfg, fn))
    h = ServerHarness(registry)
    h.start()
    try:
        yield h
    finally:
        h.stop()


def _expected(x, req_id=""):
    """The slow path's answer for ``x``: the response the model gives,
    encoded without a template."""
    y = x.astype(np.float32)
    logits = np.stack([y * 0.5, y * -0.25], axis=-1)
    return ttypes.InferResponse("bert_like", "1", id=req_id, outputs=[
        ttypes.OutputTensor("LOGITS", "FP32", logits.shape, logits)])


def _http_infer(port, x, req_id, binary=True):
    header = json.dumps({
        "id": req_id,
        "inputs": [{"name": "INPUT_IDS", "datatype": "INT32",
                    "shape": list(x.shape),
                    "parameters": {"binary_data_size": x.nbytes}}],
        "outputs": [{"name": "LOGITS",
                     "parameters": {"binary_data": binary}}]}).encode()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", "/v2/models/bert_like/infer",
                     body=header + x.tobytes(),
                     headers={"Inference-Header-Content-Length":
                              str(len(header))})
        r = conn.getresponse()
        body = r.read()
        assert r.status == 200, body
        return body, r.getheader("Inference-Header-Content-Length")
    finally:
        conn.close()


def _grpc_infer(port, x, req_id) -> bytes:
    req = pb.ModelInferRequest(
        model_name="bert_like", id=req_id,
        inputs=[pb.ModelInferRequest.InferInputTensor(
            name="INPUT_IDS", datatype="INT32", shape=list(x.shape))],
        raw_input_contents=[x.tobytes()])
    r = urllib.request.Request(
        f"http://127.0.0.1:{port}/inference.GRPCInferenceService/ModelInfer",
        data=encode_frame(req), headers={"Content-Type": CONTENT_TYPE})
    with urllib.request.urlopen(r, timeout=30) as resp:
        body = resp.read()
    frames = [(f, bytes(p)) for f, p in iter_frames([body])]
    assert [f for f, _ in frames] == [0, TRAILER_FLAG]
    return frames[0][1]


def test_served_http_answers_the_slow_paths_bytes(served):
    rng = np.random.default_rng(17)
    core = served.core
    core.http_wire_templates.retire("bert_like")
    before = dict(core.http_wire_templates.stats)
    for k, b in enumerate((32, 32, 1, 8, 32)):
        x = rng.integers(0, 30522, (b, _SEQ), dtype=np.int32)
        body, hlen = _http_infer(served.http_port, x, f"req-{k}")
        header, segs = wire.encode_http_response(
            _expected(x, f"req-{k}"), _requested(("LOGITS",)), True)
        assert body == header + b"".join(bytes(s) for s in segs)
        assert int(hlen) == len(header)
    # one template for (bert_like, LOGITS binary), every other a stamp
    assert core.http_wire_templates.templates("bert_like") == 1
    stats = core.http_wire_templates.stats
    assert (stats["misses"] - before["misses"],
            stats["hits"] - before["hits"]) == (1, 4)
    assert stats["errors"] == 0
    # LOGITS in JSON: the slow path, no template
    x = rng.integers(0, 30522, (2, _SEQ), dtype=np.int32)
    body, hlen = _http_infer(served.http_port, x, "", binary=False)
    header, segs = wire.encode_http_response(
        _expected(x), _requested(("LOGITS",), binary=False), False)
    assert (body, segs) == (header, [])
    assert core.http_wire_templates.templates("bert_like") == 1


def test_served_grpc_answers_the_slow_paths_bytes(served):
    rng = np.random.default_rng(18)
    core = served.core
    core.grpc_wire_templates.retire("bert_like")
    before = dict(core.grpc_wire_templates.stats)
    for k, b in enumerate((32, 32, 4, 32)):
        x = rng.integers(0, 30522, (b, _SEQ), dtype=np.int32)
        got = _grpc_infer(served.http_port, x, f"g-{k}")
        assert got == slow_pb(_expected(x, f"g-{k}"))
    assert core.grpc_wire_templates.templates("bert_like") == 1
    stats = core.grpc_wire_templates.stats
    assert (stats["misses"] - before["misses"],
            stats["hits"] - before["hits"]) == (1, 3)
    assert stats["errors"] == 0
