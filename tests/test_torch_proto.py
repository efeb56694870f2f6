"""The port's proto3 codec (``triton_client_tpu_torch.protocol``) against
protobuf's, on the JAX package's ``inference_pb2``.

* The field table: every message of ``inference.proto`` and its fields
  (number, name, type, label, message or enum type, map key and value,
  oneof) equal to ``inference_pb2.DESCRIPTOR``; the enums too.
* Every message, each filled three times from a seed (every field set,
  each oneof's member picked at random, defaults and negative numbers
  among the values, repeated fields and maps of 0-3 entries, nested
  messages three deep), built on each side from the same values: the
  port's bytes equal ``SerializeToString()`` byte for byte, or, where the
  message holds a map (whose entry order is not defined), protobuf parses
  the port's bytes to its own message; the port parses protobuf's bytes to
  the same proto3 JSON as ``MessageToDict``.
* The gRPC clients' request builders (``get_inference_request``) of both
  packages on the same inputs, and the servers' response builders on the
  same response: equal messages.
* Hypothesis properties: negative varints, oneof members at their default,
  empty packed fields, and large ``bytes`` fields (decoded as views of the
  buffer, not copies); long packed varints decode with numpy to the same
  values as the loop.
"""

import base64

import numpy as np
import pytest
from google.protobuf import descriptor as gdesc
from google.protobuf import json_format
from hypothesis import given, settings
from hypothesis import strategies as st

from triton_client_tpu.grpc import InferInput as JInferInput
from triton_client_tpu.grpc import InferRequestedOutput as JOutput
from triton_client_tpu.grpc._utils import \
    get_inference_request as j_get_inference_request
from triton_client_tpu.protocol import inference_pb2 as pb
from triton_client_tpu.server import types as jtypes
from triton_client_tpu.server.wire import build_pb_response
from triton_client_tpu_torch.grpc import InferInput as TInferInput
from triton_client_tpu_torch.grpc import InferRequestedOutput as TOutput
from triton_client_tpu_torch.grpc._utils import \
    get_inference_request as t_get_inference_request
from triton_client_tpu_torch.protocol import _proto3
from triton_client_tpu_torch.protocol import inference as tp
from triton_client_tpu_torch.server import types as ttypes
from triton_client_tpu_torch.server.wire import \
    build_pb_response as port_pb_response

_TYPE_NAMES = {
    gdesc.FieldDescriptor.TYPE_DOUBLE: "double",
    gdesc.FieldDescriptor.TYPE_FLOAT: "float",
    gdesc.FieldDescriptor.TYPE_INT64: "int64",
    gdesc.FieldDescriptor.TYPE_UINT64: "uint64",
    gdesc.FieldDescriptor.TYPE_INT32: "int32",
    gdesc.FieldDescriptor.TYPE_UINT32: "uint32",
    gdesc.FieldDescriptor.TYPE_BOOL: "bool",
    gdesc.FieldDescriptor.TYPE_STRING: "string",
    gdesc.FieldDescriptor.TYPE_BYTES: "bytes",
}


def _short(full_name: str) -> str:
    return full_name[len("inference."):]


def _is_map(f) -> bool:
    return f.message_type is not None and \
        f.message_type.GetOptions().map_entry


def _type_of(f):
    if f.message_type is not None:
        return _short(f.message_type.full_name)
    if f.enum_type is not None:
        return _short(f.enum_type.full_name)
    return _TYPE_NAMES[f.type]


def _all_messages():
    """Every message descriptor of inference.proto, nested ones too, map
    entries left out."""
    out = []

    def walk(desc):
        if desc.GetOptions().map_entry:
            return
        out.append(desc)
        for nested in desc.nested_types:
            walk(nested)

    for desc in pb.DESCRIPTOR.message_types_by_name.values():
        walk(desc)
    return out


_DESCS = {_short(d.full_name): d for d in _all_messages()}


def _pb_class(name: str):
    cls = pb
    for part in name.split("."):
        cls = getattr(cls, part)
    return cls


# ---------------------------------------------------------------------------
# the field table
# ---------------------------------------------------------------------------

def test_every_message_of_the_proto_is_in_the_table():
    assert sorted(tp.MESSAGES) == sorted(_DESCS)


@pytest.mark.parametrize("name", sorted(_DESCS))
def test_field_table_matches_descriptor(name):
    want = []
    for f in _DESCS[name].fields:
        if _is_map(f):
            kf = f.message_type.fields_by_name["key"]
            vf = f.message_type.fields_by_name["value"]
            type_ = ("map", _type_of(kf), _type_of(vf))
            repeated = False
        else:
            type_ = _type_of(f)
            repeated = f.is_repeated
        oneof = f.containing_oneof.name if f.containing_oneof else None
        want.append((f.number, f.name, type_, repeated, oneof))
    got = tp.field_table()[f"inference.{name}"]
    assert sorted(got) == sorted(want)


def test_enums_match_descriptor():
    want = {}
    for e in pb.DESCRIPTOR.enum_types_by_name.values():
        want[_short(e.full_name)] = {v.name: v.number for v in e.values}
    for desc in _DESCS.values():
        for e in desc.enum_types:
            want[_short(e.full_name)] = {v.name: v.number for v in e.values}
    assert tp.ENUMS == want


# ---------------------------------------------------------------------------
# every message, built on both sides from the same values
# ---------------------------------------------------------------------------

_INT_EDGES = {"int32": [0, 1, -1, 127, 128, -(2 ** 31), 2 ** 31 - 1],
              "int64": [0, -1, 300, -(2 ** 63), 2 ** 63 - 1],
              "uint32": [0, 1, 2 ** 32 - 1], "uint64": [0, 2 ** 64 - 1]}


def _scalar(type_: str, rng, enum=None):
    if enum is not None:
        return int(rng.choice(list(enum.values())))
    if type_ in _INT_EDGES:
        if rng.random() < 0.5:
            edges = _INT_EDGES[type_]
            return edges[int(rng.integers(len(edges)))]
        lo, hi = {"int32": (-(2 ** 31), 2 ** 31 - 1),
                  "int64": (-(2 ** 63), 2 ** 63 - 1),
                  "uint32": (0, 2 ** 32 - 1),
                  "uint64": (0, 2 ** 64 - 1)}[type_]
        return int(rng.integers(lo, hi, dtype=np.uint64 if lo == 0
                                else np.int64, endpoint=True))
    if type_ == "bool":
        return bool(rng.integers(0, 2))
    if type_ == "float":
        return float(np.float32(rng.normal() * 10.0 ** rng.integers(-3, 4)))
    if type_ == "double":
        return float(rng.normal() * 10.0 ** rng.integers(-5, 6))
    if type_ == "string":
        return "".join(rng.choice(list("ab_Zé€0 ")) for _ in
                       range(int(rng.integers(0, 6))))
    if type_ == "bytes":
        return rng.integers(0, 256, int(rng.integers(0, 40)),
                            dtype=np.uint8).tobytes()
    raise AssertionError(type_)


def _tree(cls, rng, depth=0) -> dict:
    """Values for every field of the port's ``cls`` (one member per
    oneof), as plain Python values and nested dicts."""
    picks = {g: members[int(rng.integers(0, len(members)))]
             for g, members in cls._ONEOFS.items()}
    tree = {}
    for f in cls.FIELDS:
        if f.oneof is not None and picks[f.oneof] != f.name:
            continue
        if f.kind == "map":
            tree[f.name] = {
                _scalar(f.map_key, rng) + str(i):
                (_tree(f.map_value_cls, rng, depth + 1)
                 if f.map_value_cls is not None
                 else _scalar(f.map_value, rng))
                for i in range(int(rng.integers(0, 3)))}
        elif f.kind == "message":
            if f.repeated:
                n = int(rng.integers(0, 3)) if depth < 3 else 0
                tree[f.name] = [_tree(f.cls, rng, depth + 1)
                                for _ in range(n)]
            elif depth < 3 and (f.oneof is not None or rng.random() < 0.8):
                tree[f.name] = _tree(f.cls, rng, depth + 1)
        elif f.repeated:
            tree[f.name] = [_scalar(f.type, rng, f.enum)
                            for _ in range(int(rng.integers(0, 4)))]
        else:
            tree[f.name] = _scalar(f.type, rng, f.enum)
    return tree


def _build_port(cls, tree):
    kw = {}
    for f in cls.FIELDS:
        if f.name not in tree:
            continue
        v = tree[f.name]
        if f.kind == "map":
            kw[f.name] = {k: _build_port(f.map_value_cls, x)
                          if f.map_value_cls is not None else x
                          for k, x in v.items()}
        elif f.kind == "message":
            kw[f.name] = ([_build_port(f.cls, x) for x in v] if f.repeated
                          else _build_port(f.cls, v))
        else:
            kw[f.name] = v
    return cls(**kw)


def _build_pb(msg, tree):
    for f in msg.DESCRIPTOR.fields:
        if f.name not in tree:
            continue
        v = tree[f.name]
        if _is_map(f):
            target = getattr(msg, f.name)
            value_field = f.message_type.fields_by_name["value"]
            for k, x in v.items():
                if value_field.message_type is not None:
                    _build_pb(target[k], x)
                else:
                    target[k] = x
        elif f.message_type is not None:
            if f.is_repeated:
                for x in v:
                    _build_pb(getattr(msg, f.name).add(), x)
            else:
                sub = getattr(msg, f.name)
                sub.SetInParent()
                _build_pb(sub, v)
        elif f.is_repeated:
            getattr(msg, f.name).extend(v)
        else:
            setattr(msg, f.name, v)
    return msg


def _has_map_entries(msg) -> bool:
    for f, v in msg.ListFields():
        if _is_map(f):
            if len(v):
                return True
        elif f.message_type is not None:
            subs = v if f.is_repeated \
                else [v]
            if any(_has_map_entries(s) for s in subs):
                return True
    return False


def _pb_json(msg) -> dict:
    return json_format.MessageToDict(msg, preserving_proto_field_name=True)


def _assert_same(port_msg, pb_msg):
    """Byte for byte (by parse where there are maps), both directions, and
    the proto3 JSON of the port's decoding of protobuf's bytes."""
    mine = port_msg.SerializeToString()
    theirs = pb_msg.SerializeToString()
    if _has_map_entries(pb_msg):
        assert type(pb_msg).FromString(mine) == pb_msg
    else:
        assert mine == theirs
    decoded = type(port_msg).FromString(theirs)
    assert _proto3.to_dict(decoded) == _pb_json(pb_msg)
    assert _proto3.to_dict(port_msg) == _pb_json(pb_msg)
    assert decoded == port_msg


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(_DESCS))
def test_message_encodes_as_protobuf(name, seed):
    rng = np.random.default_rng([seed, *name.encode()])
    tree = _tree(tp.MESSAGES[name], rng)
    _assert_same(_build_port(tp.MESSAGES[name], tree),
                 _build_pb(_pb_class(name)(), tree))


# ---------------------------------------------------------------------------
# the clients' requests and the servers' responses
# ---------------------------------------------------------------------------

def _request_cases():
    rng = np.random.default_rng(7)
    ints = rng.integers(-9, 9, (2, 16)).astype(np.int32)
    floats = rng.random((3, 5)).astype(np.float32)
    texts = np.array([[b"ab"], [b"\xff\x00x"]], dtype=object)
    return [
        ("raw", [("INPUT0", "INT32", ints), ("INPUT1", "FP32", floats)],
         [], {}),
        ("bytes and outputs", [("TEXT", "BYTES", texts)],
         [("OUT", 0), ("CLS", 3)], {"request_id": "r-1"}),
        ("shm", [("X", "INT32", ("region_in", 128, 0)),
                 ("Y", "INT32", ("region_y", 64, 32))],
         [("OUT", ("region_out", 256, 16))], {}),
        ("sequence int", [("INPUT0", "INT32", ints)], [],
         {"sequence_id": 42, "sequence_start": True, "priority": 2,
          "timeout": 1500}),
        ("sequence string", [("INPUT0", "INT32", ints)], [],
         {"sequence_id": "seq-a", "sequence_end": True,
          "parameters": {"flag": False, "n": -3, "x": 0.5,
                         "s": "text"}}),
    ]


def _request(mod_in, mod_out, builder, inputs, outputs, kw):
    ins = []
    for name, dt, data in inputs:
        if isinstance(data, tuple):
            shape = [2, 16]
            x = mod_in(name, shape, dt)
            x.set_shared_memory(*data)
        else:
            x = mod_in(name, list(data.shape), dt)
            x.set_data_from_numpy(data)
        ins.append(x)
    outs = []
    for name, extra in outputs:
        if isinstance(extra, tuple):
            outs.append(mod_out(name).set_shared_memory(*extra))
        else:
            outs.append(mod_out(name, class_count=extra))
    return builder("model_a", ins, "2", kw.get("request_id", ""),
                   outs or None, kw.get("sequence_id", 0),
                   kw.get("sequence_start", False),
                   kw.get("sequence_end", False), kw.get("priority", 0),
                   kw.get("timeout"), kw.get("parameters"))


@pytest.mark.parametrize("case", _request_cases(), ids=lambda c: c[0])
def test_client_requests_match_reference(case):
    _, inputs, outputs, kw = case
    port = _request(TInferInput, TOutput, t_get_inference_request, inputs,
                    outputs, kw)
    ref = _request(JInferInput, JOutput, j_get_inference_request, inputs,
                   outputs, kw)
    _assert_same(port, ref)


def _response(types):
    rng = np.random.default_rng(3)
    outs = [
        types.OutputTensor("A", "FP32", (2, 3),
                           rng.random((2, 3)).astype(np.float32)),
        types.OutputTensor("B", "BYTES", (2, 1),
                           np.array([[b"x"], [b"\x80yz"]], dtype=object)),
        types.OutputTensor("C", "INT64", (4,), None,
                           shm=types.ShmRef("r", 32, 8)),
        types.OutputTensor("D", "INT32", (0,), np.zeros(0, np.int32)),
    ]
    return types.InferResponse(model_name="m", model_version="1", id="q",
                               outputs=outs,
                               parameters={"flag": True, "n": 7})


def test_server_response_matches_reference():
    _assert_same(port_pb_response(_response(ttypes)),
                 build_pb_response(_response(jtypes)))


# ---------------------------------------------------------------------------
# properties
# ---------------------------------------------------------------------------

_PROP = settings(max_examples=60, deadline=None, database=None)


@_PROP
@given(st.lists(st.integers(-(2 ** 31), 2 ** 31 - 1), max_size=80),
       st.lists(st.integers(-(2 ** 63), 2 ** 63 - 1), max_size=80),
       st.integers(-(2 ** 31), 2 ** 31 - 1))
def test_negative_varints(int32s, int64s, count):
    port = tp.ModelInstanceGroup(name="g", count=count, gpus=int32s)
    ref = pb.ModelInstanceGroup(name="g", count=count, gpus=int32s)
    _assert_same(port, ref)
    port = tp.InferTensorContents(int_contents=int32s,
                                  int64_contents=int64s)
    ref = pb.InferTensorContents(int_contents=int32s, int64_contents=int64s)
    _assert_same(port, ref)


@_PROP
@given(st.sampled_from([("bool_param", False), ("int64_param", 0),
                        ("string_param", ""), ("double_param", 0.0),
                        ("uint64_param", 0), ("bool_param", True),
                        ("int64_param", -1), ("double_param", -0.0)]))
def test_oneof_members_at_their_default_are_written(member):
    name, value = member
    port = tp.InferParameter(**{name: value})
    ref = pb.InferParameter(**{name: value})
    assert port.WhichOneof("parameter_choice") == name
    assert len(port.SerializeToString()) >= 2
    _assert_same(port, ref)


@_PROP
@given(st.sampled_from(sorted(f.name for f in tp.InferTensorContents.FIELDS
                              if f.type != "bytes")),
       st.booleans())
def test_empty_packed_fields_are_left_out(field, set_empty):
    port = tp.InferTensorContents(**({field: []} if set_empty else {}))
    assert port.SerializeToString() == b""
    _assert_same(tp.ModelInferRequest.InferInputTensor(
        name="x", shape=[], contents=port),
        pb.ModelInferRequest.InferInputTensor(
            name="x", shape=[], contents=pb.InferTensorContents()))


@_PROP
@given(st.lists(st.binary(min_size=0, max_size=300_000), min_size=1,
                max_size=3))
def test_large_bytes_fields_decode_as_views(blobs):
    port = tp.ModelInferRequest(model_name="m", raw_input_contents=blobs)
    ref = pb.ModelInferRequest(model_name="m", raw_input_contents=blobs)
    _assert_same(port, ref)
    data = ref.SerializeToString()
    decoded = tp.ModelInferRequest.FromString(data)
    for got, want in zip(decoded.raw_input_contents, blobs):
        assert isinstance(got, memoryview) and got.obj is data
        assert got == want


@_PROP
@given(st.lists(st.integers(0, 2 ** 64 - 1), min_size=0, max_size=400))
def test_long_packed_varints_decode_with_numpy_as_the_loop(values):
    data = b"".join(_proto3.encode_varint(v) for v in values)
    assert _proto3._varints_np(np.array(values, dtype=np.uint64)
                               if values else []) == data
    assert _proto3._unvarints_np(data).tolist() == values
    assert _proto3._unpack("uint64", data) == values


def test_int_contents_of_a_bert_request_decode_without_a_python_loop(
        monkeypatch):
    """12,288 packed int32 varints (a bert_large request's tokens in typed
    contents) decode with numpy: the per-varint reader is not called."""
    tokens = np.random.default_rng(0).integers(0, 30522, 32 * 384)
    data = pb.InferTensorContents(int_contents=tokens.tolist())\
        .SerializeToString()
    calls = []
    real = _proto3._read_varint
    monkeypatch.setattr(_proto3, "_read_varint",
                        lambda *a: calls.append(1) or real(*a))
    got = tp.InferTensorContents.FromString(data)
    assert got.int_contents == tokens.tolist()
    assert len(calls) <= 4


def test_json_bytes_and_int64_spelling():
    msg = tp.ModelInferResponse(raw_output_contents=[b"\x00\xff"],
                                parameters={"n": tp.InferParameter(
                                    int64_param=-5)})
    assert _proto3.to_dict(msg) == {
        "parameters": {"n": {"int64_param": "-5"}},
        "raw_output_contents": [base64.b64encode(b"\x00\xff").decode()]}
