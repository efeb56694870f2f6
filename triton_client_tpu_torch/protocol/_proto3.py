"""A proto3 wire codec on the standard library and numpy.

The machine the port serves on has neither ``protobuf`` nor ``grpcio``, so
the port encodes and decodes its gRPC messages itself.  A message class is
built from a field table (:func:`message_class`); this module turns its
instances into the proto3 wire format and back, byte for byte as protobuf's
own serializer writes them:

* fields in field-number order; a scalar at its default (0, ``""``,
  ``b""``, false) is left out, except a member of a oneof, which is written
  whenever it is the one set (``InferParameter.bool_param = false`` is two
  bytes on the wire);
* varints, with a negative ``int32``/``int64``/enum sign-extended to ten
  bytes; ``float``/``double`` as little-endian fixed32/fixed64;
* repeated scalars packed (proto3's default); the decoder also takes them
  unpacked;
* maps as repeated ``key = 1`` / ``value = 2`` entries, both always written
  (the order of the entries is the dict's);
* a submessage written whenever it is set, empty or not.

``bytes`` fields are zero-copy both ways: the encoder takes ``bytes``,
``bytearray`` or a byte ``memoryview`` as it is, and the decoder hands out
``memoryview`` slices of the buffer it was given (``raw_input_contents``
and ``raw_output_contents`` are not copied).  Packed fixed-width fields
decode with ``numpy.frombuffer`` and long packed varint fields with a
vectorised numpy decoder; repeated scalars are Python lists.

:func:`to_dict` is ``json_format.MessageToDict(msg,
preserving_proto_field_name=True)``: int64 and uint64 as strings, bytes as
base64, enums by name, a float at its shortest round-tripping repr.
"""

from __future__ import annotations

import base64
import math
import struct
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["DecodeError", "Field", "Message", "MAP", "message_class",
           "to_dict", "encode_varint"]

_MASK64 = (1 << 64) - 1

#: scalar type -> wire type
_WIRE = {"double": 1, "float": 5, "int64": 0, "uint64": 0, "int32": 0,
         "uint32": 0, "bool": 0, "enum": 0, "string": 2, "bytes": 2,
         "message": 2}
_PACKABLE = ("double", "float", "int64", "uint64", "int32", "uint32",
             "bool", "enum")
_FIXED = {"double": "<f8", "float": "<f4"}
# a packed varint field of at least this many bytes decodes with numpy
_VECTOR_MIN = 64


class DecodeError(ValueError):
    """The bytes are not a valid encoding of the message."""


# ---------------------------------------------------------------------------
# varints
# ---------------------------------------------------------------------------

_ONE_BYTE = [bytes([i]) for i in range(128)]


def encode_varint(value: int) -> bytes:
    """The varint of ``value``; a negative one as its 64-bit two's
    complement (ten bytes)."""
    if 0 <= value < 128:
        return _ONE_BYTE[value]
    value &= _MASK64
    out = bytearray()
    while value > 0x7F:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _read_varint(buf, pos: int, end: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= end:
            raise DecodeError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result & _MASK64, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint longer than ten bytes")


def _varints_np(values) -> bytes:
    """Packed varints of many values, vectorised (negatives as 64-bit two's
    complement)."""
    v = np.asarray(values)
    v = (v.astype(np.int64).view(np.uint64) if v.dtype.kind in "ib"
         else v.astype(np.uint64))
    groups = np.stack([(v >> np.uint64(7 * k)) & np.uint64(0x7F)
                       for k in range(10)], axis=1).astype(np.uint8)
    # bytes each value needs: up to its highest non-zero 7-bit group
    nonzero = groups != 0
    count = np.where(nonzero.any(axis=1),
                     10 - np.argmax(nonzero[:, ::-1], axis=1), 1)
    k = np.arange(10)
    keep = k[None, :] < count[:, None]
    cont = k[None, :] < (count - 1)[:, None]
    groups = groups | (cont.astype(np.uint8) << 7)
    return groups[keep].tobytes()


def _unvarints_np(data) -> np.ndarray:
    """The uint64 values of a packed varint run, vectorised."""
    b = np.frombuffer(data, dtype=np.uint8)
    if b.size == 0:
        return np.zeros(0, np.uint64)
    last = b < 0x80
    if not last[-1]:
        raise DecodeError("truncated packed varint")
    ends = np.flatnonzero(last)
    starts = np.concatenate(([0], ends[:-1] + 1))
    lengths = ends - starts + 1
    if lengths.max() > 10:
        raise DecodeError("varint longer than ten bytes")
    # each byte's place in its value
    place = np.arange(b.size) - np.repeat(starts, lengths)
    parts = (b & 0x7F).astype(np.uint64) << (7 * place).astype(np.uint64)
    return np.add.reduceat(parts, starts)


# ---------------------------------------------------------------------------
# scalar conversions
# ---------------------------------------------------------------------------

def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _signed32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


_FROM_VARINT: Dict[str, Callable[[int], Any]] = {
    "int64": _signed64, "uint64": lambda v: v, "int32": _signed32,
    "enum": _signed32, "uint32": lambda v: v & 0xFFFFFFFF,
    "bool": lambda v: v != 0,
}
_NP_FROM_VARINT = {"int64": np.int64, "uint64": np.uint64,
                   "int32": np.int32, "enum": np.int32,
                   "uint32": np.uint32}


def _scalar_bytes(ftype: str, v) -> bytes:
    """The encoding of one scalar value, without its tag."""
    if ftype == "float":
        return struct.pack("<f", v)
    if ftype == "double":
        return struct.pack("<d", v)
    if ftype == "bool":
        return b"\x01" if v else b"\x00"
    if ftype == "uint32":
        return encode_varint(int(v) & 0xFFFFFFFF)
    return encode_varint(int(v))


def _is_default(ftype: str, v) -> bool:
    if ftype in ("float", "double"):
        # -0.0 is not the default: its bits are not zero
        return v == 0 and math.copysign(1.0, v) > 0
    return not v


def _nbytes(v) -> int:
    return v.nbytes if isinstance(v, memoryview) else len(v)


# ---------------------------------------------------------------------------
# field tables
# ---------------------------------------------------------------------------

class MAP:
    """The type of a map field: ``MAP(key type, value type)``."""

    __slots__ = ("key", "value")

    def __init__(self, key: str, value: str):
        self.key, self.value = key, value


class Field:
    """One row of a message's field table.  ``type`` is a scalar type
    name, the full name of a message or enum type, or a :class:`MAP`;
    ``repeated`` marks a repeated field and ``oneof`` names the oneof a
    field belongs to."""

    __slots__ = ("number", "name", "type", "repeated", "oneof", "kind",
                 "cls", "enum", "map_key", "map_value", "map_value_cls")

    def __init__(self, number: int, name: str, type, repeated: bool = False,
                 oneof: Optional[str] = None):
        self.number, self.name, self.type = number, name, type
        self.repeated, self.oneof = repeated, oneof
        # resolved by message_class: "scalar", "message", "map"
        self.kind = ""
        self.cls = None
        self.enum = None
        self.map_key = self.map_value = None
        self.map_value_cls = None

    @property
    def is_map(self) -> bool:
        return isinstance(self.type, MAP)


class Message:
    """Base of the generated message classes: attributes per field, and
    protobuf's method names for what the port uses."""

    __slots__ = ()
    FULL_NAME = ""
    FIELDS: Tuple[Field, ...] = ()
    _BY_NAME: Dict[str, Field] = {}
    _BY_NUMBER: Dict[int, Field] = {}
    _ONEOFS: Dict[str, Tuple[str, ...]] = {}

    def __init__(self, **kwargs):
        for f in self.FIELDS:
            if f.oneof is None:
                object.__setattr__(self, f.name, _default(f))
        for group in self._ONEOFS:
            object.__setattr__(self, "_o_" + group, None)
        for name, value in kwargs.items():
            if name not in self._BY_NAME:
                raise TypeError(f"{self.FULL_NAME} has no field {name!r}")
            f = self._BY_NAME[name]
            if f.repeated:
                value = list(value)
            elif f.is_map:
                value = dict(value)
            setattr(self, name, value)

    # -- protobuf's names ----------------------------------------------------
    def SerializeToString(self) -> bytes:
        out: List[Any] = []
        _encode(self, out)
        # tpu-lint: disable=WIRE-COPY the one gather of the message's parts
        return b"".join(out)

    def encode_parts(self) -> Tuple[List[Any], int]:
        """The encoding as a list of buffers (payloads not copied) and its
        length: ``b"".join(parts)`` is ``SerializeToString()``."""
        out: List[Any] = []
        return out, _encode(self, out)

    @classmethod
    def FromString(cls, data) -> "Message":
        msg = cls()
        msg.ParseFromString(data)
        return msg

    def ParseFromString(self, data) -> None:
        """Replace the contents with the decoding of ``data``; ``bytes``
        fields become views of ``data``."""
        self.__init__()
        mv = memoryview(data)
        if mv.ndim != 1 or mv.itemsize != 1:
            mv = mv.cast("B")
        _decode_into(self, mv, 0, mv.nbytes)

    def WhichOneof(self, group: str) -> Optional[str]:
        if group not in self._ONEOFS:
            raise ValueError(f"{self.FULL_NAME} has no oneof {group!r}")
        which = getattr(self, "_o_" + group)
        return which[0] if which is not None else None

    def __eq__(self, other) -> bool:
        if type(other) is not type(self):
            return NotImplemented
        return all(_field_value(self, f) == _field_value(other, f)
                   for f in self.FIELDS)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({to_dict(self)!r})"


def _default(f: Field):
    if f.repeated:
        return []
    if f.is_map:
        return {}
    if f.kind == "message":
        return None
    return _SCALAR_DEFAULT[f.type if f.enum is None else "enum"]


_SCALAR_DEFAULT = {"double": 0.0, "float": 0.0, "int64": 0, "uint64": 0,
                   "int32": 0, "uint32": 0, "bool": False, "enum": 0,
                   "string": "", "bytes": b""}


def _field_value(msg: Message, f: Field):
    v = getattr(msg, f.name)
    if f.oneof is not None:
        return (msg.WhichOneof(f.oneof) == f.name, v)
    if f.type == "bytes" and not f.repeated:
        return bytes(v)
    if f.type == "bytes" and f.repeated:
        return [bytes(x) for x in v]
    return v


def _oneof_property(name: str, group: str, default):
    """A oneof member: reads its value where it is the member set, else its
    default (None for a message)."""
    slot = "_o_" + group

    def get(self):
        which = getattr(self, slot)
        return which[1] if which is not None and which[0] == name \
            else default

    def set_(self, value):
        object.__setattr__(self, slot, (name, value))

    return property(get, set_)


def message_class(full_name: str, fields: Sequence[Field]) -> type:
    """A :class:`Message` subclass for one table.  Its message and enum
    type names are resolved by :func:`resolve` once every class of the
    protocol exists, so tables may name each other in any order."""
    fields = tuple(sorted(fields, key=lambda f: f.number))
    names = [f.name for f in fields if f.oneof is None]
    oneofs: Dict[str, Tuple[str, ...]] = {}
    for f in fields:
        if f.oneof is not None:
            oneofs[f.oneof] = oneofs.get(f.oneof, ()) + (f.name,)
    ns: Dict[str, Any] = {
        "__slots__": tuple(names) + tuple("_o_" + g for g in oneofs),
        "FULL_NAME": full_name, "FIELDS": fields,
        "_BY_NAME": {f.name: f for f in fields},
        "_BY_NUMBER": {f.number: f for f in fields},
        "_ONEOFS": oneofs, "_ENCODERS": (),
    }
    for f in fields:
        if f.oneof is not None:
            ns[f.name] = _oneof_property(f.name, f.oneof,
                                         _SCALAR_DEFAULT.get(f.type))
    cls = type(full_name.rsplit(".", 1)[-1], (Message,), ns)
    cls.__qualname__ = full_name
    return cls


def resolve(registry: Dict[str, Any], enums: Dict[str, Dict[str, int]]):
    """Resolve every table's type names; call once all classes exist."""
    for cls in registry.values():
        for f in cls.FIELDS:
            if f.is_map:
                f.kind = "map"
                f.map_key = f.type.key
                f.map_value = f.type.value
                if f.map_value in registry:
                    f.map_value_cls = registry[f.map_value]
                elif f.map_value in enums:
                    raise NotImplementedError("enum map values")
            elif f.type in registry:
                f.kind, f.cls = "message", registry[f.type]
            elif f.type in enums:
                f.kind, f.enum = "scalar", enums[f.type]
            elif f.type in _SCALAR_DEFAULT:
                f.kind = "scalar"
            else:
                raise KeyError(f"{cls.FULL_NAME}.{f.name}: unknown type "
                               f"{f.type!r}")
        cls._ENCODERS = tuple(_make_encoder(f) for f in cls.FIELDS)


def _wire_type(f: Field) -> int:
    return _WIRE["enum" if f.enum is not None else f.type]


def _scalar_type(f: Field) -> str:
    return "enum" if f.enum is not None else f.type


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------

def _encode(msg: Message, out: List[Any]) -> int:
    n = 0
    for enc in type(msg)._ENCODERS:
        n += enc(msg, out)
    return n


def _len_prefixed(tag: bytes, parts_or_bytes, size: int,
                  out: List[Any]) -> int:
    head = tag + encode_varint(size)
    out.append(head)
    if isinstance(parts_or_bytes, list):
        out.extend(parts_or_bytes)
    else:
        out.append(parts_or_bytes)
    return len(head) + size


def _encode_one(ftype: str, number: int, v, out: List[Any]) -> int:
    """One value of a non-repeated field of scalar type ``ftype`` (always
    written: the caller has decided it is present)."""
    if ftype == "string":
        b = v.encode("utf-8")
        return _len_prefixed(encode_varint(number << 3 | 2), b, len(b), out)
    if ftype == "bytes":
        return _len_prefixed(encode_varint(number << 3 | 2), v, _nbytes(v),
                             out)
    b = encode_varint(number << 3 | _WIRE[ftype]) + _scalar_bytes(ftype, v)
    out.append(b)
    return len(b)


def _encode_message(cls, number: int, v, out: List[Any]) -> int:
    if not isinstance(v, cls):
        raise TypeError(f"expected {cls.FULL_NAME}, got "
                        f"{type(v).__name__}")
    parts: List[Any] = []
    size = _encode(v, parts)
    return _len_prefixed(encode_varint(number << 3 | 2), parts, size, out)


def _packed(ftype: str, values) -> bytes:
    if ftype in _FIXED:
        return np.asarray(values, dtype=_FIXED[ftype]).tobytes()
    if ftype == "bool":
        return bytes(1 if x else 0 for x in values)
    if len(values) >= _VECTOR_MIN // 2:
        if ftype == "uint32":
            values = np.asarray(values, dtype=np.int64) & 0xFFFFFFFF
        return _varints_np(values)
    if ftype == "uint32":
        return b"".join(encode_varint(int(x) & 0xFFFFFFFF) for x in values)
    return b"".join(encode_varint(int(x)) for x in values)


def _make_encoder(f: Field) -> Callable[[Message, List[Any]], int]:
    name, number = f.name, f.number
    if f.kind == "map":
        key_t, val_t, val_cls = f.map_key, f.map_value, f.map_value_cls
        tag = encode_varint(number << 3 | 2)

        def enc_map(msg, out):
            n = 0
            for k, v in getattr(msg, name).items():
                parts: List[Any] = []
                size = _encode_one(key_t, 1, k, parts)
                if val_cls is not None:
                    size += _encode_message(val_cls, 2, v, parts)
                else:
                    size += _encode_one(val_t, 2, v, parts)
                n += _len_prefixed(tag, parts, size, out)
            return n
        return enc_map
    if f.kind == "message":
        cls = f.cls
        if f.oneof is not None:
            group = "_o_" + f.oneof

            def enc_oneof_msg(msg, out):
                which = getattr(msg, group)
                if which is None or which[0] != name:
                    return 0
                return _encode_message(cls, number, which[1], out)
            return enc_oneof_msg
        if f.repeated:
            def enc_msgs(msg, out):
                return sum(_encode_message(cls, number, v, out)
                           for v in getattr(msg, name))
            return enc_msgs

        def enc_msg(msg, out):
            v = getattr(msg, name)
            return 0 if v is None else _encode_message(cls, number, v, out)
        return enc_msg
    ftype = _scalar_type(f)
    if f.repeated:
        if ftype in _PACKABLE:
            tag = encode_varint(number << 3 | 2)

            def enc_packed(msg, out):
                values = getattr(msg, name)
                if len(values) == 0:
                    return 0
                data = _packed(ftype, values)
                return _len_prefixed(tag, data, len(data), out)
            return enc_packed

        def enc_rep(msg, out):
            return sum(_encode_one(ftype, number, v, out)
                       for v in getattr(msg, name))
        return enc_rep
    if f.oneof is not None:
        group = "_o_" + f.oneof

        def enc_oneof(msg, out):
            which = getattr(msg, group)
            if which is None or which[0] != name:
                return 0
            return _encode_one(ftype, number, which[1], out)
        return enc_oneof

    def enc_scalar(msg, out):
        v = getattr(msg, name)
        if _is_default(ftype, v):
            return 0
        return _encode_one(ftype, number, v, out)
    return enc_scalar


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

def _skip(buf, pos: int, end: int, wire: int) -> int:
    if wire == 0:
        return _read_varint(buf, pos, end)[1]
    if wire == 1:
        pos += 8
    elif wire == 5:
        pos += 4
    elif wire == 2:
        n, pos = _read_varint(buf, pos, end)
        pos += n
    else:
        raise DecodeError(f"unsupported wire type {wire}")
    if pos > end:
        raise DecodeError("truncated field")
    return pos


def _read_scalar(ftype: str, buf, pos: int, end: int):
    """(value, new position) of one scalar of ``ftype``."""
    if ftype == "string":
        n, pos = _read_varint(buf, pos, end)
        if pos + n > end:
            raise DecodeError("truncated string")
        try:
            return str(buf[pos:pos + n], "utf-8"), pos + n
        except UnicodeDecodeError as e:
            raise DecodeError(f"string field is not UTF-8: {e}")
    if ftype == "bytes":
        n, pos = _read_varint(buf, pos, end)
        if pos + n > end:
            raise DecodeError("truncated bytes")
        return buf[pos:pos + n], pos + n
    if ftype in _FIXED:
        width = 8 if ftype == "double" else 4
        if pos + width > end:
            raise DecodeError("truncated fixed-width field")
        return struct.unpack_from("<d" if width == 8 else "<f", buf,
                                  pos)[0], pos + width
    v, pos = _read_varint(buf, pos, end)
    return _FROM_VARINT[ftype](v), pos


def _unpack(ftype: str, data) -> list:
    """A packed run of ``ftype`` values as a list."""
    if ftype in _FIXED:
        if len(data) % np.dtype(_FIXED[ftype]).itemsize:
            raise DecodeError("packed fixed-width run of a bad length")
        return np.frombuffer(data, dtype=_FIXED[ftype]).tolist()
    if len(data) >= _VECTOR_MIN:
        raw = _unvarints_np(data)
        if ftype == "bool":
            return (raw != 0).tolist()
        if ftype == "uint64":
            return raw.tolist()
        # two's complement: the low 32 bits for the 32-bit types
        return raw.astype(_NP_FROM_VARINT[ftype]).tolist()
    out = []
    pos, end = 0, len(data)
    conv = _FROM_VARINT[ftype]
    while pos < end:
        v, pos = _read_varint(data, pos, end)
        out.append(conv(v))
    return out


def _decode_into(msg: Message, buf, pos: int, end: int) -> None:
    by_number = type(msg)._BY_NUMBER
    while pos < end:
        key, pos = _read_varint(buf, pos, end)
        number, wire = key >> 3, key & 7
        f = by_number.get(number)
        if f is None:
            pos = _skip(buf, pos, end, wire)
            continue
        if f.kind == "message" or f.kind == "map":
            if wire != 2:
                raise DecodeError(f"{f.name}: wire type {wire}, expected 2")
            n, pos = _read_varint(buf, pos, end)
            if pos + n > end:
                raise DecodeError(f"{f.name}: truncated submessage")
            if f.kind == "map":
                k, v = _decode_entry(f, buf, pos, pos + n)
                getattr(msg, f.name)[k] = v
            elif f.repeated:
                sub = f.cls()
                _decode_into(sub, buf, pos, pos + n)
                getattr(msg, f.name).append(sub)
            elif f.oneof is not None:
                sub = f.cls()
                _decode_into(sub, buf, pos, pos + n)
                setattr(msg, f.name, sub)
            else:
                sub = getattr(msg, f.name)
                if sub is None:
                    sub = f.cls()
                    object.__setattr__(msg, f.name, sub)
                _decode_into(sub, buf, pos, pos + n)
            pos += n
            continue
        ftype = _scalar_type(f)
        if f.repeated:
            if wire == 2 and ftype in _PACKABLE:
                n, pos = _read_varint(buf, pos, end)
                if pos + n > end:
                    raise DecodeError(f"{f.name}: truncated packed field")
                getattr(msg, f.name).extend(_unpack(ftype, buf[pos:pos + n]))
                pos += n
                continue
            if wire != _WIRE[ftype]:
                raise DecodeError(f"{f.name}: wire type {wire}")
            v, pos = _read_scalar(ftype, buf, pos, end)
            getattr(msg, f.name).append(v)
            continue
        if wire != _WIRE[ftype]:
            raise DecodeError(f"{f.name}: wire type {wire}")
        v, pos = _read_scalar(ftype, buf, pos, end)
        setattr(msg, f.name, v)
    if pos != end:
        raise DecodeError("field runs past the end of its message")


def _decode_entry(f: Field, buf, pos: int, end: int):
    """(key, value) of one map entry; a missing part takes its default."""
    key = _SCALAR_DEFAULT[f.map_key]
    value = None
    while pos < end:
        tag, pos = _read_varint(buf, pos, end)
        number, wire = tag >> 3, tag & 7
        if number == 1 and wire == _WIRE[f.map_key]:
            key, pos = _read_scalar(f.map_key, buf, pos, end)
        elif number == 2 and f.map_value_cls is not None and wire == 2:
            n, pos = _read_varint(buf, pos, end)
            if pos + n > end:
                raise DecodeError(f"{f.name}: truncated map value")
            value = f.map_value_cls()
            _decode_into(value, buf, pos, pos + n)
            pos += n
        elif number == 2 and f.map_value_cls is None \
                and wire == _WIRE[f.map_value]:
            value, pos = _read_scalar(f.map_value, buf, pos, end)
        else:
            pos = _skip(buf, pos, end, wire)
    if value is None:
        value = (f.map_value_cls() if f.map_value_cls is not None
                 else _SCALAR_DEFAULT[f.map_value])
    return key, value


# ---------------------------------------------------------------------------
# proto3 JSON (MessageToDict with preserving_proto_field_name=True)
# ---------------------------------------------------------------------------

def _shortest_float(v: float) -> float:
    """The shortest decimal that reads back as the same float32 (protobuf's
    ``ToShortestFloat``)."""
    def f32(x):
        return struct.unpack("<f", struct.pack("<f", x))[0]

    precision = 6
    rounded = float(f"{v:.{precision}g}")
    while f32(rounded) != v:
        precision += 1
        rounded = float(f"{v:.{precision}g}")
    return rounded


def _json_scalar(f: Field, ftype: str, v):
    if f.enum is not None:
        for label, number in f.enum.items():
            if number == v:
                return label
        return v
    if ftype in ("int64", "uint64"):
        return str(v)
    if ftype == "bytes":
        return base64.b64encode(v).decode("utf-8")
    if ftype in ("float", "double"):
        if math.isinf(v):
            return "-Infinity" if v < 0 else "Infinity"
        if math.isnan(v):
            return "NaN"
        return _shortest_float(v) if ftype == "float" else v
    if ftype == "bool":
        return bool(v)
    if ftype in ("int32", "uint32"):
        return int(v)
    return v


def to_dict(msg: Message) -> dict:
    out: Dict[str, Any] = {}
    for f in msg.FIELDS:
        v = getattr(msg, f.name)
        if f.kind == "map":
            if v:
                entry = Field(2, "value", f.map_value)
                entry.kind = "scalar"
                out[f.name] = {
                    (("true" if k else "false") if isinstance(k, bool)
                     else str(k)):
                    (to_dict(x) if f.map_value_cls is not None
                     else _json_scalar(entry, f.map_value, x))
                    for k, x in v.items()}
        elif f.kind == "message":
            if f.oneof is not None:
                if msg.WhichOneof(f.oneof) == f.name:
                    out[f.name] = to_dict(v)
            elif f.repeated:
                if v:
                    out[f.name] = [to_dict(x) for x in v]
            elif v is not None:
                out[f.name] = to_dict(v)
        elif f.repeated:
            if len(v):
                ftype = _scalar_type(f)
                out[f.name] = [_json_scalar(f, ftype, x) for x in v]
        elif f.oneof is not None:
            if msg.WhichOneof(f.oneof) == f.name:
                out[f.name] = _json_scalar(f, _scalar_type(f), v)
        elif not _is_default(_scalar_type(f), v):
            out[f.name] = _json_scalar(f, _scalar_type(f), v)
    return out
