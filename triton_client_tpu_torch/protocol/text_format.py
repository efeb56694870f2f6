"""Readers of the protobuf text format and of proto3 JSON, on the port's
own message classes (``_proto3.py``, ``inference.py``).

The machine the port serves on has no ``protobuf``, whose ``text_format``
reads a repository's ``config.pbtxt`` in the reference and whose
``json_format`` reads a load request's ``config`` override.  These two
functions do the same for the port's field tables:

* :func:`parse_text`: field names, ``:`` before a scalar (optional before a
  message), messages in ``{ }`` or ``< >``, repeated fields given one by
  one or as a ``[ ]`` list, maps as ``key`` / ``value`` entries, enums by
  name or number, strings in either quote with C escapes (adjacent strings
  join), integers in decimal, hex or octal, floats with an optional ``f``,
  ``inf`` and ``nan``, ``#`` comments, and ``,`` or ``;`` after a field;
* :func:`parse_json`: proto3 JSON by proto field name or its lowerCamelCase
  ``json_name``, int64 as a number or a string, enums by name or number,
  bytes in base64, maps as objects, ``null`` as the field's default.

As protobuf's parsers do, an unknown field, an unknown enum value, a
singular field given twice and a second member of a oneof are errors
(:class:`ParseError`).
"""

from __future__ import annotations

import base64
import json
import math
import re
from typing import Any, List, Optional, Tuple

from ._proto3 import _SCALAR_DEFAULT, Field, Message

__all__ = ["ParseError", "parse_text", "parse_json"]

_INT_RANGE = {"int32": (-(1 << 31), (1 << 31) - 1),
              "uint32": (0, (1 << 32) - 1),
              "int64": (-(1 << 63), (1 << 63) - 1),
              "uint64": (0, (1 << 64) - 1)}


class ParseError(ValueError):
    """The text is not a valid rendering of the message."""


# ---------------------------------------------------------------------------
# the text format
# ---------------------------------------------------------------------------

_TOKEN = re.compile(r"""
    (?P<ws>\s+|\#[^\n]*)
  | (?P<str>"(?:[^"\\\n]|\\.)*"|'(?:[^'\\\n]|\\.)*')
  | (?P<num>-?(?:0[xX][0-9a-fA-F]+|(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?[fF]?))
  | (?P<ident>-?[A-Za-z_][A-Za-z0-9_.]*)
  | (?P<sym>[{}<>\[\]:,;])
""", re.X)

_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "\\": "\\", "'": "'",
            '"': '"', "a": "\a", "b": "\b", "f": "\f", "v": "\v",
            "?": "?"}


def _tokens(text: str) -> List[Tuple[str, str, int]]:
    out, pos = [], 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None:
            raise ParseError(f"{_where(text, pos)}: unexpected character "
                             f"{text[pos]!r}")
        kind = m.lastgroup
        if kind != "ws":
            out.append((kind, m.group(), pos))
        pos = m.end()
    return out


def _where(text: str, pos: int) -> str:
    line = text.count("\n", 0, pos) + 1
    col = pos - (text.rfind("\n", 0, pos) + 1) + 1
    return f"{line}:{col}"


def _unescape(lit: str) -> bytes:
    body, out, i = lit[1:-1], bytearray(), 0
    while i < len(body):
        c = body[i]
        if c != "\\":
            out += c.encode("utf-8")
            i += 1
            continue
        i += 1
        e = body[i]
        if e in _ESCAPES:
            out += _ESCAPES[e].encode()
            i += 1
        elif e in "xX":
            m = re.match(r"[0-9a-fA-F]{1,2}", body[i + 1:])
            if m is None:
                raise ParseError(f"invalid escape in {lit}")
            out.append(int(m.group(), 16))
            i += 1 + m.end()
        elif e in "01234567":
            m = re.match(r"[0-7]{1,3}", body[i:])
            out.append(int(m.group(), 8) & 0xFF)
            i += m.end()
        else:
            raise ParseError(f"invalid escape \\{e} in {lit}")
    return bytes(out)


class _TextParser:
    def __init__(self, text: str):
        self.text = text
        self.toks = _tokens(text)
        self.i = 0

    # -- tokens -------------------------------------------------------------
    def peek(self) -> Optional[Tuple[str, str, int]]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def take(self) -> Tuple[str, str, int]:
        tok = self.peek()
        if tok is None:
            raise ParseError("unexpected end of input")
        self.i += 1
        return tok

    def error(self, tok, msg: str) -> ParseError:
        pos = tok[2] if tok is not None else len(self.text)
        return ParseError(f"{_where(self.text, pos)}: {msg}")

    def at(self, sym: str) -> bool:
        tok = self.peek()
        return tok is not None and tok[0] == "sym" and tok[1] == sym

    def expect(self, sym: str) -> None:
        tok = self.peek()
        if not self.at(sym):
            raise self.error(tok, f"expected '{sym}', got "
                             f"{tok[1] if tok else 'the end'!r}")
        self.i += 1

    # -- messages -----------------------------------------------------------
    def message(self, msg: Message, close: Optional[str]) -> None:
        seen = set()
        while True:
            tok = self.peek()
            if tok is None:
                if close is not None:
                    raise self.error(tok, f"expected '{close}'")
                return
            if close is not None and self.at(close):
                self.i += 1
                return
            kind, name, _ = self.take()
            if kind != "ident":
                raise self.error(tok, f"expected a field name, got {name!r}")
            f = type(msg)._BY_NAME.get(name)
            if f is None:
                raise self.error(tok, f'Message type "{msg.FULL_NAME}" has '
                                 f'no field named "{name}".')
            if not (f.repeated or f.kind == "map"):
                if name in seen:
                    raise self.error(tok, f'Message type "{msg.FULL_NAME}" '
                                     f'should not have multiple "{name}" '
                                     "fields.")
                if f.oneof is not None and msg.WhichOneof(f.oneof):
                    raise self.error(tok, f'Field "{name}" is specified '
                                     "along with field "
                                     f'"{msg.WhichOneof(f.oneof)}", another '
                                     f'member of oneof "{f.oneof}" for '
                                     f'message type "{msg.FULL_NAME}".')
                seen.add(name)
            self.field(msg, f, tok)
            if self.at(",") or self.at(";"):
                self.i += 1

    def field(self, msg: Message, f: Field, name_tok) -> None:
        composite = f.kind in ("message", "map")
        if self.at(":"):
            self.i += 1
        elif not composite:
            raise self.error(self.peek(), 'Expected ":".')
        if self.at("["):
            if not (f.repeated or f.kind == "map"):
                raise self.error(name_tok, f"{f.name} is not repeated")
            self.i += 1
            first = True
            while not self.at("]"):
                if not first:
                    self.expect(",")
                first = False
                self.one(msg, f)
            self.i += 1
            return
        self.one(msg, f)

    def one(self, msg: Message, f: Field) -> None:
        if f.kind == "map":
            key, value = self.map_entry(f)
            getattr(msg, f.name)[key] = value
            return
        if f.kind == "message":
            sub = f.cls()
            self.submessage(sub)
            if f.repeated:
                getattr(msg, f.name).append(sub)
            else:
                setattr(msg, f.name, sub)
            return
        v = self.scalar(f)
        if f.repeated:
            getattr(msg, f.name).append(v)
        else:
            setattr(msg, f.name, v)

    def submessage(self, sub: Message) -> None:
        tok = self.peek()
        if self.at("{"):
            self.i += 1
            self.message(sub, "}")
        elif self.at("<"):
            self.i += 1
            self.message(sub, ">")
        else:
            raise self.error(tok, "expected '{' or '<'")

    def map_entry(self, f: Field):
        open_tok = self.peek()
        if not (self.at("{") or self.at("<")):
            raise self.error(open_tok, "expected '{' or '<'")
        close = "}" if open_tok[1] == "{" else ">"
        self.i += 1
        key_f = Field(1, "key", f.map_key)
        key_f.kind = "scalar"
        key, value = None, None
        while not self.at(close):
            tok = self.take()
            if tok[1] == "key":
                self.expect(":")
                key = self.scalar(key_f)
            elif tok[1] == "value":
                if f.map_value_cls is not None:
                    if self.at(":"):
                        self.i += 1
                    value = f.map_value_cls()
                    self.submessage(value)
                else:
                    self.expect(":")
                    val_f = Field(2, "value", f.map_value)
                    val_f.kind = "scalar"
                    value = self.scalar(val_f)
            else:
                raise self.error(tok, f"map entry of {f.name} has no field "
                                 f"named {tok[1]!r}")
            if self.at(",") or self.at(";"):
                self.i += 1
        self.i += 1
        if key is None:
            key = _SCALAR_DEFAULT[f.map_key]
        if value is None:
            value = (f.map_value_cls() if f.map_value_cls is not None
                     else _SCALAR_DEFAULT[f.map_value])
        return key, value

    def scalar(self, f: Field):
        tok = self.take()
        kind, lit, _ = tok
        ftype = "enum" if f.enum is not None else f.type
        if ftype in ("string", "bytes"):
            if kind != "str":
                raise self.error(tok, f"expected a string for {f.name}, got "
                                 f"{lit!r}")
            raw = _unescape(lit)
            while self.peek() is not None and self.peek()[0] == "str":
                raw += _unescape(self.take()[1])
            if ftype == "bytes":
                return raw
            try:
                return raw.decode("utf-8")
            except UnicodeDecodeError:
                raise self.error(tok, f"{f.name}: string is not UTF-8")
        if ftype == "enum":
            if kind == "ident" and lit in f.enum:
                return f.enum[lit]
            if kind == "num" and re.fullmatch(r"-?\d+", lit):
                n = int(lit)
                if n in f.enum.values():
                    return n
            raise self.error(tok, f'Enum type "inference.{f.type}" has no '
                             f"value named {lit}.")
        if ftype == "bool":
            if lit in ("true", "True", "t", "1"):
                return True
            if lit in ("false", "False", "f", "0"):
                return False
            raise self.error(tok, f"invalid value for boolean field "
                             f'"{f.name}": {lit}.')
        if ftype in ("float", "double"):
            low = lit.lower().lstrip("-")
            if kind == "ident" and low in ("inf", "infinity", "nan"):
                v = math.nan if low == "nan" else math.inf
                return -v if lit.startswith("-") else v
            if kind != "num":
                raise self.error(tok, f"expected a number for {f.name}, got "
                                 f"{lit!r}")
            return _float_literal(lit, lambda m: self.error(tok, m))
        if kind != "num":
            raise self.error(tok, f"expected an integer for {f.name}, got "
                             f"{lit!r}")
        return _int_literal(lit, ftype, lambda m: self.error(tok, m))


def _float_literal(lit: str, error):
    body = lit.lstrip("-")
    try:
        if body[:2].lower() == "0x":
            v = float(int(body, 16))
        else:
            v = float(body[:-1] if body[-1] in "fF" else body)
    except ValueError:
        raise error(f"invalid number {lit}")
    return -v if lit.startswith("-") else v


def _int_literal(lit: str, ftype: str, error):
    neg = lit.startswith("-")
    body = lit[1:] if neg else lit
    try:
        if body.lower().startswith("0x"):
            n = int(body, 16)
        elif len(body) > 1 and body.startswith("0") and body.isdigit():
            n = int(body, 8)
        else:
            n = int(body)
    except ValueError:
        raise error(f"Couldn't parse integer: {lit}")
    n = -n if neg else n
    lo, hi = _INT_RANGE[ftype]
    if not lo <= n <= hi:
        raise error(f"Couldn't parse integer: {lit}")
    return n


def parse_text(text: str, cls: type) -> Message:
    """``text`` (protobuf text format) as a new ``cls`` message."""
    msg = cls()
    _TextParser(text).message(msg, None)
    return msg


# ---------------------------------------------------------------------------
# proto3 JSON
# ---------------------------------------------------------------------------

def _camel(name: str) -> str:
    head, *rest = name.split("_")
    return head + "".join(p[:1].upper() + p[1:] for p in rest)


def _json_scalar(f: Field, ftype: str, v, where: str):
    if ftype == "enum":
        if isinstance(v, str) and v in f.enum:
            return f.enum[v]
        if isinstance(v, int) and not isinstance(v, bool):
            return v
        raise ParseError(f'Invalid enum value {v!r} for enum type {f.type} '
                         f"at {where}.")
    if ftype == "string":
        if not isinstance(v, str):
            raise ParseError(f"Failed to parse {where} field: expected "
                             f"string, got {v!r}.")
        return v
    if ftype == "bytes":
        if not isinstance(v, str):
            raise ParseError(f"Failed to parse {where} field: expected "
                             f"base64 string, got {v!r}.")
        try:
            return base64.b64decode(v + "=" * (-len(v) % 4),
                                    altchars=b"-_" if "-" in v or "_" in v
                                    else None)
        except ValueError as e:
            raise ParseError(f"Failed to parse {where} field: {e}.")
    if ftype == "bool":
        if not isinstance(v, bool):
            raise ParseError(f"Failed to parse {where} field: expected "
                             f"true or false, got {v!r}.")
        return v
    if ftype in ("float", "double"):
        if isinstance(v, str) and v in ("NaN", "Infinity", "-Infinity"):
            return float(v.replace("Infinity", "inf"))
        if isinstance(v, bool) or not isinstance(v, (int, float, str)):
            raise ParseError(f"Failed to parse {where} field: {v!r}.")
        try:
            return float(v)
        except ValueError:
            raise ParseError(f"Failed to parse {where} field: {v!r}.")
    if isinstance(v, bool):
        raise ParseError(f"Failed to parse {where} field: {v!r}.")
    if isinstance(v, float):
        if not v.is_integer():
            raise ParseError(f"Failed to parse {where} field: "
                             f"Couldn't parse integer: {v!r}.")
        v = int(v)
    elif isinstance(v, str):
        try:
            v = int(v)
        except ValueError:
            raise ParseError(f"Failed to parse {where} field: "
                             f"Couldn't parse integer: {v!r}.")
    elif not isinstance(v, int):
        raise ParseError(f"Failed to parse {where} field: {v!r}.")
    lo, hi = _INT_RANGE[ftype]
    if not lo <= v <= hi:
        raise ParseError(f"Failed to parse {where} field: integer {v} is "
                         "out of range.")
    return v


def _json_into(msg: Message, obj: Any, path: str) -> None:
    if not isinstance(obj, dict):
        raise ParseError(f"{path}: expected an object, got {obj!r}")
    by_json = {}
    for f in type(msg).FIELDS:
        by_json[f.name] = f
        by_json[_camel(f.name)] = f
    seen = set()
    for key, v in obj.items():
        f = by_json.get(key)
        if f is None:
            raise ParseError(f'Message type "{msg.FULL_NAME}" has no field '
                             f'named "{key}" at "{path}".')
        if f.name in seen:
            raise ParseError(f'Message type "{msg.FULL_NAME}" should not '
                             f'have multiple "{f.name}" fields at "{path}".')
        seen.add(f.name)
        where = f"{path}.{f.name}"
        if v is None:
            continue  # null: the field keeps its default
        if f.oneof is not None and msg.WhichOneof(f.oneof):
            raise ParseError(f'Message type "{msg.FULL_NAME}" should not '
                             f'have multiple "{f.oneof}" oneof fields at '
                             f'"{path}".')
        if f.kind == "map":
            if not isinstance(v, dict):
                raise ParseError(f"{where}: expected an object")
            key_f = Field(1, "key", f.map_key)
            key_f.kind = "scalar"
            out = getattr(msg, f.name)
            for k, x in v.items():
                if f.map_key == "bool":
                    if k not in ("true", "false"):
                        raise ParseError(f"{where}: invalid map key {k!r}")
                    mk = k == "true"
                elif f.map_key == "string":
                    mk = k
                else:
                    mk = _json_scalar(key_f, f.map_key, k, where)
                if f.map_value_cls is not None:
                    sub = f.map_value_cls()
                    _json_into(sub, x, f"{where}[{k}]")
                    out[mk] = sub
                else:
                    val_f = Field(2, "value", f.map_value)
                    val_f.kind = "scalar"
                    out[mk] = _json_scalar(val_f, f.map_value, x, where)
            continue
        ftype = "enum" if f.enum is not None else f.type
        if f.repeated:
            if not isinstance(v, list):
                raise ParseError(f"{where}: expected an array, got {v!r}")
            items = getattr(msg, f.name)
            for i, x in enumerate(v):
                if f.kind == "message":
                    sub = f.cls()
                    _json_into(sub, x, f"{where}[{i}]")
                    items.append(sub)
                else:
                    items.append(_json_scalar(f, ftype, x, where))
            continue
        if f.kind == "message":
            sub = f.cls()
            _json_into(sub, v, where)
            setattr(msg, f.name, sub)
        else:
            setattr(msg, f.name, _json_scalar(f, ftype, v, where))


def parse_json(text: Any, cls: type) -> Message:
    """Proto3 JSON (a string, or the object it decodes to) as a new ``cls``
    message."""
    if isinstance(text, (str, bytes, bytearray)):
        try:
            obj = json.loads(text)
        except ValueError as e:
            raise ParseError(f"Failed to load JSON: {e}.")
    else:
        obj = text
    msg = cls()
    _json_into(msg, obj, cls.FULL_NAME.rsplit(".", 1)[-1])
    return msg
