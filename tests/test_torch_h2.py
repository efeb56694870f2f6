"""The port's HTTP/2 codec (``triton_client_tpu_torch/protocol/hpack.py``
and ``protocol/h2.py``) on its own, on the CPU.

* HPACK against RFC 7541: the integer examples of C.1, every header block
  of C.2 to C.6 decoded (one decoder per section, as the RFC chains them)
  with the dynamic table's size and first entry after each block, every
  byte value through the Huffman code and back, bad padding and EOS
  refused, table size updates (eviction, the limit, the position in a
  block), and the encoder's blocks decoded back; where ``libnghttp2`` is
  installed, its deflater's blocks decode here and the encoder's blocks
  decode there.
* The connection without I/O: two endpoints talk through their bytes;
  frames split across reads give the events of one read; CONTINUATION,
  padding, PING, RST_STREAM and GOAWAY; flow control with a 1-byte and a
  16 KiB window (nothing is ever sent past a window, WINDOW_UPDATE
  follows consumption, a changed INITIAL_WINDOW_SIZE moves the open
  streams' windows, a reset stream's unconsumed data goes back to the
  connection); and each connection error and stream error answered as RFC
  9113 says (GOAWAY or RST_STREAM with its code).
"""

import ctypes
import ctypes.util
import struct

import pytest

from triton_client_tpu_torch.protocol import h2
from triton_client_tpu_torch.protocol.hpack import (Decoder, Encoder,
                                                    HpackError,
                                                    decode_integer,
                                                    encode_integer,
                                                    huffman_decode,
                                                    huffman_encode)

# -- HPACK: RFC 7541 Appendix C ----------------------------------------------

C1 = [(10, 5, "0a"), (1337, 5, "1f9a0a"), (42, 8, "2a")]


@pytest.mark.parametrize("value,prefix,hexed", C1)
def test_integer_examples_of_c1(value, prefix, hexed):
    assert encode_integer(value, prefix).hex() == hexed
    assert decode_integer(bytes.fromhex(hexed), 0, prefix) == (
        value, len(hexed) // 2)


_REQ1 = [(":method", "GET"), (":scheme", "http"), (":path", "/"),
         (":authority", "www.example.com")]
_REQ2 = _REQ1 + [("cache-control", "no-cache")]
_REQ3 = [(":method", "GET"), (":scheme", "https"), (":path", "/index.html"),
         (":authority", "www.example.com"), ("custom-key", "custom-value")]
_RESP1 = [(":status", "302"), ("cache-control", "private"),
          ("date", "Mon, 21 Oct 2013 20:13:21 GMT"),
          ("location", "https://www.example.com")]
_RESP2 = [(":status", "307")] + _RESP1[1:]
_RESP3 = [(":status", "200"), ("cache-control", "private"),
          ("date", "Mon, 21 Oct 2013 20:13:22 GMT"),
          ("location", "https://www.example.com"),
          ("content-encoding", "gzip"),
          ("set-cookie",
           "foo=ASDJKHQKBZXOQWEOPIUAXQWEOIU; max-age=3600; version=1")]

# (section, table size limit, [(block hex, headers, table size after,
# newest entry after)])
SECTIONS = [
    ("C.2.1", 4096, [(
        "400a637573746f6d2d6b65790d637573746f6d2d686561646572",
        [("custom-key", "custom-header")], 55,
        ("custom-key", "custom-header"))]),
    ("C.2.2", 4096, [(
        "040c2f73616d706c652f70617468", [(":path", "/sample/path")], 0,
        None)]),
    ("C.2.3", 4096, [(
        "100870617373776f726406736563726574", [("password", "secret")], 0,
        None)]),
    ("C.2.4", 4096, [("82", [(":method", "GET")], 0, None)]),
    ("C.3", 4096, [
        ("828684410f7777772e6578616d706c652e636f6d", _REQ1, 57,
         (":authority", "www.example.com")),
        ("828684be58086e6f2d6361636865", _REQ2, 110,
         ("cache-control", "no-cache")),
        ("828785bf400a637573746f6d2d6b65790c637573746f6d2d76616c7565",
         _REQ3, 164, ("custom-key", "custom-value"))]),
    ("C.4", 4096, [
        ("828684418cf1e3c2e5f23a6ba0ab90f4ff", _REQ1, 57,
         (":authority", "www.example.com")),
        ("828684be5886a8eb10649cbf", _REQ2, 110,
         ("cache-control", "no-cache")),
        ("828785bf408825a849e95ba97d7f8925a849e95bb8e8b4bf", _REQ3, 164,
         ("custom-key", "custom-value"))]),
    ("C.5", 256, [
        ("4803333032580770726976617465611d4d6f6e2c203231204f637420323031"
         "332032303a31333a323120474d546e1768747470733a2f2f7777772e657861"
         "6d706c652e636f6d", _RESP1, 222,
         ("location", "https://www.example.com")),
        ("4803333037c1c0bf", _RESP2, 222, (":status", "307")),
        ("88c1611d4d6f6e2c203231204f637420323031332032303a31333a32322047"
         "4d54c05a04677a69707738666f6f3d4153444a4b48514b425a584f5157454f"
         "50495541585157454f49553b206d61782d6167653d333630303b2076657273"
         "696f6e3d31", _RESP3, 215, _RESP3[-1])]),
    ("C.6", 256, [
        ("488264025885aec3771a4b6196d07abe941054d444a8200595040b8166e082"
         "a62d1bff6e919d29ad171863c78f0b97c8e9ae82ae43d3", _RESP1, 222,
         ("location", "https://www.example.com")),
        ("4883640effc1c0bf", _RESP2, 222, (":status", "307")),
        ("88c16196d07abe941054d444a8200595040b8166e084a62d1bffc05a839bd9"
         "ab77ad94e7821dd7f2e6c7b335dfdfcd5b3960d5af27087f3672c1ab270fb5"
         "291f9587316065c003ed4ee5b1063d5007", _RESP3, 215, _RESP3[-1])]),
]


@pytest.mark.parametrize("section,limit,blocks", SECTIONS,
                         ids=[s[0] for s in SECTIONS])
def test_rfc7541_appendix_c(section, limit, blocks):
    d = Decoder(limit)
    for hexed, headers, size, newest in blocks:
        assert d.decode(bytes.fromhex(hexed)) == headers
        assert d.table.size == size
        if newest is not None:
            assert d.table.entries[0] == newest


def test_c4_huffman_string():
    coded = bytes.fromhex("f1e3c2e5f23a6ba0ab90f4ff")
    assert huffman_encode(b"www.example.com") == coded
    assert huffman_decode(coded) == b"www.example.com"


@pytest.mark.parametrize("b", range(256))
def test_huffman_round_trip_of_every_byte(b):
    for data in (bytes([b]), bytes([b]) * 7, bytes([b, 255 - b, b])):
        assert huffman_decode(huffman_encode(data)) == data


def test_huffman_round_trip_of_all_bytes_at_once():
    data = bytes(range(256)) * 3
    assert huffman_decode(huffman_encode(data)) == data


@pytest.mark.parametrize("coded,why", [
    (bytes([0xFF, 0xFF, 0xFF, 0xFF]), "EOS"),  # 30 ones: EOS
    (huffman_encode(b"a") + b"\xff", "padding over 7 bits"),
    (bytes([0x18]), "padding not ones"),  # '0' (00000) then 000
])
def test_huffman_refuses_bad_strings(coded, why):
    with pytest.raises(HpackError):
        huffman_decode(coded)


def test_table_size_updates():
    d = Decoder(4096)
    d.decode(bytes.fromhex(SECTIONS[0][2][0][0]))
    assert d.table.size == 55
    d.decode(b"\x20")  # size update to 0: every entry evicted
    assert d.table.size == 0 and not d.table.entries
    d.decode(encode_integer(100, 5, 0x20))  # back up, within the limit
    assert d.table.max_size == 100
    with pytest.raises(HpackError):  # past the announced limit
        d.decode(encode_integer(4097, 5, 0x20))
    with pytest.raises(HpackError):  # after a field
        Decoder().decode(b"\x82\x20")
    # an entry larger than the whole table empties it
    d = Decoder(4096)
    d.decode(encode_integer(40, 5, 0x20))
    d.decode(b"\x40\x01a" + encode_integer(64, 7) + b"x" * 64)
    assert d.table.size == 0
    with pytest.raises(HpackError):
        Decoder().decode(b"\xbe")  # dynamic index past the table


@pytest.mark.parametrize("huffman", [False, True])
def test_encoder_blocks_decode_back(huffman):
    enc, dec = Encoder(huffman=huffman), Decoder()
    blocks = [_REQ1, _REQ3, [("grpc-status", "0"),
                             ("grpc-message", "a%20b"),
                             ("authorization", "Basic dTpw"),
                             ("x-bin", "".join(map(chr, range(256))))]]
    for headers in blocks * 2:
        assert dec.decode(enc.encode(headers)) == headers
    assert dec.table.max_size == 0  # the first block sized it to 0


# -- against nghttp2's HPACK, where the library is installed ---------------
_NG = ctypes.util.find_library("nghttp2")


class _NV(ctypes.Structure):
    _fields_ = [("name", ctypes.c_char_p), ("value", ctypes.c_char_p),
                ("namelen", ctypes.c_size_t), ("valuelen", ctypes.c_size_t),
                ("flags", ctypes.c_uint8)]


class _NVOut(ctypes.Structure):
    """``nghttp2_nv`` as the inflater fills it (pointers, not C strings:
    a value may hold NUL)."""
    _fields_ = [("name", ctypes.c_void_p), ("value", ctypes.c_void_p),
                ("namelen", ctypes.c_size_t), ("valuelen", ctypes.c_size_t),
                ("flags", ctypes.c_uint8)]


@pytest.fixture(scope="module")
def nghttp2():
    if _NG is None:
        pytest.skip("libnghttp2 is not installed")
    lib = ctypes.CDLL(_NG)
    lib.nghttp2_hd_deflate_new.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_size_t]
    lib.nghttp2_hd_deflate_hd.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(_NV), ctypes.c_size_t]
    lib.nghttp2_hd_deflate_hd.restype = ctypes.c_ssize_t
    lib.nghttp2_hd_inflate_new.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
    lib.nghttp2_hd_inflate_hd2.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(_NVOut),
        ctypes.POINTER(ctypes.c_int),
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int]
    lib.nghttp2_hd_inflate_hd2.restype = ctypes.c_ssize_t
    lib.nghttp2_hd_inflate_end_headers.argtypes = [ctypes.c_void_p]
    return lib


def _ng_deflater(lib):
    d = ctypes.c_void_p()
    assert lib.nghttp2_hd_deflate_new(ctypes.byref(d), 4096) == 0
    return d


def _ng_deflate(lib, d, headers):
    raw = [(n.encode("latin-1"), v.encode("latin-1")) for n, v in headers]
    nva = (_NV * len(raw))(*[_NV(n, v, len(n), len(v), 0) for n, v in raw])
    buf = ctypes.create_string_buffer(1 << 16)
    n = lib.nghttp2_hd_deflate_hd(d, buf, len(buf), nva, len(raw))
    assert n >= 0
    return buf.raw[:n]


def _ng_inflate(lib, inf, block: bytes):
    out = []
    pos = 0
    while True:
        nv, flags = _NVOut(), ctypes.c_int(0)
        n = lib.nghttp2_hd_inflate_hd2(inf, ctypes.byref(nv),
                                       ctypes.byref(flags), block[pos:],
                                       len(block) - pos, 1)
        assert n >= 0, f"nghttp2 refused the block ({n})"
        pos += n
        if flags.value & 0x02:  # NGHTTP2_HD_INFLATE_EMIT
            out.append((ctypes.string_at(nv.name, nv.namelen).decode(
                "latin-1"), ctypes.string_at(nv.value, nv.valuelen).decode(
                    "latin-1")))
        if flags.value & 0x01:  # NGHTTP2_HD_INFLATE_FINAL
            lib.nghttp2_hd_inflate_end_headers(inf)
            return out


def _header_lists():
    lists = [_REQ1, _REQ2, _REQ3, _RESP1, _RESP3]
    for b in range(0, 256, 16):
        value = "".join(chr(x) for x in range(b, b + 16))
        lists.append([("x-bytes", value), ("grpc-message", value[::-1])])
    return lists


def test_nghttp2_blocks_decode_here(nghttp2):
    """nghttp2 indexes into its table and Huffman-codes what is shorter:
    every block of a chain decodes here to what it was given."""
    d = _ng_deflater(nghttp2)
    dec = Decoder()
    for headers in _header_lists() * 2:
        assert dec.decode(_ng_deflate(nghttp2, d, headers)) == headers


@pytest.mark.parametrize("huffman", [False, True])
def test_encoder_blocks_decode_in_nghttp2(nghttp2, huffman):
    inf = ctypes.c_void_p()
    assert nghttp2.nghttp2_hd_inflate_new(ctypes.byref(inf)) == 0
    enc = Encoder(huffman=huffman)
    for headers in _header_lists() * 2:
        assert _ng_inflate(nghttp2, inf, enc.encode(headers)) == headers


# -- the connection ------------------------------------------------------------
def frame(ftype, flags, sid, payload=b""):
    return struct.pack(">I", len(payload))[1:] + bytes([ftype, flags]) + \
        struct.pack(">I", sid) + payload


def parse_frames(data):
    out = []
    pos = 0
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 3], "big")
        ftype, flags = data[pos + 3], data[pos + 4]
        sid = struct.unpack(">I", data[pos + 5:pos + 9])[0] & 0x7FFFFFFF
        out.append((ftype, flags, sid, bytes(data[pos + 9:pos + 9 + n])))
        pos += 9 + n
    return out


def pair(client_settings=None, server_settings=None, window=h2.DEFAULT_WINDOW):
    c = h2.H2Connection(client=True, settings=client_settings,
                        connection_window=window)
    s = h2.H2Connection(client=False, settings=server_settings,
                        connection_window=window)
    c.initiate()
    s.initiate()
    s.receive_data(c.data_to_send())
    c.receive_data(s.data_to_send())
    s.receive_data(c.data_to_send())
    return c, s


REQUEST = [(":method", "POST"), (":scheme", "http"), (":path", "/a/B"),
           (":authority", "x"), ("content-type", "application/grpc"),
           ("te", "trailers")]


def _kinds(events):
    return [type(e).__name__ for e in events]


def test_a_request_and_its_answer():
    c, s = pair()
    c.send_headers(1, REQUEST)
    c.send_data(1, b"hello", end_stream=True)
    ev = s.receive_data(c.data_to_send())
    assert _kinds(ev) == ["HeadersReceived", "DataReceived", "StreamEnded"]
    assert ev[0].headers == REQUEST and ev[1].data == b"hello"
    s.send_headers(1, [(":status", "200")])
    s.send_data(1, b"world")
    s.send_headers(1, [("grpc-status", "0")], end_stream=True)
    ev = c.receive_data(s.data_to_send())
    assert _kinds(ev) == ["HeadersReceived", "DataReceived",
                          "HeadersReceived", "StreamEnded"]
    assert ev[2].trailers and not ev[0].trailers
    assert not c.streams and not s.streams


def test_frames_split_across_reads_give_the_same_events():
    c, s = pair()
    c.send_headers(1, REQUEST)
    c.send_data(1, b"x" * 1000, end_stream=True)
    c.send_headers(3, REQUEST, end_stream=True)
    c.ping(b"12345678")
    wire = bytes(c.data_to_send())
    _c2, whole = pair()
    at_once = whole.receive_data(wire)
    _c3, split = pair()
    events = []
    for i in range(len(wire)):
        events += split.receive_data(wire[i:i + 1])
    assert events == at_once
    assert split.data_to_send() == whole.data_to_send()


def test_continuation_joins_a_header_block():
    c, s = pair()
    big = [("x-big", "v" * 40000)] + REQUEST[4:]
    c.send_headers(1, REQUEST[:4] + big, end_stream=True)
    wire = c.data_to_send()
    types = [f[0] for f in parse_frames(wire)]
    assert types[0] == h2.HEADERS and types.count(h2.CONTINUATION) >= 2
    ev = s.receive_data(wire)
    assert ev[0].headers == REQUEST[:4] + big


def test_padding_on_data_and_headers():
    c, s = pair()
    block = c.encoder.encode(REQUEST)
    # HEADERS, padded (3 bytes) and with a priority block
    payload = bytes([3]) + b"\0\0\0\0\x10" + block + b"\0" * 3
    raw = frame(h2.HEADERS, h2.END_HEADERS | h2.PADDED | h2.PRIORITY_FLAG,
                1, payload)
    raw += frame(h2.DATA, h2.PADDED | h2.END_STREAM, 1,
                 bytes([10]) + b"abc" + b"\0" * 10)
    ev = s.receive_data(raw)
    assert ev[0].headers == REQUEST
    assert ev[1].data == b"abc" and ev[1].flow_controlled_length == 14
    assert s.recv_window == h2.DEFAULT_WINDOW - 14


def test_ping_is_acknowledged():
    c, s = pair()
    c.ping(b"abcdefgh")
    ev = s.receive_data(c.data_to_send())
    assert ev == [h2.PingReceived(b"abcdefgh")]
    ev = c.receive_data(s.data_to_send())
    assert ev == [h2.PingAckReceived(b"abcdefgh")]


def test_rst_stream_both_ways():
    c, s = pair()
    c.send_headers(1, REQUEST)
    s.receive_data(c.data_to_send())
    c.reset_stream(1, h2.ErrorCode.CANCEL)
    ev = s.receive_data(c.data_to_send())
    assert ev == [h2.StreamReset(1, h2.ErrorCode.CANCEL, remote=True)]
    # the server's late frames on it are dropped by the client
    assert not s.streams
    c.send_headers(3, REQUEST)
    s.receive_data(c.data_to_send())
    s.reset_stream(3, h2.ErrorCode.REFUSED_STREAM)
    ev = c.receive_data(s.data_to_send())
    assert ev == [h2.StreamReset(3, h2.ErrorCode.REFUSED_STREAM)]


def test_goaway_names_the_last_stream():
    c, s = pair()
    c.send_headers(1, REQUEST, end_stream=True)
    s.receive_data(c.data_to_send())
    s.close_connection(h2.ErrorCode.NO_ERROR)
    c.send_headers(3, REQUEST, end_stream=True)  # crosses the GOAWAY
    # the server drops the stream it never took
    assert s.receive_data(c.data_to_send()) == []
    ev = c.receive_data(s.data_to_send())
    assert ev == [h2.ConnectionTerminated(0, 1, b"")]
    assert not c.can_open_stream()


@pytest.mark.parametrize("window,size", [(1, 3000), (16384, 100000)])
def test_flow_control_never_passes_the_window(window, size):
    """The client announces a stream window of ``window`` bytes: the
    server sends a body of ``size`` bytes only as WINDOW_UPDATEs let it,
    and the client gets it whole and in order."""
    c, s = pair(client_settings={h2.Setting.INITIAL_WINDOW_SIZE: window},
                window=1 << 20)
    c.send_headers(1, REQUEST, end_stream=True)
    s.receive_data(c.data_to_send())
    s.send_headers(1, [(":status", "200")])
    c.receive_data(s.data_to_send())
    body = (bytes(range(256)) * (size // 256 + 1))[:size]
    got = bytearray()
    pos = rounds = 0
    while pos < len(body):
        avail = s.local_flow_window(1)
        assert 0 < avail <= window
        if len(body) - pos > avail:
            with pytest.raises(h2.FlowControlBlocked):
                s.send_data(1, body[pos:pos + avail + 1])
        n = min(avail, len(body) - pos)
        s.send_data(1, body[pos:pos + n])
        pos += n
        assert s.local_flow_window(1) == avail - n
        for ev in c.receive_data(s.data_to_send()):
            if isinstance(ev, h2.DataReceived):
                got += ev.data
                c.acknowledge_received_data(ev.flow_controlled_length, 1)
        s.receive_data(c.data_to_send())  # the WINDOW_UPDATEs
        rounds += 1
    assert bytes(got) == body
    assert rounds >= len(body) // window


def test_initial_window_change_moves_open_streams():
    c, s = pair()
    c.send_headers(1, REQUEST)
    s.receive_data(c.data_to_send())
    s.send_headers(1, [(":status", "200")])
    s.send_data(1, b"x" * 1000)
    c.receive_data(s.data_to_send())
    assert s.streams[1].send_window == h2.DEFAULT_WINDOW - 1000
    c.update_settings({h2.Setting.INITIAL_WINDOW_SIZE: 1 << 20})
    s.receive_data(c.data_to_send())
    assert s.streams[1].send_window == (1 << 20) - 1000
    c.update_settings({h2.Setting.INITIAL_WINDOW_SIZE: 100})
    s.receive_data(c.data_to_send())
    assert s.streams[1].send_window == 100 - 1000  # negative: wait
    assert s.local_flow_window(1) == 0


def test_unconsumed_data_of_a_reset_stream_returns_to_the_connection():
    c, s = pair(window=h2.DEFAULT_WINDOW)
    for sid in (1, 3):
        c.send_headers(sid, REQUEST)
    c.send_data(1, b"x" * 60000)
    s.receive_data(c.data_to_send())
    assert s.recv_window == h2.DEFAULT_WINDOW - 60000
    c.reset_stream(1, h2.ErrorCode.CANCEL)  # never consumed by the server
    s.receive_data(c.data_to_send())
    c.receive_data(s.data_to_send())  # the connection's WINDOW_UPDATE
    assert c.send_window == h2.DEFAULT_WINDOW
    c.send_data(3, b"y" * 60000)  # the connection is not starved


# each connection error: (bytes after the handshake, the code)
def _bad_block():
    return frame(h2.HEADERS, h2.END_HEADERS, 1, b"\x80")  # index 0


CONNECTION_ERRORS = {
    "data_on_stream_0": (frame(h2.DATA, 0, 0, b"x"),
                         h2.ErrorCode.PROTOCOL_ERROR),
    "headers_on_even_stream": (frame(h2.HEADERS, h2.END_HEADERS, 2,
                                     b"\x83"), h2.ErrorCode.PROTOCOL_ERROR),
    "data_on_idle_stream": (frame(h2.DATA, 0, 5, b"x"),
                            h2.ErrorCode.PROTOCOL_ERROR),
    "window_update_on_idle_stream": (
        frame(h2.WINDOW_UPDATE, 0, 7, struct.pack(">I", 1)),
        h2.ErrorCode.PROTOCOL_ERROR),
    "rst_on_idle_stream": (frame(h2.RST_STREAM, 0, 9, struct.pack(">I", 8)),
                           h2.ErrorCode.PROTOCOL_ERROR),
    "rst_on_stream_0": (frame(h2.RST_STREAM, 0, 0, struct.pack(">I", 8)),
                        h2.ErrorCode.PROTOCOL_ERROR),
    "frame_over_max_size": (frame(h2.DATA, 0, 1, b"x" * 16385),
                            h2.ErrorCode.FRAME_SIZE_ERROR),
    "settings_length": (frame(h2.SETTINGS, 0, 0, b"\0" * 5),
                        h2.ErrorCode.FRAME_SIZE_ERROR),
    "settings_ack_payload": (frame(h2.SETTINGS, h2.ACK, 0, b"\0" * 6),
                             h2.ErrorCode.FRAME_SIZE_ERROR),
    "settings_on_stream": (frame(h2.SETTINGS, 0, 1),
                           h2.ErrorCode.PROTOCOL_ERROR),
    "ping_length": (frame(h2.PING, 0, 0, b"\0" * 7),
                    h2.ErrorCode.FRAME_SIZE_ERROR),
    "ping_on_stream": (frame(h2.PING, 0, 1, b"\0" * 8),
                       h2.ErrorCode.PROTOCOL_ERROR),
    "rst_length": (frame(h2.RST_STREAM, 0, 1, b"\0" * 3),
                   h2.ErrorCode.FRAME_SIZE_ERROR),
    "window_update_length": (frame(h2.WINDOW_UPDATE, 0, 0, b"\0" * 3),
                             h2.ErrorCode.FRAME_SIZE_ERROR),
    "window_update_zero": (frame(h2.WINDOW_UPDATE, 0, 0, b"\0" * 4),
                           h2.ErrorCode.PROTOCOL_ERROR),
    "connection_window_overflow": (
        frame(h2.WINDOW_UPDATE, 0, 0, struct.pack(">I", 2 ** 31 - 1)),
        h2.ErrorCode.FLOW_CONTROL_ERROR),
    "initial_window_too_large": (
        frame(h2.SETTINGS, 0, 0, struct.pack(">HI", 4, 2 ** 31)),
        h2.ErrorCode.FLOW_CONTROL_ERROR),
    "enable_push_not_boolean": (
        frame(h2.SETTINGS, 0, 0, struct.pack(">HI", 2, 2)),
        h2.ErrorCode.PROTOCOL_ERROR),
    "max_frame_size_out_of_range": (
        frame(h2.SETTINGS, 0, 0, struct.pack(">HI", 5, 100)),
        h2.ErrorCode.PROTOCOL_ERROR),
    "push_promise": (frame(h2.PUSH_PROMISE, h2.END_HEADERS, 1,
                           b"\0\0\0\2\x82"), h2.ErrorCode.PROTOCOL_ERROR),
    "continuation_without_headers": (
        frame(h2.CONTINUATION, h2.END_HEADERS, 1, b"\x82"),
        h2.ErrorCode.PROTOCOL_ERROR),
    "frame_inside_a_header_block": (
        frame(h2.HEADERS, 0, 1, b"\x83") + frame(h2.PING, 0, 0, b"\0" * 8),
        h2.ErrorCode.PROTOCOL_ERROR),
    "padding_past_the_frame": (frame(h2.DATA, h2.PADDED, 1, b"\x05ab"),
                               h2.ErrorCode.PROTOCOL_ERROR),
    "malformed_header_block": (None, h2.ErrorCode.COMPRESSION_ERROR),
    "goaway_on_stream": (frame(h2.GOAWAY, 0, 1, b"\0" * 8),
                         h2.ErrorCode.PROTOCOL_ERROR),
    "goaway_too_short": (frame(h2.GOAWAY, 0, 0, b"\0" * 7),
                         h2.ErrorCode.FRAME_SIZE_ERROR),
    "data_past_the_connection_window": (
        b"".join(frame(h2.DATA, 0, 1, b"x" * 16384) for _ in range(4))
        + frame(h2.DATA, 0, 1, b"x" * 16), h2.ErrorCode.FLOW_CONTROL_ERROR),
}


@pytest.mark.parametrize("case", sorted(CONNECTION_ERRORS))
def test_connection_errors_send_goaway(case):
    raw, code = CONNECTION_ERRORS[case]
    c, s = pair(server_settings={h2.Setting.INITIAL_WINDOW_SIZE: 1 << 20})
    c.send_headers(1, REQUEST)  # stream 1 open
    s.receive_data(c.data_to_send())
    s.data_to_send()
    if raw is None:
        raw = frame(h2.HEADERS, h2.END_HEADERS, 3, b"\x80")
    with pytest.raises(h2.H2ProtocolError) as e:
        s.receive_data(raw)
    assert e.value.code == code
    goaway = [f for f in parse_frames(s.data_to_send())
              if f[0] == h2.GOAWAY]
    assert len(goaway) == 1
    last, got = struct.unpack(">II", goaway[0][3][:8])
    assert (last, got) == (1, code)
    assert s.receive_data(frame(h2.PING, 0, 0, b"\0" * 8)) == []


@pytest.mark.parametrize("preface", [
    b"GET / HTTP/1.1\r\nHost: x\r\n\r\n",
    h2.PREFACE + frame(h2.PING, 0, 0, b"\0" * 8),  # not SETTINGS first
])
def test_a_bad_start_is_a_protocol_error(preface):
    s = h2.H2Connection(client=False)
    s.initiate()
    with pytest.raises(h2.H2ProtocolError) as e:
        s.receive_data(preface)
    assert e.value.code == h2.ErrorCode.PROTOCOL_ERROR


STREAM_ERRORS = {
    "data_past_the_stream_window": (
        lambda: b"".join(frame(h2.DATA, 0, 1, b"x" * 16384)
                         for _ in range(4)) + frame(h2.DATA, 0, 1, b"x"),
        h2.ErrorCode.FLOW_CONTROL_ERROR),
    "window_update_zero_on_a_stream": (
        lambda: frame(h2.WINDOW_UPDATE, 0, 1, b"\0" * 4),
        h2.ErrorCode.PROTOCOL_ERROR),
    "stream_window_overflow": (
        lambda: frame(h2.WINDOW_UPDATE, 0, 1, struct.pack(">I", 2 ** 31 - 1)),
        h2.ErrorCode.FLOW_CONTROL_ERROR),
    "trailers_without_end_stream": (
        lambda: frame(h2.HEADERS, h2.END_HEADERS, 1,
                      Encoder().encode([("x", "y")])),
        h2.ErrorCode.PROTOCOL_ERROR),
    "priority_length": (lambda: frame(h2.PRIORITY, 0, 1, b"\0" * 4),
                        h2.ErrorCode.FRAME_SIZE_ERROR),
}


@pytest.mark.parametrize("case", sorted(STREAM_ERRORS))
def test_stream_errors_send_rst_stream(case):
    make, code = STREAM_ERRORS[case]
    c, s = pair(window=1 << 20)
    c.send_headers(1, REQUEST)
    s.receive_data(c.data_to_send())
    s.data_to_send()
    ev = s.receive_data(make())
    assert h2.StreamReset(1, code, remote=False) in ev
    rst = [f for f in parse_frames(s.data_to_send())
           if f[0] == h2.RST_STREAM]
    assert rst == [(h2.RST_STREAM, 0, 1, struct.pack(">I", code))]
    # the connection lives on
    c.send_headers(3, REQUEST, end_stream=True)
    assert _kinds(s.receive_data(c.data_to_send())) == [
        "HeadersReceived", "StreamEnded"]


def test_malformed_request_headers_are_a_stream_error():
    c, s = pair()
    # (the encoder writes names in lower case: this block is by hand)
    block = b"\x83\x00\x05Upper\x01x"
    ev = s.receive_data(frame(h2.HEADERS, h2.END_HEADERS, 1, block))
    assert ev == [h2.StreamReset(1, h2.ErrorCode.PROTOCOL_ERROR,
                                 remote=False)]


def test_data_after_the_end_of_a_stream_is_stream_closed():
    c, s = pair()
    c.send_headers(1, REQUEST, end_stream=True)
    s.receive_data(c.data_to_send())
    ev = s.receive_data(frame(h2.DATA, 0, 1, b"late"))
    assert ev == [h2.StreamReset(1, h2.ErrorCode.STREAM_CLOSED,
                                 remote=False)]


def test_max_concurrent_streams_refuses_one_more():
    c, s = pair(server_settings={h2.Setting.MAX_CONCURRENT_STREAMS: 2})
    assert c.peer_settings[h2.Setting.MAX_CONCURRENT_STREAMS] == 2
    for sid in (1, 3):
        c.send_headers(sid, REQUEST)
    assert not c.can_open_stream()
    s.receive_data(c.data_to_send())
    # a client that ignores the limit gets REFUSED_STREAM
    raw = frame(h2.HEADERS, h2.END_HEADERS, 5, c.encoder.encode(REQUEST))
    ev = s.receive_data(raw)
    assert ev == [h2.StreamReset(5, h2.ErrorCode.REFUSED_STREAM,
                                 remote=False)]
