"""The port's model zoo fixtures against the JAX package's, on the CPU.

Both packages' in-process servers serve the 14 fixtures the reference's
examples and clients are written against (and ``simple``, a member of
``ensemble_scale_sum``); ``dense_tpu`` and ``simple_cnn`` serve the
reference's own weights in the port (drawn as the reference draws them,
carried across as numpy).  The port's HTTP and gRPC clients send the same
requests to both servers, and each test holds equal:

* the model metadata and config JSON of every fixture and ``resnet50``
  (the platform and backend aside, ``jax`` against ``pytorch``, and the
  instance kind of ``dense_tpu`` and ``resnet50``: ``KIND_TPU`` in the
  reference, the device's kind in the port);
* every fixture's outputs, exactly -- ``dense_tpu`` (bf16 matmuls) within
  2e-2 of the largest reference output and ``simple_cnn`` (f32) within
  1e-5 of it, since XLA and torch sum in other orders;
* the running sums of interleaved sequences, with int and string
  correlation ids (``simple_dyna_sequence`` seeds a string id from
  ``hash(str(id)) % 1000``, which Python salts per process: both servers
  run in this one);
* statuses and error texts;
* ``identity_bf16``'s bits, through binary HTTP, gRPC and system shared
  memory, equal to the bits sent (NaN payloads, infinities, signed zeros
  and subnormals among them), and its JSON numbers;
* classification strings: the core's ``_classify`` on arrays with ties,
  batched and unbatched, with and without labels, and end to end.

Beside: ``register_all`` registers the reference's 25 models in its
order; ``custom_identity_int32`` sleeps
for its ``execute_delay_ms``.
"""

import json
import time
import urllib.request
import uuid

import ml_dtypes
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from triton_client_tpu.models import zoo as jzoo
from triton_client_tpu.models import vision as jvision
from triton_client_tpu.server import core as jcore
from triton_client_tpu.server.registry import ModelRegistry as JaxRegistry
from triton_client_tpu.server.testing import ServerHarness as JaxHarness
from triton_client_tpu_torch import grpc as tgrpc
from triton_client_tpu_torch import http as thttp
from triton_client_tpu_torch.models import vision as tvision
from triton_client_tpu_torch.models import zoo as tzoo
from triton_client_tpu_torch.server import core as tcore
from triton_client_tpu_torch.server.registry import ModelRegistry
from triton_client_tpu_torch.server.testing import ServerHarness
from triton_client_tpu_torch.utils import InferenceServerException
import triton_client_tpu_torch.utils.shared_memory as tsys

FIXTURES = ["simple_string", "simple_int8", "simple_identity",
            "custom_identity_int32", "identity_fp32", "identity_bf16",
            "simple_sequence", "simple_dyna_sequence", "repeat_int32",
            "square_int32", "dense_tpu", "simple_cnn", "scale_by_two",
            "ensemble_scale_sum"]
PROTOCOLS = ["http", "grpc"]


def _dense_params():
    """``dense_tpu``'s weights as the reference draws them."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    D = tzoo.DENSE_D
    return {"w1": np.asarray(jax.random.normal(k1, (D, 2 * D),
                                               jnp.bfloat16) * 0.05),
            "w2": np.asarray(jax.random.normal(k2, (2 * D, D),
                                               jnp.bfloat16) * 0.05)}


def _cnn_params():
    """``simple_cnn``'s weights as the reference draws them."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    return {"conv_w": np.asarray(jax.random.normal(
                k1, (8, 3, 4, 4), jnp.float32) * 0.1),
            "dense_w": np.asarray(jax.random.normal(
                k2, (8 * 14 * 14, 1000), jnp.float32) * 0.02)}


@pytest.fixture(scope="module")
def servers():
    jreg = JaxRegistry()
    for m in (jzoo.make_simple(), jzoo.make_simple_string(),
              jzoo.make_simple_int8(), jzoo.make_simple_identity(),
              jzoo.make_custom_identity_int32(), jzoo.make_identity_fp32(),
              jzoo.make_identity_bf16(), jzoo.SequenceModel(),
              jzoo.DynaSequenceModel(), jzoo.make_repeat_int32(),
              jzoo.make_square_int32(), jzoo.make_dense_tpu(),
              jzoo.make_simple_cnn(), jzoo.make_scale_by_two(),
              jzoo.make_ensemble_scale_sum(), jvision.make_resnet50()):
        jreg.register_model(m)
    treg = ModelRegistry()
    for m in (tzoo.make_simple(), tzoo.make_simple_string(),
              tzoo.make_simple_int8(), tzoo.make_simple_identity(),
              tzoo.make_custom_identity_int32(), tzoo.make_identity_fp32(),
              tzoo.make_identity_bf16(), tzoo.SequenceModel(),
              tzoo.DynaSequenceModel(), tzoo.make_repeat_int32(),
              tzoo.make_square_int32(),
              tzoo.make_dense_tpu("cpu", params=_dense_params()),
              tzoo.make_simple_cnn(params=_cnn_params()),
              tzoo.make_scale_by_two(), tzoo.make_ensemble_scale_sum(),
              tvision.make_resnet50("cpu")):
        treg.register_model(m)
    with JaxHarness(jreg) as jh, ServerHarness(treg) as th:
        yield th.http_url, jh.http_url


def _client(protocol, url):
    mod = thttp if protocol == "http" else tgrpc
    return mod.InferenceServerClient(url)


def _mod(protocol):
    return thttp if protocol == "http" else tgrpc


def _inputs(mod, arrays):
    out = []
    for name, dt, arr in arrays:
        x = mod.InferInput(name, list(arr.shape), dt)
        x.set_data_from_numpy(arr)
        out.append(x)
    return out


def _send(protocol, url, model, arrays, outputs, class_count=0, **kw):
    """(result, elapsed s) of one request through the port's client."""
    mod = _mod(protocol)
    with _client(protocol, url) as c:
        outs = [mod.InferRequestedOutput(o, class_count=class_count)
                for o in outputs]
        t0 = time.perf_counter()
        res = c.infer(model, _inputs(mod, arrays), outputs=outs, **kw)
        return res, time.perf_counter() - t0


def _error(fn):
    with pytest.raises(InferenceServerException) as e:
        fn()
    return e.value.status(), e.value.message()


# ---------------------------------------------------------------------------
# registration, metadata, config
# ---------------------------------------------------------------------------

def test_register_all_registers_the_reference_models_in_order():
    jreg = JaxRegistry()
    jzoo.register_all(jreg)
    treg = ModelRegistry()
    tzoo.register_all(treg, device="cpu")
    want = list(jreg._models)
    assert [m.name for m in treg.models()] == want
    assert len(want) == 25


def _without(d, *keys):
    return {k: v for k, v in d.items() if k not in keys}


@pytest.mark.parametrize("protocol", PROTOCOLS)
@pytest.mark.parametrize("name", FIXTURES + ["resnet50"])
def test_config_and_metadata_match_reference(servers, name, protocol):
    port, ref = (_client(protocol, u) for u in servers)
    try:
        as_json = {} if protocol == "http" else {"as_json": True}
        t, j = (c.get_model_metadata(name, **as_json) for c in (port, ref))
        assert _without(t, "platform") == _without(j, "platform")
        t, j = (c.get_model_config(name, **as_json) for c in (port, ref))
        if protocol == "grpc":
            t, j = t["config"], j["config"]
        if name in ("dense_tpu", "resnet50"):
            # the device's kind: KIND_TPU in the reference, here the CPU's
            (tg,), (jg,) = t.pop("instance_group"), j.pop("instance_group")
            assert (tg.pop("kind"), jg.pop("kind")) == ("KIND_CPU",
                                                        "KIND_TPU")
            assert tg == jg
        if name == "ensemble_scale_sum":
            assert t == j
        assert _without(t, "platform", "backend") == \
            _without(j, "platform", "backend")
    finally:
        port.close()
        ref.close()


# ---------------------------------------------------------------------------
# outputs
# ---------------------------------------------------------------------------

def _cases():
    rng = np.random.default_rng(80)
    ints = rng.integers(-1000, 1000, (2, 1, 16))
    i8 = rng.integers(-128, 128, (2, 1, 16)).astype(np.int8)
    i8[:, 0, :4] = [[127, -128, 100, -100], [1, -1, 100, -100]]
    ident = np.array([b"abc", b"", b"\xff\x00\xfe", "h\xe9llo".encode(),
                      b"x" * 70, b"0", b"\n", b"zz"],
                     dtype=object).reshape(2, 4)
    return {
        "simple_string": ([
            ("INPUT0", "BYTES", np.array([str(v).encode() for v in
                                          ints[0].ravel()], dtype=object)
             .reshape(1, 16)),
            ("INPUT1", "BYTES", np.array([str(v).encode() for v in
                                          ints[1].ravel()], dtype=object)
             .reshape(1, 16))], ["OUTPUT0", "OUTPUT1"]),
        "simple_int8": ([("INPUT0", "INT8", i8[0]),
                         ("INPUT1", "INT8", i8[1])], ["OUTPUT0", "OUTPUT1"]),
        "simple_identity": ([("INPUT0", "BYTES", ident)], ["OUTPUT0"]),
        "custom_identity_int32": ([("INPUT0", "INT32", rng.integers(
            -2**31, 2**31, (3, 5)).astype(np.int32))], ["OUTPUT0"]),
        "identity_fp32": ([("INPUT0", "FP32", np.array(
            [[np.nan, np.inf, -np.inf, -0.0, 1e-45],
             [1.5, -2.25, 3e38, -7.0, 0.0]], dtype=np.float32))],
            ["OUTPUT0"]),
        "dense_tpu": ([("INPUT", "FP32", rng.normal(
            0, 1, (4, tzoo.DENSE_D)).astype(np.float32))], ["OUTPUT"]),
        "simple_cnn": ([("INPUT", "FP32", rng.random(
            (2, 3, 224, 224)).astype(np.float32))], ["OUTPUT"]),
        "scale_by_two": ([("INPUT", "INT32", ints[0].astype(np.int32))],
                         ["OUTPUT"]),
        "ensemble_scale_sum": ([("RAW0", "INT32", ints[0].astype(np.int32)),
                                ("RAW1", "INT32", ints[1].astype(np.int32))],
                               ["SUM", "DIFF"]),
    }


# the bound of each model whose arithmetic the two packages order
# differently: a share of the largest reference output
CLOSE = {"dense_tpu": 2e-2, "simple_cnn": 1e-5}


@pytest.mark.parametrize("protocol", PROTOCOLS)
@pytest.mark.parametrize("name", sorted(_cases()))
def test_outputs_match_reference(servers, name, protocol):
    arrays, outputs = _cases()[name]
    (t, _), (j, _) = (_send(protocol, u, name, arrays, outputs)
                      for u in servers)
    for o in outputs:
        got, want = t.as_numpy(o), j.as_numpy(o)
        assert got.dtype == want.dtype and got.shape == want.shape, o
        if name in CLOSE:
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err <= CLOSE[name], (o, err)
        else:
            np.testing.assert_array_equal(got, want)
        if protocol == "http":
            assert t.get_output(o) == j.get_output(o)
        else:
            assert t.get_output(o, as_json=True) == \
                j.get_output(o, as_json=True)


def test_outputs_are_the_fixtures_arithmetic(servers):
    """What each fixture computes, not only that both packages agree."""
    cases = _cases()
    res, _ = _send("http", servers[0], "simple_string",
                   *cases["simple_string"])
    a, b = ([int(v) for v in arr.ravel()]
            for _, _, arr in cases["simple_string"][0])
    assert [int(v) for v in res.as_numpy("OUTPUT0").ravel()] == \
        [x + y for x, y in zip(a, b)]
    (_, _, x0), (_, _, x1) = cases["simple_int8"][0]
    res, _ = _send("grpc", servers[0], "simple_int8", *cases["simple_int8"])
    np.testing.assert_array_equal(res.as_numpy("OUTPUT0"), x0 + x1)
    (_, _, r0), (_, _, r1) = cases["ensemble_scale_sum"][0]
    res, _ = _send("http", servers[0], "ensemble_scale_sum",
                   *cases["ensemble_scale_sum"])
    np.testing.assert_array_equal(res.as_numpy("SUM"), 2 * r0 + r1)
    np.testing.assert_array_equal(res.as_numpy("DIFF"), 2 * r0 - r1)


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_execute_delay_ms_is_slept_as_in_reference(servers, protocol):
    x = np.arange(6, dtype=np.int32).reshape(2, 3)
    answers = [_send(protocol, u, "custom_identity_int32",
                     [("INPUT0", "INT32", x)], ["OUTPUT0"],
                     parameters={"execute_delay_ms": 300}) for u in servers]
    for res, elapsed in answers:
        assert elapsed >= 0.3
        np.testing.assert_array_equal(res.as_numpy("OUTPUT0"), x)


# ---------------------------------------------------------------------------
# sequences
# ---------------------------------------------------------------------------

def _run_sequences(protocol, url, model, ids):
    """Two sequences interleaved, start / middle / end: every OUTPUT."""
    steps = [(0, 5, True, False), (1, 7, True, False), (0, -2, False, False),
             (1, 100, False, False), (0, 11, False, True),
             (1, 1, False, True)]
    got = []
    for which, value, start, end in steps:
        res, _ = _send(protocol, url, model,
                       [("INPUT", "INT32", np.array([value], np.int32))],
                       ["OUTPUT"], sequence_id=ids[which],
                       sequence_start=start, sequence_end=end)
        got.append(int(res.as_numpy("OUTPUT")[0]))
    return got


@pytest.mark.parametrize("protocol", PROTOCOLS)
@pytest.mark.parametrize("model,kind", [
    ("simple_sequence", int), ("simple_dyna_sequence", int),
    ("simple_dyna_sequence", str), ("simple_sequence", str)])
def test_sequences_match_reference(servers, model, kind, protocol):
    base = {"http": 1000, "grpc": 2000}[protocol] + (10 if kind is str
                                                     else 0)
    ids = [base + 1, base + 2] if kind is int else \
        [f"seq-{protocol}-{uuid.uuid4().hex[:6]}-{i}" for i in range(2)]
    t, j = (_run_sequences(protocol, u, model, ids) for u in servers)
    assert t == j
    if model == "simple_sequence":
        assert t == [5, 7, 3, 107, 14, 108]


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_sequence_errors_match_reference(servers, protocol):
    x = [("INPUT", "INT32", np.array([1], np.int32))]
    for model in ("simple_sequence", "simple_dyna_sequence"):
        t, j = (_error(lambda u=u: _send(protocol, u, model, x, ["OUTPUT"]))
                for u in servers)
        assert t == j and "correlation ID" in t[1]
    bad = [("INPUT", "FP32", np.array([1.0], np.float32))]
    t, j = (_error(lambda u=u: _send(protocol, u, "simple_sequence", bad,
                                     ["OUTPUT"], sequence_id=5))
            for u in servers)
    assert t == j


# ---------------------------------------------------------------------------
# BF16, bit for bit
# ---------------------------------------------------------------------------

def _bf16_bits():
    specials = [0x0000, 0x8000, 0x7F80, 0xFF80, 0x7FC1, 0xFFA5, 0x0001,
                0x8001, 0x007F, 0x3F80, 0xBF80, 0x7F7F]
    rnd = np.random.default_rng(81).integers(0, 2**16, 20)
    return np.array(specials + list(rnd), dtype=np.uint16).reshape(2, 16)


def _bf16_over_shm(url, bits):
    """identity_bf16 with its input and output in system shm regions (the
    port's client): the output region's bits."""
    n = bits.nbytes
    with thttp.InferenceServerClient(url) as c:
        handles = []
        try:
            for name in ("bf_in", "bf_out"):
                key = f"/tctzoo_{uuid.uuid4().hex[:10]}"
                handles.append(tsys.create_shared_memory_region(name, key,
                                                                n))
                c.register_system_shared_memory(name, key, n)
            tsys.set_shared_memory_region(handles[0], [bits])
            inp = thttp.InferInput("INPUT0", list(bits.shape), "BF16")
            inp.set_shared_memory("bf_in", n)
            out = thttp.InferRequestedOutput("OUTPUT0")
            out.set_shared_memory("bf_out", n)
            res = c.infer("identity_bf16", [inp], outputs=[out])
            assert res.get_output("OUTPUT0")["datatype"] == "BF16"
            got = np.array(tsys.get_contents_as_numpy(
                handles[1], np.uint16, list(bits.shape)))
            c.unregister_system_shared_memory()
            return got
        finally:
            for h in handles:
                tsys.destroy_shared_memory_region(h)


@pytest.mark.parametrize("transport", ["http", "grpc", "system_shm"])
def test_identity_bf16_round_trip_is_bit_equal(servers, transport):
    bits = _bf16_bits()
    for url in servers:
        if transport == "system_shm":
            got = _bf16_over_shm(url, bits)
        else:
            res, _ = _send(transport, url, "identity_bf16", [
                ("INPUT0", "BF16", bits.view(ml_dtypes.bfloat16))],
                ["OUTPUT0"])
            out = res.as_numpy("OUTPUT0")
            assert out.dtype == ml_dtypes.bfloat16
            got = out.view(np.uint16)
        np.testing.assert_array_equal(got, bits)


def test_identity_bf16_json_matches_reference(servers):
    """BF16 as JSON numbers both ways (a raw request: the clients send
    BF16 binary only), values bf16 holds exactly."""
    values = [0.0, -0.0, 1.5, -2.25, 3.0e38, 9.183549615799121e-41, 1e-3]
    exact = np.array(values, np.float32).astype(ml_dtypes.bfloat16)
    body = json.dumps({
        "inputs": [{"name": "INPUT0", "datatype": "BF16", "shape": [1, 7],
                    "data": exact.astype(np.float64).tolist()}],
        "outputs": [{"name": "OUTPUT0",
                     "parameters": {"binary_data": False}}]}).encode()
    got = []
    for url in servers:
        req = urllib.request.Request(
            f"http://{url}/v2/models/identity_bf16/infer", data=body)
        with urllib.request.urlopen(req) as r:
            got.append(json.loads(r.read())["outputs"])
    assert got[0] == got[1]
    assert got[0][0]["data"] == exact.astype(np.float64).tolist()


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------

class _Labelled:
    def __init__(self, labels):
        self._labels = labels

    def labels(self, name):
        return self._labels


def _classify_cases():
    rng = np.random.default_rng(82)
    ties = np.array([1.0, 3.0, 3.0, 0.0, 3.0, -1.0, 3.0, 0.5], np.float32)
    wide = np.zeros((3, 100), np.float32)
    wide[1, ::7] = 2.0
    wide[2] = rng.integers(0, 3, 100)
    return {
        "unbatched ties": (ties, 4, None),
        "unbatched k over width": (ties, 20, [f"l{i}" for i in range(8)]),
        "batched ties, labels": (wide, 5, [f"c{i}" for i in range(100)]),
        "batched, short labels": (wide, 9, ["a", "b", "c"]),
        "batched random": (rng.normal(0, 1, (4, 30)).astype(np.float32), 3,
                           None),
        "float64 rows": (rng.normal(0, 1e3, (2, 12)), 6, None),
    }


@pytest.mark.parametrize("case", sorted(_classify_cases()))
def test_classify_matches_reference(case):
    arr, k, labels = _classify_cases()[case]
    model = _Labelled(labels)
    got = tcore.InferenceCore._classify(model, "OUT", arr, k)
    want = jcore.InferenceCore._classify(None, model, "OUT", arr, k)
    assert got.dtype == want.dtype == np.object_
    assert got.shape == want.shape
    assert got.tolist() == want.tolist()


@pytest.mark.parametrize("protocol", PROTOCOLS)
@pytest.mark.parametrize("model", ["identity_fp32", "simple_cnn"])
def test_classification_outputs_match_reference(servers, model, protocol):
    """End to end: identity_fp32 (no labels) on rows with ties, and
    simple_cnn (labels) on a black image, whose 1000 logits all tie at
    0: the strings, their shape and BYTES type equal the reference's."""
    if model == "identity_fp32":
        x = np.array([[2.0, 5.0, 5.0, -1.0, 5.0, 0.0],
                      [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]], np.float32)
        name, k = "INPUT0", 4
        out = "OUTPUT0"
    else:
        x = np.zeros((1, 3, 224, 224), np.float32)
        name, k = "INPUT", 3
        out = "OUTPUT"
    (t, _), (j, _) = (_send(protocol, u, model, [(name, "FP32", x)], [out],
                            class_count=k) for u in servers)
    got, want = t.as_numpy(out), j.as_numpy(out)
    assert got.dtype == want.dtype == np.object_
    assert got.shape == want.shape == (x.shape[0], k)
    assert got.tolist() == want.tolist()
    if model == "simple_cnn":
        assert all(s.decode().split(":")[2].startswith("class_")
                   for s in got.ravel())
