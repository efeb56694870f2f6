"""The port's shared-memory data path against the JAX package's, on the CPU.

* System shm: ``triton_client_tpu_torch.utils.shared_memory`` against
  ``triton_client_tpu.utils.shared_memory`` -- the same contents, error
  codes and accounting, and each package attaches the other's regions by key
  (both map ``/dev/shm/<key>``).
* CUDA shm with ``device="cpu"``: ``triton_client_tpu_torch.utils.
  cuda_shared_memory`` against ``triton_client_tpu.utils.xla_shared_memory``
  on JAX's CPU device.
* End to end, as ``tests/test_xla_shared_memory.py``'s ``test_cudashm_flow``:
  the reference's HTTP client registers regions with the port's server and
  with the reference's, sends shm inputs, reads shm outputs, then status and
  unregister, for ``simple`` and the tiny ``longctx_tpu`` (the reference's
  seed-11 weights carried to the port as numpy arrays).  ``simple`` is held
  exactly; LOGPROBS to 5e-2 of the reference (the bf16 logit bound of
  test_torch_transformer.py, as test_torch_serving.py holds it) and equal to
  the port's own forward on the same tokens.  Status JSON and error texts
  are held equal to the reference server's.
"""

import json
import os
import urllib.error
import urllib.request
import uuid

import ml_dtypes
import numpy as np
import pytest
import torch

import jax

import triton_client_tpu.utils.shared_memory as jsys
import triton_client_tpu.utils.xla_shared_memory as jcuda
from triton_client_tpu import http as httpclient
from triton_client_tpu.models import language as jlang
from triton_client_tpu.models import transformer as jtr
from triton_client_tpu.models import zoo as jzoo
from triton_client_tpu.server.registry import ModelRegistry as JaxRegistry
from triton_client_tpu.server.testing import ServerHarness as JaxHarness
from triton_client_tpu.utils import serialize_byte_tensor
from triton_client_tpu_torch._cuda_broker import broker
from triton_client_tpu_torch.models import language as tlang
from triton_client_tpu_torch.models import zoo as tzoo
from triton_client_tpu_torch.server import core as tcore
from triton_client_tpu_torch.server.model import TorchModel, make_config
from triton_client_tpu_torch.server.registry import ModelRegistry
from triton_client_tpu_torch.server.testing import ServerHarness
from triton_client_tpu_torch.utils import typed_view
import triton_client_tpu_torch.utils.cuda_shared_memory as tcuda
import triton_client_tpu_torch.utils.shared_memory as tsys

S = 512  # the tiny longctx_tpu preset's window


def _key():
    return f"/tctshm_{uuid.uuid4().hex[:12]}"


@pytest.fixture(autouse=True)
def _no_leaks():
    before = (set(tsys.mapped_shared_memory_regions()),
              set(tcuda.allocated_shared_memory_regions()))
    yield
    assert set(tsys.mapped_shared_memory_regions()) == before[0]
    assert set(tcuda.allocated_shared_memory_regions()) == before[1]
    assert jcuda.allocated_shared_memory_regions() == []


# ---------------------------------------------------------------------------
# system shm API
# ---------------------------------------------------------------------------

_VALUES = {
    "int32": np.arange(-6, 6, dtype=np.int32).reshape(3, 4),
    "bf16": np.linspace(-2, 2, 10).astype(ml_dtypes.bfloat16).reshape(2, 5),
    "bytes": np.array([[b"hello", b""], [b"\x80\xff", b"tpu-shm"]],
                      dtype=np.object_),
}


def _nbytes(value):
    if value.dtype == np.object_:
        return serialize_byte_tensor(value).nbytes
    return value.nbytes


@pytest.mark.parametrize("kind", sorted(_VALUES))
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_system_shm_round_trip_across_packages(kind, writer):
    value = _VALUES[kind]
    key, size = _key(), _nbytes(value) + 8
    make, other = (tsys, jsys) if writer == "port" else (jsys, tsys)
    h = make.create_shared_memory_region("rt", key, size)
    a = other.attach_shared_memory_region("rt", key, size)
    try:
        make.set_shared_memory_region(h, [value])
        for mod, handle in ((make, h), (other, a)):
            got = mod.get_contents_as_numpy(handle, value.dtype, value.shape)
            assert got.dtype == value.dtype
            np.testing.assert_array_equal(got, value)
        # and back: the attaching package writes at an offset
        other.set_shared_memory_region(a, [np.array([7, 9], np.uint32)],
                                       offset=size - 8)
        for mod, handle in ((make, h), (other, a)):
            np.testing.assert_array_equal(mod.get_contents_as_numpy(
                handle, np.uint32, [2], offset=size - 8), [7, 9])
    finally:
        other.destroy_shared_memory_region(a)
        make.destroy_shared_memory_region(h)
    assert not os.path.exists("/dev/shm/" + key[1:])


def test_system_shm_offset_writes_match_jax():
    got = {}
    for name, mod in (("port", tsys), ("jax", jsys)):
        h = mod.create_shared_memory_region("off", _key(), 64)
        try:
            mod.set_shared_memory_region(h, [np.arange(8, dtype=np.int32)])
            mod.set_shared_memory_region(
                h, [np.array([100, 101], np.int32),
                    np.array([1.5], np.float32)], offset=8)
            got[name] = np.array(mod.get_contents_as_numpy(h, np.uint8,
                                                           [64]))
        finally:
            mod.destroy_shared_memory_region(h)
    np.testing.assert_array_equal(got["port"], got["jax"])
    assert got["port"][:32].view(np.int32).tolist() == [
        0, 1, 100, 101, int(np.float32(1.5).view(np.int32)), 5, 6, 7]


def _err(fn):
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value).__name__, e.value.err, str(e.value)


@pytest.mark.parametrize("case", [
    "set_past_end", "set_negative_offset", "get_past_end",
    "get_negative_offset", "zero_size", "attach_missing", "create_only"])
def test_system_shm_errors_match_jax(case):
    def run(mod):
        key = _key()
        h = mod.create_shared_memory_region("err", key, 16)
        try:
            return _err({
                "set_past_end": lambda: mod.set_shared_memory_region(
                    h, [np.zeros(5, np.int32)]),
                "set_negative_offset": lambda: mod.set_shared_memory_region(
                    h, [np.zeros(1, np.int32)], offset=-4),
                "get_past_end": lambda: mod.get_contents_as_numpy(
                    h, np.int32, [2], offset=12),
                "get_negative_offset": lambda: mod.get_contents_as_numpy(
                    h, np.int32, [1], offset=-1),
                "zero_size": lambda: mod.create_shared_memory_region(
                    "z", _key(), 0),
                "attach_missing": lambda: mod.attach_shared_memory_region(
                    "m", _key(), 16),
                "create_only": lambda: mod.create_shared_memory_region(
                    "c", key, 16, create_only=True),
            }[case])
        finally:
            mod.destroy_shared_memory_region(h)

    assert run(tsys) == run(jsys)


def test_system_shm_accounting_and_tensor_view():
    key = _key()
    h = tsys.create_shared_memory_region("acct", key, 32)
    try:
        assert key in tsys.mapped_shared_memory_regions()
        tsys.set_shared_memory_region(h, [np.arange(8, dtype=np.int32)])
        t = tsys.as_shared_memory_tensor(h, "INT32", [2, 2], offset=8)
        assert t.tolist() == [[2, 3], [4, 5]]
        t[0, 0] = 42  # a view: the write lands in the region
        assert tsys.get_contents_as_numpy(h, np.int32, [8])[2] == 42
        # a framework takes it through DLPack, without a copy
        assert torch.from_dlpack(t).data_ptr() == t.data_ptr()
        bf = tsys.as_shared_memory_tensor(h, "BF16", [4])
        assert bf.dtype == torch.bfloat16
    finally:
        tsys.destroy_shared_memory_region(h)
    assert key not in tsys.mapped_shared_memory_regions()
    assert not os.path.exists("/dev/shm/" + key[1:])
    # the view outlives the region's handle: still mapped, still readable
    assert t.tolist() == [[42, 3], [4, 5]]


# ---------------------------------------------------------------------------
# CUDA shm API, device="cpu", against xla_shared_memory on JAX's CPU device
# ---------------------------------------------------------------------------

def _tcreate(name, size):
    return tcuda.create_shared_memory_region(name, size, 0, device="cpu")


def _both(name, size):
    return ((tcuda, _tcreate(name, size)),
            (jcuda, jcuda.create_shared_memory_region(name, size, 0)))


@pytest.mark.parametrize("value", [
    np.arange(12, dtype=np.int32).reshape(3, 4),
    np.linspace(-1, 1, 6).astype(np.float32),
    np.array([b"hello", b"", b"tpu-shm"], dtype=np.object_),
], ids=["int32", "fp32", "bytes"])
def test_cuda_shm_set_get_matches_jax(value):
    for mod, h in _both("setget", _nbytes(value)):
        try:
            mod.set_shared_memory_region(h, [value])
            got = mod.get_contents_as_numpy(h, value.dtype, value.shape)
            np.testing.assert_array_equal(got, value)
        finally:
            mod.destroy_shared_memory_region(h)


def test_cuda_shm_offset_write_keeps_earlier_bytes():
    # mirrors tests/test_xla_shared_memory.py:99 in both packages
    first = np.arange(8, dtype=np.int32)
    second = np.arange(100, 104, dtype=np.int32)
    for mod, h in _both("off_region", 64):
        try:
            mod.set_shared_memory_region(h, [first])
            mod.set_shared_memory_region(h, [second], offset=first.nbytes)
            np.testing.assert_array_equal(
                mod.get_contents_as_numpy(h, np.int32, [8]), first)
            np.testing.assert_array_equal(mod.get_contents_as_numpy(
                h, np.int32, [4], offset=first.nbytes), second)
        finally:
            mod.destroy_shared_memory_region(h)


@pytest.mark.parametrize("case", ["too_small", "invalid_device",
                                  "not_a_list", "zero_size"])
def test_cuda_shm_errors_match_jax(case):
    for mod, make in ((tcuda, lambda n, s, d: tcuda.create_shared_memory_region(
            n, s, d, device="cpu")), (jcuda, jcuda.create_shared_memory_region)):
        if case == "invalid_device":
            with pytest.raises(mod.CudaSharedMemoryException, match="device"):
                make("bad_dev", 64, 99)
            continue
        if case == "zero_size":
            with pytest.raises(mod.CudaSharedMemoryException,
                               match="byte_size must be positive"):
                make("zero", 0, 0)
            continue
        h = make("err", 16, 0)
        try:
            if case == "too_small":
                with pytest.raises(mod.CudaSharedMemoryException,
                                   match="byte_size 16 is too small for 20"):
                    mod.set_shared_memory_region(h, [np.zeros(5, np.int32)])
            else:
                with pytest.raises(mod.CudaSharedMemoryException,
                                   match="must be a list"):
                    mod.set_shared_memory_region(h, np.zeros(2, np.int32))
        finally:
            mod.destroy_shared_memory_region(h)


def test_cuda_shm_dlpack_ingest_and_zero_copy_view():
    src = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    for mod, h in _both("dlpack", src.numel() * 4):
        try:
            mod.set_shared_memory_region_from_dlpack(h, [src.numpy()])
            np.testing.assert_array_equal(
                mod.get_contents_as_numpy(h, np.float32, [3, 4]), src.numpy())
            with pytest.raises(mod.CudaSharedMemoryException,
                               match="contiguous"):
                mod.set_shared_memory_region_from_dlpack(h, [src.numpy().T])
        finally:
            mod.destroy_shared_memory_region(h)
    h = _tcreate("dlpack_torch", 64)
    try:
        tcuda.set_shared_memory_region_from_dlpack(h, [src])
        view = tcuda.as_shared_memory_tensor(h, "FP32", [3, 4])
        assert torch.equal(view, src)
        assert view.data_ptr() == h.tensor.data_ptr()  # a view, no copy
        at8 = tcuda.as_shared_memory_tensor(h, "FP32", [2], offset=8)
        assert at8.data_ptr() == h.tensor.data_ptr() + 8
        # an offset that is not a multiple of the item size copies
        odd = tcuda.as_shared_memory_tensor(h, "INT16", [2], offset=3)
        assert odd.data_ptr() != h.tensor.data_ptr() + 3
        assert odd.numpy().tobytes() == h.tensor[3:7].numpy().tobytes()
        with pytest.raises(tcuda.CudaSharedMemoryException,
                           match="run past the region"):
            tcuda.as_shared_memory_tensor(h, "FP32", [16], offset=4)
        with pytest.raises(tcuda.CudaSharedMemoryException,
                           match="does not support DLPack"):
            tcuda.set_shared_memory_region_from_dlpack(h, [object()])
    finally:
        tcuda.destroy_shared_memory_region(h)


def test_cuda_shm_leak_accounting_and_raw_handle():
    before = len(jcuda.allocated_shared_memory_regions())
    pairs = _both("leak", 32)
    names = [mod.allocated_shared_memory_regions() for mod, _ in pairs]
    assert names[0] == names[1][before:] == ["leak"]
    (_, th), _ = pairs
    desc = json.loads(tcuda.get_raw_handle(th))
    # a host region: its uuid and nothing to map from another process
    assert set(desc) == {"uuid", "device_id", "byte_size"}
    assert broker().lookup(desc["uuid"]).tensor.data_ptr() == \
        th.tensor.data_ptr()
    for mod, h in pairs:
        mod.destroy_shared_memory_region(h)
        mod.destroy_shared_memory_region(h)  # twice is harmless
    assert broker().lookup(desc["uuid"]) is None
    with pytest.raises(tcuda.CudaSharedMemoryException, match="destroyed"):
        tcuda.get_contents_as_numpy(th, np.int32, [1])


def test_typed_view_is_a_view_where_aligned():
    region = torch.arange(32, dtype=torch.uint8)
    v = typed_view(region, torch.int32, [2, 2], 4)
    assert v.data_ptr() == region.data_ptr() + 4
    assert v.flatten().tolist() == region[4:20].view(torch.int32).tolist()
    c = typed_view(region, torch.int32, [1], 5)
    assert c.data_ptr() != region.data_ptr() + 5
    assert c.numpy().tobytes() == region[5:9].numpy().tobytes()
    with pytest.raises(ValueError):
        typed_view(region, torch.int32, [8], 4)


# ---------------------------------------------------------------------------
# end to end: the reference's HTTP client against both servers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def servers():
    jreg = JaxRegistry()
    jreg.register_model(jzoo.make_simple())
    jreg.register_model(jlang.make_longctx_tpu())
    cfg = jlang.longctx_cfg()
    np_params = {k: np.asarray(v) for k, v in
                 jtr.init_params(jax.random.PRNGKey(11), cfg).items()}
    treg = ModelRegistry()
    treg.register_model(tzoo.make_simple())
    treg.register_model(tlang.make_longctx_tpu("cpu", params=np_params))
    with JaxHarness(jreg) as jh, ServerHarness(treg) as th:
        yield jh, th


class _Regions:
    """Regions of one package and kind, registered with one server."""

    def __init__(self, client, package, kind):
        self.client, self.package, self.kind = client, package, kind
        self.handles = {}

    def make(self, name, size):
        if self.kind == "system":
            mod = tsys if self.package == "port" else jsys
            key = _key()
            h = mod.create_shared_memory_region(name, key, size)
            self.client.register_system_shared_memory(name, key, size)
        else:
            mod = tcuda if self.package == "port" else jcuda
            h = (_tcreate(name, size) if self.package == "port"
                 else jcuda.create_shared_memory_region(name, size, 0))
            self.client.register_cuda_shared_memory(
                name, mod.get_raw_handle(h), 0, size)
        self.handles[name] = (mod, h)
        return h

    def set(self, name, value):
        mod, h = self.handles[name]
        mod.set_shared_memory_region(h, [value])

    def get(self, name, dtype, shape):
        mod, h = self.handles[name]
        return np.array(mod.get_contents_as_numpy(h, dtype, shape))

    def status(self):
        return (self.client.get_system_shared_memory_status()
                if self.kind == "system"
                else self.client.get_cuda_shared_memory_status())

    def unregister(self):
        if self.kind == "system":
            self.client.unregister_system_shared_memory()
        else:
            self.client.unregister_cuda_shared_memory()

    def destroy(self):
        for mod, h in self.handles.values():
            mod.destroy_shared_memory_region(h)


def _shm_flow(url, package, kind, model, inputs, outputs):
    """register -> shm inputs -> infer -> shm outputs -> status ->
    unregister.  ``inputs``: {name: array}; ``outputs``: {name: (dtype,
    shape)}.  Returns (outputs, response JSON, status before and after
    unregister)."""
    client = httpclient.InferenceServerClient(url)
    regions = _Regions(client, package, kind)
    try:
        ins, outs = [], []
        for name, arr in inputs.items():
            regions.make("in_" + name, arr.nbytes)
            regions.set("in_" + name, arr)
            inp = httpclient.InferInput(name, list(arr.shape), "INT32")
            inp.set_shared_memory("in_" + name, arr.nbytes)
            ins.append(inp)
        for name, (dtype, shape) in outputs.items():
            nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
            regions.make("out_" + name, nbytes)
            out = httpclient.InferRequestedOutput(name)
            out.set_shared_memory("out_" + name, nbytes)
            outs.append(out)
        result = client.infer(model, ins, outputs=outs)
        got = {name: regions.get("out_" + name, dtype, shape)
               for name, (dtype, shape) in outputs.items()}
        before = regions.status()
        regions.unregister()
        after = regions.status()
        return got, result.get_response(), before, after
    finally:
        regions.destroy()
        client.close()


def _outputs_json(response):
    """The response without its top-level parameters (the reference adds a
    generated request id there, a tracing feature the port lacks)."""
    return {k: v for k, v in response.items() if k != "parameters"}


@pytest.mark.parametrize("kind", ["system", "cuda"])
def test_simple_over_shm_matches_jax_server(servers, kind):
    jh, th = servers
    rng = np.random.default_rng(8)
    a = rng.integers(-1000, 1000, (1, 16)).astype(np.int32)
    b = rng.integers(-1000, 1000, (1, 16)).astype(np.int32)
    io = ({"INPUT0": a, "INPUT1": b},
          {"OUTPUT0": (np.int32, [1, 16]), "OUTPUT1": (np.int32, [1, 16])})
    t = _shm_flow(th.http_url, "port", kind, "simple", *io)
    j = _shm_flow(jh.http_url, "jax", kind, "simple", *io)
    for name in ("OUTPUT0", "OUTPUT1"):
        np.testing.assert_array_equal(t[0][name], j[0][name])
    np.testing.assert_array_equal(t[0]["OUTPUT0"], a + b)
    np.testing.assert_array_equal(t[0]["OUTPUT1"], a - b)
    # the response JSON: shm parameters, no data
    assert _outputs_json(t[1]) == _outputs_json(j[1])
    if kind == "system":  # keys are per package; the rest must agree
        for status in (t[2], j[2]):
            for r in status:
                r["key"] = "k"
    assert sorted(t[2], key=lambda r: r["name"]) == \
        sorted(j[2], key=lambda r: r["name"])
    assert t[3] == j[3] == []


@pytest.mark.parametrize("kind", ["system", "cuda"])
def test_longctx_over_shm_matches_jax_and_own_forward(servers, kind):
    jh, th = servers
    tokens = np.random.default_rng(9).integers(0, 256, (2, S)).astype(
        np.int32)
    io = ({"TOKENS": tokens}, {"LOGPROBS": (np.float32, [2, S])})
    got = _shm_flow(th.http_url, "port", kind, "longctx_tpu", *io)
    want = _shm_flow(jh.http_url, "jax", kind, "longctx_tpu", *io)
    got_lp, want_lp = got[0]["LOGPROBS"], want[0]["LOGPROBS"]
    assert np.isfinite(got_lp).all() and (got_lp[:, -1] == 0).all()
    np.testing.assert_allclose(got_lp, want_lp, rtol=0, atol=5e-2)
    assert _outputs_json(got[1]) == _outputs_json(want[1])
    model = th.registry.get("longctx_tpu")
    with torch.inference_mode():
        t = torch.from_numpy(tokens)
        own = tlang.longctx_scores(model.transformer(t), t)
    assert torch.equal(torch.from_numpy(got_lp), own)


def _call(url, method, path, body=None):
    data = None if body is None else (
        body if isinstance(body, bytes) else json.dumps(body).encode())
    req = urllib.request.Request(f"http://{url}{path}", data=data,
                                 method=method)
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


_BAD_REGISTRATIONS = {
    "missing_key": ("systemsharedmemory", {"byte_size": 64}),
    "no_such_key": ("systemsharedmemory",
                    {"key": "/tctshm_no_such_key", "byte_size": 64}),
    "missing_handle": ("cudasharedmemory", {"byte_size": 64}),
    "handle_not_object": ("cudasharedmemory",
                          {"raw_handle": "abc", "byte_size": 64}),
    "handle_not_base64": ("cudasharedmemory",
                          {"raw_handle": {"b64": "***"}, "byte_size": 64}),
    "handle_not_json": ("cudasharedmemory",
                        {"raw_handle": {"b64": "bm90IGpzb24="},
                         "byte_size": 64}),
    "unknown_uuid": ("cudasharedmemory", {"raw_handle": {
        "b64": "eyJ1dWlkIjogIm5vcGUifQ=="}, "byte_size": 64}),
    "not_json": ("systemsharedmemory", b"{"),
}


@pytest.mark.parametrize("case", sorted(_BAD_REGISTRATIONS))
def test_bad_registration_errors_match_jax(servers, case):
    kind, body = _BAD_REGISTRATIONS[case]
    path = f"/v2/{kind}/region/bad/register"
    t, j = (_call(h.http_url, "POST", path, body) for h in servers[::-1])
    assert t[0] == j[0] == 400
    assert json.loads(t[1]) == json.loads(j[1])


@pytest.mark.parametrize("kind", ["system", "cuda"])
def test_infer_errors_match_jax(servers, kind):
    """Registering a name twice, an input in no region, an output region
    too small: the same status and text from both servers."""
    a = np.ones((1, 16), np.int32)
    results = []
    for package, h in (("port", servers[1]), ("jax", servers[0])):
        client = httpclient.InferenceServerClient(h.http_url)
        regions = _Regions(client, package, kind)
        try:
            for name in ("in0", "in1"):
                regions.make(name, 64)
                regions.set(name, a)
            regions.make("small", 32)
            mod, h0 = regions.handles["in0"]
            if kind == "system":
                dup = {"key": h0.shm_key, "byte_size": 64}
            else:
                import base64
                dup = {"raw_handle": {"b64": base64.b64encode(
                    mod.get_raw_handle(h0)).decode()}, "byte_size": 64}
            path = "systemsharedmemory" if kind == "system" \
                else "cudasharedmemory"
            out = [_call(h.http_url, "POST",
                         f"/v2/{path}/region/in0/register", dup)]

            def infer(in0, out0, size0=64):
                body = {"inputs": [
                    {"name": n, "datatype": "INT32", "shape": [1, 16],
                     "parameters": {"shared_memory_region": r,
                                    "shared_memory_byte_size": 64}}
                    for n, r in (("INPUT0", in0), ("INPUT1", "in1"))],
                    "outputs": [{"name": "OUTPUT0", "parameters": {
                        "shared_memory_region": out0,
                        "shared_memory_byte_size": size0}}]}
                return _call(h.http_url, "POST", "/v2/models/simple/infer",
                             body)

            out.append(infer("nowhere", "small", 32))
            out.append(infer("in0", "small", 32))
            out.append(_call(h.http_url, "GET",
                             f"/v2/{path}/region/in1/status"))
            regions.unregister()
            results.append([(s, json.loads(b)) for s, b in out])
        finally:
            regions.destroy()
            client.close()
    t, j = results
    if kind == "system":
        for r in (t[-1][1] + j[-1][1]):
            r["key"] = "k"
    assert t == j
    assert [s for s, _ in t] == [400, 400, 400, 200]


# ---------------------------------------------------------------------------
# the port's core: zero copy, no batcher, bf16 into a region, the split
# ---------------------------------------------------------------------------

def _recording_core(dtype=torch.int32, batching=True):
    seen = []
    cfg = make_config(
        "rec", inputs=[("X", "INT32", [4])],
        outputs=[("Y", "BF16" if dtype == torch.bfloat16 else "INT32", [4])],
        max_batch_size=8,
        preferred_batch_sizes=[8] if batching else None,
        max_queue_delay_us=1000 if batching else 0,
        instance_kind="KIND_CPU")

    def fn(X):
        seen.append(X.data_ptr())
        return {"Y": (X * 2).to(dtype)}

    model = TorchModel(cfg, fn)
    reg = ModelRegistry()
    reg.register_model(model)
    return tcore.InferenceCore(reg), model, seen


def _shm_request(in_ref, out_ref=None):
    from triton_client_tpu_torch.server.types import (InferRequest,
                                                     InputTensor,
                                                     RequestedOutput)
    req = InferRequest(model_name="rec", inputs=[
        InputTensor("X", "INT32", (2, 4), shm=in_ref)])
    if out_ref is not None:
        req.outputs.append(RequestedOutput("Y", shm=out_ref))
    return req


def test_cuda_region_input_is_consumed_in_place_and_skips_the_batcher():
    from triton_client_tpu_torch.server.types import ShmRef

    core, model, seen = _recording_core()
    h = _tcreate("zc", 64)
    try:
        tcuda.set_shared_memory_region(h, [np.arange(8, dtype=np.int32)],
                                       offset=16)
        core.cuda_shm.register("zc", tcuda.get_raw_handle(h), 0, 64)
        resp = core.infer(_shm_request(ShmRef("zc", 32, 16),
                                       ShmRef("zc", 32, 0)))
        # the model read the region's own memory, at the offset
        assert seen == [h.tensor.data_ptr() + 16]
        assert model.stats.batch_execution_count == 0
        out = resp.outputs[0]
        assert out.data is None and out.shm.region_name == "zc"
        assert (out.datatype, out.shape) == ("INT32", (2, 4))
        np.testing.assert_array_equal(
            tcuda.get_contents_as_numpy(h, np.int32, [2, 4]),
            np.arange(8).reshape(2, 4) * 2)
        core.cuda_shm.unregister(None)
        assert core.cuda_shm.status(None) == {}
    finally:
        tcuda.destroy_shared_memory_region(h)
        core.shutdown()


def test_bf16_output_goes_into_a_cuda_region_not_onto_the_wire():
    from triton_client_tpu_torch.server.types import (InferRequest,
                                                     InputTensor, ShmRef)

    core, _, _ = _recording_core(torch.bfloat16, batching=False)
    h = _tcreate("bf", 64)
    x = np.arange(8, dtype=np.int32).reshape(2, 4)
    try:
        tcuda.set_shared_memory_region(h, [x])
        core.cuda_shm.register("bf", tcuda.get_raw_handle(h), 0, 64)
        resp = core.infer(_shm_request(ShmRef("bf", 32, 0),
                                       ShmRef("bf", 16, 32)))
        assert resp.outputs[0].datatype == "BF16"
        got = tcuda.as_shared_memory_tensor(h, "BF16", [2, 4], offset=32)
        assert torch.equal(got, torch.from_numpy(x * 2).to(torch.bfloat16))
        # on the wire the same output is the tensor's own bf16 bits
        wire = core.infer(InferRequest(model_name="rec", inputs=[
            InputTensor("X", "INT32", (2, 4), data=x)])).outputs[0]
        assert wire.datatype == "BF16" and wire.shm is None
        assert torch.equal(wire.data.view(torch.int16),
                           torch.from_numpy(x * 2).to(torch.bfloat16)
                           .view(torch.int16))
        core.cuda_shm.unregister(None)
    finally:
        tcuda.destroy_shared_memory_region(h)
        core.shutdown()


def test_request_split_is_recorded_when_asked():
    from triton_client_tpu_torch.server.types import (InferRequest,
                                                     InputTensor, ShmRef)

    core, _, _ = _recording_core()
    key = _key()
    h = tsys.create_shared_memory_region("sp", key, 64)
    x = np.arange(8, dtype=np.int32).reshape(2, 4)
    try:
        core.infer(InferRequest(model_name="rec", inputs=[
            InputTensor("X", "INT32", (2, 4), data=x)]))
        core.splits = []
        tsys.set_shared_memory_region(h, [x])
        core.system_shm.register("sp", key, 0, 64)
        core.infer(_shm_request(ShmRef("sp", 32, 0), ShmRef("sp", 32, 32)))
        core.infer(InferRequest(model_name="rec", inputs=[
            InputTensor("X", "INT32", (2, 4), data=x)]))
        np.testing.assert_array_equal(
            tsys.get_contents_as_numpy(h, np.int32, [2, 4], offset=32), x * 2)
        assert len(core.splits) == 2
        for sp in core.splits:  # shm (direct), then wire (batched)
            assert sp.forward > 0 and sp.output > 0 and sp.resolve > 0
            assert sp.total >= sp.resolve + sp.forward + sp.output
        core.system_shm.unregister(None)
    finally:
        tsys.destroy_shared_memory_region(h)
        core.shutdown()


def test_harness_marks_the_broker_while_it_serves():
    from triton_client_tpu_torch.server import testing

    before = testing._PRESENT_COUNT  # the module's servers may be up
    with ServerHarness(ModelRegistry()):
        assert broker().server_present
        with ServerHarness(ModelRegistry()):
            assert testing._PRESENT_COUNT == before + 2
        assert broker().server_present
    assert testing._PRESENT_COUNT == before
    assert broker().server_present == (before > 0)
