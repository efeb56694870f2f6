"""The port's serving stack against the JAX package's, over HTTP.

Both packages' in-process harnesses serve ``simple`` and the tiny
``longctx_tpu`` on the CPU with the same weights (the reference's seed-11
init, carried to the port as numpy arrays), and the reference's own HTTP
client sends both the same requests, with JSON tensors and with the
binary-tensor-data extension.

Tolerance on LOGPROBS: 5e-2, the bf16 logit bound of
test_torch_transformer.py (log-softmax moves by at most twice the largest
logit difference; the measured difference here is far smaller).
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax

from triton_client_tpu import http as httpclient
from triton_client_tpu.models import language as jlang
from triton_client_tpu.models import transformer as jtr
from triton_client_tpu.models import zoo as jzoo
from triton_client_tpu.server.registry import ModelRegistry as JaxRegistry
from triton_client_tpu.server.testing import ServerHarness as JaxHarness
from triton_client_tpu_torch.models import language as tlang
from triton_client_tpu_torch.models import zoo as tzoo
from triton_client_tpu_torch.server import core as tcore
from triton_client_tpu_torch.server.model import TorchModel, make_config
from triton_client_tpu_torch.server.registry import ModelRegistry
from triton_client_tpu_torch.server.testing import ServerHarness

S = 512  # the tiny preset's window


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


def _infer(url, name, arrays, binary, outputs):
    with httpclient.InferenceServerClient(url) as c:
        inputs = []
        for n, (dt, arr) in arrays.items():
            inp = httpclient.InferInput(n, list(arr.shape), dt)
            inp.set_data_from_numpy(arr, binary_data=binary)
            inputs.append(inp)
        outs = [httpclient.InferRequestedOutput(o, binary_data=binary)
                for o in outputs]
        r = c.infer(name, inputs, outputs=outs)
        return {o: np.asarray(r.as_numpy(o)) for o in outputs}


@pytest.mark.parametrize("binary", [False, True], ids=["json", "binary"])
def test_longctx_logprobs_match_jax_server(servers, binary):
    jh, th = servers
    tokens = np.random.default_rng(5).integers(0, 256, (2, S)).astype(
        np.int32)
    req = {"TOKENS": ("INT32", tokens)}
    want = _infer(jh.http_url, "longctx_tpu", req, binary, ["LOGPROBS"])
    got = _infer(th.http_url, "longctx_tpu", req, binary, ["LOGPROBS"])
    got, want = got["LOGPROBS"], want["LOGPROBS"]
    assert got.shape == want.shape == (2, S) and got.dtype == np.float32
    assert np.isfinite(got).all() and (got[:, :-1] <= 0).all()
    assert (got[:, -1] == 0).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-2)


@pytest.mark.parametrize("binary", [False, True], ids=["json", "binary"])
def test_simple_matches_jax_server(servers, binary):
    jh, th = servers
    rng = np.random.default_rng(6)
    a = rng.integers(-1000, 1000, (1, 16)).astype(np.int32)
    b = rng.integers(-1000, 1000, (1, 16)).astype(np.int32)
    req = {"INPUT0": ("INT32", a), "INPUT1": ("INT32", b)}
    outs = ["OUTPUT0", "OUTPUT1"]
    want = _infer(jh.http_url, "simple", req, binary, outs)
    got = _infer(th.http_url, "simple", req, binary, outs)
    for o in outs:
        assert got[o].dtype == np.int32
        np.testing.assert_array_equal(got[o], want[o])
    np.testing.assert_array_equal(got["OUTPUT0"], a + b)


def _get(url, path):
    try:
        with urllib.request.urlopen(f"http://{url}{path}") as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_health_metadata_and_config_match_jax_server(servers):
    jh, th = servers
    for path in ("/v2/health/live", "/v2/health/ready",
                 "/v2/models/longctx_tpu/ready",
                 "/v2/models/longctx_tpu/versions/1/ready",
                 "/v2/models/nope/ready"):
        assert _get(th.http_url, path)[0] == _get(jh.http_url, path)[0], path
    for path in ("/v2/models/longctx_tpu", "/v2/models/simple"):
        t, j = (json.loads(_get(u, path)[1])
                for u in (th.http_url, jh.http_url))
        for key in ("name", "versions", "inputs", "outputs"):
            assert t[key] == j[key], (path, key)
    t, j = (json.loads(_get(u, "/v2/models/longctx_tpu/config")[1])
            for u in (th.http_url, jh.http_url))
    for key in ("name", "max_batch_size", "input", "output"):
        assert t[key] == j[key], key
    assert t["dynamic_batching"] == j["dynamic_batching"]
    assert json.loads(_get(th.http_url, "/v2")[1])["extensions"]


def test_errors_are_4xx_with_a_message(servers):
    _, th = servers
    url = f"http://{th.http_url}/v2/models/longctx_tpu/infer"
    bad = json.dumps({"inputs": [{"name": "TOKENS", "datatype": "FP32",
                                  "shape": [1, S], "data": [0] * S}]})
    req = urllib.request.Request(url, data=bad.encode())
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req)
    assert e.value.code == 400
    assert "expects 'INT32'" in json.loads(e.value.read())["error"]
    status, body = _get(th.http_url, "/v2/models/nope")
    assert status == 400 and b"unknown model" in body


# ---------------------------------------------------------------------------
# dynamic batcher contract (a recording model, deterministic groupings)
# ---------------------------------------------------------------------------

def _recording_model(delay_us, preferred=(1, 2, 4), max_bs=4):
    seen = []
    cfg = make_config("rec", inputs=[("X", "FP32", [3])],
                      outputs=[("Y", "FP32", [3])], max_batch_size=max_bs,
                      preferred_batch_sizes=list(preferred),
                      max_queue_delay_us=delay_us, instance_kind="KIND_CPU")

    def fn(X):
        seen.append(tuple(X.shape))
        return {"Y": X * 2}

    return TorchModel(cfg, fn), seen


def _concurrent(core, model, rows):
    from triton_client_tpu_torch.server.types import (InferRequest,
                                                     InputTensor)

    results = [None] * len(rows)
    start = threading.Barrier(len(rows))

    def one(i):
        x = np.full((rows[i], 3), float(i), np.float32)
        start.wait(timeout=10)
        resp = core.infer(InferRequest(model_name=model.name, inputs=[
            InputTensor("X", "FP32", x.shape, data=x)]))
        results[i] = resp.outputs[0].data

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(rows))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    for i, r in enumerate(results):
        np.testing.assert_array_equal(r, np.full((rows[i], 3), 2.0 * i))


def test_batcher_groups_up_to_the_largest_bucket():
    # a 10 s window: four concurrent single-row requests fill the largest
    # preferred size (4) and execute as one batch, long before the window
    model, seen = _recording_model(delay_us=10_000_000)
    reg = ModelRegistry()
    reg.register_model(model)
    core = tcore.InferenceCore(reg)
    try:
        _concurrent(core, model, [1, 1, 1, 1])
    finally:
        core.shutdown()
    assert seen == [(4, 3)]
    assert model.stats.batch_execution_count == 1
    assert model.stats.batch_size_total == 4


def test_batcher_pads_to_bucket_and_carries_overflow():
    # 3 + 2 rows cannot share a max_batch_size 4 execution: the second
    # request seeds the next batch; 3 pads to bucket 4, 2 runs as 2
    model, seen = _recording_model(delay_us=300_000)
    reg = ModelRegistry()
    reg.register_model(model)
    core = tcore.InferenceCore(reg)
    try:
        _concurrent(core, model, [3, 2])
    finally:
        core.shutdown()
    assert sorted(seen) == [(2, 3), (4, 3)]
    assert model.stats.batch_size_total == 5


def test_readback_of_cpu_tensors_and_arrays():
    out = tcore.readback({"a": torch.arange(4, dtype=torch.int32),
                          "b": np.ones(2, np.float32)})
    assert isinstance(out["a"], np.ndarray) and out["a"].tolist() == [0, 1, 2, 3]
    assert out["b"].dtype == np.float32
