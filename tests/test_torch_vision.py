"""The port's ResNet-50 (``models/vision.py``) against the JAX package's, on
the CPU.

The reference's ``_init_params(PRNGKey(50))`` with every batch-norm scale
and bias redrawn from a seed (so that a swap of scale and bias, or of a
weight's layout, shows), carried to the port by ``params_from_jax``
(HWIO -> OIHW); the same images through the reference's ``_forward``
under ``jax.jit`` and the port's ``forward``:

* f32, batch 2 at 64 x 64 and batch 1 at 224 x 224: max |delta| within
  1e-5 of the reference's largest logit (the logits reach ~1e3: random He
  weights, no normalisation);
* bf16, batch 2 at 64 x 64: max |delta| within 6e-2 of the reference
  logits' RMS;
* the top 5 classes of every image equal in both: in the same order in
  f32; in bf16 the same five, and where bf16 orders two of them otherwise
  their reference logits lie within the bf16 bound of each other.

Beside: the port's own initialisation has the reference's keys, shapes and
scales; ``forward_flops`` is what torch's FLOP counter counts in one
forward; ``resnet50`` served on the CPU answers the port's forward, and its
classification strings are the core's ``_classify`` of those logits, over
HTTP, gRPC ``async_infer`` and a stream; ``perf_analyzer -m resnet50`` runs
over HTTP, CUDA shm (host regions) over gRPC, the dynamic batcher and a
gRPC stream.
"""

import json
import queue

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import jax
import jax.numpy as jnp

from triton_client_tpu.models import vision as jv
from triton_client_tpu_torch import grpc as tgrpc
from triton_client_tpu_torch import http as thttp
from triton_client_tpu_torch import perf_analyzer as tpa
from triton_client_tpu_torch.models import vision as tv
from triton_client_tpu_torch.server.core import InferenceCore
from triton_client_tpu_torch.server.registry import ModelRegistry
from triton_client_tpu_torch.server.testing import ServerHarness
import triton_client_tpu_torch.utils.cuda_shared_memory as tcuda

SCALE_SUFFIXES = ("_scale", "_s1", "_s2", "_s3", "_proj_s")
BIAS_SUFFIXES = ("_bias", "_b1", "_b2", "_b3", "_proj_b")
# parity bounds: f32 of the largest reference logit, bf16 of their RMS
F32_OF_MAX = 1e-5
BF16_OF_RMS = 6e-2


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads while these full-width forwards run: the suite's
    other workers keep their cores (some reference tests are timed)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _ref_params(dtype, seed=51):
    """The reference's weights in ``dtype`` as numpy, every batch-norm
    scale (uniform 0.5-1.5) and bias (normal 0.1) redrawn from ``seed``."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, v in jv._init_params(jax.random.PRNGKey(50), dtype).items():
        if name.endswith(SCALE_SUFFIXES):
            v = jnp.asarray(rng.uniform(0.5, 1.5, v.shape), dtype)
        elif name.endswith(BIAS_SUFFIXES) and name != "fc_bias":
            v = jnp.asarray(rng.normal(0.0, 0.1, v.shape), dtype)
        out[name] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def ref_params():
    return {"f32": _ref_params(jnp.float32),
            "bf16": _ref_params(jnp.bfloat16)}


def _images(seed, n, size):
    return np.random.default_rng(seed).normal(
        0.0, 1.0, (n, 3, size, size)).astype(np.float32)


def test_params_from_jax_carries_every_weight_across(ref_params):
    npp = ref_params["f32"]
    got = tv.params_from_jax(npp, torch.float32, "cpu")
    assert sorted(got) == sorted(npp)
    for name, arr in npp.items():
        want = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr
        np.testing.assert_array_equal(got[name].numpy(), want, err_msg=name)
    bf = tv.params_from_jax(ref_params["bf16"], torch.bfloat16, "cpu")
    assert bf["stem"].dtype == torch.bfloat16
    assert bf["fc_bias"].dtype == torch.float32


def test_init_params_follows_the_reference_initialisation(ref_params):
    npp = ref_params["f32"]
    got = tv.init_params(tv.SEED, torch.float32, "cpu")
    assert sorted(got) == sorted(npp)
    for name, arr in npp.items():
        shape = arr.transpose(3, 2, 0, 1).shape if arr.ndim == 4 \
            else arr.shape
        assert tuple(got[name].shape) == shape, name
        w = got[name]
        if w.dim() == 4:
            fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            std = float(w.std())
            assert abs(std / np.sqrt(2.0 / fan_in) - 1) < 0.1, name
        elif name.endswith(SCALE_SUFFIXES):
            assert torch.equal(w, torch.ones_like(w)), name
        elif name.endswith(BIAS_SUFFIXES):
            assert torch.equal(w, torch.zeros_like(w)), name
    assert abs(float(got["fc"].std()) / 0.01 - 1) < 0.05
    again = tv.init_params(tv.SEED, torch.float32, "cpu")
    assert all(torch.equal(got[k], again[k]) for k in got)


def _top5(logits):
    return np.argsort(-logits, axis=1, kind="stable")[:, :5]


@pytest.mark.parametrize("precision,batch,size", [
    ("f32", 2, 64), ("bf16", 2, 64), ("f32", 1, 224)])
def test_forward_matches_reference(ref_params, precision, batch, size):
    npp = ref_params[precision]
    x = _images(52 + size, batch, size)
    ref = np.asarray(jax.jit(jv._forward)(
        {k: jnp.asarray(v) for k, v in npp.items()}, x))
    dtype = torch.float32 if precision == "f32" else torch.bfloat16
    with torch.inference_mode():
        got = tv.forward(tv.params_from_jax(npp, dtype, "cpu"),
                         torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (batch, 1000)
    assert got.dtype == np.float32
    err = float(np.abs(got - ref).max())
    if precision == "f32":
        assert err <= F32_OF_MAX * float(np.abs(ref).max()), err
        np.testing.assert_array_equal(_top5(got), _top5(ref))
        return
    bound = BF16_OF_RMS * float(np.sqrt((ref ** 2).mean()))
    assert err <= bound, err
    # the same five classes; where bf16 orders two of them otherwise, the
    # reference's logits of the two lie within the bound (a near tie)
    rows = np.arange(batch)[:, None]
    assert [set(r) for r in _top5(got)] == [set(r) for r in _top5(ref)]
    gaps = np.abs(ref[rows, _top5(got)] - ref[rows, _top5(ref)])
    assert float(gaps.max()) <= bound, gaps


def test_forward_flops_is_what_the_forward_computes():
    params = tv.init_params(tv.SEED, torch.float32, "cpu")
    counter = FlopCounterMode(display=False)
    with torch.inference_mode(), counter:
        tv.forward(params, torch.zeros(1, 3, 224, 224))
    assert counter.get_total_flops() == tv.forward_flops() == 8_178_368_512


def test_make_resnet50_config_and_device():
    model = tv.make_resnet50("cpu")
    cfg = model.config
    assert (cfg.max_batch_size, cfg.preferred_batch_size,
            cfg.max_queue_delay_microseconds) == (32, [1, 4, 8, 16, 32],
                                                  2000)
    assert cfg.instance_kind == "KIND_CPU"
    assert cfg.output[0].label_filename == "OUTPUT_labels.txt"
    assert model.labels("OUTPUT")[:2] == ["class_0", "class_1"]
    assert model.resnet.params is None  # drawn at the first request
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tv.make_resnet50("cuda")


@pytest.fixture(scope="module")
def served():
    model = tv.make_resnet50("cpu")
    registry = ModelRegistry()
    registry.register_model(model)
    with ServerHarness(registry) as harness:
        yield harness, model


def test_served_resnet50_answers_the_port_forward(served):
    harness, model = served
    x = _images(60, 4, 224)
    with thttp.InferenceServerClient(harness.http_url) as c:
        inp = thttp.InferInput("INPUT", list(x.shape), "FP32")
        inp.set_data_from_numpy(x)
        raw = c.infer("resnet50", [inp]).as_numpy("OUTPUT")
    with torch.inference_mode():
        want = tv.forward(model.resnet.params, torch.from_numpy(x)).numpy()
    assert raw.shape == (4, 1000)
    np.testing.assert_allclose(raw, want, rtol=0,
                               atol=1e-6 * float(np.abs(want).max()))
    want_cls = InferenceCore._classify(model, "OUTPUT", raw, 3)
    with tgrpc.InferenceServerClient(harness.http_url) as g:
        inp = tgrpc.InferInput("INPUT", list(x.shape), "FP32")
        inp.set_data_from_numpy(x)
        out = [tgrpc.InferRequestedOutput("OUTPUT", class_count=3)]
        unary = g.async_infer("resnet50", [inp], outputs=out)
        got = unary.get_result(timeout=120).as_numpy("OUTPUT")
        done = queue.Queue()
        g.start_stream(lambda result, error: done.put((result, error)))
        g.async_stream_infer("resnet50", [inp], outputs=out)
        result, error = done.get(timeout=120)
        g.stop_stream()
    assert error is None, error
    for strings in (got, result.as_numpy("OUTPUT")):
        assert strings.dtype == np.object_ and strings.shape == (4, 3)
        assert strings.tolist() == want_cls.tolist()
    assert all(s.decode().split(":")[2] == f"class_{s.decode().split(':')[1]}"
               for s in got.ravel())


@pytest.mark.parametrize("extra", [
    ["-b", "2"],
    ["-b", "2", "-i", "grpc", "--shared-memory", "cuda",
     "--cuda-shared-memory-device", "cpu"],
    ["-b", "1", "--concurrency-range", "1:2"],
    ["-b", "1", "-i", "grpc", "--streaming"],
], ids=["http wire", "grpc cuda shm", "batcher", "grpc stream"])
def test_perf_analyzer_drives_resnet50(served, extra, capsys):
    harness, model = served
    rc = tpa.main(["-m", "resnet50", "-u", harness.http_url,
                   "--measurement-interval", "1500", "-v", *extra])
    out = capsys.readouterr().out
    assert rc == 0, out
    results = [json.loads(ln.split("result ", 1)[1])
               for ln in out.splitlines() if ln.startswith("  result ")]
    assert results, out
    for r in results:
        assert r["errors"] == 0 and r["throughput"] > 0, r
    assert harness.core.cuda_shm.status(None) == {}
    assert tcuda.allocated_shared_memory_regions() == []
