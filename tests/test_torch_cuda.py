"""On-card tests of the PyTorch port: each CUDA kernel against its plain
version (at the serving shapes of longctx_tpu, bert_large and llama_tpu
1b), the served forward through the kernels, one ensemble_llama request
over llama_tpu 1b, resnet50 and dense_tpu on the card, bf16 readback bits;
and CUDA shared-memory regions: their API, a region
mapped by another process through cudaIPC, serving over them, and the card's
memory given back after unregister.

They need an NVIDIA GPU and nvcc and skip elsewhere.  This file imports no
JAX, so it runs on a machine that has none:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: flash attention bf16 atol 2e-2 + rtol 1e-2 compared as f32
(the kernel feeds bf16 probabilities to the tensor cores, the plain version
keeps them in f32, and outputs reach ~4 where one bf16 ulp is 2**-5), f32
atol 1e-4, and beside either each query row's largest error within 5% of
the row's RMS in the plain output (chip_smoke.py's ``FLASH_ROW_TOL``: late
causal rows are ~0.03, below the atol, and a key tile skipped or read stale
moves them by ~18% of their RMS at 4096 keys); the int8 quantize pass and
matmul bit for bit.
"""

import base64
import importlib
import json

import numpy as np
import pytest
import torch

from triton_client_tpu_torch import ops
from triton_client_tpu_torch.models import language
from triton_client_tpu_torch.models import transformer as tr
from triton_client_tpu_torch.server import core

fa = importlib.import_module("triton_client_tpu_torch.ops.flash_attention")
im = importlib.import_module("triton_client_tpu_torch.ops.int8_matmul")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _rand(shape, seed):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _assert_flash_close(got, want, atol, rtol):
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    row_err = (got - want).abs().amax(-1)
    row_rms = want.pow(2).mean(-1).sqrt()
    bad = row_err > 0.05 * row_rms
    assert not bad.any(), (
        f"{int(bad.sum())} rows beyond 5% of their RMS, worst "
        f"{(row_err / row_rms.clamp_min(1e-30)).max().item():.2%}")


@pytest.mark.parametrize("dtype,atol,rtol", [(torch.bfloat16, 2e-2, 1e-2),
                                             (torch.float32, 1e-4, 0.0)])
@pytest.mark.parametrize("shape,causal", [
    ((1, 2, 128, 64), True), ((1, 2, 100, 32), False), ((1, 1, 8, 16), True),
    ((2, 4, 1000, 64), True), ((2, 4, 1000, 64), False)])
def test_flash_kernel_matches_plain(cuda, shape, causal, dtype, atol, rtol):
    q, k, v = (_rand(shape, s).to(cuda, dtype) for s in (1, 2, 3))
    before = fa.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 1 and got.dtype == dtype
    want = ops.flash_attention_reference(q, k, v, causal=causal)
    _assert_flash_close(got, want, atol, rtol)


def test_flash_kernel_head_dim_128_and_custom_scale(cuda):
    q, k, v = (_rand((1, 2, 300, 128), s).to(cuda, torch.bfloat16)
               for s in (4, 5, 6))
    got = ops.flash_attention(q, k, v, causal=True, sm_scale=0.05)
    want = ops.flash_attention_reference(q, k, v, causal=True, sm_scale=0.05)
    _assert_flash_close(got, want, 2e-2, 1e-2)


@pytest.mark.parametrize("S", [1, 127, 128, 129, 1000, 4100])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_flash_bf16_kernel_head_dims_and_ragged_lengths(cuda, D, causal, S):
    """The wgmma kernel at every head dim, ragged and tile-sized S, with
    B*H = 8 so a read or write across a head boundary shows; S = 129 also
    takes custom scales, negative and zero among them (the wrapper folds
    their sign into q)."""
    q, k, v = (_rand((2, 4, S, D), s).to(cuda, torch.bfloat16)
               for s in (14, 15, 16))
    for scale in ((None, 0.3, -0.3, 0.0) if S == 129 else (None,)):
        before = fa.launches
        got = ops.flash_attention(q, k, v, causal=causal, sm_scale=scale)
        torch.cuda.synchronize()
        assert fa.launches == before + 1
        want = ops.flash_attention_reference(q, k, v, causal=causal,
                                             sm_scale=scale)
        _assert_flash_close(got, want, 2e-2, 1e-2)


@pytest.mark.parametrize("B", [1, 32])
def test_flash_bf16_kernel_bert_large_shape_not_causal(cuda, B):
    """bert_large's attention shape (S = 384 sits under the flash gate, so
    the served forward takes the ring; the kernel still takes it)."""
    q, k, v = (_rand((B, 16, 384, 64), s).to(cuda, torch.bfloat16)
               for s in (21, 22, 23))
    got = ops.flash_attention(q, k, v, causal=False)
    want = ops.flash_attention_reference(q, k, v, causal=False)
    _assert_flash_close(got, want, 2e-2, 1e-2)


def test_flash_bf16_kernel_takes_more_than_65535_heads(cuda):
    """B*H = 70,000 with two query tiles per head (S = 200): the persistent
    grid numbers work items past the 65,535 of a grid's y dimension; f32,
    whose grid still puts B*H there, keeps that limit."""
    q, k, v = (_rand((2, 35000, 200, 16), s).to(cuda, torch.bfloat16)
               for s in (17, 18, 19))
    got = ops.flash_attention(q, k, v, causal=True)
    want = torch.cat([
        ops.flash_attention_reference(q[:, h:h + 5000], k[:, h:h + 5000],
                                      v[:, h:h + 5000], causal=True)
        for h in range(0, 35000, 5000)], dim=1)
    _assert_flash_close(got, want, 2e-2, 1e-2)
    with pytest.raises(ValueError, match="65535"):
        ops.flash_attention(*(t[:, :, :8].float().contiguous()
                              for t in (q, k, v)))


@pytest.mark.parametrize("kernel", ["flash_attention", "int8_matmul"])
def test_kernel_is_a_fresh_threads_first_cuda_work(cuda, kernel):
    """A thread whose first CUDA work is the kernel launch (a new server
    worker) gets the plain version's answer: the launch makes the device's
    context current for the tensor maps (without it the launch failed
    with cudaError 1)."""
    import threading

    if kernel == "flash_attention":
        q = _rand((1, 2, 256, 64), 1).to(cuda, torch.bfloat16)
        args, plain = (q, q, q), fa.flash_attention_reference
        run = fa.flash_attention
    else:
        x = _rand((64, 256), 2).to(cuda, torch.bfloat16)
        w = torch.randint(-127, 128, (128, 256), dtype=torch.int8,
                          device=cuda).t()
        ws = _rand((128,), 3).abs().to(cuda)
        args, plain, run = (x, w, ws), im.int8_matmul_reference, \
            im.int8_matmul
    got = {}

    def first():
        try:
            with torch.no_grad():
                got["out"] = run(*args)
            torch.cuda.current_stream(cuda).synchronize()
        except Exception as e:  # noqa: BLE001 - reported below
            got["error"] = e

    t = threading.Thread(target=first)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and "error" not in got, got
    want = plain(*args)
    if kernel == "flash_attention":
        _assert_flash_close(got["out"], want, 2e-2, 1e-2)
    else:
        assert torch.equal(got["out"], want)


def test_flash_kernel_refuses_inputs_that_require_grad(cuda):
    # the kernel has no backward yet (ROADMAP A1): with grad mode on it
    # refuses inputs that require grad, launching nothing; under no_grad
    # or inference_mode it runs
    q, k, v = (_rand((1, 2, 128, 64), s).to(cuda, torch.bfloat16)
               for s in (1, 2, 3))
    for which in range(3):
        args = [q, k, v]
        args[which] = args[which].clone().requires_grad_()
        before = fa.launches
        with pytest.raises(RuntimeError, match="ROADMAP A1"):
            ops.flash_attention(*args)
        assert fa.launches == before
    q.requires_grad_()
    with torch.no_grad():
        got = ops.flash_attention(q, k, v)
    with torch.inference_mode():
        again = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert got.grad_fn is None and torch.equal(got, again)
    _assert_flash_close(got, ops.flash_attention_reference(
        q.detach(), k, v), 2e-2, 1e-2)


def test_flash_rejects_what_the_kernel_does_not_take(cuda):
    q = _rand((1, 2, 64, 24), 7).to(cuda, torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, q, q)
    q = _rand((1, 2, 64, 64), 8).to(cuda, torch.float16)
    with pytest.raises(ValueError, match="bf16 or f32"):
        ops.flash_attention(q, q, q)


def _int8_inputs(m, k, n, seed, dtype, device):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
    ws = torch.from_numpy(
        ((np.abs(rng.standard_normal(n)) + 0.01) * 0.02).astype(np.float32))
    return x.to(device, dtype), w.to(device), ws.to(device)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(64, 256, 128), (50, 1024, 4096),
                                   (300, 4096, 1024), (1, 128, 128)])
def test_int8_kernel_bit_exact(cuda, m, k, n, dtype):
    x, w, ws = _int8_inputs(m, k, n, 9, dtype, cuda)
    before = im.launches
    got = ops.int8_matmul(x, w, ws)
    torch.cuda.synchronize()
    assert im.launches == before + 1
    assert torch.equal(got, ops.int8_matmul_reference(x, w, ws))


def _int8_special_rows(x):
    """An all-zero row, two rows with one large outlier, and a row of exact
    ties (amax 127: scale 1, all its other quotients j + 0.5)."""
    m, k = x.shape
    if m >= 50:
        x[1] = 0.0
        x[2, 5] = 1000.0
        x[m // 2, k - 1] = -3000.0
        x[3] = torch.arange(k, dtype=x.dtype) % 254 - 126.5
        x[3, 0] = 127.0
    return x


_INT8_CASES = ([(m, k, n, torch.bfloat16) for k, n in ((4096, 1024),
                                                       (1024, 4096))
                for m in (1, 50, 300, 4096, 16384)]
               + [(300, 4096, 1024, torch.float32),
                  (300, 1024, 4096, torch.float32),
                  (200, 256, 384, torch.bfloat16)]
               # llama_tpu 1b: FFN-down and FFN-up (under ``all``)
               + [(m, k, n, torch.bfloat16) for k, n in ((8192, 2048),
                                                        (2048, 8192))
                  for m in (1, 128, 1000, 1024)])


@pytest.mark.parametrize("m,k,n,dtype", _INT8_CASES)
def test_int8_quantize_rows_and_weight_layouts_bit_exact(cuda, m, k, n,
                                                         dtype):
    """The quantize pass (codes and scales) and the matmul with the weight
    row-major and K-major, each bit for bit against its plain version."""
    rng = np.random.default_rng(14)
    x = _int8_special_rows(torch.from_numpy(
        rng.standard_normal((m, k)).astype(np.float32)))
    w = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
    ws = torch.from_numpy(
        ((np.abs(rng.standard_normal(n)) + 0.01) * 0.02).astype(np.float32))
    x, w, ws = x.to(cuda, dtype), w.to(cuda), ws.to(cuda)
    before = im.quantize_launches
    q, xs = ops.int8_quantize_rows(x)
    torch.cuda.synchronize()
    assert im.quantize_launches == before + 1
    want_q, want_xs = ops.int8_quantize_rows_reference(x)
    assert torch.equal(q, want_q) and torch.equal(xs, want_xs)
    want = ops.int8_matmul_reference(x, w, ws)
    w_kmajor = w.t().contiguous().t()
    for wl in (w, w_kmajor):
        before = im.launches
        got = ops.int8_matmul(x, wl, ws)
        torch.cuda.synchronize()
        assert im.launches == before + 1
        assert torch.equal(got, want)


def test_int8_kernel_leading_dims_kmajor_weight(cuda):
    x, w, ws = _int8_inputs(4 * 75, 1024, 4096, 15, torch.bfloat16, cuda)
    x3 = x.reshape(4, 75, 1024)
    got = ops.int8_matmul(x3, w.t().contiguous().t(), ws)
    assert got.shape == (4, 75, 4096)
    assert torch.equal(got, ops.int8_matmul_reference(x3, w, ws))
    q, xs = ops.int8_quantize_rows(x3)
    assert q.shape == (4, 75, 1024) and xs.shape == (4, 75, 1)
    want_q, want_xs = ops.int8_quantize_rows_reference(x3)
    assert torch.equal(q, want_q) and torch.equal(xs, want_xs)


def test_int8_kernel_takes_more_than_65535_row_tiles(cuda):
    """The persistent GEMM and the one-block-per-row quantize pass have no
    grid limit on M: 65535 * 128 + 200 rows, the first and last rows held
    to the plain version (rows are independent)."""
    m = 65535 * 128 + 200
    x, w, ws = _int8_inputs(1000, 128, 128, 16, torch.bfloat16, cuda)
    xl = x.repeat(m // 1000 + 1, 1)[:m]
    xl[-1000:] = x.flip(0)
    got = ops.int8_matmul(xl, w, ws)
    torch.cuda.synchronize()
    want = ops.int8_matmul_reference(x, w, ws)
    assert torch.equal(got[:1000], want)
    assert torch.equal(got[-1000:], want.flip(0))


def test_int8_kernel_batched_leading_dims_and_row_scale_shape(cuda):
    x, w, ws = _int8_inputs(48, 128, 256, 10, torch.bfloat16, cuda)
    x3 = x.reshape(4, 12, 128)
    got = ops.int8_matmul(x3, w, ws.reshape(1, -1))
    assert got.shape == (4, 12, 256)
    assert torch.equal(got, ops.int8_matmul_reference(x3, w, ws))


def test_int8_unaligned_k_raises_on_card(cuda):
    x, w, ws = _int8_inputs(16, 96, 128, 11, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="multiples of 128"):
        ops.int8_matmul(x, w, ws)
    with pytest.raises(ValueError, match="multiple of 128"):
        ops.int8_quantize_rows(x)


def test_int_dot_matches_exact_product(cuda):
    rng = np.random.default_rng(12)
    for m in (5, 17, 300):
        a = torch.from_numpy(rng.integers(-127, 128, (m, 64)).astype(np.int8))
        b = torch.from_numpy(rng.integers(-127, 128, (64, 128)).astype(np.int8))
        got = tr._int_dot(a.to(cuda), b.to(cuda)).cpu()
        assert torch.equal(got, im.exact_int_dot(a, b))


def test_readback_of_cuda_tensors(cuda):
    t = torch.arange(1000, dtype=torch.float32, device=cuda) * 3
    out = core.readback({"y": t, "z": torch.ones(3, device=cuda)})
    np.testing.assert_array_equal(out["y"], np.arange(1000) * 3.0)
    assert out["z"].tolist() == [1.0, 1.0, 1.0]


def test_readback_keeps_bf16_bits(cuda):
    """A bf16 output comes back as a bfloat16 host tensor with its bits,
    and goes to the wire as those bits (no float32 detour)."""
    from triton_client_tpu_torch.utils import bf16_from_bytes, bf16_to_bytes

    bits = torch.from_numpy(np.array(
        [0x7FC1, 0xFF80, 0x8000, 0x0001, 0x3F80, 0x1234],
        dtype=np.uint16).view(np.int16))
    t = bits.view(torch.bfloat16).to(cuda)
    out = core.readback({"y": t})["y"]
    assert out.dtype == torch.bfloat16 and out.device.type == "cpu"
    assert torch.equal(out.view(torch.int16), bits)
    wire = bf16_to_bytes(out)
    assert wire.tobytes() == bits.numpy().tobytes()
    assert torch.equal(bf16_from_bytes(wire, [6]).view(torch.int16), bits)


def test_resnet50_and_dense_tpu_served_on_card(cuda):
    """``resnet50`` in bf16, ``channels_last``, and ``dense_tpu`` on the
    card through the model adapter: OUTPUT finite, resnet50 within
    chip_smoke.py's bound (6e-2 of the RMS) of an f32 forward of the same
    weights, its classification strings ``_classify`` of the logits."""
    from triton_client_tpu_torch.models import vision, zoo

    model = vision.make_resnet50("cuda")
    assert model.config.instance_kind == "KIND_GPU"
    x = np.random.default_rng(14).uniform(-1, 1, (4, 3, 224, 224)).astype(
        np.float32)
    out = core.readback(model.execute({"INPUT": x}, {}))["OUTPUT"]
    params = model.resnet.params
    assert params["stem"].dtype == torch.bfloat16
    assert params["stem"].is_contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        want = vision.forward({k: v.float() for k, v in params.items()},
                              torch.from_numpy(x).to(cuda)).cpu().numpy()
    rms = float(np.sqrt((want ** 2).mean()))
    assert out.shape == (4, 1000) and np.isfinite(out).all()
    assert float(np.abs(out - want).max()) <= 6e-2 * rms
    strings = core.InferenceCore._classify(model, "OUTPUT", out, 3)
    assert strings.shape == (4, 3)
    assert [int(s.split(b":")[1]) for s in strings[:, 0]] == \
        out.argmax(1).tolist()
    dense = zoo.make_dense_tpu("cuda")
    rows = np.random.default_rng(15).normal(
        0, 1, (4, zoo.DENSE_D)).astype(np.float32)
    y = core.readback(dense.execute({"INPUT": rows}, {}))["OUTPUT"]
    assert y.shape == (4, zoo.DENSE_D) and np.isfinite(y).all()
    assert dense.weights.params["w1"].is_cuda


@pytest.mark.parametrize("quant,atol", [("", 5e-2), ("int8", 1.5e-1)])
def test_served_forward_runs_the_kernels(cuda, monkeypatch, quant, atol):
    """``longctx_tpu`` base (S = 4096) through the model adapter: one flash
    launch per layer, one int8 launch per layer under the default ``w2``,
    LOGPROBS within chip_smoke.py's bounds of the plain-kernel forward."""
    for var in ("TRITON_TPU_LONGCTX_PRESET", "TRITON_TPU_FLASH_MIN_S",
                "TRITON_TPU_INT8_FUSED", "TRITON_TPU_FLASH"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("TRITON_TPU_QUANT_LONGCTX_TPU", quant)
    model = language.make_longctx_tpu("cuda")
    tokens = np.random.default_rng(13).integers(0, 256, (2, 4096)).astype(
        np.int32)
    f0, i0 = fa.launches, im.launches
    out = core.readback(model.execute({"TOKENS": tokens}, {}))["LOGPROBS"]
    layers = model.transformer.cfg.n_layers
    assert fa.launches - f0 == layers
    assert im.launches - i0 == (layers if quant else 0)
    fwd = tr.make_forward(model.transformer.cfg, quantized=bool(quant),
                          plain=True)
    t = torch.from_numpy(tokens).to(cuda)
    with torch.inference_mode():
        want = language.longctx_scores(
            fwd(model.transformer.params, t), t).cpu().numpy()
    assert out.shape == (2, 4096) and np.isfinite(out).all()
    np.testing.assert_allclose(out, want, rtol=0, atol=atol)


def test_ensemble_llama_served_on_card(cuda, monkeypatch):
    """One ensemble_llama request over HTTP, binary BYTES in and out,
    through llama_tpu 1b on the card: OUT_TEXT is NEXT_TOKEN's byte, and
    NEXT_TOKEN is the plain forward's argmax or a near tie (its logit within
    3e-2 of the max, chip_smoke.py's bound for llama_tpu bf16)."""
    import http.client
    import json

    from triton_client_tpu_torch import utils
    from triton_client_tpu_torch.server.registry import ModelRegistry
    from triton_client_tpu_torch.server.testing import ServerHarness

    for var in ("TRITON_TPU_LLAMA_PRESET", "TRITON_TPU_QUANT",
                "TRITON_TPU_QUANT_LLAMA_TPU"):
        monkeypatch.delenv(var, raising=False)
    llama = language.make_llama_tpu("cuda")
    assert llama.transformer.cfg.d_model == 2048
    reg = ModelRegistry()
    for m in (language.make_llama_preprocess(), llama,
              language.make_llama_postprocess(),
              language.make_ensemble_llama()):
        reg.register_model(m)
    text = np.array([[b"the quick brown fox \xff"]], dtype=object)
    raw = bytes(utils.serialize_byte_tensor_raw(text))
    header = json.dumps({
        "inputs": [{"name": "TEXT", "datatype": "BYTES", "shape": [1, 1],
                    "parameters": {"binary_data_size": len(raw)}}],
        "outputs": [{"name": n, "parameters": {"binary_data": True}}
                    for n in ("OUT_TEXT", "NEXT_TOKEN")]}).encode()
    with ServerHarness(reg) as h:
        conn = http.client.HTTPConnection("127.0.0.1", h.http_port,
                                          timeout=600)
        conn.request("POST", "/v2/models/ensemble_llama/infer", header + raw,
                     {"Inference-Header-Content-Length": str(len(header))})
        resp = conn.getresponse()
        body = resp.read()
        conn.close()
    assert resp.status == 200, body[:500]
    hlen = int(resp.getheader("Inference-Header-Content-Length"))
    outs = json.loads(body[:hlen])["outputs"]
    n_text = outs[0]["parameters"]["binary_data_size"]
    out_text = utils.deserialize_bytes_tensor(body[hlen:hlen + n_text])
    tok = int(np.frombuffer(body[hlen + n_text:], np.int32)[0])
    assert out_text.tolist() == [bytes([tok % 256])]
    tokens = language.make_llama_preprocess().execute(
        {"TEXT": text}, {})["TOKENS"]
    fwd = tr.make_forward(llama.transformer.cfg, plain=True)
    with torch.inference_mode():
        last = fwd(llama.transformer.params,
                   torch.from_numpy(tokens).to(cuda))[0, -1].float()
    assert last[tok] >= last.max() - 3e-2


# ---------------------------------------------------------------------------
# CUDA shared memory: regions, cudaIPC across processes, serving over them
# ---------------------------------------------------------------------------

_GRANULE = 2 << 20  # the card's allocation granule


def _cudashm():
    from triton_client_tpu_torch.utils import cuda_shared_memory
    return cuda_shared_memory


def test_cuda_region_set_get_dlpack_and_views(cuda):
    cudashm = _cudashm()
    h = cudashm.create_shared_memory_region("r", 256, 0)
    try:
        assert h.tensor.is_cuda and h.tensor.numel() == 256
        x = np.arange(16, dtype=np.int32)
        cudashm.set_shared_memory_region(h, [x])
        cudashm.set_shared_memory_region(
            h, [np.arange(4, dtype=np.float32)], offset=64)
        # the offset write kept the earlier bytes
        np.testing.assert_array_equal(
            cudashm.get_contents_as_numpy(h, np.int32, [16]), x)
        np.testing.assert_array_equal(cudashm.get_contents_as_numpy(
            h, np.float32, [4], offset=64), np.arange(4))
        words = np.array([b"gpu", b"", b"\xff shm"], dtype=object)
        cudashm.set_shared_memory_region(h, [words], offset=128)
        assert cudashm.get_contents_as_numpy(
            h, np.object_, [3], offset=128).tolist() == words.tolist()
        src = torch.arange(32, device=cuda, dtype=torch.bfloat16)
        cudashm.set_shared_memory_region_from_dlpack(h, [src])
        view = cudashm.as_shared_memory_tensor(h, "BF16", [4, 8])
        assert view.data_ptr() == h.tensor.data_ptr()  # zero-copy
        assert torch.equal(view.flatten(), src)
        at = cudashm.as_shared_memory_tensor(h, "INT32", [2], offset=192)
        assert at.data_ptr() == h.tensor.data_ptr() + 192
        assert torch.from_dlpack(view).data_ptr() == view.data_ptr()
        with pytest.raises(cudashm.CudaSharedMemoryException):
            cudashm.set_shared_memory_region(h, [np.zeros(65, np.int32)])
    finally:
        cudashm.destroy_shared_memory_region(h)
    assert cudashm.allocated_shared_memory_regions() == []


_IMPORTER = """
import base64, json, sys
import torch
from triton_client_tpu_torch.server.shm import CudaShmRegistry
from triton_client_tpu_torch.server.types import ShmRef
raw, n = base64.b64decode(sys.argv[1]), int(sys.argv[2])
reg = CudaShmRegistry()
reg.register("r", raw, 0, n)
x = reg.read(ShmRef("r", n // 2, 0), "INT32", [n // 8])
print(json.dumps(x.cpu().tolist()))
reg.write(ShmRef("r", n // 2, n // 2), x * 3)
torch.cuda.synchronize()
reg.unregister(None)
"""


def _child_env():
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    return env


def test_cuda_region_mapped_by_another_process(cuda):
    """A spawned process maps the region with cudaIpcOpenMemHandle, reads
    this process's bytes and writes its own back."""
    import base64
    import subprocess
    import sys

    cudashm = _cudashm()
    n = 4096
    h = cudashm.create_shared_memory_region("ipc", n, 0)
    try:
        x = np.arange(n // 8, dtype=np.int32) * 7
        cudashm.set_shared_memory_region(h, [x])
        raw = base64.b64encode(cudashm.get_raw_handle(h)).decode()
        out = subprocess.run([sys.executable, "-c", _IMPORTER, raw, str(n)],
                             capture_output=True, text=True, timeout=600,
                             env=_child_env())
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.splitlines()[-1]) == x.tolist()
        np.testing.assert_array_equal(cudashm.get_contents_as_numpy(
            h, np.int32, [n // 8], offset=n // 2), x * 3)
    finally:
        cudashm.destroy_shared_memory_region(h)


_EXPORTER = """
import base64, sys
from triton_client_tpu_torch.utils import cuda_shared_memory as cudashm
import numpy as np
h = cudashm.create_shared_memory_region("big", int(sys.argv[1]), 0)
cudashm.set_shared_memory_region(h, [np.arange(64, dtype=np.int32)])
print(base64.b64encode(cudashm.get_raw_handle(h)).decode(), flush=True)
sys.stdin.readline()
cudashm.destroy_shared_memory_region(h)
"""


@pytest.mark.parametrize("order", ["unregister_first", "client_exits_first"])
def test_unregister_gives_the_memory_back(cuda, order):
    """A region of another process, mapped by the server's registry: after
    unregister and the client's exit the card's free memory is back within
    one allocation granule, whichever goes first, and status still answers
    after the client is gone."""
    import base64
    import subprocess
    import sys

    from triton_client_tpu_torch.server.shm import CudaShmRegistry
    from triton_client_tpu_torch.server.types import ShmRef

    n = 64 << 20

    def free():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.mem_get_info()[0]

    free0 = free()
    child = subprocess.Popen([sys.executable, "-c", _EXPORTER, str(n)],
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                             text=True, env=_child_env())
    try:
        raw = base64.b64decode(child.stdout.readline())
        reg = CudaShmRegistry()
        reg.register("big", raw, 0, n)
        assert free() <= free0 - n  # the child's region (and context)
        got = reg.read(ShmRef("big", 256, 0), "INT32", [64])
        assert got.cpu().tolist() == list(range(64))
        if order == "unregister_first":
            reg.unregister("big")
        child.stdin.write("\n")
        child.stdin.flush()
        assert child.wait(timeout=300) == 0
        assert list(reg.status(None)) == (
            [] if order == "unregister_first" else ["big"])
        reg.unregister(None)
        assert reg.status(None) == {}
    finally:
        if child.poll() is None:
            child.kill()
    assert abs(free() - free0) <= _GRANULE


def _http(port, method, path, body=None):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request(method, path,
                     None if body is None else json.dumps(body).encode())
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    assert resp.status == 200, data[:500]
    return json.loads(data) if data else None


def _shm_infer(port, model, inputs, outputs):
    """Register a CUDA region per tensor, write ``inputs`` ({name: array}),
    infer with every tensor in a region, read ``outputs`` ({name: (dtype,
    shape)}), unregister and free.  Returns the outputs."""
    cudashm = _cudashm()
    regions, specs, outs = {}, [], []
    try:
        for name, arr in inputs.items():
            h = regions[name] = cudashm.create_shared_memory_region(
                name, arr.nbytes, 0)
            cudashm.set_shared_memory_region(h, [arr])
            specs.append({"name": name, "datatype": "INT32",
                          "shape": list(arr.shape), "parameters": {
                              "shared_memory_region": name,
                              "shared_memory_byte_size": arr.nbytes}})
        for name, (dtype, shape) in outputs.items():
            nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
            regions[name] = cudashm.create_shared_memory_region(
                name, nbytes, 0)
            outs.append({"name": name, "parameters": {
                "shared_memory_region": name,
                "shared_memory_byte_size": nbytes}})
        for name, h in regions.items():
            _http(port, "POST",
                  f"/v2/cudasharedmemory/region/{name}/register",
                  {"raw_handle": {"b64": base64.b64encode(
                      cudashm.get_raw_handle(h)).decode()},
                   "device_id": 0, "byte_size": h.byte_size})
        resp = _http(port, "POST", f"/v2/models/{model}/infer",
                     {"inputs": specs, "outputs": outs})
        assert all("data" not in o and o["parameters"][
            "shared_memory_region"] == o["name"] for o in resp["outputs"])
        got = {name: cudashm.get_contents_as_numpy(regions[name], dtype,
                                                   shape)
               for name, (dtype, shape) in outputs.items()}
        _http(port, "POST", "/v2/cudasharedmemory/unregister")
        assert _http(port, "GET", "/v2/cudasharedmemory/status") == []
        return got
    finally:
        for h in regions.values():
            cudashm.destroy_shared_memory_region(h)


def test_served_over_cuda_shm(cuda, monkeypatch):
    """``simple`` (a host model: its region inputs pay one device-to-host
    copy) and the tiny ``longctx_tpu`` on the card (its region input read in
    place) served with every tensor in a CUDA region; LOGPROBS equal to the
    model's own forward on the same tokens within 1e-6."""
    from triton_client_tpu_torch.models import zoo
    from triton_client_tpu_torch.server.registry import ModelRegistry
    from triton_client_tpu_torch.server.testing import ServerHarness

    monkeypatch.setenv("TRITON_TPU_LONGCTX_PRESET", "tiny")
    for var in ("TRITON_TPU_QUANT", "TRITON_TPU_QUANT_LONGCTX_TPU"):
        monkeypatch.delenv(var, raising=False)
    longctx = language.make_longctx_tpu("cuda")
    S = longctx.config.input[0].dims[0]
    reg = ModelRegistry()
    reg.register_model(zoo.make_simple())
    reg.register_model(longctx)
    rng = np.random.default_rng(21)
    a = rng.integers(-100, 100, (1, 16)).astype(np.int32)
    b = rng.integers(-100, 100, (1, 16)).astype(np.int32)
    tokens = rng.integers(0, 256, (2, S)).astype(np.int32)
    with ServerHarness(reg) as hs:
        got = _shm_infer(hs.http_port, "simple",
                         {"INPUT0": a, "INPUT1": b},
                         {"OUTPUT0": (np.int32, [1, 16]),
                          "OUTPUT1": (np.int32, [1, 16])})
        np.testing.assert_array_equal(got["OUTPUT0"], a + b)
        np.testing.assert_array_equal(got["OUTPUT1"], a - b)
        lp = _shm_infer(hs.http_port, "longctx_tpu", {"TOKENS": tokens},
                        {"LOGPROBS": (np.float32, [2, S])})["LOGPROBS"]
    t = torch.from_numpy(tokens).to(cuda)
    with torch.inference_mode():
        want = language.longctx_scores(longctx.transformer(t), t)
    assert np.isfinite(lp).all()
    np.testing.assert_allclose(lp, want.cpu().numpy(), rtol=0, atol=1e-6)


def test_hbm_headroom_is_free_plus_allocator_spare(cuda):
    """The memory governor's device headroom (``memory.hbm_stats``): the
    card's free bytes plus the caching allocator's reserved-but-
    unallocated bytes, never more than the card holds; a tensor freed into
    the allocator's cache stays headroom."""
    from triton_client_tpu_torch.server.memory import MemoryGovernor

    gov = MemoryGovernor()
    x = torch.empty(256 << 20, dtype=torch.uint8, device=cuda)
    del x  # its block stays reserved, now unallocated
    free, total = torch.cuda.mem_get_info()
    spare = torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
    assert spare >= 256 << 20
    headroom = gov.hbm_headroom()
    # the free count moves between the two reads only by other work
    assert abs(headroom - (free + spare)) <= 64 << 20
    assert 0 < headroom <= total
    rows = gov.metric_rows()["hbm_headroom"]
    assert rows and rows[0][0] == {"device": "cuda:0"}
    torch.cuda.empty_cache()


@pytest.mark.parametrize("protocol", ["http", "grpc"])
def test_admission_changes_no_launch_of_an_admitted_request(cuda,
                                                            monkeypatch,
                                                            protocol):
    """``longctx_tpu`` base int8 ``all`` served under a queue bound, a
    tenant, a priority and a deadline: an admitted request launches what it
    launches without them (8 flash, 16 int8 per forward); a request shed by
    the memory budget and one past its deadline launch nothing."""
    from triton_client_tpu_torch import grpc as tgrpc
    from triton_client_tpu_torch import http as thttp
    from triton_client_tpu_torch.server.registry import ModelRegistry
    from triton_client_tpu_torch.server.testing import ServerHarness
    from triton_client_tpu_torch.utils import InferenceServerException

    for var in ("TRITON_TPU_LONGCTX_PRESET", "TRITON_TPU_FLASH_MIN_S",
                "TRITON_TPU_FLASH"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("TRITON_TPU_QUANT_LONGCTX_TPU", "int8")
    monkeypatch.setenv("TRITON_TPU_INT8_FUSED", "all")
    model = language.make_longctx_tpu("cuda")
    layers = model.transformer.cfg.n_layers
    reg = ModelRegistry()
    reg.register_model(model)
    mod = tgrpc if protocol == "grpc" else thttp
    tokens = np.random.default_rng(3).integers(0, 256, (4, 4096)).astype(
        np.int32)
    with ServerHarness(reg) as hs:
        hs.core.default_max_queue_size = 8
        c = mod.InferenceServerClient(hs.http_url)
        inp = mod.InferInput("TOKENS", [4, 4096], "INT32")
        inp.set_data_from_numpy(tokens)

        def launches(**kw):
            f0, i0 = fa.launches, im.launches
            try:
                out = c.infer("longctx_tpu", [inp], **kw).as_numpy(
                    "LOGPROBS")
            except InferenceServerException as e:
                out = e
            return out, fa.launches - f0, im.launches - i0

        plain, f, i = launches()
        assert (f, i) == (layers, 2 * layers)
        got, f, i = launches(tenant="gold", priority=1, deadline_s=60.0)
        assert (f, i) == (layers, 2 * layers)
        np.testing.assert_array_equal(got, plain)
        err, f, i = launches(timeout=1)
        assert "deadline" in str(err) and (f, i) == (0, 0)
        hs.core.memory.budget_bytes = 1000
        err, f, i = launches()
        assert "memory budget" in str(err) and (f, i) == (0, 0)
        c.close()


# ---------------------------------------------------------------------------
# generation (models/decode.py)
# ---------------------------------------------------------------------------

def test_decode_readback_pair_on_card(cuda):
    """start_readback copies into pinned memory behind a CUDA event and
    returns at once; finish_readback waits on the event: the values are
    those the tensor held when the copy was queued."""
    from triton_client_tpu_torch.models import decode

    x = torch.arange(12, dtype=torch.float32, device=cuda).reshape(3, 4)
    pending = decode.start_readback(x)
    assert pending.host.is_pinned()
    x.add_(100)  # queued after the copy
    np.testing.assert_array_equal(decode.finish_readback(pending),
                                  np.arange(12, dtype=np.float32)
                                  .reshape(3, 4))
    assert decode.readback_ready(pending)


def test_decode_batched_tick_on_card(cuda, monkeypatch):
    """A T = 4 fused tick of the tiny preset (in f32) on the card: the
    worker's thread starts on the card, two batched generations give the
    same tokens as their independent chains on the card, and a closed-loop
    sequence interleaves with them; a sampled request reproduces from its
    seed and top_k = 1 is greedy."""
    import dataclasses
    import threading

    from triton_client_tpu_torch.models import decode

    monkeypatch.setitem(language._LLAMA_PRESETS, "tiny", dataclasses.replace(
        language._LLAMA_PRESETS["tiny"], dtype=torch.float32))
    monkeypatch.setenv("TRITON_TPU_LLAMA_PRESET", "tiny")
    monkeypatch.setenv("TRITON_TPU_DECODE_STEPS", "4")
    monkeypatch.setenv("TRITON_TPU_DECODE_SLOTS", "4")
    monkeypatch.setenv("TRITON_TPU_DECODE_MODE", "independent")
    ind = decode.DecodeModel(name="llama_decode_i", device="cuda")
    monkeypatch.setenv("TRITON_TPU_DECODE_MODE", "batched")
    bat = decode.DecodeModel(name="llama_decode_b", device="cuda")
    gi, gb = decode.GenerateModel(ind), decode.GenerateModel(bat)

    def toks(g, prompt, n, **params):
        return [int(f["token_id"][0]) for f in g._generate(
            {"text_input": np.array([prompt], object)},
            {"max_tokens": n, **params})]

    want = {p: toks(gi, p, 13) for p in (b"first prompt", b"second one")}
    got = {}
    threads = [threading.Thread(target=lambda p=p: got.__setitem__(
        p, toks(gb, p, 13))) for p in want]
    for t in threads:
        t.start()
    win = np.zeros(128, np.int32)
    res = bat._execute({"TOKENS": win},
                       {"sequence_id": 7, "sequence_start": True})
    for i in range(3):
        res = bat._execute({"TOKENS": res["NEXT_TOKEN"]},
                           {"sequence_id": 7, "sequence_end": i == 2})
    for t in threads:
        t.join(timeout=120)
    bat._shutdown()
    assert got == want
    # a sampled request draws on the card from a generator of its seed
    sampled = toks(gi, b"first prompt", 9, temperature=1.5, seed=4)
    assert sampled == toks(gi, b"first prompt", 9, temperature=1.5, seed=4)
    assert toks(gi, b"first prompt", 9, temperature=1.5, top_k=1,
                seed=5) == want[b"first prompt"][:9]
