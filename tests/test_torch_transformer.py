"""The port's transformer forward against the JAX package's.

The reference's own weights -- ``init_params(PRNGKey(11), cfg)`` for the
tiny ``longctx_tpu`` preset, the model's seed -- are carried to the port as
numpy arrays (``params_from_jax``), and the same tokens go through both
``make_forward``s on the CPU.  Every case runs twice: with
``TRITON_TPU_FLASH_MIN_S=64`` in both packages (the flash branch) and with
it unset (S = 128 is below the default gate of 1024: the single-shard ring).

Tolerances on logits: f32 1e-4 (f32 matmuls summing in different orders
through two layers); bf16 5e-2 (bf16 rounds at different places in XLA and
PyTorch); int8 1e-2 in f32.  The int8 bound is not 1e-3: the two packages'
f32 sums differ in the last bits, so an activation that lies within an ulp
of a rounding boundary takes the neighbouring int8 code in one of them, and
through causal attention that one flipped code moves every later position's
logits.  Over six token draws (logits of magnitude ~0.7) the difference was
either ~3e-7 (no flipped code) or 9e-4 to 6.3e-3 (one or more), for both
attention branches and every ``TRITON_TPU_INT8_FUSED`` setting.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from triton_client_tpu.models import language as jlang
from triton_client_tpu.models import transformer as jtr
from triton_client_tpu_torch.models import language as tlang
from triton_client_tpu_torch.models import transformer as ttr

B, S = 2, 128


def _jax_cfg(dtype):
    return dataclasses.replace(jlang._LONGCTX_PRESETS["tiny"][0], dtype=dtype)


def _torch_cfg(dtype):
    fields = {f.name: getattr(_jax_cfg(jnp.float32), f.name)
              for f in dataclasses.fields(jtr.TransformerConfig)
              if f.name != "dtype"}
    return ttr.TransformerConfig(**fields, dtype=dtype)


@pytest.fixture(scope="module")
def jax_params():
    cfg = _jax_cfg(jnp.float32)
    params = jtr.init_params(jax.random.PRNGKey(11), cfg)
    return params, jtr.quantize_layer_weights(params, cfg)


@pytest.fixture(scope="module")
def tokens():
    rng = np.random.default_rng(3)
    return rng.integers(0, 256, (B, S), dtype=np.int32)


def _np_params(params):
    return {k: np.asarray(v) for k, v in params.items()}


def _run_jax(params, tokens, jdtype, quantized):
    cfg = _jax_cfg(jdtype)
    mesh = jtr.make_mesh(1, cfg)
    fwd = jtr.make_forward(mesh, cfg, quantized=quantized)
    return np.asarray(fwd(jtr.place_params(params, mesh, cfg),
                          jnp.asarray(tokens)), np.float32)


def _run_torch(np_params, tokens, tdtype, quantized):
    cfg = _torch_cfg(tdtype)
    params = ttr.params_from_jax(np_params, cfg, device="cpu")
    fwd = ttr.make_forward(cfg, quantized=quantized)
    with torch.inference_mode():
        return fwd(params, torch.from_numpy(tokens)).numpy()


@pytest.fixture(params=["flash", "ring"])
def attention_branch(request, monkeypatch):
    if request.param == "flash":
        monkeypatch.setenv("TRITON_TPU_FLASH_MIN_S", "64")
    else:
        monkeypatch.delenv("TRITON_TPU_FLASH_MIN_S", raising=False)
    monkeypatch.delenv("TRITON_TPU_FLASH", raising=False)
    return request.param


@pytest.mark.parametrize("jdtype,tdtype,atol", [
    (jnp.float32, torch.float32, 1e-4),
    (jnp.bfloat16, torch.bfloat16, 5e-2),
])
def test_forward_matches_jax(jax_params, tokens, attention_branch, jdtype,
                             tdtype, atol):
    params, _ = jax_params
    want = _run_jax(params, tokens, jdtype, quantized=False)
    got = _run_torch(_np_params(params), tokens, tdtype, quantized=False)
    assert got.shape == (B, S, 256)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("fused", ["w2", "all", "0"])
def test_int8_forward_matches_jax(jax_params, tokens, attention_branch,
                                  monkeypatch, fused):
    monkeypatch.setenv("TRITON_TPU_INT8_FUSED", fused)
    _, qparams = jax_params
    want = _run_jax(qparams, tokens, jnp.float32, quantized=True)
    got = _run_torch(_np_params(qparams), tokens, torch.float32,
                     quantized=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)


@pytest.mark.parametrize("fused", ["w2", "all", "0"])
def test_int8_forward_kmajor_weights_matches_jax(jax_params, tokens,
                                                 attention_branch,
                                                 monkeypatch, fused):
    """The port's own ``quantize_layer_weights`` stores every int8 weight
    K-major; its forward still matches the JAX int8 forward within the
    int8 bound (atol 1e-2)."""
    monkeypatch.setenv("TRITON_TPU_INT8_FUSED", fused)
    params, qparams = jax_params
    want = _run_jax(qparams, tokens, jnp.float32, quantized=True)
    cfg = _torch_cfg(torch.float32)
    tq = ttr.quantize_layer_weights(
        ttr.params_from_jax(_np_params(params), cfg), cfg)
    assert tq["w2"][0].stride() == (1, cfg.d_ff)
    fwd = ttr.make_forward(cfg, quantized=True)
    with torch.inference_mode():
        got = fwd(tq, torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)


def test_quantized_weights_stored_kmajor(jax_params):
    """Each layer's int8 ``[K, N]`` matrix, as the forward reshapes it, is a
    view of K-major storage: no call copies a weight."""
    params, _ = jax_params
    cfg = _torch_cfg(torch.float32)
    tq = ttr.quantize_layer_weights(
        ttr.params_from_jax(_np_params(params), cfg), cfg)
    D, H, K, Fd = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
    mats = {"wq": (D, H * K), "wk": (D, H * K), "wv": (D, H * K),
            "wo": (H * K, D), "w1": (D, Fd), "w2": (Fd, D)}
    for name, (k, n) in mats.items():
        for layer in range(cfg.n_layers):
            w = tq[name][layer]
            m = w.reshape(k, n)
            assert m.data_ptr() == w.data_ptr(), name
            assert m.stride() == (1, k), (name, m.stride())
            assert m.t().is_contiguous(), name


def test_quantize_layer_weights_bit_exact(jax_params):
    params, qparams = jax_params
    cfg = _torch_cfg(torch.float32)
    got = ttr.quantize_layer_weights(
        ttr.params_from_jax(_np_params(params), cfg), cfg)
    assert sorted(got) == sorted(qparams)
    for name, want in qparams.items():
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want),
                                      err_msg=name)


def test_plain_forward_equals_kernel_forward_on_cpu(jax_params, tokens,
                                                    monkeypatch):
    """On the CPU the wrappers run the plain versions, so the reference
    forward (``plain=True``) is the same computation."""
    monkeypatch.setenv("TRITON_TPU_FLASH_MIN_S", "64")
    params, _ = jax_params
    cfg = _torch_cfg(torch.float32)
    tp = ttr.params_from_jax(_np_params(params), cfg)
    t = torch.from_numpy(tokens)
    with torch.inference_mode():
        a = ttr.make_forward(cfg)(tp, t)
        b = ttr.make_forward(cfg, plain=True)(tp, t)
    assert torch.equal(a, b)


def test_quantized_flag_checks_params(jax_params, tokens):
    params, _ = jax_params
    cfg = _torch_cfg(torch.float32)
    tp = ttr.params_from_jax(_np_params(params), cfg)
    with pytest.raises(ValueError, match="quantized=True"):
        ttr.make_forward(cfg, quantized=True)(tp, torch.from_numpy(tokens))


def test_presets_and_accounting_match_jax():
    for name, (jcfg, seq) in jlang._LONGCTX_PRESETS.items():
        tcfg, tseq = tlang._LONGCTX_PRESETS[name]
        assert tseq == seq
        for f in dataclasses.fields(jtr.TransformerConfig):
            if f.name != "dtype":
                assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
        assert tlang.n_params(tcfg) == jlang.n_params(jcfg)
        assert tlang.forward_flops_per_token(tcfg, seq) == \
            jlang.forward_flops_per_token(jcfg, seq)


def test_preset_follows_the_requested_device(monkeypatch):
    monkeypatch.delenv("TRITON_TPU_LONGCTX_PRESET", raising=False)
    assert tlang.longctx_seq_len("cpu") == 512
    monkeypatch.setenv("TRITON_TPU_LONGCTX_PRESET", "base")
    assert tlang.longctx_seq_len("cpu") == 4096
    monkeypatch.setenv("TRITON_TPU_LONGCTX_PRESET", "huge")
    with pytest.raises(ValueError, match="TRITON_TPU_LONGCTX_PRESET"):
        tlang.longctx_cfg("cpu")


def test_torch_init_params_shapes_match_jax():
    jcfg = _jax_cfg(jnp.float32)
    jp = jax.eval_shape(lambda: jtr.init_params(jax.random.PRNGKey(0), jcfg))
    tp = ttr.init_params(torch.Generator().manual_seed(0),
                         _torch_cfg(torch.float32))
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
