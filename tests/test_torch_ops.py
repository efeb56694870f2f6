"""The port's kernel wrappers against the JAX package's ops.

Same numpy inputs, made from a seed, go through ``triton_client_tpu.ops``
(its jnp reference and its Pallas kernel in interpret mode) and through
``triton_client_tpu_torch.ops``.  On the CPU the port's wrappers run their
plain versions; the CUDA kernels themselves are held to those plain versions
on the card by tests/test_torch_cuda.py and ``chip_smoke.py``.

Tolerances: flash attention in f32 to atol 1e-5 (two f32 softmax
implementations summing in different orders); bf16 compared as f32 to atol
2e-2 (one bf16 rounding of an O(1) output is 2**-8); int8 bit-exact against
the JAX reference run op by op (the same f32 divide, round-half-even, exact
s32 sums and epilogue order).  The int8 cases are not held to the JAX Pallas
kernel: interpret mode runs under ``jax.jit``, where XLA rewrites the
reference's ``max(amax, 1e-12) / 127.0`` into a multiply by the f32 constant
1/127, so that kernel flips an occasional int8 code against the JAX
reference itself.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from triton_client_tpu import ops as jops
from triton_client_tpu import parallel as jparallel
from triton_client_tpu.models import transformer as jtr
from triton_client_tpu_torch import ops as tops
from triton_client_tpu_torch.models import transformer as ttr
from triton_client_tpu_torch.parallel import ring_attention

t_flash = importlib.import_module("triton_client_tpu_torch.ops.flash_attention")
t_int8 = importlib.import_module("triton_client_tpu_torch.ops.int8_matmul")


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(arr, jdtype, tdtype):
    return jnp.asarray(arr, dtype=jdtype), torch.from_numpy(arr).to(tdtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

class TestFlashAttention:
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("shape", [
        (1, 2, 128, 64),   # block-aligned
        (2, 4, 384, 64),   # multi-block
        (1, 2, 100, 32),   # S not a block multiple
        (1, 1, 8, 16),     # S smaller than any block
    ])
    def test_matches_jax_kernel_and_reference(self, shape, causal):
        (jq, tq), (jk, tk), (jv, tv) = (
            _both(_rand(shape, s), jnp.float32, torch.float32)
            for s in (1, 2, 3))
        got = _np(tops.flash_attention(tq, tk, tv, causal=causal))
        want_ref = _np(jops.flash_attention_reference(jq, jk, jv,
                                                      causal=causal))
        want_kernel = _np(jops.flash_attention(jq, jk, jv, causal=causal,
                                               interpret=True))
        np.testing.assert_allclose(got, want_ref, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got, want_kernel, rtol=0, atol=1e-5)

    def test_bf16_inputs_accumulate_in_fp32(self):
        shape = (1, 2, 128, 64)
        (jq, tq), (jk, tk), (jv, tv) = (
            _both(_rand(shape, s), jnp.bfloat16, torch.bfloat16)
            for s in (4, 5, 6))
        got = tops.flash_attention(tq, tk, tv, causal=True)
        assert got.dtype == torch.bfloat16
        want = jops.flash_attention(jq, jk, jv, causal=True, interpret=True)
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=2e-2)

    def test_custom_scale(self):
        shape = (1, 1, 64, 32)
        (jq, tq), (jk, tk), (jv, tv) = (
            _both(_rand(shape, s), jnp.float32, torch.float32)
            for s in (7, 8, 9))
        got = tops.flash_attention(tq, tk, tv, causal=True, sm_scale=0.5)
        want = jops.flash_attention(jq, jk, jv, causal=True, sm_scale=0.5,
                                    interpret=True)
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-5)

    def test_cpu_tensors_take_the_plain_version(self):
        shape = (1, 1, 16, 8)
        q, k, v = (torch.from_numpy(_rand(shape, s)) for s in (10, 11, 12))
        before = t_flash.launches
        got = tops.flash_attention(q, k, v, causal=True)
        want = tops.flash_attention_reference(q, k, v, causal=True)
        assert torch.equal(got, want)
        assert t_flash.launches == before  # no kernel launch counted

    def test_cpu_path_gradients_match_jax(self):
        # the CPU path is the plain version, differentiable as the
        # reference's op is (its custom_vjp recomputes through the jnp
        # reference); only the CUDA kernel refuses grad (ROADMAP A1)
        shape = (1, 2, 40, 16)
        (jq, tq), (jk, tk), (jv, tv) = (
            _both(_rand(shape, s), jnp.float32, torch.float32)
            for s in (13, 14, 15))
        w = _rand(shape, 16)
        for t in (tq, tk, tv):
            t.requires_grad_()
        (tops.flash_attention(tq, tk, tv, causal=True)
         * torch.from_numpy(w)).sum().backward()
        want = jax.grad(
            lambda q, k, v: (jops.flash_attention(
                q, k, v, causal=True, interpret=True) * w).sum(),
            argnums=(0, 1, 2))(jq, jk, jv)
        for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
            np.testing.assert_allclose(_np(got), _np(ref), rtol=0,
                                       atol=1e-5)

    def test_matches_ring_attention_single_shard(self):
        """The substitution the transformer makes at the flash gate: the
        port's flash, the port's ring and the JAX ring at sp = 1 agree."""
        cfg = jtr.TransformerConfig(n_layers=1, d_model=32, n_heads=2,
                                    head_dim=16, d_ff=64, vocab_size=64)
        shape = (1, 2, 16, 16)
        (jq, tq), (jk, tk), (jv, tv) = (
            _both(_rand(shape, s), jnp.float32, torch.float32)
            for s in (13, 14, 15))
        from jax.sharding import PartitionSpec as P

        mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("sp",))
        jring = jparallel.shard_map(
            lambda q, k, v: jtr._ring_attention(q, k, v, cfg),
            mesh=mesh, in_specs=(P(), P(), P()), out_specs=P(),
            check_vma=False)(jq, jk, jv)
        tring = ring_attention(tq, tk, tv, causal=True)
        got = tops.flash_attention(tq, tk, tv, causal=True)
        np.testing.assert_allclose(_np(tring), _np(jring), rtol=0, atol=1e-5)
        np.testing.assert_allclose(_np(got), _np(jring), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# int8 matmul
# ---------------------------------------------------------------------------

def _mk(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    ws = ((np.abs(rng.standard_normal(n)) + 0.01) * 0.02).astype(np.float32)
    return x, w, ws


def _int8_pair(x, w, ws, jdtype=jnp.bfloat16, tdtype=torch.bfloat16):
    return ((jnp.asarray(x, jdtype), jnp.asarray(w), jnp.asarray(ws)),
            (torch.from_numpy(x).to(tdtype), torch.from_numpy(w),
             torch.from_numpy(ws)))


def _assert_bits_equal(got, want):
    np.testing.assert_array_equal(_np(got), _np(want))


class TestInt8Matmul:
    @pytest.mark.parametrize("m,k,n,seed", [
        (64, 256, 128, 0),   # test_exact_vs_reference
        (50, 128, 128, 1),   # test_padded_m: M not a block multiple
    ])
    def test_bit_exact_vs_jax(self, m, k, n, seed):
        (jx, jw, jws), (tx, tw, tws) = _int8_pair(*_mk(m, k, n, seed))
        got = tops.int8_matmul(tx, tw, tws)
        assert got.shape == (m, n) and got.dtype == torch.bfloat16
        _assert_bits_equal(got, jops.int8_matmul_reference(jx, jw, jws))

    def test_batched_leading_dims(self):
        x, w, ws = _mk(48, 128, 256, seed=2)
        x = x.reshape(4, 12, 128)
        (jx, jw, jws), (tx, tw, tws) = _int8_pair(x, w, ws)
        got = tops.int8_matmul(tx, tw, tws)
        assert got.shape == (4, 12, 256)
        _assert_bits_equal(got, jops.int8_matmul_reference(jx, jw, jws))

    def test_scale_shape_row_vector(self):
        (_, _, _), (tx, tw, tws) = _int8_pair(*_mk(32, 128, 128, seed=3))
        a = tops.int8_matmul(tx, tw, tws)
        b = tops.int8_matmul(tx, tw, tws.reshape(1, -1))
        assert torch.equal(a, b)

    def test_per_row_scale_isolation(self):
        x, w, ws = _mk(32, 128, 128, seed=7)
        x_hot = x.copy()
        x_hot[3] *= 1000.0
        outs = []
        for arr in (x, x_hot):
            (jx, jw, jws), (tx, tw, tws) = _int8_pair(
                arr, w, ws, jnp.float32, torch.float32)
            got = tops.int8_matmul_reference(tx, tw, tws)
            _assert_bits_equal(got, jops.int8_matmul_reference(jx, jw, jws))
            outs.append(_np(got))
        np.testing.assert_array_equal(np.delete(outs[0], 3, 0),
                                      np.delete(outs[1], 3, 0))

    def test_int32_accumulation_no_overflow(self):
        k = 8192
        x = np.ones((8, k), np.float32)
        w = np.full((k, 128), 127, np.int8)
        ws = np.ones((128,), np.float32)
        (jx, jw, jws), (tx, tw, tws) = _int8_pair(x, w, ws, jnp.float32,
                                                  torch.float32)
        out = tops.int8_matmul_reference(tx, tw, tws).double().numpy()
        assert np.all(np.isfinite(out))
        np.testing.assert_allclose(out, 127.0 * k, rtol=1e-6)
        _assert_bits_equal(tops.int8_matmul(tx, tw, tws),
                           jops.int8_matmul_reference(jx, jw, jws))

    def test_unaligned_k_takes_plain_path_on_cpu(self):
        (jx, jw, jws), (tx, tw, tws) = _int8_pair(*_mk(16, 96, 128, seed=5))
        before = t_int8.launches
        got = tops.int8_matmul(tx, tw, tws)
        assert t_int8.launches == before
        _assert_bits_equal(got, jops.int8_matmul(jx, jw, jws,
                                                 interpret=True))

    @pytest.mark.parametrize("m,k,n,seed", [(64, 256, 128, 21),
                                            (50, 128, 384, 22)])
    def test_kmajor_weight_bit_exact_vs_jax(self, m, k, n, seed):
        """A ``[K, N]`` weight stored K-major (the ``.t()`` of a contiguous
        ``[N, K]``, the layout the kernel reads) gives the row-major
        result and the JAX reference's, bit for bit."""
        x, w, ws = _mk(m, k, n, seed)
        (jx, jw, jws), (tx, tw, tws) = _int8_pair(x, w, ws)
        tw_k = tw.t().contiguous().t()
        assert tw_k.stride() == (1, k) and torch.equal(tw_k, tw)
        got = tops.int8_matmul(tx, tw_k, tws)
        assert torch.equal(got, tops.int8_matmul(tx, tw, tws))
        _assert_bits_equal(got, jops.int8_matmul_reference(jx, jw, jws))

    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    @pytest.mark.parametrize("shape", [(37, 256), (2, 9, 128)])
    def test_quantize_rows_matches_jax_int8_quant(self, dtype, shape):
        """The plain quantize-rows pass equals the reference's
        ``_int8_quant(h, (-1,))`` run op by op, codes and scales bit for
        bit, on rows that are all zero, hold one outlier, or are exact
        ties (amax 127: scale 1, quotients j + 0.5)."""
        h = _rand(shape, 23).reshape(-1, shape[-1])
        h[1] = 0.0
        h[2, 7] = 1000.0
        h[3] = np.arange(shape[-1]) % 254 - 126.5
        h[3, 0] = 127.0
        h = h.reshape(shape)
        jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                    else (jnp.bfloat16, torch.bfloat16))
        jh, th = _both(h, jdt, tdt)
        jq, js = jtr._int8_quant(jh, (-1,))
        q, xs = tops.int8_quantize_rows_reference(th)
        assert q.dtype == torch.int8 and xs.shape == (*shape[:-1], 1)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(xs.numpy(), np.asarray(js))
        assert np.all(q.numpy().reshape(-1, shape[-1])[1] == 0)
        cq, cxs = tops.int8_quantize_rows(th)  # CPU: the plain version
        assert torch.equal(cq, q) and torch.equal(cxs, xs)

    def test_plain_exact_dot_matches_int_mm(self):
        rng = np.random.default_rng(19)
        a = torch.from_numpy(rng.integers(-127, 128, (40, 64)).astype(np.int8))
        b = torch.from_numpy(rng.integers(-127, 128, (64, 24)).astype(np.int8))
        assert torch.equal(t_int8.exact_int_dot(a, b), torch._int_mm(a, b))
        assert torch.equal(ttr._int_dot(a[:5], b), torch._int_mm(a[:5], b))


# ---------------------------------------------------------------------------
# knob readers: same env, same answer (or the same loud rejection)
# ---------------------------------------------------------------------------

class TestKnobs:
    @pytest.mark.parametrize("val", [None, "0", "1", "all", "w1", "W2",
                                     "w1,w2", ""])
    def test_int8_fused_mode(self, monkeypatch, val):
        if val is None:
            monkeypatch.delenv("TRITON_TPU_INT8_FUSED", raising=False)
        else:
            monkeypatch.setenv("TRITON_TPU_INT8_FUSED", val)
        assert ttr._int8_fused_mode() == jtr._int8_fused_mode()

    def test_int8_fused_typo_rejected(self, monkeypatch):
        monkeypatch.setenv("TRITON_TPU_INT8_FUSED", "ffn_down")
        with pytest.raises(ValueError, match="unknown selector"):
            ttr._int8_fused_mode()

    @pytest.mark.parametrize("env,val", [
        ("TRITON_TPU_QUANT", "int8"), ("TRITON_TPU_QUANT", "bf16"),
        ("TRITON_TPU_QUANT_LONGCTX_TPU", "INT8"),
        ("TRITON_TPU_QUANT_LONGCTX_TPU", "none")])
    def test_resolve_quant(self, monkeypatch, env, val):
        monkeypatch.delenv("TRITON_TPU_QUANT", raising=False)
        monkeypatch.delenv("TRITON_TPU_QUANT_LONGCTX_TPU", raising=False)
        monkeypatch.setenv(env, val)
        assert ttr.resolve_quant("longctx_tpu") == \
            jtr.resolve_quant("longctx_tpu")

    def test_resolve_quant_typo_names_the_variable(self, monkeypatch):
        monkeypatch.setenv("TRITON_TPU_QUANT_LONGCTX_TPU", "int4")
        with pytest.raises(ValueError, match="TRITON_TPU_QUANT_LONGCTX_TPU"):
            ttr.resolve_quant("longctx_tpu")

    @pytest.mark.parametrize("flash,min_s", [(None, None), ("0", "64"),
                                             ("1", "2048")])
    def test_flash_gate(self, monkeypatch, flash, min_s):
        for var, val in (("TRITON_TPU_FLASH", flash),
                         ("TRITON_TPU_FLASH_MIN_S", min_s)):
            if val is None:
                monkeypatch.delenv(var, raising=False)
            else:
                monkeypatch.setenv(var, val)
        assert ttr._flash_enabled() == jtr._flash_enabled()
        assert ttr._flash_min_s() == jtr._flash_min_s()
