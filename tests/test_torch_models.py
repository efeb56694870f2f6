"""The port's MoE, encoder and next-token models against the JAX package's.

Weights are the reference's own ``init_params`` at each model's seed --
``PRNGKey(3)`` for the ``tiny-moe`` Llama preset, ``PRNGKey(17)`` for the
``moe_tpu`` tiny preset, ``PRNGKey(24)`` for the encoder at tiny widths --
carried to the port as numpy arrays, and the same tokens (numpy seeds) go
through both packages on the CPU.

Tolerances on logits, as in test_torch_transformer.py: f32 1e-4 (f32
matmuls summing in different orders); bf16 5e-2 (bf16 rounds at other
places in XLA and PyTorch); int8 1e-2 in f32 (an activation within an ulp
of a rounding boundary takes the neighbouring code in one package).  The
MoE int8 path is weight-only in its FFN (the same dequantized weights in
both packages), so its FFN adds no code flips of its own; the attention
projections take the int8 path as in the dense models.  The encoder cases
(``causal=False``, ``head_cols=2``) run twice: with
``TRITON_TPU_FLASH_MIN_S=64`` in both packages (the non-causal flash plain
version) and with it unset (the single-shard ring).

Routing: both packages score the router in f32 and keep every expert whose
score reaches the k-th largest.  One MoE layer fed the same input in both
packages (``test_moe_ffn_layer_matches_jax``) is held at every position:
f32 and int8 weight-only 1e-5, bf16 2**-5 (one bf16 ulp at the outputs'
magnitude, under 8).  Through the whole stack, bf16 activations (or, under
int8, activation codes) that differ in the last bit between the packages
move each router score by ~1e-4, so where the k-th and (k+1)-th scores lie
closer than that, one package keeps another expert: that position's logits
move by up to 0.36 and, through causal attention, later positions' by up to
~0.1.  Observed (tokens below): llama ``tiny-moe`` bf16 0.202 at a margin
of 2.8e-4 to 5.4e-4, int8 0.172 at 2.6e-4; ``moe_tpu`` tiny bf16 0.360 at
2.9e-5 to 4.2e-4; int8 none.  f32 never flipped (margins down to 3.3e-5
against f32 noise of ~1e-7).  So ``test_moe_forward_matches_jax`` holds
f32 at every position, and bf16 and int8 at every position before its
row's first routing margin under ``ROUTE_EPS`` = 2e-3 (4x the largest
margin that flipped): 91 and 57 of 256 positions (llama), 107 and 138
(``moe_tpu``), max error there 5.3e-3 / 2.5e-7 and 6.9e-3 / 3.0e-7.

``bert_large`` runs here at tiny widths only (its config and FLOPs are
checked at full width).  On the card, ``chip_smoke.py`` holds the served
full-width LOGITS (and ``moe_tpu``'s and ``llama_tpu``'s NEXT_LOGIT) to the
port's plain-kernel forward of the same tokens within its per-model
``SERVED_ATOL``: 1e-4 for ``bert_large`` and ``moe_tpu`` in bf16 and int8
and for ``llama_tpu`` int8, 3e-2 for ``llama_tpu`` bf16 (whose bf16 GEMMs
at M = 128-256 sum differently with the batch), each beside a planted
fault's reading that must exceed it.

Served ``moe_tpu`` / ``llama_tpu`` (tiny, bf16): ``NEXT_LOGIT`` within the
bf16 bound 5e-2 of the JAX server's, and ``NEXT_TOKEN`` equal to the JAX
server's -- or, where the two differ (an argmax over near-tied logits of
random weights), the JAX forward's logit at the port's token within 5e-2 of
its maximum.  Over the 3 x 4 token rows below that allowance was needed 0
times.
"""

import dataclasses
import json
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jax.sharding import PartitionSpec as P

from triton_client_tpu import http as httpclient
from triton_client_tpu import parallel as jparallel
from triton_client_tpu.models import language as jlang
from triton_client_tpu.models import transformer as jtr
from triton_client_tpu.server.registry import ModelRegistry as JaxRegistry
from triton_client_tpu.server.testing import ServerHarness as JaxHarness
from triton_client_tpu_torch.models import language as tlang
from triton_client_tpu_torch.models import transformer as ttr
from triton_client_tpu_torch.server.registry import ModelRegistry
from triton_client_tpu_torch.server.testing import ServerHarness

B, S = 2, 128
LOGIT_ATOL = 5e-2  # bf16 logits; NEXT_LOGIT and the near-tie allowance
ROUTE_EPS = 2e-3   # a routing margin below this is a near-tie

MOE_CASES = {
    "llama-tiny-moe": (jlang._LLAMA_PRESETS["tiny-moe"], 3),
    "moe_tpu-tiny": (jlang._MOE_PRESETS["tiny"][0], 17),
}
# the encoder at tiny widths: bert_large's direction and span head
ENCODER = dataclasses.replace(jlang._LLAMA_PRESETS["tiny"], causal=False)


def _torch_cfg(jcfg, dtype):
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jtr.TransformerConfig)
              if f.name != "dtype"}
    return ttr.TransformerConfig(**fields, dtype=dtype)


def _np(params):
    return {k: np.asarray(v) for k, v in params.items()}


def _tokens(vocab, seed=3, b=B, s=S):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


def _run_jax(jcfg, params, tokens, quantized, head_cols=None):
    mesh = jtr.make_mesh(1, jcfg)
    fwd = jtr.make_forward(mesh, jcfg, quantized=quantized,
                           head_cols=head_cols)
    return np.asarray(fwd(jtr.place_params(params, mesh, jcfg),
                          jnp.asarray(tokens)), np.float32)


def _run_torch(tcfg, np_params, tokens, quantized, head_cols=None):
    fwd = ttr.make_forward(tcfg, quantized=quantized, head_cols=head_cols)
    with torch.inference_mode():
        return fwd(ttr.params_from_jax(np_params, tcfg),
                   torch.from_numpy(tokens)).numpy()


@pytest.fixture(scope="module", params=sorted(MOE_CASES))
def moe_case(request):
    jcfg, seed = MOE_CASES[request.param]
    params = jtr.init_params(jax.random.PRNGKey(seed),
                             dataclasses.replace(jcfg, dtype=jnp.float32))
    return jcfg, params


# ---------------------------------------------------------------------------
# MoE forward
# ---------------------------------------------------------------------------

_DTYPES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16),
           "int8": (jnp.float32, torch.float32)}


def _case_params(jcfg, params, case):
    return jtr.quantize_layer_weights(params, jcfg) if case == "int8" \
        else params


@pytest.mark.parametrize("case,atol", [("f32", 1e-5), ("bf16", 2 ** -5),
                                       ("int8", 1e-5)])
def test_moe_ffn_layer_matches_jax(moe_case, case, atol):
    """One MoE FFN layer, the same input in both packages: routing sees the
    same activations, so every position is held (bf16: one ulp at the
    outputs' magnitude, |x + out| < 8; int8 is weight-only here, f32)."""
    jcfg, params = moe_case
    jdtype, tdtype = _DTYPES[case]
    jcfg = dataclasses.replace(jcfg, dtype=jdtype)
    p = _case_params(jcfg, params, case)
    blk = {k: v[0] for k, v in p.items()
           if k.split("_scale")[0] in ("ln2", "router", "we1", "we2")}
    x = np.random.default_rng(5).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    mesh = jtr.make_mesh(1, jcfg)
    f = jax.jit(jparallel.shard_map(
        lambda b, h: jtr._ffn_apply(b, h, jcfg), mesh=mesh,
        in_specs=(P(), P()), out_specs=P(), check_vma=False))
    want = np.asarray(f(blk, jnp.asarray(x, jdtype)), np.float32)
    tblk = {k: torch.from_numpy(np.array(v, dtype=np.int8 if v.dtype ==
                                         jnp.int8 else np.float32))
            for k, v in blk.items()}
    with torch.inference_mode():
        got = ttr._ffn_apply(tblk, torch.from_numpy(x).to(tdtype),
                             _torch_cfg(jcfg, tdtype)).float().numpy()
    assert np.abs(want).max() < 8
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.fixture
def routing_margins(monkeypatch):
    """For each MoE layer the port runs, each position's margin between
    its k-th and (k+1)-th router score (``[B, S]`` arrays)."""
    seen = []
    inner = ttr._moe_ffn

    def recording(blk, h, cfg):
        gate = torch.einsum("bsd,de->bse", h.float(), blk["router"].float())
        top = torch.topk(gate, cfg.moe_top_k + 1, dim=-1).values
        seen.append((top[..., -2] - top[..., -1]).numpy())
        return inner(blk, h, cfg)

    monkeypatch.setattr(ttr, "_moe_ffn", recording)
    return seen


def _before_first_near_tie(margins):
    """``[B, S]`` mask of the positions before their row's first routing
    near-tie (margin < ROUTE_EPS in any layer): in a causal stack every
    later position sees a flipped expert through attention."""
    near = (np.stack(margins) < ROUTE_EPS).any(axis=0)
    return ~np.logical_or.accumulate(near, axis=1)


@pytest.mark.parametrize("case,atol", [("f32", 1e-4), ("bf16", 5e-2),
                                       ("int8", 1e-2)])
def test_moe_forward_matches_jax(moe_case, routing_margins, case, atol):
    """The whole MoE stack.  f32 is held at every position; bf16 and int8
    up to each row's first routing near-tie (see the module docstring)."""
    jcfg, params = moe_case
    jdtype, tdtype = _DTYPES[case]
    jcfg = dataclasses.replace(jcfg, dtype=jdtype)
    p = _case_params(jcfg, params, case)
    tokens = _tokens(jcfg.vocab_size)
    want = _run_jax(jcfg, p, tokens, quantized=case == "int8")
    got = _run_torch(_torch_cfg(jcfg, tdtype), _np(p), tokens,
                     quantized=case == "int8")
    assert got.shape == (B, S, jcfg.vocab_size)
    assert len(routing_margins) == jcfg.n_layers
    held = np.ones((B, S), bool) if case == "f32" \
        else _before_first_near_tie(routing_margins)
    assert held.sum() >= S // 4
    np.testing.assert_allclose(got[held], want[held], rtol=0, atol=atol)


def test_moe_quantize_layer_weights_bit_exact(moe_case):
    jcfg, params = moe_case
    want = jtr.quantize_layer_weights(params, jcfg)
    tcfg = _torch_cfg(jcfg, torch.float32)
    got = ttr.quantize_layer_weights(ttr.params_from_jax(_np(params), tcfg),
                                     tcfg)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(w),
                                      err_msg=name)


def _cos(a, b):
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_moe_quantized_close_to_fp():
    """The reference's test_moe_quantized_close_to_fp on the port: MoE goes
    weight-only and stays close to the float forward (cosine > 0.99)."""
    jcfg = jtr.TransformerConfig(vocab_size=64, d_model=32, n_layers=4,
                                 n_heads=4, head_dim=8, d_ff=64, n_experts=2,
                                 dtype=jnp.float32)
    tcfg = _torch_cfg(jcfg, torch.float32)
    tokens = torch.from_numpy(_tokens(64, seed=0, b=8, s=32))
    params = ttr.params_from_jax(
        _np(jtr.init_params(jax.random.PRNGKey(6), jcfg)), tcfg)
    with torch.inference_mode():
        fp = ttr.make_forward(tcfg)(params, tokens)
        q = ttr.make_forward(tcfg, quantized=True)(
            ttr.quantize_layer_weights(params, tcfg), tokens)
    assert _cos(fp, q) > 0.99


def test_moe_routing_keeps_ties():
    """Top-k by threshold: a score tied with the k-th largest keeps its
    expert too, as in the reference (``gate >= top[..., -1:]``)."""
    cfg = ttr.TransformerConfig(d_model=4, n_experts=4, moe_top_k=2, d_ff=4,
                                dtype=torch.float32)
    h = torch.ones(1, 1, 4)
    blk = {"router": torch.tensor([[1.0, 1.0, 1.0, 0.0]] * 4),
           "we1": torch.ones(4, 4, 4),
           "we2": torch.stack([torch.eye(4) * (e + 1) for e in range(4)])}
    out = ttr._moe_ffn(blk, h, cfg)
    # experts 0-2 tie (4.0 each) and share the weight; expert 3 drops out
    he = torch.nn.functional.silu(torch.tensor(4.0))
    torch.testing.assert_close(out, torch.full((1, 1, 4), he * 2.0))


def test_torch_init_params_moe_shapes_match_jax(moe_case):
    jcfg, _ = moe_case
    jp = jax.eval_shape(lambda: jtr.init_params(jax.random.PRNGKey(0), jcfg))
    tp = ttr.init_params(torch.Generator().manual_seed(0),
                         _torch_cfg(jcfg, torch.float32))
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}


# ---------------------------------------------------------------------------
# Encoder forward (bert_large's stack at tiny widths)
# ---------------------------------------------------------------------------

@pytest.fixture(params=["flash", "ring"])
def attention_branch(request, monkeypatch):
    if request.param == "flash":
        monkeypatch.setenv("TRITON_TPU_FLASH_MIN_S", "64")
    else:
        monkeypatch.delenv("TRITON_TPU_FLASH_MIN_S", raising=False)
    monkeypatch.delenv("TRITON_TPU_FLASH", raising=False)
    return request.param


@pytest.fixture(scope="module")
def encoder_params():
    cfg = dataclasses.replace(ENCODER, dtype=jnp.float32)
    params = jtr.init_params(jax.random.PRNGKey(24), cfg)
    return params, jtr.quantize_layer_weights(params, cfg)


@pytest.mark.parametrize("case,atol", [("f32", 1e-4), ("bf16", 5e-2),
                                       ("int8", 1e-2)])
def test_encoder_forward_matches_jax(encoder_params, attention_branch, case,
                                     atol):
    params, qparams = encoder_params
    jdtype, tdtype = ((jnp.bfloat16, torch.bfloat16) if case == "bf16"
                      else (jnp.float32, torch.float32))
    jcfg = dataclasses.replace(ENCODER, dtype=jdtype)
    p = qparams if case == "int8" else params
    tokens = _tokens(jcfg.vocab_size, seed=24)
    want = _run_jax(jcfg, p, tokens, case == "int8",
                    head_cols=jlang.BERT_HEAD_COLS)
    got = _run_torch(_torch_cfg(jcfg, tdtype), _np(p), tokens, case == "int8",
                     head_cols=tlang.BERT_HEAD_COLS)
    assert got.shape == (B, S, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_encoder_attends_both_ways(encoder_params):
    """Changing the last token moves the first position's logits in the
    encoder and not in the causal stack."""
    params, _ = encoder_params
    tokens = _tokens(256, seed=24)
    later = tokens.copy()
    later[:, -1] = (later[:, -1] + 1) % 256
    for causal, moves in ((False, True), (True, False)):
        tcfg = _torch_cfg(dataclasses.replace(ENCODER, causal=causal),
                          torch.float32)
        a, b = (_run_torch(tcfg, _np(params), t, False, head_cols=2)
                for t in (tokens, later))
        assert (np.abs(a[:, 0] - b[:, 0]).max() > 1e-6) == moves


# ---------------------------------------------------------------------------
# bert_large: config and FLOPs (tests/test_benchmark_models.py TestBertLarge)
# ---------------------------------------------------------------------------

def test_bert_large_config_shape():
    m = tlang.make_bert_large("cpu")
    md = m.metadata()
    assert md["inputs"][0] == {"name": "INPUT_IDS", "datatype": "INT32",
                               "shape": [-1, tlang.BERT_SEQ_LEN]}
    assert md["outputs"][0]["shape"] == [-1, tlang.BERT_SEQ_LEN, 2]
    cfg = tlang.BERT_LARGE
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff) == \
        (24, 1024, 16, 4096)
    assert not cfg.causal and (tlang.BERT_SEQ_LEN, tlang.BERT_HEAD_COLS) == \
        (jlang.BERT_SEQ_LEN, jlang.BERT_HEAD_COLS)
    stack_params = tlang.n_params(cfg) - 2 * cfg.vocab_size * cfg.d_model
    assert 290e6 < stack_params < 360e6
    assert m.transformer.params is None  # weights wait for a request


def test_bert_large_flops_accounting():
    cfg = tlang.BERT_LARGE
    full = tlang.forward_flops_per_token(cfg, 384)
    assert full > 2 * 24 * (4 * 1024 * 1024 + 2 * 1024 * 4096)
    span = tlang.forward_flops_per_token(cfg, 384,
                                         head_cols=tlang.BERT_HEAD_COLS)
    assert abs((full - span) - 2.0 * cfg.d_model * (cfg.vocab_size - 2)) \
        < 1e-3
    assert span == jlang.forward_flops_per_token(
        jlang.BERT_LARGE, 384, head_cols=jlang.BERT_HEAD_COLS)


def test_presets_match_jax():
    for name, jcfg in jlang._LLAMA_PRESETS.items():
        assert _torch_cfg(jcfg, None) == dataclasses.replace(
            tlang._LLAMA_PRESETS[name], dtype=None), name
    for name, (jcfg, seq) in jlang._MOE_PRESETS.items():
        tcfg, tseq = tlang._MOE_PRESETS[name]
        assert tseq == seq
        assert _torch_cfg(jcfg, None) == dataclasses.replace(tcfg,
                                                             dtype=None)
    assert _torch_cfg(jlang.BERT_LARGE, None) == dataclasses.replace(
        tlang.BERT_LARGE, dtype=None)
    assert _torch_cfg(jtr.LLAMA3_8B, None) == dataclasses.replace(
        ttr.LLAMA3_8B, dtype=None)
    assert tlang.LLAMA_SEQ_LEN == jlang.LLAMA_SEQ_LEN


def test_presets_follow_the_requested_device(monkeypatch):
    monkeypatch.delenv("TRITON_TPU_MOE_PRESET", raising=False)
    monkeypatch.delenv("TRITON_TPU_LLAMA_PRESET", raising=False)
    assert tlang.moe_seq_len("cpu") == 128
    assert tlang.llama_cfg("cpu").d_model == 64
    monkeypatch.setenv("TRITON_TPU_MOE_PRESET", "base")
    monkeypatch.setenv("TRITON_TPU_LLAMA_PRESET", "1b")
    assert tlang.moe_seq_len("cpu") == 256
    assert tlang.llama_cfg("cpu").vocab_size == 128256
    monkeypatch.setenv("TRITON_TPU_LLAMA_PRESET", "70b")
    with pytest.raises(ValueError, match="TRITON_TPU_LLAMA_PRESET"):
        tlang.llama_cfg("cpu")


# ---------------------------------------------------------------------------
# Served over HTTP against the JAX server
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def servers():
    jreg = JaxRegistry()
    for m in (jlang.make_bert_large(), jlang.make_moe_tpu(),
              jlang.make_llama_tpu()):
        jreg.register_model(m)
    moe = _np(jtr.init_params(jax.random.PRNGKey(17), jlang.moe_cfg()))
    llama = _np(jtr.init_params(jax.random.PRNGKey(3), jlang._llama_cfg()))
    treg = ModelRegistry()
    treg.register_model(tlang.make_bert_large("cpu"))
    treg.register_model(tlang.make_moe_tpu("cpu", params=moe))
    treg.register_model(tlang.make_llama_tpu("cpu", params=llama))
    with JaxHarness(jreg) as jh, ServerHarness(treg) as th:
        yield jh, th, {"moe_tpu": moe, "llama_tpu": llama}


def _infer_tokens(url, name, tokens, binary):
    with httpclient.InferenceServerClient(url) as c:
        inp = httpclient.InferInput("TOKENS", list(tokens.shape), "INT32")
        inp.set_data_from_numpy(tokens, binary_data=binary)
        outs = [httpclient.InferRequestedOutput(o, binary_data=binary)
                for o in ("NEXT_TOKEN", "NEXT_LOGIT")]
        r = c.infer(name, [inp], outputs=outs)
        return (np.asarray(r.as_numpy("NEXT_TOKEN")),
                np.asarray(r.as_numpy("NEXT_LOGIT")))


def assert_next_token_close(tok, logit, want_tok, want_logit, ref_logits):
    """NEXT_LOGIT within LOGIT_ATOL; NEXT_TOKEN equal, or the reference's
    logit at ``tok`` within LOGIT_ATOL of its maximum (a near tie).
    Returns how many rows needed that allowance."""
    assert tok.dtype == np.int32 and logit.dtype == np.float32
    np.testing.assert_allclose(logit, want_logit, rtol=0, atol=LOGIT_ATOL)
    ties = 0
    for row, (t, w) in enumerate(zip(tok[:, 0], want_tok[:, 0])):
        if t != w:
            assert ref_logits[row, t] >= ref_logits[row].max() - LOGIT_ATOL, \
                (row, t, w)
            ties += 1
    return ties


@pytest.mark.parametrize("binary", [False, True], ids=["json", "binary"])
@pytest.mark.parametrize("name,seed", [("moe_tpu", 17), ("llama_tpu", 3)])
def test_next_token_models_match_jax_server(servers, name, seed, binary):
    jh, th, weights = servers
    jcfg = jlang.moe_cfg() if name == "moe_tpu" else jlang._llama_cfg()
    seq = jlang.moe_seq_len() if name == "moe_tpu" else jlang.LLAMA_SEQ_LEN
    tokens = _tokens(jcfg.vocab_size, seed=seed, b=4, s=seq)
    want_tok, want_logit = _infer_tokens(jh.http_url, name, tokens, binary)
    tok, logit = _infer_tokens(th.http_url, name, tokens, binary)
    assert tok.shape == logit.shape == (4, 1)
    ref = _run_jax(jcfg, weights[name], tokens, quantized=False)[:, -1]
    np.testing.assert_allclose(want_logit[:, 0], ref.max(-1), atol=1e-6)
    assert assert_next_token_close(tok, logit, want_tok, want_logit,
                                   ref) == 0


def _get(url, path):
    with urllib.request.urlopen(f"http://{url}{path}") as r:
        return json.loads(r.read())


@pytest.mark.parametrize("name", ["bert_large", "moe_tpu", "llama_tpu"])
def test_config_and_metadata_match_jax_server(servers, name):
    jh, th, _ = servers
    t, j = (_get(u, f"/v2/models/{name}/config")
            for u in (th.http_url, jh.http_url))
    assert t["instance_group"][0]["kind"] == "KIND_CPU"
    for cfg in (t, j):
        cfg.pop("platform"), cfg.pop("backend")
        cfg["instance_group"][0].pop("kind")
    assert t == j
    t, j = (_get(u, f"/v2/models/{name}") for u in (th.http_url, jh.http_url))
    t.pop("platform"), j.pop("platform")
    assert t == j
