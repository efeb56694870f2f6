"""The port's KV-cache decode path against the JAX package's, on the CPU.

The reference's own weights -- ``init_params(PRNGKey(7), cfg)`` for a tiny
dense config and ``PRNGKey(9)`` for a tiny MoE one (4 experts, top 2), the
configs of ``tests/test_decode.py`` -- are carried to the port as numpy
arrays (``params_from_jax``), and the same numpy tokens go through both
packages in f32.  Held to rtol / atol 2e-4 on logits, as
``tests/test_decode.py`` holds the reference to its own oracle:

* prefill, decode steps and ``reference_forward``, dense and MoE (the MoE
  decode step takes the single-token path that gathers the routed
  experts);
* the slot prefill and step, with an idle slot and per-slot positions;
* chunked prefill against full prefill (the reference's 2e-2 on K/V in its
  dtype; f32 here, so 2e-4) and against the reference's chunks;
* fused T-step ticks against single steps, with and without penalties,
  token for token, and against the reference's fused tick;
* weight-only int8 (the reference's quantized weights carried across):
  against the reference's int8 decode to 2e-4, and against fp to
  ``tests/test_decode.py``'s own bounds.

Int8 KV (``TRITON_TPU_KV_QUANT=int8``): ``_kv_quantize`` bit for bit
against the reference's eager call; the slot prefill, chunked prefill and
steps over int8 cache pairs against the reference's, and both served
models, within the bounds stated in ``KV8_*`` before they were measured;
the slab's bytes against the projection.

Beside: the readback pair on the CPU, the bucket and step knobs against
the reference's parsing, and the refusal of int8 KV in independent mode
and of unknown values.
The served models are held in ``tests/test_torch_decode_models.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from triton_client_tpu.models import decode as jdec
from triton_client_tpu.models import transformer as jtr
from triton_client_tpu_torch.models import decode as tdec
from triton_client_tpu_torch.models import transformer as ttr

TOL = dict(rtol=2e-4, atol=2e-4)
S_MAX = 24

JCFG = {
    "dense": jtr.TransformerConfig(
        vocab_size=64, d_model=32, n_layers=2, n_heads=2, head_dim=16,
        d_ff=64, n_experts=0, dtype=jnp.float32),
    "moe": jtr.TransformerConfig(
        vocab_size=64, d_model=32, n_layers=2, n_heads=2, head_dim=16,
        d_ff=64, n_experts=4, moe_top_k=2, dtype=jnp.float32),
}
SEEDS = {"dense": 7, "moe": 9}


def _tcfg(jcfg):
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jtr.TransformerConfig)
              if f.name != "dtype"}
    return ttr.TransformerConfig(**fields, dtype=torch.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module", params=["dense", "moe"])
def model(request):
    """(kind, jax cfg, torch cfg, jax params, torch params)."""
    jcfg = JCFG[request.param]
    jp = jtr.init_params(jax.random.PRNGKey(SEEDS[request.param]), jcfg)
    tp = ttr.params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                             _tcfg(jcfg))
    return request.param, jcfg, _tcfg(jcfg), jp, tp


@pytest.fixture(scope="module")
def dense():
    jcfg = JCFG["dense"]
    jp = jtr.init_params(jax.random.PRNGKey(7), jcfg)
    tp = ttr.params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                             _tcfg(jcfg))
    return jcfg, _tcfg(jcfg), jp, tp


def _tokens(seed, shape, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


# ---------------------------------------------------------------------------
# prefill, decode steps, reference_forward
# ---------------------------------------------------------------------------

def test_prefill_matches_reference(model):
    _kind, jcfg, tcfg, jp, tp = model
    toks = _tokens(0, (2, 8))
    jl, jc = jdec.make_prefill(jcfg, S_MAX)(jp, jnp.asarray(toks))
    tl, tc = tdec.make_prefill(tcfg, S_MAX)(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    np.testing.assert_allclose(_np(tc["k"]), _np(jc["k"]), **TOL)
    np.testing.assert_allclose(_np(tc["v"]), _np(jc["v"]), **TOL)
    assert tc["pos"] == int(jc["pos"]) == 8
    assert tuple(tc["k"].shape) == (tcfg.n_layers, 2, tcfg.n_heads, S_MAX,
                                    tcfg.head_dim)
    # and the port's own oracle, full recompute, against the reference's
    want = jdec.reference_forward(jp, jnp.asarray(toks), jcfg)
    got = tdec.reference_forward(tp, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(tl), _np(got[:, -1]), **TOL)


def test_decode_steps_match_reference_and_growing_forward(model):
    """prefill(P) + t steps == full forward over the first P+t+1 tokens,
    in both packages, logits held at every position."""
    _kind, jcfg, tcfg, jp, tp = model
    toks = _tokens(1, (1, 14))
    P = 6
    jl, jc = jdec.make_prefill(jcfg, S_MAX)(jp, jnp.asarray(toks[:, :P]))
    tl, tc = tdec.make_prefill(tcfg, S_MAX)(tp, torch.from_numpy(toks[:, :P]))
    jstep, tstep = jdec.make_decode_step(jcfg), tdec.make_decode_step(tcfg)
    for t in range(P, 14):
        want = tdec.reference_forward(tp, torch.from_numpy(toks[:, :t]),
                                      tcfg)[:, -1]
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL,
                                   err_msg=f"position {t}")
        np.testing.assert_allclose(_np(tl), _np(want), **TOL,
                                   err_msg=f"position {t}")
        jl, jc = jstep(jp, jc, jnp.asarray(toks[:, t:t + 1]))
        tl, tc = tstep(tp, tc, torch.from_numpy(toks[:, t:t + 1]))
    assert tc["pos"] == int(jc["pos"]) == 14


def test_greedy_generation_matches_reference(model):
    """Greedy continuation through the cache: the reference's tokens, and
    the port's full-recompute oracle's."""
    _kind, jcfg, tcfg, jp, tp = model
    prompt = _tokens(2, (1, 5))
    jl, jc = jdec.make_prefill(jcfg, S_MAX)(jp, jnp.asarray(prompt))
    tl, tc = tdec.make_prefill(tcfg, S_MAX)(tp, torch.from_numpy(prompt))
    jstep, tstep = jdec.make_decode_step(jcfg), tdec.make_decode_step(tcfg)
    jout, tout = [], []
    for _ in range(8):
        jn = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        tn = torch.argmax(tl, dim=-1).to(torch.int32)
        jout.append(int(jn[0]))
        tout.append(int(tn[0]))
        jl, jc = jstep(jp, jc, jn[:, None])
        tl, tc = tstep(tp, tc, tn[:, None])
    seq, recomp = torch.from_numpy(prompt), []
    for _ in range(8):
        lg = tdec.reference_forward(tp, seq, tcfg)[:, -1]
        nxt = torch.argmax(lg, dim=-1).to(torch.int32)
        recomp.append(int(nxt[0]))
        seq = torch.cat([seq, nxt[:, None]], dim=1)
    assert tout == jout == recomp


# ---------------------------------------------------------------------------
# slot kernels
# ---------------------------------------------------------------------------

N_SLOTS = 3


def _slot_caches(cfg, n=N_SLOTS, fill=0.0):
    shape = (cfg.n_layers, n, cfg.n_heads, S_MAX, cfg.head_dim)
    if isinstance(cfg, jtr.TransformerConfig):
        return (jnp.full(shape, fill, cfg.dtype),
                jnp.full(shape, fill, cfg.dtype))
    return (torch.full(shape, fill, dtype=cfg.dtype),
            torch.full(shape, fill, dtype=cfg.dtype))


def test_slot_prefill_matches_reference(model):
    _kind, jcfg, tcfg, jp, tp = model
    jk, jv = _slot_caches(jcfg, fill=1.0)
    tk, tv = _slot_caches(tcfg, fill=1.0)
    jpre, tpre = jdec.make_slot_prefill(jcfg), tdec.make_slot_prefill(tcfg)
    for slot in range(2):
        toks = _tokens(3 + slot, (1, 6))
        jn, jb, jlp, jk, jv = jpre(jp, jk, jv, jnp.asarray(toks), slot)
        tn, tb, tlp, tk, tv = tpre(tp, tk, tv, torch.from_numpy(toks), slot)
        assert int(tn) == int(jn)
        np.testing.assert_allclose([float(tb), float(tlp)],
                                   [float(jb), float(jlp)], **TOL)
    # every slot's lane, padding and the untouched slot 2 included
    np.testing.assert_allclose(_np(tk), _np(jk), **TOL)
    np.testing.assert_allclose(_np(tv), _np(jv), **TOL)


def test_slot_steps_with_idle_slot_match_reference(model):
    """Slot 1 skips a tick while slot 0 advances, slot 2 idles throughout:
    tokens, logits, logprobs and caches as the reference's."""
    _kind, jcfg, tcfg, jp, tp = model
    P = 6
    wins = [_tokens(4, (1, P)), _tokens(5, (1, P))]
    jk, jv = _slot_caches(jcfg)
    tk, tv = _slot_caches(tcfg)
    jpre, tpre = jdec.make_slot_prefill(jcfg), tdec.make_slot_prefill(tcfg)
    jst, tst = jdec.make_slot_step(jcfg), tdec.make_slot_step(tcfg)
    last = []
    for slot, win in enumerate(wins):
        jn, _, _, jk, jv = jpre(jp, jk, jv, jnp.asarray(win), slot)
        tn, _, _, tk, tv = tpre(tp, tk, tv, torch.from_numpy(win), slot)
        assert int(tn) == int(jn)
        last.append(int(tn))
    pos = np.array([P, P, 0], np.int32)
    for tick in range(3):
        active = np.array([True, tick != 1, False])
        tokens = np.array([last[0], last[1], 0], np.int32)
        jn, jb, jlp, jk, jv = jst(
            jp, jk, jv, jnp.asarray(tokens), jnp.zeros(N_SLOTS, jnp.int32),
            jnp.asarray(pos), jnp.asarray(active),
            jnp.zeros(N_SLOTS, bool))
        tn, tb, tlp, tk, tv = tst(
            tp, tk, tv, torch.from_numpy(tokens),
            torch.zeros(N_SLOTS, dtype=torch.int32), torch.from_numpy(pos),
            torch.from_numpy(active), torch.zeros(N_SLOTS, dtype=torch.bool))
        assert tn.tolist() == np.asarray(jn).tolist()
        np.testing.assert_allclose(_np(tb), _np(jb), **TOL)
        np.testing.assert_allclose(_np(tlp), _np(jlp), **TOL)
        for s in (0, 1):
            if active[s]:
                last[s] = int(tn[s])
                pos[s] += 1
    np.testing.assert_allclose(_np(tk), _np(jk), **TOL)
    np.testing.assert_allclose(_np(tv), _np(jv), **TOL)


@pytest.mark.parametrize("chunk", [1, 4, 8, 16])
def test_chunked_prefill_matches_full_and_reference(dense, chunk):
    jcfg, tcfg, jp, tp = dense
    prompt = _tokens(11, (1, 16))
    slot = 1
    full = tdec.make_slot_prefill(tcfg)
    k0, v0 = _slot_caches(tcfg)
    want_tok, want_best, _, want_k, want_v = full(
        tp, k0, v0, torch.from_numpy(prompt), slot)
    cp = tdec.make_slot_chunk_prefill(tcfg, S_MAX)
    jcp = jdec.make_slot_chunk_prefill(jcfg, S_MAX)
    tk, tv = _slot_caches(tcfg)
    jk, jv = _slot_caches(jcfg)
    for pos0 in range(0, 16, chunk):
        part = prompt[:, pos0:pos0 + chunk]
        tok, best, lp, tk, tv = cp(tp, tk, tv, torch.from_numpy(part), slot,
                                   pos0)
        jtok, jbest, jlp, jk, jv = jcp(jp, jk, jv, jnp.asarray(part), slot,
                                       pos0)
    assert int(tok) == int(want_tok) == int(jtok)
    np.testing.assert_allclose(float(best), float(want_best), **TOL)
    np.testing.assert_allclose([float(best), float(lp)],
                               [float(jbest), float(jlp)], **TOL)
    np.testing.assert_allclose(_np(tk[:, slot]), _np(want_k[:, slot]), **TOL)
    np.testing.assert_allclose(_np(tv[:, slot]), _np(want_v[:, slot]), **TOL)
    np.testing.assert_allclose(_np(tk), _np(jk), **TOL)


def test_chunk_prefill_leaves_other_slots_untouched(dense):
    _jcfg, tcfg, _jp, tp = dense
    k, v = _slot_caches(tcfg, n=2, fill=1.0)
    cp = tdec.make_slot_chunk_prefill(tcfg, S_MAX)
    _, _, _, k, v = cp(tp, k, v, torch.from_numpy(_tokens(12, (1, 8))), 1, 0)
    assert bool((k[:, 0] == 1.0).all()) and bool((v[:, 0] == 1.0).all())


def _fused_cohort(tcfg, tp, n_steps, pen, fused_fn=None):
    """Two auto generations (remaining 5 and 3) and one client step in a
    3-slot bucket, ticked until drained: per-slot token streams (and the
    steps each dispatch ran)."""
    k, v = _slot_caches(tcfg)
    pre = tdec.make_slot_prefill(tcfg)
    st = tdec._new_decode_state(N_SLOTS, "cpu")
    streams = {0: [], 1: [], 2: []}
    budgets = {0: 5, 1: 3}
    for slot in (0, 1, 2):
        nxt, _, _, k, v = pre(tp, k, v, torch.from_numpy(
            _tokens(20 + slot, (1, 6))), slot)
        streams[slot].append(int(nxt))
        if slot in budgets:
            tdec._state_admit(st, slot, nxt, 6, True, budgets[slot])
        else:
            tdec._state_admit(st, slot, nxt, 6, False, 0)
    counts = torch.zeros((N_SLOTS, tcfg.vocab_size), dtype=torch.int32)
    fp = torch.tensor([0.5, 0.0, 0.0]) if pen else torch.zeros(N_SLOTS)
    pp = torch.tensor([0.0, 1.0, 0.0]) if pen else torch.zeros(N_SLOTS)
    if fused_fn is None:
        fused_fn = (tdec.make_fused_slot_step_pen if pen
                    else tdec.make_fused_slot_step)(tcfg, n_steps)
    mask = torch.tensor([False, False, True])
    toks = torch.tensor([0, 0, streams[2][-1]], dtype=torch.int32)
    rem, pos = dict(budgets), {0: 6, 1: 6, 2: 6}
    first = True
    while rem:
        adv = {s: min(n_steps, r, S_MAX - pos[s]) for s, r in rem.items()}
        n_run = max(list(adv.values()) + [1 if first else 0])
        args = (tp, k, v, st, mask if first else torch.zeros(3, dtype=bool),
                toks)
        if pen:
            k, v, st, out, ran, counts = fused_fn(*args, counts, fp, pp,
                                                  n_run)
        else:
            k, v, st, out, ran = fused_fn(*args, n_run)
        vals = tdec.finish_readback(tdec.start_readback(out))
        if first:
            streams[2].append(int(vals[0, 0, 2]))
            first = False
        for s, a in adv.items():
            streams[s].extend(int(vals[0, t, s]) for t in range(a))
            pos[s] += a
            rem[s] -= a
            if rem[s] <= 0:
                del rem[s]
    return streams


@pytest.mark.parametrize("pen", [False, True], ids=["plain", "penalized"])
def test_fused_ticks_match_single_steps(dense, pen):
    """T = 1, 2, 4 give the same streams; T = 1 is the single-step tick."""
    _jcfg, tcfg, _jp, tp = dense
    want = _fused_cohort(tcfg, tp, 1, pen)
    assert [len(want[s]) for s in (0, 1, 2)] == [6, 4, 2]
    for T in (2, 4):
        assert _fused_cohort(tcfg, tp, T, pen) == want, T


@pytest.mark.parametrize("pen", [False, True], ids=["plain", "penalized"])
def test_fused_tick_matches_reference(dense, pen):
    """One T = 4 dispatch of a mixed cohort (auto slots with budgets 4 and
    2, a client step, an idle slot): the [3, T, B] block, the control state
    and the caches as the reference's."""
    jcfg, tcfg, jp, tp = dense
    n = 4
    shape = (tcfg.n_layers, n, tcfg.n_heads, S_MAX, tcfg.head_dim)
    jk, jv = jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    jpre, tpre = jdec.make_slot_prefill(jcfg), tdec.make_slot_prefill(tcfg)
    jst = jdec._new_decode_state(n)
    tst = tdec._new_decode_state(n, "cpu")
    for slot, (auto, rem) in enumerate([(True, 4), (True, 2), (False, 0)]):
        win = _tokens(30 + slot, (1, 6))
        jn, _, _, jk, jv = jpre(jp, jk, jv, jnp.asarray(win), slot)
        tn, _, _, tk, tv = tpre(tp, tk, tv, torch.from_numpy(win), slot)
        jst = jdec._state_admit(jst, slot, jn, 6, auto, rem)
        tdec._state_admit(tst, slot, tn, 6, auto, rem)
    mask = np.array([False, False, True, False])
    toks = np.array([0, 0, 17, 0], np.int32)
    targs_pen, jargs_pen = (), ()
    if pen:
        counts = _tokens(40, (n, 64), vocab=3)
        fp = np.array([0.5, 0.0, 0.0, 0.0], np.float32)
        pp = np.array([0.0, 1.5, 0.0, 0.0], np.float32)
        jargs_pen = (jnp.asarray(counts), jnp.asarray(fp), jnp.asarray(pp))
        targs_pen = tuple(torch.from_numpy(a) for a in (counts, fp, pp))
        jfused = jdec.make_fused_slot_step_pen(jcfg, 4)
        tfused = tdec.make_fused_slot_step_pen(tcfg, 4)
    else:
        jfused = jdec.make_fused_slot_step(jcfg, 4)
        tfused = tdec.make_fused_slot_step(tcfg, 4)
    jres = jfused(jp, jk, jv, jst, jnp.asarray(mask), jnp.asarray(toks),
                  *jargs_pen)
    tres = tfused(tp, tk, tv, tst, torch.from_numpy(mask),
                  torch.from_numpy(toks), *targs_pen, 4)
    jk, jv, jst2, jout, jsteps = jres[:5]
    tk, tv, tst2, tout, tsteps = tres[:5]
    assert tsteps == int(jsteps) == 4
    np.testing.assert_array_equal(_np(tout)[0], _np(jout)[0])
    np.testing.assert_allclose(_np(tout), _np(jout), **TOL)
    for key in ("prev", "pos", "active", "auto", "remaining", "tokens"):
        assert tst2[key].tolist() == np.asarray(jst2[key]).tolist(), key
    np.testing.assert_allclose(_np(tk), _np(jk), **TOL)
    np.testing.assert_allclose(_np(tv), _np(jv), **TOL)
    if pen:
        assert tres[5].tolist() == np.asarray(jres[5]).tolist()


# ---------------------------------------------------------------------------
# weight-only int8
# ---------------------------------------------------------------------------

def test_int8_decode_matches_reference_and_tracks_fp(model):
    """The reference's quantized weights through both packages' prefill
    and steps (2e-4), and the port's int8 forward close to its fp one, to
    the reference's own bounds (dense: cosine > 0.999 and the same last
    greedy token; MoE: rtol 0.1, atol 0.15)."""
    kind, jcfg, tcfg, jp, tp = model
    jq = jdec.quantize_layer_weights(jp, jcfg)
    tq = ttr.params_from_jax({k: np.asarray(v) for k, v in jq.items()},
                             tcfg)
    assert tq["wq"].dtype == torch.int8 and "wq_scale" in tq
    toks = _tokens(6, (1, 12))
    P = 6
    jl, jc = jdec.make_prefill(jcfg, S_MAX)(jq, jnp.asarray(toks[:, :P]))
    tl, tc = tdec.make_prefill(tcfg, S_MAX)(tq, torch.from_numpy(toks[:, :P]))
    jstep, tstep = jdec.make_decode_step(jcfg), tdec.make_decode_step(tcfg)
    for t in range(P, 12):
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        want = tdec.reference_forward(tq, torch.from_numpy(toks[:, :t]),
                                      tcfg)[:, -1]
        np.testing.assert_allclose(_np(tl), _np(want), **TOL)
        jl, jc = jstep(jq, jc, jnp.asarray(toks[:, t:t + 1]))
        tl, tc = tstep(tq, tc, torch.from_numpy(toks[:, t:t + 1]))
    # the port's own quantization against fp
    q = ttr.quantize_layer_weights(tp, tcfg)
    x = torch.from_numpy(toks[:, :10])
    fp = _np(tdec.reference_forward(tp, x, tcfg))
    got = _np(tdec.reference_forward(q, x, tcfg))
    if kind == "moe":
        np.testing.assert_allclose(got[:, -1], fp[:, -1], rtol=0.1,
                                   atol=0.15)
    else:
        cos = float(np.sum(fp * got) / (np.linalg.norm(fp)
                                        * np.linalg.norm(got)))
        assert cos > 0.999, cos
        assert int(np.argmax(fp[:, -1])) == int(np.argmax(got[:, -1]))


# ---------------------------------------------------------------------------
# int8 KV
# ---------------------------------------------------------------------------

#: int8 KV against the reference's int8 KV, on the CPU in f32 (stated
#: before it was measured): the reference quantizes inside ``jit``, where
#: XLA may turn ``a / 127`` into a multiply, so a code may differ by one
#: on at most 1% of the entries; logits within 5e-3 and tokens equal.
KV8_CODE_FLIPS = 0.01
KV8_ATOL = 5e-3


def _kv_inputs(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * 3
    x[..., 0, :] = 0.0                      # all-zero vectors: scale 1
    x[..., 1, :3] = [127.0, -63.5, 0.5]     # ties at half a step
    x[..., 1, 3:] = 0.0
    return x.astype(dtype)


@pytest.mark.parametrize("shape", [(2, 4, 16), (3, 2, 5, 128), (1, 7, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quantize_bit_exact_against_reference(shape, dtype):
    """The same inputs through both packages' eager ``_kv_quantize``: the
    codes and the scales bit for bit (a true divide, round half to even,
    scale 1 where a vector is all zeros)."""
    x = _kv_inputs(sum(shape), shape, np.float32)
    if dtype == "bfloat16":
        jx = jnp.asarray(x).astype(jnp.bfloat16)
        tx = torch.from_numpy(x).to(torch.bfloat16)
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jq, js = jdec._kv_quantize(jx)
    tq, ts = tdec._kv_quantize(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    assert float(ts[(0,) * (len(shape) - 2) + (0,)].max()) == 1.0


def _int8_caches_both(cfg_t, jcfg, n=N_SLOTS, s=S_MAX):
    shape = (jcfg.n_layers, n, jcfg.n_heads, s, jcfg.head_dim)

    def j():
        return {"q": jnp.zeros(shape, jnp.int8),
                "s": jnp.ones(shape[:-1], jnp.float32)}

    def t():
        return {"q": torch.zeros(shape, dtype=torch.int8),
                "s": torch.ones(shape[:-1], dtype=torch.float32)}

    return (j(), j()), (t(), t())


def _codes_close(tc, jc):
    d = np.abs(tc["q"].numpy().astype(np.int32)
               - np.asarray(jc["q"]).astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= KV8_CODE_FLIPS, (
        d.max(), (d > 0).mean())
    np.testing.assert_allclose(tc["s"].numpy(), np.asarray(jc["s"]),
                               rtol=1e-6, atol=0)


def test_int8_kv_slot_path_matches_reference(dense):
    """Slot prefill, chunked prefill and slot steps over int8 cache pairs,
    against the reference's jitted functions on the same pairs: codes,
    scales, logits and tokens within KV8_*."""
    jcfg, tcfg, jp, tp = dense
    (jk, jv), (tk, tv) = _int8_caches_both(tcfg, jcfg, n=4)
    toks = _tokens(21, (1, 8))
    jn, jb, _jl, jk, jv = jdec.make_slot_prefill(jcfg)(
        jp, jk, jv, jnp.asarray(toks), 1)
    tn, tb, _tl, tk, tv = tdec.make_slot_prefill(tcfg)(
        tp, tk, tv, torch.from_numpy(toks), 1)
    assert int(tn) == int(jn)
    np.testing.assert_allclose(float(tb), float(jb), atol=KV8_ATOL, rtol=0)
    _codes_close(tk, jk)
    _codes_close(tv, jv)
    # a chunked prefill of another slot attends over quantized chunks
    chunk_j = jdec.make_slot_chunk_prefill(jcfg, S_MAX)
    chunk_t = tdec.make_slot_chunk_prefill(tcfg, S_MAX)
    for pos0 in (0, 4):
        c = toks[:, pos0:pos0 + 4]
        jn, jb, _jl, jk, jv = chunk_j(jp, jk, jv, jnp.asarray(c), 2, pos0)
        tn, tb, _tl, tk, tv = chunk_t(tp, tk, tv, torch.from_numpy(c), 2,
                                      pos0)
    assert int(tn) == int(jn)
    np.testing.assert_allclose(float(tb), float(jb), atol=KV8_ATOL, rtol=0)
    # steps: slots 1 and 2 active at position 8, fed their own tokens
    jstep, tstep = jdec.make_slot_step(jcfg), tdec.make_slot_step(tcfg)
    tok = np.array([0, int(tn), int(tn), 0], np.int32)
    pos = np.array([0, 8, 8, 0], np.int32)
    act = np.array([False, True, True, False])
    for _ in range(4):
        jres = jstep(jp, jk, jv, jnp.asarray(tok), jnp.asarray(tok),
                     jnp.asarray(pos), jnp.asarray(act),
                     jnp.zeros(4, bool))
        tres = tstep(tp, tk, tv, torch.from_numpy(tok),
                     torch.from_numpy(tok), torch.from_numpy(pos),
                     torch.from_numpy(act), torch.zeros(4, dtype=torch.bool))
        jk, jv, tk, tv = jres[3], jres[4], tres[3], tres[4]
        assert tres[0].numpy()[act].tolist() == \
            np.asarray(jres[0])[act].tolist()
        np.testing.assert_allclose(_np(tres[1])[act],
                                   np.asarray(jres[1])[act],
                                   atol=KV8_ATOL, rtol=0)
        tok = np.where(act, np.asarray(jres[0]), tok).astype(np.int32)
        pos = pos + act
    _codes_close(tk, jk)


def _f32_tiny_preset(monkeypatch):
    from triton_client_tpu.models import language as jlang
    from triton_client_tpu_torch.models import language as tlang

    for presets, dtype in ((jlang._LLAMA_PRESETS, jnp.float32),
                           (tlang._LLAMA_PRESETS, torch.float32)):
        monkeypatch.setitem(presets, "tiny", dataclasses.replace(
            presets["tiny"], dtype=dtype))
    monkeypatch.setenv("TRITON_TPU_LLAMA_PRESET", "tiny")
    monkeypatch.setenv("TRITON_TPU_DECODE_MODE", "batched")
    monkeypatch.setenv("TRITON_TPU_DECODE_SLOTS", "4")
    for var in ("TRITON_TPU_DECODE_BUCKETS", "TRITON_TPU_PREFILL_CHUNK",
                "TRITON_TPU_KV_CACHE_BYTES", "TRITON_TPU_DECODE_STEPS"):
        monkeypatch.delenv(var, raising=False)
    jp = jtr.init_params(jax.random.PRNGKey(3), jlang._LLAMA_PRESETS["tiny"])
    return {k: np.asarray(v) for k, v in jp.items()}


def _gen_tokens(gen_model, prompt, n):
    return [int(f["token_id"][0]) for f in gen_model._generate(
        {"text_input": np.array([prompt], object)}, {"max_tokens": n})]


@pytest.mark.parametrize("chunk", ["0", "32"])
def test_int8_kv_models_match_reference_and_track_fp(monkeypatch, chunk):
    """``TRITON_TPU_KV_QUANT=int8`` served in batched mode by both
    packages (tiny preset, f32, the reference's weights): the cache is an
    int8 pair, generated tokens equal the reference's, NEXT_LOGIT within
    KV8_ATOL of the reference's int8 path, and tokens equal the port's fp
    cache's (the reference's own claim for this preset) with NEXT_LOGIT
    within its 5e-2."""
    params = _f32_tiny_preset(monkeypatch)
    monkeypatch.setenv("TRITON_TPU_PREFILL_CHUNK", chunk)
    win = np.zeros((128,), np.int32)
    win[-5:] = [7, 11, 13, 17, 19]
    seq = {"sequence_id": 9301, "sequence_start": True,
           "sequence_end": True}
    out = {}
    for quant in ("int8", None):
        if quant:
            monkeypatch.setenv("TRITON_TPU_KV_QUANT", quant)
        else:
            monkeypatch.delenv("TRITON_TPU_KV_QUANT", raising=False)
        tag = f"kv{quant or 'fp'}{chunk}"
        t = tdec.DecodeModel(name=f"llama_decode_{tag}", device="cpu",
                             params=params)
        j = jdec.DecodeModel(name=f"llama_decode_{tag}") if quant else None
        try:
            tg = tdec.GenerateModel(t, name=f"llama_generate_{tag}")
            got = (_gen_tokens(tg, b"kv quant check", 8),
                   t._execute({"TOKENS": win}, dict(seq)))
            if quant:
                k0 = t._k[0]
                assert isinstance(k0, dict)
                assert k0["q"].dtype == torch.int8
                assert k0["s"].dtype == torch.float32
                assert k0["q"].shape[:-1] == k0["s"].shape
                jg = jdec.GenerateModel(j, name=f"llama_generate_{tag}")
                want = (_gen_tokens(jg, b"kv quant check", 8),
                        j._execute({"TOKENS": win}, dict(seq)))
                assert got[0] == want[0]
                assert got[1]["NEXT_TOKEN"][0] == want[1]["NEXT_TOKEN"][0]
                np.testing.assert_allclose(got[1]["NEXT_LOGIT"],
                                           want[1]["NEXT_LOGIT"],
                                           atol=KV8_ATOL, rtol=0)
            out[quant] = got
        finally:
            t._shutdown()
            if j is not None:
                j._shutdown()
    assert out["int8"][0] == out[None][0]
    assert out["int8"][1]["NEXT_TOKEN"][0] == out[None][1]["NEXT_TOKEN"][0]
    np.testing.assert_allclose(out["int8"][1]["NEXT_LOGIT"],
                               out[None][1]["NEXT_LOGIT"], rtol=0.05,
                               atol=0.05)


def test_int8_kv_slab_bytes_and_projection(monkeypatch):
    """The int8 slab's bytes against ``_kv_bytes_per_token``'s projection:
    the reference's formula leaves out the f32 scales (4 bytes per head,
    position and k or v), so the slab holds (K + 4) / K of it."""
    params = _f32_tiny_preset(monkeypatch)
    monkeypatch.setenv("TRITON_TPU_KV_QUANT", "int8")
    t = tdec.DecodeModel(name="llama_decode_kvbytes", device="cpu",
                         params=params)
    try:
        t._ensure_fns()
        _, cfg = t._params
        slab = sum(x.numel() * x.element_size()
                   for c in t._k + t._v for x in c.values())
        tokens = sum(cnt * cap for cnt, cap in t._buckets)
        per_tok = t._kv_bytes_per_token()
        assert per_tok == cfg.n_layers * 2 * cfg.n_heads * cfg.head_dim
        assert slab == tokens * per_tok * (cfg.head_dim + 4) \
            // cfg.head_dim
    finally:
        t._shutdown()


# ---------------------------------------------------------------------------
# readback pair, knobs
# ---------------------------------------------------------------------------

def test_readback_pair_on_the_cpu():
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    pending = tdec.start_readback(x)
    x.add_(100)  # the started readback is a snapshot
    assert tdec.readback_ready(pending)
    np.testing.assert_array_equal(tdec.finish_readback(pending),
                                  np.arange(6, dtype=np.float32)
                                  .reshape(2, 3))


@pytest.mark.parametrize("spec,want", [
    (None, [(8, 256)]),
    ("48x640,16x1280", [(48, 640), (16, 1280)]),
    ("16x1280,48x640", [(48, 640), (16, 1280)]),
    ("64x160,64x160", [(64, 160), (64, 160)]),
])
def test_cache_buckets_parse_as_reference(spec, want):
    assert tdec.parse_cache_buckets(spec, 8, 256, 128) == want == \
        jdec.parse_cache_buckets(spec, 8, 256, 128)


@pytest.mark.parametrize("spec", ["48", "0x640", "4x100", "ax640"])
def test_bad_cache_buckets_fail_as_reference(spec):
    with pytest.raises(ValueError) as want:
        jdec.parse_cache_buckets(spec, 8, 256, 128)
    with pytest.raises(ValueError) as got:
        tdec.parse_cache_buckets(spec, 8, 256, 128)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("value", ["", "auto", "1", "7", "0", "x"])
def test_decode_steps_knob_as_reference(monkeypatch, value):
    monkeypatch.setenv("TRITON_TPU_DECODE_STEPS", value)
    try:
        want = jdec.resolve_decode_steps()
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(":")[0]):
            tdec.resolve_decode_steps()
        return
    assert tdec.resolve_decode_steps() == want


def test_int8_kv_and_unknown_modes_refused(monkeypatch):
    # int8 KV serves in batched mode only, as in the reference
    monkeypatch.setenv("TRITON_TPU_DECODE_MODE", "independent")
    monkeypatch.setenv("TRITON_TPU_KV_QUANT", "int8")
    with pytest.raises(ValueError, match="requires.*batched"):
        tdec.DecodeModel(device="cpu")
    with pytest.raises(ValueError, match="requires.*batched"):
        jdec.DecodeModel(name="llama_decode_kvbad")
    monkeypatch.delenv("TRITON_TPU_DECODE_MODE")
    monkeypatch.setenv("TRITON_TPU_KV_QUANT", "fp4")
    with pytest.raises(ValueError, match="expected 'int8' or unset"):
        tdec.DecodeModel(device="cpu")
    monkeypatch.delenv("TRITON_TPU_KV_QUANT")
    monkeypatch.setenv("TRITON_TPU_DECODE_MODE", "paged")
    with pytest.raises(ValueError, match="'independent' or 'batched'"):
        tdec.DecodeModel(device="cpu")
