"""KV-cache incremental decoding for the flagship transformer stack.

Counterpart of ``triton_client_tpu/models/decode.py``.  The generation
ensemble re-runs the full 128-token window for every produced token; this
module adds the decode path: **prefill** runs the window once and records
every layer's rotated K/V into a cache, and each **decode step** then
processes one new token against the cache.

Semantics are the reference's: positions are absolute and the context grows
(true KV continuation), so step t equals a full forward over the whole
accumulated sequence (``reference_forward``).  The numerics are too: scores
and softmax in f32 from casts of q and k, the causal mask at -1e30, the head
in f32, serving storage in the compute dtype with the head kept f32, and
weight-only int8 dequantized at use (``_w``).  The attention and the cache
writes are plain PyTorch: the reference's are ``jnp`` (no Pallas kernel).

Two serving modes, as in the reference (``TRITON_TPU_DECODE_MODE``):

* ``independent`` (default): each sequence owns its cache; steps run on the
  request's thread.
* ``batched``: one preallocated slot cache (``TRITON_TPU_DECODE_SLOTS``,
  in slab buckets, ``TRITON_TPU_DECODE_BUCKETS``) owned by a worker thread
  that merges every live sequence's next step into one batched dispatch per
  tick, ``TRITON_TPU_DECODE_STEPS`` (T) steps fused into it.

Where the reference donates its cache and control state through ``jit``,
the port updates the same tensors in place; a fused T-step tick is T steps
queued on the card with no host sync between them, the feedback token and
the control state staying on the device.  The reference's on-device early
exit (every slot inactive) becomes a step count the host knows before the
dispatch: an auto slot advances exactly ``min(T, remaining, cap - pos)``
steps and a client step one, the same prediction the reference's host
mirror makes after it.  Readbacks are a non-blocking copy into pinned host
memory plus a CUDA event (``start_readback``); ``finish_readback`` is the
one place that waits.

Not ported yet (ROADMAP A7b): the prefix/KV block cache, int8 KV
(``TRITON_TPU_KV_QUANT``), HBM gating of admission, device-fault
containment (recovery of a generation after a failed dispatch, the stall
watchdog, ``device_error`` chaos).  A failed dispatch rebuilds its bucket
and fails the generations that rode it, which is what the reference does
when its recovery budget is spent.  Serve meshes (A8): the port is one
device.
"""

from __future__ import annotations

import collections
import math
import os
import queue as _queue
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import instance_kind, resolve_device
from . import transformer as tr

# the decode stack dequantizes these at use (``_w``)
quantize_layer_weights = tr.quantize_layer_weights


def _stale_error(model_name: str):
    from ..server.types import InferError

    return InferError(
        f"model '{model_name}': generation slot was reclaimed before it "
        "executed")


# ---------------------------------------------------------------------------
# The math: plain functions on tensors
# ---------------------------------------------------------------------------

def _layer_blocks(params, cfg: tr.TransformerConfig):
    """Per-layer dicts of the stacked leaves (the reference's ``scan``
    slices), including any int8 ``*_scale`` siblings."""
    keys = tr._LAYER_KEYS_MOE if cfg.moe else tr._LAYER_KEYS_DENSE
    blocks = []
    for layer in range(cfg.n_layers):
        blk = {}
        for k in keys:
            blk[k] = params[k][layer]
            s = params.get(k + "_scale")
            if s is not None:
                blk[k + "_scale"] = s[layer]
        blocks.append(blk)
    return blocks


class _Blocks:
    """:func:`_layer_blocks` of the last params dict a step function was
    called with, kept so that each decode step does not slice the ~130
    per-layer views again (one tuple, replaced whole: threads sharing the
    function never see a params dict beside another's blocks)."""

    __slots__ = ("_cfg", "_last")

    def __init__(self, cfg: tr.TransformerConfig):
        self._cfg, self._last = cfg, None

    def __call__(self, params):
        last = self._last
        if last is None or last[0] is not params:
            last = (params, _layer_blocks(params, self._cfg))
            self._last = last
        return last[1]


def _w(blk, name, dtype):
    """Weight leaf, dequantized at use when a ``<name>_scale`` sibling is
    present (weight-only int8: the stored weight stays int8)."""
    w = blk[name].to(dtype)
    s = blk.get(name + "_scale")
    return w * s.to(dtype) if s is not None else w


def _embed(params, tokens, cfg: tr.TransformerConfig):
    """Rows of the embedding, cast to the compute dtype (gathered first:
    the same values as casting the table, without casting it)."""
    return params["embed"][tokens.long()].to(cfg.dtype)


def _rope_tables(positions, half: int, theta: float):
    """cos and sin of ``positions [..., 1] * freqs`` in f32, as
    ``tr._rope`` computes them, each repeated for both halves of the head
    (``[cos, cos]``, ``[sin, sin]``)."""
    freqs = 1.0 / (theta ** (torch.arange(
        0, half, dtype=torch.float32, device=positions.device) / half))
    ang = positions.float()[..., None] * freqs
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def _rotate(x, cos, sin):
    """Rotate-halves RoPE of ``x [..., K]`` (``tr._rope``'s layout):
    ``[x1 cos - x2 sin, x2 cos + x1 sin]``, written as ``x * [cos, cos] +
    [-x2, x1] * [sin, sin]`` (the same products and sums, fewer
    launches)."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x * cos + rot * sin).to(x.dtype)


def _rotate_qk(q, k, cos, sin):
    """:func:`_rotate` of q and k in one pass (one token: their head axes
    side by side)."""
    if q.shape != k.shape:
        return _rotate(q, cos, sin), _rotate(k, cos, sin)
    qk = _rotate(torch.cat([q, k], dim=1), cos, sin)
    return qk[:, :q.shape[1]], qk[:, q.shape[1]:]


def _proj(h, w):
    """``einsum("bsd,dhk->bhsk")`` as one matmul over the flattened
    heads."""
    B, S, D = h.shape
    return (h @ w.reshape(D, -1)).view(B, S, w.shape[1],
                                       w.shape[2]).transpose(1, 2)


def _project_qkv(blk, x, cfg: tr.TransformerConfig):
    h = tr._rmsnorm(x, blk["ln1"], cfg.norm_eps)
    q = _proj(h, _w(blk, "wq", h.dtype))
    k = _proj(h, _w(blk, "wk", h.dtype))
    v = _proj(h, _w(blk, "wv", h.dtype))
    return q, k, v


def _ffn(blk, x, cfg: tr.TransformerConfig):
    """Dense SiLU FFN, or routed MoE top-k.  A single-token step gathers
    only the routed experts' weights, so the bytes a step reads scale with
    top_k, not with the number of experts."""
    h = tr._rmsnorm(x, blk["ln2"], cfg.norm_eps)
    if cfg.moe:
        gate = torch.einsum("bsd,de->bse", h.float(),
                            _w(blk, "router", torch.float32))
        thresh = torch.topk(gate, cfg.moe_top_k, dim=-1).values[..., -1:]
        probs = torch.softmax(torch.where(gate >= thresh, gate, -1e30),
                              dim=-1)
        if h.shape[0] == 1 and h.shape[1] == 1:
            idx = torch.topk(gate[0, 0], cfg.moe_top_k).indices   # [k]

            def take_w(name):
                w = blk[name].index_select(0, idx)
                s = blk.get(name + "_scale")
                if s is not None:
                    return w.to(h.dtype) * s.index_select(0, idx).to(h.dtype)
                return w.to(h.dtype)

            he = F.silu(torch.einsum("bsd,edf->ebsf", h, take_w("we1")))
            oe = torch.einsum("ebsf,efd->ebsd", he, take_w("we2"))
            p_sel = probs[0, 0].index_select(0, idx)[None, None, :]
            out = torch.einsum("ebsd,bse->bsd", oe, p_sel.to(oe.dtype))
        else:
            he = F.silu(torch.einsum("bsd,edf->ebsf", h,
                                     _w(blk, "we1", h.dtype)))
            oe = torch.einsum("ebsf,efd->ebsd", he, _w(blk, "we2", h.dtype))
            out = torch.einsum("ebsd,bse->bsd", oe, probs.to(oe.dtype))
    else:
        he = F.silu(h @ _w(blk, "w1", h.dtype))
        out = he @ _w(blk, "w2", h.dtype)
    return x + out


def _attn_out(blk, x, o):
    """``x + einsum("bhsk,hkd->bsd", o, wo)``."""
    B, H, S, K = o.shape
    wo = _w(blk, "wo", o.dtype)
    return x + o.transpose(1, 2).reshape(B, S, H * K) @ wo.reshape(H * K, -1)


def _attend(q, kc, vc, valid, dtype, head_dim: int):
    """Scores and softmax in f32 from casts of q and the keys, masked at
    -1e30 where ``valid`` is false; the output cast to ``dtype``."""
    s = (q.float() @ kc.float().transpose(-1, -2)) \
        * (1.0 / math.sqrt(head_dim))
    p = torch.softmax(torch.where(valid, s, -1e30), dim=-1)
    return (p @ vc.float()).to(dtype)


def _prefill_layer(blk, x, cfg: tr.TransformerConfig, rope, valid):
    """Full causal attention over the prompt; returns rotated K/V."""
    cos, sin = rope
    q, k, v = _project_qkv(blk, x, cfg)
    q, k = _rotate_qk(q, k, cos, sin)
    o = _attend(q, k, v, valid, x.dtype, cfg.head_dim)
    x = _attn_out(blk, x, o)
    return _ffn(blk, x, cfg), k, v


def _causal(positions):
    """[S, S] mask: query i sees keys j <= i."""
    return positions[:, None] >= positions[None, :]


def _decode_layer(blk, x, kc, vc, pos: int, cfg: tr.TransformerConfig,
                  rope, valid):
    """One token at absolute position ``pos`` against the cache, written in
    place.  x: [B, 1, D]; kc/vc: [B, H, S_max, K]."""
    cos, sin = rope
    q, k, v = _project_qkv(blk, x, cfg)
    q, k = _rotate_qk(q, k, cos, sin)
    kc[:, :, pos] = k[:, :, 0].to(kc.dtype)
    vc[:, :, pos] = v[:, :, 0].to(vc.dtype)
    o = _attend(q, kc, vc, valid, x.dtype, cfg.head_dim)
    x = _attn_out(blk, x, o)
    return _ffn(blk, x, cfg)


def _head(params, x, cfg: tr.TransformerConfig):
    h = tr._rmsnorm(x, params["final_ln"], cfg.norm_eps)
    return h.float() @ params["head"].float()


def make_prefill(cfg: tr.TransformerConfig, s_max: int):
    """(params, tokens [B, S]) -> (last-position logits [B, V], cache).

    The cache is ``{"k", "v": [L, B, H, s_max, K], "pos": S}``; ``pos`` is
    a host int (the reference keeps a device scalar and mirrors it on the
    host).  The head runs in f32 over every position, then the last one is
    taken, as in the reference."""

    blocks_of = _Blocks(cfg)

    def prefill(params, tokens):
        B, S = tokens.shape
        x = _embed(params, tokens, cfg)
        positions = torch.arange(S, device=x.device)
        rope = _rope_tables(positions, cfg.head_dim // 2, cfg.rope_theta)
        valid = _causal(positions)
        shape = (cfg.n_layers, B, cfg.n_heads, s_max, cfg.head_dim)
        kc = torch.zeros(shape, dtype=cfg.dtype, device=x.device)
        vc = torch.zeros(shape, dtype=cfg.dtype, device=x.device)
        for layer, blk in enumerate(blocks_of(params)):
            x, k, v = _prefill_layer(blk, x, cfg, rope, valid)
            kc[layer, :, :, :S] = k
            vc[layer, :, :, :S] = v
        return _head(params, x, cfg)[:, -1], {"k": kc, "v": vc, "pos": S}

    return prefill


def make_decode_step(cfg: tr.TransformerConfig):
    """(params, cache, tokens [B, 1]) -> (logits [B, V], cache').  The
    cache's tensors are written in place (the reference's donation);
    ``cache'`` holds them with ``pos`` advanced."""

    blocks_of = _Blocks(cfg)

    def step(params, cache, tokens):
        pos = int(cache["pos"])
        kc, vc = cache["k"], cache["v"]
        x = _embed(params, tokens, cfg)
        dev = x.device
        rope = _rope_tables(torch.arange(pos, pos + 1, device=dev),
                            cfg.head_dim // 2, cfg.rope_theta)
        valid = torch.arange(kc.shape[3], device=dev) <= pos
        for layer, blk in enumerate(blocks_of(params)):
            x = _decode_layer(blk, x, kc[layer], vc[layer], pos, cfg, rope,
                              valid)
        return _head(params, x, cfg)[:, -1], {"k": kc, "v": vc,
                                              "pos": pos + 1}

    return step


def reference_forward(params, tokens, cfg: tr.TransformerConfig):
    """Plain full forward over [B, S] with absolute positions: the oracle
    of prefill + decode (the same math, no cache).  Logits [B, S, V]."""
    x = _embed(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=x.device)
    rope = _rope_tables(positions, cfg.head_dim // 2, cfg.rope_theta)
    valid = _causal(positions)
    for blk in _layer_blocks(params, cfg):
        x, _, _ = _prefill_layer(blk, x, cfg, rope, valid)
    return _head(params, x, cfg)


# ---------------------------------------------------------------------------
# Slot-batched continuous decoding: one preallocated cache of N slots, every
# concurrent sequence's next step merged into one batched dispatch per tick
# ---------------------------------------------------------------------------

def _rope_at(x, pos, theta, tables=None):
    """RoPE for single-position queries/keys with per-slot positions.

    x: [B, H, 1, K]; pos: [B] int32.  ``tables`` (from
    :func:`_rope_at_tables`) saves recomputing them per layer."""
    cos, sin = tables if tables is not None else _rope_at_tables(
        pos, x.shape[-1] // 2, theta)
    return _rotate(x, cos, sin)


def _rope_at_tables(pos, half: int, theta: float):
    """:func:`_rope_tables` of per-slot positions, ``[B, 1, 1, K]``."""
    cos, sin = _rope_tables(pos, half, theta)          # [B, K]
    return cos[:, None, None, :], sin[:, None, None, :]


def parse_cache_buckets(spec, n_slots: int, s_max: int, prompt_len: int):
    """Slab-size buckets for the batched slot cache.

    ``TRITON_TPU_DECODE_BUCKETS="48x640,16x1280"`` = 48 slots capped at 640
    tokens each plus 16 at 1280; unset, one bucket ``[(n_slots, s_max)]``.
    Returns ``[(count, cap), ...]`` ascending by cap (repeated caps stay
    separate pools, in spec order); every cap must exceed the prefill
    window."""
    if not spec:
        return [(n_slots, s_max)]
    out = []
    for part in spec.split(","):
        try:
            cnt_s, cap_s = part.strip().lower().split("x")
            cnt, cap = int(cnt_s), int(cap_s)
        except ValueError:
            raise ValueError(
                f"TRITON_TPU_DECODE_BUCKETS part {part.strip()!r}: expected "
                "<count>x<tokens> (e.g. '48x640')")
        if cnt <= 0:
            raise ValueError(
                f"TRITON_TPU_DECODE_BUCKETS: count must be positive in "
                f"{part.strip()!r}")
        if cap <= prompt_len:
            raise ValueError(
                f"TRITON_TPU_DECODE_BUCKETS: cap {cap} must exceed the "
                f"{prompt_len}-token prefill window (prompt + >=1 token)")
        out.append((cnt, cap))
    out.sort(key=lambda t: t[1])  # stable: same-cap pools keep spec order
    return out


def _kv_quant_refused() -> None:
    """``TRITON_TPU_KV_QUANT``: unset or ``none`` only; int8 KV is not
    ported yet, and other values fail as in the reference."""
    v = os.environ.get("TRITON_TPU_KV_QUANT", "")
    if v in ("", "none"):
        return
    if v == "int8":
        raise ValueError(
            "TRITON_TPU_KV_QUANT=int8 is not ported yet (ROADMAP A7b)")
    raise ValueError(
        f"TRITON_TPU_KV_QUANT={v!r}: expected 'int8' or unset")


def _cache_row_write(cache, new_rows, pos, active):
    """Write each slot's ``new_rows [B, H, 1, K]`` at its position ``pos
    [B]`` of ``cache [B, H, S, K]``, keeping the current entry where the
    slot is inactive (the reference's vmapped row write).  A position past
    the slab (an inactive slot that reached its cap) is clamped, as
    ``dynamic_update_slice`` clamps it; the kept entry makes it a no-op."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    p = pos.long().clamp(0, cache.shape[2] - 1)
    cur = cache[rows, :, p]                                 # [B, H, K]
    cache[rows, :, p] = torch.where(active[:, None, None],
                                    new_rows[:, :, 0].to(cache.dtype), cur)


def _cache_block_write(cache, values, slot: int, pos0: int):
    """Write a ``[1, H, C, K]`` block into one slot of ``cache [B, H, S,
    K]`` at positions ``pos0 .. pos0 + C`` (full-slot or chunked
    prefill)."""
    cache[slot, :, pos0:pos0 + values.shape[2]] = values[0].to(cache.dtype)


def _cache_slot_slice(cache, slot: int):
    """One slot's ``[1, H, S, K]`` view of a ``[B, H, S, K]`` cache."""
    return cache[slot:slot + 1]


def _greedy_head(logits):
    """The slot kernels' greedy head: f32 cast, argmax token (the first
    maximum), max logit, and the token's log-probability under the
    raw-logit softmax."""
    l32 = logits.float()
    nxt = torch.argmax(l32, dim=-1).to(torch.int32)
    best = l32.amax(dim=-1)
    lp = best - torch.logsumexp(l32, dim=-1)
    return nxt, best, lp


def _pen_head(logits, counts, fp, pp):
    """Penalized greedy head: the token is the argmax of the penalized
    logits (``fp * count + pp * (count > 0)`` subtracted), while ``best``
    and ``lp`` report the chosen token under the raw distribution.
    logits [B, V]; counts [B, V] int32; fp/pp [B] f32."""
    l32 = logits.float()
    c = counts.float()
    pen = l32 - fp[:, None] * c - pp[:, None] * (c > 0)
    nxt = torch.argmax(pen, dim=-1).to(torch.int32)
    best = torch.gather(l32, -1, nxt[:, None].long())[:, 0]
    lp = best - torch.logsumexp(l32, dim=-1)
    return nxt, best, lp


def _slot_decode_layer(blk, x, kc, vc, pos, active, cfg: tr.TransformerConfig,
                       rope, valid):
    """One token per slot, each at its own position.  Only active slots
    write their K/V: an inactive slot (no work this tick, or mid chunked
    prefill) must not clobber the entry at its stale position."""
    q, k, v = _project_qkv(blk, x, cfg)
    H = q.shape[1]
    qk = _rope_at(torch.cat([q, k], dim=1), pos, cfg.rope_theta, rope)
    q, k = qk[:, :H], qk[:, H:]
    _cache_row_write(kc, k, pos, active)
    _cache_row_write(vc, v, pos, active)
    o = _attend(q, kc, vc, valid, x.dtype, cfg.head_dim)
    x = _attn_out(blk, x, o)
    return _ffn(blk, x, cfg)


def _slot_forward(params, blocks, k, v, tokens, pos, active,
                  cfg: tr.TransformerConfig):
    """One slot-batched decode step, the body shared by
    :func:`make_slot_step` and both fused ticks.  tokens [B] int32; k/v
    [L, B, H, S, K] written in place.  Returns (k, v, raw logits [B, V])."""
    x = _embed(params, tokens[:, None], cfg)                # [B, 1, D]
    rope = _rope_at_tables(pos, cfg.head_dim // 2, cfg.rope_theta)
    S = k.shape[3]
    valid = (torch.arange(S, device=x.device)[None, :]
             <= pos[:, None])[:, None, None, :]             # [B, 1, 1, S]
    for layer, blk in enumerate(blocks):
        x = _slot_decode_layer(blk, x, k[layer], v[layer], pos, active, cfg,
                               rope, valid)
    return k, v, _head(params, x, cfg)[:, -1]


def make_slot_step(cfg: tr.TransformerConfig):
    """(params, k [L,B,H,S,K], v, tokens [B], prev [B], pos [B], active [B]
    bool, auto [B] bool) -> (greedy tokens [B] int32, best logits [B] f32,
    logprobs [B] f32, k', v').

    Every slot computes; only active slots write K/V.  Auto slots take
    their input from ``prev`` (the previous step's device-resident output)
    instead of ``tokens``."""

    blocks_of = _Blocks(cfg)

    def step(params, k, v, tokens, prev, pos, active, auto):
        tokens = torch.where(auto, prev, tokens)
        k, v, logits = _slot_forward(params, blocks_of(params), k, v,
                                     tokens, pos, active, cfg)
        nxt, best, lp = _greedy_head(logits)
        return nxt, best, lp, k, v

    return step


def resolve_decode_steps() -> int:
    """``TRITON_TPU_DECODE_STEPS``: decode steps fused into one dispatch by
    the batched worker (T; default 4, ``1`` is the single-step tick)."""
    v = os.environ.get("TRITON_TPU_DECODE_STEPS", "")
    if v in ("", "auto"):
        return 4
    try:
        n = int(v)
    except ValueError:
        raise ValueError(
            f"TRITON_TPU_DECODE_STEPS={v!r}: expected a positive integer "
            "or 'auto'")
    if n < 1:
        raise ValueError(f"TRITON_TPU_DECODE_STEPS={n} must be >= 1")
    return n


class _Readback:
    """A device->host copy in flight: its pinned host buffer and the event
    recorded behind the copy."""

    __slots__ = ("host", "event")

    def __init__(self, host, event):
        self.host, self.event = host, event


def start_readback(arr):
    """Begin the device->host transfer of ``arr`` without blocking: a
    non-blocking copy into pinned host memory and a CUDA event behind it.
    A CPU tensor is copied at once.  Pairs with :func:`finish_readback`."""
    if isinstance(arr, torch.Tensor) and arr.is_cuda:
        host = torch.empty(arr.shape, dtype=arr.dtype, pin_memory=True)
        host.copy_(arr, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return _Readback(host, event)
    return arr.detach().clone()


def readback_ready(pending) -> bool:
    """Whether :func:`finish_readback` of ``pending`` would return without
    waiting (never waits itself)."""
    return not isinstance(pending, _Readback) or pending.event.query()


def finish_readback(pending):
    """Resolve a started readback to a numpy array: the one deliberate
    blocking sync point of the decode double buffer (resolver threads wait
    here, so the worker never does)."""
    if isinstance(pending, _Readback):
        # tpu-lint: disable=DEVICE-SYNC the ONE double-buffer resolve point
        pending.event.synchronize()
        return pending.host.numpy()
    return pending.numpy()


def _upload(arr, device: torch.device):
    """A host array on ``device``: through pinned memory and a non-blocking
    copy on CUDA, so no upload waits for the work queued on the card."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


def _new_decode_state(cnt: int, device):
    """Device-resident per-slot control state of one cache bucket, updated
    by the fused tick itself: ``tokens`` (the last client-supplied token),
    ``prev`` (the slot's previous greedy output, the self-feeding loop's
    feedback), ``pos`` (absolute position; the host keeps an exact mirror),
    ``active`` (computes and writes this step), ``auto`` (self-feeds) and
    ``remaining`` (tokens left before an auto slot deactivates)."""
    def z(dtype):
        return torch.zeros(cnt, dtype=dtype, device=device)

    return {"tokens": z(torch.int32), "prev": z(torch.int32),
            "pos": z(torch.int32), "active": z(torch.bool),
            "auto": z(torch.bool), "remaining": z(torch.int32)}


def _state_admit(state, li: int, prev_tok, pos: int, self_feed: bool,
                 remaining: int):
    """Prefill finished for bucket-local slot ``li``: seed the feedback
    token (a device scalar) and the position; ``self_feed`` activates a
    server-side generation.  In place; returns the state."""
    state["prev"][li] = prev_tok
    state["pos"][li] = pos
    state["active"][li] = self_feed
    state["auto"][li] = self_feed
    state["remaining"][li] = remaining
    return state


def _state_deactivate(state, li: int):
    """Stop a self-feeding slot on the device (cancellation and reaping;
    the tick deactivates finished slots itself).  In place."""
    state["active"][li] = False
    state["auto"][li] = False
    return state


def _fused_tick_frame(n_steps: int):
    """Shared scaffolding of the fused multi-step ticks: merge the
    dispatch's client-step mask into the state, run ``body_step`` for
    ``n_run`` steps (at most T) with the state updated on the device, and
    stack each step's three output rows into the ``[3, T, B]`` readback
    block."""

    def run(k, v, state, step_mask, step_tokens, extra, body_step, n_run):
        B = step_mask.shape[0]
        S = k.shape[3]
        st = dict(state,
                  tokens=torch.where(step_mask, step_tokens,
                                     state["tokens"]),
                  active=state["active"] | step_mask)
        out = torch.zeros((3, n_steps, B), dtype=torch.float32,
                          device=step_mask.device)
        for t in range(min(n_run, n_steps)):
            k, v, row, nxt, extra = body_step(k, v, st, extra)
            out[:, t] = row
            act, auto = st["active"], st["auto"]
            rem = st["remaining"] - (act & auto).to(torch.int32)
            pos = st["pos"] + act.to(torch.int32)
            done = auto & act & ((rem <= 0) | (pos >= S))
            st = {
                "tokens": st["tokens"],
                # client-driven slots ran their one step; auto slots stop
                # when drained or at the slab cap
                "prev": torch.where(act, nxt, st["prev"]),
                "pos": pos,
                "active": act & auto & ~done,
                "auto": auto & ~done,
                "remaining": rem,
            }
        return k, v, st, out, extra

    return run


def make_fused_slot_step(cfg: tr.TransformerConfig, n_steps: int):
    """(params, k, v, state, step_mask, step_tokens, n_run) -> (k', v',
    state', out [3, T, B] f32, steps run).

    Up to ``n_steps`` (T) decode steps queued as one dispatch, the cache
    and control state on the device: client-driven slots in
    ``step_mask`` run exactly one step (step 0) with ``step_tokens``; auto
    slots feed on their own previous output and deactivate when
    ``remaining`` runs out or the slab cap is hit.  ``n_run`` (default T)
    is the number of steps the host predicts the cohort needs.
    ``out[0]`` = greedy tokens, ``out[1]`` = best raw logits, ``out[2]`` =
    chosen-token logprobs, per (step, slot); rows at or past the steps run
    are zeros.  Each step is :func:`make_slot_step`'s math."""
    frame = _fused_tick_frame(n_steps)
    blocks_of = _Blocks(cfg)

    def fused(params, k, v, state, step_mask, step_tokens, n_run=None):
        blocks = blocks_of(params)
        n_run = n_steps if n_run is None else n_run

        def body_step(k, v, st, extra):
            toks = torch.where(st["auto"], st["prev"], st["tokens"])
            k, v, logits = _slot_forward(params, blocks, k, v, toks,
                                         st["pos"], st["active"], cfg)
            nxt, best, lp = _greedy_head(logits)
            return k, v, torch.stack([nxt.float(), best, lp]), nxt, extra

        k, v, st, out, _ = frame(k, v, state, step_mask, step_tokens, None,
                                 body_step, n_run)
        return k, v, st, out, min(n_run, n_steps)

    return fused


def make_fused_slot_step_pen(cfg: tr.TransformerConfig, n_steps: int):
    """Penalized :func:`make_fused_slot_step`: per-slot frequency/presence
    penalties (``fp``/``pp`` [B] on the device, zero = the plain head) at
    the greedy head each step, the count matrix ``counts [B, V]`` carried
    on the device; only active auto slots add their chosen token.
    Returns the updated counts last."""
    frame = _fused_tick_frame(n_steps)
    blocks_of = _Blocks(cfg)

    def fused(params, k, v, state, step_mask, step_tokens, counts, fp, pp,
              n_run=None):
        blocks = blocks_of(params)
        n_run = n_steps if n_run is None else n_run
        rows = torch.arange(counts.shape[0], device=counts.device)

        def body_step(k, v, st, counts):
            toks = torch.where(st["auto"], st["prev"], st["tokens"])
            k, v, logits = _slot_forward(params, blocks, k, v, toks,
                                         st["pos"], st["active"], cfg)
            nxt, best, lp = _pen_head(logits, counts, fp, pp)
            take = (st["active"] & st["auto"]).to(counts.dtype)
            counts = counts.index_put((rows, nxt.long()), take,
                                      accumulate=True)
            return k, v, torch.stack([nxt.float(), best, lp]), nxt, counts

        k, v, st, out, counts = frame(k, v, state, step_mask, step_tokens,
                                      counts, body_step, n_run)
        return k, v, st, out, min(n_run, n_steps), counts

    return fused


def _prefill_slot(params, k, v, tokens, slot: int, cfg):
    """Prefill one slot of the shared cache in a single forward: its lane
    holds the prompt's K/V, zeros after.  Returns the raw last logits."""
    B, S = tokens.shape
    x = _embed(params, tokens, cfg)
    positions = torch.arange(S, device=x.device)
    rope = _rope_tables(positions, cfg.head_dim // 2, cfg.rope_theta)
    valid = _causal(positions)
    for layer, blk in enumerate(_layer_blocks(params, cfg)):
        x, kl, vl = _prefill_layer(blk, x, cfg, rope, valid)
        _cache_block_write(k[layer], kl, slot, 0)
        _cache_block_write(v[layer], vl, slot, 0)
    k[:, slot, :, S:] = 0
    v[:, slot, :, S:] = 0
    return _head(params, x, cfg)[:, -1]


def make_slot_prefill(cfg: tr.TransformerConfig):
    """(params, k, v, tokens [1, S], slot) -> (next token, best logit,
    logprob, k', v'): prefills one slot of the shared cache (of any slab
    length: the cache's own).  The three scalars stay on the device."""

    def prefill(params, k, v, tokens, slot):
        logits = _prefill_slot(params, k, v, tokens, slot, cfg)
        nxt, best, lp = _greedy_head(logits)
        return nxt[0], best[0], lp[0], k, v

    return prefill


def make_slot_prefill_pen(cfg: tr.TransformerConfig):
    """Penalized :func:`make_slot_prefill`: the first token already
    respects the prompt's counts (``counts_row [V]``, ``fp``, ``pp``); the
    chosen token is added to the row, which is returned last."""

    def prefill(params, k, v, tokens, slot, counts_row, fp, pp):
        logits = _prefill_slot(params, k, v, tokens, slot, cfg)
        dev = logits.device
        nxt, best, lp = _pen_head(
            logits, counts_row[None, :],
            torch.full((1,), fp, dtype=torch.float32, device=dev),
            torch.full((1,), pp, dtype=torch.float32, device=dev))
        counts_row = counts_row.index_put(
            (nxt.long(),), torch.ones(1, dtype=counts_row.dtype, device=dev),
            accumulate=True)
        return nxt[0], best[0], lp[0], k, v, counts_row

    return prefill


def make_slot_chunk_prefill(cfg: tr.TransformerConfig, s_max: int):
    """(params, k, v, chunk [1, C], slot, pos0) -> (next token, best logit,
    logprob, k', v'): prefills one chunk of a slot's prompt.  The chunk
    attends to the cache prefix earlier chunks wrote (positions < pos0) and
    causally within itself, exactly reproducing full-prompt prefill; the
    token is meaningful on the final chunk only."""

    def chunk_prefill(params, k, v, chunk, slot, pos0):
        B, C = chunk.shape
        S = k.shape[3]
        x = _embed(params, chunk, cfg)
        dev = x.device
        positions = torch.arange(pos0, pos0 + C, device=dev)
        rope = _rope_tables(positions, cfg.head_dim // 2, cfg.rope_theta)
        # [C, S]: chunk position i sees cache entries j <= pos0 + i
        valid = torch.arange(S, device=dev)[None, :] <= positions[:, None]
        for layer, blk in enumerate(_layer_blocks(params, cfg)):
            cos, sin = rope
            q, kk, vv = _project_qkv(blk, x, cfg)
            q, kk = _rotate_qk(q, kk, cos, sin)
            _cache_block_write(k[layer], kk, slot, pos0)
            _cache_block_write(v[layer], vv, slot, pos0)
            o = _attend(q, _cache_slot_slice(k[layer], slot),
                        _cache_slot_slice(v[layer], slot), valid, x.dtype,
                        cfg.head_dim)
            x = _ffn(blk, _attn_out(blk, x, o), cfg)
        nxt, best, lp = _greedy_head(_head(params, x, cfg)[:, -1])
        return nxt[0], best[0], lp[0], k, v

    return chunk_prefill


def _next_pair(logits):
    """The readback, started, of a step's greedy token and its logit (one
    copy for both scalars)."""
    return start_readback(torch.stack(
        [torch.argmax(logits, dim=-1)[0].float(), logits.amax(dim=-1)[0]]))


def _host_tokens(x) -> np.ndarray:
    """A request's TOKENS as a host int32 array (a CUDA shared-memory
    input arrives as a tensor)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# llama_decode
# ---------------------------------------------------------------------------

class DecodeModel:
    """``llama_decode``: sequence-stateful greedy decoding.

    Protocol (sequence semantics, the wire of ``simple_sequence``):

    * a ``sequence_start`` request carries TOKENS ``[prompt_len]``: the
      prompt is prefilled and the first greedy token returns;
    * every following request carries TOKENS ``[1]`` (usually the token the
      server just returned) and pays one single-token decode step;
    * ``sequence_end`` frees the sequence's cache; idle sequences are
      evicted after the config's idle time.

    Independent mode runs each step on the request's thread; batched mode
    (``TRITON_TPU_DECODE_MODE=batched``) hands it to the worker that owns
    the slot cache (see the module docstring).  The weights are
    ``llama_tpu``'s (the ``TRITON_TPU_LLAMA_PRESET`` preset for the
    device, seed 3), or ``params`` (numpy arrays in the reference's
    layout); ``TRITON_TPU_QUANT[_<MODEL>]=int8`` serves weight-only int8.
    """

    #: accumulation window per tick: long enough for a cohort's next
    #: requests to arrive after the previous tick resolved them all
    TICK_ACCUMULATE_S = 0.004

    def __init__(self, name="llama_decode", prompt_len=None, s_max=None,
                 n_slots=None, device=None,
                 params: Optional[Dict[str, np.ndarray]] = None):
        from ..server.model import Model, make_config
        from . import language

        self._language = language
        self._device = resolve_device(device)
        self._np_params = params
        self._prompt_len = prompt_len or language.LLAMA_SEQ_LEN
        self._s_max = s_max or 2 * self._prompt_len
        if n_slots is None:
            n_slots = int(os.environ.get("TRITON_TPU_DECODE_SLOTS", "8"))
        self._mode = os.environ.get("TRITON_TPU_DECODE_MODE", "independent")
        if self._mode not in ("independent", "batched"):
            raise ValueError(
                f"TRITON_TPU_DECODE_MODE={self._mode!r}: expected "
                "'independent' or 'batched'")
        bucket_spec = os.environ.get("TRITON_TPU_DECODE_BUCKETS")
        if bucket_spec and self._mode != "batched":
            raise ValueError(
                "TRITON_TPU_DECODE_BUCKETS requires "
                "TRITON_TPU_DECODE_MODE=batched (independent mode has no "
                "shared slot cache to bucket)")
        self._buckets = parse_cache_buckets(
            bucket_spec, n_slots, self._s_max, self._prompt_len)
        _kv_quant_refused()
        self._decode_steps = resolve_decode_steps()
        self._n_slots = sum(c for c, _ in self._buckets)
        self._s_max = max(cap for _, cap in self._buckets)
        self._bucket_off = []
        off = 0
        for cnt, _cap in self._buckets:
            self._bucket_off.append(off)
            off += cnt
        cfg = make_config(
            name,
            inputs=[("TOKENS", "INT32", [-1])],
            outputs=[("NEXT_TOKEN", "INT32", [1]),
                     ("NEXT_LOGIT", "FP32", [1])],
            sequence_batching=True,
            instance_kind=instance_kind(self._device),
            parameters={"prompt_tokens": str(self._prompt_len)},
        )
        outer = self

        class _Impl(Model):  # noqa: N801 - adapter onto the abstract Model
            def execute(inner, inputs, parameters):
                return outer._execute(inputs, parameters)

            def unload(inner):
                outer._shutdown()

            def attach_device_stats(inner, ds):
                outer.attach_device_stats(ds)

            def attach_cost_ledger(inner, ledger):
                outer.attach_cost_ledger(ledger)

        self._model = _Impl(cfg)
        self._model.decode_model = self
        self._device_stats = None
        self._cost_ledger = None
        self._slot_tenant: Dict[int, str] = {}
        self._state: Dict[Any, Any] = {}      # seq_id -> slot or cache
        self._free = set(range(self._n_slots))
        self._touched: Dict[Any, float] = {}
        self._seq_locks: Dict[Any, Any] = {}
        self._idle_s = cfg.max_sequence_idle_microseconds / 1e6
        self._lock = threading.Lock()
        self._init_lock = threading.Lock()
        # one request thread at a time queues independent-mode work on the
        # card: PyTorch lets go of the interpreter lock around every op, and
        # threads queueing at once thrash it (on an H100 host, 8 threads
        # took 5x one thread's time for the same decode steps)
        self._enqueue_lock = threading.Lock()
        self._fns = None
        self._fns_ind = None
        self._params = None
        self._prefill_chunk = 0
        self._chunk_fn = None
        self._jobs = None
        self._worker = None
        self._closed = False
        # per-slot generation: bumped on every release, so a job of a dead
        # sequence never touches the slot's next occupant
        self._slot_gen = [0] * self._n_slots
        # worker-owned: the slot caches and the host mirror of positions
        self._k = self._v = None
        self._pos = None
        # worker-owned dispatch id, stamped on tick rows and on each
        # traced stream's tick entries (their join key)
        self._tick_seq = 0

    @property
    def model(self):
        return self._model

    def attach_device_stats(self, ds) -> None:
        """The serving core's ``DeviceStatsCollector``: the batched worker
        records one tick row per fused dispatch into it."""
        self._device_stats = ds

    def attach_cost_ledger(self, ledger) -> None:
        """The serving core's ``CostLedger``: the batched worker charges
        each live slot's tenant an equal share of every tick's dispatch
        window and its generated tokens."""
        self._cost_ledger = ledger

    # -- lazy init ---------------------------------------------------------
    def _ensure_params(self):
        """The weights, built once: serving storage in the compute dtype
        with the f32 head kept f32 (decode reads every weight each step),
        or weight-only int8 under ``TRITON_TPU_QUANT=int8``."""
        if self._params is None:
            with self._init_lock:
                if self._params is None:
                    cfg = self._language.llama_cfg(self._device)
                    if self._np_params is not None:
                        params = tr.params_from_jax(self._np_params, cfg,
                                                    self._device)
                    else:
                        gen = torch.Generator(self._device).manual_seed(3)
                        params = tr.init_params(gen, cfg)
                    quant = tr.resolve_quant(self._model.name)
                    if quant == "int8":
                        params = quantize_layer_weights(params, cfg)
                    else:
                        params = {k: (v.to(cfg.dtype) if k != "head"
                                      and v.dtype == torch.float32 else v)
                                  for k, v in params.items()}
                    self._params = (params, cfg)
        return self._params

    def _ensure_fns(self):
        """The batched worker's state, built once: one cache and control
        state per slab bucket, the step functions and the worker thread."""
        if self._fns is None:
            params, cfg = self._ensure_params()
            with self._init_lock:
                if self._fns is None:
                    import concurrent.futures as _cf

                    dev = self._device
                    self._k, self._v, self._dstate = [], [], []
                    self._zero_mask, self._zero_tok = [], []
                    for cnt, cap in self._buckets:
                        kb, vb = self._new_cache_arrays(cnt, cap, cfg)
                        self._k.append(kb)
                        self._v.append(vb)
                        self._dstate.append(_new_decode_state(cnt, dev))
                        # a tick with no client step reuses these
                        self._zero_mask.append(
                            torch.zeros(cnt, dtype=torch.bool, device=dev))
                        self._zero_tok.append(
                            torch.zeros(cnt, dtype=torch.int32, device=dev))
                    self._auto_slots = {}
                    # (slot, gen) pairs whose sink resolution failed
                    self._dead_gens = set()
                    # bound how far dispatch runs ahead of readbacks
                    self._tick_budget = threading.Semaphore(4)
                    self._pos = np.zeros(self._n_slots, np.int32)
                    self._jobs = _queue.Queue()
                    self._readers = _cf.ThreadPoolExecutor(
                        max_workers=4,
                        thread_name_prefix=f"{self._model.name}-readback")
                    # generation sinks need per-slot order: one thread
                    self._gen_reader = _cf.ThreadPoolExecutor(
                        max_workers=1,
                        thread_name_prefix=f"{self._model.name}-gen")
                    chunk = int(os.environ.get("TRITON_TPU_PREFILL_CHUNK",
                                               "0"))
                    if chunk < 0 or (chunk and self._prompt_len % chunk):
                        raise ValueError(
                            f"TRITON_TPU_PREFILL_CHUNK={chunk} must be 0 "
                            f"or a divisor of prompt_len="
                            f"{self._prompt_len}")
                    self._prefill_chunk = chunk
                    self._chunk_fn = (
                        make_slot_chunk_prefill(cfg, self._s_max)
                        if chunk else None)
                    # penalty state, allocated at a bucket's first
                    # penalized admission
                    self._pen_counts = [None] * len(self._buckets)
                    self._pen_fp = [np.zeros(c, np.float32)
                                    for c, _ in self._buckets]
                    self._pen_pp = [np.zeros(c, np.float32)
                                    for c, _ in self._buckets]
                    self._pen_fp_dev = [
                        torch.zeros(c, dtype=torch.float32, device=dev)
                        for c, _ in self._buckets]
                    self._pen_pp_dev = [
                        torch.zeros(c, dtype=torch.float32, device=dev)
                        for c, _ in self._buckets]
                    self._pen_n = [0] * len(self._buckets)
                    self._slot_pen_seed = {}  # slot -> (fp, pp, row)
                    self._prefill_pen_fn = make_slot_prefill_pen(cfg)
                    self._fused_fn = make_fused_slot_step(
                        cfg, self._decode_steps)
                    self._fused_pen_fn = make_fused_slot_step_pen(
                        cfg, self._decode_steps)
                    self._worker = threading.Thread(
                        target=self._worker_loop, daemon=True,
                        name=f"{self._model.name}-decode-worker")
                    self._fns = (make_slot_prefill(cfg), params, cfg)
                    self._worker.start()
        return self._fns

    def _shutdown(self):
        with self._lock:
            self._closed = True
        if self._jobs is not None:
            self._jobs.put(None)

    def _ensure_fns_independent(self):
        if self._fns_ind is None:
            params, cfg = self._ensure_params()
            with self._init_lock:
                if self._fns_ind is None:
                    self._fns_ind = (make_prefill(cfg, self._s_max),
                                     make_decode_step(cfg), params, cfg)
        return self._fns_ind

    # -- slot bookkeeping (under self._lock) -------------------------------
    def _slot_bucket(self, slot: int):
        """Global slot id -> (bucket index, bucket-local index)."""
        for b in range(len(self._buckets) - 1, -1, -1):
            off = self._bucket_off[b]
            if slot >= off:
                return b, slot - off
        raise ValueError(f"slot {slot} out of range")

    def _slot_cap(self, slot: int) -> int:
        return self._buckets[self._slot_bucket(slot)[0]][1]

    def _alloc_slot_locked(self, need_s: int, prefer_large: bool = False):
        """Pop a free slot whose slab holds ``need_s`` tokens, or None.
        Generations fill the smallest fitting slab first, sequences prefer
        the largest; same-cap pools fill in order."""
        order = range(len(self._buckets))
        if prefer_large:
            order = sorted(order, key=lambda i: (-self._buckets[i][1], i))
        for b in order:
            cnt, cap = self._buckets[b]
            if cap < need_s:
                continue
            off = self._bucket_off[b]
            for slot in range(off, off + cnt):
                if slot in self._free:
                    self._free.discard(slot)
                    return slot
        return None

    def _evict_idle_locked(self, now: float) -> None:
        stale = [k for k, t in self._touched.items()
                 if now - t > self._idle_s]
        for key in stale:
            self._release_entry_locked(key)

    def _release_locked(self, seq_id) -> None:
        self._release_entry_locked(seq_id)

    def _release_entry_locked(self, seq_id) -> None:
        slot = self._state.pop(seq_id, None)
        if isinstance(slot, int):  # independent mode stores caches
            self._free.add(slot)
            self._slot_gen[slot] += 1
            self._slot_tenant.pop(slot, None)
        self._touched.pop(seq_id, None)
        self._seq_locks.pop(seq_id, None)

    # -- worker: single owner of the slot cache ------------------------------
    def _worker_loop(self):
        from ..server.types import InferError

        if self._device.type == "cuda":
            # the worker's first CUDA work runs on the primary context
            torch.cuda.set_device(self._device.index or 0)
        prefill, params, cfg = self._fns
        dev = self._device

        def fail_stale(fut):
            fut.set_exception(InferError(
                f"model '{self._model.name}': sequence was evicted or "
                "ended before this request executed"))

        def deliver_error(completion, err):
            """A prefill's failure: to the future, or through the ordered
            gen reader to a generation's sink."""
            if completion[0] == "fut":
                completion[1].set_exception(err)
            else:
                completion[2].failed = True
                self._gen_reader.submit(completion[2].put, err)

        def drain_and_fail():
            err = InferError(f"model '{self._model.name}' is unloading", 503)
            while True:
                try:
                    j = self._jobs.get_nowait()
                except _queue.Empty:
                    break
                if j is None:
                    continue
                if j[0] in ("prefill", "prefill_cont"):
                    deliver_error(j[1][-1], err)
                elif j[0] == "step":
                    j[2].set_exception(err)
            for info in self._auto_slots.values():
                self._gen_reader.submit(info["sink"].put, err)
            self._auto_slots.clear()

        def begin_prefill_trace(completion):
            """The first chunk of a generation's prefill closes its
            SLOT_WAIT stage (submit -> worker pickup)."""
            if completion[0] != "gen":
                return
            sink = completion[2]
            st = getattr(sink, "trace", None)
            if st is None or getattr(sink, "t_prefill0", None) is not None:
                return
            now = time.monotonic_ns()
            st.add_span("SLOT_WAIT", sink.t_submit, now)
            sink.t_prefill0 = now

        def finish_prefill(slot, gen, win_len, nxt_dev, best_dev, lp_dev,
                           completion):
            """Prefill finished: the sequence path resolves its future
            with the first token; the generation path streams it, seeds
            the device-side feedback and registers the slot as
            self-feeding."""
            self._pos[slot] = win_len
            b, li = self._slot_bucket(slot)
            if completion[0] == "fut":
                # a sequence slot: its client steps advance the device
                # position in the tick from here; it stays inactive
                _state_admit(self._dstate[b], li, nxt_dev, win_len, False, 0)
                pair = start_readback(torch.stack([nxt_dev.float(),
                                                   best_dev]))
                self._readers.submit(self._resolve_prefill, pair,
                                     completion[1])
                return
            _tag, n_tokens, sink = completion
            st = getattr(sink, "trace", None)
            if st is not None:
                now = time.monotonic_ns()
                if getattr(sink, "t_prefill0", None) is not None:
                    st.add_span("PREFILL", sink.t_prefill0, now)
                # the DECODE stage closes with the last token
                sink.t_decode0 = now
            _state_admit(self._dstate[b], li, nxt_dev, win_len,
                         n_tokens > 1, n_tokens - 1)
            pair = start_readback(torch.stack([nxt_dev.float(), lp_dev]))
            self._gen_reader.submit(self._resolve_gen_token, pair, sink,
                                    n_tokens == 1, slot, gen)
            if n_tokens > 1:
                self._auto_slots[slot] = {
                    "remaining": n_tokens - 1, "sink": sink, "gen": gen}
            else:
                self._release_gen_slot(slot)

        def reap_dead_gens():
            """Drop self-feeding slots whose sink resolution failed."""
            with self._lock:
                dead = list(self._dead_gens)
                self._dead_gens.clear()
            for slot, gen in dead:
                info = self._auto_slots.get(slot)
                if info is not None and info["gen"] == gen:
                    self._auto_slots.pop(slot)
                    self._deactivate_slot(slot)
                    self._release_gen_slot(slot)

        def retire_cancelled(slot, sink):
            """Free a cancelled generation's slot (stopping its self-feed
            on the device) and end its sink."""
            self._deactivate_slot(slot)
            self._release_gen_slot(slot)
            self._close_decode_span(sink)
            self._gen_reader.submit(sink.put, None)

        def gen_was_cancelled(slot, completion) -> bool:
            """A queued prefill whose consumer already left: retire it
            before spending device time."""
            if (completion[0] == "gen"
                    and getattr(completion[2], "cancelled", False)):
                retire_cancelled(slot, completion[2])
                return True
            return False

        def reap_cancelled_gens():
            """Free self-feeding slots whose consumer went away."""
            for slot in list(self._auto_slots):
                info = self._auto_slots[slot]
                if getattr(info["sink"], "cancelled", False):
                    self._auto_slots.pop(slot)
                    retire_cancelled(slot, info["sink"])

        def stale_prefill(slot, gen, completion) -> bool:
            if gen == self._slot_gen[slot]:
                return False
            deliver_error(completion, _stale_error(self._model.name))
            return True

        while True:
            if self._dead_gens:
                reap_dead_gens()
            if self._auto_slots:
                reap_cancelled_gens()
            if self._auto_slots:
                # self-feeding generations in flight: tick them even when
                # no client job is queued
                try:
                    job = self._jobs.get_nowait()
                except _queue.Empty:
                    job = ("tick", None, None)
            else:
                job = self._jobs.get()
            if job is None:
                drain_and_fail()
                # the readers finish what is queued, then end
                self._readers.shutdown(wait=False)
                self._gen_reader.shutdown(wait=False)
                return
            kind, payload, fut = job
            # one prefill flow serves ("fut", future) for the sequence
            # protocol and ("gen", n_tokens, sink) for generation
            if kind == "prefill":
                slot, gen, win, completion = payload
                if stale_prefill(slot, gen, completion) or \
                        gen_was_cancelled(slot, completion):
                    continue
                begin_prefill_trace(completion)
                C = self._prefill_chunk
                b, li = self._slot_bucket(slot)
                with self._lock:
                    seed = self._slot_pen_seed.pop(slot, None)
                try:
                    if seed is not None:
                        # penalized: the first token respects the prompt
                        # counts (a full prefill)
                        fp, pp, row = seed
                        self._ensure_pen_bucket(b)
                        (nxt, best, lp, self._k[b], self._v[b],
                         new_row) = self._prefill_pen_fn(
                            params, self._k[b], self._v[b],
                            _upload(win, dev), li, _upload(row, dev),
                            fp, pp)
                        self._pen_counts[b][li] = new_row
                        # device-resident penalty scalars: written once at
                        # admission, zeroed at release
                        self._pen_fp_dev[b][li] = fp
                        self._pen_pp_dev[b][li] = pp
                        with self._lock:
                            self._pen_fp[b][li] = fp
                            self._pen_pp[b][li] = pp
                            self._pen_n[b] += 1
                        finish_prefill(slot, gen, win.shape[1], nxt, best,
                                       lp, completion)
                        continue
                    if C and win.shape[1] > C:
                        # chunked: the first chunk now, the continuation at
                        # the queue's tail so decode steps tick in between
                        _, _, _, self._k[b], self._v[b] = self._chunk_fn(
                            params, self._k[b], self._v[b],
                            _upload(win[:, :C], dev), li, 0)
                        self._jobs.put(("prefill_cont",
                                        (slot, gen, win, C, completion),
                                        None))
                        continue
                    nxt, best, lp, self._k[b], self._v[b] = prefill(
                        params, self._k[b], self._v[b], _upload(win, dev),
                        li)
                    finish_prefill(slot, gen, win.shape[1], nxt, best, lp,
                                   completion)
                except Exception as e:  # noqa: BLE001 - via completion
                    deliver_error(completion, e)
                    # frees and invalidates every slot of the bucket, this
                    # one included
                    self._rebuild_bucket_cache(b)
                continue
            if kind == "prefill_cont":
                slot, gen, win, pos0, completion = payload
                if stale_prefill(slot, gen, completion) or \
                        gen_was_cancelled(slot, completion):
                    continue
                C = self._prefill_chunk
                b, li = self._slot_bucket(slot)
                try:
                    nxt, best, lp, self._k[b], self._v[b] = self._chunk_fn(
                        params, self._k[b], self._v[b],
                        _upload(win[:, pos0:pos0 + C], dev), li, pos0)
                    if pos0 + C < win.shape[1]:
                        self._jobs.put(("prefill_cont",
                                        (slot, gen, win, pos0 + C,
                                         completion), None))
                        continue
                    finish_prefill(slot, gen, win.shape[1], nxt, best, lp,
                                   completion)
                except Exception as e:  # noqa: BLE001 - via completion
                    deliver_error(completion, e)
                    self._rebuild_bucket_cache(b)
                continue
            # Merge steps into this tick.  The accumulation window lets a
            # cohort's next requests, which land a few milliseconds after
            # the previous tick resolved them, ride one dispatch.  Other
            # jobs wait one tick.
            batch = []
            seen = set()
            deferred = []
            closing = False

            def admit(p, f):
                slot, gen, tok = p
                if gen != self._slot_gen[slot]:
                    fail_stale(f)
                    return
                batch.append(((slot, tok), f))
                seen.add(slot)

            if kind == "step":
                admit(payload, fut)
                deadline = time.monotonic() + self.TICK_ACCUMULATE_S
                while len(seen) < self._n_slots and not closing:
                    timeout = deadline - time.monotonic()
                    if timeout <= 0:
                        break
                    try:
                        nxt_job = self._jobs.get(timeout=timeout)
                    except _queue.Empty:
                        break
                    if nxt_job is None:
                        deferred.append(None)
                        closing = True
                        break
                    k2, p2, f2 = nxt_job
                    if k2 == "step" and p2[0] not in seen:
                        admit(p2, f2)
                    else:
                        deferred.append(nxt_job)
                for d in deferred:
                    self._jobs.put(d)
            if not batch and not self._auto_slots:
                continue
            t_asm0 = time.monotonic_ns()
            queue_depth = self._jobs.qsize()
            # this tick's work by slab bucket: one dispatch per bucket
            work = [None] * len(self._buckets)

            def bucket_work(b):
                if work[b] is None:
                    work[b] = {"tokens": None, "mask": None,
                               "batch": [], "gens": []}
                return work[b]

            for (slot, tok), f in batch:
                b, li = self._slot_bucket(slot)
                w = bucket_work(b)
                if w["tokens"] is None:
                    cnt = self._buckets[b][0]
                    w["tokens"] = np.zeros(cnt, np.int32)
                    w["mask"] = np.zeros(cnt, bool)
                w["tokens"][li] = tok
                w["mask"][li] = True
                w["batch"].append((li, f))
            for slot in list(self._auto_slots):
                info = self._auto_slots[slot]
                if info["gen"] != self._slot_gen[slot]:
                    # invalidated by a rebuild, which failed its sink
                    self._auto_slots.pop(slot)
                    continue
                b, li = self._slot_bucket(slot)
                bucket_work(b)["gens"].append((slot, li))
            T = self._decode_steps
            for b, w in enumerate(work):
                if w is None:
                    continue
                cnt, cap = self._buckets[b]
                off = self._bucket_off[b]
                # the host mirror is exact: an auto slot advances
                # min(T, remaining, cap - pos) steps (the tick deactivates
                # it on the device at the same step) and a client step 1,
                # so the dispatch runs exactly the steps its cohort needs
                advances = {
                    slot: min(T, self._auto_slots[slot]["remaining"],
                              cap - int(self._pos[slot]))
                    for slot, _li in w["gens"]}
                steps_run = max([1 if w["batch"] else 0]
                                + list(advances.values()))
                self._tick_budget.acquire()
                uploads = 0
                if w["batch"]:
                    # the only per-tick control uploads: this dispatch's
                    # client tokens and their mask
                    step_tokens = _upload(w["tokens"], dev)
                    step_mask = _upload(w["mask"], dev)
                    uploads = 2
                else:
                    step_tokens = self._zero_tok[b]
                    step_mask = self._zero_mask[b]
                t_disp0 = time.monotonic_ns()
                try:
                    if self._pen_n[b] > 0:
                        # a penalized generation in this bucket: the
                        # penalized tick (zero rows are the plain head)
                        (self._k[b], self._v[b], self._dstate[b], out,
                         _steps, self._pen_counts[b]) = self._fused_pen_fn(
                            params, self._k[b], self._v[b],
                            self._dstate[b], step_mask, step_tokens,
                            self._pen_counts[b], self._pen_fp_dev[b],
                            self._pen_pp_dev[b], steps_run)
                    else:
                        (self._k[b], self._v[b], self._dstate[b], out,
                         _steps) = self._fused_fn(
                            params, self._k[b], self._v[b],
                            self._dstate[b], step_mask, step_tokens,
                            steps_run)
                    # the [3, T, B] token block's copy starts now, so the
                    # resolver finds it in flight
                    out = start_readback(out)
                    for li, _f in w["batch"]:
                        self._pos[off + li] += 1
                except Exception as e:  # noqa: BLE001 - via futures
                    self._tick_budget.release()
                    for _li, f in w["batch"]:
                        f.set_exception(e)
                    self._rebuild_bucket_cache(b)
                    t_asm0 = time.monotonic_ns()
                    continue
                gen_batch = []
                for slot, li in w["gens"]:
                    info = self._auto_slots[slot]
                    adv = advances[slot]
                    self._pos[slot] += adv
                    info["remaining"] -= adv
                    done = (info["remaining"] <= 0
                            or int(self._pos[slot]) >= cap)
                    if done:
                        # the tick already deactivated it on the device
                        self._auto_slots.pop(slot)
                        self._release_gen_slot(slot)
                    gen_batch.append((li, slot, info["sink"], adv, done,
                                      info["gen"]))
                t_done = time.monotonic_ns()
                self._tick_seq += 1
                tick_seq = self._tick_seq
                self._record_tick(b, w, gen_batch, queue_depth, steps_run,
                                  uploads, tick_seq, t_asm0, t_disp0, t_done)
                # resolve on a reader thread: the next dispatch's compute
                # starts at once and the readbacks overlap it (bounded by
                # _tick_budget)
                pool = self._gen_reader if gen_batch else self._readers
                pool.submit(self._resolve_tick, out, w["batch"], gen_batch,
                            self._tick_budget)
                t_asm0 = time.monotonic_ns()

    def _record_tick(self, b, w, gen_batch, queue_depth, steps_run, uploads,
                     tick_seq, t_asm0, t_disp0, t_done) -> None:
        """One dispatch's observability (worker thread): its tick row in
        the device statistics, its join entry on each traced stream, and
        each live slot's equal share of the dispatch window and its tokens
        in the cost ledger.  The window is the host's dispatch window: the
        card may still be running it; the counted FLOPs stay absent."""
        cnt, cap = self._buckets[b]
        off = self._bucket_off[b]
        live = len(w["batch"]) + len(gen_batch)
        ds = self._device_stats
        if ds is not None and ds.enabled:
            ds.record_tick(
                self._model.name, bucket=cap, batch=live, padded=cnt,
                queue_depth=queue_depth, assembly_ns=t_disp0 - t_asm0,
                compute_ns=t_done - t_disp0, requests=len(w["batch"]),
                syncs=1, steps=steps_run, uploads=uploads,
                tick_seq=tick_seq)
        traced = [g for g in gen_batch
                  if getattr(g[2], "trace", None) is not None]
        if traced:
            tick = {"tick_seq": tick_seq, "bucket": cap, "batch": live,
                    "padded": cnt, "steps": steps_run,
                    "requests": len(w["batch"]),
                    "start_ns": t_disp0, "end_ns": t_done}
            for _li, _slot, sink, _adv, _done, _gen in traced:
                sink.trace.add_tick(tick)
        ledger = self._cost_ledger
        if ledger is None or not ledger.enabled or not live:
            return
        share_us = (t_done - t_disp0) / live / 1e3
        if w["batch"]:
            with self._lock:
                tenants = [self._slot_tenant.get(off + li, "")
                           for li, _f in w["batch"]]
            for tenant in tenants:
                ledger.charge(self._model.name, tenant, device_us=share_us,
                              tokens=1)
        for _li, _slot, sink, adv, done, _gen in gen_batch:
            tenant = getattr(sink, "tenant", "")
            ledger.charge(self._model.name, tenant, device_us=share_us,
                          tokens=int(adv))
            sink.cost_device_us += share_us
            sink.cost_tokens += int(adv)
            if done:
                # stamped before the resolver can emit the stream record
                cost = {"tenant": tenant,
                        "device_us": round(sink.cost_device_us, 1),
                        "tokens": sink.cost_tokens}
                st = getattr(sink, "trace", None)
                if st is not None:
                    st.cost = cost
                    if st.flight is not None:
                        st.flight.cost = cost

    @staticmethod
    def _close_decode_span(sink) -> None:
        """Close a traced generation's DECODE stage exactly once (the
        last-token resolver and the worker's cancel path can race)."""
        st = getattr(sink, "trace", None)
        lock = getattr(sink, "span_lock", None)
        if st is None or lock is None:
            return
        with lock:
            t0 = getattr(sink, "t_decode0", None)
            sink.t_decode0 = None
        if t0 is not None:
            st.add_span("DECODE", t0, time.monotonic_ns())

    @staticmethod
    def _resolve_prefill(pair, fut):
        try:
            vals = finish_readback(pair)
            fut.set_result((int(vals[0]), float(vals[1])))
        except Exception as e:  # noqa: BLE001 - surfaced via future
            fut.set_exception(e)

    def _resolve_gen_token(self, pair, sink, done, slot, gen):
        try:
            vals = finish_readback(pair)
            sink.put((int(vals[0]), float(vals[1])))
            if done:
                # span before sentinel: the envelope emits the record the
                # moment it sees the end
                self._close_decode_span(sink)
                sink.put(None)
        except Exception as e:  # noqa: BLE001 - surfaced via sink
            sink.failed = True
            sink.put(e)
            with self._lock:
                self._dead_gens.add((slot, gen))

    def _resolve_tick(self, out, batch, gen_batch=(), budget=None):
        """Resolve one fused dispatch's ``[3, T, B]`` token block: each
        client step from its step-0 row, each generation's ``n_emit`` rows
        in order.  ``li`` is bucket-local, ``slot`` global."""
        try:
            vals = finish_readback(out)
        except Exception as e:  # noqa: BLE001 - surfaced via futures/sinks
            if budget is not None:
                budget.release()
            for _li, f in batch:
                f.set_exception(e)
            for _li, slot, sink, _n_emit, _done, gen in gen_batch:
                sink.failed = True
                sink.put(e)
                with self._lock:
                    self._dead_gens.add((slot, gen))
            return
        if budget is not None:
            budget.release()
        for li, f in batch:
            f.set_result((int(vals[0, 0, li]), float(vals[1, 0, li])))
        for li, _slot, sink, n_emit, done, _gen in gen_batch:
            for t in range(n_emit):
                sink.put((int(vals[0, t, li]), float(vals[2, t, li])))
            if done:
                self._close_decode_span(sink)
                sink.put(None)

    def _new_cache_arrays(self, cnt: int, cap: int, cfg):
        """A fresh zeroed k/v cache pair of one bucket,
        ``[L, cnt, H, cap, K]`` in the compute dtype."""
        shape = (cfg.n_layers, cnt, cfg.n_heads, cap, cfg.head_dim)
        return (torch.zeros(shape, dtype=cfg.dtype, device=self._device),
                torch.zeros(shape, dtype=cfg.dtype, device=self._device))

    def _rebuild_bucket_cache(self, b: int) -> None:
        """Worker-side, after a failed dispatch or prefill: the cache may
        hold a partial write, so rebuild the bucket zeroed and invalidate
        every slot in it.  Queued sequence jobs then fail stale; the
        bucket's live generations fail with a 500 (the reference recovers
        them by re-prefilling, ROADMAP A7b)."""
        from ..server.types import InferError

        cnt, cap = self._buckets[b]
        off = self._bucket_off[b]
        err = InferError(
            f"model '{self._model.name}': decode cache was rebuilt after a "
            "device error; generation aborted", 500)
        for slot in range(off, off + cnt):
            info = self._auto_slots.pop(slot, None)
            if info is not None:
                info["sink"].failed = True
                self._gen_reader.submit(info["sink"].put, err)
        with self._lock:
            # one atomic section: a live sequence whose mapping survived
            # would pass the worker's stale check and decode against the
            # zeroed cache
            for key in [k for k, s in self._state.items()
                        if isinstance(s, int) and off <= s < off + cnt]:
                self._release_entry_locked(key)
            for slot in range(off, off + cnt):
                self._free.add(slot)
                self._slot_gen[slot] += 1
                self._clear_pen_locked(slot)
                self._slot_tenant.pop(slot, None)
        try:
            _params, cfg = self._params
            self._pen_counts[b] = None
            self._k[b], self._v[b] = self._new_cache_arrays(cnt, cap, cfg)
            self._dstate[b] = _new_decode_state(cnt, self._device)
            self._pen_fp_dev[b] = torch.zeros(cnt, dtype=torch.float32,
                                              device=self._device)
            self._pen_pp_dev[b] = torch.zeros(cnt, dtype=torch.float32,
                                              device=self._device)
        except Exception:  # noqa: BLE001 - the device cannot hold a cache
            # fail pending work (503 through the drain) instead of letting
            # the worker die with futures left hanging
            with self._lock:
                self._closed = True
            self._gen_reader.submit(self._jobs.put, None)

    def _ensure_pen_bucket(self, b: int) -> None:
        """Allocate a bucket's ``[cnt, V]`` count matrix at its first
        penalized admission."""
        if self._pen_counts[b] is None:
            _, cfg = self._params
            cnt = self._buckets[b][0]
            self._pen_counts[b] = torch.zeros(
                (cnt, cfg.vocab_size), dtype=torch.int32,
                device=self._device)

    def _clear_pen_locked(self, slot) -> None:
        """Under self._lock: forget a slot's penalty state on release (its
        count row is reseeded before the next penalized use)."""
        if self._fns is None:
            return
        self._slot_pen_seed.pop(slot, None)
        b, li = self._slot_bucket(slot)
        if self._pen_fp[b][li] != 0.0 or self._pen_pp[b][li] != 0.0:
            self._pen_fp[b][li] = 0.0
            self._pen_pp[b][li] = 0.0
            self._pen_n[b] -= 1

    def _deactivate_slot(self, slot):
        """Stop a slot's self-feed on the device (cancellation, reaping)."""
        b, li = self._slot_bucket(slot)
        _state_deactivate(self._dstate[b], li)

    def _release_gen_slot(self, slot):
        """Return a generation slot to the pool; the generation bump
        invalidates any stale job."""
        b, li = self._slot_bucket(slot)
        with self._lock:
            had_pen = (self._pen_fp[b][li] != 0.0
                       or self._pen_pp[b][li] != 0.0)
            self._free.add(slot)
            self._slot_gen[slot] += 1
            self._clear_pen_locked(slot)
            self._slot_tenant.pop(slot, None)
        if had_pen:
            # a later unpenalized occupant must not inherit the penalties
            # while the bucket still runs the penalized tick
            self._pen_fp_dev[b][li] = 0.0
            self._pen_pp_dev[b][li] = 0.0

    def submit_generation(self, window, n_tokens: int,
                          freq_pen: float = 0.0, pres_pen: float = 0.0,
                          prompt_len: int = None, tenant: str = ""):
        """Queue a server-side greedy generation (batched mode): the prompt
        prefills into a free slot and the slot self-feeds, every active
        generation sharing one batched dispatch per tick.  Returns a queue
        yielding (token id, logprob) pairs, then None (or an Exception).
        ``freq_pen`` / ``pres_pen``: penalties honoured inside the tick
        (a count row per slot, seeded from the real prompt)."""
        from ..server.trace import current_trace
        from ..server.types import InferError

        st = current_trace()
        t_submit = time.monotonic_ns()
        self._ensure_fns()
        if self._closed:
            raise InferError(
                f"model '{self._model.name}' is unloading", 503)
        need_s = int(window.shape[1]) + int(n_tokens)
        use_pen = freq_pen != 0.0 or pres_pen != 0.0
        with self._lock:
            slot = self._alloc_slot_locked(need_s)
            if slot is None:
                self._evict_idle_locked(time.monotonic())
                slot = self._alloc_slot_locked(need_s)
            if slot is None:
                raise InferError(
                    f"model '{self._model.name}': no free decode slot "
                    f"holds {need_s} tokens ({self._n_slots} total); retry "
                    "when a generation or sequence completes", 429)
            gen = self._slot_gen[slot]
            self._slot_tenant[slot] = tenant
            if use_pen:
                # the real prompt's counts, not the window's padding
                if prompt_len is None:
                    raise InferError(
                        "penalized generation requires prompt_len (the "
                        "count seed cannot be recovered from the padded "
                        "window)")
                _, cfg = self._params
                real = (window[0, window.shape[1] - prompt_len:]
                        if prompt_len else np.zeros(0, np.int32))
                row = np.bincount(
                    real, minlength=cfg.vocab_size).astype(np.int32)
                self._slot_pen_seed[slot] = (
                    float(freq_pen), float(pres_pen), row)
        sink: "_queue.Queue" = _queue.Queue()
        # lifecycle spans ride the sink: only stream contexts (add_tick)
        sink.trace = st if hasattr(st, "add_tick") else None
        sink.t_submit = t_submit
        sink.t_prefill0 = None
        sink.t_decode0 = None
        sink.span_lock = threading.Lock()
        sink.tenant = tenant
        sink.cost_device_us = 0.0
        sink.cost_tokens = 0
        sink.failed = False
        self._jobs.put(("prefill",
                        (slot, gen, window, ("gen", n_tokens, sink)), None))
        return sink

    def _submit(self, kind, payload):
        import concurrent.futures

        from ..server.types import InferError

        if self._closed:
            raise InferError(
                f"model '{self._model.name}' is unloading", 503)
        fut = concurrent.futures.Future()
        if kind == "prefill":
            payload = payload + (("fut", fut),)
        self._jobs.put((kind, payload, fut))
        return fut

    # -- request path ------------------------------------------------------
    def _execute(self, inputs, parameters):
        if self._mode == "independent":
            return self._execute_independent(inputs, parameters)
        return self._execute_batched(inputs, parameters)

    def _check_id(self, parameters):
        from ..server.types import InferError

        seq_id = parameters.get("sequence_id", 0)
        if not seq_id:
            raise InferError(
                f"inference request to model '{self._model.name}' must "
                "specify a non-zero or non-empty correlation ID")
        return (seq_id, bool(parameters.get("sequence_start", False)),
                bool(parameters.get("sequence_end", False)))

    def _execute_independent(self, inputs, parameters):
        """Per-sequence caches; prefill or step, and its readback, on the
        request's thread."""
        from ..server.types import InferError

        seq_id, start, end = self._check_id(parameters)
        prefill, step, params, cfg = self._ensure_fns_independent()
        toks = _host_tokens(inputs["TOKENS"]).reshape(1, -1).astype(np.int32)
        toks = np.clip(toks, 0, cfg.vocab_size - 1)
        with self._lock:
            self._evict_idle_locked(time.monotonic())
            seq_lock = self._seq_locks.setdefault(seq_id, threading.Lock())
        with seq_lock:
            with self._lock:
                entry = self._state.get(seq_id)

            def drop():
                with self._lock:
                    self._release_locked(seq_id)

            if start or entry is None:
                if toks.shape[1] != self._prompt_len:
                    drop()
                    raise InferError(
                        f"model '{self._model.name}': sequence_start "
                        f"expects a [1,{self._prompt_len}] prompt, got "
                        f"{list(toks.shape)}")
                with self._enqueue_lock:
                    logits, cache = prefill(params,
                                            _upload(toks, self._device))
                    pair = _next_pair(logits)
                host_pos = toks.shape[1]
            else:
                cache, host_pos = entry
                if host_pos >= self._s_max:
                    # free the cache on the failure path too: the
                    # client was told to send sequence_end
                    if end:
                        drop()
                    raise InferError(
                        f"model '{self._model.name}': sequence exceeded "
                        f"the {self._s_max}-token cache; send "
                        "sequence_end")
                if toks.shape[1] != 1:
                    raise InferError(
                        f"model '{self._model.name}': decode steps "
                        f"expect TOKENS [1,1], got {list(toks.shape)}")
                with self._enqueue_lock:
                    logits, cache = step(params, cache,
                                         _upload(toks, self._device))
                    pair = _next_pair(logits)
                host_pos += 1
            vals = finish_readback(pair)
            nxt, best = int(vals[0]), float(vals[1])
            with self._lock:
                if end:
                    self._release_locked(seq_id)
                else:
                    self._state[seq_id] = (cache, host_pos)
                    self._touched[seq_id] = time.monotonic()
        return {"NEXT_TOKEN": np.array([nxt], np.int32),
                "NEXT_LOGIT": np.array([best], np.float32)}

    def _execute_batched(self, inputs, parameters):
        from ..server.types import InferError

        seq_id, start, end = self._check_id(parameters)
        _prefill, _params, cfg = self._ensure_fns()
        toks = _host_tokens(inputs["TOKENS"]).reshape(1, -1).astype(np.int32)
        toks = np.clip(toks, 0, cfg.vocab_size - 1)
        with self._lock:
            self._evict_idle_locked(time.monotonic())
            # steps of one correlation id serialize; others overlap
            seq_lock = self._seq_locks.setdefault(seq_id, threading.Lock())
        with seq_lock:
            # slot and generation read in one locked section, so a rebuild
            # in between makes the submitted gen stale
            with self._lock:
                slot = self._state.get(seq_id)
                gen = self._slot_gen[slot] if slot is not None else None
            if start or slot is None:
                if toks.shape[1] != self._prompt_len:
                    with self._lock:
                        self._release_locked(seq_id)
                    raise InferError(
                        f"model '{self._model.name}': sequence_start "
                        f"expects a [1,{self._prompt_len}] prompt, got "
                        f"{list(toks.shape)}")
                with self._lock:
                    slot = self._state.get(seq_id)
                    if slot is None:
                        # open-ended length: the largest slab
                        need = self._prompt_len + 1
                        slot = self._alloc_slot_locked(need,
                                                       prefer_large=True)
                        if slot is None:
                            self._evict_idle_locked(time.monotonic())
                            slot = self._alloc_slot_locked(
                                need, prefer_large=True)
                        if slot is None:
                            self._seq_locks.pop(seq_id, None)
                            raise InferError(
                                f"model '{self._model.name}': all "
                                f"{self._n_slots} decode slots are busy; "
                                "end or abandon a sequence first", 429)
                        self._state[seq_id] = slot
                        self._slot_tenant[slot] = \
                            parameters.get("_cost_tenant") or ""
                    gen = self._slot_gen[slot]
                fut = self._submit("prefill", (slot, gen, toks))
            else:
                # this slot's previous step completed before its future
                # resolved (per-sequence lock): the worker's mirror is
                # stable here
                cap = self._slot_cap(slot)
                if int(self._pos[slot]) >= cap:
                    if end:
                        with self._lock:
                            self._release_locked(seq_id)
                    raise InferError(
                        f"model '{self._model.name}': sequence exceeded "
                        f"the {cap}-token cache; send sequence_end")
                if toks.shape[1] != 1:
                    raise InferError(
                        f"model '{self._model.name}': decode steps expect "
                        f"TOKENS [1,1], got {list(toks.shape)}")
                fut = self._submit("step", (slot, gen, int(toks[0, 0])))
            nxt, best = fut.result(timeout=3600)
            with self._lock:
                if end:
                    self._release_locked(seq_id)
                else:
                    self._touched[seq_id] = time.monotonic()
        return {"NEXT_TOKEN": np.array([nxt], np.int32),
                "NEXT_LOGIT": np.array([best], np.float32)}


# ---------------------------------------------------------------------------
# llama_generate
# ---------------------------------------------------------------------------

def _logprob(logits, tok):
    """log-probability of ``tok [B]`` under the raw-logit softmax."""
    l32 = logits.float()
    chosen = torch.gather(l32, -1, tok[:, None].long())[:, 0]
    return chosen - torch.logsumexp(l32, dim=-1)


def _penalize(logits, counts, fp: float, pp: float):
    """``fp * count + pp * (count > 0)`` subtracted per token."""
    c = counts.float()
    return logits.float() - fp * c - pp * (c > 0).float()


def _sample(logits, gen: torch.Generator, temperature: float, top_k: int,
            top_p: float):
    """Temperature, optional top-k and nucleus (top-p) truncation, then a
    categorical draw as the reference's ``jax.random.categorical`` makes
    it: the argmax of the scaled logits plus Gumbel noise, drawn from
    ``gen`` (a ``torch.Generator``, so not JAX's stream)."""
    l32 = logits.float()
    top_vals = None
    if top_k > 0:
        top_vals = torch.topk(l32, top_k, dim=-1).values
        l32 = torch.where(l32 >= top_vals[..., -1:], l32, -math.inf)
    inv_t = 1.0 / max(temperature, 1e-6)
    if top_p < 1.0:
        # the smallest descending-probability prefix whose mass reaches
        # top_p (the first token always survives), after the temperature
        desc = (top_vals if top_vals is not None
                else torch.sort(l32, dim=-1, descending=True).values)
        cum = torch.cumsum(torch.softmax(desc * inv_t, dim=-1), dim=-1)
        keep = torch.cat([torch.ones_like(cum[..., :1], dtype=torch.bool),
                          cum[..., :-1] < top_p], dim=-1)
        kept_min = torch.where(keep, desc, math.inf).amin(dim=-1,
                                                          keepdim=True)
        l32 = torch.where(l32 >= kept_min, l32, -math.inf)
    u = torch.rand(l32.shape, generator=gen, device=l32.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return torch.argmax(l32 * inv_t + gumbel, dim=-1).to(torch.int32)


def _frame(tok: int, lp: float):
    """One streamed response: ``text_output`` is chr(token mod 256) as
    UTF-8 (the byte detokenizer), ``token_id`` the exact id."""
    return {"text_output": np.array([chr(tok % 256).encode("utf-8")],
                                    dtype=object),
            "token_id": np.array([tok], np.int32),
            "logprob": np.array([lp], np.float32)}


class GenerateModel:
    """``llama_generate``: decoupled server-side text generation.

    ``text_input`` BYTES [1] in, one ``text_output`` chunk per generated
    token out, over ``POST .../generate_stream`` (SSE) or a gRPC stream;
    ``max_tokens``, ``temperature``, ``top_k``, ``top_p``,
    ``frequency_penalty``, ``presence_penalty`` and ``seed`` arrive as
    request parameters.  Shares its weights and functions with the
    ``DecodeModel`` it is given.  Greedy requests of a batched decode model
    join its worker's tick; the rest run the per-request chain."""

    def __init__(self, decode: DecodeModel, name: str = "llama_generate",
                 default_tokens: int = 16):
        from ..server.model import Model, make_config

        self._decode = decode
        self._default_tokens = default_tokens
        cfg = make_config(
            name,
            inputs=[("text_input", "BYTES", [1])],
            outputs=[("text_output", "BYTES", [1]),
                     ("token_id", "INT32", [1]),
                     ("logprob", "FP32", [1])],
            decoupled=True,
            instance_kind=instance_kind(decode._device),
            parameters={"prompt_tokens": str(decode._prompt_len)},
        )
        outer = self

        class _Impl(Model):  # noqa: N801 - adapter onto the abstract Model
            def execute(inner, inputs, parameters):
                from ..server.types import InferError

                raise InferError(
                    f"model '{inner.name}' is decoupled: use "
                    "generate_stream or a gRPC stream")

            def execute_decoupled(inner, inputs, parameters):
                return outer._generate(inputs, parameters)

            def attach_device_stats(inner, ds):
                # generation ticks happen in the shared decode worker
                outer._decode.attach_device_stats(ds)

            def attach_cost_ledger(inner, ledger):
                outer._decode.attach_cost_ledger(ledger)

        self.model = _Impl(cfg)

    def _generate_batched(self, window, n_tokens, freq_pen=0.0,
                          pres_pen=0.0, prompt_len=None, parameters=None):
        from ..server.types import InferError

        tenant = ""
        if parameters is not None:
            tenant = parameters.get("_cost_tenant") or ""
        sink = self._decode.submit_generation(
            window, n_tokens, freq_pen=freq_pen, pres_pen=pres_pen,
            prompt_len=prompt_len, tenant=tenant)
        try:
            while True:
                item = sink.get(timeout=3600)
                if item is None:
                    # cost backchannel: the worker wrote the accumulators
                    # before it let the end through
                    if parameters is not None and sink.cost_device_us:
                        parameters["_cost_device_us"] = round(
                            sink.cost_device_us, 1)
                    return
                if isinstance(item, Exception):
                    if isinstance(item, InferError):
                        raise item
                    raise InferError(f"generation failed: {item}", 500)
                yield _frame(*item)
        except GeneratorExit:
            # the consumer closed mid-stream: the worker frees the slot
            # instead of ticking an unread generation to its end
            sink.cancelled = True
            raise

    def _generate(self, inputs, parameters):
        from ..server.types import InferError

        dec = self._decode
        _params, cfg = dec._ensure_params()
        raw = np.asarray(inputs["text_input"]).reshape(-1)
        prompt = raw[0] if len(raw) else b""
        if isinstance(prompt, str):
            prompt = prompt.encode()
        try:
            n_tokens = int(parameters.get("max_tokens", self._default_tokens))
            temperature = float(parameters.get("temperature", 0.0))
            top_k = int(parameters.get("top_k", 0))
            top_p = float(parameters.get("top_p", 1.0))
            freq_pen = float(parameters.get("frequency_penalty", 0.0))
            pres_pen = float(parameters.get("presence_penalty", 0.0))
            seed = parameters.get("seed")
            seed = None if seed is None else int(seed)
        except (TypeError, ValueError) as e:
            raise InferError(f"invalid sampling parameter: {e}")
        n_tokens = max(1, min(n_tokens, dec._s_max - dec._prompt_len))
        if not (temperature >= 0 and math.isfinite(temperature)):
            raise InferError(
                f"temperature must be finite and >= 0, got {temperature}")
        if top_k < 0 or top_k > cfg.vocab_size:
            raise InferError(
                f"top_k must be in [0, {cfg.vocab_size}], got {top_k}")
        if not (0.0 < top_p <= 1.0):
            raise InferError(f"top_p must be in (0, 1], got {top_p}")
        for name, v in (("frequency_penalty", freq_pen),
                        ("presence_penalty", pres_pen)):
            if not (-2.0 <= v <= 2.0):
                raise InferError(
                    f"{name} must be in [-2, 2], got {v}")
        if seed is None:
            # unseeded sampling varies across requests
            seed = int.from_bytes(os.urandom(4), "little")

        window = np.zeros((1, dec._prompt_len), np.int32)
        b = np.frombuffer(bytes(prompt[-dec._prompt_len:]), np.uint8)
        if b.size:
            window[0, dec._prompt_len - b.size:] = b
        window = np.clip(window, 0, cfg.vocab_size - 1)

        if dec._mode == "batched" and temperature == 0:
            # greedy generations share the worker's tick; sampled ones keep
            # the chain below (their random state is per request)
            yield from self._generate_batched(
                window, n_tokens, freq_pen=freq_pen, pres_pen=pres_pen,
                prompt_len=int(b.size), parameters=parameters)
            return
        yield from self._chain(window, int(b.size), n_tokens, temperature,
                               top_k, top_p, freq_pen, pres_pen, seed)

    def _chain(self, window, n_prompt, n_tokens, temperature, top_k, top_p,
               freq_pen, pres_pen, seed):
        """The per-request chain: every step queued with the chosen token
        fed back on the device, each token's readback started behind its
        step and yielded once it has landed (tokens come out in order while
        later steps run)."""
        dec = self._decode
        prefill, step, params, cfg = dec._ensure_fns_independent()
        dev = dec._device
        use_pen = freq_pen != 0.0 or pres_pen != 0.0
        if temperature > 0:
            gen = torch.Generator(dev).manual_seed(seed)

            def choose(logits):
                return _sample(logits, gen, temperature, top_k, top_p)
        else:
            def choose(logits):
                return torch.argmax(logits, dim=-1).to(torch.int32)

        with dec._enqueue_lock:
            if use_pen:
                # counts of the real prompt bytes, not the window's padding
                counts = _upload(np.bincount(
                    window[0, dec._prompt_len - n_prompt:] if n_prompt
                    else np.zeros(0, np.int32),
                    minlength=cfg.vocab_size).astype(np.int32)
                    .reshape(1, -1), dev)
                ones = torch.ones(1, dtype=torch.int32, device=dev)
            logits, cache = prefill(params, _upload(window, dev))
        pending = collections.deque()
        for i in range(n_tokens):
            with dec._enqueue_lock:
                cur = (_penalize(logits, counts, freq_pen, pres_pen)
                       if use_pen else logits)
                tok = choose(cur)                 # [1], on the device
                if use_pen:
                    counts = counts.index_put(
                        (torch.zeros(1, dtype=torch.long, device=dev),
                         tok.long()), ones, accumulate=True)
                # the logprob against the raw logits, in the token's
                # readback
                pending.append(start_readback(torch.stack(
                    [tok.float(), _logprob(logits, tok)])))
                if i < n_tokens - 1:
                    logits, cache = step(params, cache, tok.reshape(1, 1))
            while pending and readback_ready(pending[0]):
                vals = finish_readback(pending.popleft())
                yield _frame(int(vals[0, 0]), float(vals[1, 0]))
        while pending:
            vals = finish_readback(pending.popleft())
            yield _frame(int(vals[0, 0]), float(vals[1, 0]))


def make_llama_generate(decode: DecodeModel):
    """``llama_generate`` over ``decode``'s weights and worker."""
    return GenerateModel(decode).model
