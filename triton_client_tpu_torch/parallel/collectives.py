"""Attention collectives, single-device form.

Counterpart of ``triton_client_tpu/parallel/collectives.py``.  Only the
``sp = 1`` form of :func:`ring_attention` is ported: with one sequence shard
the ring has one step and no communication, so it is plain attention with
f32 scores, the -1e30 causal mask, and the online-softmax normalisation
``o / max(l, 1e-30)``.  It is the transformer's attention below the flash
gate.  Multi-device rings wait for the multi-device slice.
"""

from __future__ import annotations

import math

import torch


def ring_attention(q, k, v, causal: bool = True):
    """Attention over ``[B, H, S, K]`` with the reference ring's math at
    ``sp = 1``; returns ``q.dtype``."""
    S, Kd = q.shape[2], q.shape[3]
    scale = 1.0 / math.sqrt(Kd)
    s = torch.einsum("bhqk,bhsk->bhqs", q.float(), k.float()) * scale
    if causal:
        pos = torch.arange(S, device=q.device)
        mask = pos[:, None] >= pos[None, :]
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    m = torch.clamp_min(s.amax(dim=-1), -1e30)
    p = torch.exp(s - m[..., None])
    if causal:
        p = p * mask
    l = p.sum(dim=-1)
    o = torch.einsum("bhqs,bhsk->bhqk", p, v.float())
    return (o / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)
