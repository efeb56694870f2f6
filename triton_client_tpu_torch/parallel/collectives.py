"""Collectives over a process mesh, and ring attention.

Counterpart of ``triton_client_tpu/parallel/collectives.py``.  The
reference runs inside ``jax.shard_map``, where every array is a local
shard and ``psum`` / ``ppermute`` name mesh axes; here each rank is a
process holding its shards, and the same collectives run over the
:class:`~.mesh.Mesh`'s per-axis process groups:

- :func:`psum` sums over axes and is differentiable; its backward is a
  psum too, as JAX transposes ``psum`` under ``check_vma=False`` (which is
  why the train step divides gradients by ``tp * ep``).
- :func:`ppermute` rotates a tensor round one axis's ring; its backward
  sends the gradient the other way round.
- :func:`ring_attention` is attention with f32 scores, the -1e30 causal
  mask by global position and the online (m, l, o) carry.  At ``sp = 1``
  (no mesh, or an ``sp`` axis of one) it is one step with no
  communication: the transformer's attention below the flash gate.  At
  ``sp > 1`` K/V circulate the ``sp`` ring.
- :func:`replicated_axes` and :func:`sync_replicated_grads`: a gradient
  leaf is summed over exactly the axes its parameter is replicated on.

Partition specs are tuples with one entry per dim: an axis name, a tuple
of names, or None.  Under gloo, CUDA tensors are copied through host
memory for every collective (``Mesh.host_staging``): gloo moves host
tensors.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from .mesh import Mesh

Axes = Union[str, Iterable[str]]


def _live_axes(mesh: Mesh, axes: Axes) -> Tuple[str, ...]:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(a for a in axes if mesh.shape[a] > 1)


def _to_wire(x, mesh: Mesh):
    """A contiguous copy of ``x`` to send and reduce in place (on the host
    where the mesh stages): the process groups take dense tensors only."""
    x = x.contiguous()
    return x.to("cpu", copy=True) if mesh.host_staging else x.clone()


def _from_wire(x, like):
    return x.to(like.device) if x.device != like.device else x


def all_reduce(x, mesh: Mesh, axes: Axes):
    """The sum of ``x`` over ``axes`` (no gradient), as a new tensor; ``x``
    itself where every axis has size 1."""
    axes = _live_axes(mesh, axes)
    if not axes:
        return x
    buf = _to_wire(x, mesh)
    for ax in axes:
        dist.all_reduce(buf, group=mesh.groups[ax])
    return _from_wire(buf, x)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axes), None, None


def psum(x, mesh: Mesh, axes: Axes):
    """Differentiable sum over mesh ``axes``; the backward is a psum of the
    gradient (JAX's transposition under ``check_vma=False``)."""
    axes = _live_axes(mesh, axes)
    if not axes:
        return x
    return _PSum.apply(x, mesh, axes)


def _shift(x, mesh: Mesh, axis: str, shift: int):
    n = mesh.shape[axis]
    i = mesh.coords[axis]
    ring = mesh.ring[axis]
    dst, src = ring[(i + shift) % n], ring[(i - shift) % n]
    send = x.contiguous()
    if mesh.host_staging:
        send = send.to("cpu")
    recv = torch.empty_like(send)
    group = mesh.groups[axis]
    for work in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, dst, group),
            dist.P2POp(dist.irecv, recv, src, group)]):
        work.wait()
    return _from_wire(recv, x)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return _shift(x, mesh, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.mesh, ctx.axis, -ctx.shift), None, None, None


def ppermute(x, mesh: Mesh, axis: str, shift: int = 1):
    """Rotate ``x`` round ``axis``'s ring: the rank at index i sends to i +
    ``shift`` and receives from i - ``shift``.  Differentiable: the
    gradient goes the other way round."""
    if mesh.shape[axis] == 1 or shift % mesh.shape[axis] == 0:
        return x
    return _PPermute.apply(x, mesh, axis, shift)


def all_gather(x, mesh: Mesh, axis: str, dim: int):
    """The shards of ``x`` along ``axis``, concatenated on ``dim`` in ring
    order (no gradient)."""
    n = mesh.shape[axis]
    if n == 1:
        return x
    send = _to_wire(x, mesh)
    parts = [torch.empty_like(send) for _ in range(n)]
    # a group's ranks are sorted, so group rank = index on the axis
    dist.all_gather(parts, send, group=mesh.groups[axis])
    return _from_wire(torch.cat(parts, dim), x)


def ring_attention(q, k, v, causal: bool = True, *, mesh: Mesh = None,
                   axis_name: str = "sp"):
    """Attention over ``[B, H, S_chunk, K]`` sequence chunks with the
    reference ring's math; returns ``q.dtype``.

    With no mesh, or an axis of size 1, the chunk is the whole sequence.
    Otherwise this rank holds chunk ``mesh.axis_index(axis_name)`` and K/V
    travel the ring: after step r it holds the chunk of the rank r places
    behind.  The reference rotates K/V ``sp`` times, bringing them home
    unused after the last step; here the last rotation is not made."""
    if mesh is None or mesh.shape[axis_name] == 1:
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
    return _ring(q, k, v, mesh, axis_name, causal)


def _ring(q, k, v, mesh: Mesh, axis: str, causal: bool):
    sp = mesh.shape[axis]
    me = mesh.coords[axis]
    B, Hl, Sc, Kd = q.shape
    scale = 1.0 / math.sqrt(Kd)
    pos = torch.arange(Sc, device=q.device)
    qpos = me * Sc + pos
    q32 = q.float()
    m = torch.full((B, Hl, Sc), -1e30, device=q.device)
    l = torch.zeros((B, Hl, Sc), device=q.device)
    o = torch.zeros((B, Hl, Sc, Kd), device=q.device)
    k_c, v_c = k, v
    for r in range(sp):
        src = (me - r) % sp  # original owner of the chunk now held
        s = torch.einsum("bhqk,bhsk->bhqs", q32, k_c.float()) * scale
        if causal:
            mask = qpos[:, None] >= (src * Sc + pos)[None, :]
            s = torch.where(mask, s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        if causal:
            p = p * mask
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(dim=-1)
        o = corr[..., None] * o + torch.einsum("bhqs,bhsk->bhqk", p,
                                                 v_c.float())
        m = m_new
        if r < sp - 1:
            k_c = ppermute(k_c, mesh, axis, 1)
            v_c = ppermute(v_c, mesh, axis, 1)
    return (o / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)


Spec = Tuple[Union[str, Tuple[str, ...], None], ...]


def replicated_axes(spec: Spec, mesh_axes: Sequence[str]) -> Tuple[str, ...]:
    """Mesh axes over which an array with partition ``spec`` is replicated
    (the axes its gradient is summed over)."""
    used = set()
    for entry in spec:
        if entry is None:
            continue
        if isinstance(entry, (tuple, list)):
            used.update(entry)
        else:
            used.add(entry)
    return tuple(a for a in mesh_axes if a not in used)


def sync_replicated_grads(grads: Dict[str, torch.Tensor],
                          specs: Dict[str, Spec],
                          mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Sum each gradient leaf over exactly the axes its parameter is
    replicated on (sharded axes already hold disjoint shards)."""
    return {k: all_reduce(g, mesh, replicated_axes(specs[k],
                                                   mesh.axis_names))
            for k, g in grads.items()}
