"""One rank of a gloo mesh of the port on the CPU, for the mesh tests.

Not a test module: ``launch`` starts ``world`` copies of this file as
subprocesses, one rank each, over a TCP store on a free local port.  The
inputs go in as ``spec.json`` (the task and its settings) and
``inputs.npz``; rank 0 writes ``out.npz`` (and ``out.json`` for checks
that are not arrays).  Each rank prints ``RANK<r>-OK`` at its end.

    python tests/_torch_mesh_worker.py <dir> <rank> <world> <port>

This file imports neither JAX nor the JAX package: the ranks run the port
alone, and the tests compare what they write with the JAX package's
results.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

from triton_client_tpu_torch import parallel  # noqa: E402
from triton_client_tpu_torch.models import transformer as tr  # noqa: E402
from triton_client_tpu_torch.utils import checkpoint as ckpt  # noqa: E402


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(workdir, world: int, spec: dict, arrays: dict,
           timeout: float = 120.0):
    """Run ``world`` ranks on ``spec`` and ``arrays``; (``out.npz`` as a
    dict, ``out.json``).  Raises with every failed rank's stderr; every
    rank is reaped."""
    return wait(start(workdir, world, spec, arrays), timeout)


def start(workdir, world: int, spec: dict, arrays: dict):
    """Start ``world`` ranks; :func:`wait` collects them (the caller may
    work meanwhile)."""
    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "spec.json"), "w") as f:
        json.dump(spec, f)
    np.savez(os.path.join(workdir, "inputs.npz"), **arrays)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="1")
    for var in [v for v in env if v.startswith(("TRITON_TPU_", "JAX_"))]:
        env.pop(var)
    env.update(spec.get("env", {}))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), workdir, str(r),
         str(world), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=_REPO) for r in range(world)]
    return workdir, procs


def wait(started, timeout: float = 120.0):
    """The ranks' results (see :func:`launch`), waiting at most
    ``timeout`` seconds in all; every rank is reaped."""
    workdir, procs = started
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(0.1, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    bad = [f"rank {r} rc {p.returncode}:\n{err[-3000:]}"
           for r, (p, (out, err)) in enumerate(zip(procs, outs))
           if p.returncode != 0 or f"RANK{r}-OK" not in out]
    if bad:
        raise AssertionError("\n".join(bad))
    with np.load(os.path.join(workdir, "out.npz")) as z:
        got = dict(z)
    with open(os.path.join(workdir, "out.json")) as f:
        return got, json.load(f)


# -- the ranks --------------------------------------------------------------

def _cfg(fields):
    return tr.TransformerConfig(**fields, dtype=torch.float32)


def _tree(arrays, prefix):
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


def _np(tree, prefix):
    return {f"{prefix}{k}": v.detach().cpu().numpy() for k, v in tree.items()}


def task_train(spec, arrays, mesh_shape):
    """Per config: the grad fn's gathered grads and loss, one train step's
    gathered params, the mesh forward's logits, and ``steps`` steps'
    losses."""
    mesh = parallel.build_mesh(mesh_shape, tr.MESH_AXES, device="cpu")
    out = {}
    tokens, labels = arrays["tokens"], arrays["labels"]
    for name, fields in spec["cfgs"].items():
        cfg = _cfg(fields)
        params = tr.params_from_jax(_tree(arrays, f"{name}/p/"), cfg)
        opt = tr.opt_from_jax(
            {"mu": _tree(arrays, f"{name}/mu/"),
             "nu": _tree(arrays, f"{name}/nu/"),
             "count": arrays[f"{name}/count"]}, cfg)
        local = tr.shard_params(params, mesh, cfg)
        lopt = tr.shard_opt(opt, mesh, cfg)
        grads, loss = tr.make_grad_fn(mesh, cfg, n_micro=2)(
            local, tokens, labels)
        out.update(_np(tr.gather_params(grads, mesh, cfg), f"{name}/grad/"))
        out[f"{name}/loss"] = loss.numpy()
        step = tr.make_train_step(mesh, cfg, n_micro=2)
        p2, _, loss2 = step(local, lopt, tokens, labels)
        out.update(_np(tr.gather_params(p2, mesh, cfg), f"{name}/step/"))
        out[f"{name}/step_loss"] = loss2.numpy()
        out[f"{name}/logits"] = tr.make_mesh_forward(mesh, cfg)(
            local, tokens).numpy()
        losses = []
        step = tr.make_train_step(mesh, cfg, n_micro=2, lr=3e-3)
        p, o = local, lopt
        for _ in range(spec.get("steps", 0)):
            p, o, loss = step(p, o, tokens, labels)
            losses.append(float(loss))
        out[f"{name}/losses"] = np.asarray(losses, np.float32)
    return mesh, out, {}


class _StagedMesh(parallel.Mesh):
    """A CPU mesh whose collectives take the host-staged path."""

    host_staging = True


def task_collectives(spec, arrays, world):
    """Ring attention at sp = ``world`` (forward and gradients, gathered
    along S), ``psum`` and ``ppermute`` with their backwards, directly and
    host-staged, and the replicated-gradient sync on dp = 2 x tp = 2."""
    mesh = parallel.build_mesh({"sp": world}, ("sp",), device="cpu")
    out = {}
    S = arrays["q"].shape[2]
    Sc = S // world
    me = mesh.axis_index("sp")
    for causal in (True, False):
        chunk = [torch.from_numpy(arrays[n][:, :, me * Sc:(me + 1) * Sc])
                 .clone().requires_grad_() for n in ("q", "k", "v")]
        w = torch.from_numpy(arrays["w"][:, :, me * Sc:(me + 1) * Sc])
        o = parallel.ring_attention(*chunk, causal=causal, mesh=mesh)
        (o * w).sum().backward()
        tag = "causal" if causal else "full"
        out[f"{tag}/out"] = parallel.all_gather(o.detach(), mesh, "sp", 2)
        for n, t in zip("qkv", chunk):
            out[f"{tag}/d{n}"] = parallel.all_gather(t.grad, mesh, "sp", 2)
    # psum forward and backward on the same ring
    x = torch.full((3,), float(me + 1), requires_grad=True)
    total = parallel.psum(x, mesh, "sp")
    (total * (me + 1)).sum().backward()
    out["psum"], out["psum_grad"] = total.detach(), x.grad
    # ppermute by +1 and its gradient, back by -1
    y = torch.full((2,), float(me), requires_grad=True)
    z = parallel.ppermute(y, mesh, "sp", 1)
    (z * (me + 10)).sum().backward()
    out["ppermute"] = parallel.all_gather(z.detach(), mesh, "sp", 0)
    out["ppermute_grad"] = parallel.all_gather(y.grad, mesh, "sp", 0)
    # the host-staged transport (gloo with CUDA tensors) on the CPU: the
    # same collectives through its copies, on inputs and gradients that
    # are not contiguous
    staged = _StagedMesh(**{f.name: getattr(mesh, f.name)
                            for f in dataclasses.fields(mesh)})
    base = torch.arange(12.0).reshape(3, 4) * (me + 1)
    for name, m in (("direct", mesh), ("staged", staged)):
        a = base.clone().requires_grad_()
        b = parallel.ppermute(a.t(), m, "sp", 1)  # a transposed view
        c = parallel.psum(b.t(), m, "sp")
        (c * (me + 2)).sum().backward()
        out[f"{name}/value"] = parallel.all_gather(c.detach(), m, "sp", 0)
        out[f"{name}/grad"] = parallel.all_gather(a.grad.t(), m, "sp", 1)
    info = {}
    if world == 4:
        grid = parallel.build_mesh({"dp": 2, "tp": 2}, ("dp", "tp"),
                                   device="cpu")
        specs = {"w": (None, "tp"), "b": (None,)}
        grads = {"w": torch.ones(2, 2), "b": torch.ones(3)}
        synced = parallel.sync_replicated_grads(grads, specs, grid)
        out["sync/w"], out["sync/b"] = synced["w"], synced["b"]
        info["replicated"] = {k: list(parallel.replicated_axes(
            v, grid.axis_names)) for k, v in specs.items()}
    return mesh, {k: v.numpy() if torch.is_tensor(v) else v
                  for k, v in out.items()}, info


def task_checkpoint(spec, arrays, workdir, mesh_shape):
    """Resume against uninterrupted, restore onto the same shards,
    retention, a refused step, an empty directory and a mesh of another
    shape, all on this mesh."""
    mesh = parallel.build_mesh(mesh_shape, tr.MESH_AXES, device="cpu")
    cfg = _cfg(spec["cfg"])
    params = tr.params_from_jax(_tree(arrays, "p/"), cfg)
    step_fn = tr.make_train_step(mesh, cfg, n_micro=2)
    batches = [(arrays[f"tokens{i}"], arrays[f"labels{i}"])
               for i in range(4)]

    def fresh():
        local = tr.shard_params(params, mesh, cfg)
        return local, tr.adam_init(local)

    out, info = {}, {}
    p, o = fresh()
    straight = []
    for tok, lab in batches:
        p, o, loss = step_fn(p, o, tok, lab)
        straight.append(float(loss))
    out.update(_np(tr.gather_params(p, mesh, cfg), "straight/"))
    out["straight_losses"] = np.asarray(straight)

    root = os.path.join(workdir, "ckpt")
    mgr = ckpt.make_manager(root, mesh=mesh)
    info["empty_latest"] = ckpt.latest_step(mgr)
    try:
        ckpt.restore(mgr, p, o)
        info["empty_restore"] = "restored"
    except FileNotFoundError as e:
        info["empty_restore"] = f"FileNotFoundError: {e}"
    p, o = fresh()
    first = []
    for tok, lab in batches[:2]:
        p, o, loss = step_fn(p, o, tok, lab)
        first.append(float(loss))
    ckpt.save(mgr, 2, p, o)
    try:
        ckpt.save(mgr, 2, p, o)
        info["refused"] = "saved"
    except ValueError as e:
        info["refused"] = f"ValueError: {e}"
    p2, o2 = fresh()
    p2, o2, step = ckpt.restore(mgr, p2, o2)
    info["restored_step"] = step
    info["same_shards"] = all(
        torch.equal(p2[k], p[k]) and p2[k].shape == p[k].shape
        and p2[k].device == p[k].device for k in p) and all(
        torch.equal(o2[m][k], o[m][k]) for m in ("mu", "nu") for k in p) \
        and int(o2["count"]) == int(o["count"]) == 2
    resumed = list(first)
    for tok, lab in batches[2:]:
        p2, o2, loss = step_fn(p2, o2, tok, lab)
        resumed.append(float(loss))
    out.update(_np(tr.gather_params(p2, mesh, cfg), "resumed/"))
    out["resumed_losses"] = np.asarray(resumed)

    keep = ckpt.make_manager(os.path.join(workdir, "keep"), max_to_keep=2,
                             mesh=mesh)
    for s in (1, 2, 3):
        ckpt.save(keep, s, p2, o2)
    info["kept"] = ckpt.all_steps(keep)
    info["latest"] = ckpt.latest_step(keep)

    if mesh.size > 1:
        other = parallel.build_mesh({"dp": mesh.size}, tr.MESH_AXES,
                                    device="cpu")
        try:
            ckpt.restore(ckpt.make_manager(root, mesh=other), p2, o2)
            info["other_mesh"] = "restored"
        except ValueError as e:
            info["other_mesh"] = f"ValueError: {e}"
    return mesh, out, info


def main(argv) -> int:
    workdir, rank, world, port = argv[1], int(argv[2]), int(argv[3]), argv[4]
    with open(os.path.join(workdir, "spec.json")) as f:
        spec = json.load(f)
    with np.load(os.path.join(workdir, "inputs.npz")) as z:
        arrays = dict(z)
    task = spec["task"]
    assert parallel.initialize_multihost(f"127.0.0.1:{port}", world, rank)
    if task == "multihost":
        assert parallel.initialize_multihost()  # idempotent once active
        x = torch.tensor([float(rank + 1)])
        dist.all_reduce(x)
        info = {"backend": dist.get_backend(), "sum": float(x),
                "world": dist.get_world_size()}
        if rank == 0:
            np.savez(os.path.join(workdir, "out.npz"))
            with open(os.path.join(workdir, "out.json"), "w") as f:
                json.dump(info, f)
        dist.barrier()
        dist.destroy_process_group()
        print(f"RANK{rank}-OK", flush=True)
        return 0
    if task == "train":
        mesh, out, info = task_train(spec, arrays, spec["mesh"])
    elif task == "collectives":
        mesh, out, info = task_collectives(spec, arrays, world)
    elif task == "checkpoint":
        mesh, out, info = task_checkpoint(spec, arrays, workdir,
                                          spec["mesh"])
    else:
        raise ValueError(f"unknown task {task!r}")
    info["backend"] = mesh.backend
    info["transport"] = mesh.transport
    if rank == 0:
        np.savez(os.path.join(workdir, "out.npz"), **out)
        with open(os.path.join(workdir, "out.json"), "w") as f:
            json.dump(info, f)
    dist.barrier()
    dist.destroy_process_group()
    print(f"RANK{rank}-OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
