"""Training checkpoints of the transformer's sharded state.

Counterpart of ``triton_client_tpu/utils/checkpoint.py``, with its
contract: :func:`save` persists parameters, optimizer state and the step
and returns once the write is durable; a step that is not newer than the
latest raises ``ValueError`` (a skipped write must never pass for a
durable one); :func:`restore` with nothing recorded raises
``FileNotFoundError``; the manager keeps the newest ``max_to_keep`` steps;
restored tensors land on the devices and shards of the ``*_like`` state.

The reference writes with orbax, which the card's machine lacks, so the
format is the port's own.  A step is a directory ``<step>/`` holding one
``rank_<r>.pt`` per rank (``torch.save`` of that rank's shards, read back
with ``weights_only=True``) and ``manifest.json`` (the step, the mesh
shape, each leaf's name, shard shape and dtype).  Every rank writes into
``.tmp-<step>/``; after a barrier rank 0 writes the manifest and renames
the directory into place, so a step directory exists only once every
rank's shards are on disk.  A restore refuses a mesh of another shape.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

_MANIFEST = "manifest.json"


class CheckpointManager:
    """The checkpoints of one training run under ``directory``, for this
    rank of ``mesh`` (None: one process)."""

    def __init__(self, directory: str, max_to_keep: int = 3, mesh=None):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        self.mesh = mesh
        os.makedirs(self.directory, exist_ok=True)

    @property
    def rank(self) -> int:
        return self.mesh.rank if self.mesh is not None else 0

    def mesh_shape(self) -> Dict[str, int]:
        """The mesh's axes of size > 1 (a one-process mesh has none)."""
        if self.mesh is None:
            return {}
        return {a: n for a, n in self.mesh.shape.items() if n > 1}

    def barrier(self) -> None:
        if self.mesh is not None and self.mesh.size > 1:
            dist.barrier()

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def all_steps(self) -> List[int]:
        """Recorded steps, oldest first."""
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.isfile(
                    os.path.join(self.directory, name, _MANIFEST)):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None


def make_manager(directory: str, max_to_keep: int = 3,
                 mesh=None) -> CheckpointManager:
    """A manager over ``directory`` that keeps the newest ``max_to_keep``
    steps; ``mesh`` is this rank's mesh (every rank makes one)."""
    return CheckpointManager(directory, max_to_keep, mesh)


def latest_step(manager: CheckpointManager) -> Optional[int]:
    return manager.latest_step()


def all_steps(manager: CheckpointManager) -> List[int]:
    return manager.all_steps()


def _leaves(state: Dict[str, Any], prefix: str = ""):
    for k, v in state.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _durable_write(path: str, write) -> None:
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


def save(manager: CheckpointManager, step: int, params: Dict[str, Any],
         opt: Dict[str, Any]) -> None:
    """Persist this rank's shards of one training state; every rank of the
    mesh calls it.  Returns once every rank's write is on disk and the step
    is recorded."""
    step = int(step)
    latest = manager.latest_step()
    if latest is not None and step <= latest:
        raise ValueError(
            f"checkpoint step {step} is not newer than the latest recorded "
            f"step {latest}; nothing was written")
    tmp = os.path.join(manager.directory, f".tmp-{step}")
    if manager.rank == 0:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    manager.barrier()
    state = {"params": params, "opt": opt}
    # a copy each: a view would carry its whole storage into the file
    host = {name: t.detach().to("cpu", copy=True)
            for name, t in _leaves(state)}
    _durable_write(os.path.join(tmp, f"rank_{manager.rank}.pt"),
                   lambda f: torch.save(host, f))
    manager.barrier()
    if manager.rank == 0:
        manifest = {
            "step": step,
            "mesh": manager.mesh_shape(),
            "ranks": manager.mesh.size if manager.mesh is not None else 1,
            "leaves": {name: {"shape": list(t.shape),
                              "dtype": str(t.dtype).replace("torch.", "")}
                       for name, t in host.items()},
        }
        _durable_write(os.path.join(tmp, _MANIFEST),
                       lambda f: f.write(json.dumps(manifest, indent=1)
                                         .encode()))
        os.rename(tmp, manager.step_dir(step))
        fd = os.open(manager.directory, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        for old in manager.all_steps()[:-manager.max_to_keep]:
            shutil.rmtree(manager.step_dir(old))
    manager.barrier()


def _restore_tree(like: Dict[str, Any], host: Dict[str, torch.Tensor],
                  prefix: str) -> Dict[str, Any]:
    out = {}
    for k, v in like.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out[k] = _restore_tree(v, host, f"{name}/")
            continue
        if name not in host:
            raise ValueError(f"checkpoint has no leaf {name!r}")
        t = host[name]
        if tuple(t.shape) != tuple(v.shape) or t.dtype != v.dtype:
            raise ValueError(
                f"checkpoint leaf {name!r} is {tuple(t.shape)} {t.dtype}, "
                f"the state to restore onto {tuple(v.shape)} {v.dtype}")
        out[k] = t.to(v.device)
    return out


def restore(manager: CheckpointManager, params_like: Dict[str, Any],
            opt_like: Dict[str, Any], step: Optional[int] = None):
    """``(params, opt, step)`` of ``step`` (default: the latest), this
    rank's shards on the devices of ``params_like`` / ``opt_like``, which
    give the names, shard shapes and dtypes to expect."""
    if step is None:
        step = manager.latest_step()
    if step is None:
        raise FileNotFoundError("no checkpoint recorded in this directory")
    path = manager.step_dir(step)
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    if manifest["mesh"] != manager.mesh_shape():
        raise ValueError(
            f"checkpoint step {step} was saved on mesh {manifest['mesh']}, "
            f"this mesh is {manager.mesh_shape()}")
    host = torch.load(os.path.join(path, f"rank_{manager.rank}.pt"),
                      map_location="cpu", weights_only=True)
    params = _restore_tree(params_like, host, "params/")
    opt = _restore_tree(opt_like, host, "opt/")
    return params, opt, int(step)
