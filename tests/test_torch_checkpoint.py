"""Training checkpoints of the port (``utils/checkpoint.py``), on one
process and on a 4-rank gloo mesh (tp = 2 x sp = 2, ``make_mesh(4, cfg)``)
on the CPU, with the reference's contract (``tests/test_checkpoint.py``):

* four steps straight against two steps, a save, a fresh state restored
  and two more steps: losses rtol 1e-6, parameters rtol 1e-5 / atol 1e-6
  (the reference's bounds; on the CPU they come out equal);
* a restore onto the same shards is bit-equal, on the same device, with
  the Adam state and its count;
* retention keeps the newest ``max_to_keep``; a step not newer than the
  latest raises ``ValueError``; an empty directory raises
  ``FileNotFoundError``; a mesh of another shape is refused;
* the uninterrupted run itself matches the reference's train step on the
  same weights (the port's losses against the JAX package's on one
  device).

The ranks' side runs in ``tests/_torch_mesh_worker.py`` (``task_checkpoint``),
in this process for the one-process case.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_mesh_worker as worker
from triton_client_tpu.models import transformer as jtr
from triton_client_tpu_torch.models import transformer as ttr
from triton_client_tpu_torch.utils import checkpoint as ckpt

FIELDS = dict(vocab_size=64, d_model=32, n_layers=4, n_heads=4, head_dim=8,
              d_ff=64, n_experts=0)


def _arrays():
    params = jtr.init_params(jax.random.PRNGKey(0), jtr.TransformerConfig(
        **FIELDS, dtype=jnp.float32))
    arrays = {f"p/{k}": np.asarray(v) for k, v in params.items()}
    for i in range(4):
        rng = np.random.default_rng(i)
        arrays[f"tokens{i}"] = rng.integers(0, 64, (8, 32), dtype=np.int32)
        arrays[f"labels{i}"] = rng.integers(0, 64, (8, 32), dtype=np.int32)
    return params, arrays


def _jax_losses(params, arrays):
    cfg = jtr.TransformerConfig(**FIELDS, dtype=jnp.float32)
    dev = np.asarray(jax.devices()[:1]).reshape(1, 1, 1, 1, 1)
    step = jtr.make_train_step(jax.sharding.Mesh(dev, jtr.MESH_AXES), cfg,
                               n_micro=2)
    opt = jtr.adam_init(params)
    losses = []
    for i in range(4):
        params, opt, loss = step(params, opt,
                                 jnp.asarray(arrays[f"tokens{i}"]),
                                 jnp.asarray(arrays[f"labels{i}"]))
        losses.append(float(loss))
    return losses


@pytest.fixture(scope="module")
def reference():
    """The inputs and the reference's four losses (once for both runs)."""
    params, arrays = _arrays()
    return arrays, _jax_losses(params, arrays)


@pytest.fixture(scope="module", params=["one", "four"])
def run(request, tmp_path_factory, reference):
    arrays, jax_losses = reference
    workdir = tmp_path_factory.mktemp(f"ckpt_{request.param}")
    spec = {"task": "checkpoint", "cfg": FIELDS}
    if request.param == "one":
        spec["mesh"] = {a: 1 for a in ttr.MESH_AXES}
        _, out, info = worker.task_checkpoint(spec, arrays, str(workdir),
                                              spec["mesh"])
    else:
        spec["mesh"] = ttr.mesh_shape_for(4, ttr.TransformerConfig(**FIELDS))
        out, info = worker.launch(workdir, 4, spec, arrays)
    return request.param, spec["mesh"], out, info, jax_losses, workdir


def test_resume_matches_uninterrupted(run):
    _, _, out, info, _, _ = run
    assert info["restored_step"] == 2
    np.testing.assert_allclose(out["resumed_losses"], out["straight_losses"],
                               rtol=1e-6)
    names = [k[len("straight/"):] for k in out if k.startswith("straight/")]
    assert names
    for k in names:
        np.testing.assert_allclose(out[f"resumed/{k}"], out[f"straight/{k}"],
                                   rtol=1e-5, atol=1e-6,
                                   err_msg=f"param {k} diverged after resume")


def test_uninterrupted_run_matches_jax(run):
    _, _, out, _, jax_losses, _ = run
    np.testing.assert_allclose(out["straight_losses"], jax_losses, rtol=1e-4)


def test_restore_onto_the_same_shards(run):
    _, _, _, info, _, _ = run
    assert info["same_shards"] is True


def test_retention_and_latest_step(run):
    _, _, _, info, _, workdir = run
    assert info["kept"] == [2, 3] and info["latest"] == 3
    assert sorted(os.listdir(workdir / "keep")) == ["2", "3"]


def test_refusals(run):
    which, _, _, info, _, _ = run
    assert info["empty_latest"] is None
    assert info["empty_restore"].startswith("FileNotFoundError")
    assert info["refused"].startswith("ValueError") and \
        "not newer" in info["refused"]
    if which == "four":
        assert info["other_mesh"].startswith("ValueError") and \
            "mesh" in info["other_mesh"]


def test_layout_on_disk(run):
    """One file per rank of its shards and a manifest with the mesh shape,
    the step and every leaf; no temporary directory left."""
    which, mesh_shape, _, _, _, workdir = run
    root = workdir / "ckpt"
    assert sorted(os.listdir(root)) == ["2"]
    ranks = 4 if which == "four" else 1
    assert sorted(os.listdir(root / "2")) == sorted(
        ["manifest.json"] + [f"rank_{r}.pt" for r in range(ranks)])
    manifest = json.loads((root / "2" / "manifest.json").read_text())
    assert manifest["step"] == 2 and manifest["ranks"] == ranks
    assert manifest["mesh"] == {a: n for a, n in mesh_shape.items() if n > 1}
    assert manifest["leaves"]["params/wq"]["dtype"] == "float32"
    assert manifest["leaves"]["opt/count"] == {"shape": [],
                                               "dtype": "int32"}
    # tp = 2 halves the heads of every rank's wq
    heads = FIELDS["n_heads"] // mesh_shape["tp"]
    assert manifest["leaves"]["params/wq"]["shape"][2] == heads
    shard = torch.load(root / "2" / "rank_0.pt", weights_only=True)
    assert tuple(shard["params/wq"].shape) == tuple(
        manifest["leaves"]["params/wq"]["shape"])


def test_one_process_mesh_mismatch_and_bad_leaf(tmp_path):
    """A one-process checkpoint refuses a state of other shapes, and the
    manager refuses to keep nothing."""
    cfg = ttr.TransformerConfig(**FIELDS, dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    params = ttr.init_params(gen, cfg)
    opt = ttr.adam_init(params)
    mgr = ckpt.make_manager(str(tmp_path / "c"), max_to_keep=1)
    ckpt.save(mgr, 5, params, opt)
    wrong = dict(params, wq=params["wq"][:, :, :2])
    with pytest.raises(ValueError, match="params/wq"):
        ckpt.restore(mgr, wrong, opt)
    p, o, step = ckpt.restore(mgr, params, opt)
    assert step == 5 and all(torch.equal(p[k], params[k]) for k in params)
    ckpt.save(mgr, 6, params, opt)
    assert ckpt.all_steps(mgr) == [6]
    with pytest.raises(ValueError, match="max_to_keep"):
        ckpt.make_manager(str(tmp_path / "d"), max_to_keep=0)
