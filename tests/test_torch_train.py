"""The port's training step against the JAX package's, on the CPU.

The reference's weights and Adam state (``init_params`` / ``adam_init``)
are carried across as numpy arrays (``params_from_jax``, ``opt_from_jax``)
and the same numpy tokens go through both packages, in f32 at the sizes of
``tests/test_transformer.py`` (vocab 64, d_model 32, 4 layers, 4 heads of
8, d_ff 64, 2 experts or dense; B = 8, S = 32, two microbatches).

* One process: the port's ``make_grad_fn`` and ``make_train_step`` on a
  one-rank mesh against the reference's on one device, dense and MoE,
  with attention below the flash gate (the single-shard ring) and with
  ``TRITON_TPU_FLASH_MIN_S=16`` in both packages (the port's
  ``flash_attention`` autograd Function; the reference reaches its
  ``flash_attention_reference`` on the CPU).  On the flash branch the
  reference's step is its ``_adam_update`` on its gradients, what its
  ``make_train_step`` computes, without a second compile.
* Eight gloo ranks (subprocesses, ``tests/_torch_mesh_worker.py``) on the
  reference's two meshes, dp=2 x ep=2 x tp=2 and ``make_mesh(8, cfg)``
  (tp=2 x sp=2 x pp=2), against the reference's step on its 8 virtual CPU
  devices: the gathered gradients and loss, one step's parameters, the
  mesh forward's logits; and the loss falls over 5 steps at lr 3e-3.

Tolerances: the loss rtol 1e-4 and raw gradients rtol 1e-3 / atol 1e-6
(f32 sums in other orders; Adam hides constant per-leaf scale errors, so
the gradients are checked raw); a step's parameters rtol 1e-3 / atol 1e-4
(Adam's first step moves a weight by ~lr = 1e-3 along its gradient's sign,
so the step adds nothing over the gradients but a wrong update rule); the
forward's logits rtol 1e-3 / atol 1e-4, the reference's own bound for its
sharded forward.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_mesh_worker as worker
from triton_client_tpu.models import transformer as jtr
from triton_client_tpu_torch.models import transformer as ttr

FIELDS = dict(vocab_size=64, d_model=32, n_layers=4, n_heads=4, head_dim=8,
              d_ff=64)


def _fields(moe):
    return dict(FIELDS, n_experts=2 if moe else 0)


def _jcfg(moe):
    return jtr.TransformerConfig(**_fields(moe), dtype=jnp.float32)


def _tcfg(moe):
    return ttr.TransformerConfig(**_fields(moe), dtype=torch.float32)


def _data(seed=0, B=8, S=32):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 64, (B, S), dtype=np.int32),
            rng.integers(0, 64, (B, S), dtype=np.int32))


def _mesh1():
    dev = np.asarray(jax.devices()[:1]).reshape(1, 1, 1, 1, 1)
    return jax.sharding.Mesh(dev, jtr.MESH_AXES)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _state(moe, seed):
    params = jtr.init_params(jax.random.PRNGKey(seed), _jcfg(moe))
    return params, jtr.adam_init(params)


def _close_tree(got, want, rtol, atol, what):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(
            np.asarray(got[k]), np.asarray(want[k]), rtol=rtol, atol=atol,
            err_msg=f"{what} {k}")


@pytest.fixture(params=["ring", "flash"])
def attention_branch(request, monkeypatch):
    if request.param == "flash":
        monkeypatch.setenv("TRITON_TPU_FLASH_MIN_S", "16")
    else:
        monkeypatch.delenv("TRITON_TPU_FLASH_MIN_S", raising=False)
    return request.param


@pytest.mark.parametrize("moe", [True, False], ids=["moe", "dense"])
def test_one_process_grads_and_step_match_jax(moe, attention_branch):
    tokens, labels = _data()
    params, opt = _state(moe, 3)
    jg, jl = jtr.make_grad_fn(_mesh1(), _jcfg(moe), n_micro=2)(
        params, jnp.asarray(tokens), jnp.asarray(labels))
    if attention_branch == "ring":
        jp, _, jsl = jtr.make_train_step(_mesh1(), _jcfg(moe), n_micro=2)(
            jax.tree.map(jnp.copy, params), jax.tree.map(jnp.copy, opt),
            jnp.asarray(tokens), jnp.asarray(labels))
    else:
        # the branches differ in attention only, which the gradients hold;
        # the reference's step on one device is its update on them (one
        # compile less)
        jp, _ = jtr._adam_update(params, jg, opt)
        jsl = jl

    cfg = _tcfg(moe)
    mesh = ttr.make_mesh(1, cfg, device="cpu")
    assert mesh.backend is None and all(g is None
                                        for g in mesh.groups.values())
    tparams = ttr.params_from_jax(_np(params), cfg)
    topt = ttr.opt_from_jax(jax.tree.map(np.asarray, opt), cfg)
    before = {k: v.clone() for k, v in tparams.items()}
    tg, tl = ttr.make_grad_fn(mesh, cfg, n_micro=2)(tparams, tokens, labels)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    _close_tree({k: v.numpy() for k, v in tg.items()}, jg, 1e-3, 1e-6,
                "grad")
    tp, to, tsl = ttr.make_train_step(mesh, cfg, n_micro=2)(
        tparams, topt, tokens, labels)
    np.testing.assert_allclose(float(tsl), float(jsl), rtol=1e-4)
    _close_tree({k: v.numpy() for k, v in tp.items()}, jp, 1e-3, 1e-4,
                "param")
    assert int(to["count"]) == 1
    # the step returns new tensors and leaves its inputs as they were
    assert all(torch.equal(tparams[k], before[k]) for k in before)


def test_flash_branch_goes_through_the_autograd_function(monkeypatch):
    """At the gate the training forward calls ``flash_attention`` (the
    autograd Function), and its backward reaches the recompute."""
    fa = importlib.import_module("triton_client_tpu_torch.ops.flash_attention")
    monkeypatch.setenv("TRITON_TPU_FLASH_MIN_S", "16")
    calls = []
    real = fa._Flash.backward

    def counting(ctx, g):
        calls.append(g.shape)
        return real(ctx, g)

    monkeypatch.setattr(fa._Flash, "backward", staticmethod(counting))
    cfg = _tcfg(False)
    params, _ = _state(False, 3)
    tokens, labels = _data()
    mesh = ttr.make_mesh(1, cfg, device="cpu")
    ttr.make_grad_fn(mesh, cfg, n_micro=2)(
        ttr.params_from_jax(_np(params), cfg), tokens, labels)
    # 4 layers x 2 microbatches, each [mb, H, S, K]
    assert calls == [torch.Size([4, 4, 32, 8])] * 8


@pytest.mark.parametrize("sm_scale", [None, 0.3], ids=["scale-unset",
                                                      "scale-0.3"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_function_gradients(causal, sm_scale):
    """The autograd Function's gradients against autograd straight through
    the plain version (equal: the backward is that recompute) and against
    ``jax.vjp`` of the reference's ``flash_attention(..., interpret=True)``
    (its Pallas kernel in interpret mode forward, its reference's VJP
    backward), f32, atol 1e-5."""
    from triton_client_tpu.ops import flash_attention as jflash
    from triton_client_tpu_torch import ops as tops

    rng = np.random.default_rng(21)
    shape = (1, 2, 40, 16)
    q, k, v, w = (rng.standard_normal(shape).astype(np.float32)
                  for _ in range(4))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tops.flash_attention(*leaves, causal=causal, sm_scale=sm_scale)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, torch.from_numpy(w))
    plain = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    ref = tops.flash_attention_reference(*plain, causal=causal,
                                         sm_scale=sm_scale)
    want = torch.autograd.grad(ref, plain, torch.from_numpy(w))
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    _, vjp = jax.vjp(lambda a, b, c: jflash(
        a, b, c, causal=causal, sm_scale=sm_scale, interpret=True),
        *(jnp.asarray(a) for a in (q, k, v)))
    for g, r in zip(got, vjp(jnp.asarray(w))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-5)


def test_flash_backward_reports_no_work():
    """The recompute goes through ``_reference``: a cost count open over a
    forward and backward holds the forward's work once."""
    from triton_client_tpu_torch.ops import _count
    from triton_client_tpu_torch import ops as tops

    fa = importlib.import_module("triton_client_tpu_torch.ops.flash_attention")
    q, k, v = (torch.randn(1, 2, 16, 8, generator=torch.Generator()
                           .manual_seed(s)).requires_grad_()
               for s in range(3))
    count = _count.KernelCount()
    with _count.counting(count):
        tops.flash_attention(q, k, v).sum().backward()
    flops, nbytes = fa.flash_work(q, k, True)
    assert (count.flops, count.bytes) == (flops, nbytes)
    assert q.grad is not None and k.grad is not None and v.grad is not None


def test_mesh_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where CUDA is missing")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttr.make_mesh(1, _tcfg(True))
    assert ttr.make_mesh(1, _tcfg(True), device="cpu").device.type == "cpu"


def test_shard_and_gather_are_inverse_on_one_process():
    cfg = _tcfg(True)
    params, _ = _state(True, 5)
    tparams = ttr.params_from_jax(_np(params), cfg)
    mesh = ttr.make_mesh(1, cfg, device="cpu")
    local = ttr.shard_params(tparams, mesh, cfg)
    back = ttr.gather_params(local, mesh, cfg)
    assert all(torch.equal(back[k], tparams[k]) for k in tparams)


# -- eight gloo ranks ---------------------------------------------------------

MESHES = {
    "dp2_ep2_tp2": dict(dp=2, pp=1, ep=2, sp=1, tp=2),
    "make_mesh8": None,  # jtr.mesh_shape_for(8, cfg): tp=2, sp=2, pp=2
}


def _jax_mesh(shape):
    dev = np.asarray(jax.devices()[:8]).reshape(
        [shape[a] for a in jtr.MESH_AXES])
    return jax.sharding.Mesh(dev, jtr.MESH_AXES)


@pytest.fixture(scope="module", params=sorted(MESHES))
def eight_ranks(request, tmp_path_factory):
    """One launch of 8 ranks per mesh: MoE (and dense on make_mesh(8))
    grads, a step, the forward and 5 steps; beside them, computed while
    the ranks run, the reference's results on the same mesh of its 8 CPU
    devices.  The reference's step is its ``_adam_update`` on its synced
    8-device gradients, which is what its ``make_train_step`` runs on each
    shard (elementwise), without a second compile."""
    shape = MESHES[request.param] or jtr.mesh_shape_for(8, _jcfg(True))
    names = ["moe", "dense"] if request.param == "make_mesh8" else ["moe"]
    tokens, labels = _data()
    arrays = {"tokens": tokens, "labels": labels}
    states = {}
    for name in names:
        params, opt = states[name] = _state(name == "moe",
                                            7 if name == "moe" else 8)
        for k, v in params.items():
            arrays[f"{name}/p/{k}"] = np.asarray(v)
            arrays[f"{name}/mu/{k}"] = np.asarray(opt["mu"][k])
            arrays[f"{name}/nu/{k}"] = np.asarray(opt["nu"][k])
        arrays[f"{name}/count"] = np.asarray(opt["count"])
    spec = {"task": "train", "mesh": shape, "steps": 5,
            "cfgs": {n: _fields(n == "moe") for n in names}}
    started = worker.start(tmp_path_factory.mktemp(request.param), 8, spec,
                           arrays)
    want = {}
    jmesh = _jax_mesh(shape)
    for name in names:
        params, opt = states[name]
        cfg = _jcfg(name == "moe")
        placed = jtr.place_params(params, jmesh, cfg)
        g, loss = jtr.make_grad_fn(jmesh, cfg, n_micro=2)(
            placed, jnp.asarray(tokens), jnp.asarray(labels))
        p, _ = jtr._adam_update(params, _np(g), opt)
        logits = jtr.make_forward(jmesh, cfg)(placed, jnp.asarray(tokens))
        want[name] = dict(grad=_np(g), loss=float(loss), step=_np(p),
                          logits=np.asarray(logits))
    got, info = worker.wait(started)
    return request.param, names, got, info, want


def _sub(got, prefix):
    return {k[len(prefix):]: v for k, v in got.items()
            if k.startswith(prefix)}


def test_eight_rank_grads_match_jax(eight_ranks):
    mesh_name, names, got, info, want = eight_ranks
    assert info["backend"] == "gloo"
    for name in names:
        np.testing.assert_allclose(float(got[f"{name}/loss"]),
                                   want[name]["loss"], rtol=1e-4)
        _close_tree(_sub(got, f"{name}/grad/"), want[name]["grad"], 1e-3,
                    1e-6, f"{mesh_name} {name} grad")


def test_eight_rank_train_step_matches_jax(eight_ranks):
    mesh_name, names, got, _, want = eight_ranks
    for name in names:
        np.testing.assert_allclose(float(got[f"{name}/step_loss"]),
                                   want[name]["loss"], rtol=1e-4)
        _close_tree(_sub(got, f"{name}/step/"), want[name]["step"], 1e-3,
                    1e-4, f"{mesh_name} {name} param")


def test_eight_rank_forward_matches_jax(eight_ranks):
    mesh_name, names, got, _, want = eight_ranks
    for name in names:
        np.testing.assert_allclose(got[f"{name}/logits"],
                                   want[name]["logits"], rtol=1e-3,
                                   atol=1e-4, err_msg=mesh_name)


def test_eight_rank_loss_decreases(eight_ranks):
    _, names, got, _, want = eight_ranks
    for name in names:
        losses = got[f"{name}/losses"]
        assert len(losses) == 5 and losses[-1] < losses[0], losses
        np.testing.assert_allclose(losses[0], want[name]["loss"], rtol=1e-4)
