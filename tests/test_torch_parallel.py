"""The port's mesh, collectives and process-group start against the JAX
package's, on the CPU.

* ``factorize_mesh`` and ``mesh_shape_for``: the same shapes as the
  reference's on the same arguments.
* Four gloo ranks (subprocesses, ``tests/_torch_mesh_worker.py``):
  ``ring_attention`` at sp = 4, forward and the gradients of a weighted
  sum, causal and not, against the reference's ``shard_map`` ring on four
  virtual CPU devices (f32, rtol 1e-5 / atol 1e-5: the same f32 math in
  another summation order); ``psum`` and ``ppermute`` with their
  backwards; ``sync_replicated_grads`` on dp = 2 x tp = 2 against the
  reference's (``tests/test_parallel.py``'s case).
* ``initialize_multihost``: nothing set, one process, and two processes
  whose all-reduce meets.
* ``build_mesh``: a one-rank mesh makes no process group; a mesh needs a
  card unless it is asked for the CPU.
"""

import math
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import _torch_mesh_worker as worker
from triton_client_tpu import parallel as jpar
from triton_client_tpu.models import transformer as jtr
from triton_client_tpu_torch import parallel as tpar
from triton_client_tpu_torch.models import transformer as ttr

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AXES = ("dp", "pp", "ep", "sp", "tp")


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16, 32, 64])
@pytest.mark.parametrize("limits,priority", [
    ({"tp": 8, "sp": 4, "pp": 4, "ep": 2}, ("tp", "sp", "pp", "ep")),
    ({"tp": 6, "sp": 1, "pp": 1, "ep": 1}, ("tp",)),
    ({"tp": 2, "sp": 4, "pp": 8, "ep": 8}, None),
], ids=["model", "indivisible", "default-priority"])
def test_factorize_mesh_matches_jax(n, limits, priority):
    kw = {} if priority is None else {"priority": priority,
                                      "remainder_axis": "dp"}
    assert tpar.factorize_mesh(n, limits, AXES, **kw) == \
        jpar.factorize_mesh(n, limits, AXES, **kw)


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("fields", [
    {}, dict(n_heads=16, n_layers=8, n_experts=0),
    dict(n_heads=4, n_layers=4, n_experts=2), dict(n_heads=2, n_layers=1),
], ids=["tiny", "longctx-base", "test-moe", "narrow"])
def test_mesh_shape_for_matches_jax(n, fields):
    import dataclasses

    jcfg = dataclasses.replace(jtr.TINY, **fields)
    tcfg = dataclasses.replace(ttr.TINY, **fields)
    assert ttr.mesh_shape_for(n, tcfg) == jtr.mesh_shape_for(n, jcfg)
    assert ttr.MESH_AXES == jtr.MESH_AXES


def test_one_rank_mesh_makes_no_group():
    mesh = tpar.build_mesh({"dp": 1, "tp": 1}, ("dp", "tp"), device="cpu")
    assert mesh.backend is None and mesh.size == 1
    assert mesh.groups == {"dp": None, "tp": None}
    assert mesh.axis_size("tp") == 1 and mesh.axis_index("dp") == 0
    assert mesh.transport == "none (one process)"
    # an axis of one is the identity for every collective
    x = torch.arange(3.0, requires_grad=True)
    assert tpar.psum(x, mesh, ("dp", "tp")) is x
    assert tpar.ppermute(x, mesh, "tp", 1) is x
    assert tpar.all_gather(x, mesh, "dp", 0) is x


def test_mesh_of_several_ranks_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        tpar.build_mesh({"dp": 2}, ("dp",), device="cpu")


def test_mesh_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where CUDA is missing")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpar.build_mesh({"dp": 1}, ("dp",))


def test_backend_rule():
    if torch.cuda.is_available():
        pytest.skip("checks the rule where CUDA is missing")
    assert tpar.backend_for(1) == "gloo"
    assert tpar.backend_for(4) == "gloo"


def test_replicated_axes_matches_jax():
    axes = ("dp", "pp", "tp")
    for t, j in [((None, "tp"), P(None, "tp")),
                 (("pp", ("dp", "tp")), P("pp", ("dp", "tp"))),
                 ((None,), P(None))]:
        assert tpar.replicated_axes(t, axes) == jpar.replicated_axes(j, axes)


# -- four gloo ranks ----------------------------------------------------------

def _jax_ring(q, k, v, w, causal):
    mesh = jpar.build_mesh({"sp": 4}, ("sp",), jax.devices("cpu")[:4])
    spec = P(None, None, "sp", None)
    ring = jax.jit(jpar.shard_map(
        lambda q, k, v: jpar.ring_attention(q, k, v, "sp", causal=causal),
        mesh=mesh, in_specs=(spec,) * 3, out_specs=spec))
    out = ring(q, k, v)
    grads = jax.grad(lambda q, k, v: (ring(q, k, v) * w).sum(),
                     argnums=(0, 1, 2))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _jax_sync():
    mesh = jpar.build_mesh({"dp": 2, "tp": 2}, ("dp", "tp"),
                           jax.devices("cpu")[:4])
    specs = {"w": P(None, "tp"), "b": P(None)}

    def body(w, b):
        synced = jpar.sync_replicated_grads(
            {"w": w * 0 + 1.0, "b": b * 0 + 1.0}, specs, ("dp", "tp"))
        return synced["w"], synced["b"]

    f = jax.jit(jpar.shard_map(body, mesh=mesh,
                               in_specs=(P(None, "tp"), P(None)),
                               out_specs=(P(None, "tp"), P(None))))
    gw, gb = f(jnp.zeros((2, 4), jnp.float32), jnp.zeros((3,), jnp.float32))
    return np.asarray(gw), np.asarray(gb)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    rng = np.random.default_rng(0)
    B, H, S, K = 2, 2, 32, 8
    arrays = {n: rng.standard_normal((B, H, S, K)).astype(np.float32)
              for n in ("q", "k", "v", "w")}
    started = worker.start(tmp_path_factory.mktemp("collectives"), 4,
                           {"task": "collectives"}, arrays)
    want = {causal: _jax_ring(*(jnp.asarray(arrays[n])
                                for n in ("q", "k", "v", "w")), causal)
            for causal in (True, False)}
    want["sync"] = _jax_sync()
    got, info = worker.wait(started)
    return got, info, want


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_attention_sp4_matches_jax(four_ranks, causal):
    got, info, want = four_ranks
    assert info["backend"] == "gloo"
    tag = "causal" if causal else "full"
    out, grads = want[causal]
    np.testing.assert_allclose(got[f"{tag}/out"], out, rtol=1e-5, atol=1e-5)
    for n, g in zip("qkv", grads):
        np.testing.assert_allclose(got[f"{tag}/d{n}"], g, rtol=1e-5,
                                   atol=1e-5, err_msg=f"d{n}")


def test_psum_and_ppermute_and_their_backwards(four_ranks):
    got, _, _ = four_ranks
    # rank r holds r + 1: the sum is 10 everywhere; the loss sum_r (r + 1)
    # * psum(x) gives each x the psum of the cotangents, 1 + 2 + 3 + 4
    np.testing.assert_array_equal(got["psum"], np.full(3, 10.0))
    np.testing.assert_array_equal(got["psum_grad"], np.full(3, 10.0))
    # rank r receives rank r - 1's value; the gradient comes back from
    # rank r + 1, whose weight is r + 11
    np.testing.assert_array_equal(
        got["ppermute"], np.repeat([3.0, 0.0, 1.0, 2.0], 2))
    np.testing.assert_array_equal(
        got["ppermute_grad"], np.repeat([11.0, 12.0, 13.0, 10.0], 2))


def test_host_staged_transport_matches_the_direct_one(four_ranks):
    """The copies through host memory that gloo takes for CUDA tensors,
    run on the CPU: the same values and gradients as the direct path, on
    views that are not contiguous."""
    got, _, _ = four_ranks
    for what in ("value", "grad"):
        np.testing.assert_array_equal(got[f"staged/{what}"],
                                      got[f"direct/{what}"])
    # rank r holds (r + 1) * arange(12) as [3, 4]; the psum of the
    # rotated copies is 10 * arange(12) on every rank
    np.testing.assert_array_equal(
        got["direct/value"],
        np.tile(10.0 * np.arange(12.0).reshape(3, 4), (4, 1)))


def test_sync_replicated_grads_matches_jax(four_ranks):
    got, info, want = four_ranks
    gw, gb = want["sync"]
    # rank 0's shard of w (its tp half) and its copy of b
    np.testing.assert_array_equal(got["sync/w"], gw[:, :2])
    np.testing.assert_array_equal(got["sync/b"], gb)
    assert info["replicated"] == {"w": ["dp"], "b": ["dp", "tp"]}


# -- initialize_multihost -------------------------------------------------------

_ONE_PROCESS = """
import os
import torch, torch.distributed as dist
from triton_client_tpu_torch.parallel import initialize_multihost
for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
    os.environ.pop(var, None)
assert not initialize_multihost()  # nothing set: off
assert initialize_multihost("127.0.0.1:%d", 1, 0)
assert initialize_multihost()  # idempotent once active
assert dist.get_world_size() == 1 and dist.get_rank() == 0
assert dist.get_backend() == "gloo"
x = torch.ones(4)
dist.all_reduce(x)
assert float(x.sum()) == 4.0
dist.destroy_process_group()
print("OK")
"""

# the reference's three variables start the group
_FROM_ENV = """
import torch.distributed as dist
from triton_client_tpu_torch.parallel import initialize_multihost
assert initialize_multihost()
assert dist.get_world_size() == 1
print("OK")
"""

# a group someone else started counts as active
_STARTED_ELSEWHERE = """
import torch.distributed as dist
from triton_client_tpu_torch.parallel import initialize_multihost
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d",
                        world_size=1, rank=0)
assert initialize_multihost()
print("OK")
"""


@pytest.fixture(scope="module")
def one_process_starts():
    """The three one-process cases, started at once."""
    env = dict(os.environ, PYTHONPATH=_REPO)
    cases = {
        "one_process": (_ONE_PROCESS % worker.free_port(), env),
        "from_env": (_FROM_ENV, dict(
            env, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{worker.free_port()}",
            JAX_NUM_PROCESSES="1", JAX_PROCESS_ID="0")),
        "started_elsewhere": (_STARTED_ELSEWHERE % worker.free_port(), env),
    }
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", script], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=_REPO, env=case_env)
        for name, (script, case_env) in cases.items()}
    deadline = time.monotonic() + 120
    outs = {}
    try:
        for name, p in procs.items():
            outs[name] = (*p.communicate(
                timeout=max(0.1, deadline - time.monotonic())), p.returncode)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


@pytest.mark.parametrize("case", ["one_process", "from_env",
                                  "started_elsewhere"])
def test_initialize_multihost_one_process(one_process_starts, case):
    out, err, rc = one_process_starts[case]
    assert rc == 0, err[-2000:]
    assert out.strip().endswith("OK")


def test_initialize_multihost_two_processes(tmp_path):
    got, info = worker.launch(tmp_path, 2, {"task": "multihost"}, {})
    assert info == {"backend": "gloo", "sum": 3.0, "world": 2}


def test_ring_chunks_cover_the_sequence():
    """The ring's causal mask by global position: at sp = 1 with no mesh
    the port's ring is plain causal attention."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 12, 8))
                                .astype(np.float32)) for _ in range(3))
    s = (q @ k.transpose(-1, -2)) / math.sqrt(8)
    s = s.masked_fill(~torch.ones(12, 12, dtype=torch.bool).tril(), -1e30)
    want = torch.softmax(s, -1) @ v
    torch.testing.assert_close(tpar.ring_attention(q, k, v), want,
                               rtol=1e-5, atol=1e-5)
