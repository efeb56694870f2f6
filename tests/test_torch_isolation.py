"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
nor ``google.protobuf`` or ``grpc`` (the card's machine has neither: the
port has its own proto3 codec and gRPC-Web transport), and its CUDA entry
points refuse to run without CUDA instead of quietly running on the CPU."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = textwrap.dedent("""
    import importlib, pkgutil, sys
    import triton_client_tpu_torch as pkg
    names = [pkg.__name__]
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        names.append(m.name)
        importlib.import_module(m.name)
    bad = sorted(n for n in sys.modules
                 if n == "jax" or n.startswith("jax.")
                 or n == "jaxlib" or n.startswith("jaxlib.")
                 or n == "triton_client_tpu"
                 or n.startswith("triton_client_tpu.")
                 or n == "google.protobuf"
                 or n.startswith("google.protobuf.")
                 or n == "grpc" or n.startswith("grpc."))
    print(len(names))
    print(",".join(bad))
""")


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=_REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split("\n") + [""] * (
        2 - len(out.stdout.strip().split("\n")))
    # the package, its subpackages and every module (server.__main__ too)
    assert int(count) >= 20, out.stdout
    assert bad == "", f"the port pulled in: {bad}"


@pytest.mark.parametrize("module", [
    "triton_client_tpu_torch.models.decode",
    "triton_client_tpu_torch.server.generate",
])
def test_generation_modules_stand_alone(module):
    """The generation stack's modules, each imported alone in a fresh
    interpreter, pull in neither JAX nor the JAX package."""
    code = textwrap.dedent(f"""
        import importlib, sys
        importlib.import_module({module!r})
        print(",".join(sorted(
            n for n in sys.modules
            if n.split(".")[0] in ("jax", "jaxlib", "triton_client_tpu"))))
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"{module} pulled in: {out.stdout}"


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where CUDA is missing")


def test_cuda_entry_points_raise_without_cuda(no_cuda):
    from triton_client_tpu_torch.device import resolve_device
    from triton_client_tpu_torch.models import language, zoo
    from triton_client_tpu_torch.server import __main__ as cli
    from triton_client_tpu_torch.server.registry import ModelRegistry

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        language.make_longctx_tpu()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        zoo.register_all(ModelRegistry())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--http-port", "0"])
    # asking for the CPU works
    assert language.make_longctx_tpu("cpu").device.type == "cpu"
