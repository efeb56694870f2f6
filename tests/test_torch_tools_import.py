"""The port's operators' tools are standard library only.

The counterpart of ``tests/test_tools_import.py``: every module under
``triton_client_tpu_torch.tools`` imports, in a fresh interpreter, with
neither ``torch`` nor ``numpy`` loaded on the way (the package's
``__init__`` included), has a ``main``, and its ``--help`` exits 0 as
``python -m``.  The port registers no console script for them.
"""

import os
import pkgutil
import subprocess
import sys

import pytest

import triton_client_tpu_torch.tools as tools_pkg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOOLS = sorted(m.name for m in pkgutil.iter_modules(tools_pkg.__path__))


def _python(*args: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_the_three_tools_are_there():
    assert TOOLS == ["incident_report", "top", "trace_summary"]


@pytest.mark.parametrize("name", TOOLS)
def test_import_loads_neither_torch_nor_numpy(name):
    proc = _python("-c", (
        "import importlib, sys\n"
        "mod = importlib.import_module("
        f"'triton_client_tpu_torch.tools.{name}')\n"
        "assert callable(mod.main)\n"
        "print(sorted(m for m in ('torch', 'numpy') "
        "if m in sys.modules))\n"))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


@pytest.mark.parametrize("name", TOOLS)
def test_help_exits_zero(name):
    proc = _python("-m", f"triton_client_tpu_torch.tools.{name}", "--help")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("usage: ")


def test_no_console_script_names_the_ports_tools():
    with open(os.path.join(REPO, "pyproject.toml")) as f:
        assert "triton_client_tpu_torch.tools" not in f.read()
