"""Small parts of the reference's surface that the port lacked, held to
the reference on the CPU.

* The server's ``--verbose`` / ``-v``: the reference's parser takes it
  (``triton_client_tpu/server/__main__.py``) and does nothing with it;
  the port's CLI takes it too.  A ``-v --device cpu`` server comes up
  ready, and the reference's parser reads the same line, less
  ``--device``, with ``verbose`` set.
* ``utils.triton_dtype_size``: the byte size of one element of every
  Triton dtype, None for BYTES and an unknown name, as the reference's.
"""

import argparse
import os
import signal
import subprocess
import sys
import time
import urllib.request

import pytest

from triton_client_tpu import utils as jutils
from triton_client_tpu_torch import utils as tutils
from triton_client_tpu_torch.server.testing import cli_http_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DTYPES = ["BOOL", "INT8", "INT16", "INT32", "INT64", "UINT8", "UINT16",
          "UINT32", "UINT64", "FP16", "BF16", "FP32", "FP64", "BYTES",
          "NOT_A_TYPE", ""]


@pytest.mark.parametrize("dtype", DTYPES)
def test_triton_dtype_size_is_the_reference_s(dtype):
    assert tutils.triton_dtype_size(dtype) == jutils.triton_dtype_size(dtype)


def test_triton_dtype_size_matches_the_dtype_maps():
    """Fixed-size types: the numpy item size (BF16 two bytes); BYTES
    none."""
    for dtype in DTYPES[:13]:
        np_dt = tutils.triton_to_np_dtype(dtype)
        size = tutils.triton_dtype_size(dtype)
        if dtype == "BF16":
            assert size == 2
        else:
            assert size == np_dt.itemsize, dtype
    assert tutils.triton_dtype_size("BYTES") is None


class _Parsed(Exception):
    pass


def test_reference_parser_takes_verbose(monkeypatch):
    """The reference's parser reads the line the port's test starts, less
    ``--device`` (the reference has none): it stops here, before a
    server starts."""
    from triton_client_tpu.server import __main__ as jmain

    parse = argparse.ArgumentParser.parse_args

    def parse_and_stop(self, args=None, namespace=None):
        raise _Parsed(parse(self, args, namespace))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args",
                        parse_and_stop)
    for flag in ("-v", "--verbose"):
        monkeypatch.setattr(sys, "argv", [
            "serve", flag, "--http-port", "0", "--metrics-port", "0"])
        with pytest.raises(_Parsed) as parsed:
            jmain.main()
        assert parsed.value.args[0].verbose is True


def test_port_server_takes_verbose(tmp_path):
    """``-v --device cpu`` starts a server that answers
    ``/v2/health/ready``, and SIGTERM ends it with 0."""
    log_path = tmp_path / "server.log"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "triton_client_tpu_torch.server", "-v",
             "--device", "cpu", "--http-port", "0", "--grpc-port", "0",
             "--metrics-port", "0"],
            cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
            env=dict(os.environ, PYTHONPATH=REPO))
        try:
            port = cli_http_port(proc, log_path, timeout=120)
            end = time.monotonic() + 120
            while True:
                try:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{port}/v2/health/ready",
                            timeout=5) as r:
                        status = r.status
                    break
                except OSError:
                    assert proc.poll() is None, log_path.read_text()
                    assert time.monotonic() < end, log_path.read_text()
                    time.sleep(0.1)
        finally:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=30)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    assert status == 200
    assert proc.returncode == 0, log_path.read_text()
    assert "unrecognized arguments" not in log_path.read_text()
