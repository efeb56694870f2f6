"""The model repository and versioned models in the port, against the
reference's server, on the CPU.

The counterpart of ``tests/test_model_repository.py``.  Each package gets a
repository of the same layout (Triton's ``<repo>/<model>/config.pbtxt`` and
numbered ``<N>/model.py``), each with its own ``model.py`` (the port's on
``triton_client_tpu_torch.server.model.PyModel``, the reference's on its
own), served side by side; the same calls go to both, through the port's
HTTP client and its gRPC-Web client:

* the index before and after a load, load, infer, unload and reload, and
  the texts of every refusal (an unknown model, a file path that leaves
  the in-request directory, a version the policy asks for and the
  repository lacks, an unloaded model's infer);
* a reload serves the new instance, through a new dynamic batcher, and
  the stale batcher's thread stops; a request parked across a reload or
  an unload gets 503 rather than a batcher of the retired instance;
* the JSON config override and a plain reload restoring ``config.pbtxt``,
  the ``files`` load, the version policies (latest, all, specific),
  per-version statistics and metadata;
* ``unload_dependents`` on an ensemble, ``load_fail`` chaos;
* the port refuses a model.py built on the reference's ``PyModel``, and a
  config field it does not serve, naming the ROADMAP item;
* the prebuilt native ``simple_http_model_control``,
  ``simple_grpc_model_control`` (gRPC-Web) and
  ``simple_http_health_metadata`` against the port's server.

``protocol/text_format.py`` is held to protobuf's ``text_format`` and
``json_format`` on the same texts.
"""

import json
import os
import subprocess
import textwrap
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from triton_client_tpu.models import zoo as jzoo
from triton_client_tpu.server import chaos as jchaos
from triton_client_tpu.server.registry import ModelRegistry as JaxRegistry
from triton_client_tpu.server.testing import ServerHarness as JaxHarness
from triton_client_tpu_torch import grpc as tgrpc
from triton_client_tpu_torch import http as thttp
from triton_client_tpu_torch.models import zoo as tzoo
from triton_client_tpu_torch.protocol import inference as tpb
from triton_client_tpu_torch.protocol._proto3 import to_dict
from triton_client_tpu_torch.protocol.text_format import (ParseError,
                                                          parse_json,
                                                          parse_text)
from triton_client_tpu_torch.server import chaos as tchaos
from triton_client_tpu_torch.server.registry import ModelRegistry
from triton_client_tpu_torch.server.testing import ServerHarness
from triton_client_tpu_torch.utils import InferenceServerException

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_BUILD = os.path.join(REPO, "native", "client", "build")

_PKG = {"port": "triton_client_tpu_torch", "ref": "triton_client_tpu"}

MODEL_PY = textwrap.dedent(
    """
    import numpy as np
    from {pkg}.server.model import PyModel

    FACTOR = {factor}


    def get_model(config):
        def fn(inputs, params):
            x = np.asarray(inputs["X"])
            return {{"Y": (x * FACTOR).astype(np.int32)}}

        return PyModel(config, fn)
    """)

CONFIG_PBTXT = textwrap.dedent(
    """
    name: "tripler"
    backend: "python"
    input [{ name: "X" data_type: TYPE_INT32 dims: [ 4 ] }]
    output [{ name: "Y" data_type: TYPE_INT32 dims: [ 4 ] }]
    """)

# batched: the core runs it through a dynamic batcher
BATCHED_PBTXT = textwrap.dedent(
    """
    name: "batched"
    backend: "python"
    max_batch_size: 8
    input [{ name: "X" data_type: TYPE_INT32 dims: [ 4 ] }]
    output [{ name: "Y" data_type: TYPE_INT32 dims: [ 4 ] }]
    dynamic_batching { max_queue_delay_microseconds: 100 }
    """)

ADDER_CONFIG = CONFIG_PBTXT.replace('"tripler"', '"adder"')


def _model_py(which: str, factor) -> str:
    return MODEL_PY.format(pkg=_PKG[which], factor=factor)


def _write(path, text: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def _repo(root, which: str):
    """tripler (x 3) and batched (x 5), version 1 each."""
    _write(os.path.join(root, "tripler", "config.pbtxt"), CONFIG_PBTXT)
    _write(os.path.join(root, "tripler", "1", "model.py"),
           _model_py(which, 3))
    _write(os.path.join(root, "batched", "config.pbtxt"), BATCHED_PBTXT)
    _write(os.path.join(root, "batched", "1", "model.py"),
           _model_py(which, 5))
    return str(root)


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """(port harness, reference harness), each on its own repository."""
    t_root = _repo(tmp_path_factory.mktemp("port_repo"), "port")
    j_root = _repo(tmp_path_factory.mktemp("ref_repo"), "ref")
    with ServerHarness(ModelRegistry(repository_path=t_root)) as th, \
            JaxHarness(JaxRegistry(repository_path=j_root)) as jh:
        th.root, jh.root = t_root, j_root
        yield th, jh


def _clients(servers):
    th, jh = servers
    return (thttp.InferenceServerClient(th.http_url),
            thttp.InferenceServerClient(jh.http_url))


def _infer(client, model, values, version="", batched=False):
    x = np.asarray(values, np.int32)
    if batched:
        x = x[None]
    inp = thttp.InferInput("X", list(x.shape), "INT32")
    inp.set_data_from_numpy(x)
    return client.infer(model, [inp], model_version=version).as_numpy("Y")


def _outcome(fn):
    """("ok", value) or ("error", status, message) of a client call."""
    try:
        return ("ok", fn())
    except InferenceServerException as e:
        return ("error", e.status(), e.message())


def _both(servers, fn):
    """``fn(client)`` on both servers: the two outcomes, which must be
    equal (a value compared with numpy where it is an array)."""
    tc, jc = _clients(servers)
    with tc, jc:
        t, j = _outcome(lambda: fn(tc)), _outcome(lambda: fn(jc))
    assert t[0] == j[0], (t, j)
    if t[0] == "ok" and isinstance(t[1], np.ndarray):
        np.testing.assert_array_equal(t[1], j[1])
    else:
        assert t == j
    return t


def _ensure_unloaded(servers, name):
    tc, jc = _clients(servers)
    with tc, jc:
        for c in (tc, jc):
            if c.is_model_ready(name):
                c.unload_model(name)


def test_index_shows_unloaded_then_load_and_infer(servers):
    _ensure_unloaded(servers, "tripler")
    index = _both(servers, lambda c: c.get_model_repository_index())[1]
    rows = {m["name"]: m for m in index}
    assert rows["tripler"] == {"name": "tripler", "version": "1",
                               "state": "UNAVAILABLE", "reason": "unloaded"}
    assert _both(servers, lambda c: c.is_model_ready("tripler"))[1] is False
    _both(servers, lambda c: c.load_model("tripler"))
    _both(servers, lambda c: c.get_model_repository_index())
    assert _both(servers, lambda c: c.is_model_ready("tripler"))[1] is True
    out = _both(servers, lambda c: _infer(c, "tripler", [1, 2, 3, 4]))[1]
    np.testing.assert_array_equal(out, [3, 6, 9, 12])
    md = _both(servers, lambda c: c.get_model_metadata("tripler"))[1]
    assert md["versions"] == ["1"] and md["inputs"][0]["name"] == "X"


def test_unload_then_reload(servers):
    _both(servers, lambda c: c.load_model("tripler"))
    _both(servers, lambda c: c.unload_model("tripler"))
    assert _both(servers, lambda c: c.is_model_ready("tripler"))[1] is False
    err = _both(servers, lambda c: _infer(c, "tripler", [1, 1, 1, 1]))
    assert err[0] == "error" and "tripler" in err[2]
    # unloading what is not loaded
    _both(servers, lambda c: c.unload_model("tripler"))
    _both(servers, lambda c: c.load_model("tripler"))
    assert _both(servers, lambda c: c.is_model_ready("tripler"))[1] is True


def test_reload_serves_the_new_instance(servers):
    """A model.py rewritten on disk and reloaded: the next request runs
    the new instance, through a new batcher; the stale batcher's thread
    stops."""
    th, jh = servers
    _both(servers, lambda c: c.load_model("batched"))
    out = _both(servers, lambda c: _infer(c, "batched", [1, 2, 3, 4],
                                          batched=True))[1]
    np.testing.assert_array_equal(out, [[5, 10, 15, 20]])
    old = dict(th.core._batchers)
    assert list(old) == ["batched@1"]
    for h, which in ((th, "port"), (jh, "ref")):
        _write(os.path.join(h.root, "batched", "1", "model.py"),
               _model_py(which, 7))
    try:
        _both(servers, lambda c: c.load_model("batched"))
        out = _both(servers, lambda c: _infer(c, "batched", [1, 2, 3, 4],
                                              batched=True))[1]
        np.testing.assert_array_equal(out, [[7, 14, 21, 28]])
        new = th.core._batchers["batched@1"]
        assert new is not old["batched@1"]
        assert new._model is th.registry.get("batched")
        # stopped before the load answered
        assert not old["batched@1"]._thread.is_alive()
        # an unload retires the batcher too
        _both(servers, lambda c: c.unload_model("batched"))
        assert "batched@1" not in th.core._batchers
    finally:
        for h, which in ((th, "port"), (jh, "ref")):
            _write(os.path.join(h.root, "batched", "1", "model.py"),
                   _model_py(which, 5))


TORCH_MODEL_PY = textwrap.dedent(
    """
    import torch
    from triton_client_tpu_torch.server.model import TorchModel


    def get_model(config):
        w = torch.full((4,), 3, dtype=torch.int32)

        def fn(X):
            return {"Y": X * w}

        model = TorchModel(config, fn)
        model.weight = w
        return model
    """)


@pytest.mark.parametrize("kind", ["py", "torch"])
def test_unload_frees_the_instance(tmp_path, kind):
    """After an unload nothing of the core holds the retired instance (its
    device tensors would stay allocated): its batcher stops and the
    instance is collected, a TorchModel's counted first execution
    included."""
    import gc
    import weakref

    cfg = BATCHED_PBTXT + "instance_group [{ kind: KIND_CPU }]\n"
    _write(str(tmp_path / "batched" / "config.pbtxt"), cfg)
    _write(str(tmp_path / "batched" / "1" / "model.py"),
           _model_py("port", 3) if kind == "py" else TORCH_MODEL_PY)
    with ServerHarness(ModelRegistry(repository_path=str(tmp_path))) as h, \
            thttp.InferenceServerClient(h.http_url) as c:
        for _cycle in range(2):
            c.load_model("batched")
            out = _infer(c, "batched", [1, 2, 3, 4], batched=True)
            np.testing.assert_array_equal(out, [[3, 6, 9, 12]])
            ref = weakref.ref(h.registry.get("batched"))
            threads = [b._thread for k, b in h.core._batchers.items()
                       if k.startswith("batched@")]
            assert threads
            c.unload_model("batched")
            # stopped before the unload answered
            assert not any(t.is_alive() for t in threads)
            gc.collect()
            assert ref() is None


@pytest.mark.parametrize("swap", ["reload", "unload"])
def test_request_parked_across_a_swap(tmp_path, swap):
    """The port serves each connection on a thread of its own, so a request
    can resolve its instance, wait (here a chaos latency fault parks it)
    and reach the batcher after a load or an unload swapped that instance
    out.  It is refused with 503 rather than given a batcher around the
    retired instance; the next request runs the new instance, and the
    retired one is collected."""
    import gc
    import threading
    import weakref

    root = str(tmp_path)
    _write(os.path.join(root, "batched", "config.pbtxt"), BATCHED_PBTXT)
    _write(os.path.join(root, "batched", "1", "model.py"),
           _model_py("port", 3))
    with ServerHarness(ModelRegistry(repository_path=root)) as h, \
            thttp.InferenceServerClient(h.http_url) as c:
        c.load_model("batched")
        np.testing.assert_array_equal(
            _infer(c, "batched", [1, 2, 3, 4], batched=True), [[3, 6, 9, 12]])
        old = weakref.ref(h.registry.get("batched"))
        h.core.chaos = tchaos.ChaosInjector(
            rate=1.0, kinds=("latency",), latency_ms=2000, seed=0,
            max_faults=1, models=["batched"])
        parked = {}

        def run():
            with thttp.InferenceServerClient(h.http_url) as c2:
                parked["outcome"] = _outcome(lambda: _infer(
                    c2, "batched", [1, 1, 1, 1], batched=True))

        t = threading.Thread(target=run)
        t.start()
        deadline = time.monotonic() + 10
        while h.core.chaos.counters().get("batched") != 1:
            assert time.monotonic() < deadline, "the request never parked"
            time.sleep(0.01)
        _write(os.path.join(root, "batched", "1", "model.py"),
               _model_py("port", 7))
        if swap == "reload":
            c.load_model("batched")
        else:
            c.unload_model("batched")
        t.join(timeout=30)
        assert not t.is_alive()
        status, message = parked["outcome"][1:]
        assert status == "503" and "reloaded or unloaded" in message
        if swap == "reload":
            np.testing.assert_array_equal(
                _infer(c, "batched", [1, 2, 3, 4], batched=True),
                [[7, 14, 21, 28]])
            (key, b), = h.core._batchers.items()
            assert key == "batched@1"
            assert b._model is h.registry.get("batched")
        else:
            assert not h.core._batchers
        h.core.chaos = None
        gc.collect()
        assert old() is None


def test_override_of_a_registered_model_gets_a_new_batcher():
    """A registered model's load with a config override changes the config
    of the same instance: the batcher built from the old config is
    retired, and the next request runs through one built from the new."""
    from triton_client_tpu_torch.server.model import PyModel, config_from_pb

    cfg = config_from_pb(parse_text(BATCHED_PBTXT, tpb.ModelConfig),
                         "batched")
    model = PyModel(cfg, lambda inputs, params: {
        "Y": (np.asarray(inputs["X"]) * 3).astype(np.int32)})
    reg = ModelRegistry()
    reg.register_model(model)
    override = json.dumps({
        "name": "batched", "backend": "python", "max_batch_size": 8,
        "input": [{"name": "X", "data_type": "TYPE_INT32", "dims": [4]}],
        "output": [{"name": "Y", "data_type": "TYPE_INT32", "dims": [4]}],
        "dynamic_batching": {"max_queue_delay_microseconds": 300}})
    with ServerHarness(reg) as h, \
            thttp.InferenceServerClient(h.http_url) as c:
        np.testing.assert_array_equal(
            _infer(c, "batched", [1, 2, 3, 4], batched=True), [[3, 6, 9, 12]])
        old = h.core._batchers["batched@1"]
        c.load_model("batched", config=override)
        assert h.registry.get("batched") is model
        assert not old._thread.is_alive()
        np.testing.assert_array_equal(
            _infer(c, "batched", [1, 2, 3, 4], batched=True), [[3, 6, 9, 12]])
        new = h.core._batchers["batched@1"]
        assert new is not old and new._model is model
        assert new._max_delay_s == 300e-6


def test_load_with_config_override(servers):
    override = json.dumps({
        "name": "tripler", "backend": "python",
        "input": [{"name": "X", "data_type": "TYPE_INT32", "dims": [8]}],
        "output": [{"name": "Y", "data_type": "TYPE_INT32", "dims": [8]}],
    })
    _both(servers, lambda c: c.load_model("tripler", config=override))
    md = _both(servers, lambda c: c.get_model_metadata("tripler"))[1]
    assert md["inputs"][0]["shape"] == [8]
    _both(servers, lambda c: c.get_model_config("tripler"))
    # a plain reload restores config.pbtxt
    _both(servers, lambda c: c.load_model("tripler"))
    md = _both(servers, lambda c: c.get_model_metadata("tripler"))[1]
    assert md["inputs"][0]["shape"] == [4]


@pytest.mark.parametrize("override", [
    "{not json",
    json.dumps({"name": "tripler", "no_such_field": 1}),
    json.dumps({"name": "tripler", "input": [{"data_type": "TYPE_NOPE"}]}),
], ids=["malformed", "unknown-field", "unknown-enum"])
def test_bad_config_override_fails_the_load(servers, override):
    """The same status and prefix as the reference's; the parser's own
    words after it are protobuf's there (which adds the field list)."""
    tc, jc = _clients(servers)
    with tc, jc:
        t, j = [_outcome(lambda: c.load_model("tripler", config=override))
                for c in (tc, jc)]
    prefix = "failed to parse config override for 'tripler': "
    assert t[0] == j[0] == "error" and t[1] == j[1]
    assert t[2].startswith(prefix) and j[2].startswith(prefix)
    _both(servers, lambda c: c.get_model_repository_index())


def test_load_with_file_override(servers):
    config = json.dumps({
        "name": "doubler", "backend": "python",
        "input": [{"name": "X", "data_type": "TYPE_INT32", "dims": [4]}],
        "output": [{"name": "Y", "data_type": "TYPE_INT32", "dims": [4]}],
    })
    tc, jc = _clients(servers)
    with tc, jc:
        for c, which in ((tc, "port"), (jc, "ref")):
            c.load_model("doubler", config=config, files={
                "file:1/model.py": _model_py(which, 2).encode()})
            assert c.is_model_ready("doubler")
            np.testing.assert_array_equal(
                _infer(c, "doubler", [5, 6, 7, 8]), [10, 12, 14, 16])
        assert tc.get_model_repository_index() == \
            jc.get_model_repository_index()
        for c in (tc, jc):
            c.unload_model("doubler")


def test_malicious_file_path_rejected(servers):
    config = json.dumps({"name": "evil", "backend": "python"})
    t = _both(servers, lambda c: c.load_model(
        "evil", config=config, files={"file:../../outside.py": b"x = 1"}))
    assert t[0] == "error" and "invalid file path" in t[2]


def test_unknown_model_load_fails(servers):
    t = _both(servers, lambda c: c.load_model("not_in_repo"))
    assert t[0] == "error" and "not found in repository" in t[2]
    # the failed load is in the index
    _both(servers, lambda c: c.get_model_repository_index())


def test_ready_only_index(servers):
    _both(servers, lambda c: c.load_model("tripler"))
    out = []
    for h in servers:
        req = urllib.request.Request(
            f"http://{h.http_url}/v2/repository/index",
            data=b'{"ready": true}')
        with urllib.request.urlopen(req, timeout=30) as r:
            out.append(json.loads(r.read()))
    assert out[0] == out[1]
    assert all(m["state"] == "READY" for m in out[0])


def test_grpc_client_repository_calls(servers):
    """The port's gRPC-Web client: index, load with config and files,
    unload, errors, against both servers' HTTP ports."""
    th, jh = servers
    results = []
    for h, which in ((th, "port"), (jh, "ref")):
        with tgrpc.InferenceServerClient(h.http_url) as c:
            got = [c.get_model_repository_index(as_json=True)]
            c.load_model("tripler")
            c.load_model("doubler", config=json.dumps({
                "name": "doubler", "backend": "python",
                "input": [{"name": "X", "data_type": "TYPE_INT32",
                           "dims": [4]}],
                "output": [{"name": "Y", "data_type": "TYPE_INT32",
                            "dims": [4]}]}),
                files={"file:1/model.py": _model_py(which, 2).encode()})
            got.append(c.get_model_repository_index(as_json=True))
            got.append(c.is_model_ready("doubler"))
            c.unload_model("doubler")
            got.append(c.is_model_ready("doubler"))
            for call in (lambda: c.load_model("not_in_repo"),
                         lambda: c.unload_model("never_loaded")):
                with pytest.raises(InferenceServerException) as e:
                    call()
                got.append((e.value.status(), e.value.message()))
        results.append(got)
    assert results[0] == results[1]
    assert results[0][2] is True and results[0][3] is False


# -- versions ------------------------------------------------------------

ADDER_PY = textwrap.dedent(
    """
    import numpy as np
    from {pkg}.server.model import PyModel

    DELTA = {delta}


    def get_model(config):
        def fn(inputs, params):
            x = np.asarray(inputs["X"])
            return {{"Y": (x + DELTA).astype(np.int32)}}

        return PyModel(config, fn)
    """)


@pytest.fixture()
def adder(tmp_path):
    """The adder in each package's repository, versions 1 (+1) and 3
    (+3); ``policy`` appended to its config.pbtxt, then both served."""
    def make(policy: str = ""):
        roots = []
        for which in ("port", "ref"):
            mdir = tmp_path / which / "adder"
            for v in (1, 3):
                _write(str(mdir / str(v) / "model.py"),
                       ADDER_PY.format(pkg=_PKG[which], delta=v))
            _write(str(mdir / "config.pbtxt"), ADDER_CONFIG + policy)
            roots.append(str(tmp_path / which))
        return (ServerHarness(ModelRegistry(repository_path=roots[0])),
                JaxHarness(JaxRegistry(repository_path=roots[1])))
    return make


def _adder(c, version=""):
    return _infer(c, "adder", [10, 20, 30, 40], version)


@pytest.mark.parametrize("policy,served,default", [
    ("", ["3"], "3"),
    ("\nversion_policy { latest { num_versions: 2 } }\n", ["1", "3"], "3"),
    ("\nversion_policy { all {} }\n", ["1", "3"], "3"),
    ("\nversion_policy { specific { versions: [1] } }\n", ["1"], "1"),
], ids=["latest-default", "latest-2", "all", "specific"])
def test_version_policy(adder, policy, served, default):
    th, jh = adder(policy)
    with th, jh:
        servers = (th, jh)
        _both(servers, lambda c: c.load_model("adder"))
        for v in ("1", "3"):
            out = _both(servers, lambda c: _adder(c, v))
            if v in served:
                np.testing.assert_array_equal(
                    out[1], np.asarray([10, 20, 30, 40]) + int(v))
            else:
                assert out[0] == "error" and f"version {v}" in out[2]
            assert _both(servers, lambda c: c.is_model_ready(
                "adder", v))[1] is (v in served)
        np.testing.assert_array_equal(
            _both(servers, _adder)[1],
            np.asarray([10, 20, 30, 40]) + int(default))
        md = _both(servers, lambda c: c.get_model_metadata("adder"))[1]
        assert md["versions"] == served
        index = [m for m in _both(servers, lambda c:
                                  c.get_model_repository_index())[1]
                 if m["name"] == "adder"]
        assert [m["version"] for m in index] == served
        # each version's statistics under its own version; the unversioned
        # query lists every served version
        def rows(*args):
            return lambda c: [
                (m["name"], m["version"], m["inference_count"],
                 m["execution_count"])
                for m in c.get_inference_statistics(*args)["model_stats"]]

        both = _both(servers, rows("adder"))[1]
        assert [m[1] for m in both] == served
        one = _both(servers, rows("adder", served[0]))[1]
        assert [m[1] for m in one] == served[:1]
        # the policy is in the served config
        _both(servers, lambda c: c.get_model_config("adder"))


@pytest.mark.parametrize("policy,needle", [
    ("\nversion_policy { specific { versions: [7] } }\n", "[7]"),
    ("\nversion_policy { specific { } }\n", "lists no versions"),
], ids=["missing", "empty"])
def test_version_policy_refusals(adder, policy, needle):
    th, jh = adder(policy)
    with th, jh:
        t = _both((th, jh), lambda c: c.load_model("adder"))
        assert t[0] == "error" and needle in t[2]
        _both((th, jh), lambda c: c.get_model_repository_index())


# -- ensembles, chaos, refusals --------------------------------------------

@pytest.fixture()
def zoo_servers():
    treg, jreg = ModelRegistry(), JaxRegistry()
    for make in ("make_scale_by_two", "make_ensemble_scale_sum",
                 "make_simple"):
        treg.register_model(getattr(tzoo, make)())
        jreg.register_model(getattr(jzoo, make)())
    with ServerHarness(treg) as th, JaxHarness(jreg) as jh:
        yield th, jh


def test_unload_dependents(zoo_servers):
    _both(zoo_servers, lambda c: c.unload_model("ensemble_scale_sum",
                                                unload_dependents=True))
    index = _both(zoo_servers, lambda c: c.get_model_repository_index())[1]
    states = {m["name"]: m["state"] for m in index}
    # the ensemble's steps: scale_by_two and simple
    assert states == {"ensemble_scale_sum": "UNAVAILABLE",
                      "scale_by_two": "UNAVAILABLE", "simple": "UNAVAILABLE"}
    for name in ("scale_by_two", "simple", "ensemble_scale_sum"):
        _both(zoo_servers, lambda c: c.load_model(name))
    # without dependents, the member stays
    _both(zoo_servers, lambda c: c.unload_model("ensemble_scale_sum"))
    assert _both(zoo_servers, lambda c: c.is_model_ready(
        "scale_by_two"))[1] is True


def test_zoo_reload_serves_the_same_instance(zoo_servers):
    th, _jh = zoo_servers
    before = th.registry.get("simple")
    _both(zoo_servers, lambda c: c.unload_model("simple"))
    _both(zoo_servers, lambda c: c.load_model("simple"))
    assert th.registry.get("simple") is before
    gen = th.registry.generation("simple")
    assert gen == 3  # registered, unloaded, loaded


def test_load_fail_chaos(zoo_servers):
    th, jh = zoo_servers
    for h, mod in ((th, tchaos), (jh, jchaos)):
        h.core.chaos = mod.ChaosInjector(rate=1.0, kinds=("load_fail",),
                                         seed=0, max_faults=1)
    try:
        first = _both(zoo_servers, lambda c: c.load_model("simple"))
        assert first[0] == "error" and first[1] == "503"
        assert "injected load failure" in first[2]
        # max_faults spent: the next load passes; inference never draws it
        assert _both(zoo_servers, lambda c: c.load_model("simple"))[0] == \
            "ok"
        assert th.core.chaos.decide("simple") is None
        assert th.core.chaos.counters() == jh.core.chaos.counters() == {
            "simple": 1}
    finally:
        th.core.chaos = jh.core.chaos = None


def test_server_not_ready_while_a_model_loads(zoo_servers):
    """A name held LOADING makes the server not ready on both protocols,
    as in the reference; READY again restores it."""
    th, jh = zoo_servers
    for h in (th, jh):
        h.registry.set_state("simple", "LOADING", "warming up")
    try:
        assert _both(zoo_servers, lambda c: c.is_server_ready())[1] is False
        with tgrpc.InferenceServerClient(th.http_url) as g:
            assert g.is_server_ready() is False
        rows = _both(zoo_servers, lambda c: c.get_model_repository_index())
        assert {"name": "simple", "version": "1", "state": "LOADING",
                "reason": "warming up"} in rows[1]
    finally:
        for h in (th, jh):
            h.registry.set_state("simple", "READY", "")
    assert _both(zoo_servers, lambda c: c.is_server_ready())[1] is True


def test_unload_forgets_the_names_fault_and_memory_state(zoo_servers):
    """The port drops a name's quarantine (whose probe holds the retired
    instance) and its open governor pins at the unload; the reference
    keeps the quarantine (a design difference, ROADMAP C)."""
    th, _jh = zoo_servers
    core = th.core
    core.device_faults.register_probe("simple", lambda: False)
    core.device_faults.quarantine("simple", "drill")
    handle = core.memory.kv_pin("simple", 1024, "gold")
    assert not core.model_ready("simple")
    with thttp.InferenceServerClient(th.http_url) as c:
        c.unload_model("simple")
        c.load_model("simple")
    assert core.model_ready("simple")
    assert "simple" not in core.device_faults._probes
    assert core.memory.kv_unpin(handle) == ("", 0.0)  # already closed
    assert "simple" not in core.memory._kv_pinned_by_model


def test_repository_extensions_served(zoo_servers):
    out = _both(zoo_servers,
                lambda c: [e for e in c.get_server_metadata()["extensions"]
                           if e != "xla_shared_memory"])
    ext = out[1]
    assert "model_repository" in ext
    assert "model_repository(unload_dependents)" in ext


def test_reference_model_py_is_refused(tmp_path):
    """A model.py written for the JAX package builds its Model: the port
    refuses it with a load error naming its own Model class."""
    _write(str(tmp_path / "m" / "config.pbtxt"),
           CONFIG_PBTXT.replace('"tripler"', '"m"'))
    _write(str(tmp_path / "m" / "1" / "model.py"), _model_py("ref", 3))
    with ServerHarness(ModelRegistry(repository_path=str(tmp_path))) as h, \
            thttp.InferenceServerClient(h.http_url) as c:
        with pytest.raises(InferenceServerException) as e:
            c.load_model("m")
        assert "not a triton_client_tpu_torch.server.model.Model" in \
            e.value.message()
        assert c.get_model_repository_index() == [
            {"name": "m", "version": "1", "state": "UNAVAILABLE",
             "reason": "load failed"}]


_X_INPUT = '{ name: "X" data_type: TYPE_INT32 dims: [ 4 ] }'
_ENSEMBLE = textwrap.dedent(
    """
    platform: "ensemble"
    ensemble_scheduling { step [{ model_name: "inner" model_version: 1
      input_map { key: "X" value: "X" }
      output_map { key: "Y" value: "Y" } }] }
    """)
_ENSEMBLE_PY = textwrap.dedent(
    """
    from {pkg}.server.model import EnsembleModel


    def get_model(config):
        return EnsembleModel(config)
    """)
#: the config keys each package echoes for a loaded field
_ECHOED = ("default_model_filename", "input", "dynamic_batching",
           "sequence_batching", "ensemble_scheduling", "instance_group",
           "model_warmup", "response_cache")


@pytest.mark.parametrize("extra,item", [
    ("model_warmup [{ name: \"w\" batch_size: 1 }]", None),
    ("response_cache { enable: true }", None),
    ("instance_group [{ count: 2 kind: KIND_CPU }]", None),
    ("dynamic_batching { preserve_ordering: true }", None),
    ('default_model_filename: "model.py"', None),
    ((_X_INPUT, _X_INPUT[:-1] + "allow_ragged_batch: true }"), None),
    ("sequence_batching { control_input [{ name: \"START\" control "
     "[{ kind: CONTROL_SEQUENCE_START int32_false_true: [ 0, 1 ] }] }] }",
     None),
    (_ENSEMBLE, None),
    ("instance_group [{ count: 1 kind: KIND_GPU gpus: [ 0 ] }]", "A8"),
], ids=["warmup", "response-cache", "instances", "preserve-ordering",
        "default-model-filename", "ragged-batch", "control-input",
        "ensemble-step-version", "gpus"])
def test_unserved_config_fields_are_refused(tmp_path, extra, item):
    """A field the port does not serve is refused, naming its ROADMAP item
    (``instance_group.gpus``, A8).  The fields it serves since the fleet
    (``model_warmup``, and ``instance_group`` beyond one group of count
    1), the response cache (``response_cache``) and the five that the
    reference takes and does nothing with (``item`` None) load in both
    packages with the reference's answer: the same refusal (a warmup
    sample without the model's input fails the load) or the same config
    echo and outputs."""
    outcomes = {}
    for which, registry, harness in (("port", ModelRegistry, ServerHarness),
                                     ("ref", JaxRegistry, JaxHarness)):
        if which == "ref" and item is not None:
            continue
        root = tmp_path / which
        config = CONFIG_PBTXT.replace('"tripler"', '"m"')
        if isinstance(extra, tuple):
            config = config.replace(*extra)
        else:
            config += extra + "\n"
        ensemble = "ensemble_scheduling" in config
        _write(str(root / "m" / "config.pbtxt"), config)
        _write(str(root / "m" / "1" / "model.py"),
               _ENSEMBLE_PY.format(pkg=_PKG[which]) if ensemble
               else _model_py(which, 3))
        if ensemble:
            _write(str(root / "inner" / "config.pbtxt"),
                   CONFIG_PBTXT.replace('"tripler"', '"inner"'))
            _write(str(root / "inner" / "1" / "model.py"),
                   _model_py(which, 3))
        with harness(registry(repository_path=str(root))) as h, \
                thttp.InferenceServerClient(h.http_url) as c:
            try:
                if ensemble:
                    c.load_model("inner")
                c.load_model("m")
            except InferenceServerException as e:
                outcomes[which] = ("refused", e.message())
                continue
            cfg = c.get_model_config("m")
            x = thttp.InferInput("X", [4], "INT32")
            x.set_data_from_numpy(np.arange(4, dtype=np.int32))
            outcomes[which] = ("loaded", {k: cfg.get(k) for k in _ECHOED},
                               c.infer("m", [x]).as_numpy("Y").tolist())
    if item is not None:
        assert outcomes["port"][0] == "refused"
        assert f"ROADMAP {item}" in outcomes["port"][1]
    else:
        if "model_warmup" not in config:
            assert outcomes["port"][0] == "loaded", outcomes["port"]
        assert outcomes["port"] == outcomes["ref"]


# -- the readers ------------------------------------------------------------

_TEXTS = [
    CONFIG_PBTXT,
    BATCHED_PBTXT + "version_policy { latest { num_versions: 2 } }\n",
    textwrap.dedent("""
        name: 'ens'  # a comment
        platform: "ensemble"
        max_batch_size: 0x10
        input: [{ name: "A" data_type: TYPE_FP32 dims: [-1, 3] optional: true },
                { name: "B", data_type: 13, dims: 2 dims: 2 }]
        output < name: "C" data_type: TYPE_BF16 dims: [ 1 ] label_filename: "l.txt" >
        instance_group { kind: KIND_GPU count: 1 name: "g" }
        sequence_batching { max_sequence_idle_microseconds: 5000000
          control_input [{ name: "c" control [{ kind: CONTROL_SEQUENCE_START
            fp32_false_true: [0, 1.5f] int32_false_true: [-0x1, 010] }] }] }
        model_transaction_policy { decoupled: True }
        parameters { key: "k" value: { string_value: "a\\"b\\x41" "c" } }
        parameters: [{ key: "z" value { string_value: "" } }];
        ensemble_scheduling { step [{ model_name: "m" model_version: -1
          input_map { key: "x" value: "A" } output_map { key: "y" value: "C" } }] }
        """),
]


@pytest.mark.parametrize("text", _TEXTS, ids=["plain", "batched", "rich"])
def test_text_and_json_readers_as_protobuf(text):
    from google.protobuf import json_format, text_format

    from triton_client_tpu.protocol import inference_pb2 as rpb

    ref = text_format.Parse(text, rpb.ModelConfig())
    want = json_format.MessageToDict(ref, preserving_proto_field_name=True)
    ours = parse_text(text, tpb.ModelConfig)
    assert to_dict(ours) == want
    # the wire bytes read back by protobuf (its map order is its own)
    assert json_format.MessageToDict(
        rpb.ModelConfig.FromString(ours.SerializeToString()),
        preserving_proto_field_name=True) == want
    js = json_format.MessageToJson(ref)  # lowerCamelCase names
    assert to_dict(parse_json(js, tpb.ModelConfig)) == want
    assert to_dict(parse_json(json.dumps(want), tpb.ModelConfig)) == want


@pytest.mark.parametrize("text", [
    "foo: 1", 'name: "a" name: "b"', "version_policy { all {} latest {} }",
    "input { data_type: TYPE_NOPE }", "max_batch_size 3",
    "max_batch_size: 99999999999", 'name: "unterminated', "input {",
], ids=["unknown", "twice", "oneof", "enum", "colon", "range", "string",
        "open"])
def test_text_reader_refuses_as_protobuf(text):
    from google.protobuf import text_format

    from triton_client_tpu.protocol import inference_pb2 as rpb

    with pytest.raises(text_format.ParseError):
        text_format.Parse(text, rpb.ModelConfig())
    with pytest.raises(ParseError):
        parse_text(text, tpb.ModelConfig)


# -- the native clients ------------------------------------------------------

@pytest.fixture(scope="module")
def native_server():
    registry = ModelRegistry()
    for make in ("make_simple", "make_identity_fp32"):
        registry.register_model(getattr(tzoo, make)())
    with ServerHarness(registry) as h:
        yield h


@pytest.mark.parametrize("binary,env", [
    ("simple_http_model_control", {}),
    ("simple_grpc_model_control", {"TC_TPU_GRPC_TRANSPORT": "web"}),
    ("simple_http_health_metadata", {}),
])
def test_native_model_control_against_the_port(native_server, binary, env):
    path = os.path.join(NATIVE_BUILD, binary)
    if not os.access(path, os.X_OK):
        pytest.skip(f"{binary} is not built in native/client/build")
    proc = subprocess.run(
        [path, "-u", native_server.http_url], capture_output=True,
        text=True, timeout=120, env={**os.environ, **env})
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert "PASS" in proc.stdout


# -- the generation models' reload semantics -----------------------------------

@pytest.mark.parametrize("mode", ["independent", "batched"])
def test_decode_reload_semantics_as_reference(monkeypatch, mode):
    """The zoo's llama models are registered instances: an unload and a
    load give the same instance back.  ``llama_generate`` has no unload of
    its own and serves on; ``llama_decode``'s unload closes the decode
    model that both share, so in batched mode ``llama_generate`` answers
    503 "is unloading" from then on, while the reloaded ``llama_decode``
    reads ready (the reference's behaviour, kept)."""
    from triton_client_tpu.models import decode as jdec
    from triton_client_tpu_torch.models import decode as tdec

    monkeypatch.setenv("TRITON_TPU_LLAMA_PRESET", "tiny")
    monkeypatch.setenv("TRITON_TPU_DECODE_MODE", mode)
    jreg, treg = JaxRegistry(), ModelRegistry()
    jd = jdec.DecodeModel()
    for m in (jd.model, jdec.make_llama_generate(jd)):
        jreg.register_model(m)
    td = tzoo.make_llama_decode("cpu")
    for m in (td.model, tdec.make_llama_generate(td)):
        treg.register_model(m)

    def generate(url):
        req = urllib.request.Request(
            f"http://{url}/v2/models/llama_generate/generate_stream",
            data=json.dumps({"text_input": "hi", "max_tokens": 2}).encode())
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                r.read()
                return r.status, None
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    with ServerHarness(treg) as th, JaxHarness(jreg) as jh:
        runs = []
        for h in (th, jh):
            with thttp.InferenceServerClient(h.http_url) as c:
                before = h.registry.get("llama_generate")
                out = [generate(h.http_url)]
                c.unload_model("llama_generate")
                c.load_model("llama_generate")
                out.append(h.registry.get("llama_generate") is before)
                out.append(generate(h.http_url))
                c.unload_model("llama_decode")
                c.load_model("llama_decode")
                out.append(generate(h.http_url))
                out.append(c.is_model_ready("llama_decode"))
            runs.append(out)
    assert runs[0] == runs[1]
    assert runs[0][:3] == [(200, None), True, (200, None)]
    if mode == "batched":
        assert runs[0][3] == (503, {"error": "model 'llama_decode' is "
                                             "unloading"})


# -- the CLI ------------------------------------------------------------------

@pytest.mark.parametrize("zoo", [False, True], ids=["repository", "and-zoo"])
def test_cli_loads_the_repository_at_start(tmp_path, zoo):
    """``--model-repository DIR`` loads every model of DIR at start (a
    model that fails to load is reported and left UNAVAILABLE); the zoo
    is registered only with ``--zoo``."""
    import signal
    import sys

    from triton_client_tpu_torch.server.testing import free_port

    root = _repo(tmp_path / "repo", "port")
    _write(os.path.join(root, "broken", "config.pbtxt"),
           CONFIG_PBTXT.replace('"tripler"', '"broken"'))
    _write(os.path.join(root, "broken", "1", "model.py"),
           _model_py("ref", 3))
    port = free_port()
    cmd = [sys.executable, "-m", "triton_client_tpu_torch.server",
           "--device", "cpu", "--http-port", str(port), "--grpc-port", "0",
           "--metrics-port", "0", "--model-repository", root] + (["--zoo"] if zoo else [])
    log = open(tmp_path / "server.log", "w")
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=log,
                            stderr=subprocess.STDOUT,
                            env=dict(os.environ, PYTHONPATH=REPO,
                                     TRITON_TPU_LLAMA_PRESET="tiny"))
    url = f"127.0.0.1:{port}"
    try:
        end = time.monotonic() + 120
        while True:
            try:
                urllib.request.urlopen(f"http://{url}/v2/health/ready",
                                       timeout=5)
                break
            except OSError:
                assert proc.poll() is None and time.monotonic() < end
                time.sleep(0.1)
        with thttp.InferenceServerClient(url) as c:
            rows = {m["name"]: m for m in c.get_model_repository_index()}
            np.testing.assert_array_equal(
                _infer(c, "tripler", [1, 2, 3, 4]), [3, 6, 9, 12])
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=30)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    assert rows["tripler"]["state"] == rows["batched"]["state"] == "READY"
    assert rows["broken"] == {"name": "broken", "version": "1",
                              "state": "UNAVAILABLE",
                              "reason": "load failed"}
    assert ("simple" in rows) is zoo
    out = (tmp_path / "server.log").read_text()
    assert "loaded model 'tripler'" in out
    assert "failed to load 'broken'" in out
