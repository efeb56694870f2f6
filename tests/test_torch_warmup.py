"""Model warmup in the port against the reference's, on the CPU.

The counterpart of ``tests/test_metrics_warmup.py``'s ``TestWarmup`` and
``TestWarmupOnLoad``: the same model and the same repository in both
packages, served side by side and driven through the port's HTTP client.
The configured samples run before the server serves and stay out of the
statistics; the config carries them over the wire; a repository load runs
them again, holding the name (and the server) LOADING for the whole
warmup; a failed warmup fails the load with the reference's text and
leaves the server and the other models serving; a sample's data file
resolves in the model's directory.
"""

import os
import textwrap
import threading
import time

import numpy as np
import pytest

import triton_client_tpu.server as jserver
from triton_client_tpu.server.registry import ModelRegistry as JaxRegistry
from triton_client_tpu.server.testing import ServerHarness as JaxHarness
from triton_client_tpu_torch import http as thttp
from triton_client_tpu_torch.models import zoo as tzoo
from triton_client_tpu_torch.server import warmup as twarmup
from triton_client_tpu_torch.server.model import TorchModel, make_config
from triton_client_tpu_torch.server.registry import ModelRegistry
from triton_client_tpu_torch.server.testing import ServerHarness
from triton_client_tpu_torch.utils import InferenceServerException

_WARMUP = [{"name": "zeros", "count": 2,
            "inputs": {"X": ("FP32", [1, 8], "zero")}},
           {"name": "randoms", "count": 1,
            "inputs": {"X": ("FP32", [1, 8], "random")}}]


def _warm_model(which: str, name: str = "warmed"):
    """A model of ``which`` package with two warmup samples (zeros x 2,
    randoms x 1); ``calls`` records each execution's input."""
    calls = []
    if which == "port":
        cfg = make_config(name, inputs=[("X", "FP32", [1, 8])],
                          outputs=[("Y", "FP32", [1, 8])],
                          instance_kind="KIND_CPU", warmup=_WARMUP)

        def fn(X):
            calls.append(X.numpy().copy())
            return {"Y": X * 2.0}

        return TorchModel(cfg, fn), calls
    import jax.numpy as jnp

    cfg = jserver.make_config(name, inputs=[("X", "FP32", [1, 8])],
                              outputs=[("Y", "FP32", [1, 8])],
                              instance_kind="KIND_CPU", warmup=_WARMUP)

    def jfn(X):
        calls.append(np.asarray(X).copy())
        return {"Y": jnp.asarray(X) * 2.0}

    return jserver.JaxModel(cfg, jfn, jit=False), calls


def _packages():
    return (("port", ModelRegistry, ServerHarness),
            ("ref", JaxRegistry, JaxHarness))


def _register_zoo(which, registry):
    if which == "port":
        tzoo.register_all(registry, device="cpu")
    else:
        from triton_client_tpu.models import zoo as jzoo

        jzoo.register_all(registry)


class TestWarmup:
    def test_samples_run_before_serving_and_skip_stats(self):
        seen = {}
        for which, registry_cls, harness_cls in _packages():
            registry = registry_cls()
            model, calls = _warm_model(which)
            registry.register_model(model)
            with harness_cls(registry) as h:
                before = len(calls)  # before the first request
                with thttp.InferenceServerClient(h.http_url) as client:
                    stats = client.get_inference_statistics("warmed")
                    s = stats["model_stats"][0]["inference_stats"]
                    x = np.ones((1, 8), np.float32)
                    inp = thttp.InferInput("X", [1, 8], "FP32")
                    inp.set_data_from_numpy(x)
                    y = client.infer("warmed", [inp]).as_numpy("Y")
                    after = client.get_inference_statistics("warmed")
            seen[which] = (before, s["success"]["count"],
                           s["fail"]["count"], y.tolist(),
                           after["model_stats"][0]["inference_stats"]
                           ["success"]["count"], calls[:before])
        port, ref = seen["port"], seen["ref"]
        assert port[0] == ref[0] == 3  # zeros x 2 + randoms x 1
        assert port[1:5] == ref[1:5] == (0, 0, [[2.0] * 8], 1)
        # the same samples: zeros, then the same seeded normal draws
        for a, b in zip(port[5], ref[5]):
            np.testing.assert_array_equal(a, b)

    def test_warmup_config_survives_wire(self):
        cfgs = []
        for which, registry_cls, harness_cls in _packages():
            model, _ = _warm_model(which, "warmed2")
            registry = registry_cls()
            registry.register_model(model)
            with harness_cls(registry) as h, \
                    thttp.InferenceServerClient(h.http_url) as client:
                cfgs.append(client.get_model_config("warmed2"))
        assert cfgs[0]["model_warmup"] == cfgs[1]["model_warmup"]
        assert len(cfgs[0]["model_warmup"]) == 2
        assert cfgs[0]["model_warmup"][0]["inputs"]["X"]["zero_data"]

    def test_samples_equal_reference(self):
        from triton_client_tpu.server import warmup as jwarmup

        port, _ = _warm_model("port")
        ref, _ = _warm_model("ref")
        ps, rs = twarmup.warmup_samples(port), jwarmup.warmup_samples(ref)
        assert [(n, c) for n, c, _ in ps] == [(n, c) for n, c, _ in rs]
        for (_, _, a), (_, _, b) in zip(ps, rs):
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
                assert a[k].dtype == b[k].dtype


_BAD_WARM = """
    name: "badwarm"
    platform: "{platform}"
    backend: "{platform}"
    input [ {{ name: "X" data_type: TYPE_FP32 dims: [ 1, 4 ] }} ]
    output [ {{ name: "Y" data_type: TYPE_FP32 dims: [ 1, 4 ] }} ]
    instance_group [ {{ kind: KIND_CPU }} ]
    model_warmup [
      {{ name: "missing"
        inputs {{ key: "X" value: {{ data_type: TYPE_FP32 dims: [ 1, 4 ]
                                   input_data_file: "nope.bin" }} }} }}
    ]
"""

_FILE_WARM = """
    name: "filewarm"
    platform: "{platform}"
    backend: "{platform}"
    input [ {{ name: "X" data_type: TYPE_FP32 dims: [ 1, 4 ] }} ]
    output [ {{ name: "Y" data_type: TYPE_FP32 dims: [ 1, 4 ] }} ]
    instance_group [ {{ kind: KIND_CPU }} ]
    model_warmup [
      {{ name: "fromfile"
        inputs {{ key: "X" value: {{ data_type: TYPE_FP32 dims: [ 1, 4 ]
                                   input_data_file: "x.bin" }} }} }}
    ]
"""

# the model of each package; WAIT_FILE set: each execution waits until
# that file exists (the LOADING window), and records its input in SEEN
_MODEL_PY = {
    "port": """
        import os
        import time

        import numpy as np
        from triton_client_tpu_torch.server.model import TorchModel

        WAIT_FILE = {wait!r}
        SEEN = {seen!r}


        def get_model(config):
            def fn(X):
                while WAIT_FILE and not os.path.exists(WAIT_FILE):
                    time.sleep(0.01)
                if SEEN:
                    with open(SEEN, "a") as f:
                        f.write(repr(X.numpy().tolist()) + "\\n")
                return {{"Y": X * 1.0}}

            return TorchModel(config, fn)
        """,
    "ref": """
        import os
        import time

        import numpy as np
        import jax.numpy as jnp
        from triton_client_tpu.server.model import JaxModel

        WAIT_FILE = {wait!r}
        SEEN = {seen!r}


        def get_model(config):
            def fn(X):
                while WAIT_FILE and not os.path.exists(WAIT_FILE):
                    time.sleep(0.01)
                if SEEN:
                    with open(SEEN, "a") as f:
                        f.write(repr(np.asarray(X).tolist()) + "\\n")
                return {{"Y": jnp.asarray(X)}}

            return JaxModel(config, fn, jit=False)
        """,
}


def _write_model(root, which, name, config, wait="", seen=""):
    mdir = os.path.join(str(root), name)
    os.makedirs(os.path.join(mdir, "1"), exist_ok=True)
    platform = "pytorch" if which == "port" else "jax"
    with open(os.path.join(mdir, "config.pbtxt"), "w") as f:
        f.write(textwrap.dedent(config.format(platform=platform)))
    with open(os.path.join(mdir, "1", "model.py"), "w") as f:
        f.write(textwrap.dedent(_MODEL_PY[which].format(wait=wait,
                                                        seen=seen)))
    return mdir


class TestWarmupOnLoad:
    def test_repository_load_reruns_warmup(self):
        counts = []
        for which, registry_cls, harness_cls in _packages():
            registry = registry_cls()
            model, calls = _warm_model(which, "rewarm")
            registry.register_model(model)
            with harness_cls(registry) as h:
                n = [len(calls)]
                with thttp.InferenceServerClient(h.http_url) as client:
                    client.unload_model("rewarm")
                    client.load_model("rewarm")
                    n.append(len(calls))
                    assert client.is_model_ready("rewarm")
            counts.append(n)
        assert counts[0] == counts[1] == [3, 6]

    def test_failing_warmup_fails_load_but_not_server(self, tmp_path):
        messages = []
        for which, registry_cls, harness_cls in _packages():
            root = tmp_path / which
            _write_model(root, which, "badwarm", _BAD_WARM)
            registry = registry_cls(repository_path=str(root))
            _register_zoo(which, registry)
            with harness_cls(registry) as h, \
                    thttp.InferenceServerClient(h.http_url) as client:
                with pytest.raises(InferenceServerException,
                                   match="warmup failed") as e:
                    client.load_model("badwarm")
                assert client.is_server_live()
                assert client.is_server_ready()  # never left LOADING
                assert not client.is_model_ready("badwarm")
                assert client.is_model_ready("simple")
                index = {r["name"]: r["state"]
                         for r in client.get_model_repository_index()}
                assert index["badwarm"] == "UNAVAILABLE"
            messages.append(e.value.message().replace(str(root), "ROOT"))
        assert messages[0] == messages[1]

    def test_input_data_file_resolves_in_model_dir(self, tmp_path):
        seen = {}
        for which, registry_cls, harness_cls in _packages():
            root = tmp_path / which
            log = str(tmp_path / f"{which}.log")
            mdir = _write_model(root, which, "filewarm", _FILE_WARM,
                                seen=log)
            os.makedirs(os.path.join(mdir, "warmup"))
            np.arange(4, dtype=np.float32).tofile(
                os.path.join(mdir, "warmup", "x.bin"))
            registry = registry_cls(repository_path=str(root))
            with harness_cls(registry) as h, \
                    thttp.InferenceServerClient(h.http_url) as client:
                client.load_model("filewarm")
                assert client.is_model_ready("filewarm")
            with open(log) as f:
                seen[which] = f.read()
        assert seen["port"] == seen["ref"] == "[[0.0, 1.0, 2.0, 3.0]]\n"

    def test_loading_for_the_whole_warmup(self, tmp_path):
        """While the warmup runs, the name reads LOADING and neither the
        model nor the server is ready, in both packages; once it ends, both
        are."""
        readings = {}
        for which, registry_cls, harness_cls in _packages():
            root = tmp_path / which
            gate = str(tmp_path / f"{which}.go")
            _write_model(root, which, "filewarm", _FILE_WARM, wait=gate)
            mdir = os.path.join(str(root), "filewarm")
            os.makedirs(os.path.join(mdir, "warmup"))
            np.zeros(4, np.float32).tofile(
                os.path.join(mdir, "warmup", "x.bin"))
            registry = registry_cls(repository_path=str(root))
            with harness_cls(registry) as h, \
                    thttp.InferenceServerClient(h.http_url) as client, \
                    thttp.InferenceServerClient(h.http_url) as loader:
                box = {}
                t = threading.Thread(
                    target=lambda: box.setdefault(
                        "r", loader.load_model("filewarm")), daemon=True)
                t.start()
                end = time.monotonic() + 30
                while True:
                    state = {r["name"]: r["state"] for r in
                             client.get_model_repository_index()}
                    if state.get("filewarm") == "LOADING":
                        break
                    assert time.monotonic() < end, state
                    time.sleep(0.01)
                during = (client.is_server_ready(),
                          client.is_model_ready("filewarm"))
                open(gate, "w").close()
                t.join(timeout=30)
                after = (client.is_server_ready(),
                         client.is_model_ready("filewarm"),
                         {r["name"]: r["state"] for r in
                          client.get_model_repository_index()}["filewarm"])
            readings[which] = (during, after)
        assert readings["port"] == readings["ref"] == (
            (False, False), (True, True, "READY"))
