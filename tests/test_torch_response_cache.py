"""The port's response cache against the reference's, on the CPU.

The counterpart of ``tests/test_response_cache.py``.  One request script
goes to a server of each package, each serving the same counting models
(a ``PyModel`` of its own package): the answers, the executions, the
hits, misses and evictions, the statistics and the ``nv_cache_*``
families must be the reference's, for repeats, other inputs, other
parameters, a disabled model, a TTL's expiry and a reload.  The cache
objects themselves get the same put / get scripts: the byte budget's LRU,
the refusal of oversize items, replacement, frozen entries.  Bypasses
(sequence, shared memory, inputs over ``MAX_KEY_BYTES``) execute every
time in both.  A BF16 output, a CPU ``torch.bfloat16`` tensor on the port's
side, is cached and answered byte for byte.  The CLI's
``--cache-budget-bytes`` and a repository config's ``response_cache`` and
``response_cache.ttl_s`` are read by a ``--device cpu`` server.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time
import urllib.request

import ml_dtypes
import numpy as np
import pytest
import torch

import triton_client_tpu.http as jhttp
from triton_client_tpu.server import PyModel as JaxPyModel
from triton_client_tpu.server import make_config as jmake_config
from triton_client_tpu.server.core import _ResponseCache as JCache
from triton_client_tpu.server.registry import ModelRegistry as JaxRegistry
from triton_client_tpu.server.testing import ServerHarness as JaxHarness
from triton_client_tpu_torch import http as thttp
from triton_client_tpu_torch.server.core import _ResponseCache as TCache
from triton_client_tpu_torch.server.model import PyModel, make_config
from triton_client_tpu_torch.server.registry import ModelRegistry
from triton_client_tpu_torch.server.testing import ServerHarness, cli_http_port
from triton_client_tpu_torch.utils import shared_memory as tshm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PKGS = {
    "port": (ModelRegistry, ServerHarness, PyModel, make_config, thttp),
    "ref": (JaxRegistry, JaxHarness, JaxPyModel, jmake_config, jhttp),
}


def _counting(pkg, name, cache=True, ttl=None, dtype="FP32", batch=0,
              dims=None):
    """A model of ``pkg`` that adds one and counts its executions."""
    _, _, py_model, mk, _ = _PKGS[pkg]
    calls = []
    dims = dims or ([4] if batch else [1, 4])
    cfg = mk(name, inputs=[("X", dtype, dims)], outputs=[("Y", dtype, dims)],
             max_batch_size=batch, instance_kind="KIND_CPU",
             max_queue_delay_us=100 if batch else 0, response_cache=cache,
             parameters=({"response_cache.ttl_s": ttl}
                         if ttl is not None else None))

    def fn(inputs, params):
        calls.append(1)
        return {"Y": inputs["X"] + 1}

    return py_model(cfg, fn), calls


@pytest.fixture(scope="module")
def servers():
    """One server of each package: ``cached``, ``uncached``, ``ttl_model``
    (TTL 0.15 s), ``bf16_cached`` (BF16 in and out), ``batched``
    (max_batch_size 4, through the dynamic batcher) and ``big`` (inputs of
    any length)."""
    out = {}
    for pkg, (registry, harness, *_rest) in _PKGS.items():
        r = registry()
        calls = {}
        for name, kw in (("cached", {}), ("uncached", {"cache": False}),
                         ("ttl_model", {"ttl": "0.15"}),
                         ("bf16_cached", {"dtype": "BF16"}),
                         ("batched", {"batch": 4}),
                         ("big", {"dims": [1, -1]})):
            model, calls[name] = _counting(pkg, name, **kw)
            r.register_model(model)
        h = harness(r).start()
        h.calls = calls
        out[pkg] = h
    yield out
    for h in out.values():
        h.stop()


def _infer(pkg, url, model, x, dtype="FP32", **kw):
    mod = _PKGS[pkg][4]
    inp = mod.InferInput("X", list(x.shape), dtype)
    inp.set_data_from_numpy(x)
    with mod.InferenceServerClient(url) as c:
        return c.infer(model, [inp], **kw).as_numpy("Y")


def _state(h, model):
    """What the script leaves on one server for ``model``."""
    cache = h.core.response_cache
    return {"calls": len(h.calls[model]),
            "hits": cache.hits_by_model.get(model, 0),
            "misses": cache.misses_by_model.get(model, 0),
            "evictions": cache.evictions_by_model.get(model, 0)}


def _cache_lines(url, model):
    text = urllib.request.urlopen(f"http://{url}/metrics",
                                  timeout=10).read().decode()
    return sorted(ln for ln in text.splitlines()
                  if ln.startswith("nv_cache_num_")
                  and f'model="{model}"' in ln)


def _success_counts(pkg, url, model):
    with _PKGS[pkg][4].InferenceServerClient(url) as c:
        s = c.get_inference_statistics(model)["model_stats"][0]
    return (s["inference_stats"]["success"]["count"], s["execution_count"])


# request scripts: (model, input seed, parameters)
_SCRIPTS = {
    "repeats": [("cached", 0, None)] * 3,
    "other-inputs": [("cached", 1, None), ("cached", 2, None),
                     ("cached", 1, None)],
    "other-parameters": [("cached", 3, None), ("cached", 3, {"v": "b"}),
                         ("cached", 3, {"v": "b"}), ("cached", 3, None)],
    "disabled": [("uncached", 4, None)] * 3,
    "batched": [("batched", 5, None)] * 3 + [("batched", 6, None)],
}


@pytest.mark.parametrize("script", sorted(_SCRIPTS))
def test_script_counts_are_the_reference_s(servers, script):
    steps = _SCRIPTS[script]
    models = sorted({m for m, _, _ in steps})
    seen = {}
    for pkg, h in servers.items():
        before = {m: _state(h, m) for m in models}
        stats0 = {m: _success_counts(pkg, h.http_url, m) for m in models}
        answers = []
        for model, seed, params in steps:
            x = np.random.default_rng(seed).random(
                (2, 4) if model == "batched" else (1, 4)).astype(np.float32)
            y = _infer(pkg, h.http_url, model, x, parameters=params)
            np.testing.assert_allclose(y, x + 1, rtol=1e-6)
            answers.append(y.tobytes())
        after = {m: _state(h, m) for m in models}
        stats1 = {m: _success_counts(pkg, h.http_url, m) for m in models}
        seen[pkg] = (answers, {
            m: {k: after[m][k] - before[m][k]
                for k in ("calls", "hits", "misses", "evictions")}
            for m in models},
            {m: (stats1[m][0] - stats0[m][0], stats1[m][1] - stats0[m][1])
             for m in models})
    assert seen["port"] == seen["ref"]
    if script == "repeats":
        # one execution, two hits, all three counted as successes (and in
        # execution_count, as the reference counts them)
        assert seen["port"][1]["cached"] == {
            "calls": 1, "hits": 2, "misses": 1, "evictions": 0}
        assert seen["port"][2]["cached"][0] == 3


def test_metrics_families_are_the_reference_s(servers):
    x = np.full((1, 4), 7, np.float32)
    for pkg, h in servers.items():
        for _ in range(2):
            _infer(pkg, h.http_url, "cached", x)
    assert _cache_lines(servers["port"].http_url, "cached") == \
        _cache_lines(servers["ref"].http_url, "cached")
    assert len(_cache_lines(servers["port"].http_url, "cached")) == 2


def test_ttl_expiry_is_the_reference_s(servers):
    x = np.full((1, 4), 9, np.float32)
    seen = {}
    for pkg, h in servers.items():
        before = _state(h, "ttl_model")
        _infer(pkg, h.http_url, "ttl_model", x)
        _infer(pkg, h.http_url, "ttl_model", x)   # inside the TTL: a hit
        mid = len(h.calls["ttl_model"]) - before["calls"]
        time.sleep(0.2)                            # past the 0.15 s TTL
        _infer(pkg, h.http_url, "ttl_model", x)   # expired: executes
        after = _state(h, "ttl_model")
        seen[pkg] = (mid, {k: after[k] - before[k]
                           for k in ("calls", "hits", "misses",
                                     "evictions")})
    assert seen["port"] == seen["ref"] == (
        1, {"calls": 2, "hits": 1, "misses": 2, "evictions": 1})
    assert _cache_lines(servers["port"].http_url, "ttl_model") == \
        _cache_lines(servers["ref"].http_url, "ttl_model")


def test_reload_invalidates(servers):
    """An unload and a load bump the registry's generation: the entry
    made before misses after, in both."""
    x = np.full((1, 4), 11, np.float32)
    seen = {}
    for pkg, h in servers.items():
        n0 = len(h.calls["cached"])
        _infer(pkg, h.http_url, "cached", x)
        with _PKGS[pkg][4].InferenceServerClient(h.http_url) as c:
            c.unload_model("cached")
            c.load_model("cached")
        _infer(pkg, h.http_url, "cached", x)
        seen[pkg] = len(h.calls["cached"]) - n0
    assert seen == {"port": 2, "ref": 2}


def test_bf16_outputs_are_cached_byte_for_byte(servers):
    """BF16 travels as a CPU ``torch.bfloat16`` tensor in the port: its
    hits answer the miss's bytes, counted as the reference counts them.
    (The two packages' clients read BF16 back differently, as bf16 and as
    f32, and their models add in bf16 and in f32: the values agree to a
    bf16 ulp.)"""
    x = np.random.default_rng(8).random((1, 4)).astype(ml_dtypes.bfloat16)
    seen, values = {}, {}
    for pkg, h in servers.items():
        before = _state(h, "bf16_cached")
        ys = [np.asarray(_infer(pkg, h.http_url, "bf16_cached", x,
                                dtype="BF16")) for _ in range(3)]
        after = _state(h, "bf16_cached")
        seen[pkg] = (len({y.tobytes() for y in ys}),
                     after["calls"] - before["calls"],
                     after["hits"] - before["hits"])
        values[pkg] = ys[0].astype(np.float32)
    assert seen["port"] == seen["ref"] == (1, 1, 2)
    np.testing.assert_allclose(values["port"], values["ref"], atol=2 ** -6)


def test_grpc_hit(servers):
    from triton_client_tpu_torch import grpc as tgrpc

    h = servers["port"]
    x = np.full((1, 4), 13, np.float32)
    n0, hits0 = len(h.calls["cached"]), h.core.response_cache.hits
    with tgrpc.InferenceServerClient(h.http_url) as c:
        for _ in range(2):
            i = tgrpc.InferInput("X", [1, 4], "FP32")
            i.set_data_from_numpy(x)
            np.testing.assert_array_equal(
                c.infer("cached", [i]).as_numpy("Y"), x + 1)
    assert len(h.calls["cached"]) - n0 == 1
    assert h.core.response_cache.hits - hits0 == 1


def test_hit_trace_has_cache_hit_and_no_compute(servers, tmp_path):
    """A hit's trace record: the reference's shape (CACHE_HIT, the QUEUE
    span, no COMPUTE)."""
    x = np.full((1, 4), 17, np.float32)
    shapes = {}
    for pkg, h in servers.items():
        path = str(tmp_path / f"{pkg}.jsonl")
        mod = _PKGS[pkg][4]
        with mod.InferenceServerClient(h.http_url) as c:
            c.update_trace_settings(settings={
                "trace_file": [path], "trace_level": ["TIMESTAMPS"],
                "trace_rate": ["1"]})
        try:
            _infer(pkg, h.http_url, "cached", x)
            _infer(pkg, h.http_url, "cached", x)
            deadline = time.monotonic() + 20
            while True:
                lines = (open(path).read().splitlines()
                         if os.path.exists(path) else [])
                if len(lines) >= 2 or time.monotonic() > deadline:
                    break
                time.sleep(0.02)
        finally:
            with mod.InferenceServerClient(h.http_url) as c:
                c.update_trace_settings(settings={"trace_level": ["OFF"]})
        hit = json.loads(lines[1])
        shapes[pkg] = ([t["name"] for t in hit["timestamps"]],
                       sorted(s["name"] for s in hit["spans"]))
    assert shapes["port"] == shapes["ref"]
    assert "CACHE_HIT" in shapes["port"][0]
    assert "COMPUTE" not in shapes["port"][1]
    assert "QUEUE" in shapes["port"][1]


# -- bypasses -----------------------------------------------------------------

def test_sequence_requests_bypass(servers):
    x = np.full((1, 4), 19, np.float32)
    seen = {}
    for pkg, h in servers.items():
        before = _state(h, "cached")
        for flags in ({"sequence_start": True}, {}, {"sequence_end": True}):
            _infer(pkg, h.http_url, "cached", x, sequence_id=5, **flags)
        after = _state(h, "cached")
        seen[pkg] = {k: after[k] - before[k]
                     for k in ("calls", "hits", "misses")}
    assert seen["port"] == seen["ref"] == {"calls": 3, "hits": 0,
                                           "misses": 0}


def test_oversize_inputs_bypass(servers):
    """Inputs over ``MAX_KEY_BYTES`` are never hashed: each request runs,
    counted neither hit nor miss."""
    n = TCache.MAX_KEY_BYTES // 4 + 1
    assert TCache.MAX_KEY_BYTES == JCache.MAX_KEY_BYTES
    seen = {}
    for pkg, h in servers.items():
        x = np.zeros((1, n), np.float32)
        before = _state(h, "big")
        for _ in range(2):
            _infer(pkg, h.http_url, "big", x)
        after = _state(h, "big")
        seen[pkg] = {k: after[k] - before[k]
                     for k in ("calls", "hits", "misses")}
    assert seen["port"] == seen["ref"] == {"calls": 2, "hits": 0,
                                           "misses": 0}


def test_shared_memory_requests_bypass(servers):
    h = servers["port"]
    x = np.full((1, 4), 23, np.float32)
    key = f"/tctshm_rc_{os.getpid()}"
    region = tshm.create_shared_memory_region("rc_in", key, x.nbytes)
    try:
        tshm.set_shared_memory_region(region, [x])
        with thttp.InferenceServerClient(h.http_url) as c:
            c.register_system_shared_memory("rc_in", key, x.nbytes)
            try:
                before = _state(h, "cached")
                for _ in range(2):
                    i = thttp.InferInput("X", [1, 4], "FP32")
                    i.set_shared_memory("rc_in", x.nbytes)
                    np.testing.assert_array_equal(
                        c.infer("cached", [i]).as_numpy("Y"), x + 1)
                after = _state(h, "cached")
            finally:
                c.unregister_system_shared_memory("rc_in")
    finally:
        tshm.destroy_shared_memory_region(region)
    assert {k: after[k] - before[k] for k in ("calls", "hits", "misses")} \
        == {"calls": 2, "hits": 0, "misses": 0}


# -- the cache object, against the reference's --------------------------------

def _both(budget=None):
    return TCache(budget_bytes=budget), JCache(budget_bytes=budget)


def test_byte_budget_evicts_lru():
    out = []
    for cache in _both(1024):
        a = np.zeros(100, np.float32)  # 400 bytes each
        cache.put(("m", 0, "", "k1"), {"Y": a})
        cache.put(("m", 0, "", "k2"), {"Y": a})
        t2 = cache.total_bytes
        cache.put(("m", 0, "", "k3"), {"Y": a})  # 1200 > the budget
        out.append((t2, cache.total_bytes,
                    cache.get(("m", 0, "", "k1")) is None,
                    cache.get(("m", 0, "", "k2")) is not None,
                    cache.get(("m", 0, "", "k3")) is not None,
                    dict(cache.evictions_by_model)))
    assert out[0] == out[1] == (800, 800, True, True, True, {"m": 1})


def test_entry_count_bound_evicts_lru():
    out = []
    for cache in _both():
        for k in range(cache.MAX_ENTRIES + 3):
            cache.put(("m", 0, "", f"k{k}"), {"Y": np.zeros(2, np.int32)})
        out.append((len(cache._entries), dict(cache.evictions_by_model),
                    cache.get(("m", 0, "", "k0")) is None))
    assert out[0] == out[1] == (64, {"m": 3}, True)


@pytest.mark.parametrize("budget,size",
                         [(100, 100), (None, (8 << 20) // 4 + 1)],
                         ids=["over-the-budget", "over-max-item"])
def test_oversized_entry_never_cached(budget, size):
    out = []
    for cache in _both(budget):
        cache.put(("m", 0, "", "big"), {"Y": np.zeros(size, np.float32)})
        out.append((cache.total_bytes, cache.get(("m", 0, "", "big")),
                    dict(cache.misses_by_model)))
    assert out[0] == out[1] == (0, None, {"m": 1})


def test_replacement_is_not_an_eviction():
    out = []
    for cache in _both():
        a = np.zeros(10, np.float32)
        cache.put(("m", 0, "", "k"), {"Y": a})
        cache.put(("m", 0, "", "k"), {"Y": a + 1})
        out.append((dict(cache.evictions_by_model), cache.total_bytes,
                    cache.get(("m", 0, "", "k"))["Y"].tolist()))
    assert out[0] == out[1] == ({}, 40, [1.0] * 10)


def test_cached_entries_are_frozen_private_copies():
    cache = TCache()
    arr = np.ones((2, 2), np.float32)
    cache.put(("m", 0, "", "k"), {"Y": arr})
    arr[0, 0] = 5.0  # the caller's buffer changes after the put
    hit = cache.get(("m", 0, "", "k"))
    assert hit["Y"][0, 0] == 1.0
    with pytest.raises(ValueError):
        hit["Y"][0, 0] = 99.0
    bf = torch.arange(4, dtype=torch.bfloat16)
    cache.put(("m", 0, "", "b"), {"Y": bf})
    bf += 1
    got = cache.get(("m", 0, "", "b"))["Y"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, torch.arange(4, dtype=torch.bfloat16))
    got += 1  # a hit's tensor is a copy: the entry is untouched
    assert torch.equal(cache.get(("m", 0, "", "b"))["Y"],
                       torch.arange(4, dtype=torch.bfloat16))


def test_device_values_are_never_keyed_or_cached():
    """Only host values key and cache (a tensor on the card would have
    to be read back first); a meta tensor stands in for one here."""
    cache = TCache()
    meta = torch.empty(4, device="meta")
    cache.put(("m", 0, "", "k"), {"Y": meta})
    assert cache.key(None, 0, None, {"X": meta}) is None
    assert cache.total_bytes == 0
    from triton_client_tpu_torch.server.core import _cacheable

    assert _cacheable(np.zeros(2)) is not None
    assert _cacheable(torch.zeros(2)) is not None
    assert _cacheable([1, 2]) is None


def test_config_declares_response_cache_like_the_reference():
    for cache in (False, True):
        port = make_config("m", [("X", "FP32", [4])], [("Y", "FP32", [4])],
                           response_cache=cache).to_json()
        ref = jmake_config("m", [("X", "FP32", [4])], [("Y", "FP32", [4])],
                           response_cache=cache)
        assert port.get("response_cache") == (
            {"enable": True} if ref.HasField("response_cache") else None)


# -- the CLI and a repository config ------------------------------------------

_REPO_MODEL_PY = textwrap.dedent(
    """
    import numpy as np
    from triton_client_tpu_torch.server.model import PyModel


    def get_model(config):
        def fn(inputs, params):
            return {"Y": np.asarray(inputs["X"]) + 1}

        return PyModel(config, fn)
    """)

_REPO_CONFIG = textwrap.dedent(
    """
    name: "{name}"
    backend: "python"
    input [{{ name: "X" data_type: TYPE_FP32 dims: [ {n} ] }}]
    output [{{ name: "Y" data_type: TYPE_FP32 dims: [ {n} ] }}]
    response_cache {{ enable: true }}
    parameters {{ key: "response_cache.ttl_s"
                  value: {{ string_value: "{ttl}" }} }}
    """)


def _metric(text, name, model):
    for ln in text.splitlines():
        if ln.startswith(f'{name}{{model="{model}"}}'):
            return float(ln.rsplit(" ", 1)[1])
    return 0.0


def test_cli_verbose_budget_and_repository_ttl(tmp_path):
    """``-v`` and ``--cache-budget-bytes`` on a ``--device cpu``
    server whose repository's configs enable the cache: a repeat hits; a
    budget under two entries evicts the older; after a model's TTL a
    repeat misses again."""
    root = tmp_path / "repo"
    for name, n, ttl in (("small", 4, "60"), ("short", 4, "0.3")):
        d = root / name
        (d / "1").mkdir(parents=True)
        (d / "config.pbtxt").write_text(
            _REPO_CONFIG.format(name=name, n=n, ttl=ttl))
        (d / "1" / "model.py").write_text(_REPO_MODEL_PY)
    log = open(tmp_path / "server.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "triton_client_tpu_torch.server", "-v",
         "--device", "cpu", "--http-port", "0", "--grpc-port", "0",
         "--metrics-port", "0",
         "--model-repository", str(root), "--cache-budget-bytes", "24"],
        cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
        env=dict(os.environ, PYTHONPATH=REPO))
    try:
        url = f"127.0.0.1:{cli_http_port(proc, tmp_path / 'server.log')}"
        end = time.monotonic() + 120
        while True:
            try:
                urllib.request.urlopen(f"http://{url}/v2/health/ready",
                                       timeout=5)
                break
            except OSError:
                assert proc.poll() is None, (tmp_path / "server.log") \
                    .read_text()
                assert time.monotonic() < end
                time.sleep(0.1)
        with thttp.InferenceServerClient(url) as c:
            assert c.get_model_config("small")["response_cache"] == {
                "enable": True}

            def send(model, v):
                i = thttp.InferInput("X", [4], "FP32")
                i.set_data_from_numpy(np.full(4, v, np.float32))
                np.testing.assert_array_equal(
                    c.infer(model, [i]).as_numpy("Y"), np.full(4, v + 1))

            send("small", 1)
            send("small", 1)        # a hit
            send("small", 2)        # 16 + 16 bytes > 24: the first goes
            send("small", 1)        # evicted: a miss
            send("short", 3)
            time.sleep(0.4)         # past its TTL
            send("short", 3)        # expired: a miss, an eviction
        text = urllib.request.urlopen(f"http://{url}/metrics",
                                      timeout=10).read().decode()
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=30)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    assert proc.returncode == 0
    assert (_metric(text, "nv_cache_num_hits_per_model", "small"),
            _metric(text, "nv_cache_num_misses_per_model", "small")) == (1, 3)
    # the "short" entry evicted a "small" one on its insert (budget)
    assert _metric(text, "nv_cache_num_evictions_per_model", "small") >= 2
    assert (_metric(text, "nv_cache_num_hits_per_model", "short"),
            _metric(text, "nv_cache_num_misses_per_model", "short")) == (0, 2)
