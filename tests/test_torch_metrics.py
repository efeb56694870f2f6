"""``/metrics`` of the port's server against the JAX package's, on the CPU.

For the same traffic (``simple``, the batched ``dense_tpu`` and the tiny
``longctx_tpu``, by HTTP and gRPC) on both servers:

* the family names are equal, less the one listed set of families whose
  source is not ported (``metrics.UNPORTED_FAMILIES``, each with its
  ROADMAP item), every one of which the reference does declare;
* each family's label keys, HELP-less shape and type are equal, and so are
  the per-model counter values the traffic fixes (successes, inferences,
  executions, batch sizes, tick rows);
* every line parses as the Prometheus text exposition format (HELP and
  TYPE before a family's samples, label values escaped, numeric values);
* the JSON ``snapshot`` holds the same families and samples as the text;
* the ``--metrics-port`` listener serves ``/metrics`` and the debug
  snapshots and nothing else.
"""

import json
import re
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax

from triton_client_tpu import _telemetry as jtel
from triton_client_tpu.models import language as jlang
from triton_client_tpu.models import transformer as jtr
from triton_client_tpu.models import zoo as jzoo
from triton_client_tpu.server import metrics as jmetrics
from triton_client_tpu.server.registry import ModelRegistry as JaxRegistry
from triton_client_tpu.server.testing import ServerHarness as JaxHarness
from triton_client_tpu_torch import _telemetry as ttel
from triton_client_tpu_torch import grpc as tgrpc
from triton_client_tpu_torch import http as thttp
from triton_client_tpu_torch.models import language as tlang
from triton_client_tpu_torch.models import zoo as tzoo
from triton_client_tpu_torch.server import metrics as tmetrics
from triton_client_tpu_torch.server.http_server import MetricsServer
from triton_client_tpu_torch.server.registry import ModelRegistry
from triton_client_tpu_torch.server.testing import ServerHarness, free_port

S = 512

_SAMPLE = re.compile(
    r'(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>(?:[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*",?)*)\})?'
    r' (?P<value>\S+)')
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text):
    """{family: {"type", "help", "samples": [(labels, value)]}}; raises on
    a line that is not the text exposition format."""
    families = {}
    current = None
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# HELP "):
            name, _, help_text = line[7:].partition(" ")
            assert name not in families, f"family {name} twice"
            families[name] = {"help": help_text, "type": None,
                              "samples": []}
            current = name
        elif line.startswith("# TYPE "):
            name, _, kind = line[7:].partition(" ")
            assert name == current and kind in ("counter", "gauge"), line
            families[name]["type"] = kind
        else:
            m = _SAMPLE.fullmatch(line)
            assert m is not None, f"not a sample: {line!r}"
            assert m["name"] == current, f"{line!r} outside its family"
            assert families[current]["type"] is not None
            labels = dict(_LABEL.findall(m["labels"] or ""))
            families[current]["samples"].append((labels, float(m["value"])))
    return families


def _infer(url, model, arrays, grpc=False):
    mod = tgrpc if grpc else thttp
    with mod.InferenceServerClient(url) as c:
        ins = []
        for name, dt, arr in arrays:
            i = mod.InferInput(name, list(arr.shape), dt)
            i.set_data_from_numpy(arr)
            ins.append(i)
        c.infer(model, ins)


@pytest.fixture(scope="module")
def scraped():
    jreg = JaxRegistry()
    for m in (jzoo.make_simple(), jlang.make_longctx_tpu(),
              jzoo.make_dense_tpu()):
        jreg.register_model(m)
    longctx = {k: np.asarray(v) for k, v in jtr.init_params(
        jax.random.PRNGKey(11), jlang.longctx_cfg()).items()}
    treg = ModelRegistry()
    for m in (tzoo.make_simple(), tlang.make_longctx_tpu("cpu",
                                                         params=longctx),
              tzoo.make_dense_tpu("cpu")):
        treg.register_model(m)
    rng = np.random.default_rng(8)
    a = rng.integers(-9, 9, (1, 16)).astype(np.int32)
    traffic = [("simple", [("INPUT0", "INT32", a), ("INPUT1", "INT32", a)],
                False),
               ("simple", [("INPUT0", "INT32", a), ("INPUT1", "INT32", a)],
                True),
               ("dense_tpu", [("INPUT", "FP32", rng.standard_normal(
                   (5, 512)).astype(np.float32))], False),
               ("longctx_tpu", [("TOKENS", "INT32", rng.integers(
                   0, 256, (2, S)).astype(np.int32))], True)]
    out = {}
    with JaxHarness(jreg) as jh, ServerHarness(treg) as th:
        for pkg, h in (("jax", jh), ("port", th)):
            for model, arrays, grpc in traffic:
                _infer(h.http_url, model, arrays, grpc)
            text = urllib.request.urlopen(
                f"http://{h.http_url}/metrics").read().decode()
            out[pkg] = {"text": text, "core": h.core,
                        "snapshot": (tmetrics if pkg == "port"
                                     else jmetrics).snapshot(h.core)}
        yield out


def test_every_line_parses_as_prometheus_text(scraped):
    for pkg in ("port", "jax"):
        families = parse_prometheus(scraped[pkg]["text"])
        assert families
        for name, fam in families.items():
            assert fam["help"] and fam["type"], name


def test_family_names_equal_less_the_unported_set(scraped):
    port = set(parse_prometheus(scraped["port"]["text"]))
    ref = set(parse_prometheus(scraped["jax"]["text"]))
    unported = set(tmetrics.UNPORTED_FAMILIES)
    assert port == ref - unported
    # absent, not zero: no unported family appears on the port
    assert not port & unported


def test_every_unported_family_is_the_reference_s():
    import inspect

    source = inspect.getsource(jmetrics)
    for name, item in tmetrics.UNPORTED_FAMILIES.items():
        assert f'"{name}"' in source, name
        assert item.startswith(("A6b", "A7")), (name, item)


def test_response_cache_families_are_the_reference_s(scraped):
    """The response cache's three families, ported with it: declared with
    the reference's help and type, empty where no model caches, in the
    text and the snapshot (``tests/test_torch_response_cache.py`` holds
    their values under traffic)."""
    assert tmetrics.UNPORTED_FAMILIES == {}
    port = parse_prometheus(scraped["port"]["text"])
    ref = parse_prometheus(scraped["jax"]["text"])
    for name in ("nv_cache_num_hits_per_model",
                 "nv_cache_num_misses_per_model",
                 "nv_cache_num_evictions_per_model"):
        assert port[name] == ref[name], name
        assert port[name]["samples"] == []
        snap = scraped["port"]["snapshot"][name]
        assert (snap["help"], snap["type"], snap["samples"]) == (
            ref[name]["help"], ref[name]["type"], [])


def test_label_keys_and_types_match_reference(scraped):
    port = parse_prometheus(scraped["port"]["text"])
    ref = parse_prometheus(scraped["jax"]["text"])
    for name, fam in port.items():
        assert fam["type"] == ref[name]["type"], name
        pk = {tuple(sorted(labels)) for labels, _ in fam["samples"]}
        rk = {tuple(sorted(labels)) for labels, _ in ref[name]["samples"]}
        # a family the traffic leaves empty on one side only (the
        # reference's transfer counters: its CPU arrays drain through
        # copy_to_host_async; the port's CPU outputs need no readback)
        if pk and rk:
            assert pk == rk, name


_FIXED = ("nv_inference_request_success", "nv_inference_count",
          "nv_inference_exec_count", "nv_inference_batch_size_total",
          "nv_inference_batch_execution_count",
          "nv_inference_request_failure",
          "nv_inference_pending_request_count", "nv_tpu_tick_total",
          "nv_tpu_tick_batch_total", "nv_tpu_tick_padded_total",
          "nv_tpu_pad_waste_ratio", "nv_tpu_compile_total",
          "nv_tpu_jit_cache_hit_total", "nv_slo_burn_threshold")


def test_counter_values_the_traffic_fixes_match_reference(scraped):
    port = parse_prometheus(scraped["port"]["text"])
    ref = parse_prometheus(scraped["jax"]["text"])
    for name in _FIXED:
        key = sorted
        assert key(port[name]["samples"], key=repr) == \
            key(ref[name]["samples"], key=repr), name
    success = {labels["model"]: v for labels, v in
               port["nv_inference_request_success"]["samples"]}
    assert success == {"simple": 2, "dense_tpu": 5, "longctx_tpu": 2}


def test_snapshot_holds_the_text_s_families(scraped):
    text = parse_prometheus(scraped["port"]["text"])
    snap = scraped["port"]["snapshot"]
    assert set(snap) == set(text)
    for name, fam in snap.items():
        assert fam["type"] == text[name]["type"]
        assert fam["help"] == text[name]["help"]
    assert json.dumps(snap)


@pytest.mark.parametrize("value", ['plain', 'a"b', "back\\slash",
                                   "new\nline", ""])
def test_label_escaping_matches_reference(value):
    assert ttel.escape_label(value) == jtel.escape_label(value)
    line = f'm{{model="{ttel.escape_label(value)}"}} 1'
    assert _SAMPLE.fullmatch(line)


def test_metrics_port_serves_metrics_and_debug_only(scraped):
    core = scraped["port"]["core"]
    port = free_port()
    srv = MetricsServer(core, "127.0.0.1", port)
    import threading

    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{port}"
        text = urllib.request.urlopen(base + "/metrics").read().decode()
        assert set(parse_prometheus(text)) == \
            set(parse_prometheus(scraped["port"]["text"]))
        for path in ("/v2/debug/flight_recorder", "/v2/debug/device_stats",
                     "/v2/debug/costs"):
            assert json.loads(urllib.request.urlopen(base + path).read())
        for path in ("/v2/health/ready", "/v2/trace/setting"):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(base + path)
            assert e.value.code == 404
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)


def test_cache_and_fault_families_render_as_reference():
    """The nine families of the prefix/KV cache and device faults: the
    same calls on both packages' stores and fault managers give the same
    names, types and samples on ``/metrics``."""
    import torch

    from triton_client_tpu.server import kvcache as jkv
    from triton_client_tpu_torch.server import kvcache as tkv

    names = ("nv_cache_hit_total", "nv_cache_miss_total",
             "nv_cache_evict_total", "nv_cache_hit_tokens_total",
             "nv_cache_pinned_bytes", "nv_device_fault_total",
             "nv_device_recovered_sequences_total",
             "nv_device_aborted_sequences_total", "nv_device_quarantine")
    out = {}
    for pkg, kv, leaf, harness, reg in (
            ("port", tkv, lambda n: torch.zeros(n, dtype=torch.uint8),
             ServerHarness, ModelRegistry),
            ("jax", jkv, lambda n: np.zeros(n, np.uint8), JaxHarness,
             JaxRegistry)):
        store = kv.for_model("metrics_kv_m", budget_bytes=40,
                             block_tokens=4)
        try:
            toks = np.arange(9, dtype=np.int32)
            digs = store.chain_digests(toks)
            for i, d in enumerate(digs):
                store.put(d, digs[i - 1] if i else b"", leaf(8), leaf(8))
            _hit, blocks, _ = store.match(toks)
            store.release(blocks)
            store.match(np.full(9, 5, np.int32))
            store.put(b"x", b"", leaf(8), leaf(8))
            with harness(reg()) as h:
                f = h.core.device_faults
                f.record_fault("metrics_f_m", "step")
                f.record_fault("metrics_f_m", "tick_stall",
                               force_quarantine=True)
                f.record_recovered("metrics_f_m", 2)
                f.record_aborted("metrics_f_m")
                fams = parse_prometheus(urllib.request.urlopen(
                    f"http://{h.http_url}/metrics").read().decode())
                f.unquarantine("metrics_f_m")
            out[pkg] = {n: (fams[n]["type"], fams[n]["help"], sorted(
                (sorted(lb.items()), v) for lb, v in fams[n]["samples"]
                if lb.get("model") in ("metrics_kv_m", "metrics_f_m")))
                for n in names}
        finally:
            kv.drop("metrics_kv_m")
    assert out["port"] == out["jax"]
    assert all(out["port"][n][2] for n in names), out["port"]
    assert not set(names) & set(tmetrics.UNPORTED_FAMILIES)


def test_host_and_otlp_families_render_as_reference(tmp_path):
    """The six families that left ``UNPORTED_FAMILIES`` with the host
    profiler, the incident bundles and OTLP export: on both servers, after
    the same manual bundle and with an exporter set, the same names, types
    and label keys, and the same incident counts and OTLP samples; the
    OTLP families are absent (not zero) without an exporter."""
    names = ("nv_host_loop_lag_us", "nv_host_gc_pause_us_total",
             "nv_host_profile_samples_total", "nv_host_incident_total",
             "nv_otlp_export_total", "nv_otlp_dropped_total")
    out = {}
    for pkg, harness, reg in (("port", ServerHarness, ModelRegistry),
                              ("jax", JaxHarness, JaxRegistry)):
        with harness(reg()) as h:
            core = h.core
            inc = core.incidents
            inc.dir = str(tmp_path / pkg)
            inc.profile_window_s, inc.min_interval_s = 0.05, 0.0
            core.profiler._sample_once()
            core.profiler._gc_events.append((2, 1000))
            time.sleep(0.6)  # each lag probe's first wake
            inc.trigger("manual", reason="metrics", sync=True)
            before = parse_prometheus(urllib.request.urlopen(
                f"http://{h.http_url}/metrics").read().decode())
            core.enable_otlp(f"127.0.0.1:{free_port()}", replica="r")
            try:
                fams = parse_prometheus(urllib.request.urlopen(
                    f"http://{h.http_url}/metrics").read().decode())
            finally:
                otlp, core.tracer.otlp = core.tracer.otlp, None
                otlp.shutdown()
        assert not {"nv_otlp_export_total", "nv_otlp_dropped_total"} \
            & set(before)
        out[pkg] = {n: (fams[n]["type"],
                        sorted({tuple(sorted(lb)) for lb, _ in
                                fams[n]["samples"]}),
                        sorted((sorted(lb.items()), v)
                               for lb, v in fams[n]["samples"])
                        if n in ("nv_host_incident_total",
                                 "nv_otlp_export_total",
                                 "nv_otlp_dropped_total") else None)
                    for n in names}
    assert out["port"] == out["jax"]
    assert out["port"]["nv_host_incident_total"][2] == \
        [([("outcome", "written"), ("trigger", "manual")], 1.0)]
    assert not set(names) & set(tmetrics.UNPORTED_FAMILIES)
