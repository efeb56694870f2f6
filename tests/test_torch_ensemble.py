"""The port's ``ensemble_llama`` chain and BYTES tensors against the JAX
package's.

Both packages' in-process servers run ``llama_preprocess`` -> ``llama_tpu``
(tiny preset, the reference's ``init_params(PRNGKey(3))`` weights carried
to the port as numpy arrays) -> ``llama_postprocess`` under
``ensemble_llama``, and the reference's own HTTP client sends both the same
``TEXT``.  ``OUT_TEXT`` and ``NEXT_TOKEN`` must be equal: exact, no
tolerance (the token is an argmax of bf16 logits that agree within 5e-2,
test_torch_models.py; on these texts the two packages picked the same token
every time).  BYTES tensors go both ways as JSON (UTF-8 strings) and as
binary data (``<u32 length><bytes>`` per element), and the port's codec is
held byte for byte to the reference's.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from triton_client_tpu import http as httpclient
from triton_client_tpu import utils as jutils
from triton_client_tpu.models import language as jlang
from triton_client_tpu.models import transformer as jtr
from triton_client_tpu.server import model as jmodel
from triton_client_tpu.server.registry import ModelRegistry as JaxRegistry
from triton_client_tpu.server.testing import ServerHarness as JaxHarness
from triton_client_tpu_torch import utils as tutils
from triton_client_tpu_torch.models import language as tlang
from triton_client_tpu_torch.server import model as tmodel
from triton_client_tpu_torch.server.registry import ModelRegistry
from triton_client_tpu_torch.server.testing import ServerHarness

TEXTS = [b"the quick brown fox", "héllo wörld".encode(), b"",
         b"x" * 300]
NON_UTF8 = b"\xff\xfe\x00abc\x80"


def _echo_fn(inputs, params):
    return {"OUT": np.asarray(inputs["IN"])}


def _bad_ensembles(mod):
    """Two broken ensembles over llama_preprocess, built with ``mod``'s own
    config API: a step whose input is never produced, and a step mapping a
    member output the member does not produce."""
    def steps_of(cfg, steps):
        if mod is jmodel:
            for name, imap, omap in steps:
                step = cfg.ensemble_scheduling.step.add()
                step.model_name = name
                step.input_map.update(imap)
                step.output_map.update(omap)
            return cfg
        cfg.ensemble_scheduling = [mod.EnsembleStep(*s) for s in steps]
        return cfg

    def cfg(name):
        return mod.make_config(
            name, inputs=[("TEXT", "BYTES", [1])],
            outputs=[("TOKENS", "INT32", [tlang.LLAMA_SEQ_LEN])],
            max_batch_size=8, platform="ensemble", backend="")

    return [
        mod.EnsembleModel(steps_of(cfg("ens_missing"), [
            ("llama_preprocess", {"TEXT": "_nowhere"},
             {"TOKENS": "TOKENS"})])),
        mod.EnsembleModel(steps_of(cfg("ens_noout"), [
            ("llama_preprocess", {"TEXT": "TEXT"}, {"NOPE": "TOKENS"})])),
    ]


def _echo(mod):
    cfg = mod.make_config("bytes_echo", inputs=[("IN", "BYTES", [-1])],
                          outputs=[("OUT", "BYTES", [-1])])
    return mod.PyModel(cfg, _echo_fn)


@pytest.fixture(scope="module")
def servers():
    jreg = JaxRegistry()
    for m in (jlang.make_llama_preprocess(), jlang.make_llama_tpu(),
              jlang.make_llama_postprocess(), jlang.make_ensemble_llama(),
              _echo(jmodel), *_bad_ensembles(jmodel)):
        jreg.register_model(m)
    weights = {k: np.asarray(v) for k, v in jtr.init_params(
        jax.random.PRNGKey(3), jlang._llama_cfg()).items()}
    treg = ModelRegistry()
    for m in (tlang.make_llama_preprocess(),
              tlang.make_llama_tpu("cpu", params=weights),
              tlang.make_llama_postprocess(), tlang.make_ensemble_llama(),
              _echo(tmodel), *_bad_ensembles(tmodel)):
        treg.register_model(m)
    with JaxHarness(jreg) as jh, ServerHarness(treg) as th:
        yield jh, th, weights


def _ensemble(url, texts, binary):
    """One ensemble_llama request; TEXT and NEXT_TOKEN in JSON or binary,
    OUT_TEXT always binary (a byte >= 0x80 is not UTF-8, which JSON
    cannot carry)."""
    with httpclient.InferenceServerClient(url) as c:
        inp = httpclient.InferInput("TEXT", [len(texts), 1], "BYTES")
        inp.set_data_from_numpy(np.array(texts, dtype=object).reshape(-1, 1),
                                binary_data=binary)
        outs = [httpclient.InferRequestedOutput("OUT_TEXT", binary_data=True),
                httpclient.InferRequestedOutput("NEXT_TOKEN",
                                                binary_data=binary)]
        r = c.infer("ensemble_llama", [inp], outputs=outs)
        return np.asarray(r.as_numpy("OUT_TEXT")), \
            np.asarray(r.as_numpy("NEXT_TOKEN"))


@pytest.mark.parametrize("binary", [False, True], ids=["json", "binary"])
def test_ensemble_llama_matches_jax_server(servers, binary):
    jh, th, _ = servers
    texts = TEXTS + ([NON_UTF8] if binary else [])
    want_text, want_tok = _ensemble(jh.http_url, texts, binary)
    got_text, got_tok = _ensemble(th.http_url, texts, binary)
    assert got_tok.dtype == np.int32 and got_tok.shape == (len(texts), 1)
    assert got_text.shape == (len(texts), 1)
    np.testing.assert_array_equal(got_tok, want_tok)
    assert got_text.tolist() == want_text.tolist()
    assert [bytes(t) for t in got_text[:, 0]] == \
        [bytes([int(t) % 256]) for t in got_tok[:, 0]]


def test_ensemble_matches_its_steps_run_by_hand(servers):
    """The ensemble's answer is llama_tpu's on preprocess's tokens."""
    _, th, _ = servers
    text, tok = _ensemble(th.http_url, [b"hello"], binary=True)
    tokens = np.zeros((1, tlang.LLAMA_SEQ_LEN), np.int32)
    tokens[0, -5:] = np.frombuffer(b"hello", np.uint8)
    with httpclient.InferenceServerClient(th.http_url) as c:
        inp = httpclient.InferInput("TOKENS", [1, tlang.LLAMA_SEQ_LEN],
                                    "INT32")
        inp.set_data_from_numpy(tokens)
        want = c.infer("llama_tpu", [inp]).as_numpy("NEXT_TOKEN")
    np.testing.assert_array_equal(tok, want)


def _get(url, path):
    with urllib.request.urlopen(f"http://{url}{path}") as r:
        return json.loads(r.read())


def test_ensemble_config_and_metadata_match_jax_server(servers):
    jh, th, _ = servers
    for path in ("/v2/models/ensemble_llama/config",
                 "/v2/models/ensemble_llama"):
        assert _get(th.http_url, path) == _get(jh.http_url, path), path
    for name in ("llama_preprocess", "llama_postprocess"):
        t, j = (_get(u, f"/v2/models/{name}/config")
                for u in (th.http_url, jh.http_url))
        for key in ("name", "max_batch_size", "input", "output"):
            assert t[key] == j[key], (name, key)
        assert "dynamic_batching" not in t and "dynamic_batching" not in j


def test_concurrent_ensemble_requests_coalesce_on_llama_tpu(servers):
    """8 concurrent ensemble requests reach llama_tpu through its dynamic
    batcher and run in fewer executions than requests.  Each answer is the
    port's forward of that text alone: its token the argmax, or within the
    bf16 bound 5e-2 of the max (a batch of 8 may round a near tie the other
    way; "request number 4" has top logits 4.3e-3 apart).  llama_tpu's
    queue window is widened from 2 ms to 2 s on a fresh server so that the
    coalescing does not depend on how fast this host starts 8 threads."""
    _, _, weights = servers
    llama = tlang.make_llama_tpu("cpu", params=weights)
    llama.config.max_queue_delay_microseconds = 2_000_000
    reg = ModelRegistry()
    pre = tlang.make_llama_preprocess()
    for m in (pre, llama, tlang.make_llama_postprocess(),
              tlang.make_ensemble_llama()):
        reg.register_model(m)
    texts = [f"request number {i}".encode() for i in range(8)]
    results = [None] * 8
    with ServerHarness(reg) as h:
        start = threading.Barrier(8)

        def one(i):
            start.wait(timeout=30)
            results[i] = _ensemble(h.http_url, [texts[i]], True)

        threads = [threading.Thread(target=one, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    assert llama.stats.batch_size_total == 8
    assert 1 <= llama.stats.batch_execution_count < 8
    for text, (out_text, tok) in zip(texts, results):
        tokens = pre.execute({"TEXT": np.array([[text]], dtype=object)},
                             {})["TOKENS"]
        with torch.inference_mode():
            logits = llama.transformer(torch.from_numpy(tokens))[0, -1]
        t = int(tok[0, 0])
        assert logits[t] >= logits.max() - 5e-2, (text, t)
        assert out_text.tolist() == [[bytes([t % 256])]]


def _post(url, model, body):
    req = urllib.request.Request(
        f"http://{url}/v2/models/{model}/infer",
        data=json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("model,message", [
    ("ens_missing",
     "ensemble 'ens_missing': tensor(s) _nowhere are never produced"),
    ("ens_noout",
     "ensemble 'ens_noout': step 'llama_preprocess' did not produce 'NOPE'"),
])
def test_ensemble_errors_match_jax_server(servers, model, message):
    jh, th, _ = servers
    body = {"inputs": [{"name": "TEXT", "datatype": "BYTES", "shape": [1, 1],
                        "data": ["hi"]}]}
    got, want = _post(th.http_url, model, body), _post(jh.http_url, model,
                                                       body)
    assert got[0] == want[0] == 400
    assert got[1]["error"] == want[1]["error"] == message


def test_ensemble_without_steps_is_refused():
    cfg = tmodel.make_config("e", inputs=[("A", "INT32", [1])],
                             outputs=[("A", "INT32", [1])],
                             platform="ensemble", backend="")
    with pytest.raises(tmodel.InferError, match="no ensemble_scheduling"):
        tmodel.EnsembleModel(cfg)


# ---------------------------------------------------------------------------
# BYTES tensors
# ---------------------------------------------------------------------------

_CODEC_CASES = {
    "empty-strings": np.array([b"", b"", b""], dtype=object),
    "non-utf8": np.array([NON_UTF8, b"\x00" * 5, b"ok"], dtype=object),
    "2x3": np.array([[b"a", b"", b"ccc"], [b"\xc3\xa9", b"x" * 70000,
                                           b"\xff"]], dtype=object),
    "str-elements": np.array(["hé", "", "abc"], dtype=object),
    "S-dtype": np.array([b"ab", b"c"], dtype="S2"),
}


@pytest.mark.parametrize("name", sorted(_CODEC_CASES))
def test_bytes_codec_matches_reference(name):
    arr = _CODEC_CASES[name]
    got = tutils.serialize_byte_tensor(arr)
    want = jutils.serialize_byte_tensor(arr)
    assert got.dtype == want.dtype == np.uint8
    assert got.tobytes() == want.tobytes()
    back = tutils.deserialize_bytes_tensor(got.tobytes())
    assert back.dtype == np.object_ and back.shape == (arr.size,)
    assert back.tolist() == jutils.deserialize_bytes_tensor(
        want.tobytes()).tolist()
    assert back.tolist() == [x.encode() if isinstance(x, str) else bytes(x)
                             for x in arr.reshape(-1)]


def test_bytes_codec_edges():
    empty = np.array([], dtype=object)
    assert tutils.serialize_byte_tensor(empty).shape == (0,)
    assert tutils.serialize_byte_tensor(empty).dtype == \
        jutils.serialize_byte_tensor(empty).dtype
    buf = tutils.serialize_byte_tensor_raw(np.array([b"ab", b"c"],
                                                    dtype=object))
    assert tutils.deserialize_bytes_tensor(bytes(buf)).tolist() == \
        [b"ab", b"c"]
    for cut in (3, len(buf) - 1):
        with pytest.raises(ValueError, match="unexpected end"):
            tutils.deserialize_bytes_tensor(bytes(buf[:cut]))
    with pytest.raises(ValueError, match="invalid datatype"):
        tutils.serialize_byte_tensor_raw(np.array([1, 2], np.int32))


def _echo_request(url, arr, binary_in, binary_out):
    with httpclient.InferenceServerClient(url) as c:
        inp = httpclient.InferInput("IN", list(arr.shape), "BYTES")
        inp.set_data_from_numpy(arr, binary_data=binary_in)
        out = httpclient.InferRequestedOutput("OUT", binary_data=binary_out)
        r = c.infer("bytes_echo", [inp], outputs=[out])
        return r.get_output("OUT"), np.asarray(r.as_numpy("OUT"))


@pytest.mark.parametrize("binary_in", [False, True], ids=["in-json",
                                                         "in-binary"])
@pytest.mark.parametrize("binary_out", [False, True], ids=["out-json",
                                                          "out-binary"])
def test_bytes_tensors_both_ways_match_jax_server(servers, binary_in,
                                                  binary_out):
    jh, th, _ = servers
    arr = np.array(["héllo".encode(), b"", b"abc"], dtype=object)
    if binary_in and binary_out:
        arr = np.append(arr, np.array([NON_UTF8], dtype=object))
    got_meta, got = _echo_request(th.http_url, arr, binary_in, binary_out)
    want_meta, want = _echo_request(jh.http_url, arr, binary_in, binary_out)
    assert got_meta == want_meta
    assert got.tolist() == want.tolist() == arr.tolist()


def test_non_utf8_bytes_output_in_json_fails_like_jax_server(servers):
    jh, th, _ = servers
    arr = np.array([NON_UTF8], dtype=object)
    codes = []
    for url in (th.http_url, jh.http_url):
        with pytest.raises(Exception) as e:
            _echo_request(url, arr, binary_in=True, binary_out=False)
        codes.append(str(e.value))
    assert all("utf-8" in c for c in codes), codes


def test_malformed_binary_bytes_input_is_a_400(servers):
    _, th, _ = servers
    header = json.dumps({"inputs": [{
        "name": "IN", "datatype": "BYTES", "shape": [1],
        "parameters": {"binary_data_size": 6}}]}).encode()
    req = urllib.request.Request(
        f"http://{th.http_url}/v2/models/bytes_echo/infer",
        data=header + b"\x09\x00\x00\x00ab",
        headers={"Inference-Header-Content-Length": str(len(header))})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req)
    assert e.value.code == 400
    assert "malformed BYTES payload" in json.loads(e.value.read())["error"]
