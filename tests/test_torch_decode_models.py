"""The port's ``DecodeModel`` and ``GenerateModel`` against the JAX
package's, on the CPU.

Both packages' models run on the tiny ``llama_tpu`` presets in f32 (both
presets' dtype set to f32 here), the reference's weights
(``init_params(PRNGKey(3))``, ``llama_tpu``'s seed) carried to the port as
numpy, driven the way the server drives them (``_execute``, ``_generate``,
``submit_generation``).  Held: greedy tokens token for token and
``NEXT_LOGIT`` / logprobs to rtol / atol 2e-4, in independent and batched
mode, full and chunked prefill, ``tiny`` and ``tiny-moe``, greedy and
penalized; concurrent sequences and generations (two bucket pools, T = 3)
against serial runs; the sequence protocol's errors with the reference's
statuses and messages; idle eviction; slot exhaustion answered 429;
cancellation freeing the slot; an unloaded model answering 503.  The math
beneath is held in ``tests/test_torch_decode.py``.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from triton_client_tpu.models import decode as jdec
from triton_client_tpu.models import language as jlang
from triton_client_tpu.models import transformer as jtr
from triton_client_tpu.server.types import InferError as JaxInferError
from triton_client_tpu_torch.models import decode as tdec
from triton_client_tpu_torch.models import language as tlang
from triton_client_tpu_torch.server.types import InferError

TOL = dict(rtol=2e-4, atol=2e-4)


PRESET_SEED = 3   # llama_tpu's seed, which the decode models share


@pytest.fixture(params=["tiny", "tiny-moe"])
def preset(monkeypatch, request):
    """Both packages' ``request.param`` preset in f32, selected by
    ``TRITON_TPU_LLAMA_PRESET``; the reference's weights as numpy."""
    return _preset(monkeypatch, request.param)


@pytest.fixture
def tiny(monkeypatch):
    """:func:`preset`'s ``tiny`` alone, for the protocol's cases."""
    return _preset(monkeypatch, "tiny")


def _preset(monkeypatch, name):
    monkeypatch.setitem(jlang._LLAMA_PRESETS, name, dataclasses.replace(
        jlang._LLAMA_PRESETS[name], dtype=jnp.float32))
    monkeypatch.setitem(tlang._LLAMA_PRESETS, name, dataclasses.replace(
        tlang._LLAMA_PRESETS[name], dtype=torch.float32))
    monkeypatch.setenv("TRITON_TPU_LLAMA_PRESET", name)
    cfg = jlang._LLAMA_PRESETS[name]
    jp = jtr.init_params(jax.random.PRNGKey(PRESET_SEED), cfg)
    return {k: np.asarray(v) for k, v in jp.items()}


def _pair(monkeypatch, params, mode, chunk="0", slots="4", tag="",
          s_max=None):
    monkeypatch.setenv("TRITON_TPU_DECODE_MODE", mode)
    monkeypatch.setenv("TRITON_TPU_DECODE_SLOTS", slots)
    monkeypatch.setenv("TRITON_TPU_PREFILL_CHUNK", chunk)
    j = jdec.DecodeModel(name=f"llama_decode_{mode}{tag}", s_max=s_max)
    t = tdec.DecodeModel(name=f"llama_decode_{mode}{tag}", device="cpu",
                         params=params, s_max=s_max)
    return j, t


def _window(text: bytes, S=128):
    out = np.zeros((S,), np.int32)
    b = np.frombuffer(text[-S:], np.uint8)
    out[S - len(b):] = b
    return out


def _closed_loop(m, seq_id, prompt, n):
    """The sequence protocol: prefill, then n steps each fed the last
    token; (tokens, logits)."""
    toks, logits = [], []
    res = m._execute({"TOKENS": _window(prompt)},
                     {"sequence_id": seq_id, "sequence_start": True})
    for i in range(n + 1):
        toks.append(int(res["NEXT_TOKEN"][0]))
        logits.append(float(res["NEXT_LOGIT"][0]))
        if i == n:
            break
        res = m._execute({"TOKENS": res["NEXT_TOKEN"]},
                         {"sequence_id": seq_id, "sequence_end": i == n - 1})
    return toks, logits


@pytest.mark.parametrize("mode,chunk", [("independent", "0"),
                                        ("batched", "0"),
                                        ("batched", "32")],
                         ids=["independent", "batched", "batched-chunk32"])
def test_sequence_protocol_matches_reference(monkeypatch, preset, mode,
                                             chunk):
    j, t = _pair(monkeypatch, preset, mode, chunk)
    try:
        for w, prompt in enumerate([b"the quick brown fox", b"in a hole"]):
            jt, jl = _closed_loop(j, 100 + w, prompt, 5)
            tt, tl = _closed_loop(t, 100 + w, prompt, 5)
            assert tt == jt
            np.testing.assert_allclose(tl, jl, **TOL)
    finally:
        j._shutdown()
        t._shutdown()


def test_concurrent_sequences_match_serial_batched(monkeypatch, tiny):
    """Three closed loops at once through the port's slot batcher give the
    reference's serial tokens."""
    j, t = _pair(monkeypatch, tiny, "batched")
    try:
        prompts = {w: f"batched worker {w}".encode() for w in range(3)}
        want = {w: _closed_loop(j, 3100 + w, p, 4)[0]
                for w, p in prompts.items()}
        got, errors = {}, []

        def worker(w):
            try:
                got[w] = _closed_loop(t, 3200 + w, prompts[w], 4)[0]
            except Exception as exc:  # noqa: BLE001 - reported below
                errors.append((w, exc))

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in prompts]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not errors, errors
        assert got == want
    finally:
        j._shutdown()
        t._shutdown()


def _gen_tokens(g, prompt, n, **params):
    frames = list(g._generate({"text_input": np.array([prompt], object)},
                              {"max_tokens": n, **params}))
    return ([int(f["token_id"][0]) for f in frames],
            [float(f["logprob"][0]) for f in frames],
            [bytes(f["text_output"][0]) for f in frames])


@pytest.mark.parametrize("params", [{}, {"presence_penalty": -1.2,
                                         "frequency_penalty": 0.7}],
                         ids=["greedy", "penalties"])
@pytest.mark.parametrize("mode", ["independent", "batched"])
def test_generate_matches_reference(monkeypatch, preset, mode, params):
    """llama_generate's tokens, logprobs and text chunks as the
    reference's, greedy and penalized, in both modes (batched mode rides
    the worker's tick)."""
    j, t = _pair(monkeypatch, preset, mode, chunk="32")
    try:
        jg = jdec.GenerateModel(j, name="llama_generate_x")
        tg = tdec.GenerateModel(t, name="llama_generate_x")
        for prompt in (b"generate me please", b"\x00\x01 ids"):
            want = _gen_tokens(jg, prompt, 9, **params)
            got = _gen_tokens(tg, prompt, 9, **params)
            assert got[0] == want[0]
            assert got[2] == want[2]
            np.testing.assert_allclose(got[1], want[1], **TOL)
    finally:
        j._shutdown()
        t._shutdown()


def test_batched_generation_matches_independent_chain(monkeypatch, tiny):
    """Concurrent batched generations (two bucket pools, T = 3) equal the
    port's own independent chains."""
    monkeypatch.setenv("TRITON_TPU_DECODE_STEPS", "3")
    monkeypatch.setenv("TRITON_TPU_DECODE_BUCKETS", "2x160,2x256")
    _, tb = _pair(monkeypatch, tiny, "batched", tag="b")
    monkeypatch.delenv("TRITON_TPU_DECODE_BUCKETS")
    _, ti = _pair(monkeypatch, tiny, "independent", tag="i")
    try:
        gb = tdec.GenerateModel(tb)
        gi = tdec.GenerateModel(ti)
        jobs = {w: (f"concurrent gen {w}".encode(), 5 + 7 * w)
                for w in range(4)}
        want = {w: _gen_tokens(gi, p, n)[0] for w, (p, n) in jobs.items()}
        got, errors = {}, []

        def worker(w):
            try:
                got[w] = _gen_tokens(gb, *jobs[w])[0]
            except Exception as exc:  # noqa: BLE001 - reported below
                errors.append((w, exc))

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in jobs]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not errors, errors
        assert got == want
    finally:
        tb._shutdown()
        ti._shutdown()


def _errors(fn):
    with pytest.raises((InferError, JaxInferError)) as e:
        fn()
    return getattr(e.value, "http_status", None), str(e.value)


@pytest.mark.parametrize("mode", ["independent", "batched"])
def test_sequence_errors_as_reference(monkeypatch, tiny, mode):
    j, t = _pair(monkeypatch, tiny, mode, slots="2", s_max=136)
    try:
        for m in (j, t):
            m._execute({"TOKENS": _window(b"x")},
                       {"sequence_id": 9, "sequence_start": True})
        cases = [
            ({"TOKENS": _window(b"x")}, {}),                   # no id
            ({"TOKENS": np.zeros(5, np.int32)},                # prompt shape
             {"sequence_id": 8, "sequence_start": True}),
            ({"TOKENS": np.zeros(2, np.int32)},                # step shape
             {"sequence_id": 9}),
        ]
        for inputs, params in cases:
            want = _errors(lambda: j._execute(inputs, dict(params)))
            got = _errors(lambda: t._execute(inputs, dict(params)))
            assert got == want
        # the cache's end: steps until the slab is full, then the error
        for m in (j, t):
            res = {"NEXT_TOKEN": np.array([1], np.int32)}
            for _ in range(m._s_max - m._prompt_len):
                res = m._execute({"TOKENS": res["NEXT_TOKEN"]},
                                 {"sequence_id": 9})
        want = _errors(lambda: j._execute(
            {"TOKENS": np.array([1], np.int32)}, {"sequence_id": 9}))
        got = _errors(lambda: t._execute(
            {"TOKENS": np.array([1], np.int32)}, {"sequence_id": 9}))
        assert got == want and "send sequence_end" in got[1]
    finally:
        j._shutdown()
        t._shutdown()


def test_idle_sequences_are_evicted(monkeypatch, tiny):
    _, t = _pair(monkeypatch, tiny, "independent")
    t._idle_s = 0.05
    t._execute({"TOKENS": _window(b"idle")},
               {"sequence_id": 5, "sequence_start": True})
    assert 5 in t._state
    time.sleep(0.1)
    t._execute({"TOKENS": _window(b"other")},
               {"sequence_id": 6, "sequence_start": True})
    assert 5 not in t._state and 6 in t._state


def test_slot_exhaustion_is_429_as_reference(monkeypatch, tiny):
    j, t = _pair(monkeypatch, tiny, "batched")
    try:
        win = np.zeros((1, 128), np.int32)
        for m in (j, t):
            sinks = [m.submit_generation(win, 3) for _ in range(4)]
            m._sinks = sinks
        want = _errors(lambda: j.submit_generation(win, 3))
        got = _errors(lambda: t.submit_generation(win, 3))
        assert got == want and got[0] == 429
        for m in (j, t):
            for s in m._sinks:
                while s.get(timeout=60) is not None:
                    pass
        # and the sequence protocol's 429
        for m in (j, t):
            for sid in range(4):
                m._execute({"TOKENS": _window(b"s")},
                           {"sequence_id": 50 + sid, "sequence_start": True})
        want = _errors(lambda: j._execute(
            {"TOKENS": _window(b"s")},
            {"sequence_id": 60, "sequence_start": True}))
        got = _errors(lambda: t._execute(
            {"TOKENS": _window(b"s")},
            {"sequence_id": 60, "sequence_start": True}))
        assert got == want and got[0] == 429
    finally:
        j._shutdown()
        t._shutdown()


def test_cancelled_generation_frees_slot(monkeypatch, tiny):
    """Closing the consumer mid-stream flags the sink; the worker frees
    the slot, so submissions stop answering 429."""
    _, t = _pair(monkeypatch, tiny, "batched")
    try:
        g = tdec.GenerateModel(t)
        win = np.zeros((1, 128), np.int32)
        gens = [g._generate({"text_input": np.array([b"cancel me"], object)},
                            {"max_tokens": 100}) for _ in range(4)]
        for it in gens:
            next(it)
        with pytest.raises(InferError) as e:
            t.submit_generation(win, 3)
        assert e.value.http_status == 429
        for it in gens:
            it.close()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            try:
                sink = t.submit_generation(win, 2)
                break
            except InferError:
                time.sleep(0.02)
        else:
            pytest.fail("slots never freed after cancellation")
        while sink.get(timeout=60) is not None:
            pass
        assert len(t._free) == 4
    finally:
        t._shutdown()


def test_unload_fails_new_and_queued_work(monkeypatch, tiny):
    _, t = _pair(monkeypatch, tiny, "batched")
    t._execute({"TOKENS": _window(b"u")},
               {"sequence_id": 1, "sequence_start": True})
    t.model.unload()
    with pytest.raises(InferError) as e:
        t._execute({"TOKENS": np.array([1], np.int32)}, {"sequence_id": 1})
    assert e.value.http_status == 503
