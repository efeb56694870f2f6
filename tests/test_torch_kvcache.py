"""The port's prefix/KV block cache against the JAX package's, on the CPU.

Three layers, each driven the same way in both packages:

* ``KVBlockCache`` (``server/kvcache.py``): the chain digests of one
  window are the same hex digests; one script of match / put / release /
  evict / revalidate / clear gives the same ``stats()`` after every step
  (numpy leaves in the reference, torch leaves in the port, of the same
  bytes); the governor's ``cache_pin`` reservation and the pinning
  tenant's byte-seconds; the configuration and the registry.  A retired
  block (``kvcache.retire``: its storage resized to 0) is what
  ``revalidate`` drops, as the reference drops a deleted buffer.
* The decode worker's hit path, both packages on the tiny ``llama_tpu``
  preset in f32 with the reference's weights: a warm stream equals the
  cold one and the reference's, with the same ``cache_hit_tokens`` (64,
  and 960 of a 1,024-token prompt) and the same store counters; a
  stored block survives an in-place wreck and rebuild of its slab byte for
  byte (``extract`` clones; a view would carry the wreck).
* Independent mode: a cached prompt admits under ``admit_hbm`` where an
  equal cold prompt sheds with the typed memory 429; and both servers
  report the same ``cache_hit_tokens`` on a gRPC stream's final response,
  ``nv_cache_*`` rows and ``/v2/debug/device_stats`` ``kv_cache``.

No timing is asserted: the reference's warm-TTFT ratio is a CPU number;
``chip_smoke.py`` reports the card's.
"""

import dataclasses
import json
import time
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from triton_client_tpu.models import decode as jdec
from triton_client_tpu.models import language as jlang
from triton_client_tpu.models import transformer as jtr
from triton_client_tpu.server import kvcache as jkv
from triton_client_tpu.server.costs import CostLedger as JaxLedger
from triton_client_tpu.server.memory import MemoryGovernor as JaxGovernor
from triton_client_tpu.server.registry import ModelRegistry as JaxRegistry
from triton_client_tpu.server.testing import ServerHarness as JaxHarness
from triton_client_tpu.server.types import InferError as JaxInferError
from triton_client_tpu_torch import grpc as tgrpc
from triton_client_tpu_torch.models import decode as tdec
from triton_client_tpu_torch.models import language as tlang
from triton_client_tpu_torch.server import kvcache as tkv
from triton_client_tpu_torch.server.costs import CostLedger
from triton_client_tpu_torch.server.memory import MemoryGovernor
from triton_client_tpu_torch.server.registry import ModelRegistry
from triton_client_tpu_torch.server.testing import ServerHarness
from triton_client_tpu_torch.server.types import InferError

PRESET_SEED = 3   # llama_tpu's seed, which the decode models share


def _np_leaf(nbytes):
    return np.zeros(nbytes, np.uint8)


def _t_leaf(nbytes):
    return torch.zeros(nbytes, dtype=torch.uint8)


# -- the block store --------------------------------------------------------

@pytest.mark.parametrize("bt,n", [(4, 0), (4, 3), (4, 4), (4, 8), (4, 9),
                                  (16, 200), (64, 128), (64, 1024)])
def test_chain_digests_equal_reference(bt, n):
    toks = np.random.default_rng(n).integers(0, 128256, n).astype(np.int32)
    want = jkv.KVBlockCache("m", 1 << 20, block_tokens=bt).chain_digests(
        toks)
    got = tkv.KVBlockCache("m", 1 << 20, block_tokens=bt).chain_digests(
        toks)
    assert [d.hex() for d in got] == [d.hex() for d in want]
    assert len(got) == max(0, n - 1) // bt


def _store_script(mod, leaf):
    """One scripted run of a block store: each step's results and
    ``stats()``."""
    out = []
    c = mod.KVBlockCache("m", budget_bytes=48, block_tokens=4)

    def seed(tokens):
        digs = c.chain_digests(tokens)
        return [c.put(d, digs[i - 1] if i else b"", leaf(8), leaf(8))
                for i, d in enumerate(digs)]

    t1 = np.arange(9, dtype=np.int32)           # a chain of 2
    t2 = np.arange(100, 105, dtype=np.int32)
    t3 = np.arange(200, 205, dtype=np.int32)
    out.append(("seed t1", seed(t1), c.stats()))
    hit, blocks, phash = c.match(t1)
    out.append(("match t1", hit, len(blocks), phash,
                [b.refs for b in blocks], c.stats()))
    out.append(("seed t2 while t1 held", seed(t2), c.stats()))
    # full of referenced bytes and t2: a new block evicts t2, never t1
    out.append(("seed t3", seed(t3), c.stats()))
    c.release(blocks)
    out.append(("released", [b.refs for b in blocks], c.stats()))
    out.append(("miss", c.match(np.full(9, 77, np.int32))[0], c.stats()))
    out.append(("peek", c.peek(t1), c.peek(t2), c.peek(t3), c.stats()))
    out.append(("oversized", c.put(b"big", b"", leaf(40), leaf(40)),
                c.stats()))
    out.append(("again", seed(t1), c.stats()))
    # evict the chain's parent by hand: the child cascades out
    digs = c.chain_digests(t1)
    with c._lock:
        if digs[0] in c._blocks:
            c._evict_block_locked(c._blocks[digs[0]])
        c._drop_orphans_locked()
    out.append(("orphans", c.has(digs[0]), c.has(digs[1]), c.stats()))
    out.append(("seed t2 again", seed(t2), c.stats()))
    c.clear()
    out.append(("clear", c.stats()))
    return out


def test_store_script_matches_reference():
    got = _store_script(tkv, _t_leaf)
    want = _store_script(jkv, _np_leaf)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w, (g, w)


def test_retired_blocks_are_dropped_at_revalidate():
    """The port's one way to retire a block's memory, read back from
    metadata; the reference's deleted jax buffers drop the same way."""
    stores = {"port": tkv.KVBlockCache("m", 1 << 20, block_tokens=4),
              "jax": jkv.KVBlockCache("m", 1 << 20, block_tokens=4)}
    leaves = {"port": lambda: torch.zeros(8, dtype=torch.uint8),
              "jax": lambda: jnp.zeros(8, jnp.uint8)}
    toks = np.arange(13, dtype=np.int32)
    kept = {}
    for pkg, c in stores.items():
        digs = c.chain_digests(toks)
        blocks = [(leaves[pkg](), leaves[pkg]()) for _ in digs]
        for i, (d, (k, v)) in enumerate(zip(digs, blocks)):
            assert c.put(d, digs[i - 1] if i else b"", k, v)
        kept[pkg] = blocks
        assert c.revalidate() == 0
    # the middle block's k dies: it drops, and its child cascades
    tkv.retire(kept["port"][1][0])
    kept["jax"][1][0].delete()
    assert tkv._leaf_deleted(kept["port"][1][0])
    assert not tkv._leaf_deleted(kept["port"][0][0])
    assert tkv.retired(*kept["port"][1]) and not tkv.retired(
        *kept["port"][0])
    got = {pkg: (c.revalidate(), c.stats()) for pkg, c in stores.items()}
    assert got["port"] == got["jax"]
    assert got["port"][1]["blocks"] == 1
    # an int8 pair retires both of its tensors
    pair = {"q": torch.zeros(4, dtype=torch.int8), "s": torch.ones(4)}
    tkv.retire(pair)
    assert tkv._leaf_deleted(pair) and tkv._leaf_deleted(pair["s"])


def _governor_run(mod_kv, gov, ledger, leaf):
    c = mod_kv.KVBlockCache("m", budget_bytes=64, block_tokens=4,
                            governor=gov, ledger=ledger)
    toks = np.arange(9, dtype=np.int32)
    digs = c.chain_digests(toks)
    for i, d in enumerate(digs):
        c.put(d, digs[i - 1] if i else b"", leaf(8), leaf(8),
              tenant="acme")
    pinned = (gov.metric_rows()["cache_pinned"], c.stats()["pinned_bytes"])
    for _ in range(3):   # hitters pay no residency
        _hit, blocks, _ = c.match(toks)
        c.release(blocks)
    time.sleep(0.02)
    c.clear()
    cell = ledger.snapshot()["models"]["m"]
    return (pinned, gov.metric_rows()["cache_pinned"],
            gov.snapshot()["kv"]["cache_pins"], sorted(cell),
            cell["acme"]["kv_byte_seconds"]
            == pytest.approx(gov.kv_byte_seconds[("m", "acme")]),
            gov.kv_byte_seconds[("m", "acme")] > 0)


def test_governor_reservation_and_pinning_tenant_charge():
    got = _governor_run(tkv, MemoryGovernor(hbm_stats_fn=lambda: {}),
                        CostLedger(enabled=True), _t_leaf)
    want = _governor_run(jkv, JaxGovernor(hbm_stats_fn=lambda: {}),
                         JaxLedger(enabled=True), _np_leaf)
    assert got == want
    assert got[0] == ([({"model": "m"}, 32)], 32) and got[1] == []


def test_config_matches_reference(monkeypatch):
    for name in ("llama-decode.v2", "llama_decode", "m"):
        assert tkv.cache_env_key(name) == jkv.cache_env_key(name)

    def both(fn, *args):
        out = []
        for mod in (tkv, jkv):
            try:
                out.append(getattr(mod, fn)(*args))
            except ValueError as e:
                out.append(("ValueError", str(e)))
        assert out[0] == out[1], out
        return out[0]

    monkeypatch.delenv("TRITON_TPU_KV_CACHE_BYTES", raising=False)
    monkeypatch.delenv("TRITON_TPU_KV_BLOCK_TOKENS", raising=False)
    assert both("resolve_budget_bytes", "m") == 0
    assert both("resolve_block_tokens") == 64
    monkeypatch.setenv("TRITON_TPU_KV_CACHE_BYTES", "1024")
    monkeypatch.setenv(tkv.cache_env_key("m"), "2048")
    assert both("resolve_budget_bytes", "m") == 2048
    assert both("resolve_budget_bytes", "other") == 1024
    for junk in ("junk", "-5", " 7 "):
        monkeypatch.setenv(tkv.cache_env_key("m"), junk)
        both("resolve_budget_bytes", "m")
    for val in ("16", "0", "x"):
        monkeypatch.setenv("TRITON_TPU_KV_BLOCK_TOKENS", val)
        both("resolve_block_tokens")


def test_registry_lifecycle(monkeypatch):
    monkeypatch.setenv(tkv.cache_env_key("reg_m"), "4096")
    c = tkv.for_model("reg_m")
    assert c is tkv.for_model("reg_m") is tkv.get("reg_m")
    assert tkv.for_model("reg_off", budget_bytes=0) is None
    rows = tkv.metric_rows()
    assert ({"model": "reg_m"}, 0) in rows["hit"]
    assert sorted(rows) == sorted(jkv.metric_rows())
    assert tkv.snapshot()["reg_m"] == jkv.KVBlockCache(
        "reg_m", 4096).stats()
    tkv.drop("reg_m")
    assert tkv.get("reg_m") is None


# -- the decode worker's hit path -------------------------------------------

def _f32_tiny(monkeypatch):
    """Both packages' tiny preset in f32; the reference's weights."""
    for presets, dtype in ((jlang._LLAMA_PRESETS, jnp.float32),
                           (tlang._LLAMA_PRESETS, torch.float32)):
        monkeypatch.setitem(presets, "tiny", dataclasses.replace(
            presets["tiny"], dtype=dtype))
    monkeypatch.setenv("TRITON_TPU_LLAMA_PRESET", "tiny")
    for var in ("TRITON_TPU_DECODE_BUCKETS", "TRITON_TPU_KV_QUANT",
                "TRITON_TPU_PREFILL_CHUNK", "TRITON_TPU_DECODE_STEPS",
                "TRITON_TPU_KV_CACHE_BYTES", "TRITON_TPU_KV_BLOCK_TOKENS"):
        monkeypatch.delenv(var, raising=False)
    jp = jtr.init_params(jax.random.PRNGKey(PRESET_SEED),
                         jlang._LLAMA_PRESETS["tiny"])
    return {k: np.asarray(v) for k, v in jp.items()}


def _pair(monkeypatch, name, mode="batched", slots="4", budget=64 << 20,
          prompt_len=None):
    params = _f32_tiny(monkeypatch)
    monkeypatch.setenv("TRITON_TPU_DECODE_MODE", mode)
    monkeypatch.setenv("TRITON_TPU_DECODE_SLOTS", slots)
    monkeypatch.setenv(tkv.cache_env_key(name), str(budget))
    j = jdec.DecodeModel(name=name, prompt_len=prompt_len)
    t = tdec.DecodeModel(name=name, device="cpu", params=params,
                         prompt_len=prompt_len)
    return j, t


def _drain(sink):
    toks, errs = [], []
    while True:
        item = sink.get(timeout=300)
        if item is None:
            return toks, errs
        if isinstance(item, Exception):
            errs.append(item)
            return toks, errs
        toks.append(int(item[0]))


def _window(seed_tokens, width=128):
    win = np.zeros((1, width), np.int32)
    win[0, -len(seed_tokens):] = np.asarray(seed_tokens, np.int32) % 250 + 1
    return win


def _stores(name):
    return tkv.get(name), jkv.get(name)


def test_warm_stream_equals_cold_and_reference(monkeypatch):
    name = "llama_decode_tkvc"
    j, t = _pair(monkeypatch, name)
    try:
        win = _window([7, 11, 13, 17, 19])
        runs = {}
        for pkg, m in (("port", t), ("jax", j)):
            cold_sink = m.submit_generation(win, 6)
            cold, errs = _drain(cold_sink)
            assert not errs and len(cold) == 6
            assert cold_sink.cache_hit_tokens == 0
            assert cold_sink.prefix_hash is None
            warm_sink = m.submit_generation(win, 6)
            warm, errs = _drain(warm_sink)
            assert not errs
            runs[pkg] = (cold, warm, warm_sink.cache_hit_tokens,
                         warm_sink.prefix_hash)
        assert runs["port"] == runs["jax"]
        cold, warm, hit, phash = runs["port"]
        assert warm == cold and hit == 64
        tc, jc = _stores(name)
        assert phash == tc.chain_digests(win[0])[-1].hex()
        assert tc.stats() == jc.stats()
        st = tc.stats()
        assert (st["hits"], st["misses"], st["hit_tokens"]) == (1, 1, 64)
        assert st["pinned_bytes"] > 0
    finally:
        j._shutdown()
        t._shutdown()
    assert tkv.get(name) is None   # the store goes with the model


def test_divergent_prompt_with_a_shared_prefix_hits(monkeypatch):
    name = "llama_decode_tkvd"
    j, t = _pair(monkeypatch, name)
    try:
        base = list(range(1, 70))
        a, b = _window(base + [91]), _window(base + [92])
        runs = {}
        for pkg, m in (("port", t), ("jax", j)):
            want_a, errs = _drain(m.submit_generation(a, 4))
            assert not errs
            sink_b = m.submit_generation(b, 4)
            got_b, errs = _drain(sink_b)
            assert not errs
            again_b, errs = _drain(m.submit_generation(b, 4))
            runs[pkg] = (want_a, got_b, sink_b.cache_hit_tokens, again_b)
        assert runs["port"] == runs["jax"]
        assert runs["port"][2] == 64 and runs["port"][3] == runs["port"][1]
    finally:
        j._shutdown()
        t._shutdown()


def test_eviction_counter_under_a_one_block_budget(monkeypatch):
    # one f32 block of the tiny preset is 2 x 2 x 4 x 64 x 16 x 4 bytes
    name = "llama_decode_tkvt"
    j, t = _pair(monkeypatch, name, budget=80000)
    try:
        for m in (t, j):
            for i in range(3):
                _toks, errs = _drain(m.submit_generation(
                    _window([i + 1] * 66), 2))
                assert not errs
        tc, jc = _stores(name)
        assert tc.stats() == jc.stats()
        assert tc.stats()["blocks"] == 1 and tc.stats()["evictions"] >= 2
    finally:
        j._shutdown()
        t._shutdown()


def test_shared_1k_prompt_hits_960_tokens(monkeypatch):
    name = "llama_decode_tkv1k"
    j, t = _pair(monkeypatch, name, slots="2", budget=256 << 20,
                 prompt_len=1024)
    try:
        shared = _window(list(range(7, 1031)), width=1024)
        runs = {}
        for pkg, m in (("port", t), ("jax", j)):
            cold, errs = _drain(m.submit_generation(shared, 3))
            assert not errs
            sink = m.submit_generation(shared, 3)
            warm, errs = _drain(sink)
            assert not errs
            runs[pkg] = (cold, warm, sink.cache_hit_tokens)
        assert runs["port"] == runs["jax"]
        assert runs["port"][0] == runs["port"][1]
        assert runs["port"][2] == 960   # 15 of the 16 blocks
    finally:
        j._shutdown()
        t._shutdown()


def test_stored_block_survives_a_wreck_and_rebuild_of_its_slab(monkeypatch):
    """``extract`` clones: a device_error wrecks the bucket in place (NaN)
    and the rebuild replaces it, and the stored block keeps its bytes; the
    recovery then hits it.  Were the block a view of the slab, the wreck
    would show in it."""
    from triton_client_tpu_torch.server.chaos import ChaosInjector
    from triton_client_tpu_torch.server.core import DeviceFaultManager

    params = _f32_tiny(monkeypatch)
    monkeypatch.setenv("TRITON_TPU_DECODE_MODE", "batched")
    monkeypatch.setenv("TRITON_TPU_DECODE_SLOTS", "4")
    name = "llama_decode_tkvw"
    monkeypatch.setenv(tkv.cache_env_key(name), str(64 << 20))
    m = tdec.DecodeModel(name=name, device="cpu", params=params)
    try:
        win = _window([4, 8, 15, 16, 23, 42])
        want, errs = _drain(m.submit_generation(win, 5))
        assert not errs
        store = tkv.get(name)
        with store._lock:
            blocks = list(store._blocks.values())
        assert len(blocks) == 1
        before = [(b.k.clone(), b.v.clone()) for b in blocks]
        # the same bytes are in the slab's lane the prefill wrote
        assert torch.equal(m._k[0][:, 0:1, :, :64], blocks[0].k)
        mgr = DeviceFaultManager(threshold=100)
        m.attach_device_faults(mgr)
        m.attach_chaos(ChaosInjector(rate=1.0, kinds=["device_error"],
                                     seed=5, max_faults=1))
        old_k = m._k[0]
        got, errs = _drain(m.submit_generation(win, 5))
        assert m._chaos.injected_total == 1 and not errs and got == want
        assert torch.isnan(old_k).all()          # the wreck happened
        assert m._k[0] is not old_k              # and the rebuild
        for blk, (k0, v0) in zip(blocks, before):
            assert torch.equal(blk.k, k0) and torch.equal(blk.v, v0)
        assert store.stats()["blocks"] == 1 and store.stats()["hits"] >= 1
        assert mgr.snapshot()["recovered"] == {name: 1}
    finally:
        m._shutdown()


def test_block_ops_clone_and_write_back_verbatim():
    """The ops alone: an extracted block is a tensor of its own (the
    slab's later in-place writes never reach it), ``insert_run`` writes a
    chain back byte for byte, and a retired block is refused before any
    read (of its 0-byte storage)."""
    gen = torch.Generator().manual_seed(0)
    k = torch.randn((2, 3, 4, 16, 8), generator=gen)
    v = torch.randn((2, 3, 4, 16, 8), generator=gen)
    ext, ins_run = tdec.make_cache_block_ops(4)
    kb0, vb0 = ext(k, v, 1, 0)
    kb1, vb1 = ext(k, v, 1, 4)
    assert kb0.shape == (2, 1, 4, 4, 8)
    assert torch.equal(kb1, k[:, 1:2, :, 4:8])
    want = k[:, 1:2, :, :8].clone()
    k.fill_(float("nan"))
    v.fill_(float("nan"))
    assert not torch.isnan(kb0).any() and not torch.isnan(vb1).any()
    k2, v2 = torch.zeros_like(k), torch.zeros_like(v)
    ins_run(k2, v2, (kb0, kb1), (vb0, vb1), 2, 0)
    assert torch.equal(k2[:, 2:3, :, :8], want)
    assert not k2[:, 2:3, :, 8:].any() and not k2[:, :2].any()
    tkv.retire(kb1)
    with pytest.raises(RuntimeError, match="retired"):
        ins_run(k2, v2, (kb0, kb1), (vb0, vb1), 0, 0)
    # an int8 pair
    pk = {"q": torch.arange(2 * 3 * 4 * 16 * 8, dtype=torch.int32)
          .remainder(255).sub(127).to(torch.int8).reshape(2, 3, 4, 16, 8),
          "s": torch.rand((2, 3, 4, 16), generator=gen)}
    pb, _ = ext(pk, pk, 0, 8)
    assert torch.equal(pb["q"], pk["q"][:, 0:1, :, 8:12])
    assert torch.equal(pb["s"], pk["s"][:, 0:1, :, 8:12])


# -- independent mode: a hit lowers the admission projection ----------------

def _independent_run(m, win, n, seq_id):
    out = m._execute({"TOKENS": win},
                     {"sequence_id": seq_id, "sequence_start": True})
    toks = [int(out["NEXT_TOKEN"][0])]
    for i in range(n - 1):
        out = m._execute({"TOKENS": np.array([[toks[-1]]], np.int32)},
                         {"sequence_id": seq_id,
                          "sequence_end": i == n - 2})
        toks.append(int(out["NEXT_TOKEN"][0]))
    return toks


def test_prefix_hit_lowers_the_admit_hbm_projection(monkeypatch):
    """With the headroom tightened between a seeding run and the drill,
    the cached prompt admits (its projection shrank by the hit) while a
    cold prompt of the same length sheds with the typed memory 429; the
    warm tokens equal the cold ones, in both packages."""
    name = "llama_decode_tkvi"
    j, t = _pair(monkeypatch, name, mode="independent")
    results = {}
    try:
        for pkg, m, gov_cls, err_cls in (
                ("port", t, MemoryGovernor, InferError),
                ("jax", j, JaxGovernor, JaxInferError)):
            headroom = [1 << 40]
            gov = gov_cls(hbm_stats_fn=lambda h=headroom: {
                "dev:0": {"bytes_limit": h[0], "bytes_in_use": 0}})
            gov.hbm_headroom_fraction = 1.0
            m.attach_memory_governor(gov)
            shared = _window([5] * 80)
            cold = _independent_run(m, shared, 3, seq_id=101)
            per_tok = m._kv_bytes_per_token()
            headroom[0] = (m._s_max - 32) * per_tok
            warm = _independent_run(m, shared, 3, seq_id=102)
            with pytest.raises(err_cls) as ei:
                _independent_run(m, _window([9] * 80), 3, seq_id=103)
            results[pkg] = (cold, warm, per_tok, ei.value.shed_reason,
                            ei.value.http_status, str(ei.value))
        assert results["port"] == results["jax"]
        cold, warm, per_tok, reason, status, _msg = results["port"]
        assert warm == cold and reason == "memory" and status == 429
        assert per_tok == 2 * 2 * 4 * 16 * 2   # the reference's formula
        tc, jc = _stores(name)
        assert tc.stats() == jc.stats()
        assert tc.stats()["hits"] == 1 and tc.stats()["hit_tokens"] == 64
    finally:
        j._shutdown()
        t._shutdown()


# -- the served surfaces ----------------------------------------------------

def _stream_final(url, prompt, n):
    """Tokens and the final response's parameters of one llama_generate
    gRPC stream (the port's gRPC-Web client, either server)."""
    got = []
    c = tgrpc.InferenceServerClient(url)
    c.start_stream(callback=lambda result, error: got.append(
        (result, error)))
    try:
        inp = tgrpc.InferInput("text_input", [1], "BYTES")
        inp.set_data_from_numpy(np.array([prompt], dtype=object))
        c.async_stream_infer("llama_generate", [inp],
                             parameters={"max_tokens": n},
                             enable_empty_final_response=True)
    finally:
        c.stop_stream()
        c.close()
    assert all(e is None for _, e in got), got
    toks = [int(r.as_numpy("token_id")[0]) for r, _ in got[:-1]]
    final = got[-1][0].get_response().parameters
    hit = final["cache_hit_tokens"].int64_param if \
        "cache_hit_tokens" in final else None
    return toks, hit


def _json(url, path):
    with urllib.request.urlopen(f"http://{url}{path}", timeout=60) as r:
        return r.read().decode()


def test_served_cache_hit_metrics_and_device_stats(monkeypatch):
    params = _f32_tiny(monkeypatch)
    monkeypatch.setenv("TRITON_TPU_DECODE_MODE", "batched")
    monkeypatch.setenv("TRITON_TPU_DECODE_SLOTS", "4")
    monkeypatch.setenv("TRITON_TPU_KV_CACHE_BYTES", str(64 << 20))
    jreg, treg = JaxRegistry(), ModelRegistry()
    jd = jdec.DecodeModel()
    for m in (jd.model, jdec.make_llama_generate(jd)):
        jreg.register_model(m)
    td = tdec.DecodeModel(device="cpu", params=params)
    for m in (td.model, tdec.make_llama_generate(td)):
        treg.register_model(m)
    prompt = b"a shared system prompt that fills two blocks " * 3
    out = {}
    with JaxHarness(jreg) as jh, ServerHarness(treg) as th:
        for pkg, url in (("port", th.http_url), ("jax", jh.http_url)):
            cold = _stream_final(url, prompt, 4)
            warm = _stream_final(url, prompt, 4)
            metrics = [ln for ln in _json(url, "/metrics").splitlines()
                       if ln.startswith("nv_cache_") and "{" in ln
                       and "llama_decode" in ln]
            kv = json.loads(_json(url, "/v2/debug/device_stats"))[
                "kv_cache"]
            out[pkg] = (cold, warm, sorted(metrics), kv)
    assert out["port"] == out["jax"]
    cold, warm, metrics, kv = out["port"]
    assert cold[0] == warm[0] and cold[1] is None and warm[1] == 64
    assert 'nv_cache_hit_total{model="llama_decode"} 1' in metrics
    assert kv["llama_decode"]["hits"] == 1
