"""Content-addressed prefix/KV cache: the generation stack's reuse layer.

The port's copy of ``triton_client_tpu/server/kvcache.py``, with the same
digests, counters, eviction order, governor pins and export rows.  A
per-model **block store** of K/V cache segments keyed by the *content* of
the token prefix that produced them.

Hashing scheme (content addressing)
-----------------------------------
A prompt window is split into fixed ``block_tokens``-sized blocks
(``TRITON_TPU_KV_BLOCK_TOKENS``, default 64).  Block *i*'s digest chains
its parent's digest with its own token bytes::

    d_0 = blake2b(b"" + tokens[0:B])
    d_i = blake2b(d_{i-1} + tokens[iB:(i+1)B])

so a block key commits to the whole prefix, not just its own tokens.  K/V
values at position ``p`` of a causal transformer depend only on tokens
``<= p`` (and the weights), so any sequence whose window starts with the
same tokens reads the same K/V.  The chain stops at the largest multiple
of ``block_tokens`` strictly below the window length: the final
position's logits always come from a real dispatch.  The digests are pure
host work over int32 token bytes, so one window gives the same hex
digests in both packages.

Residency contract (MemoryGovernor ledger)
------------------------------------------
Every committed block opens a ``cache_pin`` in the governor's ledger
(``nv_mem_cache_pinned_bytes``).  Eviction closes the pin and charges the
*pinning* tenant the block's byte-seconds through the CostLedger, exactly
the governor's return, so the two reconcile by construction.  A sequence
that hits a block pays only its own slot pin.

Stored tensors
--------------
A block's ``k`` / ``v`` are tensors of their own (``extract`` clones
them out of the slab; the decode worker updates its slabs in place, so a
view would carry a later write into the store), or ``{"q", "s"}`` pairs
of them.  A tensor has no "deleted" state, so the port retires a stored
tensor's memory one way, :func:`retire`: its storage resized to 0 bytes.
:func:`_leaf_deleted` reads that back from metadata alone (no device
sync), for :meth:`KVBlockCache.revalidate` and for the decode worker,
which refuses to read a retired block (a read of a 0-byte storage is an
out-of-bounds access, not an error).

Refcount / eviction rules
-------------------------
A matched block is refcounted from match until the hitting sequence's
tail prefill has been dispatched (the slab copy owns the bytes from
then on).  Eviction considers only ``refs == 0`` blocks, picks the
LRU/largest hybrid victim (oldest ``last_use`` first, larger block on
ties), and then drops any block whose parent left the store — a broken
chain can never be matched again, so keeping its tail would strand
bytes.  Device faults call :meth:`KVBlockCache.revalidate`, which drops
blocks whose tensors were retired; committed blocks are tensors of their
own, so a wrecked slab leaves the store intact.

Metric families (declared once in ``metrics.collect_families``)::

    nv_cache_hit_total          counter  {model}
    nv_cache_miss_total         counter  {model}
    nv_cache_evict_total        counter  {model}
    nv_cache_hit_tokens_total   counter  {model}
    nv_cache_pinned_bytes       gauge    {model}

Configuration: ``TRITON_TPU_KV_CACHE_BYTES`` (global per-model budget,
0/unset = cache off) with per-model ``TRITON_TPU_KV_CACHE_BYTES_<MODEL>``
override (``--kv-cache-bytes MODEL=N`` on the server CLI), and
``TRITON_TPU_KV_BLOCK_TOKENS`` for the block granularity.
"""

from __future__ import annotations

import hashlib
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["KVBlockCache", "for_model", "get", "drop", "drop_all",
           "metric_rows", "snapshot", "resolve_budget_bytes",
           "resolve_block_tokens", "cache_env_key", "DEFAULT_BLOCK_TOKENS",
           "retire"]

#: Default prefix-block granularity (tokens per content-addressed block).
DEFAULT_BLOCK_TOKENS = 64

_ROOT = b""


def cache_env_key(model_name: str) -> str:
    """Per-model budget override variable (same sanitization convention
    as ``TRITON_TPU_QUANT_<MODEL>``)."""
    return "TRITON_TPU_KV_CACHE_BYTES_" + "".join(
        c if c.isalnum() else "_" for c in model_name.upper())


def resolve_budget_bytes(model_name: str) -> int:
    """The model's prefix-cache byte budget: per-model env override, then
    the global ``TRITON_TPU_KV_CACHE_BYTES``; 0/unset disables the cache.
    Malformed values fail loudly with the variable that was set."""
    var = "TRITON_TPU_KV_CACHE_BYTES"
    val = os.environ.get(var, "")
    key = cache_env_key(model_name)
    per_model = os.environ.get(key)
    if per_model is not None:
        var, val = key, per_model
    val = val.strip()
    if not val:
        return 0
    try:
        n = int(val)
    except ValueError:
        raise ValueError(f"{var}={val!r}: expected an integer byte budget")
    return max(0, n)


def resolve_block_tokens() -> int:
    val = os.environ.get("TRITON_TPU_KV_BLOCK_TOKENS", "").strip()
    if not val:
        return DEFAULT_BLOCK_TOKENS
    try:
        n = int(val)
    except ValueError:
        raise ValueError(
            f"TRITON_TPU_KV_BLOCK_TOKENS={val!r}: expected an integer")
    if n <= 0:
        raise ValueError(
            f"TRITON_TPU_KV_BLOCK_TOKENS={n}: must be positive")
    return n


def _leaf_nbytes(c) -> int:
    if isinstance(c, dict):
        return sum(_leaf_nbytes(v) for v in c.values())
    return int(c.numel()) * int(c.element_size())


def retire(c) -> None:
    """Give a stored tensor's memory back: its storage is resized to 0
    bytes (a ``{"q", "s"}`` pair, each of its tensors).  The one way the
    port retires a block's bytes; :func:`_leaf_deleted` reads it back."""
    if isinstance(c, dict):
        for v in c.values():
            retire(v)
        return
    c.untyped_storage().resize_(0)


def _leaf_deleted(c) -> bool:
    """True when a stored tensor was retired (:func:`retire`): a metadata
    check of its storage's size, never a device sync."""
    if isinstance(c, dict):
        return any(_leaf_deleted(v) for v in c.values())
    try:
        return c.untyped_storage().nbytes() == 0
    except Exception:  # noqa: BLE001 - a leaf without storage: assume live
        return False


def retired(*leaves) -> bool:
    """Whether any of ``leaves`` (tensors or pairs) was retired."""
    return any(_leaf_deleted(c) for c in leaves)


class _Block:
    __slots__ = ("digest", "parent", "k", "v", "tokens", "nbytes",
                 "refs", "last_use", "pin", "tenant")

    def __init__(self, digest, parent, k, v, tokens, nbytes, tenant):
        self.digest = digest
        self.parent = parent
        self.k = k
        self.v = v
        self.tokens = tokens
        self.nbytes = nbytes
        self.refs = 0
        self.last_use = 0
        self.pin = None
        self.tenant = tenant


class KVBlockCache:
    """One model's content-addressed K/V block store.

    Thread-safe under one short lock; the decode worker matches/commits,
    admission threads peek, the metrics renderer snapshots.  Tensors are
    only referenced here: all slicing and insertion runs in the decode
    model's block ops."""

    def __init__(self, model: str, budget_bytes: int,
                 block_tokens: Optional[int] = None,
                 governor=None, ledger=None) -> None:
        self.model = model
        self.budget_bytes = int(budget_bytes)
        self.block_tokens = int(block_tokens or resolve_block_tokens())
        self.governor = governor
        self.ledger = ledger
        self._lock = threading.Lock()
        self._blocks: Dict[bytes, _Block] = {}
        self._clock = 0
        # counter surface (nv_cache_*): monotonic over the cache lifetime
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.hit_tokens_total = 0
        self.pinned_bytes = 0

    # -- content addressing -------------------------------------------------
    def chain_digests(self, tokens) -> List[bytes]:
        """Chained digests for every COMPLETE block strictly below the
        window's final position (see module docstring).  ``tokens`` is a
        host int array/sequence — hashing is pure host work."""
        import numpy as np

        n = max(0, len(tokens) - 1) // self.block_tokens
        if not n:
            return []
        arr = np.ascontiguousarray(
            tokens[:n * self.block_tokens], dtype=np.int32)
        out: List[bytes] = []
        parent = _ROOT
        bt = self.block_tokens
        for i in range(n):
            h = hashlib.blake2b(parent, digest_size=16)
            h.update(arr[i * bt:(i + 1) * bt].tobytes())
            parent = h.digest()
            out.append(parent)
        return out

    def has(self, digest: bytes) -> bool:
        """Commit-side presence probe: lets the decode worker skip the
        extraction for blocks already in the store."""
        with self._lock:
            return digest in self._blocks

    def peek(self, tokens) -> int:
        """Longest cached prefix (tokens) WITHOUT acquiring references or
        touching hit/miss counters — the admission-projection probe."""
        digs = self.chain_digests(tokens)
        n = 0
        with self._lock:
            for d in digs:
                if d not in self._blocks:
                    break
                n += 1
        return n * self.block_tokens

    def match(self, tokens) -> Tuple[int, List[_Block], Optional[str]]:
        """Longest cached block chain for this window: returns
        ``(hit_tokens, blocks, prefix_hash)`` with every matched block's
        refcount raised (pair with :meth:`release` once the hitting
        sequence's inserts are dispatched).  One hit or one miss is
        counted per match, hit tokens accumulate."""
        digs = self.chain_digests(tokens)
        got: List[_Block] = []
        with self._lock:
            self._clock += 1
            for d in digs:
                blk = self._blocks.get(d)
                if blk is None:
                    break
                blk.refs += 1
                blk.last_use = self._clock
                got.append(blk)
            if got:
                self.hits += 1
                self.hit_tokens_total += len(got) * self.block_tokens
            else:
                self.misses += 1
        phash = got[-1].digest.hex() if got else None
        return len(got) * self.block_tokens, got, phash

    def release(self, blocks: List[_Block]) -> None:
        """Drop match references; an unreferenced block whose chain broke
        while it was held (parent evicted) is unreachable forever and is
        dropped here rather than stranded."""
        with self._lock:
            for blk in blocks:
                blk.refs = max(0, blk.refs - 1)
            self._drop_orphans_locked()

    # -- commit / evict -----------------------------------------------------
    def put(self, digest: bytes, parent: bytes, k, v,
            tenant: str = "") -> bool:
        """Commit one extracted block under ``digest``.  Returns False
        when the block is already present, exceeds the whole budget, or
        every evictable (unreferenced) byte is exhausted — commit is
        best-effort, correctness never depends on it."""
        nbytes = _leaf_nbytes(k) + _leaf_nbytes(v)
        with self._lock:
            if digest in self._blocks:
                return False
            if nbytes > self.budget_bytes:
                return False
            self._evict_to_locked(self.budget_bytes - nbytes)
            if self.pinned_bytes + nbytes > self.budget_bytes:
                return False
            blk = _Block(digest, parent, k, v, self.block_tokens,
                         nbytes, tenant)
            self._clock += 1
            blk.last_use = self._clock
            if self.governor is not None:
                # the governor lock is a leaf (same ordering contract as
                # _kv_unpin_charge): the block's residency becomes a
                # named reservation in the memory ledger
                blk.pin = self.governor.cache_pin(
                    self.model, nbytes, tenant)
            self._blocks[digest] = blk
            self.pinned_bytes += nbytes
        return True

    def _evict_block_locked(self, blk: _Block) -> None:
        self._blocks.pop(blk.digest, None)
        self.pinned_bytes = max(0, self.pinned_bytes - blk.nbytes)
        self.evictions += 1
        # drop the tensor references eagerly: the memory goes back to the
        # allocator now, not at the next gc cycle
        blk.k = blk.v = None
        pin, blk.pin = blk.pin, None
        if pin is not None and self.governor is not None:
            tenant, byte_s = self.governor.cache_unpin(pin)
            ledger = self.ledger
            if ledger is not None and ledger.enabled and byte_s > 0:
                # residency is charged to the PINNING tenant at eviction
                # time — exactly the integrator's return, so the
                # CostLedger reconciles with the governor by construction
                ledger.charge(self.model, tenant, kv_byte_seconds=byte_s)

    def _drop_orphans_locked(self) -> None:
        changed = True
        while changed:
            changed = False
            for blk in list(self._blocks.values()):
                if (blk.refs <= 0 and blk.parent != _ROOT
                        and blk.parent not in self._blocks):
                    self._evict_block_locked(blk)
                    changed = True

    def _evict_to_locked(self, target_bytes: int) -> None:
        """LRU/largest-hybrid eviction of unreferenced chains until the
        store holds at most ``target_bytes``."""
        while self.pinned_bytes > target_bytes:
            candidates = [b for b in self._blocks.values() if b.refs <= 0]
            if not candidates:
                return
            victim = min(candidates,
                         key=lambda b: (b.last_use, -b.nbytes))
            self._evict_block_locked(victim)
            self._drop_orphans_locked()

    def revalidate(self) -> int:
        """Post-fault sweep (the bucket rebuild after a failed dispatch):
        drop every block whose tensors were retired.  Returns the number
        of blocks dropped."""
        dropped = 0
        with self._lock:
            for blk in list(self._blocks.values()):
                if _leaf_deleted(blk.k) or _leaf_deleted(blk.v):
                    self._evict_block_locked(blk)
                    dropped += 1
            self._drop_orphans_locked()
        return dropped

    def clear(self) -> None:
        """Evict everything (model shutdown): every pin closes, so the
        governor's cache reservation returns to zero."""
        with self._lock:
            for blk in list(self._blocks.values()):
                self._evict_block_locked(blk)

    # -- export -------------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "budget_bytes": self.budget_bytes,
                "block_tokens": self.block_tokens,
                "blocks": len(self._blocks),
                "pinned_bytes": self.pinned_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "hit_tokens": self.hit_tokens_total,
            }


# ---------------------------------------------------------------------------
# Registry: one store per model name.  Decode models create/lookup their
# store lazily (budget 0 -> no entry, cache off); the metrics renderer and
# the device_stats debug surface aggregate over whatever is live.
# ---------------------------------------------------------------------------

_registry_lock = threading.Lock()
_registry: Dict[str, KVBlockCache] = {}


def for_model(model: str, governor=None, ledger=None,
              budget_bytes: Optional[int] = None,
              block_tokens: Optional[int] = None) -> Optional[KVBlockCache]:
    """The model's block store, created on first call (``None`` when the
    resolved budget is 0 — cache disabled).  Later calls refresh the
    governor/ledger wiring (attach order is not guaranteed)."""
    if budget_bytes is None:
        budget_bytes = resolve_budget_bytes(model)
    if budget_bytes <= 0:
        return None
    with _registry_lock:
        cache = _registry.get(model)
        if cache is None:
            cache = KVBlockCache(model, budget_bytes,
                                 block_tokens=block_tokens,
                                 governor=governor, ledger=ledger)
            _registry[model] = cache
        else:
            if governor is not None:
                cache.governor = governor
            if ledger is not None:
                cache.ledger = ledger
        return cache


def get(model: str) -> Optional[KVBlockCache]:
    with _registry_lock:
        return _registry.get(model)


def drop(model: str) -> None:
    """Remove a model's store, closing every governor pin (model unload/
    shutdown — the reservation must not outlive the model)."""
    with _registry_lock:
        cache = _registry.pop(model, None)
    if cache is not None:
        cache.clear()


def drop_all() -> None:
    with _registry_lock:
        caches = list(_registry.values())
        _registry.clear()
    for cache in caches:
        cache.clear()


def metric_rows() -> Dict[str, List[Tuple[Dict[str, str], Any]]]:
    """The ``nv_cache_*`` sample rows keyed by short family name — one
    source for the Prometheus renderer and the JSON snapshot (same
    contract as ``MemoryGovernor.metric_rows``)."""
    with _registry_lock:
        caches = sorted(_registry.items())
    rows: Dict[str, List[Tuple[Dict[str, str], Any]]] = {
        "hit": [], "miss": [], "evict": [], "hit_tokens": [],
        "pinned_bytes": [],
    }
    for model, cache in caches:
        s = cache.stats()
        rows["hit"].append(({"model": model}, s["hits"]))
        rows["miss"].append(({"model": model}, s["misses"]))
        rows["evict"].append(({"model": model}, s["evictions"]))
        rows["hit_tokens"].append(({"model": model}, s["hit_tokens"]))
        rows["pinned_bytes"].append(({"model": model}, s["pinned_bytes"]))
    return rows


def snapshot() -> Dict[str, Any]:
    """Debug-surface JSON (rides ``/v2/debug/device_stats`` under
    ``"kv_cache"``)."""
    with _registry_lock:
        caches = sorted(_registry.items())
    return {model: cache.stats() for model, cache in caches}
