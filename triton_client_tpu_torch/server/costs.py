"""Cost observability: the counted cost of a served signature, the
roofline verdict, and the per-(model, tenant) cost ledger.

The port's counterpart of ``triton_client_tpu/server/costs.py``.
``SignatureCost``, :func:`classify_roofline`, :class:`CostLedger` and
:func:`merge_cost_snapshots` are the reference's.  Where the reference asks
XLA for a compiled program's ``cost_analysis()`` and ``memory_analysis()``
without running it, the port has no compiled program to ask, so
:func:`analyze_torch_callable` counts one execution as it runs:

* FLOPs through ``torch.utils.flop_counter.FlopCounterMode``, with a
  formula of 2·M·K·N for ``aten._int_mm`` (which that counter does not
  know), and each hand kernel's own formula (``ops/_count.py``: the flash
  and int8 kernels are launched outside the dispatcher, and their plain
  versions report the same formula in place of their own ops);
* bytes accessed, XLA's definition: each op's operands read and results
  written (views and allocations move nothing), summed by a dispatch mode,
  plus the kernels' own bytes;
* argument and output bytes of the execution, and temp bytes: the peak of
  ``torch.cuda.max_memory_allocated`` over the execution above what was
  allocated at its start, less the outputs (0 on the CPU).

The counted execution is the first one of each new input signature, the
one the reference records as a compile event (``core.py``): the core runs
it under the count, so no extra forward runs, and the device statistics
keep it out of the duty-cycle and MFU window as the reference keeps its
compile out.  ``FlopCounterMode`` counts matmul-class operations only,
where XLA's count takes elementwise work too, so the two packages' FLOPs
for one model agree within a band, not exactly (``tests/
test_torch_costs.py`` states it).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "CostLedger",
    "SignatureCost",
    "analysis_enabled",
    "analyze_torch_callable",
    "classify_roofline",
    "merge_cost_snapshots",
    "peak_bytes_per_s",
    "warm_up",
]

#: H100 SXM HBM3 bandwidth, NVIDIA's data-sheet figure for the card (not a
#: measurement): the roofline's memory leg, beside
#: ``device_stats.DEFAULT_PEAK_FLOPS``.  ``TRITON_TPU_PEAK_BYTES_PER_S``
#: overrides it, as in the reference.
DEFAULT_PEAK_BYTES_PER_S = 3.35e12


def peak_bytes_per_s() -> float:
    """Peak memory bandwidth for roofline ridge points:
    ``TRITON_TPU_PEAK_BYTES_PER_S``, else :data:`DEFAULT_PEAK_BYTES_PER_S`."""
    env = os.environ.get("TRITON_TPU_PEAK_BYTES_PER_S")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    return DEFAULT_PEAK_BYTES_PER_S


def analysis_enabled() -> bool:
    """Whether signatures are counted at all (``TRITON_TPU_COST_ANALYSIS=0``
    turns it off)."""
    return os.environ.get("TRITON_TPU_COST_ANALYSIS", "1") != "0"


class SignatureCost:
    """The counted cost of one (model, input-shape) signature: FLOPs and
    bytes accessed, and the execution's argument, output and temp bytes.
    A zero field means nothing was counted for it (unknown, not free);
    ``generated_code_bytes`` is always 0 (no compiled program)."""

    __slots__ = ("flops", "bytes_accessed", "argument_bytes",
                 "output_bytes", "temp_bytes", "generated_code_bytes")

    def __init__(self, flops: float = 0.0, bytes_accessed: float = 0.0,
                 argument_bytes: int = 0, output_bytes: int = 0,
                 temp_bytes: int = 0, generated_code_bytes: int = 0) -> None:
        self.flops = float(flops)
        self.bytes_accessed = float(bytes_accessed)
        self.argument_bytes = int(argument_bytes)
        self.output_bytes = int(output_bytes)
        self.temp_bytes = int(temp_bytes)
        self.generated_code_bytes = int(generated_code_bytes)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.temp_bytes,
            "generated_code_bytes": self.generated_code_bytes,
        }


def _int_mm_flops(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    """``aten._int_mm``: 2·M·K·N, as ``mm``."""
    m, k = a_shape
    return 2 * m * k * b_shape[1]


#: ops that move no bytes: allocations (their contents are undefined)
_NO_TRAFFIC = frozenset(("empty", "empty_like", "empty_strided", "new_empty",
                         "new_empty_strided", "detach", "lift_fresh"))


def _nbytes(tree) -> int:
    """Bytes of every tensor (or array) in a nested structure."""
    import torch
    from torch.utils._pytree import tree_leaves

    total = 0
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif hasattr(leaf, "nbytes") and hasattr(leaf, "dtype"):
            total += int(leaf.nbytes)
    return total


def _bytes_mode():
    """A dispatch mode that sums each op's operand and result bytes."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _BytesAccessed(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.nbytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func.is_view and \
                    func.overloadpacket.__name__ not in _NO_TRAFFIC:
                self.nbytes += _nbytes((args, kwargs)) + _nbytes(out)
            return out

    return _BytesAccessed()


def analyze_torch_callable(
        fn: Callable[..., Any], *args: Any, device: Any = None,
        peak_sink: Optional[Callable[[str, int], None]] = None,
        **kwargs: Any) -> Tuple[Any, Optional[SignatureCost]]:
    """Run ``fn(*args, **kwargs)`` once, counted: ``(its result, its
    SignatureCost)``, the cost None where the analysis is off or the count
    failed (the result stands either way; an error of ``fn`` itself is
    raised).  ``device`` is the CUDA device whose allocator gives the
    temp bytes; its peak statistic is reset for the window, and
    ``peak_sink(device label, the peak before the reset)`` is called first
    where given, so a holder of "peak since start" keeps it."""
    if not analysis_enabled():
        return fn(*args, **kwargs), None
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ..ops import _count

    cuda = None
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and torch.cuda.is_available():
            cuda = dev
    before = 0
    if cuda is not None:
        if peak_sink is not None:
            peak_sink(f"cuda:{cuda.index or 0}",
                      torch.cuda.max_memory_allocated(cuda))
        torch.cuda.reset_peak_memory_stats(cuda)
        before = torch.cuda.memory_allocated(cuda)
    kernels = _count.KernelCount()
    flop_counter = FlopCounterMode(
        display=False,
        custom_mapping={torch.ops.aten._int_mm: _int_mm_flops})
    bytes_mode = _bytes_mode()
    with _count.counting(kernels), flop_counter, bytes_mode:
        result = fn(*args, **kwargs)
    out_bytes = _nbytes(result)
    temp = 0
    if cuda is not None:
        # the allocator accounts at enqueue, on the host: the peak is known
        # once fn returns, with no synchronisation
        temp = max(0, torch.cuda.max_memory_allocated(cuda) - before
                   - out_bytes)
    try:
        flops = float(flop_counter.get_total_flops()) + kernels.flops
    except Exception:  # noqa: BLE001 - observability never fails a request
        return result, None
    cost = SignatureCost(
        flops=flops, bytes_accessed=float(bytes_mode.nbytes) + kernels.bytes,
        argument_bytes=_nbytes((args, kwargs)), output_bytes=out_bytes,
        temp_bytes=temp)
    return result, cost


def warm_up() -> None:
    """Pay the counting's one-time set-up now: the first dispatch mode of
    a process imports PyTorch's tensor-subclass machinery (~2 s on a host
    CPU), which would otherwise land in the first counted request."""
    if analysis_enabled():
        import torch

        analyze_torch_callable(torch.add, torch.zeros(1), 1)


def classify_roofline(flops: float, bytes_accessed: float,
                      compute_s: Optional[float] = None,
                      pf: Optional[float] = None,
                      pb: Optional[float] = None) -> Optional[Dict[str, Any]]:
    """Roofline verdict for a (FLOPs, bytes) point: arithmetic intensity
    against the ridge ``peak_flops / peak_bytes_per_s`` (``compute_bound``
    at or above it, else ``memory_bound``); with a measured ``compute_s``,
    ``pct_of_peak``, the achieved percent of the bound resource's peak.
    None when either axis is unknown."""
    if flops <= 0.0 or bytes_accessed <= 0.0:
        return None
    if pf is None:
        from .device_stats import peak_flops

        pf = peak_flops()
    if pb is None:
        pb = peak_bytes_per_s()
    if pf <= 0.0 or pb <= 0.0:
        return None
    ai = flops / bytes_accessed
    ridge = pf / pb
    verdict = "compute_bound" if ai >= ridge else "memory_bound"
    out: Dict[str, Any] = {
        "arithmetic_intensity": round(ai, 4),
        "ridge_point": round(ridge, 4),
        "verdict": verdict,
    }
    if compute_s is not None and compute_s > 0.0:
        achieved = (flops / compute_s / pf if verdict == "compute_bound"
                    else bytes_accessed / compute_s / pb)
        out["pct_of_peak"] = round(achieved * 100.0, 4)
    return out


class _CostCell:
    """Cumulative per-(model, tenant) cost counters."""

    __slots__ = ("device_us", "flops", "tokens", "kv_byte_seconds")

    def __init__(self) -> None:
        self.device_us = 0.0
        self.flops = 0.0
        self.tokens = 0
        self.kv_byte_seconds = 0.0


class CostLedger:
    """Per-(model, tenant) cost attribution: device time (each request's
    slot share of its batch's compute window), FLOPs (the same share of
    the signature's counted FLOPs), generated tokens and KV byte-seconds
    (the decode slots' pins and the prefix cache's blocks, charged at
    release with the governor's own integral).  Beyond
    :data:`MAX_TRACKED_TENANTS` tenants, new ones fold into
    :data:`OVERFLOW_TENANT`.  ``enabled=False`` makes ``charge`` a no-op."""

    MAX_TRACKED_TENANTS = 1024
    OVERFLOW_TENANT = "~overflow"

    def __init__(self, enabled: Optional[bool] = None) -> None:
        if enabled is None:
            enabled = os.environ.get("TRITON_TPU_COST_LEDGER", "1") != "0"
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._cells: Dict[Tuple[str, str], _CostCell] = {}
        self._known_tenants: set = set()

    def _tenant_locked(self, tenant: str) -> str:
        if tenant in self._known_tenants:
            return tenant
        if len(self._known_tenants) < self.MAX_TRACKED_TENANTS:
            self._known_tenants.add(tenant)
            return tenant
        return self.OVERFLOW_TENANT

    def charge(self, model: str, tenant: str, device_us: float = 0.0,
               flops: float = 0.0, tokens: int = 0,
               kv_byte_seconds: float = 0.0) -> None:
        """Accumulate one attribution; tenant "" is a row of its own."""
        if not self.enabled:
            return
        with self._lock:
            key = (model, self._tenant_locked(tenant))
            cell = self._cells.get(key)
            if cell is None:
                cell = self._cells.setdefault(key, _CostCell())
            cell.device_us += device_us
            cell.flops += flops
            cell.tokens += int(tokens)
            cell.kv_byte_seconds += kv_byte_seconds

    def totals(self, model: Optional[str] = None) -> Dict[str, float]:
        """Counters summed over tenants (one model, or all)."""
        out = {"device_us": 0.0, "flops": 0.0, "tokens": 0,
               "kv_byte_seconds": 0.0}
        with self._lock:
            for (m, _t), cell in self._cells.items():
                if model is not None and m != model:
                    continue
                out["device_us"] += cell.device_us
                out["flops"] += cell.flops
                out["tokens"] += cell.tokens
                out["kv_byte_seconds"] += cell.kv_byte_seconds
        return out

    def metric_rows(self) -> Dict[str, list]:
        """``nv_cost_*`` sample rows keyed by short family name."""
        rows: Dict[str, list] = {"device_us": [], "flops": [],
                                 "tokens": [], "kv_byte_seconds": []}
        with self._lock:
            items = sorted(self._cells.items())
        for (m, t), cell in items:
            labels = {"model": m, "tenant": t}
            rows["device_us"].append((labels, round(cell.device_us, 3)))
            rows["flops"].append((labels, cell.flops))
            rows["tokens"].append((labels, cell.tokens))
            rows["kv_byte_seconds"].append(
                (labels, round(cell.kv_byte_seconds, 6)))
        return rows

    def snapshot(self, model: Optional[str] = None) -> Dict[str, Any]:
        """The ``/v2/debug/costs`` JSON: per-model, per-tenant totals."""
        with self._lock:
            items = sorted(self._cells.items())
        models: Dict[str, Any] = {}
        for (m, t), cell in items:
            if model is not None and m != model:
                continue
            models.setdefault(m, {})[t] = {
                "device_us": round(cell.device_us, 3),
                "flops": cell.flops,
                "tokens": cell.tokens,
                "kv_byte_seconds": round(cell.kv_byte_seconds, 6),
            }
        return {"enabled": self.enabled, "models": models}

    def reset(self) -> None:
        with self._lock:
            self._cells = {}
            self._known_tenants = set()


def merge_cost_snapshots(
        snapshots: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Sum :meth:`CostLedger.snapshot` dicts into one; malformed entries
    are skipped."""
    merged: Dict[str, Dict[str, Dict[str, Any]]] = {}
    enabled = False
    for snap in snapshots:
        if not isinstance(snap, dict):
            continue
        enabled = enabled or bool(snap.get("enabled"))
        for m, tenants in (snap.get("models") or {}).items():
            if not isinstance(tenants, dict):
                continue
            dst_m = merged.setdefault(m, {})
            for t, cell in tenants.items():
                if not isinstance(cell, dict):
                    continue
                dst = dst_m.setdefault(t, {"device_us": 0.0, "flops": 0.0,
                                           "tokens": 0,
                                           "kv_byte_seconds": 0.0})
                for key in ("device_us", "flops", "kv_byte_seconds"):
                    try:
                        dst[key] = round(dst[key] + float(
                            cell.get(key, 0.0)), 6)
                    except (TypeError, ValueError):
                        pass
                try:
                    dst["tokens"] += int(cell.get("tokens", 0))
                except (TypeError, ValueError):
                    pass
    return {"enabled": enabled, "models": merged}
