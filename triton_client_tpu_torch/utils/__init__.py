"""Triton v2 dtype maps (the port's own copy of the reference's
``triton_client_tpu/utils/__init__.py`` dtype helpers).

``BF16`` maps to ``ml_dtypes.bfloat16`` where that package is installed,
else to no numpy dtype.  BYTES maps to ``object``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

try:
    import ml_dtypes

    _BF16_NP: Optional[np.dtype] = np.dtype(ml_dtypes.bfloat16)
except ImportError:  # not every install ships ml_dtypes
    _BF16_NP = None

_NP_TO_TRITON = {
    np.dtype(np.bool_): "BOOL",
    np.dtype(np.int8): "INT8",
    np.dtype(np.int16): "INT16",
    np.dtype(np.int32): "INT32",
    np.dtype(np.int64): "INT64",
    np.dtype(np.uint8): "UINT8",
    np.dtype(np.uint16): "UINT16",
    np.dtype(np.uint32): "UINT32",
    np.dtype(np.uint64): "UINT64",
    np.dtype(np.float16): "FP16",
    np.dtype(np.float32): "FP32",
    np.dtype(np.float64): "FP64",
}
if _BF16_NP is not None:
    _NP_TO_TRITON[_BF16_NP] = "BF16"

_TRITON_TO_NP = {v: k for k, v in _NP_TO_TRITON.items()}
_TRITON_TO_NP["BYTES"] = np.dtype(np.object_)


def np_to_triton_dtype(np_dtype) -> Optional[str]:
    """Map a numpy dtype to its Triton v2 dtype string."""
    dt = np.dtype(np_dtype)
    if dt in _NP_TO_TRITON:
        return _NP_TO_TRITON[dt]
    if dt.kind in ("O", "S", "U"):
        return "BYTES"
    return None


def triton_to_np_dtype(dtype: str):
    """Map a Triton v2 dtype string to a numpy dtype (None if unknown)."""
    return _TRITON_TO_NP.get(dtype, None)
