"""Model warmup: the configured samples, run before a model serves.

The port's copy of ``triton_client_tpu/server/warmup.py``.
``ModelConfig.model_warmup`` (Triton's ``ModelWarmup`` messages) lists
synthetic requests that the core runs through the model's real execute
path at server start and at every repository load
(``InferenceCore._warmup_one``), so that a first user request does not pay
for building the weights on the card or for the counted first execution of
its input signature.  A BF16 input is a ``torch.bfloat16`` host tensor, as
the server holds one from the wire.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..protocol import inference as pb
from ..utils import triton_to_np_dtype
from .model import Model
from .types import InferError

_DTYPES = {v: k for k, v in pb.ENUMS["DataType"].items()}


def _datatype(number: int) -> str:
    label = _DTYPES.get(number, "TYPE_INVALID")
    return "BYTES" if label == "TYPE_STRING" else label[len("TYPE_"):]


def build_warmup_inputs(model: Model, sample,
                        model_dir: str = "") -> Dict[str, Any]:
    """The input dict of one ModelWarmup sample."""
    rng = np.random.default_rng(0)
    inputs: Dict[str, Any] = {}
    for name, spec in sample.inputs.items():
        dtype_str = _datatype(spec.data_type)
        dims = [int(d) for d in spec.dims]
        if sample.batch_size > 0 and model.max_batch_size > 0:
            dims = [int(sample.batch_size)] + dims
        kind = spec.WhichOneof("input_data_type")
        np_dtype = (np.dtype(np.float32) if dtype_str == "BF16"
                    else triton_to_np_dtype(dtype_str))
        if dtype_str == "BYTES":
            arr = np.full(dims, b"", dtype=object)
        elif kind == "random_data":
            if np.issubdtype(np_dtype, np.integer):
                arr = rng.integers(0, 127, dims).astype(np_dtype)
            else:
                arr = rng.standard_normal(dims).astype(np_dtype)
        elif kind == "input_data_file":
            path = os.path.join(model_dir, "warmup", spec.input_data_file) \
                if model_dir else spec.input_data_file
            if not os.path.isfile(path):
                raise InferError(
                    f"warmup '{sample.name}': data file not found: {path}")
            if dtype_str == "BF16":
                bits = np.fromfile(path, dtype=np.int16).reshape(dims)
                inputs[name] = torch.from_numpy(bits).view(torch.bfloat16)
                continue
            arr = np.fromfile(path, dtype=np_dtype).reshape(dims)
        else:  # zero_data (and the default where no member is set)
            arr = np.zeros(dims, dtype=np_dtype)
        inputs[name] = (torch.from_numpy(arr).to(torch.bfloat16)
                        if dtype_str == "BF16" else arr)
    return inputs


def warmup_samples(model: Model) -> List[Tuple[str, int, Dict[str, Any]]]:
    """(name, repeat count, inputs) of each configured warmup sample; an
    ``input_data_file`` resolves in ``<model_dir>/warmup/`` for a model
    loaded from a repository (Triton's layout)."""
    model_dir = getattr(model, "model_dir", "") or ""
    out = []
    for sample in model.config.model_warmup:
        count = max(int(sample.count), 1)
        out.append((sample.name or "warmup", count,
                    build_warmup_inputs(model, sample, model_dir)))
    return out
