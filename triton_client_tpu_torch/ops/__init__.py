"""Hand-written Hopper kernels for the hot ops, each beside its plain version.

Counterpart of ``triton_client_tpu/ops``: the two Pallas TPU kernels become
CUDA C++ kernels under ``csrc/`` (built by :mod:`._build`).  Each wrapper
launches its kernel for CUDA tensors and takes the plain PyTorch version only
for CPU tensors.
"""

from .flash_attention import flash_attention, flash_attention_reference
from .int8_matmul import (int8_matmul, int8_matmul_reference,
                          int8_quantize_rows, int8_quantize_rows_reference)

__all__ = ["flash_attention", "flash_attention_reference",
           "int8_matmul", "int8_matmul_reference",
           "int8_quantize_rows", "int8_quantize_rows_reference"]
