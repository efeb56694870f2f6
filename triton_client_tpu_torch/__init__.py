"""PyTorch/CUDA port of ``triton_client_tpu`` for NVIDIA Hopper (H100).

A second package beside the JAX reference.  It imports ``torch`` and numpy,
never ``jax`` and nothing of ``triton_client_tpu``; where it needs a piece of
the reference's device-agnostic code it keeps its own copy.  Module names
mirror the reference's so each port module's counterpart is easy to find.

It serves the transformer family (``bert_large``, ``longctx_tpu``,
``moe_tpu``, ``llama_tpu`` and ``ensemble_llama``) over the v2 HTTP protocol
with hand-written CUDA kernels for flash attention and the fused int8 matmul
(``ops/``, sources in ``csrc/``), tensors in the body or in shared-memory
regions: system (``utils.shared_memory``) or CUDA, mapped across processes
with cudaIPC (``utils.cuda_shared_memory``, ``server.shm``).  Its own v2
HTTP client (``http``, on kept-alive ``http.client`` connections) and load
generator (``python -m triton_client_tpu_torch.perf_analyzer``) drive it.
"""
