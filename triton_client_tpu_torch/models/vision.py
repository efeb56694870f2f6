"""ResNet-50 of the port (BASELINE row 2: ``image_client.py`` over async
gRPC).

Counterpart of ``triton_client_tpu/models/vision.py``: the ResNet-50 v1.5
architecture (bottleneck stages ``[3, 4, 6, 3]``, the stride on each
stage's first 3x3 convolution, 25.5 M parameters), ``INPUT FP32 [3, 224,
224] -> OUTPUT FP32 [1000]`` with classification labels ``class_{i}``.

The reference writes it in jnp and leaves the convolutions to XLA, so the
port's are ``torch.nn.functional.conv2d`` (cuDNN on the card).  The
arithmetic follows the reference step for step: each convolution is
followed by ``x * scale + bias`` in the compute dtype (inference batch
norm, not folded into the weights), a 7x7/2 stem with padding 3, a 3x3/2
max pool with padding 1 (padded with -inf, as ``F.max_pool2d`` pads), a
global mean in the compute dtype, then the ``fc`` in f32.

Convolution weights are OIHW (the reference's are HWIO:
:func:`params_from_jax` carries them across).  On CUDA the model serves in
bf16, activations and weights ``channels_last``; on the CPU in f32 (the
port's CPU path is for tests).  Weights are random, drawn from a
``torch.Generator`` at the first request, so not the reference's numbers.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import instance_kind, resolve_device
from ..server.model import TorchModel, make_config

# bottleneck stage plan: (blocks, mid_channels); expansion x4
STAGES = ((3, 64), (4, 128), (6, 256), (3, 512))
EXPANSION = 4
IMAGE_SIZE = 224
NUM_CLASSES = 1000
LABELS = [f"class_{i}" for i in range(NUM_CLASSES)]
SEED = 50  # the reference's PRNGKey(50)


def _convs() -> Iterator[Tuple[str, int, int, int, int, str, str]]:
    """Each convolution in the reference's order: (name, out channels, in
    channels, kernel, stride, its scale's name, its bias's name)."""
    yield "stem", 64, 3, 7, 2, "stem_scale", "stem_bias"
    cin = 64
    for si, (blocks, mid) in enumerate(STAGES):
        cout = mid * EXPANSION
        for bi in range(blocks):
            pfx = f"s{si}b{bi}"
            stride = 2 if (bi == 0 and si > 0) else 1
            yield f"{pfx}_c1", mid, cin, 1, 1, f"{pfx}_s1", f"{pfx}_b1"
            yield f"{pfx}_c2", mid, mid, 3, stride, f"{pfx}_s2", f"{pfx}_b2"
            yield f"{pfx}_c3", cout, mid, 1, 1, f"{pfx}_s3", f"{pfx}_b3"
            if bi == 0:
                yield (f"{pfx}_proj", cout, cin, 1, stride, f"{pfx}_proj_s",
                       f"{pfx}_proj_b")
            cin = cout


_CONVS = {c[0]: c for c in _convs()}


def _place(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Convolution weights ``channels_last`` on the card."""
    return {k: v.contiguous(memory_format=torch.channels_last)
            if v.dim() == 4 and v.is_cuda else v for k, v in params.items()}


def init_params(seed: int, dtype: torch.dtype,
                device) -> Dict[str, torch.Tensor]:
    """The reference's initialisation (He-normal convolutions, unit scales,
    zero biases, ``fc`` normal x 0.01, an f32 ``fc_bias`` of zeros), drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device``."""
    dev = torch.device(device)
    gen = torch.Generator(dev).manual_seed(seed)

    def normal(*shape, std):
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=dev) * std).to(dtype)

    p: Dict[str, torch.Tensor] = {}
    for name, cout, cin, k, _, scale, bias in _CONVS.values():
        p[name] = normal(cout, cin, k, k, std=math.sqrt(2.0 / (k * k * cin)))
        p[scale] = torch.ones(cout, dtype=dtype, device=dev)
        p[bias] = torch.zeros(cout, dtype=dtype, device=dev)
    p["fc"] = normal(STAGES[-1][1] * EXPANSION, NUM_CLASSES, std=0.01)
    p["fc_bias"] = torch.zeros(NUM_CLASSES, dtype=torch.float32, device=dev)
    return _place(p)


def params_from_jax(np_params: Dict[str, np.ndarray], dtype: torch.dtype,
                    device) -> Dict[str, torch.Tensor]:
    """The reference's parameter dict, carried across as numpy arrays:
    HWIO convolution weights become OIHW, every array ``dtype`` except
    ``fc_bias``, which stays f32 as in the reference."""
    out = {}
    for name, arr in np_params.items():
        a = np.array(arr, dtype=np.float32)  # a writable copy
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        out[name] = t if name == "fc_bias" else t.to(dtype)
    return _place(out)


def forward(params: Dict[str, torch.Tensor], x: torch.Tensor
            ) -> torch.Tensor:
    """Logits f32 ``[N, 1000]`` of images ``x`` ``[N, 3, H, W]``, in the
    dtype of ``params``' convolutions."""
    x = x.to(params["stem"].dtype)
    if x.is_cuda:
        x = x.contiguous(memory_format=torch.channels_last)

    def conv(x, name, relu=True):
        _, _, _, k, stride, scale, bias = _CONVS[name]
        y = F.conv2d(x, params[name], stride=stride, padding=k // 2)
        y = y * params[scale][:, None, None] + params[bias][:, None, None]
        return F.relu(y) if relu else y

    x = F.max_pool2d(conv(x, "stem"), 3, 2, 1)
    for si, (blocks, _mid) in enumerate(STAGES):
        for bi in range(blocks):
            pfx = f"s{si}b{bi}"
            sc = conv(x, f"{pfx}_proj", relu=False) if bi == 0 else x
            y = conv(x, f"{pfx}_c1")
            y = conv(y, f"{pfx}_c2")
            y = conv(y, f"{pfx}_c3", relu=False)
            x = F.relu(y + sc)
    x = x.mean(dim=(2, 3))  # global average pool, in the compute dtype
    return x.float() @ params["fc"].float() + params["fc_bias"]


def forward_flops(image_size: int = IMAGE_SIZE) -> float:
    """FLOPs (2 per multiply-add) of one image's forward: every
    convolution and the ``fc``, from the stage plan."""
    size = (image_size + 2 * 3 - 7) // 2 + 1           # the stem's output
    macs = size * size * 64 * 3 * 7 * 7
    size = (size + 2 * 1 - 3) // 2 + 1                 # the max pool's
    cin = 64
    for si, (blocks, mid) in enumerate(STAGES):
        cout = mid * EXPANSION
        for bi in range(blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            out = (size - 1) // stride + 1
            macs += size * size * mid * cin                # c1
            macs += out * out * mid * mid * 3 * 3          # c2
            macs += out * out * cout * mid                 # c3
            if bi == 0:
                macs += out * out * cout * cin             # proj
            size, cin = out, cout
    macs += cin * NUM_CLASSES                              # fc
    return 2.0 * macs


class LazyResNet:
    """Params and forward built on the first call, on one device.
    ``params`` (a numpy dict in the reference's layout) replaces the seeded
    initialisation."""

    def __init__(self, device: torch.device, dtype: torch.dtype,
                 seed: int = SEED,
                 params: Optional[Dict[str, np.ndarray]] = None):
        self.device, self.dtype, self._seed = device, dtype, seed
        self._np_params = params
        self._lock = threading.Lock()
        self.params: Optional[Dict[str, torch.Tensor]] = None

    def _ensure(self) -> Dict[str, torch.Tensor]:
        with self._lock:
            if self.params is None:
                self.params = (
                    init_params(self._seed, self.dtype, self.device)
                    if self._np_params is None else
                    params_from_jax(self._np_params, self.dtype, self.device))
            return self.params

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return forward(self._ensure(), x)


def make_resnet50(device=None,
                  params: Optional[Dict[str, np.ndarray]] = None
                  ) -> TorchModel:
    """BASELINE row 2: ``INPUT FP32 [3, 224, 224] -> OUTPUT FP32 [1000]``
    with labels, dynamic batching to 32 (preferred 1/4/8/16/32, 2,000 us),
    as the reference configures it; bf16 on CUDA, f32 on the CPU."""
    dev = resolve_device(device)
    cfg = make_config(
        "resnet50",
        inputs=[("INPUT", "FP32", [3, IMAGE_SIZE, IMAGE_SIZE])],
        outputs=[("OUTPUT", "FP32", [NUM_CLASSES])],
        max_batch_size=32,
        preferred_batch_sizes=[1, 4, 8, 16, 32],
        max_queue_delay_us=2000,
        instance_kind=instance_kind(dev),
        labels={"OUTPUT": LABELS},
    )
    run = LazyResNet(dev, torch.bfloat16 if dev.type == "cuda"
                     else torch.float32, params=params)

    def fn(INPUT):
        return {"OUTPUT": run(INPUT)}

    model = TorchModel(cfg, fn, output_labels={"OUTPUT": LABELS})
    model.resnet = run
    return model


__all__ = ["IMAGE_SIZE", "LABELS", "LazyResNet", "STAGES", "forward",
           "forward_flops", "init_params", "make_resnet50",
           "params_from_jax"]
