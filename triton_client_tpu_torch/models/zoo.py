"""The port's model zoo.

Counterpart of ``triton_client_tpu/models/zoo.py`` for this slice:
``simple`` (the protocol fixture: two INT32 [1, 16] inputs, their sum and
difference, host placed) and ``longctx_tpu`` (``models/language.py``).  The
other fixtures wait for later slices.
"""

from __future__ import annotations

from ..server.model import TorchModel, make_config
from ..server.registry import ModelRegistry


def make_simple() -> TorchModel:
    cfg = make_config(
        "simple",
        inputs=[("INPUT0", "INT32", [1, 16]), ("INPUT1", "INT32", [1, 16])],
        outputs=[("OUTPUT0", "INT32", [1, 16]),
                 ("OUTPUT1", "INT32", [1, 16])],
        # host math: the protocol path must not pay device transfers
        instance_kind="KIND_CPU",
    )

    def fn(INPUT0, INPUT1):
        return {"OUTPUT0": INPUT0 + INPUT1, "OUTPUT1": INPUT0 - INPUT1}

    return TorchModel(cfg, fn)


def register_all(registry: ModelRegistry, device=None) -> None:
    """Register every ported model; ``longctx_tpu`` on ``device`` (default
    CUDA)."""
    from . import language

    registry.register_model(make_simple())
    registry.register_model(language.make_longctx_tpu(device))
