"""The port's model zoo.

Counterpart of ``triton_client_tpu/models/zoo.py`` for the ported models:
``simple`` (the protocol fixture: two INT32 [1, 16] inputs, their sum and
difference, host placed) and the language models of ``models/language.py``
(``bert_large``, ``longctx_tpu``, ``moe_tpu``, ``llama_tpu`` and the
``ensemble_llama`` chain).  The other fixtures wait for later slices.
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
    """Register every ported model; the transformer models on ``device``
    (default CUDA).  Registration is cheap: each transformer draws its
    weights at its first request."""
    from . import language

    registry.register_model(make_simple())
    registry.register_model(language.make_bert_large(device))
    registry.register_model(language.make_longctx_tpu(device))
    registry.register_model(language.make_moe_tpu(device))
    registry.register_model(language.make_llama_preprocess())
    registry.register_model(language.make_llama_tpu(device))
    registry.register_model(language.make_llama_postprocess())
    registry.register_model(language.make_ensemble_llama())
