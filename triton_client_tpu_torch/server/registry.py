"""In-process model registry of the port's serving harness.

Counterpart of the programmatic half of ``triton_client_tpu/server/
registry.py``: register, get, index and readiness.  Every model serves one
version, ``"1"``.  Loading a Triton-style repository from disk and the
load/unload API are not ported yet.
"""

from __future__ import annotations

import threading
from typing import Dict, List

from .model import Model
from .types import InferError


class ModelRegistry:
    def __init__(self):
        self._models: Dict[str, Model] = {}
        self._lock = threading.Lock()

    def register_model(self, model: Model) -> None:
        with self._lock:
            self._models[model.name] = model

    def get(self, name: str, version: str = "") -> Model:
        with self._lock:
            model = self._models.get(name)
        if model is None:
            raise InferError(f"Request for unknown model: '{name}' is not "
                             "found", http_status=400)
        if version and version != model.served_version:
            raise InferError(
                f"Request for unknown model: '{name}' version {version} is "
                "not found", http_status=400)
        return model

    def is_ready(self, name: str, version: str = "") -> bool:
        try:
            self.get(name, version)
        except InferError:
            return False
        return True

    def models(self) -> List[Model]:
        with self._lock:
            return list(self._models.values())

    def index(self) -> List[dict]:
        """v2 repository index entries (every registered model is READY)."""
        return [{"name": m.name, "version": m.served_version,
                 "state": "READY", "reason": ""}
                for m in sorted(self.models(), key=lambda m: m.name)]
