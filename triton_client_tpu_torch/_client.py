"""Client base with plugin support (counterpart of
``triton_client_tpu/_client.py``): a registered plugin is called before
every request and may change its headers (to add auth, for example).  One
plugin at a time."""

from __future__ import annotations

from typing import Optional

from ._plugin import InferenceServerClientPlugin
from ._request import Request


class InferenceServerClientBase:
    def __init__(self):
        self._plugin: Optional[InferenceServerClientPlugin] = None

    def _call_plugin(self, request: Request) -> None:
        if self._plugin is not None:
            self._plugin(request)

    def register_plugin(self, plugin: InferenceServerClientPlugin) -> None:
        """Register ``plugin``; raises if one is registered already."""
        if self._plugin is not None:
            raise RuntimeError(
                "A plugin is already registered. Unregister it first.")
        if not isinstance(plugin, InferenceServerClientPlugin):
            raise ValueError("plugin must be an InferenceServerClientPlugin")
        self._plugin = plugin

    def plugin(self) -> Optional[InferenceServerClientPlugin]:
        """The registered plugin, or None."""
        return self._plugin

    def unregister_plugin(self) -> None:
        """Unregister the plugin; raises if none is registered."""
        if self._plugin is None:
            raise RuntimeError("No plugin is registered.")
        self._plugin = None
