"""Client plugin base (counterpart of ``triton_client_tpu/_plugin.py``)."""

from __future__ import annotations

import abc

from ._request import Request


class InferenceServerClientPlugin(abc.ABC):
    """A plugin implements ``__call__`` and changes ``request.headers`` in
    place.  The client calls it right before every HTTP request."""

    @abc.abstractmethod
    def __call__(self, request: Request) -> None:
        ...
