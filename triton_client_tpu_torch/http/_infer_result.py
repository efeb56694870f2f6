"""HTTP-protocol ``InferResult`` (counterpart of
``triton_client_tpu/http/_infer_result.py``): a v2 response body, gzip or
deflate decoded where the server encoded it, its JSON header parsed and
each binary output sliced from the rest by ``binary_data_size``."""

from __future__ import annotations

import gzip
import json
import zlib
from typing import Optional

import numpy as np

from ..utils import (deserialize_bf16_tensor, deserialize_bytes_tensor,
                     triton_to_np_dtype)


class InferResult:
    def __init__(self, response_body: bytes, verbose: bool = False,
                 header_length: Optional[int] = None,
                 content_encoding: Optional[str] = None, headers=None):
        """Parse a v2 infer response body.  ``headers``: the HTTP response
        headers, kept with lower-case names."""
        self._headers = ({k.lower(): v for k, v in dict(headers).items()}
                         if headers else {})
        if content_encoding == "gzip":
            response_body = gzip.decompress(response_body)
        elif content_encoding == "deflate":
            response_body = zlib.decompress(response_body)

        self._buffer_map = {}
        if header_length is None:
            self._result = json.loads(response_body)
        else:
            body_view = memoryview(response_body)
            self._result = json.loads(response_body[:header_length])
            offset = header_length
            for output in self._result.get("outputs", []):
                size = output.get("parameters", {}).get("binary_data_size")
                if size is not None:
                    # views of the one response buffer, no copies
                    self._buffer_map[output["name"]] = \
                        body_view[offset:offset + size]
                    offset += size
        if verbose:
            print(self._result)

    @classmethod
    def from_response_body(cls, response_body, verbose=False,
                           header_length=None, content_encoding=None):
        """A result from a stored response body."""
        return cls(response_body, verbose, header_length, content_encoding)

    def as_numpy(self, name: str) -> Optional[np.ndarray]:
        """The named output as a numpy array (BYTES: an object array of
        bytes; BF16: bfloat16 where ``ml_dtypes`` is installed), or None
        where the response has no such output or its data lies in a
        shared-memory region."""
        output = self.get_output(name)
        if output is None:
            return None
        shape = [int(s) for s in output["shape"]]
        datatype = output["datatype"]
        if name in self._buffer_map:
            buf = self._buffer_map[name]
            if datatype == "BYTES":
                return deserialize_bytes_tensor(buf).reshape(shape)
            if datatype == "BF16":
                return deserialize_bf16_tensor(buf).reshape(shape)
            return np.frombuffer(
                buf, dtype=triton_to_np_dtype(datatype)).reshape(shape)
        if "data" not in output:
            return None
        data = output["data"]
        if datatype == "BYTES":
            return np.array(
                [x.encode("utf-8") if isinstance(x, str) else bytes(x)
                 for x in data], dtype=np.object_).reshape(shape)
        return np.array(data, dtype=triton_to_np_dtype(datatype)).reshape(
            shape)

    def get_output(self, name: str) -> Optional[dict]:
        """The output's JSON dict, or None."""
        for output in self._result.get("outputs", []):
            if output["name"] == name:
                return output
        return None

    def get_response(self) -> dict:
        """The whole response JSON dict."""
        return self._result

    def get_headers(self) -> dict:
        """The HTTP response headers, names lower-case; empty for a result
        parsed from a stored body."""
        return self._headers
