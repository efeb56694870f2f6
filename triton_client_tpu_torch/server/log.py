"""Server logging behind the ``/v2/logging`` settings API.

The port's copy of ``triton_client_tpu/server/log.py``.  The settings
(``log_file``, the ``log_info`` / ``log_warning`` / ``log_error`` gates,
``log_verbose_level``, ``log_format``) are read live from
``InferenceCore.log_settings`` at each line, so an update applies to the
next one.  Line shapes:

* ``default``:  ``I0731 12:34:56.789012 model 'simple' loaded``;
* ``ISO8601``:  ``2026-07-31T12:34:56Z I model 'simple' loaded``;
* ``json``:     ``{"level": "info", "ts": <epoch s>, "msg": "...",
  "request_id": "..."}``, ``request_id`` where the line was written for a
  request (passed in, or the traced request of this thread).

An empty ``log_file`` writes to stderr; a path appends.  The port's
frontends serve a request per thread, so a line is written on the thread
that logs it (the reference hands it to a one-thread executor off its event
loop).
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict

from .._telemetry import AppendFile

#: the server's log settings at start-up
LOG_DEFAULTS: Dict[str, Any] = {
    "log_file": "",
    "log_info": True,
    "log_warning": True,
    "log_error": True,
    "log_verbose_level": 0,
    "log_format": "default",
}


class ServerLog:
    """Writes through a live reference to ``InferenceCore.log_settings``."""

    def __init__(self, settings: Dict[str, Any]) -> None:
        self._settings = settings
        self._out = AppendFile()

    def info(self, msg: str, request_id: str = "") -> None:
        self._emit("info", msg, request_id)

    def warning(self, msg: str, request_id: str = "") -> None:
        self._emit("warning", msg, request_id)

    def error(self, msg: str, request_id: str = "") -> None:
        self._emit("error", msg, request_id)

    def verbose(self, level: int, msg: str, request_id: str = "") -> None:
        if self.verbose_enabled(level):
            self._emit("info", msg, request_id)

    def verbose_enabled(self, level: int = 1) -> bool:
        """Cheap guard, so callers skip building a message."""
        try:
            return int(self._settings.get("log_verbose_level", 0)) >= level
        except (TypeError, ValueError):
            return False

    @staticmethod
    def _request_id_fallback() -> str:
        from .trace import current_trace

        trace = current_trace()
        if trace is not None:
            return trace.client_request_id or str(trace.id)
        return ""

    def _emit(self, level: str, msg: str, request_id: str = "") -> None:
        if not bool(self._settings.get(f"log_{level}", True)):
            return
        now = time.time()
        fmt = str(self._settings.get("log_format", "default"))
        if fmt == "json":
            record: Dict[str, Any] = {"level": level, "ts": now, "msg": msg}
            rid = request_id or self._request_id_fallback()
            if rid:
                record["request_id"] = rid
            line = json.dumps(record) + "\n"
        elif fmt == "ISO8601":
            stamp = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(now))
            line = f"{stamp} {level[0].upper()} {msg}\n"
        else:
            t = time.localtime(now)
            us = int((now % 1) * 1e6)
            line = (f"{level[0].upper()}{t.tm_mon:02d}{t.tm_mday:02d} "
                    f"{t.tm_hour:02d}:{t.tm_min:02d}:{t.tm_sec:02d}"
                    f".{us:06d} {msg}\n")
        path = str(self._settings.get("log_file") or "")
        if not path:
            sys.stderr.write(line)
            return
        self._out.append(path, line)

    def shutdown(self) -> None:
        self._out.close()
