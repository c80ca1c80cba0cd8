"""Structured logging — the ``emqx_logger_jsonfmt.erl`` /
``emqx_logger_textfmt.erl`` + ``?SLOG`` surface (SURVEY §5: structured
log events carry clientid/topic metadata the trace handlers filter on).

``slog(level, msg, **fields)`` is the ?SLOG analogue: fields travel as
record attributes (not rendered into the message), so the JSON
formatter emits them as first-class keys and the text formatter
appends them as ``k: v`` pairs — the reference's two console formats.

``setup_logging`` wires a console handler onto the ``emqx_tpu_torch`` logger
tree; config drives it via ``log.console`` (emqx_conf_schema's log
handlers, minimal subset).
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Any, Optional

# standard LogRecord attributes — anything else on the record is a
# structured field (came in via `extra=`)
_RESERVED = frozenset(logging.LogRecord(
    "", 0, "", 0, "", (), None).__dict__) | {
    "message", "asctime", "taskName"}


def _fields(record: logging.LogRecord) -> dict:
    return {k: v for k, v in record.__dict__.items()
            if k not in _RESERVED and not k.startswith("_")}


def _ts(record: logging.LogRecord) -> str:
    t = time.localtime(record.created)
    return (time.strftime("%Y-%m-%dT%H:%M:%S", t) +
            f".{int(record.msecs):03d}")


class JsonFormatter(logging.Formatter):
    """One JSON object per line (emqx_logger_jsonfmt)."""

    def format(self, record: logging.LogRecord) -> str:
        out: dict[str, Any] = {
            "time": _ts(record),
            "level": record.levelname.lower(),
            "msg": record.getMessage(),
            "logger": record.name,
        }
        out.update(_fields(record))
        if record.exc_info:
            out["exception"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


class TextFormatter(logging.Formatter):
    """``2026-07-30T12:00:00.123 [warning] msg, clientid: c1`` —
    the reference's console text format."""

    def format(self, record: logging.LogRecord) -> str:
        parts = [f"{_ts(record)} [{record.levelname.lower()}] "
                 f"{record.getMessage()}"]
        for k, v in _fields(record).items():
            parts.append(f"{k}: {v}")
        line = ", ".join(parts)
        if record.exc_info:
            line += "\n" + self.formatException(record.exc_info)
        return line


_LEVELS = {"debug": logging.DEBUG, "info": logging.INFO,
           "warning": logging.WARNING, "error": logging.ERROR,
           "critical": logging.CRITICAL}


def setup_logging(level: str = "warning", formatter: str = "text",
                  stream=None, to: str = "console",
                  file_path: str = "log/emqx.log",
                  logger_name: str = "emqx_tpu_torch") -> logging.Handler:
    """Configure the framework logger tree's handlers
    (emqx_conf_schema log.console / log.file: ``to`` selects console,
    file, or both; the file handler creates its directory). Replaces
    handlers a previous call installed; returns the console (or sole)
    handler. The tree owns its output (propagate=False) — like the
    reference's dedicated logger handlers, records do not ALSO flow to
    root handlers."""
    import os

    logger = logging.getLogger(logger_name)
    logger.setLevel(_LEVELS.get(level, logging.WARNING))
    for h in list(logger.handlers):
        if getattr(h, "_emqx_console", False):
            logger.removeHandler(h)
            if isinstance(h, logging.FileHandler):
                h.close()
    fmt = JsonFormatter() if formatter == "json" else TextFormatter()
    handler: Optional[logging.Handler] = None
    if to in ("console", "both"):
        handler = logging.StreamHandler(stream or sys.stderr)
        handler._emqx_console = True
        handler.setFormatter(fmt)
        logger.addHandler(handler)
    if to in ("file", "both"):
        d = os.path.dirname(file_path)
        if d:
            os.makedirs(d, exist_ok=True)
        fh = logging.FileHandler(file_path)
        fh._emqx_console = True           # same replace-on-reconfigure
        fh.setFormatter(fmt)
        logger.addHandler(fh)
        handler = handler or fh
    logger.propagate = False
    return handler


# extra= keys that would collide with LogRecord's own attributes make
# stdlib makeRecord RAISE ("Attempt to overwrite ..."), crashing the
# caller that merely tried to log — natural ?SLOG field names like
# `name` or `module` land in this set, so they are suffixed instead
_EXTRA_RESERVED = frozenset(logging.LogRecord(
    "", 0, "", 0, "", (), None).__dict__) | {"message", "asctime"}


def slog(level: str, msg: str, *, logger: Optional[str] = None,
         **fields: Any) -> None:
    """?SLOG: structured fields ride the record, not the message."""
    safe = {(k if k not in _EXTRA_RESERVED else k + "_"): v
            for k, v in fields.items()}
    logging.getLogger(logger or "emqx_tpu_torch").log(
        _LEVELS.get(level, logging.INFO), msg, extra=safe)
