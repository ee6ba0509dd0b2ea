"""Leveled structured logging for the port's runtime layers.

A tiny leveled logger whose records are ``(level, msg, fields)`` tuples
rendered as ``[repro:LEVEL] msg key=value ...`` lines, the same lines
the reference package writes, so logs of the two packages read alike.

* **Quiet by default.** The default level is ``warning`` so library code
  can narrate (``info``/``debug``) without polluting benchmark stdout;
  ``python -m repro_torch.bench --verbose`` opts into ``info``.
* **Structured.** Every record carries its key/value fields, so a
  capture handler (tests, trace tooling) sees data, not strings.
* **Capturable.** :meth:`StructuredLogger.capture` collects records
  regardless of level.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
from typing import Any, Dict, Iterator, List, Optional, TextIO

__all__ = ["LEVELS", "LOG", "LogRecord", "StructuredLogger"]

LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40}


@dataclasses.dataclass(frozen=True)
class LogRecord:
    """One structured emission: level name, message, and fields."""

    level: str
    msg: str
    fields: Dict[str, Any]

    def render(self) -> str:
        """The one-line form: ``[repro:LEVEL] msg k=v ...``, keys sorted."""
        parts = [f"[repro:{self.level}] {self.msg}"]
        parts.extend(f"{k}={self.fields[k]}" for k in sorted(self.fields))
        return " ".join(parts)


def _check_level(level: str) -> None:
    if level not in LEVELS:
        raise ValueError(f"unknown log level {level!r}; "
                         f"expected one of {sorted(LEVELS)}")


class StructuredLogger:
    """A leveled logger writing one-line structured records to a stream.

    Not a wrapper over :mod:`logging`: one instance (:data:`LOG`), one
    level, one stream, plus an explicit capture stack for tests.
    """

    def __init__(self, level: str = "warning",
                 stream: Optional[TextIO] = None):
        _check_level(level)
        self.level = level
        self.stream = stream
        self._captures: List[List[LogRecord]] = []

    def configure(self, *, level: Optional[str] = None,
                  stream: Optional[TextIO] = None) -> None:
        """Set level and/or stream (CLI entry points call this once)."""
        if level is not None:
            _check_level(level)
            self.level = level
        if stream is not None:
            self.stream = stream

    def enabled_for(self, level: str) -> bool:
        """Whether a record at ``level`` reaches the stream."""
        return LEVELS[level] >= LEVELS[self.level]

    def log(self, level: str, msg: str, **fields: Any) -> None:
        """Emit one record to every open capture and, if enabled, the stream."""
        if level not in LEVELS:
            raise ValueError(f"unknown log level {level!r}")
        rec = LogRecord(level=level, msg=msg, fields=fields)
        for sink in self._captures:
            sink.append(rec)
        if self.enabled_for(level):
            out = self.stream if self.stream is not None else sys.stderr
            print(rec.render(), file=out)

    def debug(self, msg: str, **fields: Any) -> None:
        self.log("debug", msg, **fields)

    def info(self, msg: str, **fields: Any) -> None:
        self.log("info", msg, **fields)

    def warning(self, msg: str, **fields: Any) -> None:
        self.log("warning", msg, **fields)

    def error(self, msg: str, **fields: Any) -> None:
        self.log("error", msg, **fields)

    @contextlib.contextmanager
    def capture(self) -> Iterator[List[LogRecord]]:
        """Collect every record emitted inside the block (any level).

        Captures stack: nested blocks each receive the records emitted
        while they are open.  Stream output is unaffected.
        """
        sink: List[LogRecord] = []
        self._captures.append(sink)
        try:
            yield sink
        finally:
            self._captures.remove(sink)


LOG = StructuredLogger()
