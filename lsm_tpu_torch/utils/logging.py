"""Structured metric logging (port of lsm_tpu/utils/logging.py).

The same quantities the entry points print are also emitted as JSONL
records, {"ts", "metric", "value", **tags}, for benchmark harnesses and
dashboards (`--metrics-out`); the records are lsm_tpu's, field for field.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Any, Dict, Optional, TextIO

log = logging.getLogger("lsm_tpu_torch")


class MetricLogger:
    """Append-only JSONL metric sink + mirrored human-readable logging."""

    def __init__(self, stream: Optional[TextIO] = None, path: Optional[str] = None):
        self._stream = stream
        self._file = open(path, "a") if path else None

    def emit(self, name: str, value: Any, **tags: Any) -> None:
        record: Dict[str, Any] = {"ts": time.time(), "metric": name, "value": value}
        record.update(tags)
        line = json.dumps(record)
        if self._stream is not None:
            print(line, file=self._stream, flush=True)
        if self._file is not None:
            self._file.write(line + "\n")
            self._file.flush()
        log.info("%s = %s %s", name, value, tags if tags else "")

    def close(self) -> None:
        if self._file is not None:
            self._file.close()


_default: Optional[MetricLogger] = None


def default_metrics() -> MetricLogger:
    global _default
    if _default is None:
        _default = MetricLogger(stream=sys.stderr)
    return _default
