"""Structured metric emission as JSON lines (stdout and/or a file).

The port's copy of the JAX package's ``utils/metrics.py`` ``MetricWriter``,
without the TensorBoard sink: one JSON record per event, with a monotonic
``t`` (seconds since the writer was created) and non-finite floats written
as ``null`` so every line stays strict JSON.
"""

from __future__ import annotations

import json
import math
import time
from typing import IO, Any


def _sanitize(v: Any) -> Any:
    """JSON-safe metric values: numerics become floats and non-finite
    floats become None, recursively through dicts, lists and tuples."""
    if isinstance(v, dict):
        return {k: _sanitize(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_sanitize(x) for x in v]
    if not isinstance(v, (str, bool)) and hasattr(v, "__float__"):
        v = float(v)
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v


class MetricWriter:
    """JSON-lines metric writer; one record per event.  Usable as a
    context manager, which closes the file even when the body raises."""

    def __init__(self, path: str | None = None, stdout: bool = True):
        self._file: IO[str] | None = open(path, "a") if path else None
        self._stdout = stdout
        self._t0 = time.perf_counter()
        self._closed = False

    def write(self, kind: str, step: int | None = None, **metrics: Any) -> dict[str, Any]:
        if self._closed:
            raise RuntimeError(
                f"MetricWriter is closed — write({kind!r}) after close() "
                "would lose the record")
        record = {"kind": kind, "t": round(time.perf_counter() - self._t0, 4)}
        if step is not None:
            record["step"] = int(step)
        record.update({k: _sanitize(v) for k, v in metrics.items()})
        line = json.dumps(record)
        if self._stdout:
            print(line, flush=True)
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()
        return record

    def close(self) -> None:
        """Release the file handle.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        if self._file:
            self._file.close()

    def __enter__(self) -> "MetricWriter":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
