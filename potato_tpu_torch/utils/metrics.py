"""Structured metrics stream (JSONL).

One JSON object per line, append-only (a crash loses at most the line
being written), suitable for tailing into any metrics collector.

Events emitted by the built-in surfaces:
- renderer.render(): `render_start`, `chunk` (per-chunk path only),
  `checkpoint`, `render_complete` (segments, lanes handed to the flash
  intersector, bounce passes, passes a CUDA graph replay served, graphs
  captured, uniform draws of the Threefry kernel and of the plain version,
  the lanes whose material read the Perlin, value-noise or image sampler,
  wall seconds, rays/s)
- diff.optimize_textures(): `opt_step` (step, loss, seconds),
  `opt_checkpoint`
- callers can add their own via `MetricsLogger.log(event, **fields)`.

Enable globally with the POTATO_METRICS env var (a file path, or "-"
for stderr), per call via the `metrics=` argument the surfaces accept,
or programmatically. Disabled (the default) costs one `if` per event.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import IO, Optional


class MetricsLogger:
    """Append-only JSONL metrics writer.

    Every record carries `event`, `t` (unix seconds), `dt` (seconds since
    the logger was created) and the constant fields passed to the
    constructor (e.g. run name, host id).
    """

    def __init__(self, path: Optional[str] = None, *,
                 stream: Optional[IO] = None, **constant_fields):
        self._t0 = time.time()
        self._constant = constant_fields
        self._own = False
        if stream is not None:
            self._f = stream
        elif path == "-":
            self._f = sys.stderr
        elif path:
            self._f = open(path, "a", buffering=1)  # line-buffered
            self._own = True
        else:
            self._f = None

    @property
    def enabled(self) -> bool:
        return self._f is not None

    def log(self, event: str, **fields):
        if self._f is None:
            return
        now = time.time()
        rec = {"event": event, "t": round(now, 3),
               "dt": round(now - self._t0, 3)}
        rec.update(self._constant)
        rec.update(fields)
        self._f.write(json.dumps(rec) + "\n")

    def close(self):
        if self._own and self._f is not None:
            self._f.close()
        self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


_NULL = MetricsLogger(None)


def null_metrics() -> MetricsLogger:
    """The shared disabled logger (log() is a no-op)."""
    return _NULL


def from_env_or(metrics: Optional[MetricsLogger]) -> MetricsLogger:
    """Resolve a surface's `metrics=` argument: an explicit logger wins,
    else POTATO_METRICS (path or "-") enables a fresh one, else null."""
    if metrics is not None:
        return metrics
    path = os.environ.get("POTATO_METRICS")
    if path:
        return MetricsLogger(path)
    return _NULL
