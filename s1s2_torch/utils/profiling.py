"""Tracing, step timing and metrics logging.

Port of the JAX package's ``utils/profiling.py``:

* :func:`trace_context` — a ``torch.profiler`` trace (host, and the card's
  kernels when there is a card) around a region, written as a Chrome trace
  into a directory; ``None`` is a no-op.
* :class:`StepTimer` — an EMA of steps/s on the host clock, without a
  device sync.
* :class:`MetricsLogger` — an append-only JSONL file, each line with a
  ``ts``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace_context(log_dir: Optional[str]):
    """``torch.profiler`` over the region, exported to ``log_dir/trace.json``;
    None → no-op."""
    if not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class StepTimer:
    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self._last: Optional[float] = None
        self.steps_per_sec: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        if self._last is not None:
            inst = 1.0 / max(now - self._last, 1e-9)
            self.steps_per_sec = (inst if self.steps_per_sec is None
                                  else self.ema * self.steps_per_sec + (1 - self.ema) * inst)
        self._last = now
        return self.steps_per_sec


class MetricsLogger:
    """Append-only JSONL metrics sink."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self._f = open(path, "a", buffering=1)

    def log(self, **kv) -> None:
        kv.setdefault("ts", time.time())
        self._f.write(json.dumps(kv, default=float) + "\n")

    def close(self) -> None:
        self._f.close()
