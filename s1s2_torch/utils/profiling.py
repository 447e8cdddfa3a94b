"""Tracing, program spans and metrics logging.

Port of the JAX package's ``utils/profiling.py`` (its ``StepTimer`` aside:
nothing here reads one), plus the port's spans:

* :func:`trace_context` — a ``torch.profiler`` trace (host, and the card's
  kernels when there is a card) around a region, written as a Chrome trace
  into a directory; ``None`` is a no-op.
* :func:`span` and :func:`spanned` — a named span around a region or a
  whole function, at the layer boundaries of the sampler, the model and the
  kernel wrappers. A span records only while a ``torch.profiler`` session
  records on its thread; otherwise it is one shared null context and costs
  a flag read. While on, it opens ``record_function(name)``, so the span is
  a ``user_annotation`` in the profiler's trace on that trace's clock, and
  keeps a :class:`Span` in memory, which :func:`spans` returns.
* The sync counter: while a root span (the outermost of its thread) is
  open and CUDA is up, PyTorch's sync debug mode is set to warn, and each
  host–device synchronization it reports (a copy from pageable memory,
  ``.item()``, ``.cpu()``) counts in the innermost open span of the thread
  that made it. Those warnings are counted, never shown; the mode and the
  warning filters are restored when the last root closes.
* :class:`MetricsLogger` — an append-only JSONL file, each line with a
  ``ts``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import threading
import time
import warnings
from typing import List, Optional

import torch

TRACE_FILE = "trace.json"
SYNC_WARNING = "called a synchronizing CUDA operation"
MAX_SPANS = 1 << 18  # a root opened past this many is not kept, nor its spans

_profiler_on = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()


@dataclasses.dataclass(slots=True)
class Span:
    """One recorded span. ``parent`` and ``root`` index the list that
    :func:`spans` returns (``parent`` -1 for a root, whose ``root`` is its
    own index); times are host ``time.monotonic_ns``; ``syncs`` counts the
    synchronizations made in the span and in none of its children."""

    name: str
    parent: int
    root: int
    start_ns: int
    end_ns: int = 0
    syncs: int = 0


class _Recorder:
    """The process's span buffer, each thread's stack of open spans, and
    the sync watch while any root is open."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.buffer: List[Span] = []
        self.fresh = True  # spans were off since the last one recorded
        self.roots_open = 0
        self.watch = None  # (saved sync debug mode, the warnings' catch)

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def open(self, name: str) -> Span:
        st = self.stack()
        with self.lock:
            if not st:
                if self.fresh:
                    self.buffer, self.fresh = [], False
                self.local.keep = len(self.buffer) < MAX_SPANS
                self._watch()
            idx = len(self.buffer)
            parent = st[-1] if st else None
            rec = Span(name, -1 if parent is None else parent[1],
                       idx if parent is None else parent[0].root, time.monotonic_ns())
            if self.local.keep:
                self.buffer.append(rec)
        st.append((rec, idx))
        return rec

    def close(self, rec: Span) -> None:
        rec.end_ns = time.monotonic_ns()
        st = self.stack()
        st.pop()
        if not st:
            with self.lock:
                self._unwatch()

    def _watch(self) -> None:
        self.roots_open += 1
        if self.roots_open > 1 or not torch.cuda.is_initialized():
            return
        caught = warnings.catch_warnings()
        caught.__enter__()
        warnings.filterwarnings("always", message=SYNC_WARNING)
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if not str(message).startswith(SYNC_WARNING):
                return shown(message, category, filename, lineno, file, line)
            st = getattr(self.local, "stack", None)
            if st:
                st[-1][0].syncs += 1

        warnings.showwarning = show
        self.watch = (torch.cuda.get_sync_debug_mode(), caught)
        torch.cuda.set_sync_debug_mode("warn")

    def _unwatch(self) -> None:
        self.roots_open -= 1
        if self.roots_open or self.watch is None:
            return
        mode, caught = self.watch
        self.watch = None
        torch.cuda.set_sync_debug_mode(mode)
        caught.__exit__(None, None, None)


_REC = _Recorder()


class _Recording:
    """The span's context while a profiler session records."""

    __slots__ = ("name", "rf", "rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.rec = _REC.open(self.name)
        return self

    def __exit__(self, *exc):
        _REC.close(self.rec)
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A span named ``name`` around a ``with`` block (see the module)."""
    if not _profiler_on():
        _REC.fresh = True
        return _NULL
    return _Recording(name)


def spanned(name: str):
    """Decorator: a span named ``name`` around every call of the function."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler_on():
                _REC.fresh = True
                return fn(*args, **kwargs)
            with _Recording(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def spans() -> List[Span]:
    """The spans recorded since spans were last off: the current or the last
    profiler session's, roots whole, in the order they opened."""
    with _REC.lock:
        return list(_REC.buffer)


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
    _REC.fresh = True
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


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
