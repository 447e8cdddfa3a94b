"""What a traced window did on the device, from ``torch.profiler``'s trace.

The window runs under the profiler inside a ``bench.window`` annotation
that ends after the final synchronize. Its Chrome trace is written to a
temporary file, read back and deleted. From it:

* the device operations (kernels, copies, fills) inside the window, with
  their durations;
* ``busy_s``: the union of their intervals; ``window_s``: the annotation's
  length; the rest is idle;
* the idle gaps, each named by the host operation that launched the
  device operation ending it (the innermost CPU op around its launch);
* the kernel launches.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import re
import tempfile
from pathlib import Path
from typing import Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")


def program_kernels(root: Path) -> Tuple[str, ...]:
    """The names of the program's own kernels: every ``__global__`` function
    of its CUDA sources."""
    names = set()
    for p in sorted((root / "s1s2_torch").rglob("*.cu")):
        names.update(_GLOBAL.findall(p.read_text()))
    return tuple(sorted(names))


class Trace:
    """The window's device operations and idle gaps."""

    def __init__(self, events: List[Dict]):
        wins = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
                and e.get("cat") == "user_annotation"]
        if not wins:
            raise RuntimeError(f"the trace holds no {WINDOW!r} annotation")
        lo = float(wins[0]["ts"])
        hi = lo + float(wins[0]["dur"])
        self.window_s = (hi - lo) / 1e6
        dev = sorted((e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"
                      and lo <= float(e["ts"]) <= hi), key=lambda e: float(e["ts"]))
        # (name, seconds, is a kernel launch) of every device operation in the window
        self.ops: List[Tuple[str, float, bool]] = [
            (e["name"], min(float(e["dur"]), hi - float(e["ts"])) / 1e6, e["cat"] == "kernel")
            for e in dev]
        self.launches = sum(1 for *_, k in self.ops if k)
        busy, end, gaps = 0.0, lo, []
        for e in dev:
            s, t = float(e["ts"]), min(float(e["ts"]) + float(e["dur"]), hi)
            if s > end:
                gaps.append((s - end, e))
            if t > end:
                busy += t - max(s, end)
                end = t
        self.busy_s = busy / 1e6
        tail = (hi - end) / 1e6
        self.gaps = self._name_gaps(events, gaps) + ([("window end", tail)] if tail > 0 else [])

    @staticmethod
    def _name_gaps(events: List[Dict], gaps) -> List[Tuple[str, float]]:
        launch = {e["args"]["correlation"]: e for e in events
                  if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
        ops = collections.defaultdict(list)
        for e in events:
            if e.get("cat") == "cpu_op" and e.get("ph") == "X":
                ops[e.get("tid")].append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                                          e["name"]))
        for v in ops.values():
            v.sort()
        starts = {tid: [o[0] for o in v] for tid, v in ops.items()}
        out = []
        for gap_us, e in gaps:
            name = "host: no launch found"
            rt = launch.get(e.get("args", {}).get("correlation"))
            if rt is not None:
                name = "host: outside any op"
                v, ts = ops.get(rt.get("tid"), []), float(rt["ts"])
                last = bisect.bisect_right(starts.get(rt.get("tid"), []), ts) - 1
                for j in range(last, max(-1, last - 64), -1):  # the innermost op around it
                    if v[j][1] >= ts:
                        name = f"host in {v[j][2]}"
                        break
            out.append((name, gap_us / 1e6))
        return out

    def breakdown(self, n: int = 10) -> Dict[str, List[List]]:
        """The device operations that took most time, and the idle time by
        what the host was doing, at most ``n`` of each."""
        by_op, by_gap = collections.Counter(), collections.Counter()
        for name, sec, _ in self.ops:
            by_op[name[:160]] += sec
        for name, sec in self.gaps:
            by_gap[name[:160]] += sec
        return {"device_ops": [[k, v] for k, v in by_op.most_common(n)],
                "idle_gaps": [[k, v] for k, v in by_gap.most_common(n)]}


def traced(run):
    """Run ``run()`` under the profiler inside the window annotation; →
    (its result, :class:`Trace`)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            result = run()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return result, Trace(events)
