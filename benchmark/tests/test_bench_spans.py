"""The four readers of the program's spans (``harness/spans.py``) on a tiny
CPU run under the profiler, with a stand-in trace that has device time (a
CPU trace has none, so a traced CPU run reports none of them)."""

import sys
import types
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness import cell  # noqa: E402
from benchmark.harness.traffic import Inputs, Program  # noqa: E402
from s1s2_torch.utils import profiling  # noqa: E402

CPU = torch.device("cpu")
SMALL = {
    "student24x4.ddim1.b128": {"arch": {}, "mix": {"batch": 2, "size": 32, "calib_n": 2}},
    "unet96_eps.dpm5_int8.b64": {"arch": {"base_ch": 8},
                                 "mix": {"batch": 2, "size": 32, "calib_n": 2}},
}
READERS = ("sampler_host_ms_per_batch", "model_host_ms_per_batch", "kernel_host_ms_per_batch",
           "host_syncs_per_batch")
CALLS = 3


def traced_ctx(name, calls=CALLS):
    """``calls`` calls of the cell under the profiler after one with spans
    off; → the readers' ctx, its trace a stand-in with device time."""
    c = cell.load_cell(name, True)
    cfg = dict(c.cfg, arch=dict(c.cfg["arch"], **SMALL[name]["arch"]))
    mix = dict(c.mix, **SMALL[name]["mix"])
    inputs = Inputs(cfg, mix, 2 ** 31 + 7, CPU)
    program = Program(cfg, mix, inputs)
    program(inputs.call_noise())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(calls):
            program(inputs.call_noise())
    return dict(trace=types.SimpleNamespace(busy_s=1.0),
                window=types.SimpleNamespace(calls=calls))


@pytest.fixture(scope="module", params=sorted(SMALL))
def traced(request):
    return request.param, traced_ctx(request.param)


def test_each_reader_reads_a_traced_run(traced):
    name, ctx = traced
    v = {m: cell.reader(m)(ctx) for m in READERS}
    assert all(v[m] > 0 for m in READERS[:3]), v
    assert v["host_syncs_per_batch"] == 0  # no card, no sync
    assert {m["name"] for m in cell.load_cell(name, True).metrics} >= set(READERS)


def test_the_three_ms_metrics_sum_to_the_calls_span_time(traced):
    _, ctx = traced
    recs = profiling.spans()
    roots_ms = sum(r.end_ns - r.start_ns for r in recs if r.parent < 0) / 1e6 / CALLS
    total = sum(cell.reader(m)(ctx) for m in READERS[:3])
    assert total == pytest.approx(roots_ms, rel=1e-9)


def test_a_count_that_is_not_the_windows_calls_gives_none(traced):
    _, ctx = traced
    for calls in (CALLS - 1, CALLS + 1):
        other = dict(ctx, window=types.SimpleNamespace(calls=calls))
        assert all(cell.reader(m)(other) is None for m in READERS)


def test_no_device_time_or_no_spans_gives_none(traced, monkeypatch):
    _, ctx = traced
    for tr in (None, types.SimpleNamespace(busy_s=0.0)):
        assert all(cell.reader(m)(dict(ctx, trace=tr)) is None for m in READERS)
    # a program that records no spans, as before it had them
    monkeypatch.setitem(sys.modules, "s1s2_torch.utils.profiling",
                        types.ModuleType("s1s2_torch.utils.profiling"))
    assert all(cell.reader(m)(ctx) is None for m in READERS)
