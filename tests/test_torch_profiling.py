"""The port's spans and sync counter (``s1s2_torch/utils/profiling.py``):
the off path, nesting, roots and threads, the buffer's session, the spans
in the Chrome trace, and the spans a call of each benchmark cell's sampler
makes. The file imports neither JAX nor the JAX package, so its card case
runs on the card's machine:

    python -m pytest --noconftest tests/test_torch_profiling.py -q -m gpu
"""

import json
import threading
import warnings

import numpy as np
import pytest
import torch

from s1s2_torch.core.parametrize import q_sample
from s1s2_torch.core.schedule import Schedule
from s1s2_torch.models.quant import make_quant_denoise_fn, make_sampler_calib, quantize_unet
from s1s2_torch.models.unet import init_params, load_unet
from s1s2_torch.ops import conv3x3, fused_elementwise, halo, matmul, stem_pack
from s1s2_torch.sampling.dpm_solver import dpm_solver_2m
from s1s2_torch.sampling.grids import round_unique_grid
from s1s2_torch.sampling.samplers import ddim_anchored, make_denoise_fn
from s1s2_torch.utils import profiling
from s1s2_torch.utils.profiling import span, spanned, spans

CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def spans_off_between_tests():
    """A span met with the profiler off: the next recorded span starts the
    buffer anew, as between a benchmark's warm-up and its traced window."""
    span("off")


def profiled():
    return torch.profiler.profile(activities=CPU)


def names():
    return [s.name for s in spans()]


def test_off_path_records_nothing_and_returns_the_shared_null_context(monkeypatch):
    with profiled():
        with span("kept"):
            pass
    assert span("a") is span("b") is profiling._NULL

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    f = spanned("f")(lambda x: x + 1)
    with span("a"):
        assert f(1) == 2
    assert names() == ["kept"]  # the last session's, untouched


def test_nesting_and_roots():
    f = spanned("f")(lambda: None)
    with profiled():
        with span("a"):
            with span("b"):
                f()
            f()
        with span("c"):
            pass
    got = [(s.name, s.parent, s.root) for s in spans()]
    assert got == [("a", -1, 0), ("b", 0, 0), ("f", 1, 0), ("f", 0, 0), ("c", -1, 4)]
    recs = spans()
    for s in recs:
        assert s.end_ns >= s.start_ns and s.syncs == 0
        if s.parent >= 0:
            p = recs[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_each_thread_keeps_its_own_stack(monkeypatch):
    """Two threads with spans open at once. A profiler session records on
    the thread that started it, and two sessions cannot run at once, so
    here the profiler's flag and ``record_function`` are stood in for."""
    monkeypatch.setattr(profiling, "_profiler_on", lambda: True)
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: profiling._NULL)
    barrier = threading.Barrier(2, timeout=30)

    def work(tag):
        with span(f"{tag}.outer"):
            barrier.wait()
            with span(f"{tag}.inner"):
                barrier.wait()

    profiling._REC.fresh = True
    threads = [threading.Thread(target=work, args=(t,)) for t in ("x", "y")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    recs = spans()
    assert sorted(s.name for s in recs) == ["x.inner", "x.outer", "y.inner", "y.outer"]
    for tag in ("x", "y"):
        outer = next(i for i, s in enumerate(recs) if s.name == f"{tag}.outer")
        inner = next(s for s in recs if s.name == f"{tag}.inner")
        assert recs[outer].parent == -1 and recs[outer].root == outer
        assert inner.parent == outer and inner.root == outer


def test_the_buffer_holds_only_the_last_session(tmp_path):
    with profiled():
        with span("first"):
            pass
    with span("off"):
        pass
    with profiled():
        with span("second"):
            pass
    assert names() == ["second"]
    with profiling.trace_context(str(tmp_path)):  # back to back, no span off between
        with span("third"):
            pass
    assert names() == ["third"]


def test_spans_are_user_annotations_in_the_trace(tmp_path):
    f = spanned("kernel.f")(lambda x: x * 2)
    with profiling.trace_context(str(tmp_path)):
        with span("sampler.call"):
            with span("sampler.step"):
                f(torch.ones(4))
    events = json.loads((tmp_path / profiling.TRACE_FILE).read_text())["traceEvents"]
    ann = {e["name"]: e for e in events if e.get("cat") == "user_annotation"
           and e.get("ph") == "X"}
    assert {"sampler.call", "sampler.step", "kernel.f"} <= set(ann)

    def inside(child, parent):
        c, p = ann[child], ann[parent]
        return p["ts"] <= c["ts"] and c["ts"] + c["dur"] <= p["ts"] + p["dur"]

    assert inside("sampler.step", "sampler.call") and inside("kernel.f", "sampler.step")
    recs = spans()
    assert [(s.name, s.parent) for s in recs] == [("sampler.call", -1), ("sampler.step", 0),
                                                ("kernel.f", 1)]


def test_syncs_count_in_the_innermost_span_and_are_not_shown(monkeypatch):
    """The counter's warning path, with PyTorch's sync debug mode stood in
    for (the mode itself needs CUDA): a sync warning counts in the
    innermost open span, other warnings pass through, and the mode and the
    filters come back when the root closes."""
    mode = {"now": 0}
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: mode["now"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda m: mode.update(now={"warn": 1}.get(m, m)))
    sync = profiling.SYNC_WARNING + " (Triggered internally)"
    filters = list(warnings.filters)
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("always")
        with profiled():
            with span("root"):
                assert mode["now"] == 1
                warnings.warn(sync)
                with span("child"):
                    warnings.warn(sync)
                    warnings.warn(sync)
                    warnings.warn("something else")
        assert mode["now"] == 0
    assert [str(w.message) for w in shown] == ["something else"]
    assert warnings.filters == filters
    assert [(s.name, s.syncs) for s in spans()] == [("root", 1), ("child", 2)]


def _int8_fn(base, stem, B, tvals, gt, cond, schedule):
    params = init_params(4, base, stem, seed=0)
    calib = make_sampler_calib(gt, cond, schedule.alpha_bar_np(), tvals, n=B,
                               noises=[torch.randn(gt.shape) for _ in tvals])
    return make_quant_denoise_fn(quantize_unet(params, calib, out_ch=4, base_ch=base,
                                               stem_s2d=stem), cond)


def _cell_call(cell):
    """The sampler call of a benchmark cell at base 8 on 32x32 patches."""
    torch.manual_seed(0)
    schedule = Schedule.cosine(1000)
    B, S = 1, 32
    gt, cond = torch.rand(B, S, S, 4), torch.randn(B, S, S, 4)
    if cell == "student24x4.ddim1.b128":
        fn = _int8_fn(8, 4, B, (200, 100, 20), gt, cond, schedule)
        return lambda noise: ddim_anchored(fn, gt, schedule, 200, 1, noise=noise)
    if cell == "unet96_eps.dpm5_int8.b64":
        fn = _int8_fn(8, 1, B, (999, 500, 200, 20), gt, cond, schedule)
        grid = round_unique_grid(200, 5, 1000)
        a = schedule.alpha_bar_np()[grid[-1]]
        sab, s1m = float(np.sqrt(a)), float(np.sqrt(np.float32(1.0) - a))
        return lambda noise: dpm_solver_2m(fn, q_sample(gt, noise, sab, s1m), schedule, grid)
    net = load_unet(init_params(4, 8, 1, seed=0), 4, 8, 1, compute_dtype=torch.bfloat16,
                    device="cpu")
    fn = make_denoise_fn(net, cond)
    return lambda noise: ddim_anchored(fn, gt, schedule, 200, 20, noise=noise)


# spans a call: sampler.call, q_sample, then per denoiser call a step, a
# forward, the stem pack and 13 conv wrappers, and in DDIM the fused update
SPANS_A_CALL = {"student24x4.ddim1.b128": 19, "unet96_eps.dpm5_int8.b64": 82,
                "unet96_eps.ddim20_bf16.b64": 342}


@pytest.mark.parametrize("cell", sorted(SPANS_A_CALL))
def test_each_cells_sampler_makes_its_spans(cell):
    call = _cell_call(cell)
    call(torch.randn(1, 32, 32, 4))  # spans off
    with profiled():
        for _ in range(2):
            call(torch.randn(1, 32, 32, 4))
    recs = spans()
    assert len(recs) == 2 * SPANS_A_CALL[cell]
    assert sum(s.name == "sampler.call" for s in recs) == 2
    roots = [s.name for s in recs if s.parent < 0]
    nested = [s.name for s in recs if s.parent >= 0 and recs[s.parent].name == "sampler.call"]
    if cell == "unet96_eps.dpm5_int8.b64":  # the entry diffuses gt before the solver
        assert roots == ["q_sample", "sampler.call"] * 2
        assert set(nested) == {"sampler.step"}
    else:
        assert roots == ["sampler.call"] * 2 and nested.count("q_sample") == 2
    for s in recs:
        if s.name == "model.forward":
            assert recs[s.parent].name == "sampler.step"
        if s.name.startswith("kernel.conv") or s.name == "kernel.stem_pack":
            assert recs[s.parent].name == "model.forward"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the sync counter reads CUDA's sync debug mode)")
    return torch.device("cuda")


LAUNCH_COUNTERS = (conv3x3.conv3x3_relu, conv3x3.conv3x3_relu_int8, conv3x3.conv3x3_int8_q,
                   fused_elementwise.fused_ddim_update, matmul.matmul, halo.halo_rows_x2,
                   stem_pack.stem_pack)


@pytest.mark.gpu
def test_gpu_syncs_and_kernel_spans_on_the_card(cuda):
    x = torch.ones(1024, device=cuda)
    schedule = Schedule.cosine(1000)
    g = torch.Generator(device=cuda).manual_seed(0)
    B, S = 2, 64
    gt = torch.rand((B, S, S, 4), generator=g, device=cuda)
    cond = torch.randn((B, S, S, 4), generator=g, device=cuda)
    params = {k: v.to(cuda) for k, v in init_params(4, 24, 4, seed=0).items()}
    calib = make_sampler_calib(gt, cond, schedule.alpha_bar_np(), (200, 20), n=B,
                               noises=[torch.randn(gt.shape, generator=g, device=cuda)] * 2)
    fn = make_quant_denoise_fn(quantize_unet(params, calib, out_ch=4, base_ch=24,
                                             stem_s2d=4), cond)
    ddim_anchored(fn, gt, schedule, 200, 2, generator=g)  # warm, spans off
    torch.cuda.synchronize()
    before = sum(f.launches for f in LAUNCH_COUNTERS)
    with torch.profiler.profile(activities=CPU + [torch.profiler.ProfilerActivity.CUDA]):
        with span("copy"):
            torch.ones(1024).to(cuda)  # from pageable host memory
        with span("add"):
            x + x
        with span("item"):
            (x + x).sum().item()
        torch.cuda.synchronize()
        ddim_anchored(fn, gt, schedule, 200, 2, generator=g)
        torch.cuda.synchronize()
    recs = spans()
    assert [(s.name, s.syncs) for s in recs[:3]] == [("copy", 1), ("add", 0), ("item", 1)]
    kernels = sum(s.name.startswith("kernel.") for s in recs)
    assert kernels == sum(f.launches for f in LAUNCH_COUNTERS) - before == 2 * 14 + 2
    q = next(s for s in recs if s.name == "q_sample")
    assert q.syncs == 2  # its two (B,) coefficient vectors, copied from the host
    assert torch.cuda.get_sync_debug_mode() == 0
