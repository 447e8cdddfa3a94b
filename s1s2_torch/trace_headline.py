"""Where the time of a path goes on the card.

    python -m s1s2_torch.trace_headline [--path headline|line1|line2|cfg|probe]
                                        [--steps N] [--trace out.json]

``headline`` (the default) prepares the main path as
``headline.run_headline`` does (24x4 student, evidence set, calibration,
int8), then runs 10 DDIM-1 batches of its timed inputs ``data(128, 7)``.
``line1`` and ``line2`` are the port's bench lines (``s1s2_torch.bench``)
on the full-width base-96 UNet: bf16 GT-anchored DDIM at B=128 (``--steps``
steps from t=999, default 2: every step is one forward and one update, as
in the bench's 50) and int8 DPM-Solver++(2M)-5 at B=64, one untimed call,
then 2 profiled calls. ``cfg`` is the CFG line's int8 call (the cfg_v
teacher, rollout-calibrated, per-channel scales, ``conv1`` in bf16; the
5-step stacked-CFG sampler at B=32, a 64-row forward a step), one untimed
call, then 2 profiled calls. Under ``torch.profiler`` it prints, per call: the
wall time on CUDA events, the device time of each kernel (the hand-written
ones and PyTorch's own), and the device's idle share (1 − summed kernel
time / wall time). With ``--trace`` it also writes the Chrome trace.
``probe`` takes the probe's kernels (``tools/probe_int8.py``'s shapes) and
their PyTorch yardsticks one by one, each over 50 back-to-back calls that
cycle through two inputs, as ``chip_smoke.py`` times them: the host's
enqueue time and the event-loop time per call without the profiler, then
under it the device time per call and the idle share. It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import itertools
import json
import time
from typing import Callable, Dict, List

import torch

from s1s2_torch import bench
from s1s2_torch.headline import DATA_SEED, STEPS, T_START, data, prepare
from s1s2_torch.models.quant import make_quant_denoise_fn
from s1s2_torch.sampling.samplers import ddim_anchored
from s1s2_torch.utils.profiling import spans

OURS = ("conv3x3_int8_kernel", "quantize_pad_kernel", "conv3x3_bf16_kernel",
        "ddim_update_kernel", "matmul_kernel", "transpose_i8_kernel", "halo_rows_x2_kernel",
        "stem_pack_vec_kernel", "stem_pack_scalar_kernel")


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v:
            return float(v)
    return 0.0


BATCH, ITERS = 128, 10


def profile(step: Callable[[], object], iters: int, warmup: int, trace: str = "",
            device="cuda") -> Dict:
    """``warmup`` untimed calls of ``step``, then ``iters`` under the profiler:
    per call the wall time on CUDA events and the device time by kernel.
    On the CPU (``device="cpu"``, for a run at a tiny size) only the host
    is traced: the rows are operators by their own host time, and the wall
    time is the host's clock (no device time, no idle share)."""
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    for _ in range(warmup):
        step()
    sync()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        if cuda:
            start.record()
        for _ in range(iters):
            step()
        if cuda:
            end.record()
        sync()
        host_ms = (time.perf_counter() - t0) * 1e3 / iters
    wall_ms = start.elapsed_time(end) / iters if cuda else host_ms
    # the program's spans are annotations whose device time is their kernels'
    annotations = {s.name for s in spans()}
    rows: List[Dict] = []
    for evt in prof.key_averages():
        if cuda:
            us = _device_us(evt)
            keep = (getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA
                    and evt.key not in annotations)
        else:
            us, keep = float(evt.self_cpu_time_total), True
        if us > 0 and keep:
            rows.append({"name": evt.key, "ms": us / 1e3 / iters,
                         "calls": evt.count / iters,
                         "ours": any(k in evt.key for k in OURS)})
    rows.sort(key=lambda r: -r["ms"])
    busy = sum(r["ms"] for r in rows)
    if trace:
        prof.export_chrome_trace(trace)
    return {"device": torch.cuda.get_device_name(0) if cuda else "cpu", "iters": iters,
            "wall_ms": wall_ms, "kernel_ms": busy,
            "ours_ms": sum(r["ms"] for r in rows if r["ours"]),
            "idle_share": max(0.0, 1.0 - busy / wall_ms) if cuda else None, "kernels": rows}


def breakdown(trace: str = "") -> Dict:
    """The main path: int8 DDIM-1 of the 24x4 student at B=128."""
    if not torch.cuda.is_available():
        raise SystemExit("trace_headline needs a CUDA card")
    p = prepare("24x4", "cuda")
    cond_b, gt_b = data(BATCH, DATA_SEED, p["gt"].shape[1], p["device"])
    fn = make_quant_denoise_fn(p["qp"], cond_b)
    gen = torch.Generator(device=p["device"])
    gen.manual_seed(0)

    def step():
        ddim_anchored(fn, gt_b, p["schedule"], T_START, STEPS, generator=gen)

    return {"path": "headline", "batch": BATCH, **profile(step, ITERS, 3, trace)}


def breakdown_cfg(trace: str = "") -> Dict:
    """The CFG line's int8 sampler call at B=32 on the cfg_v teacher."""
    if not torch.cuda.is_available():
        raise SystemExit("trace_headline needs a CUDA card")
    calls = bench.make_cfg_samplers(bench.cfg_state(device="cuda"), bench.CFG_BATCH)
    return {"path": "cfg", "batch": bench.CFG_BATCH, **profile(calls["int8"], 2, 1, trace)}


def breakdown_bench(line: int, steps: int = 2, trace: str = "") -> Dict:
    """Bench line 1 (bf16 DDIM, B=128, ``steps`` steps) or 2 (int8
    DPM-Solver++(2M)-5, B=64) on the base-96 UNet."""
    if not torch.cuda.is_available():
        raise SystemExit("trace_headline needs a CUDA card")
    state = bench.base96_state()
    if line == 1:
        step, batch = bench.make_line1(state, bench.LINE1_BATCH, steps), bench.LINE1_BATCH
    else:
        step, batch = bench.make_line2(state, bench.LINE2_BATCH), bench.LINE2_BATCH
    return {"path": f"line{line}", "batch": batch, **profile(step, 2, 1, trace)}


PROBE_CALLS = 50


def breakdown_probe() -> List[Dict]:
    """The probe kernels beside their PyTorch yardsticks at the probe's
    shapes: per call, the host's enqueue time and the CUDA-event time of 50
    back-to-back calls without the profiler, then the device time and idle
    share of 50 more under it."""
    if not torch.cuda.is_available():
        raise SystemExit("trace_headline needs a CUDA card")
    from s1s2_torch.ops.halo import halo_rows_x2
    from s1s2_torch.ops.matmul import matmul
    from s1s2_torch.tools.probe_int8 import DMA_SHAPE, DMA_TH, MATMUL_SHAPE

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    xs = [torch.randn(DMA_SHAPE, generator=g, device=dev) for _ in range(2)]
    M, K, N = MATMUL_SHAPE
    b16 = [(torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16),
            torch.randn((K, N), generator=g, device=dev).to(torch.bfloat16)) for _ in range(2)]
    i8 = [(torch.randint(-128, 128, (M, K), generator=g, device=dev).to(torch.int8),
           torch.randint(-128, 128, (K, N), generator=g, device=dev).to(torch.int8))
          for _ in range(2)]
    cases = (
        ("halo_rows_x2", lambda i: halo_rows_x2(xs[i % 2], DMA_TH)),
        ("x[1:-1]*2", lambda i: xs[i % 2][1:-1] * 2.0),
        ("matmul bf16->bf16", lambda i: matmul(*b16[i % 2], torch.bfloat16)),
        ("torch.matmul bf16", lambda i: torch.matmul(*b16[i % 2])),
        ("matmul int8->int32", lambda i: matmul(*i8[i % 2], torch.int32)),
        ("torch._int_mm", lambda i: torch._int_mm(*i8[i % 2])),
    )
    out = []
    for name, fn in cases:
        count = itertools.count()

        def step(fn=fn, count=count):
            return fn(next(count))

        for _ in range(3):
            step()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(PROBE_CALLS):
            step()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3 / PROBE_CALLS
        torch.cuda.synchronize()
        loop_ms = start.elapsed_time(end) / PROBE_CALLS
        r = profile(step, PROBE_CALLS, 0)
        out.append({"name": name, "host_ms": host_ms, "loop_ms": loop_ms,
                    "profiled_wall_ms": r["wall_ms"], "device_ms": r["kernel_ms"],
                    "idle_share": r["idle_share"], "kernels": r["kernels"]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", choices=("headline", "line1", "line2", "cfg", "probe"),
                    default="headline")
    ap.add_argument("--steps", type=int, default=2, help="line 1's DDIM steps")
    ap.add_argument("--trace", default="", help="write the Chrome trace here (not probe)")
    args = ap.parse_args(argv)
    if args.path == "probe":
        if args.trace:
            raise SystemExit("--trace is for headline, line1, line2 and cfg")
        rows = breakdown_probe()
        print(torch.cuda.get_device_name(0))
        for r in rows:
            print(f"{r['name']:20s} host {r['host_ms']:.4f} ms/call, event loop "
                  f"{r['loop_ms']:.4f} ms/call; profiled: wall {r['profiled_wall_ms']:.4f}, "
                  f"device {r['device_ms']:.4f} ms/call, idle share {r['idle_share']:.3f}")
            for k in r["kernels"]:
                print(f"  {k['ms']:9.4f} ms {k['calls']:6.1f}x {k['name'][:100]}")
            print(json.dumps({k: v for k, v in r.items() if k != "kernels"}))
        return 0
    if args.path == "headline":
        r = breakdown(args.trace)
    elif args.path == "cfg":
        r = breakdown_cfg(args.trace)
    else:
        r = breakdown_bench(int(args.path[-1]), args.steps, args.trace)
    print(f"{r['device']} {r['path']} B={r['batch']}: wall {r['wall_ms']:.4f} ms/iter, "
          f"kernels {r['kernel_ms']:.4f} ms/iter (hand-written {r['ours_ms']:.4f}), "
          f"idle share {r['idle_share']:.3f}")
    for k in r["kernels"][:20]:
        print(f"  {k['ms']:9.4f} ms {k['calls']:6.1f}x {'*' if k['ours'] else ' '} {k['name'][:110]}")
    print(json.dumps({k: v for k, v in r.items() if k != "kernels"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
