"""The port's benchmark: the JAX package's ``bench.py`` default lines on one
card.

    python -m s1s2_torch.bench [--batch1 128] [--batch2 64] [--steps 50]

Prints three JSON lines with bench.py's metric names, each with the card's
name under ``device`` (bench.py's ``vs_baseline`` is left out: its target was
set for another chip):

1. ``patches_per_sec_per_chip_50step_ddim_256px_bf16``: the full-width
   UNetSmall (base 96, no stem, ≈17M parameters, flax's init from
   ``PRNGKey(0)``, bit for bit) in bf16, GT-anchored DDIM, 50 steps from t=999, B=128; two timed
   iterations after one warm-up, with the per-iteration spread.
2. ``patches_per_sec_per_chip_dpm2m5_int8_at_ddim20_quality_256px``: the same
   model quantized to int8 (calibrated at t ∈ (999, 500, 200, 20) on 8
   patches), DPM-Solver++(2M) on ``round_unique_grid(200, 5, 1000)`` from
   ``q_sample(gt)`` at the grid's top, B=64, ten timed iterations after one
   warm-up. The grid [0, 50, 100, 150, 200] makes 5 denoiser calls.
3. the headline: the first of the 24x4, 16x2 and 12 distilled students whose
   checkpoint is present, self-verified on the 32-file evidence set and
   timed by ``headline.run_headline``; a missing checkpoint prints a
   ``{"skipped": ...}`` line first, and the base-96 student's line, last,
   is named ``patches_per_sec_per_chip_distill1_int8_at_ddim20_quality_256px``.

Inputs are bench.py's ``data(B, seed)`` with jax's own bits (``core/random.py``):
seed 1 for line 1, 3 for line 2, 7 for the headline. Every timed call draws
fresh noise on the card and is timed with CUDA events. Called with ``device="cpu"`` (as the tests call the line functions,
at a small size) the lines run the same calls but carry ``"value": null``:
no device time is measured there.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from s1s2_torch.core.parametrize import Parameterization, q_sample
from s1s2_torch.core.schedule import Schedule
from s1s2_torch import headline
from s1s2_torch.headline import CC, CT, EXPECT_MAE, TEACHER_ANCHOR, data, run_headline
from s1s2_torch.models.quant import make_quant_denoise_fn, make_sampler_calib, quantize_unet
from s1s2_torch.models.unet import init_params, load_unet
from s1s2_torch.sampling.dpm_solver import dpm_solver_2m
from s1s2_torch.sampling.grids import round_unique_grid
from s1s2_torch.sampling.samplers import ddim_anchored, make_denoise_fn

LINE1 = "patches_per_sec_per_chip_50step_ddim_256px_bf16"
LINE2 = "patches_per_sec_per_chip_dpm2m5_int8_at_ddim20_quality_256px"
HEADLINE = "patches_per_sec_per_chip_distill1_w{}_int8_at_ddim20_quality_256px"
# the base-96 student's line, bench.py's last fallback, has no width in its name
FALLBACK_METRIC = "patches_per_sec_per_chip_distill1_int8_at_ddim20_quality_256px"
# bench.py's preference order (spec, batch, params); the first present one
# is the headline, and "1", the base-96 student, comes last
HEADLINE_PREF = [("24x4", 128, "1.11M"), ("16x2", 128, "0.48M"), ("12", 128, "0.27M")]
FALLBACK = ("1", 64, "17M")
T_START = 999
CALIB_TVALS = (999, 500, 200, 20)
DPM_GRID = (200, 5, 1000)  # round_unique_grid(t_hi, steps, T)
SEED = 0
LINE1_BATCH, LINE2_BATCH = 128, 64


def base96_state(device="cpu") -> Dict[str, torch.Tensor]:
    """Lines 1-2's model: the full-width UNetSmall (base 96, no stem),
    freshly initialised from ``SEED``."""
    state = init_params(CT, 96, 1, seed=SEED, in_ch=CC + CT)
    return {k: v.to(device) for k, v in state.items()}


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def timed(run: Callable[[], torch.Tensor], device: torch.device, warmup: int,
          iters: int) -> Dict:
    """Run ``warmup`` untimed calls, then ``iters`` calls each between CUDA
    events. → {"ms": [per call], "out": last result}; on the CPU no time."""
    out = None
    for _ in range(warmup):
        out = run()
    ms: List[float] = []
    for _ in range(iters):
        if device.type != "cuda":
            out = run()
            continue
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run()
        end.record()
        torch.cuda.synchronize(device)
        ms.append(start.elapsed_time(end))
    return {"ms": ms, "out": out}


def make_line1(state: Dict[str, torch.Tensor], batch: int = LINE1_BATCH, steps: int = 50,
               size: int = 256, base_ch: int = 96, device="cuda") -> Callable[[], torch.Tensor]:
    """Line 1's call: bf16 GT-anchored DDIM, ``steps`` steps from t=999, on
    bench.py's data(batch, 1), fresh noise every call. Per call: 13 bf16 conv
    launches and one DDIM update a step."""
    device = _device(device)
    model = load_unet(state, CT, base_ch, 1, compute_dtype=torch.bfloat16, device=device)
    cond, gt = data(batch, 1, size, device)
    fn = make_denoise_fn(model, cond)
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    schedule = Schedule.cosine(1000)
    return lambda: ddim_anchored(fn, gt, schedule, T_START, steps, generator=gen)


def make_line2(state: Dict[str, torch.Tensor], batch: int = LINE2_BATCH, size: int = 256,
               base_ch: int = 96, device="cuda") -> Callable[[], torch.Tensor]:
    """Line 2's set-up and call: calibrate on bench.py's data(batch, 3) at
    (999, 500, 200, 20), quantize; the call runs int8 DPM-Solver++(2M) on
    round_unique_grid(200, 5, 1000) from q_sample(gt, fresh noise) at
    K = grid[-1]. Per call: 5 denoiser calls, each 12 int8 convs and the
    bf16 ``inc``."""
    device = _device(device)
    params = {k: v.to(device) for k, v in state.items()}
    cond, gt = data(batch, 3, size, device)
    schedule = Schedule.cosine(1000)
    ab = schedule.alpha_bar_np()
    qp = quantize_unet(params, make_sampler_calib(gt, cond, ab, CALIB_TVALS),
                       out_ch=CT, base_ch=base_ch)
    grid = round_unique_grid(*DPM_GRID)
    K = int(grid[-1])
    sab, s1m = float(np.sqrt(ab[K])), float(np.sqrt(np.float32(1.0) - ab[K]))
    fn = make_quant_denoise_fn(qp, cond)
    gen = torch.Generator(device=device).manual_seed(SEED + 10)

    def run():
        noise = torch.randn(gt.shape, generator=gen, dtype=torch.float32, device=device)
        return dpm_solver_2m(fn, q_sample(gt, noise, sab, s1m), schedule, grid,
                             Parameterization.EPS)

    return run


def _result(r: Dict) -> Dict:
    return {"finite": bool(torch.isfinite(r["out"]).all()), "shape": list(r["out"].shape)}


def bench_bf16_ddim(state: Dict[str, torch.Tensor], batch: int = LINE1_BATCH, steps: int = 50,
                    warmup: int = 1, iters: int = 2, size: int = 256, base_ch: int = 96,
                    device="cuda") -> Dict:
    """Line 1: ``iters`` timed calls of :func:`make_line1`'s after ``warmup``;
    the value is the mean of the per-call patches/s, as in bench.py."""
    device = _device(device)
    r = timed(make_line1(state, batch, steps, size, base_ch, device), device, warmup, iters)
    its = [batch / (ms / 1e3) for ms in r["ms"]]
    return {"metric": LINE1, "value": sum(its) / len(its) if its else None,
            "unit": "patches/s", "per_iteration": its, "ms_per_batch": r["ms"],
            "batch": batch, "steps": steps, "base_ch": base_ch, **_result(r),
            "device": device_name(device)}


def bench_int8_dpm(state: Dict[str, torch.Tensor], batch: int = LINE2_BATCH, warmup: int = 1,
                   iters: int = 10, size: int = 256, base_ch: int = 96,
                   device="cuda") -> Dict:
    """Line 2: ``iters`` timed calls of :func:`make_line2`'s after ``warmup``
    (calibration included before them); the value is patches over the summed
    time, as in bench.py."""
    device = _device(device)
    r = timed(make_line2(state, batch, size, base_ch, device), device, warmup, iters)
    total = sum(r["ms"]) if r["ms"] else None
    return {"metric": LINE2, "value": batch * len(r["ms"]) / (total / 1e3) if total else None,
            "unit": "patches/s", "ms_per_batch": (total / len(r["ms"])) if total else None,
            "batch": batch, "iters": iters, "grid": round_unique_grid(*DPM_GRID).tolist(),
            "base_ch": base_ch, **_result(r), "device": device_name(device)}


def bench_headline(device="cuda", n_files: int = 32, size: int = 256,
                   emit: Callable[[Dict], None] = print) -> Optional[Dict]:
    """Line 3: the first present rung of bench.py's preference order, run and
    self-verified by ``run_headline``; ``emit`` gets a skip line for each
    absent rung before it."""
    device = _device(device)
    for spec, batch, n_params in HEADLINE_PREF + [FALLBACK]:
        ckpt = headline.CKPT_DIR / f"distill_eps_student{spec}.bf16.msgpack"
        if not ckpt.is_file():
            emit({"skipped": f"w{spec}", "reason": f"checkpoint absent: {ckpt}"})
            continue
        r = run_headline(spec, batch=batch, device=device, n_files=n_files, size=size)
        metric = FALLBACK_METRIC if spec == FALLBACK[0] else HEADLINE.format(spec)
        return {"metric": metric, "value": r["patches_per_s"],
                "unit": "patches/s", "ms_per_batch": r.get("ms_per_batch"),
                "config": f"width-distilled {spec} 1-step student, int8, B={batch} "
                          f"({n_params} params)",
                "quality_checked": r["quality_checked"], "verified_mae": r["mae"],
                "expect_mae": EXPECT_MAE[spec], "teacher_anchor": TEACHER_ANCHOR,
                "weights": ckpt.name,
                "device": r["device"]}
    return None


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch1", type=int, default=LINE1_BATCH, help="line 1 batch")
    ap.add_argument("--batch2", type=int, default=LINE2_BATCH, help="line 2 batch")
    ap.add_argument("--steps", type=int, default=50, help="line 1 DDIM steps")
    args = ap.parse_args(argv)
    state = base96_state()
    lines = []

    def emit(line):
        lines.append(line)
        print(json.dumps(line), flush=True)

    emit(bench_bf16_ddim(state, args.batch1, args.steps))
    emit(bench_int8_dpm(state, args.batch2))
    head = bench_headline(emit=emit)
    if head is not None:
        emit(head)
    return lines


if __name__ == "__main__":
    main()
