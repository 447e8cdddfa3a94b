"""The port's benchmark: the JAX package's ``bench.py`` lines on one card.

    [S1S2_BENCH_CFG=1] [S1S2_BENCH_WIDTHS=1] python -m s1s2_torch.bench \
        [--batch1 128] [--batch2 64] [--steps 50]

Prints bench.py's JSON lines with its metric names, in its order, each with
the card's name under ``device`` (bench.py's ``vs_baseline`` is left out:
its target was set for another chip): lines 1-2, then, when bench.py's own
switches ask for them, the guided-generation line (``S1S2_BENCH_CFG``) and
one line a rung of the width ladder (``S1S2_BENCH_WIDTHS``), and the
headline last:

1. ``patches_per_sec_per_chip_50step_ddim_256px_bf16``: the full-width
   UNetSmall (base 96, no stem, ≈17M parameters, flax's init from
   ``PRNGKey(0)``, bit for bit) in bf16, GT-anchored DDIM, 50 steps from t=999, B=128; two timed
   iterations after one warm-up, with the per-iteration spread.
2. ``patches_per_sec_per_chip_dpm2m5_int8_at_ddim20_quality_256px``: the same
   model quantized to int8 (calibrated at t ∈ (999, 500, 200, 20) on 8
   patches), DPM-Solver++(2M) on ``round_unique_grid(200, 5, 1000)`` from
   ``q_sample(gt)`` at the grid's top, B=64, ten timed iterations after one
   warm-up. The grid [0, 50, 100, 150, 200] makes 5 denoiser calls.
* ``patches_per_sec_per_chip_cfg_g3_5step_int8_quality_equal_256px``: the
   committed ``cfg_v`` teacher (v-prediction, base 96) under classifier-free
   guidance at g=3, cond and null-cond stacked into one forward, 5 steps of
   ``round_unique_grid(999, 5, 1000)``. Quality first, through the port's
   ``cli.evaluate --mode cfg_sweep`` on files 96-127 of the 129-file rich
   synthetic set (seed 0), in bf16 and in the quality-equal int8 setting
   (rollout calibration, per-channel activation scales, ``conv1`` in bf16);
   ``quality_checked`` is int8 ≤ bf16 + 0.002, beside the committed anchors
   0.29821 and 0.29791. Then 8 timed calls after one warm-up of the
   sampler at B=32 (a 64-row forward a step) on cond ``normal(PRNGKey(11))``
   in bf16 and in int8 (rollout calibration at g=3 on 8 of those conds).
* ``patches_per_sec_per_chip_distill1_w{spec}_int8_at_ddim20_quality_256px``:
   each rung of bench.py's ``WIDTHS`` through ``headline.run_headline``.
3. the headline: the first of the 24x4, 16x2 and 12 distilled students whose
   checkpoint is present, self-verified on the 32-file evidence set and
   timed by ``headline.run_headline``; a missing checkpoint prints a
   ``{"skipped": ...}`` line first, and the base-96 student's line, last,
   is named ``patches_per_sec_per_chip_distill1_int8_at_ddim20_quality_256px``.

Inputs are bench.py's ``data(B, seed)`` with jax's own bits (``core/random.py``):
seed 1 for line 1, 3 for line 2, 7 for the headline and the ladder. Every timed call draws
fresh noise on the card and is timed with CUDA events. Called with ``device="cpu"`` (as the tests call the line functions,
at a small size) the lines run the same calls but carry ``"value": null``:
no device time is measured there.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import tempfile
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from s1s2_torch.core.parametrize import Parameterization, q_sample
from s1s2_torch.core.schedule import Schedule
from s1s2_torch import headline
from s1s2_torch.headline import CC, CT, EXPECT_MAE, TEACHER_ANCHOR, data, run_headline
from s1s2_torch.core import random
from s1s2_torch.data.synthetic import make_synthetic_patches
from s1s2_torch.models.quant import (make_cfg_rollout_calib, make_quant_cfg_denoise_fn,
                                     make_quant_denoise_fn, make_sampler_calib, quantize_unet)
from s1s2_torch.models.unet import init_params, load_unet
from s1s2_torch.models.weights import params_from_numpy
from s1s2_torch.sampling.dpm_solver import dpm_solver_2m
from s1s2_torch.sampling.grids import round_unique_grid
from s1s2_torch.sampling.samplers import (ddim_anchored, ddim_grid_sample, make_cfg_denoise_fn,
                                          make_denoise_fn)
from s1s2_torch.train.checkpoint import load_params

LINE1 = "patches_per_sec_per_chip_50step_ddim_256px_bf16"
LINE2 = "patches_per_sec_per_chip_dpm2m5_int8_at_ddim20_quality_256px"
HEADLINE = "patches_per_sec_per_chip_distill1_w{}_int8_at_ddim20_quality_256px"
# the base-96 student's line, bench.py's last fallback, has no width in its name
FALLBACK_METRIC = "patches_per_sec_per_chip_distill1_int8_at_ddim20_quality_256px"
# bench.py's preference order (spec, batch, params); the first present one
# is the headline, and "1", the base-96 student, comes last
HEADLINE_PREF = [("24x4", 128, "1.11M"), ("16x2", 128, "0.48M"), ("12", 128, "0.27M")]
FALLBACK = ("1", 64, "17M")
# bench.py's width ladder (spec, batch, params), narrowest/best last; the
# expected MAEs are headline.EXPECT_MAE's
WIDTHS = [("64", 64, "7.7M"), ("48", 128, "4.3M"), ("32", 128, "1.9M"), ("24", 256, "1.1M"),
          ("16", 128, "0.48M"), ("12", 128, "0.27M"), ("48x4", 128, "4.37M"),
          ("16x2", 128, "0.48M")]
CFG_LINE = "patches_per_sec_per_chip_cfg_g3_5step_int8_quality_equal_256px"
CFG_CKPT = "cfg_v_teacher.bf16.msgpack"
# committed cfg_sweep g=3 MAEs (examples/results_synthetic/CFG_Sweep/
# cfg_sweep_summary_{bf16_r4,int8_rollout_pc_bf16conv1}.csv)
CFG_ANCHORS = {"bf16": 0.29821, "int8": 0.29791}
CFG_INT8_FLAGS = ["--int8", "--int8_calib", "rollout", "--int8_perchannel",
                  "--int8_bf16_blocks", "conv1"]
CFG_G, CFG_BATCH, CFG_ITERS, CFG_COND_SEED = 3.0, 32, 8, 11
CFG_GRID = (999, 5, 1000)
CFG_SET = (129, 96, 128)  # rich set files, first and end of the scored range
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


def cfg_quality(ckpt: str = "", n_files: int = CFG_SET[0], first: int = CFG_SET[1],
                end: int = CFG_SET[2], size: int = 256, base_ch: int = 96,
                device="cuda") -> Dict[str, float]:
    """The CFG line's quality check, as bench.py runs it: the ``rich``
    synthetic set (seed 0; written uncompressed, the same values), files
    ``first``..``end-1`` through ``cli.evaluate --mode cfg_sweep`` at g=3,
    once in bf16 and once with ``CFG_INT8_FLAGS``. → {"bf16": MAE,
    "int8": MAE}. ``ckpt`` defaults to the committed cfg_v teacher;
    ``"@random"`` is the harness's fresh init (for a small run)."""
    from s1s2_torch.cli.evaluate import main as eval_main

    ckpt = ckpt or str(headline.CKPT_DIR / CFG_CKPT)
    maes = {}
    with tempfile.TemporaryDirectory() as td:
        patches = os.path.join(td, "rich")
        make_synthetic_patches(patches, n=n_files, size=size, seed=0, rich=True,
                               compress=False)
        lst = os.path.join(td, "eval.txt")
        with open(lst, "w") as f:
            f.write("".join(f"patch_{i:06d}.npz\n" for i in range(first, end)))
        for tag, extra in (("bf16", []), ("int8", CFG_INT8_FLAGS)):
            out = os.path.join(td, "out_" + tag)
            eval_main([
                "--mode", "cfg_sweep", "--patch_dir", patches, "--file_list", lst,
                "--ckpt", ckpt, "--pred_param", "v", "--t_start", str(CFG_GRID[0]),
                "--ddim_steps", str(CFG_GRID[1]), "--out_dir", out,
                "--guidance_scales", str(CFG_G), "--save_viz_n", "0",
                "--base_ch", str(base_ch), "--device", str(device)] + extra)
            with open(os.path.join(out, "cfg_sweep_summary.csv")) as f:
                maes[tag] = float(next(iter(csv.DictReader(f)))["MAE_mean"])
    return maes


def cfg_state(ckpt: str = "", base_ch: int = 96, device="cpu") -> Dict[str, torch.Tensor]:
    """The CFG line's weights: the committed cfg_v teacher, or with
    ``"@random"`` flax's init from ``PRNGKey(0)``."""
    if ckpt == "@random":
        state = init_params(CT, base_ch, 1, seed=0, in_ch=CC + CT)
    else:
        state = params_from_numpy(load_params(ckpt or str(headline.CKPT_DIR / CFG_CKPT)))
    return {k: v.to(device) for k, v in state.items()}


def make_cfg_samplers(state: Dict[str, torch.Tensor], batch: int = CFG_BATCH,
                      size: int = 256, base_ch: int = 96, device="cuda") -> Dict:
    """The CFG line's timed calls: the 5-step stacked-CFG ``ddim_grid_sample``
    (v, η = 0) at g=3 on cond ``normal(PRNGKey(11), (batch, size, size, 4))``
    from fresh noise·√(1−ᾱ_K) drawn on the card each call, through the bf16
    net and through the int8 net (rollout calibration on 8 of the conds,
    per-channel scales, ``conv1`` in bf16). → {"bf16": call, "int8": call,
    "qp": QuantParams}."""
    device = _device(device)
    schedule = Schedule.cosine(1000)
    grid = round_unique_grid(*CFG_GRID)
    vscale = float(np.sqrt(np.float32(1.0) - schedule.alpha_bar_np()[int(grid[-1])]))
    model = load_unet(state, CT, base_ch, 1, in_ch=CC + CT, compute_dtype=torch.bfloat16,
                      device=device)
    cond = torch.from_numpy(random.normal(random.PRNGKey(CFG_COND_SEED),
                                          (batch, size, size, CC))).to(device)
    calib = make_cfg_rollout_calib(model, cond, schedule, grid, CFG_G, param="v", out_ch=CT)
    qp = quantize_unet(state, calib, out_ch=CT, base_ch=base_ch, act_perchannel=True,
                       bf16_blocks=("conv1",))
    gen = torch.Generator(device=device).manual_seed(SEED + 12)

    def call(fn):
        def run():
            noise = torch.randn((batch, size, size, CT), generator=gen, dtype=torch.float32,
                                device=device) * vscale
            return ddim_grid_sample(fn, noise, schedule, grid, Parameterization.V)
        return run

    return {"bf16": call(make_cfg_denoise_fn(model, cond, CFG_G)),
            "int8": call(make_quant_cfg_denoise_fn(qp, cond, CFG_G)), "qp": qp}


def bench_cfg(ckpt: str = "", batch: int = CFG_BATCH, iters: int = CFG_ITERS, warmup: int = 1,
              size: int = 256, base_ch: int = 96, cfg_set=CFG_SET, device="cuda") -> Dict:
    """The guided-generation line: :func:`cfg_quality`, then ``iters`` timed
    calls of each of :func:`make_cfg_samplers`' after ``warmup``; the value
    is the int8 patches/s, as in bench.py."""
    device = _device(device)
    maes = cfg_quality(ckpt, *cfg_set, size=size, base_ch=base_ch, device=device)
    calls = make_cfg_samplers(cfg_state(ckpt, base_ch, device), batch, size, base_ch, device)
    r = {m: timed(calls[m], device, warmup, iters) for m in ("bf16", "int8")}
    pps = {m: batch * len(r[m]["ms"]) / (sum(r[m]["ms"]) / 1e3) if r[m]["ms"] else None
           for m in r}
    return {"metric": CFG_LINE, "value": pps["int8"], "unit": "patches/s",
            "config": f"cfg_v teacher, guidance {CFG_G}, 5-step stacked CFG, int8 rollout-calib"
                      f" + per-channel + bf16 conv1, B={batch}",
            "bf16_patches_per_s": pps["bf16"],
            "int8_speedup_vs_bf16": pps["int8"] / pps["bf16"] if pps["bf16"] else None,
            "verified_mae_bf16": maes["bf16"], "verified_mae_int8": maes["int8"],
            "quality_checked": bool(maes["int8"] <= maes["bf16"] + 0.002),
            "committed_anchor_bf16": CFG_ANCHORS["bf16"],
            "committed_anchor_int8": CFG_ANCHORS["int8"],
            "protocol": f"{cfg_set[0]}-file rich set (seed 0), --file_list files "
                        f"{cfg_set[1]}-{cfg_set[2] - 1}, cfg_sweep g={CFG_G:g}",
            "ms_per_batch": {m: sum(r[m]["ms"]) / len(r[m]["ms"]) if r[m]["ms"] else None
                             for m in r},
            "batch": batch, "iters": iters, **_result(r["int8"]),
            "device": device_name(device)}


def _rung_line(spec: str, batch: int, n_params: str, metric: str, r: Dict,
               ckpt_name: str) -> Dict:
    return {"metric": metric, "value": r["patches_per_s"],
            "unit": "patches/s", "ms_per_batch": r.get("ms_per_batch"),
            "config": f"width-distilled {spec} 1-step student, int8, B={batch} "
                      f"({n_params} params)",
            "quality_checked": r["quality_checked"], "verified_mae": r["mae"],
            "expect_mae": EXPECT_MAE[spec], "teacher_anchor": TEACHER_ANCHOR,
            "weights": ckpt_name, "device": r["device"]}


def bench_widths(device="cuda", n_files: int = 32, size: int = 256,
                 batch: Optional[int] = None, emit: Callable[[Dict], None] = print) -> List[Dict]:
    """The width ladder: one line a rung of ``WIDTHS`` (its own batch, or
    ``batch``), each self-verified and timed by ``run_headline``; an absent
    checkpoint gives a skip line."""
    device = _device(device)
    lines = []
    for spec, wb, n_params in WIDTHS:
        ckpt = headline.CKPT_DIR / f"distill_eps_student{spec}.bf16.msgpack"
        if not ckpt.is_file():
            emit({"skipped": f"w{spec}", "reason": f"checkpoint absent: {ckpt}"})
            continue
        wb = batch or wb
        r = run_headline(spec, batch=wb, device=device, n_files=n_files, size=size)
        line = _rung_line(spec, wb, n_params, HEADLINE.format(spec), r, ckpt.name)
        lines.append(line)
        emit(line)
    return lines


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
        return _rung_line(spec, batch, n_params, metric, r, ckpt.name)
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
    if os.environ.get("S1S2_BENCH_CFG"):
        if (headline.CKPT_DIR / CFG_CKPT).is_file():
            emit(bench_cfg())
        else:
            emit({"skipped": "cfg", "reason": f"checkpoint absent: "
                                              f"{headline.CKPT_DIR / CFG_CKPT}"})
    if os.environ.get("S1S2_BENCH_WIDTHS"):
        bench_widths(emit=emit)
    head = bench_headline(emit=emit)
    if head is not None:
        emit(head)
    return lines


if __name__ == "__main__":
    main()
