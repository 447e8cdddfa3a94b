"""Full-metric scoring of a distilled student against its teacher:

    python -m s1s2_torch.tools.score_distill_full --workdir W [--int8]
        [--student_base_ch 24 --student_s2d 4] [--out rows.jsonl] [--device cpu]

Port of the JAX package's ``tools/score_distill_full.py``. It reads the
teacher (base 96) and the student from a ``bench_distill`` workdir (its
``patches/`` set; ``--teacher``/``--student`` may be absolute paths) and
scores, GT-anchored from ``--t_start`` on the noise ``normal(PRNGKey(1234),
gt.shape)`` (jax's bits), the teacher's ddim-20 and ddim-1 (a v teacher on
the round-unique grid), the student's ddim-``--student_steps``, and with
``--int8`` the student quantized per tensor after calibration at (t_hi,
t_hi//2, 20) (``make_sampler_calib``), on six metrics (masked MAE, MSE,
PSNR, SSIM, SAM, ERGAS). One JSON row each (rounded to 5 decimals), then a
summary row with ``quality_matched_full``; ``--out`` writes them as JSONL.

Runs on the card by default (``--device cpu`` for the CPU); the bf16 nets
run the conv kernel there and the DDIM update kernel on every pass.
``--compute_dtype float32`` is the CPU's parity mode (the conv kernel takes
bf16 only).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Dict, List

import numpy as np
import torch

TEACHER_BASE = 96
NOISE_SEED = 1234
METRICS = ("mae", "mse", "psnr", "ssim", "sam_rad", "ergas")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("s1s2_torch.tools.score_distill_full")
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--teacher", default="teacher_last.msgpack")
    ap.add_argument("--student", default="student_endpoint.msgpack")
    ap.add_argument("--t_start", type=int, default=200)
    ap.add_argument("--param", choices=("eps", "v"), default="eps",
                    help="TEACHER parameterization (students are always eps)")
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--student_steps", type=int, default=1,
                    help="student DDIM budget (2 for a progressive-only 2-step student)")
    ap.add_argument("--student_base_ch", type=int, default=96,
                    help="student UNet width (width-distilled students, "
                         "distill --student_base_ch)")
    ap.add_argument("--student_s2d", type=int, default=1,
                    help="student's space-to-depth stem factor (matches distill --student_s2d)")
    ap.add_argument("--out", default=None, help="write rows to this JSONL")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--compute_dtype", choices=("bfloat16", "float32"), default="bfloat16",
                    help="the nets' compute dtype; float32 is the CPU's parity mode")
    return ap


def rounded(row: Dict) -> Dict:
    return {k: (round(v, 5) if isinstance(v, float) else v) for k, v in row.items()}


def scorer(gt: torch.Tensor, mask: torch.Tensor, rows: List[Dict],
           emit: Callable[[str], None]) -> Callable[[str, torch.Tensor], Dict]:
    """``score(tag, pred)`` → the six-metric row (appended to ``rows``,
    emitted rounded)."""
    from s1s2_torch.eval import metrics as M

    def score(tag, pred):
        row = {"model": tag, "mae": float(M.masked_mae(pred, gt, mask)),
               "mse": float(M.masked_mse(pred, gt, mask)), "psnr": float(M.psnr(pred, gt, mask)),
               "ssim": float(M.ssim_simple(pred, gt)), "sam_rad": float(M.sam(pred, gt, mask)),
               "ergas": float(M.ergas(pred, gt, mask))}
        rows.append(row)
        emit(json.dumps(rounded(row)))
        return row

    return score


def load_net(path: str, base_ch: int, s2d: int, dtype: torch.dtype, device):
    """(inference UNetSmall, its f32 state on ``device``) of a checkpoint."""
    from s1s2_torch.models.unet import load_unet
    from s1s2_torch.models.weights import params_from_numpy
    from s1s2_torch.train.checkpoint import load_params

    state = params_from_numpy(load_params(path))
    net = load_unet(state, 4, base_ch, s2d, compute_dtype=dtype, device=device)
    return net, {k: v.to(device) for k, v in state.items()}


def write_jsonl(path: str, rows: List[Dict]) -> None:
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(rounded(r)) + "\n")


def run(args, emit: Callable[[str], None] = print) -> List[Dict]:
    """The rows (unrounded), the summary last."""
    from s1s2_torch.core import random
    from s1s2_torch.core.parametrize import Parameterization, q_sample
    from s1s2_torch.core.schedule import Schedule
    from s1s2_torch.data.dataset import load_set
    from s1s2_torch.models.quant import (make_quant_denoise_fn, make_sampler_calib,
                                         quantize_unet)
    from s1s2_torch.sampling.grids import round_unique_grid
    from s1s2_torch.sampling.samplers import ddim_anchored, ddim_grid_sample, make_denoise_fn
    from s1s2_torch.train.trainer import DTYPES, resolve_device

    device = resolve_device(args.device, "scoring")
    dtype = DTYPES[args.compute_dtype]
    schedule = Schedule.cosine(1000)
    cond, gt, mask = load_set(os.path.join(args.workdir, "patches"), device)
    teacher, _ = load_net(os.path.join(args.workdir, args.teacher), TEACHER_BASE, 1, dtype,
                          device)
    student, s_state = load_net(os.path.join(args.workdir, args.student), args.student_base_ch,
                                args.student_s2d, dtype, device)
    noise = torch.from_numpy(random.normal(random.PRNGKey(NOISE_SEED),
                                           tuple(gt.shape))).to(device)
    rows: List[Dict] = []
    score = scorer(gt, mask, rows, emit)

    def sample(net, steps, param="eps"):
        fn = make_denoise_fn(net, cond)
        if param == "eps":
            return ddim_anchored(fn, gt, schedule, args.t_start, steps, noise=noise)
        # v teachers: round-unique grid with the anchored init (bench_distill --param v)
        ab = schedule.alpha_bar_np()
        grid = round_unique_grid(args.t_start, steps, schedule.T)
        K = int(grid[-1])
        x_init = q_sample(gt, noise, float(np.sqrt(ab[K])), float(np.sqrt(1.0 - ab[K])))
        return ddim_grid_sample(fn, x_init, schedule, grid, Parameterization.V)

    t20 = score("teacher_ddim20", sample(teacher, 20, args.param))
    score("teacher_ddim1", sample(teacher, 1, args.param))
    n_s = args.student_steps
    s1 = score(f"student_ep_ddim{n_s}", sample(student, n_s))

    if args.int8:
        ab = schedule.alpha_bar_np()
        t_hi = min(max(args.t_start, 1), schedule.T - 1)
        qp = quantize_unet(s_state, make_sampler_calib(gt, cond, ab, (t_hi, max(t_hi // 2, 1),
                                                                      20)),
                           base_ch=args.student_base_ch, stem_s2d=args.student_s2d)
        score(f"student_ep_int8_ddim{n_s}",
              ddim_anchored(make_quant_denoise_fn(qp, cond), gt, schedule, args.t_start, n_s,
                            noise=noise))

    summary = {"summary": True, "quality_matched_full": bool(
        s1["mae"] <= t20["mae"] * 1.01 and s1["ssim"] >= t20["ssim"] - 0.01
        and s1["sam_rad"] <= t20["sam_rad"] * 1.05)}
    rows.append(summary)
    emit(json.dumps(summary))
    if args.out:
        write_jsonl(args.out, rows)
    return rows


def main(argv=None, emit: Callable[[str], None] = print) -> List[Dict]:
    return run(build_parser().parse_args(argv), emit)


if __name__ == "__main__":
    main()
