"""Held-out check of the width-distillation ladder: the teacher and every
committed student width scored on a synthetic set the students never saw,
on six metrics, in bf16 and int8:

    python -m s1s2_torch make_synthetic --out P --n 32 --size 256 --seed 1
    python -m s1s2_torch.tools.score_width_holdout --patch_dir P \\
        --widths 96 64 48 32 24 16 12 16x2 48x4 24x4 [--out rows.jsonl] [--device cpu]

Port of the JAX package's ``tools/score_width_holdout.py``: the base-96
teacher ``distill_eps_teacher`` at ddim-20, then for each ``--widths`` entry
(``BASE`` or ``BASExS``, S the space-to-depth stem; "96" is the base-96
student ``distill_eps_student1``) the student's GT-anchored DDIM-1 from
``--t_start`` and the same after per-tensor int8 quantization (calibration
at (t_start, t_start//2, 20)), all on the noise ``normal(PRNGKey(1234),
gt.shape)``. One JSON row each (rounded to 5 decimals); ``--out`` writes
them as JSONL. Runs on the card by default (``--device cpu`` for the CPU);
``--compute_dtype float32`` is the CPU's parity mode.
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, List

import torch

from s1s2_torch.data.dataset import load_set
from s1s2_torch.headline import CKPT_DIR
from s1s2_torch.tools.score_distill_full import NOISE_SEED, load_net, scorer, write_jsonl

WIDTHS = ["96", "64", "48", "32", "24", "16"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("s1s2_torch.tools.score_width_holdout")
    ap.add_argument("--patch_dir", required=True,
                    help="held-out patch dir (another make_synthetic seed than the "
                         "training/evidence set)")
    ap.add_argument("--t_start", type=int, default=200)
    ap.add_argument("--widths", type=str, nargs="+", default=WIDTHS,
                    help="BASE or BASExS (S = s2d stem factor; ckpt name "
                         "distill_eps_student{BASExS})")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--compute_dtype", choices=("bfloat16", "float32"), default="bfloat16",
                    help="the nets' compute dtype; float32 is the CPU's parity mode")
    return ap


def run(args, emit: Callable[[str], None] = print) -> List[Dict]:
    """The rows (unrounded): the teacher's, then two a width."""
    from s1s2_torch.core import random
    from s1s2_torch.core.schedule import Schedule
    from s1s2_torch.models.quant import (make_quant_denoise_fn, make_sampler_calib,
                                         quantize_unet)
    from s1s2_torch.sampling.samplers import ddim_anchored, make_denoise_fn
    from s1s2_torch.train.trainer import DTYPES, resolve_device

    device = resolve_device(args.device, "scoring")
    dtype = DTYPES[args.compute_dtype]
    schedule = Schedule.cosine(1000)
    ab = schedule.alpha_bar_np()
    cond, gt, mask = load_set(args.patch_dir, device)
    noise = torch.from_numpy(random.normal(random.PRNGKey(NOISE_SEED),
                                           tuple(gt.shape))).to(device)
    rows: List[Dict] = []
    score = scorer(gt, mask, rows, emit)

    def ddim(fn, steps):
        return ddim_anchored(fn, gt, schedule, args.t_start, steps, noise=noise)

    teacher, _ = load_net(str(CKPT_DIR / "distill_eps_teacher.bf16.msgpack"), 96, 1, dtype,
                          device)
    score("teacher_ddim20", ddim(make_denoise_fn(teacher, cond), 20))
    del teacher
    for spec in args.widths:
        w_s, _, s2d_s = str(spec).partition("x")
        w, s2d = int(w_s), int(s2d_s or 1)
        tag = "1" if (w == 96 and s2d == 1) else str(spec)
        net, state = load_net(str(CKPT_DIR / f"distill_eps_student{tag}.bf16.msgpack"), w, s2d,
                              dtype, device)
        score(f"student{spec}_ddim1", ddim(make_denoise_fn(net, cond), 1))
        calib = make_sampler_calib(gt, cond, ab, (args.t_start, max(args.t_start // 2, 1), 20))
        qp = quantize_unet(state, calib, base_ch=w, stem_s2d=s2d)
        score(f"student{spec}_int8_ddim1", ddim(make_quant_denoise_fn(qp, cond), 1))
    if args.out:
        write_jsonl(args.out, rows)
    return rows


def main(argv=None, emit: Callable[[str], None] = print) -> List[Dict]:
    return run(build_parser().parse_args(argv), emit)


if __name__ == "__main__":
    main()
