"""Compare strips for the distilled 1-step student: the port of the JAX
package's ``tools/demo_distill_viz.py``.

    python -m s1s2_torch.tools.demo_distill_viz --workdir W --out D [--k 4]
        [--teacher T --student S] [--param eps|v] [--device cpu]

For the first ``--k`` patches of a ``bench_distill`` workdir (its
``patches/``; ``--teacher``/``--student`` may be absolute paths, both base
96), it saves the true-colour strips ``GT | teacher ddim-20 | student
ddim-1`` (per-image percentile stretch, white gaps of 6 px) as
``patch{i:02d}_gt_teacher20_student1.png`` and ``summary.json`` with each
patch's masked MAE of both predictions, rounded to 5 decimals. Sampling is
GT-anchored from ``--t_start`` on the noise ``normal(PRNGKey(1234),
gt.shape)`` (jax's bits): linspace DDIM for an ε teacher and the student, the
round-unique grid for a v teacher.

Runs on the card by default (``--device cpu`` for the CPU), the nets in
bf16 (the conv kernel and the DDIM update kernel on the card);
``--compute_dtype float32`` is the CPU's parity mode.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("s1s2_torch.tools.demo_distill_viz")
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--teacher", default="teacher_last.msgpack")
    ap.add_argument("--student", default="student_endpoint.msgpack")
    ap.add_argument("--out", required=True)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--t_start", type=int, default=200)
    ap.add_argument("--param", choices=("eps", "v"), default="eps",
                    help="TEACHER parameterization (students are always eps)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--compute_dtype", choices=("bfloat16", "float32"), default="bfloat16",
                    help="the nets' compute dtype; float32 is the CPU's parity mode")
    return ap


def strip3(a: np.ndarray, b: np.ndarray, c: np.ndarray, gap: int = 6) -> np.ndarray:
    pad = np.full((a.shape[0], gap, 3), 255, np.uint8)
    return np.concatenate([a, pad, b, pad, c], axis=1)


def run(args) -> List[Dict]:
    from s1s2_torch.core import random
    from s1s2_torch.core.parametrize import Parameterization, q_sample
    from s1s2_torch.core.schedule import Schedule
    from s1s2_torch.data.dataset import load_set
    from s1s2_torch.eval.metrics import masked_mae_per_sample
    from s1s2_torch.sampling.grids import round_unique_grid
    from s1s2_torch.sampling.samplers import ddim_anchored, ddim_grid_sample, make_denoise_fn
    from s1s2_torch.tools.score_distill_full import TEACHER_BASE, load_net
    from s1s2_torch.train.trainer import DTYPES, resolve_device
    from s1s2_torch.viz.render import true_color, write_png

    device = resolve_device(args.device, "demo_distill_viz")
    dtype = DTYPES[args.compute_dtype]
    cond, gt, mask = load_set(os.path.join(args.workdir, "patches"), device,
                              max_files=args.k)
    teacher, _ = load_net(os.path.join(args.workdir, args.teacher), TEACHER_BASE, 1, dtype,
                          device)
    student, _ = load_net(os.path.join(args.workdir, args.student), TEACHER_BASE, 1, dtype,
                          device)
    schedule = Schedule.cosine(1000)
    noise = torch.from_numpy(random.normal(random.PRNGKey(1234), tuple(gt.shape))).to(device)

    def sample(net, steps, param="eps"):
        fn = make_denoise_fn(net, cond)
        if param == "eps":
            return ddim_anchored(fn, gt, schedule, args.t_start, steps, noise=noise)
        ab = schedule.alpha_bar_np()
        grid = round_unique_grid(args.t_start, steps, schedule.T)
        K = int(grid[-1])
        x_init = q_sample(gt, noise, float(np.sqrt(ab[K])), float(np.sqrt(1.0 - ab[K])))
        return ddim_grid_sample(fn, x_init, schedule, grid, Parameterization.V)

    t20 = sample(teacher, 20, args.param)
    s1 = sample(student, 1)

    def mae(pred, i):
        return round(float(masked_mae_per_sample(pred[i:i + 1], gt[i:i + 1], mask[i:i + 1])), 5)

    gt_np, t20_np, s1_np = (a.cpu().numpy() for a in (gt, t20, s1))

    os.makedirs(args.out, exist_ok=True)
    rows = []
    for i in range(gt_np.shape[0]):
        write_png(os.path.join(args.out, f"patch{i:02d}_gt_teacher20_student1.png"),
                  strip3(true_color(gt_np[i]), true_color(t20_np[i]), true_color(s1_np[i])))
        rows.append({"patch": i, "teacher20_mae": mae(t20, i), "student1_mae": mae(s1, i)})
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump({"layout": "GT | teacher ddim-20 | student ddim-1", "rows": rows}, f,
                  indent=1)
    print(json.dumps(rows))
    return rows


def main(argv=None) -> List[Dict]:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
