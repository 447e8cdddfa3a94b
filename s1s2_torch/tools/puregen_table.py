"""The pure-generation table: DDIM step budgets × CFG guidance scales through
the eval harness's ``true_infer`` mode, in one process.

    python -m s1s2_torch.tools.puregen_table --ckpt C --patch_dir P \\
        --out_dir O [--file_list F] [--int8] [--steps 1 2 5 10 20 50] \\
        [--scales 1 2] [--n_seeds 4] [--jsonl J] [--device cuda]

Port of the JAX package's ``tools/puregen_table.py``. The checkpoint loads
once (one ``EvalContext``); ``guidance_scale`` is set before the context is
made, so that an ``--int8`` calibration covers the null-cond pass too. Then
for each scale g and step budget: ``guidance_scale`` (None for g = 1) and
``ddim_steps`` are set on the config, which the harness reads when it
builds the denoiser and the grid, and ``run_true_infer`` writes that cell's
tables under ``O/g{g}_s{steps}/``. One JSON line a cell (``guidance``,
``steps``, ``calls``, ``t_start``, ``n_seeds``, ``int8`` and the mode's
metrics), appended to ``--jsonl`` when given, and ``O/puregen_table.csv``
with one row a cell. ``calls`` counts the denoiser calls of a sample: for
a v model ``steps`` counts the round-unique grid's points, so the calls are
its transitions, ``len(grid) − 1``; for ε, ``steps``. Runs on the card by
default (``--device cpu`` for the CPU).
"""

from __future__ import annotations

import argparse
import csv
import json
import os
from typing import Dict, List

from s1s2_torch.eval.harness import EvalConfig, EvalContext, run_true_infer
from s1s2_torch.sampling.grids import round_unique_grid


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("s1s2_torch.tools.puregen_table",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--patch_dir", required=True)
    ap.add_argument("--file_list", default=None)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--pred_param", default="v", choices=["eps", "v"])
    ap.add_argument("--base_ch", type=int, default=96)
    ap.add_argument("--T", type=int, default=1000)
    ap.add_argument("--t_start", type=int, default=999)
    ap.add_argument("--steps", type=int, nargs="+", default=[1, 2, 5, 10, 20, 50])
    ap.add_argument("--scales", type=float, nargs="+", default=[1.0, 2.0])
    ap.add_argument("--n_seeds", type=int, default=4)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--cache_dir", default=None)
    ap.add_argument("--jsonl", default=None,
                    help="also append one JSON row per cell here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None, emit=print) -> List[Dict]:
    args = build_parser().parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    cfg = EvalConfig(
        patch_dir=args.patch_dir, out_dir=args.out_dir, ckpt=args.ckpt,
        mode="true_infer", T=args.T, base_ch=args.base_ch,
        pred_param=args.pred_param, batch_size=args.batch_size,
        t_start=args.t_start, n_seeds=args.n_seeds, int8=args.int8,
        file_list=args.file_list, cache_dir=args.cache_dir, device=args.device,
        # set before the context: the int8 calibration then covers the null-cond pass
        guidance_scale=args.scales[0],
    )
    ctx = EvalContext(cfg)

    rows = []
    for g in args.scales:
        for steps in args.steps:
            cfg.guidance_scale = None if g == 1.0 else float(g)
            cfg.ddim_steps = int(steps)
            cfg.out_dir = os.path.join(args.out_dir, f"g{g:g}_s{steps}")
            os.makedirs(cfg.out_dir, exist_ok=True)
            r = run_true_infer(ctx)
            if args.pred_param == "v":
                calls = len(round_unique_grid(args.t_start, steps, args.T)) - 1
            else:
                calls = steps
            row = {"guidance": g, "steps": steps, "calls": calls,
                   "t_start": args.t_start,
                   "n_seeds": args.n_seeds, "int8": args.int8,
                   **{k: round(v, 6) for k, v in r.items()}}
            emit(json.dumps(row))
            if args.jsonl:
                with open(args.jsonl, "a") as f:
                    f.write(json.dumps(row) + "\n")
            rows.append(row)

    with open(os.path.join(args.out_dir, "puregen_table.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    return rows


if __name__ == "__main__":
    main()
