"""Evidence run for the distilled few-step sampler:

    python -m s1s2_torch.tools.bench_distill --ckpt T.msgpack --int8 \\
        --epochs_per_phase 250 --endpoint_epochs 150 [--out W] [--device cpu]

Port of the JAX package's ``tools/bench_distill.py``. It trains a soak
teacher on synthetic patches (``train/trainer.train_loop``, base 96,
``--epochs``) or loads ``--ckpt`` (``--param`` ε or v), distills it
16 → 8 → 4 → 2 → 1 steps (``progressive_distill``, batches in
``default_rng(7 + phase·10000 + epoch)`` order) and optionally fine-tunes
the one-step student on the teacher's ddim-20 endpoints
(``--endpoint_epochs``), then scores GT-anchored reconstruction MAE from
``--t_start`` on the noise ``normal(PRNGKey(1234))``:

    teacher: ddim-20 (the quality anchor), ddim-2, ddim-1, dpm2m-5
    student: ddim-2, ddim-1; student_ep: ddim-1; (--int8) student_int8: ddim-1

One JSON line a row, then a summary with ``quality_matched_distill1``
(student ddim-1 MAE ≤ teacher ddim-20 MAE × 1.01) and, with ``--int8``,
``quality_matched_distill1_int8``. The workdir (``--out``, else a new
temporary directory) keeps ``patches/``, ``student.msgpack`` and
``student_endpoint.msgpack`` for ``score_distill_full``. Before the
student's rows, a ``progressive_timing`` line (a record per phase) and
after the endpoint phase an ``endpoint_timing`` line give the steps' rate:
the host's clock between a phase's first and last progress records, each
written after that epoch's losses were read back from the device (so the
window holds only steps on batches already there). Runs on the card
by default (``--device cpu`` for the CPU); ``--compute_dtype float32`` is
the CPU's parity mode. A bf16 checkpoint is read as f32 (the JAX tool keeps
its dtype, so its student would train in bf16).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Callable, Dict

import numpy as np
import torch

BASE = 96


def step_rate(stamps, steps_per_epoch: int):
    """{epochs_timed, s_per_epoch, ms_per_step} between the first and last
    of ``stamps`` ((clock, epoch) pairs), or None with fewer than two."""
    if len(stamps) < 2:
        return None
    (t0, e0), (t1, e1) = stamps[0], stamps[-1]
    s_ep = (t1 - t0) / (e1 - e0)
    return {"epochs_timed": e1 - e0, "s_per_epoch": s_ep,
            "ms_per_step": s_ep / steps_per_epoch * 1e3}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("s1s2_torch.tools.bench_distill")
    ap.add_argument("--epochs", type=int, default=40, help="teacher soak epochs")
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--t_start", type=int, default=200)
    ap.add_argument("--teacher_steps", type=int, default=16)
    ap.add_argument("--final_steps", type=int, default=1)
    ap.add_argument("--epochs_per_phase", type=int, default=8)
    ap.add_argument("--distill_lr", type=float, default=1e-4)
    ap.add_argument("--ckpt", default=None, help="skip teacher training")
    ap.add_argument("--param", choices=("eps", "v"), default="eps",
                    help="teacher parameterization (the student always "
                         "carries an eps head; distill converts internally)")
    ap.add_argument("--puregen", action="store_true",
                    help="distill/score the PURE-GENERATION map "
                         "(ddim_generate from unit noise; use with "
                         "--t_start 999). eps teachers only.")
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--endpoint_epochs", type=int, default=0,
                    help="after the progressive phases, fine-tune the 1-step "
                         "student on teacher ddim-20 ENDPOINTS for this many epochs")
    ap.add_argument("--endpoint_seeds", type=int, default=4,
                    help="noise draws per patch for the endpoint target set")
    ap.add_argument("--skip_progressive", action="store_true",
                    help="endpoint-only: fine-tune straight from the teacher "
                         "(requires --endpoint_epochs > 0)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--compute_dtype", choices=("bfloat16", "float32"), default="bfloat16",
                    help="the nets' compute dtype; float32 is the CPU's parity mode")
    return ap


def run(args, emit: Callable[[str], None] = print) -> Dict:
    """→ {"rows": {(tag, steps): MAE}, "summary": {...}}."""
    from s1s2_torch.core import random
    from s1s2_torch.core.parametrize import Parameterization, q_sample
    from s1s2_torch.core.schedule import Schedule
    from s1s2_torch.data.dataset import load_set
    from s1s2_torch.data.synthetic import make_synthetic_patches
    from s1s2_torch.eval.metrics import masked_mae
    from s1s2_torch.models.quant import make_quant_denoise_fn, quantize_unet
    from s1s2_torch.models.unet import UNetSmall, load_unet
    from s1s2_torch.models.weights import params_from_numpy
    from s1s2_torch.sampling.dpm_solver import dpm_solver_2m
    from s1s2_torch.sampling.grids import round_unique_grid
    from s1s2_torch.sampling.samplers import (ddim_anchored, ddim_generate, ddim_grid_sample,
                                              make_denoise_fn)
    from s1s2_torch.train.checkpoint import load_model, save_model
    from s1s2_torch.train.distill import DistillConfig, endpoint_distill, progressive_distill
    from s1s2_torch.train.trainer import DTYPES, resolve_device

    device = resolve_device(args.device, "distillation")
    dtype = DTYPES[args.compute_dtype]
    work = args.out or tempfile.mkdtemp(prefix="s1s2_distill_")
    patches = os.path.join(work, "patches")
    if not os.path.isdir(patches) or not os.listdir(patches):
        make_synthetic_patches(patches, n=args.n, size=args.size, seed=0)

    T = 1000
    schedule = Schedule.cosine(T)
    model = UNetSmall(out_ch=4, base_ch=BASE, compute_dtype=dtype, autograd=True)
    log = lambda d: emit(json.dumps(d))  # noqa: E731
    if args.ckpt:
        teacher = params_from_numpy(load_model(model.state_dict(), args.ckpt))
    else:
        from s1s2_torch.train.loop import TrainConfig
        from s1s2_torch.train.trainer import RunConfig, train_loop

        run_cfg = RunConfig(patch_dir=patches, model_path=os.path.join(work, "teacher.msgpack"),
                            epochs=args.epochs, batch_size=args.batch, base_ch=BASE, seed=0,
                            compute_dtype=args.compute_dtype, device=str(device))
        hist = train_loop(run_cfg, TrainConfig(T=T, pred_param=args.param),
                          progress=lambda d: d.get("avg_loss") is not None and log(d))
        teacher = hist["final_state"].ema_tree()

    cond, gt, mask = load_set(patches, device)
    noise = torch.from_numpy(random.normal(random.PRNGKey(1234), tuple(gt.shape))).to(device)
    ab = schedule.alpha_bar_np()

    def mae(pred):
        return float(masked_mae(pred, gt, mask))

    rows: Dict = {}

    def anchored_init(steps):
        grid = round_unique_grid(args.t_start, steps, T)
        K = int(grid[-1])
        return grid, q_sample(gt, noise, float(np.sqrt(ab[K])), float(np.sqrt(1.0 - ab[K])))

    def score(tag, params, steps_list, dpm=False, param="eps"):
        fn = make_denoise_fn(load_unet(params, 4, BASE, compute_dtype=dtype, device=device),
                             cond)
        p = Parameterization(param)
        for steps in steps_list:
            if args.puregen:
                out = ddim_generate(fn, tuple(gt.shape), schedule, args.t_start, steps,
                                    noise=noise)
            elif param == "eps":
                out = ddim_anchored(fn, gt, schedule, args.t_start, steps, noise=noise)
            else:
                # the v head has no linspace anchored sampler: the round-unique
                # grid with the same anchored init
                grid, x_init = anchored_init(steps)
                out = ddim_grid_sample(fn, x_init, schedule, grid, p)
            rows[(tag, steps)] = mae(out)
            log({"model": tag, "sampler": "ddim", "steps": steps,
                 "mae": round(rows[(tag, steps)], 5)})
        if dpm:
            grid, x_init = anchored_init(5)
            rows[(tag, "dpm2m5")] = mae(dpm_solver_2m(fn, x_init, schedule, grid, p))
            log({"model": tag, "sampler": "dpm2m", "steps": 5,
                 "mae": round(rows[(tag, "dpm2m5")], 5)})

    anchor_steps = 50 if args.puregen else 20
    score("teacher", teacher, (anchor_steps, 2, 1), dpm=not args.puregen, param=args.param)

    cfg = DistillConfig(T=T, t_start=args.t_start, teacher_steps=args.teacher_steps,
                        final_steps=args.final_steps, epochs_per_phase=args.epochs_per_phase,
                        lr=args.distill_lr, teacher_param=args.param)
    # the whole set stays on the device: batches are gathered there
    n_ds = cond.shape[0]
    bsz = min(args.batch, n_ds)  # never zero batches on tiny sets

    def device_batches(seed):
        order = torch.from_numpy(np.random.default_rng(seed).permutation(n_ds)).to(device)
        for lo in range(0, n_ds - bsz + 1, bsz):
            idx = order[lo:lo + bsz]
            yield cond.index_select(0, idx), gt.index_select(0, idx), mask.index_select(0, idx)

    stamps = []

    def log_timed(d):
        stamps.append((time.perf_counter(), d))
        log(d)

    if args.skip_progressive:
        student = teacher
    else:
        result = progressive_distill(
            model, schedule, cfg, teacher,
            batches=lambda phase, epoch: device_batches(7 + phase * 10_000 + epoch),
            progress=log_timed, device=device)
        student = result["params"]
        log({"progressive_timing": [
            {"phase": p, "student_steps": s_steps, **(step_rate(
                [(t, d["epoch"]) for t, d in stamps if d.get("phase") == p], n_ds // bsz)
                or {})} for p, s_steps in enumerate(cfg.phase_steps())]})
        save_model(student, os.path.join(work, "student.msgpack"))
        score("student", student, (2, 1))

    if args.endpoint_epochs > 0:
        student = endpoint_distill(
            model, schedule, cfg, student, teacher, cond, gt, mask,
            epochs=args.endpoint_epochs, batch_size=args.batch, teacher_steps=anchor_steps,
            n_seeds=args.endpoint_seeds, mode="puregen" if args.puregen else "anchored",
            progress=log_timed, device=device)
        n_ep = n_ds * args.endpoint_seeds
        log({"endpoint_timing": step_rate(
            [(t, d["endpoint_epoch"]) for t, d in stamps if "endpoint_epoch" in d],
            n_ep // min(args.batch, n_ep))})
        save_model(student, os.path.join(work, "student_endpoint.msgpack"))
        score("student_ep", student, (1,))

    best1 = min(v for (tag, s), v in rows.items() if s == 1 and tag != "teacher")
    summary = {
        "teacher_anchor_steps": anchor_steps,
        "teacher_ddim20_mae": round(rows[("teacher", anchor_steps)], 5),
        "teacher_ddim1_mae": round(rows[("teacher", 1)], 5),
        "student_ddim1_mae": round(best1, 5),
        "quality_matched_distill1": bool(best1 <= rows[("teacher", anchor_steps)] * 1.01),
        "workdir": work,
    }
    if ("student", 2) in rows:
        summary["student_ddim2_mae"] = round(rows[("student", 2)], 5)

    if args.int8:
        calib = []
        for tval in (args.t_start, args.t_start // 2, 5):
            x_c = q_sample(gt[:8], noise[:8], float(np.sqrt(ab[tval])),
                           float(np.sqrt(1.0 - ab[tval])))
            calib.append((torch.cat([x_c, cond[:8]], dim=-1),
                          torch.full((x_c.shape[0],), tval, dtype=torch.int32, device=device)))
        qp = quantize_unet({k: v.to(device) for k, v in student.items()}, calib, base_ch=BASE)
        fn_q = make_quant_denoise_fn(qp, cond)
        if args.puregen:
            out = ddim_generate(fn_q, tuple(gt.shape), schedule, args.t_start, 1, noise=noise)
        else:
            out = ddim_anchored(fn_q, gt, schedule, args.t_start, 1, noise=noise)
        m = mae(out)
        rows[("student_int8", 1)] = m
        log({"model": "student_int8", "sampler": "ddim", "steps": 1, "mae": round(m, 5)})
        summary["student_int8_ddim1_mae"] = round(m, 5)
        summary["quality_matched_distill1_int8"] = bool(
            m <= rows[("teacher", anchor_steps)] * 1.01)
    emit(json.dumps(summary))
    return {"rows": rows, "summary": summary}


def main(argv=None, emit: Callable[[str], None] = print) -> Dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.skip_progressive and args.endpoint_epochs <= 0:
        ap.error("--skip_progressive needs --endpoint_epochs > 0 "
                 "(otherwise there is no student to score)")
    if args.puregen and args.param != "eps":
        ap.error("--puregen needs an eps teacher")
    return run(args, emit)


if __name__ == "__main__":
    main()
