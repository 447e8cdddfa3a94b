"""The solver quality-against-steps evidence table, on the card.

    python -m s1s2_torch.tools.bench_quality_matched [--epochs 8] [--n 32]
        [--size 256] [--batch 8] [--t_start 200] [--ckpt X] [--int8] [--out W]
        [--device cuda]

Port of the JAX package's ``tools/bench_quality_matched.py``. It makes
``--n`` synthetic patches (seed 0) in the workdir (``--out``, else a new
temporary directory), trains a soak model on them
(``train/trainer.train_loop``: base 96, ε, ``--epochs`` epochs at
``--batch``, seed 0, one JSON line a progress record) or loads ``--ckpt``
(a ``.msgpack``, or a reference ``.pth``), then scores GT-anchored
reconstruction from ``--t_start`` over the same files and noise
(``normal(PRNGKey(1234), gt.shape)``, jax's bits from ``core/random.py``,
so the card and the CPU share it): DDIM {20, 10, 5} steps
(``ddim_anchored``) and DPM-Solver++(2M) {10, 5} steps on
``round_unique_grid(t_start, steps, 1000)`` from ``q_sample(gt, noise)``
at the grid's top, one JSON line a row with the masked MAE. With
``--int8`` the same rows again through the int8 net (calibrated at
(t_start, t_start // 2, 5) on the first 8 files with that same noise at
every t, as the JAX tool calibrates). The last line is the JAX tool's
summary: ``quality_matched`` (dpm2m-5 MAE ≤ 1.01 × ddim-20 MAE),
``ddim20_mae``, ``dpm2m5_mae``, ``workdir``, and with ``--int8``
``dpm2m5_int8_mae`` and ``quality_matched_int8``.

Soak models establish the solvers' ordering (the 2nd-order multistep
solver matching DDIM at about 4× fewer calls), not absolute quality.
Runs on the card by default; ``--device cpu`` for the CPU. :func:`score`
is the scoring alone, for a caller that has the model (its
``compute_dtype`` float32 is the CPU's parity mode).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from s1s2_torch.core import random
from s1s2_torch.core.parametrize import Parameterization, q_sample
from s1s2_torch.core.schedule import Schedule
from s1s2_torch.models.quant import make_quant_denoise_fn, make_sampler_calib, quantize_unet
from s1s2_torch.models.unet import load_unet
from s1s2_torch.sampling.dpm_solver import dpm_solver_2m
from s1s2_torch.sampling.grids import round_unique_grid
from s1s2_torch.sampling.samplers import ddim_anchored, make_denoise_fn

T = 1000
BASE = 96
NOISE_SEED = 1234
DDIM_STEPS, DPM_STEPS = (20, 10, 5), (10, 5)
MATCH = 1.01  # dpm2m-5 matches ddim-20 within 1%


def score(params: Dict[str, torch.Tensor], cond: torch.Tensor, gt: torch.Tensor,
          mask: torch.Tensor, t_start: int = 200, int8: bool = False, base_ch: int = BASE,
          compute_dtype: torch.dtype = torch.bfloat16,
          emit: Callable[[str], None] = print) -> Dict[Tuple[str, int], float]:
    """The table's rows for ``params`` on (cond, gt, mask) (tensors on the
    device the model runs on): {(sampler, steps): masked MAE}, the sampler
    ``ddim``/``dpm2m`` and with ``int8`` also ``ddim_int8``/``dpm2m_int8``.
    The MAE is the JAX tool's, on the host: Σ|(pred − gt)·m| / (Σm · C)."""
    device = gt.device
    schedule = Schedule.cosine(T)
    ab = schedule.alpha_bar_np()
    noise = torch.from_numpy(random.normal(random.PRNGKey(NOISE_SEED),
                                           tuple(gt.shape))).to(device)
    gt_np, m = gt.cpu().numpy(), mask.cpu().numpy()[..., None]

    def mae(pred):
        return float(np.abs((pred.cpu().numpy() - gt_np) * m).sum()
                     / (m.sum() * gt_np.shape[-1]))

    model = load_unet(params, gt.shape[-1], base_ch, compute_dtype=compute_dtype,
                      device=device)
    fns = {"": make_denoise_fn(model, cond)}
    if int8:
        calib = make_sampler_calib(gt, cond, ab, (t_start, t_start // 2, 5),
                                   noises=[noise] * 3)
        qp = quantize_unet(params, calib, out_ch=gt.shape[-1], base_ch=base_ch)
        fns["_int8"] = make_quant_denoise_fn(qp, cond)
    rows = {}
    for suffix, fn in fns.items():
        for steps in DDIM_STEPS:
            out = ddim_anchored(fn, gt, schedule, t_start, steps, noise=noise)
            rows[(f"ddim{suffix}", steps)] = mae(out)
            emit(json.dumps({"sampler": f"ddim{suffix}", "steps": steps,
                             "mae": round(rows[(f"ddim{suffix}", steps)], 5)}))
        for steps in DPM_STEPS:
            grid = round_unique_grid(t_start, steps, T)
            K = int(grid[-1])
            x_init = q_sample(gt, noise, float(np.sqrt(ab[K])), float(np.sqrt(1.0 - ab[K])))
            out = dpm_solver_2m(fn, x_init, schedule, grid, Parameterization.EPS)
            rows[(f"dpm2m{suffix}", steps)] = mae(out)
            emit(json.dumps({"sampler": f"dpm2m{suffix}", "steps": steps,
                             "mae": round(rows[(f"dpm2m{suffix}", steps)], 5)}))
    return rows


def summary(rows: Dict[Tuple[str, int], float], work: str) -> Dict:
    """The JAX tool's last line."""
    d20 = rows[("ddim", 20)]
    out = {"quality_matched": bool(rows[("dpm2m", 5)] <= d20 * MATCH),
           "ddim20_mae": round(d20, 5), "dpm2m5_mae": round(rows[("dpm2m", 5)], 5),
           "workdir": work}
    if ("dpm2m_int8", 5) in rows:
        out["dpm2m5_int8_mae"] = round(rows[("dpm2m_int8", 5)], 5)
        out["quality_matched_int8"] = bool(rows[("dpm2m_int8", 5)] <= d20 * MATCH)
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("s1s2_torch.tools.bench_quality_matched",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--n", type=int, default=32, help="synthetic patch count")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--t_start", type=int, default=200)
    ap.add_argument("--ckpt", default=None, help="skip training, load this .msgpack/.pth")
    ap.add_argument("--int8", action="store_true",
                    help="also score the quantized int8 path (models/quant.py)")
    ap.add_argument("--out", default=None, help="workdir (default: tmp)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None, emit: Callable[[str], None] = print) -> Dict:
    args = build_parser().parse_args(argv)
    from s1s2_torch.data.dataset import load_set
    from s1s2_torch.data.synthetic import make_synthetic_patches
    from s1s2_torch.models.unet import UNetSmall
    from s1s2_torch.models.weights import params_from_numpy
    from s1s2_torch.train.checkpoint import load_any_checkpoint
    from s1s2_torch.train.trainer import resolve_device

    device = resolve_device(args.device, "bench_quality_matched")
    work = args.out or tempfile.mkdtemp(prefix="s1s2_qm_")
    patches = os.path.join(work, "patches")
    if not os.path.isdir(patches) or not os.listdir(patches):
        make_synthetic_patches(patches, n=args.n, size=args.size, seed=0)
    if args.ckpt:
        template = UNetSmall(out_ch=4, base_ch=BASE).state_dict()
        loaded = load_any_checkpoint(args.ckpt, template=template)
        params = params_from_numpy(loaded["params"] if args.ckpt.endswith(".pth") else loaded)
    else:
        from s1s2_torch.train.loop import TrainConfig
        from s1s2_torch.train.trainer import RunConfig, train_loop

        run = RunConfig(patch_dir=patches, model_path=os.path.join(work, "soak.msgpack"),
                        epochs=args.epochs, batch_size=args.batch, base_ch=BASE, seed=0,
                        device=str(device))
        hist = train_loop(run, TrainConfig(T=T, pred_param="eps"),
                          progress=lambda d: emit(json.dumps(d)))
        params = hist["final_state"].ema_tree()
    params = {k: v.to(device) for k, v in params.items()}
    cond, gt, mask = load_set(patches, device)
    rows = score(params, cond, gt, mask, args.t_start, args.int8, BASE, emit=emit)
    out = summary(rows, work)
    emit(json.dumps(out))
    return {"rows": rows, "summary": out}


if __name__ == "__main__":
    main()
