"""int8 against bf16, end to end: GT-anchored DDIM-50 on UNetSmall-96.

    python -m s1s2_torch.tools.bench_int8 [--batch 64] [--quant_up] \\
        [--ckpt examples/checkpoints/distill_eps_teacher.bf16.msgpack --patches D]

The port of the JAX package's ``tools/bench_int8.py``. It times the sampler
(``ddim_anchored`` from t=999, ``--steps`` steps) through the bf16 net and
through the int8 net (``models/quant.py``), and with ``--quant_up`` also
through the int8 net whose 2×2 transposed convs run in int8 on the matmul
kernel; with ``--ckpt`` and ``--patches`` it reports each path's MAE, so a
speedup is tied to its quality cost (without patches: the int8 outputs'
distance to bf16's).

As in the JAX tool: the model is flax's init from ``PRNGKey(0)`` (base 96)
unless ``--ckpt`` is given; the batch is the first ``--batch`` patches of
``--patches`` (repeated up to the batch), else cond ``normal(PRNGKey(1))``
and gt ``uniform(PRNGKey(2))``; the calibration is ``q_sample(gt)`` of the
first 8 rows at t ∈ (999, 600, 200, 50, 5), its noise from ``PRNGKey(3)``
split per t (drawn at the 8 rows' shape, ``models/quant.make_sampler_calib``;
the JAX tool draws the whole batch's and keeps 8 rows); the calls' noise is
``PRNGKey(9)`` for the warm-up and ``PRNGKey(10 + i)`` for timed call i,
drawn with jax's bits on the CPU and from a CUDA generator with those seeds
on a card. Timed calls run between CUDA events; on the CPU there is no
device time and patches/s is null.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

import numpy as np
import torch

CALIB_TVALS = (999, 600, 200, 50, 5)
SIZE, CC, CT = 256, 4, 4


def _batch(batch: int, patches: Optional[str], size: int):
    from s1s2_torch.core import random
    from s1s2_torch.data.dataset import NpzPatchDataset

    if patches:
        ds = NpzPatchDataset(patches)
        items = [ds[i] for i in range(min(len(ds), batch))]
        cond = np.stack([d["cond"] for d in items])
        gt = np.stack([d["target"] for d in items])
        while cond.shape[0] < batch:  # tile up to the batch
            cond, gt = np.concatenate([cond, cond])[:batch], np.concatenate([gt, gt])[:batch]
        return cond, gt
    return (random.normal(random.PRNGKey(1), (batch, size, size, CC)),
            random.uniform(random.PRNGKey(2), (batch, size, size, CT)))


def run(batch: int = 64, steps: int = 50, iters: int = 3, ckpt: Optional[str] = None,
        patches: Optional[str] = None, quant_up: bool = False, size: int = SIZE,
        base_ch: int = 96, device="cuda", emit=print) -> Dict:
    """The tool's measurement. → {"rows": [{"path", "patches_per_s"}], the
    report line's keys, "qp": {path: QuantParams}, "out": {path: output}}."""
    from s1s2_torch.bench import _device, timed
    from s1s2_torch.core import random
    from s1s2_torch.core.schedule import Schedule
    from s1s2_torch.models.quant import (QuantParams, calibrate, make_quant_denoise_fn,
                                         make_sampler_calib, quantize_weights)
    from s1s2_torch.models.unet import init_params, load_unet
    from s1s2_torch.models.weights import params_from_numpy
    from s1s2_torch.sampling.samplers import ddim_anchored, make_denoise_fn
    from s1s2_torch.train.checkpoint import load_params

    device = _device(device)
    state = (params_from_numpy(load_params(ckpt)) if ckpt
             else init_params(CT, base_ch, 1, seed=0, in_ch=CC + CT))
    state = {k: v.to(device) for k, v in state.items()}
    cond_np, gt_np = _batch(batch, patches, size)
    cond, gt = torch.from_numpy(cond_np).to(device), torch.from_numpy(gt_np).to(device)
    schedule = Schedule.cosine(1000)
    calib = make_sampler_calib(gt, cond, schedule.alpha_bar_np(), CALIB_TVALS,
                               key=random.PRNGKey(3), n=min(8, batch))
    scales = calibrate(state, calib, CT, base_ch)
    qps = {}
    for name, up in (("int8", False), ("int8_quant_up", True)) if quant_up else (("int8", False),):
        w8, bias = quantize_weights(state, quant_up=up)
        qps[name] = QuantParams(state, w8, bias, scales, CT, base_ch)
    emit(json.dumps({"calibrated": len(scales), "paths": ["bf16", *qps]}))
    model = load_unet(state, CT, base_ch, 1, in_ch=CC + CT, device=device)
    gen = torch.Generator(device=device) if device.type == "cuda" else None

    def call_noise(seed):
        if gen is None:
            return {"noise": torch.from_numpy(random.normal(random.PRNGKey(seed), gt.shape))}
        return {"generator": gen.manual_seed(seed)}

    rows: List[Dict] = []
    outs = {}
    fns = {"bf16": make_denoise_fn(model, cond),
           **{name: make_quant_denoise_fn(qp, cond) for name, qp in qps.items()}}
    for name, fn in fns.items():
        seeds = iter([9] + [10 + i for i in range(iters)])
        r = timed(lambda: ddim_anchored(fn, gt, schedule, 999, steps, **call_noise(next(seeds))),
                  device, warmup=1, iters=iters)
        outs[name] = r["out"].float().cpu().numpy()
        pps = batch * len(r["ms"]) / (sum(r["ms"]) / 1e3) if r["ms"] else None
        rows.append({"path": name, "patches_per_s": pps, "ms_per_call": r["ms"] or None})
        emit(json.dumps(rows[-1]))
    rep: Dict = {"speedup": {name: (rows[i]["patches_per_s"] / rows[0]["patches_per_s"]
                                    if rows[0]["patches_per_s"] else None)
                             for i, name in enumerate(fns) if i}}
    if patches:
        for name, out in outs.items():
            rep[f"mae_{name}"] = float(np.abs(out - gt_np).mean())
    else:
        for name in qps:
            d = np.abs(outs[name] - outs["bf16"])
            rep[f"{name}_vs_bf16_out_maxabs"] = float(d.max())
            rep[f"{name}_vs_bf16_out_mae"] = float(d.mean())
    emit(json.dumps(rep))
    return {"rows": rows, **rep, "qp": qps, "out": outs}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser("s1s2_torch bench_int8")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--patches", default=None)
    ap.add_argument("--quant_up", action="store_true",
                    help="also run the 2x2 transposed convs in int8")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)
    return run(args.batch, args.steps, args.iters, args.ckpt, args.patches, args.quant_up,
               device=args.device)


if __name__ == "__main__":
    main()
