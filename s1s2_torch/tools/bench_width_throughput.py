"""Throughput of the int8 one-step anchored DDIM against the UNet's width and
space-to-depth stem, on the card.

    python -m s1s2_torch.tools.bench_width_throughput [--widths 96 64 48 24x2]
        [--batches 64 128] [--iters 30] [--device cuda]

Port of the JAX package's ``tools/bench_width_throughput.py``. A width is
BASE or BASExS (S the stem's space-to-depth factor, ``UNetSmall.stem_s2d``):
``--widths 12 24x2 48x4`` takes base 12 at full resolution, base 24 on a
2× stem and base 48 on a 4× stem (the last two at base 12's operations
with S× wider channels at (256/S)² body resolution). For each width, on
random weights (flax's init from ``PRNGKey(0)``: the rate does not depend
on them):

1. calibrate on 8 rows (cond ``normal(PRNGKey(3))``, gt
   ``uniform(PRNGKey(4))``, jax's bits from ``core/random.py``) at t ∈
   (200, 100, 20) (``models/quant.make_sampler_calib``) and quantize the
   double-conv blocks to int8 (``quantize_unet``);
2. for each batch size: one warm-up call, then ``iters`` calls of
   GT-anchored DDIM-1 from t=200 through the int8 net
   (``make_quant_denoise_fn``, built once outside the timed region), each
   on fresh noise drawn on the card inside the timed region, between CUDA
   events. The timed inputs are drawn on the card from generators seeded
   13 and 14 (the JAX tool uses ``PRNGKey(13)`` and ``(14)``; on the CPU
   the port draws those bits).

One JSON line a (width, batch), with the JAX tool's keys: ``base_ch``,
``s2d``, ``batch``, ``params_m`` and ``distill1_int8_patches_per_s``
(null with ``--device cpu``: no device time there), and ``device``.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Tuple

import torch

from s1s2_torch.core import random
from s1s2_torch.core.schedule import Schedule
from s1s2_torch.models.quant import (QuantParams, make_quant_denoise_fn, make_sampler_calib,
                                     quantize_unet)
from s1s2_torch.models.unet import init_params
from s1s2_torch.sampling.samplers import ddim_anchored

CC = CT = 4
SIZE = 256
CALIB_TVALS, CALIB_N = (200, 100, 20), 8
T_START, STEPS = 200, 1


def parse_width(spec: str) -> Tuple[int, int]:
    """"BASE" or "BASExS" → (base, s2d)."""
    base, _, s2d = spec.partition("x")
    return int(base), int(s2d or 1)


def quantized(spec: str, size: int = SIZE, device="cuda") -> Tuple[QuantParams, int]:
    """A width's int8 net on random weights and its parameter count."""
    base, s2d = parse_width(spec)
    params = {k: v.to(device) for k, v in init_params(CT, base, s2d, seed=0).items()}
    cond = torch.from_numpy(random.normal(random.PRNGKey(3), (CALIB_N, size, size, CC)))
    gt = torch.from_numpy(random.uniform(random.PRNGKey(4), (CALIB_N, size, size, CT)))
    calib = make_sampler_calib(gt.to(device), cond.to(device),
                               Schedule.cosine(1000).alpha_bar_np(), CALIB_TVALS, n=CALIB_N)
    qp = quantize_unet(params, calib, out_ch=CT, base_ch=base, stem_s2d=s2d)
    return qp, int(sum(v.numel() for v in params.values()))


def inputs(batch: int, size: int, device: torch.device):
    """The timed (cond, gt): jax's bits of PRNGKey(13)/(14) on the CPU, a
    generator's draws on the card."""
    shape = (batch, size, size, CC)
    if device.type == "cpu":
        return (torch.from_numpy(random.normal(random.PRNGKey(13), shape)),
                torch.from_numpy(random.uniform(random.PRNGKey(14), shape)))
    g = torch.Generator(device=device)
    return (torch.randn(shape, generator=g.manual_seed(13), device=device),
            torch.rand(shape, generator=g.manual_seed(14), device=device))


def sampler(qp: QuantParams, cond: torch.Tensor, gt: torch.Tensor):
    """Int8 GT-anchored DDIM-1 from t=200 through ``qp``, its denoiser and
    schedule built once: → ``call(noise=None, generator=None)`` (``noise``
    given, or drawn with ``generator`` on gt's device)."""
    fn, schedule = make_quant_denoise_fn(qp, cond), Schedule.cosine(1000)

    def call(noise=None, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return ddim_anchored(fn, gt, schedule, T_START, STEPS, noise=noise, generator=generator)

    return call


def run(widths=("96", "64", "48"), batches=(64, 128), iters: int = 30, size: int = SIZE,
        device="cuda", emit=print) -> List[Dict]:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_width_throughput measures the card: torch.cuda.is_available() "
                         "is false (--device cpu for a run without rates)")
    rows = []
    for spec in widths:
        base, s2d = parse_width(spec)
        qp, n_par = quantized(spec, size, device)
        for B in batches:
            cond, gt = inputs(B, size, device)
            call = sampler(qp, cond, gt)
            gen = torch.Generator(device=device).manual_seed(9)
            call(generator=gen)  # warm-up
            pps = None
            if device.type == "cuda":
                torch.cuda.synchronize(device)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(iters):
                    out = call(generator=gen)
                end.record()
                torch.cuda.synchronize(device)
                pps = B * iters / (start.elapsed_time(end) / 1e3)
            else:
                out = call(generator=gen)
            row = {"base_ch": base, "s2d": s2d, "batch": B, "params_m": round(n_par / 1e6, 2),
                   "distill1_int8_patches_per_s": None if pps is None else round(pps, 1),
                   "finite": bool(torch.isfinite(out).all()),
                   "device": torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu"}
            emit(json.dumps(row))
            rows.append(row)
            del cond, gt, out, call
        del qp
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--widths", type=str, nargs="+", default=["96", "64", "48"],
                    help="BASE or BASExS (S = s2d stem factor)")
    ap.add_argument("--batches", type=int, nargs="+", default=[64, 128])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    return run(a.widths, a.batches, a.iters, device=a.device)


if __name__ == "__main__":
    main()
