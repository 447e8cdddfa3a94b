"""Configuration sweep of the 50-step DDIM flagship path on the card: batch
size × up-conv form.

    python -m s1s2_torch.tools.bench_variants [quick] [--device cuda]

Port of the JAX package's ``tools/bench_variants.py``: the full-width
UNetSmall (base 96, flax's init from ``PRNGKey(0)``) in bf16, GT-anchored
DDIM, 50 steps from t=999, over B ∈ {8, 16, 32, 64} (``quick``: 32) and
``up`` ∈ {ps, convt} (``UNetSmall(up_impl=...)``: the matmul and pixel
shuffle, or ``F.conv_transpose2d``; the 3×3 convs run on the port's
kernel in both). Each cell: one warm-up call, then 3 calls between CUDA
events, each on fresh noise drawn on the card; inputs cond ~ N(0, 1) and
gt ~ U[0, 1) drawn on the card from generators seeded 1 and 2. One JSON
line a cell with the JAX keys ``B``, ``up`` and ``patches_per_s``, or
``error`` (its first 100 characters) when the cell fails (out of memory),
and ``device``. ``--device cpu`` runs each cell once, with no rate
(``run``'s ``steps``, ``size`` and ``base`` give a tiny run).
"""

from __future__ import annotations

import argparse
import itertools
import json
from typing import Dict, List

import torch

from s1s2_torch.core.schedule import Schedule
from s1s2_torch.models.unet import UP_IMPLS, init_params, load_unet
from s1s2_torch.sampling.samplers import ddim_anchored, make_denoise_fn

CC = CT = 4


def bench_one(B: int, up_impl: str, steps: int = 50, iters: int = 3, size: int = 256,
              base: int = 96, device="cuda"):
    """patches/s of one cell (None on the CPU, where the calls run once)."""
    device = torch.device(device)
    model = load_unet(init_params(CT, base, 1, seed=0), CT, base, 1,
                      compute_dtype=torch.bfloat16, device=device, up_impl=up_impl)
    g = torch.Generator(device=device)
    cond = torch.randn((B, size, size, CC), generator=g.manual_seed(1), device=device)
    gt = torch.rand((B, size, size, CT), generator=g.manual_seed(2), device=device)
    fn = make_denoise_fn(model, cond)
    schedule = Schedule.cosine(1000)
    gen = torch.Generator(device=device).manual_seed(3)

    def call():
        return ddim_anchored(fn, gt, schedule, 999, steps, generator=gen)

    out = call()
    if device.type != "cuda":
        return None, bool(torch.isfinite(out).all())
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        out = call()
    end.record()
    torch.cuda.synchronize(device)
    return B * iters / (start.elapsed_time(end) / 1e3), bool(torch.isfinite(out).all())


def run(quick: bool = False, steps: int = 50, size: int = 256, base: int = 96,
        device="cuda", emit=print) -> List[Dict]:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_variants measures the card: torch.cuda.is_available() is false "
                         "(--device cpu for a run without rates)")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    rows = []
    for B, up in itertools.product([32] if quick else [8, 16, 32, 64], UP_IMPLS):
        try:
            pps, finite = bench_one(B, up, steps, size=size, base=base, device=device)
            row = {"B": B, "up": up, "patches_per_s": None if pps is None else round(pps, 2),
                   "finite": finite, "device": name}
        except torch.cuda.OutOfMemoryError as e:
            row = {"B": B, "up": up, "error": str(e)[:100], "device": name}
        emit(json.dumps(row))
        rows.append(row)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", nargs="?", choices=("quick",), default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    return run(a.mode == "quick", device=a.device)


if __name__ == "__main__":
    main()
