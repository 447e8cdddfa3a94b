"""Training-step throughput: patches/s of the train step (forward, backward,
AdamW, EMA) at 256², base 96, bf16, v, remat off and on.

    python -m s1s2_torch.tools.bench_train [batch sizes ...] [--device cuda]
        [--size 256] [--base_ch 96] [--iters 10]

Port of the JAX package's ``tools/bench_train.py``: its model (flax's init
from ``PRNGKey(0)``), its ``TrainConfig(T=1000, pred_param="v")``, one
warm-up step, then ``iters`` steps timed on the host clock up to a
synchronize, default batch sizes 4 8 16 32. Its JSON line per (B, remat)
gains ``bound_share``, the rate as a share of the reckoned bound (below),
``peak_mem_bytes`` (``torch.cuda.max_memory_allocated`` over the warm-up
and the timed steps), ``device``, and the last step's ``loss`` and
``skipped``. On the card the inputs and the step's draws come from CUDA
generators (cond ``randn`` seeded 1, x0 ``rand`` seeded 2); on the CPU
they are the JAX tool's threefry bits.

The bound: a forward's 13 3×3 convs do 2·9·Cin·Cout·H·W operations each
(2.94e11 a 256² base-96 sample); a step does three times that (the forward
and the backward's two products), four with remat (the forward again),
over the card's bf16 peak (``PEAK_BF16_OPS_PER_S``, H100 SXM, dense).
"""

from __future__ import annotations

import argparse
import functools
import json
import time

import torch

from s1s2_torch.core import random
from s1s2_torch.core.schedule import Schedule
from s1s2_torch.models.unet import UNetSmall, init_params
from s1s2_torch.train.loop import TrainConfig, create_train_state, make_train_step

PEAK_BF16_OPS_PER_S = 989e12
CC = CT = 4


def conv_ops_per_sample(base_ch: int = 96, size: int = 256, in_ch: int = CC + CT) -> float:
    """Operations of one forward's 13 3×3 convs for one sample."""
    b = base_ch
    total = 2 * 9 * (in_ch + 1) * b * size * size  # inc
    for ci, co, level in ((b, 2 * b, 0), (2 * b, 4 * b, 1), (4 * b, 8 * b, 2),  # down1-3
                          (8 * b, 4 * b, 2), (4 * b, 2 * b, 1), (2 * b, b, 0)):  # conv3-1
        total += 2 * 9 * (ci * co + co * co) * (size >> level) ** 2
    return float(total)


def step_ops_per_sample(base_ch: int = 96, size: int = 256, remat: bool = False) -> float:
    return (4 if remat else 3) * conv_ops_per_sample(base_ch, size)


@functools.lru_cache(maxsize=2)
def _params(base_ch: int):
    return init_params(CT, base_ch, 1, seed=0, in_ch=CC + CT)


def data(B: int, size: int, device: torch.device):
    """(cond, x0, mask) of the JAX tool: cond N(0,1), x0 U[0,1), mask ones."""
    shape = (B, size, size, CC)
    if device.type == "cpu":
        return (torch.from_numpy(random.normal(random.PRNGKey(1), shape)),
                torch.from_numpy(random.uniform(random.PRNGKey(2), shape)),
                torch.ones(shape[:3]))
    g = torch.Generator(device=device)
    cond = torch.randn(shape, generator=g.manual_seed(1), device=device)
    x0 = torch.rand(shape, generator=g.manual_seed(2), device=device)
    return cond, x0, torch.ones(shape[:3], device=device)


def bench(B: int, remat: bool = False, iters: int = 10, size: int = 256, base_ch: int = 96,
          device="cuda") -> dict:
    """One (B, remat) line: warm-up step, then ``iters`` timed steps."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_train measures the card and no CUDA card is present; "
                           "pass --device cpu for a CPU run")
    model = UNetSmall(CT, base_ch, 1, CC + CT, torch.bfloat16, autograd=True, remat=remat)
    cfg = TrainConfig(T=1000, pred_param="v")
    state = create_train_state(_params(base_ch), cfg, device)
    step = make_train_step(model, Schedule.cosine(1000), cfg)
    batch = data(B, size, device)
    key = random.PRNGKey(3)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    state, m = step(state, batch, key)  # warm-up
    if cuda:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        state, m = step(state, batch, key)
    loss = float(m["loss"])  # waits for the last step
    dt = time.perf_counter() - t0
    pps = B * iters / dt
    bound_pps = PEAK_BF16_OPS_PER_S / step_ops_per_sample(base_ch, size, remat)
    return {"B": B, "remat": remat, "train_patches_per_s": pps,
            "bound_share": pps / bound_pps if cuda else None,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(device) if cuda else None,
            "device": torch.cuda.get_device_name(device) if cuda else "cpu",
            "loss": loss, "skipped": int(state.skipped)}


def main(argv=None, emit=print) -> list:
    ap = argparse.ArgumentParser("s1s2_torch.tools.bench_train")
    ap.add_argument("batch_sizes", nargs="*", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--base_ch", type=int, default=96)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    rows = []
    for B in args.batch_sizes or [4, 8, 16, 32]:
        for remat in (False, True):
            try:
                row = bench(B, remat, args.iters, args.size, args.base_ch, args.device)
            except torch.cuda.OutOfMemoryError as e:  # the JAX tool's line for a batch too large
                row = {"B": B, "remat": remat, "error": str(e)[:120]}
            torch.cuda.empty_cache()
            rows.append(row)
            emit(json.dumps(row))
    return rows


if __name__ == "__main__":
    main()
