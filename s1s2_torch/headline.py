"""The main path end to end: a distilled int8 student's GT-anchored DDIM-1
(the 24x4, bench.py's fallbacks 16x2 and 12, or any rung of its width
ladder).

Port of the headline rung of the JAX package's benchmark (``bench.py``,
``rung``). In one process it

1. loads ``examples/checkpoints/distill_eps_student{spec}.bf16.msgpack``
   with the port's own msgpack reader;
2. regenerates the deterministic synthetic evidence set (seed 0, 32 files
   of 256², written to a temporary directory and read back);
3. calibrates on the first 8 files at t ∈ (200, 100, 20) through the bf16
   network (noise from ``PRNGKey(5)``, split once per t) and quantizes the
   double-conv blocks to int8;
4. runs one GT-anchored DDIM step from t=200 with the evidence noise
   ``normal(PRNGKey(1234), gt.shape)``;
5. scores it with ``masked_mae`` and checks it against the committed
   evidence MAE and the teacher anchor;
6. on a CUDA device, times patches/s of the same int8 DDIM-1 at ``batch``
   as bench.py times it: on ``data(batch, 7)`` (cond ~ N(0, 1) from
   ``PRNGKey(7)``, gt ~ U[0, 1) from ``PRNGKey(8)``, made once on the host
   and moved to the card), one warm-up call, then 100 calls between CUDA
   events, each drawing its own DDIM noise on the card inside the timed
   region.

Every host draw is the JAX package's own (``core/random.py``). The timed
calls' noise comes from a CUDA ``torch.Generator``, not from threefry: the
reference draws it on the device inside ``jit``, and a host draw would add
a host-to-device copy per call that the reference does not pay. That noise
feeds no MAE.
"""

from __future__ import annotations

import functools
import os
import tempfile
import time
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from s1s2_torch.core import random
from s1s2_torch.core.schedule import Schedule
from s1s2_torch.data.dataset import NpzPatchDataset
from s1s2_torch.data.synthetic import make_synthetic_patches
from s1s2_torch.eval.metrics import masked_mae
from s1s2_torch.models.quant import (make_quant_denoise_fn, make_sampler_calib,
                                     quantize_unet)
from s1s2_torch.models.weights import params_from_numpy, spec_arch
from s1s2_torch.ops.conv3x3 import conv3x3_relu, conv3x3_relu_int8
from s1s2_torch.ops.fused_elementwise import fused_ddim_update
from s1s2_torch.sampling.samplers import ddim_anchored
from s1s2_torch.train.checkpoint import load_params

CKPT_DIR = Path(__file__).resolve().parents[1] / "examples" / "checkpoints"
# committed int8 evidence MAEs (examples/results_synthetic/distill_width{spec}_metrics.jsonl)
# of the headline rungs and bench.py's WIDTHS ladder; "1", the base-96
# student, as bench.py states it
EXPECT_MAE = {"24x4": 0.32764, "16x2": 0.33557, "12": 0.34379, "1": 0.36465,
              "64": 0.34812, "48": 0.35026, "32": 0.34052, "24": 0.34453, "16": 0.34008,
              "48x4": 0.33002}
TEACHER_ANCHOR = 0.44074  # teacher ddim-20 evidence MAE
CALIB_TVALS, CALIB_N = (200, 100, 20), 8  # calibration noise: PRNGKey(5), split per t
NOISE_SEED = 1234  # the evidence noise: normal(PRNGKey(1234), gt.shape)
DATA_SEED = 7  # the timed inputs: data(batch, 7)
T_START, STEPS = 200, 1
WARMUP, TIMING_ITERS = 1, 100
CC = CT = 4  # cond and target channels
KERNELS = (conv3x3_relu, conv3x3_relu_int8, fused_ddim_update)


def launch_counts() -> Dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}


def evidence_set(n_files: int = 32, size: int = 256,
                 seed: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(cond, gt, mask) NHWC float32 numpy arrays of the synthetic evidence set."""
    with tempfile.TemporaryDirectory() as td:
        make_synthetic_patches(td, n=n_files, size=size, seed=seed, compress=False)
        ds = NpzPatchDataset(td)
        items = [ds[i] for i in range(len(ds))]
    cond = np.stack([it["cond"] for it in items])
    gt = np.stack([it["target"] for it in items])
    mask = np.stack([np.ones(it["target"].shape[:2], np.float32)
                     if it["mask"] is None else it["mask"] for it in items])
    return cond, gt, mask


@functools.lru_cache(maxsize=4)
def _data_host(B: int, seed: int, size: int) -> Tuple[np.ndarray, np.ndarray]:
    cond = random.normal(random.PRNGKey(seed), (B, size, size, CC))
    gt = random.uniform(random.PRNGKey(seed + 1), (B, size, size, CT))
    cond.flags.writeable = gt.flags.writeable = False
    return cond, gt


def data(B: int, seed: int, size: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """bench.py's random batch ``data(B, seed)``: cond = normal(PRNGKey(seed)),
    gt = uniform(PRNGKey(seed + 1)), (B, size, size, 4) f32 each, drawn on the
    host with jax's bits (kept for reuse) and moved to ``device``."""
    cond, gt = _data_host(B, seed, size)
    return torch.tensor(cond, device=device), torch.tensor(gt, device=device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prepare(spec: str = "24x4", device="cuda", n_files: int = 32,
            size: int = 256) -> Dict:
    """Steps 1-3: load the checkpoint, make the evidence set and quantize.
    Returns the QuantParams, the evidence tensors on ``device``, the
    schedule and per-step seconds."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    secs = {}
    t0 = time.perf_counter()
    base_ch, s2d = spec_arch(spec)
    ckpt = os.path.join(CKPT_DIR, f"distill_eps_student{spec}.bf16.msgpack")
    params = {k: v.to(device) for k, v in params_from_numpy(load_params(ckpt)).items()}
    secs["load"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cond_np, gt_np, mask_np = evidence_set(n_files, size)
    cond = torch.from_numpy(cond_np).to(device)
    gt = torch.from_numpy(gt_np).to(device)
    mask = torch.from_numpy(mask_np).to(device)
    secs["data"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    schedule = Schedule.cosine(1000)
    calib = make_sampler_calib(gt, cond, schedule.alpha_bar_np(), CALIB_TVALS, n=CALIB_N)
    qp = quantize_unet(params, calib, out_ch=gt.shape[-1], base_ch=base_ch,
                       stem_s2d=s2d)
    _sync(device)
    secs["calibrate"] = time.perf_counter() - t0
    return dict(device=device, qp=qp, cond=cond, gt=gt, mask=mask,
                schedule=schedule, seconds=secs,
                n_params=int(sum(v.numel() for v in params.values())))


def run_headline(spec: str = "24x4", batch: int = 128, device="cuda",
                 n_files: int = 32, size: int = 256) -> Dict:
    """Run the main path; returns the evidence MAE, its check, the kernel
    launches of the evidence DDIM-1, the QuantParams, phase seconds and (on
    a CUDA device) patches/s at ``batch``."""
    p = prepare(spec, device, n_files, size)
    device, qp, cond, gt, mask = p["device"], p["qp"], p["cond"], p["gt"], p["mask"]
    schedule, secs = p["schedule"], p["seconds"]

    t0 = time.perf_counter()
    noise = torch.from_numpy(random.normal(random.PRNGKey(NOISE_SEED), tuple(gt.shape))).to(device)
    before = launch_counts()
    pred = ddim_anchored(make_quant_denoise_fn(qp, cond), gt, schedule, T_START,
                         STEPS, noise=noise)
    mae = float(masked_mae(pred, gt, mask))
    after = launch_counts()
    secs["evidence"] = time.perf_counter() - t0
    expect = EXPECT_MAE.get(spec)
    out = {
        "spec": spec,
        "n_params": p["n_params"],
        "mae": mae,
        "expect_mae": expect,
        "teacher_anchor": TEACHER_ANCHOR,
        "quality_checked": bool(expect is not None and mae <= 0.95 * TEACHER_ANCHOR
                                and abs(mae - expect) < 0.02),
        "pred_shape": tuple(pred.shape),
        "pred_finite": bool(torch.isfinite(pred).all()),
        "evidence_launches": {k: after[k] - before[k] for k in after},
        "qp": qp,
        "batch": batch,
        "patches_per_s": None,
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu"),
        "seconds": secs,
    }
    if device.type == "cuda":
        t0 = time.perf_counter()
        cond_b, gt_b = data(batch, DATA_SEED, size, device)
        fn = make_quant_denoise_fn(qp, cond_b)
        gen = torch.Generator(device=device)
        gen.manual_seed(NOISE_SEED)
        for _ in range(WARMUP):
            ddim_anchored(fn, gt_b, schedule, T_START, STEPS, generator=gen)
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(TIMING_ITERS):
            ddim_anchored(fn, gt_b, schedule, T_START, STEPS, generator=gen)
        end.record()
        torch.cuda.synchronize(device)
        ms = start.elapsed_time(end) / TIMING_ITERS
        out.update(ms_per_batch=ms, patches_per_s=batch / (ms / 1e3),
                   timing_iters=TIMING_ITERS)
        secs["timing"] = time.perf_counter() - t0
    return out
