"""Roofline of the denoiser on the card: operations counted from the model's
shapes, and the measured rate of a forward and of the DDIM scan.

    python -m s1s2_torch.tools.roofline [--batch 64] [--base 96] [--stem 1]
        [--steps 50] [--iters 5] [--device cuda]

Port of the JAX package's ``tools/roofline.py``. It prints

* the operations of ONE denoiser forward at B=``batch`` and per patch, the
  bytes of that forward and their ratio (AI, operations a byte);
* the forward alone: patches/s and TFLOP/s over ``10·iters`` calls;
* the GT-anchored DDIM scan of ``steps`` steps from t=999: patches/s and
  TFLOP/s over ``iters`` calls, and its overhead over ``steps`` forwards;
* each rate's share of the card's dense bf16 tensor-core peak
  (``bench_conv.PEAK_OPS_PER_S["bf16"]``), ``mfu`` being the scan's;

then one JSON line of the same numbers. ``--stem`` counts a space-to-depth
student's forward (``--base 24 --stem 4``, the headline's 24x4).

**What is counted.** The JAX tool reads XLA's ``cost_analysis``; the port
counts the products its layers compute, 2 operations a multiply-add: the
13 3×3 convs at 9 taps an output pixel (``bench_conv.model_convs``: the
kernel multiplies the SAME padding's zero taps too), the three 2×2
stride-2 up-convs (one (Ci, 4·Co) product an input pixel) and the 1×1
head. XLA counts only the taps inside the image (a 3×3 conv at H×H has
(3H−2)² of 9H² in each image) and adds the elementwise work (bias, ReLU,
pools), so for base 96 at 256² the port's 3.0185e11 a patch is 1.0%
above the JAX tool's 2.98782e11, and at base 8, 32² 7.4% above its
3.1683e7 (the border taps weigh more in a small image;
``tests/test_torch_roofline.py`` holds the two counts together). The
bytes of a forward are counted the same way: every layer reads its input
and its weights once and writes its output once, bf16 activations and
weights, the f32 input and output of the network. Its elementwise and
glue passes are not counted as operations.

Timing is between CUDA events after one warm-up call; the inputs are drawn
on the card from a generator (cond and x ~ N(0, 1), gt ~ U[0, 1)), and the
weights are flax's init from ``PRNGKey(0)``. With ``--device cpu`` the
counts are printed and each path runs once, with no rate: the CPU gives no
device time.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

import torch

from s1s2_torch.core.schedule import Schedule
from s1s2_torch.models.unet import init_params, load_unet
from s1s2_torch.sampling.samplers import ddim_anchored, make_denoise_fn
from s1s2_torch.tools.bench_conv import PEAK_OPS_PER_S, model_convs, time_ms

CC = CT = 4
SIZE = 256
T_START, T_FWD = 999, 500


def forward_counts(base: int = 96, stem: int = 1, size: int = SIZE, batch: int = 1,
                   in_ch: int = CC + CT, out_ch: int = CT) -> Dict[str, float]:
    """Operations (2 a multiply-add) and bytes of one forward at ``batch``:
    ``convs``, ``up``, ``head``, ``ops`` (their sum) and ``bytes``."""
    body = size // stem
    convs = model_convs(base, stem, in_ch, size)
    ops_conv = sum(2.0 * 9 * H * H * ci * co for _, H, ci, co, _ in convs)
    nbytes = sum(2.0 * (H * H * (ci + co) * batch + 9 * ci * co) + 4.0 * co
                 for _, H, ci, co, _ in convs)
    ops_up = 0.0
    for level, ci, co in ((3, 8 * base, 4 * base), (2, 4 * base, 2 * base), (1, 2 * base, base)):
        h = body >> level
        ops_up += 2.0 * h * h * ci * 4 * co
        nbytes += 2.0 * (h * h * ci * batch + 4 * h * h * co * batch + 4 * ci * co) + 4.0 * co
    cho = out_ch * stem * stem
    ops_head = 2.0 * body * body * base * cho
    nbytes += 2.0 * (body * body * base * batch + base * cho) + 4.0 * cho
    nbytes += 4.0 * size * size * (in_ch + out_ch) * batch  # the f32 input and output
    return {"convs": ops_conv * batch, "up": ops_up * batch, "head": ops_head * batch,
            "ops": (ops_conv + ops_up + ops_head) * batch, "bytes": nbytes}


def run(batch: int = 64, base: int = 96, stem: int = 1, steps: int = 50, iters: int = 5,
        size: int = SIZE, device="cuda", emit=print) -> Dict:
    """Count, time and print; → the JSON line's dict."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("roofline measures the card: torch.cuda.is_available() is false "
                         "(--device cpu counts only)")
    c = forward_counts(base, stem, size, batch)
    emit(f"forward (B={batch}, base={base}, stem={stem}, {size}x{size}): operations = "
         f"{c['ops']:.4e} ({c['ops'] / batch:.4e} / patch; convs {c['convs'] / batch:.4e}, "
         f"up-convs {c['up'] / batch:.4e}, head {c['head'] / batch:.4e})")
    emit(f"  bytes = {c['bytes']:.4e}  (AI = {c['ops'] / c['bytes']:.1f} operations/byte)")

    model = load_unet(init_params(CT, base, stem, seed=0), CT, base, stem,
                      compute_dtype=torch.bfloat16, device=device)
    g = torch.Generator(device=device).manual_seed(1)
    x = torch.randn((batch, size, size, CC + CT), generator=g, device=device)
    gt = torch.rand((batch, size, size, CT), generator=g.manual_seed(2), device=device)
    t = torch.full((batch,), T_FWD, dtype=torch.int32, device=device)
    fn = make_denoise_fn(model, x[..., :CC])
    schedule = Schedule.cosine(1000)
    gen = torch.Generator(device=device).manual_seed(3)

    def scan():
        return ddim_anchored(fn, gt, schedule, T_START, steps, generator=gen)

    peak = PEAK_OPS_PER_S["bf16"]
    out = {"batch": batch, "base_ch": base, "stem_s2d": stem, "size": size, "steps": steps,
           "ops_per_forward": c["ops"], "ops_per_patch": c["ops"] / batch,
           "bytes_per_forward": c["bytes"], "ai": c["ops"] / c["bytes"], "peak_ops_per_s": peak,
           "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
    f_ms: Optional[float] = None
    s_ms: Optional[float] = None
    with torch.no_grad():
        if device.type == "cuda":
            f_ms = time_ms(lambda: model(x, t), [()], 10 * iters)
            s_ms = time_ms(scan, [()], iters)
        else:
            y, z = model(x, t), scan()
            out["finite"] = bool(torch.isfinite(y).all() and torch.isfinite(z).all())
    if f_ms is None:
        out.update(forward_ms=None, forward_patches_per_s=None, forward_tflops=None,
                   forward_mfu=None, scan_ms=None, scan_patches_per_s=None, scan_tflops=None,
                   mfu=None, scan_overhead=None)
        emit("no device time on the CPU: rates not measured")
    else:
        f_ops_s, s_ops_s = c["ops"] / (f_ms / 1e3), c["ops"] * steps / (s_ms / 1e3)
        per_step = s_ms / steps
        out.update(forward_ms=f_ms, forward_patches_per_s=batch / (f_ms / 1e3),
                   forward_tflops=f_ops_s / 1e12, forward_mfu=f_ops_s / peak,
                   scan_ms=s_ms, scan_patches_per_s=batch / (s_ms / 1e3),
                   scan_tflops=s_ops_s / 1e12, mfu=s_ops_s / peak,
                   scan_overhead=(per_step - f_ms) / f_ms)
        emit(f"forward-only: {out['forward_patches_per_s']:8.2f} patches/s  "
             f"{out['forward_tflops']:7.1f} TFLOP/s  MFU={out['forward_mfu']:.1%}")
        emit(f"ddim-{steps} scan: {out['scan_patches_per_s']:8.2f} patches/s  "
             f"{out['scan_tflops']:7.1f} TFLOP/s  MFU={out['mfu']:.1%}")
        emit(f"  per-step {per_step:.2f} ms vs forward {f_ms:.2f} ms "
             f"-> scan overhead {out['scan_overhead']:+.1%}")
    emit(json.dumps(out))
    return out


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--base", type=int, default=96)
    ap.add_argument("--stem", type=int, default=1, help="space-to-depth stem factor")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    return run(a.batch, a.base, a.stem, a.steps, a.iters, device=a.device)


if __name__ == "__main__":
    main()
