"""A profiler trace of the flagship 50-step DDIM sampler on the card.

    python -m s1s2_torch.tools.profile_forward [OUT_DIR] [--device cuda]

Port of the JAX package's ``tools/profile_forward.py``: the full-width
UNetSmall (base 96, flax's init from ``PRNGKey(0)``, bf16) as an ε
denoiser, GT-anchored DDIM, 50 steps from t=999, at B=32 on 256² inputs
(cond ~ N(0, 1), gt ~ U[0, 1), drawn on the card from a generator); one
untimed call, then one call under ``torch.profiler``
(``trace_headline.profile``). It writes the Chrome trace to
``OUT_DIR/trace.json`` (default: ``s1s2_trace`` in the temporary
directory) and prints the call's wall time, the device's idle share and
its top device ops, as ``trace_headline`` prints them. ``--device cpu``
traces the host only (``run``'s ``batch``, ``base``, ``size`` and ``steps``
give a tiny run).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Dict

import torch

from s1s2_torch.core.schedule import Schedule
from s1s2_torch.models.unet import init_params, load_unet
from s1s2_torch.sampling.samplers import ddim_anchored, make_denoise_fn
from s1s2_torch.trace_headline import profile

CC = CT = 4


def run(out_dir: str, batch: int = 32, base: int = 96, size: int = 256, steps: int = 50,
        device="cuda", emit=print) -> Dict:
    """Trace one DDIM call into ``out_dir/trace.json``; → ``profile``'s dict
    with ``trace`` (the file's path)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profile_forward traces the card: torch.cuda.is_available() is false "
                         "(--device cpu traces the host)")
    model = load_unet(init_params(CT, base, 1, seed=0), CT, base, 1,
                      compute_dtype=torch.bfloat16, device=device)
    g = torch.Generator(device=device).manual_seed(1)
    cond = torch.randn((batch, size, size, CC), generator=g, device=device)
    gt = torch.rand((batch, size, size, CT), generator=g.manual_seed(2), device=device)
    fn = make_denoise_fn(model, cond)
    schedule = Schedule.cosine(1000)
    gen = torch.Generator(device=device).manual_seed(3)
    os.makedirs(out_dir, exist_ok=True)
    trace = os.path.join(out_dir, "trace.json")
    r = profile(lambda: ddim_anchored(fn, gt, schedule, 999, steps, generator=gen), 1, 1,
                trace, device)
    emit(f"{r['device']} ddim-{steps} B={batch} base={base} {size}x{size}: wall "
         f"{r['wall_ms']:.4f} ms/call, kernels {r['kernel_ms']:.4f} ms (hand-written "
         f"{r['ours_ms']:.4f}), idle share "
         + ("-" if r["idle_share"] is None else f"{r['idle_share']:.3f}"))
    for k in r["kernels"][:20]:
        emit(f"  {k['ms']:9.4f} ms {k['calls']:6.1f}x {'*' if k['ours'] else ' '} "
             f"{k['name'][:110]}")
    emit(f"trace written to {trace}")
    r["trace"] = trace
    emit(json.dumps({k: v for k, v in r.items() if k != "kernels"}))
    return r


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", nargs="?", default=os.path.join(tempfile.gettempdir(), "s1s2_trace"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    return run(a.out, device=a.device)


if __name__ == "__main__":
    main()
