"""Full-scene stitched-inference throughput.

    python -m s1s2_torch.tools.bench_scene [--modes all|fast|cli] [--precision int8|bf16]

The port of the JAX package's ``tools/bench_scene.py``: times
``eval/scene.infer_scene`` on a synthetic H×W×4 cond scene
(``np.random.default_rng(0)``), the host's tiling and stitching included,
with the predictor of ``cli/infer_scene.py`` (the sampler a user runs), after
one warm-up scene of 4 tiles; the best of ``--repeats`` scenes is kept (seeds
0, 1, ...). The model is flax's init from ``PRNGKey(0)`` (throughput does not
depend on the weights) unless ``--ckpt`` is given; ``--precision int8``
(the default, as in the JAX tool) quantizes it on ``default_rng(0)`` inputs
at t ∈ (t_start, 100, 5).

Rows (``--modes all``): host noise and f32 both ways; noise drawn on the
device; cond sent in f16; predictions back in f16; f16 both ways with 3
batches in flight (``infer_scene --fast_transfer``); the device stitch with
3 in flight (``--fast_transfer --stitch device``). ``fast`` runs the last
two. ``cli`` runs the CLI's own three settings: its default (host noise,
host stitch), ``--stitch device`` and ``--fast_transfer``.

The sampler is the CLI's: ``--solver ddim`` is the linspace DDIM for ε (the
JAX tool's ``ddim`` runs the round-unique grid for both) and the
round-unique grid for v; ``dpm2m`` is DPM-Solver++(2M) on the round-unique
grid. Each row prints the card's name; on the CPU (``--device cpu``) the
seconds are the host's.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List

import numpy as np


def main(argv=None, emit=print) -> List[Dict]:
    ap = argparse.ArgumentParser("s1s2_torch bench_scene")
    ap.add_argument("--size", type=int, default=1536)
    ap.add_argument("--patch", type=int, default=256)
    ap.add_argument("--stride", type=int, default=192)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--t_start", type=int, default=200)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--base_ch", type=int, default=96)
    ap.add_argument("--s2d", type=int, default=1)
    ap.add_argument("--solver", choices=["dpm2m", "ddim"], default="dpm2m")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--pred_param", choices=["eps", "v"], default="eps")
    ap.add_argument("--modes", choices=["all", "fast", "cli"], default="all")
    ap.add_argument("--precision", choices=["int8", "bf16"], default="int8")
    ap.add_argument("--ckpt", default=None, help="weights (default: flax's init)")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)

    import torch

    from s1s2_torch.bench import _device, device_name
    from s1s2_torch.cli.infer_scene import build_parser, make_predictor
    from s1s2_torch.eval.scene import infer_scene, tile_coords
    from s1s2_torch.models.quant import quantize_unet
    from s1s2_torch.models.unet import init_params
    from s1s2_torch.models.weights import params_from_numpy
    from s1s2_torch.train.checkpoint import load_params

    device = _device(args.device)
    H = W = args.size
    ps, CT = args.patch, 4
    state = (params_from_numpy(load_params(args.ckpt)) if args.ckpt
             else init_params(CT, args.base_ch, args.s2d, seed=0, in_ch=8))
    state = {k: v.to(device) for k, v in state.items()}
    rng = np.random.default_rng(0)
    scene = rng.standard_normal((H, W, 4)).astype(np.float32)
    qp = None
    if args.precision == "int8":
        calib = [(torch.from_numpy(rng.standard_normal((8, ps, ps, 8)).astype(np.float32))
                  .to(device), torch.full((8,), t, dtype=torch.int32, device=device))
                 for t in (args.t_start, 100, 5)]
        qp = quantize_unet(state, calib, base_ch=args.base_ch, stem_s2d=args.s2d)
    cli = build_parser().parse_args([
        "--scene", "-", "--ckpt", "-", "--out_dir", "-", "--base_ch", str(args.base_ch),
        "--s2d", str(args.s2d), "--pred_param", args.pred_param, "--t_start",
        str(args.t_start), "--ddim_steps", str(args.steps), "--solver", args.solver,
        "--patch_size", str(ps), "--device", str(device)])

    def predictor(device_noise, f16_out):
        return make_predictor(cli, state, device, qp, device_noise, f16_out)

    dev_f16 = {"noise": "device", "transfer_dtype": np.float16}
    if args.modes == "cli":
        rows = (("host-noise f32 (the CLI's default)", predictor(False, False), {}),
                ("host-noise f32, device-stitch (--stitch device)", predictor(False, False),
                 {"stitch": "device"}),
                ("f16 both + pipeline-3 (--fast_transfer)", predictor(True, True),
                 {**dev_f16, "pipeline": 3}))
    else:
        rows = (("host-noise f32", predictor(False, False), {}),
                ("device-noise f32", predictor(True, False), {"noise": "device"}),
                ("device-noise f16-transfer", predictor(True, False), dev_f16),
                ("device-noise f16 both ways", predictor(True, True), dev_f16),
                ("f16 both + pipeline-3", predictor(True, True), {**dev_f16, "pipeline": 3}),
                ("device-stitch + pipeline-3", predictor(True, False),
                 {**dev_f16, "pipeline": 3, "stitch": "device"}))
        if args.modes == "fast":
            rows = rows[-2:]
    n_tiles = len(tile_coords(H, W, ps, args.stride))
    sampler = (f"{args.solver}-{args.steps} {args.precision} base{args.base_ch}"
               + (f" s2d{args.s2d}" if args.s2d > 1 else "")
               + f" {args.pred_param} t{args.t_start}")
    out_rows = []
    with torch.no_grad():
        for label, predict, kw in rows:
            infer_scene(predict, scene[:ps + 1, :ps + 1], CT, ps=ps, stride=ps,
                        batch_size=args.batch, **kw)  # warm-up
            best = None
            for r in range(args.repeats):
                t0 = time.perf_counter()
                infer_scene(predict, scene, CT, ps=ps, stride=args.stride,
                            batch_size=args.batch, rng_seed=r, **kw)
                dt = time.perf_counter() - t0
                best = dt if best is None else min(best, dt)
            out_rows.append({"mode": label, "scene": f"{H}x{W}", "tiles": n_tiles,
                             "batch": args.batch, "sampler": sampler, "scene_seconds": best,
                             "tiles_per_s": n_tiles / best, "mpx_per_s": H * W / best / 1e6,
                             "device": device_name(device)})
            emit(json.dumps(out_rows[-1]))
    return out_rows


if __name__ == "__main__":
    main()
