"""Full-scene inference CLI: tile a large preprocessed scene, run the batched
sampler per tile, stitch with feathered blending. The port of the JAX
package's ``cli/infer_scene.py``, with its flags and ``--device``.

    python -m s1s2_torch.cli.infer_scene --scene cond.npy --ckpt m.msgpack \\
        --out_dir out --pred_param v --t_start 999 --ddim_steps 50

``--scene`` is a (H,W,4) or (4,H,W) .npy of S1 conditioning channels (raw
values with --normalize, else already Patch.py-normalized). The sampler is
the JAX CLI's: ε DDIM on the linspace grid (the fused DDIM kernel), v DDIM
on the round-unique grid (η from ``fold_in(PRNGKey(seed), tag)``, the tag
the bits of the batch's first noise value, or its first seed), or
DPM-Solver++(2M); ``--guidance_scale`` stacks cond and null-cond, ``--int8``
quantizes on the scene's first tiles. ``--fast_transfer`` draws each tile's
noise on the card from a ``torch.Generator`` seeded with ``(seed·2²⁰ +
tile) & 0x7FFFFFFF`` (the JAX package draws ``normal(PRNGKey(that))``:
other bits, the same determinism per (seed, tile); on the CPU the port
draws JAX's bits), moves cond and predictions in f16 and keeps 3 batches in
flight. ``--mesh_data N`` shards each tile batch over N processes, one per
device, launched by ``python -m torch.distributed.run --nproc_per_node N -m
s1s2_torch infer_scene ...`` (``parallel.shard_predict_batch``: each rank
samples its rows, every rank gathers the batch); rank 0 writes the scene.
"""

import argparse
import json
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("s1s2_torch infer_scene")
    ap.add_argument("--scene", required=True, help=".npy cond scene")
    ap.add_argument("--mask", default=None, help="optional (H,W) .npy valid mask")
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--T", type=int, default=1000)
    ap.add_argument("--base_ch", type=int, default=96)
    ap.add_argument("--out_ch", type=int, default=4)
    ap.add_argument("--pred_param", choices=["eps", "v"], default="eps")
    ap.add_argument("--t_start", type=int, default=999)
    ap.add_argument("--ddim_steps", type=int, default=50)
    ap.add_argument("--eta", type=float, default=0.0)
    ap.add_argument("--patch_size", type=int, default=256)
    ap.add_argument("--stride", type=int, default=192)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--normalize", action="store_true",
                    help="apply Patch.py per-tile normalization to raw S1")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--guidance_scale", type=float, default=None)
    ap.add_argument("--solver", choices=["ddim", "dpm2m"], default="ddim")
    ap.add_argument("--mesh_data", type=int, default=0,
                    help="shard tile batches over N processes' 'data' axis (one per device; "
                         "the world must be N)")
    ap.add_argument("--fast_transfer", action="store_true",
                    help="draw each tile's noise on the device (deterministic per tile), "
                         "move cond/pred in f16, keep 3 batches in flight")
    ap.add_argument("--stitch", choices=["host", "device"], default="host",
                    help="'device' feather-accumulates on the device; the scene comes "
                         "back once")
    ap.add_argument("--s2d", type=int, default=1,
                    help="checkpoint's UNetSmall.stem_s2d factor")
    ap.add_argument("--int8", action="store_true",
                    help="quantized int8 inference, calibrated on the scene's first tiles")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    return ap


def read_scene(args):
    """(scene (H,W,C) f32, mask (H,W) f32 or None) from the CLI's files."""
    scene = np.load(args.scene).astype(np.float32)
    if scene.ndim != 3:
        raise ValueError("scene must be 3-D")
    if scene.shape[0] <= 8 and scene.shape[-1] > 8:
        scene = np.transpose(scene, (1, 2, 0))  # CHW → HWC
    mask = np.load(args.mask).astype(np.float32) if args.mask else None
    return scene, mask


def calibrate_on_scene(args, state, scene, mask, device):
    """The JAX CLI's int8 recipe (``cli/infer_scene.py:97-129``): the
    scene's first 8 tiles (normalized with ``--normalize``) as cond, x_t
    drawn from ``np.random.default_rng(seed)`` at the top of the trajectory
    (unit noise), halfway (0.6·z + 0.2) and t=5 (0.2·z + 0.5)."""
    import torch

    from s1s2_torch.eval.scene import normalize_tile, tile_coords
    from s1s2_torch.models.quant import quantize_unet

    ps, t_hi = args.patch_size, min(max(args.t_start, 1), args.T - 1)
    tiles = []
    for r, c in tile_coords(scene.shape[0], scene.shape[1], ps, args.stride)[:8]:
        t = scene[r:r + ps, c:c + ps].astype(np.float32)
        if args.normalize:
            t = normalize_tile(t, mask[r:r + ps, c:c + ps] if mask is not None else None)
        tiles.append(t)
    cond = torch.from_numpy(np.stack(tiles)).to(device)
    n = cond.shape[0]
    rng = np.random.default_rng(args.seed)
    calib = []
    for tval, amp, mu in ((t_hi, 1.0, 0.0), (max(t_hi // 2, 1), 0.6, 0.2), (5, 0.2, 0.5)):
        x_t = (rng.standard_normal((n, ps, ps, args.out_ch)) * amp + mu).astype(np.float32)
        calib.append((torch.cat([torch.from_numpy(x_t).to(device), cond], dim=-1),
                      torch.full((n,), tval, dtype=torch.int32, device=device)))
    return quantize_unet(state, calib, out_ch=args.out_ch, base_ch=args.base_ch,
                         stem_s2d=args.s2d)


def make_predictor(args, state, device, qp=None, device_noise=None, f16_out=None):
    """The per-batch sampler ``(cond_b, noise_b) → (B,ps,ps,out_ch)`` tensor
    on ``device``: cond (B,ps,ps,Cc) in any float type, noise (B,ps,ps,out_ch)
    f32, or with ``device_noise`` a (B,) int32 array of per-tile seeds; the
    output in f16 with ``f16_out``. Both default to ``--fast_transfer``'s
    (f16 out unless ``--stitch device``). ``qp``, when given, is the int8
    net; otherwise the bf16 net holds ``state``."""
    import torch

    from s1s2_torch.core import random
    from s1s2_torch.core.parametrize import Parameterization
    from s1s2_torch.core.schedule import Schedule
    from s1s2_torch.eval.scene import upload
    from s1s2_torch.models.quant import make_quant_cfg_denoise_fn, make_quant_denoise_fn
    from s1s2_torch.models.unet import load_unet
    from s1s2_torch.sampling.dpm_solver import dpm_solver_2m
    from s1s2_torch.sampling.grids import round_unique_grid
    from s1s2_torch.sampling.samplers import (_ddim_linspace_scan, ddim_grid_sample,
                                              make_cfg_denoise_fn, make_denoise_fn)

    schedule = Schedule.cosine(args.T)
    param = Parameterization(args.pred_param)
    grid = round_unique_grid(args.t_start, args.ddim_steps, args.T)
    ab = float(schedule.alpha_bar_np()[min(max(args.t_start, 1), args.T - 1)])
    vscale = float(np.sqrt(1.0 - ab))
    ps, C = args.patch_size, args.out_ch
    model = None
    if qp is None:
        in_ch = (state["inc.kernel"].shape[2] - 1) // (args.s2d * args.s2d)  # x_t ‖ cond
        model = load_unet(state, C, args.base_ch, args.s2d, in_ch=in_ch, device=device)
    gen = torch.Generator(device=device) if device.type == "cuda" else None
    if device_noise is None:
        device_noise = args.fast_transfer
    if f16_out is None:
        f16_out = args.fast_transfer and args.stitch != "device"

    def tile_noise(seeds):
        """One (ps, ps, C) draw per tile seed: a card generator seeded with it,
        or on the CPU JAX's normal(PRNGKey(seed)) bits."""
        if gen is None:
            return torch.from_numpy(np.stack(
                [random.normal(random.PRNGKey(int(s)), (ps, ps, C)) for s in seeds]))
        return torch.stack([torch.randn((ps, ps, C), generator=gen.manual_seed(int(s)),
                                        dtype=torch.float32, device=device) for s in seeds])

    def predict_batch(cond_b, noise_b, rows=slice(None)):
        # the tag and the η draws are the whole batch's; a mesh rank then
        # samples its rows (parallel.shard_predict_batch)
        B = len(cond_b)
        if device_noise:
            tag = int(noise_b[0])
        else:
            tag = int(np.asarray(noise_b[0, 0, 0, 0], np.float32).view(np.int32))
        cond_b, noise_b = cond_b[rows], noise_b[rows]
        cond = upload(cond_b, device).float()
        noise = tile_noise(noise_b) if device_noise else upload(noise_b, device)
        if qp is not None:
            fn = (make_quant_cfg_denoise_fn(qp, cond, args.guidance_scale)
                  if args.guidance_scale is not None else make_quant_denoise_fn(qp, cond))
        elif args.guidance_scale is not None:
            fn = make_cfg_denoise_fn(model, cond, args.guidance_scale)
        else:
            fn = make_denoise_fn(model, cond)
        if args.solver == "dpm2m":
            x_init = noise if param is Parameterization.EPS else noise * vscale
            out = dpm_solver_2m(fn, x_init, schedule, grid, param)
        elif param is Parameterization.EPS:
            out = _ddim_linspace_scan(fn, noise.contiguous(), schedule, args.t_start,
                                      args.ddim_steps, (0.0, 1.0))
        else:
            # the η key varies per batch, deterministically: a tag from this
            # batch's noise or seed payload folded into PRNGKey(seed)
            out = ddim_grid_sample(fn, noise * vscale, schedule, grid, Parameterization.V,
                                   eta=args.eta,
                                   key=random.fold_in(random.PRNGKey(args.seed), tag),
                                   batch_rows=(rows, B))
        # f16 is a transfer format: predictions that stay on the device for
        # the device stitch keep f32
        return out.to(torch.float16) if f16_out else out

    return predict_batch


def run(args, scene, mask):
    """Load the checkpoint, build the predictor (int8 after calibration with
    ``--int8``) and infer the scene: → (H, W, out_ch) f32."""
    import torch

    from s1s2_torch.eval.scene import infer_scene
    from s1s2_torch.models.weights import params_from_numpy
    from s1s2_torch.train.checkpoint import load_params

    mesh = None
    if args.mesh_data:
        from s1s2_torch.parallel.mesh import (backend_for, initialize_distributed,
                                              require_world, shard_predict_batch)

        initialize_distributed(backend=backend_for(args.device))
        mesh = require_world(args.mesh_data)
    device = torch.device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    state = {k: v.to(device) for k, v in params_from_numpy(load_params(args.ckpt)).items()}
    qp = calibrate_on_scene(args, state, scene, mask, device) if args.int8 else None
    predict = make_predictor(args, state, device, qp)
    if mesh is not None:
        predict = shard_predict_batch(predict, mesh)
    fast = dict(noise="device", transfer_dtype=np.float16, pipeline=3) \
        if args.fast_transfer else {}
    with torch.no_grad():
        return infer_scene(predict, scene, args.out_ch, ps=args.patch_size, stride=args.stride,
                           batch_size=args.batch_size, mask_scene=mask,
                           normalize=args.normalize, rng_seed=args.seed, stitch=args.stitch,
                           **fast)


def main(argv=None):
    args = build_parser().parse_args(argv)
    from s1s2_torch.viz.render import save_rgb_triplet

    from s1s2_torch.parallel.mesh import is_writer

    scene, mask = read_scene(args)
    out = run(args, scene, mask)
    if is_writer():
        os.makedirs(args.out_dir, exist_ok=True)
        np.save(os.path.join(args.out_dir, "scene_pred.npy"), np.transpose(out, (2, 0, 1)))
        if args.out_ch >= 4:
            save_rgb_triplet(out, os.path.join(args.out_dir, "scene_true.png"),
                             os.path.join(args.out_dir, "scene_cir.png"))
    res = {"out": args.out_dir, "shape": list(out.shape), "tiles": "feather-stitched"}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
