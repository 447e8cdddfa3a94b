"""Offline post-training quantization: write a deployable int8 artifact.

    python -m s1s2_torch.cli.quantize --ckpt model.msgpack --patch_dir P \\
        --out model.int8.msgpack [--t_start 200] [--device cuda]

The port of the JAX package's ``cli/quantize.py``: calibrates activation
scales on the first ``--n_calib`` patches of ``--patch_dir`` q-sampled at a
spread of timesteps (noise ``PRNGKey(--seed)`` split per t, with a
zeroed-cond twin for guidance), quantizes the double-conv weights per
output channel and writes the ``save_quant`` blob, which
``evaluate --int8_ckpt`` (of either package) serves without recalibrating.
"""

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser("s1s2_torch quantize")
    ap.add_argument("--ckpt", required=True, help=".msgpack checkpoint")
    ap.add_argument("--patch_dir", required=True, help="calibration patches")
    ap.add_argument("--out", required=True, help="output .int8.msgpack")
    ap.add_argument("--T", type=int, default=1000)
    ap.add_argument("--base_ch", type=int, default=96)
    ap.add_argument("--s2d", type=int, default=1,
                    help="checkpoint's UNetSmall.stem_s2d factor (stored in the artifact)")
    ap.add_argument("--t_start", type=int, default=200,
                    help="top of the calibration timestep spread")
    ap.add_argument("--n_calib", type=int, default=8)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--device", default="cuda", help="where calibration runs: cuda or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from s1s2_torch.core import random
    from s1s2_torch.core.schedule import Schedule
    from s1s2_torch.data.dataset import NpzPatchDataset
    from s1s2_torch.models.quant import make_sampler_calib, quantize_unet, save_quant
    from s1s2_torch.models.weights import params_from_numpy
    from s1s2_torch.train.checkpoint import load_params

    if args.ckpt.endswith(".pth"):
        raise NotImplementedError("the .pth reader is not ported yet (ROADMAP §1 item 4)")
    dev = torch.device(args.device)
    ds = NpzPatchDataset(args.patch_dir)
    _, Ct, _, _ = ds.probe_channels()
    state = {k: v.to(dev) for k, v in params_from_numpy(load_params(args.ckpt)).items()}
    n = min(len(ds), args.n_calib)
    items = [ds[i] for i in range(n)]
    cond = torch.from_numpy(np.stack([d["cond"] for d in items])).to(dev)
    gt = torch.from_numpy(np.stack([d["target"] for d in items])).to(dev)
    t_hi = min(max(args.t_start, 1), args.T - 1)
    calib = make_sampler_calib(gt, cond, Schedule.cosine(args.T).alpha_bar_np(),
                               sorted({t_hi, max(t_hi // 2, 1), min(5, t_hi)}),
                               key=random.PRNGKey(args.seed), n=n, null_cond=True)
    qp = quantize_unet(state, calib, out_ch=Ct, base_ch=args.base_ch, stem_s2d=args.s2d)
    save_quant(qp, args.out)
    out = {"out": args.out, "conv_scales": len(qp.act_scale), "calib_files": n}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
