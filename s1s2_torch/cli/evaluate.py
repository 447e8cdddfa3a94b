"""Evaluation CLI: the port of the JAX package's ``cli/evaluate.py``, with
the same flags and defaults (and ``--device``); ``--mode`` takes the modes
the port's harness has (``eval/harness.py:MODES``).

    python -m s1s2_torch.cli.evaluate --mode cfg_sweep --patch_dir P \
        --ckpt examples/checkpoints/cfg_v_teacher.bf16.msgpack --pred_param v \
        --t_start 999 --ddim_steps 5 --guidance_scales 3 --save_viz_n 0 --out_dir out

Prints the mode's result as one JSON line and returns it.
"""

import argparse
import json

from s1s2_torch.eval.harness import MODES


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("s1s2_torch evaluate")
    ap.add_argument("--mode", required=True, choices=sorted(MODES.keys()))
    ap.add_argument("--patch_dir", required=True)
    ap.add_argument("--ckpt", default=None,
                    help=".pth (reference) | .msgpack (s1s2) | @random (smoke)")
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--T", type=int, default=1000)
    ap.add_argument("--time_schedule", choices=["cosine", "linear"], default="cosine")
    ap.add_argument("--base_ch", type=int, default=96)
    ap.add_argument("--s2d", type=int, default=1,
                    help="space-to-depth stem factor of the checkpoint "
                         "(UNetSmall.stem_s2d; distill --student_s2d)")
    ap.add_argument("--pred_param", choices=["eps", "v"], default="eps")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--max_files", type=int, default=0, help="0 = ALL files")
    ap.add_argument("--save_viz_n", type=int, default=6)
    # ddim (default 200 like the reference; limitation mode defaults to the
    # full range — pass an explicit value to clamp, or -1 for full range)
    ap.add_argument("--t_start", type=int, default=None)
    ap.add_argument("--ddim_steps", type=int, default=20)
    ap.add_argument("--eta", type=float, default=0.0)
    ap.add_argument("--solver", choices=["ddim", "dpm2m"], default="ddim",
                    help="dpm2m = 2nd-order multistep (s1s2 extension; "
                         "fewer steps for equal quality)")
    # sweep
    ap.add_argument("--t_start_grid", type=str, default="")
    ap.add_argument("--ddim_steps_grid", type=str, default="")
    # small-t diagnostics
    ap.add_argument("--t_small", type=int, default=20)
    ap.add_argument("--t_values", type=int, nargs="*", default=[5, 10, 20, 40, 80, 160])
    ap.add_argument("--n_seeds", type=int, default=8)
    ap.add_argument("--seed_base", type=int, default=1234)
    # limitation
    ap.add_argument("--limitation_sampler", choices=["ddpm", "ddim"], default="ddim")
    ap.add_argument("--partial_reverse_k", nargs="*", type=int, default=None)
    ap.add_argument("--band_weights", nargs="*", type=float, default=None)
    ap.add_argument("--save_n", type=int, default=16)
    # CFG
    ap.add_argument("--guidance_scale", type=float, default=None)
    ap.add_argument("--guidance_scales", nargs="*", type=float, default=None,
                    help="grid for --mode cfg_sweep")
    # viz
    ap.add_argument("--select_top_cloud", type=int, default=12)
    ap.add_argument("--zoom", type=int, default=0)
    ap.add_argument("--zoom_k", type=int, default=0)
    ap.add_argument("--full_metrics", action="store_true",
                    help="add PSNR/SAM/ERGAS columns (Comparison_Original style)")
    ap.add_argument("--file_list", type=str, default=None,
                    help="txt with npz filenames (one per line) forcing exact order")
    ap.add_argument("--viz_mode", choices=["percentile", "dataset_fixed"],
                    default="percentile")
    ap.add_argument("--viz_q_low", type=float, default=1.0)
    ap.add_argument("--viz_q_high", type=float, default=99.0)
    ap.add_argument("--compute_dtype", choices=["bfloat16", "float32"],
                    default="bfloat16")
    ap.add_argument("--int8", action="store_true",
                    help="quantized int8 inference (double-conv blocks on the "
                         "int8 conv kernel)")
    ap.add_argument("--int8_ckpt", type=str, default=None,
                    help="pre-quantized artifact from `s1s2_torch.cli.quantize` — "
                         "serve int8 without recalibration (implies --int8)")
    ap.add_argument("--int8_calib", choices=["qsample", "rollout"],
                    default="qsample",
                    help="activation-scale source: qsample = forward-"
                         "diffused GT (default); rollout = per-guidance "
                         "bf16-trajectory calibration (cfg_sweep; fixes "
                         "the int8+CFG clipping degradation)")
    ap.add_argument("--int8_perchannel", action="store_true",
                    help="per-input-channel activation scales folded into "
                         "the int8 weights (finer resolution; reduces "
                         "per-branch quant noise under CFG)")
    ap.add_argument("--int8_bf16_blocks", nargs="*", default=[],
                    help="double-conv blocks to keep bf16 inside the int8 "
                         "net (e.g. conv1 = the output-adjacent decoder "
                         "block; trades speed for CFG fidelity)")
    ap.add_argument("--mesh_data", type=int, default=0,
                    help="shard eval batches over N devices' 'data' axis "
                         "(0 = single device); batch_size must divide by N")
    ap.add_argument("--cache_dir", type=str, default=None,
                    help="decompress the npz dataset once into mmap'd .npy "
                         "files here (multi-pass modes re-read data per "
                         "seed/config; zlib dominates the host otherwise)")
    ap.add_argument("--noise_npz", type=str, default=None,
                    help="inject explicit per-file noise from this .npz "
                         "(keys s{salt}_i{index}, NHWC) instead of fold_in "
                         "draws")
    ap.add_argument("--rng_by", choices=["index", "name"], default="index",
                    help="per-file RNG identity. index = dataset index "
                         "(default; what every committed evidence artifact "
                         "was produced under) — PROTOCOL-SENSITIVE: the "
                         "same file evaluated inside the full dataset vs "
                         "inside any subset (--file_list / copied subdir) "
                         "draws different noise, shifting absolute MAEs "
                         "~0.006. name = crc32 of the npz basename: "
                         "numbers become invariant to the selection "
                         "protocol. Prefer name for new result sets; never "
                         "mix keyings in one comparison")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: cuda (default) or cpu")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    from s1s2_torch.eval.harness import EvalConfig, run_mode
    from s1s2_torch.models.unet import BLOCKS

    if args.t_start is None:
        args.t_start = -1 if args.mode == "limitation" else 200

    # fail loud on int8 knobs that would be silently ignored
    if args.int8_bf16_blocks:
        bad = [b for b in args.int8_bf16_blocks if b not in BLOCKS]
        if bad:
            ap.error(f"--int8_bf16_blocks: unknown block(s) {bad}; "
                     f"valid double-conv blocks are {list(BLOCKS)}")
    if args.int8_calib == "rollout" and args.mode != "cfg_sweep":
        ap.error("--int8_calib rollout is only implemented for --mode cfg_sweep")

    cfg = EvalConfig(
        patch_dir=args.patch_dir,
        out_dir=args.out_dir,
        ckpt=args.ckpt,
        mode=args.mode,
        T=args.T,
        schedule=args.time_schedule,
        base_ch=args.base_ch,
        stem_s2d=args.s2d,
        pred_param=args.pred_param,
        batch_size=args.batch_size,
        max_files=args.max_files,
        save_viz_n=args.save_viz_n,
        t_start=args.t_start,
        ddim_steps=args.ddim_steps,
        eta=args.eta,
        solver=args.solver,
        t_start_grid=tuple(int(x) for x in args.t_start_grid.split(",") if x),
        ddim_steps_grid=tuple(int(x) for x in args.ddim_steps_grid.split(",") if x),
        t_small=args.t_small,
        t_values=tuple(args.t_values),
        n_seeds=args.n_seeds,
        seed_base=args.seed_base,
        limitation_sampler=args.limitation_sampler,
        partial_reverse_k=tuple(args.partial_reverse_k or ()),
        band_weights=tuple(args.band_weights) if args.band_weights else None,
        save_n=args.save_n,
        guidance_scale=args.guidance_scale,
        guidance_scales=tuple(args.guidance_scales or ()),
        select_top_cloud=args.select_top_cloud,
        zoom=args.zoom,
        zoom_k=args.zoom_k,
        full_metrics=args.full_metrics,
        compute_dtype=args.compute_dtype,
        int8=args.int8 or args.int8_ckpt is not None,
        int8_ckpt=args.int8_ckpt,
        int8_calib=args.int8_calib,
        int8_perchannel=args.int8_perchannel,
        int8_bf16_blocks=tuple(args.int8_bf16_blocks),
        cache_dir=args.cache_dir,
        mesh_data=args.mesh_data,
        noise_npz=args.noise_npz,
        rng_by=args.rng_by,
        file_list=args.file_list,
        viz_mode=args.viz_mode,
        viz_q_low=args.viz_q_low,
        viz_q_high=args.viz_q_high,
        device=args.device,
    )
    result = run_mode(cfg)
    print(json.dumps({str(k): v for k, v in result.items()}, default=float), flush=True)
    return result


if __name__ == "__main__":
    main()
