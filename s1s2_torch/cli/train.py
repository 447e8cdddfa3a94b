"""Training CLI, one entry point for both of the reference's trainers
(``--pred_param`` / ``--preset``):

    python -m s1s2_torch train --patch_dir P --model_path out/model.msgpack \\
        --pred_param v --epochs 40 [--device cpu]

The port of the JAX package's ``cli/train.py``: every flag and default of
its parser, plus ``--device`` (the card by default). The multi-process
flags (``--coordinator``, ``--num_processes``, ``--process_id``) and the
mesh flags (``--spatial_shard``, ``--model_shard`` > 1) raise: ROADMAP §1
item 7 (7c) ports them. One JSON line is printed per progress record.
"""

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("s1s2_torch train")
    ap.add_argument("--patch_dir", type=str, required=True)
    ap.add_argument("--model_path", type=str, required=True,
                    help=".msgpack; _last/_best siblings are derived")
    ap.add_argument("--T", type=int, default=1000)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--lr", type=float, default=None,
                    help="default 1e-4 (v) / 1e-5 (eps preset)")
    ap.add_argument("--base_ch", type=int, default=96)
    ap.add_argument("--grad_clip", type=float, default=0.5)
    ap.add_argument("--max_patches", type=int, default=None)
    ap.add_argument("--weight_decay", type=float, default=1e-4)
    ap.add_argument("--ema_decay", type=float, default=0.999)
    ap.add_argument("--seed", type=int, default=1337)
    ap.add_argument("--band_weights", nargs="*", type=float, default=None)
    ap.add_argument("--mask_as_weights", action="store_true")
    ap.add_argument("--pred_param", choices=["eps", "v"], default="v")
    ap.add_argument("--t_sampler", choices=["uniform", "high_only", "mix_high"],
                    default="mix_high")
    ap.add_argument("--high_t_frac", type=float, default=0.5)
    ap.add_argument("--high_t_min_ratio", type=float, default=0.6)
    ap.add_argument("--p2_gamma", type=float, default=1.0)
    ap.add_argument("--p2_k", type=float, default=1e-3)
    ap.add_argument("--aux_x0_loss_w", type=float, default=0.02)
    ap.add_argument("--preset", choices=["v", "eps_reference"], default="v",
                    help="eps_reference = the reference eps-trainer's behavior")
    ap.add_argument("--cfg_drop_prob", type=float, default=0.0,
                    help="cond dropout for CFG training (cfg_v family)")
    ap.add_argument("--lr_schedule", choices=["constant", "warmup_cosine"],
                    default="constant")
    ap.add_argument("--warmup_steps", type=int, default=100)
    ap.add_argument("--total_steps", type=int, default=10_000,
                    help="decay horizon for warmup_cosine")
    ap.add_argument("--schedule", choices=["cosine", "linear"], default="cosine")
    ap.add_argument("--compute_dtype", choices=["bfloat16", "float32"],
                    default="bfloat16")
    ap.add_argument("--save_state_dir", type=str, default=None,
                    help="directory of the resumable state file")
    ap.add_argument("--save_every", type=int, default=1,
                    help="checkpoint cadence in epochs (model_last/best + resume state; "
                         "the final epoch always saves)")
    ap.add_argument("--resume", action="store_true",
                    help="restore params+opt+EMA+step from --save_state_dir")
    ap.add_argument("--profile_dir", type=str, default=None,
                    help="write a torch.profiler trace of epoch 1")
    ap.add_argument("--metrics_jsonl", type=str, default=None,
                    help="append per-epoch metrics to this JSONL file")
    ap.add_argument("--remat", action="store_true",
                    help="recompute UNet blocks in the backward (less memory, more FLOPs)")
    ap.add_argument("--cache_dir", type=str, default=None,
                    help="decompress the npz dataset ONCE into mmap'd .npy files here")
    ap.add_argument("--spatial_shard", action="store_true",
                    help="not ported (ROADMAP §1 item 7)")
    ap.add_argument("--model_shard", type=int, default=1,
                    help="values above 1 are not ported (ROADMAP §1 item 7)")
    ap.add_argument("--log_every", type=int, default=50)
    ap.add_argument("--coordinator", type=str, default=None,
                    help="multi-process training: not ported (ROADMAP §1 item 7)")
    ap.add_argument("--num_processes", type=int, default=None)
    ap.add_argument("--process_id", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the step runs: cuda (default) or cpu")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if any(v is not None for v in (args.coordinator, args.num_processes, args.process_id)):
        raise NotImplementedError("multi-process training (--coordinator, --num_processes, "
                                  "--process_id) is not ported yet (ROADMAP §1 item 7, 7c)")
    from s1s2_torch.train.loop import TrainConfig
    from s1s2_torch.train.trainer import RunConfig, train_loop

    common = dict(
        T=args.T,
        weight_decay=args.weight_decay,
        grad_clip=args.grad_clip,
        ema_decay=args.ema_decay,
        mask_as_weights=args.mask_as_weights,
        band_weights=tuple(args.band_weights) if args.band_weights else None,
        cfg_drop_prob=args.cfg_drop_prob,
        lr_schedule=args.lr_schedule,
        warmup_steps=args.warmup_steps,
        total_steps=args.total_steps,
    )
    if args.preset == "eps_reference":
        cfg = TrainConfig.eps_reference(
            **common, **({"lr": args.lr} if args.lr is not None else {}))
    else:
        cfg = TrainConfig(
            lr=args.lr if args.lr is not None else 1e-4,
            pred_param=args.pred_param,
            t_sampler=args.t_sampler,
            high_t_frac=args.high_t_frac,
            high_t_min_ratio=args.high_t_min_ratio,
            p2_gamma=args.p2_gamma,
            p2_k=args.p2_k,
            aux_x0_loss_w=args.aux_x0_loss_w,
            **common,
        )
    run = RunConfig(
        patch_dir=args.patch_dir,
        model_path=args.model_path,
        epochs=args.epochs,
        batch_size=args.batch_size,
        base_ch=args.base_ch,
        max_patches=args.max_patches,
        seed=args.seed,
        schedule=args.schedule,
        log_every=args.log_every,
        save_state_dir=args.save_state_dir,
        save_every=args.save_every,
        resume=args.resume,
        spatial_shard=args.spatial_shard,
        model_shard=args.model_shard,
        compute_dtype=args.compute_dtype,
        profile_dir=args.profile_dir,
        metrics_jsonl=args.metrics_jsonl,
        remat=args.remat,
        cache_dir=args.cache_dir,
        device=args.device,
    )

    def progress(d):
        # one write a record, so nothing can splice between text and newline
        sys.stdout.write(json.dumps(d) + "\n")
        sys.stdout.flush()

    hist = train_loop(run, cfg, progress=progress)
    progress({"best_loss": hist["best_loss"], "epoch_loss": hist["epoch_loss"],
              "skipped": hist["skipped"]})


if __name__ == "__main__":
    main()
