"""Certify reference checkpoints against the port's model: the port of the
JAX package's ``cli/validate_parity.py``, with its flags, plus ``--device``
and ``--compute_dtype``.

Forward parity (per checkpoint; ``models/torch_twin.validate_pth_parity``):
    python -m s1s2_torch validate_parity --pth ddpm_s1_to_s2_v3.pth

Table parity (``eval/parity.run_full_parity``):
    python -m s1s2_torch validate_parity --full --patch_dir P --out_dir O \\
        --eps_ckpt ddpm_s1_to_s2_v3.pth [--v_ckpt ...] [--rel_tol 0.02]

Runs on the card by default (``--device cpu`` for the CPU). The nets run
in bf16 on the card (the conv kernel's dtype) and in f32 on the CPU unless
``--compute_dtype`` says otherwise; the forward report names the pass rule
it applied (f32: ``max_abs < 1e-3``; bf16: the port's f32 forward on the
CPU within ``max_abs < 1e-3`` of the twin, the converter's check, and on the
card ``rel <= 2 x cpu_bf16_rel``, the CPU plain path's bf16 ``rel`` beside
it; see ``models/torch_twin.py``).
"""

import argparse
import json


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("s1s2_torch validate_parity")
    ap.add_argument("--pth", help="forward-parity mode: one .pth to certify")
    ap.add_argument("--image_size", type=int, default=64)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    # --full table mode
    ap.add_argument("--full", action="store_true",
                    help="rerun every BASELINE.md table and diff")
    ap.add_argument("--patch_dir")
    ap.add_argument("--out_dir")
    ap.add_argument("--eps_ckpt", help="ddpm_s1_to_s2_v3 family (.pth/.msgpack)")
    ap.add_argument("--v_ckpt", help="ddpm_s1_to_s2_upgraded_v family")
    ap.add_argument("--cfg_ckpt", help="ddpm_s1_to_s2_cfg_v family")
    ap.add_argument("--rel_tol", type=float, default=0.02)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--T", type=int, default=1000)
    ap.add_argument("--base_ch", type=int, default=96)
    ap.add_argument("--expected", default=None,
                    help="JSON file overriding/extending the expected tables")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--compute_dtype", choices=("bfloat16", "float32"), default=None,
                    help="the port's compute dtype (default: bfloat16 on the card, float32 "
                         "on the CPU; the card's conv kernel takes bfloat16 only)")
    return ap


def main(argv=None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    from s1s2_torch.train.trainer import resolve_device

    device = str(resolve_device(args.device, "validate_parity"))
    if args.full:
        if not (args.patch_dir and args.out_dir):
            ap.error("--full needs --patch_dir/--out_dir")
        from s1s2_torch.eval.parity import run_full_parity

        expected = None
        if args.expected:
            with open(args.expected) as f:
                expected = json.load(f)
        ckpts = {k: v for k, v in (("eps", args.eps_ckpt), ("v", args.v_ckpt),
                                   ("cfg_v", args.cfg_ckpt)) if v}
        report = run_full_parity(
            args.patch_dir, args.out_dir, ckpts, expected=expected,
            rel_tol=args.rel_tol, batch_size=args.batch_size, T=args.T,
            base_ch=args.base_ch, device=device, compute_dtype=args.compute_dtype,
        )
        print(json.dumps({k: report[k] for k in
                          ("tables_ran", "tables_skipped_no_ckpt",
                           "n_pass", "n_fail", "all_pass")}))
        return report

    if not args.pth:
        ap.error("--pth required (or use --full)")
    from s1s2_torch.models.torch_twin import validate_pth_parity

    report = validate_pth_parity(args.pth, args.image_size, args.batch, args.seed,
                                 device=device, compute_dtype=args.compute_dtype)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
