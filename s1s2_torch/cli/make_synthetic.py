"""Write synthetic patch npz files shaped like the real data (for tests
and demos without rasters):

    python -m s1s2_torch make_synthetic --out P --n 32 --size 256 --seed 0

The port of the JAX package's ``cli/make_synthetic.py`` on the port's
``data/synthetic.py``: the same flags and defaults, the same files byte for
byte. The distillation recipes' evidence set is ``--n 32 --size 256 --seed
0``; the width students' held-out set is the same with ``--seed 1``.
"""

import argparse

from s1s2_torch.data.synthetic import make_synthetic_patches


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("s1s2_torch make_synthetic")
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--c_cond", type=int, default=4,
                    help="number of conditioning (S1-like) bands")
    ap.add_argument("--rich", action="store_true",
                    help="dataset-level learnable cond→target map "
                         "(one mixing matrix + nonlinear features) instead "
                         "of per-patch random mixing; see "
                         "s1s2_torch.data.synthetic")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    files = make_synthetic_patches(args.out, n=args.n, size=args.size, seed=args.seed,
                                   rich=args.rich, c_cond=args.c_cond)
    print(f"wrote {len(files)} patches to {args.out}")


if __name__ == "__main__":
    main()
