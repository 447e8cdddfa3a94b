"""Cast a params msgpack to bf16 and save it (half the size, for archiving):
the port of the JAX package's ``tools/archive_ckpt.py``.

    python -m s1s2_torch.tools.archive_ckpt in.msgpack out.msgpack

Every floating array leaf becomes bfloat16; other leaves are kept. Read with
the port's msgpack reader and written with its writer, the output is the
JAX tool's bytes for the same params file. The models cast their params to
the compute dtype (bf16) inside the forward anyway, so a bf16-stored
checkpoint evaluates as the original does up to that cast.
"""

from __future__ import annotations

import argparse
import os

import torch


def cast_bf16(tree):
    """The tree with each floating tensor leaf cast to bfloat16."""
    if isinstance(tree, dict):
        return {k: cast_bf16(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(torch.bfloat16)
    return tree


def main(argv=None) -> None:
    ap = argparse.ArgumentParser("s1s2_torch.tools.archive_ckpt")
    ap.add_argument("src")
    ap.add_argument("dst")
    args = ap.parse_args(argv)

    from s1s2_torch.train.checkpoint import _write, msgpack_restore, msgpack_serialize

    with open(args.src, "rb") as f:
        tree = msgpack_restore(f.read())
    _write(args.dst, msgpack_serialize(cast_bf16(tree)))
    print(f"{args.src} ({os.path.getsize(args.src) >> 20} MiB) -> "
          f"{args.dst} ({os.path.getsize(args.dst) >> 20} MiB)")


if __name__ == "__main__":
    main()
