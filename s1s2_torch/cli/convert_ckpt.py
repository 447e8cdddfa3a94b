"""Convert a reference PyTorch ``.pth`` checkpoint to a ``.msgpack`` params
file (and report the inferred architecture): the port of the JAX package's
``cli/convert_ckpt.py``.

    python -m s1s2_torch convert_ckpt --pth ref.pth --out ref.msgpack

The ``.pth`` is read with ``models/convert.py`` and written by the port's
msgpack writer (``train/checkpoint.save_model``): the bytes the JAX CLI
writes for the same file. Prints ``{"out", "in_ch", "out_ch", "base_ch"}``
as one JSON line.
"""

import argparse
import json


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("s1s2_torch convert_ckpt")
    ap.add_argument("--pth", required=True)
    ap.add_argument("--out", required=True, help="output .msgpack path")
    args = ap.parse_args(argv)

    from s1s2_torch.models.convert import (infer_arch_from_state_dict, load_pth_state_dict,
                                           torch_state_dict_to_params)
    from s1s2_torch.train.checkpoint import save_model

    sd = load_pth_state_dict(args.pth)
    arch = infer_arch_from_state_dict(sd)
    save_model(torch_state_dict_to_params(sd)["params"], args.out)
    out = {"out": args.out, **arch}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
