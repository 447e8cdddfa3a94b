"""Patch-extraction CLI: the port of the JAX package's ``cli/patchify.py``,
with the flags of the reference ``Patch.py``.

    python -m s1s2_torch patchify --base-dir RAW --output-dir PATCHES

Host numpy (``data/patchify.py``); prints the manifest without its patch
list as one JSON line and returns the manifest.
"""

import argparse
import json


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("s1s2_torch patchify")
    ap.add_argument("--base-dir", required=True)
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--patch-size", type=int, default=256)
    ap.add_argument("--stride", type=int, default=32)
    ap.add_argument("--max-patches", type=int, default=10000)
    ap.add_argument("--per-folder-share", action="store_true")
    ap.add_argument("--valid-ratio-threshold", type=float, default=0.80)
    ap.add_argument("--variance-threshold", type=float, default=1e-4)
    ap.add_argument("--dark-thr", type=float, default=0.10)
    ap.add_argument("--dark-max-ratio", type=float, default=0.60)
    ap.add_argument("--texture-thr", type=float, default=5e-5)
    ap.add_argument("--exact-filters", action="store_true",
                    help="per-window Laplacian boundary parity (slower)")
    ap.add_argument("--no-previews", action="store_true")
    args = ap.parse_args(argv)

    from s1s2_torch.data.patchify import PatchifyConfig, run_patchify

    out = run_patchify(PatchifyConfig(
        base_dir=args.base_dir,
        output_dir=args.output_dir,
        patch_size=args.patch_size,
        stride=args.stride,
        max_patches=args.max_patches,
        per_folder_share=args.per_folder_share,
        valid_ratio_threshold=args.valid_ratio_threshold,
        variance_threshold=args.variance_threshold,
        dark_thr=args.dark_thr,
        dark_max_ratio=args.dark_max_ratio,
        texture_thr=args.texture_thr,
        exact_filters=args.exact_filters,
        write_previews=not args.no_previews,
    ))
    print(json.dumps({k: v for k, v in out.items() if k != "patches"}))
    return out


if __name__ == "__main__":
    main()
