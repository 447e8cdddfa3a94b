"""Synthetic patch fixtures (a numpy-only copy of the JAX package's
``data/synthetic.py``, kept here so the port imports nothing of it; the same
seed writes the same bytes).

Generates npz files with the exact Patch.py output contract
(`Patch.py:253-255`) — smooth correlated fields standing in for SAR/optical
patches — so training/eval/tests run end-to-end without rasters
(SURVEY.md §7 build order step 3).
"""

from __future__ import annotations

import json
import os

import numpy as np


def _smooth_field(rng: np.random.Generator, H: int, W: int, octaves: int = 3):
    """Cheap multi-octave value noise via upsampled random grids."""
    acc = np.zeros((H, W), np.float32)
    for o in range(octaves):
        h = max(2, H >> (octaves - o + 1))
        w = max(2, W >> (octaves - o + 1))
        g = rng.standard_normal((h, w)).astype(np.float32)
        ys = np.linspace(0, h - 1, H)
        xs = np.linspace(0, w - 1, W)
        yi, xi = np.floor(ys).astype(int), np.floor(xs).astype(int)
        yf, xf = (ys - yi)[:, None], (xs - xi)[None, :]
        yi1 = np.minimum(yi + 1, h - 1)
        xi1 = np.minimum(xi + 1, w - 1)
        up = (
            g[np.ix_(yi, xi)] * (1 - yf) * (1 - xf)
            + g[np.ix_(yi1, xi)] * yf * (1 - xf)
            + g[np.ix_(yi, xi1)] * (1 - yf) * xf
            + g[np.ix_(yi1, xi1)] * yf * xf
        )
        acc += up * (0.5**o)
    return acc


def make_synthetic_patches(
    out_dir: str,
    n: int = 8,
    size: int = 64,
    c_cond: int = 4,
    c_tgt: int = 4,
    seed: int = 0,
    mask_holes: bool = True,
    with_cloud: bool = False,
    rich: bool = False,
    compress: bool = True,
) -> list:
    """Write ``n`` synthetic patch npz files; target bands are deterministic
    functions of the cond bands (so models CAN learn the mapping).

    ``rich=True`` makes the cond→target map LEARNABLE ACROSS PATCHES: the
    default draws a fresh random mixing matrix per patch (each patch has a
    different cond→target relation, so the dataset-level mapping is
    irreducibly ambiguous — pure generation can't benefit from model
    quality), while rich uses one dataset-level mixing with per-channel
    nonlinearities (tanh/sin/|·| compositions) plus a small
    cond-independent detail field. Models trained on a rich set can drive
    pure-generation MAE down with capacity/steps — the regime the
    reference's published true-infer table lives in
    (`Evaluation_Updated/Evaluation_Pure_Generation/ddim_true_infer_summary.txt`).
    """
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    fixed_mix = (rng.standard_normal((c_tgt, c_cond)).astype(np.float32) * 0.4
                 if rich else None)
    files = []
    for i in range(n):
        base = [_smooth_field(rng, size, size) for _ in range(c_cond)]
        cond = np.stack(base).astype(np.float32)  # ~N(0,1)-ish like z-scored SAR
        if rich:
            # dataset-level deterministic map: nonlinear per-channel
            # features mixed by ONE matrix, + low-amplitude unpredictable
            # detail (posterior-mean floor, like real optical texture)
            feat_list = [
                np.tanh(cond[0]) + 0.3 * np.sin(3.0 * cond[1 % c_cond]),
                np.tanh(cond[1 % c_cond] * cond[2 % c_cond]),
                np.abs(np.tanh(cond[2 % c_cond])) - 0.5,
                np.tanh(0.5 * cond[3 % c_cond] + 0.25 * cond[0] ** 2),
            ]
            # c_cond > 4: extend with deterministic harmonics (keeps the
            # first four exprs — and thus all committed seeds — unchanged)
            for j in range(4, c_cond):
                feat_list.append(
                    np.tanh(cond[j % c_cond])
                    * np.cos((j + 1) * cond[(j + 1) % c_cond]))
            feats = np.stack(feat_list[:c_cond]).astype(np.float32)
            tgt = np.tensordot(fixed_mix, feats, axes=1)
            detail = _smooth_field(rng, size, size, octaves=5)
            tgt = tgt + 0.05 * detail[None, :, :]
        else:
            mix = rng.standard_normal((c_tgt, c_cond)).astype(np.float32) * 0.4
            tgt = np.tensordot(mix, np.tanh(cond), axes=1)
        tgt = np.clip(0.5 + 0.4 * tgt, 0.0, 1.0).astype(np.float32)
        mask = np.ones((size, size), np.uint8)
        if mask_holes and i % 2 == 0:
            r0, c0 = rng.integers(0, size // 2, 2)
            mask[r0 : r0 + size // 4, c0 : c0 + size // 4] = 0
        extra = {}
        if with_cloud:
            # increasing cloud fraction with file index (cloudy_viz ranking,
            # `Evaluation/Comparison_Original.py:271-278` key contract)
            cloud = (_smooth_field(rng, size, size) > (1.0 - i / max(n - 1, 1))
                     ).astype(np.float32)
            extra["cloud_mask"] = cloud
        path = os.path.join(out_dir, f"patch_{i:06d}.npz")
        # compress=False: identical VALUES, ~3x faster writes on the 1-core
        # host -- bench.py's in-process evidence regeneration uses it
        (np.savez_compressed if compress else np.savez)(
            path,
            inputs=cond,
            target=tgt,
            mask=mask,
            **extra,
            folder="synthetic",
            row=0,
            col=0,
            patch_size=size,
            stride=size,
            valid_ratio=float(mask.mean()),
        )
        files.append(path)
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump({"total_patches": n, "synthetic": True}, f)
    return files
