"""PNG previews: the numpy half of the JAX package's ``viz/render.py``.

Percentile stretches, true-colour (B4, B3, B2) and CIR (B8, B4, B3)
composites, per-image and dataset-fixed ranges, the SAR preview and the
side-by-side strips, and the files the harness writes from them
(:func:`save_rgb_triplet`, :func:`save_pred_gt`). Inputs are channels-last
numpy (H, W, C) with the bands [B2, B3, B4, B8].

PIL is not among the card's packages, so :func:`write_png` encodes the RGB8
PNGs itself (``zlib`` and ``struct``); a decoder reads the same pixels
PIL's own writer would have stored. The comparison panels (``save_panel``:
bilinear resizes and drawn titles) are not ported (ROADMAP §1 item 7).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Iterable

import numpy as np


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray) -> None:
    """An (H, W, 3) uint8 array as an 8-bit RGB PNG: no interlace, every row
    with filter 0 (none), one zlib stream."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {rgb.shape} {rgb.dtype}")
    H, W, _ = rgb.shape
    rows = np.concatenate([np.zeros((H, 1), np.uint8), rgb.reshape(H, 3 * W)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))


def percentile_stretch_uint8(a: np.ndarray, p_lo: float = 2, p_hi: float = 98) -> np.ndarray:
    """2–98 percentile stretch → uint8."""
    a = np.nan_to_num(np.asarray(a, np.float32), nan=0.0, posinf=0.0, neginf=0.0)
    lo, hi = np.percentile(a, [p_lo, p_hi])
    if hi - lo < 1e-6:
        hi = lo + 1.0
    return (np.clip((a - lo) / (hi - lo), 0, 1) * 255).astype(np.uint8)


def make_rgb(b1, b2, b3) -> np.ndarray:
    return np.dstack([percentile_stretch_uint8(b) for b in (b1, b2, b3)])


def true_color(t4_hwc: np.ndarray) -> np.ndarray:
    """True colour = (B4, B3, B2)."""
    return make_rgb(t4_hwc[..., 2], t4_hwc[..., 1], t4_hwc[..., 0])


def cir_color(t4_hwc: np.ndarray) -> np.ndarray:
    """CIR = (B8, B4, B3)."""
    return make_rgb(t4_hwc[..., 3], t4_hwc[..., 2], t4_hwc[..., 1])


def save_rgb_triplet(t4_hwc: np.ndarray, path_true: str, path_cir: str) -> None:
    write_png(path_true, true_color(t4_hwc))
    write_png(path_cir, cir_color(t4_hwc))


# -- fixed-range rendering -----------------------------------------------------


def stretch_fixed(x_hwc: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Per-band fixed [lo, hi] → uint8 (H, W, C)."""
    y = (x_hwc - lo[None, None, :]) / (hi - lo + 1e-8)[None, None, :]
    return (np.clip(y, 0, 1) * 255).astype(np.uint8)


def per_image_lo_hi(gt_hwc: np.ndarray, q_low=2.0, q_high=98.0):
    """GT-derived per-band ranges."""
    C = gt_hwc.shape[-1]
    lo = np.array([np.percentile(gt_hwc[..., c], q_low) for c in range(C)], np.float32)
    hi = np.array([np.percentile(gt_hwc[..., c], q_high) for c in range(C)], np.float32)
    hi = np.where(hi - lo < 1e-6, lo + 1.0, hi)
    return lo, hi


def dataset_fixed_lo_hi(gts: Iterable[np.ndarray], q_low=1.0, q_high=99.0):
    """Dataset-wide per-band min / max of the per-image percentiles."""
    lo = hi = None
    for g in gts:
        l, h = per_image_lo_hi(g, q_low, q_high)
        lo = l if lo is None else np.minimum(lo, l)
        hi = h if hi is None else np.maximum(hi, h)
    hi = np.where(hi - lo < 1e-6, lo + 1.0, hi)
    return lo.astype(np.float32), hi.astype(np.float32)


def fixed_true_cir(t4_hwc: np.ndarray, lo, hi):
    u8 = stretch_fixed(t4_hwc, lo, hi)
    return (np.dstack([u8[..., 2], u8[..., 1], u8[..., 0]]),
            np.dstack([u8[..., 3], u8[..., 2], u8[..., 1]]))


# -- composite views -----------------------------------------------------------


def s1_preview(cond_hwc: np.ndarray) -> np.ndarray:
    """Heuristic SAR RGB."""
    C = cond_hwc.shape[-1]
    st = percentile_stretch_uint8
    if C == 2:
        return np.dstack([st(cond_hwc[..., 0]), st(cond_hwc[..., 1]), st(cond_hwc[..., 0])])
    if C == 1:
        ch = st(cond_hwc[..., 0])
        return np.dstack([ch, ch, ch])
    return np.dstack([st(cond_hwc[..., i]) for i in range(3)])


def hstack_compare(left_u8: np.ndarray, right_u8: np.ndarray, gap: int = 6) -> np.ndarray:
    """Side-by-side strip with a white gap."""
    h, w, _ = left_u8.shape
    canvas = np.full((h, w * 2 + gap, 3), 255, np.uint8)
    canvas[:, :w] = left_u8
    canvas[:, w + gap:] = right_u8
    return canvas


def save_pred_gt(pred_hwc: np.ndarray, gt_hwc: np.ndarray, out_dir: str, stem: str) -> None:
    """The six-file pred / GT set."""
    os.makedirs(out_dir, exist_ok=True)
    pt, pc = true_color(pred_hwc), cir_color(pred_hwc)
    gt, gc = true_color(gt_hwc), cir_color(gt_hwc)
    for name, img in (("pred_true", pt), ("gt_true", gt), ("pred_cir", pc), ("gt_cir", gc),
                      ("compare_true", hstack_compare(pt, gt)),
                      ("compare_cir", hstack_compare(pc, gc))):
        write_png(os.path.join(out_dir, f"{stem}_{name}.png"), img)
