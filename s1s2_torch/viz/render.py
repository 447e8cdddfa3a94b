"""PNG previews: the numpy half of the JAX package's ``viz/render.py``.

Percentile stretches, true-colour (B4, B3, B2) and CIR (B8, B4, B3)
composites, per-image and dataset-fixed ranges, the SAR preview and the
side-by-side strips, the comparison panels (:func:`save_panel`), and the
files the harness writes from them (:func:`save_rgb_triplet`,
:func:`save_pred_gt`). Inputs are channels-last numpy (H, W, C) with the
bands [B2, B3, B4, B8].

PIL is not among the card's packages, so the port does without it:

* :func:`write_png` encodes the 8-bit RGB and grey PNGs itself (``zlib`` and
  ``struct``); a decoder reads the same pixels PIL's own writer would have
  stored, though the bytes differ.
* :func:`resize_bilinear` is Pillow's ``Image.resize(..., BILINEAR)`` on
  uint8, bit for bit: its ``ImagingResample`` (triangle-filter coefficients
  with the support widened by the scale when downscaling, normalised and
  rounded to 22-bit fixed point; the horizontal pass, clipped to 8 bits,
  then the vertical one).
* :func:`draw_title` draws a title as ``ImageDraw.text`` draws it in
  Pillow's default font, from the glyph atlas ``_glyphs.py``
  (``make_glyphs.py`` writes it): the glyphs' coverage merged as FreeType's
  renderer in Pillow merges overlapping glyphs, then blended onto the panel
  with Pillow's integer blend ``DIV255(bg·(255−a) + ink·a)``. A character
  outside the atlas (printable ASCII) raises ``ValueError``.
"""

from __future__ import annotations

import os
import struct
import zlib
from functools import lru_cache
from typing import Iterable, List, Optional, Tuple

import numpy as np

from s1s2_torch.viz import _glyphs


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """An (H, W, 3) uint8 array as an 8-bit RGB PNG, an (H, W) one as an
    8-bit grey PNG (what PIL writes for ``Image.fromarray`` of each): no
    interlace, every row with filter 0 (none), one zlib stream."""
    img = np.ascontiguousarray(img)
    grey = img.ndim == 2
    if img.dtype != np.uint8 or not (grey or img.ndim == 3 and img.shape[2] == 3):
        raise ValueError(f"expected (H, W, 3) or (H, W) uint8, got {img.shape} {img.dtype}")
    H, W = img.shape[:2]
    rows = np.concatenate([np.zeros((H, 1), np.uint8), img.reshape(H, -1)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 0 if grey else 2, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))



def read_png(path: str) -> np.ndarray:
    """What :func:`write_png` wrote, back as the (H, W, 3) or (H, W) uint8
    array: 8-bit RGB or grey, rows with filter 0, any number of IDAT
    chunks."""
    with open(path, "rb") as f:
        data = f.read()
    W, H, depth, kind = struct.unpack(">IIBB", data[16:26])
    if data[:8] != b"\x89PNG\r\n\x1a\n" or depth != 8 or kind not in (0, 2):
        raise ValueError(f"{path}: not an 8-bit RGB or grey PNG")
    pos, idat = 8, b""
    while pos < len(data):
        n, chunk = struct.unpack(">I4s", data[pos:pos + 8])
        if chunk == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    ch = 3 if kind == 2 else 1
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(H, 1 + ch * W)
    if rows[:, 0].any():
        raise ValueError(f"{path}: a row filter other than 0")
    return rows[:, 1:].reshape((H, W, 3) if ch == 3 else (H, W))

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


# -- Pillow's bilinear resize --------------------------------------------------

PRECISION_BITS = 22  # Pillow's fixed-point coefficients: 32 - 8 - 2


@lru_cache(maxsize=None)
def _bilinear_coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(out, ksize) source indices and 22-bit fixed-point weights of one
    axis: Pillow's ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` for
    the triangle filter (support 1), in the same double arithmetic. Unused
    taps have weight 0 and index 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    idx = np.zeros((out_size, ksize), np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) * ss)) for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        for x, v in enumerate(w):
            k = v / ww if ww != 0.0 else v
            kk[xx, x] = int(0.5 + k * (1 << PRECISION_BITS))
            idx[xx, x] = x + xmin
    idx.flags.writeable = kk.flags.writeable = False  # shared by every caller (cached)
    return idx, kk


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    idx, kk = _bilinear_coeffs(img.shape[axis], out_size)
    shape = [1] * img.ndim
    shape[axis] = out_size
    acc = np.full(tuple(out_size if a == axis else n for a, n in enumerate(img.shape)),
                  1 << (PRECISION_BITS - 1), np.int64)
    for k in range(idx.shape[1]):
        acc += np.take(img, idx[:, k], axis=axis).astype(np.int64) * kk[:, k].reshape(shape)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear(im: np.ndarray, width: int, height: int) -> np.ndarray:
    """Pillow's ``Image.fromarray(im).resize((width, height), BILINEAR)`` of
    an (H, W[, C]) uint8 array, bit for bit: the horizontal pass (8-bit
    clipped) first, then the vertical; an axis whose size does not change is
    not resampled."""
    if im.dtype != np.uint8:
        raise ValueError(f"expected uint8, got {im.dtype}")
    if im.shape[1] != width:
        im = _resample_axis(im, width, 1)
    if im.shape[0] != height:
        im = _resample_axis(im, height, 0)
    return im


def _resize_width(im: np.ndarray, width: int) -> np.ndarray:
    h, w = im.shape[:2]
    if w == width:
        return im
    return resize_bilinear(im, width, int(h * width / w))


# -- titles ----------------------------------------------------------------------


def _div255(a: np.ndarray) -> np.ndarray:
    """Pillow's ``DIV255``: a / 255 rounded, in integers."""
    a = a + 128
    return ((a >> 8) + a) >> 8


def title_coverage(title: str) -> Tuple[np.ndarray, int, int]:
    """The 8-bit coverage of ``title`` laid out from a pen at (0, 0), the
    top of the line: (coverage, x of its left column, y of its top row).
    The pen advances by each glyph's 26.6 advance plus the pair's kerning;
    a glyph's box goes at the pen's pixel (rounded) plus its bearings, and
    overlapping glyphs merge as ``a + DIV255(b·(255−a))``."""
    placed, pen, prev = [], 0, None
    for ch in title:
        g = _glyphs.GLYPHS.get(ord(ch))
        if g is None:
            raise ValueError(f"title character {ch!r} (U+{ord(ch):04X}) is not in the glyph "
                             f"atlas ({_glyphs.FONT}: printable ASCII only)")
        if prev is not None:
            pen += _glyphs.KERNING.get((prev, ord(ch)), 0)
        left, top, w, h, adv, bits = g
        if w and h:
            cov = np.frombuffer(bytes.fromhex(bits), np.uint8).reshape(h, w)
            placed.append((((pen + 32) >> 6) + left, top, cov))
        pen += adv
        prev = ord(ch)
    if not placed:
        return np.zeros((0, 0), np.uint8), 0, 0
    x0 = min(x for x, _, _ in placed)
    y0 = min(y for _, y, _ in placed)
    x1 = max(x + c.shape[1] for x, _, c in placed)
    y1 = max(y + c.shape[0] for _, y, c in placed)
    out = np.zeros((y1 - y0, x1 - x0), np.int64)
    for x, y, c in placed:
        sub = out[y - y0:y - y0 + c.shape[0], x - x0:x - x0 + c.shape[1]]
        a = c.astype(np.int64)
        sub[...] = a + _div255(sub * (255 - a))
    return out.astype(np.uint8), x0, y0


def draw_title(panel: np.ndarray, title: str, xy: Tuple[int, int] = (10, 5),
               ink: Tuple[int, int, int] = (255, 255, 0)) -> np.ndarray:
    """``ImageDraw.Draw(im).text(xy, title, fill=ink)`` with Pillow's
    default font on an (H, W, 3) uint8 panel, in place (clipped to the
    panel); returns the panel."""
    cov, dx, dy = title_coverage(title)
    x, y = xy[0] + dx, xy[1] + dy
    H, W = panel.shape[:2]
    cx0, cy0 = max(0, -x), max(0, -y)
    cx1, cy1 = min(cov.shape[1], W - x), min(cov.shape[0], H - y)
    if cx1 <= cx0 or cy1 <= cy0:
        return panel
    a = cov[cy0:cy1, cx0:cx1, None].astype(np.int64)
    box = panel[y + cy0:y + cy1, x + cx0:x + cx1]
    ink_a = np.asarray(ink, np.int64)[None, None, :]
    box[...] = _div255(box.astype(np.int64) * (255 - a) + ink_a * a).astype(np.uint8)
    return panel


# -- comparison panels -------------------------------------------------------------


def _crop(arr: np.ndarray, i: int, j: int, size: int) -> np.ndarray:
    """PIL's ``crop((j, i, j + size, i + size))``: zeros outside the image."""
    out = np.zeros((size, size) + arr.shape[2:], arr.dtype)
    part = arr[i:i + size, j:j + size]
    out[:part.shape[0], :part.shape[1]] = part
    return out


def save_panel(
    pred_hwc: np.ndarray,
    gt_hwc: Optional[np.ndarray],
    cond_hwc: np.ndarray,
    out_path: str,
    title: str = "",
    zoom: int = 0,
    zoom_k: int = 0,
    tile_width: int = 512,
    rng_seed: int = 0,
) -> None:
    """2×3 comparison panel (S1 | GT | Pred over CIR GT | CIR pred | error),
    or one row (S1 | Pred | CIR pred) without GT, each tile resized to
    ``tile_width``; the title drawn at (10, 5) in yellow. With GT, ``zoom``
    and ``zoom_k``: the ``zoom_k`` highest-error of 1000 ``zoom``² windows
    drawn from ``default_rng(rng_seed)``, each cropped from the S1, GT and
    prediction images and enlarged ×2 (nearest), as
    ``{stem}_{s1,gt_true,pred_true}_zoom{k}.png``."""
    s1_rgb = s1_preview(cond_hwc)
    pred_true, pred_cir = true_color(pred_hwc), cir_color(pred_hwc)
    if gt_hwc is not None:
        gt_true, gt_cir = true_color(gt_hwc), cir_color(gt_hwc)
        err_u8 = percentile_stretch_uint8(np.abs(pred_hwc - gt_hwc).mean(axis=-1))
        rows = [[s1_rgb, gt_true, pred_true], [gt_cir, pred_cir, np.dstack([err_u8] * 3)]]
    else:
        rows = [[s1_rgb, pred_true, pred_cir]]

    def hstack(ims: List[np.ndarray]) -> np.ndarray:
        ims = [_resize_width(im, tile_width) for im in ims]
        h = max(im.shape[0] for im in ims)
        ims = [resize_bilinear(im, im.shape[1], h) if im.shape[0] != h else im for im in ims]
        return np.concatenate(ims, axis=1)

    panel = np.ascontiguousarray(np.concatenate([hstack(r) for r in rows], axis=0))
    if title:
        draw_title(panel, title)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    write_png(out_path, panel)

    if zoom > 0 and zoom_k > 0 and gt_hwc is not None:
        err = np.abs(pred_hwc - gt_hwc).mean(axis=-1)
        H, W = err.shape
        rng = np.random.default_rng(rng_seed)
        scores = []
        for _ in range(1000):
            i = int(rng.integers(0, max(1, H - zoom + 1)))
            j = int(rng.integers(0, max(1, W - zoom + 1)))
            scores.append((float(err[i:i + zoom, j:j + zoom].mean()), i, j))
        scores.sort(reverse=True)
        for k in range(min(zoom_k, len(scores))):
            _, i, j = scores[k]
            for name, arr in (("s1", s1_rgb), ("gt_true", gt_true), ("pred_true", pred_true)):
                crop = _crop(arr, i, j, zoom).repeat(2, axis=0).repeat(2, axis=1)
                write_png(out_path.replace(".png", f"_{name}_zoom{k}.png"), crop)
