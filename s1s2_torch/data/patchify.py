"""Patch extraction: the port of the JAX package's ``data/patchify.py``,
the reference ``Patch.py`` around whole-scene window statistics.

    python -m s1s2_torch patchify --base-dir RAW --output-dir PATCHES

It reads the same collocated band files (B2/B3/B4/B8 targets, Sigma0 HH/HV
with the three filename fallbacks, incidence angle, elevation,
collocationFlags), applies the same quality filters (valid ratio ≥ 0.80,
all-band variance, dark fraction, B8 Laplacian-variance texture), the same
normalisation (valid-mask z-score for HH/HV, /90 incidence, /1000
elevation, zero-fill invalid) and writes the same artifacts: a compressed
npz per patch {inputs, target, mask, geo meta}, per-patch PNG previews
(true colour and CIR included) and ``manifest.json`` with the skip counters
and at most 2000 patch entries.

Every window's filter statistics come from integral images built once per
scene (:func:`scene_window_stats`), so the sliding loop reduces to
lookups. As in the JAX package, the Laplacian response is computed once
over the whole scene (symmetric padding at the scene's edges), so pixels
within 1 px of an interior window edge use their true neighbours;
``exact_filters=True`` runs the per-window :func:`laplacian_var` instead.

Host numpy, as in the JAX package. Raster I/O: ``rasterio`` is a gated
import (only for real ``.img`` rasters); ``.npy`` band files are read
directly, with an identity geotransform. The previews are written with the
port's own PNG encoder (``viz/render.write_png``): the pixels PIL's writer
would store.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# raster I/O (host; rasterio gated, .npy accepted)
# ---------------------------------------------------------------------------


def read_band(path: str) -> Optional[np.ndarray]:
    """Read a single-band raster as float32; None if missing
    (`Patch.py:12-17`). ``.npy`` files are read directly (test path)."""
    if not os.path.exists(path):
        npy = path + ".npy"
        if os.path.exists(npy):
            return np.load(npy).astype(np.float32)
        return None
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    try:
        import rasterio
    except ImportError as e:
        raise ImportError(
            "rasterio is required for .img rasters; install it or provide "
            ".npy band files"
        ) from e
    with rasterio.open(path) as src:
        return src.read(1).astype("float32")


def get_geo(path: str) -> Tuple[tuple, str]:
    """Geotransform + CRS (`Patch.py:19-24`); identity for .npy test rasters."""
    if path.endswith(".npy") or os.path.exists(path + ".npy"):
        return (0.0, 1.0, 0.0, 0.0, 0.0, -1.0), ""
    import rasterio

    with rasterio.open(path) as src:
        transform = tuple(src.transform.to_gdal())
        crs = src.crs.to_string() if src.crs else ""
    return transform, crs


# ---------------------------------------------------------------------------
# per-scene preprocessing (`Patch.py:26-62`)
# ---------------------------------------------------------------------------


def maybe_scale_s2_to_01(band: np.ndarray) -> np.ndarray:
    """0..10000 → 0..1 heuristic (95th pct > 2.0) then hard clip [0,1]."""
    finite = np.isfinite(band)
    if not np.any(finite):
        return np.zeros_like(band, dtype=np.float32)
    q95 = np.nanpercentile(band[finite], 95)
    if q95 > 2.0:
        band = band / 10000.0
    return np.clip(band, 0.0, 1.0).astype(np.float32)


def build_mask(inputs: np.ndarray, target: np.ndarray,
               colloc: Optional[np.ndarray] = None) -> np.ndarray:
    """finite(all inputs) ∧ finite(all targets) ∧ (collocationFlags > 0)."""
    mask = np.isfinite(inputs).all(axis=0) & np.isfinite(target).all(axis=0)
    if colloc is not None:
        mask &= colloc > 0
    return mask


def zscore(x: np.ndarray, mask: Optional[np.ndarray]) -> np.ndarray:
    """z-score with valid-mask statistics (``Patch.py:51-62``): mean and
    standard deviation over the masked pixels (all pixels when the mask is
    missing or empty), NaNs ignored; a non-finite mean becomes 0 and a
    non-finite or tiny (< 1e-6) deviation becomes 1."""
    if mask is None or not np.any(mask):
        mu, sigma = np.nanmean(x), np.nanstd(x)
    else:
        mu, sigma = float(np.nanmean(x[mask])), float(np.nanstd(x[mask]))
    if not np.isfinite(mu):
        mu = 0.0
    if not np.isfinite(sigma) or sigma < 1e-6:
        sigma = 1.0
    return (x - mu) / sigma


def patch_iter(H: int, W: int, ps: int, stride: int) -> Iterator[Tuple[int, int]]:
    for r in range(0, H - ps + 1, stride):
        for c in range(0, W - ps + 1, stride):
            yield r, c


# ---------------------------------------------------------------------------
# exact per-window filters (parity reference, `Patch.py:88-114`)
# ---------------------------------------------------------------------------


def dark_fraction(Y: np.ndarray, M: np.ndarray, thr: float = 0.10) -> float:
    if not np.any(M):
        return 1.0
    vis_mean = (Y[0] + Y[1] + Y[2]) / 3.0
    dark = (vis_mean < thr) & (Y[3] < thr) & M
    return float(dark.sum()) / float(M.sum())


def _laplacian_symm(a: np.ndarray) -> np.ndarray:
    """5-point Laplacian with symmetric boundary (== convolve2d boundary='symm'
    for the symmetric kernel [[0,1,0],[1,-4,1],[0,1,0]])."""
    p = np.pad(a, 1, mode="symmetric")
    return (
        p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:] - 4.0 * p[1:-1, 1:-1]
    )


def laplacian_var(img: np.ndarray, M: np.ndarray) -> float:
    """Exact per-window texture measure (`Patch.py:100-114`)."""
    a = img.astype(np.float32).copy()
    bad = ~np.isfinite(a)
    if np.any(bad & M):
        a[bad] = np.nanmean(a[M])
    L = _laplacian_symm(a)
    return float(np.nanvar(L[M])) if np.any(M) else 0.0


# ---------------------------------------------------------------------------
# vectorized whole-scene window statistics
# ---------------------------------------------------------------------------


def _integral(a: np.ndarray) -> np.ndarray:
    """Zero-padded 2D integral image (float64 for exactness)."""
    s = np.zeros((a.shape[0] + 1, a.shape[1] + 1), np.float64)
    np.cumsum(np.cumsum(np.nan_to_num(a, nan=0.0), axis=0), axis=1, out=s[1:, 1:])
    return s


def _window_sums(S: np.ndarray, rows: np.ndarray, cols: np.ndarray, ps: int) -> np.ndarray:
    """Box sums for all (row, col) windows from an integral image."""
    r, c = rows[:, None], cols[None, :]
    return S[r + ps, c + ps] - S[r, c + ps] - S[r + ps, c] + S[r, c]


@dataclasses.dataclass
class WindowStats:
    """Per-window filter statistics for one scene (grids are (nR, nC))."""

    rows: np.ndarray
    cols: np.ndarray
    valid_ratio: np.ndarray
    var_per_band: np.ndarray  # (C, nR, nC) variance of Y over valid pixels
    dark_ratio: np.ndarray
    lap_var: np.ndarray


def scene_window_stats(
    target: np.ndarray,
    mask: np.ndarray,
    ps: int,
    stride: int,
    dark_thr: float = 0.10,
) -> WindowStats:
    """All filter stats for every stride-aligned window in one pass."""
    C, H, W = target.shape
    rows = np.arange(0, H - ps + 1, stride)
    cols = np.arange(0, W - ps + 1, stride)
    m = mask.astype(np.float64)
    Sm = _integral(m)
    cnt = _window_sums(Sm, rows, cols, ps)
    area = float(ps * ps)
    valid_ratio = cnt / area
    safe_cnt = np.maximum(cnt, 1.0)

    var_pb = np.empty((C, len(rows), len(cols)), np.float64)
    for c in range(C):
        ym = np.where(mask, target[c], 0.0).astype(np.float64)
        s1 = _window_sums(_integral(ym), rows, cols, ps)
        s2 = _window_sums(_integral(ym * ym), rows, cols, ps)
        mean = s1 / safe_cnt
        var_pb[c] = np.maximum(s2 / safe_cnt - mean * mean, 0.0)

    vis_mean = (target[0] + target[1] + target[2]) / 3.0
    dark = ((vis_mean < dark_thr) & (target[3] < dark_thr) & mask).astype(np.float64)
    dark_cnt = _window_sums(_integral(dark), rows, cols, ps)
    dark_ratio = np.where(cnt > 0, dark_cnt / safe_cnt, 1.0)

    # scene-level Laplacian of B8 (NaNs propagate like the reference's
    # un-filled bad pixels), then masked variance via integral images over
    # finite ∧ valid pixels
    L = _laplacian_symm(target[3].astype(np.float32))
    ok = np.isfinite(L) & mask
    Lz = np.where(ok, L, 0.0).astype(np.float64)
    okf = ok.astype(np.float64)
    n_ok = np.maximum(_window_sums(_integral(okf), rows, cols, ps), 1.0)
    l1 = _window_sums(_integral(Lz), rows, cols, ps)
    l2 = _window_sums(_integral(Lz * Lz), rows, cols, ps)
    lmean = l1 / n_ok
    lap_var = np.maximum(l2 / n_ok - lmean * lmean, 0.0)

    return WindowStats(rows, cols, valid_ratio, var_pb, dark_ratio, lap_var)


# ---------------------------------------------------------------------------
# main pipeline
# ---------------------------------------------------------------------------

S1_NAME_FALLBACKS = [
    ["Sigma0_HH_db_m.img", "Sigma0_HV_db_m.img"],
    ["Sigma0_HH_db_corr024_m.img", "Sigma0_HV_db_corr024_m.img"],
    ["Sigma0_HH_db_corr028_m.img", "Sigma0_HV_db_corr028_m.img"],
]
TARGET_BANDS = ["B2.img", "B3.img", "B4.img", "B8.img"]
AUX_BANDS = ["projectedLocalIncidenceAngle_m.img", "elevation_ref_egm2008.img"]


@dataclasses.dataclass
class PatchifyConfig:
    """CLI surface of `Patch.py:314-338`."""

    base_dir: str
    output_dir: str
    patch_size: int = 256
    stride: int = 32
    max_patches: int = 10000
    per_folder_share: bool = False
    valid_ratio_threshold: float = 0.80
    variance_threshold: float = 1e-4
    dark_thr: float = 0.10
    dark_max_ratio: float = 0.60
    texture_thr: float = 5e-5
    exact_filters: bool = False  # per-window Laplacian (bit parity, slow)
    write_previews: bool = True


def load_scene(folder_path: str):
    """Read one collocated folder → (inputs (4,H,W), target (4,H,W), mask,
    geo) or None if bands are missing (`Patch.py:152-192`)."""
    target_bands = []
    for name in TARGET_BANDS:
        band = read_band(os.path.join(folder_path, name))
        if band is None:
            return None
        target_bands.append(maybe_scale_s2_to_01(band))
    target = np.stack(target_bands).astype(np.float32)

    s1 = None
    for names in S1_NAME_FALLBACKS:
        arrs = [read_band(os.path.join(folder_path, n)) for n in names]
        if not any(a is None for a in arrs):
            s1 = np.stack(arrs)
            break
    if s1 is None:
        return None

    aux = [read_band(os.path.join(folder_path, p)) for p in AUX_BANDS]
    if any(a is None for a in aux):
        return None
    inputs = np.concatenate([s1.astype(np.float32), np.stack(aux).astype(np.float32)])

    colloc = read_band(os.path.join(folder_path, "collocationFlags.img"))
    mask = build_mask(inputs, target, colloc)
    geo = get_geo(os.path.join(folder_path, "B2.img"))
    return inputs, target, mask, geo


def run_patchify(cfg: PatchifyConfig) -> Dict:
    """Full pipeline (`Patch.py:118-310`) → manifest dict (also written to
    manifest.json)."""
    from s1s2_torch.viz.render import make_rgb, percentile_stretch_uint8, write_png

    os.makedirs(cfg.output_dir, exist_ok=True)
    preview_dir = os.path.join(cfg.output_dir, "preview_patches")
    if cfg.write_previews:
        os.makedirs(preview_dir, exist_ok=True)

    folders = sorted(
        f for f in os.listdir(cfg.base_dir)
        if os.path.isdir(os.path.join(cfg.base_dir, f))
    )
    per_folder_cap = None
    if cfg.max_patches and cfg.per_folder_share and folders:
        per_folder_cap = max(1, cfg.max_patches // len(folders))

    count = 0
    manifest: List[Dict] = []
    skips = {"dark": 0, "texture": 0, "validratio": 0, "var": 0}

    for folder in folders:
        if cfg.max_patches and count >= cfg.max_patches:
            break
        scene = load_scene(os.path.join(cfg.base_dir, folder))
        if scene is None:
            continue
        inputs, target, valid_mask, (transform, crs) = scene
        H, W = target.shape[1:]
        ps = cfg.patch_size

        stats = scene_window_stats(target, valid_mask, ps, cfg.stride, cfg.dark_thr)
        r_index = {r: i for i, r in enumerate(stats.rows)}
        c_index = {c: i for i, c in enumerate(stats.cols)}

        saved_here = 0
        for row, col in patch_iter(H, W, ps, cfg.stride):
            if cfg.max_patches and count >= cfg.max_patches:
                break
            if per_folder_cap and saved_here >= per_folder_cap:
                break
            ri, ci = r_index[row], c_index[col]

            # filters in reference order (`Patch.py:205-224`)
            vr = float(stats.valid_ratio[ri, ci])
            if vr < cfg.valid_ratio_threshold:
                skips["validratio"] += 1
                continue
            if bool(np.all(stats.var_per_band[:, ri, ci] < cfg.variance_threshold)):
                skips["var"] += 1
                continue
            if float(stats.dark_ratio[ri, ci]) > cfg.dark_max_ratio:
                skips["dark"] += 1
                continue
            M = valid_mask[row : row + ps, col : col + ps]
            if cfg.exact_filters:
                lv = laplacian_var(target[3, row : row + ps, col : col + ps], M)
            else:
                lv = float(stats.lap_var[ri, ci])
            if lv < cfg.texture_thr:
                skips["texture"] += 1
                continue

            X = inputs[:, row : row + ps, col : col + ps].copy()
            Y = target[:, row : row + ps, col : col + ps].copy()

            # normalize (`Patch.py:228-244`)
            X[0] = zscore(X[0], M)
            X[1] = zscore(X[1], M)
            X[2] = np.nan_to_num(X[2], nan=0.0) / 90.0
            X[3] = np.nan_to_num(X[3], nan=0.0) / 1000.0
            for ch in range(X.shape[0]):
                X[ch][~M] = 0.0
                X[ch] = np.nan_to_num(X[ch], nan=0.0, posinf=0.0, neginf=0.0)
            for ch in range(Y.shape[0]):
                Y[ch][~M] = 0.0
                Y[ch] = np.nan_to_num(Y[ch], nan=0.0, posinf=0.0, neginf=0.0)

            patch_id = f"{count:06d}"
            out_npz = os.path.join(cfg.output_dir, f"patch_{patch_id}.npz")
            np.savez_compressed(
                out_npz,
                inputs=X.astype(np.float32),
                target=Y.astype(np.float32),
                mask=M.astype("uint8"),
                folder=folder,
                row=int(row),
                col=int(col),
                transform=list(transform),
                crs=str(crs),
                patch_size=ps,
                stride=cfg.stride,
                valid_ratio=vr,
            )

            prev_rel = ""
            if cfg.write_previews:
                pdir = os.path.join(preview_dir, f"patch_{patch_id}")
                os.makedirs(pdir, exist_ok=True)
                for name, arr in zip(
                    ["HH_dB_std", "HV_dB_std", "IncAngle_n", "Elevation_km"], X
                ):
                    write_png(os.path.join(pdir, f"{name}.png"), percentile_stretch_uint8(arr))
                for name, arr in zip(["B2", "B3", "B4", "B8"], Y):
                    write_png(os.path.join(pdir, f"{name}.png"), percentile_stretch_uint8(arr))
                write_png(os.path.join(pdir, "true_color.png"), make_rgb(Y[2], Y[1], Y[0]))
                write_png(os.path.join(pdir, "false_color_CIR.png"), make_rgb(Y[3], Y[2], Y[1]))
                prev_rel = os.path.relpath(pdir, cfg.output_dir)

            manifest.append({
                "patch_id": patch_id,
                "folder": folder,
                "npz": os.path.relpath(out_npz, cfg.output_dir),
                "preview_dir": prev_rel,
                "row": int(row),
                "col": int(col),
                "valid_ratio": vr,
            })
            count += 1
            saved_here += 1

    out = {
        "total_patches": count,
        "dark_skipped": skips["dark"],
        "texture_skipped": skips["texture"],
        "validratio_skipped": skips["validratio"],
        "var_skipped": skips["var"],
        "base_dir": cfg.base_dir,
        "patch_size": cfg.patch_size,
        "stride": cfg.stride,
        "valid_ratio_threshold": cfg.valid_ratio_threshold,
        "variance_threshold": cfg.variance_threshold,
        "dark_thr": cfg.dark_thr,
        "dark_max_ratio": cfg.dark_max_ratio,
        "texture_thr": cfg.texture_thr,
        "patches": manifest[:2000],
    }
    with open(os.path.join(cfg.output_dir, "manifest.json"), "w") as f:
        json.dump(out, f, indent=2, ensure_ascii=False)
    return out
