"""Classical baselines that bound what the diffusion model must beat.

Port of the JAX package's ``eval/baselines.py``: the SISR bicubic
down-and-up on the GT itself, with PyTorch's own a=-0.75 cubic kernel as a
pair of f32 interpolation-matrix products (TF32 off on the card), and the
per-image ridge regression S1 → S2 fit on the same image. Neither is a
kernel of the JAX package: the resize is two ``torch.matmul``s, the fit
host numpy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _cubic_weights(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Cubic-convolution kernel (Keys 1981) with PyTorch's a=-0.75."""
    ax = np.abs(x)
    return np.where(
        ax <= 1.0,
        (a + 2.0) * ax ** 3 - (a + 3.0) * ax ** 2 + 1.0,
        np.where(ax < 2.0, a * (ax ** 3 - 5.0 * ax ** 2 + 8.0 * ax - 4.0), 0.0),
    )


def _bicubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) f32 matrix of ``F.interpolate(mode='bicubic',
    align_corners=False)``: source coordinate (d+0.5)·(n_in/n_out)−0.5, four
    taps clamped to the border, no antialias widening on downscale."""
    src = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(src).astype(np.int64)
    mat = np.zeros((n_out, n_in), np.float32)
    for k in range(-1, 3):
        idx = np.clip(i0 + k, 0, n_in - 1)
        w = _cubic_weights(src - (i0 + k)).astype(np.float32)
        np.add.at(mat, (np.arange(n_out), idx), w)
    return mat


def _bicubic_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Separable bicubic resize of NHWC f32 ``x``: rows, then columns, each
    one f32 matrix product."""
    mh = torch.from_numpy(_bicubic_matrix(x.shape[1], out_h)).to(x.device)
    mw = torch.from_numpy(_bicubic_matrix(x.shape[2], out_w)).to(x.device)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        x = torch.einsum("hj,bjwc->bhwc", mh, x.float())
        return torch.einsum("wk,bhkc->bhwc", mw, x)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


def baseline_bicubic(x_gt: torch.Tensor, scale_factor: int = 4) -> torch.Tensor:
    """Bicubic down by ``scale_factor`` then back up, on the GT, clipped to
    [0, 1]."""
    _, H, W, _ = x_gt.shape
    lr = _bicubic_resize(x_gt, H // scale_factor, W // scale_factor)
    return torch.clamp(_bicubic_resize(lr, H, W), 0.0, 1.0)


def baseline_linear_fit_predict(cond: np.ndarray, gt: np.ndarray, mask: Optional[np.ndarray],
                                subsample_max: int = 200_000, ridge: float = 1e-4,
                                seed: int = 0) -> np.ndarray:
    """Per-band ridge regression S1 → S2 fit on the same image: cond
    (H,W,Cc), gt (H,W,Ct), mask (H,W) or None → (H,W,Ct) f32, zeros outside
    the mask, clipped to [0, 1]. The f32 normal equations are solved for all
    bands at once."""
    H, W, Cc = cond.shape
    Ct = gt.shape[-1]
    m = (mask > 0).reshape(-1) if mask is not None else np.ones(H * W, bool)
    X = cond.reshape(-1, Cc)[m]
    Xb = np.concatenate([X, np.ones((X.shape[0], 1), np.float32)], axis=1)
    ys = gt.reshape(-1, Ct)[m]
    if Xb.shape[0] > subsample_max:
        idx = np.random.default_rng(seed).choice(Xb.shape[0], subsample_max, replace=False)
        Xb_fit, ys_fit = Xb[idx], ys[idx]
    else:
        Xb_fit, ys_fit = Xb, ys
    XtX = (Xb_fit.T @ Xb_fit) + np.float32(ridge) * np.eye(Cc + 1, dtype=np.float32)
    Wmat = np.linalg.solve(XtX, Xb_fit.T @ ys_fit)
    yhat = (Xb @ Wmat).astype(np.float32)
    pred = np.zeros((H * W, Ct), np.float32)
    pred[m] = yhat
    return np.clip(pred.reshape(H, W, Ct), 0.0, 1.0)
