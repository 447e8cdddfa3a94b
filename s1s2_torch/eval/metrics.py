"""Masked image-quality metrics (NHWC, float32).

Port of the JAX package's ``eval/metrics.py``: the global-sum convention
Σw·err / (Σw·C + 1e-8) (``masked_mae``, ``masked_mse``,
``per_file_mae_mse``), the per-sample-mean convention, PSNR with the 99.0
cap, the global SSIM surrogate, SAM, ERGAS, the streaming channelwise sums
and the ε/v prediction diagnostics. Masks have shape (B, H, W) or
(B, H, W, 1) and are binarized by ``mask > 0``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch


def _weights(pred: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, H, W, 1) binary float32 weights from an optional mask."""
    B, H, W, _ = pred.shape
    if mask is None:
        return torch.ones((B, H, W, 1), dtype=torch.float32, device=pred.device)
    if mask.dim() == 3:
        mask = mask[..., None]
    return (mask > 0).float()


def masked_mae(pred, tgt, mask=None) -> torch.Tensor:
    w = _weights(pred, mask)
    num = (w * (pred.float() - tgt.float()).abs()).sum()
    den = w.sum() * pred.shape[-1]
    return num / (den + 1e-8)


def masked_mse(pred, tgt, mask=None) -> torch.Tensor:
    w = _weights(pred, mask)
    num = (w * (pred.float() - tgt.float()) ** 2).sum()
    den = w.sum() * pred.shape[-1]
    return num / (den + 1e-8)


def per_file_mae_mse(pred, tgt, mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample (B,) MAE/MSE in the global-sum convention."""
    w = _weights(pred, mask)
    d = pred.float() - tgt.float()
    den = w.sum(dim=(1, 2, 3)) * pred.shape[-1] + 1e-8
    mae = (w * d.abs()).sum(dim=(1, 2, 3)) / den
    mse = (w * d ** 2).sum(dim=(1, 2, 3)) / den
    return mae, mse


# -- per-sample-mean convention ----------------------------------------------


def masked_mae_per_sample(pred, tgt, mask=None) -> torch.Tensor:
    w = _weights(pred, mask)
    num = (w * (pred.float() - tgt.float()).abs()).sum(dim=(1, 2, 3)).mean()
    den = (w.sum(dim=(1, 2, 3)).clamp_min(1e-8) * pred.shape[-1]).mean()
    return num / den


def masked_mse_per_sample(pred, tgt, mask=None) -> torch.Tensor:
    w = _weights(pred, mask)
    num = (w * (pred.float() - tgt.float()) ** 2).sum(dim=(1, 2, 3)).mean()
    den = (w.sum(dim=(1, 2, 3)).clamp_min(1e-8) * pred.shape[-1]).mean()
    return num / den


def per_sample(metric: Callable) -> Callable:
    """Lift a whole-batch metric to per-sample (B,) values: the metric of
    each sample alone, as a batch of one."""
    def fn(pred, tgt, mask=None):
        return torch.stack([metric(pred[i:i + 1], tgt[i:i + 1],
                                   None if mask is None else mask[i:i + 1])
                            for i in range(pred.shape[0])])
    return fn


# -- derived scores ----------------------------------------------------------


def psnr(pred, tgt, mask=None) -> torch.Tensor:
    """10·log10(1/MSE) with the reference's 99.0 cap for MSE ≤ 1e-12."""
    m = masked_mse(pred, tgt, mask)
    return torch.where(m <= 1e-12, torch.full_like(m, 99.0),
                       10.0 * torch.log10(1.0 / m.clamp_min(1e-30)))


def psnr_from_mse(mse: float) -> float:
    """Host-side PSNR used by streaming aggregation."""
    return 99.0 if mse <= 1e-12 else 10.0 * math.log10(1.0 / mse)


def ssim_simple(pred, tgt, C1: float = 0.01 ** 2, C2: float = 0.03 ** 2) -> torch.Tensor:
    """Global (non-windowed) SSIM-like index over the whole tensor, with an
    unbiased variance."""
    pred, tgt = pred.float(), tgt.float()
    mu_x, mu_y = pred.mean(), tgt.mean()
    n = pred.numel()
    bessel = n / max(n - 1, 1)
    vx = ((pred - mu_x) ** 2).mean() * bessel
    vy = ((tgt - mu_y) ** 2).mean() * bessel
    cxy = ((pred - mu_x) * (tgt - mu_y)).mean()
    return ((2 * mu_x * mu_y + C1) * (2 * cxy + C2)) / (
        (mu_x ** 2 + mu_y ** 2 + C1) * (vx + vy + C2) + 1e-8)


def sam(pred, tgt, mask=None) -> torch.Tensor:
    """Spectral Angle Mapper (radians), averaged over masked pixels."""
    pred, tgt = pred.float(), tgt.float()
    w = _weights(pred, mask)[..., 0]
    dot = (pred * tgt).sum(dim=-1)
    p_norm = (pred ** 2).sum(dim=-1).sqrt().clamp_min(1e-8)
    g_norm = (tgt ** 2).sum(dim=-1).sqrt().clamp_min(1e-8)
    angle = torch.arccos((dot / (p_norm * g_norm)).clamp(-1.0, 1.0))
    return (angle * w).sum() / w.sum().clamp_min(1.0)


def ergas(pred, tgt, mask=None, scale_ratio: float = 4.0) -> torch.Tensor:
    """ERGAS; the per-band RMSE is masked but the band mean is over all
    pixels (+1e-8)."""
    pred, tgt = pred.float(), tgt.float()
    C = pred.shape[-1]
    w = _weights(pred, mask)
    num = (w * (pred - tgt) ** 2).sum(dim=(0, 1, 2))
    rmse_c = (num / (w.sum() + 1e-8)).clamp_min(0.0).sqrt()
    mean_c = tgt.mean(dim=(0, 1, 2)) + 1e-8
    return 100.0 * ((1.0 / C) * ((rmse_c / mean_c) ** 2).sum()).sqrt() * scale_ratio


# -- streaming dataset aggregation -------------------------------------------


def channelwise_error_sums(pred, tgt, mask=None
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-channel |err| and err² sums over masked pixels and the
    valid-pixel count; accumulate across batches, finish with
    :func:`aggregate_final`."""
    w = _weights(pred, mask)
    d = pred.float() - tgt.float()
    return (w * d.abs()).sum(dim=(0, 1, 2)), (w * d ** 2).sum(dim=(0, 1, 2)), w.sum()


def aggregate_final(abs_sum_c, sq_sum_c, pix_sum, band_weights=None):
    """Streaming sums → (MAE, MSE, PSNR, mae_c, mse_c, psnr_c), in float64
    numpy on the host."""
    def host(v):
        return np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v, np.float64)

    abs_sum_c, sq_sum_c = host(abs_sum_c), host(sq_sum_c)
    denom = max(float(pix_sum), 1e-8)
    mae_c = abs_sum_c / denom
    mse_c = sq_sum_c / denom
    if band_weights is None:
        mae, mse = float(mae_c.mean()), float(mse_c.mean())
    else:
        bw = np.asarray(band_weights, np.float64)
        bw = bw / max(bw.sum(), 1e-8)
        mae, mse = float((mae_c * bw).sum()), float((mse_c * bw).sum())
    psnr_c = np.where(mse_c <= 1e-12, 99.0, 10.0 * np.log10(1.0 / np.maximum(mse_c, 1e-300)))
    return mae, mse, psnr_from_mse(mse), mae_c, mse_c, psnr_c


# -- prediction diagnostics ---------------------------------------------------


def _cosine(a, b) -> torch.Tensor:
    a, b = a.float(), b.float()
    return (a * b).sum() / ((a ** 2).sum().sqrt() * (b ** 2).sum().sqrt() + 1e-8)


def eps_diagnostics(pred_eps, true_eps) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ε-MSE, cosine(pred, true)), unmasked, over the whole tensor."""
    return ((pred_eps.float() - true_eps.float()) ** 2).mean(), _cosine(pred_eps, true_eps)


def v_diagnostics(pred_v, true_v, eps_pred=None, true_eps=None):
    """(v-MSE, v-cos[, derived-ε cos])."""
    v_mse = ((pred_v.float() - true_v.float()) ** 2).mean()
    v_cos = _cosine(pred_v, true_v)
    if eps_pred is None:
        return v_mse, v_cos
    return v_mse, v_cos, _cosine(eps_pred, true_eps)
