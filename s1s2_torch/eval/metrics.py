"""Masked image-quality metrics, global-sum convention (NHWC, float32).

Port of the JAX package's ``eval/metrics.py`` (``masked_mae``,
``masked_mse``, ``per_file_mae_mse``): Σw·err / (Σw·C + 1e-8), with masks of
shape (B, H, W) or (B, H, W, 1) binarized by ``mask > 0``.
"""

from __future__ import annotations

from typing import Optional, Tuple

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
