"""Training losses, NHWC, computed in float32.

Port of the JAX package's ``train/loss.py``: one per-channel
pixel-weighted MSE for both of the reference's trainers, computed in f32
whatever dtype the model's forward ran in.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def masked_mse_per_channel(
    pred: torch.Tensor,
    target: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    band_weights: Optional[torch.Tensor | Sequence[float]] = None,
    mask_as_weights: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted per-channel MSE → (scalar loss, per-channel losses (C,)).

    * the mask is binarised (> 0); with ``mask_as_weights`` the binarised
      mask is then divided by its mean, clamped to 1e-6;
    * one denominator, Σw clamped to 1e-6, shared by every channel;
    * optional per-channel band weights, normalised by their clamped sum;
      without them the loss is the mean of the channel losses.
    """
    pred, target = pred.float(), target.float()
    B, H, W, C = pred.shape
    if mask is None:
        w = torch.ones((B, H, W, 1), dtype=torch.float32, device=pred.device)
    else:
        if mask.dim() == 3:
            mask = mask[..., None]
        w = (mask > 0).float()
    if mask_as_weights:
        w = w / torch.clamp(w.mean(), min=1e-6)

    se = (pred - target) ** 2 * w
    denom = torch.clamp(w.sum(), min=1e-6)
    ch_losses = se.sum(dim=(0, 1, 2)) / denom

    if band_weights is not None:
        bw = torch.as_tensor(band_weights, dtype=torch.float32, device=pred.device).reshape(C)
        total = (ch_losses * bw).sum() / torch.clamp(bw.sum(), min=1e-6)
    else:
        total = ch_losses.mean()
    return total, ch_losses
