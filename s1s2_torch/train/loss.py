"""Training losses, NHWC, computed in float32.

Port of the JAX package's ``train/loss.py``: one per-channel
pixel-weighted MSE for both of the reference's trainers, computed in f32
whatever dtype the model's forward ran in.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch


def masked_mse_per_channel(
    pred: torch.Tensor,
    target: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    band_weights: Optional[torch.Tensor | Sequence[float]] = None,
    mask_as_weights: bool = False,
    psum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted per-channel MSE → (scalar loss, per-channel losses (C,)).

    * the mask is binarised (> 0); with ``mask_as_weights`` the binarised
      mask is then divided by its mean, clamped to 1e-6;
    * one denominator, Σw clamped to 1e-6, shared by every channel;
    * optional per-channel band weights, normalised by their clamped sum;
      without them the loss is the mean of the channel losses.

    ``psum`` sums a tensor over the shards of the batch (``parallel/comm.psum``
    on a mesh): the mean, Σw and the squared errors are then the global
    batch's. Without it the batch is whole.
    """
    psum = psum or (lambda t: t)
    pred, target = pred.float(), target.float()
    B, H, W, C = pred.shape
    if mask is None:
        w = torch.ones((B, H, W, 1), dtype=torch.float32, device=pred.device)
    else:
        if mask.dim() == 3:
            mask = mask[..., None]
        w = (mask > 0).float()
    if mask_as_weights:
        n = torch.full((), float(w.numel()), dtype=torch.float32, device=w.device)
        w_sum, n = psum(torch.stack([w.sum(), n]))
        w = w / torch.clamp(w_sum / n, min=1e-6)

    se = (pred - target) ** 2 * w
    denom = torch.clamp(psum(w.sum()), min=1e-6)
    ch_losses = psum(se.sum(dim=(0, 1, 2))) / denom

    if band_weights is not None:
        bw = torch.as_tensor(band_weights, dtype=torch.float32, device=pred.device).reshape(C)
        total = (ch_losses * bw).sum() / torch.clamp(bw.sum(), min=1e-6)
    else:
        total = ch_losses.mean()
    return total, ch_losses
