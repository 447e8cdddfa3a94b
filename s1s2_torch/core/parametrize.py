"""Forward diffusion and the ε → x0 conversion, in float32.

Port of the JAX package's ``core/parametrize.py`` (the ε parts the main path
uses). Coefficients are per-sample ``(B,)`` values or scalars, broadcast
against NHWC tensors ``(B, H, W, C)``.
"""

from __future__ import annotations

import torch


def _bcast(coef, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-sample (B,) coefficient (or a scalar) against a
    (B, ...) tensor, as float32 on its device."""
    coef = torch.as_tensor(coef, dtype=torch.float32, device=like.device)
    return coef.reshape(coef.shape + (1,) * (like.dim() - coef.dim()))


def q_sample(x0, noise, sqrt_ab, sqrt_1mab) -> torch.Tensor:
    """x_t = √ᾱ_t·x0 + √(1−ᾱ_t)·ε."""
    return _bcast(sqrt_ab, x0) * x0.float() + _bcast(sqrt_1mab, x0) * noise.float()


def x0_from_eps(x_t, eps, sqrt_ab, sqrt_1mab, eps_guard: float = 1e-8):
    """x0 = (x_t − √(1−ᾱ)·ε) / √(ᾱ + guard), ᾱ rebuilt from its square root."""
    a = _bcast(sqrt_ab, x_t)
    b = _bcast(sqrt_1mab, x_t)
    denom = torch.sqrt(a * a + eps_guard)
    return (x_t.float() - b * eps.float()) / denom
