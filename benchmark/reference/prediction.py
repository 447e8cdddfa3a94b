"""A network's prediction → (x0, ε) at one timestep, one function a
parameterization, named as the configurations name it (``prediction``).
``sab`` and ``s1m`` are √ᾱ and √(1−ᾱ) as float32 values."""

from __future__ import annotations

import torch


def eps(x_t: torch.Tensor, pred: torch.Tensor, sab: float, s1m: float):
    """ε prediction: x0 = (x_t − √(1−ᾱ)·ε̂) / √(ᾱ + 1e-8), ᾱ the square of
    √ᾱ."""
    den = torch.sqrt(torch.tensor(sab, device=x_t.device) ** 2 + 1e-8)
    return (x_t - s1m * pred) / den, pred


def v(x_t: torch.Tensor, pred: torch.Tensor, sab: float, s1m: float):
    """v prediction: x0 = √ᾱ·x_t − √(1−ᾱ)·v̂, ε = √(1−ᾱ)·x_t +
    √ᾱ·v̂."""
    return sab * x_t - s1m * pred, s1m * x_t + sab * pred
