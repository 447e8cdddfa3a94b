"""Diffusion parameterization algebra: ε / v / x0 conversions, in float32.

Port of the JAX package's ``core/parametrize.py``. Coefficients are
per-sample ``(B,)`` values or scalars, broadcast against NHWC tensors
``(B, H, W, C)``; every function computes in float32 whatever its input
dtype.
"""

from __future__ import annotations

import enum

import torch

from s1s2_torch.utils.profiling import spanned


class Parameterization(str, enum.Enum):
    """What the denoiser network predicts."""

    EPS = "eps"
    V = "v"


def _bcast(coef, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-sample (B,) coefficient (or a scalar) against a
    (B, ...) tensor, as float32 on its device."""
    coef = torch.as_tensor(coef, dtype=torch.float32, device=like.device)
    return coef.reshape(coef.shape + (1,) * (like.dim() - coef.dim()))


@spanned("q_sample")
def q_sample(x0, noise, sqrt_ab, sqrt_1mab) -> torch.Tensor:
    """x_t = √ᾱ_t·x0 + √(1−ᾱ_t)·ε."""
    return _bcast(sqrt_ab, x0) * x0.float() + _bcast(sqrt_1mab, x0) * noise.float()


def v_from_x0_eps(x0, eps, sqrt_ab, sqrt_1mab) -> torch.Tensor:
    """v = √ᾱ·ε − √(1−ᾱ)·x0."""
    return _bcast(sqrt_ab, eps) * eps.float() - _bcast(sqrt_1mab, x0) * x0.float()


def x0_eps_from_v(x_t, v, sqrt_ab, sqrt_1mab):
    """Invert the v system: x0 = √ᾱ·x_t − √(1−ᾱ)·v, ε = √(1−ᾱ)·x_t + √ᾱ·v."""
    a = _bcast(sqrt_ab, x_t)
    b = _bcast(sqrt_1mab, x_t)
    x_t, v = x_t.float(), v.float()
    return a * x_t - b * v, b * x_t + a * v


def x0_from_eps(x_t, eps, sqrt_ab, sqrt_1mab, eps_guard: float = 1e-8):
    """x0 = (x_t − √(1−ᾱ)·ε) / √(ᾱ + guard), ᾱ rebuilt from its square root."""
    a = _bcast(sqrt_ab, x_t)
    b = _bcast(sqrt_1mab, x_t)
    denom = torch.sqrt(a * a + eps_guard)
    return (x_t.float() - b * eps.float()) / denom


def eps_from_x0(x_t, x0, sqrt_ab, sqrt_1mab, eps_guard: float = 1e-8):
    """ε = (x_t − √ᾱ·x0) / √(1−ᾱ + guard)."""
    a = _bcast(sqrt_ab, x_t)
    b = _bcast(sqrt_1mab, x_t)
    denom = torch.sqrt(b * b + eps_guard)
    return (x_t.float() - a * x0.float()) / denom


def snr(alpha_bar_t, clamp_min: float = 1e-8) -> torch.Tensor:
    """Signal-to-noise ratio SNR(t) = ᾱ / max(1−ᾱ, clamp_min)."""
    ab = torch.as_tensor(alpha_bar_t, dtype=torch.float32)
    return ab / torch.clamp(1.0 - ab, min=clamp_min)


def p2_weight(alpha_bar_t, gamma: float = 1.0, k: float = 1e-3) -> torch.Tensor:
    """p2/SNR loss reweighting: w = (k + SNR)^(−γ)."""
    return torch.pow(k + snr(alpha_bar_t), -gamma)


def target_for(param: Parameterization, x0, noise, sqrt_ab, sqrt_1mab) -> torch.Tensor:
    """Training target for the chosen parameterization."""
    if Parameterization(param) is Parameterization.EPS:
        return noise.float()
    return v_from_x0_eps(x0, noise, sqrt_ab, sqrt_1mab)


def pred_to_x0_eps(param: Parameterization, x_t, pred, sqrt_ab, sqrt_1mab):
    """A network prediction → (x0̂, ε̂) under either parameterization."""
    if Parameterization(param) is Parameterization.EPS:
        return x0_from_eps(x_t, pred, sqrt_ab, sqrt_1mab), pred.float()
    return x0_eps_from_v(x_t, pred, sqrt_ab, sqrt_1mab)
