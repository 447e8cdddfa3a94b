"""DPM-Solver++(2M), the second-order multistep ODE sampler.

Port of the JAX package's ``sampling/dpm_solver.py``. With λ = log(α/σ),
α = √ᾱ, σ = √(1−ᾱ), a step s → t with h = λ_t − λ_s > 0 is

    first step:   x_t = (σ_t/σ_s)·x_s − α_t·(e^{−h}−1)·x0(x_s)
    later steps:  D   = (1 + 1/(2r))·x0(x_s) − 1/(2r)·x0_prev,  r = h_prev/h
                  x_t = (σ_t/σ_s)·x_s − α_t·(e^{−h}−1)·D

The per-step coefficients come from ``alpha_bar`` in float64 on the host and
are cast to float32, as the JAX sampler casts them; products of two
coefficients are taken in float32 on the host, in the order the JAX step
takes them. The ``lax.scan`` is a Python loop and the update is plain
float32 PyTorch (the JAX version has no Pallas kernel here either).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from s1s2_torch.core.parametrize import Parameterization, pred_to_x0_eps
from s1s2_torch.core.schedule import Schedule
from s1s2_torch.sampling.samplers import DenoiseFn
from s1s2_torch.utils.profiling import span, spanned


def dpm_coefs(schedule: Schedule, grid: np.ndarray):
    """Per-step f32 coefficients of the solve down ``grid`` (ascending):
    t_s, √ᾱ_s, √(1−ᾱ_s), σ_t/σ_s, α_t·φ (φ = e^{−h}−1, product in f32) and
    1/(2r), in step order (noisiest first)."""
    grid = np.asarray(grid, np.int64)
    ab = schedule.alpha_bar_np().astype(np.float64)[grid]
    alpha, sigma = np.sqrt(ab), np.sqrt(1.0 - ab)
    lam = np.log(np.clip(alpha, 1e-12, None)) - np.log(np.clip(sigma, 1e-12, None))
    order = np.arange(len(grid) - 1, 0, -1)  # step from grid[i] to grid[i-1]
    h = lam[order - 1] - lam[order]
    h_prev = np.concatenate([[h[0]], h[:-1]])
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    a_phi = f32(alpha[order - 1]) * f32(np.expm1(-h))
    return (grid[order], f32(np.sqrt(ab[order])), f32(np.sqrt(1.0 - ab[order])),
            f32(sigma[order - 1] / np.clip(sigma[order], 1e-12, None)), a_phi,
            f32(1.0 / (2.0 * (h_prev / h))))


@spanned("sampler.call")
def dpm_solver_2m(denoise_fn: DenoiseFn, x_init: torch.Tensor, schedule: Schedule,
                  grid: np.ndarray, param: Parameterization = Parameterization.EPS,
                  clip: Tuple[float, float] = (0.0, 1.0)) -> torch.Tensor:
    """Solve from grid[-1] (noisiest) down the ascending integer ``grid``;
    returns the final x0 prediction, clamped. ``x_init`` must be at the
    noise level of grid[-1]. Makes ``len(grid)`` denoiser calls: one per
    step and a last one at grid[0]."""
    grid = np.asarray(grid, np.int64)
    t_s, sab, s1m, sr, a_phi, inv2r = dpm_coefs(schedule, grid)
    param = Parameterization(param)
    B = x_init.shape[0]
    x_t, x0_prev = x_init.float(), None
    for i in range(len(t_s)):
        with span("sampler.step"):
            t = torch.full((B,), int(t_s[i]), dtype=torch.int32, device=x_t.device)
            x0, _ = pred_to_x0_eps(param, x_t, denoise_fn(x_t, t), float(sab[i]),
                                   float(s1m[i]))
            if x0_prev is None:
                d = x0
            else:
                w = np.float32(1.0) + inv2r[i]  # (1 + 1/2r) in f32
                d = float(w) * x0 - float(inv2r[i]) * x0_prev
            x_t, x0_prev = float(sr[i]) * x_t - float(a_phi[i]) * d, x0
    ab0 = float(schedule.alpha_bar_np().astype(np.float64)[grid[0]])
    with span("sampler.step"):
        t0 = torch.full((B,), int(grid[0]), dtype=torch.int32, device=x_t.device)
        x0, _ = pred_to_x0_eps(param, x_t, denoise_fn(x_t, t0), float(np.float32(np.sqrt(ab0))),
                               float(np.float32(np.sqrt(1.0 - ab0))))
    return torch.clamp(x0, clip[0], clip[1])
