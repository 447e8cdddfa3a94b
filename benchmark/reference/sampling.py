"""The plain reference's schedule, grids and samplers.

Written from the samplers' equations, with nothing of the program: the
cosine schedule of Nichol & Dhariwal (s = 0.008, betas clipped to
[1e-5, 0.999], tables stored as float32), GT-anchored DDIM down a
truncating linspace grid, and DPM-Solver++(2M) down a round-unique grid.
Coefficients are worked out on the host in float64 and rounded to float32;
the arithmetic between denoiser calls is float32, one operation at a time.
A sampler turns the network's prediction into (x0, ε) by the function of
``prediction.py`` that the configuration's ``prediction`` names.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from benchmark.reference import prediction as predictions

Denoise = Callable[[torch.Tensor, int], torch.Tensor]


def cosine_alpha_bar(T: int = 1000, s: float = 0.008) -> np.ndarray:
    """ᾱ in float64: betas from the cosine curve in float64, clipped and
    stored in float32, then their cumulative product in float64. The
    schedule's table is this rounded to float32; √ᾱ of the forward
    diffusion is taken from the float64 values."""
    t = np.linspace(0.0, T, T + 1, dtype=np.float64)
    f = np.cos(((t / T + s) / (1.0 + s)) * math.pi / 2.0) ** 2
    f = f / f[0]
    betas = np.clip(1.0 - f[1:] / f[:-1], 1e-5, 0.999).astype(np.float32)
    return np.cumprod(1.0 - betas.astype(np.float64))


def _f32(v) -> float:
    return float(np.float32(v))


def linspace_grid(t_start: int, steps: int, T: int) -> np.ndarray:
    t_start = max(1, min(int(t_start), T - 1))
    return np.linspace(float(t_start), 0.0, steps + 1).astype(np.int64)


def round_unique_grid(t_hi: int, steps: int, T: int) -> np.ndarray:
    t_hi = max(1, min(int(t_hi), T - 1))
    g = np.unique(np.round(np.linspace(0.0, float(t_hi), steps)).astype(np.int64))
    if g[-1] != t_hi:
        g = np.unique(np.append(g, t_hi))
    return g


def q_sample(x0: torch.Tensor, noise: torch.Tensor, sab: float, s1m: float) -> torch.Tensor:
    return sab * x0 + s1m * noise


def ddim_anchored(denoise: Denoise, gt: torch.Tensor, noise: torch.Tensor,
                  ab64: np.ndarray, t_start: int, steps: int,
                  prediction: str = "eps") -> torch.Tensor:
    """Forward-diffuse gt to t_start (√ᾱ from float64), DDIM down the
    linspace grid with coefficients from the float32 table, the last x0
    estimate clamped to [0, 1]."""
    to_x0_eps = getattr(predictions, prediction)
    T = len(ab64)
    ab = ab64.astype(np.float32)
    t_start = max(1, min(int(t_start), T - 1))
    x = q_sample(gt, noise, _f32(np.sqrt(ab64[t_start])), _f32(np.sqrt(1.0 - ab64[t_start])))
    ts = linspace_grid(t_start, steps, T)
    x0 = x
    for tc, tn in zip(ts[:-1], ts[1:]):
        a_c, a_n = np.float64(ab[tc]), np.float64(ab[tn])
        x0, eps = to_x0_eps(x, denoise(x, int(tc)), _f32(np.sqrt(a_c)), _f32(np.sqrt(1.0 - a_c)))
        x = _f32(np.sqrt(a_n)) * x0 + _f32(np.sqrt(1.0 - a_n)) * eps
    return x0.clamp(0.0, 1.0)


def dpm_solver_2m(denoise: Denoise, gt: torch.Tensor, noise: torch.Tensor,
                  ab64: np.ndarray, grid: np.ndarray, prediction: str = "eps") -> torch.Tensor:
    """x_K = q_sample(gt) at the grid's top K, then DPM-Solver++(2M) down
    the ascending grid with λ = log(α/σ); one denoiser call a step and a
    last one at grid[0]; the final x0 estimate clamped to [0, 1]."""
    to_x0_eps = getattr(predictions, prediction)
    grid = np.asarray(grid, np.int64)
    ab = ab64.astype(np.float32)
    a64 = ab.astype(np.float64)
    K = int(grid[-1])
    x = q_sample(gt, noise, float(np.sqrt(ab[K])), float(np.sqrt(np.float32(1.0) - ab[K])))
    alpha, sigma = np.sqrt(a64[grid]), np.sqrt(1.0 - a64[grid])
    lam = np.log(np.clip(alpha, 1e-12, None)) - np.log(np.clip(sigma, 1e-12, None))

    def x0_of(x, i):  # the x0 estimate at grid[i]
        return to_x0_eps(x, denoise(x, int(grid[i])), _f32(alpha[i]), _f32(sigma[i]))[0]

    x0_prev, h_prev = None, None
    for i in range(len(grid) - 1, 0, -1):  # grid[i] → grid[i-1]
        h = lam[i - 1] - lam[i]
        x0 = x0_of(x, i)
        if x0_prev is None:
            d, h_prev = x0, h
        else:
            inv2r = np.float32(1.0 / (2.0 * (h_prev / h)))
            d = float(np.float32(1.0) + inv2r) * x0 - float(inv2r) * x0_prev
        a_phi = np.float32(alpha[i - 1]) * np.float32(np.expm1(-h))
        x = _f32(sigma[i - 1] / max(sigma[i], 1e-12)) * x - float(a_phi) * d
        x0_prev, h_prev = x0, h
    return x0_of(x, 0).clamp(0.0, 1.0)
