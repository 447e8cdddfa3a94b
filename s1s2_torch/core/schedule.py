"""Diffusion beta schedules and derived tables.

Port of the JAX package's ``core/schedule.py``: the cosine and linear
schedules, any betas through ``from_betas`` and the ``make_schedule``
selector. Tables are generated in float64 on the host with numpy, then
stored as float32, so they are bit-equal to the reference tables.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def cosine_beta_schedule(T: int, s: float = 0.008) -> np.ndarray:
    """Nichol & Dhariwal cosine schedule, betas clipped to [1e-5, 0.999];
    float32 numpy array of length ``T``."""
    t = np.linspace(0.0, T, T + 1, dtype=np.float64)
    f = np.cos(((t / T + s) / (1.0 + s)) * math.pi / 2.0) ** 2
    alpha_bar = f / f[0]
    betas = 1.0 - (alpha_bar[1:] / alpha_bar[:-1])
    return np.clip(betas, 1e-5, 0.999).astype(np.float32)


def linear_beta_schedule(T: int, beta_start: float = 1e-4,
                         beta_end: float = 0.02) -> np.ndarray:
    """Ho et al. linear schedule: a float64 linspace, stored as float32."""
    return np.linspace(beta_start, beta_end, T, dtype=np.float64).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Immutable diffusion schedule tables: float32 CPU tensors of length
    ``T``. Samplers read them on the host; nothing here lives on a card."""

    T: int
    betas: torch.Tensor
    alphas: torch.Tensor
    alpha_bar: torch.Tensor
    sqrt_alpha_bar: torch.Tensor
    sqrt_one_minus_alpha_bar: torch.Tensor

    @classmethod
    def from_betas(cls, betas: np.ndarray) -> "Schedule":
        # cumulative product in float64, then float32 tables
        b64 = betas.astype(np.float64)
        alphas = 1.0 - b64
        alpha_bar = np.cumprod(alphas)

        def f32(a):
            return torch.from_numpy(np.asarray(a, dtype=np.float32))

        return cls(
            T=int(betas.shape[0]),
            betas=f32(betas),
            alphas=f32(alphas),
            alpha_bar=f32(alpha_bar),
            sqrt_alpha_bar=f32(np.sqrt(alpha_bar)),
            sqrt_one_minus_alpha_bar=f32(np.sqrt(1.0 - alpha_bar)),
        )

    @classmethod
    def cosine(cls, T: int = 1000, s: float = 0.008) -> "Schedule":
        return cls.from_betas(cosine_beta_schedule(T, s))

    @classmethod
    def linear(cls, T: int = 1000, beta_start: float = 1e-4,
               beta_end: float = 0.02) -> "Schedule":
        return cls.from_betas(linear_beta_schedule(T, beta_start, beta_end))

    def alpha_bar_np(self) -> np.ndarray:
        """float32 numpy copy of alpha_bar for host-side coefficient math."""
        return self.alpha_bar.numpy().copy()


def make_schedule(T: int = 1000, kind: str = "cosine", **kw) -> Schedule:
    """Schedule selector: ``kind`` is "cosine" or "linear"."""
    if kind == "cosine":
        return Schedule.cosine(T, **kw)
    if kind == "linear":
        return Schedule.linear(T, **kw)
    raise ValueError(f"unknown schedule kind: {kind!r} (expected cosine|linear)")
