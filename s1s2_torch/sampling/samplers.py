"""GT-anchored DDIM (ε, linspace grid) — the main path's sampler.

Port of ``_coef``, ``_ddim_linspace_scan`` and ``ddim_anchored`` of the JAX
package's ``sampling/samplers.py``. The scan becomes a Python loop over the
steps; each step is one denoiser call and one launch of the fused DDIM
update (``ops/fused_elementwise.py``). The per-step coefficients are
computed on the host from ``alpha_bar`` in float64 and cast to float32,
exactly as the JAX sampler computes them.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from s1s2_torch.core.parametrize import q_sample
from s1s2_torch.core.schedule import Schedule
from s1s2_torch.ops.fused_elementwise import fused_ddim_update
from s1s2_torch.sampling.grids import clamp_t, linspace_grid

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _coef(schedule: Schedule, idx: np.ndarray) -> np.ndarray:
    """Float64 ᾱ values (of the float32 table) at integer timesteps."""
    return schedule.alpha_bar_np().astype(np.float64)[idx]


def ddim_linspace_coefs(schedule: Schedule, t_start: int, steps: int):
    """(ts, s1m, sabg, sabn, s1mn): the descending grid and, per step, the
    four f32 coefficients of the update, from float64."""
    ts = linspace_grid(t_start, steps, schedule.T)
    a_cur = _coef(schedule, ts[:-1])
    a_next = _coef(schedule, ts[1:])
    f32 = lambda a: np.asarray(a, dtype=np.float32)  # noqa: E731
    return (ts, f32(np.sqrt(1.0 - a_cur)), f32(np.sqrt(a_cur + 1e-8)),
            f32(np.sqrt(a_next)), f32(np.sqrt(1.0 - a_next)))


def _ddim_linspace_scan(denoise_fn: DenoiseFn, x_init: torch.Tensor,
                        schedule: Schedule, t_start: int, steps: int,
                        clip: Tuple[float, float]) -> torch.Tensor:
    """Iterate (t_cur → t_next) along the linspace grid and return the LAST
    x0̂ (not x_t), clamped."""
    ts, s1m, sabg, sabn, s1mn = ddim_linspace_coefs(schedule, t_start, steps)
    B = x_init.shape[0]
    x, x0_hat = x_init, x_init
    for i in range(len(ts) - 1):
        t = torch.full((B,), int(ts[i]), dtype=torch.int32, device=x.device)
        eps = denoise_fn(x, t).float().contiguous()
        x0_hat, x = fused_ddim_update(x, eps, float(s1m[i]), float(sabg[i]),
                                      float(sabn[i]), float(s1mn[i]))
    return torch.clamp(x0_hat, clip[0], clip[1])


def ddim_anchored(denoise_fn: DenoiseFn, x_gt: torch.Tensor, schedule: Schedule,
                  t_start: int = 200, steps: int = 20,
                  clip: Tuple[float, float] = (0.0, 1.0),
                  noise: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """GT-anchored deterministic DDIM (ε): forward-diffuse GT to t_start with
    the f32 ``sqrt_alpha_bar`` tables, then denoise down the linspace grid.
    ``noise`` (B,H,W,C) may be given; otherwise it is drawn with
    ``generator`` on x_gt's device."""
    t_start = clamp_t(t_start, schedule.T)
    B = x_gt.shape[0]
    if noise is None:
        noise = torch.randn(x_gt.shape, generator=generator, dtype=torch.float32,
                            device=x_gt.device)
    sab = torch.full((B,), float(schedule.sqrt_alpha_bar[t_start]))
    s1m = torch.full((B,), float(schedule.sqrt_one_minus_alpha_bar[t_start]))
    x_t = q_sample(x_gt, noise, sab, s1m).contiguous()
    return _ddim_linspace_scan(denoise_fn, x_t, schedule, t_start, steps, clip)
