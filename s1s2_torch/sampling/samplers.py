"""Diffusion samplers (ε and v) and the classifier-free-guidance denoiser.

Port of the JAX package's ``sampling/samplers.py``. Each ``lax.scan``
becomes a Python loop over the steps, one denoiser call per step. The
per-step coefficients are computed on the host from ``alpha_bar`` in float64
and cast to float32, exactly as the JAX samplers compute them; the
arithmetic between denoiser calls is float32.

The GT-anchored and pure-generation DDIM (``ddim_anchored``,
``ddim_generate``) and the stride-1 chain of ``partial_ddim_from_gt`` run
each step's update through the fused DDIM kernel
(``ops/fused_elementwise.py``); the other samplers are plain PyTorch, as
their JAX versions are plain XLA.

JAX keys become ``torch.Generator``s. Where a JAX sampler draws noise from a
key, the port draws it with ``generator`` on the device of its inputs, or
takes it from ``noise`` (so a test can replay JAX's draws);
``ddim_grid_sample`` also takes a jax-layout key, or a (B, 2) batch of
per-file keys, and then draws the reference's own bits on the host
(``core/random.py``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from s1s2_torch.core import random
from s1s2_torch.core.parametrize import Parameterization, pred_to_x0_eps, q_sample
from s1s2_torch.core.schedule import Schedule
from s1s2_torch.ops.fused_elementwise import fused_ddim_update
from s1s2_torch.sampling.grids import clamp_t, linspace_grid

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def make_denoise_fn(model: Callable, cond: torch.Tensor) -> DenoiseFn:
    """Bind a model ``(x_and_cond, t) → pred`` and its conditioning into
    ``(x_t, t) → pred``; the concatenation order is [x_t, cond]."""
    cond = cond.float()

    def fn(x_t, t):
        with torch.no_grad():
            return model(torch.cat([x_t.float(), cond], dim=-1), t)

    return fn


def make_cfg_denoise_fn(model: Callable, cond: torch.Tensor, guidance_scale: float,
                        null_cond: Optional[torch.Tensor] = None) -> DenoiseFn:
    """Classifier-free guidance, ``pu + g·(pc − pu)``, with the cond and
    null-cond (zeros by default) passes stacked along the batch: one forward
    of 2B rows a step, not two."""
    if null_cond is None:
        null_cond = torch.zeros_like(cond)
    both = torch.cat([cond, null_cond], dim=0).float()
    g = float(guidance_scale)

    def fn(x_t, t):
        x2 = torch.cat([x_t, x_t], dim=0).float()
        with torch.no_grad():
            pred = model(torch.cat([x2, both], dim=-1), torch.cat([t, t], dim=0))
        pc, pu = torch.chunk(pred, 2, dim=0)
        return pu + g * (pc - pu)

    return fn


def _coef(schedule: Schedule, idx: np.ndarray) -> np.ndarray:
    """Float64 ᾱ values (of the float32 table) at integer timesteps."""
    return schedule.alpha_bar_np().astype(np.float64)[idx]


def _f32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def _t_vec(t: int, B: int, device) -> torch.Tensor:
    return torch.full((B,), int(t), dtype=torch.int32, device=device)


def _randn(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                       device=device)


def _device(device, noise: Optional[torch.Tensor],
            generator: Optional[torch.Generator]) -> torch.device:
    """Where a sampler without input tensors runs: ``device`` if given, else
    the device of ``noise`` or of ``generator``, else the card."""
    if device is not None:
        return torch.device(device)
    if noise is not None:
        return noise.device
    if generator is not None:
        return generator.device
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# ε-model, linspace convention (GT-anchored recon & pure generation)
# ---------------------------------------------------------------------------


def ddim_linspace_coefs(schedule: Schedule, t_start: int, steps: int):
    """(ts, s1m, sabg, sabn, s1mn): the descending grid and, per step, the
    four f32 coefficients of the update, from float64."""
    ts = linspace_grid(t_start, steps, schedule.T)
    a_cur = _coef(schedule, ts[:-1])
    a_next = _coef(schedule, ts[1:])
    return (ts, _f32(np.sqrt(1.0 - a_cur)), _f32(np.sqrt(a_cur + 1e-8)),
            _f32(np.sqrt(a_next)), _f32(np.sqrt(1.0 - a_next)))


def _ddim_linspace_scan(denoise_fn: DenoiseFn, x_init: torch.Tensor,
                        schedule: Schedule, t_start: int, steps: int,
                        clip: Tuple[float, float], return_traj: bool = False):
    """Iterate (t_cur → t_next) along the linspace grid and return the LAST
    x0̂ (not x_t), clamped; with ``return_traj=True`` the pair ``(x0̂, (ts,
    traj))`` of the int32 timesteps and the x_t states the denoiser saw
    (step-major), for rollout calibration."""
    ts, s1m, sabg, sabn, s1mn = ddim_linspace_coefs(schedule, t_start, steps)
    B = x_init.shape[0]
    x, x0_hat = x_init, x_init
    traj = []
    for i in range(len(ts) - 1):
        if return_traj:
            traj.append(x)
        eps = denoise_fn(x, _t_vec(ts[i], B, x.device)).float().contiguous()
        x0_hat, x = fused_ddim_update(x, eps, float(s1m[i]), float(sabg[i]),
                                      float(sabn[i]), float(s1mn[i]))
    out = torch.clamp(x0_hat, clip[0], clip[1])
    if return_traj:
        t_steps = torch.as_tensor(ts[:-1].astype(np.int32), device=out.device)
        return out, (t_steps, torch.stack(traj))
    return out


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
        noise = _randn(x_gt.shape, generator, x_gt.device)
    sab = torch.full((B,), float(schedule.sqrt_alpha_bar[t_start]))
    s1m = torch.full((B,), float(schedule.sqrt_one_minus_alpha_bar[t_start]))
    x_t = q_sample(x_gt, noise, sab, s1m).contiguous()
    return _ddim_linspace_scan(denoise_fn, x_t, schedule, t_start, steps, clip)


def ddim_generate(denoise_fn: DenoiseFn, shape: Tuple[int, ...], schedule: Schedule,
                  t_start: int = 200, steps: int = 20,
                  clip: Tuple[float, float] = (0.0, 1.0),
                  noise: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  device=None) -> torch.Tensor:
    """Pure generation (ε): x_t ~ N(0, I) at full scale (or the stored
    ``noise``), DDIM down the linspace grid, conditioned only through
    denoise_fn. Like the JAX sampler it does not clamp ``t_start`` itself;
    ``linspace_grid`` does."""
    dev = _device(device, noise, generator)
    x_t = (_randn(shape, generator, dev) if noise is None
           else noise.to(dev, torch.float32)).contiguous()
    return _ddim_linspace_scan(denoise_fn, x_t, schedule, t_start, steps, clip)


# ---------------------------------------------------------------------------
# round-unique grid convention (ε and v, deterministic or stochastic η)
# ---------------------------------------------------------------------------


def ddim_grid_sample(denoise_fn: DenoiseFn, x_init: torch.Tensor, schedule: Schedule,
                     grid: np.ndarray, param: Parameterization = Parameterization.V,
                     eta: float = 0.0, clip: Tuple[float, float] = (0.0, 1.0),
                     return_traj: bool = False,
                     noise: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     key: Optional[np.ndarray] = None,
                     batch_rows: Optional[Tuple[slice, int]] = None):
    """Descending sweep over an ascending unique grid; at the lowest grid
    point x_t ← x0̂. Returns that final array, clamped, or with
    ``return_traj=True`` the pair ``(x0, (t_cur, traj))`` of per-step int32
    timesteps and the x_t states the denoiser saw (step-major).

    η>0 adds the stochastic DDIM term σ·z with
    σ = η·√((1−ᾱ_prev)/(1−ᾱ_cur+1e-8)·max(0, 1−ᾱ_cur/ᾱ_prev)); the draws z
    come from ``noise`` of shape ``(len(grid),) + x_init.shape`` (replay);
    else from ``key`` as the JAX sampler draws them: a (2,) key is split
    into one key per step, each drawing the whole (B,H,W,C) batch, and a
    (B, 2) batch of per-file keys is split per file, so file b's step-i
    draw is ``normal(split(key[b], n)[i], (H,W,C))`` whatever the batch
    holds; else from ``generator`` on x_init's device. ``batch_rows =
    (rows, B)`` says that x_init holds the rows ``rows`` of a batch of B (a
    device mesh's share): a (2,) key then draws the whole batch's shape and
    takes those rows, so the draws are the whole batch's.
    """
    grid = np.asarray(grid, np.int64)
    n = len(grid)
    a = _coef(schedule, grid)  # ascending t, descending ᾱ
    order = np.arange(n - 1, -1, -1)
    t_cur = grid[order]
    a_cur = a[order]
    a_prev = np.where(order > 0, a[np.maximum(order - 1, 0)], 1.0)  # dummy at last
    sigma = float(eta) * np.sqrt(
        (1.0 - a_prev) / (1.0 - a_cur + 1e-8) * np.clip(1.0 - a_cur / a_prev, 0.0, None))
    dir_term = np.sqrt(np.clip((1.0 - a_prev) - sigma ** 2, 0.0, None))
    sab, s1m = _f32(np.sqrt(a_cur)), _f32(np.sqrt(1.0 - a_cur))
    sab_p, dirt, sig = _f32(np.sqrt(a_prev)), _f32(dir_term), _f32(sigma)
    if noise is not None and tuple(noise.shape) != (n,) + tuple(x_init.shape):
        raise ValueError(f"replay noise must be (len(grid),)+x_init.shape = "
                         f"{(n,) + tuple(x_init.shape)}, got {tuple(noise.shape)}")
    step_keys = None
    if noise is None and key is not None and eta > 0:
        key = random.as_key(key)
        if key.ndim == 2:  # (B, n, 2) → (n, B, 2): step-major, one stream per file
            step_keys = np.swapaxes(random.split(key, n), 0, 1)
        else:
            step_keys = random.split(key, n)
    param = Parameterization(param)
    B = x_init.shape[0]
    x_t = x_init.float()
    traj = []
    for i in range(n):
        if return_traj:
            traj.append(x_t)
        pred = denoise_fn(x_t, _t_vec(t_cur[i], B, x_t.device))
        x0_pred, eps_pred = pred_to_x0_eps(param, x_t, pred, float(sab[i]), float(s1m[i]))
        if i == n - 1:
            x_t = x0_pred
            break
        x_next = float(sab_p[i]) * x0_pred + float(dirt[i]) * eps_pred
        if eta > 0:
            if noise is not None:
                z = noise[i].to(x_t.device, torch.float32)
            elif step_keys is not None:
                shape = tuple(x_t.shape[1:]) if step_keys.ndim == 3 else tuple(x_t.shape)
                if batch_rows is not None and step_keys.ndim == 2:
                    shape = (batch_rows[1],) + shape[1:]
                z = random.normal(step_keys[i], shape)
                if batch_rows is not None and step_keys.ndim == 2:
                    z = z[batch_rows[0]]
                z = torch.from_numpy(np.ascontiguousarray(z)).to(x_t.device)
            else:
                z = _randn(x_t.shape, generator, x_t.device)
            x_next = x_next + float(sig[i]) * z
        x_t = x_next
    x_t = torch.clamp(x_t, clip[0], clip[1])
    if return_traj:
        t_steps = torch.as_tensor(t_cur.astype(np.int32), device=x_t.device)
        return x_t, (t_steps, torch.stack(traj))
    return x_t


def scaled_noise_init(shape: Tuple[int, ...], schedule: Schedule, t_start: int,
                      generator: Optional[torch.Generator] = None,
                      device=None) -> torch.Tensor:
    """x_t = randn·√(1−ᾱ_{t_start}), the scale rounded to f32 — the
    v-sampler's mean-free init."""
    a_t = float(schedule.alpha_bar_np()[clamp_t(t_start, schedule.T)])
    scale = float(np.float32(np.sqrt(1.0 - a_t)))
    return _randn(shape, generator, _device(device, None, generator)) * scale


# ---------------------------------------------------------------------------
# ancestral DDPM (all T steps)
# ---------------------------------------------------------------------------


def ddpm_ancestral(denoise_fn: DenoiseFn, shape: Tuple[int, ...], schedule: Schedule,
                   param: Parameterization = Parameterization.EPS,
                   clip: Tuple[float, float] = (0.0, 1.0),
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   device=None, key: Optional[np.ndarray] = None) -> torch.Tensor:
    """Full ancestral DDPM from pure noise, T model calls.

    ``noise`` (optional) replays an external draw stream: shape
    ``(T,) + shape``, ``noise[0]`` the pure-noise init and ``noise[j]``
    (j = 1..T−1) the draw after the mean of step j, at t = T−j; the step at
    t = 0 adds no noise. Else, with a jax-layout ``key``, the draws are the
    JAX sampler's: ``split(key, T + 1)``, the init from the first key and
    step j's draw from key j + 1, each the whole batch, on the host
    (``core/random.py``); else from ``generator``.
    """
    T = schedule.T
    betas = schedule.betas.numpy().astype(np.float64)
    alphas = 1.0 - betas
    ab = schedule.alpha_bar_np().astype(np.float64)
    order = np.arange(T - 1, -1, -1)
    if noise is not None and tuple(noise.shape) != (T,) + tuple(shape):
        raise ValueError(f"ddpm replay noise must be (T,)+shape = {(T,) + tuple(shape)}, "
                         f"got {tuple(noise.shape)}")
    dev = _device(device, noise, generator)
    inv_sa = _f32(1.0 / np.sqrt(alphas[order]))
    coef = _f32(betas[order] / np.sqrt(1.0 - ab[order] + 1e-8))
    sab, s1m = _f32(np.sqrt(ab[order])), _f32(np.sqrt(1.0 - ab[order]))
    scale = _f32(np.where(order > 0, np.sqrt(betas[order]), 0.0))
    param = Parameterization(param)
    keys = random.split(random.as_key(key), T + 1) if noise is None and key is not None else None

    def draw(j):  # the stream's j-th tensor: 0 the init, j the draw after step j-1
        if noise is not None:
            return noise[j].to(dev, torch.float32)
        if keys is not None:
            return torch.from_numpy(random.normal(keys[j], tuple(shape))).to(dev)
        return _randn(shape, generator, dev)

    x_t = draw(0)
    B = shape[0]
    for j, t in enumerate(order):
        pred = denoise_fn(x_t, _t_vec(t, B, dev))
        if param is Parameterization.EPS:
            eps = pred.float()
        else:
            _, eps = pred_to_x0_eps(param, x_t, pred, float(sab[j]), float(s1m[j]))
        mean = float(inv_sa[j]) * (x_t - float(coef[j]) * eps)
        if t == 0:
            x_t = mean
            break
        x_t = mean + float(scale[j]) * draw(j + 1)
    return torch.clamp(x_t, clip[0], clip[1])


# ---------------------------------------------------------------------------
# diagnostics
# ---------------------------------------------------------------------------


def partial_ddim_from_gt(denoise_fn: DenoiseFn, x_gt: torch.Tensor, schedule: Schedule,
                         k: int, clip: Tuple[float, float] = (0.0, 1.0),
                         noise: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Forward-diffuse GT to t=k, reverse k→0 with stride-1 deterministic
    DDIM; the result is the final x_t of that chain (not x0̂), clamped."""
    k = int(max(0, min(k, schedule.T - 1)))
    B = x_gt.shape[0]
    if noise is None:
        noise = _randn(x_gt.shape, generator, x_gt.device)
    sab = torch.full((B,), float(schedule.sqrt_alpha_bar[k]))
    s1m = torch.full((B,), float(schedule.sqrt_one_minus_alpha_bar[k]))
    x_t = q_sample(x_gt, noise, sab, s1m).contiguous()
    grid = np.arange(k, -1, -1)
    a_cur, a_next = _coef(schedule, grid[:-1]), _coef(schedule, grid[1:])
    s1mc, sabg = _f32(np.sqrt(1.0 - a_cur)), _f32(np.sqrt(a_cur + 1e-8))
    sabn, s1mn = _f32(np.sqrt(a_next)), _f32(np.sqrt(1.0 - a_next))
    for i in range(k):
        eps = denoise_fn(x_t, _t_vec(grid[i], B, x_t.device)).float().contiguous()
        _, x_t = fused_ddim_update(x_t, eps, float(s1mc[i]), float(sabg[i]),
                                   float(sabn[i]), float(s1mn[i]))
    return torch.clamp(x_t, clip[0], clip[1])


def one_step_recon(denoise_fn: DenoiseFn, x_gt: torch.Tensor, schedule: Schedule,
                   t_small: int = 20, param: Parameterization = Parameterization.EPS,
                   clip: Tuple[float, float] = (0.0, 1.0),
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Single-step x0 reconstruction at small t."""
    t_small = clamp_t(t_small, schedule.T)
    B = x_gt.shape[0]
    if noise is None:
        noise = _randn(x_gt.shape, generator, x_gt.device)
    sab = torch.full((B,), float(schedule.sqrt_alpha_bar[t_small]))
    s1m = torch.full((B,), float(schedule.sqrt_one_minus_alpha_bar[t_small]))
    x_t = q_sample(x_gt, noise, sab, s1m)
    pred = denoise_fn(x_t, _t_vec(t_small, B, x_gt.device))
    x0_hat, _ = pred_to_x0_eps(param, x_t, pred, sab, s1m)
    return torch.clamp(x0_hat, clip[0], clip[1])
