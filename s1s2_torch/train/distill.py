"""Progressive step distillation (Salimans & Ho, 2022) for the anchored-DDIM
sampler, and endpoint distillation of a one-step student.

Port of the JAX package's ``train/distill.py``. A student trained so that
ONE deterministic DDIM step reproduces TWO teacher steps halves the
sampler's UNet calls per phase, down to a one-step ε model that
``ddim_anchored(..., steps=1)`` drives unchanged; endpoint distillation
then regresses that student straight onto a teacher's multi-step output.

Teacher and student take different paths. The student trains through
``UNetSmall(autograd=True)`` with the train step's machinery (flat f32
params, Adam moments and EMA in ``train/loop.TrainState``,
``functional_call``, ``guarded_update``: a non-finite batch makes no update
and counts the skip on the device). The teacher is frozen, so every teacher
forward (the progressive step's two steps, the endpoint rollouts) runs
through the inference ``UNetSmall``, whose 3×3 convs are the hand-written
kernel on the card (bf16 only; f32 is the CPU's parity mode) and their plain
versions on the CPU. Each progressive phase rebuilds that teacher from the
previous phase's debiased EMA.

Draws. The progressive step splits ``fold_in(key, step)`` into the keys of
the grid segments and the noise, as in JAX: ``draws="threefry"`` draws
jax's own bits on the host (``core/random.py``); ``draws="device"`` draws
them on the card from a ``torch.Generator`` seeded each step with
``train/loop.step_seed(key, step)``; ``"auto"`` is threefry on the CPU and
the card's generator on a card. The endpoint targets' noise
(``normal(PRNGKey(50_000 + seed + s))``) and the batch order
(``default_rng(seed).permutation``) are the reference's bits everywhere.

No step reads a value back to the host. The epoch loops keep each epoch's sum
of finite losses and their count on the device, and read them only when a
progress record is due; ``debiased_ema`` reads ``step`` and ``skipped`` at
the end and at each snapshot. The JAX functions' ``mesh`` (multi-chip) path
is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from s1s2_torch.core import random
from s1s2_torch.core.parametrize import (Parameterization, pred_to_x0_eps, q_sample, snr,
                                         x0_from_eps)
from s1s2_torch.core.schedule import Schedule
from s1s2_torch.models.unet import UNetSmall
from s1s2_torch.sampling.grids import linspace_grid, round_unique_grid
from s1s2_torch.train.loop import (Optimizer, ParamLayout, StepDraws, TrainConfig,
                                   TrainState, create_train_state, guarded_update, upload)
from s1s2_torch.train.trainer import resolve_device

Params = Dict[str, torch.Tensor]
MESH_NOT_PORTED = ("a device mesh (multi-chip distillation) is not ported yet "
                   "(ROADMAP §1 item 7, 7c)")


# ---------------------------------------------------------------------------
# grids + target algebra
# ---------------------------------------------------------------------------


def distill_grids(t_start: int, student_steps: int, T: int) -> Tuple[np.ndarray, np.ndarray]:
    """(student_grid, teacher_grid): the teacher grid is the 2× refinement of
    the student's descending linspace grid, and the student grid is taken
    from its even points, so the two always align."""
    tg = linspace_grid(t_start, 2 * student_steps, T)
    if np.any(np.diff(tg) >= 0):
        raise ValueError(
            f"degenerate distill grid for t_start={t_start}, "
            f"student_steps={student_steps}: the 2x teacher grid {tg} has "
            "repeated/non-decreasing timesteps, which makes the one-step "
            "inversion ill-conditioned (its denominator ~1e-9 stays finite, "
            "silently poisoning targets). Use student_steps <= t_start/2.")
    return tg[::2].copy(), tg


def ddim_step_exact(x_t, eps, sab_cur, s1mab_cur, sab_next, s1mab_next):
    """One anchored-DDIM update, the sampler's own arithmetic: x0̂ through
    the guarded divide, then re-noised to the next grid point. → (x_next,
    x0̂); per-sample (B,) coefficients or scalars."""
    x0_hat = x0_from_eps(x_t, eps, sab_cur, s1mab_cur)
    return q_sample(x0_hat, eps, sab_next, s1mab_next), x0_hat


def _bc(c, like: torch.Tensor) -> torch.Tensor:
    c = torch.as_tensor(c, dtype=torch.float32, device=like.device)
    return c.reshape(c.shape + (1,) * (like.dim() - c.dim()))


def invert_ddim_step(x_t, x_next, sab_cur, s1mab_cur, sab_next, s1mab_next):
    """The (ε, x0) that ONE anchored-DDIM update would need to map x_t to
    x_next, in f32, inverting :func:`ddim_step_exact` with its √(ᾱ+1e-8)
    guard: x_next = (√ᾱ_n/g)·x_t + (√(1−ᾱ_n) − √ᾱ_n·√(1−ᾱ_t)/g)·ε,
    g = √(ᾱ_t + 1e-8)."""
    x_t, x_next = x_t.float(), x_next.float()
    sc = _bc(sab_cur, x_t)
    g = torch.sqrt(sc * sc + 1e-8)
    a = _bc(sab_next, x_t) / g
    denom = _bc(s1mab_next, x_t) - a * _bc(s1mab_cur, x_t)
    eps_tgt = (x_next - a * x_t) / denom
    x0_tgt = (x_t - _bc(s1mab_cur, x_t) * eps_tgt) / g
    return eps_tgt, x0_tgt


# ---------------------------------------------------------------------------
# config / state
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    """Hyperparameters of one distillation run (the JAX package's)."""

    T: int = 1000
    t_start: int = 200          # top of the sampling grid being distilled
    teacher_steps: int = 16     # starting sampler budget (halved per phase)
    final_steps: int = 1
    epochs_per_phase: int = 4
    lr: float = 1e-4
    weight_decay: float = 1e-4
    grad_clip: float = 0.5
    ema_decay: float = 0.999
    teacher_param: str = "eps"  # what the INITIAL teacher predicts
    mask_as_weights: bool = False

    def phase_steps(self) -> Tuple[int, ...]:
        """Student budgets per phase: teacher_steps/2, /4, …, final_steps."""
        out, s = [], self.teacher_steps
        while s > self.final_steps:
            s //= 2
            out.append(max(s, self.final_steps))
        return tuple(out)


def _train_config(cfg: DistillConfig) -> TrainConfig:
    return TrainConfig(T=cfg.T, lr=cfg.lr, weight_decay=cfg.weight_decay,
                       grad_clip=cfg.grad_clip, ema_decay=cfg.ema_decay)


def make_distill_optimizer(cfg: DistillConfig) -> Optimizer:
    """optax's ``clip_by_global_norm(grad_clip)`` → ``adamw(lr,
    weight_decay)`` at a constant LR; ``grad_clip <= 0`` means no clip."""
    return Optimizer(_train_config(cfg))


def debiased_ema(state: TrainState, init_params, decay: float) -> Params:
    """The EMA read-out that corrects the init's weight on short runs.

    A distill EMA starts from the phase's init, so after n applied updates
    it still holds decay**n of it: ema_n = decay**n·init + (1 −
    decay**n)·<trajectory average>, and subtracting the known init part
    debiases it exactly. For decay**n ≤ 0.05 the EMA is returned as it is;
    for decay**n ≥ 0.9 the trained params (an EMA that short is mostly its
    init). n counts APPLIED updates, step − skipped: a skipped step leaves
    the EMA alone. ``init_params``: a state dict or the state's flat layout.
    Reads ``skipped`` from the device. → a state dict (views of one flat
    tensor)."""
    n = int(state.step) - int(state.skipped)
    w = float(decay) ** max(n, 0)
    if w >= 0.9:
        flat = state.params
    elif w <= 0.05:
        flat = state.ema_params
    else:
        init = (init_params if torch.is_tensor(init_params)
                else state.layout.flatten(init_params, state.params.device))
        flat = (state.ema_params - w * init) / (1.0 - w)
    return state.layout.unflatten(flat)


def create_distill_state(params: Params, cfg: DistillConfig, device=None) -> TrainState:
    """A student state initialised FROM ``params`` (the paper's init; also
    how each phase chains into the next), on ``device``."""
    return create_train_state(params, _train_config(cfg), device)


def training_net(model: UNetSmall) -> UNetSmall:
    """``model`` if it is on the training path, else a
    ``UNetSmall(autograd=True)`` of its architecture."""
    if model.autograd:
        return model
    return UNetSmall(model.out_ch, model.base_ch, model.stem_s2d, model.in_ch,
                     model.compute_dtype, autograd=True)


def inference_net(model: UNetSmall, params: Params, device) -> UNetSmall:
    """The inference UNetSmall (the hand-written conv on the card) of
    ``model``'s architecture, holding ``params``, on ``device``."""
    net = UNetSmall(model.out_ch, model.base_ch, model.stem_s2d, model.in_ch,
                    model.compute_dtype).to(device)
    net.load_state_dict(params, strict=True)
    return net


class _LossSum:
    """An epoch's sum of finite losses (float64, the order JAX's host sum
    takes) and their count, kept on the device."""

    def __init__(self, device: torch.device):
        self.total = torch.zeros((), dtype=torch.float64, device=device)
        self.n = torch.zeros((), dtype=torch.int64, device=device)

    def add(self, loss: torch.Tensor) -> None:
        finite = torch.isfinite(loss)
        self.total += torch.where(finite, loss.double(), 0.0)
        self.n += finite.long()

    def mean(self) -> float:
        """Read back: the running mean as the JAX package prints it."""
        return float(self.total) / max(1, int(self.n))


def _masks(mask: torch.Tensor, mask_as_weights: bool) -> torch.Tensor:
    m = mask[..., None].float()
    if mask_as_weights:
        return m / torch.clamp(m.mean(), min=1e-6)
    return (m > 0).float()


# ---------------------------------------------------------------------------
# the progressive step
# ---------------------------------------------------------------------------


class DistillStep(StepDraws):
    """``step(state, teacher, batch, key) → (state, metrics)``, distilling a
    2·student_steps teacher into a student_steps ε-student.

    Per batch sample: draw a grid segment i, build x_t at grid[i] by forward
    diffusion of the data x0, roll the frozen ``teacher`` (an inference
    ``UNetSmall``) TWO sampler steps to grid[i+1], invert the one-step update
    for the ε the student must emit, and take a masked truncated-SNR x0-MSE
    gradient step (w = max(SNR(t), 1)) through ``model``, a
    ``UNetSmall(autograd=True)``. batch = (cond, x0, mask), numpy arrays or
    tensors. metrics: ``loss`` (NaN when skipped), ``ch_losses``,
    ``eps_mse``, ``skipped``, tensors on the state's device."""

    def __init__(self, model: UNetSmall, schedule: Schedule, cfg: DistillConfig,
                 student_steps: int, teacher_param: Optional[str] = None, draws: str = "auto"):
        if not getattr(model, "autograd", False):
            raise ValueError("the student trains on UNetSmall(autograd=True)")
        super().__init__(draws)
        self.model, self.cfg = model, cfg
        self.opt = make_distill_optimizer(cfg)
        self.t_param = Parameterization(teacher_param or cfg.teacher_param)
        sg, tg = distill_grids(cfg.t_start, student_steps, cfg.T)
        self.N = student_steps
        ab = schedule.alpha_bar_np().astype(np.float64)
        f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
        # (t_cur, t_mid, √ᾱ/√(1−ᾱ) at cur, mid and next, ᾱ_cur), one entry a segment
        self._host = (sg[:-1].astype(np.int32), tg[1::2].astype(np.int32),
                      *(f32(np.sqrt(v)) for idx in (sg[:-1], tg[1::2], sg[1:])
                        for v in (ab[idx], 1.0 - ab[idx])),
                      f32(ab[sg[:-1]]))
        self._tables: Dict[torch.device, tuple] = {}

    def tables(self, device: torch.device):
        if device not in self._tables:
            self._tables[device] = tuple(upload(a, device) for a in self._host)
        return self._tables[device]

    def draw(self, key, step: int, B: int, shape, device: torch.device):
        """(i (B,) int64 grid segments, noise f32 of ``shape``) of ``step``."""
        if self.threefry(device):
            k_i, k_noise = random.split(random.fold_in(key, step))
            i = random.randint(k_i, (B,), 0, self.N)
            noise = random.normal(k_noise, tuple(shape))
            return upload(i, device).long(), upload(noise, device)
        gen = self.generator(key, step, device)
        i = torch.randint(0, self.N, (B,), generator=gen, device=device)
        return i, torch.randn(tuple(shape), generator=gen, device=device)

    def teacher_two_steps(self, teacher, cond, x_t, t_cur, t_mid, coefs):
        sab_c, s1mab_c, sab_m, s1mab_m, sab_n, s1mab_n = coefs
        with torch.no_grad():
            pred1 = teacher(torch.cat([x_t, cond], dim=-1), t_cur)
            x0_1, eps1 = pred_to_x0_eps(self.t_param, x_t, pred1, sab_c, s1mab_c)
            x_mid = q_sample(x0_1, eps1, sab_m, s1mab_m)
            pred2 = teacher(torch.cat([x_mid, cond], dim=-1), t_mid)
            x0_2, eps2 = pred_to_x0_eps(self.t_param, x_mid, pred2, sab_m, s1mab_m)
            return q_sample(x0_2, eps2, sab_n, s1mab_n)

    def loss_and_grads(self, params: torch.Tensor, layout: ParamLayout, teacher, cond, x0,
                       mask, i, noise):
        """→ (loss, ch_losses, eps_mse, grads) of flat ``params`` on one batch."""
        t_cur_tab, t_mid_tab, *coef_tabs, ab_cur_tab = self.tables(params.device)
        t_cur, t_mid = t_cur_tab[i], t_mid_tab[i]
        coefs = tuple(t[i] for t in coef_tabs)
        sab_c, s1mab_c, sab_n, s1mab_n = coefs[0], coefs[1], coefs[4], coefs[5]
        x_t = q_sample(x0, noise, sab_c, s1mab_c)
        x_next = self.teacher_two_steps(teacher, cond, x_t, t_cur, t_mid, coefs)
        eps_tgt, x0_tgt = invert_ddim_step(x_t, x_next, sab_c, s1mab_c, sab_n, s1mab_n)

        flat = params.detach().requires_grad_(True)
        pred = functional_call(self.model, layout.unflatten(flat),
                               (torch.cat([x_t, cond], dim=-1), t_cur))
        x0_pred, eps_pred = pred_to_x0_eps(Parameterization.EPS, x_t, pred, sab_c, s1mab_c)
        w = torch.clamp(snr(ab_cur_tab[i]), min=1.0)  # (B,)
        m = _masks(mask, self.cfg.mask_as_weights)  # (B,H,W,1)
        C = x0.shape[-1]
        err2 = m * (x0_pred - x0_tgt) ** 2
        denom = torch.clamp(m.sum(dim=(1, 2, 3)), min=1e-6) * C
        loss = (w * (err2.sum(dim=(1, 2, 3)) / denom)).mean()
        ch = err2.detach().sum(dim=(0, 1, 2)) / torch.clamp(m.sum(), min=1e-6)
        eps_mse = (m * (eps_pred.detach() - eps_tgt) ** 2).sum() / torch.clamp(m.sum() * C,
                                                                                 min=1e-6)
        grads, = torch.autograd.grad(loss, flat)
        return loss.detach(), ch, eps_mse, grads

    def __call__(self, state: TrainState, teacher, batch, key):
        device = state.params.device
        cond, x0, mask = (upload(a, device).float() for a in batch)
        i, noise = self.draw(key, state.step, x0.shape[0], x0.shape, device)
        loss, ch, eps_mse, grads = self.loss_and_grads(state.params, state.layout, teacher,
                                                       cond, x0, mask, i, noise)
        finite_in = torch.isfinite(cond).all() & torch.isfinite(x0).all()
        new_state, ok = guarded_update(state, self.opt, grads, loss, self.cfg.ema_decay,
                                       inputs_finite=finite_in)
        return new_state, {"loss": torch.where(ok, loss, torch.full_like(loss, float("nan"))),
                           "ch_losses": ch, "eps_mse": eps_mse, "skipped": new_state.skipped}


def make_distill_step(model: UNetSmall, schedule: Schedule, cfg: DistillConfig,
                      student_steps: int, teacher_param: Optional[str] = None,
                      draws: str = "auto") -> DistillStep:
    """The progressive step of ``model`` (a ``UNetSmall(autograd=True)``);
    see :class:`DistillStep` and the module docstring for ``draws``."""
    return DistillStep(model, schedule, cfg, student_steps, teacher_param, draws)


# ---------------------------------------------------------------------------
# endpoint distillation (single-t trajectory-endpoint regression)
# ---------------------------------------------------------------------------


class EndpointStep:
    """``step(state, batch, key=None) → (state, metrics)`` of ENDPOINT
    distillation: the student (``model``, a ``UNetSmall(autograd=True)``),
    queried once at t = cfg.t_start, regresses onto a precomputed teacher
    full-chain output. batch = (cond, x0, mask, noise, x0_teacher): the same
    ``noise`` made the teacher rollout's init and makes the student's input.

    The regression runs in the head's own space: "eps" inverts the one-step
    DDIM update for the ε whose x0̂ is the teacher endpoint (for t_start=200
    the x0 loss times the constant ᾱ), "v" inverts x0̂ = √ᾱ·x_t − √(1−ᾱ)·v,
    which stays O(1)-conditioned at t≈T where the ε readout divides by
    √ᾱ ≈ 1e-4. ``pure_noise_init`` takes each family's pure-generation init
    (x_t = noise for ε, √(1−ᾱ)·noise for v) instead of ``q_sample(x0,
    noise)``; ``spectral_w`` adds ``w·mean(1 − cos(x0_pred, x0_tgt))`` over
    the masked pixels. metrics: ``loss`` (NaN when skipped), ``ch_losses``,
    ``skipped``."""

    def __init__(self, model: UNetSmall, schedule: Schedule, cfg: DistillConfig,
                 pure_noise_init: bool = False, spectral_w: float = 0.0,
                 student_param: str = "eps"):
        if not getattr(model, "autograd", False):
            raise ValueError("the student trains on UNetSmall(autograd=True)")
        self.model, self.cfg = model, cfg
        self.pure_noise_init, self.spectral_w = pure_noise_init, float(spectral_w)
        self.opt = make_distill_optimizer(cfg)
        self.t_start = int(cfg.t_start)
        ab = float(schedule.alpha_bar_np()[min(self.t_start, cfg.T - 1)])
        # f32 constants, as the JAX step holds them
        self.sab = float(np.float32(np.sqrt(ab)))
        self.s1mab = float(np.float32(np.sqrt(1.0 - ab)))
        self.g_guard = float(np.float32(np.sqrt(ab + 1e-8)))
        self.s_par = Parameterization(student_param)

    def loss_and_grads(self, params: torch.Tensor, layout: ParamLayout, cond, x0, mask, noise,
                       x0_tgt):
        """→ (loss, ch_losses, grads) of flat ``params`` on one batch."""
        eps_head = self.s_par is Parameterization.EPS
        sab, s1mab, g = self.sab, self.s1mab, self.g_guard
        B = x0.shape[0]
        if self.pure_noise_init:
            x_t = noise if eps_head else noise * s1mab
        else:  # q_sample's arithmetic, the scalars kept on the host
            x_t = sab * x0 + s1mab * noise
        flat = params.detach().requires_grad_(True)
        t = torch.full((B,), self.t_start, dtype=torch.int32, device=x0.device)
        pred = functional_call(self.model, layout.unflatten(flat),
                               (torch.cat([x_t, cond], dim=-1), t))
        pred_req = (x_t - g * x0_tgt) / s1mab if eps_head else (sab * x_t - x0_tgt) / s1mab
        m = _masks(mask, self.cfg.mask_as_weights)
        err2 = m * (pred - pred_req) ** 2
        loss = err2.sum() / torch.clamp(m.sum() * x0.shape[-1], min=1e-6)
        if self.spectral_w > 0.0:
            x0_pred = (x_t - s1mab * pred) / g if eps_head else sab * x_t - s1mab * pred
            dot = (x0_pred * x0_tgt).sum(-1)
            nrm = (torch.clamp(torch.sqrt((x0_pred ** 2).sum(-1)), min=1e-6)
                   * torch.clamp(torch.sqrt((x0_tgt ** 2).sum(-1)), min=1e-6))
            cos = torch.clamp(dot / nrm, -1.0, 1.0)
            mm = m[..., 0]
            loss = loss + self.spectral_w * ((1.0 - cos) * mm).sum() / torch.clamp(
                mm.sum(), min=1e-6)
        ch = err2.detach().sum(dim=(0, 1, 2)) / torch.clamp(m.sum(), min=1e-6)
        grads, = torch.autograd.grad(loss, flat)
        return loss.detach(), ch, grads

    def __call__(self, state: TrainState, batch, key=None):
        device = state.params.device
        cond, x0, mask, noise, x0_tgt = (upload(a, device).float() for a in batch)
        loss, ch, grads = self.loss_and_grads(state.params, state.layout, cond, x0, mask,
                                              noise, x0_tgt)
        finite_in = (torch.isfinite(cond).all() & torch.isfinite(x0).all()
                     & torch.isfinite(x0_tgt).all())
        new_state, ok = guarded_update(state, self.opt, grads, loss, self.cfg.ema_decay,
                                       inputs_finite=finite_in)
        return new_state, {"loss": torch.where(ok, loss, torch.full_like(loss, float("nan"))),
                           "ch_losses": ch, "skipped": new_state.skipped}


def make_endpoint_distill_step(model: UNetSmall, schedule: Schedule, cfg: DistillConfig,
                               pure_noise_init: bool = False, spectral_w: float = 0.0,
                               student_param: str = "eps") -> EndpointStep:
    """The endpoint step of ``model`` (a ``UNetSmall(autograd=True)``); see
    :class:`EndpointStep`."""
    return EndpointStep(model, schedule, cfg, pure_noise_init, spectral_w, student_param)


def endpoint_targets(teacher: UNetSmall, schedule: Schedule, cfg: DistillConfig,
                     cond: torch.Tensor, x0: torch.Tensor, teacher_steps: int, n_seeds: int,
                     teacher_param, seed: int, rollout_chunk: int = 32, mode: str = "anchored",
                     guidance_scale: Optional[float] = None, host_store: bool = False):
    """The endpoint target set: for each of ``n_seeds`` draws
    ``normal(PRNGKey(50_000 + seed + s), x0.shape)`` (jax's bits, on the
    host), the teacher's ddim-``teacher_steps`` output from it, rolled in
    ``rollout_chunk`` patches through ``teacher`` (an inference net on
    cond's device). → (noise, targets), each (n_seeds·N, H, W, C), seed
    major: tensors on the device, or numpy arrays with ``host_store``."""
    from s1s2_torch.sampling.samplers import (ddim_anchored, ddim_generate, ddim_grid_sample,
                                              make_cfg_denoise_fn, make_denoise_fn)

    t_par = Parameterization(teacher_param)
    device, n_ds = x0.device, x0.shape[0]
    chunk = min(n_ds, max(1, rollout_chunk))
    if t_par is Parameterization.V:
        grid = round_unique_grid(cfg.t_start, teacher_steps, cfg.T)
        ab_k = float(schedule.alpha_bar_np()[int(grid[-1])])
        sab_k, s1mab_k = float(np.sqrt(ab_k)), float(np.sqrt(1.0 - ab_k))

    def roll_teacher(cond_c, x0_c, nz_c):
        if guidance_scale is not None and float(guidance_scale) != 1.0:
            fn_c = make_cfg_denoise_fn(teacher, cond_c, float(guidance_scale))
        else:
            fn_c = make_denoise_fn(teacher, cond_c)
        if mode == "puregen":
            if t_par is Parameterization.EPS:
                return ddim_generate(fn_c, tuple(x0_c.shape), schedule, cfg.t_start,
                                     teacher_steps, noise=nz_c)
            return ddim_grid_sample(fn_c, nz_c * float(np.float32(s1mab_k)), schedule, grid,
                                    t_par)
        if t_par is Parameterization.EPS:
            return ddim_anchored(fn_c, x0_c, schedule, cfg.t_start, teacher_steps, noise=nz_c)
        return ddim_grid_sample(fn_c, q_sample(x0_c, nz_c, sab_k, s1mab_k), schedule, grid,
                                t_par)

    ep_noise, ep_tgt = [], []
    for s in range(n_seeds):
        nz_h = random.normal(random.PRNGKey(50_000 + seed + s), tuple(x0.shape))
        nz = None if host_store else upload(nz_h, device)
        tgt_chunks = []
        for lo in range(0, n_ds, chunk):
            sl = slice(lo, min(lo + chunk, n_ds))
            t_c = roll_teacher(cond[sl], x0[sl],
                               upload(nz_h[sl], device) if host_store else nz[sl])
            tgt_chunks.append(t_c.cpu().numpy() if host_store else t_c)
        ep_noise.append(nz_h if host_store else nz)
        ep_tgt.append(np.concatenate(tgt_chunks) if host_store else torch.cat(tgt_chunks))
    cat = np.concatenate if host_store else torch.cat
    return cat(ep_noise), cat(ep_tgt)


def endpoint_distill(
    model: UNetSmall,
    schedule: Schedule,
    cfg: DistillConfig,
    student_params: Params,
    teacher_params: Params,
    cond,
    x0,
    mask,
    epochs: int,
    batch_size: int,
    teacher_steps: int = 20,
    n_seeds: int = 4,
    teacher_param: Optional[str] = None,
    progress: Optional[Callable[[dict], None]] = None,
    log_every: int = 25,
    seed: int = 11,
    rollout_chunk: int = 32,
    mode: str = "anchored",
    spectral_w: float = 0.0,
    student_param: str = "eps",
    guidance_scale: Optional[float] = None,
    student_model: Optional[UNetSmall] = None,
    snapshot_every: int = 0,
    snapshot_fn: Optional[Callable[[Params, int], None]] = None,
    mesh: Optional[Any] = None,
    device="cuda",
) -> Params:
    """Build the teacher's ddim-``teacher_steps`` endpoint targets under
    ``n_seeds`` stored noise draws, then fine-tune the (one-step) student on
    them with :class:`EndpointStep`. → the student's debiased EMA.

    ``model`` is a UNetSmall of the teacher's architecture: the teacher
    (``teacher_params``) rolls through its inference twin, and the student
    (``student_params``) trains on ``student_model``, a
    ``UNetSmall(autograd=True)`` that may differ in width and stem (width
    distillation; default: ``model``'s architecture). (cond, x0, mask) are
    the whole dataset, NHWC.

    ``mode="anchored"`` distills the GT-anchored reconstruction map
    (``ddim_anchored``), ``"puregen"`` the pure-generation map
    (``ddim_generate``, typically t_start=999). ε teachers roll the linspace
    DDIM, v teachers the round-unique grid (anchored init ``q_sample(x0,
    noise, K)``, pure-generation init ``√(1−ᾱ_K)·noise``); ``guidance_scale``
    (g ≠ 1) rolls the teacher with classifier-free guidance, so the student
    absorbs it. Rollouts run in ``rollout_chunk`` patches; the (noise,
    target) set stays on the device while 2·n_seeds·x0.nbytes ≤ 2 GiB, else
    on the host with each batch uploaded. Every epoch shuffles with
    ``default_rng(seed).permutation``; a progress record every ``log_every``
    epochs and at the last; ``snapshot_fn(debiased EMA, epoch)`` every
    ``snapshot_every`` epochs before the last.
    """
    if mesh is not None:
        raise NotImplementedError(MESH_NOT_PORTED)
    device = resolve_device(device, "distillation")
    t_par = Parameterization(teacher_param or cfg.teacher_param)
    if mode not in ("anchored", "puregen"):
        raise ValueError(f"unknown endpoint mode {mode!r}")
    if mode == "puregen" and t_par is not Parameterization.EPS and student_param != "v":
        raise ValueError("puregen endpoint targets from a v teacher need a "
                         "v student head (student_param='v'): the ε readout "
                         "x0̂ = (x_t − σε)/√ᾱ is ill-conditioned at t≈T")
    cond, x0, mask = (upload(a, device).float() for a in (cond, x0, mask))
    n_ds = x0.shape[0]
    host_store = 2 * n_seeds * x0.numel() * 4 > 2 << 30
    ep_noise, ep_tgt = endpoint_targets(
        inference_net(model, teacher_params, device), schedule, cfg, cond, x0, teacher_steps,
        n_seeds, t_par, seed, rollout_chunk, mode, guidance_scale, host_store)
    n_ep = ep_noise.shape[0]
    if n_ep < batch_size:
        batch_size = n_ep  # never run zero steps: a tiny target set is one batch

    step = make_endpoint_distill_step(student_model or training_net(model), schedule,
                                      cfg, pure_noise_init=(mode == "puregen"),
                                      spectral_w=spectral_w, student_param=student_param)
    state = create_distill_state(student_params, cfg, device)
    init = state.params
    rng = np.random.default_rng(seed)
    for ep in range(1, epochs + 1):
        order = rng.permutation(n_ep)
        order_d = upload(order, device)
        acc = _LossSum(device)
        for lo in range(0, n_ep - batch_size + 1, batch_size):
            idx = order_d[lo:lo + batch_size]
            idx_ds = idx % n_ds  # seed-tiled → the underlying patch
            if host_store:
                idx_h = order[lo:lo + batch_size]
                pair = (upload(ep_noise[idx_h], device), upload(ep_tgt[idx_h], device))
            else:
                pair = (ep_noise.index_select(0, idx), ep_tgt.index_select(0, idx))
            batch = (cond.index_select(0, idx_ds), x0.index_select(0, idx_ds),
                     mask.index_select(0, idx_ds)) + pair
            state, metrics = step(state, batch)
            acc.add(metrics["loss"])
        if progress and (ep % log_every == 0 or ep == epochs):
            progress({"endpoint_epoch": ep, "loss": acc.mean(), "skipped": int(state.skipped)})
        if (snapshot_fn is not None and snapshot_every > 0 and ep % snapshot_every == 0
                and ep < epochs):
            # a killed long run still leaves a usable student
            snapshot_fn(debiased_ema(state, init, cfg.ema_decay), ep)
    return debiased_ema(state, init, cfg.ema_decay)


# ---------------------------------------------------------------------------
# progressive distillation
# ---------------------------------------------------------------------------


def progressive_distill(
    model: UNetSmall,
    schedule: Schedule,
    cfg: DistillConfig,
    teacher_params: Params,
    batches: Callable[[int, int], Iterable],
    progress: Optional[Callable[[dict], None]] = None,
    mesh: Optional[Any] = None,
    device="cuda",
) -> dict:
    """Halve the sampler budget phase by phase: teacher_steps → … →
    final_steps. ``model`` is a UNetSmall of the teacher's (and student's)
    architecture; ``batches(phase, epoch)`` yields (cond, x0, mask) NHWC
    batches. Each phase's student starts from, and distills against, the
    previous phase's debiased EMA (the first from ``teacher_params``); from
    phase 1 on the teacher is ε, and its inference net is rebuilt at each
    phase boundary. A progress record every epoch. → {'params': the final
    student, 'phase_history': [...], 'steps': final_steps}."""
    if mesh is not None:
        raise NotImplementedError(MESH_NOT_PORTED)
    device = resolve_device(device, "distillation")
    student = training_net(model)
    params = teacher_params
    teacher = inference_net(model, params, device)
    t_param = cfg.teacher_param
    history = []
    for phase, s_steps in enumerate(cfg.phase_steps()):
        step_fn = make_distill_step(student, schedule, cfg, s_steps, teacher_param=t_param)
        state = create_distill_state(params, cfg, device)
        init = state.params
        key = random.PRNGKey(1000 + phase)
        losses = []
        for epoch in range(1, cfg.epochs_per_phase + 1):
            acc = _LossSum(device)
            for batch in batches(phase, epoch):
                state, metrics = step_fn(state, teacher, batch, key)
                acc.add(metrics["loss"])
            losses.append(acc.mean())
            if progress:
                progress({"phase": phase, "student_steps": s_steps, "epoch": epoch,
                          "loss": losses[-1], "skipped": int(state.skipped)})
        params = debiased_ema(state, init, cfg.ema_decay)
        teacher = inference_net(model, params, device)
        t_param = "eps"  # every student has the ε head
        history.append({"student_steps": s_steps, "epoch_loss": losses})
    return {"params": params, "phase_history": history,
            "steps": cfg.phase_steps()[-1] if history else cfg.teacher_steps}
