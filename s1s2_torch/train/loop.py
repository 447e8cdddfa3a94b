"""The diffusion train step: q_sample → target → UNet forward and backward
→ masked loss (f32) → global-norm clip → AdamW → EMA lerp.

Port of the JAX package's ``train/loop.py``, for both of the reference's
trainers: the ε-trainer (uniform t, plain masked MSE against ε,
:meth:`TrainConfig.eps_reference`) and the v-trainer (ε or v, the
``uniform``/``high_only``/``mix_high`` t-samplers, p2/SNR weighting from
the batch mean, detached, and an auxiliary x0 loss), with optional CFG
cond dropout.

The step never reads a value back to the host. A batch whose inputs, loss
or gradients are not finite makes no update: :func:`guarded_update`
selects old against new with ``torch.where`` on the device and counts the
skip. The optimizer is written here on tensors, after optax's arithmetic
(``clip_by_global_norm`` → ``adamw``): ``torch.nn.utils.clip_grad_norm_``
divides by ‖g‖ + 1e-6 where optax adds nothing, and ``torch.optim.AdamW``
updates in place, where no selection can follow it. The parameters, the
Adam moments and the EMA live as flat f32 tensors (:class:`ParamLayout`
maps them to the model's names), so each optimizer op is one pass over
all parameters.

Draws. ``fold_in(key, step)`` is split into the keys of t, the noise and
the CFG drop, as in JAX. ``draws="threefry"`` draws jax's own bits on the
host (``core/random.py``), so t, noise and the drop equal JAX's;
``draws="device"`` draws them on the card with a ``torch.Generator``
seeded each step from the same ``fold_in(key, step)`` (see
:func:`step_seed`), which costs no host time and replays the same noise
when a run resumes. ``"auto"`` is threefry on the CPU and the card's
generator on a card.

The step runs on a device mesh (``parallel/mesh.py``; the ``mesh`` it is
built with, by default ``local_mesh()``, the 1×1×1 mesh of this process
alone, on which every collective is skipped). The batch a rank gets is its data rows, cut
to its space rows. The step draws for the global batch and shape and takes
this rank's block, so the noise is the unsharded step's; the loss takes its
sums and counts over the data and space axes (``parallel/comm.psum``), so it
is the global batch's loss on every rank; one ``all_reduce`` sums the flat
gradient over data×space (and a replicated leaf's over the model axis too:
the backward is seeded with loss/model, ``parallel/comm.gather_channels``);
the clip's norm adds the sharded leaves' squares over the model axis; and a
skip is decided by all ranks together, so no replica parts from the others.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from s1s2_torch.core import random
from s1s2_torch.core.parametrize import (Parameterization, p2_weight, pred_to_x0_eps,
                                         q_sample, target_for)
from s1s2_torch.core.schedule import Schedule
from s1s2_torch.parallel.comm import psum
from s1s2_torch.parallel.mesh import AXES, local_mesh, tp_sharded
from s1s2_torch.train.loss import masked_mse_per_channel

# ---------------------------------------------------------------------------
# timestep samplers
# ---------------------------------------------------------------------------


def _t_min(T: int, high_t_min_ratio: float) -> int:
    return int(max(1, min(T - 1, round(high_t_min_ratio * T))))


def sample_timesteps(key, T: int, B: int, mode: str = "uniform", high_t_frac: float = 0.5,
                     high_t_min_ratio: float = 0.6) -> np.ndarray:
    """uniform | high_only | mix_high, on jax's threefry bits → (B,) int32."""
    t_min = _t_min(T, high_t_min_ratio)
    k1, k2, k3 = random.split(key, 3)
    if mode == "uniform":
        return random.randint(k1, (B,), 0, T)
    if mode == "high_only":
        return random.randint(k1, (B,), t_min, T)
    if mode == "mix_high":
        hi = random.uniform(k3, (B,)) < np.float32(high_t_frac)
        return np.where(hi, random.randint(k1, (B,), t_min, T), random.randint(k2, (B,), 0, T))
    raise ValueError(f"Unknown t_sampler: {mode}")


def sample_timesteps_device(gen: torch.Generator, T: int, B: int, mode: str = "uniform",
                            high_t_frac: float = 0.5,
                            high_t_min_ratio: float = 0.6) -> torch.Tensor:
    """The same three samplers drawn with ``gen`` on its device → (B,) int32."""
    t_min = _t_min(T, high_t_min_ratio)
    kw = dict(generator=gen, device=gen.device, dtype=torch.int32)
    if mode == "uniform":
        return torch.randint(0, T, (B,), **kw)
    if mode == "high_only":
        return torch.randint(t_min, T, (B,), **kw)
    if mode == "mix_high":
        hi = torch.rand((B,), generator=gen, device=gen.device) < high_t_frac
        return torch.where(hi, torch.randint(t_min, T, (B,), **kw),
                           torch.randint(0, T, (B,), **kw))
    raise ValueError(f"Unknown t_sampler: {mode}")


def step_seed(key, step: int) -> int:
    """The card generator's seed for ``step``: the 64-bit value of
    ``fold_in(key, step)`` (the trainer's key is ``PRNGKey(seed + 1)``),
    high word first, masked to 63 bits. It depends only on the key and the
    step, so a resumed run replays an unbroken run's noise."""
    k = random.fold_in(key, step)
    return ((int(k[0]) << 32) | int(k[1])) & 0x7FFFFFFFFFFFFFFF


# ---------------------------------------------------------------------------
# config / state
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Static training hyperparameters (defaults: the reference CLI's)."""

    T: int = 1000
    lr: float = 1e-4
    weight_decay: float = 1e-4
    grad_clip: float = 0.5
    ema_decay: float = 0.999
    pred_param: str = "v"  # 'eps' | 'v'
    t_sampler: str = "mix_high"  # 'uniform' | 'high_only' | 'mix_high'
    high_t_frac: float = 0.5
    high_t_min_ratio: float = 0.6
    use_p2: bool = True
    p2_gamma: float = 1.0
    p2_k: float = 1e-3
    aux_x0_loss_w: float = 0.02
    mask_as_weights: bool = False
    band_weights: Optional[Tuple[float, ...]] = None
    cfg_drop_prob: float = 0.0  # classifier-free-guidance cond dropout
    # 'constant' | 'warmup_cosine' (linear warmup → cosine decay to 0)
    lr_schedule: str = "constant"
    warmup_steps: int = 100
    total_steps: int = 10_000  # decay horizon for warmup_cosine

    @classmethod
    def eps_reference(cls, **kw) -> "TrainConfig":
        """The ε-trainer's fixed behavior: uniform t, no p2, no aux loss,
        lr 1e-5."""
        base = dict(lr=1e-5, pred_param="eps", t_sampler="uniform", use_p2=False,
                    aux_x0_loss_w=0.0)
        base.update(kw)
        return cls(**base)


@dataclasses.dataclass(frozen=True)
class ParamLayout:
    """Names and shapes of a parameter tree, laid end to end in one flat
    f32 tensor in this order. ``sharded`` marks, leaf by leaf, the leaves of
    which a model axis keeps a slice here (the shapes are the slices'); empty
    when nothing is sharded."""

    names: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    sharded: Tuple[bool, ...] = ()

    @classmethod
    def of(cls, params: Dict[str, torch.Tensor]) -> "ParamLayout":
        return cls(tuple(params), tuple(tuple(p.shape) for p in params.values()))

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(math.prod(s) for s in self.shapes)

    def flatten(self, params: Dict[str, torch.Tensor], device=None) -> torch.Tensor:
        return torch.cat([params[n].detach().reshape(-1).to(device, torch.float32)
                          for n in self.names])

    def unflatten(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Views of ``flat`` under the layout's names (autograd sees one
        ``split``, whose backward is one concatenation)."""
        return {n: p.view(s) for n, p, s in zip(self.names, flat.split(self.sizes),
                                                  self.shapes)}

    def sharded_mask(self, device) -> torch.Tensor:
        """(numel,) bool: True over the elements of the sharded leaves."""
        return torch.cat([torch.full((n,), bool(f), device=device)
                          for n, f in zip(self.sizes, self.sharded)])


@dataclasses.dataclass
class AdamState:
    count: torch.Tensor  # () int32: updates applied (optax's count, also the LR schedule's)
    mu: torch.Tensor  # flat f32
    nu: torch.Tensor  # flat f32


@dataclasses.dataclass
class TrainState:
    """``step`` advances on every call whatever the data, so it is a host
    integer; everything that depends on the data is a tensor on the
    device. ``params`` and ``ema_params`` are flat (``layout``)."""

    step: int
    params: torch.Tensor
    opt_state: AdamState
    ema_params: torch.Tensor
    skipped: torch.Tensor  # () int32: non-finite batches skipped
    layout: ParamLayout

    def ema_tree(self, mesh=None) -> Dict[str, torch.Tensor]:
        """The EMA by name; a model-sharded state's is gathered whole (every
        rank of ``mesh``'s model group enters)."""
        if not any(self.layout.sharded):
            return self.layout.unflatten(self.ema_params)
        full, flat = gather_flat(self.ema_params, self.layout, mesh)
        return full.unflatten(flat)


# ---------------------------------------------------------------------------
# the optimizer: optax's clip_by_global_norm → adamw, on flat tensors
# ---------------------------------------------------------------------------

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


def clip_by_global_norm(g: torch.Tensor, max_norm: float, sq_norm=None) -> torch.Tensor:
    """``select(‖g‖ < max, g, g / ‖g‖ · max)``, nothing added to the norm;
    ``sq_norm(g)`` gives ‖g‖² (default Σg²; :func:`mesh_sq_norm` on a mesh)."""
    norm = torch.sqrt(sq_norm(g) if sq_norm is not None else (g * g).sum())
    return torch.where(norm < max_norm, g, (g / norm) * max_norm)


def mesh_sq_norm(g: torch.Tensor, layout: ParamLayout, mesh) -> torch.Tensor:
    """‖g‖² of the whole tree from this rank's flat gradient: the sharded
    leaves' squares summed over the model axis, each replicated leaf once."""
    if not any(layout.sharded):
        return (g * g).sum()
    sq = g * g
    mask = layout.sharded_mask(g.device)
    sharded = mesh.all_reduce_(torch.where(mask, sq, 0.0).sum(), ("model",))
    return sharded + torch.where(mask, 0.0, sq).sum()


def reduce_grads(g: torch.Tensor, layout: ParamLayout, mesh) -> torch.Tensor:
    """The ranks' gradient shares summed into the gradient, in place: every
    leaf over data×space, a replicated leaf also over the model axis."""
    mesh.all_reduce_(g, ("data", "space"))
    if any(layout.sharded):
        rep = torch.nonzero(~layout.sharded_mask(g.device)).reshape(-1)
        part = mesh.all_reduce_(g.index_select(0, rep), ("model",))
        g.index_copy_(0, rep, part)
    return g


def all_ranks(ok: torch.Tensor, mesh) -> torch.Tensor:
    """``ok`` on every rank of the mesh (a flag reduced over all its axes)."""
    bad = mesh.all_reduce_((~ok).to(torch.int32), AXES)
    return bad == 0


def warmup_cosine(count: torch.Tensor, peak: float, warmup_steps: int,
                  decay_steps: int) -> torch.Tensor:
    """``optax.warmup_cosine_decay_schedule(0, peak, warmup_steps,
    decay_steps)`` at an int32 ``count``, in f32: a linear ramp from 0 for
    ``warmup_steps``, then ``peak·½(1 + cos(π·min(c, D)/D))`` with
    c = count − warmup_steps and D = decay_steps − warmup_steps."""
    if warmup_steps > 0:
        frac = 1 - torch.clamp(count, 0, warmup_steps).float() / warmup_steps
        ramp = (0.0 - peak) * frac + peak
    else:  # optax's polynomial schedule with no transition is its init value
        ramp = torch.zeros((), dtype=torch.float32, device=count.device)
    span = float(decay_steps - warmup_steps)
    c = torch.clamp((count - warmup_steps).float(), max=span)
    cosine = peak * (0.5 * (1 + torch.cos(math.pi * c / span)))
    return torch.where(count < warmup_steps, ramp, cosine)


class Optimizer:
    """optax's ``chain(clip_by_global_norm(grad_clip), adamw(lr,
    weight_decay))`` with β 0.9/0.999 and eps 1e-8 outside the square root:
    ``mu = (1−β1)·g + β1·mu``, ``nu = (1−β2)·g² + β2·nu``, each bias-corrected
    by ``1 − β^count`` on the incremented count, ``u = mu_hat/(√nu_hat +
    eps) + wd·p``, ``p + (−lr)·u``; with ``warmup_cosine`` the LR is the
    schedule at the count before the increment."""

    def __init__(self, cfg: TrainConfig):
        if cfg.lr_schedule not in ("constant", "warmup_cosine"):
            raise ValueError(f"unknown lr_schedule: {cfg.lr_schedule!r}")
        self.cfg = cfg

    def init(self, params: torch.Tensor) -> AdamState:
        return AdamState(torch.zeros((), dtype=torch.int32, device=params.device),
                         torch.zeros_like(params), torch.zeros_like(params))

    def lr(self, count: torch.Tensor):
        cfg = self.cfg
        if cfg.lr_schedule == "constant":
            return cfg.lr
        return warmup_cosine(count, cfg.lr, cfg.warmup_steps,
                             max(cfg.total_steps, cfg.warmup_steps + 1))

    def update(self, g: torch.Tensor, opt: AdamState, params: torch.Tensor,
               sq_norm=None) -> Tuple[torch.Tensor, AdamState]:
        cfg = self.cfg
        if cfg.grad_clip and cfg.grad_clip > 0:
            g = clip_by_global_norm(g, cfg.grad_clip, sq_norm)
        mu = (1 - B1) * g + B1 * opt.mu
        nu = (1 - B2) * (g * g) + B2 * opt.nu
        count = opt.count + 1
        c = count.float()
        u = (mu / (1 - B1 ** c)) / (torch.sqrt(nu / (1 - B2 ** c)) + ADAM_EPS)
        u = u + cfg.weight_decay * params
        return params + (-self.lr(opt.count)) * u, AdamState(count, mu, nu)


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    return Optimizer(cfg)


def create_train_state(params: Dict[str, torch.Tensor], cfg: TrainConfig,
                       device=None) -> TrainState:
    """A fresh state on ``device`` holding a copy of ``params`` (a flat
    state dict, e.g. ``models.unet.init_params``): Adam's moments at zero,
    the EMA equal to the params."""
    layout = ParamLayout.of(params)
    flat = layout.flatten(params, device)
    return TrainState(step=0, params=flat, opt_state=make_optimizer(cfg).init(flat),
                      ema_params=flat.clone(),
                      skipped=torch.zeros((), dtype=torch.int32, device=flat.device),
                      layout=layout)


def guarded_update(state: TrainState, opt: Optimizer, grads: torch.Tensor,
                   loss: torch.Tensor, ema_decay: float, inputs_finite=True, mesh=None):
    """The optimizer update and the EMA lerp (``(1−d)·p + d·ema``), applied
    only when the inputs, the loss and the gradients are all finite (on every
    rank of ``mesh``, :func:`local_mesh` by default); else an on-device no-op
    that counts the skip. ``grads`` is this rank's share, summed here over
    the mesh. → ``(new_state, ok)``."""
    mesh = mesh or local_mesh()
    grads = reduce_grads(grads, state.layout, mesh)
    ok = all_ranks(torch.isfinite(grads).all() & torch.isfinite(loss) & inputs_finite, mesh)
    new_params, new_opt = opt.update(grads, state.opt_state, state.params,
                                     lambda g: mesh_sq_norm(g, state.layout, mesh))
    new_params = torch.where(ok, new_params, state.params)
    new_opt = AdamState(*(torch.where(ok, a, b) for a, b in (
        (new_opt.count, state.opt_state.count), (new_opt.mu, state.opt_state.mu),
        (new_opt.nu, state.opt_state.nu))))
    new_ema = torch.where(ok, (1.0 - ema_decay) * new_params + ema_decay * state.ema_params,
                          state.ema_params)
    new_state = TrainState(step=state.step + 1, params=new_params, opt_state=new_opt,
                           ema_params=new_ema, skipped=state.skipped + (~ok).to(torch.int32),
                           layout=state.layout)
    return new_state, ok


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def upload(a, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device`` without a host sync (pinned
    memory, asynchronous copy); a tensor already there is returned as is."""
    t = torch.as_tensor(a)
    if t.device == device:
        return t
    return t.pin_memory().to(device, non_blocking=True)


class StepDraws:
    """Where a step takes its per-step draws (see the module docstring):
    ``draws`` is ``"threefry"``, ``"device"`` or ``"auto"``. The train step
    and the progressive distillation step share it."""

    def __init__(self, draws: str):
        if draws not in ("auto", "threefry", "device"):
            raise ValueError(f"draws must be auto, threefry or device, got {draws!r}")
        self.draws = draws
        self._gens: Dict[torch.device, torch.Generator] = {}

    def threefry(self, device: torch.device) -> bool:
        return self.draws == "threefry" or (self.draws == "auto" and device.type == "cpu")

    def generator(self, key, step: int, device: torch.device) -> torch.Generator:
        """``device``'s generator (one kept per device), seeded for ``step``."""
        gen = self._gens.get(device)
        if gen is None:
            gen = self._gens[device] = torch.Generator(device=device)
        gen.manual_seed(step_seed(key, step))
        return gen


class TrainStep(StepDraws):
    """``step(state, batch, key) → (state, metrics)``; batch = (cond
    (B,H,W,Cc), x0 (B,H,W,Ct), mask (B,H,W) or None), numpy arrays or
    tensors; key a ``core.random`` key. ``model`` is a
    ``UNetSmall(autograd=True)``; the step differentiates the state's params
    through it with ``functional_call``. metrics: ``loss`` (NaN when the
    step was skipped), ``ch_losses``, ``p2_w``, ``skipped``, all tensors on
    the state's device."""

    def __init__(self, model, schedule: Schedule, cfg: TrainConfig, draws: str = "auto",
                 mesh=None):
        if not getattr(model, "autograd", False):
            raise ValueError("the train step needs the training path: UNetSmall(autograd=True)")
        super().__init__(draws)
        self.model, self.schedule, self.cfg = model, schedule, cfg
        self.mesh = mesh or local_mesh()
        self.opt = make_optimizer(cfg)
        self.param = Parameterization(cfg.pred_param)
        self._tables: Dict[torch.device, tuple] = {}

    def tables(self, device: torch.device):
        """(ᾱ, √ᾱ, √(1−ᾱ), band weights) on ``device``, uploaded once."""
        if device not in self._tables:
            s, bw = self.schedule, self.cfg.band_weights
            self._tables[device] = tuple(
                upload(a, device) for a in (s.alpha_bar, s.sqrt_alpha_bar,
                                            s.sqrt_one_minus_alpha_bar)) + (
                upload(np.asarray(bw, np.float32), device) if bw else None,)
        return self._tables[device]

    def draw(self, key, step: int, B: int, shape: Sequence[int], device: torch.device):
        """(t (B,) int32, noise f32 of ``shape``, keep (B,1,1,1) f32 or None)
        of ``step``, on ``device``."""
        cfg = self.cfg
        if self.threefry(device):
            k_t, k_noise, k_drop = random.split(random.fold_in(key, step), 3)
            t = sample_timesteps(k_t, cfg.T, B, cfg.t_sampler, cfg.high_t_frac,
                                 cfg.high_t_min_ratio)
            noise = random.normal(k_noise, tuple(shape))
            keep = ((random.uniform(k_drop, (B, 1, 1, 1)) >= np.float32(cfg.cfg_drop_prob))
                    .astype(np.float32) if cfg.cfg_drop_prob > 0.0 else None)
            return (upload(t, device), upload(noise, device),
                    None if keep is None else upload(keep, device))
        gen = self.generator(key, step, device)
        t = sample_timesteps_device(gen, cfg.T, B, cfg.t_sampler, cfg.high_t_frac,
                                    cfg.high_t_min_ratio)
        noise = torch.randn(tuple(shape), generator=gen, device=device)
        keep = ((torch.rand((B, 1, 1, 1), generator=gen, device=device) >= cfg.cfg_drop_prob)
                .float() if cfg.cfg_drop_prob > 0.0 else None)
        return t, noise, keep

    def p2(self, t: torch.Tensor) -> torch.Tensor:
        """The p2 weight of the batch: the mean over the global batch's t."""
        cfg = self.cfg
        if not cfg.use_p2:
            return torch.ones((), dtype=torch.float32, device=t.device)
        alpha_bar = self.tables(t.device)[0]
        return p2_weight(alpha_bar[t], cfg.p2_gamma, cfg.p2_k).mean().detach()

    def loss_and_grads(self, params: torch.Tensor, layout: ParamLayout, cond: torch.Tensor,
                       x0: torch.Tensor, mask: Optional[torch.Tensor], t: torch.Tensor,
                       noise: torch.Tensor, p2_w: Optional[torch.Tensor] = None):
        """→ (loss, ch_losses, p2_w, grads): the loss of flat ``params`` on
        one batch (the global batch's on a mesh) and this rank's share of its
        gradient, a flat f32 tensor. ``p2_w`` defaults to :meth:`p2` of
        ``t``."""
        cfg, mesh = self.cfg, self.mesh
        if p2_w is None:
            p2_w = self.p2(t)
        _, sab_t, s1mab_t, band_w = self.tables(params.device)
        sab, s1mab = sab_t[t], s1mab_t[t]
        total = lambda v: psum(v, mesh)  # noqa: E731
        flat = params.detach().requires_grad_(True)
        x_t = q_sample(x0, noise, sab, s1mab)
        target = target_for(self.param, x0, noise, sab, s1mab)
        pred = functional_call(self.model, layout.unflatten(flat),
                               (torch.cat([x_t, cond], dim=-1), t))
        base_loss, ch_losses = masked_mse_per_channel(pred, target, mask, band_w,
                                                      cfg.mask_as_weights, total)
        loss = base_loss * p2_w
        if cfg.aux_x0_loss_w > 0.0:
            x0_pred, _ = pred_to_x0_eps(self.param, x_t, pred, sab, s1mab)
            aux_loss, _ = masked_mse_per_channel(x0_pred, x0, mask, band_w,
                                                 cfg.mask_as_weights, total)
            loss = loss + cfg.aux_x0_loss_w * aux_loss
        grads, = torch.autograd.grad(share(loss, mesh), flat)
        return loss.detach(), ch_losses.detach(), p2_w, grads

    def __call__(self, state: TrainState, batch, key):
        device, mesh = state.params.device, self.mesh
        cond, x0, mask = (None if a is None else upload(a, device).float() for a in batch)
        t, noise, keep = global_draws(self.draw, key, state.step, x0.shape, device, mesh)
        p2_w = self.p2(t)
        rows = mesh.rows(t.shape[0])
        t, noise = t[rows], mesh.local(noise, spatial=True)
        keep = None if keep is None else keep[rows]
        if keep is not None:
            cond = cond * keep
        loss, ch_losses, _, grads = self.loss_and_grads(state.params, state.layout, cond,
                                                        x0, mask, t, noise, p2_w)
        finite_in = torch.isfinite(cond).all() & torch.isfinite(x0).all()
        new_state, ok = guarded_update(state, self.opt, grads, loss, self.cfg.ema_decay,
                                       inputs_finite=finite_in, mesh=mesh)
        metrics = {"loss": torch.where(ok, loss, torch.full_like(loss, float("nan"))),
                   "ch_losses": ch_losses, "p2_w": p2_w, "skipped": new_state.skipped}
        return new_state, metrics


def global_draws(draw, key, step: int, local_shape, device, mesh):
    """``draw(key, step, B, shape, device)`` for the global batch: the
    local (B, h, ...) shape times the mesh's data and space sizes."""
    B, h = local_shape[0], local_shape[1]
    shape = (B * mesh.data, h * mesh.space) + tuple(local_shape[2:])
    return draw(key, step, shape[0], shape, device)


def share(loss: torch.Tensor, mesh) -> torch.Tensor:
    """What this rank's backward is seeded with: the loss, divided by the
    model axis's size (the channel gather's backward sums the shares)."""
    return loss / mesh.model


def tp_shard_state(state: TrainState, mesh) -> TrainState:
    """A full state as this rank keeps it on ``mesh``'s model axis: each
    leaf of the params, the Adam moments and the EMA that the rule shards
    (``parallel/mesh.tp_sharded``) cut to this rank's slice."""
    L = state.layout
    sharded = tuple(tp_sharded(s, mesh.model) for s in L.shapes)
    local = ParamLayout(L.names, tuple(
        tuple(s[:-1]) + (s[-1] // mesh.model,) if f else tuple(s)
        for s, f in zip(L.shapes, sharded)), sharded)

    def cut(flat):
        tree = L.unflatten(flat)
        return torch.cat([mesh.param_slice(tree[n]).reshape(-1) for n in L.names])

    return TrainState(step=state.step, params=cut(state.params),
                      opt_state=AdamState(state.opt_state.count, cut(state.opt_state.mu),
                                          cut(state.opt_state.nu)),
                      ema_params=cut(state.ema_params), skipped=state.skipped, layout=local)


def full_layout(layout: ParamLayout, m: int) -> ParamLayout:
    """The unsharded layout of a layout whose sharded leaves hold 1/m."""
    return ParamLayout(layout.names, tuple(
        tuple(s[:-1]) + (s[-1] * m,) if f else tuple(s)
        for s, f in zip(layout.shapes, layout.sharded)))


def gather_flat(flat: torch.Tensor, layout: ParamLayout, mesh):
    """(full layout, full flat tensor) from this rank's slices of a
    model-sharded flat tensor; every rank of the model group enters."""
    tree = layout.unflatten(flat)
    return full_layout(layout, mesh.model), torch.cat(
        [(mesh.all_gather(tree[n], ("model",), dim=-1) if f else tree[n]).reshape(-1)
         for n, f in zip(layout.names, layout.sharded)])


def tp_gather_state(state: TrainState, mesh) -> TrainState:
    """The full state from the ranks' slices (every rank of the model group
    enters): the inverse of :func:`tp_shard_state`, bit for bit."""
    L = state.layout
    if not any(L.sharded):
        return state
    whole = lambda flat: gather_flat(flat, L, mesh)[1]  # noqa: E731
    return TrainState(step=state.step, params=whole(state.params),
                      opt_state=AdamState(state.opt_state.count, whole(state.opt_state.mu),
                                          whole(state.opt_state.nu)),
                      ema_params=whole(state.ema_params), skipped=state.skipped,
                      layout=full_layout(L, mesh.model))


def make_train_step(model, schedule: Schedule, cfg: TrainConfig,
                    draws: str = "auto", mesh=None) -> TrainStep:
    """The train step of ``model`` (a ``UNetSmall(autograd=True)``, built on
    the same ``mesh``); see :class:`TrainStep` and the module docstring for
    ``draws`` and ``mesh``."""
    return TrainStep(model, schedule, cfg, draws, mesh)
