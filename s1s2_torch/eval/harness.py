"""Evaluation harness: every table mode of the reference's eval scripts.

Port of the JAX package's ``eval/harness.py``. ``EvalConfig`` carries every
field of the JAX config (plus ``device``); ``EvalContext`` loads the dataset
(``--file_list`` in forced order, ``--cache_dir`` through ``MmapCache``),
the schedule (cosine or linear) and the model (a ``.msgpack`` checkpoint
through the port's reader, a reference ``.pth`` through
``models/convert.py``, ``"@random"`` through ``init_params``, or an int8
artifact), quantizes it when asked, and gives each file its own noise:
``normal(fold_in(PRNGKey(seed_base + salt), id))`` with the id the file's
dataset index or the crc32 of its name, drawn on the host with the
reference's bits (``core/random.py``), or replayed from ``--noise_npz``.
Files ride in batches; per-file numbers are per-sample metrics, so they do
not depend on the batch a file lands in. The CSV and summary files have the
JAX harness's names, columns and number formats.

Modes (:data:`MODES`): ``ddim``, ``ddim_sweep``, ``eps``, ``vdiag``,
``seed_stats``, ``per_band``, ``ablate``, ``tsweep``, ``true_infer``,
``onestep``, ``limitation``, ``baseline_bicubic``, ``baseline_linear``,
``cfg_sweep``, and the panel modes ``night_demo`` and ``cloudy_viz``;
``tsweep`` and ``cfg_sweep`` write comparison panels as their previews
(``viz/render.save_panel``).

``--mesh_data N`` runs on a data mesh of N processes, one per device
(``parallel/mesh.py``; launched by ``python -m torch.distributed.run
--nproc_per_node N -m s1s2_torch evaluate ...``, NCCL on the card, Gloo with
``--device cpu``): the batch must divide by N, and where the JAX harness
shards its samplers (``EvalContext.shard_call``: the DDIM/DPM samplers and
the one-step sampler) each rank samples its rows of the batch and every rank
gathers the whole batch, so every rank runs the same loop; rank 0 alone
writes files.
"""

from __future__ import annotations

import csv
import dataclasses
import os
import zlib
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from s1s2_torch.core import random
from s1s2_torch.core.parametrize import (Parameterization, pred_to_x0_eps, q_sample,
                                         v_from_x0_eps)
from s1s2_torch.core.schedule import make_schedule
from s1s2_torch.data.dataset import NpzPatchDataset, load_patch
from s1s2_torch.data.loader import MmapCache, eval_batches
from s1s2_torch.eval import metrics as M
from s1s2_torch.eval.baselines import baseline_bicubic, baseline_linear_fit_predict
from s1s2_torch.models.convert import (infer_arch_from_state_dict, load_pth_state_dict,
                                       torch_state_dict_to_params)
from s1s2_torch.models.quant import (load_quant, make_cfg_rollout_calib,
                                     make_quant_cfg_denoise_fn, make_quant_denoise_fn,
                                     make_sampler_calib, quantize_unet)
from s1s2_torch.models.unet import init_params, load_unet
from s1s2_torch.models.weights import params_from_numpy
from s1s2_torch.parallel.mesh import (backend_for, initialize_distributed, is_writer,
                                      require_world)
from s1s2_torch.sampling.dpm_solver import dpm_solver_2m
from s1s2_torch.sampling.grids import full_range_grid, round_unique_grid
from s1s2_torch.sampling.samplers import (_ddim_linspace_scan, ddim_anchored,
                                          ddim_grid_sample, ddpm_ancestral,
                                          make_cfg_denoise_fn, make_denoise_fn,
                                          one_step_recon, partial_ddim_from_gt)
from s1s2_torch.train.checkpoint import load_params
from s1s2_torch.viz import render as V

# Salt offsets partitioning the per-file RNG space (fold_in of the file id
# on PRNGKey(seed_base + salt)): init noise uses salt 0 (seed_stats 1000+s,
# true_infer 5000+s), the η streams ETA_SALT(+s), so stochastic-DDIM draws
# never collide with init draws.
ETA_SALT = 7000
# limitation mode: full-range init draws, and the partial-reverse forward
# noise at PARTIAL_SALT + k
LIMITATION_SALT = 300
PARTIAL_SALT = 310

@dataclasses.dataclass
class EvalConfig:
    patch_dir: str
    out_dir: str
    ckpt: Optional[str] = None
    mode: str = "ddim"
    T: int = 1000
    schedule: str = "cosine"
    base_ch: int = 96
    stem_s2d: int = 1
    pred_param: str = "eps"  # 'eps' | 'v'
    batch_size: int = 8
    max_files: int = 0
    save_viz_n: int = 6
    # ddim
    t_start: int = 200
    ddim_steps: int = 20
    eta: float = 0.0
    # sweep grids
    t_start_grid: Tuple[int, ...] = ()
    ddim_steps_grid: Tuple[int, ...] = ()
    # small-t diagnostics
    t_small: int = 20
    t_values: Tuple[int, ...] = (5, 10, 20, 40, 80, 160)
    n_seeds: int = 8
    seed_base: int = 1234
    # limitation mode
    limitation_sampler: str = "ddim"  # 'ddpm' | 'ddim'
    partial_reverse_k: Tuple[int, ...] = ()
    band_weights: Optional[Tuple[float, ...]] = None
    save_n: int = 16
    # CFG
    guidance_scale: Optional[float] = None
    guidance_scales: Tuple[float, ...] = ()
    solver: str = "ddim"  # 'ddim' | 'dpm2m'
    # viz / cloud
    select_top_cloud: int = 12
    zoom: int = 0
    zoom_k: int = 0
    full_metrics: bool = False
    compute_dtype: str = "bfloat16"
    file_list: Optional[str] = None  # txt file, one npz name per line, forced order
    viz_mode: str = "percentile"  # 'percentile' | 'dataset_fixed'
    viz_q_low: float = 1.0
    viz_q_high: float = 99.0
    # int8 inference (models/quant.py)
    int8: bool = False
    int8_calib: str = "qsample"  # 'qsample' | 'rollout' (cfg_sweep)
    int8_perchannel: bool = False
    int8_bf16_blocks: tuple = ()
    int8_ckpt: Optional[str] = None
    cache_dir: Optional[str] = None
    mesh_data: int = 0
    # .npz of explicit noise keyed "s{salt}_i{file_index}" (NHWC float32)
    # replacing the per-file draws; a missing key raises
    noise_npz: Optional[str] = None
    rng_by: str = "index"  # 'index' | 'name'
    # the port's own: where the model runs ("cuda" or "cpu")
    device: str = "cuda"


def stable_file_id(name: str) -> int:
    """crc32 of an npz basename: the 'name' per-file RNG keying."""
    return zlib.crc32(name.encode("utf-8")) & 0xFFFFFFFF


def eval_mesh(cfg: EvalConfig):
    """``--mesh_data``'s data mesh (None without it): the batch must divide
    by N, and the world must be N processes (torchrun's environment)."""
    if not cfg.mesh_data:
        return None
    if cfg.batch_size % cfg.mesh_data:
        raise ValueError(f"batch_size {cfg.batch_size} not divisible by "
                         f"mesh_data {cfg.mesh_data}")
    initialize_distributed(backend=backend_for(cfg.device))
    return require_world(cfg.mesh_data)


def _viz(save, *args, **kw) -> None:
    """A file writer of the modes, called on rank 0 only."""
    if is_writer():
        save(*args, **kw)


class EvalContext:
    """Loads the dataset and the model once; gives denoise closures and
    per-file noise."""

    def __init__(self, cfg: EvalConfig):
        self.mesh = eval_mesh(cfg)
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        self.viz_dir = os.path.join(cfg.out_dir, "previews")
        if is_writer():
            os.makedirs(self.viz_dir, exist_ok=True)
        self.ds = NpzPatchDataset(cfg.patch_dir,
                                  max_files=cfg.max_files if cfg.max_files > 0 else None)
        if cfg.file_list:
            with open(cfg.file_list) as f:
                wanted = [ln.strip() for ln in f if ln.strip()]
            missing = [w for w in wanted if w not in set(self.ds.files)]
            if missing:
                raise FileNotFoundError(f"file_list entries not found: {missing[:5]}")
            self.ds.files = wanted  # exact forced order
        self.Cc, self.Ct, self.H, self.W = self.ds.probe_channels()
        # batches from the mmap cache when asked (same files and order, so
        # file_idx and the per-file noise do not change)
        self.eval_ds = MmapCache(self.ds, cfg.cache_dir) if cfg.cache_dir else self.ds
        self.schedule = make_schedule(cfg.T, cfg.schedule)
        self.param = Parameterization(cfg.pred_param)
        self.file_idx = {f: i for i, f in enumerate(self.ds.files)}
        self.model = None
        self.state = None
        self.qparams = None
        if cfg.ckpt or cfg.int8_ckpt:
            if cfg.int8_ckpt:
                self.qparams = load_quant(cfg.int8_ckpt, self.device)
                self.state = (self._load_ckpt(cfg.ckpt) if cfg.ckpt
                              else self.qparams.params)
            else:
                self.state = self._load_ckpt(cfg.ckpt)
            dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
            self.model = load_unet(self.state, self.Ct, cfg.base_ch, cfg.stem_s2d,
                                   in_ch=self.Cc + self.Ct, compute_dtype=dtype,
                                   device=self.device)
            if cfg.int8 and self.qparams is None:
                self.qparams = self._quantize()

    def _load_ckpt(self, path: str) -> Dict[str, torch.Tensor]:
        if path.endswith(".pth"):
            sd = load_pth_state_dict(path)
            arch = infer_arch_from_state_dict(sd)
            want = {"in_ch": self.Cc + self.Ct, "out_ch": self.Ct, "base_ch": self.cfg.base_ch}
            if arch != want or self.cfg.stem_s2d != 1:
                raise ValueError(f"{path}: the checkpoint's architecture {arch} does not match "
                                 f"the configuration {want} with stem_s2d "
                                 f"{self.cfg.stem_s2d} (check --base_ch and --s2d)")
            state = params_from_numpy(torch_state_dict_to_params(sd)["params"])
        elif path == "@random":  # documented test hook: flax's init from PRNGKey(0)
            state = init_params(self.Ct, self.cfg.base_ch, self.cfg.stem_s2d, seed=0,
                                in_ch=self.Cc + self.Ct)
        else:
            state = params_from_numpy(load_params(path))
        return {k: v.to(self.device) for k, v in state.items()}

    def _first_items(self, keys: Sequence[str]) -> List[torch.Tensor]:
        """The first (up to 8) files' arrays under ``keys``, stacked, on the
        context's device."""
        items = [self.ds[i] for i in range(min(len(self.ds), 8))]
        return [torch.from_numpy(np.stack([d[k] for d in items])).to(self.device)
                for k in keys]

    def _quantize(self):
        """int8 quantization calibrated on the first (up to 8) files,
        q-sampled at a spread of sampler timesteps, with null-cond twins
        when guidance runs."""
        cond, gt = self._first_items(("cond", "target"))
        n = cond.shape[0]
        t_hi = min(max(self.cfg.t_start, 1), self.cfg.T - 1)
        null_cond = self.cfg.guidance_scale is not None or self.cfg.mode == "cfg_sweep"
        calib = make_sampler_calib(
            gt, cond, self.schedule.alpha_bar_np(),
            sorted({t_hi, max(t_hi // 2, 1), min(5, t_hi)}),
            key=random.PRNGKey(self.cfg.seed_base), n=n, null_cond=null_cond)
        return self._quantize_on(calib)

    def _quantize_on(self, calib):
        return quantize_unet(self.state, calib, out_ch=self.Ct, base_ch=self.cfg.base_ch,
                             stem_s2d=self.cfg.stem_s2d,
                             act_perchannel=self.cfg.int8_perchannel,
                             bf16_blocks=tuple(self.cfg.int8_bf16_blocks))

    def quantize_rollout(self, guidance_scale: float):
        """int8 re-calibration for one guidance scale on a guided bf16
        rollout from the first (up to 8) files' cond: the ε family walks
        the linspace scan the ε sweep samples with, the v family the
        round-unique grid with the sweep's η."""
        (cond,) = self._first_items(("cond",))
        n = cond.shape[0]
        grid = round_unique_grid(self.cfg.t_start, self.cfg.ddim_steps, self.cfg.T)
        calib = make_cfg_rollout_calib(
            self.model, cond, self.schedule, grid, guidance_scale, param=self.param,
            key=random.PRNGKey(self.cfg.seed_base), n=n, out_ch=self.Ct,
            eta=self.cfg.eta, eps_linspace=(self.cfg.t_start, self.cfg.ddim_steps))
        return self._quantize_on(calib)

    def denoise_fn(self, cond: torch.Tensor):
        g = self.cfg.guidance_scale
        if self.cfg.int8:
            if g is not None:
                return make_quant_cfg_denoise_fn(self.qparams, cond, g)
            return make_quant_denoise_fn(self.qparams, cond)
        if g is not None:
            return make_cfg_denoise_fn(self.model, cond, g)
        return make_denoise_fn(self.model, cond)

    def shard_call(self, sampler):
        """``sampler`` over the eval mesh: every argument is batch-major
        (cond, gt, noise, η keys); each rank runs the sampler on its rows of
        each and gathers the whole batch's output. Identity without a
        mesh."""
        mesh = self.mesh
        if mesh is None:
            return sampler

        def wrapped(*args):
            B = args[0].shape[0]
            for a in args:
                if a.shape[0] != B:
                    raise ValueError(f"shard_call: an argument of shape {tuple(a.shape)} "
                                     f"does not lead with the batch {B}")
            rows = mesh.rows(B)
            return mesh.all_gather(sampler(*(a[rows] for a in args)), ("data",))

        return wrapped

    def tensors(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        """Host batches as tensors on the context's device."""
        return [torch.from_numpy(np.asarray(a)).to(self.device) for a in arrays]

    def per_file_keys(self, indices: Sequence[int], salt: int = 0) -> np.ndarray:
        """(B, 2) uint32 keys ``fold_in(PRNGKey(seed_base + salt), id)``."""
        base = random.PRNGKey(self.cfg.seed_base + salt)
        if self.cfg.rng_by == "name":
            ids = [stable_file_id(self.ds.files[int(i)]) for i in indices]
        elif self.cfg.rng_by == "index":
            ids = [int(i) for i in indices]
        else:
            raise ValueError(f"rng_by must be 'index' or 'name', got {self.cfg.rng_by!r}")
        return np.stack([random.fold_in(base, i) for i in ids])

    def per_file_noise(self, indices: Sequence[int], salt: int = 0) -> torch.Tensor:
        """(B, H, W, Ct) f32 on the context's device: each file's own draw,
        or its array of ``--noise_npz`` (whatever its shape)."""
        if self.cfg.noise_npz is not None:
            if not hasattr(self, "_injected_noise"):
                self._injected_noise = dict(np.load(self.cfg.noise_npz))
            try:
                arr = np.stack([self._injected_noise[f"s{salt}_i{int(i)}"]
                                for i in indices]).astype(np.float32)
            except KeyError as e:
                raise KeyError(f"noise_npz {self.cfg.noise_npz} missing key {e} "
                               f"(salt={salt}); regenerate it for this mode") from e
        else:
            arr = random.normal(self.per_file_keys(indices, salt), (self.H, self.W, self.Ct))
        return torch.from_numpy(arr).to(self.device)


# ---------------------------------------------------------------------------
# small host helpers
# ---------------------------------------------------------------------------


def _write_csv(path: str, header: List[str], rows: List[List]) -> None:
    if not is_writer():
        return
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


def _mstd(a: Sequence[float]) -> Tuple[float, float]:
    arr = np.asarray(a, np.float64)
    return float(arr.mean()), float(arr.std())  # population std


def _summary(path: str, lines: List[str]) -> None:
    if not is_writer():
        return
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _np(*ts: torch.Tensor) -> List[np.ndarray]:
    return [t.detach().cpu().numpy() for t in ts]


def _per_sample(fn, *batches: torch.Tensor) -> List[np.ndarray]:
    """``fn`` of each sample alone (the JAX harness's vmapped metrics): one
    (B,) f32 host array for each value ``fn`` returns."""
    outs = []
    for i in range(batches[0].shape[0]):
        o = fn(*(b[i] for b in batches))
        outs.append([float(v) for v in (o if isinstance(o, tuple) else (o,))])
    return [np.asarray(c, np.float32) for c in zip(*outs)]


def _padded(ctx: EvalContext, names: Sequence[str], n_valid: int) -> List[int]:
    """The batch's dataset indices, the last repeated to the batch size."""
    idxs = [ctx.file_idx[n] for n in names]
    return idxs + [idxs[-1]] * (ctx.cfg.batch_size - n_valid)


def _ddim_from_init(fn, x_init, schedule, t_start, steps):
    """ε linspace DDIM from an explicit init (the pure-generation path)."""
    return _ddim_linspace_scan(fn, x_init, schedule, t_start, steps, (0.0, 1.0))


def _v_init_scale(ctx: EvalContext, t_start: int) -> float:
    """√(1 − ᾱ_K) of the v samplers' mean-free init, K the clamped t_start."""
    ab = float(ctx.schedule.alpha_bar_np()[min(max(t_start, 1), ctx.cfg.T - 1)])
    return float(np.sqrt(1.0 - ab))


# ---------------------------------------------------------------------------
# samplers shared by the modes
# ---------------------------------------------------------------------------


def _make_recon_sampler(ctx: EvalContext, t_start: Optional[int] = None,
                        steps: Optional[int] = None):
    """``(cond, gt, noise, eta_keys) → x0̂`` for the configured solver and
    parameterization: GT-anchored linspace DDIM (ε), the round-unique grid
    from ``noise·√(1−ᾱ)`` with per-file η streams (v), or DPM-Solver++(2M)
    from the anchored (ε) or mean-free (v) init. ``eta_keys`` is a (B, 2)
    batch of per-file keys, used only by the stochastic v path."""
    cfg = ctx.cfg
    t_start = cfg.t_start if t_start is None else t_start
    steps = cfg.ddim_steps if steps is None else steps
    sched = ctx.schedule

    if cfg.solver == "dpm2m":
        grid = round_unique_grid(t_start, steps, cfg.T)
        K = int(grid[-1])

        def sample(cond, gt, noise, eta_keys):
            if ctx.param is Parameterization.EPS:
                x_init = q_sample(gt, noise, float(sched.sqrt_alpha_bar[K]),
                                  float(sched.sqrt_one_minus_alpha_bar[K]))
            else:
                ab = float(sched.alpha_bar_np()[K])
                x_init = noise * float(np.sqrt(1.0 - ab))
            return dpm_solver_2m(ctx.denoise_fn(cond), x_init, sched, grid, ctx.param)
        return ctx.shard_call(sample)

    if ctx.param is Parameterization.EPS:
        def sample(cond, gt, noise, eta_keys):
            return ddim_anchored(ctx.denoise_fn(cond), gt, sched, t_start, steps, noise=noise)
        return ctx.shard_call(sample)

    grid = round_unique_grid(t_start, steps, cfg.T)
    scale = _v_init_scale(ctx, t_start)

    def sample(cond, gt, noise, eta_keys):
        return ddim_grid_sample(ctx.denoise_fn(cond), noise * scale, sched, grid,
                                Parameterization.V, eta=cfg.eta, key=eta_keys)
    return ctx.shard_call(sample)


def _one_step_sampler(ctx: EvalContext, t_small: Optional[int] = None):
    t_small = ctx.cfg.t_small if t_small is None else t_small

    def sample(cond, gt, noise):
        return one_step_recon(ctx.denoise_fn(cond), gt, ctx.schedule, t_small, ctx.param,
                              noise=noise)
    return ctx.shard_call(sample)


# ---------------------------------------------------------------------------
# modes
# ---------------------------------------------------------------------------


def run_ddim(ctx: EvalContext) -> Dict:
    """GT-anchored ε DDIM / pure-noise v DDIM, per-file metrics (with
    ``--full_metrics`` also PSNR, SAM, ERGAS) and the first files'
    true-colour and CIR previews."""
    cfg = ctx.cfg
    rows, maes, mses = [], [], []
    extra = {"psnr": [], "sam": [], "ergas": []}
    sample = _make_recon_sampler(ctx)
    saved = 0
    for (cond, gt, mask), names, n_valid in eval_batches(ctx.eval_ds, cfg.batch_size):
        padded = _padded(ctx, names, n_valid)
        cond_t, gt_t, mask_t = ctx.tensors(cond, gt, mask)
        x0 = sample(cond_t, gt_t, ctx.per_file_noise(padded),
                    ctx.per_file_keys(padded, salt=ETA_SALT))
        mae_b, mse_b = _np(*M.per_file_mae_mse(x0, gt_t, mask_t))
        if cfg.full_metrics:
            p_b, s_b, e_b = _np(*(M.per_sample(f)(x0, gt_t, mask_t)
                                  for f in (M.psnr, M.sam, M.ergas)))
        x0_np = _np(x0)[0]
        for j in range(n_valid):
            maes.append(float(mae_b[j]))
            mses.append(float(mse_b[j]))
            row = [names[j], cfg.t_start, cfg.ddim_steps]
            if ctx.param is Parameterization.V:
                row.append(cfg.eta)  # the v reference writes an eta column
            row += [f"{mae_b[j]:.6f}", f"{mse_b[j]:.6f}"]
            if cfg.full_metrics:
                extra["psnr"].append(float(p_b[j]))
                extra["sam"].append(float(s_b[j]))
                extra["ergas"].append(float(e_b[j]))
                row += [f"{p_b[j]:.3f}", f"{s_b[j]:.4f}", f"{e_b[j]:.2f}"]
            rows.append(row)
            if saved < cfg.save_viz_n:
                _viz(V.save_rgb_triplet, x0_np[j],
                     os.path.join(ctx.viz_dir, f"{saved:03d}_ddim_pred_true.png"),
                     os.path.join(ctx.viz_dir, f"{saved:03d}_ddim_pred_cir.png"))
                saved += 1

    header = ["file", "t_start", "ddim_steps", "MAE", "MSE"]
    if ctx.param is Parameterization.V:
        header.insert(3, "eta")
    if cfg.full_metrics:
        header += ["PSNR", "SAM(rad)", "ERGAS"]
    _write_csv(os.path.join(cfg.out_dir, "ddim_metrics.csv"), header, rows)

    mae_mu, mae_sd = _mstd(maes)
    mse_mu, mse_sd = _mstd(mses)
    lines = [
        f"files: {len(maes)}  t_start: {cfg.t_start}  steps: {cfg.ddim_steps}",
        f"MAE mean/std: {mae_mu:.6f} / {mae_sd:.6f}",
        f"MSE mean/std: {mse_mu:.6f} / {mse_sd:.6f}",
    ]
    if ctx.param is Parameterization.V:
        lines.insert(1, f"eta: {cfg.eta}")
    if cfg.full_metrics:
        lines += [
            f"PSNR mean/std: {_mstd(extra['psnr'])[0]:.3f} / {_mstd(extra['psnr'])[1]:.3f}",
            f"SAM  mean/std: {_mstd(extra['sam'])[0]:.4f} / {_mstd(extra['sam'])[1]:.4f}",
            f"ERGAS mean/std:{_mstd(extra['ergas'])[0]:.2f} / {_mstd(extra['ergas'])[1]:.2f}",
        ]
    _summary(os.path.join(cfg.out_dir, "ddim_summary.txt"), lines)
    return {"MAE_mean": mae_mu, "MAE_std": mae_sd, "MSE_mean": mse_mu, "MSE_std": mse_sd}


def run_ddim_sweep(ctx: EvalContext) -> Dict:
    """t_start × steps grid, each file with its own noise in every cell."""
    cfg = ctx.cfg
    if not (cfg.t_start_grid and cfg.ddim_steps_grid):
        raise ValueError("ddim_sweep needs --t_start_grid and --ddim_steps_grid")
    rows, results = [], {}
    for t_start in cfg.t_start_grid:
        for steps in cfg.ddim_steps_grid:
            sample = _make_recon_sampler(ctx, t_start, steps)
            maes, mses = [], []
            for (cond, gt, mask), names, n_valid in eval_batches(ctx.eval_ds, cfg.batch_size):
                padded = _padded(ctx, names, n_valid)
                cond_t, gt_t, mask_t = ctx.tensors(cond, gt, mask)
                x0 = sample(cond_t, gt_t, ctx.per_file_noise(padded),
                            ctx.per_file_keys(padded, salt=ETA_SALT))
                mae_b, mse_b = _np(*M.per_file_mae_mse(x0, gt_t, mask_t))
                maes += list(mae_b[:n_valid])
                mses += list(mse_b[:n_valid])
            mae_mu, mae_sd = _mstd(maes)
            mse_mu, mse_sd = _mstd(mses)
            rows.append([t_start, steps, len(maes),
                         f"{mae_mu:.6f}", f"{mae_sd:.6f}", f"{mse_mu:.6f}", f"{mse_sd:.6f}"])
            results[(t_start, steps)] = mae_mu
    _write_csv(os.path.join(cfg.out_dir, "ddim_sweep_summary.csv"),
               ["t_start", "steps", "files", "MAE_mean", "MAE_std", "MSE_mean", "MSE_std"],
               rows)
    return results


def run_pred_diagnostics(ctx: EvalContext) -> Dict:
    """``eps`` and ``vdiag``: prediction-space MSE and cosine at t_small,
    per file (v: the v-MSE, v-cosine and the cosine of the derived ε)."""
    cfg = ctx.cfg
    is_v = ctx.param is Parameterization.V
    t_small = max(1, min(cfg.t_small, cfg.T - 1))
    sab = float(ctx.schedule.sqrt_alpha_bar[t_small])
    s1m = float(ctx.schedule.sqrt_one_minus_alpha_bar[t_small])

    def diag(cond, gt, noise):
        x_t = q_sample(gt, noise, sab, s1m)
        t = torch.full((gt.shape[0],), t_small, dtype=torch.int32, device=gt.device)
        pred = ctx.denoise_fn(cond)(x_t, t)
        if is_v:
            v_true = v_from_x0_eps(gt, noise, sab, s1m)
            _, eps_pred = pred_to_x0_eps(Parameterization.V, x_t, pred, sab, s1m)
            return _per_sample(M.v_diagnostics, pred, v_true, eps_pred, noise)
        return _per_sample(M.eps_diagnostics, pred, noise)

    rows, col1, col2, col3 = [], [], [], []
    for (cond, gt, mask), names, n_valid in eval_batches(ctx.eval_ds, cfg.batch_size):
        cond_t, gt_t = ctx.tensors(cond, gt)
        out = diag(cond_t, gt_t, ctx.per_file_noise(_padded(ctx, names, n_valid)))
        for j in range(n_valid):
            if is_v:
                rows.append([names[j], t_small, f"{out[0][j]:.6f}",
                             f"{out[1][j]:.6f}", f"{out[2][j]:.6f}"])
                col3.append(float(out[2][j]))
            else:
                rows.append([names[j], t_small, f"{out[0][j]:.6f}", f"{out[1][j]:.6f}"])
            col1.append(float(out[0][j]))
            col2.append(float(out[1][j]))

    if is_v:
        _write_csv(os.path.join(cfg.out_dir, "vdiag.csv"),
                   ["file", "t_small", "v_MSE", "v_cosine", "eps_cosine"], rows)
        _summary(os.path.join(cfg.out_dir, "vdiag_summary.txt"), [
            f"files: {len(col1)}  t_small: {t_small}",
            f"v_MSE mean/std: {_mstd(col1)[0]:.6f} / {_mstd(col1)[1]:.6f}",
            f"v_cos mean/std: {_mstd(col2)[0]:.6f} / {_mstd(col2)[1]:.6f}",
            f"eps_cos mean/std: {_mstd(col3)[0]:.6f} / {_mstd(col3)[1]:.6f}",
        ])
        return {"v_mse": _mstd(col1)[0], "v_cos": _mstd(col2)[0], "eps_cos": _mstd(col3)[0]}
    _write_csv(os.path.join(cfg.out_dir, "eps_diag.csv"),
               ["file", "t_small", "eps_MSE", "cosine"], rows)
    _summary(os.path.join(cfg.out_dir, "eps_summary.txt"), [
        f"files: {len(col1)}  t_small: {t_small}",
        f"eps_MSE mean/std: {_mstd(col1)[0]:.6f} / {_mstd(col1)[1]:.6f}",
        f"cosine  mean/std: {_mstd(col2)[0]:.6f} / {_mstd(col2)[1]:.6f}",
    ])
    return {"eps_mse": _mstd(col1)[0], "cosine": _mstd(col2)[0]}


def run_seed_stats(ctx: EvalContext) -> Dict:
    """n_seeds one-step recons per file (noise salt 1000 + seed): per-file
    mean/std and the dataset's mean of means."""
    cfg = ctx.cfg
    sample = _one_step_sampler(ctx)
    per_file: Dict[str, List[Tuple[float, float]]] = {}
    for s in range(cfg.n_seeds):
        for (cond, gt, mask), names, n_valid in eval_batches(ctx.eval_ds, cfg.batch_size):
            cond_t, gt_t, mask_t = ctx.tensors(cond, gt, mask)
            noise = ctx.per_file_noise(_padded(ctx, names, n_valid), salt=1000 + s)
            mae_b, mse_b = _np(*M.per_file_mae_mse(sample(cond_t, gt_t, noise), gt_t, mask_t))
            for j in range(n_valid):
                per_file.setdefault(names[j], []).append((float(mae_b[j]), float(mse_b[j])))
    rows, mae_means, mae_stds, mse_means, mse_stds = [], [], [], [], []
    for name in ctx.ds.files:
        vals = np.asarray(per_file[name])
        mae_mu, mae_sd = float(vals[:, 0].mean()), float(vals[:, 0].std())
        mse_mu, mse_sd = float(vals[:, 1].mean()), float(vals[:, 1].std())
        rows.append([name, cfg.t_small, cfg.n_seeds,
                     f"{mae_mu:.6f}", f"{mae_sd:.6f}", f"{mse_mu:.6f}", f"{mse_sd:.6f}"])
        mae_means.append(mae_mu)
        mae_stds.append(mae_sd)
        mse_means.append(mse_mu)
        mse_stds.append(mse_sd)
    _write_csv(os.path.join(cfg.out_dir, "seed_stats.csv"),
               ["file", "t_small", "n_seeds", "MAE_mean", "MAE_std", "MSE_mean", "MSE_std"],
               rows)
    _summary(os.path.join(cfg.out_dir, "seed_stats_summary.txt"), [
        f"files: {len(rows)}  t_small: {cfg.t_small}  n_seeds: {cfg.n_seeds}",
        f"MAE mean_of_means/std_of_means: {np.mean(mae_means):.6f} / {np.std(mae_means):.6f}",
        f"MSE mean_of_means/std_of_means: {np.mean(mse_means):.6f} / {np.std(mse_means):.6f}",
        f"Avg per-file MAE_std: {np.mean(mae_stds):.6f}",
        f"Avg per-file MSE_std: {np.mean(mse_stds):.6f}",
    ])
    return {"MAE_mean_of_means": float(np.mean(mae_means))}


def run_per_band(ctx: EvalContext) -> Dict:
    """One-step recon (noise salt 7), per band MAE, MSE, PSNR and global
    SSIM per file, then per-band dataset aggregates; previews of the first
    files."""
    cfg = ctx.cfg
    sample = _one_step_sampler(ctx)
    band_accum: Dict[int, List[Tuple[float, float, float, float]]] = {}
    rows = []
    saved = 0
    for (cond, gt, mask), names, n_valid in eval_batches(ctx.eval_ds, cfg.batch_size):
        cond_t, gt_t, mask_t = ctx.tensors(cond, gt, mask)
        x0 = sample(cond_t, gt_t, ctx.per_file_noise(_padded(ctx, names, n_valid), salt=7))
        per_band = []
        for b in range(ctx.Ct):
            p, g = x0[..., b:b + 1], gt_t[..., b:b + 1]
            mae_b, mse_b = _np(*M.per_file_mae_mse(p, g, mask_t))
            ps = _np(M.per_sample(M.psnr)(p, g, mask_t))[0]
            ss = _per_sample(M.ssim_simple, p, g)[0]
            per_band.append((mae_b, mse_b, ps, ss))
        x0_np = _np(x0)[0]
        for j in range(n_valid):
            row = [names[j]]
            for b in range(ctx.Ct):
                mae_b, mse_b, ps, ss = per_band[b]
                row += [f"{mae_b[j]:.6f}", f"{mse_b[j]:.6f}", f"{ps[j]:.3f}", f"{ss[j]:.4f}"]
                if cfg.full_metrics:
                    row.append("NaN")  # per-band SAM is ill-posed: the reference writes NaN
                band_accum.setdefault(b, []).append(
                    (float(mae_b[j]), float(mse_b[j]), float(ps[j]), float(ss[j])))
            rows.append(row)
            if saved < cfg.save_viz_n:
                _viz(V.save_rgb_triplet, x0_np[j],
                     os.path.join(ctx.viz_dir, f"{saved:03d}_pb_pred_true.png"),
                     os.path.join(ctx.viz_dir, f"{saved:03d}_pb_pred_cir.png"))
                saved += 1
    hdr = ["file"]
    for b in range(ctx.Ct):
        hdr += [f"band{b}_MAE", f"band{b}_MSE", f"band{b}_PSNR", f"band{b}_SSIMs"]
        if cfg.full_metrics:
            hdr.append(f"band{b}_SAM")
    _write_csv(os.path.join(cfg.out_dir, "per_band_all.csv"), hdr, rows)

    agg_rows = []
    for b, vals in sorted(band_accum.items()):
        arr = np.asarray(vals)
        agg_rows.append([b] + [
            f"{arr[:, 0].mean():.6f}", f"{arr[:, 0].std():.6f}",
            f"{arr[:, 1].mean():.6f}", f"{arr[:, 1].std():.6f}",
            f"{arr[:, 2].mean():.3f}", f"{arr[:, 2].std():.3f}",
            f"{arr[:, 3].mean():.4f}", f"{arr[:, 3].std():.4f}",
        ])
    _write_csv(os.path.join(cfg.out_dir, "per_band_summary.csv"),
               ["band", "MAE_mean", "MAE_std", "MSE_mean", "MSE_std",
                "PSNR_mean", "PSNR_std", "SSIMs_mean", "SSIMs_std"], agg_rows)
    return {"bands": len(band_accum)}


def run_ablate(ctx: EvalContext) -> Dict:
    """Each cond channel zeroed in turn, one-step recon with one shared noise
    (salt 99, file 0) for every file; ΔMAE/ΔMSE against the unablated
    recon."""
    cfg = ctx.cfg
    sample = _one_step_sampler(ctx)
    rows = []
    ch_stats: Dict[int, List[Tuple[float, float, float, float]]] = {}
    t_small = max(1, min(cfg.t_small, cfg.T - 1))
    for (cond, gt, mask), names, n_valid in eval_batches(ctx.eval_ds, cfg.batch_size):
        noise = ctx.per_file_noise([0] * cfg.batch_size, salt=99)
        cond_t, gt_t, mask_t = ctx.tensors(cond, gt, mask)
        base_mae, base_mse = _np(*M.per_file_mae_mse(sample(cond_t, gt_t, noise), gt_t, mask_t))
        per_ch = []
        for ch in range(ctx.Cc):
            cond_ab = cond_t.clone()
            cond_ab[..., ch] = 0.0
            per_ch.append(_np(*M.per_file_mae_mse(sample(cond_ab, gt_t, noise), gt_t, mask_t)))
        for j in range(n_valid):
            for ch in range(ctx.Cc):
                mae_b, mse_b = per_ch[ch]
                dmae = float(mae_b[j] - base_mae[j])
                dmse = float(mse_b[j] - base_mse[j])
                rows.append([names[j], t_small,
                             f"{base_mae[j]:.6f}", f"{base_mse[j]:.6f}", ch,
                             f"{mae_b[j]:.6f}", f"{mse_b[j]:.6f}",
                             f"{dmae:.6f}", f"{dmse:.6f}"])
                ch_stats.setdefault(ch, []).append(
                    (float(mae_b[j]), float(mse_b[j]), dmae, dmse))
    _write_csv(os.path.join(cfg.out_dir, "ablate_all.csv"),
               ["file", "t_small", "baseline_MAE", "baseline_MSE", "channel",
                "MAE", "MSE", "dMAE", "dMSE"], rows)
    agg = []
    for ch, vals in sorted(ch_stats.items()):
        arr = np.asarray(vals)
        row = [ch]
        for k in range(4):
            row += [f"{arr[:, k].mean():.6f}", f"{arr[:, k].std():.6f}"]
        agg.append(row)
    _write_csv(os.path.join(cfg.out_dir, "ablate_summary.csv"),
               ["channel", "MAE_mean", "MAE_std", "MSE_mean", "MSE_std",
                "dMAE_mean", "dMAE_std", "dMSE_mean", "dMSE_std"], agg)
    return {ch: float(np.asarray(v)[:, 2].mean()) for ch, v in ch_stats.items()}


def run_tsweep(ctx: EvalContext) -> Dict:
    """One-step recon at each of ``t_values`` with one shared noise (salt
    99, file 0); the first ``save_viz_n`` files' panels of the middle t's
    prediction."""
    cfg = ctx.cfg
    rows = []
    results: Dict[int, List[float]] = {}
    samplers = {int(t): _one_step_sampler(ctx, int(t)) for t in cfg.t_values}
    mid_t = max(1, min(int(cfg.t_values[len(cfg.t_values) // 2]), cfg.T - 1))
    saved = 0
    for (cond, gt, mask), names, n_valid in eval_batches(ctx.eval_ds, cfg.batch_size):
        noise = ctx.per_file_noise([0] * cfg.batch_size, salt=99)
        cond_t, gt_t, mask_t = ctx.tensors(cond, gt, mask)
        outs = {}
        for t in cfg.t_values:
            t_c = max(1, min(int(t), cfg.T - 1))
            outs[t_c] = x0 = samplers[int(t)](cond_t, gt_t, noise)
            mae_b, mse_b = _np(*M.per_file_mae_mse(x0, gt_t, mask_t))
            for j in range(n_valid):
                rows.append([names[j], t_c, f"{mae_b[j]:.6f}", f"{mse_b[j]:.6f}"])
                results.setdefault(t_c, []).append(float(mae_b[j]))
        n_viz = min(cfg.save_viz_n - saved, n_valid)
        if n_viz > 0:
            mid = _np(outs[mid_t])[0]
            for j in range(n_viz):
                _viz(V.save_panel, mid[j], gt[j], cond[j],
                     os.path.join(ctx.viz_dir, f"{saved:03d}_tsweep_t{mid_t}.png"),
                     title=f"t-sweep middle t={mid_t}")
                saved += 1
    _write_csv(os.path.join(cfg.out_dir, "tsweep.csv"), ["file", "t", "MAE", "MSE"], rows)
    return {t: float(np.mean(v)) for t, v in results.items()}


def run_true_infer(ctx: EvalContext) -> Dict:
    """Pure generation: n_seeds generations from noise per file (salt
    5000 + seed, η streams ETA_SALT + seed), MAE/MSE/PSNR/SAM/ERGAS mean
    and std."""
    cfg = ctx.cfg
    sched = ctx.schedule
    if cfg.solver == "dpm2m":
        grid = round_unique_grid(cfg.t_start, cfg.ddim_steps, cfg.T)
        init_scale = (1.0 if ctx.param is Parameterization.EPS
                      else _v_init_scale(ctx, cfg.t_start))

        def generate(cond, noise, eta_keys):
            return dpm_solver_2m(ctx.denoise_fn(cond), noise * init_scale, sched, grid,
                                 ctx.param)
    elif ctx.param is Parameterization.EPS:
        def generate(cond, noise, eta_keys):
            return _ddim_from_init(ctx.denoise_fn(cond), noise, sched, cfg.t_start,
                                   cfg.ddim_steps)
    else:
        grid = round_unique_grid(cfg.t_start, cfg.ddim_steps, cfg.T)
        scale = _v_init_scale(ctx, cfg.t_start)

        def generate(cond, noise, eta_keys):
            return ddim_grid_sample(ctx.denoise_fn(cond), noise * scale, sched, grid,
                                    Parameterization.V, eta=cfg.eta, key=eta_keys)

    per_file: Dict[str, List[Tuple[float, ...]]] = {}
    for s in range(max(1, cfg.n_seeds)):
        for (cond, gt, mask), names, n_valid in eval_batches(ctx.eval_ds, cfg.batch_size):
            padded = _padded(ctx, names, n_valid)
            cond_t, gt_t, mask_t = ctx.tensors(cond, gt, mask)
            x0 = generate(cond_t, ctx.per_file_noise(padded, salt=5000 + s),
                          ctx.per_file_keys(padded, salt=ETA_SALT + s))
            mae_b, mse_b = _np(*M.per_file_mae_mse(x0, gt_t, mask_t))
            p_b, s_b, e_b = _np(*(M.per_sample(f)(x0, gt_t, mask_t)
                                  for f in (M.psnr, M.sam, M.ergas)))
            for j in range(n_valid):
                per_file.setdefault(names[j], []).append(
                    (float(mae_b[j]), float(mse_b[j]), float(p_b[j]),
                     float(s_b[j]), float(e_b[j])))
    rows, agg = [], {k: [] for k in ("mae", "mse", "psnr", "sam", "ergas")}
    for name in ctx.ds.files:
        arr = np.asarray(per_file[name])
        rows.append([name, cfg.t_start, cfg.ddim_steps, cfg.n_seeds,
                     f"{arr[:, 0].mean():.6f}", f"{arr[:, 0].std():.6f}",
                     f"{arr[:, 1].mean():.6f}", f"{arr[:, 1].std():.6f}",
                     f"{arr[:, 2].mean():.3f}", f"{arr[:, 3].mean():.4f}",
                     f"{arr[:, 4].mean():.2f}"])
        for col, k in enumerate(("mae", "mse", "psnr", "sam", "ergas")):
            agg[k].append(float(arr[:, col].mean()))
    _write_csv(os.path.join(cfg.out_dir, "ddim_true_infer_metrics.csv"),
               ["file", "t_start", "ddim_steps", "seeds", "MAE_mean", "MAE_std",
                "MSE_mean", "MSE_std", "PSNR_mean", "SAM_mean", "ERGAS_mean"], rows)
    _summary(os.path.join(cfg.out_dir, "ddim_true_infer_summary.txt"), [
        f"files: {len(rows)}  t_start: {cfg.t_start}  steps: {cfg.ddim_steps}  "
        f"seeds: {cfg.n_seeds}",
        f"MAE  mean/std: {_mstd(agg['mae'])[0]:.6f} / {_mstd(agg['mae'])[1]:.6f}",
        f"MSE  mean/std: {_mstd(agg['mse'])[0]:.6f} / {_mstd(agg['mse'])[1]:.6f}",
        f"PSNR mean/std: {_mstd(agg['psnr'])[0]:.3f} / {_mstd(agg['psnr'])[1]:.3f}",
        f"SAM  mean/std: {_mstd(agg['sam'])[0]:.4f} / {_mstd(agg['sam'])[1]:.4f}",
        f"ERGAS mean/std: {_mstd(agg['ergas'])[0]:.2f} / {_mstd(agg['ergas'])[1]:.2f}",
    ])
    return {f"{k.upper()}_mean": _mstd(agg[k])[0] for k in ("mae", "mse", "psnr", "sam", "ergas")}


def run_onestep(ctx: EvalContext) -> Dict:
    """On the first batch: the t=0 identity (ε: exactly GT; v: through the
    model, x0̂ = √ᾱ₀·gt − √(1−ᾱ₀)·v̂) and the one-step recon at t_small
    (noise of files 0..B−1, salt 0), with the first file's previews."""
    cfg = ctx.cfg
    (cond, gt, mask), names, n_valid = next(iter(eval_batches(ctx.eval_ds, cfg.batch_size)))
    cond_t, gt_t, mask_t = ctx.tensors(cond, gt, mask)
    if ctx.param is Parameterization.V:
        ab0 = float(ctx.schedule.alpha_bar_np()[0])
        v0 = ctx.denoise_fn(cond_t)(gt_t, torch.zeros((gt_t.shape[0],), dtype=torch.int32,
                                                      device=gt_t.device))
        x0_t0 = torch.clamp(float(np.sqrt(ab0)) * gt_t - float(np.sqrt(1.0 - ab0)) * v0,
                            0.0, 1.0)
        mae0 = float(M.masked_mae(x0_t0, gt_t, mask_t))
        mse0 = float(M.masked_mse(x0_t0, gt_t, mask_t))
    else:
        mae0 = float(M.masked_mae(gt_t, gt_t, mask_t))
        mse0 = float(M.masked_mse(gt_t, gt_t, mask_t))

    x0 = _one_step_sampler(ctx)(cond_t, gt_t, ctx.per_file_noise(list(range(cfg.batch_size))))
    mae = float(M.masked_mae(x0, gt_t, mask_t))
    mse = float(M.masked_mse(x0, gt_t, mask_t))

    x0_first = _np(x0[0])[0]
    _viz(V.save_rgb_triplet, gt[0], os.path.join(cfg.out_dir, "gt_true.png"),
         os.path.join(cfg.out_dir, "gt_cir.png"))
    _viz(V.save_rgb_triplet, x0_first, os.path.join(cfg.out_dir, "pred_true.png"),
         os.path.join(cfg.out_dir, "pred_cir.png"))
    if ctx.param is Parameterization.V:
        lo, hi = V.per_image_lo_hi(gt[0])
        tr, ci = V.fixed_true_cir(x0_first, lo, hi)
        _viz(V.write_png, os.path.join(cfg.out_dir, "pred_true_fixed.png"), tr)
        _viz(V.write_png, os.path.join(cfg.out_dir, "pred_cir_fixed.png"), ci)

    _summary(os.path.join(cfg.out_dir, "onestep_summary.txt"), [
        f"[t=0 identity] MAE={mae0:.6f}  MSE={mse0:.6f}  (should be ~0.0)",
        f"[one-step@t={cfg.t_small}] MAE={mae:.6f}  MSE={mse:.6f}",
    ])
    return {"t0_mae": mae0, "onestep_mae": mae, "onestep_mse": mse}


def _limitation_sampler(ctx: EvalContext):
    """``(cond, x_init, key) → x0̂`` of the limitation mode: ancestral DDPM
    (replaying the whole per-file draw stream of ``--noise_npz``, or drawing
    every tensor from ``key``), full-range ε DDIM from unit noise, or the v
    round-unique grid from ``x_init·√(1−ᾱ_K)`` with η (t_start < 0: the
    full range)."""
    cfg = ctx.cfg
    sched = ctx.schedule
    if cfg.limitation_sampler == "ddpm":
        def sample(cond, x_init, key):
            shape = tuple(cond.shape[:3]) + (ctx.Ct,)
            if x_init is not None:  # the replayed stream: (B, T, H, W, C) → (T, B, H, W, C)
                return ddpm_ancestral(ctx.denoise_fn(cond), shape, sched, ctx.param,
                                      noise=x_init.movedim(1, 0))
            return ddpm_ancestral(ctx.denoise_fn(cond), shape, sched, ctx.param, key=key,
                                  device=cond.device)
        return sample
    if ctx.param is Parameterization.EPS:
        grid = full_range_grid(cfg.T, cfg.ddim_steps)

        def sample(cond, x_init, key):
            return ddim_grid_sample(ctx.denoise_fn(cond), x_init, sched, grid,
                                    Parameterization.EPS, key=key)
        return sample
    K = cfg.T - 1 if cfg.t_start < 0 or cfg.t_start >= cfg.T - 1 else max(1, cfg.t_start)
    grid = round_unique_grid(K, cfg.ddim_steps, cfg.T)
    scale = float(np.sqrt(1.0 - ctx.schedule.alpha_bar_np()[K]))

    def sample(cond, x_init, key):
        return ddim_grid_sample(ctx.denoise_fn(cond), x_init * scale, sched, grid,
                                Parameterization.V, eta=cfg.eta, key=key)
    return sample


def run_limitation(ctx: EvalContext) -> Dict:
    """Full-dataset streaming eval of full-range sampling from pure noise:
    pixel-weighted MAE/MSE/PSNR over all files and per band (and weighted
    by ``--band_weights``), the first ``--save_n`` predictions as
    ``*_pred.npy``/``*_gt.npy`` (CHW) with their previews, and the
    partial-reverse diagnostics on the first batch."""
    cfg = ctx.cfg
    abs_tot = np.zeros(ctx.Ct, np.float64)
    sq_tot = np.zeros(ctx.Ct, np.float64)
    pix_tot = 0.0
    sample = _limitation_sampler(ctx)

    viz_lo = viz_hi = None
    if cfg.viz_mode == "dataset_fixed" and cfg.save_n > 0:
        # one GT in host memory at a time
        gts = (load_patch(ctx.ds.path(i))["target"] for i in range(len(ctx.ds)))
        viz_lo, viz_hi = V.dataset_fixed_lo_hi(gts, cfg.viz_q_low, cfg.viz_q_high)

    # fresh-noise DDPM draws every tensor from the batch key, no init draw
    needs_init = not (cfg.limitation_sampler == "ddpm" and cfg.noise_npz is None)
    saved = 0
    base_key = random.PRNGKey(cfg.seed_base)
    first_batch = None
    for bi, ((cond, gt, mask), names, n_valid) in enumerate(
            eval_batches(ctx.eval_ds, cfg.batch_size)):
        padded = _padded(ctx, names, n_valid)
        x_init = ctx.per_file_noise(padded, salt=LIMITATION_SALT) if needs_init else None
        cond_t, gt_t, mask_t = ctx.tensors(cond, gt, mask)
        x0 = sample(cond_t, x_init, random.fold_in(base_key, bi))
        a, s, w = M.channelwise_error_sums(x0[:n_valid], gt_t[:n_valid], mask_t[:n_valid])
        abs_tot += np.asarray(_np(a)[0], np.float64)
        sq_tot += np.asarray(_np(s)[0], np.float64)
        pix_tot += float(w)
        if first_batch is None:
            first_batch = (cond_t, gt_t, mask_t, padded, n_valid)
        x0_np = _np(x0)[0]
        for j in range(n_valid):
            if saved >= cfg.save_n:
                break
            stem = f"{cfg.limitation_sampler}_{bi:04d}_{j:02d}"
            if viz_lo is not None:
                pt, pc = V.fixed_true_cir(x0_np[j], viz_lo, viz_hi)
                gtt, gtc = V.fixed_true_cir(gt[j], viz_lo, viz_hi)
                _viz(V.write_png, os.path.join(cfg.out_dir, f"{stem}_compare_true.png"),
                     V.hstack_compare(pt, gtt))
                _viz(V.write_png, os.path.join(cfg.out_dir, f"{stem}_compare_cir.png"),
                     V.hstack_compare(pc, gtc))
            else:
                _viz(V.save_pred_gt, x0_np[j], gt[j], cfg.out_dir, stem)
            _viz(np.save, os.path.join(cfg.out_dir, f"{stem}_pred.npy"),
                 np.transpose(x0_np[j], (2, 0, 1)))
            _viz(np.save, os.path.join(cfg.out_dir, f"{stem}_gt.npy"),
                 np.transpose(gt[j], (2, 0, 1)))
            saved += 1

    result = {}
    mae, mse, psnr_v, mae_c, mse_c, psnr_c = M.aggregate_final(abs_tot, sq_tot, pix_tot)
    result.update({"MAE": mae, "MSE": mse, "PSNR": psnr_v})
    lines = [
        "==== Unweighted (equal-channel) ====",
        f"MAE:  {mae:.6f}", f"MSE:  {mse:.6f}", f"PSNR: {psnr_v:.3f} dB",
    ]
    if cfg.band_weights:
        mae_w, mse_w, psnr_w, *_ = M.aggregate_final(abs_tot, sq_tot, pix_tot,
                                                     band_weights=list(cfg.band_weights))
        lines += ["==== Weighted (band_weights) ====",
                  f"band_weights = {list(cfg.band_weights)}",
                  f"MAE_w:  {mae_w:.6f}", f"MSE_w:  {mse_w:.6f}",
                  f"PSNR_w: {psnr_w:.3f} dB"]
        result.update({"MAE_w": mae_w})
    names4 = ["B2", "B3", "B4", "B8"] if ctx.Ct == 4 else [f"Band{i}" for i in range(ctx.Ct)]
    lines.append("-- Per-channel metrics (pixel-weighted) --")
    for i, nm in enumerate(names4):
        lines.append(f"{nm:>3s}:  MAE={mae_c[i]:.6f}  MSE={mse_c[i]:.6f}  PSNR={psnr_c[i]:.3f} dB")

    if cfg.partial_reverse_k and first_batch is not None:
        cond0, gt0, mask0, padded0, nv0 = first_batch
        for k in cfg.partial_reverse_k:
            xr = partial_ddim_from_gt(ctx.denoise_fn(cond0), gt0, ctx.schedule, int(k),
                                      noise=ctx.per_file_noise(padded0, salt=PARTIAL_SALT + int(k)))
            a, s, w = M.channelwise_error_sums(xr[:nv0], gt0[:nv0], mask0[:nv0])
            mae_k, mse_k, psnr_k, *_ = M.aggregate_final(a, s, float(w))
            lines.append(f"[partial-reverse k={int(k)}] MAE={mae_k:.6f}  MSE={mse_k:.6f}  "
                         f"PSNR={psnr_k:.3f} dB")
            result[f"partial_k{int(k)}_MAE"] = mae_k

    _summary(os.path.join(cfg.out_dir, "limitation_summary.txt"), lines)
    return result


def run_baseline(ctx: EvalContext, kind: str) -> Dict:
    """The bicubic or ridge-linear classical baseline with the full metric
    set."""
    cfg = ctx.cfg
    rows, agg = [], {k: [] for k in ("mae", "mse", "psnr", "sam", "ergas")}
    for (cond, gt, mask), names, n_valid in eval_batches(ctx.eval_ds, cfg.batch_size):
        gt_t, mask_t = ctx.tensors(gt, mask)
        if kind == "bicubic":
            pred = baseline_bicubic(gt_t)
        else:
            (pred,) = ctx.tensors(np.stack([
                baseline_linear_fit_predict(cond[j], gt[j], mask[j], seed=cfg.seed_base)
                for j in range(gt.shape[0])]))
        mae_b, mse_b = _np(*M.per_file_mae_mse(pred, gt_t, mask_t))
        p_b, s_b, e_b = _np(*(M.per_sample(f)(pred, gt_t, mask_t)
                              for f in (M.psnr, M.sam, M.ergas)))
        for j in range(n_valid):
            rows.append([names[j], f"{mae_b[j]:.6f}", f"{mse_b[j]:.6f}",
                         f"{p_b[j]:.3f}", f"{s_b[j]:.4f}", f"{e_b[j]:.2f}"])
            for k, v in zip(("mae", "mse", "psnr", "sam", "ergas"),
                            (mae_b, mse_b, p_b, s_b, e_b)):
                agg[k].append(float(v[j]))
    _write_csv(os.path.join(cfg.out_dir, f"baseline_{kind}_metrics.csv"),
               ["file", "MAE", "MSE", "PSNR", "SAM(rad)", "ERGAS"], rows)
    _summary(os.path.join(cfg.out_dir, f"baseline_{kind}_summary.txt"), [
        f"files: {len(rows)}  baseline: {kind}",
        f"MAE  mean/std: {_mstd(agg['mae'])[0]:.6f} / {_mstd(agg['mae'])[1]:.6f}",
        f"MSE  mean/std: {_mstd(agg['mse'])[0]:.6f} / {_mstd(agg['mse'])[1]:.6f}",
        f"PSNR mean/std: {_mstd(agg['psnr'])[0]:.3f} / {_mstd(agg['psnr'])[1]:.3f}",
        f"SAM  mean/std: {_mstd(agg['sam'])[0]:.4f} / {_mstd(agg['sam'])[1]:.4f}",
        f"ERGAS mean/std: {_mstd(agg['ergas'])[0]:.2f} / {_mstd(agg['ergas'])[1]:.2f}",
    ])
    return {"MAE_mean": _mstd(agg["mae"])[0]}


def run_cfg_sweep(ctx: EvalContext) -> Dict:
    """Guidance-scale sweep: for each g, pure-noise DDIM generation with the
    cond/uncond pair stacked into one forward, scored against GT per file
    (MAE, MSE, PSNR); one summary row a scale in ``cfg_sweep_summary.csv``.
    ε: the linspace scan from unit noise; v: the round-unique grid from
    noise·√(1−ᾱ_{t_start}) with η drawn per file (``ETA_SALT``)."""
    cfg = ctx.cfg
    scales = list(cfg.guidance_scales) if cfg.guidance_scales else [1.0, 1.5, 2.0, 3.0, 5.0]
    rows, results, qp_by_g = [], {}, {}

    def cfg_fn(cond, g):
        if cfg.int8:
            return make_quant_cfg_denoise_fn(qp_by_g.get(g, ctx.qparams), cond, g)
        return make_cfg_denoise_fn(ctx.model, cond, g)

    grid = round_unique_grid(cfg.t_start, cfg.ddim_steps, cfg.T)
    scale = float(np.sqrt(np.float32(1.0) - ctx.schedule.alpha_bar_np()[
        min(max(cfg.t_start, 1), cfg.T - 1)]))
    psnr_v = M.per_sample(M.psnr)
    for g in scales:
        if cfg.int8 and cfg.int8_calib == "rollout":
            qp_by_g[g] = ctx.quantize_rollout(float(g))

        def generate(cond, noise, eta_keys, g=float(g)):
            if ctx.param is Parameterization.EPS:
                return _ddim_from_init(cfg_fn(cond, g), noise, ctx.schedule,
                                       cfg.t_start, cfg.ddim_steps)
            return ddim_grid_sample(cfg_fn(cond, g), noise * scale, ctx.schedule, grid,
                                    Parameterization.V, eta=cfg.eta, key=eta_keys)

        maes, mses, psnrs = [], [], []
        viz_left = cfg.save_viz_n
        for (cond, gt, mask), names, n_valid in eval_batches(ctx.eval_ds, cfg.batch_size):
            padded = _padded(ctx, names, n_valid)
            cond_t, gt_t, mask_t = ctx.tensors(cond, gt, mask)
            with torch.no_grad():
                x0 = generate(cond_t, ctx.per_file_noise(padded),
                              ctx.per_file_keys(padded, salt=ETA_SALT))
            n_viz = min(viz_left, n_valid)
            if n_viz > 0:
                x0_np = _np(x0)[0]
                for j in range(n_viz):
                    _viz(V.save_panel, x0_np[j], gt[j], cond[j],
                         os.path.join(ctx.viz_dir,
                                      f"cfg_g{g:g}_{os.path.splitext(names[j])[0]}.png"),
                         title=f"CFG g={g:g}  t_start={cfg.t_start} "
                               f"steps={cfg.ddim_steps}  {names[j]}")
                viz_left -= n_viz
            mae_b, mse_b = _np(*M.per_file_mae_mse(x0, gt_t, mask_t))
            maes += list(mae_b[:n_valid])
            mses += list(mse_b[:n_valid])
            psnrs += list(_np(psnr_v(x0, gt_t, mask_t))[0][:n_valid])
        mae_mu, mae_sd = _mstd(maes)
        rows.append([g, cfg.t_start, cfg.ddim_steps, len(maes),
                     f"{mae_mu:.6f}", f"{mae_sd:.6f}",
                     f"{_mstd(mses)[0]:.6f}", f"{_mstd(psnrs)[0]:.3f}"])
        results[g] = mae_mu
    _write_csv(os.path.join(cfg.out_dir, "cfg_sweep_summary.csv"),
               ["guidance", "t_start", "steps", "files",
                "MAE_mean", "MAE_std", "MSE_mean", "PSNR_mean"], rows)
    return results


def run_night_demo(ctx: EvalContext) -> Dict:
    """GT-free generation panels: ε linspace DDIM from each file's noise at
    ``t_start`` with ``ddim_steps``, one panel a file (S1 | pred | CIR
    pred) until ``max(1, save_viz_n)`` are written; batches after that are
    not run."""
    cfg = ctx.cfg
    n = 0
    for (cond, gt, mask), names, n_valid in eval_batches(ctx.eval_ds, cfg.batch_size):
        (cond_t,) = ctx.tensors(cond)
        noise = ctx.per_file_noise(_padded(ctx, names, n_valid))
        x0 = _ddim_from_init(ctx.denoise_fn(cond_t), noise, ctx.schedule, cfg.t_start,
                             cfg.ddim_steps)
        x0_np = _np(x0)[0]
        for j in range(n_valid):
            if n >= max(1, cfg.save_viz_n):
                return {"panels": n}
            _viz(V.save_panel, x0_np[j], None, cond[j],
                 os.path.join(ctx.viz_dir, f"{n:03d}_night_panel.png"),
                 title=f"Night demo: {names[j]}")
            n += 1
    return {"panels": n}


def cloud_ranking(ctx: EvalContext) -> List[Tuple[float, str, int]]:
    """(−cloud fraction, name, index) of every file, cloudiest first, ties
    by name then index; a file without a cloud layer has fraction 0."""
    fracs = []
    for i, f in enumerate(ctx.ds.files):
        cloud = load_patch(ctx.ds.path(i), with_cloud=True).get("cloud")
        frac = float((cloud > 0.5).mean()) if cloud is not None else 0.0
        fracs.append((-frac, f, i))
    return sorted(fracs)


def run_cloudy_viz(ctx: EvalContext) -> Dict:
    """The ``select_top_cloud`` cloudiest files, reconstructed from t=200 in
    20 steps (``_make_recon_sampler``) on their own noise and η keys, as
    real batches (the last one short, not padded); a panel each with GT, and
    zoom crops per ``--zoom`` / ``--zoom_k``."""
    cfg = ctx.cfg
    selected = cloud_ranking(ctx)[: cfg.select_top_cloud]
    sampler = _make_recon_sampler(ctx, 200, 20)
    n = 0
    for lo in range(0, len(selected), cfg.batch_size):
        chunk = selected[lo: lo + cfg.batch_size]
        items = [load_patch(ctx.ds.path(i)) for _, _, i in chunk]
        idxs = [i for _, _, i in chunk]
        cond_t, gt_t = ctx.tensors(np.stack([d["cond"] for d in items]),
                                   np.stack([d["target"] for d in items]))
        x0 = _np(sampler(cond_t, gt_t, ctx.per_file_noise(idxs),
                         ctx.per_file_keys(idxs, salt=ETA_SALT)))[0]
        for j, (_, fname, _) in enumerate(chunk):
            _viz(V.save_panel, x0[j], items[j]["target"], items[j]["cond"],
                 os.path.join(ctx.viz_dir, f"{n:03d}_cloudy_panel.png"),
                 title=f"Cloudy case: {fname}", zoom=cfg.zoom, zoom_k=cfg.zoom_k)
            n += 1
    return {"panels": len(selected)}


MODES = {
    "onestep": run_onestep,
    "cfg_sweep": run_cfg_sweep,
    "ddim": run_ddim,
    "ddim_sweep": run_ddim_sweep,
    "eps": run_pred_diagnostics,
    "vdiag": run_pred_diagnostics,
    "seed_stats": run_seed_stats,
    "per_band": run_per_band,
    "ablate": run_ablate,
    "tsweep": run_tsweep,
    "true_infer": run_true_infer,
    "night_demo": run_night_demo,
    "cloudy_viz": run_cloudy_viz,
    "baseline_bicubic": partial(run_baseline, kind="bicubic"),
    "baseline_linear": partial(run_baseline, kind="linear"),
    "limitation": run_limitation,
}


def run_mode(cfg: EvalConfig) -> Dict:
    if cfg.mode not in MODES:
        raise ValueError(f"unknown mode {cfg.mode!r}; modes: {sorted(MODES)}")
    if cfg.mode == "vdiag":
        cfg = dataclasses.replace(cfg, pred_param="v")
    return MODES[cfg.mode](EvalContext(cfg))
