"""Evaluation harness: the core every mode shares, and the ``cfg_sweep`` mode.

Port of the JAX package's ``eval/harness.py``. ``EvalConfig`` carries every
field of the JAX config (plus ``device``); ``EvalContext`` loads the dataset
(``--file_list`` in forced order), the schedule (cosine or linear) and the
model (a ``.msgpack`` checkpoint through the port's reader, ``"@random"``
through ``init_params``, or an int8 artifact), quantizes it when asked, and
gives each file its own noise: ``normal(fold_in(PRNGKey(seed_base + salt),
id))`` with the id the file's dataset index or the crc32 of its name, drawn
on the host with the reference's bits (``core/random.py``), or replayed from
``--noise_npz``. Files ride in batches; per-file numbers are per-sample
metrics, so they do not depend on the batch a file lands in.

Ported modes: ``cfg_sweep`` (:data:`MODES`). The other fifteen, the
``.pth`` reader, ``--mesh_data``, ``--cache_dir`` and the preview panels
(``--save_viz_n > 0``) are ROADMAP §1 items 3-4 and raise
``NotImplementedError``.
"""

from __future__ import annotations

import csv
import dataclasses
import os
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from s1s2_torch.core import random
from s1s2_torch.core.parametrize import Parameterization
from s1s2_torch.core.schedule import make_schedule
from s1s2_torch.data.dataset import NpzPatchDataset
from s1s2_torch.data.loader import eval_batches
from s1s2_torch.eval import metrics as M
from s1s2_torch.models.quant import (load_quant, make_cfg_rollout_calib,
                                     make_quant_cfg_denoise_fn, make_quant_denoise_fn,
                                     make_sampler_calib, quantize_unet)
from s1s2_torch.models.unet import init_params, load_unet
from s1s2_torch.models.weights import params_from_numpy
from s1s2_torch.sampling.grids import round_unique_grid
from s1s2_torch.sampling.samplers import (_ddim_linspace_scan, ddim_grid_sample,
                                          make_cfg_denoise_fn, make_denoise_fn)
from s1s2_torch.train.checkpoint import load_params

# Salt offsets partitioning the per-file RNG space (fold_in of the file id
# on PRNGKey(seed_base + salt)): init noise uses salt 0, the η streams
# ETA_SALT, so stochastic-DDIM draws never collide with init draws.
ETA_SALT = 7000

NOT_PORTED = "is not ported yet (ROADMAP §1 items 3-4)"


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


class EvalContext:
    """Loads the dataset and the model once; gives denoise closures and
    per-file noise."""

    def __init__(self, cfg: EvalConfig):
        for flag, on in (("--mesh_data", cfg.mesh_data), ("--cache_dir", cfg.cache_dir),
                         ("--save_viz_n > 0 (preview panels, viz/render.py)",
                          cfg.save_viz_n > 0)):
            if on:
                raise NotImplementedError(f"{flag} {NOT_PORTED}")
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        os.makedirs(cfg.out_dir, exist_ok=True)
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
        self.eval_ds = self.ds
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
            raise NotImplementedError(f"the .pth reader {NOT_PORTED}")
        if path == "@random":  # documented test hook: flax's init from PRNGKey(0)
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
        or its array of ``--noise_npz``."""
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
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


def _mstd(a: Sequence[float]) -> Tuple[float, float]:
    arr = np.asarray(a, np.float64)
    return float(arr.mean()), float(arr.std())  # population std


def _summary(path: str, lines: List[str]) -> None:
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _ddim_from_init(fn, x_init, schedule, t_start, steps):
    """ε linspace DDIM from an explicit init (the pure-generation path)."""
    return _ddim_linspace_scan(fn, x_init, schedule, t_start, steps, (0.0, 1.0))


# ---------------------------------------------------------------------------
# modes
# ---------------------------------------------------------------------------


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
        for (cond, gt, mask), names, n_valid in eval_batches(ctx.eval_ds, cfg.batch_size):
            idxs = [ctx.file_idx[n] for n in names]
            padded = idxs + [idxs[-1]] * (cfg.batch_size - n_valid)
            with torch.no_grad():
                x0 = generate(torch.from_numpy(cond).to(ctx.device),
                              ctx.per_file_noise(padded),
                              ctx.per_file_keys(padded, salt=ETA_SALT))
            gt_j = torch.from_numpy(gt).to(ctx.device)
            mask_j = torch.from_numpy(mask).to(ctx.device)
            mae_b, mse_b = M.per_file_mae_mse(x0, gt_j, mask_j)
            p_b = psnr_v(x0, gt_j, mask_j)
            maes += list(mae_b.cpu().numpy()[:n_valid])
            mses += list(mse_b.cpu().numpy()[:n_valid])
            psnrs += list(p_b.cpu().numpy()[:n_valid])
        mae_mu, mae_sd = _mstd(maes)
        rows.append([g, cfg.t_start, cfg.ddim_steps, len(maes),
                     f"{mae_mu:.6f}", f"{mae_sd:.6f}",
                     f"{_mstd(mses)[0]:.6f}", f"{_mstd(psnrs)[0]:.3f}"])
        results[g] = mae_mu
    _write_csv(os.path.join(cfg.out_dir, "cfg_sweep_summary.csv"),
               ["guidance", "t_start", "steps", "files",
                "MAE_mean", "MAE_std", "MSE_mean", "PSNR_mean"], rows)
    return results


MODES = {
    "cfg_sweep": run_cfg_sweep,
}


def run_mode(cfg: EvalConfig) -> Dict:
    if cfg.mode not in MODES:
        raise NotImplementedError(f"mode {cfg.mode!r} {NOT_PORTED}; ported: {sorted(MODES)}")
    return MODES[cfg.mode](EvalContext(cfg))
