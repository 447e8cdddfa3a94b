"""The epoch-level training loop on one device.

Port of the JAX package's ``train/trainer.py``: the flax init (bit for bit,
``models.unet.init_params``), one step per batch with the metrics read back
one step late (no per-step host sync), the reference's EMA-weighted
``_last`` / ``_best`` / final model files with a ``.loss.json`` sidecar that
keeps the best loss across restarts, the resumable state every
``save_every`` epochs, resume at ``step // steps_per_epoch + 1`` (the same
shuffle and the same per-step noise as an unbroken run), a metrics JSONL
and a ``torch.profiler`` trace of epoch 1. The JAX trainer's mesh options
(``spatial_shard``, ``model_shard > 1``) are not ported.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from s1s2_torch.core import random
from s1s2_torch.core.schedule import Schedule
from s1s2_torch.data.dataset import NpzPatchDataset
from s1s2_torch.data.loader import MmapCache, batch_iterator
from s1s2_torch.models.unet import UNetSmall, init_params
from s1s2_torch.train.checkpoint import (reference_artifact_paths, restore_state, save_model,
                                         save_state, state_file)
from s1s2_torch.train.loop import TrainConfig, create_train_state, make_train_step
from s1s2_torch.utils.profiling import MetricsLogger, trace_context

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass
class RunConfig:
    """Run-level settings: the JAX package's fields, plus ``device``."""

    patch_dir: str
    model_path: str  # .msgpack; _last/_best siblings are derived
    epochs: int = 40
    batch_size: int = 4
    base_ch: int = 96
    max_patches: Optional[int] = None
    seed: int = 1337
    schedule: str = "cosine"
    log_every: int = 50
    save_state_dir: Optional[str] = None  # resume state directory
    resume: bool = False  # restore params+opt+EMA+step from save_state_dir
    spatial_shard: bool = False
    model_shard: int = 1
    compute_dtype: str = "bfloat16"
    profile_dir: Optional[str] = None  # torch.profiler trace of epoch 1
    metrics_jsonl: Optional[str] = None  # structured metrics sink
    remat: bool = False  # recompute UNet blocks in the backward (memory ↔ FLOPs)
    cache_dir: Optional[str] = None  # MmapCache dir (decompress npz once)
    save_every: int = 1  # checkpoint cadence in epochs (last/best/state)
    device: str = "cuda"


def resolve_device(name, what: str = "training") -> torch.device:
    """``name`` as a device; a CUDA device gets its index, and with no card
    it raises: ``what`` runs on the card unless the caller asks for the CPU."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{what} runs on the card by default and no CUDA card is "
                               "present; pass --device cpu to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def train_loop(run: RunConfig, cfg: TrainConfig,
               progress: Optional[Callable[[dict], None]] = None) -> dict:
    """A full training run → history dict (``epoch_loss``, ``steps_per_sec``,
    ``best_loss``, ``skipped``, ``final_state``)."""
    if run.save_every < 1:
        raise ValueError(f"save_every must be >= 1, got {run.save_every}")
    if run.spatial_shard or run.model_shard > 1:
        raise NotImplementedError("spatial_shard and model_shard > 1 shard the step over a "
                                  "device mesh: not ported yet (ROADMAP §1 item 7, 7c)")
    device = resolve_device(run.device)
    ds = NpzPatchDataset(run.patch_dir, max_files=run.max_patches)
    Cc, Ct, H, W = ds.probe_channels()
    if run.cache_dir:
        ds = MmapCache(ds, run.cache_dir)

    schedule = Schedule.cosine(cfg.T) if run.schedule == "cosine" else Schedule.linear(cfg.T)
    model = UNetSmall(out_ch=Ct, base_ch=run.base_ch, in_ch=Cc + Ct,
                      compute_dtype=DTYPES[run.compute_dtype], autograd=True, remat=run.remat)
    mlog = MetricsLogger(run.metrics_jsonl) if run.metrics_jsonl else None
    params = init_params(Ct, run.base_ch, 1, seed=run.seed, in_ch=Cc + Ct)
    state = create_train_state(params, cfg, device)
    start_epoch = 1
    if run.resume and run.save_state_dir and os.path.exists(state_file(run.save_state_dir)):
        state = restore_state(run.save_state_dir, template=state)
        # the state is saved at epoch boundaries, so its step locates the next
        # epoch; that epoch replays the unbroken run's shuffle (seed, epoch)
        # and noise (fold_in(key, step))
        steps_per_epoch = len(ds) // run.batch_size
        if steps_per_epoch > 0:
            start_epoch = state.step // steps_per_epoch + 1
        if progress:
            progress({"resumed_at_step": state.step, "resumed_at_epoch": start_epoch})

    step = make_train_step(model, schedule, cfg)
    key = random.PRNGKey(run.seed + 1)

    final_path, last_path, best_path = reference_artifact_paths(run.model_path)
    # the best loss survives restarts in a sidecar next to model_best: the
    # state file holds no loss, and a post-resume save must not overwrite a
    # better model_best
    best_sidecar = best_path + ".loss.json"
    best_loss = float("inf")
    if start_epoch > 1 and os.path.exists(best_sidecar):
        with open(best_sidecar) as f:
            best_loss = float(json.load(f)["best_loss"])
    history = {"epoch_loss": [], "steps_per_sec": []}

    try:
        for epoch in range(start_epoch, run.epochs + 1):
            running, n_batches = 0.0, 0
            t0 = time.perf_counter()
            with trace_context(run.profile_dir if epoch == 1 else None):
                # metrics are read one step late: the host never waits on the
                # step in flight
                pending = None
                for batch in batch_iterator(ds, run.batch_size, shuffle=True, drop_last=True,
                                            seed=run.seed, epoch=epoch):
                    state, metrics = step(state, batch, key)
                    if pending is not None:
                        v = float(pending["loss"])
                        if np.isfinite(v):
                            running += v
                            n_batches += 1
                    pending = metrics
                    if progress and n_batches and n_batches % run.log_every == 0:
                        ch = pending["ch_losses"].cpu().numpy()
                        progress({"epoch": epoch, "step": state.step,
                                  "loss": running / max(1, n_batches),
                                  "p2": float(pending["p2_w"]),
                                  "skipped": int(state.skipped),
                                  **{f"ch{i}": round(float(v), 6)
                                     for i, v in enumerate(ch[:4])}})
                if pending is not None:
                    v = float(pending["loss"])
                    if np.isfinite(v):
                        running += v
                        n_batches += 1
            dt = time.perf_counter() - t0
            avg_loss = running / max(1, n_batches)
            history["epoch_loss"].append(avg_loss)
            history["steps_per_sec"].append(n_batches / max(dt, 1e-9))

            # the EMA-weighted last/best/final triple; save_every > 1 saves less
            # often, "best" then being the best at the save points; the last epoch
            # always saves, and resume granularity equals the cadence
            do_save = (epoch % run.save_every == 0) or epoch == run.epochs
            if do_save:
                save_model(state.ema_tree(), last_path)
                if avg_loss < best_loss:
                    best_loss = avg_loss
                    save_model(state.ema_tree(), best_path)
                    with open(best_sidecar, "w") as f:
                        json.dump({"best_loss": best_loss, "epoch": epoch}, f)
                if run.save_state_dir:
                    save_state(state, run.save_state_dir)
            skipped = int(state.skipped)
            if progress:
                progress({"epoch": epoch, "avg_loss": avg_loss, "skipped": skipped,
                          "epoch_time_s": dt})
            if mlog:
                mlog.log(epoch=epoch, avg_loss=avg_loss, skipped=skipped, epoch_time_s=dt,
                         steps_per_sec=history["steps_per_sec"][-1])
    finally:
        if mlog:
            mlog.close()
    save_model(state.ema_tree(), final_path)
    history["best_loss"] = best_loss
    history["skipped"] = int(state.skipped)
    history["final_state"] = state
    return history
