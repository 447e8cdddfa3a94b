"""``s1s2_torch/tools/bench_quality_matched.py`` against the JAX tool's
scoring on the same inputs: a base-8 checkpoint written by the JAX package
(its init from ``PRNGKey(0)``), 3 synthetic files of 32², the noise
``normal(PRNGKey(1234))``; the rows ddim 20/10/5 and dpm2m 10/5 from
t=200, bf16 and with ``--int8``, computed here with the JAX package's
``ddim_anchored``, ``dpm_solver_2m``, ``q_sample`` and quantization as the
JAX tool computes them (the JAX denoisers jitted). Tolerances on a row's
MAE: 5e-5 in bf16 (nets that round at other places, through up to 20
steps; measured 5e-6), 1e-3 in int8 (a one-ulp bf16 difference can move an
activation across an int8 step; measured 8e-5), 1e-6 in f32 (sums in
other orders; measured 0). Then the summary's keys, and the tool's main on
the checkpoint and as a one-epoch soak, with the model's base patched down
to 8."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s1s2.core import Schedule as JSchedule
from s1s2.core.parametrize import Parameterization, q_sample
from s1s2.data.dataset import NpzPatchDataset
from s1s2.data.synthetic import make_synthetic_patches
from s1s2.models import UNetSmall as JUNet
from s1s2.models.quant import make_quant_denoise_fn, make_sampler_calib, quantize_unet
from s1s2.sampling import ddim_anchored, dpm_solver_2m, make_denoise_fn
from s1s2.sampling.grids import round_unique_grid
from s1s2.train.checkpoint import save_model
from s1s2_torch.data.dataset import load_set
from s1s2_torch.models.unet import UNetSmall
from s1s2_torch.models.weights import params_from_numpy
from s1s2_torch.tools import bench_quality_matched as bqm
from s1s2_torch.train.checkpoint import load_model

torch.set_num_threads(1)
BASE, SIZE, N, T0 = 8, 32, 3, 200
TOL = {"bf16": 5e-5, "int8": 1e-3, "f32": 1e-6}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    root = tmp_path_factory.mktemp("qm")
    patches = str(root / "patches")
    make_synthetic_patches(patches, n=N, size=SIZE, seed=0)
    params = jax.jit(JUNet(out_ch=4, base_ch=BASE).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 8), jnp.float32),
        jnp.zeros((1,), jnp.int32))["params"]
    ckpt = str(root / "m.msgpack")
    save_model(params, ckpt)
    return dict(root=root, patches=patches, params=params, ckpt=ckpt)


def _jax_rows(case, dtype, int8):
    """The JAX tool's scoring loop, on the JAX package."""
    ds = NpzPatchDataset(case["patches"])
    items = [ds[i] for i in range(len(ds))]
    cond = jnp.asarray(np.stack([it["cond"] for it in items]))
    gt = jnp.asarray(np.stack([it["target"] for it in items]))
    mask = np.stack([np.ones(it["target"].shape[:2], np.float32) if it["mask"] is None
                     else it["mask"] for it in items])
    schedule = JSchedule.cosine(1000)
    key = jax.random.PRNGKey(1234)
    noise = jax.random.normal(key, gt.shape)
    ab = schedule.alpha_bar_np()

    def mae(pred):
        m = mask[..., None]
        return float(np.abs((np.asarray(pred) - np.asarray(gt)) * m).sum()
                     / (m.sum() * gt.shape[-1]))

    model = JUNet(out_ch=4, base_ch=BASE, compute_dtype=dtype)
    # the denoisers jitted (one compile each, not an eager net per step)
    fns = {"": jax.jit(make_denoise_fn(model.apply, {"params": case["params"]}, cond))}
    if int8:
        qp = quantize_unet(case["params"], make_sampler_calib(
            gt, cond, ab, (T0, T0 // 2, 5), noise=noise))
        fns["_int8"] = jax.jit(make_quant_denoise_fn(qp, cond))
    rows = {}
    for suffix, f in fns.items():
        for steps in (20, 10, 5):
            rows[(f"ddim{suffix}", steps)] = mae(
                ddim_anchored(f, gt, key, schedule, T0, steps, noise=noise))
        for steps in (10, 5):
            grid = round_unique_grid(T0, steps, 1000)
            K = int(grid[-1])
            x_init = q_sample(gt, noise, float(np.sqrt(ab[K])), float(np.sqrt(1.0 - ab[K])))
            rows[(f"dpm2m{suffix}", steps)] = mae(
                dpm_solver_2m(f, x_init, schedule, grid, Parameterization.EPS))
    return rows


def _port_params(case):
    return params_from_numpy(load_model(UNetSmall(4, BASE).state_dict(), case["ckpt"]))


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_rows_against_jax(case, dtype):
    int8 = dtype == "bf16"
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16),
                "f32": (jnp.float32, torch.float32)}[dtype]
    ref = _jax_rows(case, jdt, int8)
    cond, gt, mask = load_set(case["patches"], "cpu")
    lines = []
    got = bqm.score(_port_params(case), cond, gt, mask, T0, int8, BASE, tdt, lines.append)
    assert list(got) == list(ref) and len(lines) == len(ref) == (10 if int8 else 5)
    for k, v in got.items():
        tol = TOL["int8"] if k[0].endswith("_int8") else TOL[dtype]
        assert abs(v - ref[k]) <= tol, (k, v, ref[k])
    assert json.loads(lines[0]) == {"sampler": "ddim", "steps": 20,
                                    "mae": round(got[("ddim", 20)], 5)}
    s = bqm.summary(got, "w")
    assert set(s) == ({"quality_matched", "ddim20_mae", "dpm2m5_mae", "workdir"}
                      | ({"dpm2m5_int8_mae", "quality_matched_int8"} if int8 else set()))
    assert s["quality_matched"] == (got[("dpm2m", 5)] <= got[("ddim", 20)] * 1.01)


def test_main_on_a_checkpoint_and_as_a_soak(case, tmp_path, monkeypatch):
    monkeypatch.setattr(bqm, "BASE", BASE)
    lines = []
    out = bqm.main(["--ckpt", case["ckpt"], "--n", str(N), "--size", str(SIZE), "--int8",
                    "--out", str(case["root"]), "--device", "cpu"], emit=lines.append)
    last = json.loads(lines[-1])
    assert last == out["summary"] and last["workdir"] == str(case["root"])
    assert {"dpm2m5_int8_mae", "quality_matched_int8"} <= set(last) and len(lines) == 11
    soak = []
    res = bqm.main(["--epochs", "1", "--n", "2", "--size", "16", "--batch", "2",
                    "--out", str(tmp_path), "--device", "cpu"], emit=soak.append)
    assert os.path.isfile(tmp_path / "soak.msgpack") and len(res["rows"]) == 5
    assert any("avg_loss" in json.loads(ln) for ln in soak[:-6])
    assert json.loads(soak[-1])["workdir"] == str(tmp_path)
