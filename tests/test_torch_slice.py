"""The whole main path of the port (``run_headline``) on the CPU at a small
size, against the JAX package's headline recipe (bench.py ``rung``) on the
same data, the same calibration noise and the same sampling noise."""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from s1s2.core import Schedule as JSchedule
from s1s2.data.dataset import NpzPatchDataset as JDataset
from s1s2.data.synthetic import make_synthetic_patches as j_make_synthetic
from s1s2.eval.metrics import masked_mae as j_masked_mae
from s1s2.eval.metrics import masked_mse as j_masked_mse
from s1s2.eval.metrics import per_file_mae_mse as j_per_file
from s1s2.models import quant as jq
from s1s2.sampling import ddim_anchored as j_ddim_anchored
from s1s2_torch.data.synthetic import make_synthetic_patches
from s1s2_torch.eval import metrics as tm
from s1s2_torch.headline import CALIB_TVALS, NOISE_SEED, evidence_set, run_headline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "examples", "checkpoints", "distill_eps_student24x4.bf16.msgpack")
N_FILES, SIZE = 4, 64


def _jax_headline(n_files, size):
    """bench.py's rung() recipe: calibration from make_sampler_calib
    (PRNGKey(5)), evidence noise jax.random.normal(PRNGKey(1234))."""
    with tempfile.TemporaryDirectory() as td:
        j_make_synthetic(td, n=n_files, size=size, seed=0, compress=False)
        ds = JDataset(td)
        items = [ds[i] for i in range(len(ds))]
    cond = jnp.asarray(np.stack([it["cond"] for it in items]))
    gt = jnp.asarray(np.stack([it["target"] for it in items]))
    mask = jnp.asarray(np.stack([it["mask"] for it in items]))
    sched = JSchedule.cosine(1000)
    calib = jq.make_sampler_calib(gt, cond, sched.alpha_bar_np(), CALIB_TVALS)
    with open(CKPT, "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    qp = jq.quantize_unet(tree, calib, base_ch=24, stem_s2d=4)
    key = jax.random.PRNGKey(NOISE_SEED)
    pred = j_ddim_anchored(jq.make_quant_denoise_fn(qp, cond), gt, key, sched, 200, 1,
                           noise=jax.random.normal(key, gt.shape))
    return float(j_masked_mae(pred, gt, mask)), np.asarray(pred)


@pytest.fixture(scope="module")
def both():
    port = run_headline("24x4", batch=N_FILES, device="cpu", n_files=N_FILES, size=SIZE)
    return port, _jax_headline(N_FILES, SIZE)


def test_headline_mae_matches_jax(both):
    """The evidence MAE of the port's int8 DDIM-1 against the JAX package's
    on the same inputs and the same draws (calibration and evidence noise
    from jax's keys): within 2e-4 (the int8 paths differ where a bf16 ulp
    moves an activation across a quantization step, ROADMAP §3)."""
    port, (j_mae, _) = both
    assert abs(port["mae"] - j_mae) <= 2e-4, (port["mae"], j_mae)


def test_headline_result_is_well_formed(both):
    port, (_, j_pred) = both
    assert port["pred_shape"] == j_pred.shape == (N_FILES, SIZE, SIZE, 4)
    assert port["pred_finite"]
    assert port["device"] == "cpu" and port["patches_per_s"] is None
    assert port["n_params"] == 1107208
    assert port["expect_mae"] == 0.32764
    # on the CPU the wrappers run their plain versions: no kernel launches
    assert set(port["evidence_launches"].values()) == {0}
    assert set(port["qp"].act_scale) == {
        f"{b}.{c}" for b in ("down1", "down2", "down3", "conv3", "conv2", "conv1")
        for c in ("conv1", "conv2")} | {"up3", "up2", "up1"}


def test_evidence_set_same_bytes_as_jax(tmp_path):
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    a = make_synthetic_patches(str(ours), n=3, size=32, seed=0, compress=False)
    b = j_make_synthetic(str(theirs), n=3, size=32, seed=0, compress=False)
    for pa, pb in zip(a, b):
        with open(pa, "rb") as fa, open(pb, "rb") as fb:
            assert fa.read() == fb.read()
    cond, gt, mask = evidence_set(3, 32)
    assert cond.shape == gt.shape == (3, 32, 32, 4) and mask.shape == (3, 32, 32)


@pytest.mark.parametrize("mask_kind", ["none", "hw", "hw1"])
def test_metrics_match_jax(rng, mask_kind):
    pred = rng.random((3, 16, 16, 4)).astype(np.float32)
    tgt = rng.random((3, 16, 16, 4)).astype(np.float32)
    mask = {"none": None, "hw": (rng.random((3, 16, 16)) > 0.3).astype(np.float32),
            "hw1": (rng.random((3, 16, 16, 1)) > 0.3).astype(np.float32)}[mask_kind]
    tmask = None if mask is None else torch.from_numpy(mask)
    jmask = None if mask is None else jnp.asarray(mask)
    tp, tt = torch.from_numpy(pred), torch.from_numpy(tgt)
    jp, jt = jnp.asarray(pred), jnp.asarray(tgt)
    # f32 sums in another order: a few ulps
    np.testing.assert_allclose(float(tm.masked_mae(tp, tt, tmask)),
                               float(j_masked_mae(jp, jt, jmask)), rtol=1e-6)
    np.testing.assert_allclose(float(tm.masked_mse(tp, tt, tmask)),
                               float(j_masked_mse(jp, jt, jmask)), rtol=1e-6)
    for g, r in zip(tm.per_file_mae_mse(tp, tt, tmask), j_per_file(jp, jt, jmask)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6)


def test_all_masked_out_is_zero_not_nan():
    z = torch.zeros((1, 4, 4, 2))
    assert float(tm.masked_mae(z, z + 1, torch.zeros((1, 4, 4)))) == 0.0
