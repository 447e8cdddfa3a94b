"""s1s2_torch's eval harness against the JAX harness in f32, mode by mode:
every CSV and summary cell within one unit of its last printed digit, the
limitation mode's ``*_pred.npy``/``*_gt.npy`` arrays, and every PNG the
JAX harness writes, decoded with PIL, against the port's (which its own
encoder wrote). Same small setting as ``test_torch_modes.py``."""

import glob
import os

import numpy as np
import pytest
from PIL import Image

import test_torch_modes as common
from s1s2.viz import render as jrender
from s1s2_torch.viz import render as trender

CASES = common.CASES
# previews that must decode to the JAX harness's pixels exactly; per_band's
# one-step predictions differ from JAX's in the 7th digit (f32 sums in
# another order), which can move a stretched pixel by one level
PNG_SLACK = {"per_band": 1}


@pytest.fixture(scope="module")
def patches(tmp_path_factory):
    return common.make_patches(tmp_path_factory)


one_torch_thread = common.one_torch_thread


def _pngs(d):
    return sorted(os.path.relpath(p, d) for p in glob.glob(os.path.join(d, "**", "*.png"),
                                                          recursive=True))


@pytest.mark.parametrize("name", list(CASES))
def test_mode_f32_against_jax(patches, tmp_path, name):
    kw = dict(CASES[name])
    if name in ("ddim", "per_band"):
        kw["save_viz_n"] = 3
    jdir, pdir, rj, rt = common.run_both(patches, str(tmp_path), compute_dtype="float32", **kw)
    common.assert_tables_match(jdir, pdir, 0.0)
    common.assert_results_match(rj, rt, 1e-5)
    # the arrays (limitation): 20 DDPM steps or 4 DDIM steps from pure noise
    # amplify f32 reordering to ~5e-5
    npys = sorted(os.path.basename(p) for p in glob.glob(os.path.join(jdir, "*.npy")))
    assert npys == sorted(os.path.basename(p) for p in glob.glob(os.path.join(pdir, "*.npy")))
    for f in npys:
        ref, got = np.load(os.path.join(jdir, f)), np.load(os.path.join(pdir, f))
        assert got.dtype == np.float32 and got.shape == ref.shape == (4, common.SIZE,
                                                                      common.SIZE)
        if f.endswith("_gt.npy"):
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    pngs = _pngs(jdir)
    assert pngs == _pngs(pdir)
    for f in pngs:
        with Image.open(os.path.join(jdir, f)) as a, Image.open(os.path.join(pdir, f)) as b:
            assert b.mode == a.mode == "RGB"
            ref, got = np.asarray(a, np.int16), np.asarray(b, np.int16)
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= PNG_SLACK.get(name, 0), f


def test_previews_written_where_the_jax_harness_writes_them(patches, tmp_path):
    """The files of the modes that write previews: ddim's and per_band's
    first files, onestep's GT and prediction (v: with the fixed-range
    pair), limitation's six-file sets."""
    _, pdir, _, _ = common.run_both(patches, str(tmp_path / "o"), mode="onestep",
                                    pred_param="v")
    assert _pngs(pdir) == sorted(["gt_true.png", "gt_cir.png", "pred_true.png", "pred_cir.png",
                                  "pred_true_fixed.png", "pred_cir_fixed.png"])
    _, pdir, _, _ = common.run_both(patches, str(tmp_path / "l"), mode="limitation",
                                    ddim_steps=2, t_start=-1, save_n=1)
    assert _pngs(pdir) == sorted(f"ddim_0000_00_{k}.png" for k in (
        "pred_true", "gt_true", "pred_cir", "gt_cir", "compare_true", "compare_cir"))


@pytest.mark.parametrize("shape", [(32, 32, 4), (7, 13, 4), (1, 1, 4)])
def test_renderers_and_encoder_pixel_equal_to_pil(tmp_path, shape):
    """On the same array the port's stretches and its PNG encoder give the
    pixels the JAX package's renderer writes with PIL."""
    rng = np.random.default_rng(sum(shape))
    x = rng.random(shape, dtype=np.float32)
    g = rng.random(shape, dtype=np.float32)
    jrender.save_rgb_triplet(x, str(tmp_path / "jt.png"), str(tmp_path / "jc.png"))
    trender.save_rgb_triplet(x, str(tmp_path / "tt.png"), str(tmp_path / "tc.png"))
    jrender.save_pred_gt(x, g, str(tmp_path / "j"), "s")
    trender.save_pred_gt(x, g, str(tmp_path / "t"), "s")
    lo, hi = jrender.dataset_fixed_lo_hi([g, x])
    tlo, thi = trender.dataset_fixed_lo_hi(iter([g, x]))
    np.testing.assert_array_equal(tlo, lo)
    np.testing.assert_array_equal(thi, hi)
    for a, b in zip(jrender.fixed_true_cir(x, lo, hi), trender.fixed_true_cir(x, lo, hi)):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(trender.s1_preview(x[..., :2]), jrender.s1_preview(x[..., :2]))
    pairs = [("jt.png", "tt.png"), ("jc.png", "tc.png")] + [
        (f"j/s_{k}.png", f"t/s_{k}.png") for k in ("pred_true", "gt_true", "pred_cir", "gt_cir",
                                                   "compare_true", "compare_cir")]
    for j, t in pairs:
        with Image.open(tmp_path / j) as a, Image.open(tmp_path / t) as b:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_png_encoder_refuses_what_it_cannot_write(tmp_path):
    with pytest.raises(ValueError):
        trender.write_png(str(tmp_path / "x.png"), np.zeros((4, 4, 4), np.uint8))
    with pytest.raises(ValueError):
        trender.write_png(str(tmp_path / "x.png"), np.zeros((4, 4, 3), np.float32))
