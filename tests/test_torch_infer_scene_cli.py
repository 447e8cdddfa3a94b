"""s1s2_torch infer_scene CLI end to end on the CPU with a tiny model: the
cases of tests/test_infer_scene_cli.py that apply to the port, and the
stitched scene against the JAX package's CLI on the same files."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import s1s2.models as jmodels
import s1s2_torch.models.unet as tunet
from s1s2.cli.infer_scene import main as jax_main
from s1s2_torch.cli.infer_scene import main

COMMON = ["--T", "20", "--base_ch", "4", "--t_start", "15", "--ddim_steps", "3",
          "--patch_size", "32", "--stride", "24", "--batch_size", "2"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port on one torch thread: the test run has a worker a core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A base-4 UNet (flax's init) and a raw 4×64×80 scene with its mask."""
    from s1s2.train.checkpoint import save_model

    d = tmp_path_factory.mktemp("scene")
    v = jmodels.UNetSmall(out_ch=4, base_ch=4, compute_dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 8)), jnp.zeros((1,), jnp.int32))
    ckpt = str(d / "m.msgpack")
    save_model(v["params"], ckpt)
    rng = np.random.default_rng(0)
    np.save(d / "scene.npy", rng.standard_normal((4, 64, 80)).astype(np.float32))  # CHW
    np.save(d / "mask.npy", (rng.random((64, 80)) > 0.05).astype(np.float32))
    return {"ckpt": ckpt, "scene": str(d / "scene.npy"), "mask": str(d / "mask.npy"), "dir": d}


def _files(tiny):
    return ["--scene", tiny["scene"], "--ckpt", tiny["ckpt"]]


def _jax_scene(tiny, out, extra, compute_dtype=jnp.bfloat16):
    """The JAX CLI's scene (its UNetSmall in ``compute_dtype``)."""
    orig = jmodels.UNetSmall
    jmodels.UNetSmall = functools.partial(orig, compute_dtype=compute_dtype)
    try:
        jax_main(_files(tiny) + ["--out_dir", out] + COMMON + extra)
    finally:
        jmodels.UNetSmall = orig
    return np.load(os.path.join(out, "scene_pred.npy"))


def _port_scene(tiny, out, extra, compute_dtype=torch.bfloat16):
    """The port CLI's scene on the CPU (its UNetSmall in ``compute_dtype``)."""
    orig = tunet.load_unet
    tunet.load_unet = functools.partial(orig, compute_dtype=compute_dtype)
    try:
        res = main(_files(tiny) + ["--out_dir", out, "--device", "cpu"] + COMMON + extra)
    finally:
        tunet.load_unet = orig
    assert res["shape"] == [64, 80, 4]
    return np.load(os.path.join(out, "scene_pred.npy"))


@pytest.mark.parametrize("pred_param", ["eps", "v"])
def test_scene_cli(tiny, tmp_path, pred_param):
    out = str(tmp_path / f"out_{pred_param}")
    pred = _port_scene(tiny, out, ["--mask", tiny["mask"], "--pred_param", pred_param,
                                   "--normalize"])
    assert pred.shape == (4, 64, 80)
    assert np.isfinite(pred).all()
    assert os.path.exists(os.path.join(out, "scene_true.png"))
    assert os.path.exists(os.path.join(out, "scene_cir.png"))


@pytest.mark.parametrize("pred_param", ["eps", "v"])
def test_scene_equals_the_jax_cli(tiny, tmp_path, pred_param):
    """Host noise (the same numpy bits in both packages), --normalize with a
    mask, a padded last batch: in f32 the port's scene is within 1e-4 of the
    JAX CLI's (its UNetSmall in f32); in bf16 within the JAX bf16 scene's own
    distance to its f32 scene (mean and max)."""
    extra = ["--mask", tiny["mask"], "--pred_param", pred_param, "--normalize",
             "--seed", "3"]
    j32 = _jax_scene(tiny, str(tmp_path / "j32"), extra, jnp.float32)
    j16 = _jax_scene(tiny, str(tmp_path / "j16"), extra)
    t32 = _port_scene(tiny, str(tmp_path / "t32"), extra, torch.float32)
    t16 = _port_scene(tiny, str(tmp_path / "t16"), extra)
    assert np.abs(t32 - j32).max() <= 1e-4
    gap = np.abs(j16 - j32)
    d = np.abs(t16 - j16)
    assert d.mean() <= gap.mean() and d.max() <= gap.max(), (d.mean(), gap.mean())


def test_fast_transfer_and_device_stitch_equal_the_jax_cli(tiny, tmp_path):
    """--fast_transfer: each tile's noise from its seed (on the CPU the port
    draws jax's normal(PRNGKey(seed)) bits), f16 transfers, 3 batches in
    flight; with --stitch device too. In f32, within the f16 rounding of the
    JAX CLI's scene."""
    for tag, extra in (("fast", ["--fast_transfer"]),
                       ("fast_dev", ["--fast_transfer", "--stitch", "device"])):
        extra = extra + ["--pred_param", "v", "--eta", "0.5", "--seed", "5"]
        a = _jax_scene(tiny, str(tmp_path / f"j_{tag}"), extra, jnp.float32)
        b = _port_scene(tiny, str(tmp_path / f"t_{tag}"), extra, torch.float32)
        np.testing.assert_allclose(b, a, rtol=0, atol=2e-3)


def test_stochastic_v_eta_key_equals_the_jax_cli(tiny, tmp_path):
    """v with η > 0: the η draws come from fold_in(PRNGKey(seed), the bits
    of the batch's first noise value), as the JAX CLI folds them."""
    extra = ["--pred_param", "v", "--eta", "1.0", "--seed", "2"]
    a = _jax_scene(tiny, str(tmp_path / "j"), extra, jnp.float32)
    b = _port_scene(tiny, str(tmp_path / "t"), extra, torch.float32)
    assert np.abs(b - a).max() <= 1e-4


def test_scene_cli_mesh_data_is_not_ported(tiny, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 7"):
        main(_files(tiny) + ["--out_dir", str(tmp_path / "o"), "--device", "cpu",
                             "--mesh_data", "8"] + COMMON)


def test_scene_cli_int8(tiny, tmp_path):
    """--int8 quantizes the scene sampler on the scene's first tiles; the
    output stays finite and shaped, and equals the JAX CLI's --int8 scene
    within the int8 forward's own distance to bf16 (the JAX scene's mean
    |int8 − bf16|)."""
    extra = ["--pred_param", "eps", "--batch_size", "4", "--int8"]
    pred = _port_scene(tiny, str(tmp_path / "out"), extra)
    assert pred.shape == (4, 64, 80)
    assert np.isfinite(pred).all()
    j8 = _jax_scene(tiny, str(tmp_path / "j8"), extra)
    j16 = _jax_scene(tiny, str(tmp_path / "j16"), extra[:-1])
    assert np.abs(pred - j8).mean() <= np.abs(j8 - j16).mean()


def test_scene_cli_dpm2m_with_guidance_equals_the_jax_cli(tiny, tmp_path):
    extra = ["--solver", "dpm2m", "--guidance_scale", "2.0", "--pred_param", "eps"]
    a = _jax_scene(tiny, str(tmp_path / "j"), extra, jnp.float32)
    b = _port_scene(tiny, str(tmp_path / "t"), extra, torch.float32)
    assert np.abs(b - a).max() <= 1e-4


def test_scene_cli_needs_a_card_unless_told_cpu(tiny, tmp_path):
    """The CLI defaults to the card and never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        main(_files(tiny) + ["--out_dir", str(tmp_path / "o")] + COMMON)


def test_dispatcher_runs_infer_scene_and_names_what_is_not_ported(tiny, tmp_path, capsys):
    from s1s2_torch.__main__ import main as dispatch

    assert dispatch(["infer_scene"] + _files(tiny) + ["--out_dir", str(tmp_path / "o"),
                                                        "--device", "cpu"] + COMMON) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["shape"] == [64, 80, 4]
    for cmd, item in (("patchify", "item 7"), ("convert_ckpt", "item 7"),
                      ("validate_parity", "item 7")):
        assert dispatch([cmd]) == 2
        assert item in capsys.readouterr().err
    for cmd, flag in (("train", "--patch_dir"), ("distill", "--endpoint_epochs"),
                      ("make_synthetic", "--rich")):
        with pytest.raises(SystemExit) as e:  # ported: its parser answers --help
            dispatch([cmd, "--help"])
        assert e.value.code == 0 and flag in capsys.readouterr().out
    assert dispatch(["nope"]) == 2 and dispatch([]) == 2
