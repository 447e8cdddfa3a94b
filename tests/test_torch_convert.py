"""The port's reader of the reference's ``.pth`` checkpoints
(``s1s2_torch/models/convert.py``) against the JAX package's converter:
the committed crossval checkpoints load, their converted trees are the
JAX package's bit for bit, and the port's f32 forward on them is within
1e-4 of the JAX forward; the transposed-conv kernel flip reproduces
``nn.ConvTranspose2d``; the architecture is inferred as the JAX package
infers it."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s1s2.models import convert as jconvert
from s1s2.models.torch_twin import build_torch_unet
from s1s2.models.unet import UNetSmall as JUNet
from s1s2.data.synthetic import make_synthetic_patches
from s1s2_torch.cli import quantize as tquantize
from s1s2_torch.eval import harness as th
from s1s2_torch.models import convert as tconvert
from s1s2_torch.models.unet import load_unet
from s1s2_torch.models.weights import params_from_numpy
from s1s2_torch.ops.pixel_shuffle import ps_conv_transpose_2x2
from s1s2_torch.train.checkpoint import load_params

REF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples",
                   "ref_crossval")
PTH = {p: os.path.join(REF, f"ref_{p}_model.pth") for p in ("eps", "v")}


def _leaves(tree):
    return {".".join(p.key for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("param", ["eps", "v"])
def test_committed_pth_loads_into_the_jax_tree(param):
    ref = _leaves(jconvert.load_pth_checkpoint(PTH[param])["params"])
    got = _leaves(tconvert.load_pth_checkpoint(PTH[param])["params"])
    assert sorted(got) == sorted(ref) and len(got) == 34
    for k, v in ref.items():
        assert got[k].dtype == np.float32 and got[k].flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(got[k], v)
    # the checkpoint reader dispatches .pth to the converter
    assert sorted(params_from_numpy(load_params(PTH[param]))) == sorted(ref)


@pytest.mark.parametrize("param", ["eps", "v"])
def test_f32_forward_within_1e4_of_jax(param):
    tree = jconvert.load_pth_checkpoint(PTH[param])
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 32, 32, 8)).astype(np.float32)
    t = np.array([999, 20], np.int32)
    ref = np.asarray(JUNet(out_ch=4, base_ch=16, compute_dtype=jnp.float32).apply(
        tree, jnp.asarray(x), jnp.asarray(t)))
    model = load_unet(params_from_numpy(tconvert.load_pth_checkpoint(PTH[param])["params"]),
                      4, 16, compute_dtype=torch.float32, device="cpu")
    got = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("param", ["eps", "v"])
def test_port_forward_equals_the_reference_module(param):
    """The reference's own module layout (the JAX package's torch twin)
    holding the same state dict computes what the port computes."""
    sd = tconvert.load_pth_state_dict(PTH[param])
    twin = build_torch_unet(**tconvert.infer_arch_from_state_dict(sd)).eval()
    twin.load_state_dict(sd, strict=True)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 32, 32, 8)).astype(np.float32)
    t = np.array([5, 500])
    with torch.no_grad():
        ref = twin(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t))
    model = load_unet(params_from_numpy(tconvert.torch_state_dict_to_params(sd)["params"]),
                      4, 16, compute_dtype=torch.float32, device="cpu")
    got = model(torch.from_numpy(x), torch.from_numpy(t).int())
    np.testing.assert_allclose(got.numpy(), ref.permute(0, 2, 3, 1).numpy(), atol=1e-4, rtol=0)


def test_conv_and_transposed_conv_layouts_equal_jax():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((6, 5, 3, 3)).astype(np.float32)
    np.testing.assert_array_equal(tconvert._conv(w), jconvert._conv(w))
    wt = rng.standard_normal((6, 5, 2, 2)).astype(np.float32)
    got = tconvert._conv_transpose(wt)
    np.testing.assert_array_equal(got, jconvert._conv_transpose(wt))
    assert got.shape == (2, 2, 6, 5) and got[0, 0, 1, 2] == wt[1, 2, 1, 1]


def test_transposed_conv_flip_reproduces_conv_transpose2d():
    """The flipped kernel in the port's 2x2 stride-2 up-conv computes what
    the reference's ``nn.ConvTranspose2d`` computes with the original."""
    torch.manual_seed(0)
    up = torch.nn.ConvTranspose2d(6, 5, 2, stride=2)
    x = torch.randn(2, 6, 4, 7)
    with torch.no_grad():
        ref = up(x).permute(0, 2, 3, 1)
    k = torch.from_numpy(tconvert._conv_transpose(up.weight.detach().numpy()))
    got = ps_conv_transpose_2x2(x.permute(0, 2, 3, 1).contiguous(), k, up.bias.detach())
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=0)


def test_infer_arch_and_unwrap_equal_jax():
    sd = tconvert.load_pth_state_dict(PTH["eps"])
    for wrapped in (sd, {"model": sd}, {"state_dict": sd}):
        got = tconvert.infer_arch_from_state_dict(wrapped)
        assert got == jconvert.infer_arch_from_state_dict(wrapped) == {
            "in_ch": 8, "out_ch": 4, "base_ch": 16}
        assert tconvert.unwrap_state_dict(wrapped) is jconvert.unwrap_state_dict(wrapped)
    assert tconvert.unwrap_state_dict({"model": {"a": 1}}) == {"model": {"a": 1}}


def test_harness_loads_a_pth_and_refuses_another_architecture(tmp_path):
    make_synthetic_patches(str(tmp_path / "p"), n=2, size=32, seed=0)
    base = dict(patch_dir=str(tmp_path / "p"), ckpt=PTH["v"], mode="vdiag", save_viz_n=0,
                device="cpu", batch_size=2)
    res = th.run_mode(th.EvalConfig(out_dir=str(tmp_path / "o"), base_ch=16, **base))
    assert np.isfinite(res["v_mse"])
    with pytest.raises(ValueError, match="architecture"):
        th.run_mode(th.EvalConfig(out_dir=str(tmp_path / "o2"), base_ch=96, **base))


def test_quantize_cli_reads_a_pth(tmp_path):
    make_synthetic_patches(str(tmp_path / "p"), n=2, size=32, seed=0)
    out = tquantize.main(["--ckpt", PTH["eps"], "--patch_dir", str(tmp_path / "p"),
                          "--out", str(tmp_path / "q.msgpack"), "--base_ch", "16",
                          "--n_calib", "2", "--device", "cpu"])
    assert out["calib_files"] == 2 and os.path.getsize(tmp_path / "q.msgpack") > 0
