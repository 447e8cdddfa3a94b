"""s1s2_torch UNetSmall against the JAX UNetSmall on the same numpy inputs
and the same weights: the committed 24x4 checkpoint (full width, 64² patches,
body at 16²) and a small random-init model without the stem."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from s1s2.models import UNetSmall as JUNet
from s1s2_torch.models.unet import UNetSmall, load_unet, max_pool2
from s1s2_torch.models.weights import params_from_numpy, spec_arch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "examples", "checkpoints", "distill_eps_student24x4.bf16.msgpack")


@pytest.fixture(scope="module")
def student():
    with open(CKPT, "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    rng = np.random.default_rng(7)
    x = np.concatenate([rng.standard_normal((3, 64, 64, 4)),
                        rng.random((3, 64, 64, 4))], -1).astype(np.float32)
    t = np.array([200, 100, 20], np.int32)
    return tree, x, t


def _port(tree, dtype, base_ch=24, stem_s2d=4, out_ch=4):
    return load_unet(params_from_numpy(tree), out_ch, base_ch, stem_s2d,
                     compute_dtype=dtype, device="cpu")


def test_f32_forward_matches_jax_on_24x4_checkpoint(student):
    tree, x, t = student
    ref = JUNet(out_ch=4, base_ch=24, stem_s2d=4, compute_dtype=jnp.float32).apply(
        {"params": tree}, jnp.asarray(x), jnp.asarray(t))
    got = _port(tree, torch.float32)(torch.from_numpy(x), torch.from_numpy(t))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 64, 64, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def test_bf16_forward_matches_jax_on_24x4_checkpoint(student):
    """bf16 rounds at other places in the two (JAX rounds each conv's
    product and its bias add separately, the port's conv once; the 2×2 up
    conv is a matmul here and a transposed conv there), and the differences
    compound over the network's depth: mean |Δ| ≤ 1.5% of mean |ε| and
    max |Δ| ≤ 0.25 on ε of unit scale."""
    tree, x, t = student
    ref = np.asarray(JUNet(out_ch=4, base_ch=24, stem_s2d=4, compute_dtype=jnp.bfloat16).apply(
        {"params": tree}, jnp.asarray(x), jnp.asarray(t)))
    got = _port(tree, torch.bfloat16)(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    d = np.abs(got - ref)
    assert d.mean() <= 0.015 * np.abs(ref).mean(), d.mean()
    assert d.max() <= 0.25, d.max()


@pytest.mark.parametrize("stem_s2d,H", [(1, 16), (2, 16)])
def test_f32_forward_matches_jax_random_init(stem_s2d, H):
    """A narrow random-init model (base 8), with and without a 2× stem."""
    rng = np.random.default_rng(stem_s2d)
    x = rng.standard_normal((2, H, H, 7)).astype(np.float32)
    t = np.array([999, 3], np.int32)
    jm = JUNet(out_ch=3, base_ch=8, stem_s2d=stem_s2d, compute_dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t))["params"]
    ref = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t))
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = load_unet(params_from_numpy(tree), 3, 8, stem_s2d, in_ch=7,
                      compute_dtype=torch.float32, device="cpu")
    got = model(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def test_state_dict_names_mirror_the_jax_tree(student):
    tree, _, _ = student
    state = params_from_numpy(tree)
    assert all(v.dtype == torch.float32 for v in state.values())
    model = UNetSmall(4, 24, 4)
    assert set(model.state_dict()) == set(state)
    for k, v in model.state_dict().items():
        assert tuple(v.shape) == tuple(state[k].shape), k


def test_params_from_numpy_is_exact_for_bf16(student):
    tree, _, _ = student
    state = params_from_numpy(tree)
    np.testing.assert_array_equal(state["inc.kernel"].numpy(),
                                  np.asarray(tree["inc"]["kernel"], np.float32))


def test_spec_arch():
    assert spec_arch("24x4") == (24, 4)
    assert spec_arch("16") == (16, 1)
    assert spec_arch("1") == (96, 1)


def test_max_pool2_matches_jax():
    import flax.linen as nn

    x = np.random.default_rng(0).standard_normal((2, 8, 6, 3)).astype(np.float32)
    ref = nn.max_pool(jnp.asarray(x), (2, 2), (2, 2))
    np.testing.assert_array_equal(max_pool2(torch.from_numpy(x)).numpy(), np.asarray(ref))


def test_raw_timestep_channel_rounds_like_jax_in_bf16():
    """t=999 is not a bf16 value: it is cast to f32 first, then to bf16, in
    both; the model output depends on it."""
    from s1s2_torch.models.unet import input_map

    x = torch.zeros((1, 4, 4, 2))
    got = input_map(x, torch.tensor([999], dtype=torch.int32), 1, torch.bfloat16)
    ref = jnp.asarray(jnp.float32(999)).astype(jnp.bfloat16)
    assert float(got[0, 0, 0, -1]) == float(ref)
