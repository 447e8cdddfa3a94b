"""The port's threefry2x32 PRNG (``s1s2_torch/core/random.py``, numpy only)
against jax's on the CPU: the raw bits, ``uniform``, ``split`` and
``fold_in`` bit for bit; ``normal`` and ``truncated_normal`` within 2
float32 ulp (XLA may fuse a multiply and an add into one rounding where
numpy would round twice; the port computes those fused steps exactly, so
on this jax they come out equal); flax's per-module keys and the base-8
UNet's init within 2 ulp, leaf by leaf."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax.core import scope as flax_scope

from s1s2.models import UNetSmall as JUNet
from s1s2_torch.core import random
from s1s2_torch.models.unet import init_params
from s1s2_torch.models.weights import params_from_numpy

SEEDS = (0, 5, 1234, 2 ** 32 - 1)
SHAPES = ((), (7,), (3, 5, 2), (1001,), (2, 33, 17))


def _ulps(a, b) -> int:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max(initial=0))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_split_and_fold_in_bit_equal(seed):
    kj, kn = jax.random.PRNGKey(seed), random.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(kj), kn)
    for num in (1, 2, 3, 8):
        np.testing.assert_array_equal(np.asarray(jax.random.split(kj, num)),
                                      random.split(kn, num))
    for data in (0, 1, 77, 2 ** 31 + 5, 2 ** 32 - 1):
        np.testing.assert_array_equal(np.asarray(jax.random.fold_in(kj, data)),
                                      random.fold_in(kn, data))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_and_uniform_bit_equal(seed, shape):
    kj, kn = jax.random.PRNGKey(seed), random.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(jax.random.bits(kj, shape, jnp.uint32)),
                                  random.random_bits(kn, shape))
    np.testing.assert_array_equal(np.asarray(jax.random.uniform(kj, shape)),
                                  random.uniform(kn, shape))
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(kj, shape, minval=-0.3, maxval=2.5)),
        random.uniform(kn, shape, -0.3, 2.5))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES + ((300_001,),))
def test_normal_and_truncated_normal_within_2_ulp(seed, shape):
    kj, kn = jax.random.PRNGKey(seed), random.PRNGKey(seed)
    assert _ulps(jax.random.normal(kj, shape), random.normal(kn, shape)) <= 2
    for lo, hi in ((-2.0, 2.0), (-1.0, 3.0)):
        got = random.truncated_normal(kn, lo, hi, shape)
        assert _ulps(jax.random.truncated_normal(kj, lo, hi, shape), got) <= 2
        assert got.size == 0 or (got.min() > lo and got.max() < hi)


def test_a_batch_of_keys_draws_one_stream_per_key():
    keys = jax.random.split(jax.random.PRNGKey(3), 5)
    kn = np.asarray(keys)
    np.testing.assert_array_equal(np.asarray(jax.vmap(lambda k: jax.random.split(k, 4))(keys)),
                                  random.split(kn, 4))
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (9, 3)))(keys)),
        random.uniform(kn, (9, 3)))
    assert _ulps(jax.vmap(lambda k: jax.random.normal(k, (4, 7, 3)))(keys),
                 random.normal(kn, (4, 7, 3))) <= 2
    np.testing.assert_array_equal(np.asarray(jax.vmap(lambda k: jax.random.fold_in(k, 9))(keys)),
                                  random.fold_in(kn, 9))


def test_erf_and_erf_inv_follow_xla():
    x = np.linspace(-0.999999, 0.999999, 200_001, dtype=np.float32)
    assert _ulps(jax.lax.erf_inv(x), random.erf_inv(x)) <= 2
    assert np.isinf(random.erf_inv(np.float32([-1.0, 1.0]))).all()
    # the bounds truncated_normal takes: erf(±2/√2), erf(-1/√2), erf(3/√2)
    b = np.float32([-2.0, 2.0, -1.0, 3.0]) / np.float32(np.sqrt(2))
    np.testing.assert_array_equal(np.asarray(jax.lax.erf(b)), random.erf(b))


def test_fold_in_static_is_flax_module_key():
    root = jax.random.PRNGKey(0)
    for path in (("inc", 1), ("down1", "conv1", 1), ("down1", "conv1", 2), ("up3", 1)):
        np.testing.assert_array_equal(np.asarray(flax_scope._fold_in_static(root, path)),
                                      random.fold_in_static(random.PRNGKey(0), path))


@pytest.mark.parametrize("stem", [1, 2])
def test_init_params_is_flax_init_bit_for_bit(stem):
    """init_params(base_ch=8) against UNetSmall(base_ch=8).init(PRNGKey(0))
    leaf by leaf, within 2 ulp (equal on this jax)."""
    model = JUNet(out_ch=4, base_ch=8, stem_s2d=stem)
    ref = params_from_numpy(jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 8), jnp.float32),
        jnp.zeros((1,), jnp.int32))["params"]))
    got = init_params(4, 8, stem, seed=0)
    assert set(got) == set(ref)
    for k in ref:
        assert _ulps(ref[k].numpy(), got[k].numpy()) <= 2, k
