"""The classical baselines of s1s2_torch (``eval/baselines.py``) against the
JAX package's, within 1e-6: the bicubic down-and-up with PyTorch's a=-0.75
kernel (and against ``F.interpolate`` itself, which the reference calls),
and the per-image ridge fit, masked and unmasked, with and without its
subsample."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from s1s2.eval import baselines as jb
from s1s2_torch.eval import baselines as tb


@pytest.mark.parametrize("n_in,n_out", [(32, 8), (8, 32), (256, 64), (7, 5), (5, 12)])
def test_bicubic_matrix_equals_jax(n_in, n_out):
    np.testing.assert_array_equal(tb._bicubic_matrix(n_in, n_out), jb._bicubic_matrix(n_in, n_out))


@pytest.mark.parametrize("shape", [(2, 32, 32, 4), (1, 64, 48, 3)])
def test_bicubic_baseline_equals_jax_and_torch(shape):
    x = np.random.default_rng(0).random(shape, dtype=np.float32)
    ref = np.asarray(jb.baseline_bicubic(jnp.asarray(x)))
    got = tb.baseline_bicubic(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
    # the reference's own resize: F.interpolate(mode="bicubic") down and up
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    lr = F.interpolate(xt, size=(shape[1] // 4, shape[2] // 4), mode="bicubic",
                       align_corners=False)
    sr = F.interpolate(lr, size=shape[1:3], mode="bicubic", align_corners=False)
    np.testing.assert_allclose(got.numpy(), sr.clamp(0, 1).permute(0, 2, 3, 1).numpy(),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("subsample_max", [200_000, 300])
def test_linear_baseline_equals_jax(masked, subsample_max):
    rng = np.random.default_rng(1)
    cond = rng.standard_normal((32, 32, 4)).astype(np.float32)
    gt = np.clip(cond[..., :4] @ rng.random((4, 4), dtype=np.float32) * 0.2 + 0.4, 0, 1)
    gt = (gt + 0.01 * rng.standard_normal(gt.shape)).astype(np.float32)
    mask = (rng.random((32, 32)) > 0.2).astype(np.float32) if masked else None
    ref = jb.baseline_linear_fit_predict(cond, gt, mask, subsample_max=subsample_max, seed=3)
    got = tb.baseline_linear_fit_predict(cond, gt, mask, subsample_max=subsample_max, seed=3)
    assert got.dtype == np.float32 and got.shape == (32, 32, 4)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    if masked:
        assert not got[mask == 0].any()
