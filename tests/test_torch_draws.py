"""Where the port draws what the JAX package draws, with its bits
(``s1s2_torch/core/random.py``): ``make_sampler_calib``'s ``PRNGKey(5)``
split once per t, ``ddim_grid_sample``'s per-step keys (one stream for the
batch, or one per file from a (B, 2) key batch), bench.py's ``data(B,
seed)``, and the name of bench.py's base-96 fallback line."""

import ast
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s1s2.core import Schedule as JSchedule
from s1s2.models import quant as jq
from s1s2.sampling import grids as jgrids
from s1s2.sampling import samplers as js
from s1s2_torch import bench, headline
from s1s2_torch.core import random
from s1s2_torch.core.schedule import Schedule
from s1s2_torch.models import quant as tq
from s1s2_torch.sampling import samplers as ts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TVALS = (200, 100, 20)


def _ulps(a, b) -> int:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max(initial=0))


@pytest.mark.parametrize("key", [None, 11])
def test_sampler_calib_draws_the_reference_noise(key):
    """The port's calibration batches against the JAX package's
    ``make_sampler_calib`` on the same gt/cond, its default key or another:
    the same x_t (the noise is jax's to 2 ulp; equal on this jax)."""
    rng = np.random.default_rng(4)
    gt = rng.random((10, 16, 16, 4)).astype(np.float32)
    cond = rng.standard_normal((10, 16, 16, 4)).astype(np.float32)
    ab = JSchedule.cosine(1000).alpha_bar_np()
    jkw = {} if key is None else {"key": jax.random.PRNGKey(key)}
    tkw = {} if key is None else {"key": random.PRNGKey(key)}
    ref = jq.make_sampler_calib(jnp.asarray(gt), jnp.asarray(cond), ab, TVALS, **jkw)
    got = tq.make_sampler_calib(torch.from_numpy(gt), torch.from_numpy(cond), ab, TVALS, **tkw)
    assert len(got) == len(ref) == len(TVALS)
    for (jx, jt), (tx, tt) in zip(ref, got):
        assert tuple(tx.shape) == (8, 16, 16, 8)
        # x_t = √ᾱ·gt + √(1−ᾱ)·ε: a 2-ulp ε moves x_t by at most that much of √(1−ᾱ)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=5e-7)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def _affine(x_t, t):
    """A stand-in denoiser both frameworks evaluate alike: 0.25·x_t."""
    return 0.25 * x_t


@pytest.mark.parametrize("per_file", [False, True])
def test_ddim_grid_sample_draws_with_jax_keys(per_file):
    """η = 0.7 on round_unique_grid(999, 10, 1000): with one key, step i
    draws normal(split(key, n)[i], (B,H,W,C)); with a (B, 2) key batch,
    file b draws normal(split(key[b], n)[i], (H,W,C)). Within 1e-5 of the
    JAX sampler (the draws agree to 2 ulp)."""
    B, H, C = 3, 8, 4
    grid = jgrids.round_unique_grid(999, 10, 1000)
    x0 = np.random.default_rng(2).standard_normal((B, H, H, C)).astype(np.float32)
    jkey = (jax.random.split(jax.random.PRNGKey(6), B) if per_file
            else jax.random.PRNGKey(6))
    ref = js.ddim_grid_sample(_affine, jnp.asarray(x0), jkey, JSchedule.cosine(1000), grid,
                              "v", eta=0.7, clip=(-1e30, 1e30))
    got = ts.ddim_grid_sample(_affine, torch.from_numpy(x0), Schedule.cosine(1000), grid, "v",
                              eta=0.7, clip=(-1e30, 1e30), key=np.asarray(jkey))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    det = ts.ddim_grid_sample(_affine, torch.from_numpy(x0), Schedule.cosine(1000), grid, "v",
                              clip=(-1e30, 1e30))
    assert not torch.allclose(got, det)  # the η term is really there


def test_per_file_keys_make_a_file_independent_of_its_batch():
    """With per-file keys a file's result does not depend on the other
    files of the batch, as the reference's per-file seeds promise."""
    grid = jgrids.round_unique_grid(999, 6, 1000)
    x0 = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 8, 8, 4))
                          .astype(np.float32))
    keys = random.split(random.PRNGKey(9), 4)
    S = Schedule.cosine(1000)
    whole = ts.ddim_grid_sample(_affine, x0, S, grid, "v", eta=1.0, key=keys)
    alone = ts.ddim_grid_sample(_affine, x0[2:3], S, grid, "v", eta=1.0, key=keys[2:3])
    assert torch.equal(whole[2:3], alone)


def test_bench_data_is_the_reference_batch():
    """data(B, seed): cond = normal(PRNGKey(seed)), gt = uniform(PRNGKey(seed + 1))."""
    cond, gt = headline.data(2, 7, 16, "cpu")
    assert cond.shape == gt.shape == (2, 16, 16, 4) and cond.dtype == torch.float32
    assert _ulps(jax.random.normal(jax.random.PRNGKey(7), (2, 16, 16, 4)), cond.numpy()) <= 2
    np.testing.assert_array_equal(np.asarray(jax.random.uniform(jax.random.PRNGKey(8),
                                                                (2, 16, 16, 4))), gt.numpy())
    assert bench.data is headline.data


def _bench_py_metrics():
    """Every metric name bench.py spells out in one string constant."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    return {n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and n.value.startswith("patches_per_sec_per_chip_")}


def test_base96_fallback_prints_bench_py_name(tmp_path, monkeypatch):
    """With only the base-96 student present, the headline line carries
    bench.py's name for it, after a skip line for each width rung."""
    shutil.copy(headline.CKPT_DIR / "distill_eps_student1.bf16.msgpack", tmp_path)
    monkeypatch.setattr(headline, "CKPT_DIR", tmp_path)
    skips = []
    head = bench.bench_headline("cpu", n_files=2, size=32, emit=skips.append)
    assert [s["skipped"] for s in skips] == ["w24x4", "w16x2", "w12"]
    assert head["metric"] == bench.FALLBACK_METRIC
    assert head["metric"] in _bench_py_metrics()
    assert head["metric"] == "patches_per_sec_per_chip_distill1_int8_at_ddim20_quality_256px"
    assert head["expect_mae"] == 0.36465
