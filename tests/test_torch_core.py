"""s1s2_torch core math against the JAX package: schedules, grids and the
forward-process algebra are bit-equal in float32."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from s1s2.core import parametrize as jpar
from s1s2.core import schedule as jsched
from s1s2.sampling import grids as jgrids
from s1s2_torch.core import parametrize as tpar
from s1s2_torch.core import schedule as tsched
from s1s2_torch.sampling import grids as tgrids

TABLES = ("betas", "alphas", "alpha_bar", "sqrt_alpha_bar", "sqrt_one_minus_alpha_bar")


@pytest.mark.parametrize("kind,T", [("cosine", 1000), ("cosine", 37), ("linear", 1000)])
def test_schedule_tables_bit_equal(kind, T):
    """The cosine schedule, and ``from_betas`` on the JAX package's linear
    betas."""
    ref = jsched.make_schedule(T, kind)
    got = (tsched.Schedule.cosine(T) if kind == "cosine"
           else tsched.Schedule.from_betas(jsched.linear_beta_schedule(T)))
    assert got.T == ref.T
    for name in TABLES:
        r = np.asarray(getattr(ref, name))
        g = getattr(got, name).numpy()
        assert g.dtype == np.float32 and r.dtype == np.float32
        np.testing.assert_array_equal(g, r, err_msg=name)
    np.testing.assert_array_equal(got.alpha_bar_np(), ref.alpha_bar_np())


@pytest.mark.parametrize("T,start,end", [(1000, 1e-4, 0.02), (37, 1e-3, 0.05), (1, 1e-4, 0.02)])
def test_linear_schedule_bit_equal(T, start, end):
    """The linear betas (a float64 linspace stored as float32) and every
    table of ``Schedule.linear``: bit-equal, the cumulative product taken in
    float64 as the JAX package takes it."""
    np.testing.assert_array_equal(tsched.linear_beta_schedule(T, start, end),
                                  jsched.linear_beta_schedule(T, start, end))
    ref, got = jsched.Schedule.linear(T, start, end), tsched.Schedule.linear(T, start, end)
    for name in TABLES:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)


@pytest.mark.parametrize("kind", ["cosine", "linear"])
def test_make_schedule_selects_like_jax(kind):
    ref, got = jsched.make_schedule(100, kind), tsched.make_schedule(100, kind)
    np.testing.assert_array_equal(got.alpha_bar_np(), ref.alpha_bar_np())
    with pytest.raises(ValueError, match="unknown schedule kind"):
        tsched.make_schedule(100, "sigmoid")


@pytest.mark.parametrize("T,s", [(1000, 0.008), (50, 0.02)])
def test_cosine_betas_bit_equal(T, s):
    np.testing.assert_array_equal(tsched.cosine_beta_schedule(T, s),
                                  jsched.cosine_beta_schedule(T, s))


@pytest.mark.parametrize("t,steps", [(200, 1), (200, 20), (999, 50), (1200, 7), (0, 3), (57, 13)])
def test_grids_exact(t, steps):
    T = 1000
    assert tgrids.clamp_t(t, T) == jgrids.clamp_t(t, T)
    np.testing.assert_array_equal(tgrids.linspace_grid(t, steps, T),
                                  jgrids.linspace_grid(t, steps, T))
    np.testing.assert_array_equal(tgrids.round_unique_grid(t, steps, T),
                                  jgrids.round_unique_grid(t, steps, T))
    np.testing.assert_array_equal(tgrids.round_unique_grid(t, steps, T, False),
                                  jgrids.round_unique_grid(t, steps, T, False))


def _inputs(rng, B=3):
    x0 = rng.random((B, 8, 8, 4), dtype=np.float32)
    noise = rng.standard_normal((B, 8, 8, 4)).astype(np.float32)
    t = rng.integers(1, 1000, B)
    sched = jsched.Schedule.cosine(1000)
    sab = np.asarray(sched.sqrt_alpha_bar)[t]
    s1m = np.asarray(sched.sqrt_one_minus_alpha_bar)[t]
    return x0, noise, sab, s1m


def test_q_sample_bit_equal(rng):
    x0, noise, sab, s1m = _inputs(rng)
    ref = np.asarray(jpar.q_sample(jnp.asarray(x0), jnp.asarray(noise), sab, s1m))
    got = tpar.q_sample(torch.from_numpy(x0), torch.from_numpy(noise),
                        torch.from_numpy(sab), torch.from_numpy(s1m)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_q_sample_scalar_coefficients_bit_equal(rng):
    x0, noise, _, _ = _inputs(rng)
    ab = np.float32(jsched.Schedule.cosine(1000).alpha_bar_np()[100])
    sab, s1m = float(np.sqrt(ab)), float(np.sqrt(np.float32(1.0) - ab))
    ref = np.asarray(jpar.q_sample(jnp.asarray(x0), jnp.asarray(noise), sab, s1m))
    got = tpar.q_sample(torch.from_numpy(x0), torch.from_numpy(noise), sab, s1m).numpy()
    np.testing.assert_array_equal(got, ref)


def test_x0_from_eps_bit_equal(rng):
    x0, noise, sab, s1m = _inputs(rng)
    ref = np.asarray(jpar.x0_from_eps(jnp.asarray(x0), jnp.asarray(noise), sab, s1m))
    got = tpar.x0_from_eps(torch.from_numpy(x0), torch.from_numpy(noise),
                           torch.from_numpy(sab), torch.from_numpy(s1m)).numpy()
    np.testing.assert_array_equal(got, ref)
