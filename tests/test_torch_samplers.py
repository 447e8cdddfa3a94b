"""s1s2_torch parameterization algebra, UNetSmall (convt up path) and the
samplers without guidance, against the JAX package on the same numpy inputs,
the same weights and the same noise. The sampler tests run a base-8 model
at 32² in f32: a random-init model is no denoiser, so its predictions are
large and each step's division by √ᾱ amplifies the last bits in which the
two frameworks' convolutions differ (sum order); the tolerances below are
stated per sampler with that reason."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s1s2.core import Schedule as JSchedule
from s1s2.core import parametrize as jp
from s1s2.models import UNetSmall as JUNet
from s1s2.models import quant as jq
from s1s2.sampling import dpm_solver as jdpm
from s1s2.sampling import grids as jgrids
from s1s2.sampling import samplers as js
from s1s2_torch.core import parametrize as tp
from s1s2_torch.core.schedule import Schedule
from s1s2_torch.models import quant as tq
from s1s2_torch.models.unet import UNetSmall, init_params, load_unet
from s1s2_torch.models.weights import params_from_numpy
from s1s2_torch.ops.fused_elementwise import fused_ddim_update
from s1s2_torch.sampling import samplers as ts
from s1s2_torch.sampling.dpm_solver import dpm_solver_2m
from s1s2_torch.sampling.grids import round_unique_grid

B, H, C = 2, 32, 4
WIDE = (-1e30, 1e30)  # no clamp: compare the raw result


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# ---------------------------------------------------------------------------
# parameterization algebra: bit for bit in f32
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def alg():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5, 6, 4)).astype(np.float32)
    e = rng.standard_normal((3, 5, 6, 4)).astype(np.float32)
    ab = np.concatenate([rng.random(3), [1.0, 0.0, 0.999999, 1e-6]]).astype(np.float32)
    a, b = np.sqrt(ab[:3]), np.sqrt(1.0 - ab[:3])
    return x, e, ab, a, b


def _eq(got, ref):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_parameterization_enum():
    assert tp.Parameterization("v") is tp.Parameterization.V
    assert [p.value for p in tp.Parameterization] == [p.value for p in jp.Parameterization]
    assert tp.Parameterization.EPS == "eps"


def test_v_from_x0_eps_bit_equal(alg):
    x, e, _, a, b = alg
    _eq(tp.v_from_x0_eps(_t(x), _t(e), _t(a), _t(b)), jp.v_from_x0_eps(x, e, a, b))
    _eq(tp.v_from_x0_eps(_t(x), _t(e), float(a[0]), float(b[0])),
        jp.v_from_x0_eps(x, e, a[0], b[0]))


def test_x0_eps_from_v_bit_equal(alg):
    x, e, _, a, b = alg
    for got, ref in zip(tp.x0_eps_from_v(_t(x), _t(e), _t(a), _t(b)),
                        jp.x0_eps_from_v(x, e, a, b)):
        _eq(got, ref)


def test_eps_from_x0_bit_equal(alg):
    x, e, _, a, b = alg
    _eq(tp.eps_from_x0(_t(x), _t(e), _t(a), _t(b)), jp.eps_from_x0(x, e, a, b))
    # the 1e-8 guard at ᾱ = 1 (no noise left): finite, as in JAX
    one, zero = np.ones(3, np.float32), np.zeros(3, np.float32)
    got = tp.eps_from_x0(_t(x), _t(e), _t(one), _t(zero))
    assert torch.isfinite(got).all()
    _eq(got, jp.eps_from_x0(x, e, one, zero))


def test_x0_from_eps_bit_equal(alg):
    x, e, _, a, b = alg
    _eq(tp.x0_from_eps(_t(x), _t(e), _t(a), _t(b)), jp.x0_from_eps(x, e, a, b))


def test_snr_bit_equal(alg):
    ab = alg[2]
    _eq(tp.snr(_t(ab)), jp.snr(ab))
    _eq(tp.snr(_t(ab), 1e-3), jp.snr(ab, 1e-3))


@pytest.mark.parametrize("gamma", [1.0, 0.5])
def test_p2_weight(alg, gamma):
    """XLA's CPU pow is not correctly rounded (a few thousand of 10^5 random
    f32 inputs differ from a correctly rounded pow by an ulp), so p2_weight
    agrees within 2^-22 relative (two f32 ulps)."""
    ab = alg[2]
    got, ref = tp.p2_weight(_t(ab), gamma).numpy(), np.asarray(jp.p2_weight(ab, gamma))
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -22, atol=0)


@pytest.mark.parametrize("param", ["eps", "v"])
def test_target_for_and_pred_to_x0_eps_bit_equal(alg, param):
    x, e, _, a, b = alg
    _eq(tp.target_for(param, _t(x), _t(e), _t(a), _t(b)), jp.target_for(param, x, e, a, b))
    for got, ref in zip(tp.pred_to_x0_eps(tp.Parameterization(param), _t(x), _t(e), _t(a), _t(b)),
                        jp.pred_to_x0_eps(param, x, e, a, b)):
        _eq(got, ref)


# ---------------------------------------------------------------------------
# the model: a convt-initialised JAX tree in the port's UNetSmall
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(21)
    cond = rng.standard_normal((B, H, H, C)).astype(np.float32)
    gt = rng.random((B, H, H, C)).astype(np.float32)
    noise = rng.standard_normal((B, H, H, C)).astype(np.float32)
    jm = JUNet(out_ch=C, base_ch=8, up_impl="convt", compute_dtype=jnp.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, H, H, 2 * C)),
                             jnp.zeros((1,), jnp.int32))["params"]
    tree = jax.tree_util.tree_map(np.asarray, params)
    state = params_from_numpy(tree)
    model = load_unet(state, C, 8, 1, compute_dtype=torch.float32, device="cpu")
    return dict(
        cond=cond, gt=gt, noise=noise, params=params, tree=tree, state=state,
        jfn=js.make_denoise_fn(jm.apply, {"params": params}, jnp.asarray(cond)),
        tfn=ts.make_denoise_fn(model, torch.from_numpy(cond)),
        S=JSchedule.cosine(1000), St=Schedule.cosine(1000))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_unet_against_jax_convt(case, dtype):
    """f32: within 1e-4 (sum order). bf16: the tolerance of
    test_torch_unet.py (mean |Δ| ≤ 1.5% of mean |ε|, max |Δ| ≤ 0.25)."""
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.standard_normal((B, H, H, C)), case["cond"]], -1).astype(np.float32)
    t = np.array([999, 20], np.int32)
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref = np.asarray(JUNet(out_ch=C, base_ch=8, up_impl="convt", compute_dtype=jdt).apply(
        {"params": case["params"]}, jnp.asarray(x), jnp.asarray(t)))
    got = load_unet(case["state"], C, 8, 1, compute_dtype=tdt, device="cpu")(
        torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert got.dtype == np.float32 and got.shape == (B, H, H, C)
    if dtype == "f32":
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    else:
        d = np.abs(got - ref)
        assert d.mean() <= 0.015 * np.abs(ref).mean(), d.mean()
        assert d.max() <= 0.25, d.max()


def test_init_params_shapes_and_distribution():
    """The port's init has the JAX model's tree and flax's distributions:
    kernels LeCun-normal (std 1/√fan_in, truncated at 2/0.8796 of it), biases
    zero; the same seed gives the same tree."""
    jm = JUNet(out_ch=4, base_ch=16, up_impl="convt")
    tmpl = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 8)),
                            jnp.zeros((1,), jnp.int32))
    ref = params_from_numpy(jax.tree_util.tree_map(np.asarray, tmpl["params"]))
    got = init_params(4, 16, 1, seed=3)
    assert set(got) == set(ref) == set(UNetSmall(4, 16, 1).state_dict())
    for k, v in got.items():
        assert v.dtype == torch.float32 and v.shape == ref[k].shape, k
        if k.endswith(".bias"):
            assert not v.any(), k
            continue
        std = float(np.sqrt(1.0 / np.prod(v.shape[:-1])))
        assert float(v.abs().max()) <= 2.0 * std / 0.87962566103423978 * (1 + 1e-6), k
        if v.numel() >= 4096:
            assert abs(float(v.std()) / std - 1.0) < 0.05, (k, float(v.std()), std)
    again = init_params(4, 16, 1, seed=3)
    assert all(torch.equal(got[k], again[k]) for k in got)
    assert not torch.equal(got["inc.kernel"], init_params(4, 16, 1, seed=4)["inc.kernel"])


# ---------------------------------------------------------------------------
# samplers, base 8 at 32², f32, the same noise
# ---------------------------------------------------------------------------


def _close(got, ref, rtol, atol):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("clip", ["default", "none"])
def test_ddim_anchored_50_from_999(case, clip):
    """50 steps from t=999: the first steps divide by √ᾱ_999 ≈ 6e-3, so the
    unclamped result of the random model reaches |x| ~ 1e6 and the two agree
    within 2e-3 relative; clamped to [0, 1] they agree within 1e-5."""
    kw = {} if clip == "default" else {"clip": WIDE}
    ref = js.ddim_anchored(case["jfn"], jnp.asarray(case["gt"]), None, case["S"], 999, 50,
                           noise=jnp.asarray(case["noise"]), **kw)
    got = ts.ddim_anchored(case["tfn"], torch.from_numpy(case["gt"]), case["St"], 999, 50,
                           noise=torch.from_numpy(case["noise"]), **kw)
    _close(got, ref, *((0, 1e-5) if clip == "default" else (2e-3, 1e-4)))


@pytest.mark.parametrize("param", ["eps", "v"])
def test_dpm_solver_2m_on_bench_grid(case, param):
    """DPM-Solver++(2M) on round_unique_grid(200, 5, 1000) (bench.py line 2),
    from q_sample(gt) at grid[-1]: within 1e-5 absolute unclamped (|x| ≤ 3)."""
    grid = jgrids.round_unique_grid(200, 5, 1000)
    assert np.array_equal(grid, round_unique_grid(200, 5, 1000))
    ab = case["S"].alpha_bar_np()
    K = int(grid[-1])
    x_init = np.asarray(jp.q_sample(case["gt"], case["noise"], float(np.sqrt(ab[K])),
                                    float(np.sqrt(1.0 - ab[K]))))
    calls = []

    def counted(x, t):
        calls.append(int(t[0]))
        return case["tfn"](x, t)

    ref = jdpm.dpm_solver_2m(case["jfn"], jnp.asarray(x_init), case["S"], grid, param, clip=WIDE)
    got = dpm_solver_2m(counted, _t(x_init), case["St"], grid, param, clip=WIDE)
    _close(got, ref, 0, 1e-5)
    assert calls == [200, 150, 100, 50, 0]  # 4 solver steps and the final call
    clamped = dpm_solver_2m(case["tfn"], _t(x_init), case["St"], grid, param)
    assert float(clamped.min()) >= 0.0 and float(clamped.max()) <= 1.0


def test_ddim_generate(case):
    """Pure generation from stored noise at t=999, 20 steps; linspace_grid
    clamps t_start=5000 to 999 in both."""
    for t_start in (999, 5000):
        ref = js.ddim_generate(case["jfn"], (B, H, H, C), None, case["S"], t_start, 20,
                               clip=WIDE, noise=jnp.asarray(case["noise"]))
        got = ts.ddim_generate(case["tfn"], (B, H, H, C), case["St"], t_start, 20, clip=WIDE,
                               noise=torch.from_numpy(case["noise"]))
        _close(got, ref, 2e-3, 1e-4)


@pytest.mark.parametrize("param", ["eps", "v"])
def test_ddim_grid_sample_eta0(case, param):
    """Deterministic full-range sweep on round_unique_grid(999, 10, 1000):
    within 1e-5 absolute clamped."""
    grid = jgrids.round_unique_grid(999, 10, 1000)
    ref = js.ddim_grid_sample(case["jfn"], jnp.asarray(case["noise"]), jax.random.PRNGKey(3),
                              case["S"], grid, param)
    got = ts.ddim_grid_sample(case["tfn"], torch.from_numpy(case["noise"]), case["St"], grid, param)
    _close(got, ref, 0, 1e-5)


def test_ddim_grid_sample_eta_replays_jax_draws(case):
    """η = 0.7 with the per-step draws JAX takes from its key (split into
    len(grid) keys, one normal draw each) handed to the port: within 1e-5."""
    grid = jgrids.round_unique_grid(999, 10, 1000)
    key = jax.random.PRNGKey(3)
    draws = np.stack([np.asarray(jax.random.normal(k, (B, H, H, C), jnp.float32))
                      for k in jax.random.split(key, len(grid))])
    ref = js.ddim_grid_sample(case["jfn"], jnp.asarray(case["noise"]), key, case["S"], grid,
                              "v", eta=0.7)
    got = ts.ddim_grid_sample(case["tfn"], torch.from_numpy(case["noise"]), case["St"], grid,
                              "v", eta=0.7, noise=torch.from_numpy(draws))
    _close(got, ref, 0, 1e-5)
    det = ts.ddim_grid_sample(case["tfn"], torch.from_numpy(case["noise"]), case["St"], grid, "v")
    assert not torch.equal(got, det)  # the η term is really there
    with pytest.raises(ValueError):
        ts.ddim_grid_sample(case["tfn"], torch.from_numpy(case["noise"]), case["St"], grid, "v",
                            eta=0.7, noise=torch.from_numpy(draws[1:]))


def test_ddim_grid_sample_return_traj(case):
    """The trajectory holds the x_t each step's denoiser saw, with its t;
    the states grow to |x| ~ 60, within 5e-5 absolute."""
    grid = jgrids.round_unique_grid(999, 10, 1000)
    rx, (rt, rtraj) = js.ddim_grid_sample(case["jfn"], jnp.asarray(case["noise"]),
                                          jax.random.PRNGKey(3), case["S"], grid, "v",
                                          return_traj=True)
    gx, (gt_, gtraj) = ts.ddim_grid_sample(case["tfn"], torch.from_numpy(case["noise"]),
                                           case["St"], grid, "v", return_traj=True)
    assert gt_.dtype == torch.int32 and gt_.tolist() == np.asarray(rt).tolist()
    assert tuple(gtraj.shape) == (len(grid), B, H, H, C)
    np.testing.assert_array_equal(gtraj[0].numpy(), case["noise"])
    _close(gtraj, rtraj, 0, 5e-5)
    _close(gx, rx, 0, 1e-5)


@pytest.mark.parametrize("param", ["eps", "v"])
def test_ddpm_ancestral_replay(case, param):
    """All 100 steps of Schedule.cosine(100) with the same (T,)+shape draw
    stream. The ε chain multiplies by 1/√α_t up to 31.6 (β clipped at
    0.999) and the random model's output grows to |x| ~ 2e4 unclamped, so
    it agrees within 5e-3 relative, and within 2e-3 absolute once clamped
    to [0, 1] (a value inside came from that large chain); the v chain
    stays small: 1e-3 relative, 1e-5 absolute clamped. The clamp is the
    last operation of both samplers, so the clamped results are the clamped
    raw ones."""
    S100, St100 = JSchedule.cosine(100), Schedule.cosine(100)
    draws = np.random.default_rng(8).standard_normal((100, B, H, H, C)).astype(np.float32)
    ref = np.asarray(js.ddpm_ancestral(case["jfn"], (B, H, H, C), None, S100, param, clip=WIDE,
                                       noise=jnp.asarray(draws)))
    got = ts.ddpm_ancestral(case["tfn"], (B, H, H, C), St100, param, clip=WIDE,
                            noise=torch.from_numpy(draws))
    _close(got, ref, 5e-3 if param == "eps" else 1e-3, 1e-4)
    _close(torch.clamp(got, 0.0, 1.0), np.clip(ref, 0.0, 1.0), 0,
           2e-3 if param == "eps" else 1e-5)
    with pytest.raises(ValueError):
        ts.ddpm_ancestral(case["tfn"], (B, H, H, C), St100, param,
                          noise=torch.from_numpy(draws[:99]))


@pytest.mark.parametrize("k", [0, 10])
def test_partial_ddim_from_gt(case, k):
    """The final x_t of the stride-1 chain k → 0 (not x0̂): within 1e-5."""
    ref = js.partial_ddim_from_gt(case["jfn"], jnp.asarray(case["gt"]), None, case["S"], k,
                                  noise=jnp.asarray(case["noise"]))
    n = fused_ddim_update.launches
    got = ts.partial_ddim_from_gt(case["tfn"], torch.from_numpy(case["gt"]), case["St"], k,
                                  noise=torch.from_numpy(case["noise"]))
    _close(got, ref, 0, 1e-5)
    assert fused_ddim_update.launches == n  # the CPU runs the plain version


@pytest.mark.parametrize("param", ["eps", "v"])
def test_one_step_recon(case, param):
    ref = js.one_step_recon(case["jfn"], jnp.asarray(case["gt"]), None, case["S"], 20, param,
                            noise=jnp.asarray(case["noise"]))
    got = ts.one_step_recon(case["tfn"], torch.from_numpy(case["gt"]), case["St"], 20, param,
                            noise=torch.from_numpy(case["noise"]))
    _close(got, ref, 0, 1e-6)


def test_scaled_noise_init_and_generators():
    """scaled_noise_init draws N(0, I) with the generator and scales it by
    the f32 √(1−ᾱ_t); samplers draw on the device they are given."""
    S = Schedule.cosine(1000)
    g = torch.Generator().manual_seed(0)
    x = ts.scaled_noise_init((2, 4, 4, 3), S, 999, generator=g, device="cpu")
    z = torch.randn((2, 4, 4, 3), generator=torch.Generator().manual_seed(0))
    scale = np.float32(np.sqrt(1.0 - float(JSchedule.cosine(1000).alpha_bar_np()[999])))
    assert x.device.type == "cpu" and torch.equal(x, z * float(scale))
    a = ts.ddim_generate(lambda x, t: torch.zeros_like(x), (1, 4, 4, 2), S, 50, 2,
                         generator=torch.Generator().manual_seed(1))
    b = ts.ddim_generate(lambda x, t: torch.zeros_like(x), (1, 4, 4, 2), S, 50, 2,
                         generator=torch.Generator().manual_seed(1))
    assert a.device.type == "cpu" and torch.equal(a, b)


def test_int8_dpm_against_jax_quant_denoise(case):
    """bench.py line 2 at base 8: int8 DPM-Solver++(2M)-5 through the port's
    quantized model against JAX's make_quant_denoise_fn, both calibrated at
    tvals (999, 500, 200, 20) on the same noise. Within the tolerance of
    test_torch_quant.py: mean |Δ| ≤ 0.6 × the mean |int8 − bf16| of the JAX
    sampler, max |Δ| ≤ 0.25 × max |x0|."""
    gt, cond, S = case["gt"], case["cond"], case["S"]
    ab = S.alpha_bar_np()
    tvals = (999, 500, 200, 20)
    rng = np.random.default_rng(9)
    noises = [rng.standard_normal(gt.shape).astype(np.float32) for _ in tvals]
    jcal = []
    for tval, eps in zip(tvals, noises):
        x_t = jp.q_sample(jnp.asarray(gt), jnp.asarray(eps), float(np.sqrt(ab[tval])),
                          float(np.sqrt(1.0 - ab[tval])))
        jcal.append((jnp.concatenate([x_t, jnp.asarray(cond)], -1),
                     jnp.full((B,), tval, jnp.int32)))
    jqp = jq.quantize_unet(case["tree"], jcal, base_ch=8)
    tcal = tq.make_sampler_calib(torch.from_numpy(gt), torch.from_numpy(cond), ab, tvals,
                                 noises=[torch.from_numpy(e) for e in noises])
    tqp = tq.quantize_unet(case["state"], tcal, base_ch=8)
    grid = jgrids.round_unique_grid(200, 5, 1000)
    K = int(grid[-1])
    x_init = np.asarray(jp.q_sample(gt, case["noise"], float(np.sqrt(ab[K])),
                                    float(np.sqrt(1.0 - ab[K]))))
    ref = np.asarray(jdpm.dpm_solver_2m(jq.make_quant_denoise_fn(jqp, jnp.asarray(cond)),
                                        jnp.asarray(x_init), S, grid))
    bf16 = np.asarray(jdpm.dpm_solver_2m(
        js.make_denoise_fn(JUNet(out_ch=C, base_ch=8).apply, {"params": case["params"]},
                           jnp.asarray(cond)), jnp.asarray(x_init), S, grid))
    got = dpm_solver_2m(tq.make_quant_denoise_fn(tqp, torch.from_numpy(cond)), _t(x_init),
                        case["St"], grid).numpy()
    d = np.abs(got - ref)
    assert np.isfinite(got).all() and got.shape == (B, H, H, C)
    assert d.mean() <= 0.6 * np.abs(ref - bf16).mean(), (d.mean(), np.abs(ref - bf16).mean())
    assert d.max() <= 0.25 * np.abs(ref).max(), d.max()
