"""The port's endpoint distillation step and target sets
(s1s2_torch.train.distill) against the JAX package's on the same numpy
inputs and the same flax init, at base 8, 32², B=2.

Tolerances. The step, in every head / init / spectral / mask case, is held
to JAX's own spread measured in the same test (the distance between JAX's
bf16 and f32 steps: losses, per-channel losses, parameter and EMA updates,
Adam's moments): the port's f32 step within 1e-2 of it of JAX's f32 step,
its bf16 step within twice it of JAX's bf16 step. The target sets are f32
teacher rollouts (the same DDIM arithmetic on the same draws; only the
convs' f32 sums differ in order): within 1e-5 relative of JAX's, the noise
bit for bit. JAX's UNet is jitted and its step run op by op, so every case
shares one compiled forward and backward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from s1s2.core import Schedule as JSchedule
from s1s2.core.parametrize import Parameterization as JParam
from s1s2.core.parametrize import q_sample as j_q_sample
from s1s2.models import UNetSmall as JUNet
from s1s2.sampling import samplers as js
from s1s2.sampling.grids import round_unique_grid as j_round_unique_grid
from s1s2.train import distill as jd
from s1s2_torch.core.schedule import Schedule
from s1s2_torch.models.unet import UNetSmall, init_params
from s1s2_torch.train import distill, loop

B, H, BASE, T = 2, 32, 8, 1000
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
SLACK = {"f32": 1e-2, "bf16": 2.0}
STEPS = 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # small convs; the test run has a worker a core
    yield
    torch.set_num_threads(threads)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    n = np.linalg.norm(b)
    return np.linalg.norm(a - b) / n if n else np.linalg.norm(a - b)


def jflat(tree, names):
    f = flatten_dict(tree)
    return np.concatenate([np.asarray(f[tuple(n.split("."))], np.float32).reshape(-1)
                           for n in names])


@pytest.fixture(scope="module")
def params():
    return init_params(4, BASE, 1, seed=0, in_ch=8)


@pytest.fixture(scope="module")
def jparams(params):
    return unflatten_dict({tuple(k.split(".")): jnp.asarray(v.numpy()) for k, v in params.items()})


@pytest.fixture(scope="module")
def japply():
    """One jitted apply per compute dtype, shared by every case."""
    return {d: jax.jit(JUNet(out_ch=4, base_ch=BASE, compute_dtype=DTYPES[d][0]).apply)
            for d in DTYPES}


def ep_batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, H, 4)).astype(np.float32),
            rng.uniform(size=(B, H, H, 4)).astype(np.float32),
            (rng.uniform(size=(B, H, H)) > 0.2).astype(np.float32),
            rng.normal(size=(B, H, H, 4)).astype(np.float32),
            rng.uniform(size=(B, H, H, 4)).astype(np.float32))


def adam_state(opt_state):
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    for s in opt_state if isinstance(opt_state, tuple) else ():
        found = adam_state(s)
        if found is not None:
            return found
    return None


# (student_param, pure_noise_init, spectral_w, mask_as_weights): both heads in
# both modes, then the spectral term and the mask weights on each head and mode
CASES = [("eps", False, 0.0, False), ("v", False, 0.0, False), ("eps", True, 0.0, False),
         ("v", True, 0.0, False), ("eps", False, 0.5, True), ("v", True, 0.5, False),
         ("eps", True, 0.3, False), ("v", False, 0.0, True)]


def run_case(params, jparams, japply, case, dtype, data):
    head, pure, sw, maw = case
    kw = dict(T=T, t_start=600 if pure else 200, ema_decay=0.9, mask_as_weights=maw)
    jcfg, cfg = jd.DistillConfig(**kw), distill.DistillConfig(**kw)
    jstep = jd.make_endpoint_distill_step(japply[dtype], JSchedule.cosine(T), jcfg,
                                          pure_noise_init=pure, spectral_w=sw, student_param=head)
    model = UNetSmall(4, BASE, 1, 8, DTYPES[dtype][1], autograd=True)
    step = distill.make_endpoint_distill_step(model, Schedule.cosine(T), cfg,
                                              pure_noise_init=pure, spectral_w=sw,
                                              student_param=head)
    jstate = jd.create_distill_state(jparams, jcfg)
    state = distill.create_distill_state(params, cfg, "cpu")
    names, out = tuple(params), {"jax": [], "port": []}
    for _ in range(STEPS):
        jstate, jm = jstep(jstate, tuple(jnp.asarray(a) for a in data), jax.random.PRNGKey(0))
        adam = adam_state(jstate.opt_state)
        out["jax"].append(dict(loss=float(jm["loss"]), ch=np.asarray(jm["ch_losses"]),
                               skipped=int(jm["skipped"]), params=jflat(jstate.params, names),
                               ema=jflat(jstate.ema_params, names), mu=jflat(adam.mu, names),
                               nu=jflat(adam.nu, names)))
        state, m = step(state, data)
        out["port"].append(dict(loss=float(m["loss"]), ch=m["ch_losses"].numpy(),
                                skipped=int(m["skipped"]), params=state.params.numpy().copy(),
                                ema=state.ema_params.numpy().copy(),
                                mu=state.opt_state.mu.numpy().copy(),
                                nu=state.opt_state.nu.numpy().copy()))
    return out


def quantities(rs, p0):
    r = rs[-1]
    return {"loss": [x["loss"] for x in rs], "ch": np.stack([x["ch"] for x in rs]),
            "update": r["params"] - p0, "ema_update": r["ema"] - p0, "mu": r["mu"], "nu": r["nu"]}


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{'puregen' if c[1] else 'anchored'}"
                                                      f"-sw{c[2]}-{'maw' if c[3] else 'bin'}")
def test_endpoint_step_matches_jax_within_its_own_spread(params, jparams, japply, case):
    data = ep_batch(CASES.index(case))
    runs = {d: run_case(params, jparams, japply, case, d, data) for d in DTYPES}
    p0 = loop.ParamLayout.of(params).flatten(params).numpy()
    j32, j16 = quantities(runs["f32"]["jax"], p0), quantities(runs["bf16"]["jax"], p0)
    for dtype in DTYPES:
        jq, pq = quantities(runs[dtype]["jax"], p0), quantities(runs[dtype]["port"], p0)
        for k in jq:
            spread, d = rel(j16[k], j32[k]), rel(pq[k], jq[k])
            assert d <= SLACK[dtype] * spread, (dtype, k, d, spread)
        assert all(x["skipped"] == 0 for x in runs[dtype]["port"] + runs[dtype]["jax"])


def test_endpoint_step_skips_a_non_finite_target(params, jparams, japply):
    data = list(ep_batch(3))
    data[4] = data[4].copy()
    data[4][0, 1, 2, 3] = np.inf
    out = run_case(params, jparams, japply, CASES[0], "f32", tuple(data))
    p0 = loop.ParamLayout.of(params).flatten(params).numpy()
    for side in ("jax", "port"):
        assert [x["skipped"] for x in out[side]] == [1, 2]
        assert all(np.isnan(x["loss"]) for x in out[side])
        assert np.array_equal(out[side][-1]["params"], p0)


# ---------------------------------------------------------------------------
# target sets
# ---------------------------------------------------------------------------


def jax_targets(apply, jparams, cfg, cond, x0, steps, n_seeds, t_param, seed, mode, g):
    """JAX's ``endpoint_distill``'s ``roll_teacher`` (train/distill.py) over the whole
    set, seed by seed."""
    sched = JSchedule.cosine(T)
    t_par = JParam(t_param)
    if t_par is JParam.V:
        grid = j_round_unique_grid(cfg.t_start, steps, cfg.T)
        ab_k = float(sched.alpha_bar_np()[int(grid[-1])])
        sab_k, s1mab_k = float(np.sqrt(ab_k)), float(np.sqrt(1.0 - ab_k))
    if g is not None:
        fn = js.make_cfg_denoise_fn(apply, {"params": jparams}, cond, g)
    else:
        fn = js.make_denoise_fn(apply, {"params": jparams}, cond)
    noise, tgt = [], []
    for s in range(n_seeds):
        nz = jax.random.normal(jax.random.PRNGKey(50_000 + seed + s), x0.shape)
        k0 = jax.random.PRNGKey(0)
        if mode == "puregen" and t_par is JParam.EPS:
            out = js.ddim_generate(fn, x0.shape, k0, sched, cfg.t_start, steps, noise=nz)
        elif mode == "puregen":
            out = js.ddim_grid_sample(fn, nz * s1mab_k, k0, sched, grid, t_par)
        elif t_par is JParam.EPS:
            out = js.ddim_anchored(fn, x0, k0, sched, cfg.t_start, steps, noise=nz)
        else:
            out = js.ddim_grid_sample(fn, j_q_sample(x0, nz, sab_k, s1mab_k), k0, sched, grid,
                                      t_par)
        noise.append(np.asarray(nz))
        tgt.append(np.asarray(out))
    return np.concatenate(noise), np.concatenate(tgt)


@pytest.mark.parametrize("t_param,mode,g", [("eps", "anchored", None), ("eps", "puregen", None),
                                            ("v", "anchored", None), ("v", "puregen", None),
                                            ("eps", "anchored", 3.0), ("v", "puregen", 3.0)])
def test_endpoint_targets_match_jax(params, jparams, japply, t_param, mode, g):
    cond, x0 = ep_batch(7)[:2]
    cfg = distill.DistillConfig(T=T, t_start=200)
    want_n, want_t = jax_targets(japply["f32"], jparams, jd.DistillConfig(T=T, t_start=200),
                                 jnp.asarray(cond), jnp.asarray(x0), 3, 2, t_param, 11, mode, g)
    teacher = distill.inference_net(UNetSmall(4, BASE, 1, 8, torch.float32), params, "cpu")
    for host_store in (False, True):  # chunks of one patch: the rollout's bounded chunks
        got_n, got_t = distill.endpoint_targets(
            teacher, Schedule.cosine(T), cfg, torch.from_numpy(cond), torch.from_numpy(x0), 3, 2,
            t_param, 11, rollout_chunk=1, mode=mode, guidance_scale=g, host_store=host_store)
        got_n, got_t = (np.asarray(a) if host_store else a.numpy() for a in (got_n, got_t))
        assert got_n.shape == got_t.shape == (2 * B, H, H, 4)
        assert np.array_equal(got_n, want_n)
        assert rel(got_t, want_t) <= 1e-5, rel(got_t, want_t)
