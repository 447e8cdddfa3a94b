"""The port's progressive distillation (s1s2_torch.train.distill) against the
JAX package's on the same numpy inputs, the same flax init and the same
threefry draws, at base 8, 32², B=2.

Tolerances. Grids, phase budgets and the debiased EMA's regimes are exact;
the inversion round trip holds to 1e-6 relative (f32). The step is held to
JAX's own spread, measured in the same test: the distance between JAX's
bf16 step and its f32 step (relative norms of the losses, per-channel
losses, ε-MSEs, parameter and EMA updates and Adam's moments). The port's
f32 step must be within 1e-2 of that distance of JAX's f32 step (f32 rounds
2^16 finer than bf16), its bf16 step within twice it of JAX's bf16 step
(two bf16 evaluations, each that far from f32, can be twice that apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from s1s2.core import Schedule as JSchedule
from s1s2.models import UNetSmall as JUNet
from s1s2.train import distill as jd
from s1s2.train.loop import TrainState as JState
from s1s2_torch.core.schedule import Schedule
from s1s2_torch.models.unet import UNetSmall, init_params
from s1s2_torch.train import distill, loop

B, H, BASE, T = 2, 32, 8, 1000
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
SLACK = {"f32": 1e-2, "bf16": 2.0}
KEY = np.asarray(jax.random.PRNGKey(3))
STEPS = 5
CFG = dict(T=T, t_start=200, teacher_steps=4, ema_decay=0.9)


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


def to_jax(params):
    return unflatten_dict({tuple(k.split(".")): jnp.asarray(v.numpy())
                           for k, v in params.items()})


def jflat(tree, names):
    f = flatten_dict(tree)
    return np.concatenate([np.asarray(f[tuple(n.split("."))], np.float32).reshape(-1)
                           for n in names])


@pytest.fixture(scope="module")
def params():
    return init_params(4, BASE, 1, seed=0, in_ch=8)


def batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, H, 4)).astype(np.float32),
            rng.uniform(size=(B, H, H, 4)).astype(np.float32),
            (rng.uniform(size=(B, H, H)) > 0.2).astype(np.float32))


def adam_state(opt_state):
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    for s in opt_state if isinstance(opt_state, tuple) else ():
        found = adam_state(s)
        if found is not None:
            return found
    return None


# ---------------------------------------------------------------------------
# grids and algebra
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t_start,steps,T_", [(200, 1, 1000), (200, 2, 1000), (200, 8, 1000),
                                              (999, 1, 1000), (999, 16, 1000), (37, 3, 1000),
                                              (200, 50, 1000), (5000, 4, 1000)])
def test_distill_grids_match_jax(t_start, steps, T_):
    sg, tg = distill.distill_grids(t_start, steps, T_)
    jsg, jtg = jd.distill_grids(t_start, steps, T_)
    assert np.array_equal(sg, jsg) and np.array_equal(tg, jtg)
    assert np.array_equal(tg[::2], sg)


@pytest.mark.parametrize("t_start,steps", [(3, 2), (2, 2), (1, 1), (10, 8)])
def test_degenerate_grid_raises_like_jax(t_start, steps):
    with pytest.raises(ValueError, match="degenerate distill grid") as got:
        distill.distill_grids(t_start, steps, 1000)
    with pytest.raises(ValueError) as want:
        jd.distill_grids(t_start, steps, 1000)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("teacher,final", [(16, 1), (8, 2), (1, 1), (12, 1), (5, 1), (16, 3)])
def test_phase_steps_match_jax(teacher, final):
    cfg = distill.DistillConfig(teacher_steps=teacher, final_steps=final)
    assert cfg.phase_steps() == jd.DistillConfig(teacher_steps=teacher,
                                                 final_steps=final).phase_steps()
    assert dataclass_fields(cfg) == dataclass_fields(jd.DistillConfig())


def dataclass_fields(c):
    return {f.name: f.default for f in c.__dataclass_fields__.values()}


def test_inversion_round_trip_and_jax():
    """invert(step(x, ε)) gives ε and x0̂ back within 1e-6 relative, and the
    inversion equals JAX's on the same inputs (the same f32 arithmetic)."""
    rng = np.random.default_rng(4)
    sched = Schedule.cosine(T)
    ab = sched.alpha_bar_np().astype(np.float64)
    sg, _ = distill.distill_grids(200, 4, T)
    i = np.array([0, 3, 1, 2])
    cur, nxt = sg[:-1][i], sg[1:][i]
    c = [np.sqrt(ab[cur]).astype(np.float32), np.sqrt(1 - ab[cur]).astype(np.float32),
         np.sqrt(ab[nxt]).astype(np.float32), np.sqrt(1 - ab[nxt]).astype(np.float32)]
    x_t = rng.normal(size=(4, 8, 8, 4)).astype(np.float32)
    eps = rng.normal(size=(4, 8, 8, 4)).astype(np.float32)
    ct = [torch.from_numpy(v) for v in c]
    x_next, x0_hat = distill.ddim_step_exact(torch.from_numpy(x_t), torch.from_numpy(eps), *ct)
    eps_back, x0_back = distill.invert_ddim_step(torch.from_numpy(x_t), x_next, *ct)
    assert rel(eps_back.numpy(), eps) <= 1e-6 and rel(x0_back.numpy(), x0_hat.numpy()) <= 1e-6
    jx_next, jx0 = jd.ddim_step_exact(jnp.asarray(x_t), jnp.asarray(eps), *map(jnp.asarray, c))
    assert rel(x_next.numpy(), np.asarray(jx_next)) <= 1e-6
    assert rel(x0_hat.numpy(), np.asarray(jx0)) <= 1e-6
    je, jx = jd.invert_ddim_step(jnp.asarray(x_t), jx_next, *map(jnp.asarray, c))
    pe, px = distill.invert_ddim_step(torch.from_numpy(x_t), torch.from_numpy(np.array(jx_next)),
                                      *ct)
    assert rel(pe.numpy(), np.asarray(je)) <= 1e-6 and rel(px.numpy(), np.asarray(jx)) <= 1e-6


# ---------------------------------------------------------------------------
# the debiased EMA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step,skipped,regime", [(0, 0, "params"), (1, 0, "params"),
                                                 (30, 0, "ema"), (5, 0, "debiased"),
                                                 (12, 9, "debiased"), (60, 12, "ema"),
                                                 (40, 12, "debiased"), (3, 3, "params")])
def test_debiased_ema_regimes_match_jax(params, step, skipped, regime):
    """decay 0.9: w = 0.9**n with n = step − skipped; w ≥ 0.9 → params,
    w ≤ 0.05 → EMA, else (EMA − w·init)/(1 − w)."""
    cfg = distill.DistillConfig(ema_decay=0.9)
    layout = loop.ParamLayout.of(params)
    g = torch.Generator().manual_seed(step)
    p0 = layout.flatten(params)
    cur = p0 + torch.randn(p0.shape, generator=g)
    ema = p0 + torch.randn(p0.shape, generator=g)
    state = distill.create_distill_state(params, cfg, "cpu")
    state = loop.TrainState(step=step, params=cur, opt_state=state.opt_state, ema_params=ema,
                            skipped=torch.tensor(skipped, dtype=torch.int32), layout=layout)
    got = distill.debiased_ema(state, params, 0.9)
    assert distill.debiased_ema(state, p0, 0.9).keys() == got.keys()
    names = tuple(params)
    jstate = JState(step=jnp.int32(step), params=to_jax(layout.unflatten(cur)), opt_state=None,
                    ema_params=to_jax(layout.unflatten(ema)), skipped=jnp.int32(skipped))
    want = jflat(jd.debiased_ema(jstate, to_jax(params), 0.9), names)
    flat = layout.flatten(got).numpy()
    assert np.array_equal(flat, want) if regime != "debiased" else rel(flat, want) <= 1e-7
    expect = {"params": cur, "ema": ema}.get(regime)
    if expect is not None:
        assert torch.equal(layout.flatten(got), expect)


# ---------------------------------------------------------------------------
# the progressive step
# ---------------------------------------------------------------------------


def run_jax(params, dtype, teacher_param, steps, data, student_steps=2):
    model = JUNet(out_ch=4, base_ch=BASE, compute_dtype=DTYPES[dtype][0])
    jcfg = jd.DistillConfig(**CFG, teacher_param=teacher_param)
    jp = to_jax(params)
    state = jd.create_distill_state(jp, jcfg)
    step = jax.jit(jd.make_distill_step(model.apply, JSchedule.cosine(T), jcfg, student_steps))
    names, out = tuple(params), []
    for _ in range(steps):
        state, m = step(state, jp, tuple(jnp.asarray(a) for a in data), jnp.asarray(KEY))
        adam = adam_state(state.opt_state)
        out.append(dict(loss=float(m["loss"]), ch=np.asarray(m["ch_losses"]),
                        eps_mse=float(m["eps_mse"]), skipped=int(m["skipped"]),
                        params=jflat(state.params, names), ema=jflat(state.ema_params, names),
                        mu=jflat(adam.mu, names), nu=jflat(adam.nu, names)))
    return out


def run_port(params, dtype, teacher_param, steps, data, student_steps=2):
    model = UNetSmall(4, BASE, 1, 8, DTYPES[dtype][1], autograd=True)
    cfg = distill.DistillConfig(**CFG, teacher_param=teacher_param)
    teacher = distill.inference_net(model, params, "cpu")
    state = distill.create_distill_state(params, cfg, "cpu")
    step = distill.make_distill_step(model, Schedule.cosine(T), cfg, student_steps,
                                     draws="threefry")
    out = []
    for _ in range(steps):
        state, m = step(state, teacher, data, KEY)
        out.append(dict(loss=float(m["loss"]), ch=m["ch_losses"].numpy(),
                        eps_mse=float(m["eps_mse"]), skipped=int(m["skipped"]),
                        params=state.params.numpy().copy(), ema=state.ema_params.numpy().copy(),
                        mu=state.opt_state.mu.numpy().copy(), nu=state.opt_state.nu.numpy().copy()))
    return out, state


@pytest.fixture(scope="module")
def runs(params):
    """STEPS progressive steps (4 → 2), ε and v teachers, f32 and bf16."""
    data = batch()
    out = {}
    for tp in ("eps", "v"):
        for dtype in DTYPES:
            out["jax", tp, dtype] = run_jax(params, dtype, tp, STEPS, data)
            out["port", tp, dtype] = run_port(params, dtype, tp, STEPS, data)[0]
    return out


def quantities(rs, p0, upto):
    r = rs[upto - 1]
    return {"loss": [x["loss"] for x in rs[:upto]], "ch": np.stack([x["ch"] for x in rs[:upto]]),
            "eps_mse": [x["eps_mse"] for x in rs[:upto]], "update": r["params"] - p0,
            "ema_update": r["ema"] - p0, "mu": r["mu"], "nu": r["nu"]}


@pytest.mark.parametrize("upto", [1, STEPS])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("teacher_param", ["eps", "v"])
def test_progressive_step_matches_jax_within_its_own_spread(runs, params, teacher_param, dtype,
                                                            upto):
    p0 = loop.ParamLayout.of(params).flatten(params).numpy()
    j32, j16 = (quantities(runs["jax", teacher_param, d], p0, upto) for d in ("f32", "bf16"))
    jax_q = quantities(runs["jax", teacher_param, dtype], p0, upto)
    port_q = quantities(runs["port", teacher_param, dtype], p0, upto)
    for k in jax_q:
        spread = rel(j16[k], j32[k])
        d = rel(port_q[k], jax_q[k])
        assert d <= SLACK[dtype] * spread, (k, d, spread)
    for side in ("port", "jax"):
        assert [x["skipped"] for x in runs[side, teacher_param, dtype][:upto]] == [0] * upto


def test_progressive_step_skips_a_non_finite_batch_like_jax(params):
    cond, x0, mask = batch()
    x0[1, 3, 4, 2] = np.nan
    port, state = run_port(params, "f32", "eps", 2, (cond, x0, mask))
    jax_r = run_jax(params, "f32", "eps", 2, (cond, x0, mask))
    p0 = loop.ParamLayout.of(params).flatten(params).numpy()
    for r in (port, jax_r):
        assert [x["skipped"] for x in r] == [1, 2]
        assert all(np.isnan(x["loss"]) for x in r)
        assert np.array_equal(r[-1]["params"], p0) and np.array_equal(r[-1]["ema"], p0)
    assert int(state.opt_state.count) == 0 and state.step == 2


def test_progressive_step_draws_on_a_generator_per_step(params):
    """draws="device" seeds a generator from (key, step): the same step
    draws the same segments and noise, the next step other ones; the
    segments stay in [0, N)."""
    model = UNetSmall(4, BASE, 1, 8, torch.float32, autograd=True)
    step = distill.make_distill_step(model, Schedule.cosine(T), distill.DistillConfig(**CFG), 2,
                                     draws="device")
    dev = torch.device("cpu")
    i0, n0 = step.draw(KEY, 0, 64, (64, 2, 2, 1), dev)
    i0b, n0b = step.draw(KEY, 0, 64, (64, 2, 2, 1), dev)
    i1, n1 = step.draw(KEY, 1, 64, (64, 2, 2, 1), dev)
    assert torch.equal(i0, i0b) and torch.equal(n0, n0b) and not torch.equal(n0, n1)
    assert set(i0.tolist()) == {0, 1} and i0.dtype == torch.int64
    with pytest.raises(ValueError):
        distill.make_distill_step(model, Schedule.cosine(T), distill.DistillConfig(), 2,
                                  draws="nope")
    with pytest.raises(ValueError, match="autograd"):
        distill.make_distill_step(UNetSmall(4, BASE), Schedule.cosine(T),
                                  distill.DistillConfig(), 2)
