"""The port's train step (s1s2_torch.train.loss/loop) against the JAX
package's on the same numpy inputs, the same flax init and the same
threefry draws, at base 8, 32², B=2.

Tolerances. The loss, the timestep draws and the optimizer's arithmetic are
held to 1 ulp-scale bounds stated at each test. The whole step is held to
JAX's own spread, measured in the same test: the distance between JAX's
bf16 step and its f32 step (relative norms of the losses, per-channel
losses, parameter and EMA updates and Adam's moments). The port's f32 step
must be within 1e-2 of that distance of JAX's f32 step (f32 rounds 2^16
finer than bf16), its bf16 step within twice it of JAX's bf16 step (two
bf16 evaluations, each that far from f32, can be twice that apart)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn
from flax.traverse_util import flatten_dict, unflatten_dict

from s1s2.core import Schedule as JSchedule
from s1s2.models import UNetSmall as JUNet
from s1s2.train import loop as jloop
from s1s2.train.loss import masked_mse_per_channel as j_mse
from s1s2_torch.core import random
from s1s2_torch.core.schedule import Schedule
from s1s2_torch.models.unet import UNetSmall, init_params, max_pool2, max_pool2_train
from s1s2_torch.train import loop
from s1s2_torch.train.loss import masked_mse_per_channel

B, H, BASE, T = 2, 32, 8, 1000
STEPS = 20
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
SLACK = {"f32": 1e-2, "bf16": 2.0}


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


@pytest.fixture(scope="module")
def params():
    return init_params(4, BASE, 1, seed=0, in_ch=8)


@pytest.fixture(scope="module")
def jparams(params):
    return unflatten_dict({tuple(k.split(".")): jnp.asarray(v.numpy()) for k, v in params.items()})


def batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, H, 4)).astype(np.float32),
            rng.uniform(size=(B, H, H, 4)).astype(np.float32),
            (rng.uniform(size=(B, H, H)) > 0.2).astype(np.float32))


KEY = np.asarray(jax.random.PRNGKey(3))


def jflat(tree, names):
    f = flatten_dict(tree)
    return np.concatenate([np.asarray(f[tuple(n.split("."))], np.float32).reshape(-1)
                           for n in names])


def adam_state(opt_state):
    """optax's ScaleByAdamState inside a chain's nested state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    for s in opt_state if isinstance(opt_state, tuple) else ():
        found = adam_state(s)
        if found is not None:
            return found
    return None


def run_jax(jparams, names, dtype, jcfg, steps, data):
    model = JUNet(out_ch=4, base_ch=BASE, compute_dtype=DTYPES[dtype][0])
    state = jloop.create_train_state(jparams, jcfg)
    step = jax.jit(jloop.make_train_step(model.apply, JSchedule.cosine(T), jcfg))
    out = []
    for _ in range(steps):
        state, m = step(state, tuple(jnp.asarray(a) for a in data), jnp.asarray(KEY))
        adam = adam_state(state.opt_state)
        out.append(dict(loss=float(m["loss"]), ch=np.asarray(m["ch_losses"]),
                        p2=float(m["p2_w"]), skipped=int(m["skipped"]),
                        params=jflat(state.params, names), ema=jflat(state.ema_params, names),
                        mu=jflat(adam.mu, names), nu=jflat(adam.nu, names)))
    return out


def run_port(params, dtype, cfg, steps, data, remat=False, draws="threefry"):
    model = UNetSmall(4, BASE, 1, 8, DTYPES[dtype][1], autograd=True, remat=remat)
    state = loop.create_train_state(params, cfg)
    step = loop.make_train_step(model, Schedule.cosine(T), cfg, draws=draws)
    out = []
    for _ in range(steps):
        state, m = step(state, data, KEY)
        out.append(dict(loss=float(m["loss"]), ch=m["ch_losses"].numpy(), p2=float(m["p2_w"]),
                        skipped=int(m["skipped"]), params=state.params.numpy().copy(),
                        ema=state.ema_params.numpy().copy(), mu=state.opt_state.mu.numpy().copy(),
                        nu=state.opt_state.nu.numpy().copy()))
    return out, state


@pytest.fixture(scope="module")
def runs(params, jparams):
    """STEPS steps of the default (v) config in f32 and bf16, JAX and port."""
    names = tuple(params)
    data = batch()
    out = {}
    for dtype in DTYPES:
        out["jax", dtype] = run_jax(jparams, names, dtype, jloop.TrainConfig(T=T), STEPS, data)
        out["port", dtype] = run_port(params, dtype, loop.TrainConfig(T=T), STEPS, data)[0]
    return out


def quantities(rs, p0, upto):
    """The compared quantities after ``upto`` steps."""
    r = rs[upto - 1]
    return {"loss": [x["loss"] for x in rs[:upto]], "ch": np.stack([x["ch"] for x in rs[:upto]]),
            "update": r["params"] - p0, "ema_update": r["ema"] - p0, "mu": r["mu"], "nu": r["nu"]}


@pytest.mark.parametrize("upto", [1, STEPS])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_steps_match_jax_within_its_own_spread(runs, params, dtype, upto):
    p0 = loop.ParamLayout.of(params).flatten(params).numpy()
    j32, j16 = (quantities(runs["jax", d], p0, upto) for d in ("f32", "bf16"))
    jax_q, port_q = quantities(runs["jax", dtype], p0, upto), quantities(runs["port", dtype], p0,
                                                                          upto)
    for k in jax_q:
        spread = rel(j16[k], j32[k])
        assert rel(port_q[k], jax_q[k]) <= SLACK[dtype] * spread, (k, rel(port_q[k], jax_q[k]),
                                                                    spread)
    assert [x["skipped"] for x in runs["port", dtype][:upto]] == [0] * upto
    assert [x["skipped"] for x in runs["jax", dtype][:upto]] == [0] * upto
    # p2 weight: the batch mean of (k + SNR)^-1 at the same t, within XLA's pow
    assert np.allclose([x["p2"] for x in runs["port", dtype][:upto]],
                       [x["p2"] for x in runs["jax", dtype][:upto]], rtol=1e-5)


def test_ema_is_the_lerp_of_the_new_params(params):
    cfg = loop.TrainConfig(T=T, ema_decay=0.9)
    state = loop.create_train_state(params, cfg)
    step = loop.make_train_step(UNetSmall(4, BASE, 1, 8, torch.float32, autograd=True),
                                Schedule.cosine(T), cfg)
    new, _ = step(state, batch(), KEY)
    want = (1.0 - 0.9) * new.params + 0.9 * state.ema_params
    assert torch.equal(new.ema_params, want)
    assert not torch.equal(new.params, state.params) and new.step == 1


def test_non_finite_batch_is_skipped_like_jax(params, jparams):
    cond, x0, mask = batch()
    cond[0, 3, 4, 1] = np.nan
    cfg, jcfg = loop.TrainConfig(T=T), jloop.TrainConfig(T=T)
    port, state = run_port(params, "f32", cfg, 2, (cond, x0, mask))
    jax_r = run_jax(jparams, tuple(params), "f32", jcfg, 2, (cond, x0, mask))
    p0 = loop.ParamLayout.of(params).flatten(params).numpy()
    for r in (port, jax_r):
        assert [x["skipped"] for x in r] == [1, 2]
        assert all(np.isnan(x["loss"]) for x in r)
        assert np.array_equal(r[-1]["params"], p0) and np.array_equal(r[-1]["ema"], p0)
        assert not r[-1]["mu"].any()
    assert int(state.opt_state.count) == 0 and state.step == 2


def test_non_finite_grads_are_skipped(params):
    """A finite batch whose gradients overflow makes no update either."""
    cfg = loop.TrainConfig(T=T)
    state = loop.create_train_state(params, cfg)
    opt = loop.make_optimizer(cfg)
    grads = torch.ones_like(state.params)
    grads[7] = float("inf")
    new, ok = loop.guarded_update(state, opt, grads, torch.tensor(1.0), cfg.ema_decay)
    assert not bool(ok) and int(new.skipped) == 1
    assert torch.equal(new.params, state.params) and torch.equal(new.opt_state.mu,
                                                                  state.opt_state.mu)


@pytest.mark.parametrize("mode", ["no_mask", "mask_3d", "mask_4d", "mask_as_weights",
                                  "band_weights"])
def test_masked_mse_matches_jax(mode):
    rng = np.random.default_rng(1)
    pred = rng.normal(size=(3, 8, 8, 4)).astype(np.float32)
    tgt = rng.normal(size=(3, 8, 8, 4)).astype(np.float32)
    mask = (rng.uniform(size=(3, 8, 8)) - 0.3).astype(np.float32)  # binarised at > 0
    kw = {"no_mask": dict(mask=None), "mask_3d": dict(mask=mask),
          "mask_4d": dict(mask=mask[..., None]),
          "mask_as_weights": dict(mask=mask, mask_as_weights=True),
          "band_weights": dict(mask=mask, band_weights=(1.0, 2.0, 0.5, 0.0))}[mode]
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    got, got_ch = masked_mse_per_channel(torch.from_numpy(pred), torch.from_numpy(tgt), **tkw)
    want, want_ch = j_mse(jnp.asarray(pred), jnp.asarray(tgt), **kw)
    # f32 sums of 192 terms in another order: a few ulp
    np.testing.assert_allclose(got_ch.numpy(), np.asarray(want_ch), rtol=1e-6)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_masked_mse_computes_in_f32_from_bf16():
    pred = torch.randn((2, 4, 4, 4), generator=torch.Generator().manual_seed(0))
    loss, ch = masked_mse_per_channel(pred.bfloat16(), torch.zeros_like(pred))
    assert loss.dtype == ch.dtype == torch.float32
    assert torch.equal(ch, (pred.bfloat16().float() ** 2).sum((0, 1, 2)) / 32)


@pytest.mark.parametrize("lo,hi,shape", [(0, 1000, (7,)), (600, 1000, (13,)), (0, 50, (3, 4)),
                                         (5, 5, (4,)), (0, 2 ** 31 - 1, (6,)), (-7, 9, (5,)),
                                         (-2 ** 31, 2 ** 31 - 1, (9,))])
def test_randint_is_jax_bit_for_bit(lo, hi, shape):
    for seed in range(4):
        k = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.randint(k, shape, lo, hi))
        got = random.randint(np.asarray(k), shape, lo, hi)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("mode", ["uniform", "high_only", "mix_high"])
def test_sample_timesteps_is_jax_bit_for_bit(mode):
    for seed in range(3):
        k = jax.random.PRNGKey(seed)
        want = np.asarray(jloop.sample_timesteps(k, T, 64, mode, 0.3, 0.7))
        got = loop.sample_timesteps(np.asarray(k), T, 64, mode, 0.3, 0.7)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("mode", ["uniform", "high_only", "mix_high"])
def test_sample_timesteps_on_a_generator_keeps_the_ranges(mode):
    g = torch.Generator().manual_seed(0)
    t = loop.sample_timesteps_device(g, T, 4096, mode, 0.5, 0.6)
    assert t.dtype == torch.int32 and int(t.min()) >= 0 and int(t.max()) < T
    high = (t >= 600).float().mean().item()
    assert {"uniform": 0.35 < high < 0.45, "high_only": high == 1.0,
            "mix_high": 0.65 < high < 0.75}[mode]
    with pytest.raises(ValueError):
        loop.sample_timesteps_device(g, T, 4, "nope")


def test_step_seed_depends_on_key_and_step_only():
    k = random.PRNGKey(1338)
    assert loop.step_seed(k, 5) == loop.step_seed(random.PRNGKey(1338), 5)
    assert len({loop.step_seed(k, s) for s in range(50)}) == 50
    assert all(0 <= loop.step_seed(k, s) < 2 ** 63 for s in range(50))


def test_device_draws_replay_per_step(params):
    """The card's draw route (a generator re-seeded per step) on a CPU
    generator: the same step gives the same draws, as a resumed run needs."""
    step = loop.make_train_step(UNetSmall(4, BASE, 1, 8, torch.float32, autograd=True),
                                Schedule.cosine(T), loop.TrainConfig(T=T, cfg_drop_prob=0.3),
                                draws="device")
    cpu = torch.device("cpu")
    a, b, c = (step.draw(KEY, s, 4, (4, 8, 8, 4), cpu) for s in (7, 7, 8))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[1], c[1])
    assert not step.threefry(cpu)


@pytest.mark.parametrize("schedule", ["constant", "warmup_cosine"])
def test_optimizer_matches_optax_step_by_step(schedule):
    """clip → AdamW against optax on random gradients, large (clipped) and
    small, with both LR schedules; warmup 3 of 8 steps. Within 4e-7 relative
    of the params, or a few ulp (1e-6) of an update's size (lr) per step
    taken: f32 ops in the same order, but XLA's pow, cos and fused
    multiply-adds round within an ulp of PyTorch's."""
    cfg = loop.TrainConfig(lr=1e-2, weight_decay=0.1, grad_clip=0.5, lr_schedule=schedule,
                           warmup_steps=3, total_steps=8)
    jcfg = jloop.TrainConfig(lr=1e-2, weight_decay=0.1, grad_clip=0.5, lr_schedule=schedule,
                             warmup_steps=3, total_steps=8)
    rng = np.random.default_rng(2)
    p = rng.normal(size=(257,)).astype(np.float32)
    tx = jloop.make_optimizer(jcfg)
    jp, js = jnp.asarray(p), tx.init(jnp.asarray(p))
    update = jax.jit(tx.update)
    opt = loop.make_optimizer(cfg)
    tp = torch.from_numpy(p.copy())
    ts = opt.init(tp)
    for i in range(12):
        g = (rng.normal(size=p.shape) * (3.0 if i % 3 == 0 else 1e-3)).astype(np.float32)
        u, js = update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, u)
        tp, ts = opt.update(torch.from_numpy(g), ts, tp)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=4e-7,
                                   atol=1e-6 * cfg.lr * (i + 1))
    assert int(ts.count) == 12


def test_warmup_cosine_matches_optax():
    sched = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 10, 50)
    for c in range(0, 70):
        got = float(loop.warmup_cosine(torch.tensor(c, dtype=torch.int32), 3e-4, 10, 50))
        assert abs(got - float(sched(c))) <= 1e-6 * 3e-4, c


def test_clip_adds_nothing_to_the_norm():
    g = torch.tensor([3.0, 4.0])
    assert torch.equal(loop.clip_by_global_norm(g, 10.0), g)
    assert torch.equal(loop.clip_by_global_norm(g, 1.0), g / 5.0 * 1.0)
    j = optax.clip_by_global_norm(1.0).update(jnp.asarray(g.numpy()), None)[0]
    assert np.array_equal(np.asarray(j), (g / 5.0).numpy())


def test_train_config_defaults_and_eps_reference_match_jax():
    assert dataclass_dict(loop.TrainConfig()) == dataclass_dict(jloop.TrainConfig())
    assert (dataclass_dict(loop.TrainConfig.eps_reference(lr=3e-5, cfg_drop_prob=0.1))
            == dataclass_dict(jloop.TrainConfig.eps_reference(lr=3e-5, cfg_drop_prob=0.1)))


def dataclass_dict(c):
    import dataclasses

    return dataclasses.asdict(c)


@pytest.mark.parametrize("case", ["eps_reference", "cfg_dropout_bands_cosine"])
def test_options_step_matches_jax(params, jparams, case):
    """The ε preset, and CFG cond dropout with band weights, mask weights and
    the warmup-cosine LR, three steps each in f32 against JAX."""
    kw = ({} if case == "eps_reference" else
          dict(cfg_drop_prob=0.5, band_weights=(1.0, 0.5, 2.0, 1.0), mask_as_weights=True,
               lr_schedule="warmup_cosine", warmup_steps=2, total_steps=5, t_sampler="high_only"))
    make = "eps_reference" if case == "eps_reference" else None
    cfg = loop.TrainConfig.eps_reference(**kw) if make else loop.TrainConfig(T=T, **kw)
    jcfg = jloop.TrainConfig.eps_reference(**kw) if make else jloop.TrainConfig(T=T, **kw)
    data = batch(1)
    port = run_port(params, "f32", cfg, 3, data)[0]
    jax_r = run_jax(jparams, tuple(params), "f32", jcfg, 3, data)
    p0 = loop.ParamLayout.of(params).flatten(params).numpy()
    # the f32 bound of test_steps_match_jax_within_its_own_spread (1e-2 of
    # JAX's bf16-vs-f32 distance, ≥ 4e-5 there) on the losses, the update and
    # Adam's moments; the EMA has moved by ~1e-3 of the update after three
    # steps, under an ulp of its values, so it is held by its values: 1e-6
    jq, pq = quantities(jax_r, p0, 3), quantities(port, p0, 3)
    for k in ("loss", "ch", "update", "mu", "nu"):
        assert rel(pq[k], jq[k]) <= 4e-5, (k, rel(pq[k], jq[k]))
    assert rel(port[-1]["ema"], jax_r[-1]["ema"]) <= 1e-6


def test_cfg_dropout_keeps_jax_rows():
    """The drop mask is JAX's: uniform(k_drop, (B,1,1,1)) >= p."""
    cfg = loop.TrainConfig(T=T, cfg_drop_prob=0.5)
    step = loop.make_train_step(UNetSmall(4, BASE, 1, 8, torch.float32, autograd=True),
                                Schedule.cosine(T), cfg)
    for s in range(6):
        _, _, keep = step.draw(KEY, s, 16, (16, 4, 4, 4), torch.device("cpu"))
        k_drop = jax.random.split(jax.random.fold_in(jnp.asarray(KEY), s), 3)[2]
        want = np.asarray(jax.random.uniform(k_drop, (16, 1, 1, 1)) >= 0.5, np.float32)
        assert np.array_equal(keep.numpy(), want)


def test_remat_equals_no_remat(params):
    """Recomputing each block in the backward gives the same gradients, bit
    for bit (the same ops on the same inputs)."""
    data = tuple(torch.from_numpy(a) for a in batch())
    t = torch.tensor([10, 900], dtype=torch.int32)
    noise = torch.from_numpy(random.normal(random.PRNGKey(4), (B, H, H, 4)))
    grads = []
    for remat in (False, True):
        step = loop.make_train_step(UNetSmall(4, BASE, 1, 8, torch.float32, autograd=True,
                                              remat=remat), Schedule.cosine(T),
                                    loop.TrainConfig(T=T))
        state = loop.create_train_state(params, loop.TrainConfig(T=T))
        grads.append(step.loss_and_grads(state.params, state.layout, *data, t, noise)[3])
    assert torch.equal(grads[0], grads[1]) and grads[0].abs().sum() > 0


def test_remat_needs_the_training_path():
    with pytest.raises(ValueError):
        UNetSmall(4, 8, remat=True)
    with pytest.raises(ValueError):
        loop.make_train_step(UNetSmall(4, 8), Schedule.cosine(T), loop.TrainConfig())


def test_max_pool_ties_route_as_jax():
    """On tied windows (common in bf16) JAX's gradient of nn.max_pool gives
    the whole gradient to the first largest element; amax would split it."""
    win = np.array([[1.0, 1.0], [1.0, 0.5]], np.float32)
    x = np.tile(win, (3, 4))[None, :, :, None] * np.array([1.0, 2.0], np.float32)  # (1,6,8,2)
    x[0, 2, 2, 1] = 7.0  # one window with a unique max
    up = np.random.default_rng(3).normal(size=(1, 3, 4, 2)).astype(np.float32)
    want = jax.grad(lambda a: (nn.max_pool(a, (2, 2), (2, 2)) * up).sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (max_pool2_train(xt) * torch.from_numpy(up)).sum().backward()
    assert np.array_equal(xt.grad.numpy(), np.asarray(want))
    assert torch.equal(max_pool2_train(xt).detach(), max_pool2(xt.detach()))
    xa = torch.from_numpy(x).requires_grad_(True)
    (max_pool2(xa) * torch.from_numpy(up)).sum().backward()
    assert not np.array_equal(xa.grad.numpy(), np.asarray(want))  # amax splits ties


def test_training_path_forward_matches_inference_path(params):
    """The autograd conv computes the inference conv's function (f32)."""
    x = torch.from_numpy(np.concatenate(batch()[:2], -1))
    t = torch.tensor([3, 700], dtype=torch.int32)
    inf = UNetSmall(4, BASE, 1, 8, torch.float32)
    inf.load_state_dict(params)
    tr = UNetSmall(4, BASE, 1, 8, torch.float32, autograd=True)
    tr.load_state_dict(params)
    with torch.no_grad():
        np.testing.assert_allclose(tr(x, t).numpy(), inf(x, t).numpy(), rtol=1e-5, atol=1e-5)
