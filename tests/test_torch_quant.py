"""s1s2_torch int8 path against the JAX package's models/quant.py on the
same numpy inputs and the committed 24x4 checkpoint (full width, 64²)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from s1s2.core import Schedule as JSchedule
from s1s2.core.parametrize import q_sample as j_q_sample
from s1s2.models import UNetSmall as JUNet
from s1s2.models import quant as jq
from s1s2_torch.core.random import PRNGKey
from s1s2_torch.models import quant as tq
from s1s2_torch.models.weights import params_from_numpy
from s1s2_torch.ops.conv3x3 import conv3x3_relu, conv3x3_relu_int8

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "examples", "checkpoints", "distill_eps_student24x4.bf16.msgpack")
TVALS = (200, 100, 20)


def _j(name):
    return name.replace(".", "/")


@pytest.fixture(scope="module")
def case():
    with open(CKPT, "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    rng = np.random.default_rng(11)
    gt = rng.random((8, 64, 64, 4)).astype(np.float32)
    cond = rng.standard_normal((8, 64, 64, 4)).astype(np.float32)
    noises = [rng.standard_normal(gt.shape).astype(np.float32) for _ in TVALS]
    ab = JSchedule.cosine(1000).alpha_bar_np()
    # the JAX recipe of make_sampler_calib, with the noise drawn by numpy
    jcal = []
    for tval, eps in zip(TVALS, noises):
        x_t = j_q_sample(jnp.asarray(gt), jnp.asarray(eps), float(np.sqrt(ab[tval])),
                         float(np.sqrt(1.0 - ab[tval])))
        jcal.append((jnp.concatenate([x_t, jnp.asarray(cond)], -1),
                     jnp.full((8,), tval, jnp.int32)))
    jqp = jq.quantize_unet(tree, jcal, base_ch=24, stem_s2d=4)
    state = params_from_numpy(tree)
    tcal = tq.make_sampler_calib(torch.from_numpy(gt), torch.from_numpy(cond), ab, TVALS,
                                 noises=[torch.from_numpy(e) for e in noises])
    tqp = tq.quantize_unet(state, tcal, base_ch=24, stem_s2d=4)
    x = np.concatenate([noises[0][:3], cond[:3]], -1)
    t = np.array([200, 100, 20], np.int32)
    return dict(tree=tree, state=state, jcal=jcal, tcal=tcal, jqp=jqp, tqp=tqp, x=x, t=t)


def test_calibration_batches_bit_equal(case):
    for (jx, jt), (tx, tt) in zip(case["jcal"], case["tcal"]):
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_int8_weights_and_scales_bit_equal(case):
    jqp, tqp = case["jqp"], case["tqp"]
    assert sorted(map(_j, tqp.w8)) == sorted(jqp.w8)
    for name, (w8, sw) in tqp.w8.items():
        jw8, jsw = jqp.w8[_j(name)]
        assert w8.dtype == torch.int8 and sw.dtype == torch.float32
        np.testing.assert_array_equal(w8.numpy(), np.asarray(jw8))
        np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw))
        np.testing.assert_array_equal(tqp.bias[name].numpy(), np.asarray(jqp.bias[_j(name)]))


def test_activation_scales(case):
    """The scales are the absmax of each conv input through the bf16 network.
    The first block's input is one conv deep, and its scale is within one
    bf16 ulp, which is 2^-8 to 2^-7 of a value. Deeper inputs carry the bf16
    rounding differences of every conv before them (JAX rounds the product
    and the bias add separately, the port's conv once), so their scales agree
    within 2^-5 relative."""
    jqp, tqp = case["jqp"], case["tqp"]
    assert sorted(map(_j, tqp.act_scale)) == sorted(jqp.act_scale)
    rel = {k: abs(v - jqp.act_scale[_j(k)]) / jqp.act_scale[_j(k)]
           for k, v in tqp.act_scale.items()}
    assert rel["down1.conv1"] <= 2.0 ** -7
    assert max(rel.values()) <= 2.0 ** -5, rel


def test_calibration_takes_the_max_over_batches(case):
    state, tcal = case["state"], case["tcal"]
    both = tq.calibrate(state, tcal, base_ch=24, stem_s2d=4)
    each = [tq.calibrate(state, [b], base_ch=24, stem_s2d=4) for b in tcal]
    for k, v in both.items():
        assert v == max(e[k] for e in each)


def test_int8_forward_against_jax(case):
    """With the same scales, the port's int8 forward against quant_apply. A
    bf16 difference of one ulp can move an activation across an int8 step,
    so the two differ by a fraction of the quantization error itself: mean
    |Δ| ≤ 0.6 × the mean |int8 − bf16| of the JAX model on the same input,
    and max |Δ| ≤ 0.25 × max |ε| (the bound tests/test_quant.py puts on
    int8 against bf16)."""
    jqp, tqp, x, t = case["jqp"], case["tqp"], case["x"], case["t"]
    same = tq.QuantParams(tqp.params, tqp.w8, tqp.bias,
                          {k: jqp.act_scale[_j(k)] for k in tqp.act_scale}, 4, 24, 4)
    ref = np.asarray(jq.quant_apply(jqp, jnp.asarray(x), jnp.asarray(t)))
    got = tq.quant_apply(same, torch.from_numpy(x), torch.from_numpy(t)).numpy()
    bf16 = np.asarray(JUNet(out_ch=4, base_ch=24, stem_s2d=4).apply(
        {"params": case["tree"]}, jnp.asarray(x), jnp.asarray(t)))
    d = np.abs(got - ref)
    assert np.isfinite(got).all() and got.shape == (3, 64, 64, 4)
    assert d.mean() <= 0.6 * np.abs(ref - bf16).mean(), (d.mean(), np.abs(ref - bf16).mean())
    assert d.max() <= 0.25 * np.abs(ref).max(), d.max()


def test_int8_forward_with_own_calibration(case):
    """End to end through the port's own calibration: still well inside the
    JAX int8-vs-bf16 gap."""
    jqp, tqp, x, t = case["jqp"], case["tqp"], case["x"], case["t"]
    ref = np.asarray(jq.quant_apply(jqp, jnp.asarray(x), jnp.asarray(t)))
    got = tq.quant_apply(tqp, torch.from_numpy(x), torch.from_numpy(t)).numpy()
    bf16 = np.asarray(JUNet(out_ch=4, base_ch=24, stem_s2d=4).apply(
        {"params": case["tree"]}, jnp.asarray(x), jnp.asarray(t)))
    assert np.abs(got - ref).mean() <= 0.75 * np.abs(ref - bf16).mean()


def test_quant_apply_on_cpu_launches_no_kernel(case):
    n = (conv3x3_relu.launches, conv3x3_relu_int8.launches)
    tq.quant_apply(case["tqp"], torch.from_numpy(case["x"][:1]), torch.from_numpy(case["t"][:1]))
    assert (conv3x3_relu.launches, conv3x3_relu_int8.launches) == n


def test_denoise_fn_concatenates_x_then_cond(case):
    tqp, x, t = case["tqp"], case["x"], case["t"]
    fn = tq.make_quant_denoise_fn(tqp, torch.from_numpy(x[..., 4:]))
    a = fn(torch.from_numpy(x[..., :4]), torch.from_numpy(t))
    b = tq.quant_apply(tqp, torch.from_numpy(x), torch.from_numpy(t))
    assert torch.equal(a, b)


def test_seeded_calibration_is_deterministic():
    gt = torch.rand((2, 8, 8, 4))
    cond = torch.rand((2, 8, 8, 4))
    ab = JSchedule.cosine(1000).alpha_bar_np()
    a = tq.make_sampler_calib(gt, cond, ab, TVALS)  # PRNGKey(5)
    b = tq.make_sampler_calib(gt, cond, ab, TVALS, key=PRNGKey(5))
    c = tq.make_sampler_calib(gt, cond, ab, TVALS, key=PRNGKey(6))
    assert all(torch.equal(x[0], y[0]) for x, y in zip(a, b))
    assert not torch.equal(a[0][0], c[0][0])
    assert [int(x[1][0]) for x in a] == list(TVALS)


@pytest.mark.parametrize("kw", [{"quant_up": True},
                                {"quant_up": True, "act_perchannel": True},
                                {"quant_up": True, "bf16_blocks": ("conv1",)}])
def test_options_not_ported_yet_raise(case, kw):
    """quant_up (int8 transposed convs) was the one option not ported, and
    these cases checked that it raised; it is ported now, with any other
    option beside it, and each case holds it to the JAX package: both entry
    points quantize the same convs, the int8 weights and biases (per-channel
    scales folded in: the JAX scales) are JAX's bit for bit, and the forward
    with JAX's scales is within test_int8_forward_against_jax's bounds."""
    jqp = jq.quantize_unet(case["tree"], case["jcal"], base_ch=24, stem_s2d=4, **kw)
    tqp = tq.quantize_unet(case["state"], case["tcal"], base_ch=24, stem_s2d=4, **kw)
    assert sorted(map(_j, tqp.w8)) == sorted(jqp.w8)
    assert {"up3", "up2", "up1"} <= set(tqp.w8) and ("conv1.conv1" in tqp.w8) == (
        "bf16_blocks" not in kw)
    pc = kw.get("act_perchannel", False)
    scales = {k: (torch.from_numpy(np.asarray(jqp.act_scale[_j(k)])) if pc
                  else jqp.act_scale[_j(k)]) for k in tqp.act_scale}
    w8, bias = tq.quantize_weights(case["state"], quant_up=True,
                                   act_scales=scales if pc else None,
                                   bf16_blocks=kw.get("bf16_blocks", ()))
    for name, (q, sw) in w8.items():
        np.testing.assert_array_equal(q.numpy(), np.asarray(jqp.w8[_j(name)][0]))
        np.testing.assert_array_equal(sw.numpy(), np.asarray(jqp.w8[_j(name)][1]))
        np.testing.assert_array_equal(bias[name].numpy(), np.asarray(jqp.bias[_j(name)]))
    same = tq.QuantParams(case["state"], w8, bias, scales, 4, 24, 4, pc)
    x, t = case["x"], case["t"]
    ref = np.asarray(jq.quant_apply(jqp, jnp.asarray(x), jnp.asarray(t)))
    got = tq.quant_apply(same, torch.from_numpy(x), torch.from_numpy(t)).numpy()
    bf16 = np.asarray(JUNet(out_ch=4, base_ch=24, stem_s2d=4).apply(
        {"params": case["tree"]}, jnp.asarray(x), jnp.asarray(t)))
    d = np.abs(got - ref)
    assert d.mean() <= 0.6 * np.abs(ref - bf16).mean(), (d.mean(), np.abs(ref - bf16).mean())
    assert d.max() <= 0.25 * np.abs(ref).max(), d.max()


def test_quant_params_copy_to_a_device_is_the_same_model(case):
    tqp, x, t = case["tqp"], case["x"], case["t"]
    copy = tqp.to("cpu")
    assert copy.act_scale == tqp.act_scale and copy.act_scale is not tqp.act_scale
    assert all(torch.equal(copy.deq[k], tqp.deq[k]) for k in tqp.deq)
    assert torch.equal(tq.quant_apply(copy, torch.from_numpy(x), torch.from_numpy(t)),
                       tq.quant_apply(tqp, torch.from_numpy(x), torch.from_numpy(t)))
