"""The int8-out conv mode (``ops/conv3x3.conv3x3_int8_q``) through its plain
version on the CPU, and the probe's conv chains (``tools/probe_int8.py``),
against the reference probe's int8 chain (``tools/probe_pallas_int8.py:
probe_conv``): ``conv_general_dilated`` with int32 accumulation, then
``clip(round(max(f32(acc)·scale, 0)), -127, 127)`` to int8, here on the
JAX package's CPU. Integer sums are exact and the requant is one f32
multiply and a round half to even, so every comparison is bit-equal. The
CUDA kernel itself is held to the plain version on the card
(``chip_smoke.py`` phase 3, ``tests/test_torch_gpu.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s1s2_torch.ops.conv3x3 import (conv3x3_int8_q, conv3x3_int8_q_plain, conv3x3_relu,
                                    requant_plain)
from s1s2_torch.tools import probe_int8

torch.set_num_threads(1)
SCALE = np.float32(1.0 / (127.0 * 8))


def _jax_requant_conv(x8, w8, scale=SCALE, relu=True):
    dn = jax.lax.conv_dimension_numbers(x8.shape, w8.shape, ("NHWC", "HWIO", "NHWC"))
    acc = jax.lax.conv_general_dilated(jnp.asarray(x8), jnp.asarray(w8), (1, 1), "SAME",
                                       dimension_numbers=dn,
                                       preferred_element_type=jnp.int32)
    y = acc.astype(jnp.float32) * jnp.float32(scale)
    if relu:
        y = jnp.maximum(y, 0.0)
    return np.asarray(jnp.clip(jnp.round(y), -127, 127).astype(jnp.int8))


def _operands(B, H, Cin, Cout, seed=0):
    """The reference probe's operands at a small shape: x ~ N(0, 1), w ~
    N(0, 0.05²), x8 = int8(16·x), w8 = int8(160·w), cast toward zero."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, H, Cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, Cin, Cout)) * 0.05).astype(np.float32)
    return x, w, (x * 16).astype(np.int8), (w * 160).astype(np.int8)


def _tq(deq, b):
    return (torch.from_numpy(np.asarray(deq, np.float32)),
            torch.from_numpy(np.asarray(b, np.float32)))


@pytest.mark.parametrize("B,H,Cin,Cout", [(1, 16, 32, 32), (1, 16, 64, 32), (2, 20, 32, 24)])
def test_int8_out_plain_bit_equal_to_jax(B, H, Cin, Cout):
    _, _, x8, w8 = _operands(B, H, Cin, Cout)
    deq, b = _tq(np.full(Cout, SCALE), np.zeros(Cout))
    got = conv3x3_int8_q(torch.from_numpy(x8), torch.from_numpy(w8), deq, b)
    assert got.dtype == torch.int8 and tuple(got.shape) == (B, H, H, Cout)
    want = _jax_requant_conv(x8, w8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).mean() > 0.2  # the requant keeps values: not all clipped to 0


def test_int8_out_without_relu_clips_both_sides():
    """Without ReLU the requant clips at ±127; a large scale reaches both."""
    _, _, x8, w8 = _operands(1, 16, 32, 32, seed=1)
    scale = np.float32(0.05)
    deq, b = _tq(np.full(32, scale), np.zeros(32))
    got = conv3x3_int8_q(torch.from_numpy(x8), torch.from_numpy(w8), deq, b, apply_relu=False)
    want = _jax_requant_conv(x8, w8, scale, relu=False)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 127).any() and (want == -127).any()


def test_requant_per_channel_scale_and_bias():
    """The general epilogue: acc·deq[co] + b[co] in two f32 roundings."""
    rng = np.random.default_rng(2)
    acc = rng.integers(-200_000, 200_000, (2, 4, 4, 8)).astype(np.int32)
    deq = (rng.random(8) * 1e-3).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    got = requant_plain(torch.from_numpy(acc), *_tq(deq, b)).numpy()
    y = np.maximum(acc.astype(np.float32) * deq + b, np.float32(0))
    np.testing.assert_array_equal(got, np.clip(np.round(y), -127, 127).astype(np.int8))


def test_cast_toward_zero_as_astype():
    v = np.array([-130.7, -127.9, -1.5, -0.5, 0.5, 1.5, 2.7, 126.99, 300.0], np.float32)
    got = probe_int8.int8_toward_zero(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, [-128, -127, -1, 0, 0, 1, 2, 126, 127])
    x = np.random.default_rng(3).standard_normal(1000).astype(np.float32) * 16
    np.testing.assert_array_equal(probe_int8.int8_toward_zero(torch.from_numpy(x)).numpy(),
                                  x.astype(np.int8))


@pytest.mark.parametrize("C,scale", [(32, SCALE), (64, SCALE), (32, np.float32(1 / 64))])
def test_three_rep_chain_bit_equal_to_jax(C, scale):
    """The probe's int8 chain, 3 reps at B=1, 16²: each rep's int8 output
    is the next rep's input. At the probe's scale 1/(127·8) the values
    shrink rep by rep at these widths (the probe times the chain; it keeps
    no signal); at 1/64 they stay alive through all three."""
    _, _, x8, w8 = _operands(1, 16, C, C, seed=4)
    got = probe_int8.chain_int8(torch.from_numpy(x8), torch.from_numpy(w8), reps=3,
                                scale=float(scale)).numpy()
    want = x8
    for _ in range(3):
        want = _jax_requant_conv(want, w8, scale)
    np.testing.assert_array_equal(got, want)
    if scale != SCALE:
        assert 0.1 < (want > 0).mean() < 1 and (want == 127).any()
    plain = probe_int8.chain_int8(torch.from_numpy(x8), torch.from_numpy(w8), reps=3,
                                  scale=float(scale), conv=conv3x3_int8_q_plain).numpy()
    np.testing.assert_array_equal(plain, got)


def test_bf16_chain_against_conv2d_chain():
    """The bf16 chain on the conv's plain version and on ``F.conv2d``: the
    same function (relu and ×0.0625 commute with the one rounding), so
    within a bf16 ulp of the larger per rep."""
    x, w, _, _ = _operands(1, 16, 32, 32, seed=5)
    xb, wb = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w).to(torch.bfloat16)
    a = probe_int8.chain_bf16(xb, wb, reps=1).float()
    b = probe_int8.chain_conv2d(xb, wb, reps=1).float()
    assert a.dtype == b.dtype and a.shape == b.shape
    assert float((a - b).abs().max()) <= 2.0 ** -7 * float(a.abs().max())
    zero = torch.zeros(32)
    np.testing.assert_array_equal(a.numpy(),
                                  (conv3x3_relu(xb, wb, zero) * 0.0625).float().numpy())


def test_wrapper_refuses_a_cin_off_the_k_step():
    x8 = torch.zeros((1, 8, 8, 24), dtype=torch.int8)
    w8 = torch.zeros((3, 3, 24, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="multiple of 32"):
        conv3x3_int8_q(x8, w8, torch.ones(16), torch.zeros(16))


def test_bounds_and_the_card_check():
    b = probe_int8.conv_bounds()
    ops = 6 * 2.0 * 32 * 256 * 256 * 9 * 128 * 128
    assert b["bf16"] == (pytest.approx(1e3 * ops / 989e12), "operations")
    assert b["int8"] == (pytest.approx(1e3 * ops / 1979e12), "operations")
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="measures the card"):
            probe_int8.main(["conv"])
    with pytest.raises(SystemExit, match="usage"):
        probe_int8.main(["convs"])


def test_plain_version_is_conv_then_requant():
    _, _, x8, w8 = _operands(1, 8, 32, 16, seed=6)
    deq, b = _tq(np.full(16, SCALE), np.zeros(16))
    a = conv3x3_int8_q_plain(torch.from_numpy(x8), torch.from_numpy(w8), deq, b)
    assert conv3x3_int8_q.launches == 0  # the CPU path launches nothing
    np.testing.assert_array_equal(a.numpy(), _jax_requant_conv(x8, w8))
