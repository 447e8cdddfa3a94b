"""s1s2_torch ops against the JAX package on the same numpy inputs: the conv
plain versions against the Pallas conv kernels (interpret mode) and the int8
conv of models/quant.py, the DDIM update against the Pallas kernel and the
sampler's arithmetic, the pixel-shuffle ops against JAX. The CUDA kernels
themselves are checked against the plain versions on the card by
tests/test_torch_gpu.py and by chip_smoke.py."""

import os
import stat
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from s1s2.ops import fused_ddim_update as j_fused_ddim_update
from s1s2.ops import pixel_shuffle as jps
from s1s2.ops.conv3x3 import conv3x3_relu as j_conv3x3_relu
from s1s2.ops.conv3x3 import conv3x3_relu_bs as j_conv3x3_relu_bs
from s1s2.sampling.samplers import _ddim_linspace_scan as j_scan
from s1s2.core import Schedule as JSchedule
from s1s2_torch.core.schedule import Schedule
from s1s2_torch.ops import _build
from s1s2_torch.ops import pixel_shuffle as tps
from s1s2_torch.ops.conv3x3 import (conv3x3_int8_acc_plain, conv3x3_relu,
                                    conv3x3_relu_int8, conv3x3_relu_int8_plain,
                                    conv3x3_relu_plain, packed_weight, quantize_act)
from s1s2_torch.ops.fused_elementwise import (ddim_coefs, ddim_update_plain,
                                              fused_ddim_update)
from s1s2_torch.sampling.samplers import _ddim_linspace_scan

BF16 = jnp.bfloat16


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _bf16_close(got, ref):
    """Within 1 bf16 ulp of the larger magnitude (f32 accumulation order
    differs), plus 1e-6 absolute for values that straddle zero."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    mag = np.maximum(np.abs(got), np.abs(ref))
    assert np.all(np.abs(got - ref) <= mag * 2.0 ** -7 + 1e-6), np.abs(got - ref).max()


def _conv_case(rng, B, H, W, Ci, Co):
    x = rng.standard_normal((B, H, W, Ci)).astype(np.float32)
    w = (rng.standard_normal((3, 3, Ci, Co)) * 0.2).astype(np.float32)
    b = rng.standard_normal(Co).astype(np.float32)
    return x, w, b


CONV_SHAPES = [  # tests/test_ops.py shapes, plus the 24x4 stem's odd Cin=129
    (1, 8, 8, 4, 4, 8),
    (3, 32, 16, 8, 5, 8),
    (2, 16, 8, 6, 7, 4),
    (1, 16, 16, 129, 24, 8),
]
CONV_BS_SHAPES = [
    (1, 8, 8, 4, 4, 8, True),
    (3, 32, 16, 8, 5, 8, True),
    (2, 16, 8, 6, 7, 4, False),
    (1, 24, 8, 3, 9, 8, True),
    (2, 16, 16, 129, 24, 8, False),
]


class TestConvPlainF32:
    @pytest.mark.parametrize("B,H,W,Ci,Co,TH", CONV_SHAPES)
    def test_matches_pallas_conv3x3_relu(self, rng, B, H, W, Ci, Co, TH):
        x, w, b = _conv_case(rng, B, H, W, Ci, Co)
        with pltpu.force_tpu_interpret_mode():
            ref = j_conv3x3_relu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), tile_rows=TH)
        got = conv3x3_relu(_t(x), _t(w), _t(b))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-5)

    @pytest.mark.parametrize("B,H,W,Ci,Co,R,relu", CONV_BS_SHAPES)
    def test_matches_pallas_conv3x3_relu_bs(self, rng, B, H, W, Ci, Co, R, relu):
        x, w, b = _conv_case(rng, B, H, W, Ci, Co)
        with pltpu.force_tpu_interpret_mode():
            ref = j_conv3x3_relu_bs(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                    tile_rows=R, apply_relu=relu)
        got = conv3x3_relu_plain(_t(x), _t(w), _t(b), apply_relu=relu)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-5)


def test_train_conv_kept_off_tf32_is_the_conv_and_its_gradients():
    """The card's f32 training conv (``conv3x3._ConvF32``: ``F.conv2d`` with
    TF32 off in its forward and its backward) is ``F.conv2d`` and its exact
    gradients: the same output, and gradcheck in f64, here on the CPU."""
    from s1s2_torch.ops.conv3x3 import _ConvF32

    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 5, 7, 6), generator=g, dtype=torch.float64, requires_grad=True)
    w = torch.randn((4, 5, 3, 3), generator=g, dtype=torch.float64, requires_grad=True)
    assert torch.equal(_ConvF32.apply(x, w), torch.nn.functional.conv2d(x, w, padding=1))
    assert torch.autograd.gradcheck(_ConvF32.apply, (x, w))


class TestConvPlainBF16:
    @pytest.mark.parametrize("B,H,W,Ci,Co,TH", CONV_SHAPES)
    def test_matches_pallas_conv3x3_relu(self, rng, B, H, W, Ci, Co, TH):
        x, w, b = _conv_case(rng, B, H, W, Ci, Co)
        xb, wb = jnp.asarray(x).astype(BF16), jnp.asarray(w).astype(BF16)
        with pltpu.force_tpu_interpret_mode():
            ref = j_conv3x3_relu(xb, wb, jnp.asarray(b), tile_rows=TH)
        got = conv3x3_relu(_t(xb).to(torch.bfloat16), _t(wb).to(torch.bfloat16), _t(b))
        assert got.dtype == torch.bfloat16 and ref.dtype == BF16
        _bf16_close(got.float().numpy(), ref)

    @pytest.mark.parametrize("B,H,W,Ci,Co,R,relu", CONV_BS_SHAPES)
    def test_matches_pallas_conv3x3_relu_bs(self, rng, B, H, W, Ci, Co, R, relu):
        x, w, b = _conv_case(rng, B, H, W, Ci, Co)
        xb, wb = jnp.asarray(x).astype(BF16), jnp.asarray(w).astype(BF16)
        with pltpu.force_tpu_interpret_mode():
            ref = j_conv3x3_relu_bs(xb, wb, jnp.asarray(b), tile_rows=R, apply_relu=relu)
        got = conv3x3_relu_plain(_t(xb).to(torch.bfloat16), _t(wb).to(torch.bfloat16),
                                 _t(b), apply_relu=relu)
        _bf16_close(got.float().numpy(), ref)

    def test_wrapper_on_cpu_runs_plain_and_launches_nothing(self, rng):
        x, w, b = _conv_case(rng, 2, 8, 8, 5, 3)
        before = (conv3x3_relu.launches, conv3x3_relu_int8.launches)
        xb, wb = _t(x).to(torch.bfloat16), _t(w).to(torch.bfloat16)
        assert torch.equal(conv3x3_relu(xb, wb, _t(b), False),
                           conv3x3_relu_plain(xb, wb, _t(b), False))
        assert (conv3x3_relu.launches, conv3x3_relu_int8.launches) == before

    @pytest.mark.parametrize("xs,ws", [((2, 8, 8, 5), (3, 3, 4, 3)), ((8, 8, 5), (3, 3, 5, 3)),
                                       ((2, 8, 8, 5), (1, 1, 5, 3))])
    def test_bad_shapes_raise(self, xs, ws):
        with pytest.raises(ValueError):
            conv3x3_relu(torch.zeros(xs), torch.zeros(ws), torch.zeros(ws[-1]))


def _int8_case(rng, B, H, W, Ci, Co):
    """bf16 activations (ReLU-like and signed), per-Co int8 weights as
    quantize_weights makes them, f32 bias; sx = absmax/127."""
    x = rng.standard_normal((B, H, W, Ci)).astype(np.float32)
    x[..., : Ci // 2] = np.abs(x[..., : Ci // 2])
    xb = np.asarray(jnp.asarray(x).astype(BF16).astype(jnp.float32))
    w = (rng.standard_normal((3, 3, Ci, Co)) * 0.1).astype(np.float32)
    sw = np.maximum(np.abs(w).reshape(-1, Co).max(0) / 127.0, 1e-12).astype(np.float32)
    w8 = np.clip(np.round(w / sw), -127, 127).astype(np.int8)
    b = rng.standard_normal(Co).astype(np.float32)
    sx = max(float(np.abs(xb).max()), 1e-6) / 127.0
    return xb, w8, sw, b, sx


INT8_SHAPES = [(2, 8, 8, 24, 48), (1, 16, 16, 48, 24), (2, 4, 4, 192, 96), (1, 8, 8, 5, 7)]


class TestConvInt8Plain:
    @pytest.mark.parametrize("B,H,W,Ci,Co", INT8_SHAPES)
    def test_quantizer_is_true_division_round_half_even(self, rng, B, H, W, Ci, Co):
        xb, _, _, _, sx = _int8_case(rng, B, H, W, Ci, Co)
        want = np.clip(np.round(xb / np.float32(sx)), -127, 127).astype(np.int8)
        got = quantize_act(torch.from_numpy(xb.copy()).to(torch.bfloat16), sx).numpy()
        np.testing.assert_array_equal(got, want)

    def test_kernel_quantizer_arithmetic_is_the_ieee_division(self, rng):
        """The card's quantizer (csrc/conv3x3.cu quantize_act) in float32
        numpy: t = x·RN(1/sx), the IEEE quotient only where t lies within
        3.1e-5 of a half-integer, rint by adding and subtracting 1.5·2^23.
        Equal to the plain version for every finite bf16 x, at scales where
        many quotients are exact half-integers (powers of two), at scales
        sx = RN(x0 / (k + 0.5)) that put a quotient within an ulp of a
        half-integer (without the IEEE fallback, some of these differ) and
        at random ones."""
        f32 = np.float32
        bits = np.arange(1 << 16, dtype=np.uint32) << np.uint32(16)
        x = bits.view(np.float32)
        x = x[np.isfinite(x)]
        xb = torch.from_numpy(x.copy()).to(torch.bfloat16)
        assert torch.equal(xb.float(), torch.from_numpy(x))  # every value is a bf16
        magic = f32(12582912.0)
        scales = [f32(2.0) ** k for k in range(-24, 8)]
        scales += list((10.0 ** rng.uniform(-8, 3, 200)).astype(np.float32))
        scales += list((rng.uniform(0.5, 40.0, 50) / 127.0).astype(np.float32))
        x0 = x[(np.abs(x) > 1e-3) & (np.abs(x) < 1e3)]
        scales += [f32(abs(float(rng.choice(x0))) / (int(rng.integers(0, 127)) + 0.5))
                   for _ in range(300)]
        with np.errstate(over="ignore", invalid="ignore"):
            for sx in scales:
                sx = f32(sx)
                t = x * (f32(1.0) / sx)
                h = np.abs(t)
                dist = np.abs(h - ((h + magic) - magic))
                near = (h < f32(128.0)) & (dist > f32(0.5) - f32(3.1e-5))
                t = np.where(near, x / sx, t)
                t = np.clip(t, f32(-128.0), f32(128.0))
                q = np.clip((t + magic).view(np.int32) - 0x4B400000, -127, 127)
                np.testing.assert_array_equal(q.astype(np.int8), quantize_act(xb, float(sx)).numpy(),
                                              err_msg=f"sx={sx!r}")

    def test_quantizer_against_xla(self, rng):
        """XLA compiles the JAX package's ``x / sx`` (sx a compile-time
        constant) into a multiplication by the f32 reciprocal; the port
        divides. They may differ by one step, rarely, where x/sx lies within
        an ulp of a rounding boundary."""
        xb, *_, sx = _int8_case(rng, 8, 32, 32, 48, 8)
        f = jax.jit(lambda x: jnp.clip(jnp.round(x.astype(jnp.float32) / sx),
                                       -127, 127).astype(jnp.int8))
        ref = np.asarray(f(jnp.asarray(xb).astype(BF16))).astype(np.int32)
        got = quantize_act(torch.from_numpy(xb.copy()).to(torch.bfloat16), sx).numpy().astype(np.int32)
        assert np.abs(got - ref).max() <= 1
        assert (got != ref).mean() < 5e-3

    @pytest.mark.parametrize("B,H,W,Ci,Co", INT8_SHAPES)
    def test_int32_accumulator_bit_equal(self, rng, B, H, W, Ci, Co):
        xb, w8, *_, sx = _int8_case(rng, B, H, W, Ci, Co)
        x8 = quantize_act(torch.from_numpy(xb.copy()).to(torch.bfloat16), sx)
        ref = jax.lax.conv_general_dilated(
            jnp.asarray(x8.numpy()), jnp.asarray(w8), (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32)
        got = conv3x3_int8_acc_plain(x8, torch.from_numpy(w8))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

    def test_accumulator_exact_above_2_pow_24(self):
        """Cin=192 at full scale: |acc| = 9·192·127·127 > 2^24 stays exact."""
        x8 = torch.full((1, 3, 3, 192), 127, dtype=torch.int8)
        w8 = torch.full((3, 3, 192, 1), 127, dtype=torch.int8)
        acc = conv3x3_int8_acc_plain(x8, w8)
        assert int(acc[0, 1, 1, 0]) == 9 * 192 * 127 * 127

    @pytest.mark.parametrize("B,H,W,Ci,Co", INT8_SHAPES)
    @pytest.mark.parametrize("relu", [True, False])
    def test_output_bit_equal_to_quant_int8_conv(self, rng, B, H, W, Ci, Co, relu):
        """models/quant.py:159-168 on the same int8 activations, evaluated op
        by op as written: the int32 accumulator, the f32 epilogue
        acc·(sx·sw) + b, ReLU and the bf16 cast agree bit for bit."""
        xb, w8, sw, b, sx = _int8_case(rng, B, H, W, Ci, Co)
        x8 = quantize_act(torch.from_numpy(xb.copy()).to(torch.bfloat16), sx)

        def ref_fn(x8, w8, sw, b):
            acc = jax.lax.conv_general_dilated(
                x8, w8, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
                preferred_element_type=jnp.int32)
            y = acc.astype(jnp.float32) * (sx * sw) + b
            return (jax.nn.relu(y) if relu else y).astype(BF16)

        ref = ref_fn(jnp.asarray(x8.numpy()), jnp.asarray(w8), jnp.asarray(sw), jnp.asarray(b))
        deq = torch.tensor(sx, dtype=torch.float32) * torch.from_numpy(sw)
        acc = conv3x3_int8_acc_plain(x8, torch.from_numpy(w8))
        y = acc.float() * deq + torch.from_numpy(b)
        got = (torch.relu(y) if relu else y).to(torch.bfloat16)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))
        full = conv3x3_relu_int8(torch.from_numpy(xb.copy()).to(torch.bfloat16), torch.from_numpy(w8),
                                 sx, deq, torch.from_numpy(b), apply_relu=relu)
        assert torch.equal(full, got)

    def test_epilogue_against_xla_fma(self, rng):
        """Under jit, XLA's CPU backend contracts acc·deq + b into one FMA;
        the port keeps the two roundings of the source. After the bf16 cast
        the two differ by at most one bf16 ulp."""
        acc = rng.integers(-2 ** 24, 2 ** 24, (4096,)).astype(np.int32)
        deq = (rng.random(4096) * 1e-3).astype(np.float32)
        b = rng.standard_normal(4096).astype(np.float32)
        ref = jax.jit(lambda a, d, b: (a.astype(jnp.float32) * d + b).astype(BF16))(
            jnp.asarray(acc), jnp.asarray(deq), jnp.asarray(b))
        got = (torch.from_numpy(acc).float() * torch.from_numpy(deq)
               + torch.from_numpy(b)).to(torch.bfloat16)
        _bf16_close(got.float().numpy(), ref)

    @pytest.mark.parametrize("B,H,W,Ci,Co", INT8_SHAPES + [(1, 8, 8, 129, 70)])
    def test_packed_weights_give_the_same_implicit_gemm(self, rng, B, H, W, Ci, Co):
        """The card kernel's int8 layout: weights (9, Cout, Cin up to 32),
        activations with Cin zero-padded to 32, summed as nine shifted
        (B·H·W, Cin_pad) × (Cin_pad, Cout) products, tap = 3·ky + kx.
        Equal to the plain int32 accumulator; packed once per weight tensor,
        again only after an in-place change."""
        xb, w8, *_, sx = _int8_case(rng, B, H, W, Ci, Co)
        x8 = quantize_act(torch.from_numpy(xb.copy()).to(torch.bfloat16), sx)
        w = torch.from_numpy(w8)
        p = packed_weight(w)
        cs = -(-Ci // 32) * 32
        assert p.dtype == torch.int8 and tuple(p.shape) == (9, Co, cs)
        assert not p[:, :, Ci:].any()
        xp = torch.zeros((B, H + 2, W + 2, cs), dtype=torch.int64)
        xp[:, 1:-1, 1:-1, :Ci] = x8.long()
        acc = torch.zeros((B, H, W, Co), dtype=torch.int64)
        for tap in range(9):
            ky, kx = divmod(tap, 3)
            acc += xp[:, ky:ky + H, kx:kx + W] @ p[tap].long().T
        assert torch.equal(acc.int(), conv3x3_int8_acc_plain(x8, w))
        assert packed_weight(w) is p
        w.mul_(-1)
        assert torch.equal(packed_weight(w), -p)

    def test_wrapper_on_cpu_is_plain(self, rng):
        xb, w8, sw, b, sx = _int8_case(rng, 1, 8, 8, 6, 5)
        deq = torch.tensor(sx, dtype=torch.float32) * torch.from_numpy(sw)
        args = (torch.from_numpy(xb.copy()).to(torch.bfloat16), torch.from_numpy(w8), sx, deq,
                torch.from_numpy(b))
        n = conv3x3_relu_int8.launches
        assert torch.equal(conv3x3_relu_int8(*args), conv3x3_relu_int8_plain(*args))
        assert conv3x3_relu_int8.launches == n


class TestDDIMUpdate:
    def test_plain_matches_pallas_fused_ddim_update(self, rng):
        x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
        e = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
        a_cur, a_next = np.float32(0.7), np.float32(0.9)
        with pltpu.force_tpu_interpret_mode():
            x0, xn = j_fused_ddim_update(jnp.asarray(x), jnp.asarray(e), a_cur, a_next)
        # the Pallas kernel multiplies by an f32 reciprocal and forms its
        # coefficients in f32; the port divides, with f64-derived coefficients
        g0, gn = fused_ddim_update(_t(x), _t(e), *ddim_coefs(a_cur, a_next))
        np.testing.assert_allclose(g0.numpy(), np.asarray(x0), rtol=2e-6, atol=1e-6)
        np.testing.assert_allclose(gn.numpy(), np.asarray(xn), rtol=2e-6, atol=1e-6)

    @pytest.mark.parametrize("t_start,steps", [(200, 1), (200, 4), (999, 3)])
    def test_sampler_loop_bit_equal_to_scan_arithmetic(self, rng, t_start, steps):
        """The port's step loop against _ddim_linspace_scan's arithmetic
        (samplers.py:111-128) written out in unfused float32 numpy, with a
        denoiser that is the same arithmetic in both."""
        x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
        c = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
        from s1s2.sampling.grids import linspace_grid
        from s1s2.sampling.samplers import _coef

        js = JSchedule.cosine(1000)
        ts = linspace_grid(t_start, steps, js.T)
        a_cur, a_next = _coef(js, ts[:-1]), _coef(js, ts[1:])
        xs = [np.asarray(v, np.float32) for v in (
            np.sqrt(1.0 - a_cur), np.sqrt(a_cur + 1e-8), np.sqrt(a_next), np.sqrt(1.0 - a_next))]
        ref = x
        for i in range(steps):
            eps = np.float32(0.5) * ref + c
            x0 = (ref - xs[0][i] * eps) / xs[1][i]
            ref = xs[2][i] * x0 + xs[3][i] * eps
        got = _ddim_linspace_scan(lambda xt, t: 0.5 * xt + _t(c), _t(x),
                                  Schedule.cosine(1000), t_start, steps, (-1e9, 1e9))
        np.testing.assert_array_equal(got.numpy(), x0)

    @pytest.mark.parametrize("t_start,steps", [(200, 1), (200, 4), (999, 3)])
    def test_sampler_loop_matches_jax_scan(self, rng, t_start, steps):
        """Against the compiled JAX scan, whose body XLA's CPU backend
        contracts into FMAs: within 1e-5 relative to the output's scale."""
        x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
        c = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
        ref = np.asarray(j_scan(lambda xt, t: 0.5 * xt + jnp.asarray(c), jnp.asarray(x),
                                JSchedule.cosine(1000), t_start, steps, (-1e9, 1e9)))
        got = _ddim_linspace_scan(lambda xt, t: 0.5 * xt + _t(c), _t(x),
                                  Schedule.cosine(1000), t_start, steps, (-1e9, 1e9))
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())

    def test_sampler_clamps(self, rng):
        x = rng.standard_normal((1, 4, 4, 4)).astype(np.float32) * 5
        got = _ddim_linspace_scan(lambda xt, t: torch.zeros_like(xt), _t(x),
                                  Schedule.cosine(1000), 200, 1, (0.0, 1.0))
        assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0

    def test_coefficients_from_float64(self):
        ab = Schedule.cosine(1000).alpha_bar_np().astype(np.float64)
        s1m, sabg, sabn, s1mn = ddim_coefs(ab[200], ab[0])
        assert s1m == float(np.float32(np.sqrt(1.0 - ab[200])))
        assert sabg == float(np.float32(np.sqrt(ab[200] + 1e-8)))
        assert sabn == float(np.float32(np.sqrt(ab[0])))
        assert s1mn == float(np.float32(np.sqrt(1.0 - ab[0])))

    def test_wrapper_on_cpu_is_plain(self, rng):
        x, e = _t(rng.standard_normal((3, 5))), _t(rng.standard_normal((3, 5)))
        n = fused_ddim_update.launches
        got = fused_ddim_update(x, e, 0.6, 0.8, 0.9, 0.4)
        ref = ddim_update_plain(x, e, 0.6, 0.8, 0.9, 0.4)
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
        assert fused_ddim_update.launches == n


class TestPixelShuffle:
    @pytest.mark.parametrize("s", [2, 4])
    def test_space_to_depth_and_back_bit_equal(self, rng, s):
        x = rng.standard_normal((2, 16, 8, 3)).astype(np.float32)
        ref = jps.space_to_depth(jnp.asarray(x), s)
        got = tps.space_to_depth(_t(x), s)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(tps.depth_to_space(got, s).numpy(), x)
        np.testing.assert_array_equal(
            tps.depth_to_space(_t(np.asarray(ref)), s).numpy(),
            np.asarray(jps.depth_to_space(ref, s)))

    def test_block_major_order_is_not_pixel_unshuffle(self, rng):
        x = _t(rng.standard_normal((1, 4, 4, 3)))
        ours = tps.space_to_depth(x, 2)
        torch_order = torch.nn.functional.pixel_unshuffle(x.permute(0, 3, 1, 2), 2)
        assert not torch.equal(ours, torch_order.permute(0, 2, 3, 1))

    def test_conv_transpose_matches_flax_f32(self, rng):
        from flax import linen as nn

        Ci, Co = 6, 5
        x = rng.standard_normal((2, 8, 8, Ci)).astype(np.float32)
        k = rng.standard_normal((2, 2, Ci, Co)).astype(np.float32)
        b = rng.standard_normal(Co).astype(np.float32)
        ref = nn.ConvTranspose(Co, (2, 2), strides=(2, 2), padding="VALID",
                               dtype=jnp.float32).apply({"params": {"kernel": k, "bias": b}}, x)
        got = tps.ps_conv_transpose_2x2(_t(x), _t(k), _t(b))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)

    def test_conv_transpose_matches_jax_bf16(self, rng):
        Ci, Co = 16, 8
        x = jnp.asarray(rng.standard_normal((2, 4, 4, Ci)).astype(np.float32)).astype(BF16)
        k = jnp.asarray(rng.standard_normal((2, 2, Ci, Co)).astype(np.float32)).astype(BF16)
        b = jnp.asarray(rng.standard_normal(Co).astype(np.float32)).astype(BF16)
        ref = jps.ps_conv_transpose_2x2(x, k, b)
        got = tps.ps_conv_transpose_2x2(_t(x).to(torch.bfloat16), _t(k).to(torch.bfloat16),
                                        _t(b).to(torch.bfloat16))
        assert got.dtype == torch.bfloat16
        # each of product and bias add rounds once to bf16: within 2 ulps
        g, r = got.float().numpy(), np.asarray(ref, np.float32)
        assert np.all(np.abs(g - r) <= np.maximum(np.abs(g), np.abs(r)) * 2.0 ** -6 + 1e-6)


class TestBuild:
    """The build orchestration, with a stand-in for nvcc (a script that
    writes its outputs and prints ptxas lines)."""

    @pytest.fixture
    def fake_tree(self, tmp_path, monkeypatch):
        csrc = tmp_path / "csrc"
        csrc.mkdir()
        (csrc / "a.cu").write_text("// a\n")
        (csrc / "b.cu").write_text("// b\n")
        nvcc = tmp_path / "bin" / "nvcc"
        nvcc.parent.mkdir()
        nvcc.write_text(
            f"#!{sys.executable}\n"
            "import sys, time\n"
            "a = sys.argv[1:]\n"
            "out = a[a.index('-o') + 1]\n"
            "src = open(a[a.index('-c') + 1]).read() if '-c' in a else ''\n"
            "if 'SLEEP' in src:\n"
            "    time.sleep(30)\n"
            "if 'FAIL' in src:\n"
            "    sys.exit(2)\n"
            "open(out, 'w').write('built')\n"
            "if '-c' in a:\n"
            "    sys.stderr.write('ptxas info    : Compiling entry function k\\n'\n"
            "                     'ptxas info    : Used 40 registers, 30720 bytes smem\\n'\n"
            "                     'ptxas info    : other\\n')\n")
        nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
        monkeypatch.setattr(_build, "CSRC", csrc)
        monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "_build")
        monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
        return csrc

    def test_build_links_one_library_and_keeps_ptxas_lines(self, fake_tree):
        info = _build.build()
        assert info.compiled and info.path.name == "libs1s2k.so"
        assert info.path.read_text() == "built"
        assert len(info.ptxas) == 4 and all("ptxas info" in ln for ln in info.ptxas)
        leftovers = sorted(p.name for p in info.path.parent.iterdir())
        assert leftovers == ["libs1s2k.so", "ptxas.txt"]  # no objects, temps or locks
        again = _build.build()
        assert not again.compiled and again.path == info.path and again.ptxas == info.ptxas

    def test_source_change_gives_a_new_build_dir(self, fake_tree):
        first = _build.build().path.parent
        (fake_tree / "a.cu").write_text("// a, edited\n")
        assert _build.build().path.parent != first

    def test_failed_compile_raises_and_leaves_no_library(self, fake_tree):
        (fake_tree / "b.cu").write_text("FAIL\n")
        with pytest.raises(RuntimeError, match="nvcc failed"):
            _build.build()
        assert not list((_build.BUILD_ROOT).rglob("*.so"))

    def test_compile_time_limit(self, fake_tree, monkeypatch):
        (fake_tree / "a.cu").write_text("SLEEP\n")
        monkeypatch.setattr(_build, "BUILD_TIMEOUT_S", 1.0)
        with pytest.raises(RuntimeError, match="longer than"):
            _build.build()

    def test_missing_nvcc_raises(self, tmp_path, monkeypatch):
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        monkeypatch.setenv("PATH", str(tmp_path))
        if os.path.exists("/usr/local/cuda/bin/nvcc"):
            assert _build.find_nvcc() == "/usr/local/cuda/bin/nvcc"
        else:
            with pytest.raises(RuntimeError, match="nvcc not found"):
                _build.find_nvcc()

    def test_check_raises_on_cuda_error(self):
        _build.check(0, "ok")
        with pytest.raises(RuntimeError, match="CUDA error 9"):
            _build.check(9, "launch")
