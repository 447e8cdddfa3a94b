"""s1s2_torch ``quant_up`` (int8 2x2 transposed convs) against the JAX
package's models/quant.py: the int8 up kernels and scales, the int32
accumulator of one up-conv, the int8 forward, and the msgpack artifact
written by either package and read by the other."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from s1s2.core import Schedule as JSchedule
from s1s2.core.parametrize import q_sample as j_q_sample
from s1s2.models import UNetSmall as JUNet
from s1s2.models import quant as jq
from s1s2_torch.models import quant as tq
from s1s2_torch.models.weights import params_from_numpy
from s1s2_torch.ops.matmul import matmul, matmul_int8_packed, pack_int8_b
from s1s2_torch.ops.pixel_shuffle import (ps_conv_transpose_2x2_int8,
                                          ps_conv_transpose_2x2_int8_plain, ps_int8_weight)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the w24 pure-generation student: up1 is K=48 -> N=4*24=96, below the
# matmul kernel's tiles; up2 K=96 -> N=192
CKPT = os.path.join(REPO, "examples", "checkpoints",
                    "distill_cfg_puregen_student24.bf16.msgpack")
CKPT_24X4 = os.path.join(REPO, "examples", "checkpoints", "distill_eps_student24x4.bf16.msgpack")
TVALS = (200, 100, 20)
UPS = ("up3", "up2", "up1")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port on one torch thread: the test run has a worker a core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def w24():
    with open(CKPT, "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    rng = np.random.default_rng(21)
    x = rng.standard_normal((2, 32, 32, 8)).astype(np.float32)
    t = np.array([999, 500], np.int32)
    scales_pc = jq.calibrate(tree, [(jnp.asarray(x), jnp.asarray(t))], base_ch=24,
                             per_channel=True)
    return dict(tree=tree, state=params_from_numpy(tree), x=x, t=t, scales_pc=scales_pc)


@pytest.mark.parametrize("per_channel", [False, True], ids=["per_tensor", "per_channel"])
def test_quantize_weights_with_the_up_kernels_bit_equal(w24, per_channel):
    """quant_up adds up3/up2/up1, (2,2,Ci,Co) int8 with a per-Co f32 sw,
    bit-equal to the JAX package's, per tensor and with per-channel scales
    folded in."""
    sc = w24["scales_pc"] if per_channel else None
    jw8, jb = jq.quantize_weights(w24["tree"], quant_up=True, act_scales=sc)
    tsc = {k.replace("/", "."): torch.from_numpy(np.asarray(v)) for k, v in sc.items()} \
        if per_channel else None
    w8, bias = tq.quantize_weights(w24["state"], quant_up=True, act_scales=tsc)
    assert sorted(k.replace(".", "/") for k in w8) == sorted(jw8)
    for name in UPS:
        q, sw = w8[name]
        assert q.dtype == torch.int8 and tuple(q.shape[:2]) == (2, 2)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jw8[name][0]))
        np.testing.assert_array_equal(sw.numpy(), np.asarray(jw8[name][1]))
        np.testing.assert_array_equal(bias[name].numpy(), np.asarray(jb[name]))


def _jax_acc(x8, w8):
    return np.asarray(jax.lax.conv_transpose(
        jnp.asarray(x8), jnp.asarray(w8), (2, 2), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), transpose_kernel=False,
        preferred_element_type=jnp.int32))


@pytest.mark.parametrize("Ci,Co", [(48, 24), (96, 48), (64, 128)])
def test_int32_accumulator_equals_conv_transpose(Ci, Co):
    """The up-conv's int32 sums, one (B·H·W, Ci) x (Ci, 4·Co) product on
    the packed operand and a depth-to-space, are jax.lax.conv_transpose's
    bit for bit, at the narrow students' K/N below the kernel's tiles (48/96,
    96/192) and at tile multiples; the extreme int8 values included."""
    rng = np.random.default_rng(Ci)
    x8 = rng.integers(-127, 128, (3, 5, 7, Ci)).astype(np.int8)
    w8 = rng.integers(-127, 128, (2, 2, Ci, Co)).astype(np.int8)
    x8[0, 0, 0], w8[..., 0] = 127, -127
    wp = ps_int8_weight(torch.from_numpy(w8))
    assert wp.shape == (-(-4 * Co // 128) * 128, -(-Ci // 64) * 64)
    acc = matmul_int8_packed(torch.from_numpy(x8).reshape(-1, Ci), wp, 4 * Co)
    assert acc.dtype == torch.int32 and acc.shape == (3 * 5 * 7, 4 * Co)
    got = acc.reshape(3, 5, 7, 2, 2, Co).permute(0, 1, 3, 2, 4, 5).reshape(3, 10, 14, Co)
    np.testing.assert_array_equal(got.numpy(), _jax_acc(x8, w8))


def test_int8_up_conv_output_equals_the_jax_expression():
    """x8 = clip(round(x / sx)), the int32 conv_transpose, acc·deq + bias
    in f32, bf16 (quant.py:181-192, eager, so two roundings) — bit-equal,
    per tensor and per channel; the plain version is the same function."""
    rng = np.random.default_rng(3)
    Ci, Co = 48, 24
    x = jnp.asarray(rng.standard_normal((2, 4, 6, Ci)).astype(np.float32)).astype(jnp.bfloat16)
    w8 = rng.integers(-127, 128, (2, 2, Ci, Co)).astype(np.int8)
    sw = (rng.random(Co).astype(np.float32) + 0.5) * np.float32(1e-3)
    b = rng.standard_normal(Co).astype(np.float32)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    wp = ps_int8_weight(torch.from_numpy(w8))
    for sx in (0.031, (rng.random(Ci).astype(np.float32) + 0.1) * np.float32(0.02)):
        x8 = jnp.clip(jnp.round(x.astype(jnp.float32) / sx), -127, 127).astype(jnp.int8)
        acc = jax.lax.conv_transpose(x8, jnp.asarray(w8), (2, 2), "VALID",
                                     dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                     transpose_kernel=False, preferred_element_type=jnp.int32)
        deq = jnp.asarray(sw) if np.ndim(sx) else sx * jnp.asarray(sw)
        ref = np.asarray((acc.astype(jnp.float32) * deq + jnp.asarray(b)).astype(jnp.float32)
                         .astype(jnp.bfloat16).astype(jnp.float32))
        tsx = torch.from_numpy(sx) if np.ndim(sx) else sx
        tdeq = torch.from_numpy(np.asarray(deq, np.float32))
        got = ps_conv_transpose_2x2_int8(xt, wp, tsx, tdeq, torch.from_numpy(b))
        plain = ps_conv_transpose_2x2_int8_plain(xt, wp, tsx, tdeq, torch.from_numpy(b))
        assert got.dtype == torch.bfloat16 and got.shape == (2, 8, 12, Co)
        np.testing.assert_array_equal(got.float().numpy(), ref)
        assert torch.equal(got, plain)


def test_packed_matmul_refuses_what_does_not_fit():
    wp = pack_int8_b(torch.zeros((48, 96), dtype=torch.int8))
    assert wp.shape == (128, 64)
    with pytest.raises(ValueError):
        matmul_int8_packed(torch.zeros((4, 80), dtype=torch.int8), wp, 96)
    with pytest.raises(ValueError):
        matmul_int8_packed(torch.zeros((4, 48), dtype=torch.int8), wp, 129)
    with pytest.raises(TypeError):
        matmul_int8_packed(torch.zeros((4, 48), dtype=torch.float32), wp, 96)
    with pytest.raises(TypeError):
        pack_int8_b(torch.zeros((48, 96)))


def test_packed_matmul_on_the_cpu_launches_no_kernel():
    n = (matmul.launches, dict(matmul.mode_launches))
    matmul_int8_packed(torch.ones((3, 48), dtype=torch.int8),
                       pack_int8_b(torch.ones((48, 96), dtype=torch.int8)), 96)
    assert (matmul.launches, matmul.mode_launches) == n


@pytest.fixture(scope="module")
def s24x4():
    """tests/test_torch_quant.py's case: the committed 24x4 student at 64²,
    calibrated on q_sample states at t = 200, 100, 20 (numpy noise, seed 11),
    its int8 forward run on 3 of those states."""
    with open(CKPT_24X4, "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    rng = np.random.default_rng(11)
    gt = rng.random((8, 64, 64, 4)).astype(np.float32)
    cond = rng.standard_normal((8, 64, 64, 4)).astype(np.float32)
    noises = [rng.standard_normal(gt.shape).astype(np.float32) for _ in TVALS]
    ab = JSchedule.cosine(1000).alpha_bar_np()
    calib = []
    for tval, eps in zip(TVALS, noises):
        x_t = j_q_sample(jnp.asarray(gt), jnp.asarray(eps), float(np.sqrt(ab[tval])),
                         float(np.sqrt(1.0 - ab[tval])))
        calib.append((jnp.concatenate([x_t, jnp.asarray(cond)], -1),
                      jnp.full((8,), tval, jnp.int32)))
    x = np.concatenate([noises[0][:3], cond[:3]], -1)
    return dict(tree=tree, state=params_from_numpy(tree), calib=calib, x=x,
                t=np.array(TVALS, np.int32))


@pytest.mark.parametrize("per_channel", [False, True], ids=["per_tensor", "per_channel"])
def test_quant_apply_with_quant_up_against_jax(s24x4, per_channel):
    """The 24x4 student's int8 forward with int8 up-convs (up1 is K=48 ->
    N=96) against quant_apply with the same scales, within the bounds
    tests/test_torch_quant.py puts on the int8 forward: mean |Δ| ≤ 0.6 × JAX's
    own mean |int8 − bf16|, max |Δ| ≤ 0.25 × max |ε|."""
    x, t, tree = s24x4["x"], s24x4["t"], s24x4["tree"]
    jqp = jq.quantize_unet(tree, s24x4["calib"], base_ch=24, stem_s2d=4, quant_up=True,
                           act_perchannel=per_channel)
    scales = {k.replace("/", "."): (torch.from_numpy(np.asarray(v)) if per_channel else v)
              for k, v in jqp.act_scale.items()}
    w8, bias = tq.quantize_weights(s24x4["state"], quant_up=True,
                                   act_scales=scales if per_channel else None)
    tqp = tq.QuantParams(s24x4["state"], w8, bias, scales, 4, 24, 4, per_channel)
    assert set(UPS) <= set(tqp.up8)
    ref = np.asarray(jq.quant_apply(jqp, jnp.asarray(x), jnp.asarray(t)))
    got = tq.quant_apply(tqp, torch.from_numpy(x), torch.from_numpy(t)).numpy()
    bf16 = np.asarray(JUNet(out_ch=4, base_ch=24, stem_s2d=4).apply(
        {"params": tree}, jnp.asarray(x), jnp.asarray(t)))
    d = np.abs(got - ref)
    assert np.isfinite(got).all() and got.shape == (3, 64, 64, 4)
    assert d.mean() <= 0.6 * np.abs(ref - bf16).mean(), (d.mean(), np.abs(ref - bf16).mean())
    assert d.max() <= 0.25 * np.abs(ref).max(), d.max()
    # quant_up changes the forward: the up-convs do run in int8
    plain = tq.QuantParams(s24x4["state"], {k: v for k, v in w8.items() if k not in UPS},
                           bias, scales, 4, 24, 4, per_channel)
    assert not np.array_equal(got, tq.quant_apply(plain, torch.from_numpy(x),
                                                  torch.from_numpy(t)).numpy())


@pytest.fixture(scope="module")
def base8():
    """A base-8 UNet at 32², flax's init, calibrated on its own input (B=2)."""
    params = JUNet(out_ch=4, base_ch=8).init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 8)),
                                             jnp.zeros((1,), jnp.int32))["params"]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, 32, 8)).astype(np.float32)
    t = np.array([999, 200], np.int32)
    return params, x, t


@pytest.mark.parametrize("per_channel", [False, True], ids=["per_tensor", "per_channel"])
def test_jax_written_quant_up_artifact_in_the_port(base8, tmp_path, per_channel):
    """A quant_up artifact written by the JAX package's save_quant, read by the
    port's load_quant: the forward equals JAX's bit for bit (before the
    repair the port ran the up-convs in bf16, max |Δ| 0.75)."""
    params, x, t = base8
    jqp = jq.quantize_unet(params, [(jnp.asarray(x), jnp.asarray(t))], base_ch=8,
                           quant_up=True, act_perchannel=per_channel)
    path = str(tmp_path / "jax.int8.msgpack")
    jq.save_quant(jqp, path)
    tqp = tq.load_quant(path)
    assert set(UPS) <= set(tqp.w8) and set(UPS) <= set(tqp.up8)
    ref = np.asarray(jq.quant_apply(jqp, jnp.asarray(x), jnp.asarray(t)))
    got = tq.quant_apply(tqp, torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("per_channel", [False, True], ids=["per_tensor", "per_channel"])
def test_port_written_quant_up_artifact_in_jax(base8, tmp_path, per_channel):
    """The port's own quant_up artifact, read by the JAX package's load_quant:
    the same int8 weights, scales and metadata, and JAX's forward on it
    equals the port's within the int8 forward's bounds."""
    params, x, t = base8
    state = params_from_numpy(params)
    calib = [(torch.from_numpy(x), torch.from_numpy(t))]
    tqp = tq.quantize_unet(state, calib, base_ch=8, quant_up=True, act_perchannel=per_channel)
    path = str(tmp_path / "port.int8.msgpack")
    tq.save_quant(tqp, path)
    jqp = jq.load_quant(path)
    assert sorted(jqp.w8) == sorted(k.replace(".", "/") for k in tqp.w8)
    for name in UPS:
        np.testing.assert_array_equal(np.asarray(jqp.w8[name][0]), tqp.w8[name][0].numpy())
        np.testing.assert_array_equal(np.asarray(jqp.act_scale[name]),
                                      np.asarray(tqp.act_scale[name], np.float32))
    assert jqp.act_perchannel == per_channel and jqp.base_ch == 8
    ref = np.asarray(jq.quant_apply(jqp, jnp.asarray(x), jnp.asarray(t)))
    got = tq.quant_apply(tqp, torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_bench_int8_with_quant_up_on_the_cpu(tmp_path):
    """tools/bench_int8 at a small size: the bf16, int8 and int8 + quant_up
    paths on a patch set, each with its MAE; the quant_up net holds its
    packed up-conv operands."""
    from s1s2_torch.data.synthetic import make_synthetic_patches
    from s1s2_torch.tools import bench_int8

    make_synthetic_patches(str(tmp_path / "p"), n=3, size=32, seed=0)
    r = bench_int8.run(batch=4, steps=2, iters=1, patches=str(tmp_path / "p"), quant_up=True,
                       size=32, base_ch=8, device="cpu", emit=lambda _: None)
    assert [row["path"] for row in r["rows"]] == ["bf16", "int8", "int8_quant_up"]
    assert all(row["patches_per_s"] is None for row in r["rows"])  # no device time here
    maes = [r[f"mae_{p}"] for p in ("bf16", "int8", "int8_quant_up")]
    assert all(np.isfinite(maes)) and max(maes) - min(maes) < 0.02
    assert set(UPS) <= set(r["qp"]["int8_quant_up"].up8) and not r["qp"]["int8"].up8
    assert r["out"]["int8_quant_up"].shape == (4, 32, 32, 4)
