"""The port's up-conv forms (``UNetSmall(up_impl=...)``) against the JAX
package's: ``"convt"`` (``F.conv_transpose2d``, flax's ``nn.ConvTranspose``
in JAX) and ``"ps"`` (matmul and pixel shuffle) over one param tree, at
base 8, 32², f32 on the CPU, and ``tools/bench_variants.py`` (the sweep of
both forms) at a tiny size. The up-convs' biases are made non-zero so that
their add is tested too. Tolerance 1e-5 absolute on outputs of order 1:
f32 sums taken in other orders (oneDNN against XLA) over at most 9·192
terms."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s1s2.models import UNetSmall as JUNet
from s1s2.ops.pixel_shuffle import ps_conv_transpose_2x2 as jps
from s1s2_torch.models.unet import UNetSmall, conv_transpose_2x2, load_unet
from s1s2_torch.models.weights import params_from_numpy
from s1s2_torch.ops.pixel_shuffle import ps_conv_transpose_2x2
from s1s2_torch.tools import bench_variants

torch.set_num_threads(1)
B, H, C = 2, 32, 4


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(11)
    params = jax.jit(JUNet(out_ch=C, base_ch=8, up_impl="convt").init)(
        jax.random.PRNGKey(0), jnp.zeros((1, H, H, 2 * C)), jnp.zeros((1,), jnp.int32))["params"]
    tree = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), params)
    for up in ("up3", "up2", "up1"):
        tree[up]["bias"] = (0.1 * rng.standard_normal(tree[up]["bias"].shape)).astype(np.float32)
    x = np.concatenate([rng.standard_normal((B, H, H, C)), rng.random((B, H, H, C))],
                       -1).astype(np.float32)
    t = np.array([200, 20], np.int32)
    return dict(tree=tree, state=params_from_numpy(tree), x=x, t=t)


def _jax(case, up_impl):
    return np.asarray(JUNet(out_ch=C, base_ch=8, up_impl=up_impl, compute_dtype=jnp.float32)
                      .apply({"params": case["tree"]}, jnp.asarray(case["x"]),
                             jnp.asarray(case["t"])))


def _port(case, up_impl):
    model = load_unet(case["state"], C, 8, 1, compute_dtype=torch.float32, device="cpu",
                      up_impl=up_impl)
    return model(torch.from_numpy(case["x"]), torch.from_numpy(case["t"])).numpy()


@pytest.mark.parametrize("up_impl", ["convt", "ps"])
def test_forward_against_jax_convt(case, up_impl):
    ref = _jax(case, "convt")
    got = _port(case, up_impl)
    assert got.shape == (B, H, H, C) and np.abs(ref).mean() > 0.05
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_convt_against_the_ports_ps_and_jax_ps(case):
    got = _port(case, "convt")
    np.testing.assert_allclose(got, _port(case, "ps"), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, _jax(case, "ps"), atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_up_conv_layer_forms_agree(dtype):
    """One 2×2 stride-2 up-conv: F.conv_transpose2d against the JAX
    package's pixel-shuffle op and the port's; bf16: one product rounding
    and the bias add in bf16 in each, so within 2 bf16 ulps."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 6, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 16, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    tx, tk, tb = (torch.from_numpy(a) for a in (x, k, b))
    got = conv_transpose_2x2(tx.to(dtype), tk, tb).float().numpy()
    ps = ps_conv_transpose_2x2(tx.to(dtype), tk, tb).float().numpy()
    assert got.shape == (2, 10, 12, 8)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = np.asarray(jps(jnp.asarray(x).astype(jdt), jnp.asarray(k).astype(jdt),
                         jnp.asarray(b)).astype(jnp.float32))
    tol = 1e-5 if dtype == torch.float32 else 2 * 2.0 ** -8 * np.abs(ref)
    assert (np.abs(got - ref) <= tol).all() and (np.abs(got - ps) <= tol).all()


def test_default_is_ps_and_a_bad_form_raises():
    assert UNetSmall(4, 8).up1.impl == "ps"
    assert load_unet(UNetSmall(4, 8).state_dict(), 4, 8, device="cpu").up3.impl == "ps"
    with pytest.raises(ValueError, match="up_impl"):
        UNetSmall(4, 8, up_impl="nearest")


def test_bench_variants_runs_both_forms_on_the_cpu():
    lines = []
    rows = bench_variants.run(quick=True, steps=2, size=16, base=8, device="cpu",
                              emit=lines.append)
    assert [(r["B"], r["up"]) for r in rows] == [(32, "ps"), (32, "convt")]
    assert all(r["finite"] and r["patches_per_s"] is None for r in rows)
    assert len(lines) == 2 and all(ln.startswith('{"B": 32') for ln in lines)
