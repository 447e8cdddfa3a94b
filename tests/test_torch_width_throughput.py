"""``s1s2_torch/tools/bench_width_throughput.py`` against the JAX tool's
chain on the same inputs, at base 8 and 8x2 (a 2× space-to-depth stem),
32²: the parameter count (``params_m``), and the int8 DDIM-1 the tool
times, through ``quantize_unet`` → ``make_quant_denoise_fn`` →
``ddim_anchored`` on the JAX tool's calibration (cond ``normal(PRNGKey(3))``,
gt ``uniform(PRNGKey(4))``, 8 rows, t ∈ (200, 100, 20), noise from
``PRNGKey(5)``) and timed inputs (``PRNGKey(13)``, ``(14)``), one noise
array for both. The weights are each package's own init from
``PRNGKey(0)``. Tolerance: the int8 path's of ``tests/test_torch_quant.py``
(mean |Δ| ≤ 0.6 × mean |int8 − bf16| of the JAX outputs, max |Δ| ≤ 0.25 ×
max |ref|): a one-ulp bf16 difference can move an activation across an
int8 step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s1s2.core import Schedule as JSchedule
from s1s2.models import UNetSmall as JUNet
from s1s2.models.quant import make_quant_denoise_fn, make_sampler_calib, quantize_unet
from s1s2.models.unet import count_params
from s1s2.sampling import ddim_anchored, make_denoise_fn
from s1s2_torch.tools import bench_width_throughput as bwt

torch.set_num_threads(1)
SIZE, B = 32, 2


def _jax_chain(spec, noise):
    base, s2d = bwt.parse_width(spec)
    model = JUNet(out_ch=4, base_ch=base, stem_s2d=s2d, compute_dtype=jnp.bfloat16)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0),
                                    jnp.zeros((1, SIZE, SIZE, 8), jnp.float32),
                                    jnp.zeros((1,), jnp.int32))
    schedule = JSchedule.cosine(1000)
    cond = jax.random.normal(jax.random.PRNGKey(3), (8, SIZE, SIZE, 4))
    gt = jax.random.uniform(jax.random.PRNGKey(4), (8, SIZE, SIZE, 4))
    qp = quantize_unet(variables["params"],
                       make_sampler_calib(gt, cond, schedule.alpha_bar_np(), (200, 100, 20)),
                       base_ch=base, stem_s2d=s2d)
    cond = jax.random.normal(jax.random.PRNGKey(13), (B, SIZE, SIZE, 4))
    gt = jax.random.uniform(jax.random.PRNGKey(14), (B, SIZE, SIZE, 4))
    key, n = jax.random.PRNGKey(9), jnp.asarray(noise)
    int8 = ddim_anchored(make_quant_denoise_fn(qp, cond), gt, key, schedule, 200, 1, noise=n)
    bf16 = ddim_anchored(make_denoise_fn(model.apply, variables, cond), gt, key, schedule,
                         200, 1, noise=n)
    return count_params(variables["params"]), np.asarray(int8), np.asarray(bf16)


@pytest.mark.parametrize("spec", ["8", "8x2"])
def test_params_and_int8_ddim1_against_jax(spec):
    noise = np.random.default_rng(5).standard_normal((B, SIZE, SIZE, 4)).astype(np.float32)
    n_par, ref, bf16 = _jax_chain(spec, noise)
    qp, n = bwt.quantized(spec, SIZE, "cpu")
    assert n == n_par and round(n / 1e6, 2) == round(n_par / 1e6, 2)
    cond, gt = bwt.inputs(B, SIZE, torch.device("cpu"))
    got = bwt.sampler(qp, cond, gt)(noise=torch.from_numpy(noise)).numpy()
    assert got.shape == ref.shape == (B, SIZE, SIZE, 4) and np.isfinite(got).all()
    d = np.abs(got - ref)
    assert d.mean() <= 0.6 * np.abs(ref - bf16).mean(), (d.mean(), np.abs(ref - bf16).mean())
    assert d.max() <= 0.25 * np.abs(ref).max(), d.max()


def test_parse_width():
    assert bwt.parse_width("96") == (96, 1) and bwt.parse_width("24x2") == (24, 2)


def test_tool_lines_on_the_cpu():
    lines = []
    rows = bwt.run(widths=("8", "8x2"), batches=(2,), iters=1, size=SIZE, device="cpu",
                   emit=lines.append)
    assert [(r["base_ch"], r["s2d"], r["batch"]) for r in rows] == [(8, 1, 2), (8, 2, 2)]
    keys = {"base_ch", "s2d", "batch", "params_m", "distill1_int8_patches_per_s"}
    assert all(keys <= set(r) and r["finite"] for r in rows)
    assert all(r["distill1_int8_patches_per_s"] is None for r in rows) and len(lines) == 2
