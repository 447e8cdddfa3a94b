"""The UNet's space-to-depth stem on the training path
(``UNetSmall(stem_s2d=s, autograd=True)``, the width students' path in
distillation) against ``jax.value_and_grad`` of the JAX package's UNet, at
base 8, 32², f32, from flax's init (``models.unet.init_params``, held bit
for bit to flax's). The loss and each parameter's gradient hold to 1e-5
relative (f32 sums in another order through the network)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from s1s2.models import UNetSmall as JUNet
from s1s2_torch.models.unet import UNetSmall, init_params
from s1s2_torch.train import loop

H, BASE = 32, 8


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


@pytest.mark.parametrize("s2d", [1, 2, 4])
def test_s2d_stem_gradients_match_jax_grad(s2d):
    params = init_params(4, BASE, s2d, seed=5, in_ch=8)
    jmodel = JUNet(out_ch=4, base_ch=BASE, stem_s2d=s2d, compute_dtype=jnp.float32)
    jvars = jax.jit(jmodel.init)(jax.random.PRNGKey(5), jnp.zeros((1, H, H, 8)),
                                 jnp.zeros((1,), jnp.int32))
    names = tuple(params)
    # init_params is flax's init at the same seed, bit for bit
    assert np.array_equal(jflat(jvars["params"], names),
                          loop.ParamLayout.of(params).flatten(params).numpy())
    rng = np.random.default_rng(s2d)
    x = rng.normal(size=(2, H, H, 8)).astype(np.float32)
    t = np.array([17, 640], np.int32)
    wts = rng.normal(size=(2, H, H, 4)).astype(np.float32)

    def jloss(p):
        return jnp.mean(jmodel.apply({"params": p}, jnp.asarray(x), jnp.asarray(t)) ** 2
                        * jnp.asarray(wts))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jvars["params"])
    model = UNetSmall(4, BASE, s2d, 8, torch.float32, autograd=True)
    layout = loop.ParamLayout.of(params)
    flat = layout.flatten(params).requires_grad_(True)
    out = torch.func.functional_call(model, layout.unflatten(flat),
                                     (torch.from_numpy(x), torch.from_numpy(t)))
    loss = (out ** 2 * torch.from_numpy(wts)).mean()
    g, = torch.autograd.grad(loss, flat)
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    gt = layout.unflatten(g)
    jgf = flatten_dict(jg)
    for n in names:
        assert rel(gt[n].numpy(), np.asarray(jgf[tuple(n.split("."))])) <= 1e-5, n
