"""The port's roofline tool (``s1s2_torch/tools/roofline.py``) against the
JAX package's: its operation count of one forward beside XLA's
``cost_analysis`` of the JAX ``UNetSmall`` (the count the JAX tool prints),
and the tool itself at a tiny size on the CPU.

The two counts differ by design, and the tolerances say how: the port
counts the products its kernels compute, 9 taps an output pixel of every
3×3 conv (the SAME padding's zero taps included, as the kernel multiplies
them), where XLA counts only the taps inside the image and adds the
elementwise work (bias, ReLU, pools). At base 96, 256² the port is 1.0%
above XLA; the port's count less the padding's taps (computed here from the
shapes) is within 0.2% of XLA's, the rest being XLA's elementwise count.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from s1s2.models import UNetSmall as JUNet
from s1s2_torch.tools import roofline

torch.set_num_threads(1)


def _xla_flops(base, size, batch):
    m = JUNet(out_ch=4, base_ch=base, compute_dtype=jnp.bfloat16)
    v = jax.jit(m.init)(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 8), jnp.float32),
                        jnp.zeros((1,), jnp.int32))
    x = jnp.zeros((batch, size, size, 8), jnp.float32)
    t = jnp.full((batch,), 500, jnp.int32)
    ca = jax.jit(lambda x, t: m.apply(v, x, t)).lower(x, t).compile().cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    return float(ca["flops"])


def _padding_taps_ops(base, size, batch):
    """Operations of the 3×3 convs' taps that fall on the SAME padding."""
    b = base
    convs = [(size, 9, b)]
    for level, ci, co in ((0, b, 2 * b), (1, 2 * b, 4 * b), (2, 4 * b, 8 * b),
                          (2, 8 * b, 4 * b), (1, 4 * b, 2 * b), (0, 2 * b, b)):
        H = size >> level
        convs += [(H, ci, co), (H, co, co)]
    return batch * sum(2.0 * (9 * H * H - (3 * H - 2) ** 2) * ci * co for H, ci, co in convs)


@pytest.mark.parametrize("base,size,batch", [(96, 256, 1), (8, 32, 2)])
def test_operation_count_against_cost_analysis(base, size, batch):
    port = roofline.forward_counts(base, 1, size, batch)["ops"]
    xla = _xla_flops(base, size, batch)
    valid = port - _padding_taps_ops(base, size, batch)
    # XLA counts the valid taps and the elementwise ops: between the port's
    # count less its padding taps and the port's count
    assert valid < xla < port, (valid, xla, port)
    if base == 96:
        assert abs(port / xla - 1) < 0.015, port / xla  # 1.0%: the padding taps
        assert abs(valid / xla - 1) < 0.002, valid / xla  # the elementwise ops


def test_the_count_by_layer_at_base96():
    c = roofline.forward_counts(96, 1, 256, 1)
    assert c["convs"] == 294553387008.0
    assert c["up"] == 3 * 2 * 32 * 32 * 768 * 4 * 384  # each level 2.416e9
    assert c["head"] == 2 * 256 * 256 * 96 * 4
    assert c["ops"] == c["convs"] + c["up"] + c["head"]
    two = roofline.forward_counts(96, 1, 256, 2)
    assert two["ops"] == 2 * c["ops"] and two["bytes"] < 2 * c["bytes"]  # weights read once


def test_stem_counts_the_body_at_its_resolution():
    """The 24x4 headline's forward: a 4x space-to-depth stem runs the body
    at 64² with an inc of 8·16 + 1 input channels and a 64-channel head."""
    c = roofline.forward_counts(24, 4, 256, 1)
    body = roofline.forward_counts(24, 1, 64, 1)
    inc = lambda ci: 2.0 * 9 * 64 * 64 * ci * 24  # noqa: E731
    assert c["convs"] == body["convs"] - inc(9) + inc(129)
    assert c["up"] == body["up"] and c["head"] == 16 * body["head"]


def test_tool_runs_on_the_cpu_with_no_rates():
    lines = []
    out = roofline.run(batch=2, base=8, steps=2, iters=1, size=32, device="cpu",
                       emit=lines.append)
    assert out["finite"] and out["mfu"] is None and out["scan_overhead"] is None
    assert out["ops_per_patch"] == roofline.forward_counts(8, 1, 32, 1)["ops"]
    assert lines[-1].startswith("{") and "operations" in lines[0]
