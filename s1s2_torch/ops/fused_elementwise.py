"""Fused DDIM step update.

Port of the Pallas kernel ``fused_ddim_update`` of the JAX package's
``ops/fused_elementwise.py``. In one pass over f32 tensors:

    x0 = (x_t − s1m·ε) / sabg          s1m = √(1−ᾱ_cur), sabg = √(ᾱ_cur + 1e-8)
    xn = sabn·x0 + s1mn·ε              sabn = √ᾱ_next,   s1mn = √(1−ᾱ_next)

The four coefficients are f32 scalars computed on the host
(:func:`ddim_coefs`, as the sampler computes them). The CUDA kernel is
``csrc/fused_elementwise.cu``; it divides (the Pallas kernel multiplies by
the reciprocal, which differs by up to 1 ulp) and has no FMA contraction.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from s1s2_torch.ops import _build
from s1s2_torch.utils.profiling import spanned


def ddim_coefs(a_cur: float, a_next: float) -> Tuple[float, float, float, float]:
    """(s1m, sabg, sabn, s1mn) as f32 values, from ᾱ in float64."""
    a_cur, a_next = np.float64(a_cur), np.float64(a_next)
    return tuple(float(np.float32(v)) for v in (
        np.sqrt(1.0 - a_cur), np.sqrt(a_cur + 1e-8),
        np.sqrt(a_next), np.sqrt(1.0 - a_next)))


def ddim_update_plain(x: torch.Tensor, eps: torch.Tensor, s1m: float, sabg: float,
                      sabn: float, s1mn: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two lines of f32 arithmetic; the divisor is a tensor so that the
    division is a true one on every device."""
    x0 = (x - s1m * eps) / torch.tensor(sabg, dtype=torch.float32, device=x.device)
    return x0, sabn * x0 + s1mn * eps


@spanned("kernel.fused_ddim_update")
def fused_ddim_update(x: torch.Tensor, eps: torch.Tensor, s1m: float, sabg: float,
                      sabn: float, s1mn: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (x0, xn), f32 tensors of x's shape."""
    if x.device.type == "cpu":
        return ddim_update_plain(x, eps, s1m, sabg, sabn, s1mn)
    for name, t in (("x", x), ("eps", eps)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"{name}: expected a contiguous float32 tensor")
        if t.device != x.device or t.shape != x.shape:
            raise ValueError(f"{name}: expected {tuple(x.shape)} on {x.device}")
    k = _build.kernels()
    x0 = torch.empty_like(x)
    xn = torch.empty_like(x)
    rc = k.s1s2k_ddim_update(
        x.data_ptr(), eps.data_ptr(), x0.data_ptr(), xn.data_ptr(), x.numel(),
        s1m, sabg, sabn, s1mn, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "fused_ddim_update")
    fused_ddim_update.launches += 1
    return x0, xn


fused_ddim_update.launches = 0
