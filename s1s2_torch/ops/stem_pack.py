"""The inference stem's input in one pass: x_t and cond → space-to-depth ‖ t
‖ zero pad → bf16.

Replaces no TPU kernel: the JAX package builds the stem's input
(``models/unet.py:input_map``) from plain jnp ops, which XLA fuses. PyTorch
runs that composition (:func:`stem_pack_plain`) as separate kernels, each
reading and writing the whole tensor in f32, and at the 4× stem they made
the largest block of the main path's device time. The CUDA kernel
(``csrc/stem_pack.cu``) reads x_t and cond once and writes ``inc``'s padded
bf16 input once, so it is bounded by those bytes; every value rounds once,
f32 to bf16 to nearest even, so its output is bit-equal to the
composition's.

The output is laid out as ``models/unet.input_map(..., pad=True)`` lays it
out: (B, H/s, W/s, P) with P = s²(Cx+Cc)+1 rounded up to a multiple of 8,
the channels block-major (di, dj, c) with c over x_t's channels and then
cond's, then ``bf16(float(t))``, then zeros. ``cond`` may be ``None``, with
x_t the concatenated input.

The wrapper runs the plain version when x_t lies on the CPU and launches
the kernel when it lies on a CUDA device; it never falls back from one to
the other. ``stem_pack.launches`` counts the kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from s1s2_torch.ops import _build
from s1s2_torch.ops.conv3x3 import K_MULT
from s1s2_torch.ops.pixel_shuffle import space_to_depth
from s1s2_torch.utils.profiling import spanned

# t's dtypes the kernel reads, by the code its C entry takes
T_KINDS = {torch.int32: 0, torch.int64: 1, torch.float32: 2}


def stem_channels(c: int, s: int) -> int:
    """P: the s²·c data channels and t, rounded up to the conv kernel's
    multiple of 8 bf16 channels (a 16-byte pixel row)."""
    m = K_MULT["bf16"]
    return -(-(s * s * c + 1) // m) * m


def stem_pack_plain(x: torch.Tensor, cond: Optional[torch.Tensor], t_idx: torch.Tensor,
                    s: int, dtype: torch.dtype = torch.bfloat16,
                    pad: bool = True) -> torch.Tensor:
    """Plain version, PyTorch's composition: (x ‖ cond) in f32 → s2d stem →
    ‖ raw t channel (cast to f32 first, then to ``dtype``) → contiguous NHWC
    in ``dtype``; with ``pad`` zero channels follow up to
    :func:`stem_channels`."""
    xf = x.float() if cond is None else torch.cat([x.float(), cond.float()], dim=-1)
    if s > 1:
        xf = space_to_depth(xf, s)
    B, H, W, C = xf.shape
    parts = [xf, t_idx.float().reshape(B, 1, 1, 1).expand(B, H, W, 1)]
    extra = -(C + 1) % K_MULT["bf16"]
    if pad and extra:
        parts.append(xf.new_zeros((1, 1, 1, 1)).expand(B, H, W, extra))
    return torch.cat(parts, dim=-1).to(dtype).contiguous()


def _check_shapes(x, cond, t_idx, s):
    if x.dim() != 4 or s < 1 or x.shape[1] % s or x.shape[2] % s:
        raise ValueError(f"expected x (B, H, W, C) with H and W divisible by s={s}, got "
                         f"{tuple(x.shape)}")
    if cond is not None and (cond.dim() != 4 or cond.shape[:3] != x.shape[:3]):
        raise ValueError(f"cond {tuple(cond.shape)} does not match x {tuple(x.shape)} "
                         "in (B, H, W)")
    if t_idx.numel() != x.shape[0]:
        raise ValueError(f"t_idx holds {t_idx.numel()} values for a batch of {x.shape[0]}")


@spanned("kernel.stem_pack")
def stem_pack(x: torch.Tensor, cond: Optional[torch.Tensor], t_idx: torch.Tensor,
              s: int) -> torch.Tensor:
    """x (B,H,W,Cx) f32, cond (B,H,W,Cc) f32 or None, t_idx (B,) int32, int64
    or f32 → (B, H/s, W/s, :func:`stem_channels`\\ (Cx+Cc, s)) bf16."""
    _check_shapes(x, cond, t_idx, s)
    if x.device.type == "cpu":
        return stem_pack_plain(x, cond, t_idx, s)
    for name, v in (("x", x), ("cond", cond)):
        if v is not None and (v.dtype != torch.float32 or not v.is_contiguous()
                              or v.device != x.device):
            raise TypeError(f"{name}: expected a contiguous float32 tensor on {x.device}, "
                            f"got {v.dtype} on {v.device}")
    if t_idx.dtype not in T_KINDS or not t_idx.is_contiguous() or t_idx.device != x.device:
        raise TypeError(f"t_idx: expected a contiguous {' / '.join(map(str, T_KINDS))} "
                        f"tensor on {x.device}, got {t_idx.dtype} on {t_idx.device}")
    B, H, W, Cx = x.shape
    Cc = 0 if cond is None else cond.shape[-1]
    P = stem_channels(Cx + Cc, s)
    y = torch.empty((B, H // s, W // s, P), dtype=torch.bfloat16, device=x.device)
    rc = _build.kernels().s1s2k_stem_pack(
        x.data_ptr(), None if cond is None else cond.data_ptr(), t_idx.data_ptr(),
        T_KINDS[t_idx.dtype], y.data_ptr(), B, H, W, Cx, Cc, s, P, x.device.index,
        _build.stream(x.device))
    _build.check(rc, "stem_pack")
    stem_pack.launches += 1
    return y


stem_pack.launches = 0
