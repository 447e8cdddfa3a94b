"""Space-to-depth, depth-to-space and the 2×2 stride-2 transposed conv.

Port of the JAX package's ``ops/pixel_shuffle.py``. The channel order is
block-major (di, dj, c), which is NOT ``F.pixel_unshuffle``'s (c, di, dj).

The transposed conv is one (B·H·W, Ci) × (Ci, 4·Co) matmul and a reshape:
every input pixel makes its own 2×2 output block. The kernel is stored in
flax ConvTranspose layout (kH, kW, Ci, Co), which holds the taps spatially
flipped, so block offset (di, dj) reads ``K[1-di, 1-dj]``.

The int8 form (:func:`ps_conv_transpose_2x2_int8`, the JAX package's
``models/quant.py`` up-conv under ``quant_up``) quantizes the activations,
runs the product on the int8 mode of the matmul kernel (``ops/matmul.py``)
against the weight matrix packed once (:func:`ps_int8_weight`), and then
dequantizes; every output pixel takes exactly one input pixel's Ci sums, so
its int32 accumulator is ``jax.lax.conv_transpose``'s.
"""

from __future__ import annotations

import torch

from s1s2_torch.ops.conv3x3 import quantize_act
from s1s2_torch.ops.matmul import (matmul_int8_packed, matmul_int8_packed_plain,
                                   pack_int8_b)


def space_to_depth(x: torch.Tensor, s: int) -> torch.Tensor:
    """(B,H,W,C) → (B,H/s,W/s,s·s·C), block-major (di,dj,c) channel order."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // s, s, W // s, s, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H // s, W // s, s * s * C)


def depth_to_space(x: torch.Tensor, s: int) -> torch.Tensor:
    """(B,H,W,s·s·C) → (B,s·H,s·W,C), inverse of :func:`space_to_depth`."""
    B, H, W, K = x.shape
    C = K // (s * s)
    x = x.reshape(B, H, W, s, s, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, s * H, s * W, C)


def ps_kernel_matrix(kernel: torch.Tensor) -> torch.Tensor:
    """(2,2,Ci,Co) flax ConvTranspose kernel → (Ci, 4·Co) matmul operand,
    columns ordered (di, dj, co)."""
    Ci, Co = kernel.shape[2], kernel.shape[3]
    k = torch.flip(kernel, dims=(0, 1))  # (di, dj, Ci, Co)
    return k.permute(2, 0, 1, 3).reshape(Ci, 4 * Co)


def ps_conv_transpose_2x2(x: torch.Tensor, kernel: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """x (B,H,W,Ci), kernel (2,2,Ci,Co), bias (Co,) → (B,2H,2W,Co), in
    x's dtype (the product rounds once to it, then the bias add rounds)."""
    B, H, W, Ci = x.shape
    Co = kernel.shape[-1]
    y = torch.matmul(x.reshape(B * H * W, Ci), ps_kernel_matrix(kernel).to(x.dtype))
    y = y.reshape(B, H, W, 2, 2, Co).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(B, 2 * H, 2 * W, Co) + bias.to(x.dtype)


def ps_int8_weight(w8: torch.Tensor) -> torch.Tensor:
    """(2,2,Ci,Co) int8 flax ConvTranspose kernel → the matmul kernel's
    packed operand of its (Ci, 4·Co) matrix (``ops/matmul.pack_int8_b``),
    made once per model."""
    return pack_int8_b(ps_kernel_matrix(w8))


def _int8_epilogue(acc: torch.Tensor, B: int, H: int, W: int, deq: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """(B·H·W, 4·Co) int32 → ``acc·deq + bias`` in f32 (two roundings, no
    ReLU), bf16, depth-to-space → (B,2H,2W,Co)."""
    Co = deq.shape[0]
    y = (acc.reshape(B, H, W, 2, 2, Co).float() * deq + bias).to(torch.bfloat16)
    return y.permute(0, 1, 3, 2, 4, 5).reshape(B, 2 * H, 2 * W, Co)


def ps_conv_transpose_2x2_int8(x: torch.Tensor, wp: torch.Tensor, sx, deq: torch.Tensor,
                               bias: torch.Tensor) -> torch.Tensor:
    """x (B,H,W,Ci) bf16, ``wp = ps_int8_weight(w8)``, sx (a float, or a
    (Ci,) f32 tensor; a 0-d tensor on x's device spares the card a host
    copy), deq (Co,) f32, bias (Co,) f32 → (B,2H,2W,Co) bf16:
    ``x8 = clip(round(x / sx), -127, 127)`` (a true division), the int32
    product on the card's int8 matmul kernel (its plain version for a CPU
    tensor), then ``acc·deq + bias``."""
    B, H, W, Ci = x.shape
    x8 = quantize_act(x, sx).reshape(B * H * W, Ci)
    acc = matmul_int8_packed(x8, wp, 4 * deq.shape[0])
    return _int8_epilogue(acc, B, H, W, deq, bias)


def ps_conv_transpose_2x2_int8_plain(x: torch.Tensor, wp: torch.Tensor, sx,
                                     deq: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`ps_conv_transpose_2x2_int8` on any device:
    the exact product of ``ops/matmul.matmul_int8_packed_plain``."""
    B, H, W, Ci = x.shape
    x8 = quantize_act(x, sx).reshape(B * H * W, Ci)
    return _int8_epilogue(matmul_int8_packed_plain(x8, wp, 4 * deq.shape[0]), B, H, W,
                          deq, bias)
