"""Space-to-depth, depth-to-space and the 2×2 stride-2 transposed conv.

Port of the JAX package's ``ops/pixel_shuffle.py``. The channel order is
block-major (di, dj, c), which is NOT ``F.pixel_unshuffle``'s (c, di, dj).

The transposed conv is one (B·H·W, Ci) × (Ci, 4·Co) matmul and a reshape:
every input pixel makes its own 2×2 output block. The kernel is stored in
flax ConvTranspose layout (kH, kW, Ci, Co), which holds the taps spatially
flipped, so block offset (di, dj) reads ``K[1-di, 1-dj]``.
"""

from __future__ import annotations

import torch


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
