"""UNetSmall — the conditional denoiser, NHWC, HWIO weights.

Port of the JAX package's ``models/unet.py``: a 3-level encoder/decoder of
(3×3 conv → ReLU)×2 blocks with 2×2 max-pool down and 2×2 stride-2
transposed-conv up, skip concatenation ordered [up, skip], the raw integer
timestep as one extra input channel, a 1×1 head and an optional s×s
space-to-depth stem (``stem_s2d``) that runs the whole body at (H/s, W/s).

Compute runs in ``compute_dtype`` (bf16 on the card, where the 3×3 convs go
through the hand-written kernel; f32 is a parity mode for the CPU). The
parameters are f32, as in the JAX model. The JAX model's two up paths
share one param tree and compute the same function, so a tree from either
loads as it is: ``up_impl="ps"`` (the port's default; the JAX model's
default is ``"convt"``) is one matmul and a pixel shuffle
(``ops/pixel_shuffle.py``), ``"convt"`` PyTorch's ``F.conv_transpose2d``,
the counterpart of flax's ``nn.ConvTranspose`` (a library op in both
packages). The 3×3 convs run on the kernel in both. :func:`init_params`
gives a freshly initialised tree with flax's own bits.

``UNetSmall(autograd=True)`` is the training path: the 3×3 convs run
through ``ops/conv3x3.conv3x3_relu_train`` (``F.conv2d``, differentiable)
instead of the kernel, which has no backward, and the pools through
:func:`max_pool2_train`, whose backward routes a tie as JAX does;
``remat=True`` then recomputes each double-conv block in the backward pass
(``torch.utils.checkpoint``), as the JAX model's ``nn.remat`` does. The
parameters stay ``requires_grad=False``: a trainer differentiates its own
copy (``train/loop.py``, through ``torch.func.functional_call``).

``UNetSmall(mesh=...)`` is this rank's part of the model on a device mesh
(``parallel/mesh.py``). On the model axis each layer whose output channels
divide it holds its slice of them (the registered parameters have the
slice's shape) and gathers the full output (``parallel/comm.gather_channels``);
the other layers run whole on every rank. On the space axis (the training
path only) the input holds this rank's rows of H, each 3×3 conv reads one
halo row from each neighbour (``parallel/comm.halo_rows``), and the pools,
the space-to-depth stem, the 2×2 up-convs and the 1×1 head stay local, so
the local height must divide by 8·``stem_s2d``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from s1s2_torch.core import random
from s1s2_torch.ops.conv3x3 import K_MULT, conv3x3_relu, conv3x3_relu_train
from s1s2_torch.ops.pixel_shuffle import (depth_to_space, ps_conv_transpose_2x2,
                                          space_to_depth)
from s1s2_torch.parallel.comm import gather_channels, halo_rows
from s1s2_torch.parallel.mesh import tp_sharded

BLOCKS = ("down1", "down2", "down3", "conv3", "conv2", "conv1")
UPS = ("up3", "up2", "up1")
UP_IMPLS = ("ps", "convt")


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=torch.float32), requires_grad=False)


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2×2 stride-2 max-pool, NHWC."""
    B, H, W, C = x.shape
    return x.reshape(B, H // 2, 2, W // 2, 2, C).amax(dim=(2, 4))


def max_pool2_train(x: torch.Tensor) -> torch.Tensor:
    """2×2 stride-2 max-pool, NHWC, whose backward gives each window's
    gradient to its first largest element in row-major order, as JAX's
    gradient of ``nn.max_pool`` does (``amax`` would split it among tied
    elements, which bf16 makes common). The same values as
    :func:`max_pool2`."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def conv1x1(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """1×1 conv as one matmul in x's dtype, then the bias add in x's dtype."""
    Ci, Co = kernel.shape[2], kernel.shape[3]
    y = torch.matmul(x.reshape(-1, Ci), kernel.reshape(Ci, Co).to(x.dtype))
    return y.reshape(*x.shape[:-1], Co) + bias.to(x.dtype)


def input_map(x_and_cond: torch.Tensor, t_idx: torch.Tensor, s: int,
              dtype: torch.dtype, pad: bool = False) -> torch.Tensor:
    """(x_t ‖ cond) → s2d stem → ‖ raw t channel (cast to f32 first, then to
    the compute dtype) → contiguous NHWC in ``dtype``. With ``pad`` (the
    inference path's stem input) zero channels follow up to a multiple of 8
    (129 → 136 for the 4× stem, 33 → 40, 9 → 16), in the same pass: the
    conv kernel's TMA reads 16-byte pixel rows, and the ``inc`` weight's
    missing rows count as zeros (``ops/conv3x3.py``; the CPU's plain
    version reads the first Cin channels)."""
    xf = x_and_cond.float()
    if s > 1:
        xf = space_to_depth(xf, s)
    B, H, W, C = xf.shape
    parts = [xf, t_idx.float().reshape(B, 1, 1, 1).expand(B, H, W, 1)]
    extra = -(C + 1) % K_MULT["bf16"]
    if pad and extra:
        parts.append(xf.new_zeros((1, 1, 1, 1)).expand(B, H, W, extra))
    return torch.cat(parts, dim=-1).to(dtype).contiguous()


def cast_param(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``p`` in ``dtype``, made once per parameter (and again only after an
    in-place change) and kept on it, so that the conv kernel's weight
    layout, made once per weight tensor, is made once per parameter."""
    cached = getattr(p, "_s1s2_cast", None)
    if (cached is not None and cached[0] == p._version and cached[1].dtype == dtype
            and cached[1].device == p.device):
        return cached[1]
    c = p.detach().to(dtype).contiguous()
    p._s1s2_cast = (p._version, c)
    return c


def sharded_out(co: int, mesh) -> bool:
    """Whether a layer of ``co`` output channels keeps a slice of them on
    ``mesh``'s model axis (the rule of ``parallel/mesh.tp_sharded``)."""
    return mesh is not None and tp_sharded((co,), mesh.model)


def conv3x3(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
            autograd: bool, padded_input: bool = False, mesh=None,
            sharded: bool = False) -> torch.Tensor:
    if autograd:
        if mesh is not None and mesh.space > 1:
            y = conv3x3_relu_train(halo_rows(x, mesh), kernel, bias, pad_rows=False)
        else:
            y = conv3x3_relu_train(x, kernel, bias)
    else:
        # the bias rounds to the compute dtype first, as flax's nn.Conv does
        y = conv3x3_relu(x, cast_param(kernel, x.dtype), bias.to(x.dtype).float(),
                         padded_input=padded_input)
    return gather_channels(y, mesh) if sharded else y


def double_conv(x, k1, b1, k2, b2, autograd: bool, mesh=None,
                sharded=(False, False)) -> torch.Tensor:
    y = conv3x3(x, k1, b1, autograd, mesh=mesh, sharded=sharded[0])
    return conv3x3(y, k2, b2, autograd, mesh=mesh, sharded=sharded[1])


class Conv3x3(nn.Module):
    def __init__(self, ci: int, co: int, autograd: bool = False, mesh=None):
        super().__init__()
        self.sharded = sharded_out(co, mesh)
        co = co // mesh.model if self.sharded else co
        self.kernel = _param(3, 3, ci, co)
        self.bias = _param(co)
        self.autograd, self.mesh = autograd, mesh

    def forward(self, x: torch.Tensor, padded_input: bool = False) -> torch.Tensor:
        return conv3x3(x, self.kernel, self.bias, self.autograd, padded_input, self.mesh,
                       self.sharded)


class DoubleConv(nn.Module):
    def __init__(self, ci: int, co: int, autograd: bool = False, remat: bool = False,
                 mesh=None):
        super().__init__()
        self.conv1 = Conv3x3(ci, co, autograd, mesh)
        self.conv2 = Conv3x3(co, co, autograd, mesh)
        self.autograd, self.remat, self.mesh = autograd, remat, mesh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ps = (self.conv1.kernel, self.conv1.bias, self.conv2.kernel, self.conv2.bias)
        flags = (self.autograd, self.mesh, (self.conv1.sharded, self.conv2.sharded))
        if self.remat and torch.is_grad_enabled():
            # the parameters go in as arguments, so the recomputation reads the
            # tensors this forward read (functional_call restores the module's
            # own before the backward runs)
            return checkpoint(double_conv, x, *ps, *flags, use_reentrant=False,
                              preserve_rng_state=False)
        return double_conv(x, *ps, *flags)


def conv_transpose_2x2(x: torch.Tensor, kernel: torch.Tensor,
                       bias: torch.Tensor) -> torch.Tensor:
    """The 2×2 stride-2 transposed conv as ``F.conv_transpose2d``: x
    (B,H,W,Ci), kernel (2,2,Ci,Co) in flax ConvTranspose layout (taps
    spatially flipped), bias (Co,) → (B,2H,2W,Co) in x's dtype, the bias
    added after the product rounds, as flax's ``nn.ConvTranspose`` adds it."""
    w = torch.flip(kernel, dims=(0, 1)).permute(2, 3, 0, 1).to(x.dtype)  # (Ci, Co, kH, kW)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, stride=2)
    return y.permute(0, 2, 3, 1) + bias.to(x.dtype)


class UpPS(nn.Module):
    """The 2×2 stride-2 up-conv: ``impl`` "ps" (matmul and pixel shuffle) or
    "convt" (:func:`conv_transpose_2x2`), one param tree."""

    def __init__(self, ci: int, co: int, mesh=None, impl: str = "ps"):
        super().__init__()
        self.sharded, self.mesh, self.impl = sharded_out(co, mesh), mesh, impl
        co = co // mesh.model if self.sharded else co
        self.kernel = _param(2, 2, ci, co)
        self.bias = _param(co)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = ps_conv_transpose_2x2 if self.impl == "ps" else conv_transpose_2x2
        y = up(x, self.kernel, self.bias)
        return gather_channels(y, self.mesh) if self.sharded else y


class Conv1x1(nn.Module):
    def __init__(self, ci: int, co: int, mesh=None):
        super().__init__()
        self.sharded, self.mesh = sharded_out(co, mesh), mesh
        co = co // mesh.model if self.sharded else co
        self.kernel = _param(1, 1, ci, co)
        self.bias = _param(co)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv1x1(x, self.kernel, self.bias)
        return gather_channels(y, self.mesh) if self.sharded else y


class UNetSmall(nn.Module):
    """``forward(x_and_cond (B,H,W,C_xt+C_cond), t_idx (B,)) → (B,H,W,out_ch)``
    float32. ``in_ch`` counts the x_t and cond channels together.
    ``autograd`` selects the training path and ``remat`` its recomputed
    blocks (module docstring); both are off for inference. ``mesh`` makes
    it this rank's part of the model on a device mesh, and ``up_impl`` picks
    the up-convs' form (module docstring)."""

    def __init__(self, out_ch: int = 4, base_ch: int = 96, stem_s2d: int = 1,
                 in_ch: int = 8, compute_dtype: torch.dtype = torch.bfloat16,
                 autograd: bool = False, remat: bool = False, mesh=None,
                 up_impl: str = "ps"):
        super().__init__()
        if up_impl not in UP_IMPLS:
            raise ValueError(f"up_impl must be one of {UP_IMPLS}, got {up_impl!r}")
        if remat and not autograd:
            raise ValueError("remat recomputes the training path: it needs autograd=True")
        if mesh is not None and mesh.space > 1 and not autograd:
            raise ValueError("the space axis shards the training path (autograd=True) only")
        b, s = base_ch, stem_s2d
        self.out_ch, self.base_ch, self.stem_s2d, self.in_ch = out_ch, base_ch, stem_s2d, in_ch
        self.compute_dtype, self.autograd, self.mesh = compute_dtype, autograd, mesh
        blk = lambda ci, co: DoubleConv(ci, co, autograd, remat, mesh)  # noqa: E731
        self.inc = Conv3x3(in_ch * s * s + 1, b, autograd, mesh)
        self.down1 = blk(b, 2 * b)
        self.down2 = blk(2 * b, 4 * b)
        self.down3 = blk(4 * b, 8 * b)
        self.up3 = UpPS(8 * b, 4 * b, mesh, up_impl)
        self.conv3 = blk(8 * b, 4 * b)
        self.up2 = UpPS(4 * b, 2 * b, mesh, up_impl)
        self.conv2 = blk(4 * b, 2 * b)
        self.up1 = UpPS(2 * b, b, mesh, up_impl)
        self.conv1 = blk(2 * b, b)
        self.outc = Conv1x1(b, out_ch * s * s, mesh)

    def forward(self, x_and_cond: torch.Tensor, t_idx: torch.Tensor) -> torch.Tensor:
        s = self.stem_s2d
        if self.mesh is not None and self.mesh.space > 1 and x_and_cond.shape[1] % (8 * s):
            raise ValueError(
                f"input {tuple(x_and_cond.shape)}: this rank's {x_and_cond.shape[1]} rows "
                f"of H must divide by 8*stem_s2d = {8 * s} (three pools after the stem) "
                f"on a space axis of {self.mesh.space}")
        pool = max_pool2_train if self.autograd else max_pool2
        pad = not self.autograd  # the kernel's stem input; autograd's conv takes it as it is
        x = input_map(x_and_cond, t_idx, s, self.compute_dtype, pad=pad)
        e1 = self.inc(x, padded_input=pad)
        e2 = pool(self.down1(e1))
        e3 = pool(self.down2(e2))
        e4 = pool(self.down3(e3))
        d3 = self.conv3(torch.cat([self.up3(e4), e3], dim=-1))
        d2 = self.conv2(torch.cat([self.up2(d3), e2], dim=-1))
        d1 = self.conv1(torch.cat([self.up1(d2), e1], dim=-1))
        out = self.outc(d1)
        if s > 1:
            out = depth_to_space(out, s)
        return out.float()


def load_unet(state: Dict[str, torch.Tensor], out_ch: int = 4, base_ch: int = 96,
              stem_s2d: int = 1, in_ch: int = 8,
              compute_dtype: torch.dtype = torch.bfloat16,
              device="cuda", mesh=None, up_impl: str = "ps") -> UNetSmall:
    """A UNetSmall holding ``state`` (see ``weights.params_from_numpy``);
    on a ``mesh`` with a model axis, this rank's slices of it."""
    model = UNetSmall(out_ch, base_ch, stem_s2d, in_ch, compute_dtype, mesh=mesh,
                      up_impl=up_impl)
    if mesh is not None:
        state = {k: mesh.param_slice(v) for k, v in state.items()}
    model.load_state_dict(state, strict=True)
    return model.to(device)


# the standard deviation of N(0, 1) truncated to [-2, 2] (flax's variance_scaling)
_TRUNC_STD = 0.87962566103423978


def init_params(out_ch: int = 4, base_ch: int = 96, stem_s2d: int = 1, seed: int = 0,
                in_ch: int = 8) -> Dict[str, torch.Tensor]:
    """A freshly initialised flat state (f32 CPU tensors): the bits of the JAX
    model's ``UNetSmall(...).init(PRNGKey(seed), ...)["params"]``.

    flax draws each parameter from its own key, ``PRNGKey(seed)`` folded with
    the SHA-1 of the module path and the module's count of draws so far
    (``flax/core/scope.py``: ``LazyRng``, ``_fold_in_static``); the path is
    the state name without its leaf (``"down1.conv1.kernel"`` → ``("down1",
    "conv1")``), the kernel is the module's first draw and the bias its
    second. Kernels (HWIO) are LeCun-normal: a normal truncated to ±2,
    times √(1/fan_in)/0.8796… with fan_in = kH·kW·Ci, in float32; biases
    are zero."""
    root = random.PRNGKey(seed)
    state = {}
    for name, p in UNetSmall(out_ch, base_ch, stem_s2d, in_ch).state_dict().items():
        *path, leaf = name.split(".")
        shape = tuple(p.shape)
        if leaf == "kernel":
            key = random.fold_in_static(root, (*path, 1))
            std = np.sqrt(np.float32(1.0 / np.prod(shape[:-1]))) / np.float32(_TRUNC_STD)
            arr = random.truncated_normal(key, -2.0, 2.0, shape) * std
        else:
            arr = np.zeros(shape, np.float32)
        state[name] = torch.from_numpy(arr)
    return state

