"""3×3 SAME conv + bias (+ ReLU), NHWC activations, HWIO weights.

Port of the Pallas kernels ``conv3x3_relu`` and ``conv3x3_relu_bs`` of the
JAX package's ``ops/conv3x3.py`` (nine shifted (H·W, Cin) × (Cin, Cout)
products, f32 accumulation, fused bias/ReLU), and of the int8 conv that
``models/quant.py`` runs in its double-conv blocks. Both modes are one
hand-written CUDA kernel for Hopper (``csrc/conv3x3.cu``: ``wgmma`` fed by
TMA, A from registers through ``ldmatrix``, an N tile chosen per launch
from Cout, :func:`conv_plan`):

* :func:`conv3x3_relu` — bf16 in, f32 accumulation, ``acc + b``, optional
  ReLU, bf16 out.
* :func:`conv3x3_relu_int8` — bf16 activations quantized on load,
  ``clip(round(x / sx), -127, 127)`` with one scale ``sx`` for the tensor
  or a (Cin,) tensor of scales, one per input channel; int8 × int8
  products summed exactly in int32; ``acc·deq[co] + b[co]``, optional
  ReLU, bf16 out. The caller computes ``deq``: ``f32(sx)·sw`` for one
  scale, ``sw`` alone when the per-channel scales were folded into the
  weights (``models/quant.py``).
* :func:`conv3x3_int8_q` — the int8 mode's int8-out variant, the fused
  requant of the reference probe's int8 conv chain
  (``tools/probe_pallas_int8.py:probe_conv``): int8 activations whose Cin is
  a multiple of 32, read as they are (no quantize pass), the same int32
  sums and ``acc·deq[co] + b[co]``, optional ReLU, then
  ``clip(rint(·), -127, 127)``, int8 out. With ``deq`` one scale and ``b``
  zero it is the probe's ``clip(round(max(f32(acc)·scale, 0)), -127, 127)``
  bit for bit.

The kernel reads its weights K-major, ``(9, Cout, Cin)`` with Cin padded
as the activations are (:func:`packed_weight`, made once per weight tensor
and kept on it). TMA reads the activations as a (C, W, H, B) tensor, whose
pixel rows must be 16-byte multiples: the int8 mode quantizes them in a
first kernel into an int8 copy with the channels zero-padded to a multiple
of 32 (scratch allocated here); the bf16 mode takes an input whose Cin is
a multiple of 8 as it is, and one whose Cin is not with its channels
zero-padded to the next multiple of 8, upstream (the stems' ``inc``: the
model's ``input_map`` writes it so, and the model says so with
``padded_input``) or here (a pass of its own). A padded input meets zero
weight rows, so the sums are those of the unpadded one; on the CPU the
plain version reads the first Cin channels.

Each wrapper runs its plain PyTorch version when the tensor lies on the CPU
and launches the kernel when it lies on a CUDA device; it never falls back
from one to the other. ``launches`` counts the wrapper calls that launched
the kernel (the int8 mode's also by scale mode, ``mode_launches``).

The kernels have no backward. Training runs :func:`conv3x3_relu_train`,
PyTorch's differentiable conv, as the JAX package trains through XLA's
``nn.Conv`` and never through its Pallas kernel.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from s1s2_torch.ops import _build
from s1s2_torch.utils.profiling import spanned

# the channel multiple of each mode's activations and weight rows: 16-byte
# pixel rows for TMA, 32 int8 channels (a k-step) for the quantized copy
K_MULT = {"bf16": 8, "int8": 32}
# the kernel's tile plan (csrc/conv3x3.cu:plan): a block's 16 x 16 output
# pixels with a haloed 18 x 18 tile of a chunk of 32, 64 or 128 bytes of
# each pixel's channels; N tiles; shared memory
CHUNK_BYTES = (32, 64, 128)
N_WIDTHS, N_MAX, MAX_STAGES = (16, 24, 32, 48, 64, 96, 128), 128, 8
SMEM_DYN = 231424


def _a_stride(kb: int) -> int:
    """Bytes of one haloed input-tile buffer of ``kb``-byte chunks, 1024-aligned."""
    return -(-18 * 18 * kb // 1024) * 1024


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1)


@contextlib.contextmanager
def _no_tf32():
    """cuDNN's f32 convs in f32: PyTorch lets them round their operands to
    TF32 by default (on an H100, 2.8e-4 relative on a 768-channel conv's
    output and 1.4e-2 on its gradients, PERF.md, PR 14). Sets the convs'
    own precision, which works whichever of PyTorch's two flag interfaces
    the caller used (reading the legacy ``allow_tf32`` refuses a mix)."""
    conv = torch.backends.cudnn.conv
    keep = conv.fp32_precision
    conv.fp32_precision = "ieee"
    try:
        yield
    finally:
        conv.fp32_precision = keep


def conv3x3_relu_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       apply_relu: bool = True) -> torch.Tensor:
    """Plain version: ``F.conv2d`` in f32 on the inputs' values (TF32 off),
    ``+ b``, optional ReLU, one rounding to ``x.dtype``."""
    with _no_tf32():
        y = F.conv2d(_nchw(x.float()), _oihw(w.float()), padding=1)
    y = y.permute(0, 2, 3, 1) + b.float()
    if apply_relu:
        y = torch.relu(y)
    return y.to(x.dtype).contiguous()


class _ConvF32(torch.autograd.Function):
    """``F.conv2d`` (3×3, NCHW/OIHW, ``padding`` (rows, columns)) whose
    forward and backward both run with TF32 off, whatever the caller's
    flags: autograd runs the backward after the forward's context has
    closed."""

    @staticmethod
    def forward(ctx, x, w, padding):
        ctx.save_for_backward(x, w)
        ctx.padding = padding
        with _no_tf32():
            return F.conv2d(x, w, padding=padding)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        with _no_tf32():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                gy, x, w, None, (1, 1), ctx.padding, (1, 1), False, (0, 0), 1,
                (ctx.needs_input_grad[0], ctx.needs_input_grad[1], False))
        return gx, gw, None


def conv3x3_relu_train(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       pad_rows: bool = True) -> torch.Tensor:
    """The training path's conv, differentiable: ``F.conv2d`` in x's dtype
    (cuDNN on the card; in f32 kept off TF32, forward and backward, as the
    JAX package's f32 conv is f32), then the bias add in x's dtype, as
    flax's ``nn.Conv`` adds it after the conv has rounded, then ReLU. ``w``
    and ``b`` are the f32 parameters, cast inside the graph so that their
    gradients come back in f32. NHWC in, NHWC out. ``pad_rows=False`` pads
    W only: x then carries its halo rows (``parallel/comm.halo_rows``) and
    the output has two rows fewer."""
    xn, wn = _nchw(x), _oihw(w.to(x.dtype))
    padding = (1, 1) if pad_rows else (0, 1)
    if x.dtype == torch.float32 and x.is_cuda:
        y = _ConvF32.apply(xn, wn, padding)
    else:
        y = F.conv2d(xn, wn, padding=padding)
    return torch.relu(y.permute(0, 2, 3, 1) + b.to(x.dtype))


def _scale(sx, device) -> torch.Tensor:
    """The activation scale as an f32 tensor on ``device``: a 0-d tensor of
    a float, or the (Cin,) tensor of per-channel scales."""
    if isinstance(sx, torch.Tensor):
        return sx.to(device=device, dtype=torch.float32)
    return torch.tensor(sx, dtype=torch.float32, device=device)


def quantize_act(x: torch.Tensor, sx) -> torch.Tensor:
    """int8 activations ``clip(round(x / sx), -127, 127)``: a true f32
    division (by a tensor, never a host scalar, which PyTorch's CUDA path
    would turn into a multiplication by the reciprocal) and round-half-even.
    ``sx`` is a float or a (Cin,) tensor broadcast over the last axis."""
    q = torch.round(x.float() / _scale(sx, x.device))
    return q.clamp(-127, 127).to(torch.int8)


def conv3x3_int8_acc_plain(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """Exact int32 accumulator of the int8 conv. The largest |acc| is
    9·Cin·127², 2.8e7 for the 24x4 student (Cin 192) and 1.1e8 < 2^31 for
    the base-96 UNet (Cin 768): above 2^24, so f32 would round; f64 is exact
    below 2^53."""
    acc = F.conv2d(_nchw(x8.double()), _oihw(w8.double()), padding=1)
    return acc.permute(0, 2, 3, 1).to(torch.int32)


def _dequant(acc: torch.Tensor, deq: torch.Tensor, b: torch.Tensor,
             apply_relu: bool) -> torch.Tensor:
    """The int8 epilogue's f32 value ``acc·deq + b`` (ReLU optional) in
    separate PyTorch ops, so no FMA."""
    y = acc.float() * deq.float() + b.float()
    return torch.relu(y) if apply_relu else y


def conv3x3_relu_int8_plain(x: torch.Tensor, w8: torch.Tensor, sx,
                            deq: torch.Tensor, b: torch.Tensor,
                            apply_relu: bool = True) -> torch.Tensor:
    """Plain version of the int8 mode."""
    acc = conv3x3_int8_acc_plain(quantize_act(x, sx), w8)
    return _dequant(acc, deq, b, apply_relu).to(torch.bfloat16).contiguous()


def requant_plain(acc: torch.Tensor, deq: torch.Tensor, b: torch.Tensor,
                  apply_relu: bool = True) -> torch.Tensor:
    """int32 sums → ``clip(rint(relu(f32(acc)·deq + b)), -127, 127)`` int8,
    rounding half to even."""
    y = _dequant(acc, deq, b, apply_relu)
    return torch.round(y).clamp(-127, 127).to(torch.int8).contiguous()


def conv3x3_int8_q_plain(x8: torch.Tensor, w8: torch.Tensor, deq: torch.Tensor,
                         b: torch.Tensor, apply_relu: bool = True) -> torch.Tensor:
    """Plain version of :func:`conv3x3_int8_q`: the exact int32 sums of
    :func:`conv3x3_int8_acc_plain`, then :func:`requant_plain`."""
    return requant_plain(conv3x3_int8_acc_plain(x8, w8), deq, b, apply_relu)


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if name == "x" and t.data_ptr() % 16:
        raise ValueError(f"{name}: must start on a 16-byte boundary (the kernel "
                         f"loads 16 bytes at a time)")


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def packed_weight(w: torch.Tensor) -> torch.Tensor:
    """The kernel's weight layout: HWIO (3,3,Cin,Cout) → K-major (9, Cout,
    Cin rounded up to the mode's channel multiple, ``K_MULT``: 8 for bf16 or
    any float, 32 for int8), zero-padded, so that TMA brings an N tile's
    rows of 128 bytes of input channels for one tap at a time. Made once per
    weight tensor (and again only if the tensor was changed in place) and
    kept on it."""
    cached = getattr(w, "_s1s2_packed", None)
    if cached is not None and cached[0] == w._version:
        return cached[1]
    _, _, Cin, Cout = w.shape
    k_mult = K_MULT["int8" if w.dtype == torch.int8 else "bf16"]
    p = torch.zeros((9, Cout, _round_up(Cin, k_mult)), dtype=w.dtype, device=w.device)
    p[:, :, :Cin] = w.reshape(9, Cin, Cout).transpose(1, 2)
    w._s1s2_packed = (w._version, p)
    return p


def conv_plan(mode: str, cs: int, cout: int) -> dict:
    """The kernel's launch plan for ``cs`` input channels as it reads them
    (bf16: a multiple of 8; int8: of 32) and ``cout`` output channels, by
    the rules the C entry applies (``csrc/conv3x3.cu:plan``, held to this
    one on the card through :func:`kernel_plan`): ``ntn`` N tiles of ``bn``
    channels (the narrowest width of ``N_WIDTHS`` that holds an even split
    of Cout into tiles of at most 128), ``nchunks`` chunks of ``kb`` bytes
    of each pixel (``chunk`` channels; 32 or 64 bytes where a pixel's
    channels fit, else 128), ``na`` input-tile buffers, ``nst`` weight
    stages filling the shared memory, and the global strides in bytes of the
    activation and weight tensor maps."""
    e = 2 if mode == "bf16" else 1
    ntn = -(-cout // N_MAX)
    bn = next(w for w in N_WIDTHS if w >= -(-cout // ntn))
    kb = next(k for k in CHUNK_BYTES if cs * e <= k or k == CHUNK_BYTES[-1])
    nchunks = -(-cs * e // kb)
    na = 2 if nchunks > 1 else 1
    nst = min(MAX_STAGES, (SMEM_DYN - 1024 - na * _a_stride(kb)) // (bn * kb))
    return dict(bn=bn, ntn=-(-cout // bn), kb=kb, nchunks=nchunks, chunk=kb // e, na=na,
                nst=nst, smem=1024 + na * _a_stride(kb) + nst * bn * kb,
                x_strides=(cs * e,), w_strides=(cs * e, cs * e * cout))


def kernel_plan(mode: str, cs: int, cout: int) -> dict:
    """The plan the built C entry computes (``s1s2k_conv3x3_plan``): the
    keys ``bn``, ``ntn``, ``kb``, ``na``, ``nst`` and ``smem`` of
    :func:`conv_plan`. Needs the built library, so a CUDA toolkit."""
    keys = ("bn", "ntn", "kb", "na", "nst", "smem")
    out = (ctypes.c_int * len(keys))()
    _build.check(_build.kernels().s1s2k_conv3x3_plan(int(mode == "int8"), cs, cout, out),
                 "conv3x3 plan")
    return dict(zip(keys, out))


def _conv_shapes(x: torch.Tensor, w: torch.Tensor, padded_input: bool = False):
    """(B, H, W, Cin, Cout); with ``padded_input`` x holds Cin rounded up to
    a multiple of 8 channels (a stem input padded upstream), else Cin."""
    ok = x.dim() == 4 and w.dim() == 4 and w.shape[:2] == (3, 3) and x.shape[3] == (
        _round_up(w.shape[2], K_MULT["bf16"]) if padded_input else w.shape[2])
    if not ok:
        raise ValueError(f"expected x (B,H,W,Cin{' rounded up to 8' if padded_input else ''}) "
                         f"and w (3,3,Cin,Cout), got {tuple(x.shape)} and {tuple(w.shape)}")
    B, H, W, _ = x.shape
    return B, H, W, w.shape[2], w.shape[3]


@spanned("kernel.conv3x3_relu")
def conv3x3_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 apply_relu: bool = True, padded_input: bool = False) -> torch.Tensor:
    """x (B,H,W,Cin), w (3,3,Cin,Cout), b (Cout,) f32 → (B,H,W,Cout) in
    x.dtype. With ``padded_input`` x holds Cin rounded up to a multiple of 8
    channels, the ones past Cin zero (a stem input that ``input_map`` wrote
    with ``pad=True``). On a CUDA device x and w must be bf16 (the kernel's
    mode); on the CPU any float dtype runs through the plain version."""
    B, H, W, Cin, Cout = _conv_shapes(x, w, padded_input)
    if x.device.type == "cpu":
        return conv3x3_relu_plain(x[..., :Cin] if x.shape[3] != Cin else x, w, b, apply_relu)
    _check(x, "x", torch.bfloat16, x.shape, x.device)
    _check(w, "w", torch.bfloat16, (3, 3, Cin, Cout), x.device)
    _check(b, "b", torch.float32, (Cout,), x.device)
    k = _build.kernels()
    cs = _round_up(Cin, K_MULT["bf16"])
    if x.shape[3] != cs:  # rows TMA cannot stride: zero channels up to cs
        x = F.pad(x, (0, cs - x.shape[3]))
    wp = packed_weight(w)
    y = torch.empty((B, H, W, Cout), dtype=torch.bfloat16, device=x.device)
    rc = k.s1s2k_conv3x3_bf16(
        x.data_ptr(), wp.data_ptr(), b.data_ptr(), y.data_ptr(),
        B, H, W, cs, Cout, int(apply_relu), x.device.index,
        _build.stream(x.device))
    _build.check(rc, "conv3x3_relu (bf16)")
    conv3x3_relu.launches += 1
    return y


conv3x3_relu.launches = 0


@spanned("kernel.conv3x3_relu_int8")
def conv3x3_relu_int8(x: torch.Tensor, w8: torch.Tensor, sx,
                      deq: torch.Tensor, b: torch.Tensor,
                      apply_relu: bool = True) -> torch.Tensor:
    """x (B,H,W,Cin) bf16, w8 (3,3,Cin,Cout) int8, sx the activation scale
    (a float, or a (Cin,) f32 tensor on x's device: one per input channel),
    deq (Cout,) f32, b (Cout,) f32 → (B,H,W,Cout) bf16."""
    B, H, W, Cin, Cout = _conv_shapes(x, w8)
    if x.device.type == "cpu":
        return conv3x3_relu_int8_plain(x, w8, sx, deq, b, apply_relu)
    _check(x, "x", torch.bfloat16, (B, H, W, Cin), x.device)
    _check(w8, "w8", torch.int8, (3, 3, Cin, Cout), x.device)
    _check(deq, "deq", torch.float32, (Cout,), x.device)
    _check(b, "b", torch.float32, (Cout,), x.device)
    per_channel = isinstance(sx, torch.Tensor)
    if per_channel:
        _check(sx, "sx", torch.float32, (Cin,), x.device)
    k = _build.kernels()
    wp = packed_weight(w8)
    x8 = torch.empty((B, H, W, _round_up(Cin, K_MULT["int8"])), dtype=torch.int8,
                     device=x.device)
    y = torch.empty((B, H, W, Cout), dtype=torch.bfloat16, device=x.device)
    rc = k.s1s2k_conv3x3_int8(
        x.data_ptr(), x8.data_ptr(), wp.data_ptr(), deq.data_ptr(), b.data_ptr(),
        y.data_ptr(), B, H, W, Cin, Cout, 0.0 if per_channel else float(sx),
        sx.data_ptr() if per_channel else None, int(apply_relu), x.device.index,
        _build.stream(x.device))
    _build.check(rc, "conv3x3_relu_int8")
    conv3x3_relu_int8.launches += 1
    conv3x3_relu_int8.mode_launches["per_channel" if per_channel else "per_tensor"] += 1
    return y


conv3x3_relu_int8.launches = 0
conv3x3_relu_int8.mode_launches = {"per_tensor": 0, "per_channel": 0}


@spanned("kernel.conv3x3_int8_q")
def conv3x3_int8_q(x8: torch.Tensor, w8: torch.Tensor, deq: torch.Tensor, b: torch.Tensor,
                   apply_relu: bool = True) -> torch.Tensor:
    """x8 (B,H,W,Cin) int8 with Cin a multiple of 32, w8 (3,3,Cin,Cout)
    int8, deq (Cout,) f32, b (Cout,) f32 → (B,H,W,Cout) int8
    ``clip(rint(relu(acc·deq + b)), -127, 127)`` (the int8 mode's int8-out
    variant; ``launches`` counts its own launches)."""
    B, H, W, Cin, Cout = _conv_shapes(x8, w8)
    if Cin % K_MULT["int8"]:
        raise ValueError(f"x8: Cin {Cin} is not a multiple of {K_MULT['int8']} (the kernel "
                         f"reads the int8 activations as they are)")
    if x8.device.type == "cpu":
        return conv3x3_int8_q_plain(x8, w8, deq, b, apply_relu)
    _check(x8, "x", torch.int8, (B, H, W, Cin), x8.device)
    _check(w8, "w8", torch.int8, (3, 3, Cin, Cout), x8.device)
    _check(deq, "deq", torch.float32, (Cout,), x8.device)
    _check(b, "b", torch.float32, (Cout,), x8.device)
    k = _build.kernels()
    wp = packed_weight(w8)
    y8 = torch.empty((B, H, W, Cout), dtype=torch.int8, device=x8.device)
    rc = k.s1s2k_conv3x3_int8_q(
        x8.data_ptr(), wp.data_ptr(), deq.data_ptr(), b.data_ptr(), y8.data_ptr(),
        B, H, W, Cin, Cout, int(apply_relu), x8.device.index, _build.stream(x8.device))
    _build.check(rc, "conv3x3_int8_q")
    conv3x3_int8_q.launches += 1
    return y8


conv3x3_int8_q.launches = 0
