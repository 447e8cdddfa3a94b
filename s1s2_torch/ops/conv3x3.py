"""3×3 SAME conv + bias (+ ReLU), NHWC activations, HWIO weights.

Port of the Pallas kernels ``conv3x3_relu`` and ``conv3x3_relu_bs`` of the
JAX package's ``ops/conv3x3.py`` (nine shifted (H·W, Cin) × (Cin, Cout)
products, f32 accumulation, fused bias/ReLU), and of the int8 conv that
``models/quant.py`` runs in its double-conv blocks. Both modes are one
hand-written CUDA kernel (``csrc/conv3x3.cu``):

* :func:`conv3x3_relu` — bf16 in, f32 accumulation, ``acc + b``, optional
  ReLU, bf16 out.
* :func:`conv3x3_relu_int8` — bf16 activations quantized on load,
  ``clip(round(x / sx), -127, 127)`` with one scale ``sx`` for the tensor
  or a (Cin,) tensor of scales, one per input channel; int8 × int8
  products summed exactly in int32; ``acc·deq[co] + b[co]``, optional
  ReLU, bf16 out. The caller computes ``deq``: ``f32(sx)·sw`` for one
  scale, ``sw`` alone when the per-channel scales were folded into the
  weights (``models/quant.py``).

On the card the int8 mode quantizes the activations in a first kernel into
an int8 copy with the channels zero-padded to a multiple of 32 (scratch
allocated here), and reads its weights as ``(9, Cout_pad, Cin_pad)``
(:func:`packed_int8_weight`), made once per weight tensor and kept on it.

Each wrapper runs its plain PyTorch version when the tensor lies on the CPU
and launches the kernel when it lies on a CUDA device; it never falls back
from one to the other. ``launches`` counts the wrapper calls that launched
the kernel (the int8 mode's also by scale mode, ``mode_launches``).

The kernels have no backward. Training runs :func:`conv3x3_relu_train`,
PyTorch's differentiable conv, as the JAX package trains through XLA's
``nn.Conv`` and never through its Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from s1s2_torch.ops import _build

# the kernel's tiles (csrc/conv3x3.cu): 64 output channels a block, 32 int8
# input channels a chunk
N_TILE, K_CHUNK_I8 = 64, 32


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1)


def conv3x3_relu_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       apply_relu: bool = True) -> torch.Tensor:
    """Plain version: ``F.conv2d`` in f32 on the inputs' values (TF32 off),
    ``+ b``, optional ReLU, one rounding to ``x.dtype``."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        y = F.conv2d(_nchw(x.float()), _oihw(w.float()), padding=1)
    y = y.permute(0, 2, 3, 1) + b.float()
    if apply_relu:
        y = torch.relu(y)
    return y.to(x.dtype).contiguous()


def conv3x3_relu_train(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The training path's conv, differentiable: ``F.conv2d`` in x's dtype
    (cuDNN on the card), then the bias add in x's dtype, as flax's
    ``nn.Conv`` adds it after the conv has rounded, then ReLU. ``w`` and
    ``b`` are the f32 parameters, cast inside the graph so that their
    gradients come back in f32. NHWC in, NHWC out."""
    y = F.conv2d(_nchw(x), _oihw(w.to(x.dtype)), padding=1).permute(0, 2, 3, 1)
    return torch.relu(y + b.to(x.dtype))


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


def conv3x3_relu_int8_plain(x: torch.Tensor, w8: torch.Tensor, sx,
                            deq: torch.Tensor, b: torch.Tensor,
                            apply_relu: bool = True) -> torch.Tensor:
    """Plain version of the int8 mode; separate PyTorch ops, so no FMA."""
    acc = conv3x3_int8_acc_plain(quantize_act(x, sx), w8)
    y = acc.float() * deq.float() + b.float()
    if apply_relu:
        y = torch.relu(y)
    return y.to(torch.bfloat16).contiguous()


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if name in ("x", "w") and t.data_ptr() % 16:
        raise ValueError(f"{name}: must start on a 16-byte boundary (the kernel "
                         f"loads 16 bytes at a time)")


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def packed_int8_weight(w8: torch.Tensor) -> torch.Tensor:
    """The int8 mode's weight layout: HWIO (3,3,Cin,Cout) int8 →
    (9, Cout rounded up to 64, Cin rounded up to 32), zero-padded, so the
    kernel reads 32 consecutive input channels of one output channel with
    one 16-byte load per half. Made once per weight tensor (and again only
    if the tensor was changed in place) and kept on it."""
    cached = getattr(w8, "_s1s2_packed", None)
    if cached is not None and cached[0] == w8._version:
        return cached[1]
    _, _, Cin, Cout = w8.shape
    p = torch.zeros((9, _round_up(Cout, N_TILE), _round_up(Cin, K_CHUNK_I8)),
                    dtype=torch.int8, device=w8.device)
    p[:, :Cout, :Cin] = w8.reshape(9, Cin, Cout).transpose(1, 2)
    w8._s1s2_packed = (w8._version, p)
    return p


def _conv_shapes(x: torch.Tensor, w: torch.Tensor):
    if x.dim() != 4 or w.dim() != 4 or w.shape[:2] != (3, 3) or w.shape[2] != x.shape[3]:
        raise ValueError(f"expected x (B,H,W,Cin) and w (3,3,Cin,Cout), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    B, H, W, Cin = x.shape
    return B, H, W, Cin, w.shape[3]


def conv3x3_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 apply_relu: bool = True) -> torch.Tensor:
    """x (B,H,W,Cin), w (3,3,Cin,Cout), b (Cout,) f32 → (B,H,W,Cout) in
    x.dtype. On a CUDA device x and w must be bf16 (the kernel's mode); on
    the CPU any float dtype runs through the plain version."""
    B, H, W, Cin, Cout = _conv_shapes(x, w)
    if x.device.type == "cpu":
        return conv3x3_relu_plain(x, w, b, apply_relu)
    _check(x, "x", torch.bfloat16, (B, H, W, Cin), x.device)
    _check(w, "w", torch.bfloat16, (3, 3, Cin, Cout), x.device)
    _check(b, "b", torch.float32, (Cout,), x.device)
    k = _build.kernels()
    y = torch.empty((B, H, W, Cout), dtype=torch.bfloat16, device=x.device)
    rc = k.s1s2k_conv3x3_bf16(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
        B, H, W, Cin, Cout, int(apply_relu), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "conv3x3_relu (bf16)")
    conv3x3_relu.launches += 1
    return y


conv3x3_relu.launches = 0


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
    wp = packed_int8_weight(w8)
    x8 = torch.empty((B, H, W, _round_up(Cin, K_CHUNK_I8)), dtype=torch.int8, device=x.device)
    y = torch.empty((B, H, W, Cout), dtype=torch.bfloat16, device=x.device)
    rc = k.s1s2k_conv3x3_int8(
        x.data_ptr(), x8.data_ptr(), wp.data_ptr(), deq.data_ptr(), b.data_ptr(),
        y.data_ptr(), B, H, W, Cin, Cout, 0.0 if per_channel else float(sx),
        sx.data_ptr() if per_channel else None, int(apply_relu), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "conv3x3_relu_int8")
    conv3x3_relu_int8.launches += 1
    conv3x3_relu_int8.mode_launches["per_channel" if per_channel else "per_tensor"] += 1
    return y


conv3x3_relu_int8.launches = 0
conv3x3_relu_int8.mode_launches = {"per_tensor": 0, "per_channel": 0}
