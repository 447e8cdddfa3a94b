"""The plain reference of the denoiser: UNetSmall in plain PyTorch, its
calibration and its post-training quantization.

Written from the architecture and the configuration's stated precision,
with nothing of the program:

* UNetSmall (NHWC, HWIO kernels, flax names): an optional s×s
  space-to-depth stem (block-major (di, dj, c) channels), the raw integer
  timestep as one more input channel, ``inc`` 3×3 conv, three
  (3×3 conv → ReLU)×2 blocks each followed by a 2×2 max-pool, three 2×2
  stride-2 transposed convs (flax ``ConvTranspose`` kernels, taps stored
  flipped) each concatenated [up, skip] into a double-conv block, a 1×1
  head and the inverse of the stem.
* bf16 storage: every activation is rounded to bfloat16 where the
  configuration stores it (the stem input, each conv's output after its
  bias and ReLU, an up-conv's or the head's product and then its bias sum),
  and each product is summed in float32 with TF32 off.
* Quantized blocks (``qmax`` 127 for int8; 7 gives the int4 control):
  static per-tensor activation scales ``max(absmax, 1e-6)/qmax`` from
  calibration batches run through the bf16 network, per-output-channel
  weight scales ``max|w|/qmax``, ``clip(round(x/s), ±qmax)`` with a true
  float32 division and round-half-even, the integer sums exact (float64),
  then ``acc·(sx·sw) + b`` in float32, ReLU, bf16.

Everything runs in blocks of rows, so the reference fits beside whatever
the caller keeps.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

BLOCKS = ("down1", "down2", "down3", "conv3", "conv2", "conv1")
UPS = ("up3", "up2", "up1")


@contextlib.contextmanager
def f32_math():
    """float32 sums in float32: TF32 off for matmuls and cuDNN's convs,
    restored after."""
    knobs = (torch.backends.cuda.matmul, torch.backends.cudnn.conv)
    keep = [k.fp32_precision for k in knobs]
    for k in knobs:
        k.fp32_precision = "ieee"
    try:
        yield
    finally:
        for k, v in zip(knobs, keep):
            k.fp32_precision = v


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def space_to_depth(x: torch.Tensor, s: int) -> torch.Tensor:
    B, H, W, C = x.shape
    x = x.reshape(B, H // s, s, W // s, s, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H // s, W // s, s * s * C)


def depth_to_space(x: torch.Tensor, s: int) -> torch.Tensor:
    B, H, W, K = x.shape
    x = x.reshape(B, H, W, s, s, K // (s * s)).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, s * H, s * W, K // (s * s))


def _conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3×3 SAME conv, NHWC × HWIO, in x's dtype."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1)


def pool(x: torch.Tensor) -> torch.Tensor:
    B, H, W, C = x.shape
    return x.reshape(B, H // 2, 2, W // 2, 2, C).amax(dim=(2, 4))


class Quant:
    """The quantized convs' weights and scales, worked out from the f32
    parameters and the calibrated absmax of each conv input."""

    def __init__(self, params: Dict[str, torch.Tensor], absmax: Dict[str, float],
                 qmax: int):
        self.qmax = float(qmax)
        self.sx, self.wq, self.deq = {}, {}, {}
        for blk in BLOCKS:
            for c in ("conv1", "conv2"):
                name = f"{blk}.{c}"
                w = params[f"{name}.kernel"].float()
                sw = w.abs().amax(dim=(0, 1, 2)) / torch.tensor(self.qmax, device=w.device)
                sw = torch.clamp(sw, min=1e-12)
                sx = torch.tensor(max(absmax[name], 1e-6) / self.qmax, dtype=torch.float32,
                                  device=w.device)
                self.wq[name] = torch.round(w / sw).clamp(-self.qmax, self.qmax).double()
                self.sx[name], self.deq[name] = sx, sx * sw


class UNet:
    """UNetSmall's forward. ``quant=None`` runs every conv in bf16 storage;
    with a :class:`Quant` the double-conv blocks run quantized, ``inc``, the
    up-convs and the head in bf16 storage."""

    def __init__(self, params: Dict[str, torch.Tensor], stem_s2d: int = 1,
                 quant: Optional[Quant] = None):
        self.p, self.s, self.quant = params, stem_s2d, quant

    def _conv_bf16(self, x, name):
        w = bf16(self.p[f"{name}.kernel"].float())
        return bf16(torch.relu(_conv(x, w) + bf16(self.p[f"{name}.bias"].float())))

    def _conv_q(self, x, name):
        q = self.quant
        xq = torch.round(x / q.sx[name]).clamp(-q.qmax, q.qmax).double()
        acc = _conv(xq, q.wq[name]).float()
        return bf16(torch.relu(acc * q.deq[name] + self.p[f"{name}.bias"].float()))

    def _block(self, x, blk, record):
        for c in ("conv1", "conv2"):
            name = f"{blk}.{c}"
            if record is not None:
                record[name] = max(record.get(name, 0.0), float(x.abs().amax()))
            x = self._conv_q(x, name) if self.quant is not None else self._conv_bf16(x, name)
        return x

    def _up(self, x, name, record):
        if record is not None:
            record[name] = max(record.get(name, 0.0), float(x.abs().amax()))
        k = bf16(self.p[f"{name}.kernel"].float())  # (2, 2, Ci, Co), taps flipped
        w = torch.flip(k, dims=(0, 1)).permute(2, 3, 0, 1)
        y = bf16(F.conv_transpose2d(x.permute(0, 3, 1, 2), w, stride=2).permute(0, 2, 3, 1))
        return bf16(y + bf16(self.p[f"{name}.bias"].float()))

    def __call__(self, x_and_cond: torch.Tensor, t: int,
                 record: Optional[Dict[str, float]] = None) -> torch.Tensor:
        """(B, H, W, C) f32, an integer timestep → (B, H, W, out) f32; with
        ``record`` (bf16 network only) each block conv's and up-conv's
        input absmax is folded into it."""
        with f32_math():
            x = x_and_cond.float()
            if self.s > 1:
                x = space_to_depth(x, self.s)
            B, H, W, _ = x.shape
            x = bf16(torch.cat([x, x.new_full((B, H, W, 1), float(t))], dim=-1))
            e1 = self._conv_bf16(x, "inc")
            e2 = pool(self._block(e1, "down1", record))
            e3 = pool(self._block(e2, "down2", record))
            e4 = pool(self._block(e3, "down3", record))
            d3 = self._block(torch.cat([self._up(e4, "up3", record), e3], -1), "conv3", record)
            d2 = self._block(torch.cat([self._up(d3, "up2", record), e2], -1), "conv2", record)
            d1 = self._block(torch.cat([self._up(d2, "up1", record), e1], -1), "conv1", record)
            k = bf16(self.p["outc.kernel"].float())
            out = bf16(torch.einsum("bhwc,cd->bhwd", d1, k.reshape(k.shape[2], k.shape[3])))
            out = bf16(out + bf16(self.p["outc.bias"].float()))
            return depth_to_space(out, self.s) if self.s > 1 else out


def calibrate(params: Dict[str, torch.Tensor], stem_s2d: int,
              batches: List[Tuple[torch.Tensor, int]], rows: int = 8) -> Dict[str, float]:
    """Absmax of every block-conv and up-conv input over the calibration
    batches (x_and_cond, t), through the bf16 network, ``rows`` at a time."""
    net, rec = UNet(params, stem_s2d), {}
    for x, t in batches:
        for i in range(0, x.shape[0], rows):
            net(x[i:i + rows], t, record=rec)
    return rec


def denoiser(params, stem_s2d: int, cond: torch.Tensor, quant: Optional[Quant] = None):
    """``(x_t, t) → ε̂`` of the reference network on [x_t, cond]."""
    net = UNet(params, stem_s2d, quant)
    return lambda x, t: net(torch.cat([x, cond], dim=-1), t)
