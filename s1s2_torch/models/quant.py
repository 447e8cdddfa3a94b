"""int8 inference path for UNetSmall — post-training quantization.

Port of the JAX package's ``models/quant.py``, per-tensor path (the main
path's default):

* weights of the 12 double-conv convs: symmetric per-output-channel int8,
  ``sw = max|w| / 127`` (floored at 1e-12);
* activations: one static per-tensor scale per conv input,
  ``sx = max(absmax, 1e-6) / 127``, from calibration batches run through
  the bf16 network;
* ``inc`` (which carries the raw-integer t channel), the 2×2 transposed
  convs and the 1×1 head stay bf16.

Calibration and inference share one forward skeleton (:func:`_forward`), so
the topology cannot drift between them. ``quant_up``, ``act_perchannel`` and
``bf16_blocks`` are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from s1s2_torch.core import random
from s1s2_torch.core.parametrize import q_sample
from s1s2_torch.models.unet import BLOCKS, UPS, conv1x1, input_map, max_pool2
from s1s2_torch.ops.conv3x3 import conv3x3_relu, conv3x3_relu_int8, packed_int8_weight
from s1s2_torch.ops.pixel_shuffle import depth_to_space, ps_conv_transpose_2x2


def conv_names() -> List[str]:
    return [f"{blk}.{c}" for blk in BLOCKS for c in ("conv1", "conv2")]


def _unsupported(quant_up, act_perchannel, bf16_blocks) -> None:
    if quant_up or act_perchannel or tuple(bf16_blocks):
        raise NotImplementedError(
            "quant_up, act_perchannel and bf16_blocks are not ported yet")


@dataclasses.dataclass
class QuantParams:
    """int8 weights and scales of the double-conv blocks, and the bf16
    kernels and f32 biases of everything, on one device.

    ``params``: flat f32 state (``"down1.conv1.kernel"``, …);
    ``w8``: name → (int8 HWIO kernel, per-Co f32 ``sw``);
    ``act_scale``: name → ``sx`` (a Python float, as in the JAX package).
    """

    params: Dict[str, torch.Tensor]
    w8: Dict[str, Tuple[torch.Tensor, torch.Tensor]]
    bias: Dict[str, torch.Tensor]
    act_scale: Dict[str, float]
    out_ch: int = 4
    base_ch: int = 96
    stem_s2d: int = 1

    def __post_init__(self):
        # bf16 kernels and f32 biases for the convs that run in bf16, and
        # deq = f32(sx)·sw in f32 for the int8 ones (quant.py:166)
        self.bf16 = {k[:-len(".kernel")]: v.to(torch.bfloat16).contiguous()
                     for k, v in self.params.items() if k.endswith(".kernel")}
        self.b32 = {k[:-len(".bias")]: v.to(torch.bfloat16).float().contiguous()
                    for k, v in self.params.items() if k.endswith(".bias")}
        self.deq = {}
        for name, (q, sw) in self.w8.items():
            sx = torch.tensor(self.act_scale[name], dtype=torch.float32, device=sw.device)
            self.deq[name] = (sx * sw).contiguous()
            if q.device.type == "cuda":
                packed_int8_weight(q)  # the card kernel's layout, made once here

    def to(self, device) -> "QuantParams":
        """A copy with every tensor on ``device`` (same scales)."""
        return QuantParams(
            {k: v.to(device) for k, v in self.params.items()},
            {k: (q.to(device), s.to(device)) for k, (q, s) in self.w8.items()},
            {k: v.to(device) for k, v in self.bias.items()},
            dict(self.act_scale), self.out_ch, self.base_ch, self.stem_s2d)


def quantize_weights(params: Dict[str, torch.Tensor], quant_up: bool = False,
                     act_scales=None, bf16_blocks: Tuple[str, ...] = ()):
    """Per-output-channel symmetric int8 for every double-conv kernel, in
    numpy exactly as the JAX package does it. → (w8, bias) on params' device."""
    _unsupported(quant_up, act_scales is not None, bf16_blocks)
    w8, bias = {}, {}
    for name in conv_names():
        k = params[f"{name}.kernel"]
        w = k.detach().cpu().numpy().astype(np.float32)  # (3,3,Ci,Co)
        sw = np.abs(w).reshape(-1, w.shape[-1]).max(axis=0) / np.float32(127.0)
        sw = np.maximum(sw, np.float32(1e-12)).astype(np.float32)
        q = np.clip(np.round(w / sw), -127, 127).astype(np.int8)
        w8[name] = (torch.from_numpy(q).to(k.device),
                    torch.from_numpy(sw).to(k.device))
        bias[name] = params[f"{name}.bias"].float().contiguous()
    return w8, bias


def _forward(qp: QuantParams, x_and_cond: torch.Tensor, t_idx: torch.Tensor, *,
             mode: str, records: Optional[Dict[str, torch.Tensor]] = None):
    """mode='calib': bf16 blocks, record each block/up input's absmax.
    mode='int8': int8 blocks with the static ``qp.act_scale``."""
    x = input_map(x_and_cond, t_idx, qp.stem_s2d, torch.bfloat16)

    def block_conv(x, name):
        if mode == "calib":
            records[name] = x.float().abs().amax()
            return conv3x3_relu(x, qp.bf16[name], qp.b32[name])
        w8, _ = qp.w8[name]
        return conv3x3_relu_int8(x, w8, qp.act_scale[name], qp.deq[name], qp.bias[name])

    def block(x, blk):
        return block_conv(block_conv(x, f"{blk}.conv1"), f"{blk}.conv2")

    def up_conv(x, name):
        if mode == "calib":
            records[name] = x.float().abs().amax()
        return ps_conv_transpose_2x2(x, qp.bf16[name], qp.b32[name])

    e1 = conv3x3_relu(x, qp.bf16["inc"], qp.b32["inc"])
    e2 = max_pool2(block(e1, "down1"))
    e3 = max_pool2(block(e2, "down2"))
    e4 = max_pool2(block(e3, "down3"))
    d3 = block(torch.cat([up_conv(e4, "up3"), e3], dim=-1), "conv3")
    d2 = block(torch.cat([up_conv(d3, "up2"), e2], dim=-1), "conv2")
    d1 = block(torch.cat([up_conv(d2, "up1"), e1], dim=-1), "conv1")
    out = conv1x1(d1, qp.bf16["outc"], qp.b32["outc"])
    if qp.stem_s2d > 1:
        out = depth_to_space(out, qp.stem_s2d)
    return out.float()


def calibrate(params, batches: Iterable, out_ch: int = 4, base_ch: int = 96,
              stem_s2d: int = 1, per_channel: bool = False) -> Dict[str, float]:
    """Per-tensor absmax of every double-conv (and up-conv) input over the
    calibration batches, as scales ``max(absmax, 1e-6) / 127``.

    batches: iterable of (x_and_cond (B,H,W,C), t_idx (B,)) on params' device.
    """
    _unsupported(False, per_channel, ())
    qp = QuantParams(params, {}, {}, {}, out_ch, base_ch, stem_s2d)
    mx: Dict[str, float] = {}
    with torch.no_grad():
        for x, t in batches:
            rec: Dict[str, torch.Tensor] = {}
            _forward(qp, x, t, mode="calib", records=rec)
            for k, v in rec.items():
                v = float(v)
                mx[k] = v if k not in mx else max(mx[k], v)
    return {k: max(v, 1e-6) / 127.0 for k, v in mx.items()}


def make_sampler_calib(gt: torch.Tensor, cond: torch.Tensor, alpha_bar: np.ndarray,
                       tvals, *, key=None, n: int = 8,
                       noises: Optional[List[torch.Tensor]] = None):
    """Sampler-representative calibration batches: ``x_t = q_sample(gt)`` at
    each timestep of ``tvals``, concatenated with cond.

    The forward noise for each tval is ``normal(sub, gt[:n].shape)`` after
    ``key, sub = split(key)``, the key a jax-layout (2,) uint32 array
    (default ``PRNGKey(5)``), drawn on the host with the reference's own
    threefry bits (``core/random.py``); or it is taken from ``noises`` (one
    (n,H,W,C) tensor per tval). The coefficients are f32 square roots of the
    f32 ``alpha_bar`` entries, as in the JAX package.
    """
    gt, cond = gt[:n], cond[:n]
    if key is None:
        key = random.PRNGKey(5)
    calib = []
    for i, tval in enumerate(tvals):
        if noises is None:
            key, sub = random.split(key)
            eps = torch.from_numpy(random.normal(sub, tuple(gt.shape))).to(gt.device)
        else:
            eps = noises[i][:n].to(gt.device)
        ab = np.float32(alpha_bar[tval])
        x_t = q_sample(gt, eps, float(np.sqrt(ab)), float(np.sqrt(np.float32(1.0) - ab)))
        t_vec = torch.full((gt.shape[0],), int(tval), dtype=torch.int32, device=gt.device)
        calib.append((torch.cat([x_t, cond.float()], dim=-1), t_vec))
    return calib


def quantize_unet(params: Dict[str, torch.Tensor], calib_batches, out_ch: int = 4,
                  base_ch: int = 96, quant_up: bool = False, stem_s2d: int = 1,
                  act_perchannel: bool = False,
                  bf16_blocks: Tuple[str, ...] = ()) -> QuantParams:
    """One-call post-training quantization of a trained UNetSmall state."""
    _unsupported(quant_up, act_perchannel, bf16_blocks)
    scales = calibrate(params, calib_batches, out_ch, base_ch, stem_s2d)
    w8, bias = quantize_weights(params)
    return QuantParams(params, w8, bias, scales, out_ch, base_ch, stem_s2d)


def quant_apply(qp: QuantParams, x_and_cond: torch.Tensor, t_idx: torch.Tensor):
    """int8 forward: (B,H,W,C) → (B,H,W,out_ch) f32."""
    with torch.no_grad():
        return _forward(qp, x_and_cond, t_idx, mode="int8")


def make_quant_denoise_fn(qp: QuantParams, cond: torch.Tensor):
    """Sampler-facing closure ``(x_t, t) → ε̂``, concatenating [x_t, cond]."""
    cond = cond.float()

    def fn(x_t, t):
        return quant_apply(qp, torch.cat([x_t.float(), cond], dim=-1), t)

    return fn
