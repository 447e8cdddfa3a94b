"""int8 inference path for UNetSmall — post-training quantization.

Port of the JAX package's ``models/quant.py``:

* weights of the 12 double-conv convs (less the blocks named in
  ``bf16_blocks``, which stay bf16): symmetric per-output-channel int8,
  ``sw = max|w| / 127`` (floored at 1e-12);
* activations: static scales per conv input from calibration batches run
  through the bf16 network, ``sx = max(absmax, 1e-6) / 127``: one per
  tensor, or with ``act_perchannel`` one per input channel, folded into the
  weights before they are quantized (``w·sx_ci``), so the dequant factor is
  ``sw`` alone;
* ``inc`` (which carries the raw-integer t channel) and the 1×1 head stay
  bf16; the 2×2 transposed convs too, unless ``quant_up``, which quantizes
  their kernels per output channel in the same way and runs them as int8
  products on the matmul kernel's int8 mode
  (``ops/pixel_shuffle.ps_conv_transpose_2x2_int8``), dequantized with
  ``acc·deq + b`` and no ReLU.

Calibration batches come from the sampler's own states: ``q_sample(gt)`` at
a spread of timesteps (:func:`make_sampler_calib`, with zeroed-cond twins
for guidance), or a guided bf16 rollout (:func:`make_cfg_rollout_calib`).
:func:`save_quant` and :func:`load_quant` write and read the JAX package's
msgpack artifact. Calibration and inference share one forward skeleton
(:func:`_forward`), so the topology cannot drift between them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from s1s2_torch.core import random
from s1s2_torch.core.parametrize import Parameterization, q_sample
from s1s2_torch.models.unet import BLOCKS, UPS, conv1x1, input_map, max_pool2
from s1s2_torch.models.weights import params_from_numpy
from s1s2_torch.ops.conv3x3 import conv3x3_relu, conv3x3_relu_int8, packed_weight
from s1s2_torch.ops.pixel_shuffle import (depth_to_space, ps_conv_transpose_2x2,
                                          ps_conv_transpose_2x2_int8, ps_int8_weight)
from s1s2_torch.train.checkpoint import load_params, msgpack_serialize
from s1s2_torch.train.checkpoint import nest as _nest
from s1s2_torch.utils.profiling import span

Scale = Union[float, torch.Tensor]


def conv_names(bf16_blocks: Tuple[str, ...] = ()) -> List[str]:
    return [f"{blk}.{c}" for blk in BLOCKS if blk not in bf16_blocks
            for c in ("conv1", "conv2")]


@dataclasses.dataclass
class QuantParams:
    """int8 weights and scales of the double-conv blocks, and the bf16
    kernels and f32 biases of everything, on one device.

    ``params``: flat f32 state (``"down1.conv1.kernel"``, …);
    ``w8``: name → (int8 HWIO kernel, per-Co f32 ``sw``), for the convs that
    run in int8 (a double-conv absent from it runs in bf16; ``up3``/``up2``/
    ``up1`` are in it under ``quant_up``);
    ``act_scale``: name → ``sx``, a Python float (per tensor) or a (Ci,) f32
    tensor (``act_perchannel``).
    """

    params: Dict[str, torch.Tensor]
    w8: Dict[str, Tuple[torch.Tensor, torch.Tensor]]
    bias: Dict[str, torch.Tensor]
    act_scale: Dict[str, Scale]
    out_ch: int = 4
    base_ch: int = 96
    stem_s2d: int = 1
    act_perchannel: bool = False

    def __post_init__(self):
        # bf16 kernels and f32 biases for the convs that run in bf16; for the
        # int8 ones the scale on the device and deq (quant.py:166): f32(sx)·sw
        # in f32 per tensor, sw alone per channel (sx folded into w8). The
        # int8 up-convs get their packed matmul operand (on every device) and
        # sx as a tensor on the device, which spares their quantize pass a
        # host copy; the 3x3 convs' int8 weights get the conv kernel's layout
        # on a card
        self.up8: Dict[str, torch.Tensor] = {}
        self.bf16 = {k[:-len(".kernel")]: v.to(torch.bfloat16).contiguous()
                     for k, v in self.params.items() if k.endswith(".kernel")}
        self.b32 = {k[:-len(".bias")]: v.to(torch.bfloat16).float().contiguous()
                    for k, v in self.params.items() if k.endswith(".bias")}
        self.sx: Dict[str, Scale] = {}
        self.deq = {}
        for name, (q, sw) in self.w8.items():
            sx = self.act_scale[name]
            if self.act_perchannel:
                self.sx[name] = torch.as_tensor(sx, dtype=torch.float32).to(
                    sw.device).contiguous()
                self.deq[name] = sw.float().contiguous()
            else:
                self.sx[name] = float(sx)
                self.deq[name] = (torch.tensor(float(sx), dtype=torch.float32,
                                               device=sw.device) * sw).contiguous()
            if name in UPS:
                self.up8[name] = ps_int8_weight(q)
                if not self.act_perchannel:
                    self.sx[name] = torch.tensor(float(sx), dtype=torch.float32,
                                                 device=sw.device)
            elif q.device.type == "cuda":
                packed_weight(q)  # the card kernel's layout, made once here

    def to(self, device) -> "QuantParams":
        """A copy with every tensor on ``device`` (same scales)."""
        return QuantParams(
            {k: v.to(device) for k, v in self.params.items()},
            {k: (q.to(device), s.to(device)) for k, (q, s) in self.w8.items()},
            {k: v.to(device) for k, v in self.bias.items()},
            {k: v.to(device) if isinstance(v, torch.Tensor) else v
             for k, v in self.act_scale.items()},
            self.out_ch, self.base_ch, self.stem_s2d, self.act_perchannel)


def quantize_weights(params: Dict[str, torch.Tensor], quant_up: bool = False,
                     act_scales: Optional[Dict[str, Scale]] = None,
                     bf16_blocks: Tuple[str, ...] = ()):
    """Per-output-channel symmetric int8 for every double-conv kernel outside
    ``bf16_blocks`` (and with ``quant_up`` the three 2×2 transposed-conv
    kernels), in numpy exactly as the JAX package does it; with
    ``act_scales`` (per-input-channel scales) each kernel is first scaled by
    its input channels' ``sx`` in f32. → (w8, bias) on params' device."""
    w8, bias = {}, {}
    for name in conv_names(tuple(bf16_blocks)) + (list(UPS) if quant_up else []):
        k = params[f"{name}.kernel"]
        w = k.detach().cpu().numpy().astype(np.float32)  # (3,3,Ci,Co) / (2,2,Ci,Co)
        if act_scales is not None:
            sx = act_scales[name]
            sx = (sx.detach().cpu().numpy() if isinstance(sx, torch.Tensor)
                  else np.asarray(sx)).astype(np.float32)
            w = w * sx[None, None, :, None]
        sw = np.abs(w).reshape(-1, w.shape[-1]).max(axis=0) / np.float32(127.0)
        sw = np.maximum(sw, np.float32(1e-12)).astype(np.float32)
        q = np.clip(np.round(w / sw), -127, 127).astype(np.int8)
        w8[name] = (torch.from_numpy(q).to(k.device),
                    torch.from_numpy(sw).to(k.device))
        bias[name] = params[f"{name}.bias"].float().contiguous()
    return w8, bias


def _forward(qp: QuantParams, x_and_cond: torch.Tensor, t_idx: torch.Tensor, *,
             mode: str, records: Optional[Dict[str, torch.Tensor]] = None,
             cond: Optional[torch.Tensor] = None):
    """mode='calib': bf16 blocks, record each block/up input's absmax (per
    tensor, or per channel when ``qp.act_perchannel``).
    mode='int8': the convs of ``qp.w8`` in int8 with the static scales, the
    other double-convs and up-convs in bf16.
    With ``cond`` the first argument is x_t alone (``input_map``)."""
    x = input_map(x_and_cond, t_idx, qp.stem_s2d, torch.bfloat16, pad=True, cond=cond)

    def record(x, name):
        ax = x.float().abs()
        records[name] = ax.amax(dim=(0, 1, 2)) if qp.act_perchannel else ax.amax()

    def block_conv(x, name):
        if mode == "calib":
            record(x, name)
        if mode == "calib" or name not in qp.w8:
            return conv3x3_relu(x, qp.bf16[name], qp.b32[name])
        w8, _ = qp.w8[name]
        return conv3x3_relu_int8(x, w8, qp.sx[name], qp.deq[name], qp.bias[name])

    def block(x, blk):
        return block_conv(block_conv(x, f"{blk}.conv1"), f"{blk}.conv2")

    def up_conv(x, name):
        if mode == "calib":
            record(x, name)
        if mode == "calib" or name not in qp.w8:
            return ps_conv_transpose_2x2(x, qp.bf16[name], qp.b32[name])
        return ps_conv_transpose_2x2_int8(x, qp.up8[name], qp.sx[name], qp.deq[name],
                                          qp.bias[name])

    e1 = conv3x3_relu(x, qp.bf16["inc"], qp.b32["inc"], padded_input=True)
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
              stem_s2d: int = 1, per_channel: bool = False) -> Dict[str, Scale]:
    """Absmax of every double-conv (and up-conv) input over the calibration
    batches, as scales ``max(absmax, 1e-6) / 127``: Python floats, or with
    ``per_channel`` (Ci,) f32 CPU tensors computed in f32 as the JAX package
    computes them.

    batches: iterable of (x_and_cond (B,H,W,C), t_idx (B,)) on params' device.
    """
    qp = QuantParams(params, {}, {}, {}, out_ch, base_ch, stem_s2d,
                     act_perchannel=per_channel)
    mx: Dict[str, Union[float, np.ndarray]] = {}
    with torch.no_grad():
        for x, t in batches:
            rec: Dict[str, torch.Tensor] = {}
            _forward(qp, x, t, mode="calib", records=rec)
            for k, v in rec.items():
                v = v.cpu().numpy().astype(np.float32) if per_channel else float(v)
                if k in mx:
                    v = np.maximum(mx[k], v) if per_channel else max(mx[k], v)
                mx[k] = v
    if per_channel:
        return {k: torch.from_numpy(np.maximum(v, np.float32(1e-6)) / np.float32(127.0))
                for k, v in mx.items()}
    return {k: max(v, 1e-6) / 127.0 for k, v in mx.items()}


def make_sampler_calib(gt: torch.Tensor, cond: torch.Tensor, alpha_bar: np.ndarray,
                       tvals, *, key=None, n: int = 8,
                       noises: Optional[List[torch.Tensor]] = None,
                       null_cond: bool = False):
    """Sampler-representative calibration batches: ``x_t = q_sample(gt)`` at
    each timestep of ``tvals``, concatenated with cond, and with
    ``null_cond`` a zeroed-cond twin after each (guidance's unconditional
    pass).

    The forward noise for each tval is ``normal(sub, gt[:n].shape)`` after
    ``key, sub = split(key)``, the key a jax-layout (2,) uint32 array
    (default ``PRNGKey(5)``), drawn on the host with the reference's own
    threefry bits (``core/random.py``); or it is taken from ``noises`` (one
    (n,H,W,C) tensor per tval). The coefficients are f32 square roots of the
    f32 ``alpha_bar`` entries, as in the JAX package.
    """
    gt, cond = gt[:n], cond[:n].float()
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
        calib.append((torch.cat([x_t, cond], dim=-1), t_vec))
        if null_cond:
            calib.append((torch.cat([x_t, torch.zeros_like(cond)], dim=-1), t_vec))
    return calib


def make_cfg_rollout_calib(model, cond: torch.Tensor, schedule, grid,
                           guidance_scale: float, *, param, key=None, n: int = 8,
                           eta: float = 0.0, out_ch: int = 4, eps_linspace=None):
    """Guided-rollout calibration batches: the (x_t, t) states a bf16 CFG
    generation visits, each with cond and with a zeroed-cond twin.

    ``model`` is the bf16 net ``(x_and_cond, t) → pred``. The start noise is
    ``normal(key, (n, H, W, out_ch)) · scale`` with no split (default key
    ``PRNGKey(5)``), drawn on the host with the reference's bits; scale is 1
    for ε and f32 √(1−ᾱ_K) for v, K the grid's top. With
    ``eps_linspace=(t_start, steps)`` the ε family walks the linspace scan
    (what the ε sweep samples with); otherwise, and always for v, the walk
    is ``ddim_grid_sample`` on ``grid`` with ``eta`` and its η draws from
    ``PRNGKey(0)``.
    """
    from s1s2_torch.sampling.samplers import (_ddim_linspace_scan, ddim_grid_sample,
                                              make_cfg_denoise_fn)

    cond = cond[:n].float()
    if key is None:
        key = random.PRNGKey(5)
    param = Parameterization(param)
    ab = schedule.alpha_bar_np()
    K = int(np.asarray(grid)[-1])
    scale = 1.0 if param is Parameterization.EPS else float(
        np.sqrt(np.float32(1.0) - ab[min(max(K, 1), schedule.T - 1)]))
    noise = random.normal(key, tuple(cond.shape[:3]) + (out_ch,)) * np.float32(scale)
    noise = torch.from_numpy(noise).to(cond.device)
    fn = make_cfg_denoise_fn(model, cond, float(guidance_scale))
    if param is Parameterization.EPS and eps_linspace is not None:
        t_start, steps = eps_linspace
        _, (ts, traj) = _ddim_linspace_scan(fn, noise, schedule, int(t_start), int(steps),
                                            (0.0, 1.0), return_traj=True)
    else:
        _, (ts, traj) = ddim_grid_sample(fn, noise, schedule, grid, param, eta=eta,
                                         return_traj=True, key=random.PRNGKey(0))
    calib = []
    zero = torch.zeros_like(cond)
    for i in range(len(ts)):
        t_vec = torch.full((cond.shape[0],), int(ts[i]), dtype=torch.int32,
                           device=cond.device)
        calib.append((torch.cat([traj[i], cond], dim=-1), t_vec))
        calib.append((torch.cat([traj[i], zero], dim=-1), t_vec))
    return calib


def quantize_unet(params: Dict[str, torch.Tensor], calib_batches, out_ch: int = 4,
                  base_ch: int = 96, quant_up: bool = False, stem_s2d: int = 1,
                  act_perchannel: bool = False,
                  bf16_blocks: Tuple[str, ...] = ()) -> QuantParams:
    """One-call post-training quantization of a trained UNetSmall state:
    calibrate (per tensor or per channel; the up-convs' inputs are recorded
    too), then quantize the weights, with the per-channel scales folded in;
    ``quant_up`` also runs the 2×2 transposed convs in int8."""
    scales = calibrate(params, calib_batches, out_ch, base_ch, stem_s2d,
                       per_channel=act_perchannel)
    w8, bias = quantize_weights(params, quant_up=quant_up,
                                act_scales=scales if act_perchannel else None,
                                bf16_blocks=tuple(bf16_blocks))
    return QuantParams(params, w8, bias, scales, out_ch, base_ch, stem_s2d,
                       act_perchannel=act_perchannel)


def quant_apply(qp: QuantParams, x_and_cond: torch.Tensor, t_idx: torch.Tensor,
                cond: Optional[torch.Tensor] = None):
    """int8 forward: (B,H,W,C) → (B,H,W,out_ch) f32; with ``cond`` the first
    argument is x_t alone, and the stem reads the two apart."""
    with torch.no_grad():
        return _forward(qp, x_and_cond, t_idx, mode="int8", cond=cond)


def make_quant_denoise_fn(qp: QuantParams, cond: torch.Tensor):
    """Sampler-facing closure ``(x_t, t) → ε̂`` on [x_t, cond], which the
    stem reads apart (no concatenated copy)."""
    cond = cond.float().contiguous()

    def fn(x_t, t):
        with span("model.forward"):
            return quant_apply(qp, x_t, t, cond=cond)

    return fn


def make_quant_cfg_denoise_fn(qp: QuantParams, cond: torch.Tensor, guidance_scale: float,
                              null_cond: Optional[torch.Tensor] = None):
    """Classifier-free guidance through the int8 net: ``sampling.
    make_cfg_denoise_fn``'s stacked form (cond and null-cond, zeros by
    default, in one forward of 2B rows; ``pu + g·(pc − pu)``)."""
    from s1s2_torch.sampling.samplers import make_cfg_denoise_fn

    return make_cfg_denoise_fn(lambda x, t: quant_apply(qp, x, t), cond, guidance_scale,
                               null_cond)


def _jax_name(name: str) -> str:
    return name.replace(".", "/")


def save_quant(qp: QuantParams, path: str) -> None:
    """Write the JAX package's int8 artifact: one msgpack blob of the param
    tree, the int8 weights and scales, the biases, the activation scales
    (f32 arrays: 0-d per tensor, (Ci,) per channel) and int32 metadata,
    under the JAX package's names (``"down1/conv1"``)."""
    blob = {
        "params": _nest({k: v.float() for k, v in qp.params.items()}),
        "w8": {_jax_name(k): {"q": q, "s": s.float()} for k, (q, s) in qp.w8.items()},
        "bias": {_jax_name(k): v.float() for k, v in qp.bias.items()},
        "act_scale": {_jax_name(k): (v.float() if isinstance(v, torch.Tensor)
                                     else np.asarray(v, np.float32))
                      for k, v in qp.act_scale.items()},
        "meta": {"out_ch": np.int32(qp.out_ch), "base_ch": np.int32(qp.base_ch),
                 "stem_s2d": np.int32(qp.stem_s2d),
                 "act_perchannel": np.int32(qp.act_perchannel)},
    }
    with open(path, "wb") as f:
        f.write(msgpack_serialize(blob))


def load_quant(path: str, device="cpu") -> QuantParams:
    """Read an int8 artifact written by :func:`save_quant` or by the JAX
    package's ``save_quant`` onto ``device``; a 0-d activation scale becomes
    a Python float, as in the JAX package."""
    blob = load_params(path)
    meta = blob["meta"]

    def port_name(k: str) -> str:
        return k.replace("/", ".")

    return QuantParams(
        params={k: v.to(device) for k, v in params_from_numpy(blob["params"]).items()},
        w8={port_name(k): (v["q"].to(device), v["s"].float().to(device))
            for k, v in blob["w8"].items()},
        bias={port_name(k): v.float().to(device) for k, v in blob["bias"].items()},
        act_scale={port_name(k): (float(v) if v.dim() == 0 else v.float())
                   for k, v in blob["act_scale"].items()},
        out_ch=int(meta["out_ch"]),
        base_ch=int(meta["base_ch"]),
        stem_s2d=int(meta.get("stem_s2d", 1)),
        act_perchannel=bool(int(meta.get("act_perchannel", 0))),
    )
