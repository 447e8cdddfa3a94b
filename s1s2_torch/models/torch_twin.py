"""The reference's PyTorch UNet, as a plain ``nn.Module``, for parity checks.

Port of the JAX package's ``models/torch_twin.py``. :func:`build_torch_unet`
rebuilds the reference's module with its ``nn.Sequential`` layout, so a
reference ``.pth`` loads into it with ``strict=True`` (``inc.0.weight``,
``down1.0.0.weight``, ``up3.weight``, ...). :func:`validate_pth_parity` runs
it in f32 (``F.conv2d``, TF32 off) beside the port's own ``UNetSmall``,
loaded through ``models/convert.py``, on the same seeded inputs: a check of
the converter and of the port's inference path against an implementation
that shares no code with it.

The port's net runs in its compute dtype: f32 on the CPU, where the pass
rule is the JAX package's ``max_abs < 1e-3``; bf16 on the card, on the conv
kernel (which takes bf16 only). A bf16 forward is as far from f32 as bf16
rounding puts it (``rel``, mean |Δ| over mean |ref|: 0.016–0.017 on the ε
crossval net's seeded inputs), so a bf16 run is judged in two parts, neither
of which takes its reference from the run being judged:

- the converter: the port's f32 forward of the same converted state on the
  CPU's plain path, against the twin under the f32 rule (``f32_max_abs <
  1e-3``);
- the kernel (on the card only): ``rel`` within twice the ``rel`` of the
  same bf16 net on the CPU's plain path (``cpu_bf16_rel``), the bound the
  card's bf16 training steps are held to. On the CPU the bf16 run is that
  plain path, so only the converter's part applies.

The report names the rule it applied.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

F32_MAX_ABS = 1e-3  # the JAX package's f32 rule
BF16_SLACK = 2.0  # bf16: rel within this many times the CPU plain path's bf16 rel


def build_torch_unet(in_ch: int, out_ch: int, base_ch: int) -> nn.Module:
    """A torch module whose state-dict keys and shapes are the reference's;
    ``forward(x (B, in_ch, H, W), t (B,))``, the timestep as one more input
    channel."""

    def block(cin, cout):
        return nn.Sequential(
            nn.Conv2d(cin, cout, 3, padding=1), nn.ReLU(),
            nn.Conv2d(cout, cout, 3, padding=1), nn.ReLU(),
        )

    class TorchTwin(nn.Module):
        def __init__(self):
            super().__init__()
            b = base_ch
            self.inc = nn.Sequential(nn.Conv2d(in_ch + 1, b, 3, padding=1), nn.ReLU())
            self.down1 = nn.Sequential(block(b, b * 2), nn.MaxPool2d(2))
            self.down2 = nn.Sequential(block(b * 2, b * 4), nn.MaxPool2d(2))
            self.down3 = nn.Sequential(block(b * 4, b * 8), nn.MaxPool2d(2))
            self.up3 = nn.ConvTranspose2d(b * 8, b * 4, 2, stride=2)
            self.conv3 = block(b * 8, b * 4)
            self.up2 = nn.ConvTranspose2d(b * 4, b * 2, 2, stride=2)
            self.conv2 = block(b * 4, b * 2)
            self.up1 = nn.ConvTranspose2d(b * 2, b, 2, stride=2)
            self.conv1 = block(b * 2, b)
            self.outc = nn.Conv2d(b, out_ch, 1)

        def forward(self, x, t):
            B, _, H, W = x.shape
            tm = t.view(B, 1, 1, 1).float().expand(B, 1, H, W)
            h = torch.cat([x, tm], dim=1)
            e1 = self.inc(h)
            e2 = self.down1(e1)
            e3 = self.down2(e2)
            e4 = self.down3(e3)
            d3 = self.conv3(torch.cat([self.up3(e4), e3], dim=1))
            d2 = self.conv2(torch.cat([self.up2(d3), e2], dim=1))
            d1 = self.conv1(torch.cat([self.up1(d2), e1], dim=1))
            return self.outc(d1)

    return TorchTwin()


@contextlib.contextmanager
def _no_tf32():
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def default_dtype(device) -> str:
    """The port's compute dtype on ``device``: bf16 on the card (the conv
    kernel's), f32 on the CPU."""
    return "bfloat16" if torch.device(device).type == "cuda" else "float32"


def passes(report: Dict) -> bool:
    """The report's pass rule: f32 ``max_abs < 1e-3``; bf16 ``f32_max_abs <
    1e-3`` and, where the report has ``cpu_bf16_rel`` (the card), ``rel ≤ 2 ×
    cpu_bf16_rel``."""
    if report["compute_dtype"] == "float32":
        return report["max_abs"] < F32_MAX_ABS
    return report["f32_max_abs"] < F32_MAX_ABS and (
        "cpu_bf16_rel" not in report or report["rel"] <= BF16_SLACK * report["cpu_bf16_rel"])


def _rel(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(got - ref).mean() / (np.abs(ref).mean() + 1e-12))


def validate_pth_parity(pth_path: str, image_size: int = 64, batch: int = 2, seed: int = 0,
                        device="cuda", compute_dtype: Optional[str] = None) -> Dict:
    """Load a reference ``.pth``; run the twin (f32) and the port's UNetSmall
    (``compute_dtype``, by default :func:`default_dtype`) on ``device`` with
    the same inputs (``default_rng(seed)``: x standard normal (batch, in_ch,
    image_size²), t integers in [0, 1000)).

    Returns {max_abs, mean_abs, rel, in_ch, out_ch, base_ch} (the JAX
    package's report) with ``device``, ``compute_dtype``, in bf16 the
    ``f32_max_abs`` of the port's f32 forward on the CPU (the converter's
    check) and, on the card, the ``cpu_bf16_rel`` of the same bf16 net on
    the CPU's plain path, the ``rule`` applied and whether it ``pass``-ed."""
    from s1s2_torch.models.convert import (infer_arch_from_state_dict, load_pth_state_dict,
                                           torch_state_dict_to_params)
    from s1s2_torch.models.unet import load_unet
    from s1s2_torch.models.weights import params_from_numpy

    device = torch.device(device)
    compute_dtype = compute_dtype or default_dtype(device)
    sd = load_pth_state_dict(pth_path)
    arch = infer_arch_from_state_dict(sd)
    tm = build_torch_unet(**arch)
    tm.load_state_dict(sd, strict=True)
    tm = tm.eval().to(device)

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, arch["in_ch"], image_size, image_size)).astype(np.float32)
    t = rng.integers(0, 1000, batch)
    x_t = torch.from_numpy(x).to(device)
    with torch.no_grad(), _no_tf32():
        ref = tm(x_t, torch.from_numpy(t).to(device)).cpu().numpy()

    state = params_from_numpy(torch_state_dict_to_params(sd)["params"])

    def port(dev, dtype):
        net = load_unet(state, arch["out_ch"], arch["base_ch"], 1, in_ch=arch["in_ch"],
                        compute_dtype=getattr(torch, dtype), device=dev)
        with torch.no_grad():
            out = net(torch.from_numpy(x).to(dev).permute(0, 2, 3, 1).contiguous(),
                      torch.from_numpy(t.astype(np.int32)).to(dev))
        return out.permute(0, 3, 1, 2).cpu().numpy()

    got = port(device, compute_dtype)
    diff = np.abs(got - ref)
    report = {
        "max_abs": float(diff.max()),
        "mean_abs": float(diff.mean()),
        "rel": _rel(got, ref),
        **{k: float(v) for k, v in arch.items()},
        "device": str(device),
        "compute_dtype": compute_dtype,
    }
    if compute_dtype == "float32":
        report["rule"] = f"max_abs < {F32_MAX_ABS:g}"
    else:
        report["f32_max_abs"] = float(np.abs(port("cpu", "float32") - ref).max())
        report["rule"] = f"f32_max_abs < {F32_MAX_ABS:g}"
        if device.type != "cpu":
            report["cpu_bf16_rel"] = _rel(port("cpu", compute_dtype), ref)
            report["rule"] += f" and rel <= {BF16_SLACK:g} x cpu_bf16_rel"
    report["pass"] = passes(report)
    return report
