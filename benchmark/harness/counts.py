"""The yardstick's arithmetic: the work of one UNetSmall forward, layer by
layer, counted from the model's shapes, and the card's published peaks.

Operations are 2 a multiply-add of the algorithm at the model's own
shapes: 9 taps an output pixel for every 3×3 SAME conv, one (Ci, 4·Co)
product an input pixel for each 2×2 stride-2 transposed conv, one (Ci, Co)
product a pixel for the 1×1 head. The stems' true channel counts are used,
not the padded ones, so the count reads the same whatever implements a
layer. Bytes: each input byte read once and each output byte written once
(bf16 activations), the weights once (bf16, or int8 with an f32 scale
beside the f32 bias), the bias once (f32).
"""

from __future__ import annotations

from typing import Dict, List

# one NVIDIA H100 SXM, dense tensor-core rates without sparsity, at 700 W
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12
LEVEL = {"inc": 0, "down1": 0, "down2": 1, "down3": 2, "conv3": 2, "conv2": 1, "conv1": 0}
BLOCKS = ("down1", "down2", "down3", "conv3", "conv2", "conv1")


def layers(base: int, stem_s2d: int, in_ch: int, out_ch: int, size: int, batch: int,
           modes: Dict[str, str]) -> List[Dict]:
    """One dict a layer of one forward at ``batch``: name, kind (conv3x3,
    up, head), mode (the precision it runs in), ops, bytes. ``modes`` (a
    denoiser's ``MODES``) gives the precision of the stem conv ``inc``, the
    double-conv ``blocks``, the ``up``-convs and the ``head``."""
    b, body = base, size // stem_s2d
    out = []

    def conv(name, H, ci, co, mode):
        wbytes, sbytes = (1, 8) if mode == "int8" else (2, 4)
        out.append(dict(name=name, kind="conv3x3", mode=mode,
                        ops=2.0 * 9 * H * H * ci * co * batch,
                        bytes=2.0 * H * H * (ci + co) * batch + wbytes * 9.0 * ci * co
                        + sbytes * co))

    conv("inc", body, in_ch * stem_s2d ** 2 + 1, b, modes["inc"])
    chans = {"down1": (b, 2 * b), "down2": (2 * b, 4 * b), "down3": (4 * b, 8 * b),
             "conv3": (8 * b, 4 * b), "conv2": (4 * b, 2 * b), "conv1": (2 * b, b)}
    for blk in BLOCKS:
        ci, co = chans[blk]
        H = body >> LEVEL[blk]
        conv(f"{blk}.conv1", H, ci, co, modes["blocks"])
        conv(f"{blk}.conv2", H, co, co, modes["blocks"])
    for level, ci, co in ((3, 8 * b, 4 * b), (2, 4 * b, 2 * b), (1, 2 * b, b)):
        h = body >> level
        out.append(dict(name=f"up{level}", kind="up", mode=modes["up"],
                        ops=2.0 * h * h * ci * 4 * co * batch,
                        bytes=2.0 * (h * h * ci * batch + 4 * h * h * co * batch + 4 * ci * co)
                        + 4.0 * co))
    cho = out_ch * stem_s2d ** 2
    out.append(dict(name="outc", kind="head", mode=modes["head"],
                    ops=2.0 * body * body * b * cho * batch,
                    bytes=2.0 * (body * body * b * batch + b * cho) + 4.0 * cho))
    return out


def least_seconds(layer: Dict) -> float:
    """The least time the card could take for a layer: the larger of its
    operations at the peak of its precision and its bytes at HBM speed."""
    return max(layer["ops"] / PEAK_OPS_PER_S[layer["mode"]], layer["bytes"] / HBM_BYTES_PER_S)


def peak_seconds(layer: Dict) -> float:
    """A layer's operations at the peak of its precision."""
    return layer["ops"] / PEAK_OPS_PER_S[layer["mode"]]


def roofline_percent(ctx, kernels, kind: str, mode: str):
    """The least time of the traced window's ``kind`` layers in ``mode``
    over the device time of the kernels whose names hold one of
    ``kernels``, in %; None where either is absent."""
    tr = ctx["trace"]
    chosen = [x for x in ctx["layers"] if x["kind"] == kind and x["mode"] == mode]
    busy = sum(sec for name, sec, _ in tr.ops if any(k in name for k in kernels)) if tr else 0.0
    if not chosen or busy <= 0:
        return None
    calls = ctx["forwards_per_call"] * ctx["window"].calls
    return 100.0 * sum(least_seconds(x) for x in chosen) * calls / busy
