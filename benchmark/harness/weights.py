"""A configuration's weights: read from a committed flax msgpack
checkpoint, or made on the device from the seed.

The reader is a frozen copy of the program's msgpack decoder (maps,
arrays, strings, numbers and flax's ext 1 ndarrays; no msgpack package),
kept here so that the yardstick does not move when the program's reader
does. Both sides of the comparison get the tensors it returns.

``init`` makes flax's default initialisation of UNetSmall on the device:
every kernel LeCun-normal (a normal truncated to ±2, times
√(1/fan_in)/0.8796…, fan_in = kH·kW·Cin) and every bias zero, all kernels
drawn in one call from a ``torch.Generator`` on the device.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32,
           "float64": torch.float64, "int8": torch.int8, "int32": torch.int32}
_TRUNC_STD = 0.87962566103423978  # std of N(0, 1) truncated to [-2, 2]


class _Reader:
    def __init__(self, data: bytes):
        self.buf, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        self.pos += n
        return self.buf[self.pos - n:self.pos]

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[b]
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])))
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b]))
        if b in (0xCA, 0xCB):
            return self.unpack(">f" if b == 0xCA else ">d")
        if 0xCC <= b <= 0xD3:
            return self.unpack(">" + "BHIQbhiq"[b - 0xCC])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return str(self.take(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])), "utf-8")
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        if code != 1:
            raise ValueError(f"unsupported msgpack ext code {code}")
        inner = _Reader(bytes(self.take(n)))
        shape, dtype, raw = inner.read()
        dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
        shape = tuple(int(s) for s in shape)
        if not raw:
            return torch.empty(shape, dtype=_DTYPES[dtype])
        return torch.frombuffer(bytearray(raw), dtype=_DTYPES[dtype]).reshape(shape)


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def read_checkpoint(path: str, device) -> Dict[str, torch.Tensor]:
    """A flax msgpack param tree → flat ``{"down1.conv1.kernel": f32 tensor}``
    on ``device``."""
    with open(path, "rb") as f:
        tree = _Reader(f.read()).read()
    return {k: v.float().to(device).contiguous() for k, v in _flatten(tree).items()}


def unet_shapes(base: int, stem_s2d: int, in_ch: int, out_ch: int) -> List[Tuple[str, tuple]]:
    """Every parameter of UNetSmall, flax names and shapes (HWIO kernels)."""
    b, s = base, stem_s2d
    layers = [("inc", 3, in_ch * s * s + 1, b)]
    for blk, ci, co in (("down1", b, 2 * b), ("down2", 2 * b, 4 * b), ("down3", 4 * b, 8 * b)):
        layers += [(f"{blk}.conv1", 3, ci, co), (f"{blk}.conv2", 3, co, co)]
    for up, blk, ci, co in (("up3", "conv3", 8 * b, 4 * b), ("up2", "conv2", 4 * b, 2 * b),
                            ("up1", "conv1", 2 * b, b)):
        layers += [(up, 2, ci, co), (f"{blk}.conv1", 3, 2 * co, co), (f"{blk}.conv2", 3, co, co)]
    layers.append(("outc", 1, b, out_ch * s * s))
    out = []
    for name, k, ci, co in layers:
        out += [(f"{name}.kernel", (k, k, ci, co)), (f"{name}.bias", (co,))]
    return out


def init(base: int, stem_s2d: int, in_ch: int, out_ch: int, seed: int,
         device) -> Dict[str, torch.Tensor]:
    """flax's default init of UNetSmall from ``seed``, made on ``device``."""
    shapes = unet_shapes(base, stem_s2d, in_ch, out_ch)
    kernels = [(n, s) for n, s in shapes if n.endswith(".kernel")]
    sizes = [torch.Size(s).numel() for _, s in kernels]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    params = {}
    for (name, shape), part in zip(kernels, torch.split(flat, sizes)):
        fan_in = shape[0] * shape[1] * shape[2]
        params[name] = part.reshape(shape) * ((1.0 / fan_in) ** 0.5 / _TRUNC_STD)
    for name, shape in shapes:
        if name.endswith(".bias"):
            params[name] = torch.zeros(shape, dtype=torch.float32, device=device)
    return {n: params[n] for n, _ in shapes}
