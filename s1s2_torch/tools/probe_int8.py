"""Probe: chained 3×3 convs in bf16 and int8, the tensor-core matmul and the
halo load into shared memory.

    python -m s1s2_torch.tools.probe_int8 [matmul|dma|conv|all]

Port of the JAX package's ``tools/probe_pallas_int8.py`` on one CUDA card:

* ``conv``: six chained 3×3 SAME convs at B=32, 256², 128 → 128 channels,
  the reference probe's chains: in bf16 on the conv kernel's bf16 mode
  (zero bias, ReLU, then ×0.0625 to keep the values finite), with
  ``F.conv2d``'s chain (cuDNN) timed beside it as a yardstick; and in int8
  on the kernel's int8-out mode (``ops/conv3x3.conv3x3_int8_q``: int8 in,
  int32 sums, the fused requant ``clip(rint(max(f32(acc)·scale, 0)), -127,
  127)`` to int8, scale 1/(127·8)). The operands are the reference's:
  ``x ~ N(0, 1)``, ``w ~ N(0, 0.05²)``, ``x8 = int8(16·x + i)`` and ``w8 =
  int8(160·w)``, each cast toward zero as ``astype`` casts (drawn on the
  card from a generator, not with jax's bits). First the int8 chain at B=2
  bit-equal to its plain version; each chain's line gives T/s, ms and its
  bound (``bench_conv.bound_ms``). The int8-out mode runs only here; wiring
  it into the int8 forward's blocks is ROADMAP §2 item 1b;
* ``matmul``: the hand-written matmul kernel (``ops/matmul.py``), first
  int8 at 512³ exact against its plain version, then 8192 × 2048 × 2048 in
  bf16 → bf16 and int8 → int32, beside ``torch.matmul`` (bf16) and
  ``torch._int_mm`` (int8) as yardsticks of the card's library;
* ``dma``: the halo kernel (``ops/halo.py``) at (256, 128, 128) f32 with
  32-row tiles, against ``x[1:-1] * 2`` on every output row, then timed.

Timing keeps the reference probe's rule: every call gets a different input
(made before the call), each call is timed alone between CUDA events, and the
best of ``iters`` calls is kept.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from s1s2_torch.ops.conv3x3 import conv3x3_int8_q, conv3x3_int8_q_plain, conv3x3_relu
from s1s2_torch.ops.halo import halo_rows_x2, halo_rows_x2_plain
from s1s2_torch.ops.matmul import matmul, matmul_plain
from s1s2_torch.tools.bench_conv import bound_ms

MATMUL_SHAPE = (8192, 2048, 2048)  # M, K, N
DMA_SHAPE, DMA_TH = (256, 128, 128), 32
CONV_SHAPE, CONV_REPS = (32, 256, 256, 128), 6  # B, H, W, C; convs a chain
CONV_SCALE = 1.0 / (127.0 * 8)  # the int8 chain's requant scale
CONV_CHECK_BATCH = 2
ITERS = 8


def best_ms(fn: Callable, make_args: Callable[[int], tuple], iters: int = ITERS) -> float:
    """Best time in ms of ``iters`` calls of ``fn``, each on the fresh
    arguments ``make_args(i)`` and timed alone; one untimed call first."""
    fn(*make_args(0))
    torch.cuda.synchronize()
    best = float("inf")
    for i in range(1, iters + 1):
        args = make_args(i)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def _report(name: str, ms: float, ops: float) -> None:
    print(f"{name}: {ops / (ms / 1e3) / 1e12:8.1f} T/s  ({ms:.4f} ms)", flush=True)


def _int8(x: torch.Tensor) -> torch.Tensor:
    return x.round().clamp(-128, 127).to(torch.int8)


def int8_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """``x.astype(int8)`` as the reference casts: toward zero, saturated."""
    return torch.trunc(x).clamp(-128, 127).to(torch.int8)


def conv_operands(shape=CONV_SHAPE, device="cuda", seed: int = 0):
    """(x, w) f32 of the reference's conv probe: x ~ N(0, 1) of ``shape``
    (B, H, W, C), w ~ N(0, 0.05²) (3, 3, C, C), from one generator."""
    g = torch.Generator(device=device).manual_seed(seed)
    C = shape[3]
    x = torch.randn(shape, generator=g, device=device)
    w = torch.randn((3, 3, C, C), generator=g, device=device) * 0.05
    return x, w


def chain_bf16(x: torch.Tensor, w: torch.Tensor, reps: int = CONV_REPS) -> torch.Tensor:
    """``reps`` times: the conv kernel's bf16 mode with zero bias and ReLU,
    then ×0.0625 (exact in bf16)."""
    b = torch.zeros(w.shape[3], dtype=torch.float32, device=x.device)
    for _ in range(reps):
        x = conv3x3_relu(x, w, b) * 0.0625
    return x


def chain_conv2d(x: torch.Tensor, w: torch.Tensor, reps: int = CONV_REPS) -> torch.Tensor:
    """The same chain on ``F.conv2d`` (NCHW views of the NHWC operands,
    OIHW weights): the card's library as a yardstick; the port never calls
    it."""
    xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
    for _ in range(reps):
        xn = torch.relu(F.conv2d(xn, wn, padding=1)) * 0.0625
    return xn.permute(0, 2, 3, 1)


def chain_int8(x8: torch.Tensor, w8: torch.Tensor, reps: int = CONV_REPS,
               scale: float = CONV_SCALE, conv: Callable = conv3x3_int8_q) -> torch.Tensor:
    """``reps`` times: the int8-out conv, ``clip(rint(max(f32(acc)·scale,
    0)), -127, 127)`` → int8 (deq the one scale, zero bias); ``conv`` its
    plain version for a check on the card."""
    Cout = w8.shape[3]
    deq = torch.full((Cout,), scale, dtype=torch.float32, device=x8.device)
    b = torch.zeros(Cout, dtype=torch.float32, device=x8.device)
    for _ in range(reps):
        x8 = conv(x8, w8, deq, b)
    return x8


def conv_bounds(shape=CONV_SHAPE, reps: int = CONV_REPS) -> Dict[str, tuple]:
    """Each chain's least time: every conv reads its input and weights once
    and writes its output once (2 bytes an element in bf16, 1 in int8;
    bf16's ×0.0625 folded into the conv's store), against its operations at
    the mode's dense tensor-core peak. → {mode: (ms, bound_by)}."""
    B, H, W, C = shape
    ops = reps * 2.0 * B * H * W * 9 * C * C
    out = {}
    for mode, e in (("bf16", 2), ("int8", 1)):
        out[mode] = bound_ms(reps * (2 * B * H * W * C * e + 9 * C * C * e), ops, mode)
    return out


def probe_conv(device="cuda", iters: int = ITERS) -> Dict[str, float]:
    """The int8 chain at B=2 bit-equal to its plain version, then each chain
    timed at CONV_SHAPE (bf16 kernel, ``F.conv2d``, int8 kernel)."""
    B, H, W, C = CONV_SHAPE
    x, w = conv_operands(CONV_SHAPE, device)
    w16, w8 = w.to(torch.bfloat16), int8_toward_zero(w * 160)
    xc8 = int8_toward_zero(x[:CONV_CHECK_BATCH] * 16)
    same = bool(torch.equal(chain_int8(xc8, w8), chain_int8(xc8, w8, conv=conv3x3_int8_q_plain)))
    print(f"conv int8+requant x{CONV_REPS} at B={CONV_CHECK_BATCH}, {H}x{W}, {C}->{C}: "
          f"bit-equal to its plain version: {same}", flush=True)
    if not same:
        raise AssertionError("the int8-out conv chain disagrees with its plain version")
    ops = CONV_REPS * 2.0 * B * H * W * 9 * C * C
    out = {
        "bf16": best_ms(chain_bf16, lambda i: ((x + i * 1e-3).to(torch.bfloat16), w16), iters),
        "conv2d_bf16": best_ms(chain_conv2d,
                               lambda i: ((x + i * 1e-3).to(torch.bfloat16), w16), iters),
        "int8": best_ms(chain_int8, lambda i: (int8_toward_zero(x * 16 + i), w8), iters),
    }
    bounds = conv_bounds()
    for name, key, mode in (("conv bf16", "bf16", "bf16"), ("F.conv2d bf16", "conv2d_bf16",
                                                           "bf16"),
                            ("conv int8+requant", "int8", "int8")):
        _report(f"{name} x{CONV_REPS}", out[key], ops)
        print(f"  bound {bounds[mode][0]:.4f} ms ({bounds[mode][1]}), "
              f"{bounds[mode][0] / out[key]:.3f} of it", flush=True)
    out.update(bound_bf16=bounds["bf16"][0], bound_int8=bounds["int8"][0],
               int8_speedup=out["bf16"] / out["int8"])
    print(f"conv bf16 : int8 time ratio {out['int8_speedup']:.3f}", flush=True)
    return out


def probe_matmul(device="cuda", iters: int = ITERS) -> Dict[str, float]:
    """Exactness at 512³, then times in ms at MATMUL_SHAPE."""
    g = torch.Generator(device=device).manual_seed(7)
    sa = _int8(torch.randn((512, 512), generator=g, device=device) * 5)
    sb = _int8(torch.randn((512, 512), generator=g, device=device) * 5)
    if not torch.equal(matmul(sa, sb, torch.int32), matmul_plain(sa, sb, torch.int32)):
        raise AssertionError("int8 matmul kernel disagrees with its plain version at 512^3")
    print("int8 matmul kernel exact against its plain version at 512^3: OK", flush=True)

    M, K, N = MATMUL_SHAPE
    af = torch.randn((M, K), generator=g, device=device)
    bf = torch.randn((K, N), generator=g, device=device)
    ops = 2.0 * M * K * N

    def args_bf16(i):
        return (af + i).to(torch.bfloat16), bf.to(torch.bfloat16)

    def args_int8(i):
        return _int8(af * 10 + i), _int8(bf * 10)

    out = {
        "kernel_bf16": best_ms(lambda a, b: matmul(a, b, torch.bfloat16), args_bf16, iters),
        "kernel_int8": best_ms(lambda a, b: matmul(a, b, torch.int32), args_int8, iters),
        "torch_matmul_bf16": best_ms(torch.matmul, args_bf16, iters),
        "torch_int_mm_int8": best_ms(torch._int_mm, args_int8, iters),
    }
    for name, ms in out.items():
        _report(f"{name} {M}x{K}x{N}", ms, ops)
    return out


def probe_dma(device="cuda", iters: int = ITERS) -> Dict[str, float]:
    """The halo kernel against ``x[1:-1] * 2`` on every row, then timed."""
    H, W, C = DMA_SHAPE
    x = torch.arange(H * W * C, dtype=torch.float32, device=device).reshape(H, W, C) / 1e6
    out = halo_rows_x2(x, DMA_TH)
    err = float((out - halo_rows_x2_plain(x)).abs().max())
    tail = (H - 2) // DMA_TH * DMA_TH  # the rows the reference's grid never writes
    print(f"halo rows x2 {DMA_SHAPE} TH={DMA_TH}: max err {err:.2e} over all {H - 2} rows "
          f"(rows {tail}..{H - 3} included)", flush=True)
    if err != 0.0:
        raise AssertionError("halo kernel disagrees with x[1:-1] * 2")
    ms = best_ms(lambda a: halo_rows_x2(a, DMA_TH), lambda i: (x + i,), iters)
    print(f"halo rows x2 {DMA_SHAPE}: {ms:.4f} ms, "
          f"{8 * (H - 1) * W * C / (ms / 1e3) / 1e9:.1f} GB/s", flush=True)
    return {"kernel": ms, "max_abs_err": err}


def main(argv=None) -> Dict[str, Dict[str, float]]:
    argv = sys.argv[1:] if argv is None else argv
    what = argv[0] if argv else "all"
    if what not in ("matmul", "dma", "conv", "all"):
        raise SystemExit(f"usage: python -m s1s2_torch.tools.probe_int8 [matmul|dma|conv|all], "
                         f"got {what!r}")
    if not torch.cuda.is_available():
        raise SystemExit("probe_int8 measures the card: torch.cuda.is_available() is false")
    print(torch.cuda.get_device_name(0), flush=True)
    out = {}
    if what in ("conv", "all"):
        out["conv"] = probe_conv()
    if what in ("dma", "all"):
        out["dma"] = probe_dma()
    if what in ("matmul", "all"):
        out["matmul"] = probe_matmul()
    return out


if __name__ == "__main__":
    main()
