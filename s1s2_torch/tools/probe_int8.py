"""Probe: the tensor-core matmul and the halo load into shared memory.

    python -m s1s2_torch.tools.probe_int8 [matmul|dma|conv|all]

Port of the JAX package's ``tools/probe_pallas_int8.py`` on one CUDA card:

* ``matmul``: the hand-written matmul kernel (``ops/matmul.py``), first
  int8 at 512³ exact against its plain version, then 8192 × 2048 × 2048 in
  bf16 → bf16 and int8 → int32, beside ``torch.matmul`` (bf16) and
  ``torch._int_mm`` (int8) as yardsticks of the card's library;
* ``dma``: the halo kernel (``ops/halo.py``) at (256, 128, 128) f32 with
  32-row tiles, against ``x[1:-1] * 2`` on every output row, then timed.

Timing keeps the reference probe's rule: every call gets a different input
(made before the call), each call is timed alone between CUDA events, and the
best of ``iters`` calls is kept. The reference's ``conv`` probe (bf16 against
int8 conv chains with an int8-out epilogue) is not ported yet: the port's
conv has no int8-out epilogue (ROADMAP §2 item 1); ``conv`` says so.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict

import torch

from s1s2_torch.ops.halo import halo_rows_x2, halo_rows_x2_plain
from s1s2_torch.ops.matmul import matmul, matmul_plain

MATMUL_SHAPE = (8192, 2048, 2048)  # M, K, N
DMA_SHAPE, DMA_TH = (256, 128, 128), 32


def best_ms(fn: Callable, make_args: Callable[[int], tuple], iters: int = 8) -> float:
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


def probe_matmul(device="cuda", iters: int = 8) -> Dict[str, float]:
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


def probe_dma(device="cuda", iters: int = 8) -> Dict[str, float]:
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
    if what in ("conv", "all"):
        print("conv: not ported yet (needs an int8-out conv epilogue; ROADMAP §2 item 1)",
              flush=True)
    out = {}
    if what in ("dma", "all"):
        out["dma"] = probe_dma()
    if what in ("matmul", "all"):
        out["matmul"] = probe_matmul()
    return out


if __name__ == "__main__":
    main()
