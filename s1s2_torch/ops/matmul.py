"""Tiled matrix product on the tensor cores: the probe of their rate.

Port of the Pallas kernel ``pallas_matmul`` of the JAX package's
``tools/probe_pallas_int8.py``: ``C = A·B`` for row-major ``A (M, K)`` and
``B (K, N)``, in the probe's modes:

* bf16 × bf16, f32 accumulation, out f32 or bf16 (rounded to nearest even);
* int8 × int8, int32 accumulation, out int32. The sum is exact while
  ``K·128² < 2³¹`` (int8 holds −128), that is ``K ≤ 131,071``.

The CUDA kernel (``csrc/matmul.cu``) runs on Hopper's ``wgmma`` with its
operands brought into shared memory by TMA. It takes M and N in multiples
of 128 and K in steps of 32 (bf16) or 64 (int8). The Pallas grid drops any
remainder silently; this wrapper raises on a shape that is not such a
multiple, and on any other dtype. ``wgmma`` reads int8 operands K-major
only, so the int8 mode transposes B on the card first, into a scratch
``(N, K)`` tensor that this wrapper allocates (``b_scratch``); that pass is
part of the call. A constant int8 B (the int8 up-convs' weights) is
packed once instead (:func:`pack_int8_b`: transposed and zero-padded to the
tiles) and multiplied by :func:`matmul_int8_packed`, which zero-pads A to
the tiles where its shape needs it (zeros leave the int32 sums exact) and
launches the product without the transpose.

The wrapper runs its plain PyTorch version when the tensors lie on the CPU
and launches the kernel when they lie on a CUDA device; it never falls back
from one to the other. ``matmul.launches`` counts the kernel launches (one
per call, the int8 mode's transpose included), ``matmul.mode_launches`` the
same by input type. The PyTorch library calls of the probe
(``torch.matmul``, ``torch._int_mm``) are yardsticks only; nothing here
calls them.
"""

from __future__ import annotations

from typing import Optional

import torch

from s1s2_torch.ops import _build
from s1s2_torch.utils.profiling import spanned

TILE_M = TILE_N = 128
TILE_K = {torch.bfloat16: 32, torch.int8: 64}
INT8_MAX_K = (2 ** 31 - 1) // 128 ** 2  # 131,071: |Σ a·b| ≤ K·128² stays in int32
_MODES = {(torch.bfloat16, torch.float32): 0, (torch.bfloat16, torch.bfloat16): 1,
          (torch.int8, torch.int32): 2}


def _shapes(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"expected a (M, K) and b (K, N), got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    if a.dtype != b.dtype or (a.dtype, out_dtype) not in _MODES:
        raise TypeError(f"matmul takes bf16 x bf16 -> f32 or bf16, or int8 x int8 -> "
                        f"int32; got {a.dtype} x {b.dtype} -> {out_dtype}")
    M, K = a.shape
    N = b.shape[1]
    if a.dtype == torch.int8 and K > INT8_MAX_K:
        raise ValueError(f"int8 matmul: K={K} > {INT8_MAX_K}, the int32 sum could overflow")
    return M, N, K


def matmul_plain(a: torch.Tensor, b: torch.Tensor,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version. int8: an exact product (int64 on the CPU; on a card,
    f64, exact below 2^53) cast to int32. bf16: an f32 product of the bf16
    values with TF32 off, rounded once to ``out_dtype``."""
    _shapes(a, b, out_dtype)
    if a.dtype == torch.int8:
        wide = torch.int64 if a.device.type == "cpu" else torch.float64
        return torch.matmul(a.to(wide), b.to(wide)).to(torch.int32)
    keep = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        y = torch.matmul(a.float(), b.float())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = keep
    return y.to(out_dtype)


def b_scratch(b: torch.Tensor) -> Optional[torch.Tensor]:
    """The int8 mode's K-major copy of ``b (K, N)``: an uninitialised
    ``(N, K)`` int8 tensor on b's device, which the kernel fills before the
    product. None for bf16, whose B the kernel reads as it is."""
    if b.dtype != torch.int8:
        return None
    K, N = b.shape
    return b.new_empty((N, K))


@spanned("kernel.matmul")
def matmul(a: torch.Tensor, b: torch.Tensor,
           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """a (M, K), b (K, N) → (M, N) in ``out_dtype``. Raises on a shape that
    is not a tile multiple (on every device, so that the CPU path refuses
    what the kernel refuses)."""
    M, N, K = _shapes(a, b, out_dtype)
    tk = TILE_K[a.dtype]
    if M % TILE_M or N % TILE_N or K % tk:
        raise ValueError(f"matmul kernel: M={M}, N={N} must be multiples of "
                         f"{TILE_M} and K={K} of {tk} ({a.dtype}); the kernel does "
                         f"not drop a remainder")
    if a.device.type == "cpu":
        return matmul_plain(a, b, out_dtype)
    for name, t in (("a", a), ("b", b)):
        if t.device != a.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: must be contiguous, 16-byte aligned, on {a.device}")
    k = _build.kernels()
    bt = b_scratch(b)
    c = a.new_empty((M, N), dtype=out_dtype)
    rc = k.s1s2k_matmul(a.data_ptr(), b.data_ptr(), None if bt is None else bt.data_ptr(),
                        c.data_ptr(), M, N, K,
                        _MODES[(a.dtype, out_dtype)], a.device.index,
                        _build.stream(a.device))
    _build.check(rc, "matmul")
    matmul.launches += 1
    matmul.mode_launches["int8" if a.dtype == torch.int8 else "bf16"] += 1
    return c


matmul.launches = 0
matmul.mode_launches = {"bf16": 0, "int8": 0}  # the same launches, by input type


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def pack_int8_b(b: torch.Tensor) -> torch.Tensor:
    """A constant int8 ``b (K, N)`` in the layout the int8 mode reads, made
    once: ``bᵀ``, K-major, zero-padded to ``(N rounded up to 128, K rounded
    up to 64)``, contiguous, on b's device."""
    if b.dim() != 2 or b.dtype != torch.int8:
        raise TypeError(f"pack_int8_b takes an int8 (K, N) matrix, got {b.dtype} "
                        f"{tuple(b.shape)}")
    K, N = b.shape
    bt = torch.zeros((_round_up(N, TILE_N), _round_up(K, TILE_K[torch.int8])),
                     dtype=torch.int8, device=b.device)
    bt[:N, :K] = b.t()
    return bt


def _packed_shapes(a: torch.Tensor, bt: torch.Tensor, n: int):
    if a.dim() != 2 or bt.dim() != 2 or a.dtype != torch.int8 or bt.dtype != torch.int8:
        raise TypeError(f"matmul_int8_packed takes int8 a (M, K) and a packed int8 b, got "
                        f"{a.dtype} {tuple(a.shape)} and {bt.dtype} {tuple(bt.shape)}")
    M, K = a.shape
    Np, Kp = bt.shape
    if Np % TILE_N or Kp % TILE_K[torch.int8] or not 0 < n <= Np or not K <= Kp < K + 64:
        raise ValueError(f"packed b {tuple(bt.shape)} does not fit a (M, {K}) x (K, {n}) "
                         f"product (pack_int8_b's layout)")
    return M, K, Np, Kp


def matmul_int8_packed_plain(a: torch.Tensor, bt: torch.Tensor, n: int) -> torch.Tensor:
    """Plain version of :func:`matmul_int8_packed`: the exact product of
    ``a`` and the unpadded B, cast to int32 (:func:`matmul_plain`)."""
    _, K, _, _ = _packed_shapes(a, bt, n)
    return matmul_plain(a, bt[:n, :K].t(), torch.int32)


@spanned("kernel.matmul_int8_packed")
def matmul_int8_packed(a: torch.Tensor, bt: torch.Tensor, n: int) -> torch.Tensor:
    """a (M, K) int8 against ``bt = pack_int8_b(b)`` for a (K, n) b → (M, n)
    int32, exact. On a card A is zero-padded to (M rounded up to 128, the
    packed K) when its shape is not already that, the kernel computes the
    padded product and the result is the (M, n) corner of it (a view); it
    never routes a shape elsewhere."""
    M, K, Np, Kp = _packed_shapes(a, bt, n)
    if a.device.type == "cpu":
        return matmul_int8_packed_plain(a, bt, n)
    if bt.device != a.device or not bt.is_contiguous() or bt.data_ptr() % 16:
        raise ValueError(f"packed b must be contiguous, 16-byte aligned, on {a.device}")
    Mp = _round_up(M, TILE_M)
    if (Mp, Kp) != (M, K) or not a.is_contiguous() or a.data_ptr() % 16:
        ap = a.new_zeros((Mp, Kp))
        ap[:M, :K] = a
        a = ap
    k = _build.kernels()
    c = a.new_empty((Mp, Np), dtype=torch.int32)
    rc = k.s1s2k_matmul(a.data_ptr(), None, bt.data_ptr(), c.data_ptr(), Mp, Np, Kp,
                        _MODES[(torch.int8, torch.int32)], a.device.index,
                        _build.stream(a.device))
    _build.check(rc, "matmul (int8, packed b)")
    matmul.launches += 1
    matmul.mode_launches["int8"] += 1
    return c[:M, :n]
