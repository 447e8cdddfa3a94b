"""Row-halo load into fast memory: the probe of the conv's halo DMA.

Port of the Pallas kernel of ``probe_dma`` in the JAX package's
``tools/probe_pallas_int8.py``: for row tile i of x (H, W, C), load rows
``[i·TH, i·TH + TH + 2)`` into fast memory and write rows 1..TH of that
window times 2.0, so that ``out[r] = 2·x[r + 1]`` for out (H−2, W, C). The
Pallas grid ``(H−2)//TH`` never writes the rows past its last whole tile;
here the last row tile may be short and every output row is written.

The CUDA kernel (``csrc/halo.cu``) streams the rows through shared memory
with bulk asynchronous copies: persistent blocks walk column chunks down
the rows, each through a ring of slots that overlaps bulk loads, the
scaling and bulk stores, so every row of x is read once and the output does
not depend on ``th``. It takes f32, C a multiple of 4 (16-byte rows).

The wrapper runs its plain PyTorch version when the tensor lies on the CPU
and launches the kernel when it lies on a CUDA device; it never falls back
from one to the other. ``halo_rows_x2.launches`` counts the kernel launches.
"""

from __future__ import annotations

import torch

from s1s2_torch.ops import _build
from s1s2_torch.utils.profiling import spanned


def halo_rows_x2_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version, also the one PyTorch call that computes the same."""
    return x[1:-1] * 2.0


@spanned("kernel.halo_rows_x2")
def halo_rows_x2(x: torch.Tensor, th: int = 32) -> torch.Tensor:
    """x (H, W, C) f32 → (H−2, W, C) f32 with ``out[r] = 2·x[r + 1]``, in row
    tiles of ``th`` output rows."""
    if x.dim() != 3 or x.shape[0] < 3 or th < 1:
        raise ValueError(f"expected x (H, W, C) with H >= 3 and th >= 1, got "
                         f"{tuple(x.shape)} and th={th}")
    if x.device.type == "cpu":
        return halo_rows_x2_plain(x)
    H, W, C = x.shape
    if x.dtype != torch.float32 or not x.is_contiguous() or C % 4 or x.data_ptr() % 16:
        raise ValueError("halo kernel: x must be contiguous f32, 16-byte aligned, "
                         f"with C a multiple of 4; got {x.dtype} {tuple(x.shape)}")
    k = _build.kernels()
    y = x.new_empty((H - 2, W, C))
    rc = k.s1s2k_halo_rows_x2(x.data_ptr(), y.data_ptr(), H, W, C, int(th),
                              x.device.index,
                              _build.stream(x.device))
    _build.check(rc, "halo_rows_x2")
    halo_rows_x2.launches += 1
    return y


halo_rows_x2.launches = 0
