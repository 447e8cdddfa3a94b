"""Patch-filter throughput: integral-image window stats against per-window
loops, timed on the host clock: the port of the JAX package's
``tools/bench_patchify.py``.

    python -m s1s2_torch.tools.bench_patchify [scene_size]

A seeded scene (``default_rng(0)``: four uniform bands, a mask with 10%
holes) of ``scene_size``² (default 1024), 256² windows at stride 32; one
JSON line: the windows, the seconds of ``scene_window_stats`` and of the
per-window loop (valid ratio, per-band variance, dark fraction, Laplacian
variance), and their ratio. Host numpy; no card is used.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from s1s2_torch.data.patchify import dark_fraction, laplacian_var, patch_iter, scene_window_stats


def run(size: int = 1024, ps: int = 256, stride: int = 32) -> dict:
    rng = np.random.default_rng(0)
    target = rng.uniform(0, 1, (4, size, size)).astype(np.float32)
    mask = rng.uniform(0, 1, (size, size)) > 0.1
    n_windows = len(list(patch_iter(size, size, ps, stride)))

    t0 = time.perf_counter()
    scene_window_stats(target, mask, ps, stride)
    t_vec = time.perf_counter() - t0

    t0 = time.perf_counter()
    for row, col in patch_iter(size, size, ps, stride):
        M = mask[row:row + ps, col:col + ps]
        Y = target[:, row:row + ps, col:col + ps]
        _ = float(M.mean())
        _ = [float(np.var(Y[c][M])) for c in range(4)]
        _ = dark_fraction(Y, M)
        _ = laplacian_var(Y[3], M)
    t_loop = time.perf_counter() - t0
    return {"scene": size, "windows": n_windows, "integral_image_s": round(t_vec, 3),
            "per_window_s": round(t_loop, 3), "speedup": round(t_loop / t_vec, 1)}


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    out = run(int(argv[0]) if argv else 1024)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
