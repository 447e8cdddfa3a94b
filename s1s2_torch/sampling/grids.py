"""Timestep-grid builders (host-side numpy).

A copy of the JAX package's ``sampling/grids.py``; the port keeps its own so
that it imports nothing of that package.

1. linspace / truncating: ``linspace(t_start, 0, steps+1)`` cast to integers
   toward zero, descending, length steps+1.
2. round-unique: ``linspace(0, K, steps)`` → round → unique-sorted, with the
   endpoint appended if rounding dropped it. Ascending, variable length.
"""

from __future__ import annotations

import numpy as np


def clamp_t(t: int, T: int, lo: int = 1) -> int:
    """max(lo, min(t, T-1)) — the universal t_start guard."""
    return int(max(lo, min(int(t), T - 1)))


def linspace_grid(t_start: int, steps: int, T: int) -> np.ndarray:
    """Descending integer grid [t_start … 0], length steps+1 (truncating cast)."""
    t_start = clamp_t(t_start, T)
    return np.linspace(float(t_start), 0.0, steps + 1).astype(np.int64)


def round_unique_grid(t_hi: int, steps: int, T: int, ensure_endpoint: bool = True) -> np.ndarray:
    """Ascending unique integer grid over [0, t_hi] via round→unique."""
    t_hi = clamp_t(t_hi, T)
    idxs = np.unique(np.round(np.linspace(0.0, float(t_hi), steps)).astype(np.int64))
    if ensure_endpoint and idxs[-1] != t_hi:
        idxs = np.unique(np.append(idxs, t_hi))
    return idxs
