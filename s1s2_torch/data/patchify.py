"""Patch extraction: the part of the JAX package's ``data/patchify.py`` that
scene inference needs, :func:`zscore` (the reference ``Patch.py``'s
valid-mask z-score of the HH/HV backscatter). The rest of the patchify
pipeline is not ported yet (ROADMAP §1 item 7).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def zscore(x: np.ndarray, mask: Optional[np.ndarray]) -> np.ndarray:
    """z-score with valid-mask statistics (``Patch.py:51-62``): mean and
    standard deviation over the masked pixels (all pixels when the mask is
    missing or empty), NaNs ignored; a non-finite mean becomes 0 and a
    non-finite or tiny (< 1e-6) deviation becomes 1."""
    if mask is None or not np.any(mask):
        mu, sigma = np.nanmean(x), np.nanstd(x)
    else:
        mu, sigma = float(np.nanmean(x[mask])), float(np.nanstd(x[mask]))
    if not np.isfinite(mu):
        mu = 0.0
    if not np.isfinite(sigma) or sigma < 1e-6:
        sigma = 1.0
    return (x - mu) / sigma
