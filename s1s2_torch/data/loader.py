"""Ordered evaluation batches from an npz patch dataset.

Port of the JAX package's ``data/loader.py`` (``eval_batches`` and
``_assemble``): contiguous NHWC float32 numpy batches, missing masks as all
ones, the last batch padded with its last item so every batch has one
shape, and the next batch's npz decompression prefetched on one worker
thread while the current one runs. The decompress-once ``MmapCache`` is not
ported yet (ROADMAP §1); ``_assemble`` takes any dataset with a ``batch``
method in its place.
"""

from __future__ import annotations

import concurrent.futures
from typing import Iterator, List, Optional, Tuple

import numpy as np

Batch = Tuple[np.ndarray, np.ndarray, np.ndarray]  # cond, target, mask


def _assemble(ds, idxs) -> Batch:
    if hasattr(ds, "batch"):  # a cache that serves whole batches
        return ds.batch(idxs)
    conds, tgts, masks = [], [], []
    for i in idxs:
        d = ds[int(i)]
        conds.append(d["cond"])
        tgts.append(d["target"])
        m = d["mask"]
        masks.append(m if m is not None else np.ones(d["target"].shape[:2], np.float32))
    return (np.stack(conds).astype(np.float32), np.stack(tgts).astype(np.float32),
            np.stack(masks).astype(np.float32))


def eval_batches(ds, batch_size: int, max_files: Optional[int] = None,
                 prefetch: bool = True) -> Iterator[Tuple[Batch, List[str], int]]:
    """Deterministic, ordered batches for evaluation → (batch, file names,
    n_valid); the last batch is padded to ``batch_size`` with its last item."""
    n = len(ds) if not max_files else min(len(ds), max_files)

    def make(s):
        idxs = list(range(s, min(s + batch_size, n)))
        n_valid = len(idxs)
        while len(idxs) < batch_size:
            idxs.append(idxs[-1])
        return _assemble(ds, idxs), [ds.files[i] for i in idxs[:n_valid]], n_valid

    starts = list(range(0, n, batch_size))
    if not prefetch or len(starts) <= 1:
        for s in starts:
            yield make(s)
        return
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(make, starts[0])
        for s_next in starts[1:] + [None]:
            item = fut.result()
            if s_next is not None:
                fut = ex.submit(make, s_next)
            yield item
