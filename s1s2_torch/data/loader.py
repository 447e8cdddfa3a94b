"""Ordered evaluation batches from an npz patch dataset.

Port of the JAX package's ``data/loader.py`` (``eval_batches`` and
``_assemble``): contiguous NHWC float32 numpy batches, missing masks as all
ones, the last batch padded with its last item so every batch has one
shape, and the next batch's npz decompression prefetched on one worker
thread while the current one runs; and ``MmapCache``, which decompresses
the dataset once into memory-mapped ``.npy`` files and serves whole batches.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

Batch = Tuple[np.ndarray, np.ndarray, np.ndarray]  # cond, target, mask


class MmapCache:
    """Decompress-once cache: the whole dataset in three contiguous NHWC
    ``.npy`` files (cond, target, mask; a missing mask as ones) under
    ``cache_dir``, served by memory-mapped fancy indexing. A manifest of the
    file names decides whether an existing cache is reused."""

    def __init__(self, ds, cache_dir: str):
        os.makedirs(cache_dir, exist_ok=True)
        self.files = list(ds.files)
        stamp = os.path.join(cache_dir, "cache_manifest.json")
        paths = {k: os.path.join(cache_dir, f"{k}.npy") for k in ("cond", "target", "mask")}
        want = {"files": self.files}
        have = None
        if os.path.exists(stamp):
            with open(stamp) as f:
                have = json.load(f)
        if have != want or not all(os.path.exists(p) for p in paths.values()):
            first = ds[0]
            H, W, Cc = first["cond"].shape
            Ct = first["target"].shape[-1]
            n = len(ds)
            arrays = {k: np.lib.format.open_memmap(paths[k], mode="w+", dtype=np.float32,
                                                   shape=shape)
                      for k, shape in (("cond", (n, H, W, Cc)), ("target", (n, H, W, Ct)),
                                       ("mask", (n, H, W)))}
            for i in range(n):
                d = ds[i]
                arrays["cond"][i] = d["cond"]
                arrays["target"][i] = d["target"]
                arrays["mask"][i] = (d["mask"] if d["mask"] is not None
                                     else np.ones((H, W), np.float32))
            for a in arrays.values():
                a.flush()
            del arrays
            with open(stamp, "w") as f:
                json.dump(want, f)
        self._cond, self._target, self._mask = (np.load(paths[k], mmap_mode="r")
                                                for k in ("cond", "target", "mask"))

    def __len__(self) -> int:
        return len(self.files)

    def batch(self, idxs) -> Batch:
        idxs = np.asarray(idxs)
        return (np.ascontiguousarray(self._cond[idxs]), np.ascontiguousarray(self._target[idxs]),
                np.ascontiguousarray(self._mask[idxs]))


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
