"""Training and evaluation batches from an npz patch dataset.

Port of the JAX package's ``data/loader.py``: contiguous NHWC float32 numpy
batches with missing masks as all ones (``_assemble``); ``batch_iterator``,
one shuffled training epoch; ``eval_batches``, ordered batches with the
last padded with its last item so every batch has one shape; each
prefetches the next batch's npz decompression on one worker thread while
the current one runs; and ``MmapCache``, which decompresses the dataset
once into memory-mapped ``.npy`` files and serves whole batches.
"""

from __future__ import annotations

import collections
import concurrent.futures
import json
import os
import threading
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


def batch_iterator(ds, batch_size: int, *, shuffle: bool = True, drop_last: bool = True,
                   seed: int = 1337, epoch: int = 0, prefetch: bool = True,
                   process_index: int = 0, process_count: int = 1) -> Iterator[Batch]:
    """One epoch of batches, shuffled by ``default_rng(seed + epoch)``.

    ``batch_size`` is the global batch: every process shuffles alike and
    assembles its contiguous 1/``process_count`` slice of each global batch
    (with more than one process, ragged tails are dropped so every process
    sees the same number of batches). One batch is assembled ahead on a
    worker thread."""
    if batch_size % process_count:
        raise ValueError(f"global batch {batch_size} not divisible by {process_count} processes")
    local = batch_size // process_count
    n = len(ds)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed + epoch).shuffle(order)
    stops = range(0, n - batch_size + 1 if drop_last else n, batch_size)
    globals_ = [order[s:s + batch_size] for s in stops]
    if process_count > 1:
        globals_ = [g for g in globals_ if len(g) == batch_size]
    chunks = [g[process_index * local:(process_index + 1) * local] for g in globals_]
    if not prefetch or len(chunks) <= 1:
        for c in chunks:
            yield _assemble(ds, c)
        return

    q: collections.deque = collections.deque()
    lock = threading.Condition()
    done = object()

    def worker():
        end = done
        try:
            for c in chunks:
                b = _assemble(ds, c)
                with lock:
                    while len(q) >= 2:
                        lock.wait()
                    q.append(b)
                    lock.notify_all()
        except Exception as e:  # handed to the consumer, which raises it
            end = e
        with lock:
            q.append(end)
            lock.notify_all()

    threading.Thread(target=worker, daemon=True).start()
    while True:
        with lock:
            while not q:
                lock.wait()
            item = q.popleft()
            lock.notify_all()
        if item is done:
            break
        if isinstance(item, Exception):
            raise item
        yield item


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
