"""Full-scene tiled inference with feathered overlap blending.

Port of the JAX package's ``eval/scene.py``:

* tile an arbitrarily large preprocessed scene into overlapping ps×ps
  windows (stride ≤ ps; the right and bottom edges get snapped extra
  windows so every pixel is covered);
* run a batched patch predictor over the tiles (per-tile conditioning rides
  the batch axis);
* blend the overlapping predictions back with a separable Hann feather
  window.

The predictor is called with numpy inputs and returns a tensor (on the card
or the CPU) or a numpy array; :func:`upload` moves its inputs to its device
without waiting for the work already queued there, so the card computes one
batch while the host prepares the next. With ``stitch="host"`` each batch's
prediction is downloaded and blended in numpy; with ``stitch="device"`` it
is scatter-added, tile by tile in batch order, into a scene-sized f32
accumulator on the prediction's device (the same products, ``p·win``, in the
same order, so it equals the host stitch to f32 rounding), which is
downloaded once. The feather normaliser stays on the host in both.

Per-tile normalization mirrors ``Patch.py`` when requested (z-score HH/HV on
the valid mask, ``Patch.py:228-229``).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from s1s2_torch.data.patchify import zscore

_TORCH_DTYPE = {np.dtype(np.float16): torch.float16, np.dtype(np.float32): torch.float32}


def tile_coords(H: int, W: int, ps: int, stride: int) -> List[Tuple[int, int]]:
    """Top-left corners covering the full scene (edge-snapped)."""
    rows = list(range(0, max(H - ps, 0) + 1, stride))
    cols = list(range(0, max(W - ps, 0) + 1, stride))
    if rows[-1] != H - ps:
        rows.append(H - ps)
    if cols[-1] != W - ps:
        cols.append(W - ps)
    return [(r, c) for r in rows for c in cols]


def feather_window(ps: int, power: float = 1.0) -> np.ndarray:
    """Separable Hann-like blending window, strictly positive, f32."""
    w1 = 0.5 - 0.5 * np.cos(2.0 * np.pi * (np.arange(ps) + 0.5) / ps)
    w1 = np.maximum(w1, 1e-3) ** power
    return (w1[:, None] * w1[None, :]).astype(np.float32)


def normalize_tile(cond_tile: np.ndarray, mask_tile: Optional[np.ndarray]) -> np.ndarray:
    """``Patch.py``-style per-tile normalization of a raw 4-channel S1 tile:
    z-score HH/HV on valid pixels, /90 incidence, /1000 elevation, zero-fill
    invalid (``Patch.py:228-244``)."""
    out = cond_tile.copy()
    m = mask_tile.astype(bool) if mask_tile is not None else None
    out[..., 0] = zscore(out[..., 0], m)
    out[..., 1] = zscore(out[..., 1], m)
    out[..., 2] = np.nan_to_num(out[..., 2]) / 90.0
    out[..., 3] = np.nan_to_num(out[..., 3]) / 1000.0
    if m is not None:
        out[~m] = 0.0
    return np.nan_to_num(out, nan=0.0, posinf=0.0, neginf=0.0)


def upload(a: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on ``device``. To a card it goes through
    pinned memory with a non-blocking copy, queued behind the work already
    on the stream instead of waiting for it; on the CPU it is the array's
    own memory."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    device = torch.device(device)
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def device_stitch(acc: torch.Tensor, pred: torch.Tensor, chunk, win: torch.Tensor) -> None:
    """Feather-accumulate a batch of tiles into ``acc`` (H, W, C) f32 on
    pred's device, in batch order (overlapping tiles of one batch add one
    after another): ``acc[r:r+ps, c:c+ps] += p·win`` for the valid tiles of
    ``chunk`` (the padding rows after them are left out)."""
    ps = win.shape[0]
    for j, (r, c) in enumerate(chunk):
        acc[r:r + ps, c:c + ps] += pred[j].float() * win


def infer_scene(
    predict_batch: Callable[[np.ndarray, np.ndarray], object],
    cond_scene: np.ndarray,
    out_ch: int,
    ps: int = 256,
    stride: int = 192,
    batch_size: int = 8,
    mask_scene: Optional[np.ndarray] = None,
    normalize: bool = False,
    rng_seed: int = 0,
    noise: str = "host",
    transfer_dtype: Optional[np.dtype] = None,
    pipeline: int = 1,
    stitch: str = "host",
) -> np.ndarray:
    """Stitched prediction (H, W, out_ch) f32 for a whole scene.

    ``predict_batch(cond (B,ps,ps,Cc), noise (B,ps,ps,out_ch))`` →
    (B,ps,ps,out_ch), a tensor or an array. The noise is drawn on the host
    per batch from ``np.random.default_rng(rng_seed)``, so a re-run is
    reproducible and equals the JAX package's bits. The last batch is padded
    with copies of its last tile.

    * ``noise="device"``: the predictor gets a (B,) int32 array
      ``(rng_seed·2²⁰ + tile index) & 0x7FFFFFFF`` instead and draws its own
      noise, deterministic per (seed, tile).
    * ``transfer_dtype=np.float16``: the cond tiles go to the predictor in
      f16 (it computes in bf16 anyway).
    * ``pipeline``: batches in flight before the oldest is stitched (1 is
      serial); the card computes while the host stitches and prepares.
    * ``stitch="device"``: :func:`device_stitch` on the prediction's device;
      with a ``transfer_dtype`` the accumulator is downloaded in it.
    """
    H, W, _ = cond_scene.shape
    if H < ps or W < ps:
        raise ValueError(f"scene {H}x{W} smaller than patch size {ps}")
    if stride > ps:
        raise ValueError(f"stride {stride} > patch size {ps} would leave uncovered gap "
                         "stripes in the stitched output")
    if noise not in ("host", "device"):
        raise ValueError(f"noise must be 'host' or 'device', got {noise!r}")
    if stitch not in ("host", "device"):
        raise ValueError(f"stitch must be 'host' or 'device', got {stitch!r}")
    coords = tile_coords(H, W, ps, stride)
    win = feather_window(ps)
    on_device = stitch == "device"
    acc = None if on_device else np.zeros((H, W, out_ch), np.float32)
    win_t = None
    wacc = np.zeros((H, W, 1), np.float32)
    rng = np.random.default_rng(rng_seed)

    def dispatch(s):
        chunk = coords[s:s + batch_size]
        tiles = []
        for r, c in chunk:
            t = cond_scene[r:r + ps, c:c + ps].astype(np.float32)
            if normalize:
                m = mask_scene[r:r + ps, c:c + ps] if mask_scene is not None else None
                t = normalize_tile(t, m)
            tiles.append(t)
        n_valid = len(tiles)
        while len(tiles) < batch_size:  # pad to the fixed batch
            tiles.append(tiles[-1])
        cond_b = np.stack(tiles)
        if transfer_dtype is not None:
            cond_b = cond_b.astype(transfer_dtype)
        if noise == "device":
            idx = [s + j for j in range(n_valid)]
            idx += [idx[-1]] * (batch_size - n_valid)
            # seed and tile index in 31 bits (a large seed must not overflow int32)
            noise_b = np.asarray([(rng_seed * (1 << 20) + i) & 0x7FFFFFFF for i in idx],
                                 np.int32)
        else:
            noise_b = rng.standard_normal((batch_size, ps, ps, out_ch)).astype(np.float32)
        return chunk, predict_batch(cond_b, noise_b)

    def accumulate(chunk, pred):
        nonlocal acc, win_t
        for r, c in chunk:
            wacc[r:r + ps, c:c + ps] += win[..., None]
        if on_device:
            if not isinstance(pred, torch.Tensor):
                pred = torch.from_numpy(np.asarray(pred))
            if acc is None:
                acc = torch.zeros((H, W, out_ch), dtype=torch.float32, device=pred.device)
                win_t = torch.from_numpy(win[..., None]).to(pred.device)
            device_stitch(acc, pred, chunk, win_t)
        else:
            if isinstance(pred, torch.Tensor):
                pred = pred.cpu().numpy()
            pred = np.asarray(pred, np.float32)
            for j, (r, c) in enumerate(chunk):
                acc[r:r + ps, c:c + ps] += pred[j] * win[..., None]

    window = max(1, int(pipeline))
    in_flight: List = []
    for s in range(0, len(coords), batch_size):
        in_flight.append(dispatch(s))
        if len(in_flight) >= window:
            accumulate(*in_flight.pop(0))
    for item in in_flight:
        accumulate(*item)
    if on_device:
        if transfer_dtype is not None:
            # the scene-sized accumulator is the last transfer; it comes back
            # in the wire dtype (the feather weights keep every value O(1))
            acc = acc.to(_TORCH_DTYPE[np.dtype(transfer_dtype)])
        acc = acc.cpu().numpy()
    return np.asarray(acc, np.float32) / np.maximum(wacc, 1e-8)
