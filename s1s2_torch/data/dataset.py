"""npz patch dataset (a numpy-only copy of the JAX package's
``data/dataset.py``, kept here so the port imports nothing of it).

Contract (produced by s1s2.data.patchify, identical to the reference
`Patch.py:253-255` output): each ``patch_*.npz`` holds
``inputs (C_cond,H,W)``, ``target (C_tgt,H,W)`` float32, optional
``mask (H,W)`` and geo metadata. The reference's loader classes
(`Train_Orignal.py:58-88` + 3 copies) collapse to this one module.

Arrays are returned **NHWC** (channels-last, the TPU layout); everything is
nan_to_num-sanitized exactly like the reference (`Train_Orignal.py:81-85`).
Optional cloud layers are surfaced for the cloudy-viz modes
(`Evaluation/Comparison_Original.py:271-278`).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

_CLOUD_KEYS = ("cloud_mask", "s2_cloud", "qa60")


def _clean(a: np.ndarray) -> np.ndarray:
    return np.nan_to_num(a.astype(np.float32), nan=0.0, posinf=0.0, neginf=0.0)


def load_patch(path: str, with_cloud: bool = False) -> Dict[str, Optional[np.ndarray]]:
    """Load one npz → dict(cond (H,W,Cc), target (H,W,Ct), mask (H,W)|None
    [, cloud (H,W)|None])."""
    with np.load(path) as d:
        out: Dict[str, Optional[np.ndarray]] = {
            "cond": np.transpose(_clean(d["inputs"]), (1, 2, 0)),
            "target": np.transpose(_clean(d["target"]), (1, 2, 0)),
            "mask": _clean(d["mask"]) if "mask" in d else None,
        }
        if with_cloud:
            cloud = None
            for key in _CLOUD_KEYS:
                if key in d:
                    cloud = _clean(d[key])
                    break
            if cloud is None and "s2_cloud_prob" in d:
                cloud = (_clean(d["s2_cloud_prob"]) >= 0.5).astype(np.float32)
            out["cloud"] = cloud
    return out


class NpzPatchDataset:
    """Sorted listing of ``*.npz`` in a directory with optional cap
    (`Train_Orignal.py:66-74`)."""

    def __init__(self, patch_dir: str, max_files: Optional[int] = None):
        files = sorted(
            f
            for f in os.listdir(patch_dir)
            if f.endswith(".npz") and os.path.isfile(os.path.join(patch_dir, f))
        )
        if max_files is not None and max_files > 0:
            files = files[:max_files]
        if not files:
            raise FileNotFoundError(f"No .npz files found in {patch_dir}")
        self.patch_dir = patch_dir
        self.files: List[str] = files

    def __len__(self) -> int:
        return len(self.files)

    def path(self, idx: int) -> str:
        return os.path.join(self.patch_dir, self.files[idx])

    def __getitem__(self, idx: int) -> Dict[str, Optional[np.ndarray]]:
        return load_patch(self.path(idx))

    def probe_channels(self):
        """(C_cond, C_tgt, H, W) from the first file (`Train_Orignal.py:239-244`)."""
        d = self[0]
        H, W, Cc = d["cond"].shape
        Ct = d["target"].shape[-1]
        return Cc, Ct, H, W


def load_set(patch_dir: str, device=None, max_files: Optional[int] = None):
    """(cond (N,H,W,Cc), target (N,H,W,Ct), mask (N,H,W)) of every file in
    ``patch_dir`` (the first ``max_files``), stacked f32 (a missing mask is
    all ones): numpy arrays, or tensors on ``device`` when one is given."""
    ds = NpzPatchDataset(patch_dir, max_files=max_files)
    items = [ds[i] for i in range(len(ds))]
    out = (np.stack([d["cond"] for d in items]), np.stack([d["target"] for d in items]),
           np.stack([np.ones(d["target"].shape[:2], np.float32) if d["mask"] is None
                     else d["mask"] for d in items]))
    if device is None:
        return out
    import torch

    return tuple(torch.from_numpy(a).to(device) for a in out)
