"""Carry the JAX package's parameter trees into the port.

A JAX ``UNetSmall`` param tree is a nested dict (``{"down1": {"conv1":
{"kernel": …, "bias": …}}, …}``) whose kernels are HWIO. The port keeps
the same layouts and names, flattened with dots (``"down1.conv1.kernel"``),
so its state dict reads like the JAX tree.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from s1s2_torch.train.checkpoint import flatten


def params_from_numpy(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested param tree (leaves: numpy arrays of any float dtype, or torch
    tensors, e.g. the bf16 ones of the msgpack reader) → flat state of f32
    CPU tensors. bf16 → f32 is exact."""
    state = {}
    for path, v in flatten(tree).items():
        t = v.float() if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.array(v, dtype=np.float32))
        state[".".join(path)] = t.contiguous()
    return state


def spec_arch(spec: str):
    """Checkpoint spec → (base_ch, stem_s2d): "24x4" → (24, 4), "16" → (16, 1),
    "1" (the base-96 student) → (96, 1)."""
    base, _, s2d = spec.partition("x")
    return (96 if spec == "1" else int(base)), int(s2d or 1)
