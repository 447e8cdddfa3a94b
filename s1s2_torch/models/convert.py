"""The reference's PyTorch ``.pth`` checkpoints → the port's state.

Port of the JAX package's ``models/convert.py``. A reference ``UNetSmall``
``state_dict`` (``inc.0.weight``, ``down{k}.0.{0,2}.weight``,
``up{k}.weight``, ``conv{k}.{0,2}.weight``, ``outc.weight`` and their biases;
the key layout of the JAX package's ``models/torch_twin.py``) becomes the
nested param tree of the JAX model, which ``weights.params_from_numpy``
flattens into the port's state:

* ``nn.Conv2d`` OIHW → HWIO (transpose (2, 3, 1, 0));
* ``nn.ConvTranspose2d`` (in, out, kH, kW) applies its kernel as the
  adjoint of a conv (a scatter); the port's up-conv, like flax's
  ``ConvTranspose``, correlates, so the taps are flipped:
  ``W[h, w, i, o] = W_pt[i, o, kH-1-h, kW-1-w]``.

Loading tolerates ``{"model": sd}`` / ``{"state_dict": sd}`` wrappers.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _conv(w: np.ndarray) -> np.ndarray:
    """OIHW → HWIO."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _conv_transpose(w: np.ndarray) -> np.ndarray:
    """(in, out, kH, kW) adjoint kernel → (kH, kW, in, out), taps flipped."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1))[::-1, ::-1])


def _block(sd: Mapping[str, np.ndarray], prefix: str) -> Dict:
    """A reference conv_block, Sequential(Conv, ReLU, Conv, ReLU) → the
    port's DoubleConv {conv1, conv2}."""
    return {f"conv{j + 1}": {"kernel": _conv(sd[f"{prefix}.{2 * j}.weight"]),
                             "bias": np.asarray(sd[f"{prefix}.{2 * j}.bias"])}
            for j in range(2)}


def torch_state_dict_to_params(state_dict: Mapping) -> Dict:
    """A reference ``state_dict`` (tensors or arrays) → ``{"params": tree}``
    of float32 numpy leaves, the JAX package's tree."""
    sd = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
              else np.asarray(v)).astype(np.float32)
          for k, v in dict(state_dict).items()}
    params = {
        "inc": {"kernel": _conv(sd["inc.0.weight"]), "bias": sd["inc.0.bias"]},
        "outc": {"kernel": _conv(sd["outc.weight"]), "bias": sd["outc.bias"]},
    }
    for k in (1, 2, 3):
        # encoder stage down{k} = Sequential(conv_block, MaxPool): keys down{k}.0.*
        params[f"down{k}"] = _block(sd, f"down{k}.0")
        params[f"up{k}"] = {"kernel": _conv_transpose(sd[f"up{k}.weight"]),
                            "bias": sd[f"up{k}.bias"]}
        params[f"conv{k}"] = _block(sd, f"conv{k}")
    return {"params": params}


def unwrap_state_dict(obj) -> Mapping:
    """The state dict inside a ``{"model": sd}`` / ``{"state_dict": sd}``
    wrapper, or ``obj`` itself."""
    if isinstance(obj, Mapping):
        for key in ("model", "state_dict"):
            inner = obj.get(key)
            if isinstance(inner, Mapping) and any(hasattr(v, "shape") for v in inner.values()):
                return inner
    return obj


def load_pth_state_dict(path: str) -> Mapping:
    """The unwrapped ``state_dict`` of a reference ``.pth`` file, on the CPU."""
    return unwrap_state_dict(torch.load(path, map_location="cpu", weights_only=True))


def load_pth_checkpoint(path: str) -> Dict:
    """A reference ``.pth`` file → ``{"params": tree}`` (float32 numpy)."""
    return torch_state_dict_to_params(load_pth_state_dict(path))


def infer_arch_from_state_dict(state_dict: Mapping) -> Dict[str, int]:
    """(in_ch, out_ch, base_ch) from a checkpoint's shapes; ``in_ch`` counts
    the x_t and cond channels (``inc`` adds the timestep channel)."""
    sd = unwrap_state_dict(state_dict)
    base_ch, in_ch_p1 = (int(s) for s in sd["inc.0.weight"].shape[:2])
    return {"in_ch": in_ch_p1 - 1, "out_ch": int(sd["outc.weight"].shape[0]),
            "base_ch": base_ch}
