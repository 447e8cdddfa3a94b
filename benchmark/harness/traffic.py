"""The one generator of every traffic mix, and the program's side of a cell.

A mix is a data file (``benchmark/traffic/<mix>.json``) of parameters:

* ``entry``: the sampler call the window drives, found by name as
  ``benchmark/entries/<entry>.py``, with the keys it reads (``t_start``,
  ``steps``; ``grid``);
* ``denoiser``: the network under the sampler, found by name as
  ``benchmark/denoisers/<denoiser>.py``, with the keys it reads
  (``calib_t``, ``calib_n``);
* ``batch`` and ``size``: the rows of a call and the patch side;
* ``trace_seconds``: how long a traced run traces.

Everything is drawn on the device from the seed: the inputs (cond ~ N(0, 1),
gt ~ U[0, 1)) and the calibration noise once, and each call's noise inside
the timed call from a generator of its own (the check keeps the noise of
the calls it samples). The loop is closed: one caller, calls dispatched
back to back. An entry module gives ``forwards(mix)``, ``program(...)``
and ``reference(...)``; a denoiser module ``MODES``, ``program(...)`` and
``reference(...)`` (see the modules there). Nothing here names a sampler,
a precision or a parameterization.
"""

from __future__ import annotations

import hashlib
import importlib.util
from pathlib import Path
from typing import Dict

import torch

from benchmark.harness import weights

ROOT = Path(__file__).resolve().parents[2]
CC = CT = 4  # cond and target channels
_PLUGINS: Dict[str, object] = {}


def plugin(kind: str, name: str):
    """The module ``benchmark/<kind>/<name>.py``, loaded once."""
    key = f"{kind}/{name}"
    if key not in _PLUGINS:
        path = ROOT / "benchmark" / kind / f"{name}.py"
        if not path.is_file():
            raise ValueError(f"no {kind} named {name!r} ({path.relative_to(ROOT)})")
        spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _PLUGINS[key] = mod
    return _PLUGINS[key]


def sub_seed(seed: int, tag: str) -> int:
    """A seed of its own for each stream of draws, fixed by (seed, tag)."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


class Inputs:
    """What the benchmark makes from the seed and hands to both sides:
    weights, cond, gt, the calibration noise, and each call's noise."""

    def __init__(self, cfg: Dict, mix: Dict, seed: int, device: torch.device):
        arch = cfg["arch"]
        if cfg["weights"]["from"] == "checkpoint":
            self.params = weights.read_checkpoint(str(ROOT / cfg["weights"]["file"]), device)
        else:
            self.params = weights.init(arch["base_ch"], arch["stem_s2d"], arch["in_ch"],
                                       arch["out_ch"], sub_seed(seed, "weights"), device)
        B, S = int(mix["batch"]), int(mix["size"])
        gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "inputs"))
        self.cond = torch.randn((B, S, S, CC), generator=gen, device=device)
        self.gt = torch.rand((B, S, S, CT), generator=gen, device=device)
        n = int(mix.get("calib_n", 0))
        if n > B:
            raise ValueError(f"calib_n {n} is more than the batch {B}")
        self.calib_noise = [torch.randn((n, S, S, CT), generator=gen, device=device)
                            for _ in mix.get("calib_t", ())]
        self.gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "calls"))
        self.shape = (B, S, S, CT)

    def call_noise(self) -> torch.Tensor:
        """The next call's noise, drawn on the device without a sync."""
        return torch.randn(self.shape, generator=self.gen, device=self.gen.device)


class Program:
    """The program's side of a cell: the mix's denoiser on copies of the
    benchmark's weights, under the mix's entry, on the configuration's
    schedule (``s1s2_torch.core.schedule.Schedule.<schedule>(T)``)."""

    def __init__(self, cfg: Dict, mix: Dict, inputs: Inputs):
        from s1s2_torch.core.schedule import Schedule

        arch = cfg["arch"]
        schedule = getattr(Schedule, arch["schedule"])(int(arch["T"]))
        params = {k: v.clone() for k, v in inputs.params.items()}
        fn = plugin("denoisers", mix["denoiser"]).program(arch, mix, inputs, params, schedule)
        self.sample = plugin("entries", mix["entry"]).program(fn, inputs.gt, schedule, mix,
                                                               arch["prediction"])

    def __call__(self, noise: torch.Tensor) -> torch.Tensor:
        """One call of the cell: the sampler over the whole batch."""
        return self.sample(noise)
