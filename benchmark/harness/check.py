"""Whether the timed path is correct: its outputs beside the plain
reference's, on the same inputs.

A seeded reservoir keeps the inputs and outputs of a sample of the
window's calls, drawn uniformly from all of them; after the window (and
after the program's state is freed) the reference recomputes a seeded
sample of each kept call's rows, in blocks of rows, from the benchmark's
own weights and inputs. The cell's file (``benchmark/workloads/
<cell>.json``) names the numbers compared, each with its limit:

* ``gap_mean``: the mean |program − reference| over every compared value;
* ``gap_patch``: the largest such mean of one patch;
* ``gap_inner``, ``gap_inner_patch``: the same over the values that the
  reference's final clamp to [0, 1] leaves inside (0, 1). A clamped value
  hides the precision behind it, and with random weights the share the
  clamp takes differs from network to network.

A number that is not finite fails. ``failed`` counts the kept calls whose
own numbers fail.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark.harness.traffic import Inputs, plugin, sub_seed

NUMBERS = ("gap_mean", "gap_patch", "gap_inner", "gap_inner_patch")


class Reservoir:
    """A uniform sample of ``k`` of the window's calls, drawn from the seed
    (algorithm R): only references are kept, nothing is copied or synced."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng = int(k), random.Random(sub_seed(seed, "reservoir"))
        self.kept: List[Tuple[int, torch.Tensor, torch.Tensor]] = []

    def offer(self, i: int, noise: torch.Tensor, out: torch.Tensor) -> None:
        if len(self.kept) < self.k:
            self.kept.append((i, noise, out))
            return
        j = self.rng.randint(0, i)
        if j < self.k:
            self.kept[j] = (i, noise, out)


def sample_rows(batch: int, n: int, seed: int) -> List[int]:
    """The rows of each kept call that the reference recomputes."""
    return sorted(random.Random(sub_seed(seed, "rows")).sample(range(batch), min(n, batch)))


def reference_outputs(cfg: Dict, mix: Dict, inputs: Inputs, calls, rows: List[int],
                      denoiser: Optional[str] = None, block: int = 8) -> List[torch.Tensor]:
    """The plain reference's output for ``rows`` of each kept (i, noise,
    output) call: the reference of the mix's entry over the reference of
    its denoiser (or of ``denoiser``, a control put in the program's place),
    ``block`` rows at a time, on the configuration's schedule
    (``reference.sampling.<schedule>_alpha_bar(T)``)."""
    from benchmark.reference import sampling

    arch = cfg["arch"]
    ab64 = getattr(sampling, f"{arch['schedule']}_alpha_bar")(int(arch["T"]))
    entry = plugin("entries", mix["entry"])
    with torch.no_grad():
        net = plugin("denoisers", denoiser or mix["denoiser"]).reference(arch, mix, inputs, ab64)
        idx = torch.as_tensor(rows, device=inputs.gt.device)
        out = []
        for _, noise, _ in calls:
            parts = []
            for i in range(0, len(rows), block):
                r = idx[i:i + block]
                parts.append(entry.reference(net(inputs.cond[r]), inputs.gt[r], noise[r], ab64,
                                             mix, arch["prediction"]))
            out.append(torch.cat(parts))
    return out


def compare(outs: List[torch.Tensor], refs: List[torch.Tensor],
            limits: Dict[str, float]) -> Tuple[Dict[str, Dict[str, float]], int]:
    """The compared rows of each kept call beside the reference's →
    ({number: {"value", "limit"}} for the numbers ``limits`` names, count
    of kept calls whose own numbers fail)."""
    unknown = set(limits) - set(NUMBERS)
    if unknown:
        raise ValueError(f"no such number to compare: {sorted(unknown)}")
    sums = {k: 0.0 for k in ("all", "all_n", "inner", "inner_n")}
    worst: Dict[str, List[float]] = {"gap_patch": [], "gap_inner_patch": []}
    failed = 0
    for out, ref in zip(outs, refs):
        ref = ref.double()
        gap = (out.double() - ref).abs().reshape(ref.shape[0], -1)
        inner = ((ref > 0) & (ref < 1)).reshape(ref.shape[0], -1)
        n = inner.sum(dim=1)
        inner_sum = (gap * inner).sum(dim=1)
        per_patch = {"gap_patch": gap.mean(dim=1),
                     # a patch the clamp took whole is judged on all of its values
                     "gap_inner_patch": torch.where(n > 0, inner_sum / n.clamp(min=1),
                                                    gap.mean(dim=1))}
        call = {"gap_mean": float(gap.mean()),
                "gap_inner": float(inner_sum.sum() / n.sum()) if int(n.sum()) else float("nan")}
        for k, v in per_patch.items():
            call[k] = float(v.max())
            worst[k].append(call[k])
        sums["all"] += float(gap.sum())
        sums["all_n"] += gap.numel()
        sums["inner"] += float(inner_sum.sum())
        sums["inner_n"] += int(n.sum())
        if not all(call[k] <= limit for k, limit in limits.items()):
            failed += 1
    nan = float("nan")
    values = {"gap_mean": sums["all"] / sums["all_n"] if sums["all_n"] else nan,
              "gap_inner": sums["inner"] / sums["inner_n"] if sums["inner_n"] else nan,
              **{k: float(np.max(v)) if v else nan for k, v in worst.items()}}
    return {k: {"value": values[k], "limit": float(limit)} for k, limit in limits.items()}, failed


def passes(numbers: Dict[str, Dict[str, float]]) -> bool:
    """Every number finite and within its limit."""
    return all(np.isfinite(v["value"]) and v["value"] <= v["limit"] for v in numbers.values())
