"""The plain reference's sampler arithmetic against the program's, on the
CPU in float32, under a denoiser that is a fixed function of (x, t): the
two follow the same equations, so they agree to float32 rounding."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness.traffic import plugin  # noqa: E402
from benchmark.reference import prediction, sampling  # noqa: E402


@pytest.mark.parametrize("name", ["eps", "v"])
def test_prediction_matches_the_programs(name):
    from s1s2_torch.core.parametrize import Parameterization, pred_to_x0_eps

    g = torch.Generator().manual_seed(3)
    x_t, pred = torch.randn(2, 8, 8, 4, generator=g), torch.randn(2, 8, 8, 4, generator=g)
    ab = np.float32(0.37)
    sab, s1m = float(np.sqrt(ab)), float(np.sqrt(np.float32(1.0) - ab))
    ours = getattr(prediction, name)(x_t, pred, sab, s1m)
    theirs = pred_to_x0_eps(Parameterization(name), x_t, pred, sab, s1m)
    for a, b in zip(ours, theirs):
        torch.testing.assert_close(a, b, rtol=2e-6, atol=2e-6)


def _toy(x, t):  # a smooth prediction that depends on x and t (an int, or the program's vector)
    t = float(t.reshape(-1)[0]) if torch.is_tensor(t) else float(t)
    return 0.3 * torch.tanh(x) + 1e-3 * t


def test_the_schedule_matches_the_programs():
    from s1s2_torch.core.schedule import Schedule

    ours = sampling.cosine_alpha_bar(1000)
    assert np.array_equal(ours.astype(np.float32), Schedule.cosine(1000).alpha_bar_np())


@pytest.mark.parametrize("entry,mix", [
    ("ddim_anchored", {"t_start": 200, "steps": 1}),
    ("ddim_anchored", {"t_start": 999, "steps": 20}),
    ("dpm_solver_2m", {"grid": [200, 5, 1000]}),
])
def test_each_entry_matches_the_program(entry, mix):
    from s1s2_torch.core.schedule import Schedule

    g = torch.Generator().manual_seed(5)
    gt, noise = torch.rand(2, 8, 8, 4, generator=g), torch.randn(2, 8, 8, 4, generator=g)
    mod = plugin("entries", entry)
    schedule = Schedule.cosine(1000)
    theirs = mod.program(_toy, gt, schedule, mix, "eps")(noise)
    ours = mod.reference(_toy, gt, noise, sampling.cosine_alpha_bar(1000), mix, "eps")
    torch.testing.assert_close(ours, theirs, rtol=0, atol=2e-5)
