"""Each cell's control, run through the whole harness at a size a test run
can hold (the base-96 cells at their own widths on 32x32 patches), comes
out not correct against the cell's limits, while the program on the same
inputs comes out correct. The readings the limits were set from were taken
on the card at each cell's own size (``benchmark/control.py``; PERF.md)."""

import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from benchmark.harness import cell  # noqa: E402
from test_bench_cpu import SMALL  # noqa: E402


@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("control", [False, True], ids=["program", "control"])
def test_the_control_fails_the_limits_and_the_program_does_not(name, control):
    ctl = cell.load_cell(name, False).check["control"] if control else None
    if ctl and "calib_n" in ctl.get("mix", {}):  # calibrate on the rows the small batch has
        ctl = dict(ctl, mix=dict(ctl["mix"], calib_n=SMALL[name]["mix"]["batch"]))
    r = cell.run(name, 2 ** 31 + 7, 0.05, False, time.perf_counter(), device=torch.device("cpu"),
                 overrides=SMALL[name], control=ctl)
    assert r["correct"] is (not control), r["check"]
