"""Every cell driven end to end on the CPU through the program's plain
paths (the look for a card skipped), at its own widths on 32x32 patches,
and seen to come out not correct when the timed path is broken
underneath."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness import cell  # noqa: E402

CPU = torch.device("cpu")
SMALL = {
    "student24x4.ddim1.b128": {"mix": {"batch": 4, "size": 32, "calib_n": 2}},
    "unet96_eps.dpm5_int8.b64": {"mix": {"batch": 2, "size": 32, "calib_n": 2}},
    "unet96_eps.ddim20_bf16.b64": {"mix": {"batch": 2, "size": 32, "steps": 4}},
}
SEED = 2 ** 31 + 101


def run(name, trace_on=False, control=None):
    return cell.run(name, SEED, 0.2, trace_on, time.perf_counter(), device=CPU,
                    overrides=SMALL[name], control=control)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_each_cell_runs_and_is_correct(name):
    r = run(name)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "check"
    assert set(r["check"]) == set(cell.load_cell(name, False).check["limits"])
    expect = {m["name"] for m in cell.load_cell(name, False).metrics}
    assert set(r["metrics"]) == expect
    assert r["metrics"]["patches_per_s"]["value"] > 0


@pytest.mark.parametrize("name", sorted(SMALL))
def test_traced_run_names_no_device_metric_on_the_cpu(name):
    r = run(name, trace_on=True)
    assert r["correct"] and r["metrics"] == {}  # no device time on the CPU
    assert r["device"]["busy_s"] == 0.0 and r["device"]["window_s"] > 0


def _state_unchanged(monkeypatch):
    from s1s2_torch.sampling import dpm_solver, samplers

    monkeypatch.setattr(samplers, "fused_ddim_update", lambda x, eps, *a: (x, x))
    coefs = dpm_solver.dpm_coefs

    def frozen(schedule, grid):  # σ_t/σ_s = 1 and α_t·φ = 0: x_t never moves
        t_s, sab, s1m, sr, a_phi, inv2r = coefs(schedule, grid)
        return t_s, sab, s1m, sr * 0 + 1, a_phi * 0, inv2r

    monkeypatch.setattr(dpm_solver, "dpm_coefs", frozen)


def _half_batch(monkeypatch):
    from s1s2_torch.models import quant, unet

    def halve(f):  # the forward leaves the second half of the batch out
        def g(self_or_qp, x, t, *a, **k):
            h = x.shape[0] // 2
            y = f(self_or_qp, x[:h], t[:h], *a, **k)
            return torch.cat([y, torch.zeros_like(y[: x.shape[0] - h])])
        return g

    monkeypatch.setattr(quant, "_forward", halve(quant._forward))
    monkeypatch.setattr(unet.UNetSmall, "forward", halve(unet.UNetSmall.forward))


def _answer_altered(monkeypatch):
    from s1s2_torch.sampling import dpm_solver, samplers

    def alter(f):
        def g(*a, **k):
            y = f(*a, **k).clone()
            y[1] = 1.0 - y[1]
            return y
        return g

    monkeypatch.setattr(samplers, "ddim_anchored", alter(samplers.ddim_anchored))
    monkeypatch.setattr(dpm_solver, "dpm_solver_2m", alter(dpm_solver.dpm_solver_2m))


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _answer_altered],
                         ids=["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    r = run(name)
    assert not r["correct"] and r["failed"] >= 1


def _run_py(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "student24x4.ddim1.b128", "--seed", str(SEED), "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_without_a_card_it_exits_with_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    p = _run_py(ROOT)
    assert p.returncode != 0 and p.stdout == ""


def test_alone_in_a_directory_it_exits_with_no_result(tmp_path):
    import shutil

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for p in manifest["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p, ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_py(tmp_path)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.gpu
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = _run_py(ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
