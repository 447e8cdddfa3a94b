"""``s1s2_torch/tools/puregen_table.py`` against the JAX package's
``tools/puregen_table.py`` run as a subprocess on the same inputs: a base-8
v checkpoint written by the JAX package (the harness's random init from
``PRNGKey(0)``, its ``@random`` hook), 2 rich synthetic files of 32²,
``--steps 1 2 --scales 1 2 --n_seeds 1``. One subprocess writes the
checkpoint and then runs the JAX tool, so the tool's eager template init
finds every op already compiled by the hook's identical init.
``puregen_table.csv`` cell by cell: the same header and the same guidance,
steps, calls, t_start, n_seeds and int8 cells; MAE_mean and MSE_mean
within 1e-4 and PSNR_mean within 1e-2 dB (bf16 nets that round at other
places: the harness tests' bound), SAM_mean within 1e-3 and ERGAS_mean
within 1e-3 relative. Each cell's ``ddim_true_infer_metrics.csv`` is
written under the same name."""

import csv
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from s1s2.data.synthetic import make_synthetic_patches
from s1s2_torch.tools import puregen_table

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
ARGS = ["--base_ch", "8", "--steps", "1", "2", "--scales", "1", "2", "--n_seeds", "1"]
CELLS = ["g1_s1", "g1_s2", "g2_s1", "g2_s2"]
# The subprocess: write the checkpoint from the harness's random init, then
# run the JAX tool's main in the same process.
JAX_SIDE = """
import runpy, sys
from s1s2.eval.harness import EvalConfig, EvalContext
from s1s2.train.checkpoint import save_model
root, tool, args = sys.argv[1], sys.argv[2], sys.argv[3:]
ctx = EvalContext(EvalConfig(patch_dir=root + "/p", out_dir=root + "/init", ckpt="@random",
                             mode="true_infer", base_ch=8, pred_param="v"))
save_model(ctx.variables["params"], root + "/m.msgpack")
sys.argv = [tool] + args
runpy.run_path(tool, run_name="__main__")
"""


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    root = tmp_path_factory.mktemp("puregen")
    make_synthetic_patches(str(root / "p"), n=2, size=32, seed=0, rich=True)
    common = ["--ckpt", str(root / "m.msgpack"), "--patch_dir", str(root / "p")] + ARGS
    proc = subprocess.run(
        [sys.executable, "-c", JAX_SIDE, str(root), str(REPO / "tools" / "puregen_table.py"),
         *common, "--out_dir", str(root / "jax"), "--jsonl", str(root / "jax.jsonl")],
        cwd=str(REPO), capture_output=True, text=True, timeout=600,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = []
    rows = puregen_table.main(common + ["--out_dir", str(root / "port"), "--jsonl",
                                        str(root / "port.jsonl"), "--device", "cpu"],
                              emit=lines.append)
    return dict(root=root, rows=rows, lines=lines, jax_out=proc.stdout)


def test_table_against_the_jax_tool(case):
    ref = _rows(case["root"] / "jax" / "puregen_table.csv")
    got = _rows(case["root"] / "port" / "puregen_table.csv")
    assert got[0] == ref[0] == ["guidance", "steps", "calls", "t_start", "n_seeds", "int8",
                                "MAE_mean", "MSE_mean", "PSNR_mean", "SAM_mean",
                                "ERGAS_mean"]
    assert len(got) == len(ref) == 5
    for g, r in zip(got[1:], ref[1:]):
        assert g[:6] == r[:6], (g, r)
        mae, mse, psnr, sam, ergas = (float(v) for v in g[6:])
        rmae, rmse, rpsnr, rsam, rergas = (float(v) for v in r[6:])
        assert abs(mae - rmae) <= 1e-4 and abs(mse - rmse) <= 1e-4, (g, r)
        assert abs(psnr - rpsnr) <= 1e-2 and abs(sam - rsam) <= 1e-3, (g, r)
        assert abs(ergas - rergas) <= 1e-3 * abs(rergas), (g, r)


def test_calls_count_the_v_grids_transitions(case):
    """v: ``steps`` counts the round-unique grid's points, so 1 and 2 points
    are both one transition (one call)."""
    assert [(r["guidance"], r["steps"], r["calls"]) for r in case["rows"]] == [
        (1.0, 1, 1), (1.0, 2, 1), (2.0, 1, 1), (2.0, 2, 1)]


def test_lines_jsonl_and_cell_tables(case):
    root = case["root"]
    assert [json.loads(ln) for ln in case["lines"]] == case["rows"]
    port = [json.loads(ln) for ln in (root / "port.jsonl").read_text().splitlines()]
    ref = [json.loads(ln) for ln in (root / "jax.jsonl").read_text().splitlines()]
    assert port == case["rows"] and [list(r) for r in port] == [list(r) for r in ref]
    for cell in CELLS:
        got = _rows(root / "port" / cell / "ddim_true_infer_metrics.csv")
        want = _rows(root / "jax" / cell / "ddim_true_infer_metrics.csv")
        assert got[0] == want[0] and [r[:4] for r in got] == [r[:4] for r in want]
