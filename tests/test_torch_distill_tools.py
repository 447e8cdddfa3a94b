"""The port's distillation tools (``s1s2_torch.tools.score_distill_full``,
``score_width_holdout``, ``bench_distill``) against the JAX package's on
tiny sets (2 files of 32² or 16²) on the CPU.

The scoring tools run the committed checkpoints (the base-96 ε teacher, the
24x4 and 16 students) in the f32 parity mode on both sides (the JAX tools'
``UNetSmall`` held to f32, the port's ``--compute_dtype float32``): their
f32 rows within 1e-4 relative of JAX's (DDIM rollouts and metric sums in
f32, the convs' sums in another order), their int8 rows within 5e-3 (the
calibration forward is bf16 in both and rounds a conv's bias once in the
port, twice in JAX: activation scales up to 1.3% apart move int8 values by
one step here and there, 1e-4 of the evidence MAE; on 2 files of 32² the
global SSIM moves the most, 2.3e-3 of it). The JAX tools' model inits are
jitted (the same bits; op by op they take ~20 s here). ``bench_distill``'s
teacher rows are held to JAX's samplers on the same teacher (base 8 here)
within 1e-4, and its summary to its own rows."""

import functools
import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import s1s2.models as jmodels
from s1s2.core import Schedule as JSchedule
from s1s2.core.parametrize import Parameterization as JParam
from s1s2.core.parametrize import q_sample as j_q_sample
from s1s2.sampling import dpm_solver_2m as j_dpm
from s1s2.sampling import samplers as js
from s1s2.sampling.grids import round_unique_grid as j_round_unique_grid
from s1s2_torch.data.synthetic import make_synthetic_patches
from s1s2_torch.headline import CKPT_DIR
from s1s2_torch.models.unet import init_params
from s1s2_torch.tools import bench_distill, score_distill_full, score_width_holdout
from s1s2_torch.train.checkpoint import save_model

REPO = Path(__file__).resolve().parents[1]
F32_RTOL, INT8_RTOL = 1e-4, 5e-3
METRICS = ("mae", "mse", "psnr", "ssim", "sam_rad", "ergas")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # small convs; the test run has a worker a core
    yield
    torch.set_num_threads(threads)


def jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax_tool(name, argv, monkeypatch):
    """A JAX tool's ``main`` with ``argv``, its UNetSmall held to f32 and its
    model inits jitted; → its ``--out`` rows."""
    orig = jmodels.UNetSmall
    init = orig.init
    monkeypatch.setattr(orig, "init",
                        lambda self, *a, **k: jax.jit(functools.partial(init, self))(*a, **k))
    monkeypatch.setattr(jmodels, "UNetSmall",
                        lambda *a, **k: orig(*a, **{**k, "compute_dtype": jnp.float32}))
    out = argv[argv.index("--out") + 1]
    monkeypatch.setattr(sys, "argv", [name] + argv)
    jax_tool(name).main()
    with open(out) as f:
        return [json.loads(ln) for ln in f]


def check_rows(ours, theirs):
    assert [r.get("model") for r in ours] == [r.get("model") for r in theirs]
    for a, b in zip(ours, theirs):
        if "summary" in b:
            assert a == b
            continue
        rtol = INT8_RTOL if "int8" in b["model"] else F32_RTOL
        for k in METRICS:
            # JAX's rows are rounded to 5 decimals
            assert abs(a[k] - b[k]) <= rtol * abs(b[k]) + 5e-6, (b["model"], k, a[k], b[k])


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("score")
    make_synthetic_patches(str(root / "patches"), n=2, size=32, seed=0)
    return root


def test_score_distill_full_rows_match_jax(workdir, tmp_path, monkeypatch):
    argv = ["--workdir", str(workdir),
            "--teacher", str(CKPT_DIR / "distill_eps_teacher.bf16.msgpack"),
            "--student", str(CKPT_DIR / "distill_eps_student24x4.bf16.msgpack"),
            "--student_base_ch", "24", "--student_s2d", "4", "--int8"]
    rows = score_distill_full.main(argv + ["--out", str(tmp_path / "ours.jsonl"), "--device", "cpu",
                                           "--compute_dtype", "float32"], emit=lambda _: None)
    assert rows[-1]["summary"] and len(rows) == 5
    theirs = run_jax_tool("score_distill_full", argv + ["--out", str(tmp_path / "theirs.jsonl")],
                          monkeypatch)
    check_rows(rows, theirs)
    with open(tmp_path / "ours.jsonl") as f:
        written = [json.loads(ln) for ln in f]
    assert written == [score_distill_full.rounded(r) for r in rows]


def test_score_width_holdout_rows_match_jax(workdir, tmp_path, monkeypatch):
    argv = ["--patch_dir", str(workdir / "patches"), "--widths", "24x4", "16"]
    rows = score_width_holdout.main(argv + ["--out", str(tmp_path / "ours.jsonl"), "--device",
                                            "cpu", "--compute_dtype", "float32"],
                                    emit=lambda _: None)
    assert [r["model"] for r in rows] == ["teacher_ddim20", "student24x4_ddim1",
                                          "student24x4_int8_ddim1", "student16_ddim1",
                                          "student16_int8_ddim1"]
    theirs = run_jax_tool("score_width_holdout", argv + ["--out", str(tmp_path / "theirs.jsonl")],
                          monkeypatch)
    check_rows(rows, theirs)


def test_bench_distill_teacher_rows_match_jax_samplers(tmp_path, monkeypatch):
    """A base-8 teacher (the tool's width patched down), 2 files of 16²:
    the teacher's ddim-20/2/1 and dpm2m-5 MAEs against JAX's samplers on
    the same noise; the progressive and endpoint students run, are saved,
    and the summary is their rows'."""
    monkeypatch.setattr(bench_distill, "BASE", 8)
    params = init_params(4, 8, 1, seed=3, in_ch=8)
    save_model(params, str(tmp_path / "t.msgpack"))
    lines = []
    res = bench_distill.main(["--ckpt", str(tmp_path / "t.msgpack"), "--n", "2", "--size", "16",
                              "--batch", "2", "--teacher_steps", "2", "--epochs_per_phase", "1",
                              "--endpoint_epochs", "1", "--endpoint_seeds", "1", "--int8",
                              "--out", str(tmp_path / "w"), "--device", "cpu", "--compute_dtype",
                              "float32"], emit=lines.append)
    rows, summary = res["rows"], res["summary"]
    assert json.loads(lines[-1]) == summary
    timing = [json.loads(ln) for ln in lines if "_timing" in ln]
    # one epoch a phase and one endpoint epoch leave no window to time
    assert timing == [{"progressive_timing": [{"phase": 0, "student_steps": 1}]},
                      {"endpoint_timing": None}]
    assert set(rows) == {("teacher", 20), ("teacher", 2), ("teacher", 1), ("teacher", "dpm2m5"),
                         ("student", 2), ("student", 1), ("student_ep", 1), ("student_int8", 1)}
    assert all(np.isfinite(v) for v in rows.values())
    assert (tmp_path / "w" / "student.msgpack").exists()
    assert (tmp_path / "w" / "student_endpoint.msgpack").exists()
    best1 = min(rows[("student", 1)], rows[("student_ep", 1)])
    assert summary["student_ddim1_mae"] == round(best1, 5)
    assert summary["quality_matched_distill1"] == (best1 <= rows[("teacher", 20)] * 1.01)
    assert summary["quality_matched_distill1_int8"] == (
        rows[("student_int8", 1)] <= rows[("teacher", 20)] * 1.01)

    # the teacher's rows through JAX's samplers
    from s1s2_torch.data.dataset import load_set

    cond, gt, mask = (jnp.asarray(a.numpy()) for a in load_set(str(tmp_path / "w" / "patches"),
                                                               "cpu"))
    jp = {}
    for k, v in params.items():
        node = jp
        *path, leaf = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v.numpy())
    fn = js.make_denoise_fn(jax.jit(jmodels.UNetSmall(out_ch=4, base_ch=8,
                                                      compute_dtype=jnp.float32).apply),
                            {"params": jp}, cond)
    sched, key = JSchedule.cosine(1000), jax.random.PRNGKey(1234)
    noise = jax.random.normal(key, gt.shape)
    m = np.asarray(mask)[..., None]

    def mae(pred):
        return float(np.abs((np.asarray(pred) - np.asarray(gt)) * m).sum() / (m.sum() * 4))

    ab = sched.alpha_bar_np()
    for steps in (20, 2, 1):
        want = mae(js.ddim_anchored(fn, gt, key, sched, 200, steps, noise=noise))
        assert abs(rows[("teacher", steps)] - want) <= F32_RTOL * want, steps
    grid = j_round_unique_grid(200, 5, 1000)
    K = int(grid[-1])
    x_init = j_q_sample(gt, noise, float(np.sqrt(ab[K])), float(np.sqrt(1.0 - ab[K])))
    want = mae(j_dpm(fn, x_init, sched, grid, JParam.EPS))
    assert abs(rows[("teacher", "dpm2m5")] - want) <= F32_RTOL * want


def test_bench_distill_step_rate_spans_the_first_and_last_records():
    """The rate is taken between the first and last progress records:
    (clock, epoch) pairs, 4 steps an epoch."""
    assert bench_distill.step_rate([(10.0, 1)], 4) is None
    got = bench_distill.step_rate([(10.0, 1), (10.5, 2), (13.0, 5)], 4)
    assert got == {"epochs_timed": 4, "s_per_epoch": 0.75, "ms_per_step": 187.5}
