"""The port's CLIs across 2 processes on a Gloo cluster on the CPU
(``tests/_torch_mesh_cli_worker.py``, torchrun's environment), against the
same CLIs in one process, at base 8 and 32².

* ``evaluate --mesh_data 2`` (``ddim``, ``ddim_sweep``): the CSVs equal the
  single process's to atol 1e-5 (JAX's ``tests/test_eval_mesh.py`` bound); a
  batch that does not divide raises "not divisible".
* ``infer_scene --mesh_data 2``: the scene within 1e-5 of the single
  process's.
* ``train`` and ``distill`` (progressive, then endpoint): the ranks' losses
  are equal and within rel 1e-5 of one process's; ``train --model_shard 2``
  saves a model that loads and runs finite.
In each, only rank 0 writes: rank 1's output paths (``{rank}`` in the
arguments) stay empty. Each saved model loads through the port's
``load_model`` and through the JAX package's.
"""

import contextlib
import csv
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s1s2.models import UNetSmall as JUNet
from s1s2.train.checkpoint import load_model as jload_model
from s1s2_torch.__main__ import main as dispatch
from s1s2_torch.data.synthetic import make_synthetic_patches
from s1s2_torch.models.unet import UNetSmall, init_params
from s1s2_torch.train.checkpoint import load_model, save_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from test_torch_mesh_cluster import run_world  # noqa: E402

BASE, H = 8, 32
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # small convs; the test run has a worker a core
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_cli")
    make_synthetic_patches(str(d / "p"), n=8, size=H, seed=2)
    save_model(init_params(4, BASE, 1, seed=0, in_ch=8), str(d / "t.msgpack"))
    np.save(d / "scene.npy", np.random.default_rng(0).standard_normal((56, 56, 4))
            .astype(np.float32))
    return d


def runs(d):
    """name → (argv of one process, the flags the 2-process run adds)."""
    p, t = str(d / "p"), str(d / "t.msgpack")
    ev = ["evaluate", "--patch_dir", p, "--ckpt", t, "--base_ch", str(BASE), "--batch_size", "4",
          "--t_start", "200", "--ddim_steps", "4", "--compute_dtype", "float32"] + CPU
    sc = ["infer_scene", "--scene", str(d / "scene.npy"), "--ckpt", t, "--base_ch", str(BASE),
          "--patch_size", "32", "--stride", "24", "--batch_size", "4", "--ddim_steps", "3",
          "--pred_param", "v", "--eta", "0.5"] + CPU
    tr = ["train", "--patch_dir", p, "--base_ch", str(BASE), "--batch_size", "4", "--epochs",
          "2", "--T", "100", "--compute_dtype", "float32"] + CPU
    di = ["distill", "--patch_dir", p, "--teacher", t, "--base_ch", str(BASE), "--batch_size",
          "4", "--T", "100", "--t_start", "20", "--teacher_steps", "4", "--epochs_per_phase",
          "1", "--endpoint_epochs", "2", "--endpoint_seeds", "1", "--endpoint_teacher_steps",
          "4", "--compute_dtype", "float32"] + CPU
    mesh = ["--mesh_data", "2"]
    return {
        "ddim": (ev + ["--mode", "ddim"], mesh, "--out_dir", "ev"),
        "ddim_sweep": (ev + ["--mode", "ddim_sweep", "--t_start_grid", "100,200",
                             "--ddim_steps_grid", "2,3"], mesh, "--out_dir", "sw"),
        "scene": (sc, mesh, "--out_dir", "sc"),
        "scene_fast": (sc + ["--fast_transfer"], mesh, "--out_dir", "scf"),
        "train": (tr, [], "--model_path", "tr/m.msgpack"),
        "train_tp": (tr + ["--epochs", "1", "--model_shard", "2"], [], "--model_path",
                     "tp/m.msgpack"),
        "distill": (di, [], "--model_path", "di/s.msgpack"),
        # a model-sharded state saved and resumed: every rank enters the gather
        # and reads the state file back (one directory for all ranks)
        "tp_whole": (tr + ["--model_shard", "2", "--save_state_dir", str(d / "st_whole")], [],
                     "--model_path", "tpw/m.msgpack"),
        "tp_first": (tr + ["--model_shard", "2", "--epochs", "1", "--save_state_dir",
                           str(d / "st_resume")], [], "--model_path", "tpr/m.msgpack"),
        "tp_resumed": (tr + ["--model_shard", "2", "--save_state_dir", str(d / "st_resume"),
                             "--resume"], [], "--model_path", "tpr/m.msgpack"),
    }
ONE_PROCESS = ("ddim", "ddim_sweep", "scene", "scene_fast", "train", "distill")


@pytest.fixture(scope="module")
def two(files, tmp_path_factory):
    """Every run on a 2-rank cluster; → name → [rank 0's log, rank 1's]."""
    out = tmp_path_factory.mktemp("mesh_cli_out")
    spec = [["not_divisible", runs(files)["ddim"][0] + ["--mesh_data", "2", "--batch_size", "3",
                                                         "--out_dir", str(out / "nd")]]]
    for name, (argv, extra, flag, path) in runs(files).items():
        spec.append([name, argv + extra + [flag, str(out / "r{rank}" / path)]])
    with open(out / "spec.json", "w") as f:
        json.dump(spec, f)
    ranks = run_world(2, [os.path.join(REPO, "tests", "_torch_mesh_cli_worker.py"),
                          str(out / "spec.json"), str(out)])
    for rc, text in ranks:
        assert rc == 0 and "WORKER_OK" in text, text[-3000:]
    logs = {name: [(out / f"{name}_r{r}.log").read_text() for r in range(2)] for name, _ in spec}
    return out, logs


@pytest.fixture(scope="module")
def one(files, tmp_path_factory):
    """Every run in this process, no process group; → name → its output."""
    out = tmp_path_factory.mktemp("mesh_cli_one")
    logs = {}
    for name, (argv, _, flag, path) in runs(files).items():
        if name not in ONE_PROCESS:
            continue
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert dispatch(argv + [flag, str(out / path)]) == 0
        logs[name] = buf.getvalue()
    return out, logs


def no_error(logs):
    for text in logs:
        assert "ERROR" not in text, text


def read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def numeric(rows):
    """The rows' cells after the first (a file name or a grid value)."""
    return np.asarray([[float(c) for c in r[1:]] for r in rows])


@pytest.mark.parametrize("name,csv_file", [("ddim", "ddim_metrics.csv"),
                                           ("ddim_sweep", "ddim_sweep_summary.csv")])
def test_evaluate_mesh_data_2_equals_one_process(two, one, name, csv_file):
    (out2, logs), (out1, _) = two, one
    no_error(logs[name])
    path = {"ddim": "ev", "ddim_sweep": "sw"}[name]
    h2, r2 = read_csv(out2 / "r0" / path / csv_file)
    h1, r1 = read_csv(out1 / path / csv_file)
    assert h2 == h1 and len(r2) == len(r1) > 0
    assert [r[0] for r in r2] == [r[0] for r in r1]
    np.testing.assert_allclose(numeric(r2), numeric(r1), atol=1e-5)
    assert not (out2 / "r1").joinpath(path).exists()  # rank 1 wrote nothing
    assert json.loads(logs[name][0].splitlines()[-1]) == json.loads(logs[name][1].splitlines()[-1])


def test_evaluate_mesh_data_batch_that_does_not_divide_raises(two):
    _, logs = two
    for text in logs["not_divisible"]:
        assert "ERROR ValueError: batch_size 3 not divisible by mesh_data 2" in text


@pytest.mark.parametrize("name,path", [("scene", "sc"), ("scene_fast", "scf")])
def test_infer_scene_mesh_data_2_equals_one_process(two, one, name, path):
    """Host noise with η > 0 on the v grid (the η key's tag and draws are the
    whole batch's), and ``--fast_transfer`` (per-tile seeds, f16 out)."""
    (out2, logs), (out1, _) = two, one
    no_error(logs[name])
    a = np.load(out2 / "r0" / path / "scene_pred.npy")
    b = np.load(out1 / path / "scene_pred.npy")
    assert a.shape == b.shape == (4, 56, 56)
    assert np.abs(a - b).max() <= 1e-5
    assert not (out2 / "r1" / path).exists()


def test_a_model_sharded_run_resumes_as_the_unbroken_run(two):
    """``--model_shard 2`` over 2 processes: 2 epochs, against 1 epoch then
    ``--resume`` for the second; the model files are bit-equal."""
    out2, logs = two
    for name in ("tp_whole", "tp_first", "tp_resumed"):
        no_error(logs[name])
    assert "resumed_at_step" in logs["tp_resumed"][0] and "resumed_at_step" in logs[
        "tp_resumed"][1]
    a = (out2 / "r0" / "tpw" / "m.msgpack").read_bytes()
    b = (out2 / "r0" / "tpr" / "m.msgpack").read_bytes()
    assert a == b
    assert not (out2 / "r1" / "tpr").exists()


def records(text, key, field):
    """``field`` of each JSON line of ``text`` that has ``key``."""
    out = []
    for line in text.splitlines():
        try:
            d = json.loads(line)
        except ValueError:
            continue
        if isinstance(d, dict) and key in d:
            out.append(d[field])
    return out


@pytest.mark.parametrize("name,key,field", [("train", "avg_loss", "avg_loss"),
                                            ("distill", "phase", "loss"),
                                            ("distill", "endpoint_epoch", "loss")])
def test_ranks_losses_agree_with_each_other_and_with_one_process(two, one, name, key, field):
    (_, logs), (_, logs1) = two, one
    no_error(logs[name])
    r0, r1 = (records(t, key, field) for t in logs[name])
    want = records(logs1[name], key, field)
    assert r0 == r1 and len(r0) == len(want) > 0
    np.testing.assert_allclose(r0, want, rtol=1e-5)


def jax_template():
    return JUNet(out_ch=4, base_ch=BASE, compute_dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, H, 8)), jnp.zeros((1,), jnp.int32))["params"]


@pytest.mark.parametrize("name,path", [("train", "tr/m.msgpack"), ("distill", "di/s.msgpack"),
                                       ("train_tp", "tp/m.msgpack")])
def test_only_rank_0_writes_a_model_both_packages_load(two, name, path):
    out2, logs = two
    no_error(logs[name])
    assert not (out2 / "r1" / path).exists() and not (out2 / "r1").joinpath(
        os.path.dirname(path)).exists()
    template = init_params(4, BASE, 1, seed=0, in_ch=8)
    got = load_model(template, str(out2 / "r0" / path))
    net = UNetSmall(4, BASE, 1, 8, torch.float32)
    net.load_state_dict(got)
    x = torch.from_numpy(np.random.default_rng(0).random((1, H, H, 8), np.float32))
    y = net(x, torch.tensor([5], dtype=torch.int32))
    assert torch.isfinite(y).all()
    jparams = jload_model(jax_template(), str(out2 / "r0" / path))
    jy = JUNet(out_ch=4, base_ch=BASE, compute_dtype=jnp.float32).apply(
        {"params": jparams}, jnp.asarray(x.numpy()), jnp.asarray([5], jnp.int32))
    np.testing.assert_allclose(np.asarray(jy), y.numpy(), atol=1e-4)
