"""The port's distillation CLI against the JAX package's CLI on the same
files: a width run (endpoint-only, a base-4 s2d-2 student against a base-8
teacher, the 24x4 recipe's flags shortened) and the parser's errors, at 32²
on the CPU.

Tolerances. The width run is held to JAX's own spread, measured in the same
test (JAX's bf16 run against its f32 run): the port's f32 student within
1e-2 of it of JAX's f32 student, its bf16 student within twice it of JAX's
bf16 student. Its final line and snapshot records are equal. Files written
by one package are read by the other bit for bit, and the port writes the
bytes JAX's ``save_model`` writes. The errors' exit codes and messages are
equal (JAX's CLI reaches three of them only after loading its data and
initialising its model: its source holds their messages)."""

import contextlib
import functools
import inspect
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from s1s2.cli import distill as jcli
from s1s2.models import UNetSmall as JUNet
from s1s2.train.checkpoint import load_params as jload_params
from s1s2_torch.__main__ import main as dispatch
from s1s2_torch.cli import distill as cli
from s1s2_torch.data.synthetic import make_synthetic_patches
from s1s2_torch.models.unet import init_params
from s1s2_torch.models.weights import params_from_numpy
from s1s2_torch.train.checkpoint import load_params, save_model

BASE, H = 8, 32
SLACK = {"float32": 1e-2, "bfloat16": 2.0}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # small convs; the test run has a worker a core
    yield
    torch.set_num_threads(threads)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    n = np.linalg.norm(b)
    return np.linalg.norm(a - b) / n if n else np.linalg.norm(a - b)


def flat_np(tree):
    """A nested tree or a flat state → {"a.b.c": f32 array}."""
    if all(not isinstance(v, dict) for v in tree.values()):
        return {k: np.asarray(v.float() if torch.is_tensor(v) else v, np.float32)
                for k, v in tree.items()}
    return {".".join(k): np.asarray(v, np.float32) for k, v in flatten_dict(tree).items()}


def vec(d):
    return np.concatenate([d[k].reshape(-1) for k in sorted(d)])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("distill_width")
    make_synthetic_patches(str(root / "p"), n=4, size=H, seed=0)
    save_model(init_params(4, BASE, 1, seed=0, in_ch=8), str(root / "teacher.msgpack"))
    return root


def run_port(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert dispatch(["distill"] + argv + ["--device", "cpu"]) == 0
    return [json.loads(ln) for ln in buf.getvalue().splitlines()]


def run_jax(argv):
    """JAX's CLI on one device, as the port runs (with more than one visible,
    the tests' 8 virtual CPU devices, it would shard over a mesh), its model
    inits jitted (the same bits; op by op they take ~20 s here)."""
    buf = io.StringIO()
    devices, init = jax.devices, JUNet.init
    jax.devices = lambda *a, **k: devices(*a, **k)[:1]
    JUNet.init = lambda self, *a, **k: jax.jit(functools.partial(init, self))(*a, **k)
    try:
        with contextlib.redirect_stdout(buf):
            jcli.main(argv)
    finally:
        jax.devices, JUNet.init = devices, init
    return [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{")]


WIDTH = ["--student_base_ch", "4", "--student_s2d", "2", "--skip_progressive",
         "--endpoint_teacher_steps", "2", "--endpoint_seeds", "2", "--endpoint_epochs", "2",
         "--batch_size", "2", "--lr", "3e-4", "--ema_decay", "0.7", "--seed", "3"]


@pytest.fixture(scope="module")
def width_runs(setup):
    """The width recipe, shortened, through both CLIs in f32 and bf16."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        for side, run in (("port", run_port), ("jax", run_jax)):
            path = str(setup / f"w_{side}_{dtype}.msgpack")
            lines = run(["--patch_dir", str(setup / "p"), "--teacher",
                         str(setup / "teacher.msgpack"), "--model_path", path, "--base_ch",
                         str(BASE), "--compute_dtype", dtype, "--snapshot_every", "1"] + WIDTH)
            out[side, dtype] = dict(lines=lines, path=path)
    return out


def test_width_run_matches_jax_within_its_own_spread(setup, width_runs):
    p0 = vec(flat_np(init_params(4, 4, 2, seed=4, in_ch=8)))
    upd = {k: vec(flat_np(params_from_numpy(load_params(r["path"])))) - p0
           for k, r in width_runs.items()}
    spread = rel(upd["jax", "bfloat16"], upd["jax", "float32"])
    for dtype in ("float32", "bfloat16"):
        d = rel(upd["port", dtype], upd["jax", dtype])
        assert d <= SLACK[dtype] * spread, (dtype, d, spread)
        port, jax_ = (width_runs[s, dtype]["lines"] for s in ("port", "jax"))
        assert port[-1] == dict(jax_[-1], saved=port[-1]["saved"])
        assert port[-1]["student_base_ch"] == 4 and port[-1]["student_s2d"] == 2
        assert [ln.get("snapshot_epoch") for ln in port] == [
            ln.get("snapshot_epoch") for ln in jax_]
        assert os.path.exists(width_runs["port", dtype]["path"] + ".snap")


def test_saved_students_read_both_ways(width_runs):
    tmpl = unflatten_dict({tuple(k.split(".")): jnp.asarray(v.numpy())
                           for k, v in init_params(4, 4, 2, seed=0, in_ch=8).items()})
    for side in ("port", "jax"):
        path = width_runs[side, "float32"]["path"]
        a, b = flat_np(params_from_numpy(load_params(path))), flat_np(jload_params(path, tmpl))
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    # and the port writes what JAX's save_model writes for the same tree
    theirs = width_runs["jax", "float32"]["path"]
    ours = theirs + ".port.msgpack"
    save_model(params_from_numpy(load_params(theirs)), ours)
    with open(ours, "rb") as f_ours, open(theirs, "rb") as f_theirs:
        assert f_ours.read() == f_theirs.read()


ERRORS = {
    "skip_without_endpoint": (["--skip_progressive"],
                              "--skip_progressive with --endpoint_epochs 0"),
    "width_without_skip": (["--student_base_ch", "4", "--endpoint_epochs", "1"],
                           "--student_base_ch/--student_s2d require --skip_progressive"),
    "s2d_without_skip": (["--student_s2d", "2", "--endpoint_epochs", "1"],
                         "--student_base_ch/--student_s2d require --skip_progressive"),
    "init_without_skip": (["--student_init", "X", "--endpoint_epochs", "1"],
                          "--student_init only makes sense with --skip_progressive"),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_parser_errors_like_jax(setup, tmp_path, case, capsys):
    """The same exit code and message; JAX's CLI is run for the case it
    reaches before loading anything, and its source holds the others'
    messages (it reaches them after its data and model init)."""
    extra, msg = ERRORS[case]
    if case == "init_without_skip":
        extra = [extra[0], str(setup / "teacher.msgpack")] + extra[2:]
    argv = ["--patch_dir", str(setup / "p"), "--teacher", str(setup / "teacher.msgpack"),
            "--model_path", str(tmp_path / "s.msgpack"), "--base_ch", str(BASE)] + extra
    with pytest.raises(SystemExit) as e:
        cli.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().err
    assert e.value.code == 2 and msg in got
    if case == "skip_without_endpoint":
        with pytest.raises(SystemExit) as e:
            jcli.main(argv)
        assert e.value.code == 2 and got.split("error: ")[1] == capsys.readouterr().err.split(
            "error: ")[1]
    else:
        source = " ".join(inspect.getsource(jcli.main).split())
        assert " ".join(got.split("error: ")[1].split()).replace('"', "") in source.replace(
            '" "', "").replace('"', "")
    assert not (tmp_path / "s.msgpack").exists()
