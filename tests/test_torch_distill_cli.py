"""The port's distillation CLI (``python -m s1s2_torch distill``) and
``make_synthetic`` against the JAX package's, at base 8 and 32² on the CPU
(the runs through both CLIs are in ``test_torch_distill_width.py``).

Tolerances. The parser and the synthetic files are exact. A run at LR 0
and no weight decay saves its init: flax's init at ``PRNGKey(seed + 1)``,
within 1e-6 relative (the debiased read-out's f32 division). The CLI's
progressive + endpoint run equals ``progressive_distill`` and
``endpoint_distill`` called on the loader's
batches bit for bit."""

import contextlib
import io
import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from s1s2.cli import distill as jcli
from s1s2.cli import make_synthetic as jsynth
from s1s2.models import UNetSmall as JUNet
from s1s2_torch.__main__ import main as dispatch
from s1s2_torch.cli import distill as cli
from s1s2_torch.data.synthetic import make_synthetic_patches
from s1s2_torch.models.unet import init_params
from s1s2_torch.models.weights import params_from_numpy
from s1s2_torch.train import distill
from s1s2_torch.train.checkpoint import load_model, load_params, save_model

BASE, H = 8, 32


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
    root = tmp_path_factory.mktemp("distill_cli")
    make_synthetic_patches(str(root / "p"), n=4, size=H, seed=0)
    save_model(init_params(4, BASE, 1, seed=0, in_ch=8), str(root / "teacher.msgpack"))
    return root


def run_port(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert dispatch(["distill"] + argv + ["--device", "cpu"]) == 0
    return [json.loads(ln) for ln in buf.getvalue().splitlines()]


# ---------------------------------------------------------------------------
# the parser
# ---------------------------------------------------------------------------


def actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices, a.required,
                     type(a).__name__) for a in parser._actions if a.dest != "help"}


def test_parser_has_every_flag_and_default_of_jax():
    ours, theirs = actions(cli.build_parser()), actions(jcli.build_parser())
    assert ours.pop("device") == (("--device",), "cuda", None, None, False, "_StoreAction")
    assert ours == theirs


@pytest.mark.parametrize("flag,value", [("--coordinator", "localhost:1234"),
                                        ("--num_processes", "2"), ("--process_id", "0")])
def test_multi_process_flags_raise_naming_item_7(setup, tmp_path, flag, value):
    with pytest.raises(NotImplementedError, match=r"item 7, 7c"):
        cli.main(["--patch_dir", str(setup / "p"), "--teacher", str(setup / "teacher.msgpack"),
                  "--model_path", str(tmp_path / "s.msgpack"), flag, value, "--device", "cpu"])


def test_cli_needs_a_card_unless_told_cpu(setup, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--patch_dir", str(setup / "p"), "--teacher", str(setup / "teacher.msgpack"),
                  "--model_path", str(tmp_path / "s.msgpack"), "--base_ch", str(BASE)])


def test_dispatcher_answers_help_for_distill_and_make_synthetic(capsys):
    for cmd, flag in (("distill", "--endpoint_epochs"), ("make_synthetic", "--rich")):
        with pytest.raises(SystemExit) as e:
            dispatch([cmd, "--help"])
        assert e.value.code == 0 and flag in capsys.readouterr().out


# ---------------------------------------------------------------------------
# runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s2d", [1, 2])
def test_width_student_starts_from_flax_init_at_seed_plus_one(setup, tmp_path, s2d):
    """LR 0, no decay: the saved student is its init, flax's at PRNGKey(seed + 1)."""
    path = str(tmp_path / "s.msgpack")
    run_port(["--patch_dir", str(setup / "p"), "--teacher", str(setup / "teacher.msgpack"),
              "--model_path", path, "--base_ch", str(BASE), "--student_base_ch", "4",
              "--student_s2d", str(s2d), "--skip_progressive", "--endpoint_teacher_steps", "1",
              "--endpoint_seeds", "1", "--endpoint_epochs", "1", "--batch_size", "2", "--lr",
              "0", "--weight_decay", "0", "--seed", "6", "--compute_dtype", "float32"])
    init = jax.jit(JUNet(out_ch=4, base_ch=4, stem_s2d=s2d).init)(
        jax.random.PRNGKey(7), jnp.zeros((1, H, H, 8)), jnp.zeros((1,), jnp.int32))["params"]
    assert rel(vec(flat_np(params_from_numpy(load_params(path)))), vec(flat_np(init))) <= 1e-6


def test_progressive_cli_runs_the_distill_loops_on_the_loader_batches(setup, tmp_path):
    """progressive + endpoint through the CLI equals progressive_distill and
    endpoint_distill called on the same loader batches (phase·10000 + epoch
    shuffles, seed), and the output lines name the phases."""
    from s1s2_torch.core.schedule import Schedule
    from s1s2_torch.data.dataset import NpzPatchDataset
    from s1s2_torch.data.loader import batch_iterator
    from s1s2_torch.models.unet import UNetSmall
    from s1s2_torch.data.dataset import load_set

    path = str(tmp_path / "s.msgpack")
    lines = run_port(["--patch_dir", str(setup / "p"), "--teacher", str(setup / "teacher.msgpack"),
                      "--model_path", path, "--base_ch", str(BASE), "--teacher_steps", "4",
                      "--epochs_per_phase", "1", "--batch_size", "2", "--endpoint_epochs", "1",
                      "--endpoint_seeds", "1", "--endpoint_teacher_steps", "2",
                      "--compute_dtype", "float32", "--seed", "9"])
    assert [ln.get("phase") for ln in lines[:2]] == [0, 1]
    assert lines[-1]["phases"] == [2, 1] and lines[-1]["endpoint_epochs"] == 1
    ds = NpzPatchDataset(str(setup / "p"))
    model = UNetSmall(4, BASE, 1, 8, torch.float32, autograd=True)
    cfg = distill.DistillConfig(teacher_steps=4, epochs_per_phase=1)
    teacher = params_from_numpy(load_model(model.state_dict(), str(setup / "teacher.msgpack")))
    res = distill.progressive_distill(
        model, Schedule.cosine(1000), cfg, teacher,
        lambda ph, ep: batch_iterator(ds, 2, seed=9, epoch=ph * 10_000 + ep), device="cpu")
    cond, x0, mask = load_set(str(setup / "p"), "cpu")
    want = distill.endpoint_distill(model, Schedule.cosine(1000), cfg, res["params"], teacher,
                                    cond, x0, mask, epochs=1, batch_size=2, teacher_steps=2,
                                    n_seeds=1, seed=9, device="cpu")
    got = params_from_numpy(load_params(path))
    assert all(torch.equal(got[k], want[k]) for k in want)


# ---------------------------------------------------------------------------
# make_synthetic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("extra", [[], ["--rich", "--c_cond", "3"]])
def test_make_synthetic_writes_jax_files(tmp_path, extra, capsys):
    args = ["--n", "3", "--size", "16", "--seed", "1"] + extra
    assert dispatch(["make_synthetic", "--out", str(tmp_path / "ours")] + args) == 0
    jsynth.main(["--out", str(tmp_path / "theirs")] + args)
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace("ours", "theirs") == out[1]
    names = sorted(os.listdir(tmp_path / "theirs"))
    assert sorted(os.listdir(tmp_path / "ours")) == names and len(names) == 4
    for name in names:
        a, b = tmp_path / "ours" / name, tmp_path / "theirs" / name
        if name.endswith(".npz"):  # every member's bytes (the zip's timestamps aside)
            with zipfile.ZipFile(a) as za, zipfile.ZipFile(b) as zb:
                assert za.namelist() == zb.namelist()
                assert all(za.read(m) == zb.read(m) for m in za.namelist())
        else:
            assert a.read_bytes() == b.read_bytes()
