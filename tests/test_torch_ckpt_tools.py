"""s1s2_torch's checkpoint tools against the JAX package's: ``convert_ckpt``
on both committed reference nets and ``archive_ckpt`` byte-equal to the JAX
CLI's and tool's files, and ``demo_distill_viz``'s summary rows within 1e-4
of the JAX tool's (the committed base-96 ε teacher and student on two 16²
patches, in the f32 parity mode on both sides as the distillation tools'
tests run them: the JAX tool's ``UNetSmall`` held to f32 and its init
jitted, the port's ``--compute_dtype float32``: in bf16 the JAX tool's
student one-step MAE moves 1.2e-3 from its f32 value on these patches, the
port's 2e-4), its strips written."""

import functools
import json
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

import s1s2.models as jmodels
from s1s2.cli import convert_ckpt as jconvert
from s1s2.data.synthetic import make_synthetic_patches
from s1s2_torch.__main__ import main as dispatch
from s1s2_torch.tools import archive_ckpt, demo_distill_viz

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NETS = ("ref_eps_model.pth", "ref_v_model.pth")
CKPTS = os.path.join(REPO, "examples", "checkpoints")


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _run_jax_tool(name, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name] + argv)
    runpy.run_path(os.path.join(REPO, "tools", name), run_name="__main__")


@pytest.mark.parametrize("net", NETS)
def test_convert_and_archive_byte_equal_to_jax(net, tmp_path, capsys, monkeypatch):
    pth = os.path.join(REPO, "examples", "ref_crossval", net)
    jconvert.main(["--pth", pth, "--out", str(tmp_path / "j.msgpack")])
    jline = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert dispatch(["convert_ckpt", "--pth", pth, "--out", str(tmp_path / "t.msgpack")]) == 0
    tline = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tline == {**jline, "out": str(tmp_path / "t.msgpack")}
    assert tline["base_ch"] == 16
    assert _bytes(tmp_path / "t.msgpack") == _bytes(tmp_path / "j.msgpack")

    _run_jax_tool("archive_ckpt.py", [str(tmp_path / "j.msgpack"), str(tmp_path / "ja.msgpack")],
                  monkeypatch)
    jout = capsys.readouterr().out.strip().splitlines()[-1]
    archive_ckpt.main([str(tmp_path / "t.msgpack"), str(tmp_path / "ta.msgpack")])
    tout = capsys.readouterr().out.strip().splitlines()[-1]
    assert tout == jout.replace("j.msgpack", "t.msgpack").replace("ja.msgpack", "ta.msgpack")
    assert _bytes(tmp_path / "ta.msgpack") == _bytes(tmp_path / "ja.msgpack")


def test_demo_distill_viz_against_jax(tmp_path, capsys, monkeypatch):
    make_synthetic_patches(str(tmp_path / "w" / "patches"), n=3, size=16, seed=0)
    common = ["--workdir", str(tmp_path / "w"), "--k", "2",
              "--teacher", os.path.join(CKPTS, "distill_eps_teacher.bf16.msgpack"),
              "--student", os.path.join(CKPTS, "distill_eps_student1.bf16.msgpack")]
    orig = jmodels.UNetSmall
    init = orig.init
    monkeypatch.setattr(orig, "init",
                        lambda self, *a, **k: jax.jit(functools.partial(init, self))(*a, **k))
    monkeypatch.setattr(jmodels, "UNetSmall",
                        lambda *a, **k: orig(*a, **{**k, "compute_dtype": jnp.float32}))
    _run_jax_tool("demo_distill_viz.py", common + ["--out", str(tmp_path / "jax")], monkeypatch)
    rows = demo_distill_viz.main(common + ["--out", str(tmp_path / "port"), "--device", "cpu",
                                           "--compute_dtype", "float32"])
    with open(tmp_path / "jax" / "summary.json") as f:
        ref = json.load(f)
    with open(tmp_path / "port" / "summary.json") as f:
        got = json.load(f)
    assert got["layout"] == ref["layout"] and got["rows"] == rows
    assert len(rows) == len(ref["rows"]) == 2
    for g, r in zip(got["rows"], ref["rows"]):
        assert list(g) == list(r) and g["patch"] == r["patch"]
        for k in ("teacher20_mae", "student1_mae"):
            assert abs(g[k] - r[k]) <= 1e-4, (k, g, r)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
