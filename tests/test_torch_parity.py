"""s1s2_torch's parity tools against the JAX package's: the torch twin's
state-dict layout, ``validate_pth_parity`` on both committed reference nets
(the JAX f32 rule ``max_abs < 1e-3``, and the report within 1e-5 of the JAX
one's), the bf16 rule on the CPU's plain path, a planted wrong conversion
failing in either dtype, ``run_full_parity`` on a twin
fixture against the JAX driver's report (each row's actual within 1e-4
relative: f32 on both sides, sums in other orders), and the
``validate_parity`` CLI in both modes."""

import json
import os

import numpy as np
import pytest
import torch

from s1s2.data.synthetic import make_synthetic_patches
from s1s2.eval import parity as jparity
from s1s2.models import torch_twin as jtwin
from s1s2_torch.cli import validate_parity as tcli
from s1s2_torch.eval import parity as tparity
from s1s2_torch.models import torch_twin as ttwin

torch.set_num_threads(1)

REF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples",
                   "ref_crossval")
NETS = ("ref_eps_model.pth", "ref_v_model.pth")
# tiny overrides of every table (as tests/test_parity_driver.py runs them)
TINY = {
    "ddim_eps": {"config": {"t_start": 10, "ddim_steps": 2}},
    "sweep_eps": {"config": {"t_start_grid": (10, 5), "ddim_steps_grid": (2, 3), "max_files": 4},
                  "expect": {"10,2": 0.1, "10,3": 0.1, "5,2": 0.1, "5,3": 0.1}},
    "true_infer_eps": {"config": {"t_start": 19, "ddim_steps": 3, "n_seeds": 2,
                                  "max_files": 2}},
}
KW = dict(rel_tol=0.02, batch_size=2, T=20, base_ch=4)


def test_twin_state_dict_layout_equals_jax_twin():
    for args in ((8, 4, 16), (6, 3, 4)):
        j = jtwin.build_torch_unet(*args).state_dict()
        t = ttwin.build_torch_unet(*args).state_dict()
        assert list(t) == list(j)
        assert [tuple(v.shape) for v in t.values()] == [tuple(v.shape) for v in j.values()]


@pytest.mark.parametrize("net", NETS)
def test_validate_pth_parity_against_jax(net):
    path = os.path.join(REF, net)
    ref = jtwin.validate_pth_parity(path)
    got = ttwin.validate_pth_parity(path, device="cpu")
    assert got["compute_dtype"] == "float32" and got["rule"] == "max_abs < 0.001"
    assert got["max_abs"] < 1e-3 and got["pass"]
    for k, v in ref.items():
        assert abs(got[k] - v) <= 1e-5, (k, got[k], v)


def test_bf16_rule_on_the_cpu_plain_path():
    """bf16 is as far from f32 as its rounding puts it (more than 1.5% on the
    ε net). On the CPU the bf16 run is the plain path itself, so its rule is
    the converter's: the port's f32 forward within JAX's ``max_abs < 1e-3``
    of the twin; the kernel's part (``rel`` within twice the CPU plain
    path's) applies only on the card."""
    got = ttwin.validate_pth_parity(os.path.join(REF, NETS[0]), device="cpu",
                                    compute_dtype="bfloat16")
    f32 = ttwin.validate_pth_parity(os.path.join(REF, NETS[0]), device="cpu")
    assert got["rule"] == "f32_max_abs < 0.001" and got["pass"]
    assert "cpu_bf16_rel" not in got and 0.005 < got["rel"] < 0.03
    assert got["f32_max_abs"] == f32["max_abs"] < 1e-3
    assert not ttwin.passes({**got, "f32_max_abs": 1e-3})
    card = {**got, "cpu_bf16_rel": got["rel"]}
    assert ttwin.passes(card) and not ttwin.passes({**card, "rel": 2.01 * got["rel"]})


def _transposed_inc(convert):
    """``convert`` with the stem's 3x3 kernel transposed in space: a wrong
    conversion that keeps every shape."""
    def wrong(sd):
        out = convert(sd)
        k = out["params"]["inc"]["kernel"]
        out["params"]["inc"]["kernel"] = np.ascontiguousarray(k.transpose(1, 0, 2, 3))
        return out
    return wrong


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_wrong_conversion_fails(monkeypatch, dtype):
    """A converter that transposes the stem's kernel fails the check in
    either dtype (bf16 through the converter's f32 check on the CPU)."""
    from s1s2_torch.models import convert

    monkeypatch.setattr(convert, "torch_state_dict_to_params",
                        _transposed_inc(convert.torch_state_dict_to_params))
    got = ttwin.validate_pth_parity(os.path.join(REF, NETS[0]), device="cpu",
                                    compute_dtype=dtype)
    assert not got["pass"], got
    assert got["f32_max_abs" if dtype == "bfloat16" else "max_abs"] > 1e-3


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    d = tmp_path_factory.mktemp("parity")
    make_synthetic_patches(str(d / "patches"), n=4, size=16, seed=11)
    torch.manual_seed(5)
    torch.save(ttwin.build_torch_unet(8, 4, 4).state_dict(), str(d / "eps_family.pth"))
    return d


def _txt_cells(path):
    with open(path) as f:
        return [ln.split() for ln in f.read().splitlines()]


def test_run_full_parity_against_jax(fixture):
    pth, patches = str(fixture / "eps_family.pth"), str(fixture / "patches")
    ref = jparity.run_full_parity(patches, str(fixture / "jax"), {"eps": pth}, expected=TINY,
                                  **KW)
    got = tparity.run_full_parity(patches, str(fixture / "port"), {"eps": pth}, expected=TINY,
                                  device="cpu", **KW)
    assert list(got) == list(ref)
    for k in ("rel_tol", "tables_ran", "tables_skipped_no_ckpt", "n_pass", "n_fail", "all_pass"):
        assert got[k] == ref[k], k
    assert len(got["rows"]) == len(ref["rows"]) == 2 + 4 + 5
    for g, r in zip(got["rows"], ref["rows"]):
        assert list(g) == list(r)
        assert (g["table"], g["key"], g["expected"], g["ok"]) == (r["table"], r["key"],
                                                                  r["expected"], r["ok"])
        assert g["actual"] == pytest.approx(r["actual"], rel=1e-4, abs=1e-7), g
    with open(fixture / "port" / "parity_report.json") as f:
        assert json.load(f) == json.loads(json.dumps(got))
    jt, tt = (_txt_cells(fixture / w / "parity_report.txt") for w in ("jax", "port"))
    assert [[c for i, c in enumerate(row) if i not in (3, 4)] for row in tt] == \
        [[c for i, c in enumerate(row) if i not in (3, 4)] for row in jt]
    # a table whose family is not supplied is skipped
    none = tparity.run_full_parity(patches, str(fixture / "none"), {}, expected=TINY,
                                   device="cpu", **KW)
    assert none["tables_ran"] == [] and not none["all_pass"]
    assert set(none["tables_skipped_no_ckpt"]) == set(TINY)


def test_cli_both_modes(fixture, tmp_path, capsys):
    rep = tcli.main(["--pth", os.path.join(REF, NETS[1]), "--device", "cpu", "--image_size",
                     "32"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rep
    assert rep["pass"] and rep["base_ch"] == 16.0
    exp = tmp_path / "expected.json"
    exp.write_text(json.dumps({"ddim_eps": {"config": {"t_start": 10, "ddim_steps": 2},
                                            "expect": {"MAE_mean": 0.5}}}))
    out = tcli.main(["--full", "--patch_dir", str(fixture / "patches"), "--out_dir",
                     str(tmp_path / "o"), "--eps_ckpt", str(fixture / "eps_family.pth"),
                     "--expected", str(exp), "--batch_size", "2", "--T", "20", "--base_ch", "4",
                     "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == ["tables_ran", "tables_skipped_no_ckpt", "n_pass", "n_fail", "all_pass"]
    assert line["tables_ran"] == ["ddim_eps", "sweep_eps", "true_infer_eps"]
    assert out["rows"][0]["expected"] == 0.5
    assert (tmp_path / "o" / "parity_report.json").is_file()
    assert (tmp_path / "o" / "parity_report.txt").is_file()
    assert np.isfinite([r["actual"] for r in out["rows"]]).all()
