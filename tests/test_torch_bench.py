"""The port's bench (``python -m s1s2_torch.bench``) on the CPU at a small
size, through the functions of its three lines: bench.py's metric names, the
skip line of an absent headline rung and the fallback to the next one, and
that a CPU run reports no device time."""

import json
import shutil

import numpy as np
import pytest
import torch

from s1s2_torch import bench, headline
from s1s2_torch.core import random
from s1s2_torch.headline import CKPT_DIR, EXPECT_MAE
from s1s2_torch.models.unet import init_params
from s1s2_torch.ops.conv3x3 import conv3x3_relu, conv3x3_relu_int8


def _small_lines(emit):
    """bench.main's three lines at base 8, 32² (lines 1-2) and on 4 evidence
    files of 64² (the headline), on the CPU; skip lines go to ``emit``."""
    state = init_params(4, 8, 1, seed=bench.SEED)
    small = dict(size=32, base_ch=8, device="cpu")
    return [bench.bench_bf16_ddim(state, batch=2, steps=3, **small),
            bench.bench_int8_dpm(state, batch=8, **small),
            bench.bench_headline("cpu", n_files=4, size=64, emit=emit)]


def test_bench_prints_the_three_lines_of_bench_py():
    n = (conv3x3_relu.launches, conv3x3_relu_int8.launches)
    skipped = []
    out = _small_lines(skipped.append)
    assert skipped == []
    assert out == json.loads(json.dumps(out))  # each line prints as JSON
    assert [o["metric"] for o in out] == [
        "patches_per_sec_per_chip_50step_ddim_256px_bf16",
        "patches_per_sec_per_chip_dpm2m5_int8_at_ddim20_quality_256px",
        "patches_per_sec_per_chip_distill1_w24x4_int8_at_ddim20_quality_256px"]
    for o in out:
        assert o["unit"] == "patches/s" and o["device"] == "cpu"
        assert o["value"] is None  # no device time on the CPU
        assert "vs_baseline" not in o
    line1, line2, head = out
    assert line1["shape"] == [2, 32, 32, 4] and line1["finite"] and line1["steps"] == 3
    assert line2["shape"] == [8, 32, 32, 4] and line2["finite"]
    assert line2["grid"] == [0, 50, 100, 150, 200]
    assert head["quality_checked"] and head["expect_mae"] == EXPECT_MAE["24x4"]
    assert (conv3x3_relu.launches, conv3x3_relu_int8.launches) == n


def test_absent_rung_prints_a_skip_line_and_falls_back(tmp_path, monkeypatch):
    shutil.copy(CKPT_DIR / "distill_eps_student16x2.bf16.msgpack", tmp_path)
    monkeypatch.setattr(headline, "CKPT_DIR", tmp_path)
    skip = []
    head = bench.bench_headline("cpu", n_files=4, size=64, emit=skip.append)
    assert skip == [{"skipped": "w24x4", "reason": "checkpoint absent: "
                     + str(tmp_path / "distill_eps_student24x4.bf16.msgpack")}]
    assert head["metric"] == "patches_per_sec_per_chip_distill1_w16x2_int8_at_ddim20_quality_256px"
    assert head["expect_mae"] == 0.33557
    assert abs(head["verified_mae"] - 0.33557) < 0.02


def test_no_checkpoint_at_all_skips_every_rung(tmp_path, monkeypatch):
    monkeypatch.setattr(headline, "CKPT_DIR", tmp_path)
    lines = []
    assert bench.bench_headline("cpu", 2, 32, lines.append) is None
    assert [o["skipped"] for o in lines] == ["w24x4", "w16x2", "w12", "w1"]


def test_bench_data_is_seeded():
    c1, g1 = bench.data(2, 3, 8, "cpu")
    c2, g2 = bench.data(2, 3, 8, "cpu")
    assert torch.equal(c1, c2) and torch.equal(g1, g2)
    assert float(g1.min()) >= 0.0 and float(g1.max()) < 1.0
    np.testing.assert_array_equal(c1.numpy(), random.normal(random.PRNGKey(3), (2, 8, 8, 4)))
    np.testing.assert_array_equal(g1.numpy(), random.uniform(random.PRNGKey(4), (2, 8, 8, 4)))


@pytest.mark.parametrize("spec,expect", [("16x2", 0.33557), ("12", 0.34379)])
def test_headline_knows_the_fallback_rungs(spec, expect):
    assert EXPECT_MAE[spec] == expect
    assert (CKPT_DIR / f"distill_eps_student{spec}.bf16.msgpack").is_file()


def test_base96_state_is_the_full_width_unet_of_lines_1_and_2():
    """The one state lines 1-2, chip_smoke.py and trace_headline share: base
    96 at full resolution (inc 9→96, 768→768 at the bottom), ≈17M
    parameters, the same from the same seed."""
    state = bench.base96_state()
    assert tuple(state["inc.kernel"].shape) == (3, 3, 9, 96)
    assert tuple(state["down3.conv2.kernel"].shape) == (3, 3, 768, 768)
    assert 16.5e6 < sum(v.numel() for v in state.values()) < 17.5e6
    assert torch.equal(state["inc.kernel"], bench.base96_state()["inc.kernel"])
    assert (bench.LINE1_BATCH, bench.LINE2_BATCH) == (128, 64)


def test_cfg_line_at_a_small_size():
    """bench.py's guided-generation line at base 8 (the harness's "@random"
    init), 32², files 2-4 of a 6-file rich set, B=2, on the CPU: bench.py's
    keys, its quality check and no device time."""
    n = (conv3x3_relu.launches, conv3x3_relu_int8.launches)
    line = bench.bench_cfg(ckpt="@random", batch=2, iters=1, size=32, base_ch=8,
                           cfg_set=(6, 2, 5), device="cpu")
    assert line == json.loads(json.dumps(line))
    assert line["metric"] == "patches_per_sec_per_chip_cfg_g3_5step_int8_quality_equal_256px"
    for k in ("bf16_patches_per_s", "int8_speedup_vs_bf16", "verified_mae_bf16",
              "verified_mae_int8", "quality_checked"):
        assert k in line
    assert line["value"] is None and line["bf16_patches_per_s"] is None
    assert line["quality_checked"] == (line["verified_mae_int8"]
                                       <= line["verified_mae_bf16"] + 0.002)
    assert 0.0 < line["verified_mae_bf16"] < 1.0 and 0.0 < line["verified_mae_int8"] < 1.0
    assert (line["committed_anchor_bf16"], line["committed_anchor_int8"]) == (0.29821, 0.29791)
    assert line["shape"] == [2, 32, 32, 4] and line["finite"] and line["device"] == "cpu"
    assert (conv3x3_relu.launches, conv3x3_relu_int8.launches) == n


def test_cfg_samplers_calibrate_per_channel_with_conv1_in_bf16():
    calls = bench.make_cfg_samplers(bench.cfg_state("@random", 8), batch=2, size=32, base_ch=8,
                                    device="cpu")
    qp = calls["qp"]
    assert qp.act_perchannel and len(qp.w8) == 10
    assert not any(k.startswith("conv1.") for k in qp.w8)
    for mode in ("bf16", "int8"):
        out = calls[mode]()
        assert tuple(out.shape) == (2, 32, 32, 4) and bool(torch.isfinite(out).all())


def test_width_ladder_lines_at_a_small_size():
    """One line a rung of bench.py's WIDTHS, in its order, each checked
    against its committed evidence MAE (2 evidence files of 64², B=2)."""
    lines = bench.bench_widths("cpu", n_files=2, size=64, batch=2, emit=lambda _: None)
    specs = [s for s, _, _ in bench.WIDTHS]
    assert specs == ["64", "48", "32", "24", "16", "12", "48x4", "16x2"]
    assert [ln["metric"] for ln in lines] == [
        f"patches_per_sec_per_chip_distill1_w{s}_int8_at_ddim20_quality_256px" for s in specs]
    for spec, ln in zip(specs, lines):
        assert ln["expect_mae"] == EXPECT_MAE[spec] and ln["value"] is None
        assert ln["quality_checked"], ln


def test_width_ladder_expected_maes_are_bench_pys():
    assert {s: EXPECT_MAE[s] for s, _, _ in bench.WIDTHS} == {
        "64": 0.34812, "48": 0.35026, "32": 0.34052, "24": 0.34453, "16": 0.34008,
        "12": 0.34379, "48x4": 0.33002, "16x2": 0.33557}
    assert [b for _, b, _ in bench.WIDTHS] == [64, 128, 128, 256, 128, 128, 128, 128]


@pytest.mark.parametrize("cfg,widths", [(False, False), (True, False), (False, True),
                                        (True, True)])
def test_main_prints_bench_pys_lines_in_its_order(monkeypatch, capsys, cfg, widths):
    """Lines 1-2, then the CFG line (S1S2_BENCH_CFG), then the ladder
    (S1S2_BENCH_WIDTHS), the headline last; each line function stubbed."""
    monkeypatch.setattr(bench, "_device", lambda d: torch.device("cpu"))
    monkeypatch.setattr(bench, "base96_state", lambda: {})
    monkeypatch.setattr(bench, "bench_bf16_ddim", lambda *a, **k: {"metric": bench.LINE1})
    monkeypatch.setattr(bench, "bench_int8_dpm", lambda *a, **k: {"metric": bench.LINE2})
    monkeypatch.setattr(bench, "bench_cfg", lambda *a, **k: {"metric": bench.CFG_LINE})
    monkeypatch.setattr(bench, "run_headline", lambda spec, **k: {
        "patches_per_s": None, "quality_checked": True, "mae": EXPECT_MAE[spec],
        "device": "cpu"})
    for name, on in (("S1S2_BENCH_CFG", cfg), ("S1S2_BENCH_WIDTHS", widths)):
        if on:
            monkeypatch.setenv(name, "1")
        else:
            monkeypatch.delenv(name, raising=False)
    lines = bench.main([])
    want = [bench.LINE1, bench.LINE2] + ([bench.CFG_LINE] if cfg else []) + (
        [bench.HEADLINE.format(s) for s, _, _ in bench.WIDTHS] if widths else []) + [
        bench.HEADLINE.format("24x4")]
    assert [ln["metric"] for ln in lines] == want
    printed = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert [p["metric"] for p in printed] == want


def test_cfg_line_skips_without_its_checkpoint(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(headline, "CKPT_DIR", tmp_path)
    monkeypatch.setattr(bench, "_device", lambda d: torch.device("cpu"))
    for name in ("base96_state", "bench_bf16_ddim", "bench_int8_dpm"):
        monkeypatch.setattr(bench, name, lambda *a, **k: {"metric": name})
    monkeypatch.setenv("S1S2_BENCH_CFG", "1")
    monkeypatch.delenv("S1S2_BENCH_WIDTHS", raising=False)
    lines = bench.main([])
    assert lines[2] == {"skipped": "cfg", "reason": "checkpoint absent: "
                        + str(tmp_path / "cfg_v_teacher.bf16.msgpack")}
