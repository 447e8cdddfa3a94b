"""The op-by-op check that ``chip_smoke.py`` puts between the card's int8
forward and the CPU plain path, run here with both sides on the CPU: the
recorder sees every op of the forward and leaves the quant module as it
found it, equal ops pass, and an op that departs from its plain version by
more than its stated bound fails with its name."""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from s1s2_torch.models import quant
from s1s2_torch.models.unet import init_params

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def _forward(quant_up=False):
    """A calibrated base-8 int8 model (with ``quant_up``, its up-convs in int8
    too), one 16² input, its ε̂ and its ops."""
    state = init_params(4, 8, 1, seed=0)
    rng = np.random.default_rng(0)
    cond, gt = (torch.from_numpy(rng.random((2, 16, 16, 4), dtype=np.float32)) for _ in "ab")
    cal = quant.make_sampler_calib(gt, cond, np.linspace(0.99, 0.01, 1000).astype(np.float32),
                                   (500,))
    qp = quant.quantize_unet(state, cal, base_ch=8, quant_up=quant_up)
    x = torch.from_numpy(rng.random((1, 16, 16, 8), dtype=np.float32))
    t = torch.tensor([200], dtype=torch.int32)
    eps, calls = chip_smoke.record_ops(quant, qp, x, t)
    return qp, x, t, eps, calls


def test_record_ops_sees_every_op_of_the_int8_forward():
    before = {name: getattr(quant, name) for name in chip_smoke.QUANT_OPS}
    qp, x, t, eps, calls = _forward()
    assert torch.equal(eps, quant.quant_apply(qp, x, t))
    names = [c[0] for c in calls]
    assert len(names) == 21 and names.count("conv3x3_relu_int8") == 12
    assert names.count("max_pool2") == 3 and names.count("ps_conv_transpose_2x2") == 3
    assert names[:2] == ["input_map", "conv3x3_relu"] and names[-1] == "conv1x1"
    assert all(getattr(quant, name) is fn for name, fn in before.items())


def test_check_ops_passes_equal_ops():
    calls = _forward()[-1]
    rows = chip_smoke.check_ops(torch, F, quant, "cpu", calls)
    assert [r[0] for r in rows] == [c[0] for c in calls]
    assert all(r[1] == 0 and r[2] == 0.0 for r in rows)


def _nudged(calls, name, ulps):
    """``calls`` with the largest output of the first ``name`` op moved up by
    ``ulps`` bf16 ulps."""
    i = next(i for i, c in enumerate(calls) if c[0] == name)
    op, args, out = calls[i]
    flat = out.clone().reshape(-1)
    j = int(flat.float().abs().argmax())
    v = flat[j].float()
    flat[j] = (v + ulps * chip_smoke.bf16_ulp(torch, v)).to(out.dtype)
    return calls[:i] + [(op, args, flat.reshape(out.shape))] + calls[i + 1:], i


def test_record_ops_sees_the_int8_up_convs_of_quant_up():
    qp, x, t, eps, calls = _forward(quant_up=True)
    names = [c[0] for c in calls]
    assert len(names) == 21 and names.count("ps_conv_transpose_2x2_int8") == 3
    assert "ps_conv_transpose_2x2" not in names
    rows = chip_smoke.check_ops(torch, F, quant, "cpu", calls)
    assert all(r[1] == 0 for r in rows)


@pytest.mark.parametrize("name", ["conv3x3_relu_int8", "max_pool2",
                                  "ps_conv_transpose_2x2_int8", "input_map"])
def test_check_ops_requires_bit_equality_of_int8_convs_and_pools(name):
    calls, i = _nudged(_forward(quant_up=name == "ps_conv_transpose_2x2_int8")[-1], name, 1)
    with pytest.raises(AssertionError, match=f"op {i} {name} "):
        chip_smoke.check_ops(torch, F, quant, "cpu", calls)


@pytest.mark.parametrize("name", ["conv3x3_relu", "ps_conv_transpose_2x2", "conv1x1"])
def test_check_ops_allows_a_bf16_op_one_ulp_and_no_more(name):
    calls, i = _nudged(_forward()[-1], name, 1)
    rows = chip_smoke.check_ops(torch, F, quant, "cpu", calls)
    assert rows[i][1] == 1 and 0.0 < rows[i][3] <= 1.0
    calls, i = _nudged(calls, name, 64)
    with pytest.raises(AssertionError, match=f"op {i} {name} "):
        chip_smoke.check_ops(torch, F, quant, "cpu", calls)


@pytest.mark.parametrize("cx,cc,s", [(4, 4, 4), (8, 0, 1), (3, 2, 2), (5, 4, 1)])
def test_stem_library_yardstick_computes_the_stem_pack(cx, cc, s):
    """The PyTorch composition timed beside the stem pack gives its plain
    version's bits."""
    from s1s2_torch.ops.stem_pack import stem_pack_plain

    g = torch.Generator().manual_seed(cx + cc + s)
    x, cond = torch.randn((3, 16, 16, cx), generator=g), torch.randn((3, 16, 16, cc), generator=g)
    args = (x, cond if cc else None, torch.tensor([0, 257, 999], dtype=torch.int32), s)
    assert torch.equal(chip_smoke.stem_library(torch, *args), stem_pack_plain(*args))


# ``cuobjdump -sass`` text of the kernels as built for sm_90a, cut to the
# instructions the rules of ``chip_smoke.sass_rules`` read (the spellings are
# the card's own: ``HGMMA.64x256x16.F32.BF16``, ``UTMALDG.2D``, ``UBLKCP.S.G``)
_BUILT = {
    "_ZN4conv19conv3x3_bf16_kernelILi24EEEv14CUtensorMap_st": [
        "UTMALDG.4D [UR8], [UR4]", "UTMALDG.3D [UR16], [UR12]", "LDSM.16.M88.4 R4, [R2]",
        "HGMMA.64x24x16.F32.BF16 R24, R4, gdesc[UR4], R24, gsb0"],
    "_ZN4conv19conv3x3_int8_kernelILi128EEEv14CUtensorMap_st": [
        "UTMALDG.4D [UR8], [UR4]", "UTMALDG.3D [UR16], [UR12]", "LDSM.16.M88.4 R4, [R2]",
        "IGMMA.64x128x32.S8.S8 R24, R4, gdesc[UR4], R24, gsb0"],
    "_ZN6matmul13matmul_kernelILi0EEEv14CUtensorMap_st": [
        "UTMALDG.2D [UR8], [UR4]", "HGMMA.64x256x16.F32.BF16 R24, gdesc[UR4], R24, gsb0",
        "STG.E.64 desc[UR4][R2.64], R24"],
    "_ZN6matmul13matmul_kernelILi1EEEv14CUtensorMap_st": [
        "UTMALDG.2D [UR8], [UR4]", "HGMMA.64x256x16.F32.BF16 R24, gdesc[UR4], R24, gsb0",
        "F2FP.BF16.F32.PACK_AB R3, R25, R24"],
    "_ZN6matmul13matmul_kernelILi2EEEv14CUtensorMap_st": [
        "UTMALDG.2D [UR8], [UR4]", "IGMMA.64x256x32.S8.S8 R24, gdesc[UR4], R24, gsb0"],
    "_ZN6matmul19transpose_i8_kernelEPKhPhii": ["LDG.E.128 R4, desc[UR4][R2.64]",
                                                "STG.E.128 desc[UR4][R6.64], R8"],
    "_ZN4halo19halo_rows_x2_kernelEPKfPfixix": [
        "UBLKCP.S.G [UR8], [UR6], UR4", "FMUL R4, R4, 2", "UBLKCP.G.S [UR6], [UR8], UR4"],
}


def _sass(kernels):
    text = "\n\tcode for sm_90a\n"
    for name, instrs in kernels.items():
        text += f"\n\t\tFunction : {name}\n\t.headerflags\t@\"EF_CUDA_SM90\"\n"
        text += "".join(f"        /*{16 * i:04x}*/                   {ins} ;\n"
                        for i, ins in enumerate(instrs))
    return text


def test_sass_rules_pass_the_kernels_as_built():
    counts = chip_smoke.sass_counts(_sass(_BUILT))
    assert set(counts) == set(_BUILT)
    chip_smoke.sass_rules(counts)
    conv = counts["_ZN4conv19conv3x3_int8_kernelILi128EEEv14CUtensorMap_st"]
    assert conv["IGMMA"] == 1 and conv["UTMALDG"] == 2 and conv["IMMA"] == 0
    mm = counts["_ZN6matmul13matmul_kernelILi1EEEv14CUtensorMap_st"]
    assert mm["HGMMA"] == 1 and mm["UTMALDG"] == 1 and mm["HMMA"] == 0
    halo = counts["_ZN4halo19halo_rows_x2_kernelEPKfPfixix"]
    assert halo["UBLKCP.S.G"] == 1 and halo["UBLKCP.G.S"] == 1 and halo["LDG"] == 0
    assert counts["_ZN6matmul19transpose_i8_kernelEPKhPhii"]["LDG"] == 1


@pytest.mark.parametrize("kernel,instrs", [
    # the bf16 matmul back on mma.sync with cp.async
    ("_ZN6matmul13matmul_kernelILi1EEEv14CUtensorMap_st",
     ["LDGSTS.E.BYPASS.128 [R3], desc[UR4][R4.64]", "HMMA.16816.F32.BF16 R8, R4, R6, R8"]),
    # the int8 matmul on wgmma without TMA
    ("_ZN6matmul13matmul_kernelILi2EEEv14CUtensorMap_st",
     ["IGMMA.64x256x32.S8.S8 R24, gdesc[UR4], R24, gsb0"]),
    # the halo load with plain loads and stores
    ("_ZN4halo19halo_rows_x2_kernelEPKfPfixix",
     ["LDG.E.128 R4, desc[UR4][R2.64]", "STG.E.128 desc[UR4][R6.64], R4"]),
    # the halo load with bulk loads but plain stores
    ("_ZN4halo19halo_rows_x2_kernelEPKfPfixix",
     ["UBLKCP.S.G [UR8], [UR6], UR4", "STG.E.128 desc[UR4][R6.64], R4"]),
    # a conv off the tensor cores
    ("_ZN4conv19conv3x3_bf16_kernelILi24EEEv14CUtensorMap_st", ["FFMA R8, R4, R6, R8"]),
    # a conv back on mma.sync with cp.async
    ("_ZN4conv19conv3x3_bf16_kernelILi24EEEv14CUtensorMap_st",
     ["LDGSTS.E.BYPASS.128 [R3], desc[UR4][R4.64]", "LDSM.16.M88.4 R4, [R2]",
      "HMMA.16816.F32.BF16 R8, R4, R6, R8"]),
    # a conv on wgmma without TMA
    ("_ZN4conv19conv3x3_int8_kernelILi128EEEv14CUtensorMap_st",
     ["LDG.E.128 R4, desc[UR4][R2.64]", "LDSM.16.M88.4 R4, [R2]",
      "IGMMA.64x128x32.S8.S8 R24, R4, gdesc[UR4], R24, gsb0"]),
])
def test_sass_rules_fail_a_kernel_that_fell_back(kernel, instrs):
    with pytest.raises(AssertionError, match=re.escape(kernel)):
        chip_smoke.sass_rules(chip_smoke.sass_counts(_sass({**_BUILT, kernel: instrs})))


def test_sass_rules_fail_a_missing_kernel():
    built = {k: v for k, v in _BUILT.items() if "halo" not in k}
    with pytest.raises(AssertionError, match="no halo_rows_x2_kernel"):
        chip_smoke.sass_rules(chip_smoke.sass_counts(_sass(built)))


def test_sass_rules_fail_a_conv_mode_that_fell_back_alone():
    """Each of the conv's instantiations (one per N tile) is held to the
    rules: one on mma.sync among others on wgmma fails."""
    built = {**_BUILT, "_ZN4conv19conv3x3_bf16_kernelILi96EEEv14CUtensorMap_st": [
        "LDSM.16.M88.4 R4, [R2]", "HMMA.16816.F32.BF16 R8, R4, R6, R8"]}
    with pytest.raises(AssertionError, match="ILi96E"):
        chip_smoke.sass_rules(chip_smoke.sass_counts(_sass(built)))


def test_ptxas_report_reads_each_kernels_spills():
    lines = ["ptxas info    : Compiling entry function '_ZN4conv19conv3x3_bf16_kernelILi24EEEv"
             "14CUtensorMap_st' for 'sm_90a'",
             "ptxas info    : Function properties for _ZN4conv19conv3x3_bf16_kernelILi24EEEv"
             "14CUtensorMap_st",
             "0 bytes stack frame, 16 bytes spill stores, 16 bytes spill loads",
             "ptxas info    : Used 168 registers, used 1 barriers, 160 bytes smem",
             "ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'",
             "0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads"]
    assert chip_smoke.ptxas_report(lines) == {
        "_ZN4conv19conv3x3_bf16_kernelILi24EEEv14CUtensorMap_st": 16}


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_layout_probe_names_what_a_wrong_layout_reads(monkeypatch, mode):
    """On the CPU the wrappers run their plain versions, so the probe is
    clean; a conv that reads input channel c ^ 8 (a swizzle off by one bit)
    is caught at every lit channel, and the probe names the channel read."""
    from s1s2_torch.ops import conv3x3 as cv

    case = [c for c in chip_smoke.PROBE_CASES if c[0] == mode][0]
    assert chip_smoke.layout_probe(torch, *case, torch.device("cpu"), side=6, batch=1) == []
    name = "conv3x3_relu" if mode == "bf16" else "conv3x3_relu_int8"
    right = getattr(cv, name)

    def wrong(x, w, *args):
        perm = torch.arange(x.shape[-1]) ^ 8
        return right(x[..., perm.clamp(max=x.shape[-1] - 1)].contiguous(), w, *args)

    monkeypatch.setattr(cv, name, wrong)
    _, cin, _, chans = case
    bad = chip_smoke.layout_probe(torch, mode, cin, case[2], chans[:3], torch.device("cpu"),
                                  side=6, batch=1)
    assert [b[:2] for b in bad] == [(t, c) for t in range(9) for c in chans[:3]]
    assert all(f"tap {t} channel {min(c ^ 8, cin - 1)} " in h for t, c, h in bad)
