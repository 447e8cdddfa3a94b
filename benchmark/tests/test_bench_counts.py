"""The yardstick's counts and weights against the program's own tools,
which they were copied from."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness import counts, weights  # noqa: E402
from benchmark.harness.traffic import plugin  # noqa: E402

BF16, INT8 = (plugin("denoisers", d).MODES for d in ("bf16", "int8"))


@pytest.mark.parametrize("base,stem,batch", [(96, 1, 64), (24, 4, 128), (8, 1, 2)])
def test_ops_and_bf16_bytes_match_roofline_tool(base, stem, batch):
    from s1s2_torch.tools.roofline import forward_counts

    ref = forward_counts(base, stem, 256, batch)
    layers = counts.layers(base, stem, 8, 4, 256, batch, BF16)
    assert sum(x["ops"] for x in layers) == ref["ops"]
    assert sum(x["ops"] for x in layers if x["kind"] == "conv3x3") == ref["convs"]
    f32_io = 4.0 * 256 * 256 * (8 + 4) * batch  # the tool also counts the net's f32 input and output
    assert sum(x["bytes"] for x in layers) + f32_io == pytest.approx(ref["bytes"], rel=1e-12)
    # the precision changes where work is counted, never how much
    int8 = counts.layers(base, stem, 8, 4, 256, batch, INT8)
    assert sum(x["ops"] for x in int8) == ref["ops"]


@pytest.mark.parametrize("base,stem,batch", [(96, 1, 64), (24, 4, 128)])
def test_int8_conv_bounds_match_bench_conv(base, stem, batch):
    from s1s2_torch.tools.bench_conv import conv_bound_ms, model_convs

    ours = {x["name"]: x for x in counts.layers(base, stem, 8, 4, 256, batch, INT8)}
    for name, H, ci, co, mode in model_convs(base, stem, 8, 256):
        ms, _ = conv_bound_ms(mode, batch, H, ci, co)
        assert ours[name]["mode"] == mode
        if mode == "int8":
            assert 1e3 * counts.least_seconds(ours[name]) == pytest.approx(ms, rel=1e-12)


def test_checkpoint_reader_matches_program_reader():
    from s1s2_torch.models.weights import params_from_numpy
    from s1s2_torch.train.checkpoint import load_params

    path = ROOT / "examples" / "checkpoints" / "distill_eps_student24x4.bf16.msgpack"
    ours = weights.read_checkpoint(str(path), "cpu")
    theirs = params_from_numpy(load_params(str(path)))
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k
    assert sorted(n for n, _ in weights.unet_shapes(24, 4, 8, 4)) == sorted(ours)


def test_init_is_flax_default_in_distribution_and_fixed_by_the_seed():
    from s1s2_torch.models.unet import UNetSmall

    a = weights.init(16, 1, 8, 4, 2 ** 31 + 5, "cpu")
    b = weights.init(16, 1, 8, 4, 2 ** 31 + 5, "cpu")
    c = weights.init(16, 1, 8, 4, 2 ** 31 + 6, "cpu")
    shapes = {k: tuple(v.shape) for k, v in UNetSmall(4, 16, 1, 8).state_dict().items()}
    assert {k: tuple(v.shape) for k, v in a.items()} == shapes
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["down1.conv1.kernel"], c["down1.conv1.kernel"])
    k = a["down2.conv1.kernel"]
    std = (1.0 / (9 * k.shape[2])) ** 0.5
    assert k.abs().max() <= 2 * std / 0.87962566103423978 + 1e-6
    assert k.std().item() == pytest.approx(std, rel=0.05)
    assert all(float(a[n].abs().max()) == 0.0 for n in a if n.endswith(".bias"))
