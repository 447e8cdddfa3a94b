"""The stem pack (``s1s2_torch/ops/stem_pack.py``): the inference stem's
padded bf16 input, bit-equal to the composition ``models/unet.input_map``
ran before it (a frozen copy below) on the CPU, in the pair and the
one-tensor form; the int8 forward with cond apart bit-equal to the
concatenated call; and, on the card, the kernel against the plain version
at the cells' shapes. The file imports neither JAX nor the JAX package, so
its card cases run on the card's machine:

    python -m pytest --noconftest tests/test_torch_stem_pack.py -q -m gpu
"""

import numpy as np
import pytest
import torch

from s1s2_torch.core.schedule import Schedule
from s1s2_torch.models.quant import (make_quant_denoise_fn, make_sampler_calib, quant_apply,
                                     quantize_unet)
from s1s2_torch.models.unet import init_params, input_map
from s1s2_torch.ops import stem_pack as sp
from s1s2_torch.ops.pixel_shuffle import space_to_depth
from s1s2_torch.sampling.samplers import ddim_anchored

T_VALUES = (0, 1, 200, 257, 999)  # bf16 keeps t exact up to 256: 257 → 256, 999 → 1000


def composed(x_and_cond, t_idx, s, dtype, pad):
    """The stem's input as ``input_map`` composed it before the stem pack."""
    xf = x_and_cond.float()
    if s > 1:
        xf = space_to_depth(xf, s)
    B, H, W, C = xf.shape
    parts = [xf, t_idx.float().reshape(B, 1, 1, 1).expand(B, H, W, 1)]
    extra = -(C + 1) % 8
    if pad and extra:
        parts.append(xf.new_zeros((1, 1, 1, 1)).expand(B, H, W, extra))
    return torch.cat(parts, dim=-1).to(dtype).contiguous()


def _inputs(B, S, cx, cc, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = 3 * torch.randn((B, S, S, cx), generator=g)
    cond = torch.randn((B, S, S, cc), generator=g)
    return x, cond


@pytest.mark.parametrize("s", [1, 2, 4])
@pytest.mark.parametrize("form", ["pair", "one"])
def test_plain_version_is_bit_equal_to_the_composition(s, form):
    x, cond = _inputs(len(T_VALUES), 16, 4, 4)
    t = torch.tensor(T_VALUES, dtype=torch.int32)
    want = composed(torch.cat([x, cond], dim=-1), t, s, torch.bfloat16, True)
    if form == "pair":
        got = sp.stem_pack(x, cond, t, s)
        via_map = input_map(x, t, s, torch.bfloat16, pad=True, cond=cond)
    else:
        got = sp.stem_pack(torch.cat([x, cond], dim=-1), None, t, s)
        via_map = input_map(torch.cat([x, cond], dim=-1), t, s, torch.bfloat16, pad=True)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert got.shape == (5, 16 // s, 16 // s, sp.stem_channels(8, s))
    assert torch.equal(got, want) and torch.equal(via_map, want)
    C = 8 * s * s
    assert got[..., C].float()[:, 0, 0].tolist() == [0.0, 1.0, 200.0, 256.0, 1000.0]
    assert not got[..., C + 1:].float().any()


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float32])
@pytest.mark.parametrize("cx,cc,s,B", [(4, 4, 4, 3), (3, 2, 2, 1), (8, 0, 1, 3), (5, 4, 1, 2)])
def test_plain_version_at_other_channel_counts_and_t_dtypes(cx, cc, s, B, dtype):
    x, cond = _inputs(B, 8, cx, cc, seed=cx * 10 + cc)
    t = torch.tensor(T_VALUES[-B:], dtype=dtype)
    got = sp.stem_pack(x, cond if cc else None, t, s)
    assert torch.equal(got, composed(torch.cat([x, cond], dim=-1), t, s, torch.bfloat16, True))
    assert got.shape[-1] == sp.stem_channels(cx + cc, s) and got.shape[-1] % 8 == 0


@pytest.mark.parametrize("dtype,pad", [(torch.float32, False), (torch.bfloat16, False),
                                       (torch.float32, True)])
def test_other_stems_keep_the_composition(dtype, pad):
    """The training path (no pad) and the f32 parity mode: input_map's
    composition, with cond apart or not."""
    x, cond = _inputs(3, 8, 4, 4)
    t = torch.tensor([5, 600, 999], dtype=torch.int32)
    want = composed(torch.cat([x, cond], dim=-1), t, 2, dtype, pad)
    assert torch.equal(input_map(x, t, 2, dtype, pad=pad, cond=cond), want)
    assert torch.equal(input_map(torch.cat([x, cond], dim=-1), t, 2, dtype, pad=pad), want)


def test_shapes_it_cannot_take_raise():
    x, cond = _inputs(2, 8, 4, 4)
    t = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="divisible"):
        sp.stem_pack(x, cond, t, 3)
    with pytest.raises(ValueError, match="does not match"):
        sp.stem_pack(x, cond[:1], t, 2)
    with pytest.raises(ValueError, match="t_idx holds 1"):
        sp.stem_pack(x, cond, t[:1], 2)


def _int8_model(stem, base=8, B=2, S=32, device="cpu", tvals=(200, 20)):
    g = torch.Generator(device=device).manual_seed(0)
    gt = torch.rand((B, S, S, 4), generator=g, device=device)
    cond = torch.randn((B, S, S, 4), generator=g, device=device)
    schedule = Schedule.cosine(1000)
    params = {k: v.to(device) for k, v in init_params(4, base, stem, seed=0).items()}
    calib = make_sampler_calib(gt, cond, schedule.alpha_bar_np(), tvals, n=B,
                               noises=[torch.randn(gt.shape, generator=g, device=device)
                                       for _ in tvals])
    return quantize_unet(params, calib, base_ch=base, stem_s2d=stem), gt, cond, schedule


@pytest.mark.parametrize("stem", [1, 4])
def test_int8_forward_with_cond_apart_equals_the_concatenated_call(stem):
    qp, gt, cond, schedule = _int8_model(stem)
    x_t = torch.randn(gt.shape, generator=torch.Generator().manual_seed(1))
    t = torch.tensor([200, 999], dtype=torch.int32)
    want = quant_apply(qp, torch.cat([x_t, cond], dim=-1), t)
    assert torch.equal(quant_apply(qp, x_t, t, cond=cond), want)
    assert torch.equal(make_quant_denoise_fn(qp, cond)(x_t, t), want)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the stem pack kernel has no CPU mode)")
    return torch.device("cuda")


def _card_inputs(cuda, B, S, cx, cc, dtype=torch.int32):
    g = torch.Generator(device=cuda).manual_seed(B * 1000 + S + cx)
    x = 3 * torch.randn((B, S, S, cx), generator=g, device=cuda)
    cond = torch.randn((B, S, S, cc), generator=g, device=cuda) if cc else None
    t = torch.tensor(np.resize(T_VALUES, B), dtype=dtype, device=cuda)
    return x, cond, t


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,cx,cc,s", [(128, 256, 4, 4, 4), (64, 256, 8, 0, 1),
                                         (5, 64, 4, 4, 2), (3, 32, 3, 2, 2), (2, 16, 5, 4, 1)])
def test_gpu_kernel_is_bit_equal_to_the_plain_version(cuda, B, S, cx, cc, s):
    """The cells' shapes (the 24x4's pair at the 4× stem; base-96's
    concatenated input), then smaller ones and channel counts off the
    16-byte path."""
    for dtype in (torch.int32, torch.int64, torch.float32):
        x, cond, t = _card_inputs(cuda, B, S, cx, cc, dtype)
        n = sp.stem_pack.launches
        got = sp.stem_pack(x, cond, t, s)
        want = sp.stem_pack_plain(x, cond, t, s)
        torch.cuda.synchronize()
        assert sp.stem_pack.launches == n + 1
        assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.gpu
def test_gpu_wrong_dtype_or_shape_raises(cuda):
    x, cond, t = _card_inputs(cuda, 2, 16, 4, 4)
    with pytest.raises(TypeError, match="x: expected"):
        sp.stem_pack(x.to(torch.bfloat16), cond, t, 4)
    with pytest.raises(TypeError, match="cond: expected"):
        sp.stem_pack(x, cond.transpose(1, 2), t, 4)  # not contiguous
    with pytest.raises(TypeError, match="t_idx: expected"):
        sp.stem_pack(x, cond, t.to(torch.int16), 4)
    with pytest.raises(TypeError, match="t_idx: expected"):
        sp.stem_pack(x, cond, t.cpu(), 4)
    with pytest.raises(ValueError, match="divisible"):
        sp.stem_pack(x, cond, t, 3)
    with pytest.raises(ValueError, match="does not match"):
        sp.stem_pack(x, cond[:1], t, 4)


@pytest.mark.gpu
def test_gpu_one_launch_a_forward_of_the_int8_sampler(cuda):
    qp, gt, cond, schedule = _int8_model(4, base=24, S=64, device=cuda)
    fn = make_quant_denoise_fn(qp, cond)
    for steps in (1, 3):
        n = sp.stem_pack.launches
        ddim_anchored(fn, gt, schedule, 200, steps, generator=torch.Generator(
            device=cuda).manual_seed(steps))
        torch.cuda.synchronize()
        assert sp.stem_pack.launches == n + steps
