"""The CUDA kernels of s1s2_torch against their plain PyTorch versions, on
the card. These tests import neither JAX nor the JAX package, so they run on
the card's machine:

    python -m pytest --noconftest tests/test_torch_gpu.py -q -m gpu

Without a card they skip (the kernels have no CPU mode)."""

import importlib.util
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from s1s2_torch.ops.conv3x3 import (conv3x3_relu, conv3x3_relu_int8,
                                    conv3x3_relu_int8_plain, conv3x3_relu_plain)
from s1s2_torch.ops.fused_elementwise import (ddim_coefs, ddim_update_plain,
                                              fused_ddim_update)
from s1s2_torch.ops.halo import halo_rows_x2, halo_rows_x2_plain
from s1s2_torch.ops.matmul import (matmul, matmul_int8_packed, matmul_int8_packed_plain,
                                   matmul_plain, pack_int8_b)
from s1s2_torch.ops.pixel_shuffle import (ps_conv_transpose_2x2_int8,
                                          ps_conv_transpose_2x2_int8_plain, ps_int8_weight)


REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W,Ci,Co", [(2, 64, 64, 129, 24), (3, 17, 9, 5, 40), (1, 8, 8, 192, 192),
                                         (1, 256, 256, 9, 96), (1, 32, 32, 768, 768),
                                         (2, 32, 32, 9, 12), (1, 24, 40, 24, 12)])
def test_gpu_conv_bf16_kernel_matches_plain(cuda, B, H, W, Ci, Co):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((B, H, W, Ci), generator=g, device=cuda).to(torch.bfloat16)
    w = (0.1 * torch.randn((3, 3, Ci, Co), generator=g, device=cuda)).to(torch.bfloat16)
    b = torch.randn((Co,), generator=g, device=cuda)
    # f32 sums in another order: one bf16 ulp of the larger value plus twice
    # the accumulation-order bound n·2^-24·Σ|terms|, n = 9·Ci + 1
    terms = conv3x3_relu_plain(x.float().abs(), w.float().abs(), b.abs(), False)
    bound = 2 * (9 * Ci + 1) * 2.0 ** -24 * terms
    for relu in (True, False):
        got = conv3x3_relu(x, w, b, relu).float()
        ref = conv3x3_relu_plain(x, w, b, relu).float()
        mag = torch.maximum(got.abs(), ref.abs())
        assert bool(((got - ref).abs() <= mag * 2.0 ** -7 + bound).all())


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W,Ci,Co", [(2, 64, 64, 24, 48), (3, 17, 9, 5, 40), (1, 16, 16, 192, 96),
                                         (1, 256, 256, 96, 192), (1, 64, 64, 768, 384),
                                         (2, 32, 32, 12, 12), (1, 8, 8, 200, 70)])
def test_gpu_conv_int8_kernel_bit_equal(cuda, B, H, W, Ci, Co):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((B, H, W, Ci), generator=g, device=cuda).to(torch.bfloat16)
    w8 = torch.randint(-127, 128, (3, 3, Ci, Co), generator=g, device=cuda).to(torch.int8)
    sx = float(x.float().abs().amax()) / 127.0
    deq = torch.rand((Co,), generator=g, device=cuda) * 1e-3
    b = torch.randn((Co,), generator=g, device=cuda)
    for relu in (True, False):
        assert torch.equal(conv3x3_relu_int8(x, w8, sx, deq, b, relu),
                           conv3x3_relu_int8_plain(x, w8, sx, deq, b, relu))


@pytest.mark.gpu
@pytest.mark.parametrize("Ci,Co,HW", chip_smoke.AWKWARD_SHAPES)
def test_gpu_conv_awkward_shapes(cuda, Ci, Co, HW):
    """The stems' and the 12's channel counts (Cin 129, 33, 12, 9; Cout 12
    and 24) on images that are not a tile multiple, B=1: bf16 within
    ``chip_smoke.bf16_tolerance`` (the input also zero-padded to 8 channels,
    as the model writes a stem's: the same bits), int8 bit-equal."""
    g = torch.Generator(device=cuda).manual_seed(Ci * 100 + Co + HW)
    x = torch.randn((1, HW, HW, Ci), generator=g, device=cuda).to(torch.bfloat16)
    w = 0.1 * torch.randn((3, 3, Ci, Co), generator=g, device=cuda)
    b = torch.randn((Co,), generator=g, device=cuda)
    wb = w.to(torch.bfloat16)
    got, ref = conv3x3_relu(x, wb, b), conv3x3_relu_plain(x, wb, b)
    tol = chip_smoke.bf16_tolerance(torch, F, x, wb, b, torch.maximum(got.abs(), ref.abs()), Ci)
    assert bool(((got.float() - ref.float()).abs() <= tol).all())
    xp = F.pad(x, (0, -Ci % 8))
    assert torch.equal(conv3x3_relu(xp, wb, b, padded_input=True), got)
    w8 = torch.randint(-127, 128, (3, 3, Ci, Co), generator=g, device=cuda).to(torch.int8)
    sx = float(x.float().abs().amax()) / 127.0
    deq = torch.rand((Co,), generator=g, device=cuda) * 1e-3
    for relu in (True, False):
        assert torch.equal(conv3x3_relu_int8(x, w8, sx, deq, b, relu),
                           conv3x3_relu_int8_plain(x, w8, sx, deq, b, relu))


@pytest.mark.gpu
def test_gpu_conv_plan_mirror_is_the_c_entrys_plan(cuda):
    """The tile plan the built C entry launches with (``kernel_plan``)
    equals its Python mirror (``conv_plan``, whose legality the CPU tests
    check) at every conv of every model the repo runs, in both modes."""
    n, bad = chip_smoke.conv_plan_mismatches()
    assert n > 0 and bad == []


@pytest.mark.gpu
@pytest.mark.parametrize("mode,Ci,Co,channels", chip_smoke.PROBE_CASES)
def test_gpu_conv_layout_probe(cuda, mode, Ci, Co, channels):
    """One tap and one input channel lit at a time, every product exact and
    alone in its sum: both modes bit-equal to the plain version; a failure
    names the tap and channel the kernel read instead."""
    assert chip_smoke.layout_probe(torch, mode, Ci, Co, channels, cuda) == []


@pytest.mark.gpu
def test_gpu_int8_quantizer_is_the_ieee_division(cuda):
    """Every finite bf16 value through the int8 conv with an identity centre
    tap (y = q exactly), at scales that put quotients within an ulp of a
    half-integer: bit-equal to the plain version's true division."""
    x = (torch.arange(1 << 16, dtype=torch.int32) << 16).view(torch.float32)
    x = x[torch.isfinite(x)].to(torch.bfloat16).reshape(1, 51, 40, 32).to(cuda)
    w8 = torch.zeros((3, 3, 32, 32), dtype=torch.int8, device=cuda)
    w8[1, 1] = torch.eye(32, dtype=torch.int8, device=cuda)
    deq, b = torch.ones(32, device=cuda), torch.zeros(32, device=cuda)
    g = torch.Generator().manual_seed(0)
    xs = x.flatten().float().cpu()
    xs = xs[(xs.abs() > 1e-3) & (xs.abs() < 1e3)]
    for i in range(40):
        x0 = float(xs[int(torch.randint(len(xs), (1,), generator=g))])
        sx = float(torch.tensor(abs(x0) / (int(torch.randint(127, (1,), generator=g)) + 0.5)))
        assert torch.equal(conv3x3_relu_int8(x, w8, sx, deq, b, False),
                           conv3x3_relu_int8_plain(x, w8, sx, deq, b, False)), sx


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W,Ci,Co", [(2, 64, 64, 24, 48), (3, 17, 9, 5, 40),
                                         # the CFG net's int8 convs (Cin 96..768), at B=2
                                         (2, 256, 256, 96, 192), (2, 64, 64, 768, 384),
                                         (1, 8, 8, 200, 70), (2, 32, 32, 12, 12)])
def test_gpu_conv_int8_per_channel_bit_equal(cuda, B, H, W, Ci, Co):
    """One activation scale per input channel, spread over four decades, the
    folded weights' deq = sw alone; pad channels (Ci not a multiple of 32)
    read no scale."""
    g = torch.Generator(device=cuda).manual_seed(0)
    sx = (10.0 ** (4 * torch.rand((Ci,), generator=g, device=cuda) - 3)) / 127.0
    x = ((2 * torch.rand((B, H, W, Ci), generator=g, device=cuda) - 1) * 140 * sx
         ).to(torch.bfloat16)
    w8 = torch.randint(-127, 128, (3, 3, Ci, Co), generator=g, device=cuda).to(torch.int8)
    deq = torch.rand((Co,), generator=g, device=cuda) * 1e-3
    b = torch.randn((Co,), generator=g, device=cuda)
    for relu in (True, False):
        assert torch.equal(conv3x3_relu_int8(x, w8, sx, deq, b, relu),
                           conv3x3_relu_int8_plain(x, w8, sx, deq, b, relu))


@pytest.mark.gpu
def test_gpu_int8_quantizer_per_channel_is_the_ieee_division(cuda):
    """Every finite bf16 value with 32 scales at a time, each putting its
    channel's quotients near a half-integer: bit-equal to the plain
    version's true division per channel."""
    x = (torch.arange(1 << 16, dtype=torch.int32) << 16).view(torch.float32)
    x = x[torch.isfinite(x)].to(torch.bfloat16).reshape(1, 51, 40, 32).to(cuda)
    w8 = torch.zeros((3, 3, 32, 32), dtype=torch.int8, device=cuda)
    w8[1, 1] = torch.eye(32, dtype=torch.int8, device=cuda)
    deq, b = torch.ones(32, device=cuda), torch.zeros(32, device=cuda)
    g = torch.Generator().manual_seed(1)
    xs = x.flatten().float().cpu()
    xs = xs[(xs.abs() > 1e-3) & (xs.abs() < 1e3)]
    for _ in range(10):
        x0 = xs[torch.randint(len(xs), (32,), generator=g)].abs()
        sx = (x0 / (torch.randint(127, (32,), generator=g).float() + 0.5)).to(cuda)
        assert torch.equal(conv3x3_relu_int8(x, w8, sx, deq, b, False),
                           conv3x3_relu_int8_plain(x, w8, sx, deq, b, False))


@pytest.mark.gpu
def test_gpu_int8_per_tensor_scale_as_one_vector_is_the_same_conv(cuda):
    """A per-channel vector of one repeated scale gives the per-tensor result."""
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((2, 32, 32, 40), generator=g, device=cuda).to(torch.bfloat16)
    w8 = torch.randint(-127, 128, (3, 3, 40, 24), generator=g, device=cuda).to(torch.int8)
    sx = float(x.float().abs().amax()) / 127.0
    deq = torch.rand((24,), generator=g, device=cuda) * 1e-3
    b = torch.randn((24,), generator=g, device=cuda)
    vec = torch.full((40,), sx, dtype=torch.float32, device=cuda)
    assert torch.equal(conv3x3_relu_int8(x, w8, vec, deq, b),
                       conv3x3_relu_int8(x, w8, sx, deq, b))


@pytest.mark.gpu
def test_gpu_ddim_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((4, 64, 64, 4), generator=g, device=cuda)
    e = torch.randn((4, 64, 64, 4), generator=g, device=cuda)
    coefs = ddim_coefs(0.25, 0.99)
    for k, p in zip(fused_ddim_update(x, e, *coefs), ddim_update_plain(x, e, *coefs)):
        assert bool(((k - p).abs() <= 1e-6 * p.abs()).all())


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,K", [(128, 128, 64), (256, 384, 512), (512, 512, 512),
                                   # one stage of K; 5 stages (ring of 4); a 128-wide
                                   # last column tile; 8.5 stages; the probe's shape
                                   (256, 128, 640), (128, 384, 192), (384, 640, 1088),
                                   (8192, 2048, 2048)])
def test_gpu_matmul_int8_bit_equal(cuda, M, N, K):
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randint(-128, 128, (M, K), generator=g, device=cuda).to(torch.int8)
    b = torch.randint(-128, 128, (K, N), generator=g, device=cuda).to(torch.int8)
    assert torch.equal(matmul(a, b, torch.int32), matmul_plain(a, b, torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,K", [(128, 128, 32), (256, 384, 512), (512, 512, 2048),
                                   # half a stage of K; 5 stages (ring of 4); a 128-wide
                                   # last column tile; 8.5 stages; the probe's shape
                                   (256, 128, 320), (128, 384, 288), (384, 640, 544),
                                   (8192, 2048, 2048)])
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
def test_gpu_matmul_bf16_matches_plain(cuda, M, N, K, out):
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    b = torch.randn((K, N), generator=g, device=cuda).to(torch.bfloat16)
    got = matmul(a, b, out).float()
    ref = matmul_plain(a, b, torch.float32)
    # f32 sums in another order: K·2^-24·Σ|a·b| (two orders: twice that), and
    # one bf16 ulp of the value when the output is bf16
    terms = matmul_plain(a.abs(), b.abs(), torch.float32)
    tol = 2 * K * 2.0 ** -24 * terms
    if out == torch.bfloat16:
        tol = tol + ref.abs() * 2.0 ** -8
    assert bool(((got - ref).abs() <= tol).all())


@pytest.mark.gpu
@pytest.mark.parametrize("H,W,C,TH", [(256, 128, 128, 32), (66, 16, 8, 16), (37, 5, 4, 7), (3, 2, 4, 32),
                                      # rows of 1188, 3612, 4124 and 7196 floats: column
                                      # chunks (at most 4 KB) that split them raggedly;
                                      # TH above H
                                      (40, 33, 36, 64), (10, 301, 12, 50), (5, 1031, 4, 9),
                                      (19, 7, 1028, 3)])
def test_gpu_halo_writes_every_row(cuda, H, W, C, TH):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((H, W, C), generator=g, device=cuda)
    assert torch.equal(halo_rows_x2(x, TH), halo_rows_x2_plain(x))


@pytest.mark.gpu
def test_gpu_halo_output_does_not_depend_on_th(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((70, 40, 28), generator=g, device=cuda)
    want = halo_rows_x2_plain(x)
    for th in (1, 2, 7, 32, 67, 68, 500):
        assert torch.equal(halo_rows_x2(x, th), want), th


# the base-16 crossval nets at 32² (ref_{eps,v}_model.pth): (H, Cin, Cout)
# of their 13 3x3 convs, down to 8×8 (narrower than the conv's 8×16 pixel
# tile) and Cout 16 and 32 (below its 64-channel tile)
CROSSVAL_CONVS = ((32, 9, 16), (32, 16, 32), (32, 32, 32), (16, 32, 64), (16, 64, 64),
                  (8, 64, 128), (8, 128, 128), (8, 128, 64), (8, 64, 64), (16, 64, 32),
                  (16, 32, 32), (32, 32, 16), (32, 16, 16))


@pytest.mark.gpu
@pytest.mark.parametrize("B", [8, 2, 1])
@pytest.mark.parametrize("H,Ci,Co", CROSSVAL_CONVS)
def test_gpu_conv_both_modes_at_the_crossval_shapes(cuda, B, H, Ci, Co):
    g = torch.Generator(device=cuda).manual_seed(H * 1000 + Ci + Co)
    x = torch.randn((B, H, H, Ci), generator=g, device=cuda).abs_().to(torch.bfloat16)
    w = (0.1 * torch.randn((3, 3, Ci, Co), generator=g, device=cuda)).to(torch.bfloat16)
    b = 0.1 * torch.randn((Co,), generator=g, device=cuda)
    terms = conv3x3_relu_plain(x.float().abs(), w.float().abs(), b.abs(), False)
    bound = 2 * (9 * Ci + 1) * 2.0 ** -24 * terms
    got, ref = conv3x3_relu(x, w, b).float(), conv3x3_relu_plain(x, w, b).float()
    mag = torch.maximum(got.abs(), ref.abs())
    assert bool(((got - ref).abs() <= mag * 2.0 ** -7 + bound).all())
    w8 = torch.randint(-127, 128, (3, 3, Ci, Co), generator=g, device=cuda).to(torch.int8)
    sx = float(x.float().abs().amax()) / 127.0
    deq = torch.rand((Co,), generator=g, device=cuda) * 1e-3
    assert torch.equal(conv3x3_relu_int8(x, w8, sx, deq, b),
                       conv3x3_relu_int8_plain(x, w8, sx, deq, b))


@pytest.mark.gpu
def test_gpu_ddim_kernel_on_a_padded_batch(cuda):
    """The harness's last batch repeats its last file: the update is the
    same on every copy."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((4, 32, 32, 4), generator=g, device=cuda)
    e = torch.randn((4, 32, 32, 4), generator=g, device=cuda)
    x[2:], e[2:] = x[1], e[1]
    coefs = ddim_coefs(0.25, 0.99)
    for k, p in zip(fused_ddim_update(x, e, *coefs), ddim_update_plain(x, e, *coefs)):
        assert bool(((k - p).abs() <= 1e-6 * p.abs()).all())
        assert torch.equal(k[2], k[1]) and torch.equal(k[3], k[1])


# the int8 up-convs (quant_up), (B, H, W, Ci, Co): base-96's up3/up2/up1 at
# B=2 (tile multiples), the w24 student's at B=16 and the 24x4's at B=128
# (K=48 and N=96, N=192: padded), and ragged M
UP_CONVS = ((2, 32, 32, 768, 384), (2, 64, 64, 384, 192), (2, 128, 128, 192, 96),
            (16, 32, 32, 192, 96), (16, 64, 64, 96, 48), (16, 128, 128, 48, 24),
            (128, 8, 8, 192, 96), (128, 16, 16, 96, 48), (128, 32, 32, 48, 24),
            (3, 5, 7, 48, 24))


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W,Ci,Co", UP_CONVS)
def test_gpu_int8_up_conv_bit_equal(cuda, B, H, W, Ci, Co):
    """The padded int8 matmul on the packed up-conv weights: the int32 sums
    and the bf16 output (per tensor and per channel) bit-equal to the plain
    version, and one matmul launch a call."""
    g = torch.Generator(device=cuda).manual_seed(Ci + Co)
    w8 = torch.randint(-127, 128, (2, 2, Ci, Co), generator=g, device=cuda).to(torch.int8)
    wp = ps_int8_weight(w8)
    x8 = torch.randint(-127, 128, (B * H * W, Ci), generator=g, device=cuda).to(torch.int8)
    assert torch.equal(matmul_int8_packed(x8, wp, 4 * Co),
                       matmul_int8_packed_plain(x8, wp, 4 * Co))
    x = torch.randn((B, H, W, Ci), generator=g, device=cuda).to(torch.bfloat16)
    deq = torch.rand((Co,), generator=g, device=cuda) * 1e-3
    b = torch.randn((Co,), generator=g, device=cuda)
    for sx in (torch.tensor(float(x.float().abs().amax()) / 127.0, device=cuda),
               x.float().abs().amax(dim=(0, 1, 2)).clamp_min(1e-6) / 127.0):
        n = matmul.launches
        got = ps_conv_transpose_2x2_int8(x, wp, sx, deq, b)
        assert matmul.launches == n + 1
        assert torch.equal(got, ps_conv_transpose_2x2_int8_plain(x, wp, sx, deq, b))


@pytest.mark.gpu
def test_gpu_quant_up_artifact_loads_on_the_card(cuda, tmp_path):
    """A quant_up artifact read onto the card packs its up-conv weights for
    the matmul and runs each up-conv on it (3 launches a forward)."""
    from s1s2_torch.models.quant import (load_quant, make_sampler_calib, quant_apply,
                                         quantize_unet, save_quant)
    from s1s2_torch.models.unet import init_params

    g = torch.Generator().manual_seed(2)
    gt = torch.rand((2, 32, 32, 4), generator=g)
    qp = quantize_unet(init_params(4, 8, 1, seed=0), make_sampler_calib(
        gt, gt, torch.linspace(0.99, 0.01, 1000).numpy(), (500, 20)), base_ch=8, quant_up=True)
    save_quant(qp, str(tmp_path / "up.int8.msgpack"))
    back = load_quant(str(tmp_path / "up.int8.msgpack"), cuda)
    assert sorted(back.up8) == ["up1", "up2", "up3"] and all(w.is_cuda for w in back.up8.values())
    n = matmul.launches
    y = quant_apply(back, torch.cat([gt, gt], -1).to(cuda), torch.tensor([500, 20], device=cuda))
    assert matmul.launches == n + 3 and y.shape == (2, 32, 32, 4) and bool(torch.isfinite(y).all())


@pytest.mark.gpu
def test_gpu_packed_matmul_skips_the_transpose(cuda):
    """A packed B needs no scratch: the same product as the int8 mode that
    transposes B itself, at a tile-multiple shape."""
    g = torch.Generator(device=cuda).manual_seed(5)
    a = torch.randint(-128, 128, (256, 512), generator=g, device=cuda).to(torch.int8)
    b = torch.randint(-128, 128, (512, 384), generator=g, device=cuda).to(torch.int8)
    assert torch.equal(matmul_int8_packed(a, pack_int8_b(b), 384), matmul(a, b, torch.int32))


def _rel(a, b):
    n = float(b.double().norm())
    return float((a - b).double().norm()) / n if n else float((a - b).double().norm())


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W,Ci,Co", [(2, 64, 64, 9, 96), (1, 32, 32, 384, 192),
                                         (4, 16, 16, 768, 768), (3, 17, 9, 5, 40)])
def test_gpu_train_conv_matches_its_cpu_version(cuda, B, H, W, Ci, Co):
    """The training path's autograd conv (cuDNN on the card) against the same
    function on the CPU, output and the three gradients, under PyTorch's
    default flags (which let cuDNN round f32 to TF32; the port keeps its f32
    conv off it): in f32 within 1e-5 relative (the sums' order), in bf16
    within twice the CPU's own bf16-vs-f32 distance (two bf16 evaluations).
    In f32 an output whose ReLU the two devices decide apart moves every
    gradient by its whole upstream value (one such output of 786,432 moves
    them 1.7e-3 at 768 channels, PERF.md, PR 14), so the two devices must
    decide alike wherever the sums' order bound of the output,
    2·(9·Cin+1)·2^-24·Σ|terms|, does not reach 0, at most 1e-4 of the
    outputs may differ, and those get no upstream gradient on either
    device."""
    from s1s2_torch.ops.conv3x3 import conv3x3_relu_train

    g = torch.Generator().manual_seed(0)
    x, w = torch.randn((B, H, W, Ci), generator=g), 0.05 * torch.randn((3, 3, Ci, Co), generator=g)
    b, up = torch.randn((Co,), generator=g), torch.randn((B, H, W, Co), generator=g)

    def forward(dev, dtype):
        leaves = [t.to(dev, dt, copy=True).requires_grad_(True)
                  for t, dt in ((x, dtype), (w, torch.float32), (b, torch.float32))]
        return leaves, conv3x3_relu_train(*leaves)

    def grads(leaves, y, upstream):
        (y.float() * upstream.to(y.device)).sum().backward()
        return [t.detach().float().cpu() for t in (y, *(leaf.grad for leaf in leaves))]

    (lc, yc), (lh, yh) = forward(cuda, torch.float32), forward("cpu", torch.float32)
    apart = (yc.detach().cpu() > 0) != (yh.detach() > 0)
    pre = F.conv2d(x.double().permute(0, 3, 1, 2), w.double().permute(3, 2, 0, 1),
                   padding=1).permute(0, 2, 3, 1) + b.double()
    terms = F.conv2d(x.double().abs().permute(0, 3, 1, 2), w.double().abs().permute(3, 2, 0, 1),
                     padding=1).permute(0, 2, 3, 1) + b.double().abs()
    assert bool((pre[apart].abs() <= 2 * (9 * Ci + 1) * 2.0 ** -24 * terms[apart]).all())
    assert int(apart.sum()) <= 1e-4 * apart.numel()
    same = up.masked_fill(apart, 0.0)
    for c, h in zip(grads(lc, yc, same), grads(lh, yh, same)):
        assert _rel(c, h) <= 1e-5
    ref = grads(*forward("cpu", torch.float32), up)
    for c, h, r in zip(grads(*forward(cuda, torch.bfloat16), up),
                       grads(*forward("cpu", torch.bfloat16), up), ref):
        assert _rel(c, h) <= max(2 * _rel(h, r), 1e-6)


@pytest.mark.gpu
def test_gpu_train_pool_routes_ties_as_the_cpu(cuda):
    """max_pool2_train's backward on the card gives a tied window's gradient
    to its first element, as on the CPU (and as JAX does)."""
    from s1s2_torch.models.unet import max_pool2_train

    x = torch.tensor([[1.0, 1.0], [1.0, 0.5]]).repeat(8, 8)[None, :, :, None].repeat(2, 1, 1, 3)
    up = torch.randn((2, 8, 8, 3), generator=torch.Generator().manual_seed(1))
    grads = []
    for dev, dtype in (("cpu", torch.float32), (cuda, torch.float32), (cuda, torch.bfloat16)):
        xd = x.to(dev, dtype, copy=True).requires_grad_(True)
        (max_pool2_train(xd).float() * up.to(dev)).sum().backward()
        grads.append(xd.grad.float().cpu())
    assert torch.equal(grads[0], grads[1])
    # bf16: the same elements take the gradient (rounded to bf16)
    assert torch.equal(grads[2] != 0, grads[0] != 0) and int((grads[1] != 0).sum()) == up.numel()


@pytest.mark.gpu
@pytest.mark.parametrize("planted", [False, True])
def test_gpu_validate_pth_parity_bf16_rule(cuda, monkeypatch, planted):
    """The committed ε crossval net on the card's conv kernel (bf16) against
    the f32 twin, under the card's rule: the port's f32 forward on the CPU
    within ``max_abs < 1e-3`` of the twin (the converter) and ``rel`` within
    twice the CPU plain path's bf16 ``rel`` (the kernel). A converter that
    transposes the stem's kernel in space fails it."""
    from pathlib import Path

    import numpy as np

    from s1s2_torch.models import convert
    from s1s2_torch.models.torch_twin import validate_pth_parity

    if planted:
        right = convert.torch_state_dict_to_params

        def wrong(sd):
            out = right(sd)
            k = out["params"]["inc"]["kernel"]
            out["params"]["inc"]["kernel"] = np.ascontiguousarray(k.transpose(1, 0, 2, 3))
            return out

        monkeypatch.setattr(convert, "torch_state_dict_to_params", wrong)
    pth = Path(__file__).resolve().parents[1] / "examples" / "ref_crossval" / "ref_eps_model.pth"
    rep = validate_pth_parity(str(pth), device=cuda)
    assert rep["compute_dtype"] == "bfloat16"
    assert rep["rule"] == "f32_max_abs < 0.001 and rel <= 2 x cpu_bf16_rel"
    if planted:
        assert not rep["pass"] and rep["f32_max_abs"] > 1e-3
    else:
        assert rep["pass"] and rep["f32_max_abs"] < 1e-3
        assert rep["rel"] <= 2 * rep["cpu_bf16_rel"]


@pytest.mark.gpu
def test_gpu_night_demo_panel_at_256(cuda, tmp_path):
    """One night_demo panel of a 256² patch through the harness on the card
    (base 8, ``@random``): the panel's shape, its title drawn in yellow, and
    the conv and DDIM update kernels launched."""
    import numpy as np

    from s1s2_torch.data.synthetic import make_synthetic_patches
    from s1s2_torch.eval.harness import EvalConfig, run_mode
    from s1s2_torch.viz.render import read_png, title_coverage

    make_synthetic_patches(str(tmp_path / "p"), n=1, size=256, seed=0)
    conv3x3_relu.launches = fused_ddim_update.launches = 0
    out = run_mode(EvalConfig(patch_dir=str(tmp_path / "p"), out_dir=str(tmp_path / "o"),
                              mode="night_demo", ckpt="@random", base_ch=8, ddim_steps=2,
                              batch_size=1, save_viz_n=1, device=str(cuda)))
    assert out == {"panels": 1}
    assert conv3x3_relu.launches == 2 * 13 and fused_ddim_update.launches == 2
    img = read_png(str(tmp_path / "o" / "previews" / "000_night_panel.png"))
    assert img.shape == (512, 3 * 512, 3)
    # the title's strongly covered pixels (coverage ≥ 240 of 255) are yellow
    cov, dx, dy = title_coverage("Night demo: patch_000000.npz")
    ys, xs = np.nonzero(cov >= 240)
    px = img[5 + dy + ys, 10 + dx + xs].astype(int)
    assert len(ys) > 20 and bool(((px[:, :2] >= 240).all(1) & (px[:, 2] <= 15)).all())
