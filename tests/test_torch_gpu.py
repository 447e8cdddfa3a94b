"""The CUDA kernels of s1s2_torch against their plain PyTorch versions, on
the card. These tests import neither JAX nor the JAX package, so they run on
the card's machine:

    python -m pytest --noconftest tests/test_torch_gpu.py -q -m gpu

Without a card they skip (the kernels have no CPU mode)."""

import pytest
import torch

from s1s2_torch.ops.conv3x3 import (conv3x3_relu, conv3x3_relu_int8,
                                    conv3x3_relu_int8_plain, conv3x3_relu_plain)
from s1s2_torch.ops.fused_elementwise import (ddim_coefs, ddim_update_plain,
                                              fused_ddim_update)
from s1s2_torch.ops.halo import halo_rows_x2, halo_rows_x2_plain
from s1s2_torch.ops.matmul import matmul, matmul_plain


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
