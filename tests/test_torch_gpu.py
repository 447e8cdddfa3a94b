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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W,Ci,Co", [(2, 64, 64, 129, 24), (3, 17, 9, 5, 40), (1, 8, 8, 192, 192)])
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
@pytest.mark.parametrize("B,H,W,Ci,Co", [(2, 64, 64, 24, 48), (3, 17, 9, 5, 40), (1, 16, 16, 192, 96)])
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
def test_gpu_ddim_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((4, 64, 64, 4), generator=g, device=cuda)
    e = torch.randn((4, 64, 64, 4), generator=g, device=cuda)
    coefs = ddim_coefs(0.25, 0.99)
    for k, p in zip(fused_ddim_update(x, e, *coefs), ddim_update_plain(x, e, *coefs)):
        assert bool(((k - p).abs() <= 1e-6 * p.abs()).all())
