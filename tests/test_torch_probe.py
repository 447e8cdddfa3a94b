"""The port's probe kernels (ops/matmul.py, ops/halo.py) through their
plain versions on the CPU, against the Pallas kernels of
tools/probe_pallas_int8.py run in interpret mode. The reference probe is
loaded by path and not edited. The CUDA kernels themselves are held against
the plain versions on the card by tests/test_torch_gpu.py and
chip_smoke.py."""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from s1s2_torch.ops.halo import halo_rows_x2, halo_rows_x2_plain
from s1s2_torch.ops.matmul import INT8_MAX_K, b_scratch, matmul, matmul_plain

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location(
        "probe_pallas_int8_reference", REPO / "tools" / "probe_pallas_int8.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pallas_mm(ref, a, b, out_dtype):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(ref.pallas_matmul(a, b, bm=128, bn=128, bk=128,
                                            out_dtype=out_dtype).astype(jnp.float32))


@pytest.fixture(scope="module")
def mm_case():
    rng = np.random.default_rng(7)
    a8 = rng.integers(-128, 128, (256, 256)).astype(np.int8)
    b8 = rng.integers(-128, 128, (256, 256)).astype(np.int8)
    af = rng.standard_normal((256, 256)).astype(np.float32)
    bf = rng.standard_normal((256, 256)).astype(np.float32)
    return a8, b8, af, bf


def test_int8_matmul_exact_against_pallas(ref, mm_case):
    a8, b8, _, _ = mm_case
    want = _pallas_mm(ref, jnp.asarray(a8), jnp.asarray(b8), jnp.int32)
    got = matmul(torch.from_numpy(a8), torch.from_numpy(b8), torch.int32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    exact = a8.astype(np.int64) @ b8.astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), exact)


@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_bf16_matmul_against_pallas(ref, mm_case, out):
    """f32 accumulation in another order: within 2·K·2^-24·Σ|a·b|; a bf16
    output adds one bf16 ulp (2^-8 of the value) for the rounding."""
    _, _, af, bf = mm_case
    ab, bb = jnp.asarray(af).astype(jnp.bfloat16), jnp.asarray(bf).astype(jnp.bfloat16)
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[out]
    want = _pallas_mm(ref, ab, bb, jdt)
    ta = torch.from_numpy(np.array(ab.astype(jnp.float32))).to(torch.bfloat16)
    tb = torch.from_numpy(np.array(bb.astype(jnp.float32))).to(torch.bfloat16)
    got = matmul(ta, tb, tdt)
    assert got.dtype == tdt
    got = got.float().numpy()
    terms = np.abs(np.asarray(ab, np.float64)) @ np.abs(np.asarray(bb, np.float64))
    tol = 2 * 256 * 2.0 ** -24 * terms
    if out == "bf16":
        tol = tol + np.abs(want) * 2.0 ** -8
    assert (np.abs(got - want) <= tol).all()


@pytest.mark.parametrize("shape,dtype", [((100, 64, 128), torch.bfloat16),
                                         ((128, 48, 128), torch.bfloat16),
                                         ((128, 64, 200), torch.int8),
                                         ((128, 96, 128), torch.int8)])
def test_matmul_raises_where_the_pallas_grid_drops_a_remainder(shape, dtype):
    """The Pallas grid (M//bm, N//bn, K//bk) drops a remainder silently; the
    port raises on any shape that is not a tile multiple, on every device."""
    M, K, N = shape
    a, b = torch.zeros((M, K), dtype=dtype), torch.zeros((K, N), dtype=dtype)
    out = torch.int32 if dtype == torch.int8 else torch.float32
    with pytest.raises(ValueError, match="multiples"):
        matmul(a, b, out)
    assert tuple(matmul_plain(a, b, out).shape) == (M, N)  # the plain version takes any


@pytest.mark.parametrize("M,N,K,dtype", [
    (128, 128, 32, torch.bfloat16), (128, 128, 64, torch.int8),      # one k step
    (256, 384, 96, torch.bfloat16), (384, 128, 192, torch.int8),     # N = 3 or 1 x 128
    (128, 640, 544, torch.bfloat16), (256, 640, 1088, torch.int8),   # K past the ring
    (640, 256, 160, torch.bfloat16), (128, 1152, 320, torch.int8)])
def test_matmul_still_takes_every_shape_it_took(M, N, K, dtype):
    """Every shape of the old tiling (M, N multiples of 128; K of 32 for
    bf16, 64 for int8) is still accepted, with the plain version's result:
    exact for int8, the f32 product rounded once for bf16."""
    rng = np.random.default_rng(M + N + K)
    if dtype == torch.int8:
        a8 = rng.integers(-128, 128, (M, K)).astype(np.int8)
        b8 = rng.integers(-128, 128, (K, N)).astype(np.int8)
        got = matmul(torch.from_numpy(a8), torch.from_numpy(b8), torch.int32)
        assert got.dtype == torch.int32 and tuple(got.shape) == (M, N)
        np.testing.assert_array_equal(got.numpy(), a8.astype(np.int64) @ b8.astype(np.int64))
        return
    a = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)).to(torch.bfloat16)
    want = a.double() @ b.double()
    tol = 2 * K * 2.0 ** -24 * (a.double().abs() @ b.double().abs())
    for out in (torch.float32, torch.bfloat16):
        got = matmul(a, b, out)
        assert got.dtype == out and tuple(got.shape) == (M, N)
        bound = tol + (want.abs() * 2.0 ** -8 if out == torch.bfloat16 else 0)
        assert bool(((got.double() - want).abs() <= bound).all())


@pytest.mark.parametrize("K,N", [(64, 128), (1088, 640), (2048, 2048)])
def test_int8_b_scratch_is_the_k_major_copy_the_kernel_fills(K, N):
    """The int8 mode hands the kernel an (N, K) int8 scratch, N·K bytes, on
    b's device, contiguous, which the kernel fills with bᵀ; bf16 needs
    none. Filled with bᵀ, it gives the same product through K-major B."""
    b8 = torch.from_numpy(np.random.default_rng(K).integers(-128, 128, (K, N)).astype(np.int8))
    bt = b_scratch(b8)
    assert bt.dtype == torch.int8 and tuple(bt.shape) == (N, K)
    assert bt.is_contiguous() and bt.device == b8.device
    assert bt.numel() * bt.element_size() == K * N
    assert bt.data_ptr() != b8.data_ptr()
    a8 = torch.from_numpy(np.random.default_rng(N).integers(-128, 128, (128, K)).astype(np.int8))
    bt.copy_(b8.t())
    assert torch.equal(a8.long() @ bt.long().t(), matmul(a8, b8, torch.int32).long())
    assert b_scratch(b8.to(torch.bfloat16)) is None


def test_matmul_refuses_other_types_and_an_overflowing_k():
    a = torch.zeros((128, 128), dtype=torch.float32)
    with pytest.raises(TypeError):
        matmul(a, a, torch.float32)
    i8 = torch.zeros((128, 128), dtype=torch.int8)
    with pytest.raises(TypeError):
        matmul(i8, i8, torch.float32)
    with pytest.raises(TypeError):
        matmul(i8.to(torch.bfloat16), i8, torch.int32)
    big = INT8_MAX_K + 1
    with pytest.raises(ValueError, match="overflow"):
        matmul(torch.zeros((128, big), dtype=torch.int8),
               torch.zeros((big, 128), dtype=torch.int8), torch.int32)
    assert 128 ** 2 * INT8_MAX_K < 2 ** 31 <= 128 ** 2 * (INT8_MAX_K + 1)


def _pallas_halo(ref, x, TH):
    H, W, C = x.shape
    with pltpu.force_tpu_interpret_mode():
        out = pl.pallas_call(
            functools.partial(ref._dma_kernel, TH=TH),
            grid=((H - 2) // TH,),
            in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec((TH, W, C), lambda i: (i, 0, 0)),
            out_shape=jax.ShapeDtypeStruct((H - 2, W, C), jnp.float32),
            scratch_shapes=[pltpu.VMEM((TH + 2, W, C), jnp.float32),
                            pltpu.SemaphoreType.DMA],
        )(jnp.asarray(x))
    return np.asarray(out)


@pytest.mark.parametrize("H,W,C,TH", [(66, 16, 8, 16), (70, 16, 8, 16)])
def test_halo_against_pallas_and_every_row(ref, H, W, C, TH):
    """Equal to the Pallas kernel on the rows its grid writes; the port also
    writes the rows past the last whole tile, which the Pallas grid leaves
    unwritten (rows 64..67 at H=70)."""
    x = (np.arange(H * W * C, dtype=np.float32).reshape(H, W, C) / 1e3).astype(np.float32)
    want = _pallas_halo(ref, x, TH)
    got = halo_rows_x2(torch.from_numpy(x), TH).numpy()
    assert got.shape == (H - 2, W, C)
    done = (H - 2) // TH * TH
    np.testing.assert_array_equal(got[:done], want[:done])
    np.testing.assert_array_equal(got[done:], 2.0 * x[done + 1:H - 1])
    np.testing.assert_array_equal(got, halo_rows_x2_plain(torch.from_numpy(x)).numpy())


def test_halo_refuses_too_few_rows():
    with pytest.raises(ValueError):
        halo_rows_x2(torch.zeros((2, 4, 4)))
    with pytest.raises(ValueError):
        halo_rows_x2(torch.zeros((8, 4, 4)), th=0)


@pytest.mark.parametrize("arg", ["bogus", "conv2"])
def test_probe_usage_names_every_leg_it_accepts(arg):
    """The usage line lists conv, which the tool accepts; it is checked
    before the card, so it answers here too."""
    from s1s2_torch.tools import probe_int8

    with pytest.raises(SystemExit) as e:
        probe_int8.main([arg])
    assert "[matmul|dma|conv|all]" in str(e.value.code) and repr(arg) in str(e.value.code)


def test_probe_conv_points_at_the_roadmap_item_that_ports_it():
    import inspect

    from s1s2_torch.tools import probe_int8

    src = inspect.getsource(probe_int8)
    assert "ROADMAP §2 item 1" in src and "ROADMAP §1)" not in src
