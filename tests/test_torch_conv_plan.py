"""What surrounds the Hopper conv kernel (``ops/csrc/conv3x3.cu``), on the
CPU: the launch plan the C entry computes, mirrored in Python
(``ops/conv3x3.conv_plan``), is legal at every conv shape of every model
the repo runs; the bf16 mode's K-major weight layout reproduces the conv
and is made once per parameter; the stems' channels padded upstream
(``models/unet.input_map``) change no output bit, and the padded forwards
match JAX's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s1s2.models import UNetSmall as JUNet
from s1s2_torch.models import unet
from s1s2_torch.models.quant import quantize_weights
from s1s2_torch.models.unet import UNetSmall, input_map, load_unet
from s1s2_torch.ops import conv3x3 as cv
from s1s2_torch.tools import bench_conv

BF16 = jnp.bfloat16
SMEM_BLOCK = 232448  # 227 KB: a block's shared memory on sm_90
STATIC_SMEM = 20 * 8  # the kernel's mbarriers
MODELS = bench_conv.MODELS  # (label, base, stem, in_ch, patch side): every model the repo runs


def _wgmma_width(mode, n):
    """N widths of wgmma m64nNk16 (bf16: multiples of 8 up to 256) and
    m64nNk32 (s8: 8, 16, 24, then multiples of 16 up to 256)."""
    if mode == "bf16":
        return n % 8 == 0 and 8 <= n <= 256
    return n in (8, 16, 24) or (n % 16 == 0 and 32 <= n <= 256)


@pytest.mark.parametrize("label,base,stem,in_ch,side", MODELS, ids=[m[0] for m in MODELS])
def test_every_conv_of_every_model_gets_a_legal_plan(label, base, stem, in_ch, side):
    """Both modes at every conv (each can run in bf16, the int8 path's in
    int8; the stem's input padded to 8 channels): N a wgmma width of the
    type covering Cout with no empty tile, the ring of at least 2 stages
    inside 227 KB with the barriers, boxes of 32, 64 or 128 bytes (a
    swizzle's row: the narrowest that holds a pixel's channels, else 128)
    and every global stride of the tensor maps a multiple of 16 bytes."""
    convs = bench_conv.model_convs(base, stem, in_ch, side)
    assert len(convs) == 13
    for name, H, cin, cout, _ in convs:
        for mode in ("bf16",) if name == "inc" else ("bf16", "int8"):
            e = 2 if mode == "bf16" else 1
            cs = cv._round_up(cin, cv.K_MULT[mode])
            p = cv.conv_plan(mode, cs, cout)
            what = f"{label} {name} {H}x{H} {cin}->{cout} {mode}: {p}"
            assert _wgmma_width(mode, p["bn"]) and p["bn"] <= cv.N_MAX, what
            assert p["ntn"] * p["bn"] >= cout > (p["ntn"] - 1) * p["bn"], what
            assert p["chunk"] * e == p["kb"] in cv.CHUNK_BYTES, what
            assert p["kb"] == 128 or cs * e <= p["kb"] and (p["kb"] == 32 or cs * e > 32), what
            assert p["nchunks"] * p["chunk"] >= cs > (p["nchunks"] - 1) * p["chunk"], what
            assert 2 <= p["nst"] <= cv.MAX_STAGES and p["na"] == min(2, p["nchunks"]), what
            assert p["smem"] <= cv.SMEM_DYN and p["smem"] + STATIC_SMEM <= SMEM_BLOCK, what
            assert all(s % 16 == 0 for s in p["x_strides"] + p["w_strides"]), what


@pytest.mark.parametrize("mode,cs,cout,bn,ntn,na,nst,kb", [
    pytest.param(*case, id="-".join(map(str, case[:-1]))) for case in [
        ("bf16", 136, 24, 24, 1, 2, 8, 128),   # the 24x4's padded stem
        ("bf16", 16, 96, 96, 1, 1, 8, 32),     # base-96's padded stem
        ("bf16", 16, 12, 16, 1, 1, 8, 32),     # the 12's Cout
        ("bf16", 24, 48, 48, 1, 1, 8, 64),     # the 24x4's calibration convs at Cin 24
        ("int8", 32, 24, 24, 1, 1, 8, 32),     # the 24x4's int8 convs at Cin 24
        ("int8", 64, 48, 48, 1, 1, 8, 64),
        ("int8", 192, 192, 96, 2, 2, 8, 128),  # an even split, not 128 + 64
        ("bf16", 768, 768, 128, 6, 2, 8, 128),
        ("int8", 768, 384, 128, 3, 2, 8, 128),
        ("int8", 224, 70, 96, 1, 2, 8, 128)]])
def test_plan_picks_the_n_tile_and_ring(mode, cs, cout, bn, ntn, na, nst, kb):
    """The N tile, the ring and the chunk: 32 or 64 bytes of each pixel
    where its channels fit, else 128."""
    p = cv.conv_plan(mode, cs, cout)
    assert (p["bn"], p["ntn"], p["na"], p["nst"], p["kb"]) == (bn, ntn, na, nst, kb)


@pytest.mark.parametrize("B,H,W,Ci,Co", [(2, 8, 8, 24, 12), (1, 7, 5, 129, 24), (1, 8, 8, 9, 96),
                                         (2, 4, 6, 33, 16)])
def test_packed_bf16_weights_give_the_same_implicit_gemm(B, H, W, Ci, Co):
    """The bf16 mode's layout: weights (9, Cout, Cin up to 8), activations
    with Cin zero-padded to 8, summed as nine shifted (B·H·W, Cs) × (Cs,
    Cout) products, tap = 3·ky + kx: the plain version's conv, within f32
    rounding (another summation order); packed once per weight tensor,
    again only after an in-place change."""
    rng = np.random.default_rng(Ci)
    x = torch.from_numpy(rng.standard_normal((B, H, W, Ci)).astype(np.float32))
    w = torch.from_numpy((0.1 * rng.standard_normal((3, 3, Ci, Co))).astype(np.float32))
    p = cv.packed_weight(w)
    cs = -(-Ci // 8) * 8
    assert tuple(p.shape) == (9, Co, cs) and not p[:, :, Ci:].any()
    xp = torch.zeros((B, H + 2, W + 2, cs), dtype=torch.float64)
    xp[:, 1:-1, 1:-1, :Ci] = x.double()
    acc = torch.zeros((B, H, W, Co), dtype=torch.float64)
    for tap in range(9):
        ky, kx = divmod(tap, 3)
        acc += xp[:, ky:ky + H, kx:kx + W] @ p[tap].double().T
    ref = cv.conv3x3_relu_plain(x, w, torch.zeros(Co), False)
    torch.testing.assert_close(acc.float(), ref, atol=1e-5, rtol=1e-5)
    assert cv.packed_weight(w) is p
    w.mul_(-1)
    assert torch.equal(cv.packed_weight(w), -p)


def test_weights_are_cast_and_packed_once_per_parameter(monkeypatch):
    """Across repeated forwards each conv sees the same bf16 tensor, so its
    K-major layout is made once per parameter; an in-place change of a
    parameter makes both again."""
    packs = []

    def spy(x, w, b, apply_relu=True, padded_input=False):
        packs.append(cv.packed_weight(w))
        return cv.conv3x3_relu(x, w, b, apply_relu, padded_input)

    monkeypatch.setattr(unet, "conv3x3_relu", spy)
    model = UNetSmall(4, 8, 2).eval()
    torch.nn.init.normal_(model.inc.kernel)
    x, t = torch.rand((1, 16, 16, 8)), torch.tensor([5])
    model(x, t)
    first = list(packs)
    model(x, t)
    assert len(first) == 13 and all(a is b for a, b in zip(first, packs[13:]))
    assert len({id(p) for p in first}) == 13
    with torch.no_grad():
        model.inc.kernel.mul_(2)
    model(x, t)
    assert packs[26] is not first[0] and torch.equal(packs[26].float(), (2 * first[0]).float())
    assert all(a is b for a, b in zip(first[1:], packs[27:]))


@pytest.mark.parametrize("in_ch,stem", [(8, 4), (8, 2), (8, 1), (7, 1)])
def test_padded_stem_input_gives_the_same_bits(in_ch, stem):
    """``input_map(pad=True)`` adds zero channels up to a multiple of 8 (and
    none when there is one already); the inc conv on it, its weight
    unpadded, is bit-equal to the conv on the unpadded input, in bf16
    through the wrapper and in f32 through the plain version with the
    weight's missing rows as zeros."""
    rng = np.random.default_rng(stem)
    xc = torch.from_numpy(rng.standard_normal((2, 16, 16, in_ch)).astype(np.float32))
    t = torch.tensor([999, 3])
    x = input_map(xc, t, stem, torch.bfloat16)
    xp = input_map(xc, t, stem, torch.bfloat16, pad=True)
    cin = in_ch * stem * stem + 1
    assert x.shape[-1] == cin and xp.shape[-1] == -(-cin // 8) * 8
    assert torch.equal(xp[..., :cin], x) and not xp[..., cin:].any()
    w = torch.from_numpy((0.2 * rng.standard_normal((3, 3, cin, 24))).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(24).astype(np.float32))
    assert torch.equal(cv.conv3x3_relu(xp, w.bfloat16(), b, padded_input=True),
                       cv.conv3x3_relu(x, w.bfloat16(), b))
    wp = torch.zeros((3, 3, xp.shape[-1], 24))
    wp[:, :, :cin] = w
    assert torch.equal(cv.conv3x3_relu_plain(xp.float(), wp, b),
                       cv.conv3x3_relu_plain(x.float(), w, b))


@pytest.mark.parametrize("cx,cw,padded", [(136, 129, False), (136, 127, True),
                                          (129, 129, True), (24, 9, True), (16, 9, False)])
def test_the_conv_takes_a_padded_input_only_when_told(cx, cw, padded):
    """A stem input padded upstream is accepted only with ``padded_input``
    and only as Cin rounded up to 8; any other mismatch of x's channels and
    w's Cin raises, so no channel is dropped without a word."""
    x, w, b = torch.zeros((1, 4, 4, cx)), torch.zeros((3, 3, cw, 8)), torch.zeros(8)
    with pytest.raises(ValueError):
        cv.conv3x3_relu(x, w, b, padded_input=padded)
    ok = torch.zeros((1, 4, 4, -(-cw // 8) * 8))
    assert cv.conv3x3_relu(ok, w, b, padded_input=True).shape == (1, 4, 4, 8)


def test_time_set_times_each_conv_once_and_sums_the_path(monkeypatch, capsys):
    """The one per-shape conv timing loop (``bench_conv.time_set``, which
    ``chip_smoke.py``'s timing phases call), on the CPU with the clock
    stubbed: each conv in its own mode at its mode's batch, the padded stem
    through ``padded_input``, an int8 conv also in bf16 when asked (printed,
    not summed), the plain version only with ``plain_reps``, and each
    mode's sums split by what bounds each conv."""
    calls = []

    def clock(fn, args_list, reps):
        for args in args_list:
            fn(*args)
        calls.append(reps)
        return 1.0

    monkeypatch.setattr(bench_conv, "time_ms", clock)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    state = {k: 0.1 * torch.randn(v.shape, generator=torch.Generator().manual_seed(0))
             for k, v in UNetSmall(4, 8, 2, 8).state_dict().items()}
    w8 = quantize_weights(state)[0]
    shapes = bench_conv.conv_shapes(state, 8)
    gen = torch.Generator().manual_seed(1)
    inputs = bench_conv.conv_inputs(state, w8, gen)
    sums = bench_conv.time_set("t", inputs, shapes, {"bf16": 2, "int8": 3}, 5, 2,
                               calibration=True)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("time ")]
    assert len(lines) == 1 + 2 * 12 + 2
    assert lines[0].startswith("time bf16 t inc 8x8 33 (40)->8 B=2: kernel 1.0000 ms")
    assert sum("[calibration mode]" in ln for ln in lines) == 12
    assert all(" B=3:" in ln for ln in lines if ln.startswith("time int8"))
    assert sums["bf16"]["n"] == 1 and sums["int8"]["n"] == 12
    for m in ("bf16", "int8"):
        s = sums[m]
        assert s["ms"] == s["plain"] == s["n"] and s["bytes"] + s["operations"] == s["bound"]
    assert sums["int8"]["library"] == 0 and sums["bf16"]["library"] == 1
    # per shape: F.conv2d (bf16 only), kernel, plain
    assert calls == [5, 5, 2] + [5, 2, 5, 5, 2] * 12
    calls.clear()
    sums = bench_conv.time_set("t", inputs, bench_conv.int8_only(shapes), {"int8": 3}, 4)
    assert calls == [4] * 12 and sums["int8"]["plain"] == 0


def _jax_tree(state):
    tree = {}
    for k, v in state.items():
        *path, leaf = k.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v.numpy())
    return tree


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_base96_forward_with_the_padded_stem_matches_jax(dtype):
    """The full-width base-96 UNet (stem input 9 → 16 channels) on seeded
    random weights at 16², against the JAX model: f32 within 1e-4; bf16
    within the 24x4 slice test's bound (mean |Δ| ≤ 1.5% of mean |ε|)."""
    rng = np.random.default_rng(96)
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in UNetSmall(4, 96, 1).state_dict().items()}
    state = {k: torch.from_numpy((rng.standard_normal(s) / np.sqrt(np.prod(s[:-1]))
                                  ).astype(np.float32)) for k, s in shapes.items()}
    x = np.concatenate([rng.standard_normal((1, 16, 16, 4)),
                        rng.random((1, 16, 16, 4))], -1).astype(np.float32)
    t = np.array([200], np.int32)
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (BF16, torch.bfloat16)
    ref = np.asarray(JUNet(out_ch=4, base_ch=96, compute_dtype=jd).apply(
        {"params": _jax_tree(state)}, jnp.asarray(x), jnp.asarray(t)))
    got = load_unet(state, 4, 96, 1, compute_dtype=td, device="cpu")(
        torch.from_numpy(x), torch.from_numpy(t)).numpy()
    d = np.abs(got - ref)
    if dtype == "f32":
        assert d.max() <= 1e-4, d.max()
    else:
        assert d.mean() <= 0.015 * np.abs(ref).mean(), d.mean()
