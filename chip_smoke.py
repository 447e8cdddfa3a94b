#!/usr/bin/env python3
"""Smoke run of the s1s2_torch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each printing its own seconds:

1. Device: a CUDA card must be present (else exit 1, no result); prints
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``.
2. Build: compiles ``s1s2_torch/ops/csrc/*.cu`` with nvcc and prints each
   conv, matmul and halo kernel's registers and shared memory (ptxas).
   ``cuobjdump -sass`` of the built library must show (``sass_rules``):
   ``HMMA`` in every ``conv3x3_bf16_kernel`` and ``IMMA`` in
   ``conv3x3_int8_kernel``, no ``IDP4A`` or ``FFMA`` there; ``HGMMA`` in the
   bf16 ``matmul_kernel``s and ``IGMMA`` in the int8 one, each with TMA
   loads (``UTMALDG``) and no ``HMMA``/``IMMA``/``LDGSTS``; bulk loads and
   bulk stores (``UBLKCP.S.G``, ``UBLKCP.G.S``) and no ``LDG``/``STG`` in
   ``halo_rows_x2_kernel``.
3. Kernels against their plain PyTorch versions at the main path's shapes
   (the 24x4 student's 13 convs, B=8; the DDIM update at (128,256,256,4)):
   conv bf16 within 1 bf16 ulp plus the f32 accumulation-order bound,
   conv int8 bit-equal (and its quantizer on every finite bf16 value at
   scales that put quotients near k + 1/2), DDIM update within 1e-6
   relative.
3b. The probe kernels against their plain versions: the matmul int8
   bit-equal at 512³ and 8192×2048×2048, bf16 → f32 within the f32
   accumulation-order bound and bf16 → bf16 within that plus 1 bf16 ulp;
   the halo kernel bit-equal on every row at (256,128,128) with TH=32, at
   ragged heights where TH does not divide H−2, and at (1026,256,128), where
   every block cycles its ring of slots.
3c. The conv kernel at every shape of the full-width base-96 UNet (256²,
   9→96 up to 768→768 at 64²) and of the 16x2 and 12 students (their
   checkpoints' own weights), bf16 and int8, at B=1 (256²) or 2, with the
   tolerances of phase 3.
3d. The int8 mode with per-input-channel scales (the CFG path's): bit-equal
   to its plain version at the cfg_v teacher's 10 int8 conv shapes at B=64
   (its folded weights and rollout-calibrated scales, ``conv1`` in bf16),
   and its quantizer on every finite bf16 value with 32 scales at a time
   near k + 1/2; then both modes (per tensor) at the full-resolution shapes
   of the ladder's base-64, 48 and 32 students, inc to conv1.conv2.
3e. The kernels at the crossval nets' shapes (the base-16 ``.pth`` nets of
   ``examples/ref_crossval`` at 32², their own weights): the conv in both
   modes from 32×32 down to 8×8 (narrower than its 8×16-pixel tile) and
   Cout 16 and 32 (below its 64-channel tile), at B=8 and 2 (ε net) and 4
   (v net), and the DDIM update on a padded batch, with phase 3's
   tolerances.
4. Main path: ``run_headline("24x4")`` — checkpoint through the port's own
   reader, 32-file evidence set, calibration (``PRNGKey(5)``), int8
   quantization, GT-anchored DDIM-1 on ``normal(PRNGKey(1234))``, masked
   MAE; then 100 timed batches of ``data(128, 7)`` after one warm-up, as
   bench.py times them. Asserts the MAE against the committed evidence and
   the teacher anchor (and prints its difference from 0.32764), that every
   kernel was launched (counts set to 0 just before), and that the card's
   int8 forward agrees with the CPU plain path on two random patches op by
   op (``check_ops``).
4b. The base-96 path (``s1s2_torch.bench``): one bf16 forward on 2 patches,
   card against the CPU plain path (within 1.5% of mean |ε|), and one int8
   forward checked op by op as in 4; bench line 1 (bf16 DDIM-50 from t=999)
   at B=4 and line 2 (calibration, int8 DPM-Solver++(2M)-5) at B=64, one
   warm-up and one timed call each, with exact launch counts asserted and
   patches/s printed.
4c. The headline fallbacks ``run_headline("16x2")`` and ``("12")``, their
   evidence MAEs asserted against the committed ones and their int8
   forwards checked op by op as in 4.
4d. The probe path: ``python -m s1s2_torch.tools.probe_int8 all`` in
   process.
4e. The CFG line (``bench.bench_cfg``): the 129-file rich set, files 96-127
   through ``cli.evaluate --mode cfg_sweep`` in bf16 and in int8 (rollout
   calibration, per-channel scales, ``conv1`` in bf16), then 9 calls of the
   stacked-CFG sampler at B=32 each way; asserts ``quality_checked`` and
   both MAEs within 0.02 of the committed 0.29821 and 0.29791, and the
   exact launch counts. Then the CFG int8 forward against the CPU op by op.
4f. The width ladder (``bench.bench_widths``): every rung of bench.py's
   ``WIDTHS``, each evidence MAE within 0.02 of its committed value and at
   most 0.95 × 0.44074.
4g. The reference crossval (``s1s2_torch.tools.ref_crossval``): the 27
   committed reference tables replayed in bf16 on the card and again on the
   CPU plain path. Both must pass within the tool's tolerances (its f32
   per-column ones; each prediction array by its mean |Δ|), and the card's
   tables must equal the CPU's within the same tolerances: the two differ
   only where the conv kernel's f32 sums, taken in another order than
   ``F.conv2d``'s, round a bf16 output to the other side, a subset of the
   roundings that separate either run from f32, which the CPU run shows
   stays inside them. Each table's largest deviation is printed, as a
   share of its tolerance, for all three comparisons.
4h. Full width: ``cli.evaluate`` with its defaults (previews on) on the
   32-file 256² evidence set and the base-96 teachers: ``ddim`` (t_start
   200, 20 steps) on the ε teacher, its MAE within 0.02 of the committed
   ddim-20 anchor 0.44074; the same on the v teacher and under ``--int8``
   on the ε teacher (MAEs printed beside the anchors); ``per_band``,
   ``eps``, ``vdiag`` and ``onestep`` once each, finite, their files
   written; exact launch counts; each mode's seconds and patches/s. The
   anchors were drawn with ``tools/bench_distill.py``'s protocol (one batch
   key ``PRNGKey(1234)``, and for v the GT-anchored init on the
   round-unique grid), which the port's samplers then run directly: both
   within 0.02 of their anchors. The harness's v ``ddim`` is the reference
   v script's pure-noise generation from ``noise·√(1−ᾱ)``, another
   protocol; its MAE is printed beside the anchor, not held to it.
5. Timing at B=128 with CUDA events: each kernel at each path shape beside
   its plain version, ``F.conv2d`` (bf16 mode only) and its bound.
5b. Timing at the base-96 shapes (bf16 at line 1's B=128, int8 at line 2's
   B=64: ``bench.LINE1_BATCH``, ``bench.LINE2_BATCH``) beside ``F.conv2d``
   and the bound, of the per-channel int8 mode at the CFG net's 10 int8
   shapes (B=64), and of the probe kernels beside their plain versions,
   ``torch.matmul``/``torch._int_mm`` and ``x[1:-1]*2``.

Each path of 4-4h is driven with every launch count set to 0 just before it
and read just after; a kernel of the path that was not launched fails it.
Then a ``{"kernels": [...]}`` line (the conv rows' times are those of the
24x4 main path at B=128, and the per-channel int8 row's those of the CFG
net's shapes at B=64; the matmul has a row per mode, bf16 → bf16 beside
``torch.matmul`` and int8 → int32 beside ``torch._int_mm``; launches are
summed over the paths), the card line
again, and last ``{"ok": true, "device": {...}}``. Any failure raises, and
no result is printed. The port never calls cuDNN, cuBLAS's ``torch.matmul``
on the probe's operands or ``torch._int_mm``; they are timed here only as
yardsticks.
"""

import contextlib
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# dense tensor-core peaks; f32 outside the tensor cores
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
EVIDENCE_MAE, TEACHER_ANCHOR = 0.32764, 0.44074
SIZE, BATCH, CHECK_BATCH = 256, 128, 8  # patch size, timing batch, check batch
STEM = 4  # the 24x4 student's space-to-depth factor: body at SIZE / 4
LEVEL = {"inc": 0, "down1": 0, "down2": 1, "down3": 2, "conv3": 2, "conv2": 1,
         "conv1": 0}
SMOKE_LINE1_BATCH = 4  # line 1 here; line 2 runs at the bench's own batch
MATMUL_SHAPES = ((512, 512, 512), (8192, 2048, 2048))  # (M, K, N)
HALO_CASES = ((256, 128, 128, 32), (250, 128, 128, 32), (37, 5, 4, 7),  # (H, W, C, TH)
              (1026, 256, 128, 32))
RUNGS = (("16x2", 0.33557), ("12", 0.34379))  # committed evidence MAEs
LADDER_SHAPES = ("64", "48", "32")  # the ladder's full-resolution students checked in 3d
CFG_BF16_BLOCKS = ("conv1",)  # the quality-equal CFG recipe's bf16 block
CFG_CHECK_BATCH = 64  # the CFG sampler's forward: 2 x 32 stacked rows
MAE_SLACK = 0.02  # bench.py's rung slack
# 3e: (net, batch) of the crossval nets' shape checks
CROSSVAL_CHECKS = (("eps", 8), ("eps", 2), ("v", 4))
# 4h: the committed ddim-20 anchors of the base-96 teachers
# (examples/checkpoints/README.md), the evidence set and the teacher files
TEACHER_ANCHORS = {"eps": 0.44074, "v": 0.30411}
FULL_FILES, FULL_BATCH, FULL_STEPS = 32, 8, 20  # the CLI's default batch
# the ops of an int8 forward (``quant._forward``), looked up in the quant
# module at call time
QUANT_OPS = ("conv3x3_relu", "conv3x3_relu_int8", "ps_conv_transpose_2x2", "conv1x1",
             "max_pool2")


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        print(f"== {self.name}", flush=True)
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"== {self.name}: {time.perf_counter() - self.t0:.2f} s", flush=True)
        return False


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def conv_shapes(state, body, bf16_blocks=()):
    """[(name, H, Cin, Cout, mode)] of a model's 13 3x3 convs; ``inc`` and
    the blocks of ``bf16_blocks`` run in bf16, the rest in int8."""
    out = []
    for key, k in state.items():
        if not key.endswith(".kernel") or k.shape[0] != 3:
            continue
        name = key[:-len(".kernel")]
        blk = name.split(".")[0]
        out.append((name, body >> LEVEL[blk], k.shape[2], k.shape[3],
                    "bf16" if name == "inc" or blk in bf16_blocks else "int8"))
    return out


SASS_KERNELS = ("conv3x3", "quantize_pad", "matmul_kernel", "transpose_i8", "halo_rows_x2")
SASS_OPS = ("HMMA", "IMMA", "HGMMA", "IGMMA", "FFMA", "IDP4A", "LDSM", "LDGSTS", "UTMALDG",
            "UBLKCP.S.G", "UBLKCP.G.S", "LDG", "STG")
# (kernel name contains, SASS ops that must occur, ops that must not)
SASS_RULES = (
    ("conv3x3_bf16_kernel", ("HMMA",), ("IDP4A", "FFMA")),
    ("conv3x3_int8_kernel", ("IMMA",), ("IDP4A", "FFMA")),
    ("matmul_kernelILi0E", ("HGMMA", "UTMALDG"), ("HMMA", "IMMA", "LDGSTS")),
    ("matmul_kernelILi1E", ("HGMMA", "UTMALDG"), ("HMMA", "IMMA", "LDGSTS")),
    ("matmul_kernelILi2E", ("IGMMA", "UTMALDG"), ("HMMA", "IMMA", "LDGSTS")),
    ("halo_rows_x2_kernel", ("UBLKCP.S.G", "UBLKCP.G.S"), ("LDG", "STG")),
)


def sass_counts(text):
    """{mangled name: {op: count}} of the kernels ``SASS_KERNELS`` names in
    ``cuobjdump -sass`` output, for every op of ``SASS_OPS`` (an op counts
    with any suffix: ``HGMMA`` matches ``HGMMA.64x256x16.F32.BF16``)."""
    import re

    counts = {}
    for fn in re.split(r"\n\s*Function : ", text)[1:]:
        name = fn.split("\n", 1)[0].strip()
        if any(k in name for k in SASS_KERNELS):
            counts[name] = {op: len(re.findall(r"\b%s\b" % re.escape(op), fn))
                            for op in SASS_OPS}
    return counts


def sass_rules(counts):
    """Raises unless every rule of ``SASS_RULES`` names at least one kernel,
    and each kernel it names has every op it needs and none it forbids: the
    convs on ``mma.sync``, the matmul on ``wgmma`` fed by TMA, the halo load
    on bulk copies. A kernel that fell back to older instructions fails."""
    for key, need, forbid in SASS_RULES:
        names = [n for n in counts if key in n]
        if not names:
            raise AssertionError(f"no {key} in the SASS: {sorted(counts)}")
        for n in names:
            c = counts[n]
            if any(c[op] == 0 for op in need) or any(c[op] for op in forbid):
                raise AssertionError(f"{n}: needs {need}, forbids {forbid}; has {c}")


def sass_check(lib):
    """``cuobjdump -sass`` of the built library → ``sass_counts``, held to
    ``sass_rules``."""
    from pathlib import Path

    from s1s2_torch.ops import _build

    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    counts = sass_counts(out)
    sass_rules(counts)
    return counts


def bound_ms(nbytes, ops, kind):
    """(ms, "bytes" or "operations"): the larger of the two least times."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[kind]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def conv_bound_ms(mode, B, H, Cin, Cout, per_channel=False):
    """Least time for one conv: each input read once (with the Cin f32
    scales of the per-channel int8 mode), each output written once, against
    the ops at the tensor-core peak of the mode's type."""
    wbytes = 2 if mode == "bf16" else 1
    nbytes = (B * H * H * Cin * 2 + 9 * Cin * Cout * wbytes + Cout * 4 * 2
              + B * H * H * Cout * 2 + (Cin * 4 if per_channel else 0))
    return bound_ms(nbytes, 2 * 9 * B * H * H * Cin * Cout, mode)


def time_ms(torch, fn, args_list, reps):
    """Mean ms per call over ``reps`` calls, cycling through the inputs."""
    fn(*args_list[0])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(*args_list[i % len(args_list)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def matmul_bound_ms(M, K, N, mode):
    """bf16 -> bf16 or int8 -> int32: A and B read once, C written once."""
    e, out = (2, 2) if mode == "bf16" else (1, 4)
    return bound_ms(M * K * e + K * N * e + M * N * out, 2.0 * M * K * N, mode)


def halo_bound_ms(H, W, C):
    """x read once, the (H-2) rows written once, one f32 multiply each."""
    return bound_ms(4 * H * W * C + 4 * (H - 2) * W * C, (H - 2) * W * C, "f32")


def bf16_ulp(torch, v):
    """One bf16 ulp of |v| (0 where v is 0)."""
    _, e = torch.frexp(v.float().abs())
    return torch.where(v == 0, torch.zeros_like(v, dtype=torch.float32),
                       torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8))


def bf16_tolerance(torch, F, x, w, b, ref, Cin):
    """1 bf16 ulp of the larger value plus twice the f32 accumulation-order
    bound n·2^-24·Σ|terms| (n = 9·Cin + 1), per element."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        s = F.conv2d(x.float().abs().permute(0, 3, 1, 2),
                     w.float().abs().permute(3, 2, 0, 1), padding=1)
    s = s.permute(0, 2, 3, 1) + b.float().abs()
    return bf16_ulp(torch, ref) + 2 * (9 * Cin + 1) * 2.0 ** -24 * s


def record_ops(quant, qp, x, t):
    """ε̂ of ``quant.quant_apply(qp, x, t)`` and [(op, args, output)] of every
    op of ``QUANT_OPS`` it called, in call order; the quant module is left as
    it was found."""
    calls = []
    saved = {name: getattr(quant, name) for name in QUANT_OPS}

    def wrap(name):
        def fn(*args):
            out = saved[name](*args)
            calls.append((name, args, out))
            return out
        return fn

    try:
        for name in QUANT_OPS:
            setattr(quant, name, wrap(name))
        eps = quant.quant_apply(qp, x, t)
    finally:
        for name, fn in saved.items():
            setattr(quant, name, fn)
    return eps, calls


def check_ops(torch, F, quant, what, calls):
    """Each op an int8 forward ran (``record_ops``) against the same function
    on the CPU, which runs every op's plain version, fed the op's own inputs.
    The int8 convs and the max-pools must be bit-equal. The bf16 ``inc`` conv
    may differ by ``bf16_tolerance``. The up-convs and the 1x1 head are bf16
    matmuls with f32 accumulation (PyTorch's own on both devices): two bf16
    roundings (the product, then the bias add) plus twice the f32
    accumulation-order bound K·2^-24·Σ|x·w|. → [(op, elements that differ,
    max |Δ|, max |Δ|/bound)]; a failing op raises, naming the op."""
    out_rows = []
    for i, (name, args, out) in enumerate(calls):
        ref = getattr(quant, name)(*[a.cpu() if torch.is_tensor(a) else a
                                     for a in args]).to(out.device)
        d = (out.float() - ref.float()).abs()
        if name in ("conv3x3_relu_int8", "max_pool2"):
            ok = bool(torch.equal(out, ref))
            ratio = 0.0 if ok else float("inf")
        else:
            x, w, b = args
            if name == "conv3x3_relu":
                tol = bf16_tolerance(torch, F, x, w, b, torch.maximum(out.abs(), ref.abs()),
                                     x.shape[-1])
            else:
                zero = torch.zeros_like(b, dtype=torch.float32)
                op = getattr(quant, name)
                order = 2 * x.shape[-1] * 2.0 ** -24 * op(x.float().abs(), w.float().abs(), zero)
                p = op(x.float(), w.float(), zero).abs() + order  # the most either sum can be
                big = torch.maximum(torch.maximum(out.float().abs(), ref.float().abs()), p)
                tol = 2 * bf16_ulp(torch, big) + order
            ok = bool((d <= tol).all())
            ratio = float((d / tol.clamp_min(1e-30)).max())
        n = int((d > 0).sum())
        out_rows.append((name, n, float(d.max()), ratio))
        if n:
            print(f"  {what} op {i:2d} {name} {tuple(out.shape)}: {n} of {out.numel()} differ, "
                  f"max {float(d.max()):.4g}, max |d|/bound {ratio:.3g} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"{what}: op {i} {name} on the card disagrees with the CPU")
    return out_rows


def main():
    t_start = time.perf_counter()
    import torch

    with Phase("device"):
        if not torch.cuda.is_available():
            print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
            return 1
        card = card_line()
        kind = torch.cuda.get_device_name(0)
        print(card, flush=True)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
              f"{sys.version.split()[0]} devices {torch.cuda.device_count()}", flush=True)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)

    import numpy as np
    import torch.nn.functional as F

    from s1s2_torch import bench
    from s1s2_torch.core.schedule import Schedule
    from s1s2_torch.headline import CKPT_DIR, evidence_set, run_headline
    from s1s2_torch.models import quant
    from s1s2_torch.models.quant import (make_sampler_calib, quant_apply, quantize_unet,
                                         quantize_weights)
    from s1s2_torch.models.unet import load_unet
    from s1s2_torch.models.weights import params_from_numpy, spec_arch
    from s1s2_torch.ops import _build
    from s1s2_torch.ops.conv3x3 import (conv3x3_relu, conv3x3_relu_int8,
                                        conv3x3_relu_int8_plain, conv3x3_relu_plain)
    from s1s2_torch.ops.fused_elementwise import (ddim_coefs, ddim_update_plain,
                                                  fused_ddim_update)
    from s1s2_torch.ops.halo import halo_rows_x2, halo_rows_x2_plain
    from s1s2_torch.ops.matmul import matmul, matmul_plain
    from s1s2_torch.tools import probe_int8, ref_crossval
    from s1s2_torch.train.checkpoint import load_params

    kernels = (conv3x3_relu, conv3x3_relu_int8, fused_ddim_update, matmul, halo_rows_x2)
    path_launches, matmul_launches, int8_launches = {}, {}, {}

    def drive(path, fn):
        """Run one path with every launch count set to 0 just before it; keep
        the counts read just after (the matmul's also by mode)."""
        for k in kernels:
            k.launches = 0
        matmul.mode_launches = dict.fromkeys(matmul.mode_launches, 0)
        conv3x3_relu_int8.mode_launches = dict.fromkeys(conv3x3_relu_int8.mode_launches, 0)
        out = fn()
        torch.cuda.synchronize()
        path_launches[path] = {k.__name__: k.launches for k in kernels}
        matmul_launches[path] = dict(matmul.mode_launches)
        int8_launches[path] = dict(conv3x3_relu_int8.mode_launches)
        print(f"launches in {path}: {path_launches[path]}; matmul by mode "
              f"{matmul_launches[path]}; int8 conv by scale {int8_launches[path]}", flush=True)
        return out

    def require(cond, what):
        if not cond:
            raise AssertionError(what)

    with Phase("build"):
        info = _build.kernels().info
        print(f"built {info.path.name} compiled={info.compiled} in {info.seconds:.2f} s",
              flush=True)
        prev = ""
        for line in info.ptxas:  # each kernel's "Compiling entry" line, then its usage
            if any(k in line for k in SASS_KERNELS) or (
                    "Used" in line and any(k in prev for k in SASS_KERNELS)):
                print(f"ptxas: {line}", flush=True)
            prev = line
        for name, c in sass_check(info.path).items():
            print(f"sass {name[:80]}: {c}", flush=True)

    def student(spec):
        """A distilled student's checkpoint on the card."""
        st = params_from_numpy(load_params(str(
            CKPT_DIR / f"distill_eps_student{spec}.bf16.msgpack")))
        return {k: v.to(dev) for k, v in st.items()}

    state = student("24x4")
    shapes = conv_shapes(state, body=SIZE // STEM)
    w8, _ = quantize_weights(state)
    state96_cpu = bench.base96_state()
    state96 = {k: v.to(dev) for k, v in state96_cpu.items()}
    shapes96 = conv_shapes(state96, body=SIZE)
    w8_96, _ = quantize_weights(state96)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def make_inputs(st, w8d, rand_bias):
        def conv_inputs(name, B, H, Cin, Cout, mode):
            x = torch.randn((B, H, H, Cin), generator=gen, device=dev).abs_().to(torch.bfloat16)
            b = (torch.randn((Cout,), generator=gen, device=dev) * 0.1 if rand_bias
                 else st[f"{name}.bias"].contiguous())
            if mode == "bf16":
                return x, st[f"{name}.kernel"].to(torch.bfloat16).contiguous(), b, None
            sx = float(x.float().abs().amax()) / 127.0
            deq = (torch.tensor(sx, dtype=torch.float32, device=dev) * w8d[name][1]).contiguous()
            return x, w8d[name][0], b, (sx, deq)
        return conv_inputs

    conv_inputs = make_inputs(state, w8, False)
    conv_inputs96 = make_inputs(state96, w8_96, True)

    def check_conv(inputs, name, B, H, Cin, Cout, m, label=""):
        """One conv, kernel against plain version; → (key, max abs err)."""
        x, w, b, q = inputs(name, B, H, Cin, Cout, m)
        if m == "bf16":
            got = conv3x3_relu(x, w, b)
            ref = conv3x3_relu_plain(x, w, b)
            tol = bf16_tolerance(torch, F, x, w, b, torch.maximum(got.abs(), ref.abs()), Cin)
            d = (got.float() - ref.float()).abs()
            ok = bool((d <= tol).all())
            key = "conv3x3_relu"
        else:
            got = conv3x3_relu_int8(x, w, q[0], q[1], b)
            ref = conv3x3_relu_int8_plain(x, w, q[0], q[1], b)
            d = (got.float() - ref.float()).abs()
            ok = bool(torch.equal(got, ref))
            key = "conv3x3_relu_int8"
        torch.cuda.synchronize()
        e = float(d.max())
        print(f"check {m} {label}{name} {H}x{H} {Cin}->{Cout} B={B} max_abs_err={e:.3g} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        require(ok, f"conv3x3 {m} kernel disagrees at {label}{name} {H}x{H} {Cin}->{Cout}")
        return key, e

    def time_conv(inputs, name, B, H, Cin, Cout, m, reps, plain_reps, note="",
                  per_channel=False):
        """One conv at batch B: → (kernel ms, plain ms, F.conv2d ms or None,
        bound ms, bound_by)."""
        ins = [inputs(name, B, H, Cin, Cout, m) for _ in range(2)]
        if m == "bf16":
            kfn = lambda x, w, b, q: conv3x3_relu(x, w, b)  # noqa: E731
            pfn = lambda x, w, b, q: conv3x3_relu_plain(x, w, b)  # noqa: E731
            wl = ins[0][1].permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)
            bl = ins[0][2].to(torch.bfloat16)

            def lfn(x, w, b, q, wl=wl, bl=bl):
                return torch.relu_(F.conv2d(x.permute(0, 3, 1, 2), wl, bl, padding=1))
            lib_ms = time_ms(torch, lfn, ins, reps)
        else:
            kfn = lambda x, w, b, q: conv3x3_relu_int8(x, w, q[0], q[1], b)  # noqa: E731
            pfn = lambda x, w, b, q: conv3x3_relu_int8_plain(x, w, q[0], q[1], b)  # noqa: E731
            lib_ms = None
        ms = time_ms(torch, kfn, ins, reps)
        plain_ms = time_ms(torch, pfn, ins, plain_reps)
        bound, by = conv_bound_ms(m, B, H, Cin, Cout, per_channel)
        print(f"time {m}{' per-channel' if per_channel else ''} {name} {H}x{H} {Cin}->{Cout} B={B}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, F.conv2d {'-' if lib_ms is None else f'{lib_ms:.4f}'} ms, "
              f"bound {bound:.4f} ms ({by}){note}", flush=True)
        del ins
        torch.cuda.empty_cache()
        return ms, plain_ms, lib_ms, bound, by

    err = {k.__name__: 0.0 for k in kernels if k is not matmul}
    err.update({"matmul bf16": 0.0, "matmul int8": 0.0})
    with Phase("kernels vs plain versions"):
        for name, H, Cin, Cout, mode in shapes:
            for m in ("bf16", "int8") if mode == "int8" else ("bf16",):
                key, e = check_conv(conv_inputs, name, CHECK_BATCH, H, Cin, Cout, m)
                err[key] = max(err[key], e)
        # the quantizer on every finite bf16 value (identity centre tap, so
        # y = q), at scales that put quotients within an ulp of k + 1/2
        xq = (torch.arange(1 << 16, dtype=torch.int32) << 16).view(torch.float32)
        xq = xq[torch.isfinite(xq)].to(torch.bfloat16).reshape(1, 51, 40, 32).to(dev)
        wq = torch.zeros((3, 3, 32, 32), dtype=torch.int8, device=dev)
        wq[1, 1] = torch.eye(32, dtype=torch.int8, device=dev)
        ones, zeros = torch.ones(32, device=dev), torch.zeros(32, device=dev)
        mags = xq.flatten().float().abs()
        mags = mags[(mags > 1e-3) & (mags < 1e3)]
        pick = torch.randint(len(mags), (40,), generator=gen, device=dev)
        ks = torch.randint(127, (40,), generator=gen, device=dev).float() + 0.5
        for sx in (mags[pick] / ks).tolist():
            same = torch.equal(conv3x3_relu_int8(xq, wq, sx, ones, zeros, False),
                               conv3x3_relu_int8_plain(xq, wq, sx, ones, zeros, False))
            require(same, f"the int8 quantizer disagrees with the IEEE division at sx={sx!r}")
        print("check int8 quantizer: all 65280 finite bf16 values at 40 scales near k + 1/2, "
              "bit-equal", flush=True)
        ab = Schedule.cosine(1000).alpha_bar_np().astype(np.float64)
        s1m, sabg, sabn, s1mn = ddim_coefs(ab[200], ab[0])
        xd = torch.randn((BATCH, SIZE, SIZE, 4), generator=gen, device=dev)
        ed = torch.randn((BATCH, SIZE, SIZE, 4), generator=gen, device=dev)
        got = fused_ddim_update(xd, ed, s1m, sabg, sabn, s1mn)
        ref = ddim_update_plain(xd, ed, s1m, sabg, sabn, s1mn)
        torch.cuda.synchronize()
        rel = max(float(((g - r).abs() / r.abs().clamp_min(1e-30)).max())
                  for g, r in zip(got, ref))
        err["fused_ddim_update"] = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        print(f"check ddim_update {tuple(xd.shape)} max_abs_err={err['fused_ddim_update']:.3g} "
              f"max_rel_err={rel:.3g} {'ok' if rel <= 1e-6 else 'FAIL'}", flush=True)
        require(rel <= 1e-6, "fused_ddim_update kernel disagrees")
        del xd, ed, got, ref

    with Phase("probe kernels vs plain versions"):
        for M, K, N in MATMUL_SHAPES:
            a8 = torch.randint(-128, 128, (M, K), generator=gen, device=dev).to(torch.int8)
            b8 = torch.randint(-128, 128, (K, N), generator=gen, device=dev).to(torch.int8)
            got8, ref8 = matmul(a8, b8, torch.int32), matmul_plain(a8, b8, torch.int32)
            exact = torch.equal(got8, ref8)
            err["matmul int8"] = max(err["matmul int8"], float((got8 - ref8).abs().max()))
            ab16 = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
            bb16 = torch.randn((K, N), generator=gen, device=dev).to(torch.bfloat16)
            ref32 = matmul_plain(ab16, bb16, torch.float32)
            # f32 sums in two orders: 2·K·2^-24·Σ|a·b|; a bf16 output one bf16 ulp more
            tol = 2 * K * 2.0 ** -24 * matmul_plain(ab16.abs(), bb16.abs(), torch.float32)
            d32 = (matmul(ab16, bb16, torch.float32) - ref32).abs()
            got16 = matmul(ab16, bb16, torch.bfloat16).float()
            d16 = (got16 - ref32).abs()
            ok = (exact and bool((d32 <= tol).all())
                  and bool((d16 <= tol + ref32.abs() * 2.0 ** -8).all()))
            e = max(float(d32.max()),
                    float((got16 - matmul_plain(ab16, bb16, torch.bfloat16).float()).abs().max()))
            err["matmul bf16"] = max(err["matmul bf16"], e)
            print(f"check matmul {M}x{K}x{N}: int8 bit-equal={exact}, bf16->f32 max_abs_err="
                  f"{float(d32.max()):.3g}, bf16->bf16 max_abs_err {e:.3g} (against the plain "
                  f"bf16 output) {'ok' if ok else 'FAIL'}", flush=True)
            require(ok, f"matmul kernel disagrees at {M}x{K}x{N}")
            del a8, b8, got8, ref8, ab16, bb16, ref32, tol, d32, got16, d16
        for H, W, C, TH in HALO_CASES:
            x = torch.randn((H, W, C), generator=gen, device=dev)
            got, ref = halo_rows_x2(x, TH), halo_rows_x2_plain(x)
            ok = bool(torch.equal(got, ref))
            err["halo_rows_x2"] = max(err["halo_rows_x2"], float((got - ref).abs().max()))
            print(f"check halo_rows_x2 ({H},{W},{C}) TH={TH}: {H - 2} rows, "
                  f"{(H - 2 + TH - 1) // TH} row tiles, bit-equal={ok}", flush=True)
            require(ok, f"halo kernel disagrees at ({H},{W},{C}) TH={TH}")
        torch.cuda.empty_cache()

    with Phase("conv kernel at the base-96, 16x2 and 12 shapes vs plain version"):
        paths = [("base-96 ", conv_inputs96, shapes96)]
        for spec, _ in RUNGS:
            st = student(spec)
            paths.append((f"{spec} ", make_inputs(st, quantize_weights(st)[0], False),
                           conv_shapes(st, body=SIZE // spec_arch(spec)[1])))
        for label, inputs, shp in paths:
            for name, H, Cin, Cout, mode in shp:
                B = 1 if H == SIZE else 2
                for m in ("bf16", "int8") if mode == "int8" else ("bf16",):
                    key, e = check_conv(inputs, name, B, H, Cin, Cout, m, label)
                    err[key] = max(err[key], e)
        del paths
        torch.cuda.empty_cache()

    # the CFG path's int8 net (the cfg_v teacher, rollout-calibrated at g=3,
    # per-channel scales, conv1 in bf16) and its samplers, made once here
    # outside every driven path; 4e drives the line itself
    cfg_state = bench.cfg_state(device=dev)
    cfg_calls = bench.make_cfg_samplers(cfg_state, device=dev)
    cfg_qp = cfg_calls["qp"]
    cfg_shapes = conv_shapes(cfg_state, body=SIZE, bf16_blocks=CFG_BF16_BLOCKS)

    def cfg_inputs(name, B, H, Cin, Cout, mode):
        """Per-channel int8 inputs at a CFG conv: the net's folded int8 weights,
        deq = sw and scales; activations with each channel's range at 0.3-1.2x
        its calibrated one (some clip at 127)."""
        sx = cfg_qp.sx[name]
        spread = 0.3 + 0.9 * torch.rand((Cin,), generator=gen, device=dev)
        x = ((2 * torch.rand((B, H, H, Cin), generator=gen, device=dev) - 1)
             * (127 * sx * spread)).to(torch.bfloat16)
        return x, cfg_qp.w8[name][0], cfg_qp.bias[name], (sx, cfg_qp.deq[name])

    with Phase("conv kernel: per-channel int8 at the CFG shapes, both modes at the ladder's"):
        err["conv3x3_relu_int8 per_channel"] = 0.0
        for name, H, Cin, Cout, mode in cfg_shapes:
            if mode == "int8":
                _, e = check_conv(cfg_inputs, name, CFG_CHECK_BATCH, H, Cin, Cout, "int8",
                                  "cfg per-channel ")
                err["conv3x3_relu_int8 per_channel"] = max(
                    err["conv3x3_relu_int8 per_channel"], e)
        torch.cuda.empty_cache()
        # the quantizer per channel: every finite bf16 value, 32 scales at a time
        for _ in range(10):
            pick = torch.randint(len(mags), (32,), generator=gen, device=dev)
            ks = torch.randint(127, (32,), generator=gen, device=dev).float() + 0.5
            sxv = (mags[pick] / ks).contiguous()
            same = torch.equal(conv3x3_relu_int8(xq, wq, sxv, ones, zeros, False),
                               conv3x3_relu_int8_plain(xq, wq, sxv, ones, zeros, False))
            require(same, f"the per-channel int8 quantizer disagrees at sx={sxv.tolist()}")
        print("check int8 quantizer per channel: all 65280 finite bf16 values, 10 x 32 "
              "scales near k + 1/2, bit-equal", flush=True)
        for spec in LADDER_SHAPES:
            st = student(spec)
            inputs = make_inputs(st, quantize_weights(st)[0], False)
            for name, H, Cin, Cout, mode in conv_shapes(st, body=SIZE):
                B = 1 if H == SIZE else 2
                for m in ("bf16", "int8") if mode == "int8" else ("bf16",):
                    key, e = check_conv(inputs, name, B, H, Cin, Cout, m, f"{spec} ")
                    err[key] = max(err[key], e)
            del st, inputs
        torch.cuda.empty_cache()

    with Phase("kernels at the crossval nets' shapes (base 16, 32x32 down to 8x8)"):
        for net, B in CROSSVAL_CHECKS:
            st = {k: v.to(dev) for k, v in params_from_numpy(load_params(
                str(ref_crossval.REF_DIR / f"ref_{net}_model.pth"))).items()}
            inputs = make_inputs(st, quantize_weights(st)[0], False)
            for name, H, Cin, Cout, mode in conv_shapes(st, body=ref_crossval.SIZE):
                for m in ("bf16", "int8") if mode == "int8" else ("bf16",):
                    key, e = check_conv(inputs, name, B, H, Cin, Cout, m, f"crossval {net} ")
                    err[key] = max(err[key], e)
        # the harness's padded last batch: its last rows repeat a file
        xd = torch.randn((4, ref_crossval.SIZE, ref_crossval.SIZE, 4), generator=gen, device=dev)
        ed = torch.randn(xd.shape, generator=gen, device=dev)
        xd[2:], ed[2:] = xd[1].clone(), ed[1].clone()
        got = fused_ddim_update(xd, ed, s1m, sabg, sabn, s1mn)
        ref = ddim_update_plain(xd, ed, s1m, sabg, sabn, s1mn)
        rel = max(float(((g - r).abs() / r.abs().clamp_min(1e-30)).max()) for g, r in zip(got, ref))
        same = all(torch.equal(g[3], g[1]) and torch.equal(g[2], g[1]) for g in got)
        err["fused_ddim_update"] = max(err["fused_ddim_update"],
                                       max(float((g - r).abs().max()) for g, r in zip(got, ref)))
        print(f"check ddim_update padded batch {tuple(xd.shape)} max_rel_err={rel:.3g} padded rows "
              f"equal={same} {'ok' if rel <= 1e-6 and same else 'FAIL'}", flush=True)
        require(rel <= 1e-6 and same, "fused_ddim_update disagrees on a padded batch")
        del xd, ed, got, ref
        torch.cuda.empty_cache()

    with Phase("main path: run_headline('24x4')"):
        r = drive("headline 24x4", lambda: run_headline("24x4", batch=BATCH, device=dev,
                                                        size=SIZE))
        launches = path_launches["headline 24x4"]
        ev = r["evidence_launches"]
        print(f"evidence MAE {r['mae']:.5f} (committed {EVIDENCE_MAE}, difference "
              f"{r['mae'] - EVIDENCE_MAE:+.5f}; teacher anchor {TEACHER_ANCHOR}) "
              f"quality_checked={r['quality_checked']}", flush=True)
        print(f"int8 ddim-1 B={r['batch']}: {r['patches_per_s']:.1f} patches/s "
              f"({r['ms_per_batch']:.3f} ms/batch) on {card}", flush=True)
        print(f"launches in the evidence ddim-1 {ev}; "
              f"phase seconds { {k: round(v, 2) for k, v in r['seconds'].items()} }",
              flush=True)
        require(abs(r["mae"] - EVIDENCE_MAE) < 0.02 and r["mae"] <= 0.95 * TEACHER_ANCHOR,
                 f"evidence MAE {r['mae']} fails the headline check")
        require(r["pred_finite"] and r["pred_shape"] == (32, SIZE, SIZE, 4),
                f"bad prediction {r['pred_shape']} finite={r['pred_finite']}")
        require(ev["conv3x3_relu"] >= 1 and ev["conv3x3_relu_int8"] >= 12
                and ev["fused_ddim_update"] >= 1, f"the evidence ddim-1 missed a kernel: {ev}")
        require(min(launches[k] for k in ev) >= 1,
                f"a kernel was not launched on the main path: {launches}")

    def forward_check(what, y_dev, y_cpu, bound, reason):
        d = (y_dev - y_cpu).abs()
        print(f"{what} card vs cpu: max_abs {float(d.max()):.4g} mean_abs {float(d.mean()):.4g} "
              f"(bound {bound:.4g}: {reason}; |eps| mean {float(y_cpu.abs().mean()):.4g})",
              flush=True)
        require(bool(torch.isfinite(y_dev).all()) and float(d.mean()) <= bound,
                f"the card's {what} disagrees with the CPU plain path")

    def int8_forward_check(what, qp, xin, tin, n_int8=12):
        """The card's int8 forward against the CPU plain path, op by op
        (``check_ops``): every op fed the same input gives the same output, up
        to the bf16 rounding of ``inc``, the up-convs and the head. The whole
        forward's mean |card − CPU| is printed beside the int8 quantization
        error (mean |int8 − bf16| of the same model on the CPU), not held to
        a bound: a one-ulp change in a bf16 op can move an activation across
        an int8 step in every block after it."""
        e_dev, calls = record_ops(quant, qp, xin, tin)
        rows = check_ops(torch, F, quant, what, calls)
        require(len(rows) == 20 and sum(r[0] == "conv3x3_relu_int8" for r in rows) == n_int8,
                f"{what}: the int8 forward ran {[r[0] for r in rows]}")
        qpc = qp.to("cpu")
        e_cpu = quant_apply(qpc, xin.cpu(), tin.cpu())
        e_bf16 = load_unet(qpc.params, qpc.out_ch, qpc.base_ch, qpc.stem_s2d,
                           device="cpu")(xin.cpu(), tin.cpu())
        gap = float((e_cpu - e_bf16).abs().mean())
        d = float((e_dev.cpu() - e_cpu).abs().mean())
        print(f"{what}: 20 ops, {sum(r[1] == 0 for r in rows)} bit-equal, the rest within "
              f"their bounds (worst |d|/bound of a bf16 op "
              f"{max(r[3] for r in rows if r[0] not in ('conv3x3_relu_int8', 'max_pool2')):.3g}); "
              f"whole forward mean |card - cpu| {d:.4g} = {d / gap:.3f} x the int8-vs-bf16 "
              f"gap {gap:.4g} (|eps| mean {float(e_cpu.abs().mean()):.4g})", flush=True)
        require(bool(torch.isfinite(e_dev).all()), f"{what}: the card's output is not finite")

    with Phase("int8 forward, card against the CPU plain path, op by op"):
        # the main path's calibrated model, on two random inputs at full size
        xin = torch.rand((2, SIZE, SIZE, 8), generator=gen, device=dev)
        tin = torch.full((2,), 200, dtype=torch.int32, device=dev)
        int8_forward_check("24x4 int8 forward", r["qp"], xin, tin)

    with Phase("base-96 forwards, card against the CPU plain path"):
        xin = torch.rand((2, SIZE, SIZE, 8), generator=gen, device=dev)
        tin = torch.tensor([999, 200], dtype=torch.int32, device=dev)
        # bf16: the bound tests/test_torch_unet.py puts on two bf16 forwards
        # whose convs round at other places (mean |Δ| ≤ 1.5% of mean |ε|)
        y_dev = load_unet(state96_cpu, 4, 96, 1, device=dev)(xin, tin).cpu()
        y_cpu = load_unet(state96_cpu, 4, 96, 1, device="cpu")(xin.cpu(), tin.cpu())
        forward_check("base-96 bf16 forward", y_dev, y_cpu,
                      0.015 * float(y_cpu.abs().mean()), "1.5% of mean |eps|")
        cond, gt = bench.data(8, 3, SIZE, dev)
        qp96 = quantize_unet(state96, make_sampler_calib(
            gt, cond, Schedule.cosine(1000).alpha_bar_np(), bench.CALIB_TVALS), base_ch=96)
        int8_forward_check("base-96 int8 forward", qp96, xin, tin)
        del qp96, cond, gt, y_dev, y_cpu
        torch.cuda.empty_cache()

    def bench_line(path, fn, expect):
        r = drive(path, fn)
        n = path_launches[path]
        print(f"{r['metric']} B={r['batch']}: {r['value']:.3f} patches/s "
              f"({r['ms_per_batch']} ms per batch) on {card}", flush=True)
        require(r["finite"] and r["shape"] == [r["batch"], SIZE, SIZE, 4],
                f"{path}: bad output {r['shape']} finite={r['finite']}")
        require(n == expect, f"{path}: launches {n}, expected {expect}")
        torch.cuda.empty_cache()
        return r

    calls = 2  # one warm-up and one timed call
    with Phase(f"bench line 1: bf16 DDIM-50 from t=999 at B={SMOKE_LINE1_BATCH}"):
        line1 = bench_line("bench line 1", lambda: bench.bench_bf16_ddim(
            state96_cpu, batch=SMOKE_LINE1_BATCH, steps=50, warmup=1, iters=1, device=dev),
            {"conv3x3_relu": calls * 13 * 50, "conv3x3_relu_int8": 0,
             "fused_ddim_update": calls * 50, "matmul": 0, "halo_rows_x2": 0})
    with Phase(f"bench line 2: int8 DPM-Solver++(2M)-5 at B={bench.LINE2_BATCH}"):
        line2 = bench_line("bench line 2", lambda: bench.bench_int8_dpm(
            state96_cpu, batch=bench.LINE2_BATCH, warmup=1, iters=1, device=dev),
            {"conv3x3_relu": 4 * 13 + calls * 5, "conv3x3_relu_int8": calls * 5 * 12,
             "fused_ddim_update": 0, "matmul": 0, "halo_rows_x2": 0})

    with Phase("headline fallbacks: run_headline('16x2') and ('12')"):
        for spec, expect in RUNGS:
            rr = drive(f"headline {spec}", lambda spec=spec: run_headline(
                spec, batch=BATCH, device=dev, size=SIZE))
            n = path_launches[f"headline {spec}"]
            print(f"{spec}: evidence MAE {rr['mae']:.5f} (committed {expect}, teacher anchor "
                  f"{TEACHER_ANCHOR}) quality_checked={rr['quality_checked']}; int8 ddim-1 "
                  f"B={rr['batch']}: {rr['patches_per_s']:.1f} patches/s "
                  f"({rr['ms_per_batch']:.3f} ms/batch)", flush=True)
            require(abs(rr["mae"] - expect) < 0.02 and rr["mae"] <= 0.95 * TEACHER_ANCHOR
                    and rr["quality_checked"], f"{spec}: evidence MAE {rr['mae']} fails")
            require(rr["pred_finite"] and rr["pred_shape"] == (32, SIZE, SIZE, 4),
                    f"{spec}: bad prediction {rr['pred_shape']}")
            require(min(n["conv3x3_relu"], n["conv3x3_relu_int8"], n["fused_ddim_update"]) >= 1,
                    f"{spec}: a kernel was not launched: {n}")
            xin = torch.rand((2, SIZE, SIZE, 8), generator=gen, device=dev)
            int8_forward_check(f"{spec} int8 forward", rr["qp"], xin,
                               torch.full((2,), 200, dtype=torch.int32, device=dev))
            del rr
        torch.cuda.empty_cache()

    with Phase("CFG line: cfg_sweep bf16 and int8, then the B=32 sampler"):
        cfg_line = drive("cfg line", lambda: bench.bench_cfg(device=dev))
        n = path_launches["cfg line"]
        mae = {m: cfg_line[f"verified_mae_{m}"] for m in ("bf16", "int8")}
        print(f"{cfg_line['metric']} B={cfg_line['batch']}: int8 {cfg_line['value']:.3f} "
              f"patches/s, bf16 {cfg_line['bf16_patches_per_s']:.3f} patches/s (speedup "
              f"{cfg_line['int8_speedup_vs_bf16']:.4f}; ms per batch "
              f"{cfg_line['ms_per_batch']}) on {card}", flush=True)
        print(f"cfg_sweep g=3 MAE bf16 {mae['bf16']:.6f} (committed {bench.CFG_ANCHORS['bf16']}, "
              f"difference {mae['bf16'] - bench.CFG_ANCHORS['bf16']:+.5f}), int8 "
              f"{mae['int8']:.6f} (committed {bench.CFG_ANCHORS['int8']}, difference "
              f"{mae['int8'] - bench.CFG_ANCHORS['int8']:+.5f}); quality_checked="
              f"{cfg_line['quality_checked']}", flush=True)
        require(cfg_line["quality_checked"], f"CFG line: int8 MAE {mae['int8']} is above "
                                             f"bf16 {mae['bf16']} + 0.002")
        for m in ("bf16", "int8"):
            require(abs(mae[m] - bench.CFG_ANCHORS[m]) < MAE_SLACK,
                    f"CFG line: {m} MAE {mae[m]} is not within {MAE_SLACK} of "
                    f"{bench.CFG_ANCHORS[m]}")
        require(cfg_line["finite"] and cfg_line["shape"] == [bench.CFG_BATCH, SIZE, SIZE, 4],
                f"CFG line: bad output {cfg_line['shape']} finite={cfg_line['finite']}")
        # forwards: S steps a sampler call; the int8 net runs 3 bf16 convs (inc,
        # conv1) and 10 int8 ones, the bf16 net 13; each rollout calibration
        # is one bf16 CFG rollout of S forwards and 2S calibration forwards;
        # the int8 pass's context first calibrates on q_sample states as the
        # JAX harness does (3 timesteps, cond and null-cond: 6 forwards)
        S = len(bench.round_unique_grid(*bench.CFG_GRID))
        batches = -(-(bench.CFG_SET[2] - bench.CFG_SET[1]) // 8)  # cfg_sweep's batch_size 8
        calls = 1 + bench.CFG_ITERS
        calib = 3 * S * 13
        expect = {"conv3x3_relu": batches * S * 13 + 6 * 13 + 2 * calib + batches * S * 3
                  + calls * S * 13 + calls * S * 3,
                  "conv3x3_relu_int8": batches * S * 10 + calls * S * 10,
                  "fused_ddim_update": 0, "matmul": 0, "halo_rows_x2": 0}
        require(n == expect, f"CFG line: launches {n}, expected {expect}")
        require(int8_launches["cfg line"]["per_tensor"] == 0,
                f"CFG line: per-tensor int8 launches {int8_launches['cfg line']}")
        torch.cuda.empty_cache()

    with Phase("CFG int8 forward, card against the CPU plain path, op by op"):
        xin = torch.rand((2, SIZE, SIZE, 8), generator=gen, device=dev)
        xin[1, ..., 4:] = 0.0  # the stacked null-cond row
        int8_forward_check("cfg int8 forward", cfg_qp, xin,
                           torch.tensor([999, 999], dtype=torch.int32, device=dev), n_int8=10)
        torch.cuda.empty_cache()

    with Phase("width ladder: bench_widths"):
        ladder = drive("width ladder", lambda: bench.bench_widths(device=dev, emit=lambda _: None))
        n = path_launches["width ladder"]
        require([ln["metric"] for ln in ladder] == [bench.HEADLINE.format(spec)
                                                    for spec, _, _ in bench.WIDTHS],
                f"the ladder ran {[ln['metric'] for ln in ladder]}")
        for ln in ladder:
            spec = ln["metric"].split("_w")[1].split("_")[0]
            print(f"{ln['metric']}: {ln['value']:.1f} patches/s ({ln['config']}; "
                  f"{ln['ms_per_batch']:.4f} ms/batch) on {card}; evidence MAE "
                  f"{ln['verified_mae']:.5f} (committed {ln['expect_mae']}, difference "
                  f"{ln['verified_mae'] - ln['expect_mae']:+.5f})", flush=True)
            require(abs(ln["verified_mae"] - ln["expect_mae"]) < MAE_SLACK
                    and ln["verified_mae"] <= 0.95 * TEACHER_ANCHOR and ln["quality_checked"],
                    f"ladder rung {spec}: evidence MAE {ln['verified_mae']} fails")
        per_rung = path_launches["headline 24x4"]
        require(n == {k: len(bench.WIDTHS) * v for k, v in per_rung.items()},
                f"ladder launches {n}, expected {len(bench.WIDTHS)} x {per_rung}")
        torch.cuda.empty_cache()

    def quiet(fn):
        """``fn`` with its standard output (the evaluate CLI's result lines)
        dropped."""
        def run():
            with contextlib.redirect_stdout(io.StringIO()):
                return fn()
        return run

    def worst_col(table):
        """(column, max |Δ|, share of its tolerance) of a report table's
        worst column."""
        cols = table["cols"]
        col = max(cols, key=lambda c: cols[c]["max_dev"] / cols[c]["tol"])
        return col, cols[col]["max_dev"], cols[col]["max_dev"] / cols[col]["tol"]

    with Phase("crossval: ref_crossval in bf16 on the card and on the CPU plain path"):
        with tempfile.TemporaryDirectory() as td:
            card_dir, cpu_dir = Path(td) / "card", Path(td) / "cpu"
            t0 = time.perf_counter()
            drive("crossval", quiet(lambda: ref_crossval.run_replay(card_dir, "cuda",
                                                                    "bfloat16")))
            card_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            quiet(lambda: ref_crossval.run_replay(cpu_dir, "cpu", "bfloat16"))()
            cpu_s = time.perf_counter() - t0
            reps = {"card": ref_crossval.check(card_dir, "bfloat16"),
                    "cpu": ref_crossval.check(cpu_dir, "bfloat16"),
                    "card vs cpu": ref_crossval.check(card_dir, "bfloat16", against=cpu_dir)}
        for table in reps["card"]["tables"]:
            print(f"crossval {table}: " + "; ".join(
                "{} {} max |d| {:.3g} = {:.3f} of tol".format(what, *worst_col(
                    rep["tables"][table])) for what, rep in reps.items()), flush=True)
        n = path_launches["crossval"]
        print(f"crossval bf16: card {card_s:.2f} s, CPU {cpu_s:.2f} s; tables pass: "
              + ", ".join(f"{w} {r['tables_pass']}/{r['tables_total']}" for w, r in reps.items()),
              flush=True)
        for what, rep in reps.items():
            require(rep["pass"] and rep["tables_total"] == 27,
                    f"crossval {what}: {rep['tables_pass']}/{rep['tables_total']} tables pass")
        require(n["conv3x3_relu"] >= 1 and n["fused_ddim_update"] >= 1
                and n["conv3x3_relu_int8"] == 0, f"crossval launches {n}")

    with Phase(f"full width: cli.evaluate's table modes on the base-96 teachers, "
               f"{FULL_FILES} files of {SIZE}x{SIZE}"):
        from s1s2_torch.cli import evaluate
        from s1s2_torch.core import random
        from s1s2_torch.core.parametrize import Parameterization, q_sample
        from s1s2_torch.data.synthetic import make_synthetic_patches
        from s1s2_torch.eval.metrics import masked_mae
        from s1s2_torch.sampling.grids import round_unique_grid
        from s1s2_torch.sampling.samplers import (ddim_anchored, ddim_grid_sample,
                                                  make_denoise_fn)

        teacher = {p: str(CKPT_DIR / f"distill_{p}_teacher.bf16.msgpack") for p in ("eps", "v")}
        nb = FULL_FILES // FULL_BATCH
        ddim = {"conv3x3_relu": nb * FULL_STEPS * 13, "conv3x3_relu_int8": 0,
                "fused_ddim_update": nb * FULL_STEPS, "matmul": 0, "halo_rows_x2": 0}
        one = {**ddim, "conv3x3_relu": nb * 13, "fused_ddim_update": 0}
        # (name, flags, exact launch counts, or None: the int8 mode, checked below)
        full = (("ddim eps", ["--mode", "ddim", "--ckpt", teacher["eps"]], ddim),
                ("ddim v", ["--mode", "ddim", "--ckpt", teacher["v"], "--pred_param", "v"],
                 {**ddim, "fused_ddim_update": 0}),
                ("ddim eps int8", ["--mode", "ddim", "--ckpt", teacher["eps"], "--int8"], None),
                ("per_band", ["--mode", "per_band", "--ckpt", teacher["eps"]], one),
                ("eps", ["--mode", "eps", "--ckpt", teacher["eps"]], one),
                ("vdiag", ["--mode", "vdiag", "--ckpt", teacher["v"]], one),
                ("onestep", ["--mode", "onestep", "--ckpt", teacher["eps"]],
                 {**one, "conv3x3_relu": 13}))
        files = {"ddim": ["ddim_metrics.csv", "ddim_summary.txt"],
                 "per_band": ["per_band_all.csv", "per_band_summary.csv"],
                 "eps": ["eps_diag.csv", "eps_summary.txt"],
                 "vdiag": ["vdiag.csv", "vdiag_summary.txt"],
                 "onestep": ["onestep_summary.txt", "pred_true.png", "gt_cir.png"]}
        res = {}
        with tempfile.TemporaryDirectory() as td:
            make_synthetic_patches(f"{td}/p", n=FULL_FILES, size=SIZE, seed=0)
            for name, flags, expect in full:
                out = f"{td}/{name.replace(' ', '_')}"
                argv = flags + ["--patch_dir", f"{td}/p", "--out_dir", out, "--t_start", "200",
                                "--ddim_steps", str(FULL_STEPS)]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res[name] = r = drive(f"full {name}", quiet(lambda argv=argv: evaluate.main(argv)))
                dt = time.perf_counter() - t0
                n = path_launches[f"full {name}"]
                print(f"full {name}: {dt:.2f} s, {FULL_FILES / dt:.2f} patches/s on {card}; "
                      f"{ {k: round(float(v), 6) for k, v in r.items()} }", flush=True)
                mode = flags[1]
                written = files[mode] + (["previews/000_ddim_pred_true.png"] if mode == "ddim"
                                         else ["previews/005_pb_pred_cir.png"]
                                         if mode == "per_band" else [])
                require(all(Path(out, f).is_file() for f in written), f"full {name}: missing "
                        f"{[f for f in written if not Path(out, f).is_file()]}")
                require(all(np.isfinite(float(v)) for v in r.values()), f"full {name}: {r}")
                if expect is None:
                    require(n["conv3x3_relu_int8"] == nb * FULL_STEPS * 12
                            and n["fused_ddim_update"] == nb * FULL_STEPS
                            and n["conv3x3_relu"] >= nb * FULL_STEPS,
                            f"full {name}: launches {n}")
                else:
                    require(n == expect, f"full {name}: launches {n}, expected {expect}")
        for p, name in (("eps", "ddim eps"), ("v", "ddim v")):
            print(f"harness ddim-20 {p} teacher MAE {res[name]['MAE_mean']:.5f} (anchor "
                  f"{TEACHER_ANCHORS[p]}, difference {res[name]['MAE_mean'] - TEACHER_ANCHORS[p]:+.5f})",
                  flush=True)
        print(f"int8 ddim-20 eps teacher MAE {res['ddim eps int8']['MAE_mean']:.5f} beside bf16 "
              f"{res['ddim eps']['MAE_mean']:.5f}", flush=True)
        require(abs(res["ddim eps"]["MAE_mean"] - TEACHER_ANCHORS["eps"]) < MAE_SLACK,
                f"harness ddim-20 eps MAE {res['ddim eps']['MAE_mean']} is not within "
                f"{MAE_SLACK} of {TEACHER_ANCHORS['eps']}")

        # the anchors' own protocol (tools/bench_distill.py): the whole
        # evidence set under one batch key, ε GT-anchored linspace DDIM, v
        # the round-unique grid from the GT-anchored init
        cond_np, gt_np, mask_np = evidence_set(FULL_FILES, SIZE)
        noise = torch.from_numpy(random.normal(random.PRNGKey(1234), gt_np.shape)).to(dev)
        cond_t, gt_t, mask_t = (torch.from_numpy(a).to(dev) for a in (cond_np, gt_np, mask_np))
        sched = Schedule.cosine(1000)
        ab = sched.alpha_bar_np()
        grid = round_unique_grid(200, FULL_STEPS, 1000)
        K = int(grid[-1])
        x_init = q_sample(gt_t, noise, float(np.sqrt(ab[K])), float(np.sqrt(1.0 - ab[K])))
        anchored = {}
        for p in ("eps", "v"):
            model = load_unet(params_from_numpy(load_params(teacher[p])), 4, 96, 1, device=dev)
            preds = []
            for i in range(0, FULL_FILES, FULL_BATCH):
                fn = make_denoise_fn(model, cond_t[i:i + FULL_BATCH])
                preds.append(ddim_anchored(fn, gt_t[i:i + FULL_BATCH], sched, 200, FULL_STEPS,
                                           noise=noise[i:i + FULL_BATCH]) if p == "eps" else
                             ddim_grid_sample(fn, x_init[i:i + FULL_BATCH], sched, grid,
                                              Parameterization.V))
            anchored[p] = float(masked_mae(torch.cat(preds), gt_t, mask_t))
            print(f"bench_distill protocol ddim-20 {p} teacher MAE {anchored[p]:.5f} (anchor "
                  f"{TEACHER_ANCHORS[p]}, difference {anchored[p] - TEACHER_ANCHORS[p]:+.5f})",
                  flush=True)
            require(abs(anchored[p] - TEACHER_ANCHORS[p]) < MAE_SLACK,
                    f"{p} teacher on the anchor's protocol: MAE {anchored[p]} is not within "
                    f"{MAE_SLACK} of {TEACHER_ANCHORS[p]}")
            del model, preds
        del noise, cond_t, gt_t, mask_t, x_init
        torch.cuda.empty_cache()

    with Phase("probe path: probe_int8 all"):
        probe = drive("probe", lambda: probe_int8.main(["all"]))
        n = path_launches["probe"]
        require(min(matmul_launches["probe"].values()) >= 1 and n["halo_rows_x2"] >= 1,
                f"the probe path missed a kernel: {n}, matmul by mode {matmul_launches['probe']}")
        torch.cuda.empty_cache()

    rows = []
    with Phase(f"timing at B={BATCH} on {card}"):
        B = BATCH
        # sums over the launches of one int8 forward (bf16 mode: inc only)
        totals = {k: dict(ms=0.0, plain=0.0, bound=0.0, library=0.0, bytes=0.0, operations=0.0)
                  for k in ("conv3x3_relu", "conv3x3_relu_int8")}
        for name, H, Cin, Cout, mode in shapes:
            for m in ("bf16", "int8") if mode == "int8" else ("bf16",):
                on_path = (m == mode)  # launched by the timed int8 forward
                ms, plain_ms, lib_ms, bound, by = time_conv(
                    conv_inputs, name, B, H, Cin, Cout, m, 20, 2,
                    "" if on_path else " [calibration mode]")
                if on_path:
                    t = totals["conv3x3_relu" if m == "bf16" else "conv3x3_relu_int8"]
                    t["ms"] += ms
                    t["plain"] += plain_ms
                    t["bound"] += bound
                    t["library"] += lib_ms or 0.0
                    t[by] += bound
        xd = [torch.randn((B, SIZE, SIZE, 4), generator=gen, device=dev) for _ in range(3)]
        ddim_args = [(xd[i], xd[(i + 1) % 3], s1m, sabg, sabn, s1mn) for i in range(3)]
        d_ms = time_ms(torch, fused_ddim_update, ddim_args, 50)
        d_plain = time_ms(torch, ddim_update_plain, ddim_args, 20)
        d_bound = 1e3 * 16 * xd[0].numel() / HBM_BYTES_PER_S
        print(f"time ddim_update {tuple(xd[0].shape)}: kernel {d_ms:.4f} ms, plain {d_plain:.4f} ms, "
              f"bound {d_bound:.4f} ms (bytes)", flush=True)
        del xd, ddim_args
        torch.cuda.empty_cache()

    with Phase(f"timing at the base-96 shapes and the probe's on {card}"):
        sums = {m: dict(ms=0.0, plain=0.0, library=0.0, bound=0.0) for m in ("bf16", "int8")}
        for name, H, Cin, Cout, mode in shapes96:
            for m, B in (("bf16", bench.LINE1_BATCH), ("int8", bench.LINE2_BATCH)) \
                    if mode == "int8" else (("bf16", bench.LINE1_BATCH),):
                ms, plain_ms, lib_ms, bound, _ = time_conv(conv_inputs96, name, B, H, Cin,
                                                           Cout, m, 3, 1)
                for k, v in (("ms", ms), ("plain", plain_ms), ("library", lib_ms or 0.0),
                             ("bound", bound)):
                    sums[m][k] += v
        for m, B, what in (("bf16", bench.LINE1_BATCH, "13 convs of one bf16 forward (line 1)"),
                           ("int8", bench.LINE2_BATCH,
                            "12 int8 convs of one int8 forward (line 2)")):
            t = sums[m]
            print(f"time base-96 {what}, B={B}: kernel {t['ms']:.3f} ms, plain "
                  f"{t['plain']:.3f} ms, F.conv2d {t['library']:.3f} ms, bound "
                  f"{t['bound']:.3f} ms", flush=True)

        pc = dict(ms=0.0, plain=0.0, bound=0.0, bytes=0.0, operations=0.0)
        for name, H, Cin, Cout, mode in cfg_shapes:
            if mode == "int8":
                ms, plain_ms, _, bound, by = time_conv(cfg_inputs, name, CFG_CHECK_BATCH, H,
                                                       Cin, Cout, "int8", 3, 1,
                                                       per_channel=True)
                pc["ms"] += ms
                pc["plain"] += plain_ms
                pc["bound"] += bound
                pc[by] += bound
        print(f"time cfg 10 per-channel int8 convs of one CFG forward, B={CFG_CHECK_BATCH}: "
              f"kernel {pc['ms']:.3f} ms, plain {pc['plain']:.3f} ms, bound {pc['bound']:.3f} ms",
              flush=True)

        M, K, N = MATMUL_SHAPES[1]
        mm = {}
        for mode in ("bf16", "int8"):
            if mode == "bf16":
                ins = [(torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16),
                        torch.randn((K, N), generator=gen, device=dev).to(torch.bfloat16))
                       for _ in range(2)]
                kfn = lambda a, b: matmul(a, b, torch.bfloat16)  # noqa: E731
                pfn = lambda a, b: matmul_plain(a, b, torch.bfloat16)  # noqa: E731
                lfn = torch.matmul
            else:
                ins = [(torch.randint(-128, 128, (M, K), generator=gen, device=dev).to(torch.int8),
                        torch.randint(-128, 128, (K, N), generator=gen, device=dev).to(torch.int8))
                       for _ in range(2)]
                kfn = lambda a, b: matmul(a, b, torch.int32)  # noqa: E731
                pfn = lambda a, b: matmul_plain(a, b, torch.int32)  # noqa: E731
                lfn = torch._int_mm
            ms, plain_ms, lib_ms = (time_ms(torch, kfn, ins, 20), time_ms(torch, pfn, ins, 4),
                                    time_ms(torch, lfn, ins, 20))
            bound, by = matmul_bound_ms(M, K, N, mode)
            print(f"time matmul {mode} {M}x{K}x{N}: kernel {ms:.4f} ms "
                  f"({2 * M * K * N / ms / 1e9:.1f} T/s), plain {plain_ms:.4f} ms, "
                  f"{lfn.__name__} {lib_ms:.4f} ms, bound {bound:.4f} ms ({by}); probe best "
                  f"of 8: {probe['matmul']['kernel_' + mode]:.4f} ms", flush=True)
            mm[mode] = dict(ms=ms, plain=plain_ms, library=lib_ms, bound=bound, by=by)
            del ins
        H, W, C, TH = HALO_CASES[0]
        ins = [(torch.randn((H, W, C), generator=gen, device=dev),) for _ in range(2)]
        h_ms = time_ms(torch, lambda x: halo_rows_x2(x, TH), ins, 50)
        h_plain = time_ms(torch, halo_rows_x2_plain, ins, 50)
        h_lib = time_ms(torch, lambda x: x[1:-1] * 2.0, ins, 50)
        h_bound, h_by = halo_bound_ms(H, W, C)
        print(f"time halo_rows_x2 ({H},{W},{C}) TH={TH}: kernel {h_ms:.4f} ms, plain "
              f"{h_plain:.4f} ms, x[1:-1]*2 {h_lib:.4f} ms, bound {h_bound:.4f} ms ({h_by})",
              flush=True)
        del ins
        torch.cuda.empty_cache()

    total_launches = {k.__name__: sum(n[k.__name__] for n in path_launches.values())
                      for k in kernels}
    total_matmul = {m: sum(n[m] for n in matmul_launches.values()) for m in ("bf16", "int8")}
    src = "s1s2_torch/ops/csrc/"
    total_int8 = {m: sum(n[m] for n in int8_launches.values())
                  for m in ("per_tensor", "per_channel")}
    for key, mode, replaces, launches in (
            ("conv3x3_relu", "bf16 mode", "s1s2/ops/conv3x3.py:162",
             total_launches["conv3x3_relu"]),
            ("conv3x3_relu_int8", "int8 mode, per-tensor sx", "s1s2/ops/conv3x3.py:130",
             total_int8["per_tensor"])):
        t = totals[key]
        rows.append({"name": f"conv3x3 ({mode})", "route": "cuda",
                     "source": src + "conv3x3.cu", "replaces": replaces,
                     "launches": launches, "max_abs_err": err[key],
                     "ms": t["ms"], "plain_ms": t["plain"], "bound_ms": t["bound"],
                     "bound_by": "bytes" if t["bytes"] >= t["operations"] else "operations",
                     "library_ms": t["library"] if key == "conv3x3_relu" else None})
    rows.append({"name": f"conv3x3 (int8 mode, per-channel sx; the CFG net's 10 int8 convs, "
                         f"B={CFG_CHECK_BATCH})", "route": "cuda",
                 "source": src + "conv3x3.cu", "replaces": "s1s2/ops/conv3x3.py:130",
                 "launches": total_int8["per_channel"],
                 "max_abs_err": err["conv3x3_relu_int8 per_channel"], "ms": pc["ms"],
                 "plain_ms": pc["plain"], "bound_ms": pc["bound"],
                 "bound_by": "bytes" if pc["bytes"] >= pc["operations"] else "operations",
                 "library_ms": None})
    rows.append({"name": "fused_ddim_update", "route": "cuda",
                 "source": src + "fused_elementwise.cu",
                 "replaces": "s1s2/ops/fused_elementwise.py:56",
                 "launches": total_launches["fused_ddim_update"],
                 "max_abs_err": err["fused_ddim_update"], "ms": d_ms, "plain_ms": d_plain,
                 "bound_ms": d_bound, "bound_by": "bytes", "library_ms": None})
    for mode in ("bf16", "int8"):
        t = mm[mode]
        rows.append({"name": f"matmul ({mode} mode)", "route": "cuda",
                     "source": src + "matmul.cu", "replaces": "tools/probe_pallas_int8.py:43",
                     "launches": total_matmul[mode], "max_abs_err": err[f"matmul {mode}"],
                     "ms": t["ms"], "plain_ms": t["plain"], "bound_ms": t["bound"],
                     "bound_by": t["by"], "library_ms": t["library"]})
    rows.append({"name": "halo_rows_x2 (256,128,128) TH=32", "route": "cuda",
                 "source": src + "halo.cu", "replaces": "tools/probe_pallas_int8.py:133",
                 "launches": total_launches["halo_rows_x2"],
                 "max_abs_err": err["halo_rows_x2"], "ms": h_ms, "plain_ms": h_plain,
                 "bound_ms": h_bound, "bound_by": h_by, "library_ms": h_lib})
    print(f"bench lines on {card}: line 1 {line1['value']:.3f} patches/s at B={line1['batch']}, "
          f"line 2 {line2['value']:.3f} patches/s at B={line2['batch']}, CFG line int8 "
          f"{cfg_line['value']:.3f} / bf16 {cfg_line['bf16_patches_per_s']:.3f} patches/s at "
          f"B={cfg_line['batch']}, ladder "
          + ", ".join(f"{ln['metric'].split('_w')[1].split('_')[0]} {ln['value']:.1f}"
                      for ln in ladder) + " patches/s", flush=True)
    print(f"total launches by path: {path_launches}", flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
