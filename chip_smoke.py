#!/usr/bin/env python3
"""Smoke run of the s1s2_torch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each printing its own seconds:

1. Device: a CUDA card must be present (else exit 1, no result); prints
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``.
2. Build: compiles ``s1s2_torch/ops/csrc/*.cu`` with nvcc (ptxas lines).
3. Kernels against their plain PyTorch versions at the main path's shapes
   (the 24x4 student's 13 convs, B=8; the DDIM update at (128,256,256,4)):
   conv bf16 within 1 bf16 ulp plus the f32 accumulation-order bound,
   conv int8 bit-equal, DDIM update within 1e-6 relative.
4. Main path: ``run_headline("24x4")`` — checkpoint through the port's own
   reader, 32-file evidence set, calibration, int8 quantization, GT-anchored
   DDIM-1, masked MAE. Asserts the MAE against the committed evidence and
   the teacher anchor, that every kernel was launched (counts set to 0 just
   before), and that the card's int8 forward agrees with the CPU plain path
   on two evidence patches.
5. Timing at B=128 with CUDA events: each kernel at each path shape beside
   its plain version, ``F.conv2d`` (bf16 mode only) and its bound.

Then a ``{"kernels": [...]}`` line, the card line again, and last
``{"ok": true, "device": {...}}``. Any failure raises, and no result is
printed. The port never calls cuDNN; ``F.conv2d`` is timed here only as a
yardstick.
"""

import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}  # dense tensor-core peaks
EVIDENCE_MAE, TEACHER_ANCHOR = 0.32764, 0.44074
SIZE, BATCH, CHECK_BATCH = 256, 128, 8  # patch size, timing batch, check batch
STEM = 4  # the 24x4 student's space-to-depth factor: body at SIZE / 4
LEVEL = {"inc": 0, "down1": 0, "down2": 1, "down3": 2, "conv3": 2, "conv2": 1,
         "conv1": 0}


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


def conv_shapes(state, body):
    """[(name, H, Cin, Cout, mode)] of the main path's 13 3x3 convs."""
    out = []
    for key, k in state.items():
        if not key.endswith(".kernel") or k.shape[0] != 3:
            continue
        name = key[:-len(".kernel")]
        blk = name.split(".")[0]
        out.append((name, body >> LEVEL[blk], k.shape[2], k.shape[3],
                    "bf16" if name == "inc" else "int8"))
    return out


def conv_bound_ms(mode, B, H, Cin, Cout):
    """Least time for one conv: each input read once, each output written once,
    against the ops at the tensor-core peak of the mode's type."""
    wbytes = 2 if mode == "bf16" else 1
    nbytes = (B * H * H * Cin * 2 + 9 * Cin * Cout * wbytes + Cout * 4 * 2
              + B * H * H * Cout * 2)
    ops = 2 * 9 * B * H * H * Cin * Cout
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[mode]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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


def bf16_tolerance(torch, F, x, w, b, ref, Cin):
    """1 bf16 ulp of the larger value plus twice the f32 accumulation-order
    bound n·2^-24·Σ|terms| (n = 9·Cin + 1), per element."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        s = F.conv2d(x.float().abs().permute(0, 3, 1, 2),
                     w.float().abs().permute(3, 2, 0, 1), padding=1)
    s = s.permute(0, 2, 3, 1) + b.float().abs()
    _, e = torch.frexp(ref.float().abs())
    ulp = torch.where(ref == 0, torch.zeros_like(s), torch.ldexp(torch.ones_like(s), e - 8))
    return ulp + 2 * (9 * Cin + 1) * 2.0 ** -24 * s


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

    from s1s2_torch.core.schedule import Schedule
    from s1s2_torch.headline import CKPT_DIR, launch_counts, run_headline
    from s1s2_torch.models.quant import quant_apply, quantize_weights
    from s1s2_torch.models.weights import params_from_numpy
    from s1s2_torch.ops import _build
    from s1s2_torch.ops.conv3x3 import (conv3x3_relu, conv3x3_relu_int8,
                                        conv3x3_relu_int8_plain, conv3x3_relu_plain)
    from s1s2_torch.ops.fused_elementwise import (ddim_coefs, ddim_update_plain,
                                                  fused_ddim_update)
    from s1s2_torch.train.checkpoint import load_params

    with Phase("build"):
        info = _build.kernels().info
        print(f"built {info.path.name} compiled={info.compiled} in {info.seconds:.2f} s",
              flush=True)

    state = params_from_numpy(load_params(str(CKPT_DIR / "distill_eps_student24x4.bf16.msgpack")))
    state = {k: v.to(dev) for k, v in state.items()}
    shapes = conv_shapes(state, body=SIZE // STEM)
    w8, _ = quantize_weights(state)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def conv_inputs(name, B, H, Cin, Cout, mode):
        x = torch.randn((B, H, H, Cin), generator=gen, device=dev).abs_().to(torch.bfloat16)
        b = state[f"{name}.bias"].contiguous()
        if mode == "bf16":
            return x, state[f"{name}.kernel"].to(torch.bfloat16).contiguous(), b, None
        sx = float(x.float().abs().amax()) / 127.0
        deq = (torch.tensor(sx, dtype=torch.float32, device=dev) * w8[name][1]).contiguous()
        return x, w8[name][0], b, (sx, deq)

    err = {"conv3x3_relu": 0.0, "conv3x3_relu_int8": 0.0, "fused_ddim_update": 0.0}
    with Phase("kernels vs plain versions"):
        for name, H, Cin, Cout, mode in shapes:
            for m in ("bf16", "int8") if mode == "int8" else ("bf16",):
                x, w, b, q = conv_inputs(name, CHECK_BATCH, H, Cin, Cout, m)
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
                err[key] = max(err[key], e)
                print(f"check {m} {name} {H}x{H} {Cin}->{Cout} B={CHECK_BATCH} max_abs_err={e:.3g} "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    raise AssertionError(f"conv3x3 {m} kernel disagrees at {name}")
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
        if rel > 1e-6:
            raise AssertionError("fused_ddim_update kernel disagrees")
        del xd, ed, got, ref

    with Phase("main path: run_headline('24x4')"):
        for k in (conv3x3_relu, conv3x3_relu_int8, fused_ddim_update):
            k.launches = 0
        r = run_headline("24x4", batch=BATCH, device=dev, size=SIZE)
        launches = launch_counts()
        ev = r["evidence_launches"]
        print(f"evidence MAE {r['mae']:.5f} (committed {EVIDENCE_MAE}, teacher anchor "
              f"{TEACHER_ANCHOR}) quality_checked={r['quality_checked']}", flush=True)
        print(f"int8 ddim-1 B={r['batch']}: {r['patches_per_s']:.1f} patches/s "
              f"({r['ms_per_batch']:.3f} ms/batch) on {card}", flush=True)
        print(f"launches in the main path {launches}; in the evidence ddim-1 {ev}; "
              f"phase seconds { {k: round(v, 2) for k, v in r['seconds'].items()} }",
              flush=True)
        if not (abs(r["mae"] - EVIDENCE_MAE) < 0.02 and r["mae"] <= 0.95 * TEACHER_ANCHOR):
            raise AssertionError(f"evidence MAE {r['mae']} fails the headline check")
        if not (r["pred_finite"] and r["pred_shape"] == (32, SIZE, SIZE, 4)):
            raise AssertionError(f"bad prediction {r['pred_shape']} finite={r['pred_finite']}")
        if ev["conv3x3_relu"] + ev["conv3x3_relu_int8"] < 13 or ev["conv3x3_relu"] < 1 \
                or ev["conv3x3_relu_int8"] < 12 or ev["fused_ddim_update"] < 1:
            raise AssertionError(f"the evidence ddim-1 missed a kernel: {ev}")
        if min(launches.values()) < 1:
            raise AssertionError(f"a kernel was not launched on the main path: {launches}")

    with Phase("int8 forward, card against the CPU plain path"):
        # the main path's calibrated model, on two random inputs at full size
        qp = r["qp"]
        xin = torch.rand((2, SIZE, SIZE, 8), generator=gen, device=dev)
        tin = torch.full((2,), 200, dtype=torch.int32, device=dev)
        e_dev = quant_apply(qp, xin, tin).cpu()
        e_cpu = quant_apply(qp.to("cpu"), xin.cpu(), tin.cpu())
        d = (e_dev - e_cpu).abs()
        print(f"eps card vs cpu: max_abs {float(d.max()):.4g} mean_abs {float(d.mean()):.4g} "
              f"(|eps| mean {float(e_cpu.abs().mean()):.4g})", flush=True)
        if not (torch.isfinite(e_dev).all() and float(d.mean()) <= 1e-2 * float(e_cpu.abs().mean())):
            raise AssertionError("the card's int8 forward disagrees with the CPU plain path")

    rows = []
    with Phase(f"timing at B={BATCH} on {card}"):
        B = BATCH
        # sums over the launches of one int8 forward (bf16 mode: inc only)
        totals = {k: dict(ms=0.0, plain=0.0, bound=0.0, library=0.0, bytes=0.0, operations=0.0)
                  for k in ("conv3x3_relu", "conv3x3_relu_int8")}
        for name, H, Cin, Cout, mode in shapes:
            for m in ("bf16", "int8") if mode == "int8" else ("bf16",):
                ins = [conv_inputs(name, B, H, Cin, Cout, m) for _ in range(2)]
                if m == "bf16":
                    kfn = lambda x, w, b, q: conv3x3_relu(x, w, b)  # noqa: E731
                    pfn = lambda x, w, b, q: conv3x3_relu_plain(x, w, b)  # noqa: E731
                    wl = ins[0][1].permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)
                    bl = ins[0][2].to(torch.bfloat16)

                    def lfn(x, w, b, q, wl=wl, bl=bl):
                        return torch.relu_(F.conv2d(x.permute(0, 3, 1, 2), wl, bl, padding=1))
                    lib_ms = time_ms(torch, lfn, ins, 20)
                else:
                    kfn = lambda x, w, b, q: conv3x3_relu_int8(x, w, q[0], q[1], b)  # noqa: E731
                    pfn = lambda x, w, b, q: conv3x3_relu_int8_plain(x, w, q[0], q[1], b)  # noqa: E731
                    lib_ms = None
                ms = time_ms(torch, kfn, ins, 20)
                plain_ms = time_ms(torch, pfn, ins, 2)
                bound, by = conv_bound_ms(m, B, H, Cin, Cout)
                on_path = (m == mode)  # launched by the timed int8 forward
                print(f"time {m} {name} {H}x{H} {Cin}->{Cout}: kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms, F.conv2d {'-' if lib_ms is None else f'{lib_ms:.4f}'} ms, "
                      f"bound {bound:.4f} ms ({by}){'' if on_path else ' [calibration mode]'}",
                      flush=True)
                if on_path:
                    t = totals["conv3x3_relu" if m == "bf16" else "conv3x3_relu_int8"]
                    t["ms"] += ms
                    t["plain"] += plain_ms
                    t["bound"] += bound
                    t["library"] += lib_ms or 0.0
                    t[by] += bound
                del ins
        xd = [torch.randn((B, SIZE, SIZE, 4), generator=gen, device=dev) for _ in range(3)]
        ddim_args = [(xd[i], xd[(i + 1) % 3], s1m, sabg, sabn, s1mn) for i in range(3)]
        d_ms = time_ms(torch, fused_ddim_update, ddim_args, 50)
        d_plain = time_ms(torch, ddim_update_plain, ddim_args, 20)
        d_bound = 1e3 * 16 * xd[0].numel() / HBM_BYTES_PER_S
        print(f"time ddim_update {tuple(xd[0].shape)}: kernel {d_ms:.4f} ms, plain {d_plain:.4f} ms, "
              f"bound {d_bound:.4f} ms (bytes)", flush=True)
        del xd, ddim_args

    src = "s1s2_torch/ops/csrc/"
    for key, mode, replaces in (("conv3x3_relu", "bf16", "s1s2/ops/conv3x3.py:162"),
                                ("conv3x3_relu_int8", "int8", "s1s2/ops/conv3x3.py:130")):
        t = totals[key]
        rows.append({"name": f"conv3x3 ({mode} mode)", "route": "cuda",
                     "source": src + "conv3x3.cu", "replaces": replaces,
                     "launches": launches[key], "max_abs_err": err[key],
                     "ms": t["ms"], "plain_ms": t["plain"], "bound_ms": t["bound"],
                     "bound_by": "bytes" if t["bytes"] >= t["operations"] else "operations",
                     "library_ms": t["library"] if mode == "bf16" else None})
    rows.append({"name": "fused_ddim_update", "route": "cuda",
                 "source": src + "fused_elementwise.cu",
                 "replaces": "s1s2/ops/fused_elementwise.py:56",
                 "launches": launches["fused_ddim_update"],
                 "max_abs_err": err["fused_ddim_update"], "ms": d_ms, "plain_ms": d_plain,
                 "bound_ms": d_bound, "bound_by": "bytes", "library_ms": None})
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
