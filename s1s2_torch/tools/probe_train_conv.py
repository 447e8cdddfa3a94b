"""Probe: how exact the training path's f32 conv is on the card.

    python -m s1s2_torch.tools.probe_train_conv [--shape B H W Cin Cout]

Runs ``ops/conv3x3.conv3x3_relu_train`` (cuDNN's conv through autograd)
forward and backward in f32 on the card and on the CPU, and holds the
output and the three gradients (x, w, b) to the same function in float64
on the CPU: ‖a − ref‖ / ‖ref‖ for each. On the card it runs under each of
PyTorch's TF32 settings (its defaults, which let cuDNN round f32 to TF32;
the legacy ``allow_tf32`` flag in ``cudnn.flags``; the conv's own
``fp32_precision``; cuDNN switched off), and once more as plain autograd
``F.conv2d`` under the defaults: what the port ran before it kept its f32
conv off TF32. A conv that rounds its operands to TF32 shows about 1e-3 on
its output; f32 sums in another order about 1e-6. The gradients also move
with every output whose pre-activation two evaluations put on either side
of the ReLU: the CPU rows count those between f32 and float64 and give the
distances again with their upstream gradient set to 0. The default shape
is ``tests/test_torch_gpu.py``'s largest train-conv case. The card's rows
need a CUDA card; without one the tool stops after the CPU's.
"""

from __future__ import annotations

import argparse
import contextlib

import torch
import torch.nn.functional as F

from s1s2_torch.ops.conv3x3 import conv3x3_relu_train

NAMES = ("y", "dx", "dw", "db")


def plain_train_conv(x, w, b):
    """``conv3x3_relu_train`` as plain autograd ``F.conv2d`` in x's dtype."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1), padding=1)
    return torch.relu(y.permute(0, 2, 3, 1) + b.to(x.dtype))


def run(x, w, b, up, device, dtype=torch.float32, fn=conv3x3_relu_train):
    """(y, dx, dw, db) of ``fn`` on ``device``, as float64 on the CPU."""
    xd, wd, bd = (t.to(device, dtype, copy=True).requires_grad_(True) for t in (x, w, b))
    y = fn(xd, wd, bd)
    (y * up.to(device, dtype)).sum().backward()
    return [t.detach().double().cpu() for t in (y, xd.grad, wd.grad, bd.grad)]


def rel(a, ref) -> float:
    return float((a - ref).norm() / ref.norm())


@contextlib.contextmanager
def setting(name: str):
    """One of PyTorch's ways to choose the card's f32 conv arithmetic."""
    cudnn = torch.backends.cudnn
    if name == "flags(allow_tf32=False)":
        with cudnn.flags(enabled=True, benchmark=False, deterministic=False, allow_tf32=False):
            yield
    elif name == "cuDNN off":
        with cudnn.flags(enabled=False):
            yield
    elif name == "conv.fp32_precision = ieee":
        keep = cudnn.conv.fp32_precision
        cudnn.conv.fp32_precision = "ieee"
        try:
            yield
        finally:
            cudnn.conv.fp32_precision = keep
    else:
        yield


def _under(name, x, w, b, up, dev):
    with setting(name):
        return run(x, w, b, up, dev)


SETTINGS = ("defaults", "flags(allow_tf32=False)", "conv.fp32_precision = ieee", "cuDNN off")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", type=int, nargs=5, default=[4, 16, 16, 768, 768],
                    metavar=("B", "H", "W", "CIN", "COUT"))
    args = ap.parse_args(argv)
    B, H, W, ci, co = args.shape
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn((B, H, W, ci), generator=g), 0.05 * torch.randn((3, 3, ci, co), generator=g)
    b, up = torch.randn((co,), generator=g), torch.randn((B, H, W, co), generator=g)
    ref = run(x, w, b, up, "cpu", torch.float64)
    print(f"torch {torch.__version__}, cuDNN {torch.backends.cudnn.version()}, shape "
          f"{args.shape}", flush=True)
    f32 = run(x, w, b, up, "cpu")
    apart = (f32[0] > 0) != (ref[0] > 0)
    print(f"cpu f32 against float64: ReLU decided apart at {int(apart.sum())} of "
          f"{apart.numel()} outputs", flush=True)
    up0 = up.masked_fill(apart, 0.0)
    ref0, f320 = run(x, w, b, up0, "cpu", torch.float64), run(x, w, b, up0, "cpu")
    print("cpu f32, those outputs' upstream gradient 0: "
          + ", ".join(f"{n} {rel(a, r):.3g}" for n, a, r in zip(NAMES, f320, ref0)), flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("probe_train_conv: the card's rows need a CUDA card")
    dev = torch.device("cuda", 0)
    rows = [("cpu f32", lambda: f32)]
    rows += [(f"card f32, {name}", lambda name=name: _under(name, x, w, b, up, dev))
             for name in SETTINGS]
    rows.append(("card f32, plain F.conv2d, defaults",
                 lambda: run(x, w, b, up, dev, fn=plain_train_conv)))
    for label, fn in rows:
        print(f"{label}: " + ", ".join(f"{n} {rel(a, r):.3g}"
                                       for n, a, r in zip(NAMES, fn(), ref)), flush=True)


if __name__ == "__main__":
    main()
