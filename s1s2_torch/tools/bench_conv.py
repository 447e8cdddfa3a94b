"""The conv kernel's time at every conv shape of the main paths, on the card.

    python -m s1s2_torch.tools.bench_conv [--sets 24x4 base96 cfg] [--stem_pad 8]

Times ``ops/conv3x3.conv3x3_relu`` (bf16 mode) and ``conv3x3_relu_int8``
(int8 mode) with CUDA events, one line a shape, beside ``F.conv2d`` on the
same bf16 operands (NCHW views, cuDNN; a yardstick the port never calls)
and the least time the card could take (each input read once, each output
written once, against the operations at the dense tensor-core peak of the
mode's type), then one sum a set:

* ``24x4``: the headline student's 13 convs at B=128 (body 64²): ``inc``
  in bf16, the 12 others in int8 (the timed path) and in bf16 (its
  calibration);
* ``base96``: the base-96 UNet (``bench.base96_state``) at 256², its 13
  convs in bf16 at line 1's B=128 and its 12 double-conv convs in int8 at
  line 2's B=64;
* ``cfg``: the cfg_v teacher's 10 int8 convs with per-channel activation
  scales (rollout calibration, ``conv1`` in bf16), B=64.

The ``inc`` input has its channels rounded up to a multiple of
``--stem_pad`` with zeros, as the model's ``input_map`` writes it on the
card (1 leaves them as they are). Inputs are ``|N(0, 1)|`` activations
(the CFG set's: each channel spread over its calibrated range) with each
model's own weights. ``chip_smoke.py`` times the same sets through
:func:`time_set`, with the plain PyTorch version beside the kernel. It
needs a CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
from typing import Dict, List

import torch
import torch.nn.functional as F

from s1s2_torch import bench
from s1s2_torch.headline import CC, CKPT_DIR, CT
from s1s2_torch.models.quant import quantize_weights
from s1s2_torch.models.unet import UNetSmall
from s1s2_torch.models.weights import params_from_numpy, spec_arch
from s1s2_torch.ops.conv3x3 import (conv3x3_relu, conv3x3_relu_int8,
                                    conv3x3_relu_int8_plain, conv3x3_relu_plain)
from s1s2_torch.tools import ref_crossval
from s1s2_torch.train.checkpoint import load_params

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# dense tensor-core peaks; f32 outside the tensor cores
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
SIZE = 256
LEVEL = {"inc": 0, "down1": 0, "down2": 1, "down3": 2, "conv3": 2, "conv2": 1, "conv1": 0}
CFG_BF16_BLOCKS = ("conv1",)  # the quality-equal CFG recipe's bf16 block
CFG_BATCH = 64  # the CFG sampler's forward: 2 x 32 stacked rows


def bound_ms(nbytes, ops, kind: str):
    """(ms, "bytes" or "operations"): the larger of the two least times."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[kind]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def conv_bound_ms(mode: str, B: int, H: int, Cin: int, Cout: int,
                  per_channel: bool = False):
    """Least time for one conv: each input read once (with the Cin f32
    scales of the per-channel int8 mode), each output written once, against
    the ops at the tensor-core peak of the mode's type."""
    wbytes = 2 if mode == "bf16" else 1
    nbytes = (B * H * H * Cin * 2 + 9 * Cin * Cout * wbytes + Cout * 4 * 2
              + B * H * H * Cout * 2 + (Cin * 4 if per_channel else 0))
    return bound_ms(nbytes, 2 * 9 * B * H * H * Cin * Cout, mode)


def conv_shapes(state, body: int, bf16_blocks=()):
    """[(name, H, Cin, Cout, mode)] of a model's 13 3x3 convs: ``inc`` and
    the blocks of ``bf16_blocks`` in bf16, the rest in int8."""
    out = []
    for key, k in state.items():
        if not key.endswith(".kernel") or k.shape[0] != 3:
            continue
        name = key[:-len(".kernel")]
        blk = name.split(".")[0]
        out.append((name, body >> LEVEL[blk], k.shape[2], k.shape[3],
                    "bf16" if name == "inc" or blk in bf16_blocks else "int8"))
    return out


def time_ms(fn, args_list, reps: int) -> float:
    """Mean ms a call over ``reps`` calls after a warm-up call on each input,
    cycling through the inputs, between CUDA events."""
    for args in args_list:  # each input once: what a first call makes (a packed
        fn(*args)           # weight, a tensor map) is made outside the timing
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(*args_list[i % len(args_list)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# (label, base, stem, in_ch, patch side) of every model the repo runs: the
# base-96 UNet, the CFG net, the crossval nets, and each distilled student
# of the headline and the width ladder
MODELS = ([("base-96", 96, 1, 8, SIZE), ("cfg", 96, 1, CC + CT, SIZE),
           ("crossval", ref_crossval.BASE_CH, 1, 8, ref_crossval.SIZE)]
          + [(s, *spec_arch(s), 8, SIZE)
             for s in dict.fromkeys([s for s, *_ in bench.HEADLINE_PREF + bench.WIDTHS])])


def model_convs(base: int, stem: int, in_ch: int, side: int):
    """:func:`conv_shapes` of a model (meta tensors: no weights are made)."""
    with torch.device("meta"):
        state = UNetSmall(4, base, stem, in_ch).state_dict()
    return conv_shapes(state, side // stem)


def conv_inputs(state, w8, gen, rand_bias: bool = False, stem_pad: int = 8):
    """→ inputs(name, B, H, Cin, Cout, mode) → (x, w, b, q) of one of
    ``state``'s convs: ``|N(0,1)|`` bf16 activations (the ``inc``'s with its
    channels zero-padded up to a multiple of ``stem_pad``, as the model's
    ``input_map`` writes it; 1: none), the model's weights (bf16, or int8
    from ``w8 = quantize_weights(state)[0]``), its bias or, with
    ``rand_bias``, a N(0, 0.1²) one; q = None in bf16, (sx, deq) in int8
    with sx from the activations' max."""
    def inputs(name, B, H, Cin, Cout, mode):
        C = -(-Cin // stem_pad) * stem_pad if name == "inc" else Cin
        x = torch.randn((B, H, H, C), generator=gen, device=gen.device).abs_()
        x[..., Cin:] = 0
        x = x.to(torch.bfloat16)
        b = (0.1 * torch.randn((Cout,), generator=gen, device=gen.device) if rand_bias
             else state[f"{name}.bias"].float().contiguous())
        if mode == "bf16":
            return x, state[f"{name}.kernel"].to(torch.bfloat16).contiguous(), b, None
        sx = float(x.float().abs().amax()) / 127.0
        deq = (torch.tensor(sx, dtype=torch.float32, device=x.device) * w8[name][1]).contiguous()
        return x, w8[name][0], b, (sx, deq)
    return inputs


def cfg_conv_inputs(qp, gen):
    """→ inputs(...) as :func:`conv_inputs`, per-channel int8 at a CFG conv:
    the net's folded int8 weights, deq = sw and its (Cin,) scales; each
    activation channel spread over 0.3-1.2x its calibrated range (some clip
    at 127)."""
    def inputs(name, B, H, Cin, Cout, mode):
        sx = qp.sx[name]
        spread = 0.3 + 0.9 * torch.rand((Cin,), generator=gen, device=gen.device)
        x = ((2 * torch.rand((B, H, H, Cin), generator=gen, device=gen.device) - 1)
             * (127 * sx * spread)).to(torch.bfloat16)
        return x, qp.w8[name][0], qp.bias[name], (sx, qp.deq[name])
    return inputs


def conv_call(x, w, b, q, Cin):
    """The conv wrapper of the mode on one input of :func:`conv_inputs`."""
    if q is not None:
        return conv3x3_relu_int8(x, w, q[0], q[1], b)
    if x.shape[3] != Cin:  # a stem input padded as the model writes it
        return conv3x3_relu(x, w, b, padded_input=True)
    return conv3x3_relu(x, w, b)


def plain_call(x, w, b, q, Cin):
    """The plain version of :func:`conv_call` (bf16: on the first Cin channels)."""
    if q is not None:
        return conv3x3_relu_int8_plain(x, w, q[0], q[1], b)
    return conv3x3_relu_plain(x[..., :Cin], w, b)


def time_conv(inputs, label, name, B, H, Cin, Cout, m, reps, plain_reps, note="",
              per_channel=False):
    """One conv at batch B, two inputs alternating, one line: → (kernel ms,
    plain ms or None, F.conv2d ms or None, bound ms, bound_by). ``F.conv2d``
    (bf16 only) takes NCHW views of the unpadded bf16 operands."""
    ins = [inputs(name, B, H, Cin, Cout, m) for _ in range(2)]
    lib = None
    if m == "bf16":
        wl = ins[0][1].permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)
        bl = ins[0][2].to(torch.bfloat16)
        lib_ins = [(x[..., :Cin].contiguous(),) for x, *_ in ins]
        lib = time_ms(lambda x: torch.relu_(F.conv2d(x.permute(0, 3, 1, 2), wl, bl, padding=1)),
                      lib_ins, reps)
        del lib_ins
    ms = time_ms(lambda x, w, b, q: conv_call(x, w, b, q, Cin), ins, reps)
    pms = (time_ms(lambda x, w, b, q: plain_call(x, w, b, q, Cin), ins, plain_reps)
           if plain_reps else None)
    bound, by = conv_bound_ms(m, B, H, Cin, Cout, per_channel)
    C = ins[0][0].shape[3]
    print(f"time {m}{' per-channel' if per_channel else ''} {label} {name} {H}x{H} "
          f"{Cin}{f' ({C})' if C != Cin else ''}->{Cout} B={B}: kernel {ms:.4f} ms, plain "
          f"{'-' if pms is None else f'{pms:.4f}'} ms, F.conv2d "
          f"{'-' if lib is None else f'{lib:.4f}'} ms, bound {bound:.4f} ms ({by}), "
          f"{bound / ms:.3f} of the bound{note}", flush=True)
    del ins
    torch.cuda.empty_cache()
    return ms, pms, lib, bound, by


def time_set(label: str, inputs, shapes, batches: Dict[str, int], reps: int,
             plain_reps: int = 0, calibration: bool = False,
             per_channel: bool = False) -> Dict[str, Dict[str, float]]:
    """Time each (name, H, Cin, Cout, mode) of ``shapes`` in its mode at
    ``batches[mode]``, one line a shape, and sum each mode (kernel, plain
    version when ``plain_reps``, ``F.conv2d``, bound split by what bounds
    it); with ``calibration`` an int8 conv also in bf16 (its calibration
    pass: printed, not summed). Prints and returns the sums by mode."""
    sums = {m: dict(ms=0.0, plain=0.0, library=0.0, bound=0.0, bytes=0.0, operations=0.0, n=0)
            for m in batches}
    for name, H, Cin, Cout, mode in shapes:
        runs = [(mode, "")]
        if calibration and mode == "int8":
            runs.append(("bf16", " [calibration mode]"))
        for m, note in runs:
            ms, pms, lib, bound, by = time_conv(inputs, label, name, batches[m], H, Cin, Cout,
                                                m, reps, plain_reps, note, per_channel)
            if note:
                continue
            s = sums[m]
            for k, v in (("ms", ms), ("plain", pms or 0.0), ("library", lib or 0.0),
                         ("bound", bound), (by, bound), ("n", 1)):
                s[k] += v
    for m, s in sums.items():
        plain = f"{s['plain']:.3f}" if plain_reps else "-"
        print(f"time {label} {s['n']} {m}{' per-channel' if per_channel else ''} convs, "
              f"B={batches[m]}: kernel {s['ms']:.3f} ms, plain {plain} ms, F.conv2d "
              f"{s['library']:.3f} ms, bound {s['bound']:.3f} ms, "
              f"{s['bound'] / max(s['ms'], 1e-9):.3f} of the bound", flush=True)
    return sums


def bf16_all(shapes):
    """``shapes`` with every conv in bf16 (line 1's bf16 forward)."""
    return [(name, H, Cin, Cout, "bf16") for name, H, Cin, Cout, _ in shapes]


def int8_only(shapes):
    """The int8 convs of ``shapes``."""
    return [s for s in shapes if s[4] == "int8"]


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sets", nargs="+", default=["24x4", "base96", "cfg"],
                    choices=("24x4", "base96", "cfg"))
    ap.add_argument("--stem_pad", type=int, default=8,
                    help="round the inc input's channels up to this multiple (1: none)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_conv needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    print(card_line(), flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = []
    for s in args.sets:
        if s == "24x4":
            st = params_from_numpy(load_params(str(
                CKPT_DIR / "distill_eps_student24x4.bf16.msgpack")))
            st = {k: v.to(dev) for k, v in st.items()}
            out.append(time_set("24x4", conv_inputs(st, quantize_weights(st)[0], gen,
                                                    stem_pad=args.stem_pad),
                                conv_shapes(st, SIZE // 4), {"bf16": 128, "int8": 128}, 20,
                                calibration=True))
        elif s == "base96":
            st = {k: v.to(dev) for k, v in bench.base96_state().items()}
            inputs = conv_inputs(st, quantize_weights(st)[0], gen, stem_pad=args.stem_pad)
            shapes = conv_shapes(st, SIZE)
            out.append(time_set("base-96", inputs, bf16_all(shapes),
                                {"bf16": bench.LINE1_BATCH}, 3))
            out.append(time_set("base-96", inputs, int8_only(shapes),
                                {"int8": bench.LINE2_BATCH}, 3))
        else:
            st = bench.cfg_state(device=dev)
            qp = bench.make_cfg_samplers(st, device=dev)["qp"]
            out.append(time_set("cfg", cfg_conv_inputs(qp, gen),
                                int8_only(conv_shapes(st, SIZE, CFG_BF16_BLOCKS)),
                                {"int8": CFG_BATCH}, 3, per_channel=True))
    print(card_line(), flush=True)
    return out


if __name__ == "__main__":
    main()
