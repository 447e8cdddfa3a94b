#!/usr/bin/env python3
"""Smoke run of the s1s2_torch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each printing its own seconds:

1. Device: a CUDA card must be present (else exit 1, no result); prints
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``.
2. Build: compiles ``s1s2_torch/ops/csrc/*.cu`` with nvcc and prints each
   conv, matmul and halo kernel's registers, shared memory and spills
   (ptxas; spills must be 0 in the conv kernels). ``cuobjdump -sass`` of the
   built library must show (``sass_rules``): ``HGMMA`` in every
   ``conv3x3_bf16_kernel`` and the bf16 ``matmul_kernel``s, ``IGMMA`` in
   every ``conv3x3_int8_kernel`` and the int8 ``matmul_kernel``, each with
   TMA loads (``UTMALDG``) and no ``HMMA``/``IMMA``/``LDGSTS`` (and no
   ``IDP4A`` or ``FFMA`` in the convs); bulk loads and bulk stores
   (``UBLKCP.S.G``, ``UBLKCP.G.S``) and no ``LDG``/``STG`` in
   ``halo_rows_x2_kernel``. The conv's launch plan as the C entry computes
   it must equal its Python mirror (``ops/conv3x3.conv_plan``) at every
   conv of every model (``conv_plan_mismatches``).
3. First the conv kernel's layout probe (``layout_probe``: one tap and one
   input channel lit at a time, in both modes, at the cases of
   ``PROBE_CASES``; it names the tap and channel a wrong swizzle or
   descriptor reads) and both modes at the awkward shapes
   (``AWKWARD_SHAPES``: Cin 129, 33, 12, 9, Cout 12 and 24, 8² and 20², B=1),
   and the int8 mode's int8-out variant (``conv3x3_int8_q``: int8 in, the
   requant ``clip(rint(relu(acc·deq + b)), -127, 127)`` to int8) bit-equal
   to its plain version at ``INT8Q_SHAPES`` (the probe's conv, 256² and
   128 → 128 at B=2; Cin 32 and 64, Cout 12 and 24, 8² and 20²), with the
   probe's requant and with per-channel scales, a wide bias and no ReLU.
   Then the kernels against their plain PyTorch versions at the main path's shapes
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
   modes from 32×32 down to 8×8 (narrower than its 16×16-pixel tile) and
   Cout 16 and 32, at B=8 and 2 (ε net) and 4
   (v net), and the DDIM update on a padded batch, with phase 3's
   tolerances.
3a. The stem pack (``ops/stem_pack.py``) at the cells' shapes
   (``STEM_SHAPES``: the 24x4's x_t and cond apart at B=128 with the 4x
   stem, base-96's concatenated input at B=64): the kernel and the
   yardstick ``stem_library`` bit-equal to the plain version, each timed;
   then channel counts off the kernel's 16-byte path and an 8x stem.
3f. The int8 up-convs of ``quant_up`` (``ops/pixel_shuffle.
   ps_conv_transpose_2x2_int8``: the product on the matmul kernel's int8
   mode against the weight matrix packed once, zero-padded to its tiles) at
   every up shape of base-96 at B=2, of the w24 pure-generation student at
   B=16 and of the 24x4 at B=128 (K=48 with N=96, and N=192, padded), their
   own int8 weights: the int32 sums and the bf16 output bit-equal to the
   plain version.
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
   process (the conv leg's bf16 and int8 chains, the halo load, the
   matmul), with exact launch counts; the int8-out conv runs on no other
   path.
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
4i. ``quant_up`` end to end: ``s1s2_torch.tools.bench_int8 --quant_up`` on
   the base-96 ε teacher and the 32-file evidence set, B=64, DDIM-50 from
   t=999, one warm-up and one timed call of each of bf16, int8 and int8 with
   int8 up-convs: patches/s and MAEs printed, each MAE within 0.02 of bf16's,
   exact launch counts; then one int8 + quant_up forward against the CPU op
   by op, and the same net through ``save_quant`` and ``load_quant`` onto
   the card: the same forward bit for bit.
4j. Scene inference through ``cli.infer_scene``'s own code on the ε teacher:
   (a) a 384² scene (4 tiles) with DDIM-2, card against the CPU plain path
   within 1.5% of mean |pred|; (b) the device stitch against the host stitch
   (max |Δ| ≤ 1e-5); (c) ``tools.bench_scene`` at 1536² (64 tiles, stride
   192): ε DDIM-50 bf16 in the CLI's three settings (host, ``--stitch
   device``, ``--fast_transfer``), then the tool's default (int8
   DPM-Solver++(2M)-5, its six rows); seconds and tiles/s, exact launches.
4k. Serving: the w24 student quantized by ``cli.quantize`` on files 0-95 of
   the 129-file rich set at t_start 999; ``tools.bench_serve`` (its servers
   in process on port 0): batch-1 and batch-16 latency p50/p95 over 10
   requests, 4 client threads for 5 s, the predictor alone; the launch
   counts exact under the threads. Then files 96-127 through ``/infer`` with
   4 seeds: the pure-generation masked MAE (per file, as the committed
   table) within 0.02 of the committed 0.28453 (int8 artifact) and 0.28051
   (``--ckpt``, bf16), ``/healthz`` reporting the signature; and one request
   to the cfg_v teacher at g=3, 5 steps: finite, the right shape.
4l. Training (``train/loop.py``, ``train/trainer.py``; no hand-written
   kernel: the step runs PyTorch's autograd conv, as the JAX package trains
   through XLA's conv, and every path here must launch none of the port's
   kernels): (a) the train step at base 16, 64², B=4, 3 steps on jax's
   threefry draws, card against the CPU in f32 (TF32 off) and bf16: the
   losses, per-channel losses, step-0 gradients, parameter and EMA updates
   and Adam's moments within 1e-2 (f32) and 2 (bf16) times the CPU's own
   bf16-vs-f32 distance; then one non-finite batch, skipped with the params
   and EMA kept; the card's steps run under ``torch.cuda.
   set_sync_debug_mode("error")``, so a host sync in them fails the phase.
   (b) ``tools.bench_train`` at base 96, 256², bf16, B=8, 32 and 64, remat
   off and on: patches/s, the share of the reckoned bound (3 or 4 forwards'
   conv operations at ``PEAK_OPS_PER_S["bf16"]``), peak memory, every loss
   finite. (c) ``python -m s1s2_torch train`` in process on 32 synthetic
   files of 256² at base 96, B=8: two epochs, and one epoch then
   ``--resume`` for the second, under deterministic cuDNN: the state files
   and the final EMA files bit-equal, the final/_last/_best files loading
   through ``load_model``, one metrics line an epoch.
4m. Distillation (``train/distill.py``; the student trains on PyTorch's
   autograd conv, the frozen teacher runs the inference path's conv kernel
   and the rollouts the DDIM kernel): (a) the progressive step at base 16,
   64², B=4, 3 steps on jax's threefry draws in bf16 (the kernel takes bf16
   only) and the endpoint step (an s2d-2 student) in f32 and bf16, card
   against the CPU: losses, per-channel losses, ε-MSEs, step-0 gradients,
   Adam's moments, parameter and EMA updates within 1e-2 (f32) and 2 (bf16)
   times the CPU's own bf16-vs-f32 distance; the card's f32 step is held to
   the CPU's step with the network in f64 (an Adam update is near sign(g),
   and the CPU's f32 forward settles a max-pool near-tie of this input
   otherwise than f64 does, which flips updates whole; the count of updates
   more than 0.1 × lr apart is printed); one non-finite batch each,
   skipped with the params kept; the card's steps under ``set_sync_debug_
   mode("error")``; exact launches (the teacher's 26 convs a step). (b)
   ``tools.score_distill_full`` on the 32-file evidence set, the ε teacher
   with the base-96 and 24x4 students, each row's MAE within 0.005 of
   ``distill_full_metrics.jsonl`` / ``distill_width24x4_metrics.jsonl`` (the
   other five metrics printed with their differences). (c) ``python -m
   s1s2_torch make_synthetic --seed 1`` and ``tools.score_width_holdout`` on
   the ten committed widths against ``distill_width_holdout.jsonl``, the
   same bound. (d) ``python -m s1s2_torch distill`` in process: the 24x4
   recipe (teacher ``distill_eps_student1``) for 25 epochs with snapshots
   every 10, its seconds an epoch between the first snapshot and the end,
   the snapshot and the final student scored finite; then a base-96
   progressive run (teacher steps 4, two epochs a phase), the ms a step of
   phase 0's second epoch. Exact launch counts throughout.
4n. Panels, parity and the data and checkpoint CLIs, at full width (the
   base-96 teachers, 256² patches; committed checkpoints and seeded data
   only): (a) ``python -m s1s2_torch evaluate`` in process on the 32-file
   evidence set with the ε teacher, ``--mode night_demo --save_viz_n 6``,
   ``--mode tsweep --save_viz_n 2``, and ``--mode cfg_sweep --save_viz_n 2``
   on the cfg_v teacher (g=3, 5 steps from t=999), and ``--mode cloudy_viz
   --zoom 32 --zoom_k 2`` on a 32-file cloudy set (``make_synthetic_patches
   (with_cloud=True)``): the files named as the JAX harness names them,
   each decoded PNG of the panel's shape with its title's strongly covered
   pixels yellow, exact launches, seconds a panel; one cloudy batch (B=2)
   card against the CPU plain path within 1.5% of mean |pred| (4j's
   bound). (b) ``validate_parity --pth`` on both committed crossval nets and
   on a base-96 twin (torch's default init, seeded) at 256², B=2: each
   within the card's bf16 rule (the port's f32 forward on the CPU within
   ``max_abs < 1e-3`` of the twin, the converter's check, and ``rel`` ≤ 2 ×
   the CPU plain path's bf16 ``rel``, the kernel's); a converter that
   transposes the stem's kernel fails it. (c) ``validate_parity --full`` with the ε teacher on the
   evidence set, ``ddim_eps``'s ``MAE_mean`` expected at the committed
   anchor 0.44074 (the sweep and true_infer tables cut to 8 files, the
   latter to 2 seeds, ``PARITY_CUTS``): that row PASS, every table run,
   both reports written (the other rows are the reference's real-data
   numbers, printed).
   (d) ``python -m s1s2_torch patchify`` on a seeded 1536² raw scene of
   ``.npy`` bands at the reference's names (capped at 48 patches), then
   ``evaluate --mode night_demo`` on its patches; ``tools.bench_patchify``
   at 1536². (e) ``convert_ckpt`` on the ε crossval net: its msgpack's
   forward on the card bit-equal to the harness's direct ``.pth`` load;
   ``tools.archive_ckpt`` of it loads. (f) ``tools.demo_distill_viz`` with
   the ε teacher and ``distill_eps_student1`` on the first 4 evidence
   files: each row within 0.005 of the committed ``distill_demo/summary.json``
   (4m's bound on the committed score replays).
4o. The device mesh (``parallel/``) at full width, world 1 over NCCL: two
   child processes of this script (``--mesh-child``) run the CLIs in
   process, one with no process group and one with torchrun's environment
   (``RANK`` 0, ``WORLD_SIZE`` 1, ``LOCAL_RANK`` 0), so no later phase runs
   under a group; the children run at the same time. Each reports, per run,
   its seconds and launch counts by kernel and by mode (set to 0 before the
   run, read after; they join the parent's counts by path); the
   group's child also its world size, backend and
   ``torch.cuda.nccl.version()``. (a) ``evaluate --mode ddim`` with the ε
   teacher on the 32-file evidence set, bf16 and ``--int8``, with
   ``--mesh_data 1`` under the group: the CSVs bit-equal, the MAE within
   0.02 of 0.44074, the launches those of 4h's runs. (b) ``infer_scene`` on
   4j(a)'s 384² scene, bf16 and ``--int8``, with ``--mesh_data 1``: the
   scenes bit-equal, 4j's launches. (c) ``train`` at base 96, 256², B=8, one
   epoch on 16 synthetic files under deterministic cuDNN (the trainer's
   mesh over the world): the EMA files bit-equal, no kernel launched. (d)
   ``distill`` with ``distill_eps_teacher``, teacher steps 4 and one epoch a
   phase on those files, then 2 endpoint epochs (4 seeds, DDIM-20 rollouts):
   the students bit-equal, exact launches.
4p. The measurement tools (``s1s2_torch/tools``, ROADMAP §1 item 7d), each
   in process and printing its own lines but (g): (a) ``roofline`` at its
   defaults (B=64, base 96, DDIM-50) and for the 24x4's forward: ``mfu`` ≤
   1 and the scan's overhead printed, exact launches; (b)
   ``profile_forward``: the trace file written, the bf16 conv kernel the top
   device op; (c) ``bench_width_throughput --widths 96 64 48 12 24x2 48x4``
   (B=64 and 128, 30 timed calls a line): every line finite, exact
   launches; (d) ``bench_variants quick``: a rate for both up-conv forms;
   (e) ``bench_quality_matched --ckpt distill_eps_teacher --n 32 --int8``:
   ddim-20 within 0.02 of the anchor 0.44074 (4h's), then the 40-epoch
   soak, its rows printed beside BENCH_NOTES.md's committed ones (not held
   to them: the card's training draws differ); (f) ``puregen_table`` with
   the cfg_v teacher on 4e's files (the rich set's 96-127), ``--steps 1 5
   --scales 1 3 --n_seeds 4``: the g=3, 5-step cell within 0.02 of the
   committed ``Pure_Generation/cfg_teacher_table`` mean 0.30443; (g)
   ``s1s2_torch/tools/demo_results_pack.sh`` (twelve evaluate processes) on
   the 32-file evidence set with the v teacher: every directory written,
   each committed CSV of ``examples/results_synthetic/`` present with the
   same header (three with the header that both packages' harnesses write
   since the pack was committed, ``PACK_HEADERS_NOW``). The pack starts
   after (d) and runs beside (e) and (f), whose checks are MAEs and exact
   counts and do not depend on the card's other work; the soak's seconds
   and the pack's are taken with both running.
5. Timing at B=128 with CUDA events: each kernel at each path shape beside
   its plain version, ``F.conv2d`` (bf16 mode only) and its bound (the
   convs through ``tools/bench_conv.time_set``, the conv timing tool's own
   loop and inputs).
5b. Timing at the base-96 shapes (bf16 at line 1's B=128, int8 at line 2's
   B=64: ``bench.LINE1_BATCH``, ``bench.LINE2_BATCH``) beside ``F.conv2d``
   and the bound, of the per-channel int8 mode at the CFG net's 10 int8
   shapes (B=64), of the int8 up-convs' products at 3f's shapes and at
   base-96's B=64 beside ``torch._int_mm``, of the int8-out conv at the
   probe's shape (B=32, 256², 128 → 128) beside its plain version and its
   bound, and of the probe kernels beside their plain versions,
   ``torch.matmul``/``torch._int_mm`` and ``x[1:-1]*2``.

Each path of 4-4p is driven with every launch count set to 0 just before it
and read just after; a kernel of the path that was not launched fails it
(4p(g) runs in child processes, whose launches are not counted). On the
inference paths of ``STEM_PATHS`` the stem pack must launch once a forward,
and exactly 105 times in each headline and 100 and 14 times in bench lines
1 and 2.
Then a ``{"kernels": [...]}`` line (the conv rows' times are those of the
24x4 main path at B=128, and the per-channel int8 row's those of the CFG
net's shapes at B=64, and the int8-out row's those of 5b; the matmul has a
row per mode, bf16 → bf16 beside
``torch.matmul`` and int8 → int32 beside ``torch._int_mm``, and a row for
its int8 mode on the packed up-conv weights of 4i; the stem pack a row per
shape of 3a, beside ``stem_library``; launches are summed over
the paths), the card line
again, and last ``{"ok": true, "device": {...}}``. Any failure raises, and
no result is printed. The port's inference paths never call cuDNN,
cuBLAS's ``torch.matmul`` on the probe's operands or ``torch._int_mm``; they
are timed here only as yardsticks. Its training path (4l, and the students
of 4m) runs cuDNN's conv through autograd, where the JAX package runs XLA's.
"""

import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
import urllib.request
from pathlib import Path

# the conv's own timing tool: its input builders and per-shape loop, and the
# timing and bound helpers (the card's published peaks, the conv shapes of a
# model, CUDA-event loops)
from s1s2_torch.tools import bench_conv
from s1s2_torch.tools.bench_conv import (HBM_BYTES_PER_S, PEAK_OPS_PER_S, bound_ms,
                                         card_line, conv_shapes, time_ms)

EVIDENCE_MAE, TEACHER_ANCHOR = 0.32764, 0.44074
SIZE, BATCH, CHECK_BATCH = 256, 128, 8  # patch size, timing batch, check batch
STEM = 4  # the 24x4 student's space-to-depth factor: body at SIZE / 4
SMOKE_LINE1_BATCH = 4  # line 1 here; line 2 runs at the bench's own batch
MATMUL_SHAPES = ((512, 512, 512), (8192, 2048, 2048))  # (M, K, N)
HALO_CASES = ((256, 128, 128, 32), (250, 128, 128, 32), (37, 5, 4, 7),  # (H, W, C, TH)
              (1026, 256, 128, 32))
RUNGS = (("16x2", 0.33557), ("12", 0.34379))  # committed evidence MAEs
# the stem pack at the cells' shapes: (label, B, side, x_t channels, cond
# channels apart (0: one concatenated input), s)
STEM_SHAPES = (("24x4 pair", BATCH, SIZE, 4, 4, STEM), ("base-96 one tensor", 64, SIZE, 8, 0, 1))
# the paths whose every 3x3 conv launch is one of a UNet forward's 13, so
# that each forward on the card launches the stem pack once:
# stem_pack launches == (conv3x3_relu + conv3x3_relu_int8) / 13 (the
# headlines' and bench lines' counts are also held to their exact values)
STEM_PATHS = ("headline 24x4", "headline 16x2", "headline 12", "bench line 1", "bench line 2",
              "cfg line", "width ladder", "full ddim eps", "full ddim v", "full ddim eps int8",
              "full per_band", "full eps", "full vdiag", "full onestep", "quant_up",
              "scene eps", "scene eps device stitch", "scene bench eps bf16", "scene bench int8")
LADDER_SHAPES = ("64", "48", "32")  # the ladder's full-resolution students checked in 3d
CFG_BF16_BLOCKS = bench_conv.CFG_BF16_BLOCKS  # the quality-equal CFG recipe's bf16 block
CFG_CHECK_BATCH = bench_conv.CFG_BATCH  # the CFG sampler's forward: 2 x 32 stacked rows
MAE_SLACK = 0.02  # bench.py's rung slack
# 3e: (net, batch) of the crossval nets' shape checks
CROSSVAL_CHECKS = (("eps", 8), ("eps", 2), ("v", 4))
# 4h: the committed ddim-20 anchors of the base-96 teachers
# (examples/checkpoints/README.md), the evidence set and the teacher files
TEACHER_ANCHORS = {"eps": 0.44074, "v": 0.30411}
FULL_FILES, FULL_BATCH, FULL_STEPS = 32, 8, 20  # the CLI's default batch
# the ops of an int8 forward (``quant._forward``), looked up in the quant
# module at call time
W24_CKPT = "distill_cfg_puregen_student24.bf16.msgpack"  # the served pure-generation student
QU_BATCH, QU_STEPS = 64, 50  # 4i: bench_int8 --quant_up
SCENE_SIZE, SCENE_STEPS, BENCH_SCENE = 384, 2, 1536  # 4j
# 4k: rich files 96-127 served with 4 seeds; the committed pure-gen MAEs of
# the w24 student (examples/checkpoints/README.md); bench_serve shortened
SERVE_EVAL, SERVE_SEEDS = (96, 128), 4
SERVE_ANCHORS = {"int8": 0.28453, "bf16": 0.28051}
SERVE_N_LAT, SERVE_SAT_S, SERVE_THREADS = 10, 5.0, 4
# 4l: (a) the train step card against CPU: base, size, batch, steps; each
# quantity within a multiple of the CPU's own bf16-against-f32 distance, 1e-2
# of it in f32 (TF32 off) and twice it in bf16 (two bf16 evaluations, each
# that far from f32); (b) bench_train's batches; (c) the trainer: files,
# base, batch, epochs
TRAIN_CHECK = (16, 64, 4, 3)
TRAIN_SLACK = {"f32": 1e-2, "bf16": 2.0}
TRAIN_BENCH_BATCHES, TRAIN_BENCH_ITERS = (8, 32, 64), 5
TRAIN_RUN = (32, 96, 8, 2)
# 4m: (a) the progressive step (bf16; the teacher runs the conv kernel, which
# takes bf16 only) and the endpoint step (f32 and bf16) card against CPU:
# base, size, batch, steps, the endpoint student's stem, the tolerances of
# 4l (the card's f32 step against the CPU's with an f64 network); (b) the
# committed score replays: (student, base, stem, committed rows),
# each row's MAE within DISTILL_MAE_SLACK; (c) the held-out set's seed and the
# committed widths; (d) the CLI at full width: the 24x4 recipe's flags with
# DISTILL_EP epochs (snapshots every DISTILL_SNAP), and a base-96 progressive
# run (teacher steps 4, two epochs a phase)
DISTILL_CHECK = (16, 64, 4, 3, 2)
DISTILL_MAE_SLACK = 0.005
DISTILL_REPLAYS = (("1", 96, 1, "distill_full_metrics.jsonl"),
                   ("24x4", 24, 4, "distill_width24x4_metrics.jsonl"))
HOLDOUT_SEED = 1
HOLDOUT_WIDTHS = ("96", "64", "48", "32", "24", "16", "12", "16x2", "48x4", "24x4")
DISTILL_EP, DISTILL_SNAP = 25, 10
R2_FLAGS = ["--student_base_ch", "24", "--student_s2d", "4", "--skip_progressive",
            "--endpoint_teacher_steps", "1", "--endpoint_seeds", "8", "--lr", "3e-4",
            "--batch_size", "8"]
# 4n: the panel modes' expected files, the cloudy set, patchify's raw scene
# (side, patch cap) and the committed distillation demo's rows
PANEL_SHAPES = {"night": (512, 3 * 512, 3), "gt": (1024, 3 * 512, 3)}
CLOUDY_ZOOM, CLOUDY_ZOOM_K = 32, 2
PATCHIFY_SCENE, PATCHIFY_MAX = 1536, 48
PARITY_CUTS = {"sweep_eps": {"max_files": 8}, "true_infer_eps": {"n_seeds": 2, "max_files": 8}}
DEMO_K = 4
QUANT_OPS = ("input_map", "conv3x3_relu", "conv3x3_relu_int8", "ps_conv_transpose_2x2",
             "ps_conv_transpose_2x2_int8", "conv1x1", "max_pool2")
# the ops a forward must give bit for bit on the card and the CPU (the stem's
# input is the stem_pack kernel on the card)
EXACT_OPS = ("input_map", "conv3x3_relu_int8", "ps_conv_transpose_2x2_int8", "max_pool2")
# 3: the int8-out conv mode against its plain version, (B, H, Cin, Cout): the
# probe's conv at B=2, then Cin 32 and 64 x Cout 12 and 24 x 8² and 20²
INT8Q_SHAPES = ((2, 256, 128, 128),) + tuple(
    (2, hw, ci, co) for ci in (32, 64) for co in (12, 24) for hw in (8, 20))
# 4p: the measurement tools of ROADMAP §1 item 7d. (c) the width sweep's
# widths; (e) the ε teacher's committed ddim-20 anchor (4h's) and the soak's
# epochs and committed rows (BENCH_NOTES.md:79-82, printed beside the card's,
# not held to them: the card's training draws differ); (f) the pure-generation
# cell (g, steps) held to the committed cfg_teacher_table mean; (g) the
# results pack's directories (examples/results_synthetic/)
TOOL_WIDTHS, TOOL_ITERS = ("96", "64", "48", "12", "24x2", "48x4"), 30
QM_SOAK_EPOCHS = 40
QM_SOAK_ROWS = {("ddim", 20): 0.41940, ("ddim", 10): 0.42289, ("ddim", 5): 0.42962,
                ("dpm2m", 10): 0.40915, ("dpm2m", 5): 0.37561}
PUREGEN_CELL, PUREGEN_ANCHOR = (3.0, 5), 0.30443
PUREGEN_ARGS = ["--steps", "1", "5", "--scales", "1", "3", "--n_seeds", "4"]
PACK_DIRS = ("Onestep", "DDIM_Multi-step", "DDIM_Sweep", "VDiag", "Seed_Stats", "Per_Band",
             "Ablate", "Pure_Generation", "Limitation_Test", "Baselines", "DDIM_int8")
# the CSVs whose header the JAX package's harness changed after the pack was
# committed (an eta column in the ddim tables; vdiag's cosines renamed): held
# to the header both harnesses write now (the port's mode tests hold its CSVs
# to the JAX harness's); every other CSV to the committed header
_DDIM_HEADER = ["file", "t_start", "ddim_steps", "eta", "MAE", "MSE", "PSNR", "SAM(rad)", "ERGAS"]
PACK_HEADERS_NOW = {"DDIM_Multi-step/ddim_metrics.csv": _DDIM_HEADER,
                    "DDIM_int8/ddim_metrics.csv": _DDIM_HEADER,
                    "VDiag/vdiag.csv": ["file", "t_small", "v_MSE", "v_cosine", "eps_cosine"]}


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


SASS_KERNELS = ("conv3x3", "quantize_pad", "matmul_kernel", "transpose_i8", "halo_rows_x2")
SASS_OPS = ("HMMA", "IMMA", "HGMMA", "IGMMA", "FFMA", "IDP4A", "LDSM", "LDGSTS", "UTMALDG",
            "UBLKCP.S.G", "UBLKCP.G.S", "LDG", "STG")
# (kernel name contains, SASS ops that must occur, ops that must not)
SASS_RULES = (
    ("conv3x3_bf16_kernel", ("HGMMA", "UTMALDG"), ("HMMA", "IMMA", "LDGSTS", "IDP4A", "FFMA")),
    ("conv3x3_int8_kernel", ("IGMMA", "UTMALDG"), ("HMMA", "IMMA", "LDGSTS", "IDP4A", "FFMA")),
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
    convs and the matmul on ``wgmma`` fed by TMA, the halo load on bulk
    copies. A kernel that fell back to older instructions fails."""
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


def ptxas_report(lines):
    """Prints the ptxas lines of the kernels ``SASS_KERNELS`` names (entry,
    stack frame and spills, registers and shared memory) and every
    advisory; → {kernel: bytes of spill stores}."""
    import re

    cur, spills = "", {}
    for line in lines:
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            cur = m.group(1)
        ours = any(k in cur for k in SASS_KERNELS)
        if ours or "(C7" in line:
            print(f"ptxas: {line}", flush=True)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and ours:
            spills[cur] = spills.get(cur, 0) + int(m.group(1))
    return spills


def matmul_bound_ms(M, K, N, mode):
    """bf16 -> bf16 or int8 -> int32: A and B read once, C written once."""
    e, out = (2, 2) if mode == "bf16" else (1, 4)
    return bound_ms(M * K * e + K * N * e + M * N * out, 2.0 * M * K * N, mode)


def halo_bound_ms(H, W, C):
    """x read once, the (H-2) rows written once, one f32 multiply each."""
    return bound_ms(4 * H * W * C + 4 * (H - 2) * W * C, (H - 2) * W * C, "f32")


def conv_plan_mismatches():
    """The conv kernel's launch plan as the built C entry computes it
    (``kernel_plan``) against its Python mirror (``conv_plan``), at every
    conv of every model the repo runs (``bench_conv.MODELS``), in bf16 and,
    but for the stem, in int8, with the channels padded as each mode reads
    them: → (cases checked, [(case, C plan, Python plan)] that differ)."""
    from s1s2_torch.ops.conv3x3 import K_MULT, conv_plan, kernel_plan

    n, bad = 0, []
    for label, *arch in bench_conv.MODELS:
        for name, H, cin, cout, _ in bench_conv.model_convs(*arch):
            for mode in ("bf16",) if name == "inc" else ("bf16", "int8"):
                cs = -(-cin // K_MULT[mode]) * K_MULT[mode]
                c, py = kernel_plan(mode, cs, cout), conv_plan(mode, cs, cout)
                n += 1
                if any(c[k] != py[k] for k in c):
                    bad.append((f"{label} {name} {mode} {cs}->{cout}", c, py))
    return n, bad


def bf16_ulp(torch, v):
    """One bf16 ulp of |v| (0 where v is 0)."""
    _, e = torch.frexp(v.float().abs())
    return torch.where(v == 0, torch.zeros_like(v, dtype=torch.float32),
                       torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8))


def bf16_tolerance(torch, F, x, w, b, ref, Cin):
    """1 bf16 ulp of the larger value plus twice the f32 accumulation-order
    bound n·2^-24·Σ|terms| (n = 9·Cin + 1), per element. An input padded
    past w's Cin (a stem's) counts its first Cin channels."""
    cudnn = torch.backends.cudnn
    x = x[..., :w.shape[2]]
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        s = F.conv2d(x.float().abs().permute(0, 3, 1, 2),
                     w.float().abs().permute(3, 2, 0, 1), padding=1)
    s = s.permute(0, 2, 3, 1) + b.float().abs()
    return bf16_ulp(torch, ref) + 2 * (9 * Cin + 1) * 2.0 ** -24 * s


# the layout probe's cases (mode, Cin, Cout) and the input channels lit in
# each: every 16-byte piece of the chunk rows (128 bytes, and the 32- and
# 64-byte chunks of narrow channel counts), the chunk edges and the channel
# tail; the awkward shapes' (Cin, Cout, side) of 3 and the GPU tests
PROBE_CASES = (("bf16", 136, 24, (0, 7, 8, 15, 16, 31, 40, 63, 64, 100, 127, 128, 135)),
               ("bf16", 72, 192, (0, 9, 23, 50, 63, 64, 71)),
               ("bf16", 16, 96, (0, 7, 8, 15)),
               ("bf16", 24, 48, (0, 7, 8, 15, 16, 23)),
               ("int8", 160, 24, (0, 1, 16, 31, 32, 63, 64, 95, 112, 127, 128, 159)),
               ("int8", 96, 96, (0, 17, 47, 48, 80, 95)),
               ("int8", 32, 24, (0, 15, 16, 31)),
               ("int8", 64, 48, (0, 15, 16, 31, 32, 47, 48, 63)))
AWKWARD_SHAPES = tuple((ci, co, hw) for ci in (129, 33, 12, 9) for co in (12, 24)
                       for hw in (8, 20))


def int8q_operands(torch, B, H, Cin, Cout, device, gen, probe=True):
    """Operands of the int8-out conv mode: int8 activations and weights
    uniform in [-127, 127]; with ``probe`` the probe's requant (deq the one
    scale 1/(127·8), zero bias), else per-channel scales and a bias wide
    enough that outputs clip at both ends. → (x8, w8, deq, b)."""
    x8 = torch.randint(-127, 128, (B, H, H, Cin), generator=gen, device=device).to(torch.int8)
    w8 = torch.randint(-127, 128, (3, 3, Cin, Cout), generator=gen, device=device).to(torch.int8)
    if probe:
        return (x8, w8, torch.full((Cout,), 1.0 / (127.0 * 8), device=device),
                torch.zeros(Cout, device=device))
    deq = (0.2 + torch.rand((Cout,), generator=gen, device=device)) * 1e-3
    return x8, w8, deq, 50.0 * torch.randn((Cout,), generator=gen, device=device)


def layout_probe(torch, mode, Cin, Cout, channels, device, side=20, batch=2):
    """The conv kernel with one tap and one input channel lit at a time (the
    weight zero elsewhere; output channel co weighted 2^(co % 4)) on
    activations whose values name their pixel and channel (small integers,
    exact in bf16 and int8), against the plain version: every product is
    exact and alone in its sum, so both modes must agree bit for bit. →
    [(tap, channel, what the kernel read)] of the cases that disagree; for
    each, the (tap, channel) of the input whose values the kernel's output
    shows, or "no single input"."""
    from s1s2_torch.ops.conv3x3 import (conv3x3_relu, conv3x3_relu_int8,
                                        conv3x3_relu_int8_plain, conv3x3_relu_plain)

    B, H = batch, side
    ar = lambda n: torch.arange(n, device=device)  # noqa: E731
    xv = ((ar(B)[:, None, None, None] * 11 + ar(H)[None, :, None, None] * 5
           + ar(H)[None, None, :, None] * 3 + ar(Cin)[None, None, None, :] * 7) % 127 + 1)
    x = xv.to(torch.bfloat16).contiguous()
    scale = (2.0 ** (ar(Cout) % 4)).float()
    pad = torch.nn.functional.pad(xv.float(), (0, 0, 1, 1, 1, 1))
    shifted = [pad[:, ky:ky + H, kx:kx + H] for ky in range(3) for kx in range(3)]
    b = torch.zeros(Cout, device=device)
    bad = []
    for tap in range(9):
        for ci in channels:
            w = torch.zeros((3, 3, Cin, Cout), device=device)
            w[tap // 3, tap % 3, ci] = scale
            if mode == "bf16":
                w = w.to(torch.bfloat16)
                got, ref = conv3x3_relu(x, w, b, False), conv3x3_relu_plain(x, w, b, False)
            else:
                w = w.to(torch.int8)
                one = torch.ones(Cout, device=device)
                got = conv3x3_relu_int8(x, w, 1.0, one, b, False)
                ref = conv3x3_relu_int8_plain(x, w, 1.0, one, b, False)
            if torch.equal(got, ref):
                continue
            read = got.float() / scale  # what the kernel multiplied by the lit weight
            hit = "no single input"
            for t2 in range(9):
                same = (shifted[t2][..., :, None] == read[..., None, :]).all(dim=(0, 1, 2))
                found = same.nonzero()
                if len(found):
                    hit = f"tap {t2} channel {int(found[0, 0])} (output channel {int(found[0, 1])})"
                    break
            bad.append((tap, ci, hit))
    return bad


def stem_library(torch, x, cond, t, s):
    """PyTorch's least composition of the stem pack's output, the yardstick
    beside the kernel (the port never calls it): the two inputs' space-to-
    depth views copied with the bf16 cast into the output's channel slices,
    the t channel copied and the pad zeroed, four launches and no f32
    intermediate."""
    B, H, W, Cx = x.shape
    Cc = 0 if cond is None else cond.shape[-1]
    C = Cx + Cc
    n = s * s * C
    y = torch.empty((B, H // s, W // s, -(-(n + 1) // 8) * 8), dtype=torch.bfloat16,
                    device=x.device)
    d = y[..., :n].view(B, H // s, W // s, s, s, C)
    for lo, v in ((0, x), (Cx, cond)):
        if v is not None:
            c = v.shape[-1]
            d[..., lo:lo + c].copy_(v.view(B, H // s, s, W // s, s, c).permute(0, 1, 3, 2, 4, 5))
    y[..., n].copy_(t.float().view(B, 1, 1))
    y[..., n + 1:].zero_()
    return y


def record_ops(quant, qp, x, t):
    """ε̂ of ``quant.quant_apply(qp, x, t)`` and [(op, args, output)] of every
    op of ``QUANT_OPS`` it called, in call order (keyword arguments among
    the positional ones); the quant module is left as it was found."""
    import inspect

    calls = []
    saved = {name: getattr(quant, name) for name in QUANT_OPS}

    def wrap(name):
        def fn(*args, **kw):
            out = saved[name](*args, **kw)
            bound = inspect.signature(saved[name]).bind(*args, **kw)
            bound.apply_defaults()
            calls.append((name, bound.args, out))
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
    The int8 convs, the int8 up-convs (``quant_up``: int32 sums on the matmul
    kernel) and the max-pools must be bit-equal. The bf16 ``inc`` conv
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
        if name in EXACT_OPS:
            ok = bool(torch.equal(out, ref))
            ratio = 0.0 if ok else float("inf")
        else:
            x, w, b = args[:3]
            if name == "conv3x3_relu":
                tol = bf16_tolerance(torch, F, x, w, b, torch.maximum(out.abs(), ref.abs()),
                                     w.shape[2])
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


def rel(a, b):
    """‖a − b‖ / ‖b‖ over all elements (0 when both are 0)."""
    d, n = float((a - b).double().norm()), float(b.double().norm())
    return d / n if n else d


def train_phase(torch, dev, card, drive, require, path_launches):
    """4l: the train step on the card against the CPU, bench_train at full
    width, and the trainer with a resume (see the module docstring)."""
    import numpy as np

    from s1s2_torch.__main__ import main as dispatch
    from s1s2_torch.core import random
    from s1s2_torch.core.schedule import Schedule
    from s1s2_torch.data.synthetic import make_synthetic_patches
    from s1s2_torch.models.unet import UNetSmall, init_params
    from s1s2_torch.tools import bench_train
    from s1s2_torch.train.checkpoint import load_model, reference_artifact_paths, restore_state
    from s1s2_torch.train.checkpoint import flatten
    from s1s2_torch.train.loop import TrainConfig, create_train_state, make_train_step, upload

    # (a) card against CPU on jax's threefry draws, f32 and bf16
    base, size, B, steps = TRAIN_CHECK
    params = init_params(4, base, 1, seed=0, in_ch=8)
    cfg, sched, key = TrainConfig(T=1000), Schedule.cosine(1000), random.PRNGKey(1338)
    rng = np.random.default_rng(0)
    batch = (rng.standard_normal((B, size, size, 4)).astype(np.float32),
             rng.random((B, size, size, 4)).astype(np.float32),
             (rng.random((B, size, size)) > 0.1).astype(np.float32))
    bad = (batch[0].copy(), batch[1], batch[2])
    bad[0][1, 2, 3, 0] = np.nan

    def run(device, dtype):
        step = make_train_step(UNetSmall(4, base, 1, 8, dtype, autograd=True), sched, cfg,
                               draws="threefry")
        state = create_train_state(params, cfg, device)
        on_card = device.type == "cuda"
        if on_card:
            torch.cuda.synchronize(device)
            torch.cuda.set_sync_debug_mode("error")  # any host sync in the step raises
        try:
            t, noise, _ = step.draw(key, 0, B, batch[1].shape, device)
            _, _, _, grads = step.loss_and_grads(
                state.params, state.layout, *(upload(a, device) for a in batch), t, noise)
            ms = []
            for _ in range(steps):
                state, m = step(state, batch, key)
                ms.append(m)
            skipped_state, m_bad = step(state, bad, key)
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode("default")
        cpu = lambda t: t.detach().to("cpu")  # noqa: E731
        return {"loss": torch.stack([cpu(m["loss"]) for m in ms]),
                "ch_losses": torch.stack([cpu(m["ch_losses"]) for m in ms]),
                "grads": cpu(grads), "grad_norm": cpu(grads).norm(),
                "update": cpu(state.params) - state.layout.flatten(params),
                "ema_update": cpu(state.ema_params) - state.layout.flatten(params),
                "mu": cpu(state.opt_state.mu), "nu": cpu(state.opt_state.nu),
                "skipped": int(state.skipped), "skip_then": int(skipped_state.skipped),
                "skip_loss": float(m_bad["loss"]),
                "skip_kept": bool(torch.equal(cpu(skipped_state.params), cpu(state.params))
                                  and torch.equal(cpu(skipped_state.ema_params),
                                                  cpu(state.ema_params)))}

    keys = ("loss", "ch_losses", "grads", "update", "ema_update", "mu", "nu")
    runs = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for where in ("cpu", "card"):
            runs[name, where] = drive(f"train step {name} {where}", lambda d=dtype, w=where: (
                run(torch.device("cpu") if w == "cpu" else dev, d)))
    own = {k: rel(runs["bf16", "cpu"][k], runs["f32", "cpu"][k]) for k in keys}
    for name in ("f32", "bf16"):
        c, h = runs[name, "card"], runs[name, "cpu"]
        for k in keys:
            tol = TRAIN_SLACK[name] * own[k]
            d = rel(c[k], h[k])
            print(f"train step {name} card vs CPU (base {base}, {size}², B={B}, {steps} steps, "
                  f"threefry draws): {k} rel {d:.3e} (tolerance {tol:.3e} = {TRAIN_SLACK[name]} "
                  f"x the CPU's bf16-vs-f32 {own[k]:.3e})", flush=True)
            require(d <= tol, f"train step {name}: {k} card vs CPU {d} > {tol}")
        print(f"train step {name}: losses card {c['loss'].tolist()} CPU {h['loss'].tolist()}, "
              f"grad norm card {float(c['grad_norm']):.6g} CPU {float(h['grad_norm']):.6g}",
              flush=True)
        for r, where in ((c, "card"), (h, "CPU")):
            require(r["skipped"] == 0 and r["skip_then"] == 1 and r["skip_kept"]
                    and r["skip_loss"] != r["skip_loss"],
                    f"train step {name} {where}: the non-finite batch was not skipped cleanly "
                    f"(skipped {r['skipped']} then {r['skip_then']}, params kept "
                    f"{r['skip_kept']}, loss {r['skip_loss']})")
        require(all(v == 0 for v in path_launches[f"train step {name} card"].values()),
                f"train step {name}: launched a hand-written kernel")
    print("train step: one non-finite batch skipped on card and CPU (skipped 0 -> 1, params and "
          "EMA unchanged, loss NaN); the card's steps ran under sync debug mode 'error'",
          flush=True)

    # (b) bench_train at full width
    n_files, base96, tb, epochs = TRAIN_RUN
    rows = drive("train bench", lambda: bench_train.main(
        [str(b) for b in TRAIN_BENCH_BATCHES] + ["--iters", str(TRAIN_BENCH_ITERS), "--size",
                                                 str(SIZE), "--base_ch", str(base96),
                                                 "--device", str(dev)],
        emit=lambda line: print(f"bench_train: {line}", flush=True)))
    require(all(v == 0 for v in path_launches["train bench"].values()),
            "bench_train launched a hand-written kernel")
    for r in rows:
        require("error" not in r and np.isfinite(r["loss"]) and r["skipped"] == 0,
                f"bench_train B={r['B']} remat={r['remat']}: {r}")
        bound = bench_train.step_ops_per_sample(base96, SIZE, r["remat"]) / PEAK_OPS_PER_S["bf16"]
        print(f"train base-{base96} {SIZE}² bf16 B={r['B']} remat={r['remat']}: "
              f"{r['train_patches_per_s']:.3f} patches/s, {r['train_patches_per_s'] * bound:.4f} "
              f"of the bound ({1 / bound:.1f} patches/s), peak memory "
              f"{r['peak_mem_bytes'] / 2 ** 30:.2f} GiB, loss {r['loss']:.6g} on {card}",
              flush=True)

    # (c) the trainer through the dispatcher; bit-equal resume under
    # deterministic cuDNN
    with tempfile.TemporaryDirectory() as td, torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        make_synthetic_patches(f"{td}/p", n=n_files, size=SIZE, seed=0)

        def train(out, n_epochs, resume):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = dispatch(["train", "--patch_dir", f"{td}/p", "--model_path",
                               f"{out}/m.msgpack", "--base_ch", str(base96), "--batch_size",
                               str(tb), "--epochs", str(n_epochs), "--metrics_jsonl",
                               f"{out}/m.jsonl", "--save_state_dir", f"{out}/st", "--device",
                               str(dev)] + (["--resume"] if resume else []))
            require(rc == 0, f"train exited {rc}")
            return [json.loads(ln) for ln in buf.getvalue().splitlines()]

        t0 = time.perf_counter()
        whole = drive("train cli", lambda: train(f"{td}/a", epochs, False))
        t_whole = time.perf_counter() - t0
        first = train(f"{td}/b", epochs - 1, False)
        resumed = drive("train cli resumed", lambda: train(f"{td}/b", epochs, True))
        for path in ("train cli", "train cli resumed"):
            require(all(v == 0 for v in path_launches[path].values()),
                    f"{path}: launched a hand-written kernel")
        template = UNetSmall(4, base96, 1, 8).state_dict()
        for out in ("a", "b"):
            for f in reference_artifact_paths(f"{td}/{out}/m.msgpack"):
                loaded = load_model(template, f)
                require(all(torch.isfinite(v).all() for v in loaded.values()),
                        f"{f}: non-finite weights")
            with open(f"{td}/{out}/m.jsonl") as fh:
                lines = [json.loads(ln) for ln in fh]
            require([ln["epoch"] for ln in lines] == list(range(1, epochs + 1))
                     and all(np.isfinite(ln["avg_loss"]) for ln in lines),
                     f"metrics jsonl {out}: {lines}")
        sa, sb = restore_state(f"{td}/a/st"), restore_state(f"{td}/b/st")
        fa, fb = flatten(sa), flatten(sb)
        same = fa.keys() == fb.keys() and all(
            torch.equal(fa[k], fb[k]) if torch.is_tensor(fa[k]) else fa[k] == fb[k] for k in fa)
        with open(f"{td}/a/m.msgpack", "rb") as fh_a, open(f"{td}/b/m.msgpack", "rb") as fh_b:
            same_final = fh_a.read() == fh_b.read()
        ep_whole = [(ln["epoch"], ln["avg_loss"], ln["epoch_time_s"]) for ln in whole
                    if "avg_loss" in ln]
        at = [ln for ln in resumed if "resumed_at_step" in ln]
        print(f"train cli base {base96}, {n_files} files of {SIZE}², B={tb}, {epochs} epochs: "
              f"{t_whole:.2f} s with set-up, (epoch, avg loss, seconds) {ep_whole}; resumed at "
              f"{at}; state (params, Adam, EMA, "
              f"step, skipped) bit-equal to the unbroken run: {same}; final EMA file "
              f"bit-equal: {same_final}", flush=True)
        require(len(first) > 0 and same and same_final and int(sa["step"]) == epochs * (
            n_files // tb), "the resumed run differs from the unbroken one")
    return rows


def distill_phase(torch, dev, card, drive, require, path_launches):
    """4m: the progressive and endpoint steps on the card against the CPU,
    the committed score replays, the held-out width scores and the distill
    CLI at full width (see the module docstring)."""
    import numpy as np

    from s1s2_torch.__main__ import main as dispatch
    from s1s2_torch.core import random
    from s1s2_torch.core.schedule import Schedule
    from s1s2_torch.data.dataset import load_set
    from s1s2_torch.data.synthetic import make_synthetic_patches
    from s1s2_torch.eval.metrics import masked_mae
    from s1s2_torch.headline import CKPT_DIR
    from s1s2_torch.models.unet import UNetSmall, init_params, load_unet
    from s1s2_torch.models.weights import params_from_numpy
    from s1s2_torch.sampling.samplers import ddim_anchored, make_denoise_fn
    from s1s2_torch.tools import score_distill_full, score_width_holdout
    from s1s2_torch.train import distill
    from s1s2_torch.train.checkpoint import load_params
    from s1s2_torch.train.loop import upload

    results = Path(__file__).resolve().parent / "examples" / "results_synthetic"
    zero = {"conv3x3_relu": 0, "conv3x3_relu_int8": 0, "fused_ddim_update": 0, "matmul": 0,
            "halo_rows_x2": 0}

    def exact(path, want):
        got = path_launches[path]
        require(got == {**zero, **want}, f"{path}: launches {got}, want {({**zero, **want})}")

    # (a) card against CPU: the progressive step (bf16 on the card; f32 and
    # bf16 on the CPU give its own distance) and the endpoint step (f32 on the
    # card against the CPU's f64 network), each with one non-finite batch
    # after the steps
    base, size, B, steps, s2d = DISTILL_CHECK
    sched, key = Schedule.cosine(1000), random.PRNGKey(1000)
    params = init_params(4, base, 1, seed=0, in_ch=8)
    student = init_params(4, base, s2d, seed=1, in_ch=8)
    cfg = distill.DistillConfig(teacher_steps=4, ema_decay=0.9)
    rng = np.random.default_rng(0)
    cond = rng.standard_normal((B, size, size, 4)).astype(np.float32)
    x0 = rng.random((B, size, size, 4)).astype(np.float32)
    mask = (rng.random((B, size, size)) > 0.1).astype(np.float32)
    noise = rng.standard_normal((B, size, size, 4)).astype(np.float32)
    tgt = rng.random((B, size, size, 4)).astype(np.float32)

    def run(kind, device, dtype):
        model = UNetSmall(4, base, s2d if kind == "endpoint" else 1, 8, dtype, autograd=True)
        if kind == "progressive":
            step = distill.make_distill_step(model, sched, cfg, 2, draws="threefry")
            teacher = distill.inference_net(model, params, device)
            state = distill.create_distill_state(params, cfg, device)
            p0 = state.layout.flatten(params)
            good, bad = (cond, x0, mask), (cond, x0.copy(), mask)
            bad[1][1, 5, 6, 1] = np.nan
            call = lambda st, b: step(st, teacher, b, key)  # noqa: E731
            grads0 = lambda st: step.loss_and_grads(  # noqa: E731
                st.params, st.layout, teacher, *(upload(a, device) for a in good),
                *step.draw(key, 0, B, x0.shape, device))[-1]
        else:
            step = distill.make_endpoint_distill_step(model, sched, cfg)
            state = distill.create_distill_state(student, cfg, device)
            p0 = state.layout.flatten(student)
            good, bad = (cond, x0, mask, noise, tgt), (cond, x0, mask, noise, tgt.copy())
            bad[4][1, 2, 3, 0] = np.inf
            call = step
            grads0 = lambda st: step.loss_and_grads(  # noqa: E731
                st.params, st.layout, *(upload(a, device) for a in good))[-1]
        on_card = device.type == "cuda"
        if on_card:
            torch.cuda.synchronize(device)
            torch.cuda.set_sync_debug_mode("error")  # any host sync in the steps raises
        try:
            grads = grads0(state)
            ms = []
            for _ in range(steps):
                state, m = call(state, good)
                ms.append(m)
            skipped_state, m_bad = call(state, bad)
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode("default")
        cpu = lambda t: t.detach().to("cpu")  # noqa: E731
        out = {"loss": torch.stack([cpu(m["loss"]) for m in ms]),
               "ch_losses": torch.stack([cpu(m["ch_losses"]) for m in ms]),
               "grads": cpu(grads),
               "update": cpu(state.params) - p0, "ema_update": cpu(state.ema_params) - p0,
               "mu": cpu(state.opt_state.mu), "nu": cpu(state.opt_state.nu),
               "skipped": int(state.skipped), "skip_then": int(skipped_state.skipped),
               "skip_loss": float(m_bad["loss"]),
               "skip_kept": bool(torch.equal(cpu(skipped_state.params), cpu(state.params))
                                 and torch.equal(cpu(skipped_state.ema_params),
                                                 cpu(state.ema_params)))}
        if kind == "progressive":
            out["eps_mse"] = torch.stack([cpu(m["eps_mse"]) for m in ms])
        return out

    for kind, card_dtypes in (("progressive", ("bf16",)), ("endpoint", ("f32", "bf16"))):
        runs = {}
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            runs[name, "cpu"] = run(kind, torch.device("cpu"), dtype)
            if name in card_dtypes:
                runs[name, "card"] = drive(f"distill {kind} step {name} card",
                                           lambda k=kind, d=dtype: run(k, dev, d))
        if "f32" in card_dtypes:
            # an Adam update is near sign(g): a max-pool window whose argmax
            # sits at a near-tie routes its gradient elsewhere when the CPU's
            # f32 forward settles the tie otherwise than f64, and flips
            # updates whole; the card's f32 step is held to the f64 network
            runs["f64", "cpu"] = run(kind, torch.device("cpu"), torch.float64)
        keys = [k for k in runs["f32", "cpu"] if torch.is_tensor(runs["f32", "cpu"][k])]
        own = {k: rel(runs["bf16", "cpu"][k], runs["f32", "cpu"][k]) for k in keys}
        for name in card_dtypes:
            ref = "f64" if name == "f32" else name
            c, h = runs[name, "card"], runs[ref, "cpu"]
            flips = int(((c["update"] - h["update"]).abs() > 0.1 * cfg.lr).sum())
            print(f"distill {kind} step {name}: {flips} of {c['update'].numel()} parameters' "
                  f"updates differ by more than 0.1 x lr, card against the CPU's {ref}",
                  flush=True)
            for k in keys:
                slack = TRAIN_SLACK[name]
                tol, d = slack * own[k], rel(c[k], h[k])
                print(f"distill {kind} step {name} card vs CPU {ref} (base {base}, {size}², "
                      f"B={B}, {steps} steps): {k} rel {d:.3e} (tolerance {tol:.3e} = "
                      f"{slack} x the CPU's bf16-vs-f32 {own[k]:.3e})", flush=True)
                require(d <= tol, f"distill {kind} step {name}: {k} card vs CPU {d} > {tol}")
            print(f"distill {kind} step {name}: losses card {c['loss'].tolist()} CPU "
                  f"{h['loss'].tolist()}", flush=True)
            for r, where in ((c, "card"), (h, "CPU")):
                require(r["skipped"] == 0 and r["skip_then"] == 1 and r["skip_kept"]
                        and r["skip_loss"] != r["skip_loss"],
                        f"distill {kind} step {name} {where}: the non-finite batch was not "
                        f"skipped cleanly: {r['skipped']} then {r['skip_then']}, kept "
                        f"{r['skip_kept']}, loss {r['skip_loss']}")
            # the teacher's two forwards a step: the step-0 gradient's, the
            # steps' and the non-finite batch's
            exact(f"distill {kind} step {name} card",
                  {"conv3x3_relu": 2 * 13 * (steps + 2)} if kind == "progressive" else {})
    print("distill steps: one non-finite batch skipped on card and CPU (skipped 0 -> 1, params "
          "and EMA kept, loss NaN); the card's steps ran under sync debug mode 'error'",
          flush=True)

    def committed(name):
        with open(results / name) as f:
            return [json.loads(ln) for ln in f]

    def compare(what, rows, want):
        require([r.get("model") for r in rows] == [r.get("model") for r in want],
                f"{what}: rows {[r.get('model') for r in rows]}")
        for r, w in zip(rows, want):
            if "model" not in w:
                continue
            diffs = ", ".join(f"{k} {r[k]:.5f} ({r[k] - w[k]:+.5f})"
                              for k in score_distill_full.METRICS)
            print(f"{what} {w['model']}: {diffs} against the committed rows on {card}",
                  flush=True)
            require(abs(r["mae"] - w["mae"]) <= DISTILL_MAE_SLACK,
                    f"{what} {w['model']}: MAE {r['mae']} not within {DISTILL_MAE_SLACK} of "
                    f"{w['mae']}")

    # one forward: 13 convs; score_distill_full --int8: the teacher's 20 + 1,
    # the student's 1, 3 calibration batches, the int8 forward's bf16 inc
    score_counts = {"conv3x3_relu": 13 * (20 + 1 + 1 + 3) + 1, "conv3x3_relu_int8": 12,
                    "fused_ddim_update": 20 + 1 + 1 + 1}
    with tempfile.TemporaryDirectory() as td:
        # (b) the committed score replays on the evidence set
        make_synthetic_patches(f"{td}/patches", n=FULL_FILES, size=SIZE, seed=0)
        teacher_ckpt = str(CKPT_DIR / "distill_eps_teacher.bf16.msgpack")
        for spec, w, st, name in DISTILL_REPLAYS:
            argv = ["--workdir", td, "--teacher", teacher_ckpt, "--student",
                    str(CKPT_DIR / f"distill_eps_student{spec}.bf16.msgpack"),
                    "--student_base_ch", str(w), "--student_s2d", str(st), "--int8",
                    "--device", str(dev)]
            t0 = time.perf_counter()
            rows = drive(f"score_distill_full {spec}", lambda argv=argv: score_distill_full.main(
                argv, emit=lambda _: None))
            print(f"score_distill_full {spec}: {time.perf_counter() - t0:.2f} s", flush=True)
            compare(f"score_distill_full {spec}", rows, committed(name))
            exact(f"score_distill_full {spec}", score_counts)

        # (c) the held-out set through the dispatcher's make_synthetic
        with contextlib.redirect_stdout(io.StringIO()):
            require(dispatch(["make_synthetic", "--out", f"{td}/holdout", "--n", str(FULL_FILES),
                              "--size", str(SIZE), "--seed", str(HOLDOUT_SEED)]) == 0,
                    "make_synthetic failed")
        t0 = time.perf_counter()
        rows = drive("score_width_holdout", lambda: score_width_holdout.main(
            ["--patch_dir", f"{td}/holdout", "--widths", *HOLDOUT_WIDTHS, "--device", str(dev)],
            emit=lambda _: None))
        print(f"score_width_holdout, {len(HOLDOUT_WIDTHS)} widths: "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        compare("score_width_holdout", rows, committed("distill_width_holdout.jsonl"))
        nw = len(HOLDOUT_WIDTHS)
        exact("score_width_holdout", {"conv3x3_relu": 13 * 20 + nw * (13 * (1 + 3) + 1),
                                      "conv3x3_relu_int8": 12 * nw,
                                      "fused_ddim_update": 20 + 2 * nw})

        # (d) the CLI at full width: the 24x4 recipe, shortened, then a
        # base-96 progressive run; each line is timed as it is written
        class Lines(io.StringIO):
            def __init__(self):
                super().__init__()
                self.stamps = []

            def write(self, text):
                self.stamps += [(time.perf_counter(), ln) for ln in text.splitlines() if ln]
                return len(text)

        def cli(argv):
            out = Lines()
            with contextlib.redirect_stdout(out):
                require(dispatch(["distill"] + argv + ["--device", str(dev)]) == 0,
                        f"distill {argv} failed")
            return [(t, json.loads(ln)) for t, ln in out.stamps]

        model_path = f"{td}/s24x4.msgpack"
        t0 = time.perf_counter()
        lines = drive("distill cli 24x4", lambda: cli(
            ["--patch_dir", f"{td}/patches", "--teacher",
             str(CKPT_DIR / "distill_eps_student1.bf16.msgpack"), "--model_path", model_path,
             "--endpoint_epochs", str(DISTILL_EP), "--snapshot_every", str(DISTILL_SNAP)]
            + R2_FLAGS))
        total = time.perf_counter() - t0
        snaps = [(t, d["snapshot_epoch"]) for t, d in lines if "snapshot_epoch" in d]
        ends = [(t, d) for t, d in lines if "endpoint_epoch" in d]
        require(len(snaps) == DISTILL_EP // DISTILL_SNAP - (DISTILL_EP % DISTILL_SNAP == 0)
                and len(ends) == 1 and ends[0][1]["endpoint_epoch"] == DISTILL_EP
                and np.isfinite(ends[0][1]["loss"]) and ends[0][1]["skipped"] == 0,
                f"distill cli 24x4: lines {[d for _, d in lines]}")
        s_per_epoch = (ends[0][0] - snaps[0][0]) / (DISTILL_EP - snaps[0][1])
        steps_per_epoch = FULL_FILES * 8 // 8  # files x 8 seeds / B=8
        print(f"distill cli 24x4 (teacher distill_eps_student1, {FULL_FILES} files of {SIZE}², "
              f"8 seeds, B=8, {DISTILL_EP} epochs): {total:.2f} s with set-up; "
              f"{s_per_epoch:.4f} s/epoch ({steps_per_epoch} steps, "
              f"{steps_per_epoch / s_per_epoch:.1f} steps/s) between the epoch-{snaps[0][1]} "
              f"snapshot and the end; loss line {ends[0][1]}; the full recipe's 2800 epochs "
              f"would take {2800 * s_per_epoch:.0f} s on {card}", flush=True)
        exact("distill cli 24x4", {"conv3x3_relu": 8 * 13, "fused_ddim_update": 8})
        cond_e, gt_e, mask_e = load_set(f"{td}/patches", dev)
        noise_e = torch.from_numpy(random.normal(random.PRNGKey(1234), tuple(gt_e.shape))).to(dev)

        def score_file(path, base_ch, stem):
            net = load_unet(params_from_numpy(load_params(path)), 4, base_ch, stem, device=dev)
            pred = ddim_anchored(make_denoise_fn(net, cond_e), gt_e, sched, 200, 1,
                                 noise=noise_e)
            return float(masked_mae(pred, gt_e, mask_e))

        maes = drive("distill cli 24x4 files", lambda: [
            score_file(p, 24, 4) for p in (model_path + ".snap", model_path)])
        print(f"distill cli 24x4: snapshot (epoch {snaps[-1][1]}) and final student's evidence "
              f"ddim-1 MAE {maes[0]:.5f} / {maes[1]:.5f} (bf16; epoch {DISTILL_EP} of the "
              f"recipe's 2800)", flush=True)
        require(all(np.isfinite(m) for m in maes), f"distill cli 24x4: MAEs {maes}")

        t0 = time.perf_counter()
        lines = drive("distill cli base-96 progressive", lambda: cli(
            ["--patch_dir", f"{td}/patches", "--teacher", teacher_ckpt, "--model_path",
             f"{td}/p96.msgpack", "--teacher_steps", "4", "--epochs_per_phase", "2"]))
        total = time.perf_counter() - t0
        phases = [(t, d) for t, d in lines if "phase" in d]
        require([(d["student_steps"], d["epoch"]) for _, d in phases] == [(2, 1), (2, 2), (1, 1),
                                                                         (1, 2)]
                and all(np.isfinite(d["loss"]) and d["skipped"] == 0 for _, d in phases)
                and lines[-1][1]["phases"] == [2, 1], f"distill cli base-96: {lines}")
        n_steps = FULL_FILES // 8
        exact("distill cli base-96 progressive", {"conv3x3_relu": 2 * 2 * n_steps * 2 * 13})
        # phase 0's second epoch: the steps alone, the set-up and rebuilds outside
        epoch2 = phases[1][0] - phases[0][0]
        print(f"distill cli base-96 progressive (teacher distill_eps_teacher, 4 -> 2 -> 1, two "
              f"epochs a phase of {n_steps} steps at B=8): {total:.2f} s with set-up; phase 0's "
              f"second epoch {epoch2:.4f} s, {epoch2 / n_steps * 1e3:.2f} ms a step "
              f"({2 * 13} teacher convs and the student's forward and backward); losses "
              f"{[round(d['loss'], 6) for _, d in phases]}", flush=True)
        p96 = score_file(f"{td}/p96.msgpack", 96, 1)
        require(np.isfinite(p96), f"distill cli base-96: MAE {p96}")
    return {"s_per_epoch_24x4": s_per_epoch, "ms_per_step_96": epoch2 / n_steps * 1e3}

MESH_FILES = 16  # 4o: the train and distill runs' synthetic files
MESH_DISTILL = ["--teacher_steps", "4", "--epochs_per_phase", "1", "--endpoint_epochs", "2",
                "--batch_size", "8"]


def mesh_child(spec_path, out_path):
    """The child of 4o: each run of the spec through the dispatcher in this
    process, its launch counts set to 0 before it and read after."""
    import torch

    from s1s2_torch.__main__ import main as dispatch
    from s1s2_torch.ops.conv3x3 import conv3x3_relu, conv3x3_relu_int8
    from s1s2_torch.ops.fused_elementwise import fused_ddim_update
    from s1s2_torch.ops.halo import halo_rows_x2
    from s1s2_torch.ops.matmul import matmul

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = (conv3x3_relu, conv3x3_relu_int8, fused_ddim_update, matmul, halo_rows_x2)
    with open(spec_path) as f:
        spec = json.load(f)
    out = {"runs": {}}
    for name, argv, deterministic in spec:
        for k in kernels:
            k.launches = 0
        matmul.mode_launches = dict.fromkeys(matmul.mode_launches, 0)
        conv3x3_relu_int8.mode_launches = dict.fromkeys(conv3x3_relu_int8.mode_launches, 0)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf), torch.backends.cudnn.flags(
                enabled=True, benchmark=False, deterministic=deterministic, allow_tf32=False):
            rc = dispatch(argv)
        torch.cuda.synchronize()
        out["runs"][name] = {"rc": rc, "seconds": time.perf_counter() - t0,
                             "launches": {k.__name__: k.launches for k in kernels},
                             "matmul_modes": dict(matmul.mode_launches),
                             "int8_modes": dict(conv3x3_relu_int8.mode_launches),
                             "tail": buf.getvalue().splitlines()[-1:]}
    import torch.distributed as dist

    if dist.is_initialized():
        out.update(world=dist.get_world_size(), backend=dist.get_backend(),
                   nccl=".".join(map(str, torch.cuda.nccl.version())))
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def mesh_phase(torch, dev, card, require, path_launches, matmul_launches, int8_launches):
    """4o: the mesh at world 1 over NCCL against the runs without a group
    (see the module docstring). The children's launch counts join the
    parent's, by path and by mode."""
    import socket

    import numpy as np

    from s1s2_torch.data.synthetic import make_synthetic_patches
    from s1s2_torch.headline import CKPT_DIR

    teacher = str(CKPT_DIR / "distill_eps_teacher.bf16.msgpack")
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        make_synthetic_patches(f"{td}/ev", n=FULL_FILES, size=SIZE, seed=0)
        make_synthetic_patches(f"{td}/tr", n=MESH_FILES, size=SIZE, seed=0)
        np.save(f"{td}/scene.npy", np.random.default_rng(0).standard_normal(
            (SCENE_SIZE, SCENE_SIZE, 4)).astype(np.float32))
        print(f"mesh: data made in {time.perf_counter() - t0:.2f} s", flush=True)

        def spec(tag, mesh):
            o, m = f"{td}/{tag}", (["--mesh_data", "1"] if mesh else [])
            ev = ["evaluate", "--mode", "ddim", "--ckpt", teacher, "--patch_dir", f"{td}/ev",
                  "--t_start", "200", "--ddim_steps", str(FULL_STEPS), "--device", "cuda"]
            sc = ["infer_scene", "--scene", f"{td}/scene.npy", "--ckpt", teacher,
                  "--ddim_steps", str(SCENE_STEPS), "--batch_size", "4", "--device", "cuda"]
            return [
                ("evaluate bf16", ev + ["--out_dir", f"{o}/ev"] + m, False),
                ("evaluate int8", ev + ["--out_dir", f"{o}/ev8", "--int8"] + m, False),
                ("infer_scene bf16", sc + ["--out_dir", f"{o}/sc"] + m, False),
                ("infer_scene int8", sc + ["--out_dir", f"{o}/sc8", "--int8"] + m, False),
                ("train", ["train", "--patch_dir", f"{td}/tr", "--model_path",
                           f"{o}/tr/m.msgpack", "--batch_size", "8", "--epochs", "1",
                           "--device", "cuda"], True),
                ("distill", ["distill", "--patch_dir", f"{td}/tr", "--teacher", teacher,
                             "--model_path", f"{o}/d/s.msgpack", "--device", "cuda"]
                 + MESH_DISTILL, False)]

        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        group_env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                         MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        plain_env = {k: v for k, v in os.environ.items()
                     if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                                  "MASTER_PORT")}
        procs = {}
        t0 = time.perf_counter()
        for tag, env in (("plain", plain_env), ("mesh", group_env)):
            with open(f"{td}/{tag}.json", "w") as f:
                json.dump(spec(tag, tag == "mesh"), f)
            procs[tag] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mesh-child", f"{td}/{tag}.json",
                 f"{td}/{tag}.out.json"], env=env, cwd=os.path.dirname(os.path.abspath(__file__)),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs = {}
        try:
            for tag, p in procs.items():
                logs[tag] = p.communicate(timeout=600)[0]
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        print(f"mesh: both children done in {time.perf_counter() - t0:.2f} s", flush=True)
        for tag, p in procs.items():
            require(p.returncode == 0, f"mesh child {tag} exited {p.returncode}:\n"
                    f"{logs[tag][-4000:]}")
        res = {}
        for tag in procs:
            with open(f"{td}/{tag}.out.json") as f:
                res[tag] = json.load(f)
        m = res["mesh"]
        print(f"mesh: world {m.get('world')}, backend {m.get('backend')}, NCCL "
              f"{m.get('nccl')} on {card}", flush=True)
        require(m.get("world") == 1 and m.get("backend") == "nccl",
                f"mesh child: the group did not come up over NCCL at world 1: {m}")
        nb = FULL_FILES // FULL_BATCH
        want = {
            "evaluate bf16": {"conv3x3_relu": nb * FULL_STEPS * 13, "conv3x3_relu_int8": 0,
                              "fused_ddim_update": nb * FULL_STEPS, "matmul": 0,
                              "halo_rows_x2": 0},
            "evaluate int8": path_launches["full ddim eps int8"],
            "infer_scene bf16": path_launches["scene eps"],
            "infer_scene int8": {**path_launches["scene eps"],
                                 "conv3x3_relu_int8": SCENE_STEPS * 12},
            "train": dict.fromkeys(("conv3x3_relu", "conv3x3_relu_int8", "fused_ddim_update",
                                    "matmul", "halo_rows_x2"), 0),
            # two phases of 2 steps, two teacher forwards a step; 4 DDIM-20 rollouts
            "distill": {"conv3x3_relu": 2 * 2 * 2 * 13 + 4 * FULL_STEPS * 13,
                        "conv3x3_relu_int8": 0, "fused_ddim_update": 4 * FULL_STEPS,
                        "matmul": 0, "halo_rows_x2": 0}}
        for tag in procs:
            for name, r in res[tag]["runs"].items():
                path_launches[f"mesh {tag} {name}"] = r["launches"]
                matmul_launches[f"mesh {tag} {name}"] = r["matmul_modes"]
                int8_launches[f"mesh {tag} {name}"] = r["int8_modes"]
                print(f"mesh {tag} {name}: {r['seconds']:.2f} s, launches {r['launches']}; "
                      f"{r['tail']}", flush=True)
                require(r["rc"] in (0, None), f"mesh {tag} {name}: exit {r['rc']}")
        for name, w in want.items():
            got = {t: res[t]["runs"][name]["launches"] for t in procs}
            if name == "infer_scene int8":  # the calibration forwards: the same in both
                w = {**w, "conv3x3_relu": got["plain"]["conv3x3_relu"]}
                require(got["plain"]["conv3x3_relu"] >= SCENE_STEPS,
                        f"mesh infer_scene int8: launches {got}")
            require(got["plain"] == w and got["mesh"] == w,
                    f"mesh {name}: launches {got}, want {w}")

        def same(rel_path):
            a, b = (Path(td, t, rel_path).read_bytes() for t in ("plain", "mesh"))
            return a == b

        checks = {"evaluate bf16": "ev/ddim_metrics.csv", "evaluate int8": "ev8/ddim_metrics.csv",
                  "infer_scene bf16": "sc/scene_pred.npy", "infer_scene int8": "sc8/scene_pred.npy",
                  "train": "tr/m.msgpack", "distill": "d/s.msgpack"}
        for name, f in checks.items():
            eq = same(f)
            print(f"mesh {name}: {f} with the group (world 1, NCCL) bit-equal to the run "
                  f"without one: {eq}", flush=True)
            require(eq, f"mesh {name}: {f} differs between the mesh and the run without one")
        for t in ("plain", "mesh"):
            with open(Path(td, t, "ev/ddim_summary.txt")) as f:
                mae = float(f.read().split("MAE mean/std:")[1].split("/")[0])
            print(f"mesh {t} evaluate bf16: MAE {mae:.5f} (anchor {TEACHER_ANCHOR}, difference "
                  f"{mae - TEACHER_ANCHOR:+.5f})", flush=True)
            require(abs(mae - TEACHER_ANCHOR) < MAE_SLACK,
                    f"mesh {t}: MAE {mae} is not within {MAE_SLACK} of {TEACHER_ANCHOR}")
    return {t: {n: r["seconds"] for n, r in res[t]["runs"].items()} for t in res}


def panels_phase(torch, dev, card, drive, require, path_launches):
    """4n: the panel modes, forward and table parity, patchify, the
    checkpoint tools and the distillation demo (see the module
    docstring)."""
    import numpy as np

    from s1s2_torch.__main__ import main as dispatch
    from s1s2_torch.cli import validate_parity
    from s1s2_torch.core.schedule import Schedule
    from s1s2_torch.data.synthetic import make_synthetic_patches
    from s1s2_torch.eval import harness
    from s1s2_torch.eval.parity import REFERENCE_EXPECTED
    from s1s2_torch.headline import CKPT_DIR
    from s1s2_torch.models import convert
    from s1s2_torch.models.torch_twin import build_torch_unet
    from s1s2_torch.sampling.grids import round_unique_grid
    from s1s2_torch.sampling.samplers import ddim_linspace_coefs
    from s1s2_torch.tools import archive_ckpt, bench_patchify, demo_distill_viz
    from s1s2_torch.viz.render import read_png, save_panel, title_coverage

    repo = Path(__file__).resolve().parent
    teacher = str(CKPT_DIR / "distill_eps_teacher.bf16.msgpack")
    cfg_teacher = str(CKPT_DIR / "cfg_v_teacher.bf16.msgpack")
    crossval = repo / "examples" / "ref_crossval"
    zero = {"conv3x3_relu": 0, "conv3x3_relu_int8": 0, "fused_ddim_update": 0, "matmul": 0,
            "halo_rows_x2": 0}
    sched = Schedule.cosine(1000)

    def steps(t_start, n):
        return len(ddim_linspace_coefs(sched, t_start, n)[0]) - 1

    def exact(path, conv, ddim=0):
        want = {**zero, "conv3x3_relu": conv, "fused_ddim_update": ddim}
        require(path_launches[path] == want,
                f"{path}: launches {path_launches[path]}, want {want}")

    def quiet(fn):
        def run():
            with contextlib.redirect_stdout(io.StringIO()):
                return fn()
        return run

    def timed(path, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = drive(path, quiet(fn))
        return out, time.perf_counter() - t0

    def check_panels(d, want):
        """The files in ``d`` are ``want`` {name: (shape, title or None)}; each
        decodes to its shape and its title's strongly covered pixels are
        yellow; returns the seconds to decode them."""
        got = sorted(f for f in os.listdir(d) if f.endswith(".png"))
        require(got == sorted(want), f"{d}: files {got}, want {sorted(want)}")
        for name, (shape, title) in want.items():
            img = read_png(os.path.join(d, name))
            require(img.shape == shape, f"{name}: shape {img.shape}, want {shape}")
            if title:
                cov, dx, dy = title_coverage(title)
                ys, xs = np.nonzero(cov >= 240)
                px = img[5 + dy + ys, 10 + dx + xs].astype(int)
                require(len(ys) > 0 and bool(((px[:, :2] >= 240).all(1)
                                              & (px[:, 2] <= 15)).all()),
                        f"{name}: the title {title!r} is not drawn in yellow")

    def evaluate(out, flags):
        return dispatch(["evaluate", "--out_dir", out, "--device", str(dev)] + flags)

    nb = FULL_FILES // FULL_BATCH
    with tempfile.TemporaryDirectory() as td:
        ev, cloudy = f"{td}/evidence", f"{td}/cloudy"
        make_synthetic_patches(ev, n=FULL_FILES, size=SIZE, seed=0)
        make_synthetic_patches(cloudy, n=FULL_FILES, size=SIZE, seed=0, with_cloud=True)
        names = sorted(f for f in os.listdir(ev) if f.endswith(".npz"))

        # (a) the panel modes through the evaluate CLI
        base = ["--patch_dir", ev, "--ckpt", teacher]
        _, dt = timed("panels night_demo", lambda: evaluate(
            f"{td}/night", base + ["--mode", "night_demo", "--save_viz_n", "6"]))
        night_fwd = steps(200, FULL_STEPS)  # one batch of 8 holds the 6 panels
        exact("panels night_demo", 13 * night_fwd, night_fwd)
        check_panels(f"{td}/night/previews",
                     {f"{i:03d}_night_panel.png": (PANEL_SHAPES["night"],
                                                    f"Night demo: {names[i]}") for i in range(6)})
        print(f"night_demo: 6 panels in {dt:.2f} s ({dt / 6:.3f} s a panel, one batch of "
              f"{FULL_BATCH} x {FULL_STEPS} steps) on {card}", flush=True)
        # a panel's seconds split: the card's sampling (CUDA events, one batch
        # of 8 as night_demo samples it) against the host's render
        ctx = harness.EvalContext(harness.EvalConfig(patch_dir=ev, out_dir=f"{td}/split",
                                                     ckpt=teacher, device=str(dev)))
        (cond,) = ctx.tensors(np.stack([ctx.ds[i]["cond"] for i in range(FULL_BATCH)]))
        noise = ctx.per_file_noise(list(range(FULL_BATCH)))
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        x0 = harness._ddim_from_init(ctx.denoise_fn(cond), noise, ctx.schedule, 200, FULL_STEPS)
        ev1.record()
        torch.cuda.synchronize()
        sample_s = ev0.elapsed_time(ev1) / 1e3 / FULL_BATCH
        x0_np, cond_np = x0.cpu().numpy(), cond.cpu().numpy()
        gt_np = np.stack([ctx.ds[i]["target"] for i in range(2)])
        t0 = time.perf_counter()
        save_panel(x0_np[0], None, cond_np[0], f"{td}/split/a.png", title="Night demo: x.npz")
        t1 = time.perf_counter()
        save_panel(x0_np[1], gt_np[1], cond_np[1], f"{td}/split/b.png", title="Cloudy case: x",
                   zoom=CLOUDY_ZOOM, zoom_k=CLOUDY_ZOOM_K)
        t2 = time.perf_counter()
        print(f"a panel's seconds: the card samples a file in {sample_s:.4f} s ({FULL_STEPS} "
              f"steps at B={FULL_BATCH}); the host renders a panel in {t1 - t0:.3f} s without "
              f"GT, {t2 - t1:.3f} s with GT and {CLOUDY_ZOOM_K} zoom windows", flush=True)
        del ctx, cond, noise, x0

        tv = harness.EvalConfig(patch_dir=ev, out_dir="").t_values
        mid = tv[len(tv) // 2]
        _, dt = timed("panels tsweep", lambda: evaluate(
            f"{td}/tsweep", base + ["--mode", "tsweep", "--save_viz_n", "2"]))
        exact("panels tsweep", nb * len(tv) * 13)
        check_panels(f"{td}/tsweep/previews",
                     {f"{i:03d}_tsweep_t{mid}.png": (PANEL_SHAPES["gt"],
                                                      f"t-sweep middle t={mid}") for i in range(2)})
        print(f"tsweep: {len(tv)} t x {FULL_FILES} files, 2 panels, {dt:.2f} s on {card}",
              flush=True)

        grid = round_unique_grid(999, 5, 1000)
        _, dt = timed("panels cfg_sweep", lambda: evaluate(
            f"{td}/cfg", ["--patch_dir", ev, "--ckpt", cfg_teacher, "--mode", "cfg_sweep",
                          "--pred_param", "v", "--guidance_scales", "3", "--t_start", "999",
                          "--ddim_steps", "5", "--save_viz_n", "2"]))
        exact("panels cfg_sweep", nb * len(grid) * 13)
        check_panels(f"{td}/cfg/previews", {
            f"cfg_g3_{os.path.splitext(names[i])[0]}.png": (
                PANEL_SHAPES["gt"], f"CFG g=3  t_start=999 steps=5  {names[i]}")
            for i in range(2)})
        print(f"cfg_sweep: g=3, {len(grid)} stacked CFG forwards a batch, 2 panels, {dt:.2f} s "
              f"on {card}", flush=True)

        top = harness.EvalConfig(patch_dir=cloudy, out_dir="").select_top_cloud
        ranked = harness.cloud_ranking(harness.EvalContext(
            harness.EvalConfig(patch_dir=cloudy, out_dir=f"{td}/rank", device="cpu")))[:top]
        r, dt = timed("panels cloudy_viz", lambda: evaluate(
            f"{td}/cloudy_out", ["--patch_dir", cloudy, "--ckpt", teacher, "--mode",
                                 "cloudy_viz", "--zoom", str(CLOUDY_ZOOM), "--zoom_k",
                                 str(CLOUDY_ZOOM_K)]))
        cloudy_fwd = -(-top // FULL_BATCH) * steps(200, 20)  # real batches, the last short
        exact("panels cloudy_viz", 13 * cloudy_fwd, cloudy_fwd)
        zsh = (2 * CLOUDY_ZOOM, 2 * CLOUDY_ZOOM, 3)
        want = {}
        for i, (_, fname, _) in enumerate(ranked):
            want[f"{i:03d}_cloudy_panel.png"] = (PANEL_SHAPES["gt"], f"Cloudy case: {fname}")
            for k in range(CLOUDY_ZOOM_K):
                for part in ("s1", "gt_true", "pred_true"):
                    want[f"{i:03d}_cloudy_panel_{part}_zoom{k}.png"] = (zsh, None)
        check_panels(f"{td}/cloudy_out/previews", want)
        print(f"cloudy_viz: the {top} cloudiest of {FULL_FILES} (fractions "
              f"{[round(-f, 3) for f, _, _ in ranked]}), {top} panels and "
              f"{top * 3 * CLOUDY_ZOOM_K} zoom crops in {dt:.2f} s ({dt / top:.3f} s a panel) "
              f"on {card}", flush=True)

        # one cloudy batch (B=2) card against the CPU plain path
        t0 = time.perf_counter()
        preds = {}
        for where in (str(dev), "cpu"):
            ctx = harness.EvalContext(harness.EvalConfig(
                patch_dir=cloudy, out_dir=f"{td}/cmp_{where}", ckpt=teacher,
                mode="cloudy_viz", device=where))
            idxs = [i for _, _, i in ranked[:2]]
            items = [harness.load_patch(ctx.ds.path(i)) for i in idxs]
            cond, gt = ctx.tensors(np.stack([d["cond"] for d in items]),
                                   np.stack([d["target"] for d in items]))
            preds[where] = harness._make_recon_sampler(ctx, 200, 20)(
                cond, gt, ctx.per_file_noise(idxs),
                ctx.per_file_keys(idxs, salt=harness.ETA_SALT)).cpu()
        d = float((preds[str(dev)] - preds["cpu"]).abs().mean())
        tol = 0.015 * float(preds["cpu"].abs().mean())
        print(f"cloudy_viz batch B=2 card vs CPU plain path: mean |d| {d:.3e} (tolerance "
              f"{tol:.3e} = 1.5% of mean |pred|), {time.perf_counter() - t0:.2f} s with the "
              f"CPU's", flush=True)
        require(d <= tol and bool(torch.isfinite(preds[str(dev)]).all()),
                f"cloudy_viz card vs CPU: {d} > {tol}")

        # (b) forward parity: both crossval nets and a base-96 twin at 256²
        torch.manual_seed(0)
        twin = f"{td}/twin96.pth"
        torch.save(build_torch_unet(8, 4, 96).state_dict(), twin)
        for label, pth, extra in (("ref_eps_model", str(crossval / "ref_eps_model.pth"), []),
                                  ("ref_v_model", str(crossval / "ref_v_model.pth"), []),
                                  ("base-96 twin", twin, ["--image_size", str(SIZE),
                                                          "--batch", "2"])):
            rep, dt = timed(f"parity {label}", lambda pth=pth, extra=extra: validate_parity.main(
                ["--pth", pth, "--device", str(dev)] + extra))
            print(f"validate_parity {label}: max_abs {rep['max_abs']:.4e}, mean_abs "
                  f"{rep['mean_abs']:.4e}, rel {rep['rel']:.4e} (CPU plain bf16 rel "
                  f"{rep['cpu_bf16_rel']:.4e}, CPU f32 max_abs {rep['f32_max_abs']:.4e}; rule "
                  f"{rep['rule']}), {dt:.2f} s on {card}", flush=True)
            require(rep["pass"] and rep["compute_dtype"] == "bfloat16"
                    and rep["rule"] == "f32_max_abs < 0.001 and rel <= 2 x cpu_bf16_rel",
                    f"validate_parity {label}: {rep}")
            exact(f"parity {label}", 13)
        # a converter that transposes the stem's kernel in space must fail
        right = convert.torch_state_dict_to_params

        def wrong(sd):
            out = right(sd)
            k = out["params"]["inc"]["kernel"]
            out["params"]["inc"]["kernel"] = np.ascontiguousarray(k.transpose(1, 0, 2, 3))
            return out

        convert.torch_state_dict_to_params = wrong
        try:
            rep = validate_parity.main(["--pth", str(crossval / "ref_eps_model.pth"),
                                        "--device", str(dev)])
        finally:
            convert.torch_state_dict_to_params = right
        print(f"validate_parity with a transposed stem kernel: pass {rep['pass']}, CPU f32 "
              f"max_abs {rep['f32_max_abs']:.4e}, rel {rep['rel']:.4e}", flush=True)
        require(not rep["pass"], f"validate_parity passed a wrong conversion: {rep}")

        # (c) table parity: the ε teacher on the evidence set, ddim_eps's
        # MAE_mean expected at the committed anchor; the sweep and
        # true_infer tables cut in depth (their noise is drawn on the host,
        # 0.8 s a batch)
        with open(f"{td}/expected.json", "w") as f:
            json.dump({"ddim_eps": {"expect": {"MAE_mean": TEACHER_ANCHOR}}, **{
                k: {"config": {**REFERENCE_EXPECTED[k]["config"], **v}}
                for k, v in PARITY_CUTS.items()}}, f)
        rep, dt = timed("parity full", lambda: validate_parity.main(
            ["--full", "--patch_dir", ev, "--out_dir", f"{td}/parity", "--eps_ckpt", teacher,
             "--expected", f"{td}/expected.json", "--device", str(dev)]))
        for row in rep["rows"]:
            print(f"parity {row['table']} {row['key']}: expected {row['expected']}, actual "
                  f"{row['actual']}, rel_err {row['rel_err']} {'PASS' if row['ok'] else 'FAIL'}",
                  flush=True)
        print(f"validate_parity --full: {dt:.2f} s on {card}; tables {rep['tables_ran']}, "
              f"{rep['n_pass']} pass, {rep['n_fail']} fail (the reference's real-data rows "
              f"cannot hold on synthetic data)", flush=True)
        ddim_row = [r for r in rep["rows"] if r["table"] == "ddim_eps"]
        require(len(ddim_row) == 1 and ddim_row[0]["ok"]
                and abs(ddim_row[0]["actual"] - TEACHER_ANCHOR) < MAE_SLACK,
                f"parity ddim_eps: {ddim_row}")
        require(rep["tables_ran"] == ["ddim_eps", "sweep_eps", "true_infer_eps"]
                and all(os.path.isfile(f"{td}/parity/parity_report.{e}") for e in ("json", "txt")),
                f"parity --full: tables {rep['tables_ran']}")
        sweep = {**REFERENCE_EXPECTED["sweep_eps"]["config"], **PARITY_CUTS["sweep_eps"]}
        sweep_steps = sum(steps(t, n) for t in sweep["t_start_grid"]
                          for n in sweep["ddim_steps_grid"])
        ti = {**REFERENCE_EXPECTED["true_infer_eps"]["config"], **PARITY_CUTS["true_infer_eps"]}
        ddim_fwd = (nb * steps(200, FULL_STEPS)
                    + -(-sweep["max_files"] // FULL_BATCH) * sweep_steps
                    + ti["n_seeds"] * -(-ti["max_files"] // FULL_BATCH)
                    * steps(ti["t_start"], ti["ddim_steps"]))
        exact("parity full", 13 * ddim_fwd, ddim_fwd)

        # (d) patchify: a seeded raw scene of .npy bands at the reference's names
        raw = f"{td}/raw/scene_000.data"
        os.makedirs(raw)
        rng = np.random.default_rng(0)
        n = PATCHIFY_SCENE
        yy, xx = np.mgrid[0:n, 0:n].astype(np.float32) / n
        field = 0.5 + 0.25 * np.sin(12 * xx) * np.cos(9 * yy)
        for b in ("B2", "B3", "B4", "B8"):
            np.save(f"{raw}/{b}.img.npy", (10000 * np.clip(
                field + rng.normal(0, 0.05, (n, n)), 0, 1)).astype(np.float32))
        for name, lo, hi in (("Sigma0_HH_db_m", -20, -5), ("Sigma0_HV_db_m", -25, -10),
                             ("projectedLocalIncidenceAngle_m", 20, 50),
                             ("elevation_ref_egm2008", 0, 500)):
            np.save(f"{raw}/{name}.img.npy", rng.uniform(lo, hi, (n, n)).astype(np.float32))
        colloc = np.ones((n, n), np.float32)
        colloc[:, : n // 8] = 0
        np.save(f"{raw}/collocationFlags.img.npy", colloc)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            dispatch(["patchify", "--base-dir", f"{td}/raw", "--output-dir", f"{td}/patches",
                      "--max-patches", str(PATCHIFY_MAX)])
        man = json.loads(buf.getvalue().strip().splitlines()[-1])
        dt = time.perf_counter() - t0
        print(f"patchify {n}x{n} scene: {man['total_patches']} patches (cap {PATCHIFY_MAX}), "
              f"skipped validratio {man['validratio_skipped']} var {man['var_skipped']} dark "
              f"{man['dark_skipped']} texture {man['texture_skipped']}; {dt:.2f} s with "
              f"previews", flush=True)
        require(man["total_patches"] == PATCHIFY_MAX, f"patchify: {man}")
        _, dt = timed("panels night_demo on patchify's patches", lambda: evaluate(
            f"{td}/night_raw", ["--patch_dir", f"{td}/patches", "--ckpt", teacher, "--mode",
                                "night_demo", "--save_viz_n", "6"]))
        exact("panels night_demo on patchify's patches", 13 * night_fwd, night_fwd)
        check_panels(f"{td}/night_raw/previews", {
            f"{i:03d}_night_panel.png": (PANEL_SHAPES["night"],
                                         f"Night demo: patch_{i:06d}.npz") for i in range(6)})
        print(f"raw scene -> patchify -> night_demo: 6 panels in {dt:.2f} s on {card}",
              flush=True)
        bp = bench_patchify.run(n)
        print(f"bench_patchify {n}: {json.dumps(bp)} (host)", flush=True)

        # (e) checkpoints: convert_ckpt's msgpack gives the .pth's forward bit
        # for bit on the card; archive_ckpt's bf16 file loads
        pth = str(crossval / "ref_eps_model.pth")
        with contextlib.redirect_stdout(io.StringIO()):
            dispatch(["convert_ckpt", "--pth", pth, "--out", f"{td}/ref_eps.msgpack"])
            archive_ckpt.main([f"{td}/ref_eps.msgpack", f"{td}/ref_eps.bf16.msgpack"])
        x = torch.rand((2, SIZE, SIZE, 8), generator=torch.Generator().manual_seed(0)).to(dev)
        tt = torch.tensor([999, 200], dtype=torch.int32, device=dev)
        outs = {}
        for label, path in (("pth", pth), ("msgpack", f"{td}/ref_eps.msgpack"),
                            ("bf16 archive", f"{td}/ref_eps.bf16.msgpack")):
            ctx = harness.EvalContext(harness.EvalConfig(
                patch_dir=ev, out_dir=f"{td}/ck_{label.replace(' ', '_')}", ckpt=path,
                base_ch=16, device=str(dev)))
            with torch.no_grad():
                outs[label] = drive(f"ckpt {label}", lambda ctx=ctx: ctx.model(x, tt).cpu())
            exact(f"ckpt {label}", 13)
        same = torch.equal(outs["pth"], outs["msgpack"])
        d_arch = float((outs["bf16 archive"] - outs["pth"]).abs().max())
        print(f"convert_ckpt: the msgpack's forward bit-equal to the .pth's on the card: {same}; "
              f"the bf16 archive loads, max |d| {d_arch:.3e} from the .pth's forward (the net "
              f"rounds its weights to bf16 either way)", flush=True)
        require(same and bool(torch.isfinite(outs["bf16 archive"]).all()),
                "convert_ckpt: the msgpack's forward differs from the .pth's")

        # (f) the distillation demo against the committed rows
        work = f"{td}/demo_work"
        os.makedirs(work)
        os.symlink(ev, f"{work}/patches")
        rows, dt = timed("distill demo", lambda: demo_distill_viz.main(
            ["--workdir", work, "--out", f"{td}/demo", "--k", str(DEMO_K), "--teacher", teacher,
             "--student", str(CKPT_DIR / "distill_eps_student1.bf16.msgpack"), "--device",
             str(dev)]))
        exact("distill demo", 13 * (steps(200, 20) + steps(200, 1)),
              steps(200, 20) + steps(200, 1))
        with open(repo / "examples" / "results_synthetic" / "distill_demo" / "summary.json") as f:
            ref = json.load(f)["rows"]
        for r, w in zip(rows, ref):
            print(f"distill demo patch {r['patch']}: teacher ddim-20 {r['teacher20_mae']:.5f} "
                  f"({r['teacher20_mae'] - w['teacher20_mae']:+.5f}), student ddim-1 "
                  f"{r['student1_mae']:.5f} ({r['student1_mae'] - w['student1_mae']:+.5f}) "
                  f"against the committed rows", flush=True)
            require(all(abs(r[k] - w[k]) <= DISTILL_MAE_SLACK
                        for k in ("teacher20_mae", "student1_mae")),
                    f"distill demo: {r} not within {DISTILL_MAE_SLACK} of {w}")
        require(len(rows) == len(ref) == DEMO_K
                and sorted(os.listdir(f"{td}/demo")) == sorted(
                    [f"patch{i:02d}_gt_teacher20_student1.png" for i in range(DEMO_K)]
                    + ["summary.json"]), f"distill demo: {sorted(os.listdir(td + '/demo'))}")
        print(f"distill demo: {DEMO_K} strips in {dt:.2f} s on {card}", flush=True)


def tools_phase(torch, dev, card, drive, require, path_launches):
    """4p: the measurement tools (see the module docstring), each in
    process but the results pack, a shell script of evaluate processes."""
    import csv
    import shutil

    from s1s2_torch import bench
    from s1s2_torch.data.synthetic import make_synthetic_patches
    from s1s2_torch.headline import CKPT_DIR
    from s1s2_torch.tools import (bench_quality_matched, bench_variants,
                                  bench_width_throughput, profile_forward, puregen_table,
                                  roofline)

    def exact(path, want):
        got = {k: v for k, v in path_launches[path].items() if v}
        require(got == {k: v for k, v in want.items() if v},
                f"{path}: launches {path_launches[path]}, expected {want}")

    # (a) roofline at its defaults (B=64, base 96, DDIM-50), then the 24x4's
    # forward (B=128, base 24, 4x stem): forward 1 + 10·iters calls, scan
    # 1 + iters calls of 50 steps
    r = drive("tool roofline", lambda: roofline.run(device=dev))
    print(f"roofline base 96 on {card}: mfu {r['mfu']:.4f}, forward mfu {r['forward_mfu']:.4f}, "
          f"scan overhead {r['scan_overhead']:+.4f}", flush=True)
    require(0.0 < r["mfu"] <= 1.0 and 0.0 < r["forward_mfu"] <= 1.0,
            f"roofline: mfu {r['mfu']}, forward {r['forward_mfu']}")
    exact("tool roofline", {"conv3x3_relu": 13 * (51 + 6 * 50), "fused_ddim_update": 6 * 50})
    r = drive("tool roofline 24x4", lambda: roofline.run(batch=128, base=24, stem=4,
                                                          device=dev))
    require(0.0 < r["mfu"] <= 1.0, f"roofline 24x4: mfu {r['mfu']}")

    # (b) profile_forward: a trace file, the bf16 conv kernel on top
    with tempfile.TemporaryDirectory() as td:
        r = drive("tool profile_forward", lambda: profile_forward.run(td, device=dev))
        require(os.path.isfile(r["trace"]) and os.path.getsize(r["trace"]) > 0,
                f"profile_forward wrote no trace at {r['trace']}")
        require("conv3x3_bf16_kernel" in r["kernels"][0]["name"],
                f"profile_forward: the top device op is {r['kernels'][0]['name']}")
    exact("tool profile_forward", {"conv3x3_relu": 2 * 50 * 13, "fused_ddim_update": 100})

    # (c) the width sweep: per width 3 calibration forwards (13 bf16 convs),
    # then per batch 1 + TOOL_ITERS int8 DDIM-1 calls (the bf16 inc and 12
    # int8 convs)
    rows = drive("tool width sweep", lambda: bench_width_throughput.run(
        widths=TOOL_WIDTHS, iters=TOOL_ITERS, device=dev))
    require(len(rows) == 2 * len(TOOL_WIDTHS) and all(
        r["finite"] and r["distill1_int8_patches_per_s"] for r in rows),
        f"bench_width_throughput: {rows}")
    n = len(TOOL_WIDTHS)
    c = 1 + TOOL_ITERS
    exact("tool width sweep", {"conv3x3_relu": n * (39 + 2 * c),
                               "conv3x3_relu_int8": n * 2 * c * 12,
                               "fused_ddim_update": n * 2 * c})

    # (d) the variants, quick: B=32, ps and convt, 4 calls of 50 steps each
    rows = drive("tool variants", lambda: bench_variants.run(quick=True, device=dev))
    require([r["up"] for r in rows] == ["ps", "convt"]
            and all(r.get("patches_per_s") and r["finite"] for r in rows),
            f"bench_variants: {rows}")
    exact("tool variants", {"conv3x3_relu": 2 * 4 * 50 * 13, "fused_ddim_update": 2 * 4 * 50})

    with tempfile.TemporaryDirectory() as td:
        # (g) the results pack: the shell script's twelve evaluate processes on
        # the evidence set with the v teacher; `python` on PATH is this one.
        # It runs beside (e) and (f), in a session of its own so that the
        # script's children go with it if a check fails first
        make_synthetic_patches(f"{td}/ev", n=FULL_FILES, size=SIZE, seed=0)
        os.makedirs(f"{td}/bin")
        with open(f"{td}/bin/python", "w") as f:  # exec, not a link: a venv's python
            f.write(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')  # finds its packages
        os.chmod(f"{td}/bin/python", 0o755)
        repo = str(Path(__file__).resolve().parent)
        env = dict(os.environ, PATH=f"{td}/bin:" + os.environ.get("PATH", ""),
                   PYTHONPATH=repo)
        t_pack = time.perf_counter()
        pack_log = open(f"{td}/pack.log", "w+")
        pack = subprocess.Popen(
            ["bash", f"{repo}/s1s2_torch/tools/demo_results_pack.sh", f"{td}/ev",
             str(CKPT_DIR / "distill_v_teacher.bf16.msgpack"), f"{td}/pack", "v"],
            cwd=repo, env=env, stdout=pack_log, stderr=subprocess.STDOUT, text=True,
            start_new_session=True)
        try:
            # (e) the quality table on the ε teacher and the evidence set, the
            # anchor's protocol; then the soak, its rows beside the committed ones
            teacher = str(CKPT_DIR / "distill_eps_teacher.bf16.msgpack")
            qm = drive("tool quality ckpt", lambda: bench_quality_matched.main(
                ["--ckpt", teacher, "--n", str(FULL_FILES), "--int8", "--out", f"{td}/qm"]))
            d20 = qm["rows"][("ddim", 20)]
            print(f"quality table, ε teacher on {card}: ddim-20 MAE {d20:.5f} (anchor "
                  f"{TEACHER_ANCHORS['eps']}, difference {d20 - TEACHER_ANCHORS['eps']:+.5f}); "
                  f"summary {qm['summary']}", flush=True)
            require(abs(d20 - TEACHER_ANCHORS["eps"]) < MAE_SLACK,
                    f"quality table: ddim-20 MAE {d20} is not within {MAE_SLACK} of "
                    f"{TEACHER_ANCHORS['eps']}")
            t0 = time.perf_counter()
            soak = drive("tool quality soak", lambda: bench_quality_matched.main(
                ["--epochs", str(QM_SOAK_EPOCHS), "--n", str(FULL_FILES), "--out", f"{td}/qm"]))
            print(f"quality table, {QM_SOAK_EPOCHS}-epoch soak on {card} "
                  f"({time.perf_counter() - t0:.2f} s): " + ", ".join(
                      f"{k[0]}-{k[1]} {v:.5f} (committed {QM_SOAK_ROWS[k]})"
                      for k, v in soak["rows"].items())
                  + f"; quality_matched {soak['summary']['quality_matched']}", flush=True)
            for path in ("tool quality ckpt", "tool quality soak"):
                n = path_launches[path]
                require(min(n["conv3x3_relu"], n["fused_ddim_update"]) >= 1,
                        f"{path}: a kernel was not launched: {n}")
            require(path_launches["tool quality ckpt"]["conv3x3_relu_int8"] >= 1,
                    f"tool quality ckpt: no int8 conv: {path_launches['tool quality ckpt']}")

            # (f) the pure-generation table: the cfg_v teacher on the rich set's
            # files 96-127 (4e's set)
            rich, lst = f"{td}/rich", f"{td}/eval.txt"
            n_rich, first, end = bench.CFG_SET
            make_synthetic_patches(rich, n=n_rich, size=SIZE, seed=0, rich=True, compress=False)
            with open(lst, "w") as f:
                f.write("".join(f"patch_{i:06d}.npz\n" for i in range(first, end)))
            pg = drive("tool puregen", lambda: puregen_table.main(
                ["--ckpt", str(CKPT_DIR / "cfg_v_teacher.bf16.msgpack"), "--patch_dir", rich,
                 "--file_list", lst, "--out_dir", f"{td}/pg"] + PUREGEN_ARGS))
            cell = [r for r in pg if (r["guidance"], r["steps"]) == PUREGEN_CELL]
            require(len(pg) == 4 and len(cell) == 1, f"puregen_table: rows {pg}")
            mae = cell[0]["MAE_mean"]
            print(f"pure-generation g={PUREGEN_CELL[0]:g}, {PUREGEN_CELL[1]} steps on {card}: MAE "
                  f"{mae:.5f} (committed {PUREGEN_ANCHOR}, difference {mae - PUREGEN_ANCHOR:+.5f})",
                  flush=True)
            require(abs(mae - PUREGEN_ANCHOR) < MAE_SLACK,
                    f"puregen_table: MAE {mae} is not within {MAE_SLACK} of {PUREGEN_ANCHOR}")
            n = path_launches["tool puregen"]
            require(n["conv3x3_relu"] >= 1, f"tool puregen: no bf16 conv launched: {n}")
            rc = pack.wait(timeout=900)
        finally:
            if pack.poll() is None:
                os.killpg(pack.pid, signal.SIGKILL)
                pack.wait()
            pack_log.seek(0)
            out = pack_log.read()
            pack_log.close()
        print(out[-3000:] if rc == 0 else out[-5000:], flush=True)
        print(f"results pack on {card}: exit {rc}, {time.perf_counter() - t_pack:.2f} s "
              f"(beside (e) and (f))", flush=True)
        require(rc == 0, f"demo_results_pack.sh exited {rc}")
        committed = Path(repo) / "examples" / "results_synthetic"
        n_csv = 0
        for d in PACK_DIRS:
            ours = Path(td, "pack", d)
            require(ours.is_dir() and any(ours.iterdir()), f"results pack: {d} not written")
            for ref in sorted(committed.joinpath(d).glob("*.csv")):
                got = ours / ref.name
                require(got.is_file(), f"results pack: {d}/{ref.name} not written")
                with open(ref) as f1, open(got) as f2:
                    h_ref, h_got = next(csv.reader(f1)), next(csv.reader(f2))
                want = PACK_HEADERS_NOW.get(f"{d}/{ref.name}", h_ref)
                require(h_got == want, f"results pack: {d}/{ref.name} header {h_got}, want "
                                       f"{want} (committed {h_ref})")
                n_csv += 1
        print(f"results pack: all {len(PACK_DIRS)} directories written, {n_csv} CSV headers "
              f"as expected ({n_csv - len(PACK_HEADERS_NOW)} equal to the committed pack's, "
              f"{len(PACK_HEADERS_NOW)} the headers the harnesses write since: "
              f"{sorted(PACK_HEADERS_NOW)})", flush=True)
        shutil.rmtree(f"{td}/pack", ignore_errors=True)


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
    from s1s2_torch.headline import (CALIB_TVALS, CKPT_DIR, STEPS, TIMING_ITERS, WARMUP,
                                     evidence_set, run_headline)
    from s1s2_torch.models import quant
    from s1s2_torch.models.quant import (make_sampler_calib, quant_apply, quantize_unet,
                                         quantize_weights)
    from s1s2_torch.models.unet import load_unet
    from s1s2_torch.models.weights import params_from_numpy, spec_arch
    from s1s2_torch.ops import _build
    from s1s2_torch.ops.conv3x3 import (conv3x3_int8_q, conv3x3_int8_q_plain, conv3x3_relu,
                                        conv3x3_relu_int8, conv3x3_relu_int8_plain)
    from s1s2_torch.ops.fused_elementwise import (ddim_coefs, ddim_update_plain,
                                                  fused_ddim_update)
    from s1s2_torch.ops.halo import halo_rows_x2, halo_rows_x2_plain
    from s1s2_torch.ops.conv3x3 import quantize_act
    from s1s2_torch.ops.matmul import (matmul, matmul_int8_packed, matmul_int8_packed_plain,
                                       matmul_plain)
    from s1s2_torch.ops.pixel_shuffle import (ps_conv_transpose_2x2_int8,
                                              ps_conv_transpose_2x2_int8_plain, ps_int8_weight)
    from s1s2_torch.ops.stem_pack import stem_channels, stem_pack, stem_pack_plain
    from s1s2_torch.tools import probe_int8, ref_crossval
    from s1s2_torch.train.checkpoint import load_params

    kernels = (conv3x3_relu, conv3x3_relu_int8, fused_ddim_update, matmul, halo_rows_x2)
    path_launches, matmul_launches, int8_launches, int8q_launches = {}, {}, {}, {}
    stem_launches = {}

    def drive(path, fn):
        """Run one path with every launch count set to 0 just before it; keep
        the counts read just after (the matmul's also by mode, the int8 conv
        by scale mode, and the int8-out conv's and the stem pack's apart:
        only the probe runs the one, every inference forward the other)."""
        for k in kernels + (conv3x3_int8_q, stem_pack):
            k.launches = 0
        matmul.mode_launches = dict.fromkeys(matmul.mode_launches, 0)
        conv3x3_relu_int8.mode_launches = dict.fromkeys(conv3x3_relu_int8.mode_launches, 0)
        out = fn()
        torch.cuda.synchronize()
        path_launches[path] = {k.__name__: k.launches for k in kernels}
        matmul_launches[path] = dict(matmul.mode_launches)
        int8_launches[path] = dict(conv3x3_relu_int8.mode_launches)
        int8q_launches[path] = conv3x3_int8_q.launches
        stem_launches[path] = stem_pack.launches
        print(f"launches in {path}: {path_launches[path]}; matmul by mode "
              f"{matmul_launches[path]}; int8 conv by scale {int8_launches[path]}; int8-out "
              f"conv {int8q_launches[path]}; stem pack {stem_launches[path]}", flush=True)
        return out

    def require(cond, what):
        if not cond:
            raise AssertionError(what)

    with Phase("build"):
        info = _build.kernels().info
        print(f"built {info.path.name} compiled={info.compiled} in {info.seconds:.2f} s",
              flush=True)
        spills = ptxas_report(info.ptxas)
        require(not any(v for k, v in spills.items() if "conv3x3" in k),
                f"the conv kernels spill: {spills}")
        for name, c in sass_check(info.path).items():
            print(f"sass {name[:80]}: {c}", flush=True)
        n_plans, bad = conv_plan_mismatches()
        print(f"conv plan: the C entry and ops/conv3x3.conv_plan agree at {n_plans - len(bad)} "
              f"of {n_plans} (conv, mode) cases", flush=True)
        require(not bad, f"the conv plan's Python mirror has drifted from the C entry: {bad[:4]}")

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

    conv_inputs = bench_conv.conv_inputs(state, w8, gen)
    conv_inputs96 = bench_conv.conv_inputs(state96, w8_96, gen, rand_bias=True)

    def check_conv(inputs, name, B, H, Cin, Cout, m, label=""):
        """One conv, kernel against plain version; → (key, max abs err)."""
        x, w, b, q = inputs(name, B, H, Cin, Cout, m)
        got, ref = bench_conv.conv_call(x, w, b, q, Cin), bench_conv.plain_call(x, w, b, q, Cin)
        if m == "bf16":
            tol = bf16_tolerance(torch, F, x, w, b, torch.maximum(got.abs(), ref.abs()), Cin)
            d = (got.float() - ref.float()).abs()
            ok = bool((d <= tol).all())
            key = "conv3x3_relu"
        else:
            d = (got.float() - ref.float()).abs()
            ok = bool(torch.equal(got, ref))
            key = "conv3x3_relu_int8"
        torch.cuda.synchronize()
        e = float(d.max())
        print(f"check {m} {label}{name} {H}x{H} {Cin}->{Cout} B={B} max_abs_err={e:.3g} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        require(ok, f"conv3x3 {m} kernel disagrees at {label}{name} {H}x{H} {Cin}->{Cout}")
        return key, e

    err = {k.__name__: 0.0 for k in kernels if k is not matmul}
    err.update({"matmul bf16": 0.0, "matmul int8": 0.0})

    def awkward_inputs(name, B, H, Cin, Cout, mode):
        """Random operands at an awkward shape: |N(0,1)| activations, weights
        N(0, 0.1²) (int8: per-Co as quantize_weights makes them), bias N(0,1)."""
        x = torch.randn((B, H, H, Cin), generator=gen, device=dev).abs_().to(torch.bfloat16)
        w = 0.1 * torch.randn((3, 3, Cin, Cout), generator=gen, device=dev)
        b = torch.randn((Cout,), generator=gen, device=dev)
        if mode == "bf16":
            return x, w.to(torch.bfloat16), b, None
        sw = w.abs().amax(dim=(0, 1, 2)).clamp_min(1e-12) / 127.0
        w8 = torch.round(w / sw).clamp(-127, 127).to(torch.int8)
        sx = float(x.float().abs().amax()) / 127.0
        return x, w8, b, (sx, (torch.tensor(sx, device=dev) * sw).contiguous())

    with Phase("kernels vs plain versions"):
        for mode, Cin, Cout, chans in PROBE_CASES:
            bad = layout_probe(torch, mode, Cin, Cout, chans, dev)
            print(f"check layout probe {mode} {Cin}->{Cout}: {9 * len(chans)} (tap, channel) "
                  f"cases, " + ("clean" if not bad else f"{len(bad)} wrong, (tap, channel, "
                                f"what the kernel read): {bad[:12]}"), flush=True)
            require(not bad, f"the conv kernel's layout probe failed ({mode} {Cin}->{Cout})")
        for Cin, Cout, hw in AWKWARD_SHAPES:
            for m in ("bf16", "int8"):
                key, e = check_conv(awkward_inputs, "awkward", 1, hw, Cin, Cout, m)
                err[key] = max(err[key], e)
        # the int8-out mode: the probe's requant with ReLU, and per-channel
        # scales and a wide bias without it (outputs clipped at both ends)
        err["conv3x3_int8_q"] = 0.0
        for B, H, Cin, Cout in INT8Q_SHAPES:
            for probe in (True, False):
                x8, w8, deq, b = int8q_operands(torch, B, H, Cin, Cout, dev, gen, probe)
                got = conv3x3_int8_q(x8, w8, deq, b, apply_relu=probe)
                ref = conv3x3_int8_q_plain(x8, w8, deq, b, apply_relu=probe)
                torch.cuda.synchronize()
                same = bool(torch.equal(got, ref))
                e = float((got.int() - ref.int()).abs().max())
                err["conv3x3_int8_q"] = max(err["conv3x3_int8_q"], e)
                clipped = float((ref.abs() == 127).float().mean())
                print(f"check int8-out {'probe requant' if probe else 'per-channel, no relu'} "
                      f"{H}x{H} {Cin}->{Cout} B={B}: bit-equal={same}, max_abs_err={e:.3g}, "
                      f"clipped share {clipped:.3f} {'ok' if same else 'FAIL'}", flush=True)
                require(same, f"the int8-out conv disagrees at {H}x{H} {Cin}->{Cout} "
                              f"(probe={probe})")
        del x8, w8, got, ref
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

    with Phase("stem pack vs plain version at the cells' shapes, and its time"):
        # bit-equal to the composition it replaces, and timed beside it and
        # beside PyTorch's least composition (stem_library), two inputs
        # alternating (each larger than the L2 cache)
        def stem_inputs(B, S, cx, cc, s):
            """x_t, cond (None: one concatenated input) and t in [0, 1000)."""
            return (torch.randn((B, S, S, cx), generator=gen, device=dev),
                    torch.randn((B, S, S, cc), generator=gen, device=dev) if cc else None,
                    torch.randint(0, 1000, (B,), generator=gen, device=dev, dtype=torch.int32),
                    s)

        def stem_check(label, args):
            same = (bool(torch.equal(stem_pack(*args), stem_pack_plain(*args)))
                    and bool(torch.equal(stem_library(torch, *args), stem_pack_plain(*args))))
            torch.cuda.synchronize()
            print(f"check stem_pack {label} s={args[3]}: kernel and copy_ composition "
                  f"bit-equal to plain={same} {'ok' if same else 'FAIL'}", flush=True)
            require(same, f"the stem pack disagrees with its plain version at {label}")

        stem = {}
        for label, B, S, cx, cc, s in STEM_SHAPES:
            stem_ins = [stem_inputs(B, S, cx, cc, s) for _ in range(2)]
            for args in stem_ins:
                stem_check(label, args)
            nbytes = B * S * S * (cx + cc) * 4 + B * (S // s) ** 2 * stem_channels(cx + cc, s) * 2
            r = stem[label] = dict(
                ms=time_ms(stem_pack, stem_ins, 50), plain=time_ms(stem_pack_plain, stem_ins, 20),
                library=time_ms(lambda *a: stem_library(torch, *a), stem_ins, 20),
                bound=1e3 * nbytes / HBM_BYTES_PER_S)
            print(f"time stem_pack {label}: kernel {r['ms']:.4f} ms, plain {r['plain']:.4f} ms, "
                  f"copy_ composition {r['library']:.4f} ms, bound {r['bound']:.4f} ms (bytes: "
                  f"{r['bound'] / r['ms']:.1%} of it)", flush=True)
            del stem_ins
        # channel counts off the 16-byte path, and an 8x stem on it
        for cx, cc, s in ((3, 2, 2), (5, 4, 1), (4, 4, 8)):
            stem_check(f"(3,64,64,{cx})+({cc})", stem_inputs(3, 64, cx, cc, s))
        err["stem_pack"] = 0.0
        torch.cuda.empty_cache()

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
            paths.append((f"{spec} ", bench_conv.conv_inputs(st, quantize_weights(st)[0], gen),
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

    cfg_inputs = bench_conv.cfg_conv_inputs(cfg_qp, gen)

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
            inputs = bench_conv.conv_inputs(st, quantize_weights(st)[0], gen)
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
            inputs = bench_conv.conv_inputs(st, quantize_weights(st)[0], gen)
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

    # 3f: the int8 up-convs of quant_up, (label, state, body resolution,
    # batch): base-96 at B=2 (tile multiples), the w24 pure-generation
    # student at B=16 and the 24x4 at B=128 (K=48, N=96 and N=192: padded)
    w24_cpu = params_from_numpy(load_params(str(CKPT_DIR / W24_CKPT)))
    up_models = (("base-96", state96, SIZE, 2),
                 ("w24", {k: v.to(dev) for k, v in w24_cpu.items()}, SIZE, 16),
                 ("24x4", state, SIZE // STEM, 128))

    def up_inputs(st, name, body, B):
        """An up-conv's int8 operands: the model's own per-Co int8 kernel (packed
        once), its input (|N(0,1)| bf16) and per-tensor scale as a 0-d tensor
        on the card, deq = sx·sw, and its bias. → (x, wp, sx, deq, b, M, K, N)."""
        w8u, sw = quantize_weights(st, quant_up=True)[0][name]
        Ci, Co = w8u.shape[2], w8u.shape[3]
        H = body >> {"up3": 3, "up2": 2, "up1": 1}[name]
        x = torch.randn((B, H, H, Ci), generator=gen, device=dev).abs_().to(torch.bfloat16)
        sx = x.float().abs().amax() / 127.0
        return (x, ps_int8_weight(w8u), sx, (sx * sw).contiguous(),
                st[f"{name}.bias"].contiguous(), B * H * H, Ci, 4 * Co)

    with Phase("int8 up-convs (quant_up) on the matmul kernel's int8 mode vs plain version"):
        err["matmul int8 up"] = 0.0
        for label, st, body, B in up_models:
            for name in ("up3", "up2", "up1"):
                x, wp, sx, deq, b, M, K, N = up_inputs(st, name, body, B)
                x8 = quantize_act(x, sx).reshape(M, K)
                acc = matmul_int8_packed(x8, wp, N)
                ref = matmul_int8_packed_plain(x8, wp, N)
                same_acc = bool(torch.equal(acc, ref))
                err["matmul int8 up"] = max(err["matmul int8 up"],
                                            float((acc - ref).abs().max()))
                y = ps_conv_transpose_2x2_int8(x, wp, sx, deq, b)
                same_y = bool(torch.equal(y, ps_conv_transpose_2x2_int8_plain(x, wp, sx, deq, b)))
                torch.cuda.synchronize()
                print(f"check int8 up-conv {label} {name} B={B}: (M={M}, K={K}) x (K, N={N}), "
                      f"packed {tuple(wp.shape)}; int32 bit-equal={same_acc}, bf16 out "
                      f"bit-equal={same_y} {'ok' if same_acc and same_y else 'FAIL'}", flush=True)
                require(same_acc and same_y, f"the int8 up-conv disagrees at {label} {name}")
        del x, wp, x8, acc, ref, y
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

    def int8_forward_check(what, qp, xin, tin, n_int8=12, n_up8=0):
        """The card's int8 forward against the CPU plain path, op by op
        (``check_ops``): every op fed the same input gives the same output, up
        to the bf16 rounding of ``inc``, the bf16 up-convs and the head (the
        ``n_up8`` int8 up-convs of ``quant_up`` are bit-equal). The whole
        forward's mean |card − CPU| is printed beside the int8 quantization
        error (mean |int8 − bf16| of the same model on the CPU), not held to
        a bound: a one-ulp change in a bf16 op can move an activation across
        an int8 step in every block after it."""
        e_dev, calls = record_ops(quant, qp, xin, tin)
        rows = check_ops(torch, F, quant, what, calls)
        require(len(rows) == 21 and sum(r[0] == "conv3x3_relu_int8" for r in rows) == n_int8
                and sum(r[0] == "ps_conv_transpose_2x2_int8" for r in rows) == n_up8,
                f"{what}: the int8 forward ran {[r[0] for r in rows]}")
        qpc = qp.to("cpu")
        e_cpu = quant_apply(qpc, xin.cpu(), tin.cpu())
        e_bf16 = load_unet(qpc.params, qpc.out_ch, qpc.base_ch, qpc.stem_s2d,
                           device="cpu")(xin.cpu(), tin.cpu())
        gap = float((e_cpu - e_bf16).abs().mean())
        d = float((e_dev.cpu() - e_cpu).abs().mean())
        print(f"{what}: 21 ops, {sum(r[1] == 0 for r in rows)} bit-equal, the rest within "
              f"their bounds (worst |d|/bound of a bf16 op "
              f"{max(r[3] for r in rows if r[0] not in EXACT_OPS):.3g}); "
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

    from s1s2_torch.tools import bench_int8, bench_scene, bench_serve

    def tagged(tag):
        """An ``emit`` for the tools: their JSON rows, prefixed."""
        return lambda line: print(f"{tag}: {line}", flush=True)

    with Phase(f"quant_up: bench_int8 --quant_up, the base-96 eps teacher, {FULL_FILES} "
               f"evidence files, B={QU_BATCH}, DDIM-{QU_STEPS}"):
        with tempfile.TemporaryDirectory() as td:
            make_synthetic_patches(f"{td}/p", n=FULL_FILES, size=SIZE, seed=0)
            qu = drive("quant_up", lambda: bench_int8.run(
                batch=QU_BATCH, steps=QU_STEPS, iters=1, ckpt=teacher["eps"], patches=f"{td}/p",
                quant_up=True, device=dev, emit=tagged("bench_int8")))
            # the artifact: the quant_up net written and read back onto the card
            quant.save_quant(qu["qp"]["int8_quant_up"], f"{td}/up.int8.msgpack")
            qu_loaded = quant.load_quant(f"{td}/up.int8.msgpack", dev)
        n = path_launches["quant_up"]
        calls = 2 * QU_STEPS  # one warm-up and one timed call a path
        expect = {"conv3x3_relu": len(bench_int8.CALIB_TVALS) * 13 + calls * 13 + 2 * calls,
                  "conv3x3_relu_int8": 2 * calls * 12, "fused_ddim_update": 3 * calls,
                  "matmul": calls * 3, "halo_rows_x2": 0}
        require(n == expect and matmul_launches["quant_up"]["int8"] == calls * 3,
                f"quant_up: launches {n}, expected {expect}")
        for row in qu["rows"]:
            mae = qu[f"mae_{row['path']}"]
            print(f"bench_int8 {row['path']}: {row['patches_per_s']:.3f} patches/s at "
                  f"B={QU_BATCH}, DDIM-{QU_STEPS}, MAE {mae:.5f} (bf16 - this "
                  f"{qu['mae_bf16'] - mae:+.5f}) on {card}", flush=True)
            require(abs(mae - qu["mae_bf16"]) < MAE_SLACK and np.isfinite(mae),
                    f"quant_up: {row['path']} MAE {mae} is not within {MAE_SLACK} of bf16's")
        xin = torch.rand((2, SIZE, SIZE, 8), generator=gen, device=dev)
        tin = torch.tensor([999, 200], dtype=torch.int32, device=dev)
        int8_forward_check("base-96 int8 + quant_up forward", qu["qp"]["int8_quant_up"], xin,
                           tin, n_up8=3)
        same = torch.equal(quant_apply(qu_loaded, xin, tin),
                           quant_apply(qu["qp"]["int8_quant_up"], xin, tin))
        print(f"quant_up artifact: save_quant, then load_quant onto {dev}: "
              f"{sorted(qu_loaded.up8)} packed on the card, forward bit-equal={same}", flush=True)
        require(same and all(w.is_cuda for w in qu_loaded.up8.values()),
                "a quant_up artifact loaded onto the card does not give the same forward")
        del qu, qu_loaded
        torch.cuda.empty_cache()

    with Phase(f"scene inference: cli.infer_scene on the eps teacher ({SCENE_SIZE}x{SCENE_SIZE} "
               f"and {BENCH_SCENE}x{BENCH_SCENE})"):
        from s1s2_torch.cli import infer_scene as scene_cli

        scene = np.random.default_rng(0).standard_normal((SCENE_SIZE, SCENE_SIZE, 4)).astype(
            np.float32)

        def scene_run(device, extra=()):
            args = scene_cli.build_parser().parse_args(
                ["--scene", "-", "--ckpt", teacher["eps"], "--out_dir", "-", "--ddim_steps",
                 str(SCENE_STEPS), "--batch_size", "4", "--device", str(device), *extra])
            return scene_cli.run(args, scene, None)

        # (a) 4 tiles, one batch, on the card and on the CPU plain path
        host = drive("scene eps", lambda: scene_run(dev))
        cpu = scene_run("cpu")
        n = path_launches["scene eps"]
        require(n == {"conv3x3_relu": SCENE_STEPS * 13, "conv3x3_relu_int8": 0,
                      "fused_ddim_update": SCENE_STEPS, "matmul": 0, "halo_rows_x2": 0},
                f"scene: launches {n}")
        forward_check(f"scene {SCENE_SIZE}x{SCENE_SIZE} eps DDIM-{SCENE_STEPS}",
                      torch.from_numpy(host), torch.from_numpy(cpu),
                      0.015 * float(np.abs(cpu).mean()), "1.5% of mean |pred|")
        # (b) the device stitch against the host stitch of the same predictions
        on_dev = drive("scene eps device stitch", lambda: scene_run(dev, ["--stitch", "device"]))
        d = float(np.abs(on_dev - host).max())
        print(f"scene device stitch vs host stitch: max |d| {d:.3g} (max |pred| "
              f"{float(np.abs(host).max()):.4g})", flush=True)
        require(host.shape == (SCENE_SIZE, SCENE_SIZE, 4) and np.isfinite(host).all()
                and d <= 1e-5, f"scene: the device stitch is {d} from the host stitch")
        # (c) bench_scene at 1536x1536: eps DDIM-50 bf16 in the CLI's three
        # settings, then its default config (int8 DPM-Solver++(2M)-5, six rows)
        scene_rows = drive("scene bench eps bf16", lambda: bench_scene.main(
            ["--ckpt", teacher["eps"], "--precision", "bf16", "--solver", "ddim", "--steps",
             "50", "--t_start", "999", "--modes", "cli", "--repeats", "1", "--size",
             str(BENCH_SCENE), "--device", str(dev)], emit=tagged("bench_scene")))
        n = path_launches["scene bench eps bf16"]
        batches = 3 * (1 + 64 // 16)  # a warm-up scene and one timed scene a row
        require(n == {"conv3x3_relu": batches * 50 * 13, "conv3x3_relu_int8": 0,
                      "fused_ddim_update": batches * 50, "matmul": 0, "halo_rows_x2": 0},
                f"scene bench eps bf16: launches {n}")
        scene_rows += drive("scene bench int8", lambda: bench_scene.main(
            ["--repeats", "2", "--size", str(BENCH_SCENE), "--device", str(dev)],
            emit=tagged("bench_scene")))
        n = path_launches["scene bench int8"]
        batches, calls = 6 * (1 + 2 * 64 // 16), len(round_unique_grid(200, 5, 1000))
        require(n == {"conv3x3_relu": 3 * 13 + batches * calls,
                      "conv3x3_relu_int8": batches * calls * 12, "fused_ddim_update": 0,
                      "matmul": 0, "halo_rows_x2": 0}, f"scene bench int8: launches {n}")
        for r in scene_rows:
            print(f"scene {r['scene']} ({r['tiles']} tiles, batch {r['batch']}, {r['sampler']}) "
                  f"{r['mode']}: {r['scene_seconds']:.3f} s, {r['tiles_per_s']:.2f} tiles/s on "
                  f"{card}", flush=True)
        del host, cpu, on_dev
        torch.cuda.empty_cache()

    with Phase("serving: cli.quantize on the rich set, bench_serve, the pure-gen MAEs, CFG"):
        from s1s2_torch.cli import quantize as quantize_cli
        from s1s2_torch.data.dataset import NpzPatchDataset
        from s1s2_torch.eval.metrics import per_file_mae_mse

        w24_path = str(CKPT_DIR / W24_CKPT)
        with tempfile.TemporaryDirectory() as td:
            rich, train = Path(td, "rich"), Path(td, "train")
            make_synthetic_patches(str(rich), n=bench.CFG_SET[0], size=SIZE, seed=0, rich=True,
                                   compress=False)
            train.mkdir()
            for i in range(SERVE_EVAL[0]):  # the training files 0-95
                (train / f"patch_{i:06d}.npz").symlink_to(rich / f"patch_{i:06d}.npz")
            q_path = f"{td}/w24.int8.msgpack"
            quiet(lambda: quantize_cli.main(["--ckpt", w24_path, "--base_ch", "24",
                                             "--patch_dir", str(train), "--t_start", "999",
                                             "--out", q_path, "--device", str(dev)]))()
            rows = drive("serve bench", lambda: bench_serve.main(
                ["--int8_ckpt", q_path, "--n_lat", str(SERVE_N_LAT), "--sat_seconds",
                 str(SERVE_SAT_S), "--device", str(dev)], emit=tagged("bench_serve")))
            n = path_launches["serve bench"]
            # forwards a chunk: the v sampler's grid points; chunks: each server's
            # warm-up, a first request, n_lat timed ones, the saturated requests
            # and the predictor's 51 device-only calls
            forwards = len(round_unique_grid(999, 1, 1000))
            chunks = (2 + SERVE_N_LAT) + (2 + SERVE_N_LAT + rows[2]["requests"] + 51)
            require(n == {"conv3x3_relu": chunks * forwards,
                          "conv3x3_relu_int8": chunks * forwards * 12, "fused_ddim_update": 0,
                          "matmul": 0, "halo_rows_x2": 0},
                    f"serve bench: launches {n}, expected {chunks} chunks of {forwards} "
                    f"forwards (the counts under {SERVE_THREADS} client threads)")
            for r in rows:
                print(f"serve w24 int8 {r['phase']}: " + ", ".join(
                    f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in r.items() if k not in ("phase", "device")) + f" on {card}",
                      flush=True)
            ds = NpzPatchDataset(str(rich))
            items = [ds[i] for i in range(*SERVE_EVAL)]
            cond_e = np.stack([it["cond"] for it in items])
            gt_e = torch.from_numpy(np.stack([it["target"] for it in items]))
            mask_e = torch.from_numpy(np.stack([it["mask"] for it in items]))
            for tag, flags, anchor in (("int8", ["--int8_ckpt", q_path], SERVE_ANCHORS["int8"]),
                                       ("bf16", ["--ckpt", w24_path, "--base_ch", "24"],
                                        SERVE_ANCHORS["bf16"])):
                def served(flags=flags):
                    httpd, url, st = bench_serve.start_server(
                        flags + ["--port", "0", "--device", str(dev)])
                    try:
                        with urllib.request.urlopen(url + "/healthz") as resp:
                            health = json.loads(resp.read())
                        outs = [bench_serve.post_infer(url, cond_e, seed)
                                for seed in range(SERVE_SEEDS)]
                    finally:
                        bench_serve.stop_server(httpd)
                    return health, outs
                health, outs = drive(f"serve mae {tag}", served)
                require(health["signature"] == {"batch": 16, "patch": SIZE,
                                                "transfer_dtype": "float16"}
                        and health["model"]["int8"] == (tag == "int8")
                        and health["model"]["base_ch"] == 24, f"serve {tag}: /healthz {health}")
                maes = [per_file_mae_mse(torch.from_numpy(o), gt_e, mask_e)[0].mean().item()
                        for o in outs]
                mae = float(np.mean(maes))
                print(f"served w24 pure-gen {tag} MAE {mae:.5f} over files {SERVE_EVAL[0]}-"
                      f"{SERVE_EVAL[1] - 1} x {SERVE_SEEDS} seeds (per seed "
                      f"{[round(m, 5) for m in maes]}; committed {anchor}, difference "
                      f"{mae - anchor:+.5f}); warm-up {health['warmup_s']} s "
                      f"{health['warmup_parts']}", flush=True)
                require(all(np.isfinite(o).all() and o.shape == (32, SIZE, SIZE, 4) for o in outs)
                        and abs(mae - anchor) < MAE_SLACK,
                        f"served {tag} MAE {mae} is not within {MAE_SLACK} of {anchor}")
                require(path_launches[f"serve mae {tag}"]["conv3x3_relu"] >= 1
                        and (path_launches[f"serve mae {tag}"]["conv3x3_relu_int8"] >= 1)
                        == (tag == "int8"), f"serve {tag}: launches "
                                            f"{path_launches[f'serve mae {tag}']}")
            # the cfg_v teacher at g=3, 5 steps: one request
            cfg_path = str(CKPT_DIR / bench.CFG_CKPT)

            def cfg_request():
                httpd, url, _ = bench_serve.start_server(
                    ["--ckpt", cfg_path, "--guidance_scale", "3", "--steps", "5",
                     "--batch_size", "4", "--port", "0", "--device", str(dev)])
                try:
                    return bench_serve.post_infer(url, cond_e[:2], 5)
                finally:
                    bench_serve.stop_server(httpd)
            t0 = time.perf_counter()
            out = drive("serve cfg", cfg_request)
            print(f"served cfg_v teacher g=3, 5 steps: {tuple(out.shape)}, finite "
                  f"{bool(np.isfinite(out).all())}, {time.perf_counter() - t0:.2f} s with the "
                  f"server's start", flush=True)
            require(out.shape == (2, SIZE, SIZE, 4) and np.isfinite(out).all(),
                    f"served cfg: bad output {out.shape}")
            require(path_launches["serve cfg"]["conv3x3_relu"] == 2 * 5 * 13,
                    f"serve cfg: launches {path_launches['serve cfg']}")
        torch.cuda.empty_cache()

    with Phase("training: the train step card vs CPU, bench_train at base 96, the trainer "
               "with a resume"):
        train_rows = train_phase(torch, dev, card, drive, require, path_launches)
        torch.cuda.empty_cache()

    with Phase("distillation: the steps card vs CPU, the committed score replays, the held-out "
               "widths, the distill CLI at full width"):
        distill_phase(torch, dev, card, drive, require, path_launches)
        torch.cuda.empty_cache()

    with Phase("panels, parity and the data and checkpoint CLIs at full width"):
        panels_phase(torch, dev, card, drive, require, path_launches)
        torch.cuda.empty_cache()

    with Phase("mesh: evaluate, infer_scene, train and distill at world 1 over NCCL against the "
               "runs without a group"):
        mesh_phase(torch, dev, card, require, path_launches, matmul_launches, int8_launches)

    with Phase("measurement tools: roofline, profile_forward, the width and variant sweeps, "
               "the quality and pure-generation tables, the results pack"):
        tools_phase(torch, dev, card, drive, require, path_launches)
        torch.cuda.empty_cache()

    with Phase("probe path: probe_int8 all"):
        probe = drive("probe", lambda: probe_int8.main(["all"]))
        n = path_launches["probe"]
        # each timed case: one untimed call and ITERS timed ones; the conv
        # chains CONV_REPS convs a call, the int8 chain's check one chain more;
        # the matmul's exactness check one int8 call more, the halo's one call
        calls, reps = 1 + probe_int8.ITERS, probe_int8.CONV_REPS
        want = {"conv3x3_relu": calls * reps, "conv3x3_relu_int8": 0, "fused_ddim_update": 0,
                "matmul": 2 * calls + 1, "halo_rows_x2": calls + 1}
        require(n == want and matmul_launches["probe"] == {"bf16": calls, "int8": calls + 1}
                and int8q_launches["probe"] == (calls + 1) * reps,
                f"the probe path: launches {n} (want {want}), matmul by mode "
                f"{matmul_launches['probe']}, int8-out conv {int8q_launches['probe']} (want "
                f"{(calls + 1) * reps})")
        print(f"probe conv on {card}: bf16 chain {probe['conv']['bf16']:.4f} ms, int8 chain "
              f"{probe['conv']['int8']:.4f} ms, ratio {probe['conv']['int8_speedup']:.3f}; "
              f"F.conv2d chain {probe['conv']['conv2d_bf16']:.4f} ms", flush=True)
        torch.cuda.empty_cache()
    others = {p: c for p, c in int8q_launches.items() if c and p != "probe"}
    require(not others, f"the int8-out conv ran outside the probe: {others}")

    rows = []
    with Phase(f"timing at B={BATCH} on {card}"):
        B = BATCH
        # sums over the launches of one int8 forward (bf16 mode: inc only); the
        # int8 convs also in bf16, their calibration pass, printed apart
        sums = bench_conv.time_set("24x4", conv_inputs, shapes, {"bf16": B, "int8": B}, 20, 2,
                                   calibration=True)
        totals = {"conv3x3_relu": sums["bf16"], "conv3x3_relu_int8": sums["int8"]}
        xd = [torch.randn((B, SIZE, SIZE, 4), generator=gen, device=dev) for _ in range(3)]
        ddim_args = [(xd[i], xd[(i + 1) % 3], s1m, sabg, sabn, s1mn) for i in range(3)]
        d_ms = time_ms(fused_ddim_update, ddim_args, 50)
        d_plain = time_ms(ddim_update_plain, ddim_args, 20)
        d_bound = 1e3 * 16 * xd[0].numel() / HBM_BYTES_PER_S
        print(f"time ddim_update {tuple(xd[0].shape)}: kernel {d_ms:.4f} ms, plain {d_plain:.4f} ms, "
              f"bound {d_bound:.4f} ms (bytes)", flush=True)
        del xd, ddim_args
        torch.cuda.empty_cache()

    with Phase(f"timing at the base-96 shapes and the probe's on {card}"):
        # the 13 convs of one bf16 forward (line 1), the 12 int8 convs of one int8
        # forward (line 2), the CFG net's 10 per-channel int8 convs
        bench_conv.time_set("base-96", conv_inputs96, bench_conv.bf16_all(shapes96),
                            {"bf16": bench.LINE1_BATCH}, 3, 1)
        bench_conv.time_set("base-96", conv_inputs96, bench_conv.int8_only(shapes96),
                            {"int8": bench.LINE2_BATCH}, 3, 1)
        pc = bench_conv.time_set("cfg", cfg_inputs, bench_conv.int8_only(cfg_shapes),
                                 {"int8": CFG_CHECK_BATCH}, 3, 1, per_channel=True)["int8"]

        # the int8-out mode at the probe's shape (one conv of its chain), two
        # inputs alternating, beside its plain version and its bound (no
        # PyTorch call computes an int8 conv on the card)
        B, H, _, C = probe_int8.CONV_SHAPE
        ins = [int8q_operands(torch, B, H, C, C, dev, gen) for _ in range(2)]
        q_ms = time_ms(conv3x3_int8_q, ins, 20)
        q_plain = time_ms(conv3x3_int8_q_plain, ins, 1)
        q_bound, q_by = bound_ms(2 * B * H * H * C + 9 * C * C + 8 * C,
                                 2.0 * 9 * B * H * H * C * C, "int8")
        print(f"time int8-out conv {H}x{H} {C}->{C} B={B}: kernel {q_ms:.4f} ms "
              f"({2.0 * 9 * B * H * H * C * C / q_ms / 1e9:.1f} T/s), plain {q_plain:.4f} ms, "
              f"bound {q_bound:.4f} ms ({q_by}), {q_bound / q_ms:.3f} of the bound", flush=True)
        del ins
        torch.cuda.empty_cache()

        # the int8 up-convs' products on the packed weights: each model's three
        # at its 3f batch, and base-96's at bench_int8's B=64 (the quant_up path;
        # its sums are the kernel row's), beside the plain version and
        # torch._int_mm on the same unpadded operands
        up = dict(ms=0.0, plain=0.0, library=0.0, bound=0.0, bytes=0.0, operations=0.0)
        for label, st, body, B in up_models + (("base-96", state96, SIZE, QU_BATCH),):
            for name in ("up3", "up2", "up1"):
                ins, libs = [], []
                for _ in range(2):
                    x, wp, sx, _, _, M, K, N = up_inputs(st, name, body, B)
                    x8 = quantize_act(x, sx).reshape(M, K)
                    ins.append((x8,))
                    libs.append((x8, wp[:N, :K].t().contiguous()))
                ms = time_ms(lambda a, wp=wp, N=N: matmul_int8_packed(a, wp, N), ins, 20)
                plain_ms = time_ms(lambda a, wp=wp, N=N: matmul_int8_packed_plain(a, wp, N),
                                   ins, 3)
                lib_ms = time_ms(torch._int_mm, libs, 20)
                bound, by = matmul_bound_ms(M, K, N, "int8")
                print(f"time int8 up-conv {label} {name} B={B} (M={M}, K={K}) x (K, N={N}): "
                      f"kernel {ms:.4f} ms (padded to {tuple(wp.shape)}), plain {plain_ms:.4f} ms, "
                      f"_int_mm {lib_ms:.4f} ms, bound {bound:.4f} ms ({by})", flush=True)
                if B == QU_BATCH:
                    for k, v in (("ms", ms), ("plain", plain_ms), ("library", lib_ms),
                                 ("bound", bound), (by, bound)):
                        up[k] += v
                del ins, libs, x, wp, x8
        print(f"time base-96 3 int8 up-convs, B={QU_BATCH}: kernel {up['ms']:.4f} ms, plain "
              f"{up['plain']:.4f} ms, _int_mm {up['library']:.4f} ms, bound {up['bound']:.4f} ms",
              flush=True)
        torch.cuda.empty_cache()

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
            ms, plain_ms, lib_ms = (time_ms(kfn, ins, 20), time_ms(pfn, ins, 4),
                                    time_ms(lfn, ins, 20))
            bound, by = matmul_bound_ms(M, K, N, mode)
            print(f"time matmul {mode} {M}x{K}x{N}: kernel {ms:.4f} ms "
                  f"({2 * M * K * N / ms / 1e9:.1f} T/s), plain {plain_ms:.4f} ms, "
                  f"{lfn.__name__} {lib_ms:.4f} ms, bound {bound:.4f} ms ({by}); probe best "
                  f"of 8: {probe['matmul']['kernel_' + mode]:.4f} ms", flush=True)
            mm[mode] = dict(ms=ms, plain=plain_ms, library=lib_ms, bound=bound, by=by)
            del ins
        H, W, C, TH = HALO_CASES[0]
        ins = [(torch.randn((H, W, C), generator=gen, device=dev),) for _ in range(2)]
        h_ms = time_ms(lambda x: halo_rows_x2(x, TH), ins, 50)
        h_plain = time_ms(halo_rows_x2_plain, ins, 50)
        h_lib = time_ms(lambda x: x[1:-1] * 2.0, ins, 50)
        h_bound, h_by = halo_bound_ms(H, W, C)
        print(f"time halo_rows_x2 ({H},{W},{C}) TH={TH}: kernel {h_ms:.4f} ms, plain "
              f"{h_plain:.4f} ms, x[1:-1]*2 {h_lib:.4f} ms, bound {h_bound:.4f} ms ({h_by})",
              flush=True)
        del ins
        torch.cuda.empty_cache()

    with Phase("stem pack: one launch a forward on the inference paths"):
        exact = {f"headline {spec}": len(CALIB_TVALS) + (1 + WARMUP + TIMING_ITERS) * STEPS
                 for spec in ("24x4", "16x2", "12")}
        # bench lines: one warm-up and one timed call; line 2 calibrates first
        exact.update({"bench line 1": 2 * 50, "bench line 2": 4 + 2 * 5})
        bad = []
        for path in STEM_PATHS:
            n = path_launches[path]
            forwards = (n["conv3x3_relu"] + n["conv3x3_relu_int8"]) / 13
            want = exact.get(path, forwards)
            print(f"stem pack launches in {path}: {stem_launches[path]}, forwards {forwards:g}"
                  + (f", expected {want}" if path in exact else ""), flush=True)
            if stem_launches[path] != want or forwards != want:
                bad.append((path, stem_launches[path], forwards, want))
        require(not bad, f"stem pack launches (path, launches, forwards, expected): {bad}")

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
    rows.append({"name": f"conv3x3 (int8-out mode: int8 in, requant to int8; the probe's conv, "
                         f"B={probe_int8.CONV_SHAPE[0]}, {probe_int8.CONV_SHAPE[1]}², "
                         f"{probe_int8.CONV_SHAPE[3]}->{probe_int8.CONV_SHAPE[3]})",
                 "route": "cuda", "source": src + "conv3x3.cu",
                 "replaces": "s1s2/ops/conv3x3.py:130",
                 "launches": sum(int8q_launches.values()),
                 "max_abs_err": err["conv3x3_int8_q"], "ms": q_ms, "plain_ms": q_plain,
                 "bound_ms": q_bound, "bound_by": q_by, "library_ms": None})
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
    rows.append({"name": f"matmul (int8 mode, packed B: base-96's 3 up-convs of quant_up, "
                         f"B={QU_BATCH})", "route": "cuda",
                 "source": src + "matmul.cu", "replaces": "tools/probe_pallas_int8.py:43",
                 "launches": matmul_launches["quant_up"]["int8"],
                 "max_abs_err": err["matmul int8 up"], "ms": up["ms"], "plain_ms": up["plain"],
                 "bound_ms": up["bound"],
                 "bound_by": "bytes" if up["bytes"] >= up["operations"] else "operations",
                 "library_ms": up["library"]})
    for label, B, S, cx, cc, s in STEM_SHAPES:
        r = stem[label]
        rows.append({"name": f"stem_pack ({label}: ({B},{S},{S},{cx})+({cc}), s={s})",
                     "route": "cuda", "source": src + "stem_pack.cu", "replaces": None,
                     "launches": sum(stem_launches.values()), "max_abs_err": err["stem_pack"],
                     "ms": r["ms"], "plain_ms": r["plain"], "bound_ms": r["bound"],
                     "bound_by": "bytes", "library_ms": r["library"]})
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
    print(f"training on {card}, base 96, {SIZE}², bf16, patches/s: " + ", ".join(
        f"B={r['B']}{' remat' if r['remat'] else ''} {r['train_patches_per_s']:.2f}"
        for r in train_rows), flush=True)
    print(f"total launches by path: {path_launches}", flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-child"]:
        sys.exit(mesh_child(*sys.argv[2:4]))
    sys.exit(main())
