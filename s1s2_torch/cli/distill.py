"""Step-distillation CLI: distills a trained ε- or v-checkpoint into a
few-step (default one-step) ε-student for the anchored-DDIM grid, saved as
a model file every eval and inference CLI reads (``evaluate --mode ddim
--steps <final_steps>``).

    python -m s1s2_torch distill --patch_dir P --teacher out/model.msgpack \\
        --model_path out/distilled.msgpack --t_start 200 \\
        --teacher_steps 16 --final_steps 1 --epochs_per_phase 4 [--device cpu]

The port of the JAX package's ``cli/distill.py``: every flag and default of
its parser, plus ``--device`` (the card by default). The recipe that
reached quality-matched one-step sampling is progressive phases at
``--epochs_per_phase 250`` THEN ``--endpoint_epochs 150``; width
distillation (``--student_base_ch``/``--student_s2d``) is endpoint-only
(``--skip_progressive``). One process runs on each device:
``--coordinator``/``--num_processes``/``--process_id``, or torchrun's
environment (``python -m torch.distributed.run --nproc_per_node N -m
s1s2_torch distill ...``), bring up the process group (NCCL on the card,
Gloo with ``--device cpu``). Both phases run on the data mesh
``make_mesh_for_batch(--batch_size)`` over the group's ranks (1×1×1 without
a group), and rank 0 alone writes the student and its snapshots. One JSON line is printed per progress record, and
a final one, on every rank.
"""

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("s1s2_torch distill")
    ap.add_argument("--patch_dir", type=str, required=True)
    ap.add_argument("--teacher", type=str, required=True,
                    help="teacher checkpoint (.msgpack or reference .pth)")
    ap.add_argument("--model_path", type=str, required=True,
                    help="output .msgpack for the distilled student")
    ap.add_argument("--T", type=int, default=1000)
    ap.add_argument("--t_start", type=int, default=200,
                    help="top of the anchored-DDIM grid being distilled")
    ap.add_argument("--teacher_steps", type=int, default=16)
    ap.add_argument("--final_steps", type=int, default=1)
    ap.add_argument("--epochs_per_phase", type=int, default=4)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--weight_decay", type=float, default=1e-4)
    ap.add_argument("--grad_clip", type=float, default=0.5)
    ap.add_argument("--ema_decay", type=float, default=0.999)
    ap.add_argument("--teacher_param", choices=["eps", "v"], default="eps")
    ap.add_argument("--base_ch", type=int, default=96)
    ap.add_argument("--max_patches", type=int, default=None)
    ap.add_argument("--schedule", choices=["cosine", "linear"], default="cosine")
    ap.add_argument("--compute_dtype", choices=["bfloat16", "float32"], default="bfloat16",
                    help="float32 is the CPU's parity mode: on the card the teacher's "
                         "conv kernel takes bf16 only and raises for float32")
    ap.add_argument("--mask_as_weights", action="store_true")
    ap.add_argument("--seed", type=int, default=1337)
    # endpoint mode (trajectory-endpoint regression at the fixed grid top)
    ap.add_argument("--endpoint_epochs", type=int, default=0,
                    help="fine-tune the student on teacher ddim endpoints "
                         "for this many epochs after the progressive phases")
    ap.add_argument("--endpoint_seeds", type=int, default=4)
    ap.add_argument("--endpoint_teacher_steps", type=int, default=20,
                    help="teacher sampler budget for the endpoint targets")
    ap.add_argument("--endpoint_mode", choices=["anchored", "puregen"], default="anchored",
                    help="anchored: distill the GT-anchored reconstruction "
                         "map; puregen: distill pure generation from unit "
                         "noise (use with --t_start 999)")
    ap.add_argument("--student_param", choices=["eps", "v"], default="eps",
                    help="student head for the ENDPOINT phase. Use 'v' with "
                         "--endpoint_mode puregen: the v readout "
                         "x0̂ = √ᾱ·x_t − √(1−ᾱ)·v is O(1)-conditioned at "
                         "t≈T where the ε readout divides by √ᾱ≈1e-4 "
                         "(train/distill.py EndpointStep)")
    ap.add_argument("--guidance_scale", type=float, default=None,
                    help="roll the endpoint TEACHER with classifier-free "
                         "guidance at this scale (one stacked forward); the "
                         "student absorbs guidance so inference stays one "
                         "plain call — requires a cond-dropout-trained "
                         "teacher (train --cfg_drop_prob)")
    ap.add_argument("--student_base_ch", type=int, default=None,
                    help="WIDTH distillation: train a student of this "
                         "base_ch against the (--base_ch) teacher's map. "
                         "Implies endpoint-only (--skip_progressive); the "
                         "student starts from random init unless "
                         "--student_init is given")
    ap.add_argument("--student_s2d", type=int, default=1,
                    help="ARCHITECTURE distillation: give the student a "
                         "space-to-depth stem of this factor (UNetSmall."
                         "stem_s2d): the body runs at (H/s, W/s) with a "
                         "sub-pixel output head. Implies endpoint-only, "
                         "like --student_base_ch")
    ap.add_argument("--student_init", type=str, default=None,
                    help="checkpoint to INITIALIZE the student from (e.g. an "
                         "already-distilled student, for endpoint-only head "
                         "retargeting). Default: the teacher when "
                         "--skip_progressive, else the progressive result")
    ap.add_argument("--snapshot_every", type=int, default=0,
                    help="during the endpoint phase, save a debiased-EMA "
                         "student snapshot to <model_path>.snap every N "
                         "epochs — a long run killed mid-way still leaves "
                         "a usable checkpoint")
    ap.add_argument("--coordinator", type=str, default=None,
                    help="host:port of process 0 (brings up torch.distributed)")
    ap.add_argument("--num_processes", type=int, default=None)
    ap.add_argument("--process_id", type=int, default=None)
    ap.add_argument("--skip_progressive", action="store_true",
                    help="endpoint-only distillation from the raw teacher. "
                         "Measured weak at t_start=200 (a raw-teacher "
                         "80-epoch endpoint run scored 0.487 vs 0.356 for "
                         "progressive+endpoint on the same teacher): "
                         "prefer the default progressive phases followed "
                         "by --endpoint_epochs")
    ap.add_argument("--device", default="cuda",
                    help="where distillation runs: cuda (default) or cpu")
    return ap


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.skip_progressive and args.endpoint_epochs <= 0:
        ap.error("--skip_progressive with --endpoint_epochs 0 would run no "
                 "distillation at all (the saved 'student' would be the "
                 "unchanged teacher); pass --endpoint_epochs > 0")
    width_change = ((args.student_base_ch is not None and args.student_base_ch != args.base_ch)
                    or args.student_s2d != 1)
    if width_change and not args.skip_progressive:
        ap.error("--student_base_ch/--student_s2d require "
                 "--skip_progressive: the progressive phases alternate "
                 "teacher/student roles on one architecture; width/arch "
                 "distillation is an endpoint-only regression onto the "
                 "teacher's map")
    if args.student_init and not width_change and not args.skip_progressive:
        ap.error("--student_init only makes sense with "
                 "--skip_progressive (progressive distillation would "
                 "overwrite the init from the teacher)")
    from s1s2_torch.parallel.mesh import (backend_for, initialize_distributed, is_writer,
                                          make_mesh_for_batch)

    initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                           backend=backend_for(args.device))
    # the data mesh over the process group's ranks; 1×1×1 without a group
    mesh = make_mesh_for_batch(args.batch_size)
    if not mesh.active:
        print(json.dumps({"idle_rank": mesh.rank, "mesh": mesh.shape}), flush=True)
        return

    from s1s2_torch.core.schedule import Schedule
    from s1s2_torch.data.dataset import NpzPatchDataset, load_set
    from s1s2_torch.data.loader import batch_iterator
    from s1s2_torch.models.unet import UNetSmall, init_params
    from s1s2_torch.models.weights import params_from_numpy
    from s1s2_torch.train.checkpoint import load_model, save_model
    from s1s2_torch.train.distill import (DistillConfig, endpoint_distill,
                                          progressive_distill)
    from s1s2_torch.train.trainer import DTYPES, resolve_device

    device = resolve_device(args.device, "distillation")
    ds = NpzPatchDataset(args.patch_dir, max_files=args.max_patches)
    Cc, Ct, H, W = ds.probe_channels()
    schedule = Schedule.cosine(args.T) if args.schedule == "cosine" else Schedule.linear(args.T)
    dtype = DTYPES[args.compute_dtype]
    model = UNetSmall(out_ch=Ct, base_ch=args.base_ch, in_ch=Cc + Ct, compute_dtype=dtype,
                      autograd=True)
    def load(template, path):
        # .pth and msgpack files (load_params), held to the architecture's
        # names and shapes, as f32 tensors
        return params_from_numpy(load_model(template, path))

    teacher = load(model.state_dict(), args.teacher)

    cfg = DistillConfig(
        T=args.T, t_start=args.t_start, teacher_steps=args.teacher_steps,
        final_steps=args.final_steps, epochs_per_phase=args.epochs_per_phase,
        lr=args.lr, weight_decay=args.weight_decay, grad_clip=args.grad_clip,
        ema_decay=args.ema_decay, teacher_param=args.teacher_param,
        mask_as_weights=args.mask_as_weights)

    def batches(phase, epoch):
        return batch_iterator(ds, args.batch_size, shuffle=True, drop_last=True,
                              seed=args.seed, epoch=phase * 10_000 + epoch,
                              process_index=mesh.coord("data"), process_count=mesh.data)

    def log(d):
        # one write a record, so nothing can splice between text and newline
        sys.stdout.write(json.dumps(d) + "\n")
        sys.stdout.flush()

    phases = []
    student_model = None
    if width_change:
        student_model = UNetSmall(out_ch=Ct, base_ch=args.student_base_ch or args.base_ch,
                                  stem_s2d=args.student_s2d, in_ch=Cc + Ct,
                                  compute_dtype=dtype, autograd=True)
        # flax's init of the student at PRNGKey(seed + 1), bit for bit
        student = init_params(Ct, args.student_base_ch or args.base_ch, args.student_s2d,
                              seed=args.seed + 1, in_ch=Cc + Ct)
        if args.student_init:
            student = load(student, args.student_init)
    elif args.student_init:
        student = load(teacher, args.student_init)
    elif args.skip_progressive:
        student = teacher
    else:
        result = progressive_distill(model, schedule, cfg, teacher, batches, progress=log,
                                     mesh=mesh, device=device)
        student = result["params"]
        phases = [h["student_steps"] for h in result["phase_history"]]

    if args.endpoint_epochs > 0:
        cond, x0, mask = load_set(args.patch_dir, max_files=args.max_patches)
        snap_path = args.model_path + ".snap"

        def snapshot(params, ep):
            # save_model writes a temporary file and os.replace's it into
            # place: a crash mid-write leaves the previous snapshot whole
            if is_writer():
                save_model(params, snap_path)
            log({"snapshot_epoch": ep, "path": snap_path})

        student = endpoint_distill(
            model, schedule, cfg, student, teacher, cond, x0, mask,
            epochs=args.endpoint_epochs, batch_size=args.batch_size,
            teacher_steps=args.endpoint_teacher_steps, n_seeds=args.endpoint_seeds,
            progress=log, seed=args.seed, mode=args.endpoint_mode,
            student_param=args.student_param, guidance_scale=args.guidance_scale,
            student_model=student_model, snapshot_every=args.snapshot_every,
            snapshot_fn=snapshot if args.snapshot_every > 0 else None, mesh=mesh,
            device=device)

    if is_writer():
        save_model(student, args.model_path)
    log({
        "saved": args.model_path,
        "final_steps": int(args.final_steps),
        "phases": phases,
        "endpoint_epochs": args.endpoint_epochs,
        "student_param": args.student_param,
        "guidance_scale": args.guidance_scale,
        "student_base_ch": ((args.student_base_ch or args.base_ch) if width_change
                            else args.base_ch),
        "student_s2d": args.student_s2d,
    })


if __name__ == "__main__":
    main()
