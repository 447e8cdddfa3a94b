"""The readings that a cell's limits are set from, on the card: the
program's check numbers on many seeds and the control's on a few, in one
process (the benchmark's own runs never run the control).

    python3 benchmark/control.py --workload <cell> --seeds 11 12 ... \
        [--control-seeds 31 32 33] [--seconds 3] [--out readings.jsonl]

Each seed is a whole run of the cell (set-up, a short window at the cell's
own load, the check against the plain reference) with the limits of
``benchmark/workloads/<cell>.json``. The control is the cell file's
``control``: the reference of a lower-precision denoiser (``reference``:
int4 for an int8 configuration), or the program with another denoiser
(``mix``: int8 for a bf16 configuration), put in the program's place and
judged against the same reference. One JSON line a run: the seed, whether it was
the control, the numbers compared, ``correct`` and the run's seconds.
"""

if __name__ == "__main__":
    import argparse
    import json
    import sys
    import time
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

    import torch

    from benchmark.harness import cell

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("the readings are taken on a CUDA card")
    ctl = cell.load_cell(args.workload, False).check["control"]
    runs = [(s, None) for s in args.seeds] + [(s, ctl) for s in args.control_seeds]
    out = open(args.out, "a") if args.out else None
    try:
        for seed, control in runs:
            t0 = time.perf_counter()
            r = cell.run(args.workload, seed, args.seconds, False, t0, control=control)
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "control": control is not None, "correct": r["correct"],
                               "check": r["check"], "attempted": r["attempted"],
                               "seconds": time.perf_counter() - t0,
                               "reference_s": r["reference_s"],
                               "setup_s": r["metrics"].get("setup_s", {}).get("value"),
                               "memory_peak_bytes": r["device"]["memory_peak_bytes"]})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
