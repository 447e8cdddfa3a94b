"""One run of one cell: set-up, warm-up, the measured window, the check,
and the result line.

Everything a cell needs is found by name: the cell and its metrics in
``BENCHMARK.json``; its configuration in the file the manifest names; its
traffic mix in ``benchmark/traffic/<mix>.json``, and the entry and the
denoiser that the mix names in ``benchmark/entries/`` and
``benchmark/denoisers/``; its check in ``benchmark/workloads/<cell>.json``;
each metric's reader in ``benchmark/metrics/<metric>.py``. No cell, mix,
configuration, entry, denoiser or metric is named in code.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from benchmark.harness import check, counts, trace
from benchmark.harness.traffic import ROOT, Inputs, Program, plugin
WARMUP_CALLS = 2
FORBIDDEN = ("jax", "jaxlib", "flax", "s1s2")  # whole top-level module names


@dataclasses.dataclass
class Cell:
    name: str
    entry: Dict  # the manifest's workload entry
    cfg: Dict
    mix: Dict
    check: Dict
    metrics: List[Dict]  # the manifest's metric entries this cell reports


def load_cell(name: str, trace_on: bool) -> Cell:
    """The cell ``name`` and everything it names, read from the files."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    cfg = json.loads((ROOT / cfg_entry["file"]).read_text())
    mix = json.loads((ROOT / "benchmark" / "traffic" / f"{entry['traffic']}.json").read_text())
    chk = json.loads((ROOT / "benchmark" / "workloads" / f"{name}.json").read_text())
    group = manifest["per_layer" if trace_on else "end_to_end"]
    metrics = [m for m in group if name in m.get("workloads", [name])]
    return Cell(name, entry, cfg, mix, chk, metrics)


def reader(metric: str) -> Callable:
    """The ``read(ctx)`` of ``benchmark/metrics/<metric>.py``."""
    return plugin("metrics", metric).read


@dataclasses.dataclass
class Window:
    calls: int
    patches: int
    seconds: float  # host clock, first dispatch to the final synchronize
    per_call_ms: List[float]  # device time between consecutive calls' events


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(program: Program, inputs: Inputs, seconds: float, keep: check.Reservoir,
            device: torch.device) -> Window:
    """Calls back to back, dispatched ahead with no sync between them, until
    the host clock passes ``seconds``; one CUDA event after each call, read
    after the final synchronize."""
    cuda = device.type == "cuda"
    marks: list = []

    def mark():
        if cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append(e)
        else:
            marks.append(time.perf_counter())

    n = 0
    t0 = time.perf_counter()
    mark()
    deadline = t0 + seconds
    while True:
        noise = inputs.call_noise()
        keep.offer(n, noise, program(noise))
        n += 1
        mark()
        if time.perf_counter() >= deadline:
            break
    sync(device)
    elapsed = time.perf_counter() - t0
    if cuda:
        per_call = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        per_call = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    return Window(n, n * inputs.shape[0], elapsed, per_call)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run(name: str, seed: int, seconds: float, trace_on: bool, t_start: float,
        device: Optional[torch.device] = None, overrides: Optional[Dict] = None,
        control: Optional[Dict] = None) -> Dict:
    """One run; → the result line's dict. ``overrides`` (tests) replaces
    keys of the configuration's ``arch`` and of the mix. ``control`` puts a
    lower precision in the program's place (``benchmark/control.py``): the
    program with the mix's keys replaced by ``control["mix"]`` (another
    ``denoiser`` and its keys), or the reference of the denoiser
    ``control["reference"]``; the outputs are judged against the cell's own
    reference either way."""
    cell = load_cell(name, trace_on)
    cfg, mix = cell.cfg, dict(cell.mix)
    if overrides:
        cfg = dict(cfg, arch=dict(cfg["arch"], **overrides.get("arch", {})))
        mix.update(overrides.get("mix", {}))
    control = control or {}
    prog_mix = dict(mix, **control.get("mix", {}))
    device = device or torch.device("cuda", 0)
    marks = [("imports", time.perf_counter())]
    inputs = Inputs(cfg, prog_mix, seed, device)
    sync(device)
    marks.append(("inputs", time.perf_counter()))
    program = Program(cfg, prog_mix, inputs)
    sync(device)
    marks.append(("program", time.perf_counter()))
    for _ in range(WARMUP_CALLS):
        program(inputs.call_noise())
    sync(device)
    marks.append(("warmup", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    # where set-up went: process start to here, weights and inputs, the
    # program's own set-up (calibration, quantization, model), warm-up calls
    setup_parts = {name: b - a for (_, a), (name, b) in zip([("", t_start)] + marks, marks)}

    keep = check.Reservoir(cell.check["calls"], seed)
    tr = None
    if trace_on:
        win, tr = trace.traced(lambda: measure(program, inputs,
                                               min(seconds, float(mix["trace_seconds"])),
                                               keep, device))
    else:
        win = measure(program, inputs, seconds, keep, device)
    mem = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del program
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    rows = check.sample_rows(int(mix["batch"]), int(cell.check["rows"]), seed)
    idx = torch.as_tensor(rows, device=device)
    outs = [out[idx] for _, _, out in keep.kept]
    if "reference" in control:  # a lower-precision reference in the program's place
        outs = check.reference_outputs(cfg, mix, inputs, keep.kept, rows,
                                       denoiser=control["reference"])
    refs = check.reference_outputs(cfg, mix, inputs, keep.kept, rows)
    numbers, failed = check.compare(outs, refs, cell.check["limits"])
    reference_s = time.perf_counter() - t_ref

    a = cfg["arch"]
    ctx = dict(window=win, setup_s=setup_s, trace=tr,
               forwards_per_call=plugin("entries", mix["entry"]).forwards(mix),
               layers=counts.layers(a["base_ch"], a["stem_s2d"], a["in_ch"], a["out_ch"],
                                    int(mix["size"]), int(mix["batch"]),
                                    plugin("denoisers", mix["denoiser"]).MODES),
               program_kernels=trace.program_kernels(ROOT) if tr else ())
    metrics = {}
    for m in cell.metrics:
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(mem)}
    out = {"correct": check.passes(numbers) and failed == 0, "attempted": win.calls,
           "failed": failed, "metrics": metrics, "device": dev, "setup_parts": setup_parts,
           "reference_s": reference_s}
    if tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = tr.breakdown()
    out["check"] = numbers
    return out


def report(result: Dict) -> None:
    """The numbers compared, each beside its limit, as the last lines on
    standard error; the result as the last line on standard output."""
    for k, v in result["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = load_cell(args.workload, bool(args.trace)).entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}",
              file=sys.stderr)
        return 3
    if not (ROOT / "s1s2_torch").is_dir():
        print("the program (s1s2_torch) is not beside the benchmark", file=sys.stderr)
        return 4
    torch.set_num_threads(1)
    result = run(args.workload, args.seed, args.seconds, bool(args.trace), t_start)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 5
    report(result)
    return 0
