"""Replay of the reference cross-validation on the port.

    python -m s1s2_torch.tools.ref_crossval --out DIR \\
        [--device cuda|cpu] [--compute_dtype float32|bfloat16] [--families ...]

``examples/ref_crossval`` holds two ``.pth`` checkpoints trained by the
reference's own trainers (base 16, 12 synthetic 32² patches) and the 27
tables the reference's own eval scripts wrote on them. This tool runs the
port's harness (``s1s2_torch.cli.evaluate``) on those checkpoints with each
table's mode and flags, on the same data, with the reference scripts' torch
noise streams replayed through ``--noise_npz``, and diffs every output
against its committed table:

* the data: the 12-file 32² synthetic set (seed 0, ``data/synthetic.py``);
* the noise: the torch global stream seeded ``GLOBAL_SEED`` as each script
  consumes it (``build_*_noise_npz``; the map is in the docstrings);
* the diffs: CSV tables column by column over matching rows, stdout
  metric lines against the harness's summary files, and the saved
  ``*_pred.npy`` arrays element by element, each column within ``TOLS``
  (else ``DEFAULT_TOL``).

Writes ``report.json`` (``{"tables": {name: {"cols": {col: {"max_dev",
"tol", "pass"}}, "pass"}}, "pass", "tables_pass", "tables_total", ...}``)
under ``--out`` and exits 0 when every table passes. Families: ``eps`` (7
tables), ``v`` (2), ``pure`` (4), ``sweep`` (1), ``upd`` (6), ``misc`` (3),
``vmisc`` (4).
"""

from __future__ import annotations

import argparse
import csv
import json
import math
import os
import re
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

REF_DIR = Path(__file__).resolve().parents[2] / "examples" / "ref_crossval"
GLOBAL_SEED = 777
# the committed run's configuration (report.json "config"; the pure family's
# true_infer ran 10 steps and 3 seeds)
N_FILES, SIZE, BASE_CH, CT = 12, 32, 16, 4
N_SEEDS, SEED_BASE, T_START, DDIM_STEPS = 4, 1234, 200, 20
TI_STEPS, TI_SEEDS = 10, 3
T_VALUES = ("5", "20", "80")
SWEEP_GRIDS = ("300,200", "5,10")
LIM_STEPS, LIM_BS, LIM_KS = 10, 2, (5, 50)
FAMILIES = ("eps", "v", "pure", "sweep", "upd", "misc", "vmisc")

# per-column absolute tolerances (f32 on both sides; the reference's and
# the port's sums run in other orders)
TOLS = {"PSNR": 5e-2, "cosine": 5e-4, "eps_MSE": 5e-4, "v_MSE": 5e-4,
        "v_cos": 5e-4, "eps_cos": 5e-4,
        # SAM CSV quantum 1e-4 rad; ERGAS quantum 0.01 at O(100) magnitude
        "SAM_mean": 2e-3, "SAM(rad)": 2e-3, "ERGAS_mean": 0.05, "ERGAS": 0.05}
DEFAULT_TOL = 5e-4
NPY_TOL = 5e-3
# bf16: the tables keep the f32 tolerances; a limitation prediction array is
# held by its mean |Δ|, since a bf16 rounding can move a pixel of a
# pure-noise generation across the [0, 1] clamp (|Δ| up to 1 on a few pixels)
BF16_NPY_MEAN_TOL = 1e-2


# ---------------------------------------------------------------------------
# the reference scripts' torch noise streams
# ---------------------------------------------------------------------------


def _hwc(z: torch.Tensor) -> np.ndarray:
    """(C, H, W) → (H, W, C) numpy."""
    return z.permute(1, 2, 0).numpy()


def build_noise_npz(path, n_files, H, W, Ct, n_seeds, seed_base):
    """ddim / eps / vdiag: one randn(1,Ct,H,W) per file in sorted order from
    the stream seeded GLOBAL_SEED (salt 0; per_band's fresh process consumes
    it the same way, salt 7); seed_stats: manual_seed(seed_base+s) before
    each draw, the same noise for every file at seed s (salt 1000+s), and
    true_infer the same (salt 5000+s); ablate and tsweep: manual_seed
    (seed_base), one shared draw (salt 99, index 0)."""
    out = {}
    torch.manual_seed(GLOBAL_SEED)
    for i in range(n_files):
        z = _hwc(torch.randn(1, Ct, H, W)[0])
        out[f"s0_i{i}"] = z
        out[f"s7_i{i}"] = z
    for s in range(n_seeds):
        torch.manual_seed(seed_base + s)
        z = _hwc(torch.randn(1, Ct, H, W)[0])
        for i in range(n_files):
            out[f"s{1000 + s}_i{i}"] = z
            out[f"s{5000 + s}_i{i}"] = z
    torch.manual_seed(seed_base)
    out["s99_i0"] = _hwc(torch.randn(1, Ct, H, W)[0])
    np.savez(path, **out)
    return path


def build_sweep_noise_npz(path, n_files, H, W, Ct, seed_base):
    """DDIM_Sweep: manual_seed(seed_base+i) before file i's anchored init
    draw (salt 0)."""
    out = {}
    for i in range(n_files):
        torch.manual_seed(seed_base + i)
        out[f"s0_i{i}"] = _hwc(torch.randn(1, Ct, H, W)[0])
    np.savez(path, **out)
    return path


def _dataloader_base_seed():
    """The DataLoader's one int64 ``_base_seed`` draw from the default
    generator at iterator creation, before any batch's draw."""
    torch.empty((), dtype=torch.int64).random_()


def build_limitation_noise_npz(path, n_files, H, W, Ct, batch_size, ks):
    """Limitation_Test (ddim): after the DataLoader's seed draw, batch 0's
    init draw (salt 300), then one partial-reverse draw per k (salt 310+k;
    the diagnostic runs inside the loop at batch 0), then the other batches'
    init draws."""
    out = {}
    torch.manual_seed(GLOBAL_SEED)
    _dataloader_base_seed()

    def draw(bs):
        return torch.randn(bs, Ct, H, W).permute(0, 2, 3, 1).numpy()

    b0 = min(batch_size, n_files)
    z = draw(b0)
    for j in range(b0):
        out[f"s300_i{j}"] = z[j]
    for k in ks:
        zk = draw(b0)
        for j in range(b0):
            out[f"s{310 + int(k)}_i{j}"] = zk[j]
    i = b0
    while i < n_files:
        bs = min(batch_size, n_files - i)
        z = draw(bs)
        for j in range(bs):
            out[f"s300_i{i + j}"] = z[j]
        i += bs
    np.savez(path, **out)
    return path


def build_limitation_v_noise_npz(path, n_files, H, W, Ct, batch_size, steps, T):
    """Limitation_Test_v: per batch one scaled-init draw (salt 300), then one
    randn_like per non-final grid step, drawn even at η=0 (consumed here to
    keep the stream aligned, not stored)."""
    idxs = torch.unique(torch.round(torch.linspace(0, T - 1, steps)).to(torch.long),
                        sorted=True)
    out = {}
    torch.manual_seed(GLOBAL_SEED)
    _dataloader_base_seed()
    i = 0
    while i < n_files:
        bs = min(batch_size, n_files - i)
        z = torch.randn(bs, Ct, H, W).permute(0, 2, 3, 1).numpy()
        for j in range(bs):
            out[f"s300_i{i + j}"] = z[j]
        for _ in range(len(idxs) - 1):
            torch.randn(bs, Ct, H, W)
        i += bs
    np.savez(path, **out)
    return path


def build_onestep_noise_npz(path, H, W, Ct):
    """Onestep (and its v twin): one randn_like(x_gt) for the first file
    (salt 0, index 0, at batch size 1)."""
    torch.manual_seed(GLOBAL_SEED)
    np.savez(path, s0_i0=_hwc(torch.randn(1, Ct, H, W)[0]))
    return path


# ---------------------------------------------------------------------------
# diffs
# ---------------------------------------------------------------------------

# "[partial-reverse k=5] MAE=0.1  MSE=0.2  PSNR=3.4 dB" / " B2:  MAE=…" /
# "MAE:  0.123456" — uppercase names only
_METRIC_PAIR = re.compile(r"(MAE_w|MSE_w|PSNR_w|MAE|MSE|PSNR)[=:]\s*(-?\d+(?:\.\d+)?)")


def parse_metric_lines(path) -> Dict[str, float]:
    """{line prefix + metric name: value} of a reference stdout log or a
    harness summary file."""
    vals = {}
    for ln in open(path, errors="replace"):
        ln = ln.rstrip("\n")
        # progress-bar redraws share a line with real prints in the logs
        if "[partial-reverse" in ln:
            ln = ln[ln.rindex("[partial-reverse"):]
        # Comparison_v prints "[t=0] MAE~0 | [one-step@t=20] MAE=… MSE=…"
        if " | " in ln and "[one-step@" in ln:
            ln = ln[ln.rindex(" | ") + 3:]
        pairs = list(_METRIC_PAIR.finditer(ln))
        if not pairs:
            continue
        prefix = ln[:pairs[0].start()].strip().rstrip(":").strip()
        for m in pairs:
            vals[f"{prefix}{'/' if prefix else ''}{m.group(1)}"] = float(m.group(2))
    return vals


def _tol(col: str) -> float:
    """A CSV column's tolerance: its own, its last ``_`` part's, or the
    default; every PSNR column ``TOLS["PSNR"]``."""
    if "PSNR" in col:
        return TOLS["PSNR"]
    return TOLS.get(col, TOLS.get(col.split("_")[-1], DEFAULT_TOL))


def diff_text_metrics(ref_log, got_txt, report, table_name):
    """Every printed metric line of ``ref_log`` against ``got_txt``."""
    ref_v, got_v = parse_metric_lines(ref_log), parse_metric_lines(got_txt)
    entry = {"ref": str(ref_log), "got": str(got_txt), "cols": {}, "pass": True}
    missing = sorted(set(ref_v) - set(got_v))
    if missing:
        entry["pass"] = False
        entry["error"] = f"missing metric lines: {missing[:4]}"
    for key, rv in ref_v.items():
        if key in got_v:
            dev = abs(rv - got_v[key])
            tol = TOLS["PSNR"] if "PSNR" in key else DEFAULT_TOL
            entry["cols"][key] = {"max_dev": dev, "tol": tol, "pass": dev <= tol}
            entry["pass"] = entry["pass"] and dev <= tol
    report[table_name] = entry
    return entry


def diff_npy_preds(ref_dir, got_dir, report, table_name, atol=NPY_TOL, stat="max"):
    """Element-wise diff of the ``*_pred.npy`` arrays (same stems both
    sides): the largest |Δ| (``stat="max"``) or the largest mean |Δ| of an
    array (``"mean"``) within ``atol``."""
    ref_files = sorted(f for f in os.listdir(ref_dir) if f.endswith("_pred.npy"))
    entry = {"ref": str(ref_dir), "got": str(got_dir), "cols": {}, "pass": bool(ref_files),
             "rows": len(ref_files)}
    if not ref_files:
        entry["error"] = "no *_pred.npy in the reference output"
    reduce = np.max if stat == "max" else np.mean
    worst = 0.0
    for f in ref_files:
        gp = os.path.join(got_dir, f)
        if not os.path.exists(gp):
            entry["pass"] = False
            entry["error"] = f"missing {f}"
            break
        worst = max(worst, float(reduce(np.abs(np.load(os.path.join(ref_dir, f))
                                               - np.load(gp)))))
    entry["cols"][f"pred_abs_{stat}"] = {"max_dev": worst, "tol": atol, "pass": worst <= atol}
    entry["pass"] = entry["pass"] and worst <= atol
    report[table_name] = entry
    return entry


def diff_csv(ref_csv, got_csv, report, table_name):
    """Column-wise max |Δ| over rows matched by the first column."""

    def read(p):
        with open(p) as f:
            return list(csv.DictReader(f))

    ref_rows, got_rows = read(ref_csv), read(got_csv)
    entry = {"ref": str(ref_csv), "got": str(got_csv), "rows": len(ref_rows), "cols": {},
             "pass": True}
    report[table_name] = entry
    if len(ref_rows) != len(got_rows):
        entry["pass"] = False
        entry["error"] = f"row count {len(ref_rows)} vs {len(got_rows)}"
        return entry
    keycol = list(ref_rows[0].keys())[0]
    got_by_key = {}
    for r in got_rows:
        got_by_key.setdefault(r[keycol], []).append(r)
    for r in ref_rows:
        if not got_by_key.get(r[keycol]):
            entry["pass"] = False
            entry["error"] = f"missing row key {r[keycol]!r}"
            return entry
        g = got_by_key[r[keycol]].pop(0)
        for col, val in r.items():
            try:
                rv = float(val)
            except (TypeError, ValueError):
                continue  # a non-numeric column (file names)
            gv = float(g[col])
            if math.isnan(rv) and math.isnan(gv):
                continue
            c = entry["cols"].setdefault(col, {"max_dev": 0.0})
            c["max_dev"] = max(c["max_dev"], abs(rv - gv))
    for col, c in entry["cols"].items():
        c["tol"] = _tol(col)
        c["pass"] = c["max_dev"] <= c["tol"]
        entry["pass"] = entry["pass"] and c["pass"]
    return entry


# ---------------------------------------------------------------------------
# the runs and their tables
# ---------------------------------------------------------------------------

# (family, run name, checkpoint, pred_param, noise file, n_seeds, extra
# flags, [(table, committed output relative to REF_DIR, port output file,
# kind)]): each run's flags as the committed run passed them
_EPS_EXTRA = ("--t_start", str(T_START), "--ddim_steps", str(DDIM_STEPS),
              "--seed_base", str(SEED_BASE))
_EPS_TABLES = {"ddim": ("ddim_metrics.csv",), "eps": ("eps_diag.csv",),
               "seed_stats": ("seed_stats.csv",),
               "per_band": ("per_band_all.csv", "per_band_summary.csv"),
               "ablate": ("ablate_all.csv", "ablate_summary.csv")}
_UPD_TABLES = {"ddim": "ddim_metrics.csv", "eps": "eps_diag.csv",
               "seed_stats": "seed_stats.csv", "per_band": "per_band_all.csv",
               "ablate": "ablate_all.csv", "tsweep": "tsweep.csv"}


def runs() -> List[Tuple]:
    out = []
    for mode, tables in _EPS_TABLES.items():
        out.append(("eps", mode, "eps", "eps", "ref_noise", N_SEEDS, _EPS_EXTRA,
                    [(f"eps/{mode}/{t}", f"ref_eval_eps/{mode}/{t}", t, "csv") for t in tables]))
    for mode, table in (("ddim", "ddim_metrics.csv"), ("vdiag", "vdiag.csv")):
        out.append(("v", mode, "v", "v", "ref_noise", N_SEEDS, _EPS_EXTRA + ("--eta", "0"),
                    [(f"v/{mode}/{table}", f"ref_eval_v/{mode}/{table}", table, "csv")]))
    out.append(("pure", "true_infer", "eps", "eps", "ref_noise", TI_SEEDS,
                ("--t_start", str(T_START), "--ddim_steps", str(TI_STEPS),
                 "--seed_base", str(SEED_BASE)),
                [("pure/true_infer/ddim_true_infer_metrics.csv",
                  "ref_eval_pure/true_infer/ddim_true_infer_metrics.csv",
                  "ddim_true_infer_metrics.csv", "csv")]))
    for kind in ("bicubic", "linear"):
        out.append(("pure", f"baseline_{kind}", "eps", "eps", "ref_noise", N_SEEDS, (),
                    [(f"pure/baseline_{kind}/baseline_{kind}.csv",
                      f"ref_eval_pure/baseline_{kind}/baseline_{kind}.csv",
                      f"baseline_{kind}_metrics.csv", "csv")]))
    out.append(("pure", "tsweep", "eps", "eps", "ref_noise", N_SEEDS,
                ("--t_values", *T_VALUES, "--seed_base", str(SEED_BASE)),
                [("pure/tsweep/tsweep.csv", "ref_eval_pure/tsweep/tsweep.csv", "tsweep.csv",
                  "csv")]))
    out.append(("sweep", "ddim_sweep", "eps", "eps", "sweep_noise", N_SEEDS,
                ("--t_start_grid", SWEEP_GRIDS[0], "--ddim_steps_grid", SWEEP_GRIDS[1],
                 "--seed_base", str(SEED_BASE)),
                [("sweep/ddim_sweep/ddim_sweep_summary.csv",
                  "ref_eval_sweep/ddim_sweep/ddim_sweep_summary.csv",
                  "ddim_sweep_summary.csv", "csv")]))
    for mode, table in _UPD_TABLES.items():
        out.append(("upd", mode, "eps", "eps", "ref_noise", N_SEEDS,
                    _EPS_EXTRA + ("--t_values", *T_VALUES, "--full_metrics"),
                    [(f"upd/{mode}/{table}", f"ref_eval_upd/{mode}/{table}", table, "csv")]))
    lim = ("--limitation_sampler", "ddim", "--ddim_steps", str(LIM_STEPS),
           "--batch_size", str(LIM_BS), "--save_n", "4")
    out.append(("misc", "limitation", "eps", "eps", "limitation_noise", N_SEEDS,
                lim + ("--partial_reverse_k", *[str(k) for k in LIM_KS]),
                [("misc/limitation/stdout_metrics", "ref_eval_misc/limitation/run.log",
                  "limitation_summary.txt", "text"),
                 ("misc/limitation/pred_npy", "ref_eval_misc/limitation", "", "npy")]))
    one = ("--batch_size", "1", "--t_small", "20")
    out.append(("misc", "onestep", "eps", "eps", "onestep_noise", N_SEEDS, one,
                [("misc/onestep/stdout_metrics", "ref_eval_misc/onestep/run.log",
                  "onestep_summary.txt", "text")]))
    out.append(("vmisc", "limitation", "v", "v", "limitation_v_noise", N_SEEDS,
                lim[:4] + ("--eta", "0") + lim[4:],
                [("vmisc/limitation/stdout_metrics", "ref_eval_vmisc/limitation/run.log",
                  "limitation_summary.txt", "text"),
                 ("vmisc/limitation/pred_npy", "ref_eval_vmisc/limitation", "", "npy")]))
    # Comparison_v's first file is the onestep stream: one run, two tables
    out.append(("vmisc", "onestep", "v", "v", "onestep_noise", N_SEEDS, one,
                [("vmisc/onestep/stdout_metrics", "ref_eval_vmisc/onestep/run.log",
                  "onestep_summary.txt", "text"),
                 ("vmisc/compare/stdout_metrics", "ref_eval_vmisc/compare/run.log",
                  "onestep_summary.txt", "text")]))
    return out


def build_inputs(out: Path) -> Dict[str, str]:
    """The synthetic patches and every noise file, under ``out``."""
    from s1s2_torch.data.synthetic import make_synthetic_patches

    patches = out / "patches"
    if patches.is_dir():
        for f in patches.iterdir():
            f.unlink()
    make_synthetic_patches(str(patches), n=N_FILES, size=SIZE, seed=0)
    H = W = SIZE
    return {
        "patches": str(patches),
        "ref_noise": build_noise_npz(str(out / "ref_noise.npz"), N_FILES, H, W, CT, N_SEEDS,
                                     SEED_BASE),
        "sweep_noise": build_sweep_noise_npz(str(out / "sweep_noise.npz"), N_FILES, H, W, CT,
                                             SEED_BASE),
        "limitation_noise": build_limitation_noise_npz(
            str(out / "limitation_noise.npz"), N_FILES, H, W, CT, LIM_BS, LIM_KS),
        "limitation_v_noise": build_limitation_v_noise_npz(
            str(out / "limitation_v_noise.npz"), N_FILES, H, W, CT, LIM_BS, LIM_STEPS, 1000),
        "onestep_noise": build_onestep_noise_npz(str(out / "onestep_noise.npz"), H, W, CT),
    }


def run_dir(out: Path, family: str, name: str) -> Path:
    return out / f"eval_{family}" / name


def run_replay(out, device: str = "cuda", compute_dtype: str = "float32",
               families=FAMILIES) -> Dict[str, float]:
    """Run the harness for every run of ``families`` into ``out``; →
    seconds per run."""
    from s1s2_torch.cli.evaluate import main as eval_main

    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    inputs = build_inputs(out)
    seconds = {}
    for family, name, ckpt, param, noise, n_seeds, extra, _ in runs():
        if family not in families:
            continue
        t0 = time.perf_counter()
        eval_main([
            "--mode", name, "--patch_dir", inputs["patches"],
            "--ckpt", str(REF_DIR / f"ref_{ckpt}_model.pth"),
            "--out_dir", str(run_dir(out, family, name)), "--base_ch", str(BASE_CH),
            "--compute_dtype", compute_dtype, "--pred_param", param,
            "--noise_npz", inputs[noise], "--n_seeds", str(n_seeds),
            "--save_viz_n", "0", "--batch_size", "4", *extra, "--device", device])
        seconds[f"{family}/{name}"] = time.perf_counter() - t0
    return seconds


def diff_tables(out, families=FAMILIES, against: Optional[Path] = None,
                npy_tol=NPY_TOL, npy_stat="max") -> Dict:
    """Diff the replay under ``out`` against the committed reference tables,
    or, with ``against``, against another replay's outputs. → report."""
    out = Path(out)
    tables = {}
    for family, name, _, _, _, _, _, specs in runs():
        if family not in families:
            continue
        got_dir = run_dir(out, family, name)
        for table, ref_rel, got_file, kind in specs:
            if against is None:
                ref = REF_DIR / ref_rel
            else:
                ref = run_dir(Path(against), family, name) / got_file
            got = got_dir / got_file
            if kind == "csv":
                diff_csv(ref, got, tables, table)
            elif kind == "text":
                diff_text_metrics(ref, got, tables, table)
            else:
                diff_npy_preds(ref, got_dir, tables, table, npy_tol, npy_stat)
    return {"tables": tables, "pass": all(t["pass"] for t in tables.values()),
            "tables_pass": sum(t["pass"] for t in tables.values()),
            "tables_total": len(tables)}


def check(out, compute_dtype: str, families=FAMILIES, against: Optional[Path] = None) -> Dict:
    """``diff_tables`` with the tolerances of ``compute_dtype``."""
    if compute_dtype == "bfloat16":
        return diff_tables(out, families, against, npy_tol=BF16_NPY_MEAN_TOL, npy_stat="mean")
    return diff_tables(out, families, against)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("s1s2_torch ref_crossval")
    ap.add_argument("--out", required=True, help="work directory (patches, noise, outputs)")
    ap.add_argument("--device", default="cuda", help="where the model runs: cuda or cpu")
    ap.add_argument("--compute_dtype", choices=["float32", "bfloat16"], default="float32")
    ap.add_argument("--families", nargs="*", default=list(FAMILIES), choices=FAMILIES)
    args = ap.parse_args(argv)
    seconds = run_replay(args.out, args.device, args.compute_dtype, args.families)
    report = check(args.out, args.compute_dtype, args.families)
    report.update({"config": {"n": N_FILES, "size": SIZE, "base_ch": BASE_CH,
                              "n_seeds": N_SEEDS, "t_start": T_START,
                              "ddim_steps": DDIM_STEPS},
                   "global_seed": GLOBAL_SEED, "device": args.device,
                   "compute_dtype": args.compute_dtype, "seconds": seconds})
    with open(os.path.join(args.out, "report.json"), "w") as f:
        json.dump(report, f, indent=1)
    for name, t in report["tables"].items():
        devs = {c: v["max_dev"] for c, v in t["cols"].items()}
        print(f"[crossval] {name}: {'PASS' if t['pass'] else 'FAIL'} "
              f"{t.get('error', '')} {json.dumps(devs)}", flush=True)
    print(f"[crossval] {report['tables_pass']}/{report['tables_total']} tables pass "
          f"({args.device}, {args.compute_dtype})", flush=True)
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
