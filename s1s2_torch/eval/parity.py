"""Table-level parity driver: rerun the reference's published result tables
and diff.

Port of the JAX package's ``eval/parity.py``. Given the reference checkpoint
families, :func:`run_full_parity` reruns the configuration behind each
committed number through the port's ``eval.harness.run_mode`` and writes a
pass/fail report, ``parity_report.json`` and ``parity_report.txt``, with the
JAX driver's rows and layout:

    python -m s1s2_torch validate_parity --full --patch_dir P --out_dir O \
        --eps_ckpt ddpm_s1_to_s2_v3.pth [--v_ckpt ...] [--rel_tol 0.02]

Expected tables (from the reference's committed result files):
* ddim_eps      — `Evaluation/DDIM_Multi-step/ddim_summary.txt:1-3`
* sweep_eps     — `Evaluation/DDIM_Sweep/ddim_sweep_summary.csv:2-17`
* true_infer_eps— `Evaluation_Updated/Evaluation_Pure_Generation/
                   ddim_true_infer_summary.txt:1-6`

Each expected entry may be overridden or extended by a JSON file
(``--expected``), which also lets the machinery run end to end on a twin
fixture checkpoint and synthetic patches. The nets run in f32 on the CPU and
in bf16 on the card (the conv kernel takes bf16 only).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

# --- the published numbers (BASELINE.md), keyed per table -----------------

REFERENCE_EXPECTED: Dict[str, dict] = {
    "ddim_eps": {
        "mode": "ddim",
        "pred_param": "eps",
        "config": {"t_start": 200, "ddim_steps": 20},
        "expect": {"MAE_mean": 0.038182, "MSE_mean": 0.003365},
        "source": "Evaluation/DDIM_Multi-step/ddim_summary.txt:1-3",
    },
    "sweep_eps": {
        "mode": "ddim_sweep",
        "pred_param": "eps",
        "config": {
            "t_start_grid": (300, 200, 150, 100),
            "ddim_steps_grid": (10, 20, 50, 100),
            "max_files": 80,
        },
        # (t_start, steps) -> MAE_mean, the full 16-cell grid
        "expect": {
            "300,10": 0.046180, "300,20": 0.048593,
            "300,50": 0.050124, "300,100": 0.050718,
            "200,10": 0.042467, "200,20": 0.044196,
            "200,50": 0.045324, "200,100": 0.045781,
            "150,10": 0.040285, "150,20": 0.041663,
            "150,50": 0.042559, "150,100": 0.042932,
            "100,10": 0.037585, "100,20": 0.038539,
            "100,50": 0.039221, "100,100": 0.039470,
        },
        "source": "Evaluation/DDIM_Sweep/ddim_sweep_summary.csv:2-17",
    },
    "true_infer_eps": {
        "mode": "true_infer",
        "pred_param": "eps",
        "config": {"t_start": 999, "ddim_steps": 50, "n_seeds": 4,
                   "max_files": 10},
        "expect": {"MAE_mean": 0.389404, "MSE_mean": 0.237008,
                   "PSNR_mean": 6.255, "SAM_mean": 0.5371,
                   "ERGAS_mean": 250.40},
        "source": ("Evaluation_Updated/Evaluation_Pure_Generation/"
                   "ddim_true_infer_summary.txt:1-6"),
    },
}


@dataclasses.dataclass
class RowResult:
    table: str
    key: str
    expected: float
    actual: Optional[float]
    rel_err: Optional[float]
    ok: bool


def _flatten_actual(table: str, spec: dict, result: dict) -> Dict[str, float]:
    """Normalize a run_mode() return into the expected-key namespace."""
    if spec["mode"] == "ddim_sweep":
        return {f"{t},{s}": v for (t, s), v in result.items()}
    out = {}
    for k, v in result.items():
        if isinstance(v, (int, float)):
            out[k] = float(v)
    return out


def run_full_parity(
    patch_dir: str,
    out_dir: str,
    ckpts: Dict[str, str],
    *,
    expected: Optional[Dict[str, dict]] = None,
    rel_tol: float = 0.02,
    batch_size: int = 8,
    T: int = 1000,
    base_ch: int = 96,
    device: str = "cuda",
    compute_dtype: Optional[str] = None,
) -> dict:
    """Rerun each table whose checkpoint family is provided; diff against
    the published numbers. ``ckpts`` keys: 'eps' / 'v' / 'cfg_v' (paths,
    ``.pth`` or ``.msgpack``). ``compute_dtype`` defaults to f32 on the CPU
    and bf16 on the card."""
    from s1s2_torch.eval.harness import EvalConfig, run_mode
    from s1s2_torch.models.torch_twin import default_dtype

    compute_dtype = compute_dtype or default_dtype(device)
    tables = dict(REFERENCE_EXPECTED)
    if expected:
        for k, v in expected.items():
            tables[k] = {**tables[k], **v} if k in tables else v

    os.makedirs(out_dir, exist_ok=True)
    rows: List[RowResult] = []
    ran, skipped = [], []
    for name, spec in tables.items():
        ckpt = ckpts.get(spec.get("family", spec["pred_param"]))
        if not ckpt:
            skipped.append(name)
            continue
        cfg = EvalConfig(
            patch_dir=patch_dir,
            out_dir=os.path.join(out_dir, name),
            ckpt=ckpt,
            mode=spec["mode"],
            pred_param=spec["pred_param"],
            T=T,
            base_ch=base_ch,
            batch_size=batch_size,
            compute_dtype=compute_dtype,
            device=device,
            **spec.get("config", {}),
        )
        actual = _flatten_actual(name, spec, run_mode(cfg))
        for key, exp in spec["expect"].items():
            act = actual.get(key)
            rel = abs(act - exp) / max(abs(exp), 1e-12) if act is not None else None
            rows.append(RowResult(name, key, exp, act, rel, rel is not None and rel <= rel_tol))
        ran.append(name)

    report = {
        "rel_tol": rel_tol,
        "tables_ran": ran,
        "tables_skipped_no_ckpt": skipped,
        "rows": [dataclasses.asdict(r) for r in rows],
        "n_pass": sum(r.ok for r in rows),
        "n_fail": sum(not r.ok for r in rows),
        "all_pass": bool(rows) and all(r.ok for r in rows),
    }
    with open(os.path.join(out_dir, "parity_report.json"), "w") as f:
        json.dump(report, f, indent=1)
    lines = [f"{'table':16s} {'key':10s} {'expected':>12s} {'actual':>12s} "
             f"{'rel_err':>9s}  ok"]
    for r in rows:
        lines.append(
            f"{r.table:16s} {r.key:10s} {r.expected:12.6f} "
            f"{(r.actual if r.actual is not None else float('nan')):12.6f} "
            f"{(r.rel_err if r.rel_err is not None else float('nan')):9.4f}  "
            f"{'PASS' if r.ok else 'FAIL'}")
    with open(os.path.join(out_dir, "parity_report.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return report
