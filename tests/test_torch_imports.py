"""The port runs where JAX, flax, msgpack and ml_dtypes are not installed
(the card's machine has torch, numpy and the CUDA toolkit): it imports
nothing of them, and nothing of the JAX package s1s2."""

import ast
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "flax", "msgpack", "ml_dtypes", "s1s2")
PORT_FILES = sorted(p for p in (REPO / "s1s2_torch").rglob("*.py")
                    if "_build" not in p.relative_to(REPO).parts) + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_blocked_import_in_source(path):
    roots = set(_imported_roots(path))
    assert not roots & set(BLOCKED), roots & set(BLOCKED)


def test_port_has_the_mirrored_layout():
    for sub in ("core", "ops", "models", "sampling", "eval", "data", "train", "cli", "viz",
                "tools"):
        assert (REPO / "s1s2_torch" / sub / "__init__.py").is_file(), sub


SCRIPT = textwrap.dedent("""
    import importlib, json, pkgutil, sys
    BLOCKED = {blocked!r}

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked: {{name}}")
            return None

    sys.meta_path.insert(0, Block())
    for name in BLOCKED:
        sys.modules.pop(name, None)
    import numpy as np
    import torch
    import s1s2_torch
    mods = [m.name for m in pkgutil.walk_packages(s1s2_torch.__path__, "s1s2_torch.")]
    for m in mods:
        importlib.import_module(m)
    import chip_smoke
    from s1s2_torch.headline import CKPT_DIR
    from s1s2_torch.models.unet import load_unet
    from s1s2_torch.models.weights import params_from_numpy
    from s1s2_torch.train.checkpoint import load_params
    state = params_from_numpy(load_params(str(CKPT_DIR / "distill_eps_student24x4.bf16.msgpack")))
    model = load_unet(state, 4, 24, 4, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).random((2, 32, 32, 8), dtype=np.float32))
    y = model(x, torch.tensor([200, 20], dtype=torch.int32))
    # the base-96 path: a fresh init, the int8 DPM sampler and the probe ops
    from s1s2_torch.bench import bench_int8_dpm
    from s1s2_torch.models.unet import init_params
    from s1s2_torch.ops.halo import halo_rows_x2
    from s1s2_torch.ops.matmul import matmul
    r = bench_int8_dpm(init_params(4, 8, 1, seed=0), batch=1, warmup=0, iters=1, size=16,
                       base_ch=8, device="cpu")
    halo_rows_x2(torch.zeros((5, 2, 4)), 2)
    matmul(torch.zeros((128, 64), dtype=torch.int8), torch.zeros((64, 128), dtype=torch.int8),
           torch.int32)
    # the CFG line through the evaluate CLI and the harness, and the int8
    # artifact through the port's own msgpack writer and reader
    import tempfile
    from s1s2_torch.bench import bench_cfg, make_cfg_samplers, cfg_state
    from s1s2_torch.models.quant import load_quant, save_quant
    cfg = bench_cfg(ckpt="@random", batch=1, iters=1, size=16, base_ch=8, cfg_set=(3, 1, 3),
                    device="cpu")
    qp = make_cfg_samplers(cfg_state("@random", 8), batch=1, size=16, base_ch=8,
                           device="cpu")["qp"]
    with tempfile.TemporaryDirectory() as td:
        save_quant(qp, td + "/q.msgpack")
        back = load_quant(td + "/q.msgpack")
    # a reference .pth through the port's reader into table modes that write
    # previews (the port's PNG encoder) and read the mmap cache, and the
    # crossval replay's inputs (torch's own noise streams)
    import glob
    from pathlib import Path
    from s1s2_torch.data.synthetic import make_synthetic_patches
    from s1s2_torch.eval.harness import EvalConfig, run_mode
    from s1s2_torch.tools import ref_crossval
    with tempfile.TemporaryDirectory() as td:
        make_synthetic_patches(td + "/p", n=2, size=32, seed=0)
        table_modes = {{}}
        for mode in ("ddim", "baseline_bicubic", "baseline_linear", "limitation"):
            table_modes[mode] = run_mode(EvalConfig(
                patch_dir=td + "/p", out_dir=td + "/" + mode, mode=mode, base_ch=16,
                ckpt="examples/ref_crossval/ref_eps_model.pth", ddim_steps=2, batch_size=2,
                save_viz_n=1, save_n=1, t_start=-1 if mode == "limitation" else 200,
                cache_dir=td + "/cache", device="cpu"))
        pngs = len(glob.glob(td + "/*/*.png") + glob.glob(td + "/*/previews/*.png"))
        noise = sorted(ref_crossval.build_inputs(Path(td) / "cv"))
    loaded = sorted(k for k in sys.modules if k.split(".")[0] in BLOCKED)
    print(json.dumps({{"modules": mods, "shape": list(y.shape),
                      "finite": bool(torch.isfinite(y).all()), "loaded": loaded,
                      "dpm_shape": r["shape"], "dpm_finite": r["finite"],
                      "cfg_checked": cfg["quality_checked"] in (True, False),
                      "cfg_shape": cfg["shape"], "int8_convs": len(back.w8),
                      "table_modes": sorted(table_modes), "pngs": pngs, "noise": noise}}))
""")


def test_port_runs_with_jax_flax_msgpack_ml_dtypes_and_s1s2_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", SCRIPT.format(blocked=BLOCKED)],
                          cwd=str(REPO), env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["shape"] == [2, 32, 32, 4] and out["finite"]
    assert out["loaded"] == []
    assert {"s1s2_torch.headline", "s1s2_torch.ops.conv3x3", "s1s2_torch.models.quant",
            "s1s2_torch.train.checkpoint", "s1s2_torch.sampling.samplers",
            "s1s2_torch.sampling.dpm_solver", "s1s2_torch.ops.matmul", "s1s2_torch.ops.halo",
            "s1s2_torch.bench", "s1s2_torch.tools.probe_int8", "s1s2_torch.eval.harness",
            "s1s2_torch.data.loader", "s1s2_torch.cli.evaluate",
            "s1s2_torch.cli.quantize", "s1s2_torch.models.convert",
            "s1s2_torch.eval.baselines", "s1s2_torch.viz.render",
            "s1s2_torch.tools.ref_crossval"} <= set(out["modules"])
    assert out["dpm_shape"] == [1, 16, 16, 4] and out["dpm_finite"]
    assert out["cfg_checked"] and out["cfg_shape"] == [1, 16, 16, 4] and out["int8_convs"] == 10
    assert out["table_modes"] == ["baseline_bicubic", "baseline_linear", "ddim", "limitation"]
    # ddim's first file (2 previews), limitation's six-file set
    assert out["pngs"] == 8
    assert out["noise"] == ["limitation_noise", "limitation_v_noise", "onestep_noise", "patches",
                            "ref_noise", "sweep_noise"]


def test_blocker_really_blocks():
    """The same blocker makes an import of the JAX package fail."""
    code = SCRIPT.format(blocked=BLOCKED).split("import numpy as np")[0] + "import s1s2\n"
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=dict(os.environ, PYTHONPATH=str(REPO)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "blocked: s1s2" in proc.stderr
