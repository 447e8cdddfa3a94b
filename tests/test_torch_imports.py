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
                "tools", "utils"):
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
    # the serving surface: an int8 artifact with int8 up-convs through the
    # port's writer and reader, a scene through the infer_scene CLI, one
    # request to the server, bench_int8 with quant_up, and the dispatcher
    import contextlib, io, os, threading, urllib.request
    from s1s2_torch.__main__ import main as dispatch
    from s1s2_torch.cli import infer_scene, serve
    from s1s2_torch.models.quant import make_sampler_calib, quant_apply, quantize_unet
    from s1s2_torch.models.quant import _nest
    from s1s2_torch.core.schedule import Schedule
    from s1s2_torch.tools import bench_int8
    from s1s2_torch.train.checkpoint import msgpack_serialize
    st8 = init_params(4, 8, 1, seed=0)
    gt8 = torch.rand((2, 16, 16, 4))
    qp8 = quantize_unet(st8, make_sampler_calib(gt8, gt8, Schedule.cosine(1000).alpha_bar_np(),
                                                (200, 20)), base_ch=8, quant_up=True)
    with tempfile.TemporaryDirectory() as td:
        save_quant(qp8, td + "/up.msgpack")
        up = load_quant(td + "/up.msgpack")
        y8 = quant_apply(up, torch.cat([gt8, gt8], -1), torch.tensor([200, 20]))
        with open(td + "/m.msgpack", "wb") as f:
            f.write(msgpack_serialize(_nest(st8)))
        np.save(td + "/scene.npy", np.random.default_rng(0).standard_normal((40, 40, 4)))
        with contextlib.redirect_stdout(io.StringIO()):
            infer_scene.main(["--scene", td + "/scene.npy", "--ckpt", td + "/m.msgpack",
                              "--out_dir", td + "/o", "--base_ch", "8", "--patch_size", "32",
                              "--stride", "24", "--ddim_steps", "2", "--device", "cpu"])
        scene_shape = list(np.load(td + "/o/scene_pred.npy").shape)
        httpd = serve.build_server(serve.build_parser().parse_args(
            ["--int8_ckpt", td + "/up.msgpack", "--port", "0", "--patch_size", "16",
             "--batch_size", "2", "--device", "cpu"]))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        buf = io.BytesIO()
        np.savez(buf, cond=np.zeros((3, 16, 16, 4), np.float32))
        host, port = httpd.server_address[:2]
        with urllib.request.urlopen(urllib.request.Request(
                f"http://{{host}}:{{port}}/infer", data=buf.getvalue(), method="POST")) as resp:
            served = list(np.load(io.BytesIO(resp.read())).shape)
        httpd.shutdown()
        httpd.server_close()
        b8 = bench_int8.run(batch=2, steps=1, iters=1, quant_up=True, size=16, base_ch=8,
                            device="cpu", emit=lambda _: None)
    # the training slice: one train step, a train_loop with its state file
    # and metrics, and the dispatcher (train and distill are ported)
    from s1s2_torch.train.loop import TrainConfig, create_train_state, make_train_step
    from s1s2_torch.train.trainer import RunConfig, train_loop
    from s1s2_torch.models.unet import UNetSmall
    from s1s2_torch.core import random
    step = make_train_step(UNetSmall(4, 8, autograd=True, remat=True), Schedule.cosine(1000),
                           TrainConfig())
    st, m = step(create_train_state(st8, TrainConfig()), (gt8, gt8, None), random.PRNGKey(0))
    with tempfile.TemporaryDirectory() as td:
        make_synthetic_patches(td + "/p", n=4, size=16, seed=0)
        hist = train_loop(RunConfig(patch_dir=td + "/p", model_path=td + "/m.msgpack",
                                    epochs=2, batch_size=2, base_ch=8, save_state_dir=td + "/st",
                                    metrics_jsonl=td + "/m.jsonl", device="cpu"), TrainConfig())
        trained = [hist["final_state"].step, hist["skipped"],
                   sorted(os.listdir(td)), sorted(os.listdir(td + "/st"))]
    with contextlib.redirect_stdout(io.StringIO()):
        try:
            dispatch(["train", "--help"])
        except SystemExit as e:
            rc_train = e.code
    with contextlib.redirect_stdout(io.StringIO()):
        try:
            dispatch(["distill", "--help"])
        except SystemExit as e:
            rc_distill = e.code
    # the distillation slice: a progressive step and an endpoint step
    from s1s2_torch.train import distill
    dcfg = distill.DistillConfig(teacher_steps=2)
    dmodel = UNetSmall(4, 8, autograd=True)
    dstate, dm = distill.make_distill_step(dmodel, Schedule.cosine(1000), dcfg, 1)(
        distill.create_distill_state(st8, dcfg), distill.inference_net(dmodel, st8, "cpu"),
        (gt8, gt8, torch.ones(gt8.shape[:3])), random.PRNGKey(0))
    estate, em = distill.make_endpoint_distill_step(dmodel, Schedule.cosine(1000), dcfg)(
        dstate, (gt8, gt8, torch.ones(gt8.shape[:3]), gt8, gt8))
    distilled = [estate.step, int(em["skipped"]), bool(torch.isfinite(dm["loss"])),
                 bool(torch.isfinite(em["loss"]))]
    loaded = sorted(k for k in sys.modules if k.split(".")[0] in BLOCKED)
    print(json.dumps({{"modules": mods, "shape": list(y.shape),
                      "up_convs": sorted(up.up8), "up_forward": list(y8.shape),
                      "scene_shape": scene_shape, "served": served,
                      "bench_int8_paths": [r["path"] for r in b8["rows"]], "rc_train": rc_train,
                      "rc_distill": rc_distill, "step": [st.step, int(m["skipped"]),
                                                         bool(torch.isfinite(m["loss"]))],
                      "trained": trained, "distilled": distilled,
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
            "s1s2_torch.tools.ref_crossval", "s1s2_torch.eval.scene",
            "s1s2_torch.data.patchify", "s1s2_torch.cli.infer_scene", "s1s2_torch.cli.serve",
            "s1s2_torch.__main__", "s1s2_torch.tools.bench_int8",
            "s1s2_torch.tools.bench_scene", "s1s2_torch.tools.bench_serve",
            "s1s2_torch.ops.pixel_shuffle", "s1s2_torch.train.loss", "s1s2_torch.train.loop",
            "s1s2_torch.train.trainer", "s1s2_torch.cli.train", "s1s2_torch.tools.bench_train",
            "s1s2_torch.utils.profiling", "s1s2_torch.train.distill", "s1s2_torch.cli.distill",
            "s1s2_torch.cli.make_synthetic", "s1s2_torch.tools.bench_distill",
            "s1s2_torch.tools.score_distill_full",
            "s1s2_torch.tools.score_width_holdout"} <= set(out["modules"])
    assert out["up_convs"] == ["up1", "up2", "up3"] and out["up_forward"] == [2, 16, 16, 4]
    assert out["scene_shape"] == [4, 40, 40] and out["served"] == [3, 16, 16, 4]
    assert out["bench_int8_paths"] == ["bf16", "int8", "int8_quant_up"]
    assert out["rc_train"] == 0 and out["rc_distill"] == 0
    assert out["distilled"] == [2, 0, True, True]
    assert out["step"] == [1, 0, True]
    assert out["trained"] == [4, 0, ["m.jsonl", "m.msgpack", "m_best.msgpack",
                                     "m_best.msgpack.loss.json", "m_last.msgpack", "p", "st"],
                              ["train_state.msgpack"]]
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
