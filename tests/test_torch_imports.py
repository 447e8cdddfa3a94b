"""The port runs where JAX, flax, msgpack, ml_dtypes and PIL are not
installed (the card's machine has torch, numpy and the CUDA toolkit): it
imports nothing of them, and nothing of the JAX package s1s2. The glyph
atlas's generator (``s1s2_torch/viz/make_glyphs.py``) is the one module
that imports PIL, inside a function, and no module imports it."""

import ast
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "flax", "msgpack", "ml_dtypes", "PIL", "s1s2")
GENERATOR = REPO / "s1s2_torch" / "viz" / "make_glyphs.py"
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


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_blocked_import_in_source(path):
    roots = set(_imported_roots(path))
    allowed = {"PIL"} if path == GENERATOR else set()
    assert not roots & (set(BLOCKED) - allowed), roots & set(BLOCKED)
    assert "s1s2_torch.viz.make_glyphs" not in set(_imported_modules(path)) or path == GENERATOR


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_mesh_or_multi_process_option_is_refused(path):
    """ROADMAP §1 item 7c is ported: no "not ported" message of it is left
    (and since item 7d none at all: test_no_not_ported_message_is_left)."""
    text = path.read_text()
    for phrase in ("item 7c", "7, 7c", "(ROADMAP §1 item 7)", "item 7 (7c)"):
        assert phrase not in text, phrase


NOT_PORTED = re.compile(r"not\s+(yet\s+)?ported|ported\s+yet", re.IGNORECASE)


@pytest.mark.parametrize("path", PORT_FILES + sorted((REPO / "s1s2_torch").rglob("*.sh")),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_not_ported_message_is_left(path):
    """Everything is ported (ROADMAP §1 item 7d was the last item): no
    module, tool or the smoke run still refuses a path as not ported."""
    hits = [ln for ln in path.read_text().splitlines() if NOT_PORTED.search(ln)]
    assert not hits, hits


# the JAX tools that have no file of the same name under s1s2_torch/tools/,
# and the port's file that covers each (ROADMAP §1)
COVERED_ELSEWHERE = {
    "bench_cfg.py": "s1s2_torch/bench.py",  # S1S2_BENCH_CFG=1
    "bench_width_ladder.py": "s1s2_torch/bench.py",  # S1S2_BENCH_WIDTHS=1
    "bench_distill_throughput.py": "s1s2_torch/headline.py",  # run_headline(spec, batch)
    "bench_pallas_conv.py": "s1s2_torch/tools/bench_conv.py",  # and chip_smoke.py 5-5b
    "probe_pallas_int8.py": "s1s2_torch/tools/probe_int8.py",
    "rasterio_shim.py": "tests/test_torch_patchify.py",  # stays in tools/, driven there
}
JAX_TOOLS = sorted(p.name for p in (REPO / "tools").iterdir()
                   if p.suffix in (".py", ".sh") and p.name != "__init__.py")


@pytest.mark.parametrize("name", JAX_TOOLS)
def test_every_jax_tool_has_a_twin(name):
    """Each file of the JAX package's tools/ has a twin of the same name
    under s1s2_torch/tools/, or a port file that covers it."""
    twin = REPO / "s1s2_torch" / "tools" / name
    if name in COVERED_ELSEWHERE:
        assert not twin.exists(), f"{name} has a twin: drop its COVERED_ELSEWHERE entry"
        cover = REPO / COVERED_ELSEWHERE[name]
        assert cover.is_file(), cover
        if name == "rasterio_shim.py":
            assert "rasterio_shim" in cover.read_text()
    else:
        assert twin.is_file(), f"tools/{name} has no twin under s1s2_torch/tools/"


def test_port_has_the_mirrored_layout():
    for sub in ("core", "ops", "models", "sampling", "eval", "data", "train", "cli", "viz",
                "tools", "utils", "parallel"):
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
    # the panels, data and checkpoint slice: both panel modes through the
    # harness, patchify on an .npy scene, convert_ckpt, archive_ckpt, both
    # validate_parity modes, bench_patchify and the distillation demo's strips
    from s1s2_torch.cli import convert_ckpt, patchify, validate_parity
    from s1s2_torch.tools import archive_ckpt, bench_patchify, demo_distill_viz
    with tempfile.TemporaryDirectory() as td, contextlib.redirect_stdout(io.StringIO()):
        make_synthetic_patches(td + "/p", n=3, size=16, seed=0, with_cloud=True)
        panels = {{m: run_mode(EvalConfig(
            patch_dir=td + "/p", out_dir=td + "/" + m, mode=m, base_ch=8, ckpt="@random", T=50,
            t_start=40, ddim_steps=2, batch_size=2, select_top_cloud=2, save_viz_n=1,
            device="cpu"))["panels"] for m in ("night_demo", "cloudy_viz")}}
        rng = np.random.default_rng(0)
        os.makedirs(td + "/raw/s.data")
        for name in ("B2", "B3", "B4", "B8", "Sigma0_HH_db_m", "Sigma0_HV_db_m",
                     "projectedLocalIncidenceAngle_m", "elevation_ref_egm2008",
                     "collocationFlags"):
            np.save(f"{{td}}/raw/s.data/{{name}}.img.npy",
                    rng.uniform(0.1, 0.9, (48, 48)).astype(np.float32))
        patches = patchify.main(["--base-dir", td + "/raw", "--output-dir", td + "/pp",
                                 "--patch-size", "32", "--stride", "16"])["total_patches"]
        pth = "examples/ref_crossval/ref_eps_model.pth"
        converted = convert_ckpt.main(["--pth", pth, "--out", td + "/c.msgpack"])["base_ch"]
        archive_ckpt.main([td + "/c.msgpack", td + "/a.msgpack"])
        archived = str(load_params(td + "/a.msgpack")["inc"]["kernel"].dtype)
        fwd = validate_parity.main(["--pth", pth, "--device", "cpu", "--image_size", "16"])
        with open(td + "/exp.json", "w") as f:
            json.dump({{"ddim_eps": {{"config": {{"t_start": 10, "ddim_steps": 2}}}},
                       "sweep_eps": {{"config": {{"t_start_grid": [10], "ddim_steps_grid": [2]}},
                                     "expect": {{"10,2": 0.1}}}},
                       "true_infer_eps": {{"config": {{"t_start": 19, "ddim_steps": 2,
                                                      "n_seeds": 1}}}}}}, f)
        full = validate_parity.main(["--full", "--patch_dir", td + "/p", "--out_dir", td + "/par",
                                     "--eps_ckpt", pth, "--base_ch", "16", "--T", "20",
                                     "--batch_size", "2", "--expected", td + "/exp.json",
                                     "--device", "cpu"])["tables_ran"]
        windows = bench_patchify.run(288)["windows"]
        os.makedirs(td + "/w")
        os.symlink(td + "/p", td + "/w/patches")
        demo = demo_distill_viz.main([
            "--workdir", td + "/w", "--k", "2", "--out", td + "/demo", "--device", "cpu",
            "--teacher", str(CKPT_DIR / "distill_eps_teacher.bf16.msgpack"),
            "--student", str(CKPT_DIR / "distill_eps_student1.bf16.msgpack")])
        sliced = [panels, patches, converted, archived, fwd["pass"], full, windows,
                  len(demo), sorted(os.listdir(td + "/demo"))]
    loaded = sorted(k for k in sys.modules if k.split(".")[0] in BLOCKED)
    print(json.dumps({{"modules": mods, "shape": list(y.shape),
                      "up_convs": sorted(up.up8), "up_forward": list(y8.shape),
                      "scene_shape": scene_shape, "served": served,
                      "bench_int8_paths": [r["path"] for r in b8["rows"]], "rc_train": rc_train,
                      "rc_distill": rc_distill, "step": [st.step, int(m["skipped"]),
                                                         bool(torch.isfinite(m["loss"]))],
                      "trained": trained, "distilled": distilled, "sliced": sliced,
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
            "s1s2_torch.tools.score_width_holdout", "s1s2_torch.viz._glyphs",
            "s1s2_torch.viz.make_glyphs", "s1s2_torch.models.torch_twin",
            "s1s2_torch.eval.parity", "s1s2_torch.cli.validate_parity",
            "s1s2_torch.cli.convert_ckpt", "s1s2_torch.cli.patchify",
            "s1s2_torch.tools.archive_ckpt", "s1s2_torch.tools.bench_patchify",
            "s1s2_torch.tools.demo_distill_viz", "s1s2_torch.parallel",
            "s1s2_torch.parallel.mesh", "s1s2_torch.parallel.comm",
            "s1s2_torch.tools.roofline", "s1s2_torch.tools.profile_forward",
            "s1s2_torch.tools.bench_width_throughput", "s1s2_torch.tools.bench_variants",
            "s1s2_torch.tools.bench_quality_matched",
            "s1s2_torch.tools.puregen_table"} <= set(out["modules"])
    assert out["up_convs"] == ["up1", "up2", "up3"] and out["up_forward"] == [2, 16, 16, 4]
    assert out["scene_shape"] == [4, 40, 40] and out["served"] == [3, 16, 16, 4]
    assert out["bench_int8_paths"] == ["bf16", "int8", "int8_quant_up"]
    assert out["rc_train"] == 0 and out["rc_distill"] == 0
    assert out["distilled"] == [2, 0, True, True]
    assert out["sliced"] == [{"night_demo": 1, "cloudy_viz": 2}, 4, 16, "torch.bfloat16", True,
                             ["ddim_eps", "sweep_eps", "true_infer_eps"], 4, 2,
                             ["patch00_gt_teacher20_student1.png",
                              "patch01_gt_teacher20_student1.png", "summary.json"]]
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
