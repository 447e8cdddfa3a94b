"""s1s2_torch's eval harness against the JAX harness, mode by mode, in bf16:
every CSV and summary file the JAX harness writes, cell by cell, on the
same patches with the same per-file noise, on a base-8 net (``"@random"``,
flax's init from ``PRNGKey(0)``) at 32². Five files in batches of two, so
the last batch is padded. Also: both ``--rng_by`` keyings, the int8 mode,
``--cache_dir``, ``--noise_npz`` and the evaluate CLI with its defaults.
``test_torch_modes_f32.py`` holds the f32 run, the arrays and the PNGs.

Tolerances. f32: one unit of the cell's last printed digit (the two
packages sum in other orders, and a value may round to either side). bf16:
that, or 1e-4 where it is larger (PSNR 100× it, in dB) — nets that round
bf16 at other places differ in the 5th decimal of a file's MAE (as the
CFG sweep's test in ``test_torch_harness.py``); int8 10× that, since one
bf16 ulp can move an activation across an int8 step."""

import csv
import glob
import math
import os
import re

import numpy as np
import pytest
import torch

from s1s2.data.synthetic import make_synthetic_patches
from s1s2.eval import harness as jh
from s1s2_torch.cli import evaluate as tcli
from s1s2_torch.eval import harness as th

N_FILES, SIZE, BATCH = 5, 32, 2

# the harness's 13 ported modes (``ddim`` and ``limitation`` in both
# parameterizations, limitation's ancestral DDPM and the DPM-Solver++(2M)
# paths besides), small
CASES = {
    "ddim": dict(mode="ddim", ddim_steps=3, full_metrics=True),
    "ddim_v_eta": dict(mode="ddim", pred_param="v", ddim_steps=3, eta=0.5),
    "ddim_dpm2m_v": dict(mode="ddim", solver="dpm2m", pred_param="v", ddim_steps=3),
    "ddim_sweep": dict(mode="ddim_sweep", t_start_grid=(300, 200), ddim_steps_grid=(2, 3)),
    "eps": dict(mode="eps"),
    "vdiag": dict(mode="vdiag"),
    "seed_stats": dict(mode="seed_stats", n_seeds=2),
    "per_band": dict(mode="per_band", full_metrics=True),
    "ablate": dict(mode="ablate"),
    "tsweep": dict(mode="tsweep", t_values=(5, 20, 80)),
    "true_infer": dict(mode="true_infer", n_seeds=2, ddim_steps=3),
    "true_infer_dpm2m": dict(mode="true_infer", solver="dpm2m", n_seeds=1, ddim_steps=3),
    "onestep": dict(mode="onestep"),
    "limitation": dict(mode="limitation", ddim_steps=4, t_start=-1, save_n=3,
                       partial_reverse_k=(3,), band_weights=(1.0, 2.0, 0.5, 1.0)),
    "limitation_v": dict(mode="limitation", pred_param="v", ddim_steps=4, t_start=-1,
                         eta=0.3, save_n=2, viz_mode="dataset_fixed"),
    "limitation_ddpm": dict(mode="limitation", limitation_sampler="ddpm", T=20, t_start=-1,
                            save_n=2),
    "baseline_bicubic": dict(mode="baseline_bicubic"),
    "baseline_linear": dict(mode="baseline_linear"),
}


def make_patches(tmp_path_factory):
    root = tmp_path_factory.mktemp("modes")
    make_synthetic_patches(str(root / "p"), n=N_FILES, size=SIZE, seed=0)
    return str(root / "p")


@pytest.fixture(scope="module")
def patches(tmp_path_factory):
    return make_patches(tmp_path_factory)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side of these runs is a few small convs; one thread a
    test worker keeps the parallel test run from oversubscribing the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run_both(patch_dir, out, **kw):
    """The same config through both harnesses → (jax dir, port dir, jax
    result, port result)."""
    common = {**dict(patch_dir=patch_dir, ckpt="@random", base_ch=8, batch_size=BATCH,
                     save_viz_n=0), **kw}
    jdir, pdir = os.path.join(out, "jax"), os.path.join(out, "port")
    rj = jh.run_mode(jh.EvalConfig(out_dir=jdir, **common))
    rt = th.run_mode(th.EvalConfig(out_dir=pdir, device="cpu", **common))
    return jdir, pdir, rj, rt


_NUM = re.compile(r"-?\d+(?:\.\d+)?")


def _quantum(text: str) -> float:
    """One unit of the last printed digit of a number as written."""
    return 10.0 ** -len(text.split(".")[1]) if "." in text else 0.0


def _cell_tol(text: str, col: str, tol: float) -> float:
    return max(_quantum(text), tol * (100 if "PSNR" in col else 1))


def assert_tables_match(jdir, pdir, tol):
    """Every CSV and summary file of the JAX harness's output is in the
    port's, with the same header, rows and text; numbers within one unit of
    their last digit or ``tol`` (PSNR 100× it)."""
    names = sorted(os.path.basename(p) for p in glob.glob(os.path.join(jdir, "*"))
                   if p.endswith((".csv", ".txt")))
    assert names, jdir
    for name in names:
        jp, pp = os.path.join(jdir, name), os.path.join(pdir, name)
        assert os.path.exists(pp), name
        if name.endswith(".csv"):
            with open(jp) as f:
                ref = list(csv.reader(f))
            with open(pp) as f:
                got = list(csv.reader(f))
            assert got[0] == ref[0] and len(got) == len(ref), name
            cells = [(h, r, g) for rr, gg in zip(ref[1:], got[1:]) for h, r, g in
                     zip(ref[0], rr, gg)]
        else:
            with open(jp) as f:
                ref_lines = f.read().splitlines()
            with open(pp) as f:
                got_lines = f.read().splitlines()
            assert len(got_lines) == len(ref_lines), name
            cells = []
            for r, g in zip(ref_lines, got_lines):
                assert _NUM.sub("#", r) == _NUM.sub("#", g), (name, r, g)
                cells += list(zip([r] * 99, _NUM.findall(r), _NUM.findall(g)))
        for col, r, g in cells:
            try:
                rv, gv = float(r), float(g)
            except ValueError:
                assert r == g, (name, col, r, g)
                continue
            if math.isnan(rv):
                assert math.isnan(gv), (name, col, r, g)
                continue
            assert abs(rv - gv) <= _cell_tol(r, col, tol) + 1e-12, (name, col, r, g)


def assert_results_match(rj, rt, tol):
    assert [str(k) for k in rt] == [str(k) for k in rj]
    for k in rj:
        assert rt[k] == pytest.approx(rj[k], rel=tol, abs=tol), k


@pytest.mark.parametrize("name", list(CASES))
def test_mode_bf16_against_jax(patches, tmp_path, name):
    jdir, pdir, rj, rt = run_both(patches, str(tmp_path), compute_dtype="bfloat16",
                                  **CASES[name])
    assert_tables_match(jdir, pdir, 1e-4)
    assert_results_match(rj, rt, 1e-3)


@pytest.mark.parametrize("mode,extra", [("ddim", {}), ("seed_stats", {"n_seeds": 2}),
                                        ("ddim", {"pred_param": "v", "eta": 0.5})])
def test_name_keyed_noise_against_jax(patches, tmp_path, mode, extra):
    """``--rng_by name`` (the crc32 of the file's name) draws the JAX
    harness's noise: the tables agree (the dataset-index keying, the
    default, is every other test's)."""
    jdir, pdir, _, _ = run_both(patches, str(tmp_path), mode=mode, ddim_steps=2,
                                rng_by="name", **extra)
    assert_tables_match(jdir, pdir, 1e-4)


def test_the_keyings_draw_different_noise(patches, tmp_path):
    """The two keyings draw other noise, so the test above holds two
    different tables."""
    out = {}
    for rng_by in ("index", "name"):
        cfg = th.EvalConfig(patch_dir=patches, out_dir=str(tmp_path / rng_by), ckpt="@random",
                            base_ch=8, batch_size=BATCH, save_viz_n=0, mode="ddim",
                            ddim_steps=2, rng_by=rng_by, device="cpu")
        out[rng_by] = th.run_mode(cfg)["MAE_mean"]
    assert out["index"] != out["name"]


@pytest.mark.parametrize("mode", ["ddim", "per_band", "limitation"])
def test_int8_modes_against_jax(patches, tmp_path, mode):
    kw = dict(ddim_steps=3, t_start=-1 if mode == "limitation" else 200, save_n=1)
    jdir, pdir, rj, rt = run_both(patches, str(tmp_path), mode=mode, int8=True, **kw)
    assert_tables_match(jdir, pdir, 1e-3)


def test_noise_npz_replays_into_every_salt(patches, tmp_path):
    """``--noise_npz`` replaces the per-file draws (salt 0 and seed_stats'
    1000+s), the same way in both harnesses."""
    rng = np.random.default_rng(0)
    arrs = {f"s{s}_i{i}": rng.standard_normal((SIZE, SIZE, 4)).astype(np.float32)
            for s in (0, 1000, 1001) for i in range(N_FILES)}
    npz = str(tmp_path / "n.npz")
    np.savez(npz, **arrs)
    for mode in ("ddim", "seed_stats"):
        jdir, pdir, _, _ = run_both(patches, str(tmp_path / mode), mode=mode, ddim_steps=2,
                                    n_seeds=2, noise_npz=npz)
        assert_tables_match(jdir, pdir, 1e-4)


def test_cache_dir_serves_the_same_batches(patches, tmp_path):
    """``--cache_dir`` (the mmap cache) gives the port's own tables
    unchanged, and reuses the cache it wrote."""
    base = dict(patch_dir=patches, ckpt="@random", base_ch=8, batch_size=BATCH, save_viz_n=0,
                mode="per_band", device="cpu")
    th.run_mode(th.EvalConfig(out_dir=str(tmp_path / "plain"), **base))
    for i in range(2):
        th.run_mode(th.EvalConfig(out_dir=str(tmp_path / f"cached{i}"),
                                  cache_dir=str(tmp_path / "cache"), **base))
        for name in ("per_band_all.csv", "per_band_summary.csv"):
            with open(tmp_path / "plain" / name) as f, open(tmp_path / f"cached{i}" / name) as g:
                assert f.read() == g.read()
    assert sorted(os.listdir(tmp_path / "cache")) == ["cache_manifest.json", "cond.npy",
                                                      "mask.npy", "target.npy"]


def test_mmap_cache_equals_jax(patches, tmp_path):
    from s1s2.data.dataset import NpzPatchDataset as JDataset
    from s1s2.data.loader import MmapCache as JCache
    from s1s2_torch.data.dataset import NpzPatchDataset
    from s1s2_torch.data.loader import MmapCache

    ref = JCache(JDataset(patches), str(tmp_path / "j"))
    got = MmapCache(NpzPatchDataset(patches), str(tmp_path / "t"))
    assert got.files == ref.files and len(got) == len(ref) == N_FILES
    for idxs in ([0, 1], [4, 4, 2]):
        for g, r in zip(got.batch(idxs), ref.batch(idxs)):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, r)


def test_evaluate_cli_runs_a_table_mode_with_its_defaults(patches, tmp_path, capsys):
    """The CLI with its defaults (``--save_viz_n 6``: previews written)."""
    out = tmp_path / "o"
    res = tcli.main(["--mode", "ddim", "--patch_dir", patches, "--ckpt", "@random",
                     "--base_ch", "8", "--ddim_steps", "2", "--out_dir", str(out),
                     "--device", "cpu"])
    assert set(res) == {"MAE_mean", "MAE_std", "MSE_mean", "MSE_std"}
    assert capsys.readouterr().out.strip().startswith('{"MAE_mean": ')
    assert len(glob.glob(str(out / "previews" / "*_ddim_pred_*.png"))) == 2 * N_FILES
    with open(out / "ddim_metrics.csv") as f:
        assert len(list(csv.reader(f))) == N_FILES + 1
