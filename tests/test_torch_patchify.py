"""s1s2_torch's patch extraction against the JAX package's on the same
scenes: each function's output equal (bit for bit: the same numpy code),
``run_patchify`` end to end on ``.npy`` band files (the manifest and every
patch npz equal, the previews' decoded pixels equal), the ``rasterio``
branch through ``tools/rasterio_shim.py``, ``exact_filters``, the
dark-scene rejection and the CLI against the JAX CLI."""

import json
import os
import sys

import numpy as np
import pytest
from PIL import Image

from s1s2.cli import patchify as jcli
from s1s2.data import patchify as jp
from s1s2_torch.cli import patchify as tcli
from s1s2_torch.data import patchify as tp

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")


def _write_scene(folder, H=96, W=96, seed=0, dark=False, suffix=".npy", s1_names=0):
    """A synthetic collocated scene: band files at the reference's names
    (``.img.npy``; or npy bytes under the ``.img`` name itself for the
    rasterio shim, ``suffix=""``)."""
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.1, 0.9, (H, W)).astype(np.float32)

    def save(name, a):
        with open(os.path.join(folder, name + suffix), "wb") as f:
            np.save(f, a)
    for name in tp.TARGET_BANDS:
        band = np.clip(base + rng.normal(0, 0.2, (H, W)), 0, 1).astype(np.float32)
        save(name, np.full((H, W), 0.01, np.float32) if dark else band * 10000.0)
    for name in tp.S1_NAME_FALLBACKS[s1_names]:
        hh = rng.normal(-10, 3, (H, W)).astype(np.float32)
        hh[rng.random((H, W)) < 0.02] = np.nan
        save(name, hh)
    save(tp.AUX_BANDS[0], rng.uniform(20, 50, (H, W)).astype(np.float32))
    save(tp.AUX_BANDS[1], rng.uniform(0, 500, (H, W)).astype(np.float32))
    colloc = np.ones((H, W), np.float32)
    colloc[:, :7] = 0
    save("collocationFlags.img", colloc)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(3)
    target = rng.uniform(0, 1, (4, 48, 40)).astype(np.float32)
    target[:, :9] = 0.02  # a dark strip
    target[3, 5, 5] = np.nan
    mask = rng.uniform(0, 1, (48, 40)) > 0.2
    return target, mask


def _same(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif hasattr(a, "__dataclass_fields__"):
        for f in a.__dataclass_fields__:
            _same(getattr(a, f), getattr(b, f))
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


FUNCTIONS = {
    "maybe_scale_s2_to_01": lambda m, t, k: m.maybe_scale_s2_to_01(t[0] * 10000.0),
    "maybe_scale_s2_to_01_nan": lambda m, t, k: m.maybe_scale_s2_to_01(
        np.full((4, 4), np.nan, np.float32)),
    "build_mask": lambda m, t, k: m.build_mask(t[:2], t[2:], (t[0] > 0.3).astype(np.float32)),
    "zscore": lambda m, t, k: m.zscore(t[1] * 7 + 3, k),
    "zscore_no_mask": lambda m, t, k: m.zscore(t[1], None),
    "patch_iter": lambda m, t, k: list(m.patch_iter(48, 40, 16, 8)),
    "dark_fraction": lambda m, t, k: m.dark_fraction(t[:, :16, :16], k[:16, :16]),
    "laplacian_var": lambda m, t, k: m.laplacian_var(t[3, :16, :16], k[:16, :16]),
    "_integral": lambda m, t, k: m._integral(t[2]),
    "_window_sums": lambda m, t, k: m._window_sums(m._integral(t[0]), np.arange(0, 33, 8),
                                                   np.arange(0, 25, 8), 16),
    "scene_window_stats": lambda m, t, k: m.scene_window_stats(t, k, 16, 8, 0.1),
}


@pytest.mark.parametrize("name", list(FUNCTIONS))
def test_function_equal_to_jax(scene, name):
    target, mask = scene
    _same(FUNCTIONS[name](tp, target, mask), FUNCTIONS[name](jp, target, mask))


def test_load_scene_equal_to_jax(tmp_path):
    _write_scene(str(tmp_path / "s"), s1_names=2)
    _same(tp.load_scene(str(tmp_path / "s")), jp.load_scene(str(tmp_path / "s")))
    os.remove(tmp_path / "s" / "B8.img.npy")
    assert tp.load_scene(str(tmp_path / "s")) is None
    assert tp.get_geo(str(tmp_path / "s" / "B2.img")) == ((0.0, 1.0, 0.0, 0.0, 0.0, -1.0), "")


def _assert_outputs_equal(jdir, tdir, previews=True):
    with open(os.path.join(jdir, "manifest.json")) as f:
        jm = json.load(f)
    with open(os.path.join(tdir, "manifest.json")) as f:
        tm = json.load(f)
    assert tm == {**jm, "base_dir": tm["base_dir"]}
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for p in jm["patches"]:
        with np.load(os.path.join(jdir, p["npz"])) as a, np.load(os.path.join(tdir, p["npz"])) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        if previews:
            pngs = sorted(os.listdir(os.path.join(jdir, p["preview_dir"])))
            assert len(pngs) == 10
            assert sorted(os.listdir(os.path.join(tdir, p["preview_dir"]))) == pngs
            for f in pngs:
                ref = Image.open(os.path.join(jdir, p["preview_dir"], f))
                got = Image.open(os.path.join(tdir, p["preview_dir"], f))
                assert got.mode == ref.mode, f
                np.testing.assert_array_equal(np.asarray(got), np.asarray(ref), err_msg=f)
    return jm


def _run_both(base, out, **kw):
    jm = jp.run_patchify(jp.PatchifyConfig(str(base), str(out / "jax"), **kw))
    tm = tp.run_patchify(tp.PatchifyConfig(str(base), str(out / "port"), **kw))
    assert tm == jm
    return _assert_outputs_equal(str(out / "jax"), str(out / "port"),
                                 kw.get("write_previews", True))


def test_run_patchify_end_to_end_equal_to_jax(tmp_path):
    """Two scenes (one behind the second S1 name fallback), a folder with a
    band missing, a per-folder share of the cap (12 // 3 folders each)."""
    base = tmp_path / "raw"
    _write_scene(str(base / "a.data"))
    _write_scene(str(base / "b.data"), seed=1, s1_names=1)
    _write_scene(str(base / "c.data"), seed=2)
    os.remove(base / "c.data" / "B3.img.npy")
    m = _run_both(base, tmp_path, patch_size=32, stride=16, max_patches=12,
                  per_folder_share=True)
    assert m["total_patches"] == 8 and {p["folder"] for p in m["patches"]} == {"a.data",
                                                                              "b.data"}
    assert m["validratio_skipped"] > 0


def test_exact_filters_equal_to_jax(tmp_path):
    _write_scene(str(tmp_path / "raw" / "s.data"))
    m = _run_both(tmp_path / "raw", tmp_path, patch_size=32, stride=16, write_previews=False,
                  exact_filters=True, texture_thr=1.7)
    assert m["total_patches"] > 0 and m["texture_skipped"] > 0


def test_dark_scene_rejected_as_jax_rejects_it(tmp_path):
    _write_scene(str(tmp_path / "raw" / "dark.data"), dark=True)
    m = _run_both(tmp_path / "raw", tmp_path, patch_size=32, stride=32, write_previews=False)
    assert m["total_patches"] == 0
    assert m["dark_skipped"] + m["var_skipped"] + m["texture_skipped"] > 0


@pytest.fixture()
def shim(monkeypatch):
    """``tools/rasterio_shim.py``'s stand-in as ``rasterio`` for one test."""
    monkeypatch.syspath_prepend(TOOLS)
    import rasterio_shim

    saved = sys.modules.pop("rasterio", None)
    mod = rasterio_shim.install()
    sys.modules.pop("rasterio")
    if saved is not None:
        sys.modules["rasterio"] = saved
    monkeypatch.setitem(sys.modules, "rasterio", mod)
    return rasterio_shim


def test_rasterio_branch_through_the_shim(tmp_path, shim):
    """Band files at their ``.img`` names, read through ``rasterio.open``:
    the shim's geotransform and CRS in every npz."""
    _write_scene(str(tmp_path / "raw" / "s.data"), suffix="")
    path = str(tmp_path / "raw" / "s.data" / "B2.img")
    assert tp.get_geo(path) == jp.get_geo(path) == (shim.GDAL_TRANSFORM, shim.CRS_STRING)
    m = _run_both(tmp_path / "raw", tmp_path, patch_size=32, stride=32)
    with np.load(tmp_path / "port" / m["patches"][0]["npz"]) as d:
        assert tuple(d["transform"]) == shim.GDAL_TRANSFORM and str(d["crs"]) == shim.CRS_STRING


def test_read_band_without_rasterio_raises(tmp_path, monkeypatch):
    img = tmp_path / "B2.img"
    img.write_bytes(b"ENVI")
    monkeypatch.setitem(sys.modules, "rasterio", None)
    with pytest.raises(ImportError, match="rasterio is required"):
        tp.read_band(str(img))
    assert tp.read_band(str(tmp_path / "missing.img")) is None


def test_cli_against_jax_cli(tmp_path, capsys):
    _write_scene(str(tmp_path / "raw" / "s.data"))
    flags = ["--base-dir", str(tmp_path / "raw"), "--patch-size", "32", "--stride", "32",
             "--max-patches", "3", "--dark-thr", "0.05", "--no-previews"]
    jcli.main(flags + ["--output-dir", str(tmp_path / "jax")])
    jline = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    out = tcli.main(flags + ["--output-dir", str(tmp_path / "port")])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == jline
    assert out["total_patches"] == jline["total_patches"] == 3
    _assert_outputs_equal(str(tmp_path / "jax"), str(tmp_path / "port"), previews=False)
