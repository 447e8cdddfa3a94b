"""s1s2_torch's comparison panels without PIL, against Pillow and the JAX
package's ``save_panel``: the bilinear resize bit-equal to Pillow's
``Image.resize(..., BILINEAR)`` (up- and downscales, odd sizes, non-square
tiles); ``save_panel``'s decoded pixels bit-equal to the JAX ``save_panel``'s
(with and without GT and zoom crops, every title format the harness writes,
and 50 random printable-ASCII titles); the committed glyph atlas equal to a
fresh run of its generator; the PNG writer's grey mode and its reader."""

import os

import numpy as np
import pytest
from PIL import Image

from s1s2.viz import render as jr
from s1s2_torch.viz import _glyphs
from s1s2_torch.viz import render as tr

RESIZES = {  # (h, w) → (width, height)
    "tile_up": ((256, 256), (512, 512)),
    "tile_down": ((1024, 1024), (512, 512)),
    "odd_up": ((37, 53), (512, 357)),
    "odd_down": ((513, 301), (256, 150)),
    "non_square": ((64, 200), (512, 160)),
    "tiny": ((3, 2), (1, 5)),
    "height_only": ((256, 256), (256, 511)),
    "mixed": ((100, 7), (3, 100)),
}


@pytest.mark.parametrize("name", list(RESIZES))
def test_resize_bit_equal_to_pillow(name):
    (h, w), (W, H) = RESIZES[name]
    im = np.random.default_rng(len(name)).integers(0, 256, (h, w, 3), dtype=np.uint8)
    ref = np.asarray(Image.fromarray(im).resize((W, H), Image.BILINEAR))
    np.testing.assert_array_equal(tr.resize_bilinear(im, W, H), ref)


def _inputs(seed, size=32):
    rng = np.random.default_rng(seed)
    gt = rng.random((size, size, 4)).astype(np.float32)
    pred = np.clip(gt + 0.1 * rng.standard_normal(gt.shape), 0, 1).astype(np.float32)
    cond = rng.standard_normal((size, size, 4)).astype(np.float32)
    return pred, gt, cond


def _decoded(path):
    return np.asarray(Image.open(path).convert("RGB"))


def _assert_panels_equal(tmp_path, name, pred, gt, cond, **kw):
    jp, tp = str(tmp_path / "jax" / f"{name}.png"), str(tmp_path / "port" / f"{name}.png")
    jr.save_panel(pred, gt, cond, jp, **kw)
    tr.save_panel(pred, gt, cond, tp, **kw)
    files = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == files
    for f in files:
        np.testing.assert_array_equal(_decoded(tmp_path / "port" / f),
                                      _decoded(tmp_path / "jax" / f), err_msg=f)
    return files


# every title format of the harness, with and without GT and zoom
PANELS = {
    "night": (False, dict(title="Night demo: patch_000001.npz")),
    "cloudy_zoom": (True, dict(title="Cloudy case: patch_000031.npz", zoom=8, zoom_k=3)),
    "cloudy_zoom_wider_than_tile": (True, dict(title="Cloudy case: x.npz", zoom=40, zoom_k=1)),
    "tsweep": (True, dict(title="t-sweep middle t=20")),
    "cfg": (True, dict(title="CFG g=1.5  t_start=200 steps=20  patch_000003.npz")),
    "untitled_small_tiles": (True, dict(tile_width=48)),
}


@pytest.mark.parametrize("name", list(PANELS))
def test_save_panel_pixels_equal_to_jax(tmp_path, name):
    with_gt, kw = PANELS[name]
    pred, gt, cond = _inputs(len(name))
    files = _assert_panels_equal(tmp_path, name, pred, gt if with_gt else None, cond, **kw)
    assert len(files) == 1 + 3 * kw.get("zoom_k", 0)


def test_save_panel_random_titles_equal_to_jax(tmp_path):
    """50 random printable-ASCII titles of 1 to 120 characters on one
    panel's tiles."""
    rng = np.random.default_rng(0)
    pred, gt, cond = _inputs(1, size=16)
    for i in range(50):
        title = "".join(chr(c) for c in rng.integers(32, 127, int(rng.integers(1, 121))))
        _assert_panels_equal(tmp_path / str(i), "p", pred, gt, cond, title=title,
                             tile_width=128)


def test_title_outside_the_atlas_raises(tmp_path):
    pred, gt, cond = _inputs(0, size=16)
    with pytest.raises(ValueError, match="'é'"):
        tr.save_panel(pred, gt, cond, str(tmp_path / "p.png"), title="Nuit: é")
    assert not (tmp_path / "p.png").exists()


def test_grey_png_decodes_as_pil_writes_it(tmp_path):
    a = np.random.default_rng(0).integers(0, 256, (7, 5), dtype=np.uint8)
    tr.write_png(str(tmp_path / "g.png"), a)
    Image.fromarray(a).save(tmp_path / "pil.png")
    got, ref = Image.open(tmp_path / "g.png"), Image.open(tmp_path / "pil.png")
    assert got.mode == ref.mode == "L"
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))



@pytest.mark.parametrize("shape", [(9, 13, 3), (7, 5)])
def test_read_png_is_write_pngs_inverse(tmp_path, shape):
    """``read_png`` gives back what ``write_png`` wrote, as PIL decodes it."""
    a = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    tr.write_png(str(tmp_path / "a.png"), a)
    got = tr.read_png(str(tmp_path / "a.png"))
    assert got.dtype == np.uint8 and got.shape == shape
    np.testing.assert_array_equal(got, a)
    np.testing.assert_array_equal(got, np.asarray(Image.open(tmp_path / "a.png")))

def test_committed_atlas_is_the_generators_output():
    import PIL

    if PIL.__version__ != _glyphs.PILLOW:
        pytest.skip(f"the atlas is of Pillow {_glyphs.PILLOW}, this is {PIL.__version__}")
    from s1s2_torch.viz import make_glyphs

    with open(_glyphs.__file__) as f:
        assert f.read() == make_glyphs.atlas_source()
    assert sorted(_glyphs.GLYPHS) == list(range(32, 127))
