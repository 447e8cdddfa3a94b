"""s1s2_torch's panel modes against the JAX harness on the same inputs:
``night_demo`` (``--save_viz_n 0`` still writes one panel), ``cloudy_viz``
(ε and v, with zoom crops, a short last batch) and the ``tsweep`` and
``cfg_sweep`` previews. The same file names and returned dicts; each PNG's
pixels within 1 level of JAX's, at most 0.5% of them differing (the f32
predictions differ by about 1e-6, which can move a percentile stretch by
one level). Small: base 8, 16² patches, T=50, f32 on the CPU. The net is a
reference-layout ``.pth`` with torch's default init from a seed, which both
harnesses load through their converters (JAX's ``"@random"`` would compile
flax's initialisers, about 20 s on the CPU)."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from s1s2.data.synthetic import make_synthetic_patches
from s1s2.eval import harness as jh
from s1s2_torch.eval import harness as th
from s1s2_torch.models.torch_twin import build_torch_unet

torch.set_num_threads(1)

LEVELS, SHARE = 1, 0.005  # the pixel tolerance: levels, share of pixels that may differ


@pytest.fixture(scope="module")
def patches(tmp_path_factory):
    """The patch dir and the net: 5 cloudy 16² patches, a base-8 ``.pth``."""
    root = tmp_path_factory.mktemp("panels")
    make_synthetic_patches(str(root / "p"), n=5, size=16, seed=0, with_cloud=True)
    torch.manual_seed(0)
    torch.save(build_torch_unet(8, 4, 8).state_dict(), root / "net.pth")
    return str(root / "p"), str(root / "net.pth")


def _cfgs(patches, out, **kw):
    patch_dir, ckpt = patches
    common = {**dict(patch_dir=patch_dir, ckpt=ckpt, base_ch=8, T=50, t_start=40,
                     ddim_steps=4, batch_size=2, compute_dtype="float32"), **kw}
    return (jh.EvalConfig(out_dir=str(out / "jax"), **common),
            th.EvalConfig(out_dir=str(out / "port"), device="cpu", **common))


def _pngs(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".png"))


def _assert_same_pngs(jdir, tdir):
    names = _pngs(jdir)
    assert names and _pngs(tdir) == names
    for name in names:
        ref = np.asarray(Image.open(os.path.join(jdir, name)).convert("RGB"), np.int16)
        got = np.asarray(Image.open(os.path.join(tdir, name)).convert("RGB"), np.int16)
        assert got.shape == ref.shape, name
        diff = np.abs(got - ref)
        assert diff.max() <= LEVELS and (diff > 0).mean() <= SHARE, (name, diff.max(),
                                                                    (diff > 0).mean())
    return names


CASES = {
    # stops inside the first batch (the JAX mode compiles a sampler a batch)
    "night_demo": (dict(mode="night_demo", save_viz_n=2, batch_size=3),
                   [f"{i:03d}_night_panel.png" for i in range(2)]),
    "night_demo_viz0": (dict(mode="night_demo", save_viz_n=0), ["000_night_panel.png"]),
    "cloudy_viz_eps": (dict(mode="cloudy_viz", select_top_cloud=3, zoom=8, zoom_k=2),
                       sorted([f"{i:03d}_cloudy_panel.png" for i in range(3)]
                              + [f"{i:03d}_cloudy_panel_{n}_zoom{k}.png" for i in range(3)
                                 for n in ("s1", "gt_true", "pred_true") for k in range(2)])),
    "cloudy_viz_v": (dict(mode="cloudy_viz", select_top_cloud=3, pred_param="v", eta=0.5),
                     [f"{i:03d}_cloudy_panel.png" for i in range(3)]),
    "tsweep": (dict(mode="tsweep", save_viz_n=3, t_values=(5, 10, 20, 40)),
               [f"{i:03d}_tsweep_t20.png" for i in range(3)]),
    "cfg_sweep": (dict(mode="cfg_sweep", save_viz_n=3, guidance_scales=(1.0, 2.5),
                       t_start=49, ddim_steps=3),
                  sorted(f"cfg_g{g}_patch_{i:06d}.png" for g in ("1", "2.5") for i in range(3))),
}


@pytest.mark.parametrize("name", list(CASES))
def test_panel_mode_against_jax(patches, tmp_path, name):
    kw, want = CASES[name]
    jcfg, tcfg = _cfgs(patches, tmp_path, **kw)
    rj, rt = jh.run_mode(jcfg), th.run_mode(tcfg)
    assert list(rt) == list(rj)
    for k in rj:
        assert rt[k] == pytest.approx(rj[k], rel=1e-5, abs=1e-6), k
    names = _assert_same_pngs(os.path.join(jcfg.out_dir, "previews"),
                              os.path.join(tcfg.out_dir, "previews"))
    assert names == want


def test_cloud_ranking_against_jax(patches, tmp_path):
    """Cloudiest first, ties by (name, index): the order the JAX harness
    selects in (its synthetic set's cloud fraction grows with the index)."""
    jcfg, tcfg = _cfgs(patches, tmp_path, mode="cloudy_viz")
    ranked = th.cloud_ranking(th.EvalContext(tcfg))
    fracs = []
    jctx = jh.EvalContext(jcfg)
    for i, f in enumerate(jctx.ds.files):
        with np.load(jctx.ds.path(i)) as d:
            fracs.append((-float((d["cloud_mask"] > 0.5).mean()), f, i))
    assert ranked == sorted(fracs)
    assert [i for _, _, i in ranked][0] == 4
