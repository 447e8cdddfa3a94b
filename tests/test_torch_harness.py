"""s1s2_torch's eval harness, metrics, loader and CLIs against the JAX
package on the same inputs: the metrics, ``eval_batches``, the per-file keys
and noise under both keyings, ``run_mode(cfg_sweep)``'s CSV cell by cell
(bf16 and the quality-equal int8 setting), the evaluate parser's flags and
the quantize CLI's artifact. Small: base 8 (``"@random"``, flax's init from
``PRNGKey(0)``), 32², a 7-file rich synthetic set."""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s1s2.cli import evaluate as jcli
from s1s2.data import loader as jloader
from s1s2.data.dataset import NpzPatchDataset as JDataset
from s1s2.data.synthetic import make_synthetic_patches
from s1s2.eval import harness as jh
from s1s2.eval import metrics as jm
from s1s2.models import quant as jq
from s1s2_torch.cli import evaluate as tcli
from s1s2_torch.cli import quantize as tquantize
from s1s2_torch.data import loader as tloader
from s1s2_torch.data.dataset import NpzPatchDataset
from s1s2_torch.eval import harness as th
from s1s2_torch.eval import metrics as tm
from s1s2_torch.models import quant as tq
from s1s2_torch.models.quant import _nest
from s1s2_torch.models.unet import init_params
from s1s2_torch.train.checkpoint import msgpack_serialize

ORDER = (5, 2, 3, 6, 1)  # a --file_list in forced order


@pytest.fixture(scope="module")
def patches(tmp_path_factory):
    root = tmp_path_factory.mktemp("rich")
    make_synthetic_patches(str(root / "p"), n=7, size=32, seed=0, rich=True)
    lst = root / "list.txt"
    lst.write_text("".join(f"patch_{i:06d}.npz\n" for i in ORDER))
    return dict(dir=str(root / "p"), list=str(lst), root=root)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mcase():
    rng = np.random.default_rng(3)
    pred = rng.random((3, 16, 16, 4)).astype(np.float32)
    tgt = rng.random((3, 16, 16, 4)).astype(np.float32)
    mask = (rng.random((3, 16, 16)) > 0.3).astype(np.float32)
    return pred, tgt, mask


@pytest.mark.parametrize("name", ["masked_mae", "masked_mse", "masked_mae_per_sample",
                                  "masked_mse_per_sample", "psnr", "sam", "ergas"])
@pytest.mark.parametrize("masked", [True, False])
def test_masked_metrics_against_jax(mcase, name, masked):
    """f32 sums in other orders: within 1e-5 relative."""
    pred, tgt, mask = mcase
    m = mask if masked else None
    ref = float(getattr(jm, name)(jnp.asarray(pred), jnp.asarray(tgt),
                                  None if m is None else jnp.asarray(m)))
    got = float(getattr(tm, name)(torch.from_numpy(pred), torch.from_numpy(tgt),
                                  None if m is None else torch.from_numpy(m)))
    assert got == pytest.approx(ref, rel=1e-5, abs=1e-7)


def test_psnr_cap_and_host_psnr():
    x = torch.ones((1, 4, 4, 2))
    assert float(tm.psnr(x, x)) == 99.0 and tm.psnr_from_mse(0.0) == 99.0
    assert tm.psnr_from_mse(0.01) == jm.psnr_from_mse(0.01) == pytest.approx(20.0)


def test_ssim_and_diagnostics_against_jax(mcase):
    pred, tgt, _ = mcase
    assert float(tm.ssim_simple(torch.from_numpy(pred), torch.from_numpy(tgt))) == \
        pytest.approx(float(jm.ssim_simple(jnp.asarray(pred), jnp.asarray(tgt))), rel=1e-5)
    for got, ref in zip(tm.eps_diagnostics(torch.from_numpy(pred), torch.from_numpy(tgt)),
                        jm.eps_diagnostics(jnp.asarray(pred), jnp.asarray(tgt))):
        assert float(got) == pytest.approx(float(ref), rel=1e-5)
    got = tm.v_diagnostics(*(torch.from_numpy(a) for a in (pred, tgt, tgt, pred)))
    ref = jm.v_diagnostics(*(jnp.asarray(a) for a in (pred, tgt, tgt, pred)))
    assert [float(g) for g in got] == pytest.approx([float(r) for r in ref], rel=1e-5)
    assert len(tm.v_diagnostics(torch.from_numpy(pred), torch.from_numpy(tgt))) == 2


@pytest.mark.parametrize("band_weights", [None, (1.0, 2.0, 0.5, 1.0)])
def test_channelwise_sums_and_aggregate_against_jax(mcase, band_weights):
    pred, tgt, mask = mcase
    got = tm.channelwise_error_sums(*(torch.from_numpy(a) for a in (pred, tgt, mask)))
    ref = jm.channelwise_error_sums(*(jnp.asarray(a) for a in (pred, tgt, mask)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5)
    a_got = tm.aggregate_final(*got, band_weights=band_weights)
    a_ref = jm.aggregate_final(*(np.asarray(r) for r in ref), band_weights=band_weights)
    for g, r in zip(a_got, a_ref):
        np.testing.assert_allclose(g, r, rtol=1e-5)


def test_per_sample_is_the_batch_of_one_metric(mcase):
    """The harness's per-file PSNR: the B=1 trick of the JAX harness's
    ``_vmapped``, within 1e-5 relative."""
    pred, tgt, mask = mcase
    ref = np.asarray(jh._vmapped(jm.psnr)(jnp.asarray(pred), jnp.asarray(tgt),
                                          jnp.asarray(mask)))
    got = tm.per_sample(tm.psnr)(*(torch.from_numpy(a) for a in (pred, tgt, mask)))
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)


# ---------------------------------------------------------------------------
# loader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch_size,max_files,prefetch", [(3, None, True), (4, 5, True),
                                                           (2, None, False), (8, None, True)])
def test_eval_batches_equal_jax(patches, batch_size, max_files, prefetch):
    """The same batches, names and valid counts; the last batch padded with
    its last item."""
    ref = list(jloader.eval_batches(JDataset(patches["dir"]), batch_size, max_files, prefetch))
    got = list(tloader.eval_batches(NpzPatchDataset(patches["dir"]), batch_size, max_files,
                                    prefetch))
    assert len(got) == len(ref)
    for (gb, gn, gv), (rb, rn, rv) in zip(got, ref):
        assert gn == rn and gv == rv
        for g, r in zip(gb, rb):
            assert g.dtype == np.float32 and g.shape[0] == batch_size
            np.testing.assert_array_equal(g, r)
        for g in gb:
            np.testing.assert_array_equal(g[gv:], np.broadcast_to(g[gv - 1], g[gv:].shape))


# ---------------------------------------------------------------------------
# context: keys, noise, checkpoints
# ---------------------------------------------------------------------------


def _cfgs(patches, out, **kw):
    common = {**dict(patch_dir=patches["dir"], ckpt="@random", mode="cfg_sweep", base_ch=8,
                     save_viz_n=0), **kw}
    return (jh.EvalConfig(out_dir=str(out / "jax"), **common),
            th.EvalConfig(out_dir=str(out / "port"), device="cpu", **common))


@pytest.mark.parametrize("rng_by", ["index", "name"])
@pytest.mark.parametrize("file_list", [False, True])
def test_per_file_keys_and_noise_bit_equal(patches, tmp_path, rng_by, file_list):
    jcfg, tcfg = _cfgs(patches, tmp_path, rng_by=rng_by,
                       file_list=patches["list"] if file_list else None)
    jctx, tctx = jh.EvalContext(jcfg), th.EvalContext(tcfg)
    assert tctx.ds.files == jctx.ds.files and tctx.file_idx == jctx.file_idx
    idx = [3, 0, 4, 4]
    for salt in (0, jh.ETA_SALT):
        np.testing.assert_array_equal(tctx.per_file_keys(idx, salt),
                                      np.asarray(jctx.per_file_keys(idx, salt)))
        got = tctx.per_file_noise(idx, salt)
        assert got.dtype == torch.float32 and tuple(got.shape) == (4, 32, 32, 4)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jctx.per_file_noise(idx, salt)))
    assert th.stable_file_id("patch_000001.npz") == jh.stable_file_id("patch_000001.npz")


def test_noise_npz_replaces_the_draws(patches, tmp_path):
    arr = np.random.default_rng(0).standard_normal((32, 32, 4)).astype(np.float32)
    np.savez(tmp_path / "n.npz", s0_i2=arr, s0_i1=2 * arr)
    _, tcfg = _cfgs(patches, tmp_path, noise_npz=str(tmp_path / "n.npz"))
    ctx = th.EvalContext(tcfg)
    np.testing.assert_array_equal(ctx.per_file_noise([2, 1]).numpy(), np.stack([arr, 2 * arr]))
    with pytest.raises(KeyError):
        ctx.per_file_noise([3])


def test_random_and_msgpack_checkpoints(patches, tmp_path):
    """``@random`` is the JAX harness's init; a ``.msgpack`` loads through
    the port's reader with the stem; the schedule follows --time_schedule."""
    jcfg, tcfg = _cfgs(patches, tmp_path, schedule="linear")
    jctx, tctx = jh.EvalContext(jcfg), th.EvalContext(tcfg)
    ref = jax.tree_util.tree_leaves_with_path(jctx.variables["params"])
    assert len(ref) == len(tctx.state)
    for path, leaf in ref:
        key = ".".join(p.key for p in path)
        np.testing.assert_array_equal(tctx.state[key].numpy(), np.asarray(leaf))
    np.testing.assert_array_equal(tctx.schedule.alpha_bar_np(), jctx.schedule.alpha_bar_np())
    ckpt = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples",
                        "checkpoints", "distill_eps_student24x4.bf16.msgpack")
    _, scfg = _cfgs(patches, tmp_path, ckpt=ckpt, base_ch=24, stem_s2d=4)
    ctx = th.EvalContext(scfg)
    assert ctx.model.stem_s2d == 4 and tuple(ctx.state["inc.kernel"].shape) == (3, 3, 129, 24)


@pytest.mark.parametrize("kw", [{"mesh_data": 2}, {"cache_dir": "x"}, {"save_viz_n": 1},
                                {"ckpt": "model.pth"}, {"mode": "ddim"}])
def test_unported_options_raise(patches, tmp_path, kw):
    _, tcfg = _cfgs(patches, tmp_path, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        th.run_mode(tcfg)


# ---------------------------------------------------------------------------
# cfg_sweep against the JAX harness
# ---------------------------------------------------------------------------


def _rows(path):
    with open(os.path.join(path, "cfg_sweep_summary.csv")) as f:
        return list(csv.reader(f))


# (extra config, MAE/MSE tolerance): bf16 nets that round at other places
# differ in the 5th decimal of a file's MAE; in int8 a one-ulp bf16
# difference can move an activation across an int8 step, 10x that
SWEEPS = {
    "v-bf16": (dict(pred_param="v"), 1e-4),
    "v-int8-quality-equal": (dict(pred_param="v", int8=True, int8_calib="rollout",
                                  int8_perchannel=True, int8_bf16_blocks=("conv1",)), 1e-3),
    "eps-bf16": (dict(pred_param="eps"), 1e-4),
    "eps-int8-qsample": (dict(pred_param="eps", int8=True), 1e-3),
}


@pytest.mark.parametrize("name", list(SWEEPS))
def test_cfg_sweep_csv_against_jax(patches, tmp_path, name):
    """bench.py's protocol at a small size (t_start 999, 5 steps, g=3, a
    --file_list in forced order, batches of 2 with a padded last one):
    the same header, the same guidance/t_start/steps/files cells, and
    MAE_mean, MAE_std, MSE_mean within the stated tolerance, PSNR_mean
    within 100× it in dB."""
    extra, tol = SWEEPS[name]
    jcfg, tcfg = _cfgs(patches, tmp_path, t_start=999, ddim_steps=5, guidance_scales=(3.0,),
                       batch_size=2, file_list=patches["list"], **extra)
    rj, rt = jh.run_mode(jcfg), th.run_mode(tcfg)
    assert list(rt) == list(rj) == [3.0]
    ref, got = _rows(jcfg.out_dir), _rows(tcfg.out_dir)
    assert got[0] == ref[0] == ["guidance", "t_start", "steps", "files", "MAE_mean",
                                "MAE_std", "MSE_mean", "PSNR_mean"]
    assert len(got) == len(ref) == 2
    assert got[1][:4] == ref[1][:4] == ["3.0", "999", "5", str(len(ORDER))]
    for g, r in zip(got[1][4:7], ref[1][4:7]):
        assert abs(float(g) - float(r)) <= tol, (got[1], ref[1])
    assert abs(float(got[1][7]) - float(ref[1][7])) <= 100 * tol
    assert abs(rt[3.0] - rj[3.0]) <= tol


# ---------------------------------------------------------------------------
# CLIs
# ---------------------------------------------------------------------------


def _options(parser):
    return {s: a for a in parser._actions for s in a.option_strings}


def test_evaluate_parser_has_every_jax_flag_with_its_default():
    jopts, topts = _options(jcli.build_parser()), _options(tcli.build_parser())
    assert set(jopts) <= set(topts)
    for flag, a in jopts.items():
        if flag in ("-h", "--help"):
            continue
        b = topts[flag]
        assert (b.default, b.nargs, b.type, b.required) == (a.default, a.nargs, a.type,
                                                            a.required), flag
        if flag != "--mode" and a.choices is not None:
            assert list(b.choices) == list(a.choices), flag
    assert list(topts["--mode"].choices) == sorted(th.MODES) == ["cfg_sweep"]
    assert topts["--device"].default == "cuda"


def test_evaluate_cli_runs_cfg_sweep(patches, tmp_path, capsys):
    out = tmp_path / "o"
    res = tcli.main(["--mode", "cfg_sweep", "--patch_dir", patches["dir"], "--ckpt", "@random",
                     "--base_ch", "8", "--pred_param", "v", "--t_start", "999",
                     "--ddim_steps", "2", "--guidance_scales", "3", "1", "--save_viz_n", "0",
                     "--out_dir", str(out), "--max_files", "3", "--device", "cpu"])
    assert list(res) == [3.0, 1.0]
    assert capsys.readouterr().out.strip().startswith('{"3.0": ')
    assert [r[0] for r in _rows(out)[1:]] == ["3.0", "1.0"]
    with pytest.raises(SystemExit):
        tcli.main(["--mode", "cfg_sweep", "--patch_dir", "p", "--out_dir", "o",
                   "--int8_bf16_blocks", "conv9"])


def test_quantize_cli_artifact_serves_both_packages(patches, tmp_path):
    """``cli.quantize`` writes the artifact JAX's ``load_quant`` reads with
    the same int8 weights, and ``evaluate --int8_ckpt`` serves it."""
    state_ckpt = tmp_path / "m.msgpack"
    state_ckpt.write_bytes(msgpack_serialize(_nest(init_params(4, 8, 1, seed=0))))
    art = tmp_path / "m.int8.msgpack"
    tquantize.main(["--ckpt", str(state_ckpt), "--patch_dir", patches["dir"], "--out", str(art),
                    "--base_ch", "8", "--n_calib", "3", "--device", "cpu"])
    jqp, tqp = jq.load_quant(str(art)), tq.load_quant(str(art))
    assert len(jqp.w8) == len(tqp.w8) == 12 and len(tqp.act_scale) == 15
    for k, (q, s) in tqp.w8.items():
        np.testing.assert_array_equal(np.asarray(jqp.w8[k.replace(".", "/")][0]), q.numpy())
    _, tcfg = _cfgs(patches, tmp_path, ckpt=None, int8_ckpt=str(art), pred_param="v",
                    t_start=999, ddim_steps=2, guidance_scales=(3.0,), max_files=2)
    res = th.run_mode(tcfg)
    assert np.isfinite(res[3.0])
