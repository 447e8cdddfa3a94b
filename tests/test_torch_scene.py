"""s1s2_torch eval/scene.py: the cases of tests/test_scene.py on the port,
and the tiles, feather window, normalization and stitching against the JAX
package's eval/scene.py on the same inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s1s2.eval import scene as js
from s1s2_torch.data.patchify import zscore
from s1s2_torch.eval.scene import (device_stitch, feather_window, infer_scene, normalize_tile,
                                   tile_coords, upload)


class TestTiling:
    def test_edge_snap_covers_scene(self):
        coords = tile_coords(100, 70, 32, 24)
        cover = np.zeros((100, 70), bool)
        for r, c in coords:
            assert r + 32 <= 100 and c + 32 <= 70
            cover[r:r + 32, c:c + 32] = True
        assert cover.all()

    def test_exact_fit(self):
        assert tile_coords(64, 64, 64, 64) == [(0, 0)]

    def test_feather_positive_symmetric(self):
        w = feather_window(16)
        assert (w > 0).all()
        np.testing.assert_allclose(w, w[::-1], atol=1e-6)
        np.testing.assert_allclose(w, w.T, atol=1e-6)

    @pytest.mark.parametrize("H,W,ps,stride", [(100, 70, 32, 24), (64, 64, 64, 64),
                                                (1536, 1536, 256, 192), (384, 384, 256, 192),
                                                (257, 300, 256, 256)])
    def test_tiles_equal_jax(self, H, W, ps, stride):
        assert tile_coords(H, W, ps, stride) == js.tile_coords(H, W, ps, stride)

    @pytest.mark.parametrize("ps,power", [(16, 1.0), (256, 1.0), (32, 2.0)])
    def test_feather_window_equals_jax(self, ps, power):
        w = feather_window(ps, power)
        assert w.dtype == np.float32
        np.testing.assert_array_equal(w, js.feather_window(ps, power))


class TestNormalize:
    def test_normalize_tile_path(self):
        rng = np.random.default_rng(1)
        tile = rng.normal(-10, 4, (32, 32, 4)).astype(np.float32)
        mask = np.ones((32, 32), np.float32)
        out = normalize_tile(tile, mask)
        assert abs(out[..., 0].mean()) < 1e-4  # z-scored HH
        assert np.isfinite(out).all()

    @pytest.mark.parametrize("masked", [False, True])
    def test_normalize_tile_equals_jax_with_nans_and_a_mask(self, masked):
        rng = np.random.default_rng(2)
        tile = rng.normal(-10, 4, (32, 32, 4)).astype(np.float32)
        tile[3, 4, 0] = tile[5, 6, 2] = np.nan
        tile[7, 8, 3] = np.inf
        mask = (rng.random((32, 32)) > 0.3).astype(np.float32) if masked else None
        np.testing.assert_array_equal(normalize_tile(tile, mask), js.normalize_tile(tile, mask))

    def test_zscore_equals_jax_edge_cases(self):
        from s1s2.data.patchify import zscore as jz

        x = np.random.default_rng(3).normal(5, 2, (8, 8)).astype(np.float32)
        for a, m in ((x, None), (x, np.zeros((8, 8), bool)), (np.full((8, 8), 3.0), None),
                     (np.full((8, 8), np.nan), None), (x, x > 5)):
            np.testing.assert_array_equal(zscore(a, m), jz(a, m))


class TestInferScene:
    def test_constant_predictor_stitches_exactly(self):
        pred = lambda cond, noise: np.full((cond.shape[0], 32, 32, 4), 0.25, np.float32)  # noqa: E731
        cond = np.zeros((80, 96, 4), np.float32)
        out = infer_scene(pred, cond, out_ch=4, ps=32, stride=24, batch_size=3)
        assert out.shape == (80, 96, 4)
        np.testing.assert_allclose(out, 0.25, atol=1e-6)

    def test_mean_of_cond_predictor_blends_smoothly(self):
        # the predictor echoes its conditioning → the stitched output ≈ the scene
        pred = lambda cond, noise: torch.from_numpy(cond[..., :4].copy())  # noqa: E731
        base = np.random.default_rng(0).standard_normal((8, 8, 4)).astype(np.float32)
        cond = np.asarray(jax.image.resize(jnp.asarray(base), (96, 96, 4), "linear"))
        out = infer_scene(pred, cond, out_ch=4, ps=32, stride=16, batch_size=4)
        np.testing.assert_allclose(out, cond, atol=1e-4)

    def test_scene_smaller_than_patch_raises(self):
        with pytest.raises(ValueError):
            infer_scene(lambda c, n: c, np.zeros((16, 16, 4), np.float32), out_ch=4, ps=32)

    def test_stride_above_patch_raises(self):
        with pytest.raises(ValueError, match="stride"):
            infer_scene(lambda c, n: c, np.zeros((64, 64, 4), np.float32), out_ch=4, ps=32,
                        stride=40)

    def test_host_noise_and_stitch_equal_jax(self):
        """The same predictor through both packages' infer_scene: the noise
        (default_rng(seed) per batch) and the blend are the same bits; a
        normalized scene with a mask and a padded last batch."""
        rng = np.random.default_rng(6)
        scene = rng.normal(-8, 3, (80, 96, 4)).astype(np.float32)
        mask = (rng.random((80, 96)) > 0.1).astype(np.float32)
        seen = {"jax": [], "port": []}

        def pred(tag):
            def fn(cond_b, noise_b):
                seen[tag].append((cond_b.copy(), noise_b.copy()))
                return cond_b[..., :4] * 0.5 + 0.1 * noise_b
            return fn

        kw = dict(out_ch=4, ps=32, stride=24, batch_size=5, mask_scene=mask, normalize=True,
                  rng_seed=9)
        a = js.infer_scene(pred("jax"), scene, **kw)
        b = infer_scene(pred("port"), scene, **kw)
        assert len(seen["jax"]) == len(seen["port"]) == 3  # 12 tiles, the last batch padded
        for (jc, jn), (tc, tn) in zip(seen["jax"], seen["port"]):
            np.testing.assert_array_equal(tc, jc)
            np.testing.assert_array_equal(tn, jn)
        np.testing.assert_array_equal(b, a)


class TestFastTransfer:
    def test_device_noise_and_pipeline_equivalence(self):
        """noise='device' passes (B,) int32 seeds; the pipeline depth does
        not change the stitched output (dispatch order is kept)."""
        calls = []

        def pred(cond_b, seeds_b):
            assert seeds_b.dtype == np.int32 and seeds_b.ndim == 1
            calls.append(seeds_b.copy())
            g = torch.Generator().manual_seed(int(seeds_b[0]))
            noise = torch.randn(cond_b.shape[:3] + (4,), generator=g)
            return torch.from_numpy(cond_b.astype(np.float32)) * 0.5 + 0.01 * noise

        scene = np.random.default_rng(0).standard_normal((64, 64, 4)).astype(np.float32)
        out1 = infer_scene(pred, scene, out_ch=4, ps=32, stride=16, batch_size=3,
                           noise="device", rng_seed=7)
        out3 = infer_scene(pred, scene, out_ch=4, ps=32, stride=16, batch_size=3,
                           noise="device", rng_seed=7, pipeline=3)
        np.testing.assert_array_equal(out1, out3)
        # seeds deterministic in rng_seed and tile index
        assert all((c >= 7 * (1 << 20)).all() for c in calls)

    def test_device_seeds_equal_jax(self):
        seen = {"jax": [], "port": []}

        def pred(tag):
            def fn(cond_b, seeds_b):
                seen[tag].append(seeds_b.copy())
                return np.zeros(cond_b.shape[:3] + (4,), np.float32)
            return fn

        scene = np.zeros((64, 80, 4), np.float32)
        for seed in (7, 3000):  # a large seed wraps into 31 bits
            kw = dict(out_ch=4, ps=32, stride=16, batch_size=4, noise="device", rng_seed=seed)
            js.infer_scene(pred("jax"), scene, **kw)
            infer_scene(pred("port"), scene, **kw)
        for a, b in zip(seen["jax"], seen["port"]):
            np.testing.assert_array_equal(b, a)

    def test_f16_transfer_dtype(self):
        seen = {}

        def pred(cond_b, noise_b):
            seen["dtype"] = cond_b.dtype
            return cond_b.astype(np.float32) * 0.0 + 0.5

        scene = np.zeros((32, 32, 4), np.float32)
        out = infer_scene(pred, scene, out_ch=4, ps=32, stride=32, batch_size=1,
                          transfer_dtype=np.float16)
        assert seen["dtype"] == np.float16
        np.testing.assert_allclose(out, 0.5, atol=1e-6)


class TestDeviceStitch:
    def test_device_stitch_matches_host(self):
        """stitch='device' reproduces the host feather-stitch to f32 rounding
        (here bit for bit: the same products in the same order), with
        edge-snapped overlapping tiles and a padded final batch."""
        def pred(cond_b, noise_b):
            return torch.from_numpy(cond_b[..., :4] * 0.5 + 0.1)

        scene = np.random.default_rng(3).standard_normal((80, 96, 4)).astype(np.float32)
        host = infer_scene(pred, scene, out_ch=4, ps=32, stride=24, batch_size=3, stitch="host")
        dev = infer_scene(pred, scene, out_ch=4, ps=32, stride=24, batch_size=3, stitch="device")
        np.testing.assert_allclose(dev, host, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(dev, host)

    def test_device_stitch_with_pipeline_and_device_noise(self):
        def pred(cond_b, seeds_b):
            g = torch.Generator().manual_seed(int(seeds_b[0]))
            noise = torch.randn(cond_b.shape[:3] + (4,), generator=g)
            return torch.from_numpy(cond_b.astype(np.float32)) * 0.5 + 0.01 * noise

        scene = np.random.default_rng(4).standard_normal((64, 64, 4)).astype(np.float32)
        host = infer_scene(pred, scene, out_ch=4, ps=32, stride=16, batch_size=3,
                           noise="device", rng_seed=7)
        dev = infer_scene(pred, scene, out_ch=4, ps=32, stride=16, batch_size=3,
                          noise="device", rng_seed=7, pipeline=3, stitch="device")
        np.testing.assert_allclose(dev, host, rtol=0, atol=1e-5)

    def test_device_stitch_equals_jax_device_stitch(self):
        """The port's device stitch against the JAX package's (its lax.scan
        scatter-add) on the same predictions: equal to f32 rounding."""
        def pred(cond_b, noise_b):
            return np.tanh(cond_b[..., :4]) * 0.5 + 0.25

        scene = np.random.default_rng(5).standard_normal((80, 96, 4)).astype(np.float32)
        kw = dict(out_ch=4, ps=32, stride=24, batch_size=3, stitch="device")
        a = js.infer_scene(lambda c, n: jnp.asarray(pred(c, n)), scene, **kw)
        b = infer_scene(lambda c, n: torch.from_numpy(pred(c, n)), scene, **kw)
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)

    def test_device_stitch_adds_tiles_in_batch_order(self):
        """Two overlapping tiles of one batch both land (no race, no lost
        update) and the padding rows after the valid ones are left out."""
        acc = torch.zeros((4, 6, 1))
        win = torch.ones((4, 4, 1))
        pred = torch.stack([torch.full((4, 4, 1), 1.0), torch.full((4, 4, 1), 2.0),
                            torch.full((4, 4, 1), 100.0)])
        device_stitch(acc, pred, [(0, 0), (0, 2)], win)
        np.testing.assert_array_equal(acc[0, :, 0].numpy(), [1, 1, 3, 3, 2, 2])

    def test_device_stitch_f16_final_download(self):
        """With a wire dtype the scene-sized accumulator comes back in f16;
        the values stay within f16 rounding of the host stitch."""
        def pred(cond_b, noise_b):
            return torch.from_numpy(cond_b.astype(np.float32))[..., :4] * 0.5 + 0.1

        scene = np.random.default_rng(5).standard_normal((64, 80, 4)).astype(np.float32)
        host = infer_scene(pred, scene, out_ch=4, ps=32, stride=24, batch_size=3, stitch="host")
        dev = infer_scene(pred, scene, out_ch=4, ps=32, stride=24, batch_size=3,
                          stitch="device", transfer_dtype=np.float16)
        assert dev.dtype == np.float32
        # both wire precisions: the f16 cond upload and the f16 accumulator
        np.testing.assert_allclose(dev, host, rtol=1e-2, atol=1e-2)

    def test_bad_stitch_value_raises(self):
        with pytest.raises(ValueError):
            infer_scene(lambda c, n: c, np.zeros((32, 32, 4), np.float32), out_ch=4, ps=32,
                        stitch="gpu")

    def test_bad_noise_value_raises(self):
        with pytest.raises(ValueError):
            infer_scene(lambda c, n: c, np.zeros((32, 32, 4), np.float32), out_ch=4, ps=32,
                        noise="gpu")


def test_upload_on_the_cpu_is_the_array():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = upload(a, "cpu")
    assert t.dtype == torch.float32 and np.array_equal(t.numpy(), a)


@pytest.mark.parametrize("modes,labels", [
    ("all", ["host-noise f32", "device-noise f32", "device-noise f16-transfer",
             "device-noise f16 both ways", "f16 both + pipeline-3",
             "device-stitch + pipeline-3"]),
    ("cli", ["host-noise f32 (the CLI's default)",
             "host-noise f32, device-stitch (--stitch device)",
             "f16 both + pipeline-3 (--fast_transfer)"])])
def test_bench_scene_rows_on_the_cpu(modes, labels):
    """tools/bench_scene at a small size (base 8, an 80² scene of 32² tiles):
    one row per mode with the scene's seconds and tiles/s."""
    from s1s2_torch.tools import bench_scene

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rows = bench_scene.main(["--size", "80", "--patch", "32", "--stride", "24", "--batch",
                                 "4", "--base_ch", "8", "--repeats", "1", "--modes", modes,
                                 "--precision", "bf16" if modes == "cli" else "int8",
                                 "--solver", "ddim" if modes == "cli" else "dpm2m",
                                 "--steps", "2", "--device", "cpu"], emit=lambda _: None)
    finally:
        torch.set_num_threads(threads)
    assert [r["mode"] for r in rows] == labels
    assert all(r["tiles"] == 9 and r["scene_seconds"] > 0 and r["tiles_per_s"] > 0
               for r in rows)
