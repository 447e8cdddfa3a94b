"""s1s2_torch serve on the CPU: the cases of tests/test_serve.py (HTTP
protocol, chunk and pad batching, the bf16 and int8-artifact paths,
concurrent requests), and the responses against the JAX package's server
on the same requests."""

import functools
import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import s1s2.models as jmodels
import s1s2_torch.models.unet as tunet
from s1s2.cli import serve as jserve
from s1s2.models import quant as jq
from s1s2.train.checkpoint import save_model
from s1s2_torch.cli.serve import build_parser, build_server

PS, CC, CT, BCH, T = 16, 4, 4, 4, 10


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port on one torch thread: the test run has a worker a core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A base-4 UNet (flax's init) as a msgpack checkpoint, and its int8
    artifact with int8 up-convs written by the JAX package."""
    d = tmp_path_factory.mktemp("serve")
    params = jmodels.UNetSmall(out_ch=CT, base_ch=BCH).init(
        jax.random.PRNGKey(0), jnp.zeros((1, PS, PS, CC + CT)), jnp.zeros((1,), jnp.int32))["params"]
    ckpt = str(d / "m.msgpack")
    save_model(params, ckpt)
    rng = np.random.default_rng(3)
    calib = [(jnp.asarray(rng.standard_normal((2, PS, PS, CC + CT)), jnp.float32),
              jnp.full((2,), t, jnp.int32)) for t in (T - 1, 5)]
    q_path = str(d / "m.int8.msgpack")
    jq.save_quant(jq.quantize_unet(params, calib, out_ch=CT, base_ch=BCH, quant_up=True), q_path)
    return {"ckpt": ckpt, "int8": q_path}


def _args(parser, extra):
    return parser.parse_args(["--port", "0", "--T", str(T), "--base_ch", str(BCH),
                              "--patch_size", str(PS), "--batch_size", "2", "--steps", "2",
                              "--t_start", str(T - 1)] + extra)


def _start(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def _stop(httpd):
    httpd.shutdown()
    httpd.server_close()


@pytest.fixture
def server(tiny):
    httpd = _start(build_server(_args(build_parser(), ["--ckpt", tiny["ckpt"],
                                                       "--device", "cpu"])))
    yield httpd
    _stop(httpd)


def _url(httpd, path):
    h, p = httpd.server_address[:2]
    return f"http://{h}:{p}{path}"


def _post_npz(httpd, **arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(_url(httpd, "/infer"), data=buf.getvalue(), method="POST")
    return urllib.request.urlopen(req)


def _infer(httpd, cond, seed):
    with _post_npz(httpd, cond=cond, seed=np.int32(seed)) as r:
        return np.load(io.BytesIO(r.read()))


class TestServe:
    def test_healthz(self, server):
        with urllib.request.urlopen(_url(server, "/healthz")) as r:
            info = json.loads(r.read())
        assert info["status"] == "ok"
        assert info["signature"] == {"batch": 2, "patch": PS, "transfer_dtype": "float16"}
        assert info["model"]["int8"] is False
        assert info["device"] == "cpu" and info["requests"] == 0
        parts = info["warmup_parts"]
        assert parts["build_s"] == 0.0 and 0 <= parts["first_call_s"] <= info["warmup_s"]

    def test_unknown_paths_404(self, server):
        for req in (urllib.request.Request(_url(server, "/nope")),
                    urllib.request.Request(_url(server, "/nope"), data=b"x", method="POST")):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req)
            assert e.value.code == 404

    def test_infer_chunks_and_pads(self, server):
        """B=3 through a batch of 2: one full chunk and one padded."""
        cond = np.random.default_rng(0).standard_normal((3, PS, PS, CC)).astype(np.float32)
        out = _infer(server, cond, 7)
        assert out.shape == (3, PS, PS, CT)
        assert out.dtype == np.float32
        assert np.isfinite(out).all()
        with urllib.request.urlopen(_url(server, "/healthz")) as r:
            assert json.loads(r.read())["requests"] == 1

    def test_infer_accepts_hwc_and_nchw(self, server):
        hwc = np.random.default_rng(1).standard_normal((PS, PS, CC)).astype(np.float32)
        with _post_npz(server, cond=hwc) as r:
            out3 = np.load(io.BytesIO(r.read()))
        assert out3.shape == (1, PS, PS, CT)
        nchw = np.transpose(hwc[None], (0, 3, 1, 2))
        with _post_npz(server, cond=nchw) as r:
            out_nchw = np.load(io.BytesIO(r.read()))
        np.testing.assert_allclose(out_nchw, out3, atol=1e-5)

    def test_deterministic_per_seed(self, server):
        cond = np.random.default_rng(2).standard_normal((2, PS, PS, CC)).astype(np.float32)
        outs = [_infer(server, cond, seed) for seed in (3, 3, 4)]
        np.testing.assert_array_equal(outs[0], outs[1])
        assert np.abs(outs[0] - outs[2]).max() > 1e-6

    def test_bad_request_400(self, server):
        for arrays, msg in (({"cond": np.zeros((PS, PS, 7), np.float32)}, "signature"),
                            ({"cond": np.zeros((2, 2), np.float32)}, "3-D or 4-D"),
                            ({"x": np.zeros((PS, PS, CC), np.float32)}, "cond")):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post_npz(server, **arrays)
            assert e.value.code == 400
            assert msg in json.loads(e.value.read())["error"]

    def test_int8_artifact_path(self, tiny):
        """--int8_ckpt: the topology comes from the artifact's meta (the CLI's
        base_ch is ignored); a JAX-written artifact with int8 up-convs."""
        httpd = _start(build_server(_args(build_parser(), ["--int8_ckpt", tiny["int8"],
                                                           "--base_ch", "96",
                                                           "--device", "cpu"])))
        try:
            with urllib.request.urlopen(_url(httpd, "/healthz")) as r:
                info = json.loads(r.read())
            assert info["model"]["int8"] is True
            assert info["model"]["base_ch"] == BCH
            out = _infer(httpd, np.zeros((1, PS, PS, CC), np.float32), 0)
            assert out.shape == (1, PS, PS, CT)
            assert np.isfinite(out).all()
        finally:
            _stop(httpd)

    def test_missing_ckpt_exits(self):
        with pytest.raises(SystemExit):
            build_server(_args(build_parser(), ["--device", "cpu"]))

    def test_needs_a_card_unless_told_cpu(self, tiny):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises((RuntimeError, AssertionError)):
            build_server(_args(build_parser(), ["--ckpt", tiny["ckpt"]]))

    def test_concurrent_requests_pipeline_correctly(self, server):
        """Chunks of concurrent clients interleave (the lock covers only their
        enqueue); each result is bit-identical to the same request made
        alone: the per-(seed, chunk offset) noise does not depend on order."""
        rng = np.random.default_rng(5)
        conds = [rng.standard_normal((5, PS, PS, CC)).astype(np.float32) for _ in range(4)]
        seq = [_infer(server, c, 100 + k) for k, c in enumerate(conds)]
        results = [None] * len(conds)
        errs = []

        def client(k):
            try:
                results[k] = _infer(server, conds[k], 100 + k)
            except Exception as e:  # surfaced in the main thread
                errs.append(e)

        ths = [threading.Thread(target=client, args=(k,)) for k in range(len(conds))]
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        assert not errs, errs
        for k in range(len(conds)):
            np.testing.assert_array_equal(results[k], seq[k])


def _both(tiny, extra, jax_dtype=jnp.bfloat16, port_dtype=torch.bfloat16):
    """(JAX server, port server) on the same flags, their UNetSmall in the
    given compute types."""
    orig, torig = jmodels.UNetSmall, tunet.load_unet
    jmodels.UNetSmall = functools.partial(orig, compute_dtype=jax_dtype)
    tunet.load_unet = functools.partial(torig, compute_dtype=port_dtype)
    try:
        j = _start(jserve.build_server(_args(jserve.build_parser(), extra)))
        t = _start(build_server(_args(build_parser(), extra + ["--device", "cpu"])))
    finally:
        jmodels.UNetSmall, tunet.load_unet = orig, torig
    return j, t


@pytest.mark.parametrize("flags", [[], ["--pred_param", "eps", "--solver", "dpm2m"],
                                   ["--guidance_scale", "2.5"]],
                         ids=["v_ddim", "eps_dpm2m", "v_cfg"])
def test_responses_equal_the_jax_server(tiny, flags):
    """The same request (B=3: a padded chunk; seed 11) to both servers, f32
    transfers: the port draws the JAX server's threefry noise on the CPU, so
    in f32 the responses are within 1e-4, and in bf16 within the JAX bf16
    response's own distance to its f32 one."""
    cond = np.random.default_rng(8).standard_normal((3, PS, PS, CC)).astype(np.float32)
    extra = ["--ckpt", tiny["ckpt"], "--transfer_dtype", "float32"] + flags
    out = {}
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        j, t = _both(tiny, extra, jdt, dt)
        try:
            out[dt] = (_infer(j, cond, 11), _infer(t, cond, 11))
        finally:
            _stop(j)
            _stop(t)
    j32, t32 = out[torch.float32]
    j16, t16 = out[torch.bfloat16]
    assert np.abs(t32 - j32).max() <= 1e-4
    gap, d = np.abs(j16 - j32), np.abs(t16 - j16)
    assert d.mean() <= gap.mean() and d.max() <= gap.max(), (d.mean(), gap.mean())


def test_int8_artifact_responses_equal_the_jax_server(tiny):
    """The JAX-written quant_up artifact served by both packages, the f16
    transfers of the default: the same response within the int8 forward's
    own distance to the bf16 net (JAX's mean |int8 − bf16| on the request)."""
    cond = np.random.default_rng(9).standard_normal((2, PS, PS, CC)).astype(np.float32)
    j, t = _both(tiny, ["--int8_ckpt", tiny["int8"]])
    jb, _ = _both(tiny, ["--ckpt", tiny["ckpt"]])
    try:
        a, b, ref16 = _infer(j, cond, 4), _infer(t, cond, 4), _infer(jb, cond, 4)
    finally:
        for h in (j, t, jb, _):
            _stop(h)
    assert np.isfinite(b).all()
    assert np.abs(b - a).mean() <= np.abs(a - ref16).mean()


def test_the_port_quantize_cli_artifact_serves(tiny, tmp_path):
    """The port's own quantize CLI on a synthetic patch set, served by the port."""
    from s1s2_torch.cli.quantize import main as quantize
    from s1s2_torch.data.synthetic import make_synthetic_patches

    make_synthetic_patches(str(tmp_path / "p"), n=2, size=PS, seed=0)
    q = str(tmp_path / "q.int8.msgpack")
    quantize(["--ckpt", tiny["ckpt"], "--patch_dir", str(tmp_path / "p"), "--out", q,
              "--base_ch", str(BCH), "--T", str(T), "--t_start", str(T - 1), "--device", "cpu"])
    httpd = _start(build_server(_args(build_parser(), ["--int8_ckpt", q, "--device", "cpu"])))
    try:
        out = _infer(httpd, np.zeros((3, PS, PS, CC), np.float32), 1)
        assert out.shape == (3, PS, PS, CT) and np.isfinite(out).all()
    finally:
        _stop(httpd)


def test_bench_serve_phases_on_the_cpu(tiny):
    """tools/bench_serve at a tiny size: its four phases, each a row."""
    from s1s2_torch.tools import bench_serve

    rows = bench_serve.main(["--ckpt", tiny["ckpt"], "--base_ch", str(BCH), "--patch_size",
                             str(PS), "--batch", "2", "--n_lat", "3", "--sat_seconds", "0.3",
                             "--threads", "2", "--device", "cpu"], emit=lambda _: None)
    assert [r["phase"] for r in rows] == ["latency_b1", "latency_b2", "saturated",
                                          "device_only"]
    assert all(r["patches_per_s"] > 0 and r["device"] == "cpu" for r in rows)
    assert rows[2]["requests"] >= 1
