"""The port's sharded train step and sampler on a 4-rank Gloo cluster on the
CPU (``tests/_torch_mesh_worker.py``, one process a rank, torchrun's
environment), against the single-process port and the JAX package.

Bounds (JAX's own for the same meshes):
* data parallel over 2 and 4 ranks: the loss to rel 1e-5 and the params to
  atol 1e-5 of the single-process step (``tests/test_parallel.py``); and the
  4-rank step against JAX's 8-device data-parallel step on the same inputs
  within 1e-2 of JAX's own bf16-vs-f32 distance (the bound of the port's f32
  step against JAX's, ``tests/test_torch_train.py``);
* data 2 × space 2 at 32², and space 2 × model 2 with recomputed blocks:
  the params within atol 1e-5 of the unsharded step (JAX only checks that
  a space mesh runs);
* data 2 × model 2 and model 4: the step and ``ddim_anchored`` within
  rtol 2e-4 / atol 2e-5 of the replicated ones
  (``tests/test_tensor_parallel.py``), each rank holding 1/model of the
  ``inc`` kernel's output channels.
Every rank of a mesh reports the same loss, and a batch that is not finite
on one rank is skipped by all.
"""

import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from s1s2.core import Schedule as JSchedule
from s1s2.models import UNetSmall as JUNet
from s1s2.parallel import make_mesh as jmake_mesh
from s1s2.parallel import shard_batch as jshard_batch
from s1s2.parallel import shard_train_step as jshard_train_step
from s1s2.train import loop as jloop
from s1s2_torch.models.unet import UNetSmall
from s1s2_torch.sampling.samplers import ddim_anchored, make_denoise_fn
from s1s2_torch.train import loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
import _torch_mesh_worker as W  # noqa: E402

WORLD = 4


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(n, argv, timeout=300):
    """``argv`` on ``n`` ranks; → each rank's (return code, output)."""
    port = free_port()
    procs = []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO)
        env.pop("XLA_FLAGS", None)
        procs.append(subprocess.Popen([sys.executable] + argv, cwd=REPO, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, o) for p, o in zip(procs, outs)]


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_cluster")
    ranks = run_world(WORLD, [os.path.join(REPO, "tests", "_torch_mesh_worker.py"), str(out),
                              *W.SCENARIOS])
    for rc, text in ranks:
        assert rc == 0 and "WORKER_OK" in text, text[-3000:]

    def load(name):
        got = {}
        for r in range(WORLD):
            path = out / f"{name}_r{r}.npz"
            if path.exists():
                got[r] = dict(np.load(path))
        return got

    return load


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # small convs; the test run has a worker a core
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def single():
    """Each scenario's step (and sample) in one process, no mesh."""
    out = {}
    for name in W.SCENARIOS:
        params, cfg, schedule, batch, noise = W.setup(name)
        base = W.SCENARIOS[name][1]
        net = UNetSmall(4, base, 1, 8, torch.float32, autograd=True)
        state = loop.create_train_state(params, cfg)
        state, m = loop.make_train_step(net, schedule, cfg, draws="threefry")(state, batch,
                                                                               W.KEY)
        r = dict(loss=float(m["loss"]), params=state.params.numpy())
        if W.SCENARIOS[name][0][2] > 1 and W.SCENARIOS[name][0][1] == 1:
            infer = UNetSmall(4, base, 1, 8, torch.float32)
            infer.load_state_dict(params)
            r["sample"] = ddim_anchored(make_denoise_fn(infer, torch.from_numpy(batch[0])),
                                        torch.from_numpy(batch[1]), schedule,
                                        noise=torch.from_numpy(noise), **W.SAMPLE).numpy()
        out[name] = r
    return out


@pytest.mark.parametrize("name,ranks", [("dp4", 4), ("dp2", 2), ("ds", 4), ("dm", 4), ("m4", 4),
                                        ("sm", 4)])
def test_every_rank_of_the_mesh_reports_the_same_loss(cluster, name, ranks):
    got = cluster(name)
    assert sorted(got) == list(range(ranks))  # dp2 leaves ranks 2 and 3 idle
    losses = {float(g["loss"]) for g in got.values()}
    assert len(losses) == 1 and np.isfinite(losses.pop())
    assert all(int(g["skipped"]) == 0 for g in got.values())
    for g in got.values():
        np.testing.assert_array_equal(g["params"], got[0]["params"])


def test_a_non_finite_batch_on_one_rank_is_skipped_by_every_rank(cluster):
    """The NaN lies in data rank 0's rows only; the skip is decided by all
    ranks together, so no replica parts from the other."""
    params = W.setup("nan")[0]
    p0 = np.concatenate([v.numpy().reshape(-1) for v in params.values()])
    got = cluster("nan")
    assert sorted(got) == [0, 1]
    for g in got.values():
        assert int(g["skipped"]) == 1 and np.isnan(float(g["loss"]))
        np.testing.assert_array_equal(g["params"], p0)
        np.testing.assert_array_equal(g["ema"], p0)


@pytest.mark.parametrize("name", ["dp4", "dp2"])
def test_data_parallel_equals_the_single_process_step(cluster, single, name):
    got, want = cluster(name)[0], single[name]
    assert float(got["loss"]) == pytest.approx(want["loss"], rel=1e-5)
    np.testing.assert_allclose(got["params"], want["params"], atol=1e-5)


@pytest.mark.parametrize("name", ["ds", "sm"])
def test_space_mesh_equals_the_unsharded_step(cluster, single, name):
    """data 2 × space 2, and space 2 × model 2 with recomputed blocks."""
    got, want = cluster(name)[0], single[name]
    assert float(got["loss"]) == pytest.approx(want["loss"], rel=1e-5)
    np.testing.assert_allclose(got["params"], want["params"], atol=1e-5)


@pytest.mark.parametrize("name", ["dm", "m4"])
def test_tensor_parallel_step_equals_the_replicated_step(cluster, single, name):
    got, want = cluster(name)[0], single[name]
    np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["params"], want["params"], rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("name", ["dm", "m4"])
def test_tensor_parallel_sampler_equals_the_replicated_sampler(cluster, single, name):
    np.testing.assert_allclose(cluster(name)[0]["sample"], single[name]["sample"], rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("name,model", [("dm", 2), ("m4", 4), ("dp4", 1)])
def test_each_rank_holds_its_share_of_the_inc_kernel(cluster, name, model):
    base = W.SCENARIOS[name][1]
    for g in cluster(name).values():
        assert tuple(g["inc_shape"]) == (3, 3, 9, base // model)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_data_parallel_step_is_jax_8_device_step_within_its_own_spread(cluster, single):
    """JAX's 8-device data-parallel step (XLA's psum) in f32 and bf16 on the
    inputs of ``dp4``; the port's 4-rank step's update within 1e-2 of JAX's
    bf16-vs-f32 distance of JAX's f32 update."""
    params, cfg, _, batch, _ = W.setup("dp4")
    names = tuple(params)
    jparams = unflatten_dict({tuple(k.split(".")): jnp.asarray(v.numpy())
                              for k, v in params.items()})
    jcfg = jloop.TrainConfig(T=cfg.T, t_sampler=cfg.t_sampler, lr=cfg.lr)
    mesh = jmake_mesh()
    assert dict(mesh.shape) == {"data": 8, "space": 1}
    updates, losses = {}, {}
    p0 = np.concatenate([params[n].numpy().reshape(-1) for n in names])
    for tag, dtype in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        model = JUNet(out_ch=4, base_ch=W.SCENARIOS["dp4"][1], compute_dtype=dtype)
        step = jshard_train_step(jloop.make_train_step(model.apply, JSchedule.cosine(cfg.T),
                                                       jcfg), mesh)
        state, m = step(jloop.create_train_state(jparams, jcfg), jshard_batch(batch, mesh),
                        jnp.asarray(W.KEY))
        flat = flatten_dict(state.params)
        updates[tag] = np.concatenate([np.asarray(flat[tuple(n.split("."))]).reshape(-1)
                                       for n in names]) - p0
        losses[tag] = float(m["loss"])
    spread = rel(updates["bf16"], updates["f32"])
    got = cluster("dp4")[0]
    assert rel(got["params"] - p0, updates["f32"]) <= 1e-2 * spread
    assert abs(float(got["loss"]) - losses["f32"]) <= 1e-2 * abs(losses["bf16"] - losses["f32"])
