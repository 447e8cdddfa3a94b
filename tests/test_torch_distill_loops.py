"""The port's distillation loops (``progressive_distill``,
``endpoint_distill``) against the JAX package's on the same numpy data, the
same flax init and the same draws, at base 8, 32², B=2.

Tolerances. Each loop's epoch losses, snapshots and final student are held
to JAX's own spread, measured in the same test (the distance between JAX's
bf16 and f32 runs of the same loop): the port's f32 run within 1e-2 of it
of JAX's f32 run, its bf16 run within twice it of JAX's bf16 run. The
progress records' counters (phase, budget, epoch, skipped) and the phase
history's shape are equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from s1s2.core import Schedule as JSchedule
from s1s2.models import UNetSmall as JUNet
from s1s2.train import distill as jd
from s1s2_torch.core.schedule import Schedule
from s1s2_torch.models.unet import UNetSmall, init_params
from s1s2_torch.parallel import make_mesh
from s1s2_torch.train import distill, loop

N, B, H, BASE, T = 4, 2, 32, 8, 1000
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
SLACK = {"f32": 1e-2, "bf16": 2.0}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # small convs; the test run has a worker a core
    yield
    torch.set_num_threads(threads)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    n = np.linalg.norm(b)
    return np.linalg.norm(a - b) / n if n else np.linalg.norm(a - b)


def to_jax(params):
    return unflatten_dict({tuple(k.split(".")): jnp.asarray(v.numpy())
                           for k, v in params.items()})


def jflat(tree, names):
    f = flatten_dict(tree)
    return np.concatenate([np.asarray(f[tuple(n.split("."))], np.float32).reshape(-1)
                           for n in names])


def pflat(params, names):
    return np.concatenate([params[n].detach().float().cpu().numpy().reshape(-1) for n in names])


@pytest.fixture(scope="module")
def params():
    return init_params(4, BASE, 1, seed=0, in_ch=8)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(N, H, H, 4)).astype(np.float32),
            rng.uniform(size=(N, H, H, 4)).astype(np.float32),
            (rng.uniform(size=(N, H, H)) > 0.2).astype(np.float32))


def check_spread(runs, keys):
    for k in keys:
        spread = rel(runs["jax", "bf16"][k], runs["jax", "f32"][k])
        for dtype in DTYPES:
            d = rel(runs["port", dtype][k], runs["jax", dtype][k])
            assert d <= SLACK[dtype] * spread, (k, dtype, d, spread)


# ---------------------------------------------------------------------------
# progressive_distill
# ---------------------------------------------------------------------------


def make_batches(data, wrap):
    def batches(phase, epoch):
        order = np.random.default_rng(7 + phase * 10_000 + epoch).permutation(N)
        for lo in range(0, N - B + 1, B):
            yield tuple(wrap(a[order[lo:lo + B]]) for a in data)
    return batches


@pytest.fixture(scope="module")
def progressive(params, data):
    """teacher 4 → students 2, 1; 2 epochs a phase of 2 steps; EMA decay 0.7
    (0.7^4 = 0.24: the debiased regime)."""
    kw = dict(T=T, t_start=200, teacher_steps=4, epochs_per_phase=2, ema_decay=0.7)
    names, out = tuple(params), {}
    for dtype in DTYPES:
        rec = []
        res = jd.progressive_distill(JUNet(out_ch=4, base_ch=BASE,
                                           compute_dtype=DTYPES[dtype][0]).apply,
                                     JSchedule.cosine(T), jd.DistillConfig(**kw), to_jax(params),
                                     make_batches(data, jnp.asarray), progress=rec.append)
        out["jax", dtype] = dict(rec=rec, history=res["phase_history"], steps=res["steps"],
                                 params=jflat(res["params"], names))
        rec = []
        res = distill.progressive_distill(UNetSmall(4, BASE, 1, 8, DTYPES[dtype][1],
                                                    autograd=True),
                                          Schedule.cosine(T), distill.DistillConfig(**kw), params,
                                          make_batches(data, lambda a: a), progress=rec.append,
                                          device="cpu")
        out["port", dtype] = dict(rec=rec, history=res["phase_history"], steps=res["steps"],
                                  params=pflat(res["params"], names))
    p0 = loop.ParamLayout.of(params).flatten(params).numpy()
    for r in out.values():
        r["losses"] = [x["loss"] for x in r["rec"]]
        r["update"] = r["params"] - p0
    return out


def test_progressive_distill_matches_jax_within_its_own_spread(progressive):
    check_spread(progressive, ("losses", "update"))
    counters = lambda r: [(x["phase"], x["student_steps"], x["epoch"], x["skipped"])  # noqa: E731
                          for x in r["rec"]]
    want = [(0, 2, 1, 0), (0, 2, 2, 0), (1, 1, 1, 0), (1, 1, 2, 0)]
    for r in progressive.values():
        assert counters(r) == want and r["steps"] == 1


def test_progressive_distill_phase_history_matches_jax(progressive):
    for dtype in DTYPES:
        got, want = progressive["port", dtype]["history"], progressive["jax", dtype]["history"]
        assert [h["student_steps"] for h in got] == [h["student_steps"] for h in want] == [2, 1]
        assert [len(h["epoch_loss"]) for h in got] == [2, 2]
        assert [x for h in got for x in h["epoch_loss"]] == progressive["port", dtype]["losses"]


def test_loops_on_a_world_1_mesh_are_the_loops_without_one(params, data):
    """With no process group the CLI's mesh is 1×1×1 and every collective is
    skipped: both loops on it equal the loops given no mesh (which run on
    ``local_mesh()``) bit for bit."""
    model = UNetSmall(4, BASE, 1, 8, torch.float32, autograd=True)
    cfg = distill.DistillConfig(T=T, t_start=20, teacher_steps=2, epochs_per_phase=1)
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "space": 1} and mesh.group(("data",)) is None
    prog = [distill.progressive_distill(model, Schedule.cosine(T), cfg, params,
                                        make_batches(data, lambda a: a), mesh=m,
                                        device="cpu")["params"] for m in (None, mesh)]
    ends = [distill.endpoint_distill(model, Schedule.cosine(T), cfg, params, params, *data,
                                     epochs=1, batch_size=2, teacher_steps=2, n_seeds=1,
                                     mesh=m, device="cpu") for m in (None, mesh)]
    for a, b in (prog, ends):
        assert all(torch.equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------------------
# endpoint_distill: a width student (base 4, s2d 2) against the base-8 teacher
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def endpoint(params, data):
    """3 epochs of 4 targets (2 files × 2 seeds) at B=2, teacher ddim-2,
    records every 2 epochs, snapshots every epoch; EMA decay 0.7."""
    kw = dict(T=T, t_start=200, ema_decay=0.7)
    student = init_params(4, 4, 2, seed=2, in_ch=8)
    names, out = tuple(student), {}
    common = dict(epochs=3, batch_size=B, teacher_steps=2, n_seeds=2, log_every=2, seed=5,
                  snapshot_every=1, rollout_chunk=1)
    cond, x0, mask = (a[:2] for a in data)
    for dtype in DTYPES:
        jdt, tdt = DTYPES[dtype]
        rec, snaps = [], []
        res = jd.endpoint_distill(
            JUNet(out_ch=4, base_ch=BASE, compute_dtype=jdt).apply, JSchedule.cosine(T),
            jd.DistillConfig(**kw), to_jax(student), to_jax(params), jnp.asarray(cond),
            jnp.asarray(x0), jnp.asarray(mask), progress=rec.append,
            student_apply_fn=JUNet(out_ch=4, base_ch=4, stem_s2d=2, compute_dtype=jdt).apply,
            snapshot_fn=lambda p, ep: snaps.append((ep, jflat(p, names))), **common)
        out["jax", dtype] = dict(rec=rec, snaps=snaps, params=jflat(res, names))
        rec, snaps = [], []
        res = distill.endpoint_distill(
            UNetSmall(4, BASE, 1, 8, tdt), Schedule.cosine(T), distill.DistillConfig(**kw),
            student, params, cond, x0, mask, progress=rec.append,
            student_model=UNetSmall(4, 4, 2, 8, tdt, autograd=True),
            snapshot_fn=lambda p, ep: snaps.append((ep, pflat(p, names))), device="cpu",
            **common)
        out["port", dtype] = dict(rec=rec, snaps=snaps, params=pflat(res, names))
    p0 = loop.ParamLayout.of(student).flatten(student).numpy()
    for r in out.values():
        r["losses"] = [x["loss"] for x in r["rec"]]
        r["update"] = r["params"] - p0
        r["snap_updates"] = np.stack([s - p0 for _, s in r["snaps"]])
    return out


def test_endpoint_distill_width_student_matches_jax_within_its_own_spread(endpoint):
    check_spread(endpoint, ("losses", "update", "snap_updates"))
    for r in endpoint.values():
        assert [(x["endpoint_epoch"], x["skipped"]) for x in r["rec"]] == [(2, 0), (3, 0)]


def test_endpoint_distill_snapshots_like_jax(endpoint):
    """snapshot_fn gets the debiased EMA at epochs 1 and 2 (not at the last);
    the final student is the debiased EMA after the last epoch."""
    for r in endpoint.values():
        assert [ep for ep, _ in r["snaps"]] == [1, 2]
        assert not np.array_equal(r["snaps"][-1][1], r["params"])
