"""The port's device mesh (``s1s2_torch.parallel``) in one process, against
the JAX package's ``s1s2.parallel`` on the 8-device virtual CPU mesh.

The shape rules are exact: the same axis sizes for the same world and
batch, ``ValueError`` where JAX raises, the same leaves sharded by the
tensor-parallel rule, the same loader rows at each mesh coordinate. Without
a process group every collective is skipped, so the mesh at world 1 is the
single-device path: a step or loop given no mesh runs on the 1×1×1 mesh. The runs across processes are in
``tests/test_torch_mesh_cluster.py`` and ``tests/test_torch_mesh_cli.py``.
"""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from s1s2.data.loader import batch_iterator as jbatch_iterator
from s1s2.parallel import make_mesh as jmake_mesh
from s1s2.parallel import make_mesh_for_batch as jmake_mesh_for_batch
from s1s2.parallel import tp_sharding_tree as jtp_sharding_tree
from s1s2_torch import parallel
from s1s2_torch.data.dataset import NpzPatchDataset
from s1s2_torch.data.loader import batch_iterator
from s1s2_torch.data.synthetic import make_synthetic_patches
from s1s2_torch.eval.harness import EvalContext
from s1s2_torch.models.unet import UNetSmall, init_params
from s1s2_torch.parallel import mesh as pmesh

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs the 8-device virtual mesh")


def sizes(shape):
    return tuple(int(shape.get(a, 1)) for a in ("data", "space", "model"))


MESHES = [(8, None, 1, 1), (8, None, 2, 1), (8, 2, 1, 4), (8, None, 1, 4), (8, None, 2, 2),
          (8, 4, 2, 1), (6, None, 1, 3), (4, 1, 1, 4), (2, None, 1, 2), (1, None, 1, 1)]


@pytest.mark.parametrize("n,data,space,model", MESHES)
def test_make_mesh_gives_jax_axis_sizes(n, data, space, model):
    want = jmake_mesh(data, space, model, devices=jax.devices()[:n])
    got = parallel.make_mesh(data, space, model, devices=range(n))
    assert sizes(got.shape) == sizes(want.shape)
    assert got.shape == {k: int(v) for k, v in want.shape.items()}
    # rank r sits at (d, s, m) with r = (d·space + s)·model + m, JAX's reshape
    assert got.coords == (0, 0, 0) and got.ranks == tuple(range(n))


@pytest.mark.parametrize("n,data,space,model", [(8, 3, 1, 4), (8, 3, 1, 1), (8, None, 3, 1),
                                                (4, 2, 2, 2), (1, None, 2, 1), (1, None, 1, 2)])
def test_make_mesh_raises_where_jax_raises(n, data, space, model):
    with pytest.raises(ValueError, match="devices"):
        jmake_mesh(data, space, model, devices=jax.devices()[:n])
    with pytest.raises(ValueError, match=f"mesh .*x{space}x{model} != {n} devices"):
        parallel.make_mesh(data, space, model, devices=range(n))


@pytest.mark.parametrize("n,batch,space,model", [(8, 8, 1, 1), (8, 6, 1, 1), (8, 4, 2, 1),
                                                 (8, 5, 1, 1), (8, 12, 1, 2), (8, 7, 2, 2),
                                                 (3, 4, 1, 1), (1, 4, 1, 1)])
def test_make_mesh_for_batch_gives_jax_axis_sizes(n, batch, space, model):
    want = jmake_mesh_for_batch(batch, space, model, devices=jax.devices()[:n])
    got = parallel.make_mesh_for_batch(batch, space, model, devices=range(n))
    assert sizes(got.shape) == sizes(want.shape)
    # the ranks left over are idle: the mesh holds the first data·space·model
    assert got.ranks == tuple(range(int(np.prod(sizes(want.shape)))))


def test_make_mesh_for_batch_leaves_a_rank_idle():
    mesh = parallel.make_mesh_for_batch(4, devices=[5, 6, 7])  # this process is rank 0
    assert mesh.data == 2 and mesh.ranks == (5, 6) and not mesh.active


@pytest.mark.parametrize("model", [2, 3, 4, 8])
def test_tp_sharding_tree_shards_the_leaves_jax_shards(model):
    params = init_params(4, 8, 1, seed=0, in_ch=8)
    n = model * (8 // model)
    jmesh = jmake_mesh(8 // model, 1, model, devices=jax.devices()[:n])
    tree = {k: np.zeros(tuple(v.shape), np.float32) for k, v in params.items()}
    want = jtp_sharding_tree(tree, jmesh)
    got = parallel.tp_sharding_tree(params, parallel.make_mesh(8 // model, 1, model,
                                                               devices=range(n)))
    for k in params:
        j_sharded = "model" in tuple(want[k].spec)
        assert (got[k] is not None) == j_sharded, k
        if j_sharded:  # rank 0 keeps the first 1/model of the last dimension
            assert got[k] == slice(0, params[k].shape[-1] // model)


def test_tp_rule_keeps_one_slice_per_rank_and_registers_it():
    params = init_params(4, 8, 1, seed=0, in_ch=8)
    mesh = parallel.make_mesh(1, 1, 4, devices=[3, 1, 2, 0])  # rank 0 is model coordinate 3
    assert mesh.coords == (0, 0, 3)
    net = UNetSmall(4, 8, 1, 8, torch.float32, mesh=mesh)
    local = {k: mesh.param_slice(v) for k, v in params.items()}
    net.load_state_dict(local)  # the registered shapes are the slices'
    assert tuple(net.inc.kernel.shape) == (3, 3, 9, 2)
    assert torch.equal(net.inc.kernel, params["inc.kernel"][..., 6:8])
    assert torch.equal(net.outc.bias, params["outc.bias"][3:4])


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_patches")
    make_synthetic_patches(str(d), n=12, size=8, seed=3)
    return NpzPatchDataset(str(d))


@pytest.mark.parametrize("data,space,model", [(2, 1, 2), (4, 1, 1), (2, 2, 1), (1, 2, 2)])
def test_batch_iterator_rows_at_each_coordinate_are_jax_process_rows(ds, data, space, model):
    """Under a mesh the loader takes the rank's data coordinate and the data
    axis's size (as the trainer and the distill CLI pass them), as JAX's
    process slice is ``jax.process_index()``'s: ranks that differ only in
    space or model take the same rows."""
    n = data * space * model
    for pos in range(n):
        ranks = [r for r in range(1, n + 1)]
        ranks[pos] = 0  # this process sits at position pos of the grid
        mesh = parallel.make_mesh(data, space, model, devices=ranks)
        d = pos // (space * model)
        assert mesh.coord("data") == d
        got = list(batch_iterator(ds, 4, seed=9, epoch=2, prefetch=False,
                                  process_index=mesh.coord("data"), process_count=mesh.data))
        want = list(jbatch_iterator(ds, 4, seed=9, epoch=2, prefetch=False,
                                    process_index=d, process_count=data))
        assert len(got) == len(want) and len(got) >= 2
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


def test_batch_iterator_without_a_mesh_takes_the_whole_batch(ds):
    got = list(batch_iterator(ds, 4, seed=1, prefetch=False))
    want = list(jbatch_iterator(ds, 4, seed=1, prefetch=False, process_index=0,
                                process_count=1))
    assert [g[0].shape[0] for g in got] == [4, 4, 4]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[1], w[1])


def test_shard_batch_cuts_the_space_rows():
    mesh = parallel.make_mesh(1, 2, 1, devices=[1, 0])  # space coordinate 1
    x = np.arange(2 * 8 * 4 * 3, dtype=np.float32).reshape(2, 8, 4, 3)
    m = np.ones((2, 8, 4), np.float32)
    cx, cm = parallel.shard_batch((x, m), mesh, spatial=True)
    np.testing.assert_array_equal(cx, x[:, 4:])
    assert cm.shape == (2, 4, 4)
    assert parallel.shard_batch((x, m), mesh)[0] is x


def test_rows_of_a_batch_that_does_not_divide_raise():
    mesh = parallel.make_mesh(2, 1, 1, devices=[0, 1])
    assert mesh.rows(8) == slice(0, 4)
    with pytest.raises(ValueError, match="not divisible by mesh data=2"):
        mesh.rows(7)
    wrapped = parallel.shard_predict_batch(lambda c, n, rows: c[rows], mesh)
    with pytest.raises(ValueError, match="tile batch 3 not divisible by mesh data=2"):
        wrapped(np.zeros((3, 2, 2, 1)), np.zeros((3, 2, 2, 1)))


def test_shard_train_step_needs_a_template_on_a_model_axis():
    mesh = parallel.make_mesh(1, 1, 2, devices=[0, 1])
    with pytest.raises(ValueError, match="state_template"):
        parallel.shard_train_step(object(), mesh)


def test_shard_train_step_needs_the_step_built_on_its_mesh():
    from s1s2_torch.core.schedule import Schedule
    from s1s2_torch.train.loop import TrainConfig, make_train_step

    net = UNetSmall(4, 8, 1, 8, torch.float32, autograd=True)
    step = make_train_step(net, Schedule.cosine(10), TrainConfig(T=10))
    assert step.mesh.shape == {"data": 1, "space": 1} and step.mesh.group(("data",)) is None
    mesh = parallel.make_mesh(1, 1, 1)
    with pytest.raises(ValueError, match="not built on this mesh"):
        parallel.shard_train_step(step, mesh)
    step = make_train_step(net, Schedule.cosine(10), TrainConfig(T=10), mesh=mesh)
    assert callable(parallel.shard_train_step(step, mesh))


def test_shard_call_cuts_every_argument_and_refuses_one_not_batch_major():
    mesh = parallel.make_mesh(1, 1, 1)
    ctx = type("Ctx", (), {"mesh": mesh})()
    wrapped = EvalContext.shard_call(ctx, lambda c, n, k: c + n + torch.as_tensor(k))
    c, n = torch.ones((2, 3)), torch.full((2, 3), 2.0)
    assert torch.equal(wrapped(c, n, np.zeros((2, 1), np.float32)), torch.full((2, 3), 3.0))
    # a (2,) key at batch 2 would lead with the batch by chance; a (3, ...)
    # stack at batch 2 does not, and is refused rather than passed whole
    with pytest.raises(ValueError, match=r"shape \(3, 2\) does not lead with the batch 2"):
        wrapped(c, n, np.zeros((3, 2), np.float32))


def test_initialize_distributed_is_a_no_op_with_nothing_configured(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    parallel.initialize_distributed()
    assert not dist.is_initialized()
    assert pmesh.world() == (0, 1) and pmesh.is_writer()


def test_initialize_distributed_propagates_a_bad_configuration():
    with pytest.raises(ValueError, match="rank parameter missing"):
        parallel.initialize_distributed("localhost:1", backend="gloo")
    assert not dist.is_initialized()


def test_require_world_names_the_launch_line():
    with pytest.raises(ValueError, match=r"torch\.distributed\.run --nproc_per_node 4"):
        pmesh.require_world(4)
    assert pmesh.require_world(1).shape == {"data": 1, "space": 1}


def test_space_axis_needs_the_training_path_and_divisible_rows():
    mesh = parallel.make_mesh(1, 1, 1)
    mesh.space = 2  # the shape rule alone; no collective runs before it
    with pytest.raises(ValueError, match="training path"):
        UNetSmall(4, 8, 1, 8, torch.float32, mesh=mesh)
    net = UNetSmall(4, 8, 1, 8, torch.float32, autograd=True, mesh=mesh)
    x = torch.zeros((1, 12, 16, 8))
    with pytest.raises(ValueError, match=r"12 rows of H must divide by 8\*stem_s2d = 8"):
        net(x, torch.zeros((1,), dtype=torch.int32))
