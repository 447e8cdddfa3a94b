"""The device mesh on ``torch.distributed``: one process per device.

Port of the JAX package's ``parallel/mesh.py``. JAX drives every device of
a host from one process and lets XLA insert the collectives; PyTorch's idiom
is one process per device, so here the mesh is the world of the default
process group, laid out as JAX's ``reshape(data, space, model)`` lays out
devices: rank r = (d·space + s)·model + m. Each rank runs on
``cuda:LOCAL_RANK`` over NCCL, or on the CPU over Gloo.

* ``data``: the batch is split by rows; the gradient is summed over it.
* ``space``: the image rows (H) are split; each 3×3 conv of the training
  path reads one halo row from each neighbour (``parallel/comm.py``).
* ``model``: every parameter leaf whose last dimension divides the axis
  (:func:`tp_sharded`) keeps this rank's slice of it; the layer computes its
  slice of the output channels and the channel gather assembles them.

:class:`Mesh` holds the axis sizes, this rank's coordinates and one process
group for each set of axes a collective runs over. With no process group
the mesh is 1×1×1 and every collective is skipped, so the single-device path
is the mesh path at world 1. With a group, a collective over all of the
world's ranks runs through it even at world 1 (NCCL on one card).
"""

from __future__ import annotations

import datetime
import itertools
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "space", "model")
# the sets of axes a collective runs over
GROUPS = (("data",), ("space",), ("model",), ("data", "space"), AXES)
LAUNCH = "python -m torch.distributed.run --nproc_per_node {n} -m s1s2_torch ..."


def world() -> Tuple[int, int]:
    """(rank, world size) of the default group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_writer() -> bool:
    """Whether this process writes files: rank 0, or the only process."""
    return world()[0] == 0


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> None:
    """Bring up the default process group.

    The flags of the CLIs (``tcp://coordinator_address``, ``num_processes``,
    ``process_id``) or, without a coordinator, torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``). A no-op when nothing
    is configured and when a group is already up; every other failure
    propagates. ``backend`` defaults to NCCL when a card is present, else
    Gloo; under NCCL the process takes the card ``LOCAL_RANK`` (without it,
    its rank modulo the host's cards)."""
    if dist.is_initialized():
        return
    kw = {}
    if coordinator_address is not None:
        kw = dict(init_method=f"tcp://{coordinator_address}",
                  world_size=-1 if num_processes is None else num_processes,
                  rank=-1 if process_id is None else process_id)
        rank = process_id or 0
    elif os.environ.get("RANK") and os.environ.get("WORLD_SIZE"):
        rank = int(os.environ["RANK"])
    else:
        return  # nothing configured: one process
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local else rank % torch.cuda.device_count())
    dist.init_process_group(backend, timeout=datetime.timedelta(minutes=10), **kw)


def backend_for(device) -> str:
    """The collectives' backend for tensors on ``device``."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def tp_sharded(shape: Sequence[int], m: int) -> bool:
    """The tensor-parallel rule of ``tp_sharding_tree``: a leaf whose last
    dimension is at least ``m > 1`` and divisible by it is sharded over the
    model axis; every other leaf is replicated."""
    return len(shape) >= 1 and shape[-1] >= m > 1 and shape[-1] % m == 0


class Mesh:
    """A ``(data, space, model)`` mesh over the world ranks ``ranks``.

    ``coords`` is this rank's (d, s, m), or None on a rank the mesh leaves
    idle. Every rank of the world builds every group (``new_group`` is
    collective), idle ranks included."""

    def __init__(self, data: int, space: int, model: int, ranks: Sequence[int]):
        self.data, self.space, self.model = int(data), int(space), int(model)
        self.ranks = tuple(int(r) for r in ranks)
        rank, n_world = world()
        self.rank = rank
        grid = np.asarray(self.ranks).reshape(self.data, self.space, self.model)
        where = np.argwhere(grid == rank)
        self.coords = tuple(int(c) for c in where[0]) if len(where) else None
        self._groups: Dict[Tuple[str, ...], object] = {}
        for axes in GROUPS:
            other = [a for a in AXES if a not in axes]
            for fixed in itertools.product(*(range(self.size(a)) for a in other)):
                idx = [slice(None)] * 3
                for a, v in zip(other, fixed):
                    idx[AXES.index(a)] = v
                members = sorted(int(r) for r in np.ravel(grid[tuple(idx)]))
                if not dist.is_initialized():
                    group = None
                elif len(members) == n_world:
                    group = dist.group.WORLD
                elif len(members) == 1:
                    group = None
                else:
                    group = dist.new_group(members)  # collective: every rank calls it
                if rank in members:
                    self._groups[axes] = group

    # -- shape ----------------------------------------------------------------

    def size(self, axis: str) -> int:
        return getattr(self, axis)

    @property
    def shape(self) -> Dict[str, int]:
        """The axis sizes, as JAX's ``mesh.shape`` (no ``model`` key at 1)."""
        out = {"data": self.data, "space": self.space}
        if self.model > 1:
            out["model"] = self.model
        return out

    @property
    def active(self) -> bool:
        return self.coords is not None

    def coord(self, axis: str) -> int:
        return self.coords[AXES.index(axis)]

    # -- slices ---------------------------------------------------------------

    def rows(self, n: int, axis: str = "data") -> slice:
        """This rank's block of ``n`` rows split over ``axis``."""
        k = self.size(axis)
        if n % k:
            raise ValueError(f"{n} rows not divisible by mesh {axis}={k}")
        b = n // k
        i = self.coord(axis)
        return slice(i * b, (i + 1) * b)

    def local(self, x, spatial: bool = False):
        """This rank's block of a global (B, H, ...) batch array: its data
        rows and, with ``spatial``, its space rows of H."""
        x = x[self.rows(x.shape[0])]
        if spatial and x.ndim >= 3 and self.space > 1:
            x = x[:, self.rows(x.shape[1], "space")]
        return x

    def param_slice(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a full parameter leaf: its block of the last
        dimension when the leaf is sharded (:func:`tp_sharded`), else the
        leaf."""
        if not tp_sharded(x.shape, self.model):
            return x
        return x[..., self.rows(x.shape[-1], "model")]

    # -- collectives ------------------------------------------------------------

    def group(self, axes: Tuple[str, ...]):
        return self._groups[axes]

    def all_reduce_(self, t: torch.Tensor, axes: Tuple[str, ...] = AXES) -> torch.Tensor:
        """Sum ``t`` in place over ``axes``; skipped where the group is this
        rank alone."""
        g = self._groups[axes]
        if g is not None:
            dist.all_reduce(t, group=g)
        return t

    def all_gather(self, t: torch.Tensor, axes: Tuple[str, ...], dim: int = 0) -> torch.Tensor:
        """The group's tensors concatenated along ``dim`` in coordinate order."""
        g = self._groups[axes]
        if g is None:
            return t
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(g))]
        dist.all_gather(parts, t.contiguous(), group=g)
        return torch.cat(parts, dim=dim)

    def barrier(self) -> None:
        g = self._groups[AXES]
        if g is not None:
            dist.barrier(group=g)


def local_mesh() -> Mesh:
    """The 1×1×1 mesh of this process alone, what a step or a loop given no
    mesh runs on: without a process group every collective is skipped."""
    return Mesh(1, 1, 1, [world()[0]])


def make_mesh(data: Optional[int] = None, space: int = 1, model: int = 1,
              devices: Optional[Sequence[int]] = None) -> Mesh:
    """A ``(data, space, model)`` mesh over ``devices`` (world ranks; all of
    them by default, with ``data`` filling what space and model leave).
    Raises ``ValueError`` when the product is not the number of ranks."""
    ranks = list(devices if devices is not None else range(world()[1]))
    n = len(ranks)
    if data is None:
        data = n // (space * model)
    if data * space * model != n:
        raise ValueError(f"mesh {data}x{space}x{model} != {n} devices")
    return Mesh(data, space, model, ranks)


def make_mesh_for_batch(batch_size: int, space: int = 1, model: int = 1,
                        devices: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh whose data axis is the largest rank count that divides the
    global batch; the ranks left over are idle (``Mesh.active`` is False)."""
    ranks = list(devices if devices is not None else range(world()[1]))
    n = len(ranks) // (space * model)
    data = 1
    for d in range(n, 0, -1):
        if batch_size % d == 0:
            data = d
            break
    return make_mesh(data=data, space=space, model=model,
                     devices=ranks[: data * space * model])


def require_world(n: int) -> Mesh:
    """The data mesh of ``--mesh_data N``: it needs a world of exactly N
    processes."""
    size = world()[1]
    if size != n:
        raise ValueError(
            f"--mesh_data {n} runs one process per device and needs a world of {n} processes, "
            f"not {size}: launch it with `{LAUNCH.format(n=n)}`")
    return make_mesh(data=n, space=1)


def replicated(mesh: Mesh):
    """Replicated placement: ``replicated(mesh)(t)`` is ``t`` as the mesh's
    first rank holds it, on every rank of the mesh (a broadcast)."""

    def place(t: torch.Tensor) -> torch.Tensor:
        g = mesh.group(AXES)
        if g is not None:
            dist.broadcast(t, src=mesh.ranks[0], group=g)
        return t

    return place


def shard_batch(batch, mesh: Mesh, spatial: bool = False):
    """This rank's block of a batch tuple: each array holds the rows of the
    rank's data coordinate (as ``batch_iterator`` yields them under a mesh);
    with ``spatial`` its H is cut to the rank's space rows. None entries
    pass through."""
    if not (spatial and mesh.space > 1):
        return batch

    def cut(x):
        if x is None or x.ndim < 3:
            return x
        return x[:, mesh.rows(x.shape[1], "space")]

    return tuple(cut(x) for x in batch)


def shard_predict_batch(predict_batch, mesh: Mesh):
    """Device-parallel tile inference: ``wrapped(cond_b, noise_b)`` checks
    that the tile batch divides over the data axis, has this rank compute its
    rows, ``predict_batch(cond_b, noise_b, rows)`` (the whole batch is passed,
    so what the sampler takes from it, such as the η key's tag, is the same
    on every rank), and gathers the rows of all ranks in order."""
    data = mesh.data

    def wrapped(cond_b, noise_b):
        if cond_b.shape[0] % data:
            raise ValueError(f"tile batch {cond_b.shape[0]} not divisible by mesh data={data}")
        out = predict_batch(cond_b, noise_b, mesh.rows(cond_b.shape[0]))
        if not isinstance(out, torch.Tensor):
            out = torch.from_numpy(np.asarray(out))
        return mesh.all_gather(out, ("data",))

    return wrapped


def tp_sharding_tree(tree, mesh: Mesh, axis: str = "model"):
    """For each leaf of a dict tree: the model-axis slice this rank keeps
    (``slice`` over the last dimension) for a sharded leaf, None for a
    replicated one (JAX: a NamedSharding with ``P(..., 'model')`` or
    ``P()``)."""
    m = mesh.size(axis)

    def spec(x):
        if hasattr(x, "shape") and tp_sharded(tuple(x.shape), m):
            return mesh.rows(x.shape[-1], axis) if mesh.active else slice(None)
        return None

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return spec(t)

    return walk(tree)


def shard_train_step(step_fn, mesh: Mesh, spatial: bool = False, state_template=None):
    """``step(state, batch, key)`` over the mesh: ``step_fn`` is a
    ``train/loop.TrainStep`` (or another step) built on ``mesh``, whose
    collectives run over it; the batch is this rank's data rows, cut to its
    space rows with ``spatial``. On a mesh with a model axis a full state
    (``state_template``'s layout) is sharded on the first call."""
    from s1s2_torch.train.loop import tp_shard_state

    if mesh.model > 1 and state_template is None:
        raise ValueError("model-parallel mesh needs state_template")
    if getattr(step_fn, "mesh", None) is not mesh:
        raise ValueError("the step was not built on this mesh: pass it to make_train_step")
    full = None if state_template is None else state_template.layout

    def step(state, batch, key):
        if mesh.model > 1 and state.layout == full:
            state = tp_shard_state(state, mesh)
        return step_fn(state, shard_batch(batch, mesh, spatial), key)

    return step
