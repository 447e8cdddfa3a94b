"""The device mesh on ``torch.distributed``: data, space and model axes,
one process per device (``parallel/mesh.py``), and the mesh's
differentiable collectives (``parallel/comm.py``)."""

from s1s2_torch.parallel.mesh import (
    initialize_distributed,
    make_mesh,
    make_mesh_for_batch,
    replicated,
    shard_batch,
    shard_predict_batch,
    shard_train_step,
    tp_sharding_tree,
)

__all__ = [
    "make_mesh",
    "make_mesh_for_batch",
    "replicated",
    "shard_batch",
    "shard_predict_batch",
    "shard_train_step",
    "tp_sharding_tree",
    "initialize_distributed",
]
