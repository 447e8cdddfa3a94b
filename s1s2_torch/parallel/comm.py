"""Differentiable collectives of the mesh (``parallel/mesh.py``).

* :func:`psum`: a sum over mesh axes whose backward passes the gradient
  through. Every rank computes the same function of the summed value, so
  each rank's share of the gradient is the gradient of that function at
  its own summand; summing the parameter gradients afterwards (the train
  step's ``all_reduce``) completes it. The losses take their global sums
  and counts through it.
* :func:`gather_channels`: the model axis. Forward: ``all_gather`` of the
  ranks' channel slices along C. Backward: ``all_reduce`` of the full
  gradient, then this rank's slice. The gradient that reaches it is each
  rank's partial share (the train step seeds the loss divided by the model
  size), so the sum is the whole gradient. Written here because Gloo has no
  ``reduce_scatter`` and ``torch.distributed.nn``'s gather relies on it.
* :func:`halo_rows`: the space axis. Forward: send the first and last rows
  to the neighbours and receive one row from each (``batch_isend_irecv``);
  zeros at the global top and bottom, which is the 3×3 conv's SAME padding.
  Backward: send the halo rows' gradients back and add them to the edge rows
  they came from.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from s1s2_torch.parallel.mesh import Mesh


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(x: torch.Tensor, mesh: Mesh, axes: Tuple[str, ...] = ("data", "space")) -> torch.Tensor:
    """``x`` summed over ``axes`` of ``mesh`` (identity where the group is
    this rank alone); the backward passes the gradient through."""
    g = mesh.group(axes)
    if g is None:
        return x
    return _PSum.apply(x, g)


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, index):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        ctx.group, ctx.index, ctx.c = group, index, x.shape[-1]
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        c = ctx.c
        return g[..., ctx.index * c:(ctx.index + 1) * c].contiguous(), None, None, None


def gather_channels(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The model group's channel slices of ``x`` (NHWC), concatenated along
    C in coordinate order."""
    g = mesh.group(("model",))
    if g is None:
        return x
    return _GatherChannels.apply(x, g, mesh.model, mesh.coord("model"))


def _exchange(top: torch.Tensor, bottom: torch.Tensor, mesh: Mesh, up: int, down: int):
    """Send ``top`` to the rank above and ``bottom`` to the rank below (None:
    no neighbour); → (the row received from above, from below), zeros where
    there is no neighbour."""
    g = mesh.group(("space",))
    from_up, from_down = torch.zeros_like(top), torch.zeros_like(bottom)
    ops = []
    if up is not None:
        ops += [dist.P2POp(dist.isend, top, up, group=g),
                dist.P2POp(dist.irecv, from_up, up, group=g)]
    if down is not None:
        ops += [dist.P2POp(dist.isend, bottom, down, group=g),
                dist.P2POp(dist.irecv, from_down, down, group=g)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return from_up, from_down


def _neighbours(mesh: Mesh):
    d, s, m = mesh.coords
    rank = lambda s2: mesh.ranks[(d * mesh.space + s2) * mesh.model + m]  # noqa: E731
    return (rank(s - 1) if s > 0 else None,
            rank(s + 1) if s < mesh.space - 1 else None)


class _HaloRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        up, down = _neighbours(mesh)
        ctx.mesh, ctx.up, ctx.down = mesh, up, down
        above, below = _exchange(x[:, :1].contiguous(), x[:, -1:].contiguous(), mesh, up, down)
        return torch.cat([above, x, below], dim=1)

    @staticmethod
    def backward(ctx, g):
        # the halo rows' gradients belong to the neighbours' edge rows
        to_up, to_down = g[:, :1].contiguous(), g[:, -1:].contiguous()
        from_up, from_down = _exchange(to_up, to_down, ctx.mesh, ctx.up, ctx.down)
        gx = g[:, 1:-1].clone()
        gx[:, :1] += from_up
        gx[:, -1:] += from_down
        return gx, None


def halo_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(B, h, W, C) → (B, h + 2, W, C): this rank's rows with one row of
    each space neighbour above and below, zeros at the image's edges."""
    return _HaloRows.apply(x, mesh)

