"""Collectives over one named dim of a ``DeviceMesh``, on local tensors.

Counterpart of the collective half of ``src/repro/kernels/compat.py``
(``psum_scatter`` :235, ``all_gather`` :257) and of the ``lax`` collectives
the reference calls inside its shard_map bodies (``psum``, ``pmean``,
``ppermute``, ``axis_index``, ``psum(1, axis)``). A caller that runs per
shard -- ``linalg.tree_tsqr``, PowerSGD's sharded protocol -- holds this
process's local tensor and names the mesh and the dim to reduce over, as
the reference names an axis of its ambient mesh:

* ``psum`` / ``pmean``: the local tensors summed (averaged) over ``axis``,
  a ``Partial`` DTensor redistributed to ``Replicate``;
* ``psum_scatter``: the sum's rows split over ``axis`` in rank order, a
  ``Partial`` DTensor redistributed to ``Shard(0)``;
* ``all_gather``: the local row blocks stacked in rank order, a
  ``Shard(0)`` DTensor's ``full_tensor``;
* ``ppermute``: ``(source, destination)`` pairs of ranks along ``axis``,
  through ``batch_isend_irecv`` on the dim's process group.

Every collective runs on the tensors' device (NCCL on the card, gloo on
the CPU). On a dim of one rank DTensor's redistribution moves nothing, so
each call returns its input's values. ``torch.distributed.tensor`` is
imported inside the functions: only a process that runs a collective pays
for it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["axis_mesh", "axis_size", "axis_index", "mesh_axis_sizes",
           "psum", "pmean", "psum_scatter", "all_gather", "ppermute"]


def mesh_axis_sizes(mesh) -> dict:
    """``{dim name: size}`` of ``mesh``."""
    return dict(zip(mesh.mesh_dim_names or (), mesh.shape))


def axis_mesh(mesh, axis: str):
    """The one-dim mesh of ``axis`` (``mesh`` itself when that is all it
    has)."""
    if tuple(mesh.mesh_dim_names or ()) == (axis,):
        return mesh
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh {mesh.mesh_dim_names} has no dim {axis!r}")
    return mesh[axis]


def axis_size(mesh, axis: str) -> int:
    """The reference's ``lax.psum(1, axis)``."""
    return axis_mesh(mesh, axis).size()


def axis_index(mesh, axis: str) -> int:
    """This process's rank along ``axis`` (``lax.axis_index``)."""
    return axis_mesh(mesh, axis).get_local_rank()


def _redistribute(x, mesh, axis, src, dst):
    from torch.distributed.tensor import DTensor
    sub = axis_mesh(mesh, axis)
    return DTensor.from_local(x, sub, [src]).redistribute(
        sub, [dst]).to_local()


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of every rank's ``x`` along ``axis``, on every rank."""
    from torch.distributed.tensor import Partial, Replicate
    return _redistribute(x, mesh, axis, Partial(), Replicate())


def pmean(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``psum`` divided by the rank count, as ``lax.pmean``."""
    return psum(x, mesh, axis) / axis_size(mesh, axis)


def psum_scatter(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """This rank's row block of the sum of every rank's ``x``: rows must
    divide the rank count."""
    from torch.distributed.tensor import Partial, Shard
    size = axis_size(mesh, axis)
    if x.shape[0] % size != 0:
        raise ValueError(f"psum_scatter: {x.shape[0]} rows do not divide "
                         f"the {size} ranks of axis {axis!r}")
    return _redistribute(x, mesh, axis, Partial(), Shard(0))


def all_gather(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Every rank's ``x`` stacked along dim 0 in rank order (equal local
    shapes)."""
    from torch.distributed.tensor import DTensor, Shard
    sub = axis_mesh(mesh, axis)
    return DTensor.from_local(x, sub, [Shard(0)]).full_tensor()


def ppermute(x: torch.Tensor, mesh, axis: str, perm) -> torch.Tensor:
    """``lax.ppermute``: rank ``s`` of ``axis`` sends ``x`` to ``d`` for
    each ``(s, d)`` in ``perm``; a rank no pair sends to gets zeros."""
    idx = axis_index(mesh, axis)
    group = axis_mesh(mesh, axis).get_group()
    out = torch.zeros_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(),
                      dist.get_global_rank(group, d), group)
           for s, d in perm if s == idx and d != idx]
    ops += [dist.P2POp(dist.irecv, out, dist.get_global_rank(group, s),
                       group)
            for s, d in perm if d == idx and s != idx]
    if any(s == idx == d for s, d in perm):
        out.copy_(x)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out
