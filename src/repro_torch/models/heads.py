"""Head-parallel cores on DTensors: each rank runs a layer's core over its
own heads, on local tensors.

PyTorch's tensor-parallel idiom, for the parts of a layer that DTensor's
sharding propagation cannot take, or that torch 2.11 refuses (a flatten
or a split of a head-sharded dim inside a view op): the attention core,
the RWKV6 WKV scan and the Mamba2 SSD scan. The operands go to one
layout (:func:`layout`) -- the batch over the mesh dims where the
activations shard it, the heads over "model" where they divide it, whole
elsewhere -- are taken local (:func:`local`), the core runs on plain
tensors over the rank's heads, and its outputs come back DTensors in that
layout (:func:`wrap`).

An operand the core reads whole on a dim where the ranks split the work
(a parameter without a batch dim, on a mesh dim that shards the batch; a
tensor without a head dim, such as Mamba2's projection or its shared B and
C, on the "model" dim) gets a local gradient that is only this rank's
share of the sum: it leaves ``to_local`` marked ``Partial`` there, which
the backward all-reduces. A replicated operand with a head dim (RWKV6's
decay and bonus, Mamba2's ``A_log``, ``D`` and ``dt_bias``) is cut to the
rank's heads by the redistribution, which moves nothing.

``torch.distributed.tensor`` is imported inside the functions: plain
tensors never need it.
"""

from __future__ import annotations

from typing import NamedTuple

from repro_torch.ft import is_dtensor


class Heads(NamedTuple):
    """Where a core runs: its mesh, each mesh dim's role ("batch",
    "heads" or None) and this rank's heads ``[lo, lo + n)``."""
    mesh: object
    roles: tuple
    lo: int
    n: int


def _splits(n_heads: int, parts: int, groups: int) -> bool:
    """Whether ``n_heads`` split into ``parts`` contiguous blocks of whole
    groups (``groups`` groups of heads share a state, as Mamba2's B and
    C); one group is shared by every block."""
    if n_heads % parts:
        return False
    return groups == 1 or (n_heads // parts) % (n_heads // groups) == 0


def layout(ref, n_heads: int, groups: int = 1) -> Heads:
    """The layout of a core over ``ref``'s mesh: the batch (dim 0) on the
    mesh dims where the activation ``ref`` shards it, the heads on
    "model" where they split evenly into whole groups (``groups``),
    everything else whole."""
    from torch.distributed.tensor import Shard
    mesh = ref.device_mesh
    coord = mesh.get_coordinate()
    roles, lo, n = [], 0, n_heads
    for i, (name, p) in enumerate(zip(mesh.mesh_dim_names, ref.placements)):
        if isinstance(p, Shard) and p.dim == 0:
            roles.append("batch")
        elif name == "model" and _splits(n_heads, mesh.size(i), groups):
            roles.append("heads")
            n //= mesh.size(i)
            lo = coord[i] * n
        else:
            roles.append(None)
    return Heads(mesh, tuple(roles), lo, n)


def placements(hd: Heads, batch_dim, head_dim) -> list:
    """``Shard(batch_dim)`` on the batch dims, ``Shard(head_dim)`` on the
    heads dim, ``Replicate()`` elsewhere (a None dim is whole there)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for role in hd.roles:
        dim = {"batch": batch_dim, "heads": head_dim}.get(role)
        out.append(Replicate() if dim is None else Shard(dim))
    return out


def local(hd: Heads, t, batch_dim=0, head_dim=None):
    """``t`` (a DTensor) as this rank's local tensor in ``hd``'s layout,
    its batch on ``batch_dim`` and its heads on ``head_dim`` (None: it has
    none, and the rank takes it whole). Its local gradient is a pending
    sum on the dims where it is whole but the work is split."""
    from torch.distributed.tensor import Partial
    places = placements(hd, batch_dim, head_dim)
    grads = [Partial() if role is not None and {"batch": batch_dim,
                                                  "heads": head_dim}[role]
             is None else p for role, p in zip(hd.roles, places)]
    return t.redistribute(hd.mesh, places).to_local(grad_placements=grads)


def wrap(hd: Heads, t, batch_dim=0, head_dim=None):
    """A core's local output ``t`` as a DTensor in ``hd``'s layout."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, hd.mesh, placements(hd, batch_dim,
                                                     head_dim),
                              run_check=False)


def local_heads(fn, q, *kv, n_kv: int, **kw):
    """``fn(q, *kv, **kw)`` per rank over its heads, for attention cores
    (heads on dim 2, the batch on dim 0): DTensor operands are taken local
    and the output comes back a DTensor there. Plain tensors pass
    straight through.

    The heads split where the ``n_kv`` kv heads divide "model". Where they
    do not but "model" is a multiple of ``n_kv`` (chatglm3's two kv heads
    over 8 ranks), the query heads split and each rank's lie in one kv
    head's group: the kv operands are taken whole over "model" and the
    rank reads its kv head (its gradient a pending sum there, as for any
    operand a rank reads whole where the work splits). Otherwise every
    rank attends over every head."""
    if not is_dtensor(q):
        return fn(q, *kv, **kw)
    hd = layout(q, n_kv)
    if "heads" not in hd.roles:
        hq = layout(q, q.shape[2])
        group = q.shape[2] // n_kv
        if "heads" in hq.roles and group % hq.n == 0:
            lo = hq.lo // group
            kv = [local(hq, t, 0, None)[:, :, lo:lo + 1] for t in kv]
            return wrap(hq, fn(local(hq, q, 0, 2), *kv, **kw), 0, 2)
    out = fn(*(local(hd, t, 0, 2) for t in (q, *kv)), **kw)
    return wrap(hd, out, 0, 2)
