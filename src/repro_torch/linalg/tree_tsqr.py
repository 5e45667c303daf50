"""Distributed tall-skinny QR: per-shard CholeskyQR2 and a small-R tree.

Counterpart of ``src/repro/linalg/tree_tsqr.py``. Each rank holds its own
``(m/N, r)`` row block of a row-sharded operand, factors it locally on the
TSM2X kernel paths, and then only the small ``(r, r)`` R factors travel
over the mesh dim ``axis``, so the row-sharded Q never exists replicated.
The reference runs inside the caller's shard_map and names an axis of the
ambient mesh; a process has no ambient mesh, so the caller passes the
``DeviceMesh`` as ``mesh=`` (the only difference in the signature).

Two schedules over the R factors (``reduce=``):

* ``"butterfly"`` -- at level ``l`` each rank swaps its current R with
  partner ``i XOR 2^l`` (``compat.ppermute``), both sides stack the pair
  lower rank first and take the same sign-fixed small QR, so every rank
  ends every level with the same R and its own ``(r, r)`` Q block,
  accumulated into a transform ``T``: ``log2 N`` rounds of ``r * r``
  exchanges. Needs a power-of-two axis size.
* ``"gather"`` -- one all-gather of the N R factors, one ``(N r, r)``
  QR, each rank slicing its own Q block.

``reduce="auto"`` takes the butterfly exactly when the size is a power of
two. Every small QR has a non-negative R diagonal, as the local Cholesky
factors do, so R -- and ``Q = Q_local T`` -- equals the replicated
:func:`repro_torch.linalg.tsqr`'s up to rounding, not up to column signs.
The exchanges are not differentiable (PowerSGD, the consumer, runs under
``torch.no_grad``).
"""

from __future__ import annotations

import torch

from repro_torch.core import tsmm
from repro_torch.kernels import compat
from repro_torch.linalg.tsqr import tsqr as _local_tsqr

__all__ = ["tree_tsqr"]

_REDUCES = ("auto", "butterfly", "gather")


def _small_qr(x: torch.Tensor):
    """Reduced QR of a stacked-R block, signs fixed to a diagonal of R
    >= 0."""
    q, r = torch.linalg.qr(x)
    s = torch.where(torch.diagonal(r) < 0, -1.0, 1.0).to(x.dtype)
    return q * s[None, :], r * s[:, None]


def tree_tsqr(a: torch.Tensor, *, mesh, axis: str,
              policy: tsmm.GemmPolicy | None = None,
              passes: int | None = None, reduce: str = "auto",
              shift_rel: float | None = None):
    """Tall-skinny QR of the row-sharded global operand whose local block
    on this rank is ``a (m/N, r)``, over mesh dim ``axis`` of ``mesh``.

    Returns ``(q_local, r)``: this rank's ``(m/N, r)`` row block of the
    global orthonormal Q (in ``a.dtype``) and the global ``(r, r)``
    upper-triangular R (f32, non-negative diagonal), the same on every
    rank.

    The local factor is :func:`repro_torch.linalg.tsqr` under the
    caller's policy with ``shard_map="local"`` (the call is already per
    shard), so its Gram and apply stay on the tsmt and tsm2l executors;
    ``passes`` and ``shift_rel`` pass through.
    """
    if reduce not in _REDUCES:
        raise ValueError(
            f"tree_tsqr reduce={reduce!r}: valid values are {_REDUCES}")
    p = policy if policy is not None else tsmm.current_policy()
    if p.shard_map != "local":
        p = p.with_(shard_map="local")
    q0, r0 = _local_tsqr(a, policy=p, passes=passes, shift_rel=shift_rel)
    q0 = q0.float()
    size = compat.axis_size(mesh, axis)
    if size == 1:
        return q0.to(a.dtype), r0
    r_dim = a.shape[-1]
    if reduce == "auto":
        reduce = "butterfly" if size & (size - 1) == 0 else "gather"
    idx = compat.axis_index(mesh, axis)

    if reduce == "butterfly":
        if size & (size - 1) != 0:
            raise ValueError(
                f"tree_tsqr reduce='butterfly' needs a power-of-two axis "
                f"size; axis {axis!r} has {size} shards (use 'gather')")
        t_acc = None
        r_cur = r0
        for level in range(size.bit_length() - 1):
            bit = 1 << level
            perm = [(i, i ^ bit) for i in range(size)]
            r_other = compat.ppermute(r_cur, mesh, axis, perm)
            lower = (idx & bit) == 0
            top, bot = (r_cur, r_other) if lower else (r_other, r_cur)
            qs, r_cur = _small_qr(torch.cat([top, bot], dim=0))
            blk = qs[:r_dim] if lower else qs[r_dim:]
            t_acc = blk if t_acc is None else t_acc @ blk
    else:
        rs = compat.all_gather(r0, mesh, axis)            # (N*r, r)
        qs, r_cur = _small_qr(rs)
        t_acc = qs[idx * r_dim:(idx + 1) * r_dim]

    q = tsmm.tsmm(q0, t_acc.contiguous(), policy=p)       # TSM2L shape
    return q.to(a.dtype), r_cur
