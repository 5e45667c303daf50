"""ABFT (algorithm-based fault tolerance) checksums through the TSM2X kernels.

Counterpart of ``src/repro/ft/abft.py``, the paper's own headline
application: checksum encoding multiplies the protected matrix by a
skinny weight matrix, a tall-and-skinny GEMM.

    encode:  c = W^T e          e: (d1, s) skinny checksum weights
    verify:  c' = W'^T e ; a fault is detected iff ||c' - c|| > tol

Both are the TSMT shape (a reduction over the tall dim, s in {2..8}
output columns). The weight columns are ones and a ramp, so the ratio of
the ramp's deviation to the plain one, ``(i+1)/rows``, locates a single
faulty row (Huang-Abraham).

The tree API (``encode_tree``, ``verify_tree``,
``verify_and_correct_tree``) checks a tree of tensors (``repro_torch.ft``:
a mapping of name to tensor, or an ``nn.Module``'s parameters) at
checkpoint boundaries; leaves of at least 2^16 elements get a checksum.
:func:`locate_and_correct` is shared with the dispatcher's online guard
(``GemmPolicy.abft``, ``core/tsmm._abft_guard``).

Everything that reads a device value stays on the device: no ``.item()``,
no Python branch on a tensor. The faulty row is picked with a 0-dim index
tensor (``index_select`` / ``index_copy``) and the clean, repaired or
poisoned output with ``torch.where``. The offline path, like the
reference's, localizes a fault through the f32 ramp, which cannot tell
adjacent rows apart when the deviation is small against the checksum's
rounding (``tests/test_torch_abft.py`` records the reference's case).
"""

from __future__ import annotations

import math

import torch

from repro_torch.analysis import contracts as _contracts
from repro_torch.core import tsmm
from repro_torch.ft import is_dtensor, named_leaves

__all__ = [
    "checksum_weights",
    "tolerance_eps",
    "tolerance",
    "detect",
    "encode_leaf",
    "encode_tree",
    "verify_tree",
    "locate_and_correct",
    "correct_leaf",
    "verify_and_correct_tree",
]

_F32_EPS = torch.finfo(torch.float32).eps
# Leaves below this many elements get no checksum (the reference's bar).
MIN_LEAF = 65536


def _scalar(value, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim f32 tensor on ``like``'s device, made by a fill kernel (no
    host-to-device copy). Division by it is IEEE division on the card,
    where a Python divisor becomes a multiply by its reciprocal."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def checksum_weights(d1: int, s: int = 2, device=None) -> torch.Tensor:
    """``(d1, s)`` f32 columns ``[1, (i+1)/d1, ((i+1)/d1)^2, ...]``.

    Column 0 carries the error magnitude, column 1 the same scaled by the
    row position, so ``delta1/delta0 = (i+1)/d1`` locates a single faulty
    row. f32 always: a low-precision ramp would blur that ratio."""
    i = torch.arange(d1, dtype=torch.float32, device=device)
    ramp = (i + 1.0) / _scalar(d1, i)
    cols = [torch.ones_like(i), ramp]
    while len(cols) < s:
        cols.append(torch.square(cols[-1]))
    return torch.stack(cols[:s], dim=1)


def tolerance_eps(dtype, quant: str = "none") -> float:
    """The unit roundoff behind :func:`tolerance` for a protected GEMM
    writing ``dtype`` under ``quant``: at least f32's (the checksums sum in
    f32), and the 1/127 quantization step under ``quant="int8"``."""
    eps = (torch.finfo(dtype).eps if dtype.is_floating_point
           else _F32_EPS)
    eps = max(eps, _F32_EPS)
    if quant == "int8":
        eps = max(eps, 1.0 / 127.0)
    return eps


def _median(v: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of a 1-D f32 tensor: the linear rule, so an even
    count gives the two middle values weighted 0.5 each (where
    ``torch.median`` gives the lower one), and NaN if any value is NaN."""
    n = v.numel()
    q = 0.5 * (n - 1)
    lo, hi = math.floor(q), math.ceil(q)
    srt = torch.sort(v).values
    mid = srt[lo] * (1.0 - (q - lo)) + srt[hi] * (q - lo)
    return torch.where(torch.isnan(v).any(), float("nan"), mid)


def tolerance(rows: int, reduction: int, eps: float, amax) -> torch.Tensor:
    """Per-column detection threshold for checksum deviations.

    ``amax`` is the per-column max |value| of the protected output (f32).
    ``sqrt(rows) + sqrt(reduction)`` is the random-walk growth of rounding
    over the checksum reduction and the GEMM's own contraction, +32 covers
    short reductions, and ``contracts.ABFT_TOL_FACTOR`` is the margin.
    Each column's base is capped at 64x the median column, so a huge
    faulty cell cannot raise its own column's threshold past its own
    deviation; the ``1e-3 * median`` leak keeps all-zero columns from
    demanding exactness."""
    amax = torch.as_tensor(amax, dtype=torch.float32)
    med = _median(amax)
    base = torch.minimum(amax, 64.0 * med) + 1e-3 * med + 1e-30
    scale = _contracts.ABFT_TOL_FACTOR * eps * (
        math.sqrt(rows) + math.sqrt(reduction) + 32.0)
    return base * scale


def detect(c_out, c_ref, *, rows: int, reduction: int, eps: float, amax):
    """``(bad, tol)``: ``bad[j]`` is True when column j's plain or ramp
    checksum deviates past ``tol[j]``, written as the negation of the pass
    condition so a NaN deviation counts as bad."""
    d = c_out[:, :2] - c_ref[:, :2]
    tol = tolerance(rows, reduction, eps, amax)
    ok = (d[:, 0].abs() <= tol) & (d[:, 1].abs() <= tol)
    return ~ok, tol


def encode_leaf(x: torch.Tensor, s: int = 2, *, policy=None) -> torch.Tensor:
    """Checksum of one tensor viewed as ``(shape[0], -1)``: ``(cols, s)``
    f32 through ``tsmm_t`` (the TSMT shape), under ``policy`` or the active
    ``tsmm.policy(...)`` scope. A DTensor leaf is encoded block by block
    (:func:`_encode_dtensor`)."""
    if is_dtensor(x):
        return _encode_dtensor(x.detach(), s, policy)
    m = x.detach().reshape(x.shape[0], -1)
    e = checksum_weights(m.shape[0], s, device=m.device)
    return tsmm.tsmm_t(m.float(), e, policy=policy)


def _encode_dtensor(x, s: int, policy):
    """The full leaf's checksum of a DTensor leaf, a DTensor: each rank
    encodes its local block against its rows of the weights. A block of
    columns (``Shard(1)``) is its columns' checksum, which stays sharded
    (no reduction over m); a block of rows (``Shard(0)``) is a partial
    sum, all-reduced over that mesh dim (``Partial``, the psum a sharded
    reduction over m needs). A leaf of more than two dims sharded past
    dim 0 is gathered on those dims first: its flattened columns would
    not be a block."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.distributed import sharding
    mesh = x.device_mesh
    if x.dim() > 2:
        x = x.redistribute(mesh, [p if not isinstance(p, Shard) or p.dim == 0
                                  else Replicate() for p in x.placements])
    rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in x.placements]
    e = sharding.local_part(checksum_weights(x.shape[0], s,
                                             device=x.device),
                            mesh, rows)
    blk = x.to_local()
    c = tsmm.tsmm_t(blk.reshape(blk.shape[0], -1).float(), e, policy=policy)
    places = [Partial() if isinstance(p, Shard) and p.dim == 0
              else Shard(0) if isinstance(p, Shard) else Replicate()
              for p in x.placements]
    return DTensor.from_local(c, mesh, places, run_check=False).redistribute(
        mesh, [Replicate() if isinstance(p, Partial) else p for p in places])


def encode_tree(tree, s: int = 2, *, policy=None) -> dict:
    """Checksums of every leaf of at least ``MIN_LEAF`` elements, by name
    (None for the others)."""
    return {n: (encode_leaf(x, s, policy=policy)
                if x.dim() >= 1 and x.numel() >= MIN_LEAF else None)
            for n, x in named_leaves(tree)}


def verify_tree(tree, checksums: dict, *, rtol: float = 1e-3, policy=None):
    """``(ok, deviations)``: ``ok`` a 0-dim bool tensor, True when no
    leaf's checksum moved past ``rtol`` relative to the stored one;
    ``deviations`` each checksummed leaf's max relative deviation."""
    devs = {}
    for n, x in named_leaves(tree):
        c = checksums.get(n)
        if c is None:
            continue
        c2 = encode_leaf(x, c.shape[1], policy=policy)
        dev = ((c2 - c).abs() / c.abs().clamp_min(1e-6)).max()
        # a DTensor leaf's deviation, whole on every rank
        devs[n] = dev.full_tensor() if is_dtensor(dev) else dev
    if not devs:
        return torch.tensor(True), devs
    return torch.stack(list(devs.values())).max() <= rtol, devs


def _snap_to_bitflip(row, est, snap_tol):
    """Per column: the single-bit-flip neighbour of ``row`` nearest to the
    f32 estimate ``est``, where one lies within ``snap_tol`` of it; else
    ``est`` cast to the row's dtype. A genuine bit flip leaves the true
    value among the candidates, and the estimate sits within noise of it:
    snapping recovers the pre-flip bits."""
    row, est = row.detach(), est.detach()
    nbits = row.element_size() * 8
    idt = {2: torch.int16, 4: torch.int32, 8: torch.int64}[row.element_size()]
    # 1 << b in the signed view: the top shift wraps to the sign bit.
    masks = torch.bitwise_left_shift(
        torch.ones((), dtype=idt, device=row.device),
        torch.arange(nbits, dtype=idt, device=row.device))
    ri = row.contiguous().view(idt)[:, None]
    cand = (ri ^ masks[None, :]).view(row.dtype)
    dist = (cand.float() - est[:, None]).abs()
    dist = torch.where(torch.isfinite(dist), dist, float("inf"))
    kbest = torch.argmin(dist, dim=1, keepdim=True)
    best = torch.take_along_dim(cand, kbest, dim=1)[:, 0]
    dbest = torch.take_along_dim(dist, kbest, dim=1)[:, 0]
    ok = torch.isfinite(est) & (dbest <= snap_tol)
    return torch.where(ok, best, est.to(row.dtype))


class _StraightThrough(torch.autograd.Function):
    """``fn(out)`` computed on the detached output, with the gradient
    passed straight through to ``out``: on a clean run the guard is the
    identity in both directions, and a repaired row's gradient is the one
    the clean row would have had."""

    @staticmethod
    def forward(ctx, out, fn):
        return fn(out.detach())

    @staticmethod
    def backward(ctx, g):
        return g, None


def locate_and_correct(out, c_out, c_ref, *, rows: int, reduction: int,
                       mode: str, eps: float, ref_row=None):
    """Verify the 2-D ``out`` (``(rows, cols)``) against its checksums;
    on a detected fault poison it or repair it. No host sync.

    ``c_out`` is the checksum computed from the output, ``c_ref`` the one
    pushed through the operands, both ``(cols, s >= 2)`` f32 with the
    plain weights in column 0 and the ramp in column 1. ``mode``:

    * "verify" -- clean: ``out``'s values unchanged; fault: all NaN.
    * "correct" -- locate the single faulty row from the ramp/plain ratio
      of the worst column, estimate each bad column's true value, snap it
      to the nearest single-bit-flip neighbour (bit-exact for a flip), and
      accept the repair only if it cancels the deviations in every column
      (residual check); else poison as "verify" does.

    ``ref_row`` ("correct"): ``i -> (cols,) f32``, the true content of
    row ``i`` (a 0-dim index tensor) recomputed from the operands; without
    it the estimate is ``row - d0``, exact only down to f32 cancellation
    at the corrupted value's magnitude. The result's gradient passes
    straight through to ``out``."""
    if mode not in ("verify", "correct"):
        raise ValueError(
            f"[abft-mode] locate_and_correct mode {mode!r}: valid modes "
            "are 'verify', 'correct'")

    def guarded(o):
        f32 = torch.float32
        c_o = c_out.detach().to(f32)
        c_r = c_ref.detach().to(f32)
        amax = o.to(f32).abs().amax(dim=0)
        bad, tol = detect(c_o, c_r, rows=rows, reduction=reduction, eps=eps,
                          amax=amax)
        any_bad = bad.any()
        nan = torch.full_like(o, float("nan"))
        if mode == "verify":
            return torch.where(any_bad, nan, o)
        d0 = c_o[:, 0] - c_r[:, 0]
        d1 = c_o[:, 1] - c_r[:, 1]
        # The worst finite bad column; its ramp/plain ratio is the faulty
        # row's weight (i+1)/rows.
        mag = torch.where(bad & torch.isfinite(d0), d0.abs(), -float("inf"))
        # index_select, not d1[j]: a 0-dim index tensor in [] syncs.
        j = torch.argmax(mag).view(1)
        ratio = (d1 / d0).index_select(0, j)[0]
        i_f = torch.round(ratio * rows) - 1.0
        i_ok = torch.isfinite(ratio) & (i_f >= 0.0) & (i_f <= rows - 1.0)
        i = torch.where(torch.isfinite(i_f), i_f, 0.0).clamp(
            0, rows - 1).long()
        row = o.index_select(0, i.view(1))[0]
        est = (row.to(f32) - d0 if ref_row is None
               else ref_row(i).detach().to(f32))
        fix_cols = bad & torch.isfinite(est)
        snapped = _snap_to_bitflip(row, est, 4.0 * tol)
        fixed = torch.where(fix_cols, snapped, row)
        # A single-row repair must cancel both deviations in every column,
        # down to the f32 cancellation floor of what it subtracts.
        delta = fixed.to(f32) - row.to(f32)
        w_ramp = (i.to(f32) + 1.0) / _scalar(rows, o)
        cancel0 = 32.0 * _F32_EPS * (d0.abs() + delta.abs())
        cancel1 = 32.0 * _F32_EPS * (d1.abs() + (w_ramp * delta).abs())
        res_ok = (((d0 + delta).abs() <= 4.0 * tol + cancel0)
                  & ((d1 + w_ramp * delta).abs() <= 4.0 * tol + cancel1)
                  ).all()
        corrected = o.index_copy(0, i.view(1), fixed[None, :])
        good = i_ok & res_ok
        return torch.where(any_bad, torch.where(good, corrected, nan), o)

    if out.requires_grad and torch.is_grad_enabled():
        return _StraightThrough.apply(out, guarded)
    return guarded(out.detach())


def correct_leaf(x: torch.Tensor, c: torch.Tensor, *, policy=None):
    """Offline locate-and-correct of one checksummed leaf against its
    stored checksum ``c``: ``(ok_before, corrected)``, ``ok_before`` a
    0-dim bool tensor, False when the leaf had a detected fault (the copy
    is then the repair or the NaN poison)."""
    m = x.detach().reshape(x.shape[0], -1)
    c2 = encode_leaf(x, c.shape[1], policy=policy)
    rows = m.shape[0]
    eps = tolerance_eps(x.dtype)
    amax = m.float().abs().amax(dim=0)
    bad, _ = detect(c2, c, rows=rows, reduction=rows, eps=eps, amax=amax)
    fixed = locate_and_correct(m, c2, c, rows=rows, reduction=rows,
                               mode="correct", eps=eps)
    return ~bad.any(), fixed.reshape(x.shape)


def verify_and_correct_tree(tree, checksums: dict, *, policy=None):
    """Tree-wide offline locate-and-correct against stored checksums:
    ``(ok_before, corrected)``, ``corrected`` a dict by name. A leaf with a
    single-row fault comes back repaired (bit-exact for a flip), one the
    repair cannot explain NaN-poisoned, and leaves without a checksum as
    they are."""
    oks, corrected = [], {}
    for n, x in named_leaves(tree):
        c = checksums.get(n)
        if c is None:
            corrected[n] = x
            continue
        ok, corrected[n] = correct_leaf(x, c, policy=policy)
        oks.append(ok)
    ok_before = torch.stack(oks).all() if oks else torch.tensor(True)
    return ok_before, corrected
