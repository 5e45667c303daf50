"""CholeskyQR2 tall-skinny QR on the TSM2X kernel paths.

Counterpart of ``src/repro/linalg/tsqr.py``. Per pass,

    G = A^T A            # (r, r)  -- tsmt
    R = chol(G)^T        # (r, r)  -- host-shaped, negligible
    Q = A R^{-1}         # (m, r)  -- tsm2l (tiny contraction)

One Cholesky pass loses orthogonality like ``u * cond(A)^2``; the second
(CholeskyQR2, Yamamoto et al.) runs the same two GEMMs on the nearly
orthonormal Q and recovers ``|Q^T Q - I| ~ u`` once the first pass got
``cond(Q1)`` down to O(1). Past ``cond ~ 1/sqrt(u)`` the first Gram
factor is numerically singular; each pass then falls back to a
shift-regularized Cholesky (``G + s*I``, shifted CholeskyQR after Fukaya
et al.) chosen with ``torch.where``, so no pass waits on the card to
decide. A shifted pass only caps the conditioning, so ``DEFAULT_PASSES``
adds one recovery pass to classic QR2; where the default shift is large
(a tall m or a wide r) the second pass's plain Cholesky can be borderline
and shift too, so ``default_passes`` adds one more there. f32 operands
stay within ``|Q^T Q - I| <= 1e-4`` through ``cond ~ 1e6``.

Both GEMM stages go through ``core.tsmm``, so the scoped ``GemmPolicy``
applies (executor, split, quant, ``verify_contracts``, the dispatch spy)
and out-of-regime shapes take the dense route. On the card the Gram runs
on tsmt (or tsmt_split and its epilogue where the chooser splits) and the
apply on tsm2l. The small ``(r, r)`` Cholesky and triangular solve use
``torch.linalg`` in f32, as the JAX package computes them without x64:
``cholesky_ex`` with ``torch.where``, since ``cholesky`` raises where JAX
returns NaN and reading ``info`` on the host would synchronise each pass.

``tsqr``/``qr`` are differentiable through a ``torch.autograd.Function``
with the QR adjoint of the JAX package's ``_qr_bwd``: ``dQ^T Q`` goes
through ``tsmm_t`` and the two ``R^-T`` applies through ``tsmm``, inside
``tsmm.backward_scope`` of the forward's policy.
"""

from __future__ import annotations

import torch

from repro_torch.core import tsmm

__all__ = ["tsqr", "qr", "DEFAULT_PASSES", "default_passes"]

# Two classic CholeskyQR2 passes plus one recovery pass: when the shift
# fallback engages in pass 1 (cond(A) beyond ~1/sqrt(u)), pass 2's input
# still carries cond(Q1) ~ 1/sqrt(shift_rel) ~ 1e2, leaving pass-2
# orthogonality ~ u/shift_rel ~ 1e-3; one more pass lands it at ~u.
DEFAULT_PASSES = 3
# Past this relative shift one recovery pass is not enough. The shift
# grows with sqrt(m * r); a second pass whose plain Cholesky fails on its
# last pivot (a cond(Q1) near f32's reach) shifts again, which leaves
# cond(Q2) ~ 1/sqrt(shift) >= ~30, and the f32 Gram's rounding over m
# rows then keeps the third pass's |Q^T Q - I| near 1e-4..1e-3 at
# cond(A) ~ 1e6. A fourth pass starts from cond ~ 1 and lands at ~u
# (``tests/test_torch_linalg.py`` holds it at [262144,16], shift 2.4e-3).
RECOVERY_SHIFT_REL = 1e-3


def _default_shift_rel(m: int, r: int) -> float:
    """Shift (relative to the unit diagonal of the scaled Gram) that
    dominates the f32 Gram's accumulation noise ``~ sqrt(m) * u`` while
    capping the shifted conditioning at ``~ 1/sqrt(shift_rel)``."""
    eps = torch.finfo(torch.float32).eps
    return 10.0 * float(m * r) ** 0.5 * eps


def default_passes(m: int, r: int, shift_rel: float | None = None) -> int:
    """The passes ``tsqr`` runs on an (m, r) operand unless told:
    ``DEFAULT_PASSES``, plus one where the relative shift (``shift_rel``,
    default ``10 sqrt(m r) u``) exceeds ``RECOVERY_SHIFT_REL``."""
    s = shift_rel if shift_rel is not None else _default_shift_rel(m, r)
    return DEFAULT_PASSES + (s > RECOVERY_SHIFT_REL)


def _small_cholesky(g: torch.Tensor, shift_rel: float) -> torch.Tensor:
    """Lower factor ``L`` of the (r, r) Gram, ``G ~ L L^T``: Jacobi
    (diagonal) scaling conditions the f32 factorization, and a
    shift-regularized retry is chosen with ``torch.where`` wherever the
    plain factor failed (a numerically singular or indefinite Gram)."""
    r = g.shape[0]
    eye = torch.eye(r, dtype=g.dtype, device=g.device)
    d = torch.sqrt(torch.clamp(torch.diagonal(g),
                               min=torch.finfo(g.dtype).tiny))
    gs = g / (d[:, None] * d[None, :])
    l_plain, info = torch.linalg.cholesky_ex(gs)
    ok = (info == 0) & torch.isfinite(l_plain).all()
    l_shift, _ = torch.linalg.cholesky_ex(gs + shift_rel * eye)
    return d[:, None] * torch.where(ok, l_plain, l_shift)


def _upper_inverse(r: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(r.shape[0], dtype=r.dtype, device=r.device)
    return torch.linalg.solve_triangular(r, eye, upper=True)


def _chol_pass(q: torch.Tensor, policy, shift_rel: float):
    """One CholeskyQR pass: returns (Q_next, R_factor)."""
    g = tsmm.tsmm_t(q, q, policy=policy)                       # TSMT
    g = 0.5 * (g + g.transpose(0, 1))
    r_fac = _small_cholesky(g, shift_rel).transpose(0, 1)      # upper
    return tsmm.tsmm(q, _upper_inverse(r_fac), policy=policy), r_fac  # TSM2L


def _factor(a: torch.Tensor, passes: int, policy, shift_rel):
    m, r_dim = a.shape
    srel = shift_rel if shift_rel is not None else _default_shift_rel(
        m, r_dim)
    q, r_acc = a, None
    for _ in range(passes):
        q, r_fac = _chol_pass(q, policy, srel)
        r_acc = r_fac if r_acc is None else r_fac @ r_acc
    return q, r_acc


class _QR(torch.autograd.Function):
    """(Q, R) of an f32 (m, r) operand; the backward is the reduced QR's
    adjoint (m >= r), re-dispatched inside ``backward_scope``."""

    @staticmethod
    def forward(ctx, a, passes, policy, shift_rel):
        q, r = _factor(a, passes, policy, shift_rel)
        ctx.save_for_backward(q, r)
        ctx.policy = policy
        return q, r

    @staticmethod
    def backward(ctx, dq, dr):
        q, r = ctx.saved_tensors
        # M = R dR^T - dQ^T Q ;  dA = (dQ + Q copyltu(M)) R^-T. dQ^T Q is
        # the huge reduction (tsmt); grouping the two small factors first
        # leaves exactly two tall applies (tsm2l).
        with tsmm.backward_scope(ctx.policy) as bp:
            m_mat = r @ dr.transpose(0, 1) - tsmm.tsmm_t(dq, q, policy=bp)
            low = torch.tril(m_mat, -1)
            copyltu = low + low.transpose(0, 1) + torch.diag(
                torch.diagonal(m_mat))
            rinv_t = _upper_inverse(r).transpose(0, 1)
            da = (tsmm.tsmm(dq, rinv_t, policy=bp)
                  + tsmm.tsmm(q, copyltu @ rinv_t, policy=bp))
        return da, None, None, None


def tsqr(a: torch.Tensor, *, policy: tsmm.GemmPolicy | None = None,
         passes: int | None = None, shift_rel: float | None = None):
    """Tall-skinny QR via CholeskyQR2: ``A (m, r) -> (Q, R)``, ``Q``
    orthonormal ``(m, r)`` in ``a.dtype`` and ``R`` upper-triangular
    ``(r, r)`` f32 with a non-negative diagonal (the convention under
    which the factorization is unique).

    Compute runs in f32 whatever the input dtype (a bf16 Gram supports no
    useful orthogonality). Differentiable; both GEMM stages and their
    cotangents dispatch through ``core.tsmm`` under ``policy`` (default:
    the active ``tsmm.policy(...)`` scope). ``passes``: CholeskyQR passes
    (default ``default_passes(m, r, shift_rel)``: ``DEFAULT_PASSES``, one
    more past ``RECOVERY_SHIFT_REL``). ``shift_rel``: the relative
    Cholesky shift used where a Gram factor comes back numerically
    singular.
    """
    if a.dim() != 2:
        raise ValueError(f"tsqr expects a 2-D (m, r) operand; got "
                         f"{tuple(a.shape)}")
    m, r_dim = a.shape
    if r_dim == 0 or m < r_dim:
        raise ValueError(
            f"tsqr is the tall-skinny factorization (m >= r >= 1); got "
            f"shape {tuple(a.shape)}")
    if shift_rel is not None:
        shift_rel = float(shift_rel)
    n_passes = (default_passes(m, r_dim, shift_rel) if passes is None
                else int(passes))
    if n_passes < 1:
        raise ValueError(f"tsqr needs passes >= 1; got {passes}")
    p = policy if policy is not None else tsmm.current_policy()
    # The f32 upcast sits outside the Function, so its backward casts the
    # cotangent back and the Function only sees f32.
    q, r = _QR.apply(a.float(), n_passes, p, shift_rel)
    return q.to(a.dtype), r


def qr(a: torch.Tensor, *, policy: tsmm.GemmPolicy | None = None,
       passes: int | None = None, shift_rel: float | None = None):
    """Alias of :func:`tsqr` under the conventional name."""
    return tsqr(a, policy=policy, passes=passes, shift_rel=shift_rel)
