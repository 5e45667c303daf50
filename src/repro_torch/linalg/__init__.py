"""Tall-skinny linear algebra on the TSM2X kernel paths.

Counterpart of ``src/repro/linalg``: :func:`qr` / :func:`tsqr`, the
CholeskyQR2 factorization of an ``(m, r)`` operand (Gram on tsmt, apply
on tsm2l, shift-regularized fallback, differentiable). Also re-exported
as ``repro_torch.kernels.ops.tsqr``. The sharded ``tree_tsqr`` waits for
the multi-process executors.
"""

from repro_torch.linalg.tsqr import DEFAULT_PASSES, default_passes, qr, tsqr

__all__ = ["qr", "tsqr", "DEFAULT_PASSES", "default_passes"]
