"""Tall-skinny linear algebra on the TSM2X kernel paths.

Counterpart of ``src/repro/linalg``:

* :func:`qr` / :func:`tsqr` -- CholeskyQR2 of an ``(m, r)`` operand (Gram
  on tsmt, apply on tsm2l, shift-regularized fallback, differentiable),
  also re-exported as ``repro_torch.kernels.ops.tsqr``;
* :func:`tree_tsqr` -- the distributed variant for a row-sharded operand,
  on each rank's local block (small-R butterfly or gather tree over a
  ``DeviceMesh`` dim).
"""

from repro_torch.linalg.tsqr import DEFAULT_PASSES, default_passes, qr, tsqr
from repro_torch.linalg.tree_tsqr import tree_tsqr

__all__ = ["qr", "tsqr", "tree_tsqr", "DEFAULT_PASSES", "default_passes"]
