"""Forward entries for the TSM2X kernels.

Counterpart of ``src/repro/kernels/ops.py`` (``tsm2r`` :426, ``tsm2l`` :486,
``tsmt`` :571), forward only. The CUDA kernels mask ragged m, k, n
themselves, so nothing is padded here (the JAX package's ``_pad_to``), and
block sizes are fixed per tile shape inside each kernel, so there is no
parameter resolution. Operands are made contiguous (a no-op when they
already are) and handed to the per-kernel wrappers, which run the plain
version for CPU tensors and launch the kernel for CUDA tensors.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels import tsm2l as _tsm2l
from repro_torch.kernels import tsm2r as _tsm2r
from repro_torch.kernels import tsmt as _tsmt

# The TSMT kernel sizes its per-block partials for a small output dim; past
# this the shape belongs to the dense path. Copied from the JAX package's
# ``analysis/contracts.py`` (TSMT_MAX_B), so both refuse the same shapes.
TSMT_MAX_B = 512


def tsm2r(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[m,n] = A[m,k] @ B[k,n], m ~ k >> n. The paper's TSM2R."""
    return _tsm2r.tsm2r(a.contiguous(), b.contiguous())


def tsm2l(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[m,n] = A[m,k] @ B[k,n], m >> k ~ n. The paper's TSM2L."""
    return _tsm2l.tsm2l(a.contiguous(), b.contiguous())


def tsmt(x: torch.Tensor, y: torch.Tensor, *, policy=None) -> torch.Tensor:
    """C[a,b] = X[m,a]^T @ Y[m,b], m >> a, b.

    Raises ``ValueError`` when the small output dim b exceeds
    ``TSMT_MAX_B``, or the scope's ``max_skinny_t`` when a policy raised the
    classifier past it, as the JAX entry does; reorient the operands
    (``tsmt(y, x).T``) or dispatch through ``tsmm.tsmm_t``.
    """
    from repro_torch.core import tsmm   # deferred: tsmm imports this module

    p = policy if policy is not None else tsmm.current_policy()
    limit = max(TSMT_MAX_B, p.max_skinny_t)
    if y.dim() == 2 and y.shape[1] > limit:
        raise ValueError(
            f"tsmt small output dim b={y.shape[1]} exceeds the limit "
            f"({limit}). Orient the operands so the larger output dim comes "
            "first (C = tsmt(y, x).T), or dispatch through tsmm.tsmm_t, "
            "which classifies such shapes dense.")
    return _tsmt.tsmt(x.contiguous(), y.contiguous())


# Re-exported plain versions, as the JAX entry re-exports its oracles.
tsm2r_ref = ref.tsm2r_ref
tsm2l_ref = ref.tsm2l_ref
tsmt_ref = ref.tsmt_ref
