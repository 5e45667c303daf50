"""Plain PyTorch versions of the TSM2X kernels.

Counterpart of ``src/repro/kernels/ref.py``: f32 accumulation, cast back to
the input dtype. The kernel wrappers run these for CPU tensors only; on the
card they are what ``chip_smoke.py`` holds each kernel against.
"""

from __future__ import annotations

import torch


def tsm2r_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[m,n] = A[m,k] @ B[k,n] with f32 accumulation. m ~ k >> n."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def tsm2l_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[m,n] = A[m,k] @ B[k,n] with f32 accumulation. m >> k ~ n."""
    return tsm2r_ref(a, b)


def tsmt_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """C[a,b] = X[m,a]^T @ Y[m,b] with f32 accumulation. m >> a, b."""
    return torch.matmul(x.float().transpose(0, 1), y.float()).to(x.dtype)
