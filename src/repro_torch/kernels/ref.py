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


def split_len(depth: int, splits: int, block: int) -> int:
    """Rows of the reduction one of ``splits`` slices owns: the reduction
    padded to ``splits`` whole slices of ``block``-multiple length, as the
    JAX package pads it (``ops.py`` ``_pad_to(..., splits * block)``)."""
    per = -(-depth // (splits * block))
    return max(per, 1) * block


def tsm2r_split_ref(a: torch.Tensor, b: torch.Tensor, splits: int,
                    block_k: int) -> torch.Tensor:
    """(S, m, n) f32 partials: slice s is A[:, K_s] @ B[K_s, :] over the
    s-th contiguous slice K_s of length ``split_len(k, S, block_k)`` (the
    last ones cut at k, or empty)."""
    k = a.shape[1]
    step = split_len(k, splits, block_k)
    return torch.stack([
        torch.matmul(a[:, s * step:(s + 1) * step].float(),
                     b[s * step:(s + 1) * step].float())
        for s in range(splits)])


def tsmt_split_ref(x: torch.Tensor, y: torch.Tensor, splits: int,
                   block_m: int) -> torch.Tensor:
    """(S, a, b) f32 partials: slice s is X[M_s]^T Y[M_s] over the s-th
    contiguous row slice M_s of length ``split_len(m, S, block_m)``."""
    m = x.shape[0]
    step = split_len(m, splits, block_m)
    return torch.stack([
        torch.matmul(x[s * step:(s + 1) * step].float().transpose(0, 1),
                     y[s * step:(s + 1) * step].float())
        for s in range(splits)])


def sum_partials_ref(p: torch.Tensor, out_dtype) -> torch.Tensor:
    """Sum over the leading axis of (S, rows, cols) in f32, cast once."""
    return torch.sum(p.float(), dim=0).to(out_dtype)
