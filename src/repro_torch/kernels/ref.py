"""Plain PyTorch versions of the TSM2X kernels.

Counterpart of ``src/repro/kernels/ref.py``: f32 accumulation, cast back to
the input dtype. The kernel wrappers run these for CPU tensors only; on the
card they are what ``chip_smoke.py`` holds each kernel against.

The int8 versions (``*_q8*``) take int8 operands, their f32 scale
sidecars and the band length of the tall operand's scales. They form the
integer products exactly (in f64, exact below 2^53: every product is at
most 127^2) and fold the scales where the JAX kernels fold them
(``src/repro/kernels/quant.py:21-30``): TSM2R and TSM2L once per output
element (A's band scale times B's scale), TSMT once per band of the
reduction, before that band's sum is added.
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
    """Sum over the leading axis of (S, rows, cols) in f32, cast once: slice
    by slice from +0.0 in the order 0..S-1, the kernel's order, so its
    bits."""
    acc = torch.zeros(p.shape[1:], dtype=torch.float32, device=p.device)
    for part in p.float():
        acc += part
    return acc.to(out_dtype)


# ---------------------------------------------------------------------------
# Int8 operands
# ---------------------------------------------------------------------------

def _exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The integer product of two int8 matrices, exactly, as f32-rounded
    values (f64 sums are exact below 2^53). A zero sum is +0, as the
    integer's conversion gives it: a single product 0 * -5 is -0.0 in
    floating point, and adding +0.0 makes it +0."""
    return torch.matmul(a.double(), b.double()).float() + 0.0


def _row_scale(a_scale, b_scale, band: int, m: int) -> torch.Tensor:
    """(m, 1) f32: sA[band of row] * sB, the JAX kernels' folded factor."""
    rows = a_scale.reshape(-1).repeat_interleave(band)[:m]
    return (rows * b_scale.reshape(()))[:, None]


def tsm2r_q8_ref(a, b, a_scale, b_scale, band: int, out_dtype):
    """C = int(A8 B8) * sA[band of row] * sB in ``out_dtype``."""
    return (_exact(a, b) * _row_scale(a_scale, b_scale, band, a.shape[0])
            ).to(out_dtype)


def tsm2l_q8_ref(a, b, a_scale, b_scale, band: int, out_dtype):
    """Single-shot int8 TSM2L; the same function as ``tsm2r_q8_ref``."""
    return tsm2r_q8_ref(a, b, a_scale, b_scale, band, out_dtype)


def tsm2r_q8_split_ref(a, b, a_scale, b_scale, band: int, splits: int,
                       block_k: int) -> torch.Tensor:
    """(S, m, n) f32 partials of ``tsm2r_q8_ref`` over S contiguous k
    slices of ``split_len(k, S, block_k)``, each already scaled."""
    k = a.shape[1]
    step = split_len(k, splits, block_k)
    rows = _row_scale(a_scale, b_scale, band, a.shape[0])
    return torch.stack([
        _exact(a[:, s * step:(s + 1) * step], b[s * step:(s + 1) * step])
        * rows for s in range(splits)])


def _band_sums(x, y, x_scale, y_scale, band: int) -> torch.Tensor:
    """(bands, a, b) f32: band j's exact int(X8[j]^T Y8[j]) * sX[j] *
    sY[j]. A short last band is padded with zero rows (exact)."""
    m, a = x.shape
    bands = -(-m // band)
    pad = bands * band - m
    xp = torch.cat([x, x.new_zeros(pad, a)]) if pad else x
    yp = torch.cat([y, y.new_zeros(pad, y.shape[1])]) if pad else y
    ints = torch.bmm(xp.double().reshape(bands, band, a).transpose(1, 2),
                     yp.double().reshape(bands, band, -1)).float()
    factor = (x_scale.reshape(-1) * y_scale.reshape(-1))[:, None, None]
    return ints * factor


def tsmt_q8_ref(x, y, x_scale, y_scale, band: int, out_dtype):
    """C = sum over m bands j of int(X8[j]^T Y8[j]) * sX[j] * sY[j], in
    f32, cast to ``out_dtype``."""
    return torch.sum(_band_sums(x, y, x_scale, y_scale, band),
                     dim=0).to(out_dtype)


def tsmt_q8_split_ref(x, y, x_scale, y_scale, band: int,
                      splits: int) -> torch.Tensor:
    """(S, a, b) f32 partials of ``tsmt_q8_ref`` over S contiguous slices
    of ``split_len(m, S, band)`` rows (whole bands)."""
    per = split_len(x.shape[0], splits, band) // band
    sums = _band_sums(x, y, x_scale, y_scale, band)
    return torch.stack([torch.sum(sums[s * per:(s + 1) * per], dim=0)
                        for s in range(splits)])
