"""TSM2R wrapper: C[m,n] = A[m,k] @ B[k,n] with m ~ k >> n.

Replaces the TPU kernel ``src/repro/kernels/tsm2r.py::tsm2r_pallas`` with
the CUDA kernel in ``csrc/tsm2r.cu``. On the H100 it is bound by the bytes
of A at small n; at the chatglm3 width (n = 256) this first version, which
runs its FMAs on the CUDA cores in f32, is bound by the f32 FMA rate. The
kernel stages B and the next A tile through registers and shared memory
(paper Algorithm 4) and spreads the n columns over threads and a column
grid dimension, streaming A once per column tile; see the source's note.

``tsm2r_split`` replaces ``tsm2r.py::tsm2r_pallas_split`` with
``csrc/tsm2r_split.cu``: the same block body over one of S contiguous k
slices per grid z index, writing (S, m, n) f32 partials. It is bound by
the bytes of A plus the partials' round trip, and pays off where the
output tiles alone leave SMs idle (the paper's [16384^2]·[16384,16] has
128 row tiles for 132 SMs); ``kernels/reduce.py`` sums the partials.

``tsm2r_q8`` replaces ``quant.py::tsm2r_q8_pallas`` with
``csrc/tsm2r_q8.cu`` and ``tsm2r_q8_split`` replaces
``quant.py::tsm2r_q8_pallas_split`` with ``csrc/tsm2r_q8_split.cu``: the
same block body loading int8 A (per-band scales) and B (one scale),
summing four products a ``__dp4a`` into exact int32 tile sums, folding
sA[band of row] * sB into the stored tile. Bound by the bytes of A at 1
byte an element.

CPU tensors take the plain versions (``ref.tsm2r_ref``,
``ref.tsm2r_split_ref``, ``ref.tsm2r_q8_ref``, ``ref.tsm2r_q8_split_ref``);
CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _launch, ref

launches = 0         # tsm2r kernel launches; chip_smoke.py resets and reads
split_launches = 0   # tsm2r_split kernel launches, likewise
q8_launches = 0      # tsm2r_q8 kernel launches, likewise
q8_split_launches = 0   # tsm2r_q8_split kernel launches, likewise


def tsm2r(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    global launches
    _launch.check("tsm2r", a, b, "mm")
    if a.device.type == "cpu":
        return ref.tsm2r_ref(a, b)
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    _launch.launch("tsm2r", a.dtype, a, b, out, m, k, n)
    launches += 1
    return out


def tsm2r_split(a: torch.Tensor, b: torch.Tensor, splits: int,
                block_k: int) -> torch.Tensor:
    """(S, m, n) f32 partials of A @ B over S contiguous k slices of
    ``ref.split_len(k, S, block_k)`` rows each."""
    global split_launches
    _launch.check("tsm2r_split", a, b, "mm")
    if a.device.type == "cpu":
        return ref.tsm2r_split_ref(a, b, splits, block_k)
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    _launch.launch("tsm2r_split", a.dtype, a, b, out, m, k, n, splits,
                   ref.split_len(k, splits, block_k))
    split_launches += 1
    return out


def tsm2r_q8(a: torch.Tensor, b: torch.Tensor, a_scale: torch.Tensor,
             b_scale: torch.Tensor, band: int, out_dtype) -> torch.Tensor:
    """C[m,n] = int32(A8 @ B8) * sA[row // band] * sB in ``out_dtype``:
    ``a``/``b`` int8, ``a_scale`` ceil(m / band) f32 band scales, ``b_scale``
    one f32 scale."""
    global q8_launches
    (m, k), n = a.shape, b.shape[1]
    _launch.check_q8("tsm2r_q8", a, b, a_scale, b_scale, -(-m // band), 1,
                     out_dtype)
    if a.device.type == "cpu":
        return ref.tsm2r_q8_ref(a, b, a_scale, b_scale, band, out_dtype)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if out.numel() == 0:
        return out
    _launch.launch("tsm2r_q8", out_dtype, a, b, a_scale, b_scale, out, m, k,
                   n, band)
    q8_launches += 1
    return out


def tsm2r_q8_split(a: torch.Tensor, b: torch.Tensor, a_scale: torch.Tensor,
                   b_scale: torch.Tensor, band: int, splits: int,
                   block_k: int) -> torch.Tensor:
    """(S, m, n) f32 partials of ``tsm2r_q8`` over S contiguous k slices of
    ``ref.split_len(k, S, block_k)`` rows each, already scaled."""
    global q8_split_launches
    (m, k), n = a.shape, b.shape[1]
    _launch.check_q8("tsm2r_q8_split", a, b, a_scale, b_scale,
                     -(-m // band), 1, torch.float32)
    if a.device.type == "cpu":
        return ref.tsm2r_q8_split_ref(a, b, a_scale, b_scale, band, splits,
                                      block_k)
    out = torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    _launch.launch("tsm2r_q8_split", torch.float32, a, b, a_scale, b_scale,
                   out, m, k, n, band, splits,
                   ref.split_len(k, splits, block_k))
    q8_split_launches += 1
    return out
