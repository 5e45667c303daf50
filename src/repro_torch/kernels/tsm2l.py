"""TSM2L wrapper: C[m,n] = A[m,k] @ B[k,n] with m >> k ~ n.

Replaces the TPU kernel ``src/repro/kernels/tsm2l.py::tsm2l_pallas`` with
the CUDA kernel in ``csrc/tsm2l.cu``. On the H100 it is bound by the bytes
of A and C, and at the smallest shapes by launch and per-tile latency. The
kernel keeps its B tile in shared memory for the block's lifetime while
blocks stride over m; B is tiled over n (and over k past a chunk) because
all of B at k = n = 256 in f32 exceeds a block's shared memory. Tile
shapes are picked by n, the paper's tcf trade; see the source's note.

``tsm2l_q8`` replaces ``quant.py::tsm2l_q8_pallas`` with
``csrc/tsm2l_q8.cu``: the same kernel body loading int8 A (per-band
scales) and B (one scale), ``__dp4a`` on packed words into exact int32
sums, both scales folded into the one store. Bound by the bytes of A (1
byte an element) and C.

CPU tensors take the plain versions (``ref.tsm2l_ref``,
``ref.tsm2l_q8_ref``); CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _launch, ref

launches = 0      # kernel launches; chip_smoke.py resets and reads it
q8_launches = 0   # tsm2l_q8 kernel launches, likewise


def tsm2l(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    global launches
    _launch.check("tsm2l", a, b, "mm")
    if a.device.type == "cpu":
        return ref.tsm2l_ref(a, b)
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    _launch.launch("tsm2l", a.dtype, a, b, out, m, k, n)
    launches += 1
    return out


def tsm2l_q8(a: torch.Tensor, b: torch.Tensor, a_scale: torch.Tensor,
             b_scale: torch.Tensor, band: int, out_dtype) -> torch.Tensor:
    """C[m,n] = int32(A8 @ B8) * sA[row // band] * sB in ``out_dtype``."""
    global q8_launches
    (m, k), n = a.shape, b.shape[1]
    _launch.check_q8("tsm2l_q8", a, b, a_scale, b_scale, -(-m // band), 1,
                     out_dtype)
    if a.device.type == "cpu":
        return ref.tsm2l_q8_ref(a, b, a_scale, b_scale, band, out_dtype)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if out.numel() == 0:
        return out
    _launch.launch("tsm2l_q8", out_dtype, a, b, a_scale, b_scale, out, m, k,
                   n, band)
    q8_launches += 1
    return out
