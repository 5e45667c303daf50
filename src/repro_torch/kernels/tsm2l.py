"""TSM2L wrapper: C[m,n] = A[m,k] @ B[k,n] with m >> k ~ n.

Replaces the TPU kernel ``src/repro/kernels/tsm2l.py::tsm2l_pallas`` with
the CUDA kernel in ``csrc/tsm2l.cu``, bound on the H100 by the bytes of A
and C (at the smallest shapes by the launch). It runs one of two bodies,
chosen from the shape and A's alignment before the launch (``plan``;
mirrored by ``core/perf_model.py::tsm2l_plan``):

* "stream" (``csrc/tsm2l_stream.cuh``): n in 1..16, k in 1..256 and a
  16-byte aligned A, such as the paper's [m,16]·[16,16]. Persistent
  blocks, two an SM; a producer thread streams row tiles of A (whole rows,
  contiguous) into a ring of shared-memory stages with 1-D bulk copies;
  each thread keeps all n outputs of its rows (the paper's tcf: 4 rows of
  at most 32 bytes of A a thread, 2 of at most 256, else 1) with B
  broadcast from shared memory, and the tile's outputs go back through
  shared memory as bulk stores.
* "tile" (``csrc/common.cuh``'s ``tsm2l_kernel``): every other call (n >
  16, k > 256, a misaligned A). Blocks stride over row tiles and keep
  their B tile in shared memory for their lifetime; B is tiled over n
  (and over k past a chunk); three tile shapes picked by n.

``tsm2l_q8`` replaces ``quant.py::tsm2l_q8_pallas`` with
``csrc/tsm2l_q8.cu``: the same two bodies at the int8 load type (per-band
scales of A, one scale of B), ``__dp4a`` on packed words into exact int32
sums, both scales folded into the one store (``q8_plan``). The stream
body's result is bit-equal to the plain version.

CPU tensors take the plain versions (``ref.tsm2l_ref``,
``ref.tsm2l_q8_ref``); CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _launch, ref

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


def plan(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(body, grid, geometry) that ``tsm2l(a, b)`` launches for these CUDA
    operands, as the kernel's library decides them (``tsm2l_plan``)."""
    _launch.check("tsm2l", a, b, "mm")
    (m, k), n = a.shape, b.shape[1]
    return _build.tsm2l_plan(m, k, n, _launch._DTYPE_TAG[a.dtype],
                             a.data_ptr())


def q8_plan(a: torch.Tensor, b: torch.Tensor, out_dtype) -> tuple:
    """(body, grid, geometry) that ``tsm2l_q8(a, b, ..., out_dtype)``
    launches for these CUDA operands (``tsm2l_q8_plan``)."""
    (m, k), n = a.shape, b.shape[1]
    return _build.tsm2l_plan(m, k, n, "int8", a.data_ptr(),
                             _launch._DTYPE_TAG[out_dtype])


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
