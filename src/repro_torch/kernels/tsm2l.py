"""TSM2L wrapper: C[m,n] = A[m,k] @ B[k,n] with m >> k ~ n.

Replaces the TPU kernel ``src/repro/kernels/tsm2l.py::tsm2l_pallas`` with
the CUDA kernel in ``csrc/tsm2l.cu``. On the H100 it is bound by the bytes
of A and C, and at the smallest shapes by launch and per-tile latency. The
kernel keeps its B tile in shared memory for the block's lifetime while
blocks stride over m; B is tiled over n (and over k past a chunk) because
all of B at k = n = 256 in f32 exceeds a block's shared memory. Tile
shapes are picked by n, the paper's tcf trade; see the source's note.

CPU tensors take the plain version (``ref.tsm2l_ref``); CUDA tensors
launch the kernel or raise.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _launch, ref

launches = 0   # kernel launches; chip_smoke.py resets and reads it


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
