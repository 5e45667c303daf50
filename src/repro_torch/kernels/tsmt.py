"""TSMT wrapper: C[a,b] = X[m,a]^T @ Y[m,b] with m >> a, b.

Replaces the TPU kernel ``src/repro/kernels/tsmt.py::tsmt_pallas`` with the
CUDA kernel in ``csrc/tsmt.cu``. On the H100 it is bound by the bytes of X
and Y; with a, b <= 16 its output is one tile, so the sequential kernel
runs on one or a few SMs and reaches a small share of that bound until the
split-reduction kernel is ported. One block per output tile loops over all
of m and sums its thread groups' partials in a fixed order, so results are
bit-identical from run to run (no atomics); see the source's note.

CPU tensors take the plain version (``ref.tsmt_ref``); CUDA tensors launch
the kernel or raise.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _launch, ref

launches = 0   # kernel launches; chip_smoke.py resets and reads it


def tsmt(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    global launches
    _launch.check("tsmt", x, y, "mmt")
    if x.device.type == "cpu":
        return ref.tsmt_ref(x, y)
    (m, a), b = x.shape, y.shape[1]
    out = torch.empty((a, b), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    _launch.launch("tsmt", x, y, out, (m, a, b))
    launches += 1
    return out
