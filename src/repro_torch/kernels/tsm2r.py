"""TSM2R wrapper: C[m,n] = A[m,k] @ B[k,n] with m ~ k >> n.

Replaces the TPU kernel ``src/repro/kernels/tsm2r.py::tsm2r_pallas`` with
the CUDA kernel in ``csrc/tsm2r.cu``. On the H100 it is bound by the bytes
of A at small n; at the chatglm3 width (n = 256) this first version, which
runs its FMAs on the CUDA cores in f32, is bound by the f32 FMA rate. The
kernel stages B and the next A tile through registers and shared memory
(paper Algorithm 4) and spreads the n columns over threads and a column
grid dimension, streaming A once per column tile; see the source's note.

CPU tensors take the plain version (``ref.tsm2r_ref``); CUDA tensors
launch the kernel or raise.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _launch, ref

launches = 0   # kernel launches; chip_smoke.py resets and reads it


def tsm2r(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    global launches
    _launch.check("tsm2r", a, b, "mm")
    if a.device.type == "cpu":
        return ref.tsm2r_ref(a, b)
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    _launch.launch("tsm2r", a, b, out, (m, k, n))
    launches += 1
    return out
