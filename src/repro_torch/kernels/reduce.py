"""Sum of split partials: the epilogue of the split-reduction kernels.

Counterpart of ``src/repro/kernels/reduce.py``. The split kernels emit an
``(S, rows, cols)`` stack of f32 partials; this module sums it over the
leading axis in f32 and casts once:

* small stacks (at most ``JNP_REDUCE_MAX_ELEMS`` f32 elements: every
  PowerSGD and ABFT shape) take a plain ``torch.sum``, the JAX package's
  ``jnp.sum`` path, which runs outside any Pallas kernel there;
* larger stacks (split TSM2R at the paper's shapes) launch
  ``sum_partials``, which replaces the TPU kernel
  ``reduce.py::sum_partials_pallas`` with ``csrc/reduce.cu``.

``sum_partials`` is bound by reading the ``S * rows * cols * 4`` bytes of
partials. Its launch is ``perf_model.reduce_plan``: each thread owns a
vector of outputs on the flat index (4 where rows * cols and the pointers
allow), one a thread up to ``REDUCE_BLOCKS_PER_SM`` blocks an SM. A
thread issues a chunk of slices' loads before adding them in the order
0..S-1 from +0.0, so a launch gives the bits of the slice-order sum every
time: no atomics. CPU tensors take the plain version
(``ref.sum_partials_ref``); CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch

from repro_torch.core import perf_model
from repro_torch.kernels import _build, _launch, ref

# Below this many f32 partial elements the plain sum runs (kept in
# ``core/perf_model.py``, whose modelled times count the epilogue launch).
JNP_REDUCE_MAX_ELEMS = perf_model.JNP_REDUCE_MAX_ELEMS

launches = 0   # sum_partials kernel launches; chip_smoke.py resets and reads


def sum_partials(p: torch.Tensor, out_dtype) -> torch.Tensor:
    """The kernel: ``(S, rows, cols)`` f32 partials summed over S, cast to
    ``out_dtype`` (float32 or bfloat16)."""
    global launches
    if p.dim() != 3 or p.dtype != torch.float32 or not p.is_contiguous():
        raise ValueError("sum_partials takes a contiguous (S, rows, cols) "
                         f"float32 stack; got {tuple(p.shape)} {p.dtype}")
    if out_dtype not in _launch._DTYPE_TAG:
        raise TypeError(f"sum_partials writes float32 or bfloat16; got "
                        f"{out_dtype}")
    if p.numel() > 2**31 - 1:
        raise ValueError("sum_partials takes stacks below 2^31 elements")
    if p.device.type == "cpu":
        return ref.sum_partials_ref(p, out_dtype)
    s, rows, cols = p.shape
    out = torch.empty((rows, cols), dtype=out_dtype, device=p.device)
    if out.numel() == 0:
        return out
    _launch.launch("reduce", out_dtype, p, out, s, rows, cols)
    launches += 1
    return out


def plan(p: torch.Tensor, out: torch.Tensor) -> tuple:
    """(grid, threads a block, vector width, slices a chunk) of the
    ``sum_partials`` launch from the stack ``p`` into ``out``, as
    ``perf_model.reduce_plan`` mirrors it for ``p``'s device."""
    spec = perf_model.device_spec(perf_model.H100, p.device)
    return perf_model.reduce_plan(*p.shape, out.dtype, p.data_ptr(),
                                  out.data_ptr(), spec)


def c_plan(p: torch.Tensor, out: torch.Tensor) -> tuple:
    """The same as the kernel's library decides it on the card (CUDA
    tensors only)."""
    _launch.require_cuda("sum_partials", p.device)
    with torch.cuda.device(p.device):
        return _build.reduce_plan(*p.shape, _launch._DTYPE_TAG[out.dtype],
                                  p.data_ptr(), out.data_ptr())


def reduce_partials(p: torch.Tensor,
                    out_dtype) -> tuple[torch.Tensor, tuple | None]:
    """Sum the ``(S, rows, cols)`` partials stack to ``(rows, cols)``:
    the kernel above ``JNP_REDUCE_MAX_ELEMS`` elements, else a plain f32
    sum. Returns the sum and, where the kernel ran, its launch plan
    (``plan``; the dispatcher records its grid), else None."""
    s, rows, cols = p.shape
    if s == 1:
        return p[0].to(out_dtype), None
    if not perf_model.reduce_kernel_runs(s, rows, cols):
        return torch.sum(p, dim=0, dtype=torch.float32).to(out_dtype), None
    out = sum_partials(p, out_dtype)
    return out, plan(p, out)
