"""Operand checks and the ctypes launch shared by the kernel wrappers."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPE_TAG = {torch.float32: "f32", torch.bfloat16: "bf16"}
_INT_MAX = 2**31 - 1


def check(name: str, x: torch.Tensor, y: torch.Tensor, contract: str) -> None:
    """Raise unless x, y are 2-D, contiguous, of one supported dtype and one
    device, with matching contraction dims (``contract`` is "mm" for
    x[m,k] @ y[k,n], "mmt" for x[m,a]^T @ y[m,b])."""
    if x.dim() != 2 or y.dim() != 2:
        raise ValueError(f"{name} takes 2-D operands; got {tuple(x.shape)} "
                         f"and {tuple(y.shape)}")
    dx, dy = (x.shape[1], y.shape[0]) if contract == "mm" else \
        (x.shape[0], y.shape[0])
    if dx != dy:
        raise ValueError(f"{name} contraction mismatch: {tuple(x.shape)} and "
                         f"{tuple(y.shape)}")
    if x.dtype != y.dtype or x.dtype not in _DTYPE_TAG:
        raise TypeError(f"{name} takes float32 or bfloat16 operands of one "
                        f"dtype; got {x.dtype} and {y.dtype}")
    if x.device != y.device:
        raise ValueError(f"{name} operands lie on {x.device} and {y.device}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError(f"{name} takes contiguous row-major operands")
    if max(*x.shape, *y.shape) > _INT_MAX:
        raise ValueError(f"{name} dims must fit a 32-bit int")


def launch(name: str, dtype: torch.dtype, *args) -> None:
    """Launch ``<name>_<dtype tag>`` with ``args`` (tensors, passed as their
    data pointers, and ints) on the current stream of the first tensor's
    device, and raise on a non-zero cudaError_t. Every tensor lies on that
    one CUDA device."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    if dev.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors; got {dev}")
    fn = _build.launcher(name, _DTYPE_TAG[dtype])
    stream = torch.cuda.current_stream(dev).cuda_stream
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else int(a)
              for a in args]
    with torch.cuda.device(dev):
        err = fn(*c_args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
