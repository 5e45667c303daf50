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


def launch(name: str, x: torch.Tensor, y: torch.Tensor, out: torch.Tensor,
           dims: tuple[int, int, int]) -> None:
    """Launch ``<name>_<dtype>`` on the current stream of x's device and
    raise on a non-zero cudaError_t. x, y and out lie on one CUDA device."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors; got {x.device}")
    fn = _build.launcher(name, _DTYPE_TAG[x.dtype])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), *dims, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
