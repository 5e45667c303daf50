"""Operand checks and the ctypes launch shared by the kernel wrappers."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPE_TAG = {torch.float32: "f32", torch.bfloat16: "bf16"}
_INT_MAX = 2**31 - 1


def check(name: str, x: torch.Tensor, y: torch.Tensor, contract: str, *,
          int8: bool = False, y_kmajor: bool = False) -> None:
    """Raise unless x, y are 2-D, contiguous (``y_kmajor``: y's transpose
    contiguous instead), of one supported dtype (int8 for the int8
    kernels, else float32 or bfloat16) and one device, with matching
    contraction dims (``contract`` is "mm" for x[m,k] @ y[k,n], "mmt" for
    x[m,a]^T @ y[m,b])."""
    if x.dim() != 2 or y.dim() != 2:
        raise ValueError(f"{name} takes 2-D operands; got {tuple(x.shape)} "
                         f"and {tuple(y.shape)}")
    dx, dy = (x.shape[1], y.shape[0]) if contract == "mm" else \
        (x.shape[0], y.shape[0])
    if dx != dy:
        raise ValueError(f"{name} contraction mismatch: {tuple(x.shape)} and "
                         f"{tuple(y.shape)}")
    if int8 and (x.dtype != torch.int8 or y.dtype != torch.int8):
        raise TypeError(f"{name} takes int8 operands; got {x.dtype} and "
                        f"{y.dtype}")
    if not int8 and (x.dtype != y.dtype or x.dtype not in _DTYPE_TAG):
        raise TypeError(f"{name} takes float32 or bfloat16 operands of one "
                        f"dtype; got {x.dtype} and {y.dtype}")
    if x.device != y.device:
        raise ValueError(f"{name} operands lie on {x.device} and {y.device}")
    if not (x.is_contiguous() and (y.t().is_contiguous() if y_kmajor
                                   else y.is_contiguous())):
        raise ValueError(f"{name} takes contiguous row-major operands"
                         + (" (the second K-major)" if y_kmajor else ""))
    if max(*x.shape, *y.shape) > _INT_MAX:
        raise ValueError(f"{name} dims must fit a 32-bit int")


def require_cuda(name: str, dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors; got {dev}")


def launch(name: str, dtype: torch.dtype, *args) -> None:
    """Launch ``<name>_<dtype tag>`` (the input dtype of an f32/bf16 kernel,
    the output dtype of an int8 one) with ``args`` (tensors, passed as their
    data pointers, None as a null pointer, and ints) on the current stream
    of the first tensor's device, and raise on a non-zero cudaError_t.
    Every tensor lies on that one CUDA device."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    require_cuda(name, dev)
    fn = _build.launcher(name, _DTYPE_TAG[dtype])
    stream = torch.cuda.current_stream(dev).cuda_stream
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor)
              else 0 if a is None else int(a) for a in args]
    with torch.cuda.device(dev):
        err = fn(*c_args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def check_q8(name: str, x, y, x_scale, y_scale, x_bands: int,
             y_bands: int, out_dtype, *, y_kmajor: bool = False) -> None:
    """``check`` for an int8 kernel, plus its f32 scale sidecars (``x_bands``
    and ``y_bands`` scales, one device with the operands) and its output
    dtype tag."""
    check(name, x, y, "mm" if name.startswith("tsm2") else "mmt", int8=True,
          y_kmajor=y_kmajor)
    for label, s, bands in (("x", x_scale, x_bands), ("y", y_scale, y_bands)):
        if s.dtype != torch.float32 or s.numel() != bands:
            raise ValueError(f"{name} takes {bands} f32 {label} scales; got "
                             f"{tuple(s.shape)} {s.dtype}")
        if s.device != x.device or not s.is_contiguous():
            raise ValueError(f"{name} scales must be contiguous on "
                             f"{x.device}")
    if out_dtype not in _DTYPE_TAG:
        raise TypeError(f"{name} writes float32 or bfloat16; got {out_dtype}")
