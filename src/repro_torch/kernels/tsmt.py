"""TSMT wrapper: C[a,b] = X[m,a]^T @ Y[m,b] with m >> a, b.

Replaces the TPU kernel ``src/repro/kernels/tsmt.py::tsmt_pallas`` with the
CUDA kernel in ``csrc/tsmt.cu``. On the H100 it is bound by the bytes of X
and Y, read once, plus the 2 * S * a * b * 4 bytes of f32 partials past
one slice. Its output has few tiles (one at a, b <= 4), so one block per
tile would pull all of m through one SM; instead one launch spreads m over
the card: ``perf_model.tsmt_slices`` plans S slices (tiles x S about
``TSMT_BLOCKS_PER_SM`` blocks per SM, whole 8-row blocks, at least
``TSMT_MIN_SLICE_ROWS`` rows each), each block reduces its slice into an
f32 (S, a, b) workspace, and each tile's last block (a ticket counter,
the only atomic) sums the S partials in slice order and writes C once, so
results are bit-identical from run to run. S = 1 stores straight into C;
see the source's note.

``tsmt_split`` replaces ``tsmt.py::tsmt_pallas_split`` with
``csrc/tsmt_split.cu``: the same block body over one of S contiguous m
slices per grid z index, writing (S, a, b) f32 partials. It is bound by
the bytes of X and Y; splitting m multiplies the blocks by S, so at
PowerSGD's Q projection (32 output tiles) the whole card pulls from
memory. ``kernels/reduce.py`` sums the partials.

``tsmt_q8`` replaces ``quant.py::tsmt_q8_pallas`` with
``csrc/tsmt_q8.cu`` and ``tsmt_q8_split`` replaces
``quant.py::tsmt_q8_pallas_split`` with ``csrc/tsmt_q8_split.cu``: the
same block body loading int8 X and Y, both with per-band scales along m,
summing each band exactly in int32 and dequantizing it with the band's
two scales before it is added. Bound by the bytes of X and Y at 1 byte
an element. ``tsmt_q8`` spreads m over the card as ``tsmt`` does; its
slices, and a split kernel's, are whole bands.

CPU tensors take the plain versions (``ref.tsmt_ref``,
``ref.tsmt_split_ref``, ``ref.tsmt_q8_ref``, ``ref.tsmt_q8_split_ref``);
CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch

from repro_torch.core import perf_model
from repro_torch.kernels import _launch, ref

launches = 0         # tsmt kernel launches; chip_smoke.py resets and reads
split_launches = 0   # tsmt_split kernel launches, likewise
q8_launches = 0      # tsmt_q8 kernel launches, likewise
q8_split_launches = 0   # tsmt_q8_split kernel launches, likewise


def tsmt(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    global launches
    _launch.check("tsmt", x, y, "mmt")
    if x.device.type == "cpu":
        return ref.tsmt_ref(x, y)
    (m, a), b = x.shape, y.shape[1]
    out = torch.empty((a, b), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    splits, slice_ = _plan(m, a, b, x.device, x.dtype)
    _launch.launch("tsmt", x.dtype, x, y, out, m, a, b, splits, slice_,
                   _workspace(splits, a, b, x.device))
    launches += 1
    return out


def _plan(m: int, a: int, b: int, device: torch.device, dtype,
          band: int | None = None) -> tuple[int, int]:
    """(S, slice) the sequential kernel launches with for X[m,a]^T Y[m,b]
    on ``device`` (``dtype`` int8 with the scale ``band`` for tsmt_q8)."""
    spec = perf_model.device_spec(perf_model.H100, device)
    return perf_model.tsmt_slices(m, a, b, spec, dtype, quantum=band)


def _workspace(splits: int, a: int, b: int, device: torch.device):
    """The one-launch kernel's scratch: (S, a, b) f32 partials, then one
    int32 counter per output tile (cleared by the launcher); None at
    S = 1, which stores straight into C."""
    if splits <= 1:
        return None
    ga, gb, _ = perf_model.tsmt_grid(0, a, b)
    return torch.empty(splits * a * b + ga * gb, dtype=torch.float32,
                       device=device)


def tsmt_split(x: torch.Tensor, y: torch.Tensor, splits: int,
               block_m: int) -> torch.Tensor:
    """(S, a, b) f32 partials of X^T Y over S contiguous m slices of
    ``ref.split_len(m, S, block_m)`` rows each."""
    global split_launches
    _launch.check("tsmt_split", x, y, "mmt")
    if x.device.type == "cpu":
        return ref.tsmt_split_ref(x, y, splits, block_m)
    (m, a), b = x.shape, y.shape[1]
    out = torch.empty((splits, a, b), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    _launch.launch("tsmt_split", x.dtype, x, y, out, m, a, b, splits,
                   ref.split_len(m, splits, block_m))
    split_launches += 1
    return out


def tsmt_q8(x: torch.Tensor, y: torch.Tensor, x_scale: torch.Tensor,
            y_scale: torch.Tensor, band: int, out_dtype) -> torch.Tensor:
    """C[a,b] = sum over m bands j of int32(X8[j]^T Y8[j]) * sX[j] * sY[j]
    in ``out_dtype``: ``x``/``y`` int8, both scales ceil(m / band) f32."""
    global q8_launches
    (m, a), b = x.shape, y.shape[1]
    bands = -(-m // band)
    _launch.check_q8("tsmt_q8", x, y, x_scale, y_scale, bands, bands,
                     out_dtype)
    if x.device.type == "cpu":
        return ref.tsmt_q8_ref(x, y, x_scale, y_scale, band, out_dtype)
    out = torch.empty((a, b), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    splits, slice_ = _plan(m, a, b, x.device, torch.int8, band)
    _launch.launch("tsmt_q8", out_dtype, x, y, x_scale, y_scale, out, m, a,
                   b, band, splits, slice_,
                   _workspace(splits, a, b, x.device))
    q8_launches += 1
    return out


def tsmt_q8_split(x: torch.Tensor, y: torch.Tensor, x_scale: torch.Tensor,
                  y_scale: torch.Tensor, band: int,
                  splits: int) -> torch.Tensor:
    """(S, a, b) f32 partials of ``tsmt_q8`` over S contiguous m slices of
    ``ref.split_len(m, S, band)`` rows (whole bands) each."""
    global q8_split_launches
    (m, a), b = x.shape, y.shape[1]
    bands = -(-m // band)
    _launch.check_q8("tsmt_q8_split", x, y, x_scale, y_scale, bands, bands,
                     torch.float32)
    if x.device.type == "cpu":
        return ref.tsmt_q8_split_ref(x, y, x_scale, y_scale, band, splits)
    out = torch.empty((splits, a, b), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    _launch.launch("tsmt_q8_split", torch.float32, x, y, x_scale, y_scale,
                   out, m, a, b, band, splits,
                   ref.split_len(m, splits, band))
    q8_split_launches += 1
    return out
