"""Int8 quantization helpers and offline weight records.

Counterpart of the helper half of ``src/repro/kernels/quant.py``
(``quantize_blocks`` :56, ``dequantize_blocks`` :75, ``quantize_tensor``
:85, ``fake_quant`` :96, the weight records :102-162). The JAX package
computes these with ``jnp`` outside any Pallas kernel; the five int8
kernels they feed live in ``csrc/*_q8*.cu`` behind
``kernels/{tsm2r,tsm2l,tsmt}.py``.

The arithmetic is the JAX package's, step for step, so codes and scales
are the same bits on both sides: upcast to f32, ``scale = absmax / 127``
(an all-zero band gets scale 1, so it round-trips exactly), divide,
round half to even, clip to +-127, cast to int8. Both divisions are IEEE
divisions by a tensor: PyTorch's CUDA division by a Python number
multiplies by its rounded reciprocal instead, which can move a scale by
one bit.

Two bodies, chosen by where the operand lies: a CPU tensor runs the plain
torch code (``quantize_blocks_ref``, ``quantize_tensor_ref``: the plain
versions the tests hold against JAX); a CUDA
tensor (f32 or bf16) runs the fused pass ``csrc/quantize.cu`` (an absmax
launch and a codes launch, bit-identical to the plain code, which
``chip_smoke.py`` checks on the card) or raises. ``launches`` counts its
calls.

Bands: the tall operand gets one scale per ``block_rows``-row band. JAX
pads the operand to whole bands with zeros, which change no absmax; here
the last band may be short and holds only the real rows, so nothing is
copied to pad.

``quantize_tensor(x, kmajor=True)`` writes the codes of a 2-D [k, n] x
K-major: a [k, n] tensor whose transpose is contiguous, the layout the
int8 TSM2R's wgmma body reads B in (``kernels/tsm2r.py``). The values are
the row-major codes'.

Weight records: ``quantize_weights`` picks the leaves the JAX package's
``quantize_weights`` picks (every 2-D floating leaf of at least
``min_size`` elements), deciding on the JAX layout (``repro_torch.layout``),
where a segment's layers are stacked: a per-layer vector is one ``(L, d)``
record there, and the 3-D layer weights stay dense. The port keeps the
records beside the model in a ``QuantizedWeights`` and frees the dense
tensors they replace; ``serve/engine.py`` dequantizes them at the entry of
every step, as the JAX engine does, and frees them again after it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from repro_torch import layout
from repro_torch.kernels import _launch

QMAX = 127.0

launches = 0   # fused quantize passes (csrc/quantize.cu); chip_smoke.py reads


def _absmax(flat: torch.Tensor) -> torch.Tensor:
    """max |x| over dim 1 of a 2-D tensor, in f32 (exact: upcasting the
    extremes equals taking them of the upcast values)."""
    lo, hi = torch.aminmax(flat, dim=1)
    return torch.maximum(hi.float(), -lo.float())


def _scale(absmax: torch.Tensor) -> torch.Tensor:
    qmax = absmax.new_full((), QMAX)   # a tensor divisor: IEEE division
    return torch.where(absmax > 0.0, absmax / qmax, torch.ones_like(absmax))


def _codes(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """round(x / rows) clipped to +-127 as int8; ``rows`` broadcasts over
    the trailing dims. The division runs in f32 (a bf16 ``x`` is promoted
    exactly)."""
    return torch.div(x, rows).round_().clamp_(-QMAX, QMAX).to(torch.int8)


def _per_row(scale: torch.Tensor, band: int, x_shape) -> torch.Tensor:
    m = x_shape[0]
    rows = scale.reshape(-1).repeat_interleave(band)[:m]
    return rows.reshape((m,) + (1,) * (len(x_shape) - 1))


def _fused(x: torch.Tensor, rows: int, band: int, kmajor: bool = False):
    """The CUDA quantize pass over ``x`` as ``rows`` rows: (codes of
    ``x.shape``, K-major with ``kmajor``; ceil(rows / band) f32 scales)."""
    global launches
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the CUDA quantize pass takes float32 or bfloat16; "
                        f"got {x.dtype}")
    x = x.contiguous()
    bands = -(-rows // band)
    if kmajor:
        q = torch.empty(tuple(reversed(x.shape)), dtype=torch.int8,
                        device=x.device).t()
    else:
        q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if x.numel() == 0:   # nothing to launch: every band is all-zero
        return q, torch.ones(bands, device=x.device)
    cols = x.numel() // rows
    if max(rows, cols, band) > _launch._INT_MAX:
        raise ValueError("the CUDA quantize pass takes rows, cols and band "
                         "that fit a 32-bit int")
    amax = torch.empty(bands, dtype=torch.int32, device=x.device)
    scale = torch.empty(bands, dtype=torch.float32, device=x.device)
    _launch.launch("quantize", x.dtype, x, amax, scale, q, rows, cols, band,
                   int(kmajor))
    launches += 1
    return q, scale


def quantize_blocks(x: torch.Tensor, block_rows: int):
    """Symmetric int8 quantization per ``block_rows``-row band.

    Returns ``(q, scale)``: ``q`` int8 of ``x.shape``, ``scale`` a
    ``(ceil(m / block_rows), 1)`` f32 sidecar; ``dequant = q *
    scale[band]``. The last band may be short."""
    if block_rows < 1:
        raise ValueError(f"block_rows must be positive; got {block_rows}")
    m = x.shape[0]
    if x.device.type == "cuda" and m:
        q, scale = _fused(x, m, block_rows)
        return q, scale[:, None]
    return quantize_blocks_ref(x, block_rows)


def quantize_blocks_ref(x: torch.Tensor, block_rows: int):
    """``quantize_blocks``' plain torch body, on any device: what CPU
    tensors run and what the CUDA pass is held against."""
    m = x.shape[0]
    flat = x.reshape(m, -1)
    full = m // block_rows * block_rows
    parts = []
    if full and flat.shape[1]:
        parts.append(_absmax(flat[:full].reshape(full // block_rows, -1)))
    elif full:
        parts.append(torch.zeros(full // block_rows, device=x.device))
    if full < m:
        tail = flat[full:].reshape(1, -1)
        parts.append(_absmax(tail) if tail.shape[1]
                     else torch.zeros(1, device=x.device))
    absmax = (torch.cat(parts) if parts
              else torch.zeros(0, device=x.device))
    scale = _scale(absmax)
    return _codes(x, _per_row(scale, block_rows, x.shape)), scale[:, None]


def dequantize_blocks(q: torch.Tensor, scale: torch.Tensor,
                      dtype=torch.float32, *, block_rows: int | None = None):
    """Inverse of ``quantize_blocks``. ``block_rows`` defaults to the JAX
    rule, ``rows // bands`` (whole bands); pass it for a short last
    band."""
    band = block_rows or q.shape[0] // max(scale.shape[0], 1)
    return (q.float() * _per_row(scale, band, q.shape)).to(dtype)


def quantize_tensor(x: torch.Tensor, *, kmajor: bool = False):
    """Per-tensor symmetric int8; the scale is a ``(1, 1)`` f32 tensor.
    ``kmajor`` (2-D ``x`` only): the codes come K-major, the same values
    in the layout of a contiguous transpose."""
    if kmajor and x.dim() != 2:
        raise ValueError(f"K-major codes need a 2-D operand; got "
                         f"{tuple(x.shape)}")
    if x.device.type == "cuda":
        rows = x.shape[0] if kmajor and x.shape[0] else 1   # one band
        q, scale = _fused(x, rows, rows, kmajor)
        return q, scale.reshape(1, 1)
    return quantize_tensor_ref(x, kmajor=kmajor)


def quantize_tensor_ref(x: torch.Tensor, *, kmajor: bool = False):
    """``quantize_tensor``'s plain torch body, on any device."""
    absmax = (_absmax(x.reshape(1, -1)) if x.numel()
              else torch.zeros(1, device=x.device))
    scale = _scale(absmax)
    q = _codes(x, scale)
    return (q.t().contiguous().t() if kmajor else q), scale.reshape(1, 1)


def fake_quant(x: torch.Tensor) -> torch.Tensor:
    """Quantize then dequantize, in ``x.dtype``: the int8 wire format of
    PowerSGD's factors."""
    q, scale = quantize_tensor(x)
    return (q.float() * scale[0, 0]).to(x.dtype)


# ---------------------------------------------------------------------------
# Offline weight records (serving)
# ---------------------------------------------------------------------------

def is_record(t) -> bool:
    return isinstance(t, dict) and "q8" in t and "q8_scale" in t


def quantize_param(w: torch.Tensor, *, block_rows: int = 256) -> dict:
    """Record of one 2-D weight, ``{"q8", "q8_scale"}``; one per-tensor
    band when ``block_rows`` does not divide the rows (the JAX rule)."""
    m = w.shape[0]
    br = block_rows if block_rows and m % block_rows == 0 else m
    q, scale = quantize_blocks(w, br)
    return {"q8": q, "q8_scale": scale}


def dequantize_param(rec: dict, dtype=torch.float32) -> torch.Tensor:
    return dequantize_blocks(rec["q8"], rec["q8_scale"], dtype)


@dataclasses.dataclass(eq=False)
class QuantizedWeights:
    """A model whose large leaves are held as int8 records.

    ``model``: the module; each parameter that a record replaces holds an
    empty tensor of its dtype until ``dequantize_weights`` fills it.
    ``records``: ``{JAX leaf path: {"q8", "q8_scale"}}``."""

    model: torch.nn.Module
    records: dict

    def nbytes(self) -> int:
        """Bytes the records hold (codes and scales)."""
        return sum(t.numel() * t.element_size()
                   for rec in self.records.values() for t in rec.values())


def release_param(p: torch.Tensor) -> None:
    """Hold ``p`` empty (its dtype and device kept) until
    ``dequantize_weights`` fills it: the rule for a parameter that a
    record stands for."""
    p.data = torch.empty(0, dtype=p.dtype, device=p.device)


@torch.no_grad()
def quantize_weights(params: torch.nn.Module, *, block_rows: int = 256,
                     min_size: int = 4096) -> QuantizedWeights:
    """Records of every 2-D floating leaf of at least ``min_size``
    elements in the JAX layout. In place: the dense parameters that the
    records replace are freed (their memory is what records save)."""
    named = dict(params.named_parameters())
    records = {}
    for path, names in layout.jax_leaves(named).items():
        shape = layout.jax_shape(named, names)
        if (len(shape) != 2 or math.prod(shape) < min_size
                or not named[names[0]].is_floating_point()):
            continue
        w = (torch.stack([named[n] for n in names]).reshape(shape)
             if layout.stacked(names) else named[names[0]])
        records[path] = quantize_param(w, block_rows=block_rows)
        for n in names:
            release_param(named[n])
    return QuantizedWeights(params, records)


def has_quantized_weights(params) -> bool:
    return isinstance(params, QuantizedWeights) and bool(params.records)


def _groups(q: QuantizedWeights):
    """(record, its parameters in index order, the record's stacked axes
    in the JAX layout) for every record."""
    named = dict(q.model.named_parameters())
    groups = layout.jax_leaves(named)
    for path, rec in q.records.items():
        names = groups[path]
        yield rec, [named[n] for n in names], len(layout.jax_path(
            names[0])[1])


@torch.no_grad()
def dequantize_weights(q: QuantizedWeights) -> torch.nn.Module:
    """Fill every recorded parameter of ``q.model`` with its dequantized
    values, in the parameter's own dtype, and return the model.
    ``release_weights`` frees them again."""
    for rec, params, n_stacked in _groups(q):
        dense = dequantize_param(rec, params[0].dtype)
        if n_stacked:   # one tensor a parameter, in index order
            dense = dense.reshape(len(params), *dense.shape[n_stacked:])
        for i, p in enumerate(params):
            p.data = dense[i] if n_stacked else dense
    return q.model


def release_weights(q: QuantizedWeights) -> None:
    """Free the dense tensors ``dequantize_weights`` filled in."""
    for _, params, _ in _groups(q):
        for p in params:
            release_param(p)


@contextlib.contextmanager
def dequantized(params):
    """The model to run one step with: ``params`` itself when it holds no
    records, else its records dequantized for the scope and freed after
    it."""
    if not isinstance(params, QuantizedWeights):
        yield params
        return
    model = dequantize_weights(params)
    try:
        yield model
    finally:
        release_weights(params)
