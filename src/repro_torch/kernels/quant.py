"""Int8 quantization helpers and offline weight records.

Counterpart of the helper half of ``src/repro/kernels/quant.py``
(``quantize_blocks`` :56, ``dequantize_blocks`` :75, ``quantize_tensor``
:85, ``fake_quant`` :96, the weight records :102-162). The JAX package
computes these with ``jnp`` outside any Pallas kernel, so plain torch is
their counterpart here; the five int8 kernels they feed live in
``csrc/*_q8*.cu`` behind ``kernels/{tsm2r,tsm2l,tsmt}.py``.

The arithmetic is the JAX package's, step for step, so codes and scales
are the same bits on both sides: upcast to f32, ``scale = absmax / 127``
(an all-zero band gets scale 1, so it round-trips exactly), divide,
round half to even, clip to +-127, cast to int8.

Bands: the tall operand gets one scale per ``block_rows``-row band. JAX
pads the operand to whole bands with zeros, which change no absmax; here
the last band may be short and holds only the real rows, so nothing is
copied to pad.

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

QMAX = 127.0


def _absmax(flat: torch.Tensor) -> torch.Tensor:
    """max |x| over dim 1 of a 2-D tensor, in f32 (exact: upcasting the
    extremes equals taking them of the upcast values)."""
    lo, hi = torch.aminmax(flat, dim=1)
    return torch.maximum(hi.float(), -lo.float())


def _scale(absmax: torch.Tensor) -> torch.Tensor:
    return torch.where(absmax > 0.0, absmax / QMAX, torch.ones_like(absmax))


def _codes(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """round(x / rows) clipped to +-127 as int8; ``rows`` broadcasts over
    the trailing dims. The division runs in f32 (a bf16 ``x`` is promoted
    exactly)."""
    return torch.div(x, rows).round_().clamp_(-QMAX, QMAX).to(torch.int8)


def _per_row(scale: torch.Tensor, band: int, x_shape) -> torch.Tensor:
    m = x_shape[0]
    rows = scale.reshape(-1).repeat_interleave(band)[:m]
    return rows.reshape((m,) + (1,) * (len(x_shape) - 1))


def quantize_blocks(x: torch.Tensor, block_rows: int):
    """Symmetric int8 quantization per ``block_rows``-row band.

    Returns ``(q, scale)``: ``q`` int8 of ``x.shape``, ``scale`` a
    ``(ceil(m / block_rows), 1)`` f32 sidecar; ``dequant = q *
    scale[band]``. The last band may be short."""
    m = x.shape[0]
    if block_rows < 1:
        raise ValueError(f"block_rows must be positive; got {block_rows}")
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


def quantize_tensor(x: torch.Tensor):
    """Per-tensor symmetric int8; the scale is a ``(1, 1)`` f32 tensor."""
    absmax = (_absmax(x.reshape(1, -1)) if x.numel()
              else torch.zeros(1, device=x.device))
    scale = _scale(absmax)
    return _codes(x, scale), scale.reshape(1, 1)


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
        w = (torch.stack([named[n] for n in names]) if layout.stacked(names)
             else named[names[0]])
        records[path] = quantize_param(w, block_rows=block_rows)
        for n in names:
            release_param(named[n])
    return QuantizedWeights(params, records)


def has_quantized_weights(params) -> bool:
    return isinstance(params, QuantizedWeights) and bool(params.records)


def _groups(q: QuantizedWeights):
    named = dict(q.model.named_parameters())
    groups = layout.jax_leaves(named)
    for path, rec in q.records.items():
        yield rec, [named[n] for n in groups[path]], layout.stacked(
            groups[path])


@torch.no_grad()
def dequantize_weights(q: QuantizedWeights) -> torch.nn.Module:
    """Fill every recorded parameter of ``q.model`` with its dequantized
    values, in the parameter's own dtype, and return the model.
    ``release_weights`` frees them again."""
    for rec, params, stacked in _groups(q):
        dense = dequantize_param(rec, params[0].dtype)
        for i, p in enumerate(params):
            p.data = dense[i] if stacked else dense
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
