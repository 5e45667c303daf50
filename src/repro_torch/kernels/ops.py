"""Differentiable entries for the TSM2X kernels, with split-K resolution.

Counterpart of ``src/repro/kernels/ops.py`` (split resolution :156-267,
``tsm2r`` :354-438, ``tsm2l`` :445-492, ``tsmt`` :499-595).

Split resolution: ``GemmPolicy.split`` pins S (an int, or "never" for
S = 1), else the occupancy-aware chooser of ``core/perf_model.py`` picks
it ("auto"). S is then clamped so every slice owns at
least one block of the reduction (``TSM2R_BLOCK_K`` k rows, ``TSMT_BLOCK_M``
m rows). Past S = 1 the split kernel writes (S, ...) f32 partials and
``reduce.reduce_partials`` sums them. The reduction is cut into S
contiguous slices of whole blocks, as the JAX package pads it to; the
kernels mask ragged edges themselves, so nothing is copied to pad
(the JAX package's ``_pad_to``). Operands are made contiguous (a no-op
when they already are) and handed to the per-kernel wrappers, which run
the plain versions for CPU tensors and launch the kernels for CUDA
tensors.

Under ``GemmPolicy.quant="int8"`` (JAX ``ops.py:361-392, 453-457,
507-535``) the tall operand is quantized per ``perf_model.Q8_BAND``-row
band and the small operand of tsm2r/tsm2l per tensor (both tsmt operands
per band), the int8 kernel runs, split partials (already dequantized)
go through ``reduce.reduce_partials`` as usual, and the output comes back
in the caller's dtype. Split resolution then prices int8 operands, and
the tsmt slice quantum is the band.

Each entry is a ``torch.autograd.Function`` whose backward sends the
cotangent GEMMs back through ``core.tsmm`` under
``tsmm.backward_policy`` of the policy captured at forward time, as the
JAX package's custom VJPs do (the VJP of one tall-and-skinny class lands
in another):

    tsm2r/tsm2l:  C = A B        Abar = Chat B^T,  Bbar = A^T Chat (tsmm_t)
    tsmt:         C = X^T Y      Xbar = Y Chat^T,  Ybar = X Chat
"""

from __future__ import annotations

import torch

from repro_torch.core import perf_model
from repro_torch.kernels import quant, reduce, ref
from repro_torch.kernels import tsm2l as _tsm2l
from repro_torch.kernels import tsm2r as _tsm2r
from repro_torch.kernels import tsmt as _tsmt

# The TSMT kernel sizes its per-block partials for a small output dim; past
# this the shape belongs to the dense path. Copied from the JAX package's
# ``analysis/contracts.py`` (TSMT_MAX_B), so both refuse the same shapes.
TSMT_MAX_B = 512


def _dispatcher():
    # Deferred: core.tsmm imports this module.
    from repro_torch.core import tsmm
    return tsmm


def _policy_split(policy) -> int | None:
    """The policy's split pin as an int, or None for "auto"."""
    s = policy.split
    if s == "never":
        return 1
    if s == "auto":
        return None
    return int(s)


def resolve_params(kind: str, m: int, d1: int, d2: int, dtype, policy, *,
                   device: torch.device | None = None) -> dict:
    """The launch parameters dispatch would use, without running: for
    tsm2r ``{"splits", "block_k"}``, for tsmt ``{"splits", "block_m"}``,
    for tsm2l ``{}`` (it has no reduction to split). ``(d1, d2)`` are
    ``(k, n)`` for tsm2r/tsm2l, ``(a, b)`` for tsmt. ``device`` is where
    the operands lie: on a card the chooser counts blocks against its own
    SM count; on the CPU, where the plain versions have no SMs to occupy,
    "auto" resolves to S = 1 (pins still split). Without ``device`` the
    chooser models the data sheet's H100 (``perf_model.H100``). Under
    ``policy.quant="int8"`` the chooser prices int8 operands and the tsmt
    slice quantum is the scale band."""
    if kind == "tsm2l":
        return {}
    if kind not in ("tsm2r", "tsmt"):
        raise ValueError(f"unknown kernel kind {kind!r}: valid kinds are "
                         "tsm2r, tsm2l, tsmt")
    splits = _policy_split(policy)
    if policy.quant == "int8":
        dtype = torch.int8
    if kind == "tsm2r":
        depth, block, choose = (d1, perf_model.TSM2R_BLOCK_K,
                                perf_model.choose_splits_tsm2r)
    else:
        depth, block, choose = (m, perf_model.tsmt_block_m(dtype),
                                perf_model.choose_splits_tsmt)
    if splits is None and device is not None and device.type == "cpu":
        splits = 1
    if splits is None:
        spec = perf_model.H100
        if device is not None:
            spec = perf_model.device_spec(spec, device)
        splits = choose(m, d1, d2, spec, dtype)
    # Each slice must own >= one block: past that, slices are pure padding.
    splits = max(1, min(int(splits), perf_model.max_splits(depth, block)))
    # Whole-block slices may cover the depth in fewer than S; drop the
    # slices that would be empty.
    splits = max(1, -(-depth // ref.split_len(depth, splits, block)))
    key = "block_k" if kind == "tsm2r" else "block_m"
    return {"splits": splits, key: block}


def _resolve(kind, x, d1, d2, policy):
    return resolve_params(kind, x.shape[0], d1, d2, x.dtype, policy,
                          device=x.device)


# ---------------------------------------------------------------------------
# Forward implementations
# ---------------------------------------------------------------------------

def _tsm2r_impl(a, b, policy):
    tsmm = _dispatcher()
    a, b = a.contiguous(), b.contiguous()
    (m, k), n = a.shape, b.shape[1]
    p = _resolve("tsm2r", a, k, n, policy)
    s = p["splits"]
    q8 = policy.quant == "int8"
    tsmm.note_launch("tsm2r_q8" if q8 else "tsm2r",
                     perf_model.tsm2r_grid(m, k, n, s), s)
    if q8:
        band = perf_model.Q8_BAND
        a_q, a_s = quant.quantize_blocks(a, band)
        b_q, b_s = quant.quantize_tensor(b)
        if s == 1:
            return _tsm2r.tsm2r_q8(a_q, b_q, a_s, b_s, band, a.dtype)
        parts = _tsm2r.tsm2r_q8_split(a_q, b_q, a_s, b_s, band, s,
                                      p["block_k"])
        return _epilogue(parts, a.dtype)
    if s == 1:
        return _tsm2r.tsm2r(a, b)
    parts = _tsm2r.tsm2r_split(a, b, s, p["block_k"])
    return _epilogue(parts, a.dtype)


def _tsmt_impl(x, y, policy):
    tsmm = _dispatcher()
    x, y = x.contiguous(), y.contiguous()
    (m, a), b = x.shape, y.shape[1]
    p = _resolve("tsmt", x, a, b, policy)
    s = p["splits"]
    q8 = policy.quant == "int8"
    # S = 1 is the sequential kernel, which spreads m over its own plan of
    # slices in one launch: record the grid that runs.
    slices = s if s > 1 else _tsmt._plan(
        m, a, b, x.device, torch.int8 if q8 else x.dtype, p["block_m"])[0]
    tsmm.note_launch("tsmt_q8" if q8 else "tsmt",
                     perf_model.tsmt_grid(m, a, b, slices), s)
    if q8:
        band = p["block_m"]
        x_q, x_s = quant.quantize_blocks(x, band)
        y_q, y_s = quant.quantize_blocks(y, band)
        if s == 1:
            return _tsmt.tsmt_q8(x_q, y_q, x_s, y_s, band, x.dtype)
        parts = _tsmt.tsmt_q8_split(x_q, y_q, x_s, y_s, band, s)
        return _epilogue(parts, x.dtype)
    if s == 1:
        return _tsmt.tsmt(x, y)
    parts = _tsmt.tsmt_split(x, y, s, p["block_m"])
    return _epilogue(parts, x.dtype)


def _epilogue(parts, out_dtype):
    out, kernel = reduce.reduce_partials(parts, out_dtype)
    if kernel:
        _dispatcher().note_launch("reduce", parts.shape, parts.shape[0])
    return out


def _tsm2l_impl(a, b, policy):
    a, b = a.contiguous(), b.contiguous()
    if policy.quant == "int8":
        _dispatcher().note_launch("tsm2l_q8", (), 1)
        band = perf_model.Q8_BAND
        a_q, a_s = quant.quantize_blocks(a, band)
        b_q, b_s = quant.quantize_tensor(b)
        return _tsm2l.tsm2l_q8(a_q, b_q, a_s, b_s, band, a.dtype)
    _dispatcher().note_launch("tsm2l", (), 1)
    return _tsm2l.tsm2l(a, b)


# ---------------------------------------------------------------------------
# Autograd: the backward re-dispatches through tsmm
# ---------------------------------------------------------------------------

class _MatMul(torch.autograd.Function):
    """C = A @ B through tsm2r or tsm2l; the backward as the JAX VJPs:
    ``da = tsmm(ct, b^T)``, ``db = tsmm_t(a, ct)``."""

    @staticmethod
    def forward(ctx, a, b, kind, policy):
        ctx.save_for_backward(a, b)
        ctx.policy = policy
        if kind == "tsm2l":
            return _tsm2l_impl(a, b, policy)
        return _tsm2r_impl(a, b, policy)

    @staticmethod
    def backward(ctx, ct):
        a, b = ctx.saved_tensors
        tsmm = _dispatcher()
        bp = tsmm.backward_policy(ctx.policy)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = tsmm.tsmm(ct, b.transpose(0, 1), policy=bp).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = tsmm.tsmm_t(a, ct, policy=bp).to(b.dtype)
        return da, db, None, None


class _MatMulT(torch.autograd.Function):
    """C = X^T @ Y through tsmt; the backward as the JAX VJP:
    ``dx = tsmm(y, ct^T)``, ``dy = tsmm(x, ct)``."""

    @staticmethod
    def forward(ctx, x, y, policy):
        ctx.save_for_backward(x, y)
        ctx.policy = policy
        return _tsmt_impl(x, y, policy)

    @staticmethod
    def backward(ctx, ct):
        x, y = ctx.saved_tensors
        tsmm = _dispatcher()
        bp = tsmm.backward_policy(ctx.policy)
        dx = dy = None
        if ctx.needs_input_grad[0]:
            dx = tsmm.tsmm(y, ct.transpose(0, 1), policy=bp).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dy = tsmm.tsmm(x, ct, policy=bp).to(y.dtype)
        return dx, dy, None


def _policy(policy):
    return policy if policy is not None else _dispatcher().current_policy()


def tsm2r(a: torch.Tensor, b: torch.Tensor, *, policy=None) -> torch.Tensor:
    """C[m,n] = A[m,k] @ B[k,n], m ~ k >> n. The paper's TSM2R.
    Differentiable. The policy's ``split`` pins the split factor (S = 1 is
    the sequential kernel)."""
    return _MatMul.apply(a, b, "tsm2r", _policy(policy))


def tsm2l(a: torch.Tensor, b: torch.Tensor, *, policy=None) -> torch.Tensor:
    """C[m,n] = A[m,k] @ B[k,n], m >> k ~ n. The paper's TSM2L.
    Differentiable."""
    return _MatMul.apply(a, b, "tsm2l", _policy(policy))


def tsmt(x: torch.Tensor, y: torch.Tensor, *, policy=None) -> torch.Tensor:
    """C[a,b] = X[m,a]^T @ Y[m,b], m >> a, b. Differentiable.

    Raises ``ValueError`` when the small output dim b exceeds
    ``TSMT_MAX_B``, or the scope's ``max_skinny_t`` when a policy raised the
    classifier past it, as the JAX entry does; reorient the operands
    (``tsmt(y, x).T``) or dispatch through ``tsmm.tsmm_t``.
    """
    p = _policy(policy)
    limit = max(TSMT_MAX_B, p.max_skinny_t)
    if y.dim() == 2 and y.shape[1] > limit:
        raise ValueError(
            f"tsmt small output dim b={y.shape[1]} exceeds the limit "
            f"({limit}). Orient the operands so the larger output dim comes "
            "first (C = tsmt(y, x).T), or dispatch through tsmm.tsmm_t, "
            "which classifies such shapes dense.")
    return _MatMulT.apply(x, y, p)


# Re-exported plain versions, as the JAX entry re-exports its oracles.
tsm2r_ref = ref.tsm2r_ref
tsm2l_ref = ref.tsm2l_ref
tsmt_ref = ref.tsmt_ref
