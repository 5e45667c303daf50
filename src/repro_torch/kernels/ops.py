"""Differentiable entries for the TSM2X kernels, with split-K resolution.

Counterpart of ``src/repro/kernels/ops.py`` (split resolution :156-267,
``tsm2r`` :354-438, ``tsm2l`` :445-492, ``tsmt`` :499-595).

Split resolution: ``GemmPolicy.split`` pins S (an int, or "never" for
S = 1), else a record of ``GemmPolicy.tuning_table`` gives the measured
S, else the occupancy-aware chooser of ``core/perf_model.py`` picks it
("auto"; JAX ``_tuned_params`` / ``_analytic_spec``, ``ops.py:124-153``).
S is then clamped so every slice owns at least one block of the
reduction (``TSM2R_BLOCK_K`` k rows, ``TSMT_BLOCK_M`` m rows). Past S = 1 the split kernel writes (S, ...) f32 partials and
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

Operand dtypes (JAX ``jnp.dot`` with ``preferred_element_type=f32``,
``kernels/tsm2r.py:53,88``, ``tsm2l.py:43-44,74``, ``tsmt.py:54,88``):
the kernels take float32 or bfloat16 pairs of one dtype, so a mixed
float32/bfloat16 pair, and float16, are widened to float32 before the
kernel (``_kernel_pair``); under int8 only a float16 operand is widened,
since the quantize pass reads each operand on its own. The output is the
left operand's dtype, as in JAX: a kernel that cannot write it (float16)
writes float32, which is then cast once.

Under ``GemmPolicy(verify_contracts=True)`` (JAX ``ops.py:317-346``)
``resolve_params`` states the resolved launch in the terms of
``analysis/contracts.py`` (``perf_model.kernel_params``: S, the body,
its tile and shared memory, the grid) and raises ``ValueError`` before
anything launches if a contract breaks. While ``tsmm.record_dispatches``
listens, every launch is recorded with the same statement, its grid from
``contracts.launch_grid``.

Each entry is a ``torch.autograd.Function`` whose backward sends the
cotangent GEMMs back through ``core.tsmm`` inside
``tsmm.backward_scope`` of the policy captured at forward time, as the
JAX package's custom VJPs do (the VJP of one tall-and-skinny class lands
in another):

    tsm2r/tsm2l:  C = A B        Abar = Chat B^T,  Bbar = A^T Chat (tsmm_t)
    tsmt:         C = X^T Y      Xbar = Y Chat^T,  Ybar = X Chat
"""

from __future__ import annotations

import torch

from repro_torch.analysis import contracts
from repro_torch.core import perf_model
from repro_torch.kernels import quant, reduce, ref
from repro_torch.kernels import tsm2l as _tsm2l
from repro_torch.kernels import tsm2r as _tsm2r
from repro_torch.kernels import tsmt as _tsmt

# The TSMT kernel sizes its per-block partials for a small output dim; past
# this the shape belongs to the dense path (a contract, so it lives in
# ``analysis/contracts.py``, as in the JAX package).
TSMT_MAX_B = contracts.TSMT_MAX_B


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
                   device: torch.device | None = None,
                   ptrs: tuple[int, int] = (0, 0)) -> dict:
    """The launch parameters dispatch would use, without running: for
    tsm2r ``{"splits", "block_k"}``, for tsmt ``{"splits", "block_m"}``,
    for tsm2l ``{}`` (it has no reduction to split). ``(d1, d2)`` are
    ``(k, n)`` for tsm2r/tsm2l, ``(a, b)`` for tsmt. ``device`` is where
    the operands lie: on a card the chooser counts blocks against its own
    SM count; on the CPU, where the plain versions have no SMs to occupy,
    "auto" resolves to S = 1 (pins still split). Without ``device`` the
    chooser models the data sheet's H100 (``perf_model.H100``). Under
    ``policy.quant="int8"`` the chooser prices int8 operands and the tsmt
    slice quantum is the scale band.

    S comes from, in order: a pinned ``policy.split``; the record of
    ``policy.tuning_table`` at (kind, shape bucket, effective dtype, the
    card's spec name, the executor of ``device``: "cuda" on a card and
    for ``device=None``, "torch-ref" on the CPU); S = 1 for CPU tensors;
    the chooser under the table's fitted constants for the bucket
    (``TuningTable.fitted_spec``; the card's spec without a table). The
    clamps below apply to a tuned S as to a chosen one.

    Under ``policy.verify_contracts`` the resolved launch (``ptrs``: the
    operands' base addresses) is checked against the contracts on the
    limits of ``device``'s card (the data sheet's without one), and a
    violation raises ``ValueError``, listing ``[rule] detail`` for each."""
    if kind not in contracts.KINDS:
        raise ValueError(f"unknown kernel kind {kind!r}: valid kinds are "
                         "tsm2r, tsm2l, tsmt")
    out_dtype = dtype
    q8 = policy.quant == "int8"
    if q8:
        dtype = torch.int8
    if kind == "tsm2l":
        if policy.verify_contracts:
            _verify(kind, m, d1, d2, dtype, 1, device, ptrs, out_dtype, q8,
                    policy)
        return {}
    splits = _policy_split(policy)
    if kind == "tsm2r":
        depth, block, choose = (d1, perf_model.TSM2R_BLOCK_K,
                                perf_model.choose_splits_tsm2r)
    else:
        depth, block, choose = (m, perf_model.tsmt_block_m(dtype),
                                perf_model.choose_splits_tsmt)
    spec = perf_model.H100
    if device is not None:
        spec = perf_model.device_spec(spec, device)
    table = policy.tuning_table
    if splits is None and table is not None:
        rec = table.lookup(kind, m, d1, d2, dtype=dtype, spec=spec.name,
                           executor=executor_name(device))
        if rec is not None:
            splits = rec.params_dict.get("splits", 1)
    if splits is None and device is not None and device.type == "cpu":
        splits = 1
    if splits is None:
        if table is not None:
            spec = table.fitted_spec(kind, m, d1, d2, dtype=dtype, spec=spec)
        splits = choose(m, d1, d2, spec, dtype)
    # Each slice must own >= one block: past that, slices are pure padding.
    splits = max(1, min(int(splits), perf_model.max_splits(depth, block)))
    # Whole-block slices may cover the depth in fewer than S; drop the
    # slices that would be empty.
    splits = max(1, -(-depth // ref.split_len(depth, splits, block)))
    if policy.verify_contracts:
        _verify(kind, m, d1, d2, dtype, splits, device, ptrs, out_dtype, q8,
                policy)
    key = "block_k" if kind == "tsm2r" else "block_m"
    return {"splits": splits, key: block}


def executor_name(device) -> str:
    """The executor a call on ``device`` runs under (``core/tsmm.py``):
    "torch-ref" for CPU tensors, else "cuda" (``device=None`` is the data
    sheet's card)."""
    return "torch-ref" if device is not None and device.type == "cpu" \
        else "cuda"


def _verify(kind, m, d1, d2, dtype, splits, device, ptrs, out_dtype, q8,
            policy):
    """Raise unless the launch ``resolve_params`` resolved keeps every
    contract (``GemmPolicy.verify_contracts``)."""
    kernel_out = _kernel_out(out_dtype) if q8 else None
    params = perf_model.kernel_params(
        kind, m, d1, d2, dtype, splits,
        _spec(device) if device is not None else perf_model.H100,
        ptrs=ptrs, out_dtype=kernel_out)
    shape = (m, d1, d2)
    bad = (contracts.check_kernel_config(
        kind, shape, params, dtype, contracts.card_limits(device),
        max_b=policy.max_skinny_t, out_dtype=kernel_out)
        + contracts.check_grid(kind, shape, params))
    if bad:
        raise ValueError(
            "GemmPolicy.verify_contracts: resolved kernel config breaks "
            f"{len(bad)} contract(s): "
            + "; ".join(f"[{v.rule}] {v.detail}" for v in bad))


def _resolve(kind, x, d1, d2, policy, y=None):
    ptrs = (0, 0) if policy.quant == "int8" or y is None else \
        (x.data_ptr(), y.data_ptr())
    return resolve_params(kind, x.shape[0], d1, d2, x.dtype, policy,
                          device=x.device, ptrs=ptrs)


def _note(name, kind, shape, dtype, splits, device, ptrs, out_dtype=None):
    """Record the launch of kernel ``name`` (of ``kind``, on ``dtype``
    operands at ``ptrs``) onto the dispatch's event, stated as
    ``perf_model.kernel_params`` and its ``contracts.launch_grid``; a
    no-op unless ``tsmm.record_dispatches`` listens."""
    tsmm = _dispatcher()
    if not tsmm.recording():
        return
    params = perf_model.kernel_params(kind, *shape, dtype, splits,
                                      _spec(device), ptrs=ptrs,
                                      out_dtype=out_dtype)
    tsmm.note_launch(name, contracts.launch_grid(kind, shape, params),
                     splits, shape=shape, dtype=dtype, params=params)


# What the kernels read and write: float32 or bfloat16, one dtype a pair.
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_WIDENED = (torch.float16, torch.bfloat16, torch.float32)


def _kernel_pair(a, b):
    """The operands as a kernel takes them: a mixed pair of float16,
    bfloat16 and float32, or a float16 pair, widened to float32 (exact),
    as ``jnp.dot`` promotes them; any other pair as it is (the wrapper
    raises on what it does not take)."""
    if a.dtype == b.dtype and a.dtype != torch.float16:
        return a, b
    if a.dtype in _WIDENED and b.dtype in _WIDENED:
        return a.float(), b.float()
    return a, b


def _q8_operand(x):
    """An operand as the quantize pass takes it: float16 widened to
    float32 (exact; the pass upcasts to float32 anyway)."""
    return x.float() if x.dtype == torch.float16 else x


def _kernel_out(dtype):
    """The dtype a kernel writes for an output of ``dtype``: itself, or
    float32 where the kernels have no store of it (float16)."""
    return dtype if dtype in _KERNEL_DTYPES else torch.float32


# ---------------------------------------------------------------------------
# Forward implementations
# ---------------------------------------------------------------------------

def _tsm2r_impl(a, b, policy):
    out_dtype = a.dtype
    (m, k), n = a.shape, b.shape[1]
    if policy.quant == "int8":
        a, b = _q8_operand(a).contiguous(), _q8_operand(b).contiguous()
        p = _resolve("tsm2r", a, k, n, policy)
        s = p["splits"]
        band = perf_model.Q8_BAND
        # The wgmma body reads B K-major: the quantize pass writes B's
        # codes so where that body will run (fresh codes are aligned).
        kmajor = perf_model.tsm2r_body(k, n, torch.int8, splits=s) == "wgmma"
        a_q, a_s = quant.quantize_blocks(a, band)
        b_q, b_s = quant.quantize_tensor(b, kmajor=kmajor)
        _note("tsm2r_q8", "tsm2r", (m, k, n), torch.int8, s, a.device,
              (a_q.data_ptr(), b_q.data_ptr()))
        if s == 1:
            return _tsm2r.tsm2r_q8(a_q, b_q, a_s, b_s, band,
                                   _kernel_out(out_dtype)).to(out_dtype)
        parts = _tsm2r.tsm2r_q8_split(a_q, b_q, a_s, b_s, band, s,
                                      p["block_k"])
        return _epilogue(parts, out_dtype)
    a, b = _kernel_pair(a.contiguous(), b.contiguous())
    p = _resolve("tsm2r", a, k, n, policy, b)
    s = p["splits"]
    _note("tsm2r", "tsm2r", (m, k, n), a.dtype, s, a.device,
          (a.data_ptr(), b.data_ptr()))
    if s == 1:
        return _tsm2r.tsm2r(a, b).to(out_dtype)
    parts = _tsm2r.tsm2r_split(a, b, s, p["block_k"])
    return _epilogue(parts, out_dtype)


def _tsmt_impl(x, y, policy):
    out_dtype = x.dtype
    q8 = policy.quant == "int8"
    if q8:
        x, y = _q8_operand(x).contiguous(), _q8_operand(y).contiguous()
    else:
        x, y = _kernel_pair(x.contiguous(), y.contiguous())
    (m, a), b = x.shape, y.shape[1]
    p = _resolve("tsmt", x, a, b, policy, y)
    s = p["splits"]
    # S = 1 is the sequential kernel, which spreads m over its own plan of
    # slices in one launch: the record's grid is that plan's.
    if q8:
        band = p["block_m"]
        x_q, x_s = quant.quantize_blocks(x, band)
        y_q, y_s = quant.quantize_blocks(y, band)
        _note("tsmt_q8", "tsmt", (m, a, b), torch.int8, s, x.device,
              (x_q.data_ptr(), y_q.data_ptr()))
        if s == 1:
            return _tsmt.tsmt_q8(x_q, y_q, x_s, y_s, band,
                                 _kernel_out(out_dtype)).to(out_dtype)
        parts = _tsmt.tsmt_q8_split(x_q, y_q, x_s, y_s, band, s)
        return _epilogue(parts, out_dtype)
    _note("tsmt", "tsmt", (m, a, b), x.dtype, s, x.device,
          (x.data_ptr(), y.data_ptr()))
    if s == 1:
        return _tsmt.tsmt(x, y).to(out_dtype)
    parts = _tsmt.tsmt_split(x, y, s, p["block_m"])
    return _epilogue(parts, out_dtype)


def _epilogue(parts, out_dtype):
    """The (S, rows, cols) f32 partials summed, in ``out_dtype``."""
    out, plan = reduce.reduce_partials(parts, _kernel_out(out_dtype))
    if plan is not None:   # the grid the sum_partials launch has
        _dispatcher().note_launch(
            "reduce", plan[0], parts.shape[0], shape=tuple(parts.shape),
            dtype=torch.float32,
            params={"vec": plan[2], "threads": plan[1],
                    "max_blocks": perf_model.REDUCE_BLOCKS_PER_SM
                    * _spec(parts.device).n_sms,
                    "ptrs": {"p": parts.data_ptr(), "c": out.data_ptr()},
                    "out_dtype": out.dtype})
    return out.to(out_dtype)


def _tsm2l_impl(a, b, policy):
    out_dtype = a.dtype
    (m, k), n = a.shape, b.shape[1]
    if policy.quant == "int8":
        a, b = _q8_operand(a).contiguous(), _q8_operand(b).contiguous()
        _resolve("tsm2l", a, k, n, policy)
        band = perf_model.Q8_BAND
        a_q, a_s = quant.quantize_blocks(a, band)
        b_q, b_s = quant.quantize_tensor(b)
        kernel_out = _kernel_out(out_dtype)
        _note("tsm2l_q8", "tsm2l", (m, k, n), torch.int8, 1, a.device,
              (a_q.data_ptr(), b_q.data_ptr()), kernel_out)
        return _tsm2l.tsm2l_q8(a_q, b_q, a_s, b_s, band,
                               kernel_out).to(out_dtype)
    a, b = _kernel_pair(a.contiguous(), b.contiguous())
    _resolve("tsm2l", a, k, n, policy, b)
    _note("tsm2l", "tsm2l", (m, k, n), a.dtype, 1, a.device,
          (a.data_ptr(), b.data_ptr()))
    return _tsm2l.tsm2l(a, b).to(out_dtype)


def _spec(device):
    """The card model a launch on ``device`` plans against."""
    return perf_model.device_spec(perf_model.H100, device)


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
        da = db = None
        with tsmm.backward_scope(ctx.policy) as bp:
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
        dx = dy = None
        with tsmm.backward_scope(ctx.policy) as bp:
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


def tsqr(a: torch.Tensor, *, policy=None, passes: int | None = None,
         shift_rel: float | None = None):
    """Tall-skinny QR (CholeskyQR2) on tsmt and tsm2l: a re-export of
    ``repro_torch.linalg.tsqr``, imported lazily (``linalg`` consumes the
    dispatcher, which imports this module)."""
    from repro_torch import linalg
    return linalg.tsqr(a, policy=policy, passes=passes, shift_rel=shift_rel)
