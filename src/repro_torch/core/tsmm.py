"""Shape-dispatched tall-and-skinny matmul behind a scoped ``GemmPolicy``.

Counterpart of ``src/repro/core/tsmm.py``.
``tsmm(a, b)`` classifies ``A[..., m, k] @ B[k, n]`` (leading dims collapse
into the tall dim) and routes to:

* TSM2R when m ~ k >> n,
* TSM2L when m >> k ~ n,
* ``torch.matmul`` otherwise.

``tsmm_t(x, y)`` is the transposed entry, ``X[..., m, a]^T @ Y[..., m, b]``
with the leading dims collapsed into the reduction, routed to TSMT or to
``torch.matmul``.

Executors:

* ``cuda``        -- the hand-written kernels (CUDA tensors only),
* ``torch-ref``   -- their plain versions, selected only for CPU tensors,
* ``torch-dense`` -- ``torch.matmul``, the analogue of ``dense-xla``; on
  DTensor operands DTensor's own sharding propagation partitions it, as
  GSPMD partitions the reference's dense dot under a mesh,
* ``shard_map``   -- per-shard dispatch over the data-parallel dims of the
  operands' ``DeviceMesh`` (the reference's sharded ``jax.Array`` is a
  ``DTensor`` here): the tall dim shards, each rank re-enters this
  dispatcher on its local tensors (still tall-and-skinny), and
  ``tsmm_t``'s per-shard partial products combine per
  ``GemmPolicy.reduce`` -- all-reduced to a replicated output ("psum"),
  or stacked (``reduce="none"``: global ``(shards * a, b)``),
* ``shard_map-scatter`` -- ``tsmm_t`` whose partials reduce-scatter
  (``reduce="psum_scatter"``): the ``(a, b)`` product comes back
  row-sharded over the data-parallel dims.

A plain tensor is local to its process and never reaches the shard_map
executors unless one is pinned, which then raises. Data-parallel dims are
derived from the mesh's dim names (:func:`derive_dp_axes`) unless
``GemmPolicy.dp_axes`` names them. A mesh of one rank never auto-selects
shard_map: its DTensors reach ``cuda`` / ``torch-ref`` as their local
tensors and come back wrapped.

``GemmPolicy.split`` drives the split-reduction (split-K) kernels of
tsm2r and tsmt: "auto" lets the occupancy-aware chooser of
``core/perf_model.py`` pick S (it splits outputs at most 16 wide where
their tiles alone leave SMs of the card idle), an int pins S, "never"
keeps the sequential kernels. The classifier thresholds keep the JAX
package's defaults, so both packages classify every shape the same way.

``GemmPolicy.quant="int8"`` sends the kernel kinds through the five int8
kernels: the tall operand is quantized per ``perf_model.Q8_BAND``-row
band, the small operand of tsm2r/tsm2l per tensor, both tsmt operands per
band, and the output comes back in the caller's dtype. The dense path
ignores the knob, so a ``mode="dense"`` arm stays exact.

``GemmPolicy.verify_contracts=True`` checks every resolved launch against
``analysis/contracts.py`` before it runs. ``bound_class`` is the paper's
bound classifier (memory, compute or latency) on the H100's ridges.

``register_executor`` adds backends; ``GemmPolicy.executor`` pins one.
Every executor invocation passes through the deterministic fault-injection
tap (``ft/inject.py``), and ``GemmPolicy.abft`` wraps kernel-kind results
in an online Huang-Abraham checksum guard (verify, or locate and correct)
whose checksum GEMMs dispatch right back through this module
(``ft/abft.py`` owns the math).

The process default is ``GemmPolicy()``. ``refresh_default_policy()``
reads the JAX package's deprecated environment variables into it on
request (``REPRO_TSMM=off`` gives ``mode="dense"``,
``REPRO_BF16_PARAM_GRADS=1`` ``param_dtype_grads=True``); importing this
module reads no environment, so a variable left set cannot turn the
port's paths dense.

Both entries are differentiable: the ops they dispatch to are
``torch.autograd.Function``s whose backward re-enters this dispatcher
inside ``backward_scope`` of the caller's policy.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import os
import warnings

import torch

from repro_torch.core import perf_model
# inject sits below every layer (torch only), so the dispatcher can route
# each executor invocation through its fault tap.
from repro_torch.ft import inject as _inject
from repro_torch.ft import is_dtensor
from repro_torch.kernels import compat, ops

__all__ = [
    "GemmPolicy",
    "bound_class",
    "policy",
    "current_policy",
    "default_policy",
    "refresh_default_policy",
    "backward_policy",
    "backward_scope",
    "enabled",
    "classify_gemm",
    "classify_gemm_t",
    "derive_dp_axes",
    "tsmm",
    "tsmm_t",
    "register_executor",
    "unregister_executor",
    "executors",
    "executor_reduce_contract",
    "record_dispatches",
    "DispatchEvent",
    "LaunchMeta",
    "note_launch",
    "recording",
]

# Classifier threshold defaults, the JAX package's (core/tsmm.py:124-128),
# kept as they are on purpose: at chatglm3's wk/wv ([8192,4096]·[4096,256]
# bf16) tsm2r runs 1.26x slower than torch.matmul, so an H100 MAX_SKINNY
# would likely send the serve paths' wk/wv to the dense route, a decision
# about the main path to be judged on end-to-end numbers once a benchmark
# exists. chip_smoke.py's threshold_sweep line records the crossover.
SKINNY_RATIO = 16
MAX_SKINNY = 256
MIN_TALL = 2048
MAX_SKINNY_T = 512
SKINNY_RATIO_T = SKINNY_RATIO // 4

# The convention for which mesh dims carry the batch. They seed
# ``derive_dp_axes``, which reads the operands' mesh; GemmPolicy.dp_axes
# still pins dims per scope.
DP_AXIS_NAMES = ("pod", "data")

# Names treated as data-parallel when deriving dp dims from a mesh, besides
# DP_AXIS_NAMES, and names that mark a dim as model/pipeline parallel
# (never DP). A dim in neither set is DP only when no conventional DP name
# is on the mesh.
_DP_NAME_HINTS = DP_AXIS_NAMES + ("dp", "batch", "replica", "replicas")
_MODEL_NAME_HINTS = frozenset({
    "model", "tensor", "tp", "mp", "expert", "experts", "ep",
    "pipe", "pipeline", "stage", "pp", "seq", "sequence", "sp",
})

_MM_KINDS = ("auto", "dense", "tsm2r", "tsm2l")
_MMT_KINDS = ("auto", "dense", "tsmt")
_ALL_MODES = ("auto", "dense", "tsm2r", "tsm2l", "tsmt")
_SHARD_MAP_MODES = ("auto", "never", "require", "local")
# GemmPolicy.reduce: how tsmm_t's per-shard partial products combine under
# the shard_map executors. Each executor declares the modes it implements
# (its reduce contract): the one-process executors all three (one shard:
# psum == psum_scatter == none), shard_map ("psum", "none") and
# shard_map-scatter ("psum_scatter",).
_REDUCE_MODES = ("psum", "psum_scatter", "none")
_QUANT_MODES = ("none", "int8")
_ABFT_MODES = ("none", "verify", "correct")


@dataclasses.dataclass(frozen=True)
class GemmPolicy:
    """What the GEMM dispatcher decides from.

    ``mode``: "auto" classifies; "dense" sends every call to
    ``torch.matmul``; a kind name ("tsm2r"/"tsm2l" for ``tsmm``, "tsmt" for
    ``tsmm_t``) forces that kernel for its own entry and leaves the other
    entry on auto. The five thresholds are those of the JAX package's
    policy (see its docstring for their derivation). ``executor`` pins a
    registered backend by name.

    ``split``: "auto" (the chooser picks S per shape), a positive int (that
    S for every tsm2r/tsmt in scope; 1 = no split-K op) or "never" (the
    sequential kernels everywhere). The chooser models the card the
    operands lie on (``perf_model.device_spec``). The sequential TSMT
    kernel still spreads m over the card by itself, in one launch with no
    epilogue op (``perf_model.tsmt_slices``).

    ``tuning_table``: a ``core.autotune.TuningTable`` of measured split
    factors (None = the chooser alone). When set and ``split`` is "auto",
    ``kernels/ops.resolve_params`` takes the S of the record for the
    shape's bucket, dtype (int8 under ``quant="int8"``), card and executor
    (``cuda`` on the card, ``torch-ref`` for CPU tensors); without one it
    runs the chooser under the table's fitted constants for the bucket
    (``TuningTable.fitted_spec``: bucket fit first, global fit second).
    A pinned ``split`` beats the table. Must stay hashable, which
    TuningTable is; typed loosely here to keep the dispatcher free of an
    import cycle. ``backward_policy`` keeps it, so the backward's
    cotangent GEMMs look their own shapes up.

    ``quant``: "none" (operands stream at their own dtype) or "int8"
    (the kernel kinds quantize their operands and run the int8 kernels,
    the chooser pricing int8 operands; the dense path ignores it). It is
    scope-wide numeric intent, so ``backward_policy`` keeps it.

    ``verify_contracts``: check each resolved launch (S, the body, its
    shared memory, the grid) against ``analysis/contracts.py`` before it
    launches, and raise ``ValueError`` on a violation
    (``ops.resolve_params``). ``backward_policy`` keeps it.

    ``param_dtype_grads``: ``models.layers.dense`` runs the backward of
    its projections through its own ``tsmm_t`` / ``tsmm`` pair and rounds
    each gradient to its operand's dtype there (see ``layers.dense``).

    ``abft``: online algorithm-based fault tolerance for the kernel-kind
    dispatches (tsm2r, tsm2l, tsmt):

    * "none" -- no checksums; the guard is never entered.
    * "verify" -- every kernel-kind result is checked against weighted
      column checksums (plain and ramp) computed through this dispatcher
      (the checksum of the output equals the GEMM of the operand
      checksum) at a shape- and dtype-derived tolerance
      (``ft.abft.tolerance``); a detected fault poisons the whole output
      with NaN on the device, no host sync, so a finiteness check
      downstream (``step_ok``) sees it.
    * "correct" -- also locates a single faulty output row from the
      ramp/plain deviation ratio and repairs it, bit for bit for a bit
      flip (a snap to the nearest single-bit-flip neighbour of a dense
      recompute of the row); what one row cannot explain is poisoned.

    The checksum GEMMs dispatch under a neutral policy (``abft="none"``,
    "auto" mode, no executor pin, ``quant="none"``, an int ``split`` back
    to "auto") on detached float32 operands, so they reach the kernels at
    their own shapes. On a clean run the guarded output equals the
    unguarded one bit for bit and its gradient passes straight through.
    ``backward_policy`` keeps ``abft``: cotangent GEMMs of a guarded
    scope are guarded too. The outer shard_map dispatch is not guarded:
    its per-shard re-dispatch inherits ``abft``, so each shard verifies
    (or corrects) its own local GEMM.

    ``shard_map``: what DTensor operands on a mesh of more than one rank
    do. "auto" dispatches per shard when the tall dim divides the
    data-parallel dims and the local shape still classifies
    tall-and-skinny, and falls back to ``torch-dense`` otherwise; "never"
    always takes ``torch-dense``; "require" raises instead of falling
    back; "local" ignores the mesh and dispatches on the shapes as seen
    (what the shard_map executors set for their per-shard bodies).
    ``dp_axes``: the mesh dim names that carry the batch; None derives
    them from the mesh (:func:`derive_dp_axes`). An explicit tuple is
    filtered against the mesh's dim names.

    ``reduce``: how ``tsmm_t``'s per-shard partial products combine under
    the shard_map executors (no effect elsewhere, and none on ``tsmm``,
    whose shards never reduce): "psum" all-reduces to a replicated
    output; "psum_scatter" reduce-scatters, so the global ``(a, b)``
    output is row-sharded over the dp dims (``torch-dense`` when its rows
    do not divide the shards; "require" raises); "none" returns each
    shard's partial product, stacked: the global output is ``(shards *
    a, b)`` and the caller owns the reduction. ``backward_policy`` keeps
    it, but "none" becomes "psum".
    """

    mode: str = "auto"
    skinny_ratio: int = SKINNY_RATIO
    max_skinny: int = MAX_SKINNY
    min_tall: int = MIN_TALL
    max_skinny_t: int = MAX_SKINNY_T
    skinny_ratio_t: int = SKINNY_RATIO_T
    executor: str | None = None
    tuning_table: object | None = None
    split: str | int = "auto"
    quant: str = "none"
    verify_contracts: bool = False
    param_dtype_grads: bool = False
    abft: str = "none"
    shard_map: str = "auto"
    dp_axes: tuple[str, ...] | None = None
    reduce: str = "psum"

    def __post_init__(self):
        s = self.split
        if not (s in ("auto", "never")
                or (isinstance(s, int) and not isinstance(s, bool)
                    and s >= 1)):
            raise ValueError(
                f"unknown GemmPolicy split {self.split!r}: valid values are "
                "'auto', 'never', or a positive int split factor")
        if self.mode not in _ALL_MODES:
            raise ValueError(
                f"unknown GemmPolicy mode {self.mode!r}: valid modes are "
                f"{', '.join(_ALL_MODES)}")
        if self.shard_map not in _SHARD_MAP_MODES:
            raise ValueError(
                f"unknown GemmPolicy shard_map {self.shard_map!r}: valid "
                f"values are {', '.join(_SHARD_MAP_MODES)}")
        if self.reduce not in _REDUCE_MODES:
            raise ValueError(
                f"unknown GemmPolicy reduce {self.reduce!r}: valid "
                f"values are {', '.join(_REDUCE_MODES)}")
        if self.quant not in _QUANT_MODES:
            raise ValueError(
                f"unknown GemmPolicy quant {self.quant!r}: valid values are "
                f"{', '.join(_QUANT_MODES)}")
        if self.abft not in _ABFT_MODES:
            raise ValueError(
                f"unknown GemmPolicy abft {self.abft!r}: valid values are "
                f"{', '.join(_ABFT_MODES)}")

    def with_(self, **overrides) -> "GemmPolicy":
        return dataclasses.replace(self, **overrides)


def _policy_from_env() -> GemmPolicy:
    """The policy the deprecated environment variables describe, read by
    ``refresh_default_policy`` only."""
    kw = {}
    raw = os.environ.get("REPRO_TSMM")
    if raw is not None:
        warnings.warn(
            "REPRO_TSMM is deprecated; use `with tsmm.policy(mode=...)` or "
            "tsmm.refresh_default_policy() after changing it",
            DeprecationWarning, stacklevel=3)
        if raw.lower() in ("off", "0", "false"):
            kw["mode"] = "dense"
    raw = os.environ.get("REPRO_BF16_PARAM_GRADS")
    if raw is not None:
        warnings.warn(
            "REPRO_BF16_PARAM_GRADS is deprecated; use "
            "`with tsmm.policy(param_dtype_grads=True)`",
            DeprecationWarning, stacklevel=3)
        if raw == "1":
            kw["param_dtype_grads"] = True
    return GemmPolicy(**kw)


_DEFAULT_POLICY = GemmPolicy()
_POLICY_VAR: contextvars.ContextVar[GemmPolicy | None] = \
    contextvars.ContextVar("repro_torch_gemm_policy", default=None)


def default_policy() -> GemmPolicy:
    """The process-default policy: ``GemmPolicy()``, or what the last
    ``refresh_default_policy`` read."""
    return _DEFAULT_POLICY


def refresh_default_policy() -> GemmPolicy:
    """Read the deprecated environment variables into the process default
    (tests, tools). Unlike the JAX package, the import does not."""
    global _DEFAULT_POLICY
    _DEFAULT_POLICY = _policy_from_env()
    return _DEFAULT_POLICY


def current_policy() -> GemmPolicy:
    """The innermost active ``with tsmm.policy(...)`` scope, else the
    process default."""
    return _POLICY_VAR.get() or _DEFAULT_POLICY


@contextlib.contextmanager
def policy(base: GemmPolicy | None = None, /, **overrides):
    """Scope a dispatch policy: ``with tsmm.policy(mode="dense"): ...``.

    ``base`` starts from an explicit GemmPolicy instead of the current
    scope; keyword overrides apply on top. Scopes nest and restore on exit.
    """
    p = base if base is not None else current_policy()
    if overrides:
        p = dataclasses.replace(p, **overrides)
    token = _POLICY_VAR.set(p)
    try:
        yield p
    finally:
        _POLICY_VAR.reset(token)


def backward_policy(p: GemmPolicy) -> GemmPolicy:
    """Policy for the backward's re-dispatch: the caller's scope, minus a
    forward-kind force and any executor pin (cotangent shapes classify for
    themselves, and a pinned shard_map executor must not recurse per
    shard). ``reduce="none"`` becomes "psum": stacked partials would give
    a cotangent another shape than its primal; "psum_scatter" stays, so
    the backward's weight-gradient ``tsmm_t``s land sharded too. An int
    ``split`` was chosen for the forward shape, so it goes back to
    "auto"; "never", a "dense" mode, ``quant``, ``abft``,
    ``tuning_table`` and ``param_dtype_grads`` are scope-wide intent and
    stay."""
    mode = p.mode if p.mode in ("auto", "dense") else "auto"
    reduce_ = "psum" if p.reduce == "none" else p.reduce
    split = "auto" if isinstance(p.split, int) else p.split
    if (mode == p.mode and p.executor is None and reduce_ == p.reduce
            and split == p.split):
        return p
    return dataclasses.replace(p, mode=mode, executor=None, reduce=reduce_,
                               split=split)


@contextlib.contextmanager
def backward_scope(p: GemmPolicy):
    """Where a backward re-dispatches its cotangent GEMMs: yields
    ``backward_policy(p)`` and suspends fault injection for the block, so
    only forward GEMMs are fault sites (``ft/inject.py``). Every
    ``autograd.Function`` whose backward calls this dispatcher enters it."""
    with _inject.suspended():
        yield backward_policy(p)


def enabled() -> bool:
    """Deprecated alias: True unless the current policy pins the dense
    path (the old ``REPRO_TSMM=off`` check)."""
    return current_policy().mode != "dense"


# ---------------------------------------------------------------------------
# Shape classification
# ---------------------------------------------------------------------------

def classify_gemm(m: int, k: int, n: int,
                  policy: GemmPolicy | None = None) -> str:
    """Return one of 'tsm2r' | 'tsm2l' | 'dense'."""
    p = policy if policy is not None else current_policy()
    if m >= p.min_tall and n <= p.max_skinny and m >= p.skinny_ratio * n:
        if k <= p.max_skinny:              # m >> k ~ n: tiny contraction
            return "tsm2l"
        if k >= p.skinny_ratio * n:        # m ~ k >> n
            return "tsm2r"
    return "dense"


def classify_gemm_t(m: int, a_dim: int, b_dim: int,
                    policy: GemmPolicy | None = None) -> str:
    """Transposed-entry classifier: 'tsmt' | 'dense' for X[m,a]^T Y[m,b]."""
    p = policy if policy is not None else current_policy()
    if (m >= p.min_tall and b_dim <= p.max_skinny_t
            and m >= p.skinny_ratio_t * max(a_dim, b_dim)):
        return "tsmt"
    return "dense"


def bound_class(m: int, k: int, n: int, dtype=torch.bfloat16,
                policy: GemmPolicy | None = None) -> str:
    """The paper's bound class of ``[m,k]·[k,n]`` on the H100 ("memory",
    "compute" or "latency", ``perf_model.classify``). Under a
    ``quant="int8"`` policy the operands stream as int8, so they are
    classified at int8's ridge."""
    p = policy if policy is not None else current_policy()
    if p.quant == "int8":
        dtype = torch.int8
    return perf_model.classify(m, k, n, perf_model.H100, dtype)


# ---------------------------------------------------------------------------
# Dispatch spy
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LaunchMeta:
    """One kernel launch a dispatch resolved to: ``kind`` ("tsm2r",
    "tsm2l", "tsmt", their int8 kernels "tsm2r_q8", "tsm2l_q8", "tsmt_q8",
    or "reduce" for the partials epilogue), ``grid`` (the
    CUDA grid from ``perf_model``'s mirror of the tile table; for the
    sequential tsmt/tsmt_q8 its last dim is the kernel's own plan of m
    slices, ``perf_model.tsmt_slices``; for tsm2l/tsm2l_q8 the grid of
    ``perf_model.tsm2l_plan``: the stream body's persistent blocks, or
    the tile body's row and column tiles; for "reduce" the grid of
    ``perf_model.reduce_plan``: one vector of outputs a thread, at most
    ``REDUCE_BLOCKS_PER_SM`` blocks an SM) and the
    resolved ``splits`` (S; 1 for a sequential kernel). ``shape`` (m, d1,
    d2; the ``(S, rows, cols)`` stack for "reduce"), ``dtype`` (what the
    operands stream as: int8 for the int8 kernels) and ``params`` (the
    launch in ``analysis/contracts.py``'s terms, ``perf_model.
    kernel_params``) state it so, that ``contracts.launch_grid(kind,
    shape, params)`` is ``grid`` and ``contracts.check_kernel_config``
    can check it."""

    kind: str
    grid: tuple
    splits: int = 1
    shape: tuple = ()
    dtype: torch.dtype | None = None
    params: dict | None = None


@dataclasses.dataclass(frozen=True)
class DispatchEvent:
    """One routing decision: which entry, classified kind, chosen executor,
    and the (tall, minor, minor) shape it was made for. Emitted on every
    call (PyTorch runs eagerly; there is no trace to cache). ``split`` is
    the policy's split knob; ``quant`` its quantization knob ("none" |
    "int8"), so a spy can check that an int8 scope reached the int8
    kernels; ``launches`` the kernel launches the call resolved to (empty
    on the dense path, and on the outer event of a shard_map dispatch:
    the per-shard events carry their own).

    ``abft`` is the guard mode wrapped around THIS dispatch's result
    ("none" | "verify" | "correct"): the protected GEMM of a guarded scope
    carries the mode and the checksum GEMMs of its guard carry "none", so
    a spy sees exactly one guarded event per protected call. ``faults``
    holds the ``ft.inject.GemmFault``s the injection tap applied inside
    this dispatch."""

    entry: str       # "mm" (A @ B) | "mmt" (X^T Y)
    kind: str        # "tsm2r" | "tsm2l" | "tsmt" | "dense"
    executor: str    # registry key
    shape: tuple[int, int, int]
    split: str | int = "auto"
    quant: str = "none"
    launches: tuple = ()       # of LaunchMeta
    abft: str = "none"
    faults: tuple = ()         # of ft.inject.GemmFault


_LISTENERS: list = []
# Per-dispatch LaunchMeta collectors, pushed around an executor while a
# spy listens; ``kernels/ops.py`` reports into the innermost one.
_LAUNCH_NOTES: list = []
# The parallel stack of applied-fault collectors: _run_executor reports
# the GemmFaults the tap landed into the innermost frame.
_FAULT_NOTES: list = []


def recording() -> bool:
    """Whether a dispatch is collecting launch records (a spy listens)."""
    return bool(_LAUNCH_NOTES)


def note_launch(kind: str, grid, splits: int = 1, *, shape=(), dtype=None,
                params=None) -> None:
    """Record one resolved kernel launch onto the current dispatch's event
    (a no-op outside a listened-to dispatch)."""
    if _LAUNCH_NOTES:
        _LAUNCH_NOTES[-1].append(LaunchMeta(kind, tuple(grid), splits,
                                            tuple(shape), dtype, params))


@contextlib.contextmanager
def record_dispatches():
    """Collect a DispatchEvent for every routing decision in the scope."""
    log: list[DispatchEvent] = []
    _LISTENERS.append(log.append)
    try:
        yield log
    finally:
        _LISTENERS.remove(log.append)


def _run_executor(ex, entry, kind, a, b, p):
    """Invoke a registered executor through the fault-injection tap
    (``ft.inject.tap_executor``): outside an injection scope this is
    exactly ``ex(...)``; inside one, the plan's bit flips for this site
    apply and land on the innermost dispatch's event."""
    out, applied = _inject.tap_executor(ex, entry, kind, a, b, p)
    if applied and _FAULT_NOTES:
        _FAULT_NOTES[-1].extend(applied)
    return out


def _dispatch(entry: str, kind: str, executor: str, shape, p: GemmPolicy,
              run, abft: str = "none"):
    """Run the executor, then emit the spy event with the launches and
    faults it noted. Without listeners this is just ``run()``. ``abft`` is
    the guard mode stamped on the event: the caller passes the policy's
    mode only for the dispatch the guard protects."""
    if not _LISTENERS:
        return run()
    notes: list = []
    fault_notes: list = []
    _LAUNCH_NOTES.append(notes)
    _FAULT_NOTES.append(fault_notes)
    try:
        out = run()
    finally:
        _FAULT_NOTES.pop()
        _LAUNCH_NOTES.pop()
    ev = DispatchEvent(entry, kind, executor, tuple(shape), p.split,
                       p.quant, tuple(notes), abft, tuple(fault_notes))
    for cb in tuple(_LISTENERS):
        cb(ev)
    return out


# ---------------------------------------------------------------------------
# Backend registry
# ---------------------------------------------------------------------------
#
# An executor is ``fn(entry, kind, a, b, policy) -> tensor``. Kernel executors get
# 2-D operands (N-d lhs already collapsed); "torch-dense" may get the
# original N-d lhs for the "mm" entry.

def _exec_dense(entry, kind, a, b, p):
    """``torch.matmul`` of a pair of one dtype. A mixed pair is widened to
    float32 and the product cast to ``a``'s dtype, as the JAX dense
    executor accumulates in float32 and writes ``a.dtype``."""
    del kind, p
    out_dtype = a.dtype
    if a.dtype != b.dtype:
        a, b = a.float(), b.float()
    if entry == "mmt":
        a = a.transpose(0, 1)
    return torch.matmul(a, b).to(out_dtype)


def _exec_ops(entry, kind, a, b, p):
    if kind == "tsm2r":
        return ops.tsm2r(a, b, policy=p)
    if kind == "tsm2l":
        return ops.tsm2l(a, b, policy=p)
    if kind == "tsmt":
        return ops.tsmt(a, b, policy=p)
    return _exec_dense(entry, kind, a, b, p)


def _exec_cuda(entry, kind, a, b, p):
    if a.device.type != "cuda":
        raise ValueError(f"executor 'cuda' needs CUDA tensors; got {a.device}")
    return _exec_ops(entry, kind, a, b, p)


def _exec_ref(entry, kind, a, b, p):
    # ops' wrappers run the plain versions for CPU tensors (and only then).
    if a.device.type != "cpu":
        raise ValueError("executor 'torch-ref' runs the plain versions on CPU "
                         f"tensors only; got {a.device}")
    return _exec_ops(entry, kind, a, b, p)


_EXECUTORS: dict = {}
# name -> the reduce modes the executor declared (its reduce contract).
_EXECUTOR_CONTRACTS: dict = {}


def register_executor(name: str, fn, *, reduce: tuple[str, ...] | None = None,
                      overwrite: bool = False):
    """Register a backend ``fn(entry, kind, a, b, policy) -> tensor``;
    returns ``fn``. ``reduce`` declares the reduce modes it implements for
    ``tsmm_t`` (None: all of them, right for an executor that reduces
    nothing across processes)."""
    if name in _EXECUTORS and not overwrite:
        raise ValueError(f"executor {name!r} already registered "
                         "(pass overwrite=True to replace)")
    if reduce is not None:
        bad = [r for r in reduce if r not in _REDUCE_MODES]
        if bad:
            raise ValueError(
                f"executor {name!r} declares unknown reduce modes {bad}: "
                f"valid values are {', '.join(_REDUCE_MODES)}")
    _EXECUTORS[name] = fn
    _EXECUTOR_CONTRACTS[name] = (tuple(_REDUCE_MODES) if reduce is None
                                 else tuple(reduce))
    return fn


def unregister_executor(name: str) -> None:
    """Remove a registered backend (built-ins included)."""
    _EXECUTORS.pop(name, None)
    _EXECUTOR_CONTRACTS.pop(name, None)


def executors() -> dict:
    """Snapshot of the registry (name -> executor)."""
    return dict(_EXECUTORS)


def executor_reduce_contract(name: str) -> tuple[str, ...]:
    """The reduce modes executor ``name`` declared at registration."""
    if name not in _EXECUTOR_CONTRACTS:
        raise ValueError(f"executor {name!r} is not registered")
    return _EXECUTOR_CONTRACTS[name]


# ---------------------------------------------------------------------------
# The shard_map executors: DTensor operands on a DeviceMesh
# ---------------------------------------------------------------------------
#
# The reference's sharded jax.Array under ``with mesh:`` is a DTensor here,
# and its mesh is the operands' ``device_mesh``; ``shard_map`` is
# ``to_local`` -> the per-shard body on local tensors -> ``from_local``;
# ``lax.psum`` / ``psum_scatter`` over the dp axes are a ``Partial``
# placement redistributed to ``Replicate`` / ``Shard(0)``.

def _operand_mesh(a, b):
    """The operands' DeviceMesh, or None for plain tensors. A DTensor and a
    plain tensor do not mix (a plain tensor is local to its process)."""
    da, db = is_dtensor(a), is_dtensor(b)
    if not (da or db):
        return None
    if da != db:
        raise ValueError(
            "tsmm got a DTensor and a plain tensor: a plain tensor is local "
            "to its process, so wrap both operands as DTensors on one "
            "DeviceMesh, or pass both local tensors")
    if a.device_mesh != b.device_mesh:
        raise ValueError(
            f"tsmm operands lie on different meshes: {a.device_mesh} and "
            f"{b.device_mesh}")
    return a.device_mesh


def derive_dp_axes(mesh) -> tuple[str, ...]:
    """Data-parallel dims of ``mesh``, derived from its dim *names*
    (``mesh_dim_names``; order kept):

    1. dims named by the DP convention (``DP_AXIS_NAMES`` plus
       "dp"/"batch"/"replica(s)") are DP when any is present;
    2. otherwise every dim whose name does not hint model/pipeline
       parallelism ("model", "tensor", "tp", "expert", "pipe", "stage",
       "seq", ...) is DP -- a one-dim mesh with a novel name too.

    A model-named dim is never DP, even alone: a pure tensor-parallel
    ``("model",)`` mesh keeps the dense fallback. May return ()."""
    names = tuple(mesh.mesh_dim_names or ())
    conv = tuple(a for a in names if a in _DP_NAME_HINTS)
    if conv:
        return conv
    return tuple(a for a in names if a not in _MODEL_NAME_HINTS)


def _dp_axes(mesh, p: GemmPolicy) -> tuple[str, ...]:
    if p.dp_axes is not None:
        return tuple(a for a in p.dp_axes
                     if a in (mesh.mesh_dim_names or ()))
    return derive_dp_axes(mesh)


def _axes_size(mesh, axes) -> int:
    sizes = compat.mesh_axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def _placements(mesh, dp, on_dp):
    """``on_dp`` on the mesh's dp dims, ``Replicate()`` on the others (the
    reference's ``PartitionSpec(dp, None)`` over the mesh)."""
    from torch.distributed.tensor import Replicate
    return [on_dp if name in dp else Replicate()
            for name in mesh.mesh_dim_names]


def _shard_map_env(a, b, p: GemmPolicy):
    """(mesh, dp dims, inner per-shard policy) for the shard_map executors.
    The inner policy dispatches on local shapes (``shard_map="local"``)
    and drops the executor pin, so the per-shard re-dispatch cannot
    recurse."""
    mesh = _operand_mesh(a, b)
    if mesh is None:
        raise RuntimeError("shard_map executor requires an active "
                           "`with mesh:` scope: DTensor operands on a "
                           "DeviceMesh")
    dp = _dp_axes(mesh, p)
    if not dp:
        raise RuntimeError(
            f"shard_map executor found no data-parallel axes on mesh "
            f"{mesh.mesh_dim_names} (policy dp_axes={p.dp_axes}; derived "
            "axes follow tsmm.derive_dp_axes)")
    inner = dataclasses.replace(p, shard_map="local", executor=None)
    return mesh, dp, inner


def _sharded_locals(mesh, dp, *ts):
    """Each operand row-sharded over the dp dims, as its local tensor."""
    from torch.distributed.tensor import Shard
    rows = _placements(mesh, dp, Shard(0))
    return [t.redistribute(mesh, rows).to_local() for t in ts]


def _exec_shard_map(entry, kind, a, b, p):
    """Per-shard dispatch over the dp dims of the operands' mesh.

    ``mm``: the tall dim shards, B replicates; each rank re-enters the
    dispatcher on its local (still tall-and-skinny) shape, and the output
    is row-sharded. B's local gradient is this shard's part of the sum
    (``grad_placements`` Partial on the dp dims), as the transpose of the
    reference's shard_map psums a replicated operand's cotangent.
    ``mmt``: both operands shard over the tall reduction; the per-shard
    partial products combine per ``p.reduce`` -- all-reduced to a
    replicated output ("psum"), or stacked (``reduce="none"``: global
    ``(shards * a, b)``). The scatter variant is ``shard_map-scatter``.
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    del kind
    mesh, dp, inner = _shard_map_env(a, b, p)
    rows = _placements(mesh, dp, Shard(0))
    if entry == "mm":
        (a_s,) = _sharded_locals(mesh, dp, a)
        b_s = b.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
            grad_placements=_placements(mesh, dp, Partial()))
        return DTensor.from_local(tsmm(a_s, b_s, policy=inner), mesh, rows)
    if p.reduce == "psum_scatter":
        # Selection never lands here with a scatter scope; only a pinned
        # executor="shard_map" can. Refuse rather than psum: the caller
        # asked for a row-sharded layout.
        raise RuntimeError(
            "GemmPolicy pins executor='shard_map' but reduce="
            "'psum_scatter': the sharded-output layout lives on the "
            "'shard_map-scatter' executor -- pin that instead, or drop "
            "the pin and let selection match the collective")
    x_s, y_s = _sharded_locals(mesh, dp, a, b)
    out = tsmm_t(x_s, y_s, policy=inner)
    if p.reduce == "none":
        return DTensor.from_local(out, mesh, rows)
    return DTensor.from_local(
        out, mesh, _placements(mesh, dp, Partial())).redistribute(
            mesh, [Replicate()] * mesh.ndim)


def _exec_shard_map_scatter(entry, kind, a, b, p):
    """Sharded-output ``tsmm_t``: the per-shard partials reduce-scatter
    over the dp dims, so the global ``(a, b)`` product comes back
    row-sharded instead of replicated. ``mm`` has no cross-shard
    reduction to scatter, so a pin around ``tsmm`` raises."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    del kind
    if entry != "mmt":
        raise RuntimeError(
            "the shard_map-scatter executor only applies to tsmm_t (its "
            "output is the cross-shard reduction being scattered); tsmm "
            "has nothing to scatter -- use the shard_map executor")
    if p.reduce != "psum_scatter":
        # Only a pin reaches this: a psum/none scope on the scatter
        # executor would change the layout (or shape) reduce= asked for.
        raise RuntimeError(
            f"GemmPolicy pins executor='shard_map-scatter' but reduce="
            f"{p.reduce!r}: the scatter executor implements exactly "
            "reduce='psum_scatter' -- set that, or drop the pin")
    mesh, dp, inner = _shard_map_env(a, b, p)
    shards = _axes_size(mesh, dp)
    if a.shape[1] % shards != 0:
        raise RuntimeError(
            f"psum_scatter output rows ({a.shape[1]}) do not divide the "
            f"{shards} shards of dp axes {dp}; auto-selection falls back "
            "to dense for this shape -- only an explicit executor pin "
            "reaches this error")
    x_s, y_s = _sharded_locals(mesh, dp, a, b)
    return DTensor.from_local(
        tsmm_t(x_s, y_s, policy=inner), mesh,
        _placements(mesh, dp, Partial())).redistribute(
            mesh, _placements(mesh, dp, Shard(0)))


# The one-process executors implement every reduce mode (one shard: psum
# == psum_scatter == none); the shard_map pair splits the collective
# modes between them.
register_executor("torch-dense", _exec_dense, reduce=_REDUCE_MODES)
register_executor("cuda", _exec_cuda, reduce=_REDUCE_MODES)
register_executor("torch-ref", _exec_ref, reduce=_REDUCE_MODES)
register_executor("shard_map", _exec_shard_map, reduce=("psum", "none"))
register_executor("shard_map-scatter", _exec_shard_map_scatter,
                  reduce=("psum_scatter",))
# Executors that take DTensor operands as they are; any other gets them as
# replicated local tensors (``_runs_local``).
_MESH_EXECUTORS = ("torch-dense", "shard_map", "shard_map-scatter")


def _select_executor(entry: str, kind: str, m_tall: int, d1: int, d2: int,
                     p: GemmPolicy, forced: bool, device: torch.device,
                     mesh) -> str:
    if p.executor is not None:
        if p.executor not in _EXECUTORS:
            raise ValueError(
                f"GemmPolicy.executor {p.executor!r} is not registered: "
                f"known executors are {sorted(_EXECUTORS)}")
        if entry == "mmt":
            # A pinned executor refuses a collective outside its declared
            # reduce contract rather than silently change the output
            # layout the scope's reduce= asked for (mm shards never
            # reduce, so every contract holds there).
            contract = _EXECUTOR_CONTRACTS.get(p.executor,
                                               tuple(_REDUCE_MODES))
            if p.reduce not in contract:
                compatible = sorted(n for n, c in _EXECUTOR_CONTRACTS.items()
                                    if p.reduce in c)
                raise RuntimeError(
                    f"GemmPolicy pins executor={p.executor!r}, whose "
                    f"declared reduce contract is {contract}, but the scope "
                    f"asks reduce={p.reduce!r}: a pinned executor must not "
                    "silently change the output layout the collective asked "
                    f"for. Executors declaring {p.reduce!r}: {compatible} "
                    "-- pin one of those, or drop the pin and let selection "
                    "match the collective.")
        return p.executor
    if kind == "dense":
        return "torch-dense"
    if (mesh is not None and mesh.size() > 1 and not forced
            and p.shard_map != "local"):
        # The kernels have no DTensor partitioning rule: on a mesh of more
        # than one rank they run per shard or not at all. A forced kind or
        # a shard_map="local" scope bypasses this branch.
        if p.shard_map == "never":
            return "torch-dense"
        dp = _dp_axes(mesh, p)
        shards = _axes_size(mesh, dp) if dp else 0
        ok = bool(dp) and m_tall % shards == 0
        if ok:
            local = (classify_gemm(m_tall // shards, d1, d2, p)
                     if entry == "mm"
                     else classify_gemm_t(m_tall // shards, d1, d2, p))
            ok = local != "dense"
        scatter = entry == "mmt" and p.reduce == "psum_scatter"
        if ok and scatter:
            # The scatter dim is the output's rows (d1); where they do not
            # tile over the shards the sharded output cannot exist: dense,
            # not a silent psum.
            ok = d1 % shards == 0
        if ok:
            return "shard_map-scatter" if scatter else "shard_map"
        if p.shard_map == "require":
            raise RuntimeError(
                f"GemmPolicy(shard_map='require') but shape "
                f"({m_tall}, {d1}, {d2}) cannot shard over dp axes "
                f"{dp or '(none)'} of mesh {compat.mesh_axis_sizes(mesh)}"
                + (" with reduce='psum_scatter'" if scatter else ""))
        return "torch-dense"
    if device.type == "cuda":
        return "cuda"
    if device.type == "cpu":
        return "torch-ref"
    if device.type == "meta" and "meta" in _EXECUTORS:
        # Shapes only: the dry run's executor (``launch/dryrun.py``).
        return "meta"
    raise ValueError(f"no TSM2X executor for tensors on {device}")


def _runs_local(mesh, name: str, guard: bool) -> bool:
    """Whether a dispatch on the operands of ``mesh`` (None: plain
    tensors) runs on their local tensors: every executor but the
    ``_MESH_EXECUTORS``, and a guarded ``torch-dense`` fallback (the
    checksum guard works on local tensors)."""
    return mesh is not None and (name not in _MESH_EXECUTORS or guard)


def _local_operands(mesh, *ts):
    """DTensor operands as the local, whole tensors a one-process executor
    takes: replicated first (a no-op on a mesh of one rank, where a shard
    is the whole tensor; an all-gather on the card otherwise -- only a
    forced kind, a "local" scope or a pinned executor gets here then)."""
    from torch.distributed.tensor import Replicate
    rep = [Replicate()] * mesh.ndim
    return [t.redistribute(mesh, rep).to_local() for t in ts]


def _wrap_replicated(mesh, out):
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(out, mesh, [Replicate()] * mesh.ndim)


def _forced_kind(entry: str, mode: str | None, p: GemmPolicy) -> str | None:
    """Per-call mode plus the policy mode -> a pinned kind, or None for
    auto. A policy mode pinning the other entry's kind means auto here."""
    valid = _MM_KINDS if entry == "mm" else _MMT_KINDS
    if mode is not None:
        if mode not in valid:
            raise ValueError(
                f"unknown kind {mode!r} for "
                f"{'tsmm' if entry == 'mm' else 'tsmm_t'}: valid kinds are "
                f"{', '.join(valid)}")
        return None if mode == "auto" else mode
    if p.mode != "auto" and p.mode in valid:
        return p.mode
    return None


# ---------------------------------------------------------------------------
# Online ABFT (GemmPolicy.abft): checksum guard around the kernel dispatches
# ---------------------------------------------------------------------------

_ABFT_KINDS = ("tsm2r", "tsm2l", "tsmt")
# The outer shard_map dispatch is not guarded: its per-shard re-dispatch
# inherits abft through _shard_map_env's inner policy, so every shard
# verifies or corrects its local GEMM (a global checksum would need a
# collective of its own and would break the reduce="none" layout).
_ABFT_SKIP_EXECUTORS = ("shard_map", "shard_map-scatter")


def _abft_wraps(kind: str, executor: str, p: GemmPolicy) -> bool:
    """Does the online checksum guard wrap this dispatch?"""
    return (p.abft != "none" and kind in _ABFT_KINDS
            and executor not in _ABFT_SKIP_EXECUTORS)


def _abft_checksums(entry: str, x, y, out, p: GemmPolicy):
    """The two checksums of one protected dispatch, each ``(cols, 2)``
    float32: ``c_out`` straight from ``out`` and ``c_ref`` pushed through
    the operands (``e^T (A B) == (e^T A) B``), with ``rows`` and
    ``reduction`` (what ``ft.abft.tolerance`` scales with) and
    ``ref_row``, the dense float32 recompute of one output row at a 0-dim
    index tensor. The checksum GEMMs re-enter this dispatcher under a
    neutral policy, on detached float32 copies of the operands.

    ``entry="mm"``: x=(m, k), y=(k, n), out=(m, n); rows = m, reduction =
    k. ``entry="mmt"``: x=(m, a), y=(m, b), out=(a, b); rows = a,
    reduction = m."""
    from repro_torch.ft import abft as _abft  # deferred: ft.abft imports tsmm

    pc = dataclasses.replace(
        p, abft="none", mode="auto", executor=None, quant="none",
        split="auto" if isinstance(p.split, int) else p.split)
    xs, ys = x.detach().float(), y.detach().float()
    if entry == "mm":
        rows, red = x.shape
        e = _abft.checksum_weights(rows, device=x.device)
        u = tsmm_t(xs, e, policy=pc)               # (k, s) = A^T e
        c_ref = tsmm_t(ys, u, policy=pc)           # (n, s) = B^T (A^T e)

        # A multiply-and-sum, so the row is a true f32 product whatever
        # the matmul precision flags say.
        def ref_row(i):
            return (xs.index_select(0, i.view(1))[0, :, None] * ys).sum(0)
    else:
        rows, red = out.shape[0], x.shape[0]
        e = _abft.checksum_weights(rows, device=x.device)
        v = tsmm(xs, e, policy=pc)                 # (m, s) = X e
        c_ref = tsmm_t(v, ys, policy=pc).t()       # (b, s) = ((X e)^T Y)^T

        def ref_row(i):
            return (xs.index_select(1, i.view(1)) * ys).sum(0)
    c_out = tsmm_t(out.detach().float(), e, policy=pc)   # (cols, s)
    return c_out, c_ref, rows, red, ref_row


def _abft_guard(entry: str, x, y, out, p: GemmPolicy):
    """Verify, or locate and correct, one protected dispatch's 2-D
    ``out`` (``ft.abft.locate_and_correct``). On a clean run the result
    equals ``out`` bit for bit and its gradient passes straight through to
    ``out``; the guard adds no backward GEMMs."""
    from repro_torch.ft import abft as _abft

    c_out, c_ref, rows, red, ref_row = _abft_checksums(entry, x, y, out, p)
    return _abft.locate_and_correct(
        out, c_out, c_ref, rows=rows, reduction=red, mode=p.abft,
        eps=_abft.tolerance_eps(out.dtype, p.quant),
        ref_row=ref_row if p.abft == "correct" else None)


# ---------------------------------------------------------------------------
# Public entries
# ---------------------------------------------------------------------------

def tsmm(a: torch.Tensor, b: torch.Tensor, *, mode: str | None = None,
         policy: GemmPolicy | None = None) -> torch.Tensor:
    """``A[..., m, k] @ B[k, n]`` via the best path for the shape.

    Leading dims of ``a`` collapse into the tall dim for kernel dispatch;
    the dense path contracts the trailing dim in place. DTensor operands
    on a mesh of more than one rank dispatch per shard (``shard_map``)
    where the shape allows, and return a DTensor.
    """
    p = policy if policy is not None else current_policy()
    if a.dim() < 2 or b.dim() != 2:
        raise ValueError(
            f"tsmm expects a (..., m, k) lhs and a (k, n) rhs; got "
            f"{tuple(a.shape)} @ {tuple(b.shape)}")
    k = a.shape[-1]
    if b.shape[0] != k:
        raise ValueError(
            f"tsmm contraction mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    n = b.shape[1]
    m_tall = math.prod(a.shape[:-1])
    forced = _forced_kind("mm", mode, p)
    kind = forced if forced is not None else classify_gemm(m_tall, k, n, p)
    mesh = _operand_mesh(a, b)
    name = _select_executor("mm", kind, m_tall, k, n, p, forced is not None,
                            a.device, mesh)
    ex = _EXECUTORS[name]
    guard = _abft_wraps(kind, name, p)
    local = _runs_local(mesh, name, guard)
    if local:
        a, b = _local_operands(mesh, a, b)

    def run():
        if a.dim() > 2 and name != "torch-dense":
            # A per-shard product's rows are gathered where their shards
            # cut across a's leading dim (32 sequences over 64 dp ranks).
            from repro_torch.distributed import sharding
            out = _run_executor(ex, "mm", kind, a.reshape(m_tall, k), b, p)
            return sharding.whole_if_uneven(out, 0, a.shape[0]).reshape(
                *a.shape[:-1], n)
        return _run_executor(ex, "mm", kind, a, b, p)

    out = _dispatch("mm", kind, name, (m_tall, k, n), p, run,
                    abft=p.abft if guard else "none")
    if guard:
        out = _abft_guard("mm", a.reshape(m_tall, k), b,
                          out.reshape(m_tall, n), p).reshape(out.shape)
    return _wrap_replicated(mesh, out) if local else out


def tsmm_t(x: torch.Tensor, y: torch.Tensor, *, mode: str | None = None,
           policy: GemmPolicy | None = None) -> torch.Tensor:
    """``X[..., m, a]^T @ Y[..., m, b] -> (a, b)`` via TSMT when the
    reduction is huge and a, b small-ish. Leading dims (shared by both
    operands) collapse into the reduction. DTensor operands on a mesh of
    more than one rank dispatch per shard where the shape allows, the
    partial products combining per ``GemmPolicy.reduce``."""
    p = policy if policy is not None else current_policy()
    if x.dim() < 2 or x.dim() != y.dim() or x.shape[:-1] != y.shape[:-1]:
        raise ValueError(
            f"tsmm_t expects (..., m, a) and (..., m, b) with identical "
            f"leading dims; got {tuple(x.shape)} and {tuple(y.shape)}")
    a_dim, b_dim = x.shape[-1], y.shape[-1]
    m_tall = math.prod(x.shape[:-1])
    if x.dim() > 2:
        x = x.reshape(m_tall, a_dim)
        y = y.reshape(m_tall, b_dim)
    forced = _forced_kind("mmt", mode, p)
    kind = (forced if forced is not None
            else classify_gemm_t(m_tall, a_dim, b_dim, p))
    mesh = _operand_mesh(x, y)
    name = _select_executor("mmt", kind, m_tall, a_dim, b_dim, p,
                            forced is not None, x.device, mesh)
    guard = _abft_wraps(kind, name, p)
    local = _runs_local(mesh, name, guard)
    if local:
        x, y = _local_operands(mesh, x, y)
    out = _dispatch("mmt", kind, name, (m_tall, a_dim, b_dim), p,
                    lambda: _run_executor(_EXECUTORS[name], "mmt", kind, x,
                                          y, p),
                    abft=p.abft if guard else "none")
    if guard:
        out = _abft_guard("mmt", x, y, out, p)
    return _wrap_replicated(mesh, out) if local else out
