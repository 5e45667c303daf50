"""Shape-dispatched tall-and-skinny matmul behind a scoped ``GemmPolicy``.

Counterpart of ``src/repro/core/tsmm.py``, with what serving and
single-process training need.
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
* ``torch-dense`` -- ``torch.matmul``, the analogue of ``dense-xla``.

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

Both entries are differentiable: the ops they dispatch to are
``torch.autograd.Function``s whose backward re-enters this dispatcher under
``backward_policy`` of the caller's scope.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math

import torch

from repro_torch.kernels import ops

__all__ = [
    "GemmPolicy",
    "policy",
    "current_policy",
    "backward_policy",
    "classify_gemm",
    "classify_gemm_t",
    "tsmm",
    "tsmm_t",
    "record_dispatches",
    "DispatchEvent",
    "LaunchMeta",
    "note_launch",
]

# Classifier threshold defaults, the JAX package's (core/tsmm.py:124-128).
# Re-deriving them for the H100 waits for measurements.
SKINNY_RATIO = 16
MAX_SKINNY = 256
MIN_TALL = 2048
MAX_SKINNY_T = 512
SKINNY_RATIO_T = SKINNY_RATIO // 4

_MM_KINDS = ("auto", "dense", "tsm2r", "tsm2l")
_MMT_KINDS = ("auto", "dense", "tsmt")
_ALL_MODES = ("auto", "dense", "tsm2r", "tsm2l", "tsmt")
_QUANT_MODES = ("none", "int8")


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

    ``quant``: "none" (operands stream at their own dtype) or "int8"
    (the kernel kinds quantize their operands and run the int8 kernels,
    the chooser pricing int8 operands; the dense path ignores it). It is
    scope-wide numeric intent, so ``backward_policy`` keeps it.
    """

    mode: str = "auto"
    skinny_ratio: int = SKINNY_RATIO
    max_skinny: int = MAX_SKINNY
    min_tall: int = MIN_TALL
    max_skinny_t: int = MAX_SKINNY_T
    skinny_ratio_t: int = SKINNY_RATIO_T
    executor: str | None = None
    split: str | int = "auto"
    quant: str = "none"

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
        if self.quant not in _QUANT_MODES:
            raise ValueError(
                f"unknown GemmPolicy quant {self.quant!r}: valid values are "
                f"{', '.join(_QUANT_MODES)}")


_DEFAULT_POLICY = GemmPolicy()
_POLICY_VAR: contextvars.ContextVar[GemmPolicy | None] = \
    contextvars.ContextVar("repro_torch_gemm_policy", default=None)


def current_policy() -> GemmPolicy:
    """The innermost active ``with tsmm.policy(...)`` scope, else the
    default policy."""
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
    themselves). An int ``split`` was chosen for the forward shape, so it
    goes back to "auto"; "never", a "dense" mode and ``quant`` are
    scope-wide intent and stay."""
    mode = p.mode if p.mode in ("auto", "dense") else "auto"
    split = "auto" if isinstance(p.split, int) else p.split
    if mode == p.mode and p.executor is None and split == p.split:
        return p
    return dataclasses.replace(p, mode=mode, executor=None, split=split)


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
    resolved ``splits`` (S; 1 for a sequential kernel)."""

    kind: str
    grid: tuple
    splits: int = 1


@dataclasses.dataclass(frozen=True)
class DispatchEvent:
    """One routing decision: which entry, classified kind, chosen executor,
    and the (tall, minor, minor) shape it was made for. Emitted on every
    call (PyTorch runs eagerly; there is no trace to cache). ``split`` is
    the policy's split knob; ``quant`` its quantization knob ("none" |
    "int8"), so a spy can check that an int8 scope reached the int8
    kernels; ``launches`` the kernel launches the call resolved to (empty
    on the dense path)."""

    entry: str       # "mm" (A @ B) | "mmt" (X^T Y)
    kind: str        # "tsm2r" | "tsm2l" | "tsmt" | "dense"
    executor: str    # registry key
    shape: tuple[int, int, int]
    split: str | int = "auto"
    quant: str = "none"
    launches: tuple = ()       # of LaunchMeta


_LISTENERS: list = []
# Per-dispatch LaunchMeta collectors, pushed around an executor while a
# spy listens; ``kernels/ops.py`` reports into the innermost one.
_LAUNCH_NOTES: list = []


def note_launch(kind: str, grid, splits: int = 1) -> None:
    """Record one resolved kernel launch onto the current dispatch's event
    (a no-op outside a listened-to dispatch)."""
    if _LAUNCH_NOTES:
        _LAUNCH_NOTES[-1].append(LaunchMeta(kind, tuple(grid), splits))


@contextlib.contextmanager
def record_dispatches():
    """Collect a DispatchEvent for every routing decision in the scope."""
    log: list[DispatchEvent] = []
    _LISTENERS.append(log.append)
    try:
        yield log
    finally:
        _LISTENERS.remove(log.append)


def _dispatch(entry: str, kind: str, executor: str, shape, p: GemmPolicy,
              run):
    """Run the executor, then emit the spy event with the launches it
    noted. Without listeners this is just ``run()``."""
    if not _LISTENERS:
        return run()
    notes: list = []
    _LAUNCH_NOTES.append(notes)
    try:
        out = run()
    finally:
        _LAUNCH_NOTES.pop()
    ev = DispatchEvent(entry, kind, executor, tuple(shape), p.split,
                       p.quant, tuple(notes))
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


_EXECUTORS = {"torch-dense": _exec_dense, "cuda": _exec_cuda,
              "torch-ref": _exec_ref}


def _select_executor(kind: str, device: torch.device, p: GemmPolicy) -> str:
    if p.executor is not None:
        if p.executor not in _EXECUTORS:
            raise ValueError(
                f"GemmPolicy.executor {p.executor!r} is not registered: "
                f"known executors are {sorted(_EXECUTORS)}")
        return p.executor
    if kind == "dense":
        return "torch-dense"
    if device.type == "cuda":
        return "cuda"
    if device.type == "cpu":
        return "torch-ref"
    raise ValueError(f"no TSM2X executor for tensors on {device}")


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
# Public entries
# ---------------------------------------------------------------------------

def tsmm(a: torch.Tensor, b: torch.Tensor, *, mode: str | None = None,
         policy: GemmPolicy | None = None) -> torch.Tensor:
    """``A[..., m, k] @ B[k, n]`` via the best path for the shape.

    Leading dims of ``a`` collapse into the tall dim for kernel dispatch;
    the dense path contracts the trailing dim in place.
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
    name = _select_executor(kind, a.device, p)
    ex = _EXECUTORS[name]

    def run():
        if a.dim() > 2 and name != "torch-dense":
            return ex("mm", kind, a.reshape(m_tall, k), b, p).reshape(
                *a.shape[:-1], n)
        return ex("mm", kind, a, b, p)

    return _dispatch("mm", kind, name, (m_tall, k, n), p, run)


def tsmm_t(x: torch.Tensor, y: torch.Tensor, *, mode: str | None = None,
           policy: GemmPolicy | None = None) -> torch.Tensor:
    """``X[..., m, a]^T @ Y[..., m, b] -> (a, b)`` via TSMT when the
    reduction is huge and a, b small-ish. Leading dims (shared by both
    operands) collapse into the reduction."""
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
    name = _select_executor(kind, x.device, p)
    return _dispatch("mmt", kind, name, (m_tall, a_dim, b_dim), p,
                     lambda: _EXECUTORS[name]("mmt", kind, x, y, p))
