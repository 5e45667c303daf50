"""Shape-dispatched tall-and-skinny matmul behind a scoped ``GemmPolicy``.

Counterpart of ``src/repro/core/tsmm.py``, with what serving needs.
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

Only the sequential kernels exist in this package: dispatch never splits
(the JAX package also never splits under its default single-core spec).
The classifier thresholds keep the JAX package's defaults, so both packages
classify every shape the same way.
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
    "classify_gemm",
    "classify_gemm_t",
    "tsmm",
    "tsmm_t",
    "record_dispatches",
    "DispatchEvent",
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


@dataclasses.dataclass(frozen=True)
class GemmPolicy:
    """What the GEMM dispatcher decides from.

    ``mode``: "auto" classifies; "dense" sends every call to
    ``torch.matmul``; a kind name ("tsm2r"/"tsm2l" for ``tsmm``, "tsmt" for
    ``tsmm_t``) forces that kernel for its own entry and leaves the other
    entry on auto. The five thresholds are those of the JAX package's
    policy (see its docstring for their derivation). ``executor`` pins a
    registered backend by name.
    """

    mode: str = "auto"
    skinny_ratio: int = SKINNY_RATIO
    max_skinny: int = MAX_SKINNY
    min_tall: int = MIN_TALL
    max_skinny_t: int = MAX_SKINNY_T
    skinny_ratio_t: int = SKINNY_RATIO_T
    executor: str | None = None

    def __post_init__(self):
        if self.mode not in _ALL_MODES:
            raise ValueError(
                f"unknown GemmPolicy mode {self.mode!r}: valid modes are "
                f"{', '.join(_ALL_MODES)}")


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
class DispatchEvent:
    """One routing decision: which entry, classified kind, chosen executor,
    and the (tall, minor, minor) shape it was made for. Emitted on every
    call (PyTorch runs eagerly; there is no trace to cache)."""

    entry: str       # "mm" (A @ B) | "mmt" (X^T Y)
    kind: str        # "tsm2r" | "tsm2l" | "tsmt" | "dense"
    executor: str    # registry key
    shape: tuple[int, int, int]


_LISTENERS: list = []


@contextlib.contextmanager
def record_dispatches():
    """Collect a DispatchEvent for every routing decision in the scope."""
    log: list[DispatchEvent] = []
    _LISTENERS.append(log.append)
    try:
        yield log
    finally:
        _LISTENERS.remove(log.append)


def _notify(entry: str, kind: str, executor: str, shape) -> None:
    if _LISTENERS:
        ev = DispatchEvent(entry, kind, executor, tuple(shape))
        for cb in tuple(_LISTENERS):
            cb(ev)


# ---------------------------------------------------------------------------
# Backend registry
# ---------------------------------------------------------------------------
#
# An executor is ``fn(entry, kind, a, b, policy) -> tensor``. Kernel executors get
# 2-D operands (N-d lhs already collapsed); "torch-dense" may get the
# original N-d lhs for the "mm" entry.

def _exec_dense(entry, kind, a, b, p):
    del kind, p
    if entry == "mm":
        return torch.matmul(a, b)
    return torch.matmul(a.transpose(0, 1), b)


def _exec_ops(entry, kind, a, b, p):
    if kind == "tsm2r":
        return ops.tsm2r(a, b)
    if kind == "tsm2l":
        return ops.tsm2l(a, b)
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
    if a.dim() > 2 and name != "torch-dense":
        out = ex("mm", kind, a.reshape(m_tall, k), b, p).reshape(
            *a.shape[:-1], n)
    else:
        out = ex("mm", kind, a, b, p)
    _notify("mm", kind, name, (m_tall, k, n))
    return out


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
    out = _EXECUTORS[name]("mmt", kind, x, y, p)
    _notify("mmt", kind, name, (m_tall, a_dim, b_dim))
    return out
