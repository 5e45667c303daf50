"""Deterministic GEMM fault injection: seeded, replayable chaos for ABFT.

Counterpart of the GEMM half of ``src/repro/ft/inject.py``
(``GemmFault`` + ``with faults(...)``): flip a chosen bit of a chosen
element of the Nth dispatched GEMM's operands or output. The hook sits at
the executor-registry boundary in ``core/tsmm.py``: every registered
executor is invoked through :func:`tap_executor`, so any route the
dispatcher can reach is injectable. Site numbers count executor
invocations in call order within the scope; a guarded entry
(``GemmPolicy.abft``) dispatches its protected GEMM *before* its checksum
GEMMs, so the protected GEMM takes the lower site.

PyTorch runs the forward eagerly, where JAX traces it once, so two rules
keep the sites where the reference's trace puts them:

* a recompute of a checkpointed segment (``models.layers.remat``) replays
  the segment's sites from the counter value at segment entry
  (:func:`replay`): the same faults land at the same GEMMs, the counter
  does not advance and ``applied`` does not grow, as the reference's
  checkpointed trace is evaluated twice but traced once;
* the backward's re-dispatched GEMMs are no sites (:func:`suspended`,
  which ``core.tsmm.backward_scope`` enters around every backward's
  re-dispatch): autograd runs them on its device thread for CUDA
  tensors, where no scope is set, and on the caller's thread for CPU
  tensors, so only forward sites number the same on both.

A flipped tensor passes its gradient straight through (the reference's
bitcast carries no tangent): a bit flip in a GEMM's result does not change
the backward's formula, which reads the operands, not the output.

``poison_tree`` is the train-loop chaos hook. ``corrupt_checkpoint``
damages a committed ``checkpoint/checkpointer.py`` directory on the host
(a torn ``.tmp`` dir, a truncated array file, a flipped payload bit),
every choice drawn from ``random.Random(seed)``: the same code as the
reference's, so one seed damages the same file, byte and bit in both.

Import discipline: the standard library, ``torch`` and ``repro_torch.ft``
only; the dispatcher imports this module at the top level, so it sits
below every other layer.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
import random

import torch

from repro_torch.ft import is_dtensor, named_leaves

__all__ = [
    "GemmFault",
    "FaultScope",
    "faults",
    "active",
    "current_scope",
    "replay",
    "suspended",
    "flip_bit",
    "tap_executor",
    "poison_tree",
    "corrupt_checkpoint",
]

_OPERANDS = ("a", "b", "out")
_INT_VIEW = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


@dataclasses.dataclass(frozen=True)
class GemmFault:
    """One planned bit flip: at dispatch ``site``, flip ``bit`` of element
    ``(row, col)`` of the named ``operand`` ("a" | "b" | "out"). ``row``
    and ``col`` index the 2-D view the executor sees (N-d lhs operands are
    already collapsed to ``(tall, minor)`` at the tap)."""

    site: int
    operand: str = "out"
    row: int = 0
    col: int = 0
    bit: int = 29

    def __post_init__(self):
        if self.operand not in _OPERANDS:
            raise ValueError(
                f"[inject-operand] unknown operand {self.operand!r}: valid "
                f"targets are {', '.join(_OPERANDS)}")
        if self.site < 0 or self.row < 0 or self.col < 0 or self.bit < 0:
            raise ValueError(
                f"[inject-fault] site/row/col/bit must be >= 0, got {self!r}")


class FaultScope:
    """Mutable per-scope state: the plan, the call-order site counter
    (from ``start``), and the faults actually applied."""

    def __init__(self, plan, start: int = 0):
        self.plan = tuple(plan)
        self.sites_seen = start
        self.applied: list[GemmFault] = []

    def next_site(self) -> int:
        site = self.sites_seen
        self.sites_seen += 1
        return site


_SCOPE: contextvars.ContextVar[FaultScope | None] = contextvars.ContextVar(
    "repro_torch_fault_scope", default=None)


def active() -> bool:
    """Is a fault plan currently in scope?"""
    return _SCOPE.get() is not None


def current_scope() -> FaultScope | None:
    return _SCOPE.get()


@contextlib.contextmanager
def _entered(scope: FaultScope | None):
    token = _SCOPE.set(scope)
    try:
        yield scope
    finally:
        _SCOPE.reset(token)


@contextlib.contextmanager
def faults(*plan: GemmFault):
    """Activate a deterministic GEMM fault plan for the scope.

    Yields the :class:`FaultScope` (``.applied`` lists the faults whose
    sites were reached). Scopes nest and restore on exit. Re-running the
    same computation under a fresh scope with the same plan replays the
    same faults."""
    for f in plan:
        if not isinstance(f, GemmFault):
            raise TypeError(
                f"[inject-plan] fault plans take GemmFault entries, got "
                f"{type(f).__name__}")
    with _entered(FaultScope(plan)) as scope:
        yield scope


def replay(scope: FaultScope | None, start: int):
    """Context in which ``scope``'s plan applies again from site ``start``
    without advancing ``scope``'s counter or adding to its ``applied``:
    the recompute of a checkpointed segment that began at ``start``. With
    ``scope=None`` nothing is injected."""
    return _entered(None if scope is None else FaultScope(scope.plan, start))


def suspended():
    """Context with no fault scope: the GEMMs inside are no sites (the
    backward's re-dispatch)."""
    return _entered(None)


def _flip(x: torch.Tensor, row: int, col: int, bit: int) -> torch.Tensor:
    nbits = x.element_size() * 8
    flat = x if x.dim() == 2 else x.reshape(-1, x.shape[-1])
    u = flat.detach().view(_INT_VIEW[x.element_size()]).clone()
    # The top bit of a signed view is its sign: -2**(nbits-1), not a shift.
    u[row, col] ^= (1 << bit) if bit < nbits - 1 else -(1 << (nbits - 1))
    return u.view(x.dtype).reshape(x.shape)


class _Flip(torch.autograd.Function):
    """The flipped tensor, with the gradient passed straight through."""

    @staticmethod
    def forward(ctx, x, row, col, bit):
        return _flip(x, row, col, bit)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def flip_bit(x: torch.Tensor, row: int, col: int, bit: int) -> torch.Tensor:
    """Flip one bit of ``x[row, col]`` (its 2-D view ``(-1, last dim)``)
    through a signed-integer view as wide as the dtype, without a host
    sync; ``x`` itself is not changed. Differentiable, straight through."""
    nbits = x.element_size() * 8
    if not 0 <= bit < nbits:
        raise ValueError(
            f"[inject-bit] bit {bit} outside [0, {nbits}) for dtype {x.dtype}")
    if x.requires_grad and torch.is_grad_enabled():
        return _Flip.apply(x, row, col, bit)
    return _flip(x, row, col, bit)


def tap_executor(ex, entry, kind, a, b, policy):
    """Invoke executor ``ex`` with the active plan's faults for this
    dispatch site applied: operand flips before the call, output flips
    after. Returns ``(out, applied_faults)``; with no scope active this is
    exactly ``(ex(...), ())``."""
    scope = _SCOPE.get()
    if scope is None:
        return ex(entry, kind, a, b, policy), ()
    site = scope.next_site()
    hits = tuple(f for f in scope.plan if f.site == site)
    for f in hits:
        if f.operand == "a":
            a = flip_bit(a, f.row, f.col, f.bit)
        elif f.operand == "b":
            b = flip_bit(b, f.row, f.col, f.bit)
    out = ex(entry, kind, a, b, policy)
    for f in hits:
        if f.operand == "out":
            out = flip_bit(out, f.row, f.col, f.bit)
    if hits:
        scope.applied.extend(hits)
    return out, hits


def _poison_origin_(x: torch.Tensor, value: float) -> None:
    """Write ``value`` at the global element 0 of ``x``: for a DTensor on
    the ranks that hold it (coordinate 0 on every mesh dim that shards
    it, so every replica of it too), as the reference writes element 0 of
    a global array."""
    if is_dtensor(x):
        from torch.distributed.tensor import Shard
        coord = x.device_mesh.get_coordinate()
        if any(isinstance(p, Shard) and coord[i] != 0
               for i, p in enumerate(x.placements)):
            return
        x = x.to_local()
    x.view(-1)[0] = value


def poison_tree(tree, *, leaf_index: int = 0, value: float = float("nan")):
    """Overwrite element 0 of the ``leaf_index``-th non-empty float leaf
    (sorted-name order) with ``value`` (NaN by default): the train-loop
    chaos hook for a transient in-memory fault. A flat mapping comes back
    as a new dict holding a poisoned copy of that leaf; an ``nn.Module``
    is poisoned in place (its parameters are the state a step reads) and
    returned. A DTensor leaf is poisoned at its global element 0."""
    leaves = [(n, x) for n, x in named_leaves(tree)
              if isinstance(x, torch.Tensor) and x.numel() > 0
              and x.is_floating_point()]
    if not leaves:
        raise ValueError("[inject-poison] tree has no non-empty float leaves")
    name, x = leaves[leaf_index % len(leaves)]
    if isinstance(tree, torch.nn.Module):
        with torch.no_grad():
            _poison_origin_(x, value)
        return tree
    if name not in tree:
        raise ValueError(f"[inject-poison] {name} lies in a nested mapping: "
                         "pass its module or a flat mapping")
    poisoned = x.detach().clone()
    _poison_origin_(poisoned, value)
    return {**tree, name: poisoned}


# ---------------------------------------------------------------------------
# Host-side checkpoint corruptors
# ---------------------------------------------------------------------------

_CKPT_MODES = ("torn-tmp", "truncate", "bitflip")


def _committed_steps(root: str) -> list[int]:
    out = []
    for name in os.listdir(root):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(root, name, "manifest.json")):
                out.append(int(name.split("_")[1]))
    return sorted(out)


def corrupt_checkpoint(root: str, *, mode: str, seed: int = 0,
                       step: int | None = None) -> str:
    """Deterministically damage a checkpoint directory; returns the damaged
    path. Modes:

    * ``"torn-tmp"``  -- create a partial ``step_*.tmp`` dir (a preempted
      writer); restore must ignore it and the next save garbage-collects.
    * ``"truncate"``  -- truncate one committed ``arr_*.npy`` to half size;
      ``np.load`` / crc32 must fail the restore of that step.
    * ``"bitflip"``   -- flip one payload bit of one committed array file;
      the manifest crc32 must catch it.

    ``seed`` drives every choice through ``random.Random`` -- same seed,
    same damage. ``step=None`` targets the newest committed step (for
    "torn-tmp": one past it).
    """
    if mode not in _CKPT_MODES:
        raise ValueError(
            f"[inject-ckpt-mode] unknown mode {mode!r}: valid modes are "
            f"{', '.join(_CKPT_MODES)}"
        )
    rng = random.Random(seed)
    steps = _committed_steps(root)
    if mode == "torn-tmp":
        torn_step = step if step is not None else (steps[-1] + 1 if steps
                                                   else 0)
        d = os.path.join(root, f"step_{torn_step:09d}.tmp")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "arr_00000.npy"), "wb") as f:
            f.write(bytes(rng.getrandbits(8) for _ in range(64)))
        return d
    if step is None:
        if not steps:
            raise FileNotFoundError(
                f"[inject-ckpt] no committed checkpoints under {root}"
            )
        step = steps[-1]
    d = os.path.join(root, f"step_{step:09d}")
    arrs = sorted(n for n in os.listdir(d) if n.endswith(".npy"))
    target = os.path.join(d, arrs[rng.randrange(len(arrs))])
    size = os.path.getsize(target)
    if mode == "truncate":
        with open(target, "r+b") as f:
            f.truncate(max(1, size // 2))
        return target
    # bitflip: stay past the .npy header so the array *payload* is hit and
    # only the crc32 (not the header parse) can catch it.
    lo = 128 if size > 128 else 0
    off = rng.randrange(lo, size)
    with open(target, "r+b") as f:
        f.seek(off)
        byte = f.read(1)[0]
        f.seek(off)
        f.write(bytes([byte ^ (1 << rng.randrange(8))]))
    return target
