"""PowerSGD gradient compression (Vogels et al., NeurIPS'19) on the TSM2X
kernels.

Counterpart of ``src/repro/optim/powersgd.py`` (``PowerSGDConfig`` :61,
``init`` :101, ``_orthonormalize`` :112, ``_orth_factor`` :143,
``compress_one`` :151, ``shard_state`` :184, ``compress_one_sharded``
:207, ``compress_tree_sharded`` :259, ``compress_tree`` :296). Each
eligible gradient G (d1 x d2) is compressed to rank r:

    P = G @ Q          # (d1, r)  -- tsm2r
    Q' = G^T @ P_orth  # (d2, r)  -- tsmt; its 32 output tiles (d2 =
                       #             4096, r = 4) leave SMs idle, so the
                       #             one-launch kernel spreads m over S
                       #             slices itself

with error feedback. Both projections go through ``core.tsmm`` and follow
the active ``tsmm.policy(...)`` scope (or ``policy=``). ``compress="int8"``
applies ``kernels.quant.fake_quant`` to P after the TSM2R projection and
to Q after the TSMT, and counts each factor at 1 byte an element plus its
f32 scale (the JAX package's int8 wire format). ``orth="tsqr"``
orthonormalizes P with ``linalg.tsqr`` (CholeskyQR2: per pass a tsmt
Gram and a tsm2l apply) instead of Gram-Schmidt.

Two executions of the same protocol:

* ``compress_one`` / ``compress_tree`` -- the replicated one: ``psum``, a
  mean-reduce callable over the data-parallel ranks (None on one
  process), reduces both factors, which every rank then holds whole;
* ``compress_one_sharded`` / ``compress_tree_sharded`` -- per rank, over
  the mesh dim ``axis`` of a ``DeviceMesh``, with the collectives of
  ``kernels.compat``: the Q factor's state stays row-sharded
  (:func:`shard_state`), Q is mean-reduced with ``psum_scatter`` and
  gathered where the full Q is needed, and under ``orth="tsqr"`` P is
  orthonormalized row-sharded by ``linalg.tree_tsqr``. Equal to the
  replicated protocol up to rounding (psum == psum_scatter + all_gather);
  on one rank, bit for bit.

Which leaves compress is decided on the JAX package's layout
(``repro_torch.layout``), where a segment's layers are stacked on a
leading axis (a zamba2 group's Mamba2 layers on two): a leaf is
eligible when its JAX shape is 2-D with at least ``min_size`` elements.
Layer weights are 3-D there and stay dense; a per-layer vector (norm
scale, bias) is a 2-D ``(L, d)`` leaf there and is compressed as that
stacked matrix here too; zamba2's shared block is not stacked, so its
matrices compress as they are. State is keyed by the JAX leaf path (``embed.table``,
``segments.0.attn.bq``), so ``convert.state_from_jax`` carries it over.

Deliberate differences from the JAX package:

* Q's initial draw: JAX seeds it from Python's ``hash(str(path))``, which
  changes from process to process; this port seeds a ``torch.Generator``
  from ``zlib.crc32`` of the leaf path and ``seed``, so an init repeats.
  Parity tests carry Q across from JAX instead of comparing inits.
* ``_orthonormalize``'s fresh direction for a degenerate column comes from
  a generator seeded with the column index, not ``jax.random.PRNGKey(i)``:
  the two agree only while no column degenerates.
"""

from __future__ import annotations

import dataclasses
import zlib

import torch

from repro_torch import layout, linalg
from repro_torch.core import tsmm
from repro_torch.kernels import compat, quant

_ORTH_MODES = ("gram_schmidt", "tsqr")
_COMPRESS_MODES = ("none", "int8")


@dataclasses.dataclass(frozen=True)
class PowerSGDConfig:
    rank: int = 4
    min_size: int = 256 * 256      # params smaller than this stay dense
    ef_decay: float = 1.0          # error-feedback retention
    orth: str = "gram_schmidt"
    compress: str = "none"

    def __post_init__(self):
        if self.orth not in _ORTH_MODES:
            raise ValueError(
                f"unknown PowerSGDConfig orth {self.orth!r}: valid values "
                f"are {', '.join(_ORTH_MODES)}")
        if self.compress not in _COMPRESS_MODES:
            raise ValueError(
                f"unknown PowerSGDConfig compress {self.compress!r}: valid "
                f"values are {', '.join(_COMPRESS_MODES)}")


def compressible(cfg: PowerSGDConfig, params) -> dict:
    """The leaves PowerSGD compresses, ``{JAX path: (JAX shape, port
    names)}``: 2-D in the JAX layout with at least ``min_size``
    elements. Reads only shapes, so a model on the meta device answers
    for its full size."""
    named = dict(params.named_parameters())
    out = {}
    for path, names in layout.jax_leaves(named).items():
        shape = layout.jax_shape(named, names)
        if len(shape) == 2 and shape[0] * shape[1] >= cfg.min_size:
            out[path] = (shape, names)
    return out


def init(cfg: PowerSGDConfig, params, seed: int = 0) -> dict:
    """Per-leaf state for the compressible leaves: the error-feedback
    buffer and a warm-started Q, ``{path: {"err", "q"}}``."""
    named = dict(params.named_parameters())
    state = {}
    for path, (shape, names) in compressible(cfg, params).items():
        dev = named[names[0]].device
        q = _draw((shape[1], cfg.rank), zlib.crc32(path.encode()) ^ seed,
                  dev)
        state[path] = {"err": torch.zeros(shape, device=dev), "q": q}
    return state


def _draw(shape, seed: int, device, dtype=torch.float32):
    """``torch.randn`` of ``shape`` from a generator seeded with ``seed`` on
    ``device``; on the meta device (the roofline's count of a step), which
    has no generator, its shape alone."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device, dtype=dtype)


def _orthonormalize(m: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt on a skinny (d, r): r is tiny so the loop unrolls.

    A degenerate column (zero, or dependent on the columns before it: the
    projection residual keeps under 1e-4 of its norm) is replaced by a
    fresh direction drawn from a generator seeded with the column index,
    projected against the basis so far. Selection is by ``torch.where``, so
    nothing waits on the card."""
    d = m.shape[0]
    tiny = torch.finfo(torch.float32).tiny
    cols = []
    for i in range(m.shape[1]):
        c = m[:, i]
        norm0 = torch.linalg.vector_norm(c)
        fresh = _draw((d,), i, m.device, m.dtype)
        for prev in cols:
            c = c - torch.dot(prev, c) * prev
            fresh = fresh - torch.dot(prev, fresh) * prev
        resid = torch.linalg.vector_norm(c)
        degenerate = resid <= 1e-4 * norm0 + tiny
        unit = c / torch.clamp(resid, min=tiny)
        fresh_unit = fresh / torch.clamp(torch.linalg.vector_norm(fresh),
                                         min=tiny)
        cols.append(torch.where(degenerate, fresh_unit, unit))
    return torch.stack(cols, dim=1)


def _orth_factor(cfg: PowerSGDConfig, p: torch.Tensor, policy=None):
    """Orthonormalize the P factor per ``cfg.orth``."""
    if cfg.orth == "tsqr":
        q, _ = linalg.tsqr(p, policy=policy)
        return q
    return _orthonormalize(p)


@torch.no_grad()
def compress_one(cfg: PowerSGDConfig, grad, st, *, psum=None, policy=None):
    """The protocol (Vogels et al.'s order, which matters across ranks):

        P = (G+e) Q_prev ; P = psum(P) ; P = orth(P)
        Q = (G+e)^T P    ; Q = psum(Q)
        approx = P Q^T   ; e = (G+e) - approx

    ``psum`` must be a mean over the data-parallel ranks, or None on one
    process."""
    g = grad.float() + st["err"] * cfg.ef_decay
    p = tsmm.tsmm(g, st["q"], policy=policy)                      # TSM2R
    if cfg.compress == "int8":
        p = quant.fake_quant(p)
    if psum:
        p = psum(p)
    p = _orth_factor(cfg, p, policy)
    q = tsmm.tsmm_t(g, p, policy=policy)                          # TSMT
    if cfg.compress == "int8":
        q = quant.fake_quant(q)
    if psum:
        q = psum(q)
    approx = p @ q.transpose(0, 1)
    err = g - approx
    return approx, dict(st, err=err, q=q)


# ---------------------------------------------------------------------------
# The sharded-factor protocol (per rank, over one dim of a DeviceMesh)
# ---------------------------------------------------------------------------

def shard_state(state: dict, *, mesh, axis: str) -> dict:
    """Each leaf's Q cut to this rank's row block over ``axis``: (d2, r)
    -> (d2/N, r), a copy, so the full Q is not kept alive. The
    error-feedback buffers stay whole (they are rank-local state). A Q
    whose rows do not divide the rank count stays whole, and
    ``compress_one_sharded`` then reduces it replicated."""
    size = compat.axis_size(mesh, axis)
    idx = compat.axis_index(mesh, axis)
    out = {}
    for path, st in state.items():
        q = st["q"]
        if q.shape[0] % size != 0:
            out[path] = st
            continue
        slab = q.shape[0] // size
        out[path] = dict(st, q=q[idx * slab:(idx + 1) * slab].clone())
    return out


@torch.no_grad()
def compress_one_sharded(cfg: PowerSGDConfig, grad, st, *, mesh, axis: str,
                         policy=None):
    """One rank's gradient through the protocol with the Q factor kept
    row-sharded over mesh dim ``axis``; ``st["q"]`` holds this rank's
    (d2/N, r) block (see :func:`shard_state`).

    The collectives, against the replicated protocol's two mean-psums:

        gather(Q_prev)                      # full Q for the P projection
        P = pmean(G~ Q_prev); orth          # small (d1, r) all-reduce
        Q = psum_scatter(G~^T P) / N        # the sharded mean
        gather(Q) for the local decompress  # P Q^T needs full rows

    Under ``orth="tsqr"`` with P's rows tiling the ranks, P's mean is
    scattered instead, orthonormalized by ``linalg.tree_tsqr`` (only the
    (r, r) R blocks travel) and gathered back. The GEMMs dispatch with
    ``shard_map="local"``: the tensors are this rank's."""
    p_loc = (policy if policy is not None
             else tsmm.current_policy()).with_(shard_map="local")
    size = compat.axis_size(mesh, axis)
    q_sharded = st["q"].shape[0] * size == grad.shape[1]
    q_prev = (compat.all_gather(st["q"], mesh, axis) if q_sharded
              else st["q"])
    g = grad.float() + st["err"] * cfg.ef_decay
    p = tsmm.tsmm(g, q_prev, policy=p_loc)                        # TSM2R
    if cfg.compress == "int8":
        p = quant.fake_quant(p)
    if cfg.orth == "tsqr" and p.shape[0] % size == 0:
        p_shard = compat.psum_scatter(p, mesh, axis) / size
        p_orth, _ = linalg.tree_tsqr(p_shard, mesh=mesh, axis=axis,
                                     policy=p_loc)
        p = compat.all_gather(p_orth, mesh, axis)
    else:
        p = compat.pmean(p, mesh, axis)
        p = _orth_factor(cfg, p, p_loc)
    q_local = tsmm.tsmm_t(g, p, policy=p_loc)                     # TSMT
    if cfg.compress == "int8":
        q_local = quant.fake_quant(q_local)
    if q_sharded:
        q_new = compat.psum_scatter(q_local, mesh, axis) / size
        q_full = compat.all_gather(q_new, mesh, axis)
    else:
        q_new = q_full = compat.pmean(q_local, mesh, axis)
    approx = p @ q_full.transpose(0, 1)
    err = g - approx
    return approx, dict(st, err=err, q=q_new)


def _tree(cfg, grads, state, one, reduce_dense):
    """The loop of ``compress_tree`` and ``compress_tree_sharded``: each
    eligible leaf through ``one(g, st)`` and back in place of the
    original, the rest through ``reduce_dense`` (None: as they are)."""
    out, new_state = dict(grads), dict(state)
    bytes_dense = bytes_sent = 0
    for path, names in layout.jax_leaves(grads).items():
        size = sum(grads[n].numel() for n in names)
        bytes_dense += size * 4
        st = state.get(path)
        if st is None:
            if reduce_dense:
                for n in names:
                    out[n] = reduce_dense(grads[n])
            bytes_sent += size * 4
            continue
        stacked = layout.stacked(names)
        g = (torch.stack([grads[n] for n in names]).reshape(st["err"].shape)
             if stacked else grads[names[0]])
        approx, new_state[path] = one(g, st)
        # int8 wire format: 1 byte an element plus one f32 scale a factor
        # (the sharded protocol's scatter and gather of Q count once: they
        # replace the replicated protocol's psum of Q).
        fb, ov = (1, 2 * 4) if cfg.compress == "int8" else (4, 0)
        bytes_sent += (g.shape[1] + g.shape[0]) * cfg.rank * fb + ov
        approx = approx.to(g.dtype)
        if stacked:     # back to one tensor a port name, in index order
            approx = approx.reshape(len(names), *grads[names[0]].shape)
        for i, n in enumerate(names):
            out[n] = approx[i] if stacked else approx
    metrics = {"powersgd_compression": bytes_dense / max(bytes_sent, 1)}
    return out, new_state, metrics


@torch.no_grad()
def compress_tree(cfg: PowerSGDConfig, grads: dict, state: dict, *,
                  psum=None, policy=None):
    """Compress each eligible gradient, reduce its factors with ``psum``
    (a mean-reduce callable; None on one process) and decompress it in
    place of the original; the rest are reduced dense with ``psum``, or
    pass through. ``grads`` maps port parameter names to gradients.
    Returns (grads, state, metrics)."""
    return _tree(cfg, grads, state,
                 lambda g, st: compress_one(cfg, g, st, psum=psum,
                                            policy=policy), psum)


@torch.no_grad()
def compress_tree_sharded(cfg: PowerSGDConfig, grads: dict, state: dict, *,
                          mesh, axis: str, policy=None):
    """``compress_tree`` per rank over mesh dim ``axis``: eligible leaves
    go through :func:`compress_one_sharded` (``state`` from
    :func:`shard_state`), the rest are mean-reduced dense over ``axis``.
    Returns (grads, state, metrics)."""
    return _tree(cfg, grads, state,
                 lambda g, st: compress_one_sharded(
                     cfg, g, st, mesh=mesh, axis=axis, policy=policy),
                 lambda g: compat.pmean(g, mesh, axis))
