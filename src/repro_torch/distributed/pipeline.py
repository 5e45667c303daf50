"""Pipeline parallelism: a GPipe schedule over a list of stages.

Counterpart of ``src/repro/distributed/pipeline.py``. The layer stack
splits into S stages; M microbatches flow through a rotating activation
buffer of S slots. Each schedule tick runs every stage on its resident
microbatch and rotates the buffer one stage forward; outputs collect as
microbatches drain from the last stage. Plain GPipe: M microbatches over
S stages in M + S - 1 ticks (bubble fraction (S - 1) / (M + S - 1)).

In PyTorch's idiom the stages are a Python list (stage s holds its layers'
parameters, :func:`split_stages`) walked by a loop, not a stacked pytree
under ``vmap``: a hand-written kernel does not run under
``torch.func.vmap``.

* ``stage_axis=None``: one process runs the whole tick loop, which must
  equal applying the stages in sequence (and is differentiable).
* ``stage_axis="<mesh dim>"`` with ``mesh``: rank s of that mesh dim runs
  stage s alone; the buffer's rotation is ``kernels.compat.ppermute``
  (the reference's collective-permute) and the last stage's outputs are
  broadcast along the dim, so every rank returns them. Forward only: the
  point-to-point exchange carries no gradient.

Deliberate difference: a slot that holds no microbatch (the bubble: the
reference feeds zeros there and computes on them) is skipped. Its output
is never read, so the result is the same, and no stage launches work on
a bubble.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.kernels import compat


def split_stages(layer_params: list, n_stages: int) -> list:
    """``layer_params`` (one entry a layer, in order) as ``n_stages`` lists
    of consecutive layers."""
    n_layers = len(layer_params)
    if n_layers % n_stages != 0:
        raise ValueError(f"{n_layers} layers do not split into {n_stages} "
                         "stages")
    per = n_layers // n_stages
    return [list(layer_params[s * per:(s + 1) * per])
            for s in range(n_stages)]


def make_stage_fn(layer_fn):
    """Wrap a per-layer ``layer_fn(lp, x) -> x`` into a per-stage fn that
    applies the stage's layers in order."""
    def stage_fn(params_stage, x):
        for lp in params_stage:
            x = layer_fn(lp, x)
        return x
    return stage_fn


def pipeline_apply(stage_fn, stage_params: list, microbatches, *,
                   stage_axis: str | None = None, mesh=None):
    """Run ``microbatches`` (M, B, ...) through the S stages of
    ``stage_params`` (``stage_fn(stage_params[s], x) -> x``). Returns the
    (M, B, ...) outputs. With ``stage_axis``, the mesh dim of that name
    must have S ranks."""
    s_n = len(stage_params)
    m_n = microbatches.shape[0]
    if stage_axis is None:
        return _local(stage_fn, stage_params, microbatches, s_n, m_n)
    if mesh is None:
        raise ValueError("pipeline_apply(stage_axis=...) needs the mesh")
    if compat.axis_size(mesh, stage_axis) != s_n:
        raise ValueError(f"{s_n} stages over the "
                         f"{compat.axis_size(mesh, stage_axis)} ranks of "
                         f"mesh dim {stage_axis!r}")
    return _sharded(stage_fn, stage_params, microbatches, s_n, m_n, mesh,
                    stage_axis)


def _local(stage_fn, stage_params, microbatches, s_n, m_n):
    buf = [None] * s_n              # slot s: the microbatch at stage s
    outs = [None] * m_n
    for t in range(m_n + s_n - 1):
        buf[0] = microbatches[t] if t < m_n else None
        buf = [None if x is None else stage_fn(stage_params[s], x)
               for s, x in enumerate(buf)]
        if t >= s_n - 1:            # drain: microbatch t - (S - 1) is done
            outs[t - (s_n - 1)] = buf[-1]
        buf = [buf[-1]] + buf[:-1]  # rotate one stage forward
    return torch.stack(outs)


def _sharded(stage_fn, stage_params, microbatches, s_n, m_n, mesh, axis):
    me = compat.axis_index(mesh, axis)
    ring = [(s, (s + 1) % s_n) for s in range(s_n)]
    buf = torch.zeros_like(microbatches[0])
    outs = torch.zeros_like(microbatches)
    for t in range(m_n + s_n - 1):
        if me == 0 and t < m_n:
            buf = microbatches[t]
        if 0 <= t - me < m_n:       # this stage holds microbatch t - me
            buf = stage_fn(stage_params[me], buf)
            if me == s_n - 1:
                outs[t - me] = buf
        buf = compat.ppermute(buf, mesh, axis, ring)
    group = compat.axis_mesh(mesh, axis).get_group()
    dist.broadcast(outs, dist.get_global_rank(group, s_n - 1), group=group)
    return outs
