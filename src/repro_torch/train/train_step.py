"""Training step: loss -> grad -> (grad transform) -> clip -> AdamW, with
grad-accumulation microbatching.

Counterpart of ``src/repro/train/train_step.py`` (``make_loss_fn`` :26,
``_microbatch_grads`` :48, ``make_train_step`` :95, ``init_train_state``
:139, ``host_snapshot`` :147, ``restore_snapshot`` :157). PyTorch runs
eagerly: the step is a plain callable, gradients come from
``torch.autograd.grad`` over the parameters, and the parameters, moments
and gradient accumulators are updated in place. The state is
``{"params": LM, "opt": adamw state[, "extra": grad-transform state]}``.

Every step's metrics carry ``step_ok`` (loss and grad norm both finite),
the device-side half of ``launch/train.py``'s fault-or-retry decision;
``host_snapshot`` / ``restore_snapshot`` are its first line of recovery.
An MoE model's loss carries the reference's balance term,
``1e-2 * moe_balance_loss / n_layers``.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.distributed import sharding
from repro_torch.ft import host_copy, is_dtensor, local, named_leaves
from repro_torch.models import losses, model
from repro_torch.optim import adamw


def _check_placements(params, param_shardings) -> None:
    """Every parameter lies in its placements (``sharding.named``'s)."""
    for name, p in params.named_parameters():
        want = list(param_shardings[name])
        got = list(getattr(p, "placements", ()))
        if got != want:
            raise ValueError(f"[mesh-placement] {name} lies in {got}, the "
                             f"shardings say {want}")


def make_loss_fn(cfg, z_loss: float = 1e-4, loss_chunk: int = 512,
                 param_shardings=None):
    """``param_shardings``: ``{name: placements}`` (``sharding.named`` of
    the parameter specs). The reference pins the parameters to them (and
    through the transpose their cotangents); DTensor parameters already
    carry placements, so here the loss checks them, and the gradients are
    pinned where they are made (:func:`_grads`)."""
    def loss_fn(params, batch):
        if param_shardings is not None:
            _check_placements(params, param_shardings)
        hidden, metrics = model.forward_hidden(params, cfg, batch)
        loss, lm = losses.chunked_lm_loss(model.unembed_fn(params, cfg),
                                          hidden, batch, chunk=loss_chunk,
                                          z_loss=z_loss)
        if "moe_balance_loss" in metrics:
            # balance term is diagnostic-weighted; DeepSeek-style bias
            # balancing happens outside the gradient (router_bias update).
            loss = loss + 1e-2 * metrics["moe_balance_loss"] / cfg.n_layers
        return loss, {**lm, **metrics}
    return loss_fn


def _whole(t):
    """A metric as one plain tensor: a DTensor's full value (a pending sum
    reduced), on every rank."""
    return t.full_tensor() if is_dtensor(t) else t


def _grads(loss_fn, params, batch, shardings=None):
    """(loss, {name: gradient}, aux). A parameter the loss does not reach
    (an MoE layer's ``router_bias``, read only by the top-k selection)
    gets a zero gradient, as ``jax.grad`` gives it. ``shardings``
    (``{name: placements}``) pins each DTensor gradient to its
    placements: a pending sum over the batch's dp ranks (``Partial``) is
    all-reduced there, the reference's gradient reduction."""
    named = dict(params.named_parameters())
    # The backward recomputes checkpointed segments: it needs the scope too.
    with sharding.replicate_constants(params):
        loss, aux = loss_fn(params, batch)
        gs = torch.autograd.grad(loss, list(named.values()),
                                 allow_unused=True, materialize_grads=True)
    if shardings is not None:
        gs = [g.redistribute(g.device_mesh, shardings[n])
              for n, g in zip(named, gs)]
    aux = {k: _whole(v.detach()) for k, v in aux.items()}
    return _whole(loss.detach()), dict(zip(named, gs)), aux


def _microbatches(batch, n_micro: int, mesh):
    """The ``n_micro`` equal row slices of the batch. Microbatch i is rows
    ``[i b / n, (i + 1) b / n)`` of the *global* batch; with ``mesh`` its
    rows are split over the dp dims (the reference's ``P(None, dp)`` pin
    of the reshaped batch), so every rank holds its part of each
    microbatch, not a slice of its own rows cut into n."""
    b = next(iter(batch.values())).shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} "
                         "microbatches")
    size = b // n_micro
    if mesh is None:
        return [{k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                for i in range(n_micro)]
    dp = sharding.dp_axes(mesh)
    split = {k: sharding.maybe_wsc(
        v.reshape(n_micro, size, *v.shape[1:]), None, dp)
        for k, v in batch.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n_micro)]


def _microbatch_grads(loss_fn, params, batch, n_micro: int,
                      acc_shardings=None, mesh=None):
    """Gradient accumulation over ``n_micro`` equal slices of the batch:
    peak activation memory / n_micro. As the JAX package does, the
    gradients are summed in f32 and divided by ``n_micro``, the aux
    metrics are averaged, and the loss returned is the last
    microbatch's. ``acc_shardings`` (``{name: placements}``) pins each
    microbatch's gradients, and so the f32 accumulator, to the
    parameters' placements; ``mesh`` splits each microbatch over its dp
    dims (:func:`_microbatches`)."""
    acc, auxs, loss = None, [], None
    for mb in _microbatches(batch, n_micro, mesh):
        loss, g, aux = _grads(loss_fn, params, mb, acc_shardings)
        if acc is None:
            acc = {n: t.float() for n, t in g.items()}
        else:
            for n, t in g.items():
                acc[n].add_(t.float())
        auxs.append(aux)
        del g
    grads = {n: t.div_(n_micro) for n, t in acc.items()}
    aux = {k: torch.stack([a[k].float() for a in auxs]).mean()
           for k in auxs[0]}
    return loss, grads, aux


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, *, n_micro: int = 0,
                    grad_transform=None, acc_shardings=None, mesh=None,
                    opt_update_specs=None):
    """``grad_transform``: an optional (grads, extra_state) -> (grads,
    extra_state, metrics) hook; PowerSGD plugs in here
    (``lambda g, st: powersgd.compress_tree(ps_cfg, g, st)``).
    ``acc_shardings`` (``{name: placements}``, ``sharding.named`` of the
    parameter specs) pins the gradients and their f32 accumulator to the
    parameters' placements; ``mesh`` splits each microbatch over its dp
    dims; ``opt_update_specs`` (``{name: spec}``, ZeRO-1: the moments'
    specs) pins the gradients onto the update's shards right after the
    backward, and AdamW's update arithmetic with them."""
    loss_fn = make_loss_fn(cfg, param_shardings=acc_shardings)

    def train_step(state, batch):
        params, opt_state = state["params"], state["opt"]
        extra = state.get("extra")
        if n_micro and n_micro > 1:
            loss, grads, aux = _microbatch_grads(loss_fn, params, batch,
                                                 n_micro, acc_shardings,
                                                 mesh)
        else:
            loss, grads, aux = _grads(loss_fn, params, batch, acc_shardings)
        if opt_update_specs is not None:
            grads = {n: sharding.maybe_wsc_spec(g, opt_update_specs[n])
                     for n, g in grads.items()}
        gmetrics = {}
        with sharding.replicate_constants(params):
            if grad_transform is not None:
                grads, extra, gmetrics = grad_transform(grads, extra)
            params, opt_state, om = adamw.update(
                opt_cfg, params, grads, opt_state,
                update_specs=opt_update_specs)
        metrics = {k: _whole(v) for k, v in
                   {"loss": loss, **aux, **om, **gmetrics}.items()}
        metrics["step_ok"] = (torch.isfinite(metrics["loss"])
                              & torch.isfinite(metrics["grad_norm"]))
        new_state = {"params": params, "opt": opt_state}
        if extra is not None:
            new_state["extra"] = extra
        return new_state, metrics

    return train_step


def init_train_state(seed: int, cfg, opt_cfg: adamw.AdamWConfig, extra=None,
                     *, device=None):
    """Random parameters from ``seed`` (``model.init``) that require grad,
    and zero AdamW state, on ``device`` (the card unless the caller passes
    one). ``extra`` is a grad transform's state, e.g. ``powersgd.init``'s,
    built from these parameters by the caller."""
    params = model.init(cfg, seed, device=resolve_device(device))
    params.requires_grad_(True)
    state = {"params": params, "opt": adamw.init(opt_cfg, params)}
    if extra is not None:
        state["extra"] = extra
    return state


def host_snapshot(state, out: dict | None = None) -> dict:
    """Deep host copy of the train state for in-memory rollback: every
    leaf by dotted name (``ft.host_copy``), into ``out`` (the snapshot
    it replaces) when given. Cheaper than a checkpoint (no
    serialization, no fsync): the first line of the retry ladder; the
    Checkpointer is the escalation."""
    return host_copy(state, out)


@torch.no_grad()
def restore_snapshot(snapshot: dict, state):
    """Write a :func:`host_snapshot` (or a restored checkpoint, the same
    mapping of dotted name to tensor) back into the live ``state``, leaf
    by leaf with ``copy_``, and return ``state``. The JAX version builds
    a new tree; writing in place keeps one copy of the state on the
    device. The names must match the state's exactly. A DTensor leaf
    takes either its local shard (a snapshot) or the full leaf (a
    checkpoint), of which it keeps its own shard (``sharding.
    local_part``)."""
    live = dict(named_leaves(state))
    if live.keys() != snapshot.keys():
        missing = sorted(live.keys() - snapshot.keys())
        extra = sorted(snapshot.keys() - live.keys())
        raise KeyError(f"[snapshot-tree] snapshot does not match the state:"
                       f" missing {missing[:4]}, unknown {extra[:4]}")
    for n, t in live.items():
        src, dst = snapshot[n], local(t)
        if is_dtensor(t) and src.shape == t.shape:
            src = sharding.local_part(src, t.device_mesh, t.placements)
        if src.shape != dst.shape or src.dtype != dst.dtype:
            raise ValueError(f"[snapshot-tree] {n}: {tuple(src.shape)} "
                             f"{src.dtype} != {tuple(dst.shape)} {dst.dtype}")
        dst.copy_(src)
    return state
