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
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.ft import host_copy, named_leaves
from repro_torch.models import losses, model
from repro_torch.optim import adamw


def make_loss_fn(cfg, z_loss: float = 1e-4, loss_chunk: int = 512):
    def loss_fn(params, batch):
        hidden, metrics = model.forward_hidden(params, cfg, batch)
        loss, lm = losses.chunked_lm_loss(model.unembed_fn(params, cfg),
                                          hidden, batch, chunk=loss_chunk,
                                          z_loss=z_loss)
        return loss, {**lm, **metrics}
    return loss_fn


def _grads(loss_fn, params, batch):
    named = dict(params.named_parameters())
    loss, aux = loss_fn(params, batch)
    gs = torch.autograd.grad(loss, list(named.values()))
    aux = {k: v.detach() for k, v in aux.items()}
    return loss.detach(), dict(zip(named, gs)), aux


def _microbatch_grads(loss_fn, params, batch, n_micro: int):
    """Gradient accumulation over ``n_micro`` equal slices of the batch:
    peak activation memory / n_micro. As the JAX package does, the
    gradients are summed in f32 and divided by ``n_micro``, the aux
    metrics are averaged, and the loss returned is the last
    microbatch's."""
    b = next(iter(batch.values())).shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} "
                         "microbatches")
    size = b // n_micro
    acc, auxs, loss = None, [], None
    for i in range(n_micro):
        mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
        loss, g, aux = _grads(loss_fn, params, mb)
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
                    grad_transform=None):
    """``grad_transform``: an optional (grads, extra_state) -> (grads,
    extra_state, metrics) hook; PowerSGD plugs in here
    (``lambda g, st: powersgd.compress_tree(ps_cfg, g, st)``)."""
    loss_fn = make_loss_fn(cfg)

    def train_step(state, batch):
        params, opt_state = state["params"], state["opt"]
        extra = state.get("extra")
        if n_micro and n_micro > 1:
            loss, grads, aux = _microbatch_grads(loss_fn, params, batch,
                                                 n_micro)
        else:
            loss, grads, aux = _grads(loss_fn, params, batch)
        gmetrics = {}
        if grad_transform is not None:
            grads, extra, gmetrics = grad_transform(grads, extra)
        params, opt_state, om = adamw.update(opt_cfg, params, grads,
                                             opt_state)
        metrics = {"loss": loss, **aux, **om, **gmetrics}
        metrics["step_ok"] = (torch.isfinite(loss)
                              & torch.isfinite(om["grad_norm"]))
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
    device. The names must match the state's exactly."""
    live = dict(named_leaves(state))
    if live.keys() != snapshot.keys():
        missing = sorted(live.keys() - snapshot.keys())
        extra = sorted(snapshot.keys() - live.keys())
        raise KeyError(f"[snapshot-tree] snapshot does not match the state:"
                       f" missing {missing[:4]}, unknown {extra[:4]}")
    for n, t in live.items():
        src = snapshot[n]
        if src.shape != t.shape or src.dtype != t.dtype:
            raise ValueError(f"[snapshot-tree] {n}: {tuple(src.shape)} "
                             f"{src.dtype} != {tuple(t.shape)} {t.dtype}")
        t.copy_(src)
    return state
