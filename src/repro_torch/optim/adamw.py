"""AdamW over a dict of named parameters.

Counterpart of ``src/repro/optim/adamw.py`` (``AdamWConfig`` :24, ``init``
:40, ``global_norm`` :53, ``update`` :58): f32 moments, global-norm
clipping, decoupled weight decay, bias correction, parameters cast back to
their dtype. The JAX package returns new arrays; this port updates the
parameters and moments in place, which saves a copy of the whole state
(10.8 GB of moments alone at chatglm3-6b's width and 4 layers).
``state_dtype`` keeps the moments in another dtype (the dry run's
``"bfloat16"`` past 1e11 parameters, as the reference's): the update
reads them into f32 and stores them back, as the reference does.

DTensor parameters (``distributed.sharding``) get DTensor moments in the
same placements (``torch.zeros_like``), as the reference's moments take
the parameter specs. ``update(update_specs=)`` pins the update arithmetic
to other placements (ZeRO-1: replicated parameters, sharded moments).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.distributed import sharding


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str | None = None   # None = f32 moments


def init(cfg: AdamWConfig, params) -> dict:
    """``{"step": 0-d int32, "moments": {name: {"m", "v"}}}`` with zeros
    of ``cfg.state_dtype`` (f32 by default), on the parameters' device
    (and, for DTensor parameters, in their placements)."""
    sd = getattr(torch, cfg.state_dtype or "float32")
    named = dict(params.named_parameters())
    dev = next(iter(named.values())).device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "moments": {n: {"m": torch.zeros_like(p, dtype=sd),
                            "v": torch.zeros_like(p, dtype=sd)}
                        for n, p in named.items()}}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum over tensors of their f32 sums of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tensors))


@torch.no_grad()
def update(cfg: AdamWConfig, params, grads: dict, state: dict,
           update_specs: dict | None = None):
    """One AdamW step in place. ``grads`` maps parameter names to
    gradients. Returns (params, state, metrics).

    ``update_specs``: optional ``{name: spec}`` for the f32 update
    arithmetic of DTensor parameters (ZeRO-1: with replicated params and
    mesh-sharded moments, the pins keep g / m / v / delta in the sharded
    domain, so the only full-size tensor is the new parameter, which goes
    back to the parameter's placements)."""
    step = state["step"] + 1
    gnorm = global_norm(grads.values())
    one = torch.ones((), dtype=torch.float32, device=gnorm.device)
    clip = (torch.minimum(one, cfg.grad_clip / (gnorm + 1e-9))
            if cfg.grad_clip else one)
    lr = (cfg.lr(step) if callable(cfg.lr)
          else torch.tensor(cfg.lr, dtype=torch.float32, device=one.device))
    stepf = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, device=one.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, device=one.device), stepf)
    for name, p in params.named_parameters():
        spec = None if update_specs is None else update_specs[name]

        def pin(x):
            return x if spec is None else sharding.maybe_wsc_spec(x, spec)

        g = pin(grads[name].float() * clip)
        mom = state["moments"][name]
        m, v = mom["m"], mom["v"]
        if m.dtype == torch.float32:
            m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
            v.mul_(cfg.b2).add_(torch.square(g) * (1 - cfg.b2))
        else:
            m32 = m.float() * cfg.b1 + g * (1 - cfg.b1)
            v32 = v.float() * cfg.b2 + torch.square(g) * (1 - cfg.b2)
            m.copy_(m32)
            v.copy_(v32)
            m, v = m32, v32
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * pin(p.float())
        new_p = (pin(p.float()) - lr * delta).to(p.dtype)
        if spec is not None:
            new_p = new_p.redistribute(p.device_mesh, p.placements)
        p.copy_(new_p)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr, "clip_coef": clip}
