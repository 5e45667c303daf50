"""Carry parameters from the JAX package's layout into the port's modules.

``params_from_jax(cfg, tree)`` takes the pytree that the JAX package's
``models.model.init`` returns, with every leaf already a numpy array
(``jax.tree.map(np.asarray, params)``), and returns the port's ``LM``. A
segment's layers arrive stacked on a leading axis (the JAX package's
``_stack_init``); they are split into the ``nn.ModuleList``.
``state_from_jax(cfg, state)`` carries a whole JAX train state (parameters,
AdamW moments and step, PowerSGD error buffers and Q factors) into the
port's train state the same way. Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import model


def _tensor(arr) -> torch.Tensor:
    arr = np.array(arr)   # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":   # numpy extension dtype: go by bits
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _leaf(tree, name: str, field: str | None = None):
    """The JAX leaf for one port parameter name; ``field`` picks an entry
    of a per-parameter dict leaf (the AdamW moments' "m"/"v")."""
    parts = name.split(".")
    i = None
    if parts[0] == "layers":            # layers.<i>.<module>.<param>
        i, parts = int(parts[1]), ["segments", 0, *parts[2:]]
    node = tree
    for key in parts:
        node = node[key]
    if field is not None:
        node = node[field]
    return node if i is None else node[i]


def _walk(tree, prefix=""):
    """(dotted path, node) for every non-container node of a JAX pytree."""
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, (list, tuple))
             else None)
    if items is None or (isinstance(tree, dict) and "q" in tree):
        yield prefix, tree
        return
    for key, sub in items:
        yield from _walk(sub, f"{prefix}.{key}" if prefix else str(key))


def params_from_jax(cfg, tree, *, device=None) -> model.LM:
    """The port's ``LM`` for ``cfg`` holding the JAX package's parameters,
    on ``device`` (the card unless the caller passes one)."""
    dev = resolve_device(device)
    lm = model.LM(cfg, dev)
    for name, p in lm.named_parameters():
        try:
            src = _tensor(_leaf(tree, name))
        except (KeyError, IndexError) as e:
            raise KeyError(f"JAX params have no leaf for {name!r}") from e
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: JAX shape {tuple(src.shape)} != "
                             f"port shape {tuple(p.shape)}")
        p.data.copy_(src.to(p.dtype))
    return lm


def state_from_jax(cfg, state, *, device=None) -> dict:
    """The port's train state for the JAX package's one
    (``train_step.init_train_state`` plus ``powersgd.init`` as
    ``extra``), every leaf already a numpy array. Parameters require
    grad; moments and PowerSGD buffers are f32 on ``device`` (the card
    unless the caller passes one)."""
    dev = resolve_device(device)
    params = params_from_jax(cfg, state["params"], device=dev)
    params.requires_grad_(True)
    moments = {name: {f: _tensor(_leaf(state["opt"]["moments"], name, f))
                      .to(device=dev, dtype=torch.float32)
                      for f in ("m", "v")}
               for name, _ in params.named_parameters()}
    out = {"params": params,
           "opt": {"step": torch.tensor(int(state["opt"]["step"]),
                                        dtype=torch.int32, device=dev),
                   "moments": moments}}
    if state.get("extra") is not None:
        out["extra"] = {path: {k: _tensor(v).to(dev) for k, v in st.items()}
                        for path, st in _walk(state["extra"])
                        if st is not None}
    return out
