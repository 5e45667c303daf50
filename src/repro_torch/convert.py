"""Carry parameters from the JAX package's layout into the port's modules.

``params_from_jax(cfg, tree)`` takes the pytree that the JAX package's
``models.model.init`` returns, with every leaf already a numpy array
(``jax.tree.map(np.asarray, params)``), and returns the port's ``LM``. A
segment's layers arrive stacked on a leading axis (the JAX package's
``_stack_init``); they are split into the ``nn.ModuleList``. Imports
neither JAX nor the JAX package.
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


def _leaf(tree, name: str):
    """The JAX leaf for one port parameter name."""
    parts = name.split(".")
    if parts[0] == "layers":            # layers.<i>.<module>.<param>
        i, path = int(parts[1]), parts[2:]
        node = tree["segments"][0]
        for key in path:
            node = node[key]
        return node[i]
    node = tree
    for key in parts:
        node = node[key]
    return node


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
