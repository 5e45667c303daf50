"""Carry parameters from the JAX package's layout into the port's modules.

``params_from_jax(cfg, tree)`` takes the pytree that the JAX package's
``models.model.init`` returns, with every leaf already a numpy array
(``jax.tree.map(np.asarray, params)``), and returns the port's ``LM``. A
segment's layers arrive stacked on a leading axis (the JAX package's
``_stack_init``; a zamba2 group's Mamba2 layers on two, ``layout``); they
are split into the ``nn.ModuleList``s.
A tree whose leaves include int8 weight records (the JAX package's
``kernels.quant.quantize_weights``: ``{"q8", "q8_scale"}`` dicts) gives a
``kernels.quant.QuantizedWeights``: the records are carried as they are,
keyed by their JAX leaf path, and the parameters they stand for are left
empty until a serving step dequantizes them.
``state_from_jax(cfg, state)`` carries a whole JAX train state (parameters,
AdamW moments and step, PowerSGD error buffers and Q factors) into the
port's train state the same way. Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import layout, resolve_device
from repro_torch.kernels import quant
from repro_torch.models import model


def _tensor(arr) -> torch.Tensor:
    arr = np.array(arr)   # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":   # numpy extension dtype: go by bits
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _node(tree, path: str):
    """The node at a dotted JAX path (list indices are digits)."""
    node = tree
    for key in path.split("."):
        node = node[int(key)] if isinstance(node, (list, tuple)) else \
            node[key]
    return node


def _leaf(tree, name: str, field: str | None = None):
    """The JAX leaf for one port parameter name; ``field`` picks an entry
    of a per-parameter dict leaf (the AdamW moments' "m"/"v")."""
    path, idx = layout.jax_path(name)
    node = _node(tree, path)
    if field is not None:
        node = node[field]
    return node[idx] if idx else node


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


def params_from_jax(cfg, tree, *, device=None):
    """The port's ``LM`` for ``cfg`` holding the JAX package's parameters,
    on ``device`` (the card unless the caller passes one); a
    ``QuantizedWeights`` around it when the tree holds int8 records."""
    dev = resolve_device(device)
    lm = model.LM(cfg, dev)
    named = dict(lm.named_parameters())
    records = {}
    for path, names in layout.jax_leaves(named).items():
        try:
            node = _node(tree, path)
        except (KeyError, IndexError) as e:
            raise KeyError(f"JAX params have no leaf for {names[0]!r}") \
                from e
        if quant.is_record(node):
            shape = layout.jax_shape(named, names)
            rec = {k: _tensor(node[k]).to(dev) for k in ("q8", "q8_scale")}
            if tuple(rec["q8"].shape) != shape:
                raise ValueError(f"{path}: JAX record shape "
                                 f"{tuple(rec['q8'].shape)} != {shape}")
            records[path] = rec
            for n in names:
                quant.release_param(named[n])
            continue
        for name in names:
            p = named[name]
            src = _tensor(_leaf(tree, name))
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: JAX shape {tuple(src.shape)} != "
                                 f"port shape {tuple(p.shape)}")
            p.data.copy_(src.to(p.dtype))
    return quant.QuantizedWeights(lm, records) if records else lm


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
