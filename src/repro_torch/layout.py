"""The JAX package's parameter layout, seen from the port's parameter names.

The JAX package stacks a segment's layers on a leading axis
(``segments.0.attn.bq`` is one ``(L, d)`` leaf); the port keeps each layer
as its own tensor (``layers.3.attn.bq``). A zamba2 group stacks twice: its
Mamba2 layers on (group, layer) axes (``segments.0.mamba.mixer.in_proj``
is ``(G, period, d, ...)``), its LoRAs on the group axis; the Mamba2
layers past the last group are ``segments.1`` and the shared block is not
stacked. A llama3.2-vision group stacks its self-attention layers twice
(``segments.0.self.attn.wq`` is ``(G, period - 1, d, ...)``) and its cross
layer once (``segments.0.cross.kv_proj_k`` is ``(G, ...)``; the 0-d gates
become ``(G,)``). The port's ``tail`` is always the second segment:
zamba2's last Mamba2 layers, deepseek-v3's MoE layers (its dense MLA
layers are ``layers``). An MoE layer's expert stack keeps its expert axis:
JAX's ``segments.0.ffn.experts.w_gate`` is ``(L, E, d, f)``, the port's
``layers.3.ffn.experts.w_gate`` ``(E, d, f)``. Decisions the JAX package
makes per leaf (which gradients PowerSGD compresses, which weights
``quantize_weights`` turns into int8 records) are made here on the JAX
layout, so both packages pick the same leaves: an expert stack is 4-D
there, so it stays dense and uncompressed in both. A stacked group's names
come in index order, so stacking their tensors and reshaping to
``jax_shape`` gives the JAX leaf.
"""

from __future__ import annotations

import math


def jax_path(name: str) -> tuple[str, tuple[int, ...]]:
    """The JAX leaf path of a port parameter name and the index of the
    tensor within that leaf, one entry per stacked axis:
    ``layers.3.attn.bq`` -> (``segments.0.attn.bq``, (3,)),
    ``groups.2.mamba.3.mixer.in_proj`` -> (``segments.0.mamba.mixer.
    in_proj``, (2, 3)), ``groups.2.lora_attn.a`` -> (``segments.0.
    lora_attn.a``, (2,)), ``groups.1.self.3.attn.wq`` -> (``segments.0.
    self.attn.wq``, (1, 3)), ``groups.1.cross.gate_attn`` ->
    (``segments.0.cross.gate_attn``, (1,)), ``tail.1.mixer.D`` ->
    (``segments.1.mixer.D``, (1,)), ``embed.table`` -> (``embed.table``,
    ())."""
    parts = name.split(".")
    if parts[0] == "layers":
        return ".".join(["segments", "0", *parts[2:]]), (int(parts[1]),)
    if parts[0] == "tail":
        return ".".join(["segments", "1", *parts[2:]]), (int(parts[1]),)
    if parts[0] == "groups":
        if parts[2] in ("mamba", "self"):
            return (".".join(["segments", "0", parts[2], *parts[4:]]),
                    (int(parts[1]), int(parts[3])))
        return ".".join(["segments", "0", *parts[2:]]), (int(parts[1]),)
    return name, ()


def jax_leaves(named: dict) -> dict:
    """Group port parameter names by JAX leaf path, each group in index
    order: ``{path: [name, ...]}``."""
    groups: dict = {}
    for name in named:
        path, idx = jax_path(name)
        groups.setdefault(path, []).append((idx, name))
    return {path: [n for _, n in sorted(g)] for path, g in groups.items()}


def stack_shape(names: list) -> tuple:
    """The stacked axes of a group of ``jax_leaves``: () for a leaf that
    is not stacked."""
    idx = [jax_path(n)[1] for n in names]
    shape = tuple(max(i[k] for i in idx) + 1 for k in range(len(idx[0])))
    if math.prod(shape) != len(names):
        raise ValueError(f"{jax_path(names[0])[0]}: {len(names)} tensors "
                         f"do not fill the stacked axes {shape}")
    return shape


def jax_shape(named: dict, names: list) -> tuple:
    """The shape of the JAX leaf that ``names`` (one group of
    ``jax_leaves``) form: a stacked group gains its stacked axes."""
    return (*stack_shape(names), *named[names[0]].shape)


def stacked(names: list) -> bool:
    """Whether the group is a segment's layers stacked in the JAX layout."""
    return bool(jax_path(names[0])[1])
