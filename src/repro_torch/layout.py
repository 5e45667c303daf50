"""The JAX package's parameter layout, seen from the port's parameter names.

The JAX package stacks a segment's layers on a leading axis
(``segments.0.attn.bq`` is one ``(L, d)`` leaf); the port keeps each layer
as its own tensor (``layers.3.attn.bq``). Decisions the JAX package makes
per leaf (which gradients PowerSGD compresses, which weights
``quantize_weights`` turns into int8 records) are made here on the JAX
layout, so both packages pick the same leaves.
"""

from __future__ import annotations


def jax_path(name: str) -> tuple[str, int | None]:
    """The JAX leaf path of a port parameter name and the layer index
    within it: ``layers.3.attn.bq`` -> (``segments.0.attn.bq``, 3),
    ``embed.table`` -> (``embed.table``, None)."""
    parts = name.split(".")
    if parts[0] == "layers":
        return ".".join(["segments", "0", *parts[2:]]), int(parts[1])
    return name, None


def jax_leaves(named: dict) -> dict:
    """Group port parameter names by JAX leaf path, each group in layer
    order: ``{path: [name, ...]}``."""
    groups: dict = {}
    for name in named:
        path, i = jax_path(name)
        groups.setdefault(path, []).append((i, name))
    return {path: [n for _, n in sorted(g, key=lambda t: t[0] or 0)]
            for path, g in groups.items()}


def jax_shape(named: dict, names: list) -> tuple:
    """The shape of the JAX leaf that ``names`` (one group of
    ``jax_leaves``) form: a stacked group gains the leading layer axis."""
    shape = tuple(named[names[0]].shape)
    return shape if jax_path(names[0])[1] is None else (len(names), *shape)


def stacked(names: list) -> bool:
    """Whether the group is a segment's layers stacked in the JAX layout."""
    return jax_path(names[0])[1] is not None
