"""Fault tolerance of the port: deterministic GEMM fault injection and
checkpoint corruptors (``ft.inject``), algorithm-based fault tolerance
(``ft.abft``: the online checksum guard ``GemmPolicy.abft`` and the
offline tree API), the step watchdog and preemption handler
(``ft.watchdog``) and the one-process elastic plan (``ft.elastic``).

Counterpart of ``src/repro/ft``. A "tree" here is a mapping of name to
tensor, an ``nn.Module`` through its ``named_parameters()``, or a mapping
that nests either (a train state); its leaves are named by their dotted
path and taken in sorted-name order, the order ``jax.tree`` flattens a
dict in. ``host_copy`` takes a deep host copy of a tree (the train-state
snapshot and the checkpointer's staging copy). A DTensor leaf is copied
as this rank's local shard (``local``): a snapshot is per rank.
"""

from __future__ import annotations

import sys
from collections.abc import Mapping

import torch
from torch import nn


def is_dtensor(t) -> bool:
    # A DTensor exists only once torch.distributed.tensor is imported, so
    # the check never imports it.
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor (its storage, under ``no_grad``);
    a plain tensor as it is."""
    return t.to_local() if is_dtensor(t) else t


def _walk(tree, prefix: str):
    items = (tree.named_parameters() if isinstance(tree, nn.Module)
             else tree.items() if isinstance(tree, Mapping) else None)
    if items is None:
        yield prefix, tree
        return
    for key, sub in items:
        yield from _walk(sub, f"{prefix}.{key}" if prefix else str(key))


def named_leaves(tree) -> list[tuple[str, torch.Tensor]]:
    """``(dotted name, tensor)`` pairs of ``tree`` (a mapping of name to
    tensor, an ``nn.Module``'s parameters, or mappings nesting them),
    sorted by name."""
    return sorted(_walk(tree, ""), key=lambda kv: kv[0])


def host_copy(tree, out: dict | None = None, *, whole: bool = False) -> dict:
    """A deep host copy of ``tree``'s leaves by dotted name, written into
    ``out`` (an earlier ``host_copy`` of a tree with the same leaves) when
    given, else into one new host buffer holding every leaf, page-locked
    when a leaf lives on the card (one allocation, and the copies run at
    the link's rate). The copy is always taken: ``.cpu()`` of a CPU
    tensor would alias the live storage, which a train step updates in
    place. A DTensor leaf is copied as its local shard, or with ``whole``
    as the full leaf, gathered one leaf at a time (a collective: every
    rank must call)."""
    def view(t):
        return t if whole else local(t)

    leaves = named_leaves(tree)
    if out is None:
        out = _host_buffer([(n, view(t)) for n, t in leaves])
    elif [(n, t.shape, t.dtype) for n, t in out.items()] != \
            [(n, view(t).shape, t.dtype) for n, t in leaves]:
        raise ValueError("[host-copy] out does not hold this tree's leaves")
    with torch.no_grad():
        for n, t in leaves:
            src = t.full_tensor() if whole and is_dtensor(t) else local(t)
            out[n].copy_(src.detach())
    return out


def _host_buffer(leaves) -> dict:
    """Views into one flat host allocation, each leaf 64-byte aligned."""
    sizes = [t.numel() * t.element_size() for _, t in leaves]
    offsets, total = [], 0
    for size in sizes:
        offsets.append(total)
        total += -(-size // 64) * 64
    flat = torch.empty(total, dtype=torch.uint8,
                       pin_memory=any(t.is_cuda for _, t in leaves))
    return {n: flat[o:o + size].view(t.dtype).view(t.shape)
            for (n, t), o, size in zip(leaves, offsets, sizes)}
