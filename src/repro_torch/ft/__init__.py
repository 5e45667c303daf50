"""Fault tolerance of the port: deterministic GEMM fault injection
(``ft.inject``) and algorithm-based fault tolerance (``ft.abft``), the
online checksum guard ``GemmPolicy.abft`` and the offline tree API.

Counterpart of ``src/repro/ft``. A "tree" here is a mapping of name to
tensor, or an ``nn.Module`` through its ``named_parameters()``; its
leaves are taken in sorted-name order, the order ``jax.tree`` flattens a
dict in. The checkpoint corruptors, the watchdog and the elastic plans
come with the fault-tolerant training loop.
"""

from __future__ import annotations

import torch
from torch import nn


def named_leaves(tree) -> list[tuple[str, torch.Tensor]]:
    """``(name, tensor)`` pairs of ``tree`` (a mapping of name to tensor,
    or an ``nn.Module``'s parameters), sorted by name."""
    items = (tree.named_parameters() if isinstance(tree, nn.Module)
             else tree.items())
    return sorted(items, key=lambda kv: kv[0])
