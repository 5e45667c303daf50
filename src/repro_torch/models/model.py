"""LM assembly for the dense family.

Counterpart of ``src/repro/models/model.py`` (``segments`` :40, ``init``
:73, ``forward`` :219, ``unembed_fn`` :225, ``init_cache`` :282,
``prefill`` :308, ``decode_step`` :361). Where JAX stacks a segment's
layers on a leading axis and ``lax.scan``s over them, the port keeps them
in an ``nn.ModuleList`` and walks it with a Python loop. The cache is a list of
per-layer ``{"k", "v"}`` tensors, updated in place.

``forward_hidden`` and ``forward`` are differentiable (the training path
runs them under autograd; parameters that require grad get gradients),
while ``prefill`` and ``decode_step`` serve under ``torch.inference_mode``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import blocks, layers


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str          # block kind
    n: int             # layers in the segment


def segments(cfg) -> list[Segment]:
    if cfg.family == "dense":
        return [Segment("attn_mlp", cfg.n_layers)]
    raise ValueError(f"model family {cfg.family!r} is not ported yet "
                     "(ported: dense)")


class LM(nn.Module):
    """Parameters of a dense LM; attribute names follow the JAX pytree
    (``embed``, ``layers`` for the stacked segment, ``final_norm``,
    ``lm_head``)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        (seg,) = segments(cfg)
        dt = getattr(torch, cfg.dtype)
        self.cfg = cfg
        self.embed = layers.Embedding(cfg.vocab_size, cfg.d_model, dt, device)
        self.layers = nn.ModuleList(
            blocks.Block(cfg, seg.kind, device) for _ in range(seg.n))
        self.final_norm = layers.RMSNorm(cfg.d_model, device)
        if not cfg.tie_embeddings:
            self.lm_head = layers.Embedding(cfg.vocab_size, cfg.d_model, dt,
                                            device)


def init(cfg, seed: int = 0, *, device=None) -> LM:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``,
    allocated on ``device`` (the card unless the caller passes one)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return layers.init_random_(LM(cfg, dev), gen)


def _logits(params: LM, cfg, x):
    head = params.embed if cfg.tie_embeddings else params.lm_head
    return layers.unembed(head.table,
                          blocks.norm_apply(cfg, params.final_norm, x))


def forward_hidden(params: LM, cfg, batch):
    """Backbone only: returns (hidden (B,S,d), metrics). The training path
    computes the head inside ``losses.chunked_lm_loss`` to bound the live
    logits. Under autograd with ``cfg.remat`` each layer is checkpointed
    (the JAX package's per-layer remat, ``remat_group`` 1): the backward
    keeps each layer's input and runs its forward again."""
    x = layers.embed(params.embed.table, batch["tokens"])
    remat = cfg.remat and torch.is_grad_enabled()
    for seg in segments(cfg):
        for lp in params.layers:
            args = (lp, x, cfg, seg.kind)
            x, _ = (layers.remat(blocks.block_fwd, *args) if remat
                    else blocks.block_fwd(*args))
    return x, {}


def forward(params: LM, cfg, batch):
    """Returns (logits f32 (B,S,V), metrics)."""
    x, metrics = forward_hidden(params, cfg, batch)
    return _logits(params, cfg, x), metrics


def unembed_fn(params: LM, cfg):
    """Closure for the sequence-chunked loss: x_chunk -> logits_chunk."""
    return lambda xc: _logits(params, cfg, xc)


def init_cache(cfg, batch_size: int, max_len: int, *, device=None):
    dev = resolve_device(device)
    return [blocks.cache_init(cfg, seg.kind, batch_size, max_len, dev)
            for seg in segments(cfg) for _ in range(seg.n)]


@torch.inference_mode()
def prefill(params: LM, cfg, batch, cache):
    """Returns (last-token logits (B,V), cache)."""
    x = layers.embed(params.embed.table, batch["tokens"])
    (seg,) = segments(cfg)
    new_cache = []
    for lp, lc in zip(params.layers, cache):
        x, lc = blocks.block_prefill(lp, x, cfg, seg.kind, lc)
        new_cache.append(lc)
    return _logits(params, cfg, x[:, -1:])[:, 0], new_cache


@torch.inference_mode()
def decode_step(params: LM, cfg, tokens, pos: int, cache):
    """tokens: (B, 1) int; pos: int. Returns (logits (B,V), cache)."""
    x = layers.embed(params.embed.table, tokens)
    (seg,) = segments(cfg)
    new_cache = []
    for lp, lc in zip(params.layers, cache):
        x, lc = blocks.block_decode(lp, x, cfg, seg.kind, lc, pos)
        new_cache.append(lc)
    return _logits(params, cfg, x)[:, 0], new_cache
